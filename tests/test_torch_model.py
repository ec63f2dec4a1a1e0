"""whisper_tpu_torch model forward, mel and logit filters against
whisper_tpu on the same weights and inputs (CPU; kernels run as their
plain versions)."""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from whisper_tpu.audio.filters import mel_filterbank  # noqa: E402
from whisper_tpu.audio.mel import (log_mel_spectrogram_jax,  # noqa: E402
                                   pad_audio)
from whisper_tpu.decode import filters as jf  # noqa: E402
from whisper_tpu.models import whisper as wm  # noqa: E402
from whisper_tpu.weights.convert import random_params  # noqa: E402
from whisper_tpu.weights.ggml_reader import synthetic_vocab  # noqa: E402
from whisper_tpu_torch.audio import mel as tmel  # noqa: E402
from whisper_tpu_torch.decode import filters as tf  # noqa: E402
from whisper_tpu_torch.models import whisper as tm  # noqa: E402
from whisper_tpu_torch.weights import vocab as tvocab  # noqa: E402
from whisper_tpu_torch.weights.convert import from_jax  # noqa: E402

TINY = (128, 32, 64, 4, 2, 32, 64, 4, 2, 80)   # tests/test_pallas_ops.py
# float32: rounding order only; bfloat16: the frameworks round matmul
# results and operands to bf16 at different points (the Pallas bound)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    cfg = wm.WhisperConfig(*TINY, "test")
    jp = random_params(cfg, seed=0, dtype=getattr(jnp, dtype))
    tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(11)
    return {
        "dtype": dtype, "jcd": getattr(jnp, dtype),
        "tcd": getattr(torch, dtype), "tol": TOL[dtype],
        "jp": jp, "tp": tp,
        "mel": rng.randn(2, 64, 80).astype(np.float32),
        "enc": rng.randn(2, 32, 64).astype(np.float32) * 0.3,
    }


def test_conv_stem(model):
    m = model
    ref = wm.conv_stem(m["jp"]["encoder"], jnp.asarray(m["mel"]), m["jcd"])
    got = tm.conv_stem(m["tp"]["encoder"], _t(m["mel"]), m["tcd"])
    _close(got, ref, m["tol"])


def test_encode(model):
    m = model
    ref = wm.encode(m["jp"], jnp.asarray(m["mel"]), n_head=4,
                    compute_dtype=m["jcd"], attn_impl="einsum")
    got = tm.encode(m["tp"], _t(m["mel"]), n_head=4, compute_dtype=m["tcd"])
    _close(got, ref, m["tol"])


def test_cross_kv_q8(model):
    """Scales agree to rounding.  In f32 a code may sit one step off where
    the projection lands within rounding of a .5 boundary.  In bf16 a
    one-ulp difference in a column's largest element moves that column's
    scale and so many of its codes (the quantizer itself is exact on equal
    inputs, test_torch_kernels.py), so there the dequantized values are
    held to the bf16 bound instead."""
    m = model
    (jkq, jks), (jvq, jvs) = wm.cross_kv_q8(
        m["jp"], jnp.asarray(m["enc"]), n_head=4, compute_dtype=m["jcd"])
    (tkq, tks), (tvq, tvs) = tm.cross_kv_q8(
        m["tp"], _t(m["enc"]), n_head=4, compute_dtype=m["tcd"])
    f32 = m["dtype"] == "float32"
    for jq, js, tq, ts in ((jkq, jks, tkq, tks), (jvq, jvs, tvq, tvs)):
        assert tq.dtype == torch.int8 and tq.shape == jq.shape
        jq, js = np.asarray(jq), np.asarray(js)
        diff = np.abs(tq.numpy().astype(np.int32) - jq.astype(np.int32))
        if f32:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        _close(ts.numpy(), js, m["tol"])
        _close(tq.numpy() * ts.numpy()[..., None, :],
               jq * js[..., None, :], 1.0 / 127 if f32 else m["tol"])


def _prompt_inputs(m):
    """Left-padded prompt with its mask, and one shared int8 cross-KV."""
    (kq, ks), (vq, vs) = wm.cross_kv_q8(
        m["jp"], jnp.asarray(m["enc"]), n_head=4, compute_dtype=m["jcd"])
    P = 6
    pad_len = np.array([2, 0], np.int32)
    prompt = np.array([[0, 0, 50, 51, 52, 53], [7, 8, 9, 10, 11, 12]],
                      np.int32)
    idx = np.arange(P)
    positions = np.maximum(idx[None] - pad_len[:, None], 0)
    q, k = idx[None, :, None], idx[None, None, :]
    valid = (k <= q) & ((k >= pad_len[:, None, None]) | (k == q))
    mask = np.where(valid, 0.0, -np.inf).astype(np.float32)[:, None]
    return prompt, positions, pad_len, mask, (kq, ks, vq, vs)


def test_decode_prompt_tagged_q8(model):
    m = model
    prompt, positions, _, mask, (kq, ks, vq, vs) = _prompt_inputs(m)
    ref = wm.decode_prompt(m["jp"], jnp.asarray(prompt),
                           jnp.asarray(positions), ("q8", kq, ks),
                           ("q8", vq, vs), 4, self_mask=jnp.asarray(mask),
                           compute_dtype=m["jcd"])
    got = tm.decode_prompt(m["tp"], _t(prompt).long(), _t(positions).long(),
                           ("q8", _t(kq), _t(ks)), ("q8", _t(vq), _t(vs)), 4,
                           self_mask=_t(mask), compute_dtype=m["tcd"])
    for g, r in zip(got, ref):      # logits, k_self, v_self
        _close(g, r, m["tol"])


def test_decode_step_q8e(model):
    """One step of the token loop on the (L, B, H, Dh, C) self-KV with
    pad_len masking and the q8e cross path."""
    m = model
    prompt, positions, pad_len, mask, (kq, ks, vq, vs) = _prompt_inputs(m)
    _, k_self, v_self = wm.decode_prompt(
        m["jp"], jnp.asarray(prompt), jnp.asarray(positions),
        ("q8", kq, ks), ("q8", vq, vs), 4, self_mask=jnp.asarray(mask),
        compute_dtype=m["jcd"])
    P, C = prompt.shape[1], prompt.shape[1] + 4
    cache = {}
    for name, s in (("k", k_self), ("v", v_self)):
        c = np.zeros(s.shape[:2] + s.shape[3:] + (C,), np.float32)
        c[..., :P] = np.asarray(s).transpose(0, 1, 3, 4, 2)
        cache[name] = c
    tok = np.array([60, 61], np.int32)
    pos = (P - pad_len).astype(np.int32)
    jcache = {k: jnp.asarray(v).astype(m["jcd"]) for k, v in cache.items()}
    ref_logits, ref_kv = wm.decode_step(
        m["jp"], jnp.asarray(tok), jnp.asarray(pos), P, jcache,
        ("q8e", kq, ks), ("q8e", vq, vs), kv_len=P + 1, n_head=4,
        pad_len=jnp.asarray(pad_len), compute_dtype=m["jcd"])
    tcache = {k: _t(v).to(m["tcd"]) for k, v in cache.items()}
    got_logits, got_kv = tm.decode_step(
        m["tp"], _t(tok), _t(pos).long(), P, tcache,
        ("q8e", _t(kq), _t(ks)), ("q8e", _t(vq), _t(vs)), kv_len=P + 1,
        n_head=4, pad_len=_t(pad_len).long(), compute_dtype=m["tcd"])
    _close(got_logits, ref_logits, m["tol"])
    for name in ("k", "v"):
        _close(got_kv[name].float().numpy(),
               np.asarray(ref_kv[name], np.float32), m["tol"])


def test_causal_mask():
    for t, off in ((5, 0), (3, 4)):
        np.testing.assert_array_equal(tm.make_causal_mask(t, off).numpy(),
                                      np.asarray(wm.make_causal_mask(t, off)))


@pytest.mark.parametrize("pcm_dtype", ["float32", "int16"])
def test_log_mel_matches_jax(pcm_dtype):
    """Device mel on f32 and packed s16 PCM; atol 5e-4 as the Pallas mel
    test holds it (tests/test_pallas_ops.py)."""
    rng = np.random.RandomState(2)
    pcm = rng.randn(16000 * 3).astype(np.float32) * 0.1
    if pcm_dtype == "int16":
        pcm = (pcm * 32768).clip(-32768, 32767).astype(np.int16)
    padded, _, _ = pad_audio(pcm)
    tpadded, _, _ = tmel.pad_audio(pcm)
    np.testing.assert_array_equal(tpadded, padded)
    x = padded.astype(np.float32)
    if pcm_dtype == "int16":
        x = x * np.float32(1.0 / 32768.0)
    filters = mel_filterbank(80).astype(np.float32)
    ref = log_mel_spectrogram_jax(jnp.asarray(x[None]), filters)
    got = tmel.log_mel_spectrogram_torch(_t(x[None]), _t(filters))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


def test_vocab_and_filterbank_copies():
    from whisper_tpu_torch.audio.filters import mel_filterbank as tmf
    for n in (51864, 51865, 51866):
        assert tvocab.synthetic_vocab(n).__dict__ == synthetic_vocab(n).__dict__
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tmf(n_mels), mel_filterbank(n_mels))


@pytest.mark.parametrize("no_timestamps", [False, True])
def test_filter_chain_matches_jax(no_timestamps):
    """Every combination of the per-row state flags, on random logits:
    -inf in exactly the same places, 1e-5 elsewhere."""
    n_vocab = 51866
    consts_j = jf.FilterConsts.from_vocab(synthetic_vocab(n_vocab), 1500)
    consts_t = tf.FilterConsts.from_vocab(tvocab.synthetic_vocab(n_vocab),
                                          1500)
    assert consts_t.__dict__ == consts_j.__dict__
    opts = dict(no_timestamps=no_timestamps, suppress_nst=True)
    proc_j = jf.make_process_logits(consts_j, jf.FilterOptions(**opts),
                                    extra_suppress=(5, 7))
    proc_t = tf.make_process_logits(consts_t, tf.FilterOptions(**opts),
                                    extra_suppress=(5, 7))
    flags = np.array(list(itertools.product([False, True], repeat=4)))
    B = len(flags)
    rng = np.random.RandomState(9)
    logits = rng.randn(B, n_vocab).astype(np.float32) * 3.0
    # make the timestamp mass win on some rows (timestamp-sum rule)
    logits[::3, consts_j.token_beg:] += 4.0
    seek_delta = rng.randint(0, 3000, size=B).astype(np.int32)
    args = [flags[:, j] for j in range(4)] + [seek_delta]
    for temperature in (0.0, 0.7):
        ref = proc_j(jnp.asarray(logits), jnp.float32(temperature),
                     *map(jnp.asarray, args))
        got = proc_t(_t(logits), temperature, *map(_t, args))
        for g, r in zip(got, ref):
            g, r = g.numpy(), np.asarray(r)
            np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r))
            fin = np.isfinite(r)
            np.testing.assert_allclose(g[fin], r[fin], rtol=1e-5, atol=1e-5)
        got_td = tf.sample_token_data(got[2], got[1], consts_t)
        ref_td = jf.sample_token_data(ref[2], ref[1], consts_j)
        np.testing.assert_array_equal(got_td[0].numpy(), np.asarray(ref_td[0]))
        for g, r in zip(got_td[1:], ref_td[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
