"""Beam search: whisper_tpu_torch against whisper_tpu (CPU, micro dims).

decode_step(group=K), a stream's K beams as K queries against its one
cross-KV row, in the dense einsum and the "q8e", "q8i" and "q4e" modes;
K2's plain version with G queries against whisper_tpu's q8e einsum; the
serial beam window (t = 0 and t > 0) and the batched one (S = 2 streams x
K = 3 beams) in f32; the batched window at S = 1 against the serial one
(the invariant whisper_tpu states at decode/beam.py:292-295); and whole
runs: `full` with beam 5 and the ladder live, and BatchTranscriber with
beam 5, segments equal to whisper_tpu's.  At t > 0 every draw's lead over
its runner-up is asserted past GAP (tests/test_torch_sampling.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_cross_modes import TOL, _rel_err, _t, model  # noqa: E402
from test_torch_full import (_assert_same_segments, _params,  # noqa: E402
                             files, jax_context, jax_strict, pcm)
from test_torch_sampling import (_assert_draws_clear, draw_gaps,  # noqa: E402
                                 short_streams)
from test_torch_slice import _first_divergence, _segments, contexts  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.decode.filters import FilterOptions as JaxOptions  # noqa: E402
from whisper_tpu.models import whisper as wm  # noqa: E402
from whisper_tpu.ops import cross_attention as jxa  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.api import window_rng  # noqa: E402
from whisper_tpu_torch.decode.filters import FilterOptions  # noqa: E402
from whisper_tpu_torch.models import whisper as tm  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

__all__ = ["contexts", "draw_gaps", "files", "jax_strict", "model", "pcm",
           "short_streams"]

SEEK, END = 0, 3000


@pytest.mark.parametrize("tag", [None, "q8e", "q8i", "q4e"],
                         ids=["einsum", "q8e", "q8i", "q4e"])
def test_decode_step_group_matches_jax(model, tag):
    """S = 2 cross-KV rows, K = 3 beams a row: whisper_tpu's decode_step
    with group=3 against the port's, within the step tests' tolerance."""
    m = model
    S, K, P = 2, 3, 3
    kc, vc = wm.cross_kv(m["jp"], jnp.asarray(m["enc"]), n_head=4,
                         compute_dtype=m["jcd"])
    if tag is None:
        jk, jv = kc, vc
        tk, tv = (_t(np.asarray(x, np.float32)).to(m["tcd"])
                  for x in (kc, vc))
    else:
        qfn = (jxa.quantize_kv_bhdt_q4 if tag == "q4e"
               else jxa.quantize_kv_bhdt)
        (kq, ks), (vq, vs) = qfn(kc), qfn(vc)
        jk, jv = (tag, kq, ks), (tag, vq, vs)
        tk, tv = (tag, _t(kq), _t(ks)), (tag, _t(vq), _t(vs))
    L, _, H, Dh, _ = kc.shape
    rng = np.random.RandomState(8)
    cache = {n: rng.randn(L, S * K, H, Dh, P + 2).astype(np.float32) * 0.3
             for n in ("k", "v")}
    tok = np.arange(60, 60 + S * K, dtype=np.int32)
    pos = np.full((S * K,), P, np.int32)
    ref, ref_kv = wm.decode_step(
        m["jp"], jnp.asarray(tok), jnp.asarray(pos), P,
        {n: jnp.asarray(c).astype(m["jcd"]) for n, c in cache.items()},
        jk, jv, kv_len=P + 1, n_head=4, compute_dtype=m["jcd"], group=K)
    got, got_kv = tm.decode_step(
        m["tp"], _t(tok), _t(pos).long(), P,
        {n: _t(c).to(m["tcd"]) for n, c in cache.items()}, tk, tv,
        kv_len=P + 1, n_head=4, compute_dtype=m["tcd"], group=K)
    assert tuple(got.shape) == (S * K, ref.shape[-1])
    assert _rel_err(got.numpy(), ref) <= m["tol"]
    assert _rel_err(got_kv["k"].float().numpy(),
                    np.asarray(ref_kv["k"], np.float32)) <= m["tol"]
    # a row's logits do not depend on the other beams of its group
    alone, _ = tm.decode_step(
        m["tp"], _t(tok[:1]), _t(pos[:1]).long(), P,
        {n: _t(c[:, :1]).to(m["tcd"]) for n, c in cache.items()},
        *((x[:, :1] if isinstance(x, torch.Tensor) else
           (x[0],) + tuple(a[:, :1] for a in x[1:])) for x in (tk, tv)),
        kv_len=P + 1, n_head=4, compute_dtype=m["tcd"])
    assert _rel_err(alone.numpy(), got[:1].numpy()) <= m["tol"]


@pytest.mark.parametrize("G", [1, 3, 8])
def test_k2_plain_with_g_queries_matches_q8e_einsum(G):
    """K2's plain version at G queries a (b, h) against whisper_tpu's
    "q8e" einsum with q of length G, bf16 query (the step's form)."""
    rng = np.random.RandomState(G)
    B, H, Dh, Ta = 2, 4, 64, 200
    xq = rng.randn(B, G, H, Dh).astype(np.float32) * 0.3
    (kq, ks), (vq, vs) = (jxa.quantize_kv_bhdt(jnp.asarray(
        rng.randn(B, H, Dh, Ta).astype(np.float32) * 0.3)) for _ in range(2))
    ref = wm._cross_attn_step(jnp.asarray(xq), ("q8e", kq, ks),
                              ("q8e", vq, vs), jnp.bfloat16)
    q = _t(xq).transpose(1, 2).to(torch.bfloat16).contiguous()
    got = txa.cross_attention_decode_q8dt_ref(q, _t(kq), _t(ks), _t(vq),
                                              _t(vs))
    assert tuple(got.shape) == (B, H, G, Dh)
    merged = got.transpose(1, 2).reshape(B, G, H * Dh)
    assert _rel_err(merged.numpy(), ref) <= TOL["bfloat16"]


def _mel(jctx, n, seed=5):
    n_ctx = jctx.hparams.n_audio_ctx
    return np.random.RandomState(seed).randn(n, 2 * n_ctx, 80).astype(
        np.float32)


def _bare_prompts(jctx, n, P=8):
    prompt = [jctx.vocab.token_sot, jctx.vocab.token_lang(0),
              jctx.vocab.token_transcribe]
    buf = np.zeros((n, P), np.int32)
    buf[:, P - len(prompt):] = prompt
    return buf, np.full((n,), P - len(prompt), np.int32)


def _assert_same_window(got, want):
    n = int(want["n_tokens"])
    assert int(got["n_tokens"]) == n >= 3
    for key in ("tokens", "result_len", "seek_delta", "completed", "failed",
                "tid", "has_ts"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("p", "plog", "sum_logprobs_all", "no_speech_prob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def _serial_inputs(jctx, tctx, K):
    mel = _mel(jctx, 1)
    _, jkc, jvc = jctx._encode_fn(mel.shape[1] // 2)(jctx.params,
                                                     jnp.asarray(mel))
    _, tkc, tvc = tctx._encode_fn(torch.from_numpy(mel))
    jkv = [jnp.broadcast_to(x, (x.shape[0], K) + x.shape[2:])
           for x in (jkc, jvc)]
    tkv = [x.expand((x.shape[0], K) + x.shape[2:]) for x in (tkc, tvc)]
    return jkv, tkv


@pytest.mark.parametrize("t", [0.0, 0.4])
def test_serial_beam_window(contexts, draw_gaps, t):
    """The serial beam of `full`, K = 5 beams from one window's cross-KV
    broadcast to 5 rows, one (2,) key."""
    jctx, tctx = contexts
    K = 5
    jkv, tkv = _serial_inputs(jctx, tctx, K)
    buf, pad = _bare_prompts(jctx, K)
    key = window_rng(SEEK, 1, K, per_row=False)
    want = jctx._decode_window_fn(K, 8, JaxOptions(), False, False, 0,
                                  "beam")(jctx.params, *jkv, buf, pad, t,
                                          SEEK, END, key)
    got = tctx._decode_window_fn(K, 8, FilterOptions(), False, False, 0,
                                 "beam")(tctx.params, *tkv, buf, pad, t,
                                         SEEK, END, key)
    _assert_same_window(got, want)
    if t > 0:
        _assert_draws_clear(draw_gaps, at_least=3)
    else:
        assert not draw_gaps


def _batched_inputs(jctx, tctx, S):
    mel = _mel(jctx, S, seed=6)
    jenc, _, _ = jctx._encode_fn(mel.shape[1] // 2)(jctx.params,
                                                   jnp.asarray(mel))
    tenc, _, _ = tctx._encode_fn(torch.from_numpy(mel))
    nh = jctx.config.n_text_head
    jkv = wm.cross_kv_q8(jctx.params, jenc, n_head=nh,
                         compute_dtype=jnp.float32)
    tkv = tm.cross_kv_q8(tctx.params, tenc, n_head=nh,
                         compute_dtype=torch.float32)
    return jkv, tkv


@pytest.mark.parametrize("t", [0.0, 0.4])
def test_batched_beam_window(contexts, draw_gaps, t):
    """S = 2 streams x K = 3 beams against the streams' int8 cross-KV
    (einsum_q8: the q8e step with 3 queries a row), per-stream keys; the
    second stream's row is dead in one case."""
    jctx, tctx = contexts
    S, K = 2, 3
    jkv, tkv = _batched_inputs(jctx, tctx, S)
    buf, pad = _bare_prompts(jctx, S)
    keys = np.stack([window_rng(s * 1000, 1, 1, per_row=False)
                     for s in range(S)])
    seeks = np.array([0, 1000], np.int32)
    ends = np.array([3000, 2500], np.int32)
    jfn = jctx._beam_batch_window_fn(S, K, 8, JaxOptions(), False, False, 0)
    tfn = tctx._beam_batch_window_fn(S, K, 8, FilterOptions(), False, False,
                                     0)
    for live in (np.ones((S,), bool), np.array([True, False])):
        want = jfn(jctx.params, *jkv, buf, pad, t, seeks, ends, keys, live)
        got = tfn(tctx.params, *tkv, buf, pad, t, seeks, ends, keys, live)
        assert got["tokens"].shape[0] == S * K
        _assert_same_window(got, want)
    if t > 0:
        _assert_draws_clear(draw_gaps, at_least=3)


@pytest.mark.parametrize("t", [0.0, 0.4])
def test_batched_beam_at_one_stream_is_the_serial_beam(contexts, t):
    """In the dense einsum mode the batched window at S = 1 (one cross-KV
    row, K queries) decodes what the serial one (K broadcast rows) does."""
    jctx, tctx = contexts
    dense = WhisperContext(config=tctx.config, vocab=tctx.vocab,
                           filters=tctx.filters, params=tctx.params,
                           device="cpu", compute_dtype=torch.float32,
                           cross_mode="einsum")
    K = 4
    mel = torch.from_numpy(_mel(jctx, 1))
    _, kc, vc = dense._encode_fn(mel)
    buf, pad = _bare_prompts(jctx, K)
    key = window_rng(SEEK, 2, K, per_row=False)
    serial = dense._decode_window_fn(K, 8, FilterOptions(), False, False, 0,
                                     "beam")(
        dense.params, kc.expand(-1, K, -1, -1, -1),
        vc.expand(-1, K, -1, -1, -1), buf, pad, t, SEEK, END, key)
    batched = dense._beam_batch_window_fn(1, K, 8, FilterOptions(), False,
                                          False, 0)(
        dense.params, kc, vc, buf[:1], pad[:1], t, np.array([SEEK]),
        np.array([END]), key[None], np.ones((1,), bool))
    _assert_same_window(batched, serial)


def test_full_beam_with_ladder(files, pcm, jax_strict, draw_gaps):
    """`full` with the CLI's defaults: beam 5, best_of 5, the ladder live,
    on the packed q5_0 file (cut as in tests/test_torch_sampling.py); the
    rungs fail and run on both sides alike."""
    jctx = jax_context(files["q5_0"], "einsum")
    tctx = WhisperContext.from_file(files["q5_0"], compute_dtype=torch.float32,
                                    cross_mode="einsum", device="cpu")
    for ctx, factory in ((jctx, jax_params), (tctx, full_default_params)):
        p = factory(1)
        assert p.beam_search.beam_size == 5 and p.temperature_inc == 0.2
        p.print_progress = False
        p.duration_ms = 30000
        p.max_tokens = 8
        assert ctx.full(p, pcm) == 0
    assert tctx.timings.n_fail_p == jctx.timings.n_fail_p > 0
    _assert_draws_clear(draw_gaps, at_least=5)
    _assert_same_segments(tctx.result_all, jctx.result_all)


def test_batch_transcriber_beam(contexts, short_streams, draw_gaps):
    """BatchTranscriber with beam 5 and the ladder live at batch 10: two
    streams of five beams a decode call (K2 with G = 5 on the card)."""
    jctx, tctx = contexts
    over = {"strategy": 1, "temperature_inc": 0.2, "max_tokens": 8,
            "logprob_thold": -0.5}
    jb = JaxBatch(jctx, batch_size=10, params=_params(jax_params, over),
                  device_mel=True)
    jres = jb.transcribe(short_streams)
    tb = BatchTranscriber(tctx, batch_size=10,
                          params=_params(full_default_params, over),
                          device_mel=True)
    tres = tb.transcribe(short_streams)
    assert _segments(tres) == _segments(jres), _first_divergence(jres, tres)
    assert all(_segments(jres))
    assert tb.n_retried_windows == jb.n_retried_windows > 0
    _assert_draws_clear(draw_gaps, at_least=3)


def test_batch_beam_needs_the_batch(contexts):
    """A stream's beams are rows of one call: a batch under max(beam_size,
    best_of) is refused, as in whisper_tpu; the beam and ladder refusals
    are gone."""
    _, tctx = contexts
    p = _params(full_default_params, {"strategy": 1,
                                      "temperature_inc": 0.2})
    with pytest.raises(ValueError, match="batch_size"):
        BatchTranscriber(tctx, batch_size=4, params=p, device_mel=True)
    BatchTranscriber(tctx, batch_size=5, params=p, device_mel=True)
    p.temperature_inc = 0.0
    p.greedy.best_of = 8
    BatchTranscriber(tctx, batch_size=5, params=p, device_mel=True)
    p.beam_search.beam_size = 9
    with pytest.raises(ValueError, match="too many decoders"):
        BatchTranscriber(tctx, batch_size=10, params=p, device_mel=True)
