"""Every cross-KV mode of whisper_tpu against the port (CPU; kernels run as
their plain versions, the JAX side's Pallas kernels in interpret mode):
the 4-bit producer and quantizer bit for bit, the prompt pass over q4
cross-KV, the decode step's "q8dt", "q8i" and "q4e" branches, one step of
each quantized mode from a window's dense cross-KV (the `full` path), and
whole runs: `from_file` + `full` over a q5_0 file and `BatchTranscriber`,
segments identical to whisper_tpu's."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from test_torch_full import (_assert_same_segments, _params,  # noqa: E402
                             jax_context, jax_strict)
from test_torch_ggml import write_model  # noqa: E402
from test_torch_slice import MICRO, _first_divergence, _segments  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.models import whisper as wm  # noqa: E402
from whisper_tpu.ops import cross_attention as jxa  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu.weights.convert import random_params  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.decode.loop import QUANT_TAGS, loop_cross_kv  # noqa: E402
from whisper_tpu_torch.models import whisper as tm  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402
from whisper_tpu_torch.weights.convert import from_jax  # noqa: E402

__all__ = ["jax_strict"]   # a fixture shared with test_torch_full

TINY = (128, 32, 64, 4, 2, 32, 64, 4, 2, 80)
# float32: rounding order only; bfloat16: the frameworks round matmul
# results and operands to bf16 at different points (the Pallas bound)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    cfg = wm.WhisperConfig(*TINY, "test")
    jp = random_params(cfg, seed=0, dtype=getattr(jnp, dtype))
    return {"dtype": dtype, "jcd": getattr(jnp, dtype),
            "tcd": getattr(torch, dtype), "tol": TOL[dtype], "jp": jp,
            "tp": from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
            "enc": np.random.RandomState(12).randn(2, 32, 64).astype(
                np.float32) * 0.3}


@pytest.mark.parametrize("enc_layout", ["btd", "bdt"])
def test_cross_kv_q4_bit_for_bit(enc_layout):
    """Weights and activations on a coarse grid, so that both frameworks'
    f32 projections are exact: then codes and scales agree bit for bit,
    for K and for V, in both input layouts."""
    cfg = wm.WhisperConfig(*TINY, "test")
    jp = jax.tree_util.tree_map(
        np.asarray, random_params(cfg, seed=3, dtype=jnp.float32))
    rng = np.random.RandomState(4)
    blocks = jp["decoder"]["blocks"]
    for key in ("xk_w", "xv_w", "xv_b"):
        blocks[key] = (rng.randint(-8, 9, blocks[key].shape) / 64.0).astype(
            np.float32)
    enc = (rng.randint(-8, 9, (2, 32, 64)) / 16.0).astype(np.float32)
    if enc_layout == "bdt":
        enc = np.ascontiguousarray(enc.transpose(0, 2, 1))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    (jkq, jks), (jvq, jvs) = wm.cross_kv_q4(
        jparams, jnp.asarray(enc), n_head=4, compute_dtype=jnp.float32,
        enc_layout=enc_layout)
    (tkq, tks), (tvq, tvs) = tm.cross_kv_q4(
        from_jax(jp, "cpu"), _t(enc), n_head=4, compute_dtype=torch.float32,
        enc_layout=enc_layout)
    for tq, ts, jq, js in ((tkq, tks, jkq, jks), (tvq, tvs, jvq, jvs)):
        assert tq.dtype == torch.uint8 and tuple(tq.shape) == (2, 2, 4, 8, 32)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_quantizer_and_unpack_identical(dtype):
    """The q4 quantizer, bit for bit on equal inputs, with an all-zero
    column and codes on .5 boundaries (amax 7 -> scale 1); unpack inverts
    the packing."""
    rng = np.random.RandomState(5)
    k = rng.randn(3, 4, 64, 40).astype(np.float32)
    k[..., 5] = 0.0
    k[0, 0, :8, 6] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -7.0, 3.49]
    jk = jnp.asarray(k).astype(getattr(jnp, dtype))
    tk = torch.from_numpy(k).to(getattr(torch, dtype))
    jq, js = jxa.quantize_kv_bhdt_q4(jk)
    tq, ts = txa.quantize_kv_bhdt_q4(tk)
    assert tq.dtype == torch.uint8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    codes = txa.unpack_q4_bhdt(tq, torch.float32)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jxa.unpack_q4_bhdt(jq, jnp.float32)))
    assert codes[0, 0, :8, 6].tolist() == [7, 0, 2, 2, 0, -2, -7, 3]


def _step_inputs(tag, dtype):
    """xq (B, 1, H, Dh) and whisper_tpu-quantized K/V for one step."""
    rng = np.random.RandomState(6)
    B, H, Dh, Ta = 2, 4, 64, 256
    xq = rng.randn(B, 1, H, Dh).astype(np.float32) * 0.3
    kv = [jnp.asarray(rng.randn(B, H, Dh, Ta).astype(np.float32) * 0.3)
          .astype(getattr(jnp, dtype)) for _ in range(2)]
    qfn = jxa.quantize_kv_bhdt_q4 if tag == "q4e" else jxa.quantize_kv_bhdt
    return xq, [qfn(x) for x in kv]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", ["q8dt", "q8i", "q4e"])
def test_cross_attn_step_matches_jax(tag, dtype):
    """"q8dt" runs K2 (its plain version here; the Pallas kernel in
    interpret mode there); "q8i" and "q4e" are plain on both sides.  q8i's
    int8 dots are exact on both, so f32 holds to rounding order."""
    xq, ((kq, ks), (vq, vs)) = _step_inputs(tag, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = wm._cross_attn_step(jnp.asarray(xq), (tag, kq, ks),
                                  (tag, vq, vs), getattr(jnp, dtype))
    got = tm._cross_attn_step(_t(xq), (tag, _t(kq), _t(ks)),
                              (tag, _t(vq), _t(vs)), getattr(torch, dtype))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, 256)
    assert _rel_err(got.numpy(), ref) <= TOL[dtype]


def test_q8i_products_exact_past_2_24():
    """The w.v dot of "q8i" at Ta = 1500 with every weight code 127 and the
    V codes 127 but one (2): the int32 sum 127 * (1499 * 127 + 2) is past
    2^24 and odd, so not an f32 value; the split sum gives it exactly,
    rounded once to f32 as whisper_tpu's int32 -> f32 conversion rounds
    it."""
    B, H, Dh, Ta = 1, 1, 64, 1500
    xq = torch.ones(B, 1, H, Dh)
    kq = torch.zeros(B, H, Dh, Ta, dtype=torch.int8)    # uniform weights
    vq = torch.full((B, H, Dh, Ta), 127, dtype=torch.int8)
    vq[..., 0] = 2
    s = torch.ones(B, H, Ta)
    got = tm._q8i_attention(xq, kq, s, vq, s)
    total = 127 * (1499 * 127 + 2)
    assert total > 2 ** 24 and float(np.float32(total)) != total
    wsc = torch.amax(torch.softmax(torch.zeros(Ta), 0)) * (1.0 / 127.0)
    want = torch.tensor(float(np.float32(total))) * wsc
    assert torch.equal(got.flatten(), want.expand(Dh))


def test_decode_prompt_q4_tags(model):
    """The prompt pass over nibble-packed cross-KV, tagged "q4" and "q4e",
    dequantized one layer at a time."""
    m = model
    (kq, ks), (vq, vs) = wm.cross_kv_q4(m["jp"], jnp.asarray(m["enc"]),
                                        n_head=4, compute_dtype=m["jcd"])
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    pos = np.arange(4, dtype=np.int32)
    mask = np.asarray(wm.make_causal_mask(4))
    for tag in ("q4", "q4e"):
        ref = wm.decode_prompt(m["jp"], jnp.asarray(prompt),
                               jnp.asarray(pos), (tag, kq, ks), (tag, vq, vs),
                               4, self_mask=jnp.asarray(mask),
                               compute_dtype=m["jcd"])
        got = tm.decode_prompt(m["tp"], _t(prompt).long(), _t(pos).long(),
                               (tag, _t(kq), _t(ks)), (tag, _t(vq), _t(vs)),
                               4, self_mask=_t(mask), compute_dtype=m["tcd"])
        for g, r in zip(got, ref):            # logits, k_self, v_self
            assert _rel_err(g.float().numpy(), r) <= m["tol"]


# whisper_tpu/decode/loop.py:254-255: the step's tag for each mode
JAX_TAGS = {"einsum_q8": "q8e", "pallas_q8dt": "q8dt", "einsum_q8i": "q8i",
            "einsum_q4": "q4e"}


@pytest.mark.parametrize("mode", list(JAX_TAGS))
def test_decode_step_from_dense_cross_kv(model, mode):
    """One token-loop step of each quantized mode from a window's dense
    cross-KV, quantized by loop_cross_kv as whisper_tpu's window loop
    quantizes it (loop.py:252-267), under whisper_tpu's tag."""
    m = model
    tag = JAX_TAGS[mode]
    assert QUANT_TAGS == JAX_TAGS
    kc, vc = wm.cross_kv(m["jp"], jnp.asarray(m["enc"]), n_head=4,
                         compute_dtype=m["jcd"])
    qfn = jxa.quantize_kv_bhdt_q4 if tag == "q4e" else jxa.quantize_kv_bhdt
    jk, jv = (tag,) + qfn(kc), (tag,) + qfn(vc)
    L, B, H, Dh, _ = kc.shape
    P = 3
    rng = np.random.RandomState(7)
    cache = {n: rng.randn(L, B, H, Dh, P + 2).astype(np.float32) * 0.3
             for n in ("k", "v")}
    tok = np.array([60, 61], np.int32)
    pos = np.array([P, P], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref, _ = wm.decode_step(
            m["jp"], jnp.asarray(tok), jnp.asarray(pos), P,
            {n: jnp.asarray(c).astype(m["jcd"]) for n, c in cache.items()},
            jk, jv, kv_len=P + 1, n_head=4, compute_dtype=m["jcd"])
    tkc, tvc = (_t(np.asarray(x, np.float32)).to(m["tcd"]) for x in (kc, vc))
    tk, tv = loop_cross_kv(mode, tkc, tvc, m["tcd"])
    assert tk[0] == tag
    got, _ = tm.decode_step(
        m["tp"], _t(tok), _t(pos).long(), P,
        {n: _t(c).to(m["tcd"]) for n, c in cache.items()}, tk, tv,
        kv_len=P + 1, n_head=4, compute_dtype=m["tcd"])
    assert _rel_err(got.numpy(), ref) <= m["tol"]


@pytest.fixture(scope="module")
def q5_0_file(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("modes") / "q5_0.bin", "q5_0")


@pytest.fixture(scope="module")
def pcm_modes():
    """35 s of noise.  Not test_torch_full's seed 0: there, one bf16
    rounding of an activation inside K3 goes the other way on the two
    sides (ROADMAP queue 3), and einsum_q8i's 7-bit query carries it to a
    near-tie (log-probs 2.3e-4 apart, stream token 4) that picks another
    token; the same file densified (f16) matches at seed 0."""
    return (np.random.RandomState(1).randn(16000 * 35) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("mode", list(QUANT_TAGS))
def test_full_segments_identical_quantized_modes(q5_0_file, pcm_modes,
                                                 jax_strict, mode):
    """`from_file` + `full` (the CLI's --kv-q8 / --kv-q4 and the other
    int8 modes) over a q5_0 file with the packed decoder: the window's
    dense cross-KV is quantized once per window on both sides."""
    pcm = pcm_modes
    jctx = jax_context(q5_0_file, mode)
    assert jctx.full(_params(jax_params, {}), pcm) == 0
    tctx = WhisperContext.from_file(q5_0_file, compute_dtype=torch.float32,
                                    cross_mode=mode, device="cpu")
    assert tctx.full(_params(full_default_params, {}), pcm) == 0
    _assert_same_segments(tctx.result_all, jctx.result_all)
    assert sum(len(s.tokens) for s in jctx.result_all) >= 10


@pytest.mark.parametrize("mode", ["einsum", "einsum_q4"])
def test_batch_transcriber_modes(mode):
    """bench.py's serving settings kv=bf16 ("einsum", dense cross_kv) and
    kv=q4 ("einsum_q4", cross_kv_q4 fused into the batched encode)."""
    jctx = JaxContext.from_random(seed=7, compute_dtype=jnp.float32,
                                  dims=MICRO, cross_mode=mode)
    tctx = WhisperContext.from_jax(jctx, "cpu")
    assert tctx.cross_mode == mode
    rng = np.random.RandomState(1)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (12, 33)]
    over = {"language": "en", "no_timestamps": True, "max_tokens": 16,
            "n_max_text_ctx": 64}
    jres = JaxBatch(jctx, batch_size=2, params=_params(jax_params, over),
                    device_mel=True).transcribe(streams)
    tres = BatchTranscriber(tctx, batch_size=2,
                            params=_params(full_default_params, over),
                            device_mel=True).transcribe(streams)
    assert all(_segments(jres)), _segments(jres)
    assert _segments(tres) == _segments(jres), _first_divergence(jres, tres)
