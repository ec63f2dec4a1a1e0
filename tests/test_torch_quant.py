"""Plain versions of kernels K3 (quantized_matmul), K4 and K5 (single-query
cross-attention over (B, H, Ta, Dh) K/V), and the int8 quantizer, against
whisper_tpu's Pallas kernels run in interpret mode on the CPU, on the same
numpy inputs.  The CUDA kernels themselves are held against these plain
versions on the card (chip_smoke.py, tests/test_torch_gpu.py).

The Pallas kernels round to bf16 at stated points (x, the scales and each
dequantized weight in K3; the query, K/V and the softmax weights in K4/K5).
XLA on the CPU may skip such a rounding between fused ops
(`xla_allow_excess_precision`, on by default; it did so for K3 at M = 1),
which the TPU does not.  The JAX side is therefore compiled with that
option off, so it computes what the TPU kernels compute.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from whisper_tpu.ops import cross_attention as jxa  # noqa: E402
from whisper_tpu.ops import quantized as jq  # noqa: E402
from whisper_tpu.weights import quant  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.ops import quantized as tq  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
QTYPES = (quant.GGML_TYPE_Q4_0, quant.GGML_TYPE_Q4_1, quant.GGML_TYPE_Q5_0,
          quant.GGML_TYPE_Q5_1, quant.GGML_TYPE_Q8_0)
# only the f32 summation order differs between the two sides
RTOL = 1e-5


def run_strict(fn, *args):
    """A Pallas wrapper in interpret mode, compiled without excess
    precision (module docstring)."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn.lower(*args).compile(compiler_options=STRICT)(
            *args))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _packed(qtype, K, N, seed):
    """(codes_t, scales_t, mins_t|None) of a random (N, K) weight in ggml
    type `qtype`, K-major as params_from_ggml stores them."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(N, K) * 0.05 + 0.01).astype(np.float32)
    raw = quant.QUANTIZERS[qtype](w)
    return tuple(None if a is None else np.ascontiguousarray(a.T)
                 for a in jq.unpack_to_codes(raw, qtype, (N, K)))


@pytest.mark.parametrize("K,N", [(256, 128), (128, 512)])
@pytest.mark.parametrize("M", [1, 5, 40, 232])
@pytest.mark.parametrize("qtype", QTYPES)
def test_k3_plain_matches_pallas(qtype, M, K, N):
    codes, scales, mins = _packed(qtype, K, N, seed=M + K + qtype)
    x = np.random.RandomState(M).randn(M, K).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, codes, scales)]
    if mins is not None:
        jargs.append(jnp.asarray(mins))
    ref = run_strict(jq.quantized_matmul, *jargs)
    targs = [torch.from_numpy(a) for a in (x, codes, scales)]
    if mins is not None:
        targs.append(torch.from_numpy(mins))
    n = tq.quantized_matmul.launches
    got = tq.quantized_matmul(*targs)
    assert tq.quantized_matmul.launches == n      # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def test_k3_plain_rounds_like_the_kernel():
    """The roundings are the kernel's, not a dense f32 matmul's: the plain
    version differs from x @ decoded_w by the bf16 steps, and equals the
    explicit per-step rounding exactly."""
    codes, scales, mins = _packed(quant.GGML_TYPE_Q5_1, 128, 128, seed=3)
    x = np.random.RandomState(3).randn(4, 128).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, codes, scales, mins)]
    got = tq.quantized_matmul_ref(*t)
    w = (codes.astype(np.float32) * np.repeat(scales, 32, axis=0)
         + np.repeat(mins, 32, axis=0))
    assert _rel_err(got.numpy(), x @ w) > 1e-4
    bf = torch.bfloat16
    s = t[2].to(bf).float().repeat_interleave(32, 0)
    m = t[3].to(bf).float().repeat_interleave(32, 0)
    wt = ((t[1].float() * s).to(bf).float() + m).to(bf).float()
    torch.testing.assert_close(got, t[0].to(bf).float() @ wt, rtol=0, atol=0)


# (M, K, N) of K3's prompt path: the GPU tests' shapes at M = 9, 40, 232 and
# 2000, large-v3's linears at serving prompt passes of 4 and 64 streams
# (P = 232 rows each, parallel/batch.py `_prompt_bucket`), and the edges
K3_PROMPT_SHAPES = (
    [(M, K, N) for M in (9, 40, 232, 2000)
     for K, N in ((1280, 1280), (1280, 5120), (5120, 1280), (768, 768),
                  (768, 3072), (3072, 768), (128, 384))]
    + [(M, K, N) for M in (4 * 232, 64 * 232)
       for K, N in ((1280, 1280), (1280, 5120), (5120, 1280))]
    + [(9, 32, 128), (130, 64, 256), (129, 16384, 128)])


@pytest.mark.parametrize("M,K,N", K3_PROMPT_SHAPES)
def test_k3_prompt_plan_covers_tiles(M, K, N):
    """K3 at M > 8 (the carried-prompt pass): one launch of 128 x 128
    output tiles, each tile's K split over a cluster of 1, 2, 4 or 8 CTAs
    (never more than K's 32-row blocks), as many as it takes to bring the
    grid to one CTA an SM; every (row tile, column tile, 32-row block) is
    taken by exactly one CTA, and each rank's slice of the tile's rows is
    whole."""
    assert M > tq.DECODE_M
    kblocks = K // 32
    c = tq._prompt_cluster(M, N, K)
    assert c in (1, 2, 4, 8) and c <= kblocks
    row_tiles = -(-M // tq.PROMPT_TILE)
    tiles = row_tiles * (N // tq.PROMPT_TILE)
    assert tiles * c >= tq.SMS or 2 * c > min(tq.PROMPT_MAX_CLUSTER, kblocks)
    assert c == 1 or tiles * c // 2 < tq.SMS
    assert tq.PROMPT_TILE % c == 0          # the owners' row slices
    taken = {}
    for mt in range(row_tiles):
        for nt in range(N // tq.PROMPT_TILE):
            for rank in range(c):
                begin, end = tq._k_slice(rank, c, kblocks)
                assert end > begin
                for kb in range(begin, end):
                    key = (mt, nt, kb)
                    taken[key] = taken.get(key, 0) + 1
    assert len(taken) == tiles * kblocks and set(taken.values()) == {1}
    if M == 232 and (K, N) in ((1280, 1280), (1280, 5120), (5120, 1280)):
        assert tiles * c >= tq.SMS          # large-v3's prompt pass fills the card


# (K, N) of large-v3's and small's decoder linears, the micro shape of the
# GPU tests, and the edges: one 32-row block, and K far past 16 blocks a
# CTA
K3_DECODE_SHAPES = [(1280, 1280), (1280, 5120), (5120, 1280), (768, 768),
                    (768, 3072), (3072, 768), (128, 384), (32, 128),
                    (16384, 128)]


@pytest.mark.parametrize("K,N", K3_DECODE_SHAPES)
def test_k3_cluster_slices_cover_k(K, N):
    """K3 at M <= 8: one launch, the K slices of a column tile on one
    cluster of at most 16 CTAs (a power of two, never more than K's 32-row
    blocks), as many as it takes to bring the grid to two CTAs an SM; the
    slices cover every 32-row block exactly once, none empty."""
    kblocks, tiles = K // 32, N // tq.DECODE_TILE_N
    c = tq._cluster(N, K)
    assert 1 <= c <= tq.MAX_CLUSTER and c <= kblocks and c & (c - 1) == 0
    assert tiles * c >= tq.TARGET_BLOCKS or 2 * c > min(tq.MAX_CLUSTER,
                                                        kblocks)
    assert c == 1 or tiles * c // 2 < tq.TARGET_BLOCKS
    covered = []
    for rank in range(c):
        begin, end = tq._k_slice(rank, c, kblocks)
        assert end > begin
        covered += range(begin, end)
    assert covered == list(range(kblocks))


def test_k3_cluster_sizes_at_whisper_shapes():
    """64-column tiles: 20 x 16 CTAs at large-v3's square linear and fc2,
    80 x 4 at its fc1."""
    assert tq.DECODE_TILE_N == 64
    assert tq._cluster(1280, 1280) == 16
    assert tq._cluster(5120, 1280) == 4
    assert tq._cluster(1280, 5120) == 16
    assert tq._cluster(128, 32) == 1


def _kv_inputs(seed=0, B=2, H=4, Ta=37, Dh=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, 1, Dh).astype(np.float32) * 0.3
    k = rng.randn(B, H, Ta, Dh).astype(np.float32) * 0.3
    v = rng.randn(B, H, Ta, Dh).astype(np.float32) * 0.3
    return q, k, v


@pytest.mark.parametrize("Ta", [37, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_pallas(dtype, Ta):
    """q and K/V in the compute dtype: both sides round them to bf16."""
    q, k, v = (a.astype(np.float32) for a in _kv_inputs(Ta=Ta))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = run_strict(jxa.cross_attention_decode,
                     *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    n = txa.cross_attention_decode.launches
    got = txa.cross_attention_decode(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert txa.cross_attention_decode.launches == n
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("Ta", [1, 37, 64, 65, 1500, 16384])
@pytest.mark.parametrize("bh", [1, 12, 20, 80])
def test_k4_plan_covers_ta(bh, Ta):
    """K4's cluster: C CTAs (a power of two, at most 16 and at most one a
    64 keys, so C = 1 at Ta <= 64) whose ranges of whole 16-key chunks
    cover Ta exactly once, none empty; a range arrives in one tile when it
    is short, else through the ring."""
    c, tile, stages = txa._xattn_plan(bh, Ta)
    assert 1 <= c <= txa.MAX_CLUSTER and c <= -(-Ta // 64) and c & (c - 1) == 0
    if Ta <= 64:
        assert c == 1
    covered = []
    for rank in range(c):
        t0, t1 = txa._key_range(rank, c, Ta)
        assert t1 > t0 and t0 % txa.KEY_CHUNK == 0
        covered += range(t0, t1)
    assert covered == list(range(Ta))
    longest = max(t1 - t0 for t0, t1 in (txa._key_range(r, c, Ta)
                                         for r in range(c)))
    if longest <= txa.ONE_SHOT_KEYS:     # one tile holds any range
        assert stages == 2 and longest <= tile <= txa.ONE_SHOT_KEYS
    else:
        assert (tile, stages) == (txa.RING_KEYS, txa.RING_STAGES)
    assert 2 <= stages <= 8 and stages * tile * 128 <= 96 * 1024


def test_k4_plan_fills_the_card():
    """16 CTAs a (b, h) at batch 1 (B*H = 12 or 20), 96 keys each at most,
    their K and V in one copy each; 4-8 at (4, 20), through the ring."""
    assert txa._xattn_plan(12, 1500) == (16, 96, 2)
    assert txa._xattn_plan(20, 1500) == (16, 96, 2)
    c, tile, stages = txa._xattn_plan(80, 1500)
    assert c in (4, 8) and (tile, stages) == (txa.RING_KEYS, txa.RING_STAGES)
    for bh in (12, 20, 80):
        c, _, _ = txa._xattn_plan(bh, 1500)
        assert bh * c >= txa.TARGET_CTAS or c == txa.MAX_CLUSTER


@pytest.mark.parametrize("Ta", [37, 128])
def test_k5_plain_matches_pallas(Ta):
    """Identical int8 codes and scales into both (quantize_kv is held bit
    for bit below)."""
    q, k, v = _kv_inputs(seed=1, Ta=Ta)
    kq, ks = jxa.quantize_kv(jnp.asarray(k))
    vq, vs = jxa.quantize_kv(jnp.asarray(v))
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    ref = run_strict(jxa.cross_attention_decode_q8, qb, kq, ks, vq, vs)
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    n = txa.cross_attention_decode_q8.launches
    got = txa.cross_attention_decode_q8(
        torch.from_numpy(q).to(torch.bfloat16), *t)
    assert txa.cross_attention_decode_q8.launches == n
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    _, k, _ = _kv_inputs(seed=2, Ta=64)
    k = np.stack([k, 3.0 * k])                       # a leading L axis
    k[..., 5, :] = 0.0                               # an all-zero row
    jk = jnp.asarray(k).astype(getattr(jnp, dtype))
    tk = torch.from_numpy(k).to(getattr(torch, dtype))
    jq8, js = jxa.quantize_kv(jk)
    tq8, ts = txa.quantize_kv(tk)
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == js.shape == k.shape[:-1] + (1,)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_new_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    not sent down another path."""
    codes, scales, _ = _packed(quant.GGML_TYPE_Q8_0, 128, 128, seed=0)
    codes, scales = torch.from_numpy(codes), torch.from_numpy(scales)
    x = torch.zeros(1, 128, device="meta")
    with pytest.raises(ValueError):
        tq.quantized_matmul(x, codes, scales)
    q = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        txa.cross_attention_decode(q, kv, kv)
    codes8 = torch.zeros(1, 2, 8, 64, dtype=torch.int8)
    sc = torch.ones(1, 2, 8, 1)
    with pytest.raises(ValueError):
        txa.cross_attention_decode_q8(q, codes8, sc, codes8, sc)
