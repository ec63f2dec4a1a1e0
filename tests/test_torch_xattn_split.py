"""The split of Ta that kernels K2 (int8 K/V in (B, H, Dh, Ta)) and K5 (int8
K/V in (B, H, Ta, Dh)) make on the card, held here on the CPU: their plans
(`_cluster_size`, `_xattn_plan(..., elem=1)`, `_key_range`) at every
(B*H, Ta) that chip_smoke.py and the decode paths give them, and a torch
emulation of the split's arithmetic against whisper_tpu's Pallas kernels
(interpret mode, compiled without excess precision as in
tests/test_torch_quant.py).

The emulation does what the CUDA kernels do across a cluster: each CTA's
range of whole 16-key chunks gets its own (max, sum of exp(s - max)); the
pairs merge in rank order into the global max and sum; only then is any
weight formed and rounded to bf16 (times the V scale); the CTAs' partial
outputs are added in rank order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from whisper_tpu.ops import cross_attention as jxa  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
# the emulation and the Pallas kernels make the same bf16 roundings; the
# f32 sums run in other orders, so a weight within an f32 rounding of a
# bf16 tie may round the other way (the card's bound, chip_smoke.KERNEL_TOL)
TOL = 5e-4
# a block's shared memory on the H100, and what each kernel declares
# statically beside its dynamic part (csrc/cross_attention.cu): K5's
# scratch, red, stats, parts and two mbarriers; K2's qf, part, scratch,
# stats, parts and two mbarriers
SMEM_PER_BLOCK = 232448
K5_STATIC = 8 * 4 + 8 * 64 * 4 + 16 * 8 + 16 * 64 * 4 + 16
K2_STATIC = 128 * 4 + 256 * 4 * 4 + 8 * 4 + 16 * 8 + 16 * 128 * 4 + 16
K5_STAGE_BYTES = 64 * 1024
# B*H of the paths and chip_smoke's shapes (small's 12 heads and large's
# 20 at batch 1, the serving batch of 4, bench.py's batch of 64) and one
# (b, h); Ta of the encoder (1500), one CTA (<= 64), ragged chunks, the most
BH = [1, 12, 20, 80, 1280]
TA = [1, 37, 64, 65, 1500, 16384]


def _plan(kernel, bh, ta):
    """(cluster, tile_keys, n_stages) of K5; (cluster, None, None) of K2."""
    if kernel == "K2":
        return txa._cluster_size(bh, ta), None, None
    return txa._xattn_plan(bh, ta, 1)


@pytest.mark.parametrize("Ta", TA)
@pytest.mark.parametrize("bh", BH)
@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_q8_plan_partitions_ta(kernel, bh, Ta):
    """C CTAs (a power of two, at most 16 and at most one per 64 keys, so
    C = 1 at Ta <= 64) whose ranges of whole 16-key chunks cover Ta
    exactly once, none empty; a CTA's shared memory fits in a block's."""
    c, tile, stages = _plan(kernel, bh, Ta)
    assert 1 <= c <= txa.MAX_CLUSTER and c & (c - 1) == 0
    assert c <= -(-Ta // txa.MIN_KEYS)
    covered = []
    for rank in range(c):
        t0, t1 = txa._key_range(rank, c, Ta)
        assert t1 > t0 and t0 % txa.KEY_CHUNK == 0
        covered += range(t0, t1)
    assert covered == list(range(Ta))
    cap = max(t1 - t0 for t0, t1 in (txa._key_range(r, c, Ta)
                                     for r in range(c)))
    if kernel == "K2":
        dynamic = 8 * (-(-cap // 4) * 4)          # scales, logits, weights
        assert dynamic + K2_STATIC <= SMEM_PER_BLOCK
    else:
        assert 2 <= stages <= 8 and stages * tile * 64 <= K5_STAGE_BYTES
        if cap <= 2 * txa.ONE_SHOT_KEYS:          # one copy each for K, V
            assert stages == 2 and cap <= tile
        dynamic = 64 + stages * tile * 64 + 2 * cap * 4
        assert dynamic + K5_STATIC <= SMEM_PER_BLOCK
    # the most either kernel asks for, at C = 1 and Ta = MAX_TA
    assert 8 * txa.MAX_TA + K2_STATIC <= SMEM_PER_BLOCK
    assert (64 + K5_STAGE_BYTES + 2 * 4 * txa.MAX_TA + K5_STATIC
            <= SMEM_PER_BLOCK)


def test_q8_plans_fill_the_card():
    """16 CTAs a (b, h) at batch 1, 4 at the serving batch of 4, one at
    bench.py's batch of 64; K5's ranges of at most 96 keys land in one copy
    each at batch 1, its 384-key ranges at (4, 20) through the ring of 256
    keys."""
    assert txa._cluster_size(20, 1500) == 16
    assert txa._cluster_size(80, 1500) == 4
    assert txa._cluster_size(1280, 1500) == 1
    assert txa._xattn_plan(20, 1500, 1) == (16, 96, 2)
    assert txa._xattn_plan(12, 1500, 1) == (16, 96, 2)
    assert txa._xattn_plan(80, 1500, 1) == (4, 256, 4)
    assert txa._xattn_plan(1280, 1500, 1) == (1, 256, 4)
    # K4's plan is unchanged by the element size argument's default
    assert txa._xattn_plan(80, 1500) == (4, 128, 4)


def test_k2_word_path_needs_aligned_rows():
    """K2 reads 4 keys as one word only where every d-row (Ta bytes apart)
    and every range starts 4-byte aligned."""
    assert txa._q8dt_words(1500, 0, 256)
    assert not txa._q8dt_words(1501, 0, 256)
    assert not txa._q8dt_words(1500, 1, 256)
    assert not txa._q8dt_words(1500, 0, 258)


def _split_attention(q, k, ks, v, vs, cluster):
    """The split as the kernels compute it, in f32 on the CPU.  q (B, H, 1,
    Dh) bf16; k/v (B, H, Ta, Dh) int8 codes; ks/vs (B, H, Ta) f32 ->
    (B, H, 1, Dh) f32."""
    Ta, dh = k.shape[2], q.shape[-1]
    qf = q.float()
    ranges = [txa._key_range(r, cluster, Ta) for r in range(cluster)]
    logits = [torch.matmul(qf, k[:, :, t0:t1].float().transpose(-1, -2))
              * ks[:, :, None, t0:t1] * (dh ** -0.5) for t0, t1 in ranges]
    # each CTA's (max, sum), merged in rank order
    maxes = [s.amax(-1, keepdim=True) for s in logits]
    sums = [torch.exp(s - m_r).sum(-1, keepdim=True)
            for s, m_r in zip(logits, maxes)]
    m = maxes[0]
    for m_r in maxes[1:]:
        m = torch.maximum(m, m_r)
    total = torch.zeros_like(m)
    for m_r, s_r in zip(maxes, sums):
        total = total + s_r * torch.exp(m_r - m)
    inv = 1.0 / total
    # weights rounded after the merge; partial outputs added in rank order
    out = torch.zeros(q.shape, dtype=torch.float32)
    for (t0, t1), s in zip(ranges, logits):
        w = (torch.exp(s - m) * inv * vs[:, :, None, t0:t1]).to(
            torch.bfloat16).float()
        out = out + torch.matmul(w, v[:, :, t0:t1].float())
    return out


def run_strict(fn, *args):
    """A Pallas wrapper in interpret mode, compiled without excess
    precision (as tests/test_torch_quant.py runs them)."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn.lower(*args).compile(compiler_options=STRICT)(
            *args))


def _inputs(seed, B, H, Ta, Dh=64):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, 1, Dh) * 0.3).astype(np.float32)
    k = (rng.randn(B, H, Dh, Ta) * 0.3).astype(np.float32)
    v = (rng.randn(B, H, Dh, Ta) * 0.3).astype(np.float32)
    return q, k, v


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


# Ta: one CTA (37), two CTAs of 32 and 33 keys (65), four (200), sixteen
# of up to 96 keys (1500), at B*H = 8
@pytest.mark.parametrize("Ta", [37, 65, 200, 1500])
def test_k2_split_matches_pallas(Ta):
    """K2's split (its plan at B*H = 8) against `cross_attention_decode_q8dt`
    on the same int8 codes and scales, and against K2's plain version."""
    B, H = 2, 4
    q, k, v = _inputs(Ta, B, H, Ta)
    kq, ks = jxa.quantize_kv_bhdt(jnp.asarray(k))
    vq, vs = jxa.quantize_kv_bhdt(jnp.asarray(v))
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    ref = run_strict(jxa.cross_attention_decode_q8dt, qb, kq, ks, vq, vs)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a))
                          for a in (kq, ks, vq, vs))
    cluster = txa._cluster_size(B * H, Ta)
    assert cluster == min(16, -(-Ta // 64))
    got = _split_attention(tq, tkq.transpose(-1, -2), tks,
                           tvq.transpose(-1, -2), tvs, cluster)
    assert _rel_err(got.numpy(), ref) <= TOL
    plain = txa.cross_attention_decode_q8dt_ref(tq, tkq, tks, tvq, tvs)
    assert _rel_err(got.numpy(), plain.numpy()) <= TOL


@pytest.mark.parametrize("Ta", [37, 65, 200, 1500])
def test_k5_split_matches_pallas(Ta):
    """K5's split (its plan at B*H = 8) against `cross_attention_decode_q8`
    on the same int8 codes and scales, and against K5's plain version."""
    B, H = 2, 4
    q, k, v = _inputs(Ta + 1, B, H, Ta)
    k, v = (np.ascontiguousarray(a.transpose(0, 1, 3, 2)) for a in (k, v))
    kq, ks = jxa.quantize_kv(jnp.asarray(k))
    vq, vs = jxa.quantize_kv(jnp.asarray(v))
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    ref = run_strict(jxa.cross_attention_decode_q8, qb, kq, ks, vq, vs)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a))
                          for a in (kq, ks, vq, vs))
    cluster, _, _ = txa._xattn_plan(B * H, Ta, 1)
    assert cluster == min(16, -(-Ta // 64))
    got = _split_attention(tq, tkq, tks[..., 0], tvq, tvs[..., 0], cluster)
    assert _rel_err(got.numpy(), ref) <= TOL
    plain = txa.cross_attention_decode_q8_ref(tq, tkq, tks, tvq, tvs)
    assert _rel_err(got.numpy(), plain.numpy()) <= TOL


def test_flash_decoding_merge_is_another_function():
    """Rounding each range's unnormalised weights and rescaling the partial
    outputs afterwards (flash-decoding's merge) computes another function:
    at Ta = 1500 over 16 ranges it lands past TOL from the Pallas kernel,
    which the exact split meets."""
    B, H, Ta, cluster = 2, 4, 1500, 16
    q, k, v = _inputs(Ta, B, H, Ta)
    kq, ks = jxa.quantize_kv_bhdt(jnp.asarray(k))
    vq, vs = jxa.quantize_kv_bhdt(jnp.asarray(v))
    ref = run_strict(jxa.cross_attention_decode_q8dt,
                     jnp.asarray(q).astype(jnp.bfloat16), kq, ks, vq, vs)
    tq = torch.from_numpy(q).to(torch.bfloat16).float()
    tkq, tks, tvq, tvs = (torch.from_numpy(np.array(a)).float()
                          for a in (kq, ks, vq, vs))
    maxes, sums, parts = [], [], []
    for t0, t1 in (txa._key_range(r, cluster, Ta) for r in range(cluster)):
        s = torch.matmul(tq, tkq[..., t0:t1]) * tks[:, :, None, t0:t1] / 8.0
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        w = (e * tvs[:, :, None, t0:t1]).to(torch.bfloat16).float()
        maxes.append(m)
        sums.append(e.sum(-1, keepdim=True))
        parts.append(torch.matmul(w, tvq[..., t0:t1].transpose(-1, -2)))
    m = torch.stack(maxes).amax(0)
    total = sum(s * torch.exp(m_r - m) for s, m_r in zip(sums, maxes))
    merged = sum(p * torch.exp(m_r - m) for p, m_r in zip(parts, maxes))
    assert _rel_err((merged / total).numpy(), ref) > TOL
