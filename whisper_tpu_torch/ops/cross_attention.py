"""Single-query cross-attention kernels and the per-position int8
quantizer of their K/V.

K2 replaces whisper_tpu/ops/cross_attention.py
`cross_attention_decode_q8dt` / `_xattn_kernel_q8dt`: per (batch, head),
logits = (q . k_q) * k_s * Dh^-1/2, an f32 softmax, weights w * v_s
rounded to bf16, and their sum against v_q, on the (B, H, Dh, Ta) int8
layout of `cross_kv_q8`.  With a bf16 query this is the function of the
serving path's "q8e" einsum (whisper_tpu/models/whisper.py
`_cross_attn_step`) too, and K2 takes that einsum's G queries a (b, h)
(1 <= G <= MAX_QUERIES): batched beam search puts a stream's K beams on
its one cross-KV row, and K2 reads that row once for all of them.  K4
and K5 work on the (B, H, Ta, Dh) layout of cross modes "pallas" and
"pallas_q8", where Dh is contiguous: K4 replaces
`cross_attention_decode` / `_xattn_kernel` (bf16 K/V), K5
`cross_attention_decode_q8` / `_xattn_kernel_q8` (int8 K/V, (B, H, Ta, 1)
scales, K2's function).  As in those TPU kernels, the query and K/V are
rounded to bf16 inside the kernel whatever the compute dtype, and so are
the softmax weights (times the V scale, for K2 and K5) before the product
with V.

What bounds them on the H100: each decode step reads the whole cross-KV
of every layer, 2 * H * Dh * Ta elements per (batch row, layer), ~3.8 MB
per row per layer at large-v3 in int8, for 2 FLOP an element: memory
bound, three orders of magnitude under the compute ridge.  All three
(csrc/cross_attention.cu) put each (b, h) on a thread-block cluster of
CTAs that split Ta into ranges of whole 16-key chunks, at most one CTA
per 64 keys (`_cluster_size`, `_key_range`), keep the range's logits in
shared memory, agree on the softmax's global max and sum through
distributed shared memory before any weight is rounded, and add their
partial outputs in rank 0 in rank order.  K4 and K5 bring a range's K and
V into shared memory by 1-D TMA, in one copy each (up to 16 KB: 128 keys
of bf16, 256 of int8) or through a 4-stage ring of such tiles
(`_xattn_plan`).  K2 reads its d-rows, Ta bytes apart, a 32-bit word of 4
keys a thread, or byte by byte where Ta % 4 != 0 or the codes are not
4-byte aligned (`_q8dt_words`).  No bf16 copy of K/V and no score tensor
ever reaches device memory.
"""

from __future__ import annotations

import functools

import torch

DH = 64   # every Whisper model; K4 and K5 are written for it
MAX_DH = 128          # K2 takes head dims up to this
MAX_QUERIES = 8       # and up to this many queries a (b, h) (MAX_DECODERS)
Q8DT_SMEM = 200 * 1024   # K2's dynamic shared memory, at most
MAX_TA = 16384        # K2/K4/K5 keep the (Ta,) logits in shared memory
KEY_CHUNK = 16        # a CTA's key range is whole chunks of this many keys
MIN_KEYS = 64         # and at least this many keys
MAX_CLUSTER = 16      # CTAs in a cluster (non-portable above 8)
TARGET_CTAS = 264     # two CTAs per SM of the H100's 132
ONE_SHOT_KEYS = 128   # a K4 range up to this lands in one copy each for K, V
RING_KEYS = 128       # a longer one streams through a ring of this many keys
RING_STAGES = 4       # in this many stages (64 KB); K5 takes twice the keys


def _quantize(k: torch.Tensor, axis: int, lo: int, hi: int):
    """The one per-position K/V quantizer: codes round(k / scale) clipped to
    [lo, hi], still in k's dtype, and f32 scales max(amax, 1e-8) / hi with
    `axis` kept as 1, amax taken over the channel axis `axis`.  Arithmetic
    stays in the input dtype; torch.round rounds half to even, like
    jnp.round.

    The scale is x * f32(1/hi), not x / hi: XLA rewrites the reference's
    division by a constant into this product, and the scales must match bit
    for bit (a true divide matches XLA's scales 96% of the time at hi = 127,
    46% at hi = 7)."""
    amax = torch.amax(torch.abs(k), dim=axis, keepdim=True).float()
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / hi)
    inv = (1.0 / scale).to(k.dtype)
    return torch.clamp(torch.round(k * inv), lo, hi), scale


def quantize_kv(k: torch.Tensor):
    """(..., Ta, Dh) -> (int8 codes, same layout; (..., Ta, 1) f32
    per-position scales), as whisper_tpu's quantize_kv."""
    q, scale = _quantize(k, -1, -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_bhdt(k: torch.Tensor):
    """(..., H, Dh, Ta) -> (int8 codes, same layout; (..., H, Ta) f32
    per-(head, position) scales), as whisper_tpu's quantize_kv_bhdt."""
    q, scale = _quantize(k, -2, -127, 127)
    return q.to(torch.int8), scale[..., 0, :]


def quantize_kv_bhdt_q4(k: torch.Tensor):
    """(..., H, Dh, Ta) -> (uint8 (..., H, Dh/2, Ta) nibble-packed codes;
    (..., H, Ta) f32 scales), as whisper_tpu's quantize_kv_bhdt_q4: codes
    in [-8, 7] stored offset-binary (+8), even channels in the low nibble,
    odd ones in the high."""
    q, scale = _quantize(k, -2, -8, 7)
    q = (q.to(torch.int8) + 8).to(torch.uint8)
    return q[..., 0::2, :] | (q[..., 1::2, :] << 4), scale[..., 0, :]


def unpack_q4_bhdt(packed: torch.Tensor, dtype=torch.bfloat16):
    """Inverse of quantize_kv_bhdt_q4's packing, codes only (unscaled):
    (..., H, Dh/2, Ta) uint8 -> (..., H, Dh, Ta) in `dtype`, in [-8, 7]."""
    lo = ((packed & 0xF).to(torch.int8) - 8).to(dtype)
    hi = ((packed >> 4).to(torch.int8) - 8).to(dtype)
    stacked = torch.stack([lo, hi], dim=-2)         # (..., Dh/2, 2, Ta)
    return stacked.reshape(packed.shape[:-2] + (2 * packed.shape[-2],
                                                packed.shape[-1]))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16, computed on as f32."""
    return t.to(torch.bfloat16).float()


def cross_attention_decode_q8dt_ref(q, k_q, k_s, v_q, v_s):
    """Plain PyTorch version of K2, in f32 with the TPU kernel's one bf16
    rounding: q (B, H, G, Dh) as given (bf16 for K2); k_q/v_q (B, H, Dh,
    Ta) int8; k_s/v_s (B, H, Ta) f32 -> (B, H, G, Dh) f32.  The softmax
    weights times the V scale are rounded to bf16, whatever q's dtype."""
    dh = q.shape[-1]
    qk = torch.matmul(q.float(), k_q.float())              # (B, H, G, Ta)
    qk = qk * k_s[:, :, None, :] * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    wv = _bf16(w * v_s[:, :, None, :])
    return torch.matmul(wv, v_q.float().transpose(-1, -2))


def cross_attention_decode_q8dt(q, k_q, k_s, v_q, v_s):
    """q (B, H, G, Dh) bf16; k_q/v_q (B, H, Dh, Ta) int8; k_s/v_s
    (B, H, Ta) f32 -> (B, H, G, Dh) f32: G queries against each (b, h)'s
    K/V, 1 <= G <= MAX_QUERIES.

    CPU tensors take the plain version; CUDA tensors go through K2, which
    takes a bfloat16 query only, Dh up to MAX_DH and Ta up to MAX_TA.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_q8dt_ref(q, k_q, k_s, v_q, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_decode_q8dt: unsupported device "
                         f"{q.device}")
    B, H, G, Dh = q.shape
    Ta = k_q.shape[-1]
    expect = {
        "q": (q, (B, H, G, Dh), torch.bfloat16),
        "k_q": (k_q, (B, H, Dh, Ta), torch.int8),
        "k_s": (k_s, (B, H, Ta), torch.float32),
        "v_q": (v_q, (B, H, Dh, Ta), torch.int8),
        "v_s": (v_s, (B, H, Ta), torch.float32),
    }
    for name, (x, shape, dtype) in expect.items():
        if x.shape != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(
                f"cross_attention_decode_q8dt: {name} is "
                f"{tuple(x.shape)} {x.dtype} on {x.device}, expected "
                f"{shape} {dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"cross_attention_decode_q8dt: {name} must be "
                             "contiguous")
    if (not 1 <= G <= MAX_QUERIES or not 1 <= Ta <= MAX_TA
            or not 1 <= Dh <= MAX_DH):
        raise ValueError(f"K2 takes 1 <= G <= {MAX_QUERIES} queries a "
                         f"(b, h), 1 <= Ta <= {MAX_TA} and 1 <= Dh <= "
                         f"{MAX_DH} (got G={G}, Ta={Ta}, Dh={Dh})")
    from ._build import library
    out = torch.empty((B, H, G, Dh), dtype=torch.float32, device=q.device)
    library().call("wtt_cross_attention_q8", q.data_ptr(), k_q.data_ptr(),
                   k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                   out.data_ptr(), B, H, G, Dh, Ta,
                   _q8dt_cluster(B * H, Ta, G, Dh),
                   int(_q8dt_words(Ta, k_q.data_ptr(), v_q.data_ptr())),
                   torch.cuda.current_stream(q.device).cuda_stream)
    cross_attention_decode_q8dt.launches += 1
    if G > 1:
        cross_attention_decode_q8dt.launches_grouped += 1
    return out


cross_attention_decode_q8dt.launches = 0
cross_attention_decode_q8dt.launches_grouped = 0   # of them with G > 1


def cross_attention_decode_ref(q, k_t, v_t):
    """Plain PyTorch version of K4, in f32 from bf16-rounded operands:
    q (B, H, 1, Dh); k_t/v_t (B, H, Ta, Dh) -> (B, H, 1, Dh) f32."""
    dh = q.shape[-1]
    qk = torch.matmul(_bf16(q), _bf16(k_t).transpose(-1, -2)) * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    return torch.matmul(_bf16(w), _bf16(v_t))


def cross_attention_decode_q8_ref(q, k_q, k_s, v_q, v_s):
    """Plain PyTorch version of K5: q (B, H, 1, Dh); k_q/v_q (B, H, Ta, Dh)
    int8; k_s/v_s (B, H, Ta, 1) f32 -> (B, H, 1, Dh) f32."""
    dh = q.shape[-1]
    qk = torch.matmul(_bf16(q), k_q.float().transpose(-1, -2))
    qk = qk * k_s[..., 0][:, :, None, :] * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    wv = _bf16(w * v_s[..., 0][:, :, None, :])
    return torch.matmul(wv, v_q.float())


def _check(fn_name, q, tensors):
    """Shape, dtype, device, contiguity and alignment of every operand of
    K4/K5 (name -> (tensor, shape, dtype, alignment in bytes: 16 where the
    kernel reads 8 elements at once, 4 for the per-position scales));
    q must be (B, H, 1, DH) bf16."""
    B, H, one, Dh = q.shape
    if one != 1 or Dh != DH:
        raise ValueError(f"{fn_name}: q must be (B, H, 1, {DH}), got "
                         f"{tuple(q.shape)}")
    for name, (x, shape, dtype, align) in tensors.items():
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != q.device):
            raise ValueError(
                f"{fn_name}: {name} is {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, expected {shape} {dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % align:
            raise ValueError(f"{fn_name}: {name} must be contiguous and "
                             f"{align}-byte aligned")


def _cluster_size(bh: int, ta: int) -> int:
    """CTAs a (b, h) for B*H = bh and Ta = ta, in K2, K4 and K5: the
    smallest power of two that brings the grid (bh x C CTAs) to
    TARGET_CTAS, at most MAX_CLUSTER and at most one CTA per MIN_KEYS keys
    (so C = 1 at Ta <= 64)."""
    c = 1
    while 2 * c <= min(MAX_CLUSTER, -(-ta // MIN_KEYS)) and bh * c < TARGET_CTAS:
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def _xattn_plan(bh: int, ta: int, elem: int = 2) -> tuple[int, int, int]:
    """K4's (elem = 2, bf16) or K5's (elem = 1, int8) grid for B*H = bh and
    Ta = ta: (cluster size C, keys a K/V tile, stages).  The longest range
    lands in one copy each for K and V (two stages) when it has at most
    ONE_SHOT_KEYS keys (times 2 / elem: 16 KB either way); a longer one
    streams through RING_STAGES stages of RING_KEYS (times 2 / elem), so a
    CTA's shared memory stays small and the whole grid is resident at
    once."""
    c = _cluster_size(bh, ta)
    chunks = -(-ta // KEY_CHUNK)
    longest = min(-(-chunks // c) * KEY_CHUNK, ta)
    if longest <= ONE_SHOT_KEYS * 2 // elem:
        return c, longest, 2
    return c, RING_KEYS * 2 // elem, RING_STAGES


def _q8dt_smem(cluster: int, ta: int, g: int, dh: int) -> int:
    """K2's dynamic shared memory in bytes (csrc `q8dt_smem_floats`): the
    longest range's K scales, V scales and G rows of logits, then a region
    for pass 1's partial dots (G x 1024 floats) that rank 0 reuses for the
    cluster's partial outputs (cluster x G x Dh)."""
    chunks = -(-ta // KEY_CHUNK)
    cap4 = -(-min(-(-chunks // cluster) * KEY_CHUNK, ta) // 4) * 4
    return 4 * ((g + 2) * cap4 + max(g * 1024, cluster * g * dh))


def _q8dt_cluster(bh: int, ta: int, g: int, dh: int) -> int:
    """K2's cluster size.  One query: `_cluster_size`.  G > 1: the largest
    power of two (at most MAX_CLUSTER, one CTA per MIN_KEYS keys) that
    keeps the grid within TARGET_CTAS, since K2 at G > 1 holds its G sums
    in up to 128 registers a thread, two CTAs an SM: a grid past that runs
    in two waves (clusters of 16 for 20 heads at G = 5 read 3x the time of
    one query).  Then doubled (within the limits) until the longest
    range's G rows of logits fit in Q8DT_SMEM."""
    most = min(MAX_CLUSTER, -(-ta // MIN_KEYS))
    if g == 1:
        c = _cluster_size(bh, ta)
    else:
        c = 1
        while 2 * c <= most and bh * 2 * c <= TARGET_CTAS:
            c *= 2
    while _q8dt_smem(c, ta, g, dh) > Q8DT_SMEM and 2 * c <= most:
        c *= 2
    if _q8dt_smem(c, ta, g, dh) > Q8DT_SMEM:
        raise ValueError(f"K2: Ta={ta} with G={g} queries does not fit in "
                         f"shared memory")
    return c


def _q8dt_words(ta: int, k_ptr: int, v_ptr: int) -> bool:
    """Whether K2 reads its codes a 32-bit word (4 keys) at a time: every
    d-row of k_q and v_q (Ta bytes apart) and every range in it (whole
    16-key chunks) then starts 4-byte aligned.  Else byte by byte."""
    return ta % 4 == 0 and k_ptr % 4 == 0 and v_ptr % 4 == 0


def _key_range(rank: int, cluster: int, ta: int) -> tuple[int, int]:
    """The keys [t0, t1) that CTA `rank` of a K2/K4/K5 cluster takes (the
    kernels compute the same)."""
    chunks = -(-ta // KEY_CHUNK)
    return (rank * chunks // cluster * KEY_CHUNK,
            min((rank + 1) * chunks // cluster * KEY_CHUNK, ta))


def cross_attention_decode(q, k_t, v_t):
    """q (B, H, 1, Dh); k_t/v_t (B, H, Ta, Dh) -> (B, H, 1, Dh) f32.

    CPU tensors take the plain version; CUDA tensors go through K4, which
    takes bfloat16 q and K/V only (the roundings the TPU kernel makes) and
    Ta up to MAX_TA."""
    if q.device.type == "cpu":
        return cross_attention_decode_ref(q, k_t, v_t)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_decode: unsupported device "
                         f"{q.device}")
    B, H, _, Dh = q.shape
    Ta = k_t.shape[2]
    kv = (B, H, Ta, Dh)
    _check("cross_attention_decode", q, {
        "q": (q, (B, H, 1, Dh), torch.bfloat16, 16),
        "k_t": (k_t, kv, torch.bfloat16, 16),
        "v_t": (v_t, kv, torch.bfloat16, 16)})
    if not 1 <= Ta <= MAX_TA:
        raise ValueError(f"cross_attention_decode: K4 takes 1 <= Ta <= "
                         f"{MAX_TA}, got {Ta}")
    from ._build import library
    out = torch.empty((B, H, 1, Dh), dtype=torch.float32, device=q.device)
    library().call("wtt_cross_attention", q.data_ptr(), k_t.data_ptr(),
                   v_t.data_ptr(), out.data_ptr(), B, H, Dh, Ta,
                   *_xattn_plan(B * H, Ta),
                   torch.cuda.current_stream(q.device).cuda_stream)
    cross_attention_decode.launches += 1
    return out


cross_attention_decode.launches = 0


def cross_attention_decode_q8(q, k_q, k_s, v_q, v_s):
    """q (B, H, 1, Dh); k_q/v_q (B, H, Ta, Dh) int8; k_s/v_s (B, H, Ta, 1)
    f32 -> (B, H, 1, Dh) f32.

    CPU tensors take the plain version; CUDA tensors go through K5, which
    takes a bfloat16 query only and Ta up to MAX_TA."""
    if q.device.type == "cpu":
        return cross_attention_decode_q8_ref(q, k_q, k_s, v_q, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_decode_q8: unsupported device "
                         f"{q.device}")
    B, H, _, Dh = q.shape
    Ta = k_q.shape[2]
    codes, scales = (B, H, Ta, Dh), (B, H, Ta, 1)
    _check("cross_attention_decode_q8", q, {
        "q": (q, (B, H, 1, Dh), torch.bfloat16, 16),
        "k_q": (k_q, codes, torch.int8, 16),
        "k_s": (k_s, scales, torch.float32, 4),
        "v_q": (v_q, codes, torch.int8, 16),
        "v_s": (v_s, scales, torch.float32, 4)})
    if not 1 <= Ta <= MAX_TA:
        raise ValueError(f"cross_attention_decode_q8: K5 takes 1 <= Ta <= "
                         f"{MAX_TA}, got {Ta}")
    from ._build import library
    out = torch.empty((B, H, 1, Dh), dtype=torch.float32, device=q.device)
    library().call("wtt_cross_attention_bhtd_q8", q.data_ptr(),
                   k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
                   v_s.data_ptr(), out.data_ptr(), B, H, Dh, Ta,
                   *_xattn_plan(B * H, Ta, 1),
                   torch.cuda.current_stream(q.device).cuda_stream)
    cross_attention_decode_q8.launches += 1
    return out


cross_attention_decode_q8.launches = 0
