"""The decode step's fused layers on the CPU: `self_attn_step_ref`
(ops/decoder_attention.py) is, bit for bit, the torch sequence written out
here (the q/v bias adds, the cache column writes, the mask and
`_cross_attention`), in float32 and in bfloat16; its wrapper takes it on
the CPU and launches nothing; and models/whisper.py's one rule
(`_kernels`) gives `decode_step` the kernels exactly when its activations
are on a card, the compute dtype and the cache are bf16, the matrices are
dense, the widths fit and there is no tensor-parallel mesh (held with the
card test patched and the wrappers recorded), with the same logits and
cache as the plain step.  The kernels themselves are compared with these
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import gc

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from whisper_tpu_torch.models import whisper as wm  # noqa: E402
from whisper_tpu_torch.ops import decoder_attention as da  # noqa: E402
from whisper_tpu_torch.weights.convert import random_params  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
# 64 wide, 4 heads (Dh 16), 3 decoder layers
TINY = (128, 24, 64, 4, 2, 32, 64, 4, 3, 80)
WRAPPERS = ("ln_cast", "bias_cast", "bias_residual_ln", "bias_gelu_cast",
            "self_attn_step")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _eq(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _plain_mask(C, kv_len, pad_len):
    """decode_step's mask as it was written before `step_mask`."""
    idx = torch.arange(C)
    valid = (idx < kv_len)[None, :]
    if pad_len is not None:
        valid = valid & (idx[None, :] >= pad_len[:, None])
    return torch.where(valid, 0.0, float("-inf"))[:, None, None, :]


@pytest.mark.parametrize("kv_len", [1, 7, 12], ids=["first", "mid", "full"])
@pytest.mark.parametrize("padded", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ref_is_the_steps_sequence(dtype, padded, kv_len):
    """The step's torch sequence written out (each GEMM in the compute
    dtype, the q/v biases in f32 with one rounding, the cache writes,
    `_cross_attention` under the mask) against `self_attn_step_ref` on the
    q/k/v GEMMs side by side: output, q, v and both caches.  Handed the
    step's mask, or the GEMMs in f32 with the compute dtype (K3's
    products), it gives the same bits."""
    cd = dtype
    B, H, Dh, C = 3, 4, 16, 12
    D = H * Dh
    g = _gen(kv_len)
    ln = torch.randn(B, 1, D, generator=g).to(cd)
    Ws = [(torch.randn(D, D, generator=g) * 0.2).to(cd) for _ in range(3)]
    q_b, v_b = torch.randn(D, generator=g), torch.randn(D, generator=g)
    caches = [torch.randn(B, H, Dh, C, generator=g).to(cd) for _ in range(2)]
    pad = (torch.tensor([0, 3, 5]).clamp_max(kv_len - 1) if padded
           else None)
    ci = kv_len - 1

    def linear(W, b=None):
        y = F.linear(ln, W)
        if b is not None:
            y = torch.add(y, b, out=torch.empty(y.shape, dtype=cd))
        return wm._split_heads(y, H)

    q, k, v = linear(Ws[0], q_b), linear(Ws[1]), linear(Ws[2], v_b)
    kk, vv = (c.clone() for c in caches)
    kk[:, :, :, ci] = k[:, 0].to(kk.dtype)
    vv[:, :, :, ci] = v[:, 0].to(vv.dtype)
    want = wm._cross_attention(q, kk, vv, cd,
                               mask=_plain_mask(C, kv_len, pad)).to(cd)

    mask = da.step_mask(C, kv_len, pad, "cpu")
    _eq(mask, _plain_mask(C, kv_len, pad))
    products = torch.cat([F.linear(ln[:, 0], W) for W in Ws], dim=-1)
    for qkv, kw in ((products.clone(), {}),
                    (products.clone(), {"mask": mask}),
                    (products.float(), {"dtype": cd})):
        kc, vc = (c.clone() for c in caches)
        got = da.self_attn_step_ref(qkv, q_b, v_b, kc, vc, ci, kv_len, pad,
                                    H, **kw)
        _eq(got, want[:, 0])
        _eq(kc, kk)
        _eq(vc, vv)
        _eq(qkv[:, :D], q.reshape(B, D).to(qkv.dtype))
        _eq(qkv[:, 2 * D:], v.reshape(B, D).to(qkv.dtype))


def test_wrapper_takes_the_plain_version_on_cpu_only():
    """CPU tensors run the plain version and launch nothing; another
    device is refused."""
    n = da.self_attn_step.launches
    B, H, Dh, C = 2, 4, 16, 9
    g = _gen(3)
    qkv = torch.randn(B, 3 * H * Dh, generator=g).to(torch.bfloat16)
    bias = torch.randn(H * Dh, generator=g)
    caches = [torch.randn(B, H, Dh, C, generator=g).to(torch.bfloat16)
              for _ in range(2)]
    pad = torch.tensor([0, 2])
    want = da.self_attn_step_ref(qkv.clone(), bias, bias,
                                 *(c.clone() for c in caches), 4, 5, pad, H)
    _eq(da.self_attn_step(qkv, bias, bias, *caches, 4, 5, pad, H), want)
    assert da.self_attn_step.launches == n
    with pytest.raises(ValueError):
        da.self_attn_step(qkv.to("meta"), bias, bias, *caches, 4, 5, pad, H)


class _Recorder:
    """The wrappers and plain helpers in models/whisper.py's namespace,
    each call counted and passed on (on the CPU: the plain versions)."""

    def __init__(self, monkeypatch, names):
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            monkeypatch.setattr(wm, name, self._wrap(getattr(wm, name), name))

    def _wrap(self, fn, name):
        def rec(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return rec


class _Mesh:
    """A tensor-parallel axis of one rank whose collectives are the
    identity."""
    n_model = 2
    model_rank = 0

    @staticmethod
    def all_reduce(t):
        return t

    @staticmethod
    def all_gather(t, dim):
        return t


@pytest.fixture
def model():
    cfg = wm.WhisperConfig(*TINY)
    params = random_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    return cfg, params


def _cross(form, L, S, H, Dh, Ta=24):
    """The step's stacked cross-KV in `form`: a cross mode of decode/loop.py
    (`loop_cross_kv`) made from one dense (L, S, H, Dh, Ta) pair."""
    from whisper_tpu_torch.decode.loop import loop_cross_kv
    g = _gen(9)
    k, v = (torch.randn(L, S, H, Dh, Ta, generator=g) for _ in range(2))
    mode = {"dense": "einsum", "q8e": "einsum_q8", "q8i": "einsum_q8i",
            "q4e": "einsum_q4", "bhtd": "pallas", "dict": "pallas_q8"}[form]
    return loop_cross_kv(mode, k.to(torch.bfloat16), v.to(torch.bfloat16),
                         torch.bfloat16)


def _step(params, cfg, cross, group, cd=torch.bfloat16, tp=None,
          pad=True):
    """One decode step of 4 rows at cache column 6 of 10 -> (logits, the
    cache it wrote)."""
    L, H = cfg.n_text_layer, cfg.n_text_head
    Dh = cfg.n_text_state // H
    B, C = 4, 10
    g = _gen(11)
    cache = {n: torch.randn(L, B, H, Dh, C, generator=g).to(cd)
             for n in ("k", "v")}
    if tp is not None:
        params = dict(params)
        params = type("Sharded", (dict,), {})(params)
        params.mesh = tp
    logits, cache = wm.decode_step(
        params, torch.tensor([5, 7, 9, 11]), torch.tensor([3, 4, 5, 6]), 6,
        cache, *cross, kv_len=7, n_head=H,
        pad_len=torch.tensor([0, 2, 4, 6]) if pad else None,
        compute_dtype=cd, group=group)
    return logits, cache


@pytest.mark.parametrize("form,group", [
    ("dense", 1), ("q8e", 1), ("q8e", 2), ("q8i", 1), ("q8i", 2),
    ("q4e", 1), ("bhtd", 1), ("dict", 1)])
def test_decode_step_dispatch_rule(model, monkeypatch, form, group):
    """The one rule: fused exactly on the card (patched), in bf16, with
    dense matrices, a bf16 cache and no mesh: each epilogue a layer
    (ln_cast once a step; no bias_cast before the q8i step, which
    quantizes an f32 q) and no `_linear`, `_layernorm` or `_gelu`; the
    same logits and cache, bit for bit, as the plain step, in every cross
    mode.  f32 compute, a
    block-quantized matrix, a mesh, or the CPU itself keep the plain
    sequence."""
    cfg, params = model
    L, H = cfg.n_text_layer, cfg.n_text_head
    cross = _cross(form, L, 4 // group, H, cfg.n_text_state // H)
    rec = _Recorder(monkeypatch, WRAPPERS + ("_linear", "_layernorm",
                                            "_gelu"))
    plain = _step(params, cfg, cross, group)
    assert rec.calls["_linear"] == 8 * L
    assert sum(rec.calls[k] for k in WRAPPERS) == 0      # the CPU
    rec.calls = dict.fromkeys(rec.calls, 0)
    monkeypatch.setattr(wm, "_on_card", lambda x: True)
    fused = _step(params, cfg, cross, group)
    assert rec.calls == {"ln_cast": 1,
                         "bias_cast": 0 if form == "q8i" else L,
                         "bias_residual_ln": 3 * L, "bias_gelu_cast": L,
                         "self_attn_step": L, "_linear": 0, "_layernorm": 0,
                         "_gelu": 0}
    _eq(fused[0], plain[0])
    for n in ("k", "v"):
        _eq(fused[1][n], plain[1][n])

    rec.calls = dict.fromkeys(rec.calls, 0)
    _step(params, cfg, cross, group, cd=torch.float32)
    D = cfg.n_text_state
    blocks = dict(params["decoder"]["blocks"], mlp0_w={
        "q": torch.randint(-8, 8, (L, D, 4 * D), dtype=torch.int8,
                           generator=_gen(5)),
        "s": torch.full((L, D // 32, 4 * D), 1e-2)})
    packed = dict(params, decoder=dict(params["decoder"], blocks=blocks))
    _step(packed, cfg, cross, group)
    if form == "dense":
        _step(params, cfg, cross, group, tp=_Mesh())
    assert sum(rec.calls[k] for k in WRAPPERS) == 0


def test_fused_rule_reads_the_cache_and_widths(model, monkeypatch):
    """The one rule as decode_step asks it (`decoder_fused` counted, its
    layers, when it says kernels): no on the CPU; on the (patched) card
    yes, and no for an f32 cache, a non-contiguous cache, heads wider than
    the kernel takes, f32 compute or a mesh."""
    from whisper_tpu_torch.utils.trace import TRACE
    cfg, params = model
    bf16 = torch.bfloat16

    def kernels(params, cfg, cache_dtype=bf16, cd=bf16, tp=None,
                strided=False):
        L, H = cfg.n_text_layer, cfg.n_text_head
        Dh = cfg.n_text_state // H
        cache = {n: torch.zeros(L, 2, H, Dh, 16, dtype=cache_dtype)
                 for n in ("k", "v")}
        cache = {n: c[..., ::2] if strided else c[..., :8].contiguous()
                 for n, c in cache.items()}
        kc, vc = (torch.randn(L, 2, H, Dh, 24, generator=_gen(i)).to(cd)
                  for i in range(2))
        if tp is not None:
            params = type("Sharded", (dict,), {})(params)
            params.mesh = tp
        TRACE.drain()
        TRACE.enable()
        try:
            wm.decode_step(params, torch.tensor([5, 7]), torch.tensor([3, 4]),
                           4, cache, kc, vc, kv_len=5, n_head=H,
                           pad_len=torch.tensor([0, 2]), compute_dtype=cd)
        finally:
            TRACE.disable()
            recs = TRACE.drain()
        counts = [r.value for r in recs if r.name == "decoder_fused"]
        assert counts in ([], [L])
        return counts == [L]

    assert not kernels(params, cfg)
    monkeypatch.setattr(wm, "_on_card", lambda x: True)
    assert kernels(params, cfg)
    assert not kernels(params, cfg, cd=torch.float32)
    assert not kernels(params, cfg, tp=_Mesh())
    assert not kernels(params, cfg, cache_dtype=torch.float32)
    assert not kernels(params, cfg, strided=True)
    # 256 wide in 2 heads: Dh 128
    wide = wm.WhisperConfig(128, 24, 64, 4, 2, 32, 256, 2, 3, 80)
    assert not kernels(random_params(wide, seed=3, dtype=bf16, device="cpu"),
                       wide)


def test_fused_layers_are_built_once_a_decoder():
    """The layers' weights are cached for the stacked blocks they came
    from: the same list while nothing changes; rebuilt when a block is
    written in place or replaced; gone with the params.  The matrices are
    (in, out) views, q/k/v the three weights stacked, the vectors f32,
    the same names in every layer."""
    cfg = wm.WhisperConfig(*TINY)
    params = random_params(cfg, seed=4, dtype=torch.bfloat16, device="cpu")
    blocks = params["decoder"]["blocks"]
    bf16 = torch.bfloat16
    layers = wm._fused_layers(blocks, bf16)
    assert wm._fused_layers(blocks, bf16) is layers
    assert len(layers) == cfg.n_text_layer
    D = cfg.n_text_state
    _eq(layers[1]["qkv_w"].t(), torch.cat([blocks[k][1] for k in
                                           ("q_w", "k_w", "v_w")]))
    _eq(layers[2]["mlp0_w"].t(), blocks["mlp0_w"][2])
    assert all(blk.keys() == layers[0].keys() for blk in layers)
    assert not {"q_w", "k_w", "v_w"} & layers[0].keys()
    assert all(layers[0][k].dtype == torch.float32 and layers[0][k].shape
               == (D,) for k in ("q_b", "attn_ln_w", "mlp_ln_b"))
    blocks["o_b"].add_(0.0)                 # written in place
    again = wm._fused_layers(blocks, bf16)
    assert again is not layers
    blocks["mlp0_b"] = blocks["mlp0_b"].clone()
    assert wm._fused_layers(blocks, bf16) is not again
    key = id(blocks["q_w"])
    assert key in wm._FUSED_LAYERS
    del params, blocks, layers, again
    gc.collect()
    assert key not in wm._FUSED_LAYERS


@pytest.mark.parametrize("form", ["dense", "tagged", "dict"])
def test_cross_layers_are_the_stacks_layers(form):
    """decode_step's per-step unbind of the cross-KV gives layer l of
    each stacked tensor, in all three forms the step takes."""
    g = _gen(13)
    a, s = torch.randn(3, 2, 4, 8, 5, generator=g), torch.rand(3, 2, 4, 5)
    kc = {"dense": a, "tagged": ("q8e", a, s),
          "dict": {"q": a, "s": s}}[form]
    layers = wm._cross_layers(kc)
    assert len(layers) == 3
    for l, got in enumerate(layers):
        if form == "dense":
            _eq(got, a[l])
        elif form == "dict":
            assert list(got) == ["q", "s"]
            _eq(got["q"], a[l])
            _eq(got["s"], s[l])
        else:
            assert got[0] == "q8e"
            _eq(got[1], a[l])
            _eq(got[2], s[l])
