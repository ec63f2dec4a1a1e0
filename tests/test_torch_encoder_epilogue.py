"""The encoder block's row-wise epilogues (ops/encoder_epilogue.py) on the
CPU: each plain version is, bit for bit, the torch sequence written out
here (the GEMM in the compute dtype, the bias in f32, one rounding), in
float32 and in bfloat16; the wrappers take their plain versions on the CPU
and launch nothing; and models/whisper.py's one rule (`_kernels`) gives an
encoder block the kernels exactly when its activations are on a card, the
compute dtype is bf16, its matrices are dense and there is no
tensor-parallel mesh (held here with the card test patched and the
wrappers recorded).  The kernels themselves are compared with these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from whisper_tpu_torch.models import whisper as wm  # noqa: E402
from whisper_tpu_torch.ops import encoder_epilogue as ee  # noqa: E402
from whisper_tpu_torch.utils.trace import TRACE  # noqa: E402
from whisper_tpu_torch.weights.convert import random_params  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
KERNELS = ("ln_cast", "bias_cast", "bias_residual_ln", "bias_gelu_cast",
           "bias_residual")
# n_audio_ctx 24, 64 wide, 4 heads, 2 layers
TINY = (128, 24, 64, 4, 2, 32, 64, 4, 2, 80)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _inputs(dtype, rows=37, D=96, seed=0):
    """x f32 rows, a GEMM input a, weights W (the file layout's dtype),
    biases and layernorm weights; a bf16 layernorm scale as a ggml file
    gives it."""
    g = _gen(seed)
    x = torch.randn(rows, D, generator=g) * 3 + 0.5
    a = torch.randn(rows, D, generator=g)
    W = (torch.randn(D, D, generator=g) * 0.1).to(dtype)
    W4 = (torch.randn(4 * D, D, generator=g) * 0.1).to(dtype)
    b = torch.randn(D, generator=g)
    b4 = torch.randn(4 * D, generator=g)
    lw = (1 + 0.1 * torch.randn(D, generator=g)).to(dtype)
    lb = 0.1 * torch.randn(D, generator=g)
    return x, a, W, W4, b, b4, lw, lb


def _eq(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _layernorm(x, w, b):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                        1e-5)


def _linear(a, W, b, cd, out_dtype=torch.float32):
    """a @ W.T in the compute dtype, plus b in f32, rounded once."""
    y = F.linear(a.to(cd), W.to(cd))
    return torch.add(y, b.float(), out=torch.empty(y.shape, dtype=out_dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_version_is_the_blocks_sequence(kernel, dtype):
    """Each `*_ref` against the block's torch sequence written out here,
    fed the same GEMM output; bias_cast_ref also rounds an f32 product
    (K3's, an all-reduce's) to the compute dtype it is given."""
    cd = dtype
    x, a, W, W4, b, b4, lw, lb = _inputs(dtype)
    if kernel == "ln_cast":
        _eq(ee.ln_cast_ref(x, lw, lb, cd), _layernorm(x, lw, lb).to(cd))
    elif kernel == "bias_cast":
        ln = _layernorm(x, lw, lb).to(cd)
        y0, y1 = (F.linear(ln, w.to(cd)) for w in (W, W.T.contiguous()))
        got = ee.bias_cast_ref((y0, b), (y1, b * 2))
        _eq(got[0], _linear(ln, W, b, cd, cd))
        _eq(got[1], _linear(ln, W.T.contiguous(), b * 2, cd, cd))
        y32 = torch.randn(ln.shape, generator=_gen(2))
        got, = ee.bias_cast_ref((y32, b), dtype=cd)
        _eq(got, (y32 + b).to(cd))
    elif kernel == "bias_residual_ln":
        y = F.linear(a.to(cd), W.to(cd))
        x2, ln = ee.bias_residual_ln_ref(x, y, b, lw, lb, cd)
        want = x + _linear(a, W, b, cd)
        _eq(x2, want)
        _eq(ln, _layernorm(want, lw, lb).to(cd))
    elif kernel == "bias_gelu_cast":
        ln = ee.ln_cast_ref(x, lw, lb, cd)
        y = F.linear(ln, W4.to(cd))
        _eq(ee.bias_gelu_cast_ref(y, b4, cd),
            F.gelu(_linear(ln, W4, b4, cd), approximate="tanh").to(cd))
    else:
        h = torch.randn(x.shape[0], 4 * x.shape[1], generator=_gen(1))
        y = F.linear(h.to(cd), W4.T.contiguous().to(cd))
        _eq(ee.bias_residual_ref(x, y, b),
            x + _linear(h, W4.T.contiguous(), b, cd))


def _launches():
    return [getattr(ee, k).launches for k in KERNELS]


def test_wrappers_take_plain_versions_on_cpu_only():
    """CPU tensors run the plain versions and launch nothing; another
    device, or a third (y, b) pair, is refused."""
    n = _launches()
    x, a, W, W4, b, b4, lw, lb = _inputs(torch.bfloat16)
    lw = lw.float()
    y = a.to(torch.bfloat16)
    _eq(ee.ln_cast(x, lw, lb), ee.ln_cast_ref(x, lw, lb))
    for got, want in zip(ee.bias_cast((y, b), (y * 2, b)),
                         ee.bias_cast_ref((y, b), (y * 2, b))):
        _eq(got, want)
    for got, want in zip(ee.bias_residual_ln(x, y, b, lw, lb),
                         ee.bias_residual_ln_ref(x, y, b, lw, lb)):
        _eq(got, want)
    _eq(ee.bias_gelu_cast(y, b), ee.bias_gelu_cast_ref(y, b))
    _eq(ee.bias_residual(x, y, b), ee.bias_residual_ref(x, y, b))
    assert _launches() == n
    meta = x.to("meta")
    with pytest.raises(ValueError):
        ee.ln_cast(meta, lw.to("meta"), lb.to("meta"))
    with pytest.raises(ValueError):
        ee.bias_residual(meta, y.to("meta"), b.to("meta"))
    with pytest.raises(ValueError):
        ee.bias_cast((y, b), (y, b), (y, b))


@pytest.fixture
def block():
    cfg = wm.WhisperConfig(*TINY)
    params = random_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    x = torch.randn(2, cfg.n_audio_ctx, cfg.n_audio_state, generator=_gen(4))
    return params, params["encoder"]["blocks"], x


class _Recorder:
    """The wrappers in models/whisper.py's namespace, each call counted
    and passed on (on the CPU: their plain versions)."""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(KERNELS, 0)
        for name in KERNELS:
            monkeypatch.setattr(wm, name, self._wrap(name))

    def _wrap(self, name):
        fn = getattr(ee, name)

        def rec(*args):
            self.calls[name] += 1
            return fn(*args)
        return rec


class _Mesh:
    """A tensor-parallel axis of one rank: the all-reduce is the identity."""

    @staticmethod
    def all_reduce(t):
        return t


@pytest.mark.parametrize("impl", ["einsum", "pallas", "pallas_btd",
                                  "pallas_pf"])
def test_block_dispatch_rule(block, monkeypatch, impl):
    """The one rule's ops: the kernels exactly on the card (patched), in
    bf16, dense, with no mesh: one call of each wrapper a layer, the same
    bits as the plain sequence; f32 compute, a block-quantized matrix or a
    mesh keep the plain versions, and so does the CPU itself."""
    params, blocks, x = block
    xp = F.pad(x, (0, 0, 0, 8))

    def run(blocks, cd, tp=None):
        ops = wm._ops(wm._kernels(x, blocks, wm._ENCODER_MATRICES, cd, tp,
                                  "encoder_fused"), cd)
        blk = wm._layers(blocks)[0]
        if impl == "einsum" or impl == "pallas":
            return wm._encoder_block(x, blk, 4, cd, ops, impl, tp)
        return wm._PADDED_BLOCKS[impl][0](xp, blk, 4, cd, ops,
                                          t_valid=x.shape[1], tp=tp)

    rec = _Recorder(monkeypatch)
    plain = run(blocks, torch.bfloat16)
    assert sum(rec.calls.values()) == 0               # the CPU
    monkeypatch.setattr(wm, "_on_card", lambda x: True)
    fused = run(blocks, torch.bfloat16)
    assert rec.calls == {"ln_cast": 0 if impl == "pallas_pf" else 1,
                         "bias_cast": 0 if impl == "pallas_pf" else 1,
                         "bias_residual_ln": 1, "bias_gelu_cast": 1,
                         "bias_residual": 1}
    _eq(fused, plain)

    n = dict(rec.calls)
    run(blocks, torch.float32)
    # a block-quantized mlp0 ({"q": (L, K, N) int8 codes, "s": (L, K/32,
    # N)})
    L, D = blocks["q_w"].shape[0], x.shape[-1]
    packed = dict(blocks, mlp0_w={
        "q": torch.randint(-8, 8, (L, D, 4 * D), dtype=torch.int8,
                           generator=_gen(5)),
        "s": torch.full((L, D // 32, 4 * D), 1e-2)})
    run(packed, torch.bfloat16)
    run(blocks, torch.bfloat16, _Mesh())
    assert rec.calls == n


def test_encode_counts_fused_layers(block, monkeypatch):
    """encode() counts `encoder_fused` once a call, its layers, when the
    fused path runs (the card patched), and not on pallas_dt or the CPU;
    the result is the plain sequence's, bit for bit."""
    params, _, x = block
    mel = torch.randn(2, 48, 80, generator=_gen(6))
    plain = wm.encode(params, mel, n_head=4, attn_impl="einsum")
    TRACE.drain()
    TRACE.enable()
    try:
        wm.encode(params, mel, n_head=4, attn_impl="einsum")
        monkeypatch.setattr(wm, "_on_card", lambda x: True)
        fused = wm.encode(params, mel, n_head=4, attn_impl="einsum")
        wm.encode(params, mel, n_head=4, attn_impl="pallas_dt")
    finally:
        TRACE.disable()
        recs = TRACE.drain()
    counts = [r.value for r in recs if r.name == "encoder_fused"]
    assert counts == [2]
    _eq(fused, plain)
