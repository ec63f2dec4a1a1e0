"""cross_kv_quant (ops/cross_attention.py) on the CPU: its plain version is,
bit for bit, the sequence cross_kv_q8 ran without it (`_make_cross_proj`,
then `quantize_kv_bhdt` on K and on V) and whisper_tpu's quantize_kv_bhdt,
on bf16 rows with planted ties and all-zero segments, V's bias, 20 and 10
heads, Ta 1500 and 750; the wrapper takes the plain version on the CPU and
launches nothing; and models/whisper.py's one rule (`_kernels`) gives
cross_kv_q8 the fused path exactly when its input is on a card (patched
here), the compute dtype is bf16, the layout (B, Ta, D), the xk/xv
matrices dense and the heads 64 wide, counting `cross_kv_fused` once a
call.  The kernel itself is compared with the
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from whisper_tpu.ops import cross_attention as jxa  # noqa: E402
from whisper_tpu_torch.models import whisper as wm  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.utils.trace import TRACE  # noqa: E402
from whisper_tpu_torch.weights.convert import random_params  # noqa: E402

BF16 = torch.bfloat16
# a head's 64 channels whose largest magnitude is 127: the scale is then
# 127 * f32(1/127) and the inverse rounds to 1 in bf16, so the products are
# the values themselves and the halves round to even
TIES = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] * 8
TIE_CODES = [127, 0, 2, 2, 0, -2, -2, 126] * 8
SHAPES = [(20, 1500), (20, 750), (10, 1500), (10, 750)]   # (H, Ta)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _rows(B, Ta, H, seed=0):
    """bf16 projection rows k, v (B, Ta, H * 64) at the spread of the
    cross projections' outputs and V's f32 bias, with planted ties (K's
    head 1 and V's head 0 at position 5) and all-zero segments (K's and
    V's head 0 at position 3, K's last head at the last position; V's
    head 0 has no bias)."""
    g = _gen(seed)
    D = H * txa.DH
    k, v = ((torch.randn(B, Ta, D, generator=g) * 2).to(BF16)
            for _ in range(2))
    bias = (torch.randn(D, generator=g) * 0.5).to(BF16).float()
    bias[:64] = 0
    tie = torch.tensor(TIES, dtype=BF16)
    k[:, 5, 64:128] = tie
    v[:, 5, :64] = tie
    k[:, 3, :64] = 0
    v[:, 3, :64] = 0
    k[:, -1, -64:] = 0
    return k, v, bias


def _bhdt(y, H):
    B, Ta, D = y.shape
    return wm._split_heads(y, H).permute(0, 2, 3, 1)


def _eq(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _eq_pairs(got, want):
    for (gq, gs), (wq, ws) in zip(got, want):
        _eq(gq, wq)
        _eq(gs, ws)


@pytest.mark.parametrize("H,Ta", SHAPES)
def test_ref_is_the_quantizer_sequence_and_jax(H, Ta):
    """The plain version against the sequence on the same rows (V's bias
    added in f32 into an f32 tensor, split and permuted, cast to bf16,
    then quantize_kv_bhdt) and against whisper_tpu's quantize_kv_bhdt in
    bf16; the planted ties round half to even and the zero segments
    code to 0 at the 1e-8 floor of the scale."""
    B = 2
    k, v, bias = _rows(B, Ta, H, seed=H + Ta)
    got = txa.cross_kv_quant_ref(k, v, bias, H)
    v32 = torch.add(v, bias, out=torch.empty(v.shape, dtype=torch.float32))
    kb, vb = _bhdt(k, H), _bhdt(v32, H).to(BF16)
    _eq_pairs(got, (txa.quantize_kv_bhdt(kb), txa.quantize_kv_bhdt(vb)))
    for (q, s), x in zip(got, (kb, vb)):
        jq, js = jxa.quantize_kv_bhdt(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    (kq, ks), (vq, vs) = got
    assert kq[:, 1, :, 5].tolist() == [TIE_CODES] * B
    assert vq[:, 0, :, 5].tolist() == [TIE_CODES] * B
    floor = np.float32(1e-8) * np.float32(1 / 127)
    for q, s, h, t in ((kq, ks, 0, 3), (vq, vs, 0, 3), (kq, ks, -1, -1)):
        assert not q[:, h, :, t].any()
        assert s[:, h, t].tolist() == [float(floor)] * B


@pytest.mark.parametrize("H,Ta", [(20, 1500), (10, 750)])
def test_ref_is_make_cross_proj(H, Ta):
    """Fed the GEMM outputs cross_kv_q8's fused path computes, the plain
    version gives the bits of `_make_cross_proj` + `quantize_kv_bhdt`
    (the plain cross_kv_q8), with a nonzero V bias."""
    D = H * txa.DH
    g = _gen(Ta)
    enc = torch.randn(1, Ta, D, generator=g)
    blocks = {"xk_w": (torch.randn(1, D, D, generator=g) * 0.03).to(BF16),
              "xv_w": (torch.randn(1, D, D, generator=g) * 0.03).to(BF16),
              "xv_b": torch.randn(1, D, generator=g) * 0.5}
    params = {"decoder": {"blocks": blocks}}
    kb, vb = wm._make_cross_proj(params, enc, H, BF16, "btd")(
        wm._layers(blocks)[0])
    x = enc.to(BF16)
    got = txa.cross_kv_quant_ref(F.linear(x, blocks["xk_w"][0]),
                                 F.linear(x, blocks["xv_w"][0]),
                                 blocks["xv_b"][0], H)
    _eq_pairs(got, (txa.quantize_kv_bhdt(kb), txa.quantize_kv_bhdt(vb)))


def test_wrapper_takes_the_plain_version_on_cpu_only():
    """CPU tensors run the plain version, into `out` when it is given, and
    launch nothing; another device is refused."""
    n = txa.cross_kv_quant.launches
    B, Ta, H = 2, 37, 3
    k, v, bias = _rows(B, Ta, H)
    want = txa.cross_kv_quant_ref(k, v, bias, H)
    _eq_pairs(txa.cross_kv_quant(k, v, bias, H), want)
    out = (torch.empty(B, H, 64, Ta, dtype=torch.int8),
           torch.empty(B, H, Ta), torch.empty(B, H, 64, Ta, dtype=torch.int8),
           torch.empty(B, H, Ta))
    got = txa.cross_kv_quant(k, v, bias, H, out=out)
    assert all(a is b for a, b in zip((*got[0], *got[1]), out))
    _eq_pairs(got, want)
    assert txa.cross_kv_quant.launches == n
    with pytest.raises(ValueError):
        txa.cross_kv_quant(k.to("meta"), v.to("meta"), bias.to("meta"), H)


# vocab, audio ctx 24 and state 128 with 2 heads of 64, 1 encoder layer;
# text ctx 32, 128 wide, 2 heads, 3 decoder layers; 80 mels
SMALL = (128, 24, 128, 2, 1, 32, 128, 2, 3, 80)


@pytest.mark.parametrize("case", ["cpu", "card", "f32", "bdt", "packed",
                                  "dh32"])
def test_cross_kv_q8_dispatch_rule(case, monkeypatch):
    """cross_kv_q8 counts `cross_kv_fused` (its layers, once a call) and
    gives the plain call's bits when its input is on the card (patched),
    bf16, (B, Ta, D), with dense xk/xv matrices 64 wide a head; on the
    CPU itself, in f32, from the (B, D, Ta) layout, with a block-quantized
    xk or with 32-wide heads it runs the plain sequence and counts
    nothing."""
    cfg = wm.WhisperConfig(*SMALL)
    params = random_params(cfg, seed=3, dtype=BF16, device="cpu")
    blocks = params["decoder"]["blocks"]
    L, D = cfg.n_text_layer, cfg.n_text_state
    blocks["xv_b"] = torch.randn(L, D, generator=_gen(4))
    enc = torch.randn(2, cfg.n_audio_ctx, D, generator=_gen(5))
    n_head, cd, layout = cfg.n_text_head, BF16, "btd"
    if case == "f32":
        cd = torch.float32
    elif case == "bdt":
        enc, layout = enc.transpose(1, 2).contiguous(), "bdt"
    elif case == "packed":
        blocks["xk_w"] = {
            "q": torch.randint(-8, 8, (L, D, D), dtype=torch.int8,
                               generator=_gen(6)),
            "s": torch.full((L, D // 32, D), 1e-2)}
    elif case == "dh32":
        n_head = 4
    plain = wm.cross_kv_q8(params, enc, n_head, cd, layout)
    if case != "cpu":
        monkeypatch.setattr(wm, "_on_card", lambda x: True)
    TRACE.drain()
    TRACE.enable()
    try:
        got = wm.cross_kv_q8(params, enc, n_head, cd, layout)
    finally:
        TRACE.disable()
        recs = TRACE.drain()
    counts = [r.value for r in recs if r.name == "cross_kv_fused"]
    assert counts == ([L] if case == "card" else [])
    _eq_pairs(got, plain)
