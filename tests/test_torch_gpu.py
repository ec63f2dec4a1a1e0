"""Kernels K1 and K2 on the card against their plain PyTorch versions, and
the serving slice on the card through both.  Every test here needs CUDA and
skips without it.  The card has no JAX and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from whisper_tpu_torch import (BatchTranscriber, WhisperContext,  # noqa: E402
                               full_default_params)
from whisper_tpu_torch.ops import cross_attention as xa  # noqa: E402
from whisper_tpu_torch.ops import encoder_attention as ea  # noqa: E402

pytestmark = pytest.mark.gpu

# bf16 operands on both sides, rounded at different points: the bound the
# Pallas tests use
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", [(2, 200, 4, 64), (1, 1500, 20, 64),
                                   (1, 17, 1, 64)])
def test_k1_matches_plain_on_card(gen, shape):
    """T of 200 and 17 leave a ragged last tile; 1500 is the encoder's."""
    q, k, v = ((torch.randn(shape, generator=gen, device="cuda") * 0.3)
               .to(torch.bfloat16) for _ in range(3))
    n = ea.self_attention.launches
    got = ea.self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ea.self_attention.launches == n + 1
    B, T, H, Dh = shape
    assert got.shape == (B, T, H * Dh) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel_err(got, ea.self_attention_ref(q, k, v)) <= TOL


@pytest.mark.parametrize("shape", [(2, 4, 64, 256), (4, 20, 64, 1500),
                                   (1, 2, 64, 37)])
def test_k2_matches_plain_on_card(gen, shape):
    """Identical int8 codes into both; Ta=37 is not a multiple of a warp."""
    B, H, Dh, Ta = shape
    q = (torch.randn(B, H, 1, Dh, generator=gen, device="cuda") * 0.3
         ).to(torch.bfloat16)
    kq, ks = xa.quantize_kv_bhdt(
        torch.randn(shape, generator=gen, device="cuda") * 0.3)
    vq, vs = xa.quantize_kv_bhdt(
        torch.randn(shape, generator=gen, device="cuda") * 0.3)
    n = xa.cross_attention_decode_q8dt.launches
    got = xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode_q8dt.launches == n + 1
    assert got.shape == (B, H, 1, Dh) and got.dtype == torch.float32
    ref = xa.cross_attention_decode_q8dt_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    """On the card nothing is cast quietly or sent to the plain version."""
    x = torch.randn(1, 64, 2, 64, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        ea.self_attention(x, x, x, compute_dtype=torch.float32)
    with pytest.raises(ValueError):
        ea.self_attention(*(torch.zeros(1, 64, 2, 32, device="cuda",
                                        dtype=torch.bfloat16),) * 3)
    q = torch.zeros(1, 2, 1, 64, device="cuda", dtype=torch.bfloat16)
    codes = torch.zeros(1, 2, 64, 8, dtype=torch.int8, device="cuda")
    scales = torch.ones(1, 2, 8, device="cuda")
    with pytest.raises(ValueError):
        xa.cross_attention_decode_q8dt(q.float(), codes, scales, codes,
                                       scales)
    with pytest.raises(ValueError):
        xa.cross_attention_decode_q8dt(q, codes.transpose(-1, -2).contiguous()
                                       .transpose(-1, -2), scales, codes,
                                       scales)


def test_batch_transcriber_on_card_runs_both_kernels(gen):
    """The slice at small widths (head dim 64, as K1 requires) in bf16."""
    dims = (51864, 32, 128, 2, 2, 48, 128, 2, 2, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=1, device="cuda")
    p = full_default_params()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    bt = BatchTranscriber(ctx, batch_size=2, params=p, device_mel=True)
    rng = np.random.RandomState(0)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (5, 9)]
    ea.self_attention.launches = 0
    xa.cross_attention_decode_q8dt.launches = 0
    result = bt.transcribe(streams)
    torch.cuda.synchronize()
    assert ea.self_attention.launches > 0
    assert xa.cross_attention_decode_q8dt.launches > 0
    for segs in result:
        assert segs
        assert np.isfinite([t.p for s in segs for t in s.tokens]).all()
