"""Plain versions of kernels K1 and K2 (and the int8 quantizer) against
whisper_tpu's Pallas kernels, run in interpret mode on the CPU, on the
same numpy inputs.  The CUDA kernels themselves are compared with these
plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from whisper_tpu.ops import cross_attention as jxa  # noqa: E402
from whisper_tpu.ops import encoder_attention as jea  # noqa: E402
from whisper_tpu_torch.ops import _build  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.ops import encoder_attention as tea  # noqa: E402


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


# K1 at T=200: deliberately not a multiple of the TPU kernel's 256 block.
# bf16: both sides round operands and weights to bf16 at different points
# (2e-2, the Pallas tests' bound); f32: float rounding only (1e-5).
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_k1_plain_matches_pallas(dtype, tol):
    rng = np.random.RandomState(3)
    B, T, H, Dh = 2, 200, 4, 64
    q, k, v = (rng.randn(B, T, H, Dh).astype(np.float32) * 0.3
               for _ in range(3))
    ref = jea.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             compute_dtype=getattr(jnp, dtype),
                             interpret=True)
    got = tea.self_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (B, T, H * Dh)
    assert _rel_err(got.numpy(), ref) <= tol


def _q8_inputs():
    rng = np.random.RandomState(4)
    B, H, Dh, Ta = 2, 4, 64, 256
    q = rng.randn(B, H, 1, Dh).astype(np.float32) * 0.3
    k = rng.randn(B, H, Dh, Ta).astype(np.float32) * 0.3
    v = rng.randn(B, H, Dh, Ta).astype(np.float32) * 0.3
    return q, k, v


def test_k2_plain_matches_pallas():
    """Identical int8 codes and scales into both; bf16 query.  Bound 2e-2:
    the two sum in different orders and round the weights to bf16."""
    q, k, v = _q8_inputs()
    kq, ks = jxa.quantize_kv_bhdt(jnp.asarray(k))
    vq, vs = jxa.quantize_kv_bhdt(jnp.asarray(v))
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jxa.cross_attention_decode_q8dt(qb, kq, ks, vq, vs)
    t = [torch.from_numpy(np.array(x)) for x in (kq, ks, vq, vs)]
    got = txa.cross_attention_decode_q8dt(
        torch.from_numpy(q).to(torch.bfloat16), *t)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 1, 64)
    assert _rel_err(got.numpy(), ref) <= 2e-2


@pytest.mark.parametrize("layout", ["bhdt", "lbhdt"])
def test_quantize_kv_bhdt_identical_f32(layout):
    _, k, _ = _q8_inputs()
    if layout == "lbhdt":
        k = np.stack([k, 2.0 * k, k[::-1]])          # a leading L axis
    k[..., :, 5] = 0.0                               # an all-zero column
    kq, ks = jxa.quantize_kv_bhdt(jnp.asarray(k))
    tq, ts = txa.quantize_kv_bhdt(torch.from_numpy(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(kq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ks))


def test_quantize_rounds_half_to_even():
    """torch.round, like jnp.round, rounds .5 to even."""
    # amax 127 -> scale 1, so codes are round(x) directly
    k = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.49], np.float32)
    k = k.reshape(1, 7, 1)                            # (H, Dh, Ta)
    tq, _ = txa.quantize_kv_bhdt(torch.from_numpy(k))
    jq, _ = jxa.quantize_kv_bhdt(jnp.asarray(k))
    assert tq.flatten().tolist() == [127, 0, 2, 2, 0, -2, 3]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_wrappers_use_plain_version_on_cpu_only():
    """CPU tensors run the plain version and launch nothing; another
    device is refused rather than sent down any other path."""
    n1 = tea.self_attention.launches
    n2 = txa.cross_attention_decode_q8dt.launches
    q = torch.zeros(1, 8, 2, 64)
    tea.self_attention(q, q, q)
    qb = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16)
    codes = torch.zeros(1, 2, 64, 8, dtype=torch.int8)
    scales = torch.ones(1, 2, 8)
    txa.cross_attention_decode_q8dt(qb, codes, scales, codes, scales)
    assert tea.self_attention.launches == n1
    assert txa.cross_attention_decode_q8dt.launches == n2
    with pytest.raises(ValueError):
        tea.self_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError):
        txa.cross_attention_decode_q8dt(qb.to("meta"), codes, scales, codes,
                                        scales)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
    finally:
        _build.library.cache_clear()
