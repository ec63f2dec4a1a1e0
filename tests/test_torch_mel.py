"""K7's plain version and `log_mel_pallas` against whisper_tpu's Pallas
log-mel, run in interpret mode on the CPU, on the same seeded noise: atol
5e-4, the bound whisper_tpu's own Pallas mel test holds against numpy
(tests/test_pallas_ops.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from whisper_tpu.audio.filters import mel_filterbank  # noqa: E402
from whisper_tpu.audio.mel import pad_audio  # noqa: E402
from whisper_tpu.ops import mel_pallas as jmp  # noqa: E402
from whisper_tpu_torch.ops import mel_pallas as tmp  # noqa: E402


def _padded(seconds, seed):
    pcm = (np.random.RandomState(seed).randn(16000 * seconds) * 0.1).astype(
        np.float32)
    return pad_audio(pcm)[0]


@pytest.mark.parametrize("seconds", [4, 35])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_pallas_matches_jax(seconds, n_mels):
    """Frames rounded down to a multiple of 256, the max-8 clamp and
    (x+4)/4 over those frames only, as whisper_tpu computes them."""
    padded = _padded(seconds, seconds)
    filters = mel_filterbank(n_mels).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmp.log_mel_pallas(jnp.asarray(padded), filters))
    got = tmp.log_mel_pallas(torch.from_numpy(padded), filters)
    assert got.dtype == torch.float32
    n_len = (len(padded) - 400) // 160
    assert got.shape == ref.shape == (n_len // 256 * 256, n_mels)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=0)


def test_mel_blocks_plain_matches_pallas_kernel():
    """The plain version against the Pallas kernel on the same row views,
    before the epilogue: float32 against float32, rounding order only."""
    padded = _padded(4, 1)
    filters = mel_filterbank(128).astype(np.float32)
    args = tmp.mel_block_inputs(torch.from_numpy(padded), filters)
    n = args[0].shape[0]
    with pltpu.force_tpu_interpret_mode():
        ref = jmp._mel_blocks(*(jnp.asarray(a.numpy()) for a in args),
                              n_len=n)
    got = tmp._mel_blocks(*args)
    assert tuple(got.shape) == ref.shape == (n, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=0)
    rows = torch.from_numpy(padded)[:(n + 2) * 160].reshape(n + 2, 160)
    assert args[1].data_ptr() == rows[1].data_ptr()   # views, no copies
    assert args[2].stride() == (160, 1)


def test_mel_blocks_routes_and_refuses():
    """CPU tensors run the plain version and launch nothing; another device
    is refused."""
    n = tmp._mel_blocks.launches
    args = tmp.mel_block_inputs(torch.from_numpy(_padded(1, 2)),
                                mel_filterbank(80))
    tmp._mel_blocks(*args)
    assert tmp._mel_blocks.launches == n
    with pytest.raises(ValueError):
        tmp._mel_blocks(*(a.to("meta") for a in args))


@pytest.mark.parametrize("n", [1, 35, 36, 37, 100, 3072, 8960])
def test_k7_grid_covers_frames(n):
    """K7's grid: CTAs of 36 frames, the last one ragged, covering every
    frame exactly once; 60 s (8,960 frames) fills the H100's 264 slots of
    two CTAs an SM in one wave (32 frames a CTA would leave a second wave
    of 16)."""
    ranges = tmp._k7_frame_ranges(n)
    assert tmp.K7_FRAMES == 36
    assert len(ranges) == -(-n // 36)
    covered = [f for begin, end in ranges for f in range(begin, end)]
    assert covered == list(range(n))
    assert all(0 < end - begin <= 36 for begin, end in ranges)
    if n == 8960:
        assert 0.9 * 2 * 132 <= len(ranges) <= 2 * 132
