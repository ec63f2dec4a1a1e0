"""Log-mel spectrogram frontend (port of whisper_tpu.audio.mel).

`pad_audio` is a numpy copy of the original.  `log_mel_spectrogram_torch`
is the port of `log_mel_spectrogram_jax`: framing as a strided view, the
real DFT as two (400, 201) matmuls, the filterbank as one more, all in
full float32 — the result feeds log10 and a global-max clamp, so TF32
would visibly corrupt quiet mel bins.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import CHUNK_SIZE, HOP_LENGTH, N_FFT, SAMPLE_RATE


def full_f32_matmuls() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.
    TF32 keeps ~3 decimal digits: too few for the mel (log10 of quiet
    bins) and for the float32 parity runs against the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=1)
def hann_window_periodic(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann, computed in f32 like the reference
    (reference: src/whisper.cpp:3034-3043)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


def pad_audio(samples: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Stage-1/2 padding (reference: src/whisper.cpp:3199-3219).

    Returns (padded, n_len, n_len_org):
      n_len     — total frames in the padded spectrogram
      n_len_org — frames covering the real audio (drives seek_end)
    int16 input stays int16 (the batched device-mel path keeps s16 PCM
    packed until after the on-device window slice); everything else is f32.
    """
    n_samples = len(samples)
    stage_1_pad = SAMPLE_RATE * CHUNK_SIZE      # 480000
    stage_2_pad = N_FFT // 2                    # 200

    dtype = np.int16 if samples.dtype == np.int16 else np.float32
    padded = np.zeros(n_samples + stage_1_pad + 2 * stage_2_pad, dtype=dtype)
    padded[stage_2_pad:stage_2_pad + n_samples] = samples
    # reflective pad at the beginning: samples[1..200] reversed
    padded[:stage_2_pad] = samples[1:1 + stage_2_pad][::-1]

    n_len = (len(padded) - N_FFT) // HOP_LENGTH
    n_len_org = 1 + (n_samples + stage_2_pad - N_FFT) // HOP_LENGTH
    return padded, n_len, n_len_org


@functools.lru_cache(maxsize=1)
def _dft_basis() -> tuple[np.ndarray, np.ndarray]:
    n = np.arange(N_FFT, dtype=np.float64)[:, None]
    k = np.arange(N_FFT // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def log_mel_spectrogram_torch(samples: torch.Tensor,
                              filters: torch.Tensor) -> torch.Tensor:
    """(..., S) f32 padded signal (pad_audio layout) -> (..., n_len, n_mel).

    n_len = (S - N_FFT) // HOP_LENGTH, as in log_mel_spectrogram_jax; the
    log-mel max normalization is taken over each leading index's
    (n_len, n_mel) block.
    """
    full_f32_matmuls()
    dev = samples.device
    n_len = (samples.shape[-1] - N_FFT) // HOP_LENGTH
    window = torch.from_numpy(hann_window_periodic()).to(dev)
    frames = samples.unfold(-1, N_FFT, HOP_LENGTH)[..., :n_len, :] * window

    cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_basis())
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im

    mel = power @ filters.to(device=dev, dtype=torch.float32).T
    mel = torch.log10(torch.clamp_min(mel, 1e-10))
    mmax = torch.amax(mel, dim=(-1, -2), keepdim=True) - 8.0
    return (torch.maximum(mel, mmax) + 4.0) / 4.0
