"""Log-mel spectrogram frontend (port of whisper_tpu.audio.mel).

`pad_audio` and the host `log_mel_spectrogram` (the serial `full` path
and the host-mel BatchTranscriber) copy the original's: the native C++
front end (audio/native.py) when it is built and WTPU_NO_NATIVE is not 1,
else numpy.  `log_mel_spectrogram_torch`
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
from .native import log_mel_spectrogram_native


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
    dtype = np.int16 if samples.dtype == np.int16 else np.float32
    padded = np.empty(padded_length(len(samples)), dtype=dtype)
    pad_audio_into(samples, padded)
    n_len = (len(padded) - N_FFT) // HOP_LENGTH
    return padded, n_len, frames_org(len(samples))


def padded_length(n_samples: int) -> int:
    """pad_audio's length: N_FFT // 2 reflected samples ahead of the
    samples, 30 s and N_FFT // 2 zeros after them."""
    return n_samples + SAMPLE_RATE * CHUNK_SIZE + N_FFT


def frames_org(n_samples: int) -> int:
    """pad_audio's n_len_org: the frames covering n_samples of real audio."""
    return 1 + (n_samples + N_FFT // 2 - N_FFT) // HOP_LENGTH


def pad_audio_into(samples: np.ndarray, out: np.ndarray) -> None:
    """Write pad_audio's padding of samples into out (at least
    padded_length long; zeros to its end): samples[1..200] reversed, the
    samples, zeros.  int16 samples into a float out are scaled by 1/32768,
    as the device mel reads int16 PCM."""
    head = N_FFT // 2
    n = len(samples)
    if samples.dtype == np.int16 and out.dtype != np.int16:
        np.divide(samples[head:0:-1], 32768.0, out=out[:head])
        np.divide(samples, 32768.0, out=out[head:head + n])
    else:
        out[:head] = samples[head:0:-1]
        out[head:head + n] = samples
    out[head + n:] = 0


def _mel_from_padded_np(padded: np.ndarray, n_len: int,
                        filters: np.ndarray) -> np.ndarray:
    window = hann_window_periodic()
    idx = np.arange(n_len)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]
    frames = padded[idx] * window[None, :]

    spec = np.fft.rfft(frames.astype(np.float32), n=N_FFT, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)  # (n_len, 201)

    mel = power @ filters.astype(np.float32).T                    # (n_len, n_mel)
    mel = np.log10(np.maximum(mel, 1e-10))

    mmax = mel.max() - 8.0
    mel = (np.maximum(mel, mmax) + 4.0) / 4.0
    return mel.astype(np.float32)                                 # (n_len, n_mel)


def log_mel_spectrogram(samples: np.ndarray,
                        filters: np.ndarray) -> tuple[np.ndarray, int]:
    """PCM f32 (or s16) mono @16 kHz -> ((n_len, n_mel) f32 mel, n_len_org),
    on the host: the native front end when built (whisper_tpu's default;
    within 5e-5 of numpy), else numpy.

    The returned mel includes the trailing 30 s zero-pad region so a full
    window starting at any seek offset < n_len_org is always available.
    """
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        samples = samples.astype(np.float32) / 32768.0
    samples = samples.astype(np.float32, copy=False)
    if len(samples) < 1 + N_FFT // 2:
        # too short for the reflect pad; zero-extend like a silent signal
        samples = np.pad(samples, (0, 1 + N_FFT // 2 - len(samples)))
    res = log_mel_spectrogram_native(samples, filters)   # None: numpy
    if res is not None:
        return res
    padded, n_len, n_len_org = pad_audio(samples)
    return _mel_from_padded_np(padded, n_len, filters), n_len_org


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
