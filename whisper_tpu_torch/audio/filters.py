"""Slaney-scale mel filterbank, computed from scratch.

Whisper model files embed their filterbank (openai/whisper mel_filters.npz,
written into the ggml container — reference: models/convert-pt-to-ggml.py:
219-282).  That filterbank is librosa.filters.mel(16000, 400, n_mels) with
slaney scale + slaney norm; this reimplementation matches it to float
rounding and is used when converting checkpoints that lack the assets.
"""

from __future__ import annotations

import numpy as np

from ..constants import N_FFT, SAMPLE_RATE


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f * 3.0 / 200.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f)


def mel_filterbank(n_mels: int, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) float32 slaney-normalized triangular filters."""
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney norm: 2 / bandwidth
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
