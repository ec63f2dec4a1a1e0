"""Energy voice-activity detection + text similarity helpers (copy of
whisper_tpu.audio.vad).

Ports of the reference example helpers (reference: examples/common.cpp:
601-676): one-pole high-pass filter, `vad_simple` endpoint detection used
by the streaming/command examples, and Levenshtein `similarity`.
"""

from __future__ import annotations

import numpy as np


def high_pass_filter(data: np.ndarray, cutoff: float,
                     sample_rate: float) -> np.ndarray:
    """First-order IIR high-pass — the TEXTBOOK filter.

    NOTE: this is deliberately NOT what the reference's helper computes.
    The reference (common.cpp:601-613) overwrites data[i-1] with the
    filtered value before reading it on the next iteration, so its
    recurrence collapses to y_i = alpha * x_i for i >= 1 — a uniform
    attenuation, not a filter (verified against the compiled binary,
    tests/test_vad_golden.py).  `vad_simple` below reproduces the
    reference's collapsed version for decision parity; this helper keeps
    the filter the reference plainly intended."""
    rc = 1.0 / (2.0 * np.pi * cutoff)
    dt = 1.0 / sample_rate
    alpha = dt / (rc + dt)

    x = np.asarray(data, dtype=np.float64)
    out = np.empty_like(x)
    out[0] = x[0]
    y = x[0]
    dx = np.diff(x)
    for i in range(1, len(x)):
        y = alpha * (y + dx[i - 1])
        out[i] = y
    return out.astype(np.float32)


def _reference_high_pass(data: np.ndarray, cutoff: float,
                         sample_rate: float) -> np.ndarray:
    """Bit-parity twin of the reference's high_pass_filter: because the
    loop reads the already-overwritten previous sample, the output is
    [x0, alpha*x1, alpha*x2, ...] (common.cpp:601-613)."""
    rc = 1.0 / (2.0 * np.pi * cutoff)
    dt = 1.0 / sample_rate
    alpha = np.float32(dt / (rc + dt))
    x = np.asarray(data, dtype=np.float32)
    out = x * alpha
    if len(out):
        out[0] = x[0]
    return out


def vad_simple(pcmf32: np.ndarray, sample_rate: int, last_ms: int,
               vad_thold: float, freq_thold: float,
               verbose: bool = False) -> bool:
    """True when the trailing `last_ms` is quiet relative to the whole
    buffer — i.e. speech just ended (reference: common.cpp:614-650)."""
    n_samples = len(pcmf32)
    n_samples_last = (sample_rate * last_ms) // 1000

    if n_samples_last >= n_samples:
        return False

    x = np.asarray(pcmf32, dtype=np.float32)
    if freq_thold > 0.0:
        # decision parity with the reference binary: its filter collapses
        # to a uniform alpha scaling (see _reference_high_pass), which
        # makes freq_thold a near-no-op on the last/all energy RATIO —
        # using the real filter here would change decisions on
        # low-frequency-dominated audio
        x = _reference_high_pass(x, freq_thold, sample_rate)

    energy_all = float(np.abs(x).mean())
    energy_last = float(np.abs(x[n_samples - n_samples_last:]).mean())

    if verbose:
        import sys
        print(f"vad_simple: energy_all: {energy_all}, energy_last: "
              f"{energy_last}, vad_thold: {vad_thold}, "
              f"freq_thold: {freq_thold}", file=sys.stderr)

    return energy_last <= vad_thold * energy_all


def similarity(s0: str, s1: str) -> float:
    """Levenshtein-distance similarity (reference: common.cpp:652-676)."""
    len0 = len(s0) + 1
    len1 = len(s1) + 1
    col = list(range(len1))
    for i in range(1, len0):
        prev_col, col = col, [i] + [0] * (len1 - 1)
        for j in range(1, len1):
            cost = 0 if s0[i - 1] == s1[j - 1] else 1
            col[j] = min(1 + col[j - 1], 1 + prev_col[j],
                         cost + prev_col[j - 1])
    dist = col[len1 - 1]
    return 1.0 - dist / max(len(s0), len(s1))
