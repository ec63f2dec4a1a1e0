"""Sample-rate conversion matching the reference's loader.

The reference's `read_audio_data` opens every file through a decoder
configured for 16 kHz output (reference: examples/common-whisper.cpp:52),
so any non-16 kHz source passes through the vendored miniaudio *linear
resampler with a Butterworth low-pass*: an order-4 cascade of two RBJ
low-pass biquads at cutoff min(in,out)/2, run at rate max(in,out), with a
fixed-point time accumulator doing linear interpolation between
consecutive (filtered) frames.  Downsampling filters the INPUT stream;
upsampling filters the OUTPUT stream (reference: miniaudio.h, the
ma_linear_resampler section).

This module reproduces that pipeline in float32 (the reference computes
the biquads and the lerp in f32; outputs match within ~2e-6 — a tenth of
an s16 quantization step — the residue being summation-order float bits
inside the biquad recurrence), fully vectorized: the biquad
cascade runs once over the whole stream (scipy's lfilter uses the same
direct-form-2-transposed recurrence, in single precision for f32 arrays;
a numpy fallback loop covers environments without scipy), and the
fixed-point timer positions of every output frame are computed in closed
form.  Pinned against the reference decoder forced to 16 kHz output in
tests/test_resample_golden.py.
"""

from __future__ import annotations

import math

import numpy as np


def _butterworth_biquads(sr_in: int, sr_out: int, order: int = 4):
    """RBJ low-pass biquad cascade, coefficients double->f32 like the
    reference.  Returns [(b (3,), a (3,)) f32] per second-order stage."""
    lpf_rate = max(sr_in, sr_out)
    cutoff = min(sr_in, sr_out) * 0.5      # lpfNyquistFactor = 1
    stages = []
    n2 = order // 2
    for i in range(n2):
        # Butterworth pole Q spread (even order)
        ang = (1 + i * 2) * (math.pi / (order * 2))
        q = 1.0 / (2.0 * math.cos(ang))
        w = 2.0 * math.pi * cutoff / lpf_rate
        s, c = math.sin(w), math.cos(w)
        alpha = s / (2.0 * q)
        b = np.array([(1 - c) / 2, 1 - c, (1 - c) / 2], dtype=np.float64)
        a = np.array([1 + alpha, -2 * c, 1 - alpha], dtype=np.float64)
        b = (b / a[0]).astype(np.float32)
        a = (a / a[0]).astype(np.float32)
        stages.append((b, a))
    return stages


def _run_biquads(x: np.ndarray, stages) -> np.ndarray:
    """Cascade of DF2T biquads in float32, zero initial state per channel.
    x: (n, ch) f32."""
    try:
        from scipy.signal import lfilter

        y = x
        for b, a in stages:
            y = lfilter(b, a, y, axis=0)
            y = np.asarray(y, dtype=np.float32)
        return y
    except ImportError:  # pragma: no cover - scipy is present in CI
        y = x.copy()
        for b, a in stages:
            b0, b1, b2 = (np.float32(v) for v in b)
            a1, a2 = np.float32(a[1]), np.float32(a[2])
            r1 = np.zeros(x.shape[1], dtype=np.float32)
            r2 = np.zeros(x.shape[1], dtype=np.float32)
            for n in range(y.shape[0]):
                xn = y[n]
                yn = (b0 * xn + r1).astype(np.float32)
                r1 = (b1 * xn - a1 * yn + r2).astype(np.float32)
                r2 = (b2 * xn - a2 * yn).astype(np.float32)
                y[n] = yn
        return y


def resample_ma(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """miniaudio-equivalent linear resample (f32). x: (n,) or (n, ch)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    x = np.ascontiguousarray(x, dtype=np.float32)
    if sr_in == sr_out:
        return x[:, 0] if squeeze else x
    g = math.gcd(sr_in, sr_out)
    rin, rout = sr_in // g, sr_out // g
    stages = _butterworth_biquads(rin, rout)

    n_in = x.shape[0]
    adv_int, adv_frac = divmod(rin, rout)
    # output k: time = (1, 0) + k*(adv_int, adv_frac); cumulative input
    # loads before producing it = the integer part; x1 = in[loads-1],
    # x0 = in[loads-2] (zero-primed), lerp factor = frac/rout (f32).
    # max outputs: loads(k) <= n_in
    # loads(k) = 1 + k*adv_int + (k*adv_frac)//rout
    if adv_int > 0:
        k_max = (n_in - 1) // adv_int + 1
    else:
        k_max = (n_in * rout) // adv_frac + 1
    k = np.arange(k_max + 1, dtype=np.int64)
    loads = 1 + k * adv_int + (k * adv_frac) // rout
    k = k[loads <= n_in]
    loads = loads[loads <= n_in]
    frac = (k * adv_frac) % rout

    src = x if rin <= rout else _run_biquads(x, stages)   # downsample: pre-filter
    x1 = src[loads - 1]
    x0 = np.where((loads - 2)[:, None] >= 0,
                  src[np.maximum(loads - 2, 0)], np.float32(0.0))
    a = (frac.astype(np.float32) / np.float32(rout))[:, None]
    out = (x0 + (x1 - x0) * a).astype(np.float32)
    if rin < rout:                                        # upsample: post-filter
        out = _run_biquads(out, stages)
    return out[:, 0] if squeeze else out
