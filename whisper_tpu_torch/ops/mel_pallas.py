"""Fused log-mel, kernel K7 (csrc/log_mel.cu).

Replaces whisper_tpu/ops/mel_pallas.py `_mel_blocks` / `_mel_kernel`: per
frame, framing, the Hann window, the real DFT as two (400 x 201) products,
the power spectrum, the mel filterbank and log10(max(., 1e-10)), in full
float32, without the (n_frames, 400) frame matrix in device memory.

Framing trick, kept from the TPU kernel: with hop 160 and window 400 =
2*160 + 80, frame i is rows i, i+1 and the first half of row i+2 of the
audio viewed as (n, 160), so the kernel takes three row views of one
buffer and needs no gather.

The final clamp at the global max - 8 and (x + 4) / 4 need a global max,
so they run as plain torch after the kernel in `log_mel_pallas`, as they
run as XLA ops after the Pallas kernel.

What bounds K7 on the H100, and its design: see csrc/log_mel.cu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.mel import _dft_basis, hann_window_periodic
from ..constants import HOP_LENGTH, N_FFT

FRAMES_PER_BLOCK = 256   # whisper_tpu's frame count granularity
N_BINS = N_FFT // 2 + 1  # 201
K7_FRAMES = 36           # frames per CTA of K7 (the last may be ragged)
K7_N_MELS = (80, 128)    # the instances the kernel is built for


def _k7_frame_ranges(n: int) -> list[tuple[int, int]]:
    """The frames [begin, end) of each CTA of K7's grid for n frames (the
    kernel computes the same from blockIdx and n)."""
    return [(b, min(b + K7_FRAMES, n)) for b in range(0, n, K7_FRAMES)]


def _mel_blocks_ref(rows0, rows1, rows2, hann, cos_b, sin_b, filters_t):
    """Plain PyTorch version of K7, in f32: rows0/rows1 (n, 160), rows2
    (n, 80), hann (1, 400), cos_b/sin_b (400, 201), filters_t (201, n_mel)
    -> (n, n_mel) log10 mel."""
    frames = torch.cat([rows0, rows1, rows2], dim=1) * hann
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    mel = power @ filters_t
    return torch.log10(torch.clamp_min(mel, 1e-10))


def _mel_blocks(rows0, rows1, rows2, hann, cos_b, sin_b, filters_t):
    """-> (n, n_mel) log10 mel of the frames the three row views give.

    CPU tensors take `_mel_blocks_ref`; CUDA tensors go through K7, which
    takes float32 throughout, rows with a unit column stride (any row
    stride), any n >= 1 and n_mel 80 or 128."""
    if rows0.device.type == "cpu":
        return _mel_blocks_ref(rows0, rows1, rows2, hann, cos_b, sin_b,
                               filters_t)
    if rows0.device.type != "cuda":
        raise ValueError(f"_mel_blocks: unsupported device {rows0.device}")
    n = rows0.shape[0]
    n_mel = filters_t.shape[-1]
    rest = N_FFT - 2 * HOP_LENGTH
    expect = {
        "rows0": (rows0, (n, HOP_LENGTH)), "rows1": (rows1, (n, HOP_LENGTH)),
        "rows2": (rows2, (n, rest)), "hann": (hann, (1, N_FFT)),
        "cos_b": (cos_b, (N_FFT, N_BINS)), "sin_b": (sin_b, (N_FFT, N_BINS)),
        "filters_t": (filters_t, (N_BINS, n_mel))}
    for name, (x, shape) in expect.items():
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != rows0.device):
            raise ValueError(f"_mel_blocks: {name} is {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, expected {shape} "
                             f"float32 on {rows0.device}")
        rows = name.startswith("rows")
        if (x.stride(-1) != 1 if rows else not x.is_contiguous()):
            raise ValueError(f"_mel_blocks: {name} must be "
                             + ("unit-stride along a row" if rows
                                else "contiguous"))
    if n < 1 or n_mel not in K7_N_MELS:
        raise ValueError(f"K7 takes n >= 1 frames and n_mel in {K7_N_MELS}, "
                         f"got n={n}, n_mel={n_mel}")
    from ._build import library
    out = torch.empty((n, n_mel), dtype=torch.float32, device=rows0.device)
    library().call("wtt_log_mel", rows0.data_ptr(), rows0.stride(0),
                   rows1.data_ptr(), rows1.stride(0), rows2.data_ptr(),
                   rows2.stride(0), hann.data_ptr(), cos_b.data_ptr(),
                   sin_b.data_ptr(), filters_t.data_ptr(), out.data_ptr(),
                   n, n_mel, torch.cuda.current_stream(rows0.device)
                   .cuda_stream)
    _mel_blocks.launches += 1
    return out


_mel_blocks.launches = 0


def mel_block_inputs(padded_audio: torch.Tensor, filters):
    """The arguments of `_mel_blocks` for a padded signal (see
    audio.mel.pad_audio) on its device: the three row views, the window,
    the DFT bases and the transposed filterbank.  n is the frame count
    rounded down to a FRAMES_PER_BLOCK multiple."""
    n_len = (padded_audio.shape[-1] - N_FFT) // HOP_LENGTH
    n = (n_len // FRAMES_PER_BLOCK) * FRAMES_PER_BLOCK
    dev = padded_audio.device
    rows = padded_audio[:(n + 2) * HOP_LENGTH].reshape(n + 2, HOP_LENGTH)
    cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_basis())
    filters_t = torch.as_tensor(np.asarray(filters, np.float32)).to(dev).T
    return (rows[0:n], rows[1:n + 1], rows[2:n + 2, :N_FFT - 2 * HOP_LENGTH],
            torch.from_numpy(hann_window_periodic()).to(dev)[None, :],
            cos_b, sin_b, filters_t.contiguous())


def log_mel_pallas(padded_audio: torch.Tensor, filters) -> torch.Tensor:
    """Padded audio, 1-D float32 (see audio.mel.pad_audio) -> (n, n_mel)
    log-mel, n the frame count rounded down to a FRAMES_PER_BLOCK
    multiple; since the signal carries 30 s of zero padding past the
    audio, the frames dropped are silence past any window."""
    mel = _mel_blocks(*mel_block_inputs(padded_audio, filters))
    mmax = torch.amax(mel) - 8.0
    return (torch.maximum(mel, mmax) + 4.0) / 4.0
