"""The device an entry point runs on.

The port's entry points take `device="cuda"` by default: they run on the
card unless the caller asks for the CPU (the CPU tests pass "cpu").  A
CUDA device on a machine without a usable card raises here, before any
work; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`torch.device(device)`; raises RuntimeError for a CUDA device when
    torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
