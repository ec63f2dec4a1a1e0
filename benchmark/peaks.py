"""The H100's published peaks (NVIDIA's data sheet, SXM part, dense rates,
at the full 700 W), frozen here as the benchmark's yardstick: HBM3 bytes
a second, and operations a second by their type (bfloat16 on the tensor
cores, float32 on the CUDA cores)."""

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least seconds the card could take to move `nbytes` and do `ops`
    operations of `kind`: the larger of the two times."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[kind])
