"""K1: the encoder's fused self-attention (csrc/encoder_attention.cu) at
its (B, T, H, Dh) entry.  Bytes: bf16 q, k, v read once, the f32 output
written once; operations: QK^T and PV, 4 B H T^2 Dh."""

ENTRY = "wtt_encoder_attention"
KERNEL = "encoder_attention_kernel"
KIND = "bf16"


def shape(args) -> tuple:
    """(B, T, H, Dh) of one call: the entry's arguments after q, k, v,
    out."""
    return tuple(args[4:8])


def work(shape) -> tuple:
    """(bytes, operations) of one call at (B, T, H, Dh)."""
    b, t, h, dh = shape
    return b * h * t * dh * (3 * 2 + 4), 4 * b * h * t * t * dh
