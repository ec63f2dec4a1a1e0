"""K2: the decode step's cross-attention on int8 K/V with per-key scales
(csrc/cross_attention.cu `xattn_q8dt_kernel`), one query a (b, h) (G = 1).
Bytes: the bf16 query, the int8 K and V, their f32 scales read once, the
f32 output written once; operations: 4 B H Dh Ta."""

ENTRY = "wtt_cross_attention_q8"
KERNEL = "xattn_q8dt_kernel"
KIND = "bf16"


def shape(args) -> tuple:
    """(B, H, Dh, Ta, G) of one call: the entry's arguments after q, the
    codes, the scales and out."""
    b, h, g, dh, ta = args[6:11]
    return b, h, dh, ta, g


def work(shape) -> tuple:
    """(bytes, operations) of one call at (B, H, Dh, Ta, G)."""
    b, h, dh, ta, g = shape
    nbytes = b * h * (g * dh * 2 + 2 * dh * ta + 2 * ta * 4 + g * dh * 4)
    return nbytes, 4 * b * h * g * dh * ta
