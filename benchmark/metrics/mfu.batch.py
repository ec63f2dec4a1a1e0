"""mfu.batch: the model's operations of the work of the window's untraced
calls (flops.py: each real stream's windows, encoder, cross-attention K/V
and a decoder pass over its prompt and tokens) over those calls' wall
times the H100's bfloat16 peak, in percent."""

from benchmark import peaks


def read(rec):
    if not rec or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * peaks.PEAK_OPS["bf16"])
