"""mfu.omni: the model's operations of the work of the window's untraced
calls (flops_omni.py: each served window's encoder pass, connector and
language-model pass over its prompt and tokens, and the routed-expert row
products the program's `moe_routed` counter says it computed) over those
calls' wall times the H100's bfloat16 peak, in percent."""

from benchmark import peaks


def read(rec):
    if not rec or rec["window_s"] <= 0 or not rec.get("flops"):
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * peaks.PEAK_OPS["bf16"])
