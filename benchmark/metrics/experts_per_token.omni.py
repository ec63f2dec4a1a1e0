"""experts_per_token.omni: routed experts computed per routed row (the
program's `moe_routed` over `moe_tokens` counters: the null expert and
the shared experts not counted), over the untraced calls."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    tokens = w and w.get("moe_tokens")
    if not tokens or tokens["value"] <= 0 or "moe_routed" not in w:
        return None
    return w["moe_routed"]["value"] / tokens["value"]
