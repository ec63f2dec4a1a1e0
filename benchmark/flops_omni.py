"""Model operations (multiply-adds count two) of the audio-LLM's work, as
functions of its configuration (HF names): an encoder pass over one 30 s
window (flops.py's, on the audio tower's own keys), the connector's
projection, and a language-model pass over a window's T positions (the
prompt and the tokens before the last) whose attention covers all T
positions, as a teacher-forced pass computes it, whose logits cover the
judged positions, and whose routed experts cover the rows routed to them
(`routed`, from the program's counter or the reference's count)."""

from benchmark import flops


def encoder_window(cfg: dict) -> float:
    return flops.encoder_window(cfg["whisper_encoder"])


def connector(cfg: dict) -> float:
    """The projector over the pooled audio tokens (pooling counts no
    products)."""
    return 2 * cfg["whisper_query_tokens_size"] * cfg["whisper_hidden_size"] \
        * cfg["hidden_size"]


def llm_pass(cfg: dict, t: int, n_logits: int) -> float:
    """Every layer's q/k/v and output projections, attention over t keys,
    router and shared experts over t positions; the lm_head over n_logits
    positions.  The routed experts are `routed`'s."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    experts = cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"]
    shared = cfg["mlp_fixed_expert_num"] * cfg["shared_intermediate_size"]
    layer = (2 * t * d * (h + 2 * hkv) * dh + 2 * t * h * dh * d
             + 2 * 2 * t * t * h * dh + 2 * t * d * experts
             + 3 * 2 * t * d * shared)
    return cfg["num_hidden_layers"] * layer + 2 * n_logits * d * \
        cfg["vocab_size"]


def routed(cfg: dict, rows: int) -> float:
    """`rows` routed-expert row products (W1, W3 and W2 each)."""
    return rows * 3 * 2 * cfg["hidden_size"] * cfg["dynamic_intermediate_size"]


def window(cfg: dict, t: int, n_logits: int) -> float:
    """A window's work but its routed experts: its encoder pass, the
    connector and a language-model pass over t positions."""
    return encoder_window(cfg) + connector(cfg) + llm_pass(cfg, t, n_logits)
