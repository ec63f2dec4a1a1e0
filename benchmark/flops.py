"""Model operations (multiply-adds count two) of the work a cell does, as
functions of its configuration (HF names).  They count the matrix
products and convolutions of the model's forward pass: an encoder pass
over one 30 s window, the cross-attention K/V of its encoder output, and
a decoder pass over a window's T positions (prompt and decoded tokens)
whose self-attention covers all T positions of the pass, as a
teacher-forced pass computes it, and whose logits cover every position."""


def encoder_window(cfg: dict) -> float:
    """One 30 s window: the two convolutions, then each layer's four
    projections, attention (QK^T, PV) and MLP over max_source_positions."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    f = cfg["encoder_ffn_dim"]
    conv = 2 * d * cfg["num_mel_bins"] * 3 * 2 * t + 2 * d * d * 3 * t
    layer = 2 * t * (4 * d * d + 2 * d * f) + 2 * 2 * t * t * d
    return conv + cfg["encoder_layers"] * layer


def cross_kv(cfg: dict) -> float:
    """Each decoder layer's K and V projections of one window's encoder
    output."""
    d, ta = cfg["d_model"], cfg["max_source_positions"]
    return cfg["decoder_layers"] * 2 * 2 * ta * d * d


def decoder_pass(cfg: dict, t: int) -> float:
    """A decoder pass over t positions: per layer the self-attention's four
    projections and products over t keys, the cross-attention's query and
    output projections and products over the window's keys, the MLP; then
    the logits over the vocabulary."""
    d, ta = cfg["d_model"], cfg["max_source_positions"]
    f = cfg["decoder_ffn_dim"]
    layer = (2 * t * (4 * d * d + 2 * d * d + 2 * d * f)
             + 2 * 2 * t * t * d + 2 * 2 * t * ta * d)
    return cfg["decoder_layers"] * layer + 2 * t * d * cfg["vocab_size"]


def window(cfg: dict, t: int) -> float:
    """All of one window's work: its encoder pass, its cross-attention K/V
    and a decoder pass over its t positions."""
    return encoder_window(cfg) + cross_kv(cfg) + decoder_pass(cfg, t)
