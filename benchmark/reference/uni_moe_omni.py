"""Plain Uni-MoE-2.0-Omni speech-to-text forward pass in float32.

Written from the published configuration (HF HIT-TMG/Uni-MoE-2.0-Omni,
config.json, `grin_qwen2_vl`) in plain PyTorch, with no kernel, no cache
and no batching: each window is its own forward pass.  It imports nothing
of the program.  The passes run one layer at a time over all the windows
given, each layer's weights cast up to float32 once, so that the model
fits beside the program's bf16 weights.

The audio tower is Whisper-large's encoder (conv stem, pre-LN blocks,
ln_post; GELU's tanh form, as whisper.cpp computes it).  The language
model is Qwen2's decoder layer with a dynamic-capacity mixture of
experts in place of its MLP:

    a = RMSNorm(h);  q, k, v = a Wq + bq, a Wk + bk, a Wv + bv
    RoPE on q and k (rotate_half over all head channels, theta as given)
    h += causal GQA(q, k, v) Wo        (no bias on Wo)
    m = RMSNorm(h);  p = softmax(m Wr) (float32: fp32_gate)
    h += sum_shared E_s(m) + sum_{i kept, not null} p_i E_i(m),
    E(x) = W2(silu(W1 x) * W3 x)

then the final RMSNorm and the untied lm_head.  The kept set is the
shortest prefix of p sorted in descending order (the lower index first on
a tie) whose sum reaches mlp_dynamic_top_p, at most mlp_dynamic_top_k
entries; the null experts compute nothing.

Departures from the published description, each assumed where
config.json is silent:
  - connector: the encoder's 1,500 frames pooled by adaptive average
    pooling to whisper_query_tokens_size tokens, then the linear
    projector (whisper_projector_type "linear") with a bias;
  - M-RoPE's mrope_section with three equal position ids is plain 1-D
    RoPE, and audio and text positions count alike;
  - shared experts add with weight 1; routed weights are the
    probabilities over all entries, not renormalised;
  - every layer has the mixture of experts (moe_layer_freq not given);
  - no token is dropped (token_drop false): capacity is unbounded.

Routing near a boundary (the cumulative top_p threshold, or the order of
the last kept and the first unkept entry) flips on rounding, and one
flipped expert moves the logits by far more than any rounding.  So
`forward` may be handed another computation's kept sets: where the
reference's own margin to a boundary is below `delta` it takes the set
handed, and elsewhere it keeps its own and counts where the two differ.

`precision`:
  "f32"  float32 throughout, TF32 off (the reference);
  "fp8"  each operand of every matrix product and convolution rounded to
         float8 e4m3 with a scale a row (a weight's output channel, an
         activation's token); the router stays float32 as configured:
         the nearest precision below bfloat16 (the control).

Weights are the params dict in the program's layout: params["encoder"]
as Whisper's (stacked (L, out, in) linears), params["connector"] {w, b},
params["llm"] {embed, norm, lm_head, blocks: attn_norm, qkv_w (q, then
k, then v rows), qkv_b, o_w, mlp_norm, router_w, shared_w13 (each shared
expert's W1 rows then W3 rows), shared_w2 (their W2 side by side), w13
(L, E, 2F, d: W1 rows then W3 rows), w2 (L, E, d, F)}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                 # largest finite float8 e4m3


def no_tf32() -> None:
    """float32 products in float32: the reference is float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per row (last axis)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """Products in the chosen precision (see the module docstring)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8_rows(x) if self.fp8 else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A matrix cast up to float32 (rounded per output row)."""
        return self.q(w.float())

    def linear(self, x, w, b=None):
        """x @ w.T (+ b), w already through `weight`."""
        y = self.q(x) @ w.T
        return y if b is None else y + b.float()

    def conv(self, x, w, b, stride):
        """conv1d(k=3, padding=1) of (C_in, T) -> (C_out, T')."""
        w = w.float()
        if self.fp8:
            x = _fp8_rows(x.T).T              # a scale a time step
            w = _fp8_rows(w.reshape(w.shape[0], -1)).reshape(w.shape)
        y = F.conv1d(x[None], w, stride=stride, padding=1)[0]
        return y + b.float()[:, None]


# ---------------------------------------------------------------------------
# the audio tower and the connector
# ---------------------------------------------------------------------------

def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), 1e-5)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _attend(ar: Arith, q, k, v, causal: bool):
    """Attention of q (H, Tq, Dh) on k, v (H, Tk, Dh) -> (Tq, H Dh)."""
    h, tq, dh = q.shape
    s = (ar.q(q) @ ar.q(k).transpose(1, 2)) * dh ** -0.5
    if causal:
        s = s + torch.full((tq, k.shape[1]), float("-inf"),
                           device=q.device).triu(k.shape[1] - tq + 1)
    p = torch.softmax(s, dim=-1)
    o = ar.q(p) @ ar.q(v.transpose(1, 2)).transpose(1, 2)
    return o.transpose(0, 1).reshape(tq, h * dh)


def encode(enc: dict, mel: torch.Tensor, n_head: int, ar: Arith):
    """Whisper's encoder: (3000, n_mels) log-mel -> (1500, D)."""
    x = _gelu(ar.conv(mel.T, enc["conv1_w"], enc["conv1_b"], 1))
    x = _gelu(ar.conv(x, enc["conv2_w"], enc["conv2_b"], 2)).T
    x = x + enc["pos"][:x.shape[0]].float()
    blocks = enc["blocks"]
    t, d = x.shape

    def heads(y):
        return y.reshape(t, n_head, d // n_head).transpose(0, 1)

    for l in range(blocks["q_w"].shape[0]):
        blk = {key: w[l] for key, w in blocks.items()}
        w = {key: ar.weight(blk[key]) for key in
             ("q_w", "k_w", "v_w", "o_w", "mlp0_w", "mlp2_w")}
        h = _ln(x, blk["attn_ln_w"], blk["attn_ln_b"])
        a = _attend(ar, heads(ar.linear(h, w["q_w"], blk["q_b"])),
                    heads(ar.linear(h, w["k_w"])),
                    heads(ar.linear(h, w["v_w"], blk["v_b"])), False)
        x = x + ar.linear(a, w["o_w"], blk["o_b"])
        h = _ln(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
        x = x + ar.linear(_gelu(ar.linear(h, w["mlp0_w"], blk["mlp0_b"])),
                          w["mlp2_w"], blk["mlp2_b"])
    return _ln(x, enc["ln_post_w"], enc["ln_post_b"])


def connect(con: dict, enc_out: torch.Tensor, n_tokens: int, ar: Arith):
    """(Ta, D) encoder output -> (n_tokens, d) audio tokens: adaptive
    average pooling over the frames, then the linear projector."""
    pooled = F.adaptive_avg_pool1d(enc_out.T[None], n_tokens)[0].T
    return ar.linear(pooled, ar.weight(con["w"]), con["b"])


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, theta: float):
    """x (H, T, Dh) at positions 0 .. T - 1."""
    t, dh = x.shape[1], x.shape[2]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def route(p: torch.Tensor, top_p: float, top_k: int):
    """-> (kept (T, top_k) int64, -1 where an entry is not kept; the
    margin (T,) to the nearest boundary: a prefix sum's distance from
    top_p, or the gap between the last kept and the first unkept)."""
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    before = torch.zeros_like(vals[:, :top_k])
    margin = torch.full_like(vals[:, 0], float("inf"))
    for j in range(1, top_k):
        before[:, j] = vals[:, :j].sum(-1)
        margin = torch.minimum(margin, (before[:, j] - top_p).abs())
    keep = before < top_p
    n_kept = keep.sum(-1)
    padded = F.pad(vals, (0, 1))            # no entry left out: a gap to 0
    last = padded.gather(1, (n_kept - 1)[:, None])[:, 0]
    first_out = padded.gather(1, n_kept[:, None])[:, 0]
    margin = torch.minimum(margin, last - first_out)
    return torch.where(keep, idx[:, :top_k], -1), margin


def _expert(ar: Arith, x, w1, w3, w2):
    return ar.linear(F.silu(ar.linear(x, w1)) * ar.linear(x, w3), w2)


def layer_experts(ar: Arith, blk: dict) -> dict:
    """One layer's expert matrices cast up: shared_w13, shared_w2, and the
    routed experts' w13 and w2 as lists."""
    n = blk["w13"].shape[0]
    return {"shared_w13": ar.weight(blk["shared_w13"]),
            "shared_w2": ar.weight(blk["shared_w2"]),
            "w13": [ar.weight(blk["w13"][e]) for e in range(n)],
            "w2": [ar.weight(blk["w2"][e]) for e in range(n)]}


def mixture(ar: Arith, m, p, kept, experts: dict, cfg: dict):
    """The layer's experts on m (T, d), routed by `kept` (T, top_k; -1 and
    the null experts compute nothing) with the probabilities p (T, E + N0)
    -> (sum of the shared experts and the kept routed ones weighted by
    their p, the routed-expert row products computed)."""
    fs = cfg["shared_intermediate_size"]
    fr = cfg["dynamic_intermediate_size"]
    s13, s2 = experts["shared_w13"], experts["shared_w2"]
    y = torch.zeros_like(m)
    for s in range(cfg["mlp_fixed_expert_num"]):
        g13 = s13[2 * s * fs:(2 * s + 2) * fs]
        y = y + _expert(ar, m, g13[:fs], g13[fs:],
                        s2[:, s * fs:(s + 1) * fs])
    routed = 0
    for e in range(cfg["mlp_dynamic_expert_num"]):
        rows = (kept == e).any(-1).nonzero()[:, 0]
        if len(rows):
            w13 = experts["w13"][e]
            y[rows] += p[rows, e][:, None] * _expert(
                ar, m[rows], w13[:fr], w13[fr:], experts["w2"][e])
            routed += len(rows)
    return y, routed


def _same(a, b) -> torch.Tensor:
    """(T,) whether the rows of two kept-id tables hold the same sets."""
    a = a.sort(-1).values
    b = b.sort(-1).values
    return (a == b).all(-1)


def forward(params: dict, cfg: dict, audio: list, ids: list, first: list,
            ar: Arith, handed: list | None = None, delta: float = 0.0):
    """Teacher-forced passes of the language model.  Window w's input is
    the template's head ids, its audio tokens audio[w] (n_audio, d), then
    ids[w] (the template's tail and the tokens before the last judged).
    -> {"logits": [(T_w - first[w], V) logits of positions first[w] ..],
    "kept": [(T_w, L, top_k)], "probs": [(T_w, L, E + N0)] the router's
    probabilities, "routed": routed-expert row products computed; and a
    count a window: "handed", rows whose set was taken from `handed`;
    "wide", rows where a handed set differs from the reference's own at a
    margin of at least delta; "flip_margin", the widest margin of a row
    whose handed set differs from the reference's own (what delta must
    stay above); "rows", rows routed}.

    handed: per window a (T_w, L, top_k) table of kept ids (-1: none) that
    the reference takes where its margin is below delta."""
    llm = params["llm"]
    blocks = llm["blocks"]
    d = cfg["hidden_size"]
    n_head, n_kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // n_head
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    top_p, top_k = cfg["mlp_dynamic_top_p"], cfg["mlp_dynamic_top_k"]
    dev = llm["embed"].device
    head = torch.as_tensor(cfg["prompt_head"], dtype=torch.long, device=dev)
    hs = []
    for a, t in zip(audio, ids):
        tail = torch.as_tensor(t, dtype=torch.long, device=dev)
        hs.append(torch.cat([llm["embed"][head].float(), a.float(),
                             llm["embed"][tail].float()]))
    kept = [[] for _ in hs]
    probs = [[] for _ in hs]
    n = len(hs)
    out = {"routed": 0, "handed": [0] * n, "wide": [0] * n, "rows": [0] * n,
           "flip_margin": [0.0] * n}
    for l in range(blocks["qkv_w"].shape[0]):
        blk = {key: w[l] for key, w in blocks.items()}
        wq, wk, wv = ar.weight(blk["qkv_w"]).split(
            [n_head * dh, n_kv * dh, n_kv * dh])
        bq, bk, bv = blk["qkv_b"].float().split(
            [n_head * dh, n_kv * dh, n_kv * dh])
        wo = ar.weight(blk["o_w"])
        experts = layer_experts(ar, blk)
        for w, h in enumerate(hs):
            t = h.shape[0]
            a = _rms(h, blk["attn_norm"], eps)

            def split(y, n):
                return y.reshape(t, n, dh).transpose(0, 1)
            q = _rope(split(ar.linear(a, wq, bq), n_head), theta)
            k = _rope(split(ar.linear(a, wk, bk), n_kv), theta)
            v = split(ar.linear(a, wv, bv), n_kv)
            g = n_head // n_kv
            o = _attend(ar, q, k.repeat_interleave(g, 0),
                        v.repeat_interleave(g, 0), True)
            h = h + ar.linear(o, wo)
            m = _rms(h, blk["mlp_norm"], eps)
            p = torch.softmax(m @ blk["router_w"].float().T, dim=-1)
            mine, margin = route(p, top_p, top_k)
            if handed is not None:
                theirs = torch.as_tensor(handed[w][:, l], device=dev).long()
                near = margin < delta
                differ = ~_same(mine, theirs)
                out["handed"][w] += int(near.sum())
                out["wide"][w] += int((~near & differ).sum())
                if differ.any():
                    out["flip_margin"][w] = max(out["flip_margin"][w],
                                                float(margin[differ].max()))
                mine = torch.where(near[:, None], theirs, mine)
            kept[w].append(mine)
            probs[w].append(p)
            out["rows"][w] += t
            y, routed = mixture(ar, m, p, mine, experts, cfg)
            out["routed"] += routed
            hs[w] = h + y
        del wq, wk, wv, wo, experts
    head_w = ar.weight(llm["lm_head"])
    out["logits"] = [ar.linear(_rms(h[f:], llm["norm"], eps), head_w)
                     for h, f in zip(hs, first)]
    out["kept"] = [torch.stack(k, dim=1) for k in kept]
    out["probs"] = [torch.stack(p, dim=1) for p in probs]
    return out
