"""Uni-MoE-2.0-Omni's speech-to-text path in PyTorch: Whisper-large's
encoder (models/whisper.py `encode`, called as it is), a connector that
pools its 1,500 frames to 200 audio tokens and projects them to the
language model's width, and a Qwen2-style language model whose every
layer is GQA attention with RoPE and a dynamic-capacity mixture of
experts (HF HIT-TMG/Uni-MoE-2.0-Omni, `grin_qwen2_vl`).

A layer, on the residual stream h (float32):

    a = RMSNorm(h);  q, k, v = a Wq + bq, a Wk + bk, a Wv + bv
    q, k = RoPE(q), RoPE(k)            rotate_half over all head channels
    h += GQA(q, k, v) Wo               causal; n_head / n_kv_head queries a
                                       KV head, scale 1 / sqrt(head_dim)
    m = RMSNorm(h);  p = softmax(m Wr) float32, over the routed experts and
                                       then the null expert(s)
    h += sum_shared E_s(m) + sum_{i kept, not null} p_i E_i(m)

where E(x) = W2(silu(W1 x) * W3 x) and the kept set is the shortest prefix
of p sorted in descending order (ties: the lower index first) whose sum
reaches `top_p`, at most `top_k` entries.  A null expert computes nothing:
a row whose kept set is the null expert alone gets the shared experts
only.  Shared experts add with weight 1; routed weights are the
probabilities over all entries, not renormalised.

Products run on bf16 operands (the compute dtype) and come out in float32;
RMSNorm, RoPE, the softmaxes and the router run in float32.  The MoE
sorts a call's kept entries by expert and runs one grouped product over
the routed experts (`torch._grouped_mm`), whose groups' sizes stay on the
device: each expert computes its own rows only, and nothing waits for the
device.  So on a card a one-token step runs as CUDA graphs
(`_StepGraphs`), launched in a few calls a layer.  Nothing here is a
hand-written kernel.

Parameters (`param_shapes`), torch (out, in) linears stacked on a leading
layer axis:

    connector  w (d, audio_state), b (d,)
    llm        embed (V, d), norm (d,), lm_head (V, d)
      blocks   attn_norm (L, d); qkv_w (L, (H + 2 Hkv) Dh, d) with the q,
               then k, then v rows; qkv_b (L, (H + 2 Hkv) Dh); o_w (L, d,
               H Dh); mlp_norm (L, d); router_w (L, E + N, d) float32;
               shared_w13 (L, S 2 Fs, d), each shared expert's W1 rows then
               its W3 rows; shared_w2 (L, d, S Fs), their W2 side by side;
               w13 (L, E, 2 F, d), W1 rows then W3 rows; w2 (L, E, d, F)

The KV cache is one contiguous (L, B, Hkv, C, Dh) tensor each for K and V
in the compute dtype, sized once per batch (`new_cache`).  Tracing
(utils/trace.py): spans `llm_prefill` and `llm_step` (rows), `moe` (rows,
one a layer call), each with its device time on a card; counters
`moe_tokens` (rows routed), `moe_routed` (routed-expert row computations,
null excluded), `moe_null` (rows whose kept set holds a null expert) and
`moe_bytes` (expert weight bytes read: the shared experts and each routed
expert with a row, once a call), gathered on the device and read once at
the end of `greedy`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.trace import TRACE

# the leaves held in the compute dtype; the rest are float32
WEIGHT_KEYS = frozenset({"w", "embed", "lm_head", "qkv_w", "o_w",
                         "shared_w13", "shared_w2", "w13", "w2"})


@dataclasses.dataclass(frozen=True)
class OmniConfig:
    """The language model and connector of Uni-MoE-2.0-Omni (HF names in
    the comments); the audio tower is a WhisperConfig's encoder."""
    n_vocab: int = 152064              # vocab_size
    d_model: int = 3584                # hidden_size
    n_layer: int = 28                  # num_hidden_layers
    n_head: int = 28                   # num_attention_heads
    n_kv_head: int = 4                 # num_key_value_heads
    head_dim: int = 128                # hidden_size / num_attention_heads
    n_routed: int = 4                  # mlp_dynamic_expert_num
    n_null: int = 1                    # mlp_dynamic_null_expert_num
    n_shared: int = 2                  # mlp_fixed_expert_num
    routed_ffn: int = 18944            # dynamic_intermediate_size
    shared_ffn: int = 2368             # shared_intermediate_size
    top_p: float = 0.7                 # mlp_dynamic_top_p
    top_k: int = 2                     # mlp_dynamic_top_k
    rope_theta: float = 1e6            # rope_theta
    rms_eps: float = 1e-6              # rms_norm_eps
    n_audio_tokens: int = 200          # whisper_query_tokens_size
    audio_state: int = 1280            # whisper_hidden_size
    prompt_head: tuple = ()            # text ids before the audio tokens
    prompt_tail: tuple = ()            # and after them
    eos: int = 151645                  # the id that ends a transcript

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_head) + self.n_audio_tokens \
            + len(self.prompt_tail)


def param_shapes(cfg: OmniConfig) -> dict:
    """Nested dict of the connector's and language model's leaf shapes."""
    d, L, E = cfg.d_model, cfg.n_layer, cfg.n_routed
    qkv = (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim
    s_ffn = cfg.n_shared * cfg.shared_ffn
    return {
        "connector": {"w": (d, cfg.audio_state), "b": (d,)},
        "llm": {
            "embed": (cfg.n_vocab, d), "norm": (d,),
            "lm_head": (cfg.n_vocab, d),
            "blocks": {
                "attn_norm": (L, d), "qkv_w": (L, qkv, d), "qkv_b": (L, qkv),
                "o_w": (L, d, cfg.n_head * cfg.head_dim), "mlp_norm": (L, d),
                "router_w": (L, E + cfg.n_null, d),
                "shared_w13": (L, 2 * s_ffn, d), "shared_w2": (L, d, s_ffn),
                "w13": (L, E, 2 * cfg.routed_ffn, d),
                "w2": (L, E, d, cfg.routed_ffn),
            },
        },
    }


def expert_bytes(cfg: OmniConfig, dtype=torch.bfloat16) -> tuple[int, int]:
    """(one routed expert's, all the shared experts') weight bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    return (3 * cfg.d_model * cfg.routed_ffn * size,
            3 * cfg.d_model * cfg.n_shared * cfg.shared_ffn * size)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float):
    """float32 RMSNorm over the last axis, times the float32 scale w."""
    return F.rms_norm(x.float(), (x.shape[-1],), w, eps)


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin), each (T, head_dim) float32, of the positions (T,): the
    angles' cosines, and their sines with the first half negated, over
    the frequencies theta^(-2i / head_dim) twice, so that `rope` is
    rotate_half's form with one product and one fused multiply-add."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                       device=positions.device) / head_dim)
    ang = positions.double()[:, None] * inv[None]
    cos, sin = ang.cos(), ang.sin()
    return (torch.cat([cos, cos], dim=-1).float(),
            torch.cat([-sin, sin], dim=-1).float())


def rope(x, cos, sin):
    """x (..., T, Dh) float32 rotated at the tables' positions:
    x cos + rotate_half(x) sin, rotate_half(x) = [-x2, x1]."""
    half = x.shape[-1] // 2
    swapped = torch.cat([x[..., half:], x[..., :half]], dim=-1)
    return torch.addcmul(x * cos, swapped, sin)


# SDPA's flash kernels, or its plain version where they do not run: the
# same bits on every run (its cuDNN kernels, picked first on an H100, split
# a single query's keys and combine the parts in an order that changes
# from run to run, and so do the greedy tokens a few steps on)
_SDPA = [SDPBackend.FLASH_ATTENTION, SDPBackend.MATH]


def gqa_attention(q, k, v, causal: bool):
    """q (B, H, Tq, Dh), k and v (B, Hkv, Tk, Dh) in the compute dtype ->
    (B, H, Tq, Dh) in it, softmax in float32; query head h reads KV head
    h // (H / Hkv).  causal: query t sees keys up to t (Tq == Tk).  Called
    under `sdpa_kernel(_SDPA)` (`_forward` and `_StepGraphs` hold it over
    their layers)."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def route(p, top_p: float, top_k: int):
    """(kept ids (N, top_k) with -1 where an entry is not kept, their
    probabilities (N, top_k)) of the router's probabilities p (N, E + N0):
    sorted in descending order, the lower index first on a tie, entry j
    kept while the entries before it sum below top_p."""
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    before = F.pad(vals.cumsum(-1)[:, :-1], (1, 0))
    return torch.where(before < top_p, idx, -1), vals


def _swiglu(h):
    """silu(gate) * up of h (..., 2 F) = [gate | up] per expert, float32
    math, back in h's dtype."""
    g, u = h.chunk(2, dim=-1)
    return F.silu(g.float()).mul_(u).to(h.dtype)


def _shared(a, blk, cfg: OmniConfig):
    """The shared experts of a (N, d) in the compute dtype -> (N, d)
    float32: one product over their W1 / W3 rows, one over their W2
    columns."""
    h = F.linear(a, blk["shared_w13"])
    h = h.view(a.shape[0], cfg.n_shared, 2 * cfg.shared_ffn)
    act = _swiglu(h).reshape(a.shape[0], cfg.n_shared * cfg.shared_ffn)
    return F.linear(act, blk["shared_w2"]).float()


def _moe(m, blk, cfg: OmniConfig, stats=None):
    """The layer's mixture of experts of m (N, d) float32 (its RMSNorm
    output) -> ((N, d) float32, the kept ids (N, top_k), the router's
    probabilities (N, E + N0)), with no wait for the device.  stats: an
    int64 (5,) tensor that gets the call's [rows, routed-expert rows, rows
    keeping a null expert, routed experts with a row, 1]."""
    n, d = m.shape
    E, k = cfg.n_routed, cfg.top_k
    p = torch.softmax(F.linear(m, blk["router_w"]), dim=-1)
    kept, weight = route(p, cfg.top_p, k)
    a = m.to(blk["w13"].dtype)
    out = _shared(a, blk, cfg)
    # the N top_k entries sorted by expert, the nulls and then the unkept
    # ones past the routed experts; each expert's product reads its rows
    # only (the groups' ends `offs` stay on the device), and the rows past
    # the last group come out undefined and are masked
    n_bins = E + cfg.n_null + 1
    ids = torch.where(kept < 0, n_bins - 1, kept).flatten()
    order = torch.argsort(ids, stable=True)
    counts = (ids[:, None] == torch.arange(n_bins, device=m.device)).sum(0)
    offs = counts[:E].cumsum(0).to(torch.int32)
    h = torch._grouped_mm(a[order // k], blk["w13"].transpose(-2, -1),
                          offs=offs)
    y = torch._grouped_mm(_swiglu(h), blk["w2"].transpose(-2, -1),
                          offs=offs)
    routed = torch.arange(n * k, device=m.device) < offs[-1]
    y = torch.where(routed[:, None],
                    y.float() * weight.flatten()[order, None], 0.0)
    # each entry's output in its own slot, then a row's top_k slots summed
    # in order: no atomic adds, the same bits on every run
    slots = torch.empty_like(y).index_copy_(0, order, y)
    out = out + slots.view(n, k, d).sum(1)
    if stats is not None:
        routed_e = counts[:E]
        stats += torch.stack([counts.sum() // k, routed_e.sum(),
                              counts[E:-1].sum(), (routed_e > 0).sum(),
                              torch.ones_like(routed_e[0])])
    return out, kept, p


def moe(m, blk, cfg: OmniConfig, stats=None):
    """`_moe` under the `moe` span (rows; device time on a card)."""
    with TRACE.span("moe", m.shape[0], device=m.is_cuda):
        return _moe(m, blk, cfg, stats)


def flush_stats(stats, cfg: OmniConfig, dtype=torch.bfloat16) -> None:
    """With the tracer on, the MoE counts gathered since the last flush
    into its counters moe_tokens, moe_routed, moe_null and moe_bytes (the
    shared experts and each routed expert with a row, once a call); then
    zero them."""
    if TRACE.on:
        rows, routed, null, hit, calls = stats.tolist()
        one, shared = expert_bytes(cfg, dtype)
        TRACE.count("moe_tokens", rows)
        TRACE.count("moe_routed", routed)
        TRACE.count("moe_null", null)
        TRACE.count("moe_bytes", hit * one + calls * shared)
    stats.zero_()


def _attend_in(h, blk, cfg: OmniConfig, cache, l: int, pos):
    """The attention's inputs of h (B, T, d) float32 at the positions pos
    (T,) int64: its K and V written into layer l's cache there; -> the
    queries (B, H, T, Dh) in the compute dtype."""
    b, t, _ = h.shape
    cd = blk["qkv_w"].dtype
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    a = rms_norm(h, blk["attn_norm"], cfg.rms_eps).to(cd)
    qkv = F.linear(a, blk["qkv_w"]) + blk["qkv_b"]          # float32
    qk = rope(qkv[..., :(H + Hkv) * Dh].view(b, t, H + Hkv, Dh)
              .transpose(1, 2), cache["cos"][pos], cache["sin"][pos])
    kc, vc = cache["k"][l], cache["v"][l]
    kc.index_copy_(2, pos, qk[:, H:].to(kc.dtype))
    vc.index_copy_(2, pos, qkv[..., (H + Hkv) * Dh:].view(b, t, Hkv, Dh)
                   .transpose(1, 2).to(vc.dtype))
    return qk[:, :H].to(cd)


def _attend(q, cache, l: int, t_end: int):
    """GQA of the queries q (B, H, T, Dh) over layer l's cached keys 0 ..
    t_end - 1 (causal when T > 1: a pass from position 0)."""
    return gqa_attention(q, cache["k"][l][:, :, :t_end],
                         cache["v"][l][:, :, :t_end], causal=q.shape[2] > 1)


def _attend_out(h, o, blk, cfg: OmniConfig):
    """h + o Wo for the attention's output o (B, H, T, Dh), and its
    RMSNorm (the MoE's input), both float32."""
    b, t, _ = h.shape
    h = h + F.linear(o.transpose(1, 2).reshape(b, t, -1), blk["o_w"])
    return h, rms_norm(h, blk["mlp_norm"], cfg.rms_eps)


def _head(params, cfg: OmniConfig, h):
    """(B, V) float32 logits of the last positions' h (B, d) float32."""
    llm = params["llm"]
    last = rms_norm(h, llm["norm"], cfg.rms_eps)
    return F.linear(last.to(llm["lm_head"].dtype), llm["lm_head"]).float()


def layer_views(params) -> list[dict]:
    """Each layer's views of the language model's stacked blocks."""
    views = {key: w.unbind(0) for key, w in params["llm"]["blocks"].items()}
    return [{key: v[l] for key, v in views.items()}
            for l in range(len(views["qkv_w"]))]


def _forward(params, cfg: OmniConfig, x, cache, t0: int, routes, layers):
    """The language model over x (B, T, d) float32 at positions t0 .. t0 +
    T - 1 (T > 1 only from position 0: the prefill), each layer's K and V
    written into the cache and its attention reading keys 0 .. t0 + T - 1;
    -> (B, V) float32 logits of the last position."""
    b, t, _ = x.shape
    if t > 1 and t0:
        raise ValueError("a pass of more than one position starts at 0")
    pos = torch.arange(t0, t0 + t, device=x.device)
    h = x
    with sdpa_kernel(_SDPA):
        for l, blk in enumerate(layers or layer_views(params)):
            o = _attend(_attend_in(h, blk, cfg, cache, l, pos), cache, l,
                        t0 + t)
            h, m = _attend_out(h, o, blk, cfg)
            out, kept, p = moe(m.view(b * t, -1), blk, cfg, cache["stats"])
            if routes is not None:
                routes.append((kept.to(torch.int8), p))
            h = h + out.view(b, t, -1)
    return _head(params, cfg, h[:, -1])


class _StepGraphs:
    """The one-token step over a cache's B rows as CUDA graphs, so that the
    host launches a layer in a few calls: per layer one graph of the
    attention's inputs (RMSNorm, q/k/v, RoPE, the cache write at the
    position held in `pos`), the attention itself in between (its length
    grows a step), one graph of Wo, the residual and RMSNorm, and one of
    the MoE (whose groups' sizes never leave the device); then one of the
    head.  The graphs run the functions `_forward` runs, on static
    buffers, and give its bits.  Built at the first step on a cache, for
    the params and layers of that call."""

    def __init__(self, params, cfg: OmniConfig, cache, layers, tokens,
                 pos: int):
        self.params, self.cfg, self.cache = params, cfg, cache
        b, dev = tokens.shape[0], tokens.device
        cd = params["llm"]["lm_head"].dtype
        H, Dh = cfg.n_head, cfg.head_dim
        self.h = torch.zeros(b, 1, cfg.d_model, device=dev)
        self.mid = torch.zeros_like(self.h)
        self.m = torch.zeros(b, cfg.d_model, device=dev)
        self.q = torch.zeros(b, H, 1, Dh, dtype=cd, device=dev)
        self.o = torch.zeros_like(self.q)
        self.kept = torch.zeros(b, cfg.top_k, dtype=torch.long, device=dev)
        self.p = torch.zeros(b, cfg.n_routed + cfg.n_null, device=dev)
        self.logits = torch.zeros(b, cfg.n_vocab, device=dev)
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)
        fns = []
        for l, blk in enumerate(layers):
            fns += [self._in(blk, l), self._out(blk), self._moe(blk)]
        fns.append(lambda: self.logits.copy_(_head(params, cfg,
                                                   self.h[:, 0])))
        # one eager pass on a side stream (the libraries' lazy set-up),
        # then the capture; the step itself is the replay that follows
        self._load(tokens, pos)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), sdpa_kernel(_SDPA):
            for i, fn in enumerate(fns):
                fn()
                if i % 3 == 0 and i < len(fns) - 1:
                    self._attention(i // 3, pos)
        side.synchronize()
        # one memory pool for every graph: they replay in the order they
        # were captured, one at a time, and hand on only through the
        # buffers above
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        with torch.cuda.stream(side):
            for fn in fns:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    g.capture_end()
                self.graphs.append(g)
        torch.cuda.current_stream(dev).wait_stream(side)

    def _in(self, blk, l):
        def fn():
            self.q.copy_(_attend_in(self.h, blk, self.cfg, self.cache, l,
                                    self.pos))
        return fn

    def _out(self, blk):
        def fn():
            h, m = _attend_out(self.h, self.o, blk, self.cfg)
            self.mid.copy_(h)
            self.m.copy_(m.view_as(self.m))
        return fn

    def _moe(self, blk):
        def fn():
            out, kept, p = _moe(self.m, blk, self.cfg, self.cache["stats"])
            self.h.copy_(self.mid + out.view_as(self.mid))
            self.kept.copy_(kept)
            self.p.copy_(p)
        return fn

    def _load(self, tokens, pos: int) -> None:
        self.h.copy_(self.params["llm"]["embed"][tokens][:, None])
        self.pos.fill_(pos)

    def _attention(self, l: int, pos: int) -> None:
        self.o.copy_(_attend(self.q, self.cache, l, pos + 1))

    def run(self, tokens, pos: int, routes=None):
        """The step of tokens (B,) at position `pos` -> (B, V) logits."""
        self._load(tokens, pos)
        g = self.graphs
        rows = tokens.shape[0]
        with sdpa_kernel(_SDPA):
            for l in range(self.cfg.n_layer):
                g[3 * l].replay()
                self._attention(l, pos)
                g[3 * l + 1].replay()
                with TRACE.span("moe", rows, device=True):
                    g[3 * l + 2].replay()
                if routes is not None:
                    routes.append((self.kept.to(torch.int8), self.p.clone()))
        g[-1].replay()
        return self.logits.clone()


def new_cache(cfg: OmniConfig, batch: int, capacity: int, device,
              dtype=torch.bfloat16) -> dict:
    """The KV cache of `batch` rows and `capacity` positions, the rotary
    tables of those positions and the MoE's counts (`_moe`'s stats).  On
    a card in bf16 the steps on it run as CUDA graphs (`_StepGraphs`,
    built at the first step, under "graphs"); else as `_forward` runs
    them (torch's grouped product stays on the device in bf16 only: in
    other dtypes it reads the groups' sizes on the host)."""
    shape = (cfg.n_layer, batch, cfg.n_kv_head, capacity, cfg.head_dim)
    cos, sin = rope_tables(torch.arange(capacity, device=device),
                           cfg.head_dim, cfg.rope_theta)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "cos": cos, "sin": sin,
            "stats": torch.zeros(5, dtype=torch.int64, device=device),
            "graphs": None if dtype == torch.bfloat16 else False}


def prefill(params, cfg: OmniConfig, x, cache, routes=None, layers=None):
    """The prompt's embeddings x (B, T, d) float32 through every layer,
    filling cache positions 0 .. T - 1 -> (B, V) logits of position T - 1.
    layers: `layer_views(params)`, made once for many calls."""
    with TRACE.span("llm_prefill", x.shape[0], device=x.is_cuda):
        return _forward(params, cfg, x, cache, 0, routes, layers)


def step(params, cfg: OmniConfig, tokens, pos: int, cache, routes=None,
         layers=None):
    """One token a row, tokens (B,), at position `pos` -> (B, V) logits."""
    with TRACE.span("llm_step", tokens.shape[0], device=tokens.is_cuda):
        if tokens.is_cuda and cache["graphs"] is not False:
            g = cache["graphs"]
            if g is None or g.params is not params:
                g = cache["graphs"] = _StepGraphs(
                    params, cfg, cache, layers or layer_views(params),
                    tokens, pos)
            return g.run(tokens, pos, routes)
        x = params["llm"]["embed"][tokens].float()[:, None]
        return _forward(params, cfg, x, cache, pos, routes, layers)


# ---------------------------------------------------------------------------
# the speech-to-text path
# ---------------------------------------------------------------------------

def connect(params, enc, cfg: OmniConfig):
    """Encoder output (B, Ta, audio_state) float32 -> (B, n_audio_tokens, d)
    float32: adaptive average pooling over the frames, then the linear
    projector."""
    con = params["connector"]
    pooled = F.adaptive_avg_pool1d(enc.transpose(1, 2), cfg.n_audio_tokens)
    pooled = pooled.transpose(1, 2).to(con["w"].dtype)
    return F.linear(pooled, con["w"]).float() + con["b"]


def prompt_embeddings(params, cfg: OmniConfig, audio):
    """(B, prompt_len, d) float32: the template's head ids, the audio
    tokens (B, n_audio_tokens, d), the tail ids."""
    emb = params["llm"]["embed"]
    dev = audio.device

    def text(ids):
        t = emb[torch.as_tensor(ids, dtype=torch.long, device=dev)].float()
        return t[None].expand(audio.shape[0], -1, -1)
    return torch.cat([text(cfg.prompt_head), audio, text(cfg.prompt_tail)],
                     dim=1)


def greedy(params, cfg: OmniConfig, audio, cache, max_tokens: int,
           routes=None):
    """Greedy transcripts of a batch of windows' audio tokens: prefill,
    then a step a token until `max_tokens` or every row has given eos.
    -> (token ids (B, n) int64, their log-probabilities (B, n) float32),
    on the host; a row's tokens after its eos are to be dropped."""
    x = prompt_embeddings(params, cfg, audio)
    t = x.shape[1]
    layers = layer_views(params)
    cache["stats"].zero_()
    logits = prefill(params, cfg, x, cache, routes, layers)
    toks, lps = [], []
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for j in range(max_tokens):
        tok = logits.argmax(dim=-1)
        lp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
        toks.append(tok)
        lps.append(lp)
        done |= tok == cfg.eos
        if j == max_tokens - 1 or bool(done.all()):
            break
        logits = step(params, cfg, tok, t + j, cache, routes, layers)
    out = torch.stack(toks, 1).cpu(), torch.stack(lps, 1).cpu()
    flush_stats(cache["stats"], cfg, params["llm"]["blocks"]["w13"].dtype)
    return out


def random_params(enc_shapes: dict, cfg: OmniConfig, seed: int = 0,
                  dtype=torch.bfloat16, device="cpu",
                  scale: float = 0.02) -> dict:
    """Random weights: matrices N(0, scale^2) in `dtype` (the encoder's by
    weights/convert.WEIGHT_KEYS), biases N(0, scale^2) and norm scales
    1 + N(0, scale^2) in float32.  enc_shapes: the encoder's leaf shapes
    (weights/convert.param_shapes(...)["encoder"])."""
    from ..weights.convert import WEIGHT_KEYS as ENC_KEYS
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def build(tree, keys):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = build(val, keys)
                continue
            dt = dtype if key in keys else torch.float32
            t = torch.randn(tuple(val), generator=gen, dtype=torch.float32,
                            device=device) * scale
            if key.endswith(("norm", "ln_w")) or key == "ln_post_w":
                t += 1.0
            out[key] = t.to(dt)
        return out
    params = build(param_shapes(cfg), WEIGHT_KEYS)
    params["encoder"] = build(enc_shapes, ENC_KEYS)
    return params
