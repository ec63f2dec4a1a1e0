"""Uni-MoE-2.0-Omni's speech-to-text path (models/uni_moe_omni.py and
BatchTranscriber on an AudioLLMContext) against the plain float32
reference (tests/uni_moe_omni_reference.py) on seeded random weights at a
micro size: d 64, 4 query and 2 KV heads, 2 layers, 4 routed + 2 shared +
1 null experts, vocabulary 512, the encoder at width 64 over large-v3's
128 mel bands and 1,500 frames.

Tolerances: the program runs here on float32 weights, so it and the
reference differ by float32 rounding alone, summed in other orders
(grouped against per-head attention, index_add against row updates, one
product for both shared experts against two); F32_TOL bounds that with
room.  The bf16 run differs by bf16 rounding of every product's operands
through two layers: BF16_TOL is a few bf16 ulps of the logits' scale.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import uni_moe_omni_reference as ref
from whisper_tpu_torch import BatchTranscriber, ContinuousBatcher
from whisper_tpu_torch.api import AudioLLMContext, full_default_params
from whisper_tpu_torch.audio.filters import mel_filterbank
from whisper_tpu_torch.audio.mel import log_mel_spectrogram_torch, pad_audio
from whisper_tpu_torch.models import uni_moe_omni as omni
from whisper_tpu_torch.models import whisper as wm
from whisper_tpu_torch.models.whisper import WhisperConfig
from whisper_tpu_torch.utils.trace import Tracer
from whisper_tpu_torch.weights.convert import param_shapes

F32_TOL = 2e-5          # relative to the largest logit
BF16_TOL = 3e-2         # relative to the largest logit
DELTA = 1e-3            # routing margin below which the program's set is taken

ENC = WhisperConfig(512, 1500, 64, 2, 2, 448, 64, 2, 2, 128)
HF = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
      "num_hidden_layers": 2, "vocab_size": 512, "rms_norm_eps": 1e-6,
      "rope_theta": 1e6, "mlp_dynamic_expert_num": 4,
      "mlp_dynamic_null_expert_num": 1, "mlp_fixed_expert_num": 2,
      "dynamic_intermediate_size": 96, "shared_intermediate_size": 32,
      "mlp_dynamic_top_p": 0.7, "mlp_dynamic_top_k": 2,
      "whisper_query_tokens_size": 20, "whisper_hidden_size": 64,
      "encoder_attention_heads": 2, "prompt_head": [11, 12, 13],
      "prompt_tail": [14, 15]}
CFG = omni.OmniConfig(
    n_vocab=512, d_model=64, n_layer=2, n_head=4, n_kv_head=2, head_dim=16,
    routed_ffn=96, shared_ffn=32, n_audio_tokens=20, audio_state=64,
    prompt_head=(11, 12, 13), prompt_tail=(14, 15), eos=512)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _params(dtype=torch.float32, seed=3, scale=0.1):
    # init 0.1: at 0.02 and this width the router's probabilities sit near
    # uniform and no row would keep one expert alone
    return omni.random_params(param_shapes(ENC)["encoder"], CFG, seed=seed,
                              dtype=dtype, scale=scale)


@pytest.fixture(scope="module")
def params():
    return _params()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _layer0(params):
    return {k: v[0] for k, v in params["llm"]["blocks"].items()}


# ---------------------------------------------------------------------------
# routing and the mixture of experts alone
# ---------------------------------------------------------------------------

# planted probabilities over (routed 0-3, null 4), and the kept set each
# must give
PLANTED = [
    ([0.71, 0.1, 0.1, 0.05, 0.04], [0]),         # one entry reaches 0.7
    ([0.69, 0.11, 0.1, 0.05, 0.05], [0, 1]),     # just below: two
    ([0.3, 0.25, 0.2, 0.15, 0.1], [0, 1]),       # the top-2 cap bites
    ([0.05, 0.05, 0.05, 0.05, 0.8], [4]),        # the null expert alone
    ([0.1, 0.1, 0.05, 0.05, 0.7], [4]),          # null at exactly 0.7
    ([0.3, 0.3, 0.3, 0.05, 0.05], [0, 1]),       # exact tie: lower index
    ([0.05, 0.3, 0.05, 0.3, 0.3], [1, 3]),       # tie across the null
    ([0.2, 0.1, 0.6, 0.05, 0.05], [2, 0]),       # the order kept
]


def _planted_rows(rows=PLANTED):
    return torch.tensor([row for row, _ in rows], dtype=torch.float32)


# the rows planted through a router: every one but the row exactly at
# top_p, which the softmax's rounding may put on either side
ROUTED = [r for r in PLANTED if r[0][4] != 0.7]


def test_route_keeps_the_shortest_prefix_reaching_top_p():
    kept, weight = omni.route(_planted_rows(), 0.7, 2)
    for (row, want), got, w in zip(PLANTED, kept.tolist(), weight):
        assert [g for g in got if g >= 0] == want, row
        assert torch.allclose(w[:len(want)],
                              torch.tensor([row[i] for i in want]))
    mine, _ = ref.route(_planted_rows(), 0.7, 2)
    assert torch.equal(mine, kept)


def test_route_margin_is_the_nearest_boundary():
    _, margin = ref.route(_planted_rows(), 0.7, 2)
    want = [0.01, 0.01, 0.05, 0.1, 0.0, 0.0, 0.0, 0.1]
    assert margin.tolist() == pytest.approx(want, abs=1e-6)


def _planted_moe(params):
    """Rows m whose router probabilities are PLANTED exactly: m row i is
    c e_i, and column i of the router holds log p_i / c."""
    blk = dict(_layer0(params))
    c = 4.0
    logp = _planted_rows(ROUTED).log()
    n = logp.shape[0]
    router = torch.zeros_like(blk["router_w"])
    router[:, :n] = (logp / c).T
    blk["router_w"] = router
    m = torch.zeros(n, CFG.d_model)
    m[torch.arange(n), torch.arange(n)] = c
    m += 0.01 * torch.randn(n, CFG.d_model,
                            generator=torch.Generator().manual_seed(1)) \
        * (torch.arange(CFG.d_model) >= n)
    return blk, m


def test_moe_layer_against_the_reference(params):
    blk, m = _planted_moe(params)
    tr = Tracer()
    import whisper_tpu_torch.models.uni_moe_omni as mod
    old, mod.TRACE = mod.TRACE, tr
    tr.enable()
    stats = torch.zeros(5, dtype=torch.int64)
    try:
        got, mine, probs = omni.moe(m, blk, CFG, stats)
        omni.flush_stats(stats, CFG, torch.float32)
    finally:
        mod.TRACE = old
    assert stats.abs().sum() == 0
    ar = ref.Arith("f32")
    p = torch.softmax(m @ blk["router_w"].T, dim=-1)
    assert torch.allclose(p, _planted_rows(ROUTED), atol=1e-6)
    assert torch.equal(probs, p)
    kept, _ = ref.route(p, 0.7, 2)
    assert torch.equal(mine, kept)
    assert [[e for e in k if e >= 0] for k in kept.tolist()] == \
        [want for _, want in ROUTED]
    want, routed = ref.mixture(ar, m, p, kept, ref.layer_experts(ar, blk),
                               HF)
    assert _rel(got, want) < F32_TOL
    s = tr.summary()
    assert s["moe_tokens"]["value"] == len(ROUTED)
    assert s["moe_routed"]["value"] == routed == sum(
        sum(e < 4 for e in ks) for _, ks in ROUTED)
    assert s["moe_null"]["value"] == sum(4 in ks for _, ks in ROUTED)
    hit = len({e for _, ks in ROUTED for e in ks if e < 4})
    one, shared = omni.expert_bytes(CFG, torch.float32)
    assert s["moe_bytes"]["value"] == hit * one + shared
    assert s["moe"]["count"] == 1 and s["moe"]["value"] == len(ROUTED)


def test_null_only_row_gets_the_shared_experts_alone(params):
    blk, m = _planted_moe(params)
    got = omni.moe(m, blk, CFG)[0]
    ar = ref.Arith("f32")
    ex = ref.layer_experts(ar, blk)
    p = torch.softmax(m @ blk["router_w"].T, dim=-1)
    none = torch.full((len(ROUTED), 2), -1)
    shared_only, routed = ref.mixture(ar, m, p, none, ex, HF)
    assert routed == 0
    for i, (_, want) in enumerate(ROUTED):
        if want == [4]:
            assert _rel(got[i], shared_only[i]) < F32_TOL
        else:
            assert _rel(got[i], shared_only[i]) > 1e-3


# ---------------------------------------------------------------------------
# the blocks, prefill and the cache
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_are_the_references():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 7, 64, generator=g)
    w = 1 + 0.1 * torch.randn(64, generator=g)
    assert torch.allclose(omni.rms_norm(x, w, 1e-6), ref._rms(x, w, 1e-6),
                          rtol=1e-6, atol=1e-6)
    q = torch.randn(4, 9, 16, generator=g)
    cos, sin = omni.rope_tables(torch.arange(9), 16, 1e6)
    assert torch.allclose(omni.rope(q, cos, sin), ref._rope(q, 1e6),
                          rtol=1e-6, atol=1e-6)
    # position 0 is the identity; the two halves rotate as pairs
    assert torch.equal(omni.rope(q, cos, sin)[:, 0], q[:, 0])


def _tokens(n, seed=5):
    return torch.randint(0, 512, (n,), generator=torch.Generator()
                         .manual_seed(seed)).tolist()


def _audio(params, b, seed=6):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, CFG.n_audio_tokens, CFG.d_model, generator=g)


def _reference(params, audio, ids, first, handed=None, delta=DELTA):
    return ref.forward(params, HF, list(audio), [list(CFG.prompt_tail) + t
                                                 for t in ids],
                       [first] * len(ids), ref.Arith("f32"), handed, delta)


def _routes(routes, b, t_prompt, n_steps):
    """The program's route records -> per row (T, L, top_k) kept ids."""
    L = CFG.n_layer
    pre = torch.stack([k.view(b, t_prompt, -1) for k, _ in routes[:L]], 2)
    if n_steps:
        st = torch.stack([k for k, _ in routes[L:]]).view(n_steps, L, b, -1)
        pre = torch.cat([pre, st.permute(2, 0, 1, 3)], 1)
    return [r.numpy() for r in pre]


def test_prefill_then_steps_through_the_cache_match_the_full_pass(params):
    """Prefill over the prompt, then one token a step through the cache:
    each step's logits are the reference's teacher-forced full pass at
    that position."""
    b, n = 3, 6
    audio = _audio(params, b)
    ids = [_tokens(n, seed=s) for s in range(b)]
    x = omni.prompt_embeddings(params, CFG, audio)
    t = x.shape[1]
    cache = omni.new_cache(CFG, b, t + n, "cpu", torch.float32)
    routes = []
    with torch.no_grad():
        logits = [omni.prefill(params, CFG, x, cache, routes)]
        for j in range(n - 1):
            tok = torch.tensor([row[j] for row in ids])
            logits.append(omni.step(params, CFG, tok, t + j, cache, routes))
    got = torch.stack(logits, 1)                    # (b, n, V)
    with torch.no_grad():
        out = _reference(params, audio, [row[:-1] for row in ids], t - 1,
                         _routes(routes, b, t, n - 1))
    assert sum(out["wide"]) == 0
    for r in range(b):
        assert _rel(got[r], out["logits"][r]) < F32_TOL
    # the prefill alone over the whole sequence gives the last logits too
    full = torch.cat([x, params["llm"]["embed"][torch.tensor(
        [row[:-1] for row in ids])].float()], 1)
    with torch.no_grad():
        last = omni.prefill(params, CFG, full, omni.new_cache(
            CFG, b, t + n, "cpu", torch.float32))
    assert _rel(last, got[:, -1]) < F32_TOL


def test_cache_holds_each_position_once(params):
    b = 2
    audio = _audio(params, b)
    x = omni.prompt_embeddings(params, CFG, audio)
    t = x.shape[1]
    cache = omni.new_cache(CFG, b, t + 4, "cpu", torch.float32)
    with torch.no_grad():
        omni.prefill(params, CFG, x, cache)
        assert cache["k"][:, :, :, t:].abs().max() == 0
        omni.step(params, CFG, torch.tensor([1, 2]), t, cache)
    assert (cache["k"][:, :, :, t].abs().amax(-1) > 0).all()
    assert cache["k"][:, :, :, t + 1:].abs().max() == 0


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _mel(pcm, seek=0):
    padded, _, _ = pad_audio(pcm)
    n = 3000 * 160 + 400
    win = np.zeros(n, np.float32)
    part = padded[seek * 160: seek * 160 + n].astype(np.float32)
    win[:len(part)] = part / 32768.0
    return log_mel_spectrogram_torch(torch.from_numpy(win)[None], torch
                                     .from_numpy(mel_filterbank(128)))[
        :, :3000]


def _pcm(n_s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(16000 * n_s) * 4000).astype(np.int16)


# bf16 moves the router's probabilities by up to ~1e-2 here: the program's
# set is taken within 0.05 of a boundary
@pytest.mark.parametrize("dtype,tol,delta", [
    (torch.float32, F32_TOL, DELTA), (torch.bfloat16, BF16_TOL, 0.05)],
    ids=["f32", "bf16"])
def test_whole_model_teacher_forced_logits(dtype, tol, delta):
    """Encoder, connector, prefill over the prompt and the tokens: the
    program's logits at every judged position against the reference's."""
    params = _params(dtype)
    pcm = _pcm(20, 1)
    mel = _mel(pcm)
    ids = _tokens(8)
    with torch.no_grad():
        enc = wm.encode(params, mel, n_head=2, compute_dtype=dtype,
                        attn_impl="einsum")
        audio = omni.connect(params, enc, CFG)
        x = omni.prompt_embeddings(params, CFG, audio)
        t = x.shape[1]
        seq = torch.cat([x, params["llm"]["embed"][torch.tensor(
            [ids])].float()], 1)
        routes = []
        cache = omni.new_cache(CFG, 1, seq.shape[1], "cpu", dtype)
        prog = [omni.prefill(params, CFG, seq[:, :t + i],
                             omni.new_cache(CFG, 1, seq.shape[1], "cpu",
                                            dtype))[0]
                for i in range(len(ids) + 1)]
        omni.prefill(params, CFG, seq, cache, routes)
        ar = ref.Arith("f32")
        r_audio = ref.connect(params["connector"],
                              ref.encode(params["encoder"], mel[0], 2, ar),
                              CFG.n_audio_tokens, ar)
        out = _reference(params, r_audio[None], [ids], t - 1,
                         _routes(routes, 1, seq.shape[1], 0), delta)
    assert sum(out["wide"]) == 0
    assert _rel(audio[0], r_audio) < (F32_TOL if dtype == torch.float32
                                      else BF16_TOL)
    assert _rel(torch.stack(prog), out["logits"][0]) < tol


def _context(params, **llm):
    return AudioLLMContext(ENC, dataclasses.replace(CFG, **llm), params,
                           device="cpu", compute_dtype=torch.float32)


def _transcriber(ctx, batch=3, max_tokens=5, **kw):
    p = full_default_params()
    p.no_timestamps, p.temperature_inc, p.max_tokens = True, 0.0, max_tokens
    p.print_progress = False
    for k, v in kw.items():
        setattr(p, k, v)
    return BatchTranscriber(ctx, batch_size=batch, params=p, device_mel=True)


def test_transcribe_gives_one_segment_a_window(params):
    """Four streams at batch 3 (two rounds): one segment a 30 s window of
    max_tokens tokens, each the greedy choice of the reference's logits
    where the program's routing is taken near a boundary."""
    bt = _transcriber(_context(params))
    bt.warmup(pcm_dtype=np.int16)
    streams = [_pcm(n, 10 + n) for n in (40, 65, 12, 31)]
    bt.routes = {}
    out = bt.transcribe(streams)
    ar = ref.Arith("f32")
    for i, (segs, pcm) in enumerate(zip(out, streams)):
        seek_end = 1 + (len(pcm) - 200) // 160
        assert len(segs) == math.ceil((seek_end - 10) / 3000)
        for w, seg in enumerate(segs):
            seek = 3000 * w
            assert (seg.t0, seg.t1) == (seek, min(seek + 3000, seek_end))
            ids = [t.id for t in seg.tokens]
            assert len(ids) == 5 and seg.text == "".join(
                f"<|{t}|>" for t in ids)
            with torch.no_grad():
                audio = ref.connect(params["connector"], ref.encode(
                    params["encoder"], _mel(pcm, seek)[0], 2, ar),
                    CFG.n_audio_tokens, ar)
                kept, _ = bt.routes[(i, seek)]
                res = _reference(params, audio[None], [ids[:-1]],
                                 CFG.prompt_len - 1, [kept])
            assert sum(res["wide"]) == 0
            logits = res["logits"][0]
            lp = torch.log_softmax(logits, -1)
            for j, tok in enumerate(seg.tokens):
                assert logits[j].max() - logits[j, tok.id] < \
                    F32_TOL * logits.abs().max()
                assert tok.plog == pytest.approx(float(lp[j].max()),
                                                 abs=1e-4)
                assert tok.p == pytest.approx(math.exp(tok.plog))


def test_transcript_ends_before_eos(params):
    streams = [_pcm(25, 3), _pcm(25, 4)]
    first = _transcriber(_context(params), batch=2).transcribe(streams)
    ids = [t.id for t in first[0][0].tokens]
    eos = ids[2]
    again = _transcriber(_context(params, eos=eos), batch=2).transcribe(
        streams)
    got = [t.id for t in again[0][0].tokens]
    assert got == ids[:ids.index(eos)]
    other = [t.id for t in first[1][0].tokens]
    assert [t.id for t in again[1][0].tokens] == \
        (other[:other.index(eos)] if eos in other else other)


REFUSED = {
    "timestamps": dict(no_timestamps=False),
    "token_timestamps": dict(token_timestamps=True),
    "beam": dict(strategy=1),
    "sampling": dict(temperature=0.4),
    "ladder": dict(temperature_inc=0.2),
    "auto_language": dict(language="auto"),
    "detect_language": dict(detect_language=True),
    "initial_prompt": dict(initial_prompt="hello"),
    "prompt_tokens": dict(prompt_tokens=[1, 2]),
    "carried_context": dict(no_context=False),
    "grammar": dict(grammar_rules=[[]]),
    "logits_filter": dict(logits_filter_callback=lambda *a: None),
    "no_max_tokens": dict(max_tokens=0),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_supported_refuses(params, case):
    kw = dict(REFUSED[case])
    max_tokens = kw.pop("max_tokens", 5)
    with pytest.raises(ValueError, match="audio-LLM"):
        _transcriber(_context(params), max_tokens=max_tokens, **kw)


def test_check_supported_refuses_a_mesh(params):
    from whisper_tpu_torch.parallel.batch import _check_supported
    p = full_default_params()
    p.no_timestamps, p.temperature_inc, p.max_tokens = True, 0.0, 5
    _check_supported(_context(params), p, None, 2)
    with pytest.raises(ValueError, match="a device mesh"):
        _check_supported(_context(params), p, object(), 2)


def test_continuous_batcher_refuses_an_audio_llm_context(params):
    with pytest.raises(ValueError, match="WhisperContexts"):
        ContinuousBatcher(_context(params), batch_size=2)


def test_reference_copies_are_one_file():
    """The benchmark's copy of the reference is this one, byte for byte."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert (root / "benchmark" / "reference" / "uni_moe_omni.py"
            ).read_bytes() == (root / "tests" / "uni_moe_omni_reference.py"
                               ).read_bytes()
