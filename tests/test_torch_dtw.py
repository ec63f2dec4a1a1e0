"""whisper_tpu_torch's DTW token timestamps against whisper_tpu's: the numpy
helpers and presets exactly; decode_prompt_cross_qk in dense, q8 and q4
cross-KV forms (logits and the captured cross-attention within 1e-5; its
logits decode_prompt's bit for bit, in f32 and bf16);
`full` with DTW (n_top_most 2, and a custom head list), and the batched
DTW pass of BatchTranscriber, t_dtw equal token for token.  A t_dtw that
differs must come from a DTW step that was a tie within 1e-6 on whisper_tpu's
cost matrix.  f32 files and f32 contexts, so no Pallas runs interpreted."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
import whisper_tpu as wt  # noqa: E402
import whisper_tpu.dtw as jdtw  # noqa: E402
import whisper_tpu_torch as tt  # noqa: E402
import whisper_tpu_torch.dtw as tdtw  # noqa: E402
from whisper_tpu.models import whisper as jwm  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch.models import whisper as twm  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

TIE = 1e-6
BACKTRACE = jdtw.dtw_backtrace   # unrecorded, for the tie check


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("dtw") / "f32.bin", "f32")


def _contexts(path, **kw):
    return (wt.WhisperContext.from_file(path, compute_dtype=jnp.float32,
                                        **kw),
            tt.WhisperContext.from_file(path, compute_dtype=torch.float32,
                                        device="cpu", **kw))


def _noise(seconds, seed):
    return (np.random.RandomState(seed).randn(16000 * seconds)
            .astype(np.float32) * 0.1)


# ---- the numpy helpers -----------------------------------------------------

def test_presets_and_head_selection_equal():
    assert tdtw.AHEADS_PRESETS == jdtw.AHEADS_PRESETS
    cases = [(name, 32, 20, 0, None) for name in jdtw.AHEADS_PRESETS]
    cases += [("n_top_most", 6, 4, 2, None), ("n_top_most", 32, 20, 5, None),
              ("custom", 4, 6, 0, [(0, 1), (3, 5), (3, 0)])]
    for preset, L, H, n_top, custom in cases:
        a = tdtw.aheads_for(preset, L, H, n_top, custom)
        assert a == jdtw.aheads_for(preset, L, H, n_top, custom), preset
        if preset in ("n_top_most", "custom"):
            sel = tdtw.head_select_matrix(a, L, H)
            np.testing.assert_array_equal(sel,
                                          jdtw.head_select_matrix(a, L, H))
    with pytest.raises(ValueError):
        tdtw.aheads_for("nope", 4, 4)


@pytest.mark.parametrize("shape", [(1, 7), (5, 5), (9, 40), (23, 300)])
def test_backtrace_and_median_filter_equal(shape):
    rng = np.random.RandomState(sum(shape))
    cost = rng.randn(*shape)
    for got, want in zip(tdtw.dtw_backtrace(cost), jdtw.dtw_backtrace(cost)):
        np.testing.assert_array_equal(got, want)
    x = rng.randn(3, *shape).astype(np.float32)
    for width in (1, 3, 7):
        if shape[-1] > width // 2:
            np.testing.assert_array_equal(tdtw.median_filter(x, width),
                                          jdtw.median_filter(x, width))


# ---- decode_prompt_cross_qk ------------------------------------------------

def _cross_qk_inputs(model_path, form):
    """Both contexts, whisper_tpu's cross-KV of one random mel for 2 rows in
    `form` on each side, a head selection and 40 random tokens."""
    jctx, tctx = _contexts(model_path)
    cfg = tctx.config
    rng = np.random.RandomState(3)
    mel = rng.randn(1, 2 * cfg.n_audio_ctx, cfg.n_mels).astype(np.float32)
    _, kc, vc = jctx._encode_fn(cfg.n_audio_ctx)(jctx.params,
                                                  jnp.asarray(mel))
    kc = torch.from_numpy(np.array(kc)).expand(-1, 2, -1, -1, -1)
    vc = torch.from_numpy(np.array(vc)).expand(-1, 2, -1, -1, -1)
    if form == "dense":
        t_kv = (kc, vc)
        j_kv = (jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()))
    else:
        qfn = (txa.quantize_kv_bhdt if form == "q8"
               else txa.quantize_kv_bhdt_q4)
        t_kv = tuple((form,) + qfn(x.contiguous()) for x in (kc, vc))
        j_kv = tuple((form,) + tuple(jnp.asarray(a.numpy()) for a in t[1:])
                     for t in t_kv)
    aheads = [(0, 1), (2, 3), (2, 0), (1, 2)]
    sel = tdtw.head_select_matrix(aheads, cfg.n_text_layer, cfg.n_text_head)
    toks = rng.randint(0, 50000, size=(2, 40))   # n_text_ctx is 48
    return jctx, tctx, t_kv, j_kv, sel, toks


@pytest.mark.parametrize("form", ["dense", "q8", "q4"])
def test_decode_prompt_cross_qk_matches(model_path, form):
    jctx, tctx, t_kv, j_kv, sel, toks = _cross_qk_inputs(model_path, form)
    cfg = tctx.config
    T = toks.shape[1]
    got_lg, got_qk = twm.decode_prompt_cross_qk(
        tctx.params, torch.from_numpy(toks), torch.arange(T), *t_kv,
        n_head=cfg.n_text_head, head_select=sel,
        self_mask=twm.make_causal_mask(T), compute_dtype=torch.float32)
    want_lg, want_qk = jwm.decode_prompt_cross_qk(
        jctx.params, jnp.asarray(toks), jnp.arange(T), *j_kv,
        n_head=cfg.n_text_head, head_select=jnp.asarray(sel),
        self_mask=jwm.make_causal_mask(T), compute_dtype=jnp.float32)
    assert got_qk.shape == (cfg.n_text_layer, 2, 2, T, cfg.n_audio_ctx)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_qk.numpy(), np.asarray(want_qk),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["dense", "q8", "q4"])
def test_decode_prompt_cross_qk_is_decode_prompts_pass(model_path, form,
                                                       dtype):
    """decode_prompt_cross_qk runs decode_prompt's pass with the
    cross-attention weights captured (their values against whisper_tpu's
    are the test above's): its logits are decode_prompt's bit for bit in
    every cross-KV form and compute dtype, and each selected map is a
    softmax row over the audio frames."""
    _, tctx, t_kv, _, sel, toks = _cross_qk_inputs(model_path, form)
    cfg = tctx.config
    T = toks.shape[1]
    args = (tctx.params, torch.from_numpy(toks), torch.arange(T), *t_kv)
    kw = dict(self_mask=twm.make_causal_mask(T), compute_dtype=dtype)
    with torch.no_grad():
        lg, qk = twm.decode_prompt_cross_qk(*args, cfg.n_text_head, sel,
                                            **kw)
        want, _, _ = twm.decode_prompt(*args, cfg.n_text_head, **kw)
    assert lg.dtype == want.dtype == torch.float32
    assert torch.equal(lg, want)
    assert qk.dtype == torch.float32
    assert qk.shape == (cfg.n_text_layer, 2, 2, T, cfg.n_audio_ctx)
    used = torch.from_numpy(sel).sum(-1) > 0                 # (L, S)
    sums = qk.sum(-1).permute(0, 2, 1, 3)[used]              # (n, B, T)
    torch.testing.assert_close(sums, torch.ones_like(sums), atol=1e-5,
                               rtol=0)
    assert not qk.permute(0, 2, 1, 3, 4)[~used].any()


# ---- t_dtw end to end ------------------------------------------------------

@pytest.fixture
def record_costs(monkeypatch):
    """Each side's DTW cost matrices, in call order."""
    costs = {"jax": [], "torch": []}
    for tag, mod in (("jax", jdtw), ("torch", tdtw)):
        orig = mod.dtw_backtrace

        def rec(cost, _orig=orig, _tag=tag):
            costs[_tag].append(np.array(cost))
            return _orig(cost)
        monkeypatch.setattr(mod, "dtw_backtrace", rec)
    return costs


def _has_tie(cost) -> bool:
    """Whether the accumulated-cost recursion on `cost` chose between two
    predecessors within TIE of each other at some cell."""
    N, M = cost.shape
    acc = np.full((N + 1, M + 1), np.inf)
    acc[0, 0] = 0.0
    tie = False
    for j in range(1, M + 1):
        for i in range(1, N + 1):
            c = sorted((acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]))
            tie |= bool(np.isfinite(c[1]) and c[1] - c[0] <= TIE)
            acc[i, j] = cost[i - 1, j - 1] + c[0]
    return tie


def _assert_t_dtw_equal(got, want, costs):
    """got/want: per-segment [(id, t_dtw)]; token ids must be equal, and
    t_dtw too unless the DTW call that stamped them was a tie."""
    assert [[t for t, _ in s] for s in got] == [[t for t, _ in s]
                                                for s in want]
    if got == want:
        return
    assert len(costs["jax"]) == len(costs["torch"])
    differ = [k for k, (a, b) in enumerate(zip(costs["jax"], costs["torch"]))
              if [x.tolist() for x in BACKTRACE(a)]
              != [x.tolist() for x in BACKTRACE(b)]]
    assert differ, "t_dtw differs but every DTW path is the same"
    for k in differ:
        assert _has_tie(costs["jax"][k]), f"DTW call {k} differs, no tie"


def _stamps(segments):
    return [[(t.id, t.t_dtw) for t in s.tokens] for s in segments]


@pytest.mark.parametrize("kw", [
    dict(dtw_aheads_preset="n_top_most", dtw_n_top=2),
    dict(dtw_aheads_preset="custom", dtw_aheads=[(0, 3), (2, 1), (2, 2)]),
], ids=["n_top_most", "custom"])
def test_full_dtw_matches(model_path, record_costs, kw):
    jctx, tctx = _contexts(model_path, dtw_token_timestamps=True, **kw)
    pcm = _noise(40, 1)
    out = {}
    for tag, ctx, mod in (("jax", jctx, wt), ("torch", tctx, tt)):
        p = mod.full_default_params()
        p.print_progress = False
        p.temperature_inc = 0.0
        calls = []
        # deferred: one call a window, after DTW stamped the tokens
        p.new_segment_callback = lambda c, n, calls=calls: calls.append(
            (c.full_n_segments(), n,
             [t.t_dtw for s in c.result_all[-n:] for t in s.tokens
              if t.id < c.token_eot()]))
        assert ctx.full(p, pcm) == 0
        out[tag] = (ctx.result_all, calls)
    (jsegs, jcalls), (tsegs, tcalls) = out["jax"], out["torch"]
    assert [(s.t0, s.t1, s.text) for s in tsegs] == \
        [(s.t0, s.t1, s.text) for s in jsegs]
    _assert_t_dtw_equal(_stamps(tsegs), _stamps(jsegs), record_costs)
    assert tctx.timings.n_dtw == len(tcalls) >= 2    # 40 s: two windows
    assert [(n_seg, n) for n_seg, n, _ in tcalls] == \
        [(n_seg, n) for n_seg, n, _ in jcalls]
    assert sum(n for _, n, _ in tcalls) == len(tsegs)
    for _, _, stamps in tcalls:
        assert stamps and all(t >= 0 for t in stamps)


def test_batch_dtw_matches(model_path, record_costs):
    jctx, tctx = _contexts(model_path, dtw_token_timestamps=True,
                           dtw_aheads_preset="n_top_most", dtw_n_top=2)
    streams = [_noise(35, 2), _noise(12, 3), _noise(7, 4)]
    got = {}
    for tag, ctx, mod, cls in (("jax", jctx, wt, JaxBatch),
                               ("torch", tctx, tt, BatchTranscriber)):
        p = mod.full_default_params()
        p.print_progress = False
        p.temperature_inc = 0.0
        got[tag] = cls(ctx, batch_size=2, params=p).transcribe(streams)
    assert tctx.timings.n_dtw >= 4
    for tsegs, jsegs in zip(got["torch"], got["jax"]):
        assert [(s.t0, s.t1, s.text) for s in tsegs] == \
            [(s.t0, s.t1, s.text) for s in jsegs]
        assert all(t.t_dtw >= 0 for s in tsegs for t in s.tokens
                   if t.id < tctx.token_eot())
    _assert_t_dtw_equal([s for segs in got["torch"] for s in _stamps(segs)],
                        [s for segs in got["jax"] for s in _stamps(segs)],
                        record_costs)
