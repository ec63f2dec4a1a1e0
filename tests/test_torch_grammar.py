"""whisper_tpu_torch's GBNF grammar decoding against whisper_tpu's: the parser
on both repo grammars; the Python engine's masks and accepts step by step
(and the port's native engine against its Python one); the host filter
chain with grammar, suppress_regex and a logits-filter callback; the port's
device filter chain against the host one; and `full` with a grammar
(speculative greedy at t = 0, best_of 3 at t > 0, beam 5), segments equal.
The speculative path's tokens are the one-token loop's, as
tests/test_full.py holds them for whisper_tpu.

The models are f32 files (no Pallas runs interpreted) whose synthetic
vocab carries grammars/colors.gbnf's pieces at a few ids: the synthetic
" t<i>" tokens alone match nothing, so the grammar would bend nothing."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import MICRO, model_tensors  # noqa: E402
import whisper_tpu as wt  # noqa: E402
import whisper_tpu.grammar as jgram  # noqa: E402
import whisper_tpu_torch as tt  # noqa: E402
import whisper_tpu_torch.grammar as tgram  # noqa: E402
from whisper_tpu.audio.filters import mel_filterbank  # noqa: E402
from whisper_tpu.decode import filters as jfilters  # noqa: E402
from whisper_tpu.decode import host_filters as jhost  # noqa: E402
from whisper_tpu.weights.ggml_writer import write_ggml  # noqa: E402
from whisper_tpu.weights.ggml_reader import Vocab as JVocab  # noqa: E402
from whisper_tpu.weights.ggml_reader import synthetic_vocab  # noqa: E402
from whisper_tpu_torch.decode import filters as tfilters  # noqa: E402
from whisper_tpu_torch.decode import host_filters as thost  # noqa: E402
from whisper_tpu_torch.utils.logging import log_set  # noqa: E402
from whisper_tpu_torch.weights import ggml_writer as twriter  # noqa: E402
from whisper_tpu_torch.weights.vocab import Vocab  # noqa: E402
from whisper_tpu_torch.weights.vocab import synthetic_vocab as tvocab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAMMARS = {name: open(os.path.join(REPO, "grammars", f"{name}.gbnf")).read()
            for name in ("colors", "chess")}
# grammars/colors.gbnf's pieces, and chess.gbnf's, each at an id of its own
PIECE_ID0 = 1000
PIECES = [b" ", b"red", b"green", b"blue", b"yellow", b"purple", b"orange",
          b" and ", b" red", b" green", b" blue", b" and", b" yellow",
          b" pawn", b" knight", b" to ", b" takes ", b"e", b"4", b"d5",
          b",", b".", b" castle kingside", b" check", b"mate", b"and ",
          b"and", b" and red", b"blue and "]


def write_grammar_model(path, kind="f32", dims=MICRO, seed=0):
    """test_torch_ggml.write_model's random-weight file with PIECES in its
    vocab from id PIECE_ID0 on, and their logits raised by 4: the final
    layernorm's bias is a unit vector u and each piece's embedding row
    gains 4u.  The random logits spread ~0.6, so the pieces outrank the
    end-of-text token and the grammar picks among them: windows decode
    more than a token or two."""
    hp, tensors = model_tensors(dims, seed)
    u = np.random.RandomState(seed + 1).randn(hp["n_text_state"])
    u = (u / np.linalg.norm(u)).astype(np.float32)
    tensors["decoder.ln.bias"] = u
    tensors["decoder.token_embedding.weight"][
        PIECE_ID0:PIECE_ID0 + len(PIECES)] += 4.0 * u
    ftype, qtype = twriter.FILE_TYPES[kind]
    tokens = synthetic_vocab(hp["n_vocab"]).id_to_token[:50257]
    tokens[PIECE_ID0:PIECE_ID0 + len(PIECES)] = PIECES
    write_ggml(str(path), hp, mel_filterbank(hp["n_mels"]).astype(np.float32),
               tokens, tensors, ftype=ftype, qtype=qtype)
    return str(path)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return write_grammar_model(tmp_path_factory.mktemp("gram") / "f32.bin")


def _small_vocab(n=3000):
    """A vocab of n text tokens (ids < token_eot = n) with PIECES in it."""
    toks = [b" t%d" % i for i in range(n)]
    toks[PIECE_ID0:PIECE_ID0 + len(PIECES)] = PIECES
    return Vocab(n_vocab=n + 1, id_to_token=toks + [b"<eot>"],
                 token_to_id={t: i for i, t in enumerate(toks)}, token_eot=n)


def _rules(parsed):
    rules, symbols = parsed
    return [[(e.type, e.value) for e in r] for r in rules], symbols


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_parse_gbnf_equal(name):
    src = GRAMMARS[name]
    assert _rules(tgram.parse_gbnf(src)) == _rules(jgram.parse_gbnf(src))
    for bad in ("root ::= (", 'root ::= "a" | x', "root := x"):
        with pytest.raises(jgram.GrammarParseError):
            jgram.parse_gbnf(bad)
        with pytest.raises(tgram.GrammarParseError):
            tgram.parse_gbnf(bad)
    for data in ("é".encode(), b"\xe2\x82", "€x".encode()):
        for partial in (jgram.PartialUtf8(), jgram.PartialUtf8(0x2, 1)):
            cps, out = jgram.decode_utf8(data, partial)
            got, gout = tgram.decode_utf8(
                data, tgram.PartialUtf8(partial.value, partial.n_remain))
            assert (got, gout.value, gout.n_remain) == (
                cps, out.value, out.n_remain)


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_engine_masks_and_accepts_equal(name):
    """Step by step over a small vocab: whisper_tpu's Python engine, the
    port's Python engine and (with a C++ compiler) the port's native one
    give the same penalty mask, then accept the same token."""
    vocab = _small_vocab()
    rules, symbols = tgram.parse_gbnf(GRAMMARS[name])
    jrules, jsymbols = jgram.parse_gbnf(GRAMMARS[name])
    engines = [jgram.Grammar(jrules, jsymbols["root"]),
               tgram.Grammar(rules, symbols["root"])]
    native = tgram._load_native() is not None
    if native:
        engines.append(tgram.NativeGrammar(rules, symbols["root"]))
    rng = np.random.RandomState(len(name))
    n_allowed = []
    for step in range(8):
        masks = []
        for g in engines:
            m = np.zeros(vocab.n_vocab, np.float32)
            g.suppress_invalid(vocab, m, 100.0)
            masks.append(m)
        for m in masks[1:]:
            np.testing.assert_array_equal(m, masks[0], err_msg=f"step {step}")
        allowed = np.nonzero(masks[0][:vocab.token_eot] == 0)[0]
        n_allowed.append(len(allowed))
        if not len(allowed):
            break
        tok = int(rng.choice(allowed))
        forks = [g.copy() for g in engines]
        for g in engines + forks:
            g.accept_token(vocab, tok)
        # a copy advances on its own, as the host beam's forks do
        assert len(engines[1].stacks) == len(forks[1].stacks)
    assert 0 < n_allowed[0] < vocab.token_eot   # the grammar bends
    if not native:
        pytest.skip("no C++ compiler: the native engine was not compared")


def test_native_build_failure_falls_back_with_a_warning(monkeypatch,
                                                        tmp_path):
    """Without a C++ compiler the native engine cannot build: the Python
    engine decodes instead (the same masks), and a warning says so."""
    logged = []
    monkeypatch.setattr(tgram, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tgram.shutil, "which", lambda name: None)
    log_set(lambda level, msg: logged.append(msg))
    tgram._load_native.cache_clear()
    try:
        g = tgram.grammar_from_gbnf(GRAMMARS["colors"])
    finally:
        log_set(None)
        tgram._load_native.cache_clear()
    assert type(g) is tgram.Grammar
    assert any("Python engine" in m for m in logged), logged
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("case", ["initial", "grammar", "regex_callback",
                                  "timestamps_t"])
def test_process_logits_host_equal(case):
    n_vocab = 51865
    toks = synthetic_vocab(n_vocab).id_to_token
    toks[PIECE_ID0:PIECE_ID0 + len(PIECES)] = PIECES
    kw = dict(n_vocab=n_vocab, id_to_token=toks,
              token_to_id={t: i for i, t in enumerate(toks)})
    jvocab, tvocab = JVocab(**kw), Vocab(**kw)
    vocab = tvocab
    consts = {m: m.FilterConsts.from_vocab(v, 1500)
              for m, v in ((jfilters, jvocab), (tfilters, tvocab))}
    opts = {m: m.FilterOptions(suppress_nst=case == "regex_callback")
            for m in (jfilters, tfilters)}
    rng = np.random.RandomState(7)
    logits = (rng.randn(n_vocab) * 3).astype(np.float32)
    logits[PIECE_ID0:PIECE_ID0 + len(PIECES)] += 6.0
    state = dict(temperature=0.0, tokens_cur=[], has_ts=False, seek_delta=0)
    if case in ("grammar", "regex_callback"):
        state["tokens_cur"] = [PIECE_ID0 + 8]              # " red"
    if case == "timestamps_t":
        beg = vocab.token_beg
        state.update(temperature=0.7,
                     tokens_cur=[PIECE_ID0 + 9, beg + 40, beg + 40, 17],
                     has_ts=True, seek_delta=80)
    outs = []
    for mod, gmod, host, v in ((jfilters, jgram, jhost, jvocab),
                               (tfilters, tgram, thost, tvocab)):
        calls = []
        extra = {}
        if case != "initial":
            g = gmod.grammar_from_gbnf(GRAMMARS["colors"],
                                       prefer_native=False)
            for t in state["tokens_cur"]:
                if t < v.token_eot:
                    g.accept_token(v, t)
            extra.update(grammar=g, vocab=v)
        if case == "regex_callback":
            def cb(tokens_cur, lg, calls=calls):
                calls.append(list(tokens_cur))
                lg[PIECE_ID0 + 7] = -np.inf     # " and "
                lg[:50] += 0.5
            extra.update(suppress_regex=r" t1.*", logits_filter_callback=cb)
        out = host.process_logits_host(logits, consts[mod], opts[mod],
                                       **state, **extra)
        outs.append((out, calls))
    (jout, jcalls), (tout, tcalls) = outs
    for got, want in zip(tout, jout):
        np.testing.assert_array_equal(got, want)
    assert tcalls == jcalls
    if case == "regex_callback":
        assert tcalls == [state["tokens_cur"]]


@pytest.mark.parametrize("state", ["initial", "after_text", "after_ts",
                                   "after_ts_pair", "has_ts"])
@pytest.mark.parametrize("opts", [{}, {"no_timestamps": True},
                                  {"suppress_nst": True, "tdrz_enable": True}])
def test_device_filters_match_host(state, opts):
    """decode/filters.py's tensor chain (the window loop's) against the
    numpy host chain, per decoder state (ROADMAP item 10)."""
    vocab = tvocab(51865)
    consts = tfilters.FilterConsts.from_vocab(vocab, 1500)
    o = tfilters.FilterOptions(**opts)
    beg = consts.token_beg
    tokens_cur, has_ts, sd = {
        "initial": ([], False, 0),
        "after_text": ([17, 99], False, 0),
        "after_ts": ([17, beg + 30], True, 60),
        "after_ts_pair": ([beg + 30, beg + 30], True, 60),
        "has_ts": ([beg + 10, 17, 18], True, 20)}[state]
    rng = np.random.RandomState(11)
    logits = (rng.randn(2, vocab.n_vocab) * 2).astype(np.float32)
    logits[1, beg:] += 4.0      # timestamp mass decides in row 1
    process = tfilters.make_process_logits(consts, o, device="cpu")

    def flag(v, dtype=torch.bool):
        return torch.tensor([v, v], dtype=dtype)
    lts = len(tokens_cur) > 0 and tokens_cur[-1] >= beg
    pts = len(tokens_cur) < 2 or tokens_cur[-2] >= beg
    for temp in (0.0, 0.6):
        _, lp, pr = process(torch.from_numpy(logits), temp,
                            flag(not tokens_cur), flag(lts), flag(pts),
                            flag(has_ts), flag(sd, torch.int32))
        for r in range(2):
            _, hlp, hpr = thost.process_logits_host(
                logits[r], consts, o, temperature=temp,
                tokens_cur=tokens_cur, has_ts=has_ts, seek_delta=sd)
            finite = np.isfinite(hlp)
            np.testing.assert_array_equal(np.isfinite(lp[r].numpy()), finite)
            np.testing.assert_allclose(lp[r].numpy()[finite], hlp[finite],
                                       atol=1e-5, rtol=0)
            # the host chain sums in f64: logprobs within 1e-5 are
            # probabilities within a relative 1e-5
            np.testing.assert_allclose(pr[r].numpy(), hpr, rtol=1e-5,
                                       atol=1e-12)


# ---- full() with a grammar -------------------------------------------------

def _noise(seconds, seed):
    return (np.random.RandomState(seed).randn(16000 * seconds)
            .astype(np.float32) * 0.1)


def _segments(ctx):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens])
            for s in ctx.result_all]


def _params(mod, **kw):
    p = mod.full_default_params(kw.pop("strategy", 0))
    p.print_progress = False
    p.temperature_inc = 0.0
    for k, v in kw.items():
        if k == "beam_size":
            p.beam_search.beam_size = v
        elif k == "best_of":
            p.greedy.best_of = v
        else:
            setattr(p, k, v)
    return p


CASES = {
    "speculative": dict(),
    "speculative_regex_seek": dict(suppress_regex=r" red.*",
                                   no_timestamps=True),
    "best_of3_t05": dict(temperature=0.5, best_of=3),
    "beam5": dict(strategy=1, beam_size=5),
    "beam5_no_ts": dict(strategy=1, beam_size=5, no_timestamps=True,
                        single_segment=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_grammar_matches(model_path, case):
    jctx = wt.WhisperContext.from_file(model_path, compute_dtype=jnp.float32)
    tctx = tt.WhisperContext.from_file(model_path, compute_dtype=torch.float32,
                                       device="cpu")
    pcm = _noise(8, 5)
    got = {}
    for tag, ctx, mod, gmod in (("jax", jctx, wt, jgram),
                                ("torch", tctx, tt, tgram)):
        p = _params(mod, **CASES[case])
        p.grammar_rules = gmod.grammar_from_gbnf(GRAMMARS["colors"])
        assert ctx.full(p, pcm) == 0
        got[tag] = _segments(ctx)
    assert got["torch"] == got["jax"]
    assert got["torch"], "no segment: the case decodes nothing"
    # the winning tokens replay through a fresh grammar unpenalized
    vocab = tctx.vocab
    g = tgram.grammar_from_gbnf(GRAMMARS["colors"])
    for _, _, _, ids in got["torch"][:1]:
        for tid in ids:
            if tid >= vocab.token_eot:
                continue
            mask = np.zeros(vocab.n_vocab, np.float32)
            g.suppress_invalid(vocab, mask, 100.0)
            assert mask[tid] == 0.0, (case, tid, vocab.token_str(tid))
            g.accept_token(vocab, tid)
    assert tctx.timings.n_grammar > 0


def test_speculative_equals_one_token_loop(model_path):
    """A no-op logits_filter_callback forces the one-token-per-sync loop:
    the speculative chunks must give exactly its tokens."""
    tctx = tt.WhisperContext.from_file(model_path, compute_dtype=torch.float32,
                                       device="cpu")
    pcm = _noise(6, 9)
    runs = []
    for callback in (None, lambda toks, lg: None):
        p = _params(tt, no_timestamps=True, max_tokens=12)
        p.grammar_rules = tgram.grammar_from_gbnf(GRAMMARS["colors"])
        p.logits_filter_callback = callback
        tctx.timings.reset()
        assert tctx.full(p, pcm) == 0
        runs.append((_segments(tctx), tctx.timings.n_grammar_chunk))
    (spec, n_chunks), (oracle, n_oracle_chunks) = runs
    assert spec == oracle and spec
    assert n_chunks > 0 and n_oracle_chunks == 0
    # several tokens a chunk: fewer host syncs than tokens
    assert n_chunks < sum(len(ids) for *_, ids in spec)


def test_batch_refuses_grammar_with_jax_error(model_path):
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    tctx = tt.WhisperContext.from_file(model_path, compute_dtype=torch.float32,
                                       device="cpu")
    for field, value in (("grammar_rules",
                          tgram.grammar_from_gbnf(GRAMMARS["colors"])),
                         ("logits_filter_callback", lambda toks, lg: None)):
        p = _params(tt)
        setattr(p, field, value)
        with pytest.raises(ValueError, match="host-looped"):
            BatchTranscriber(tctx, batch_size=2, params=p)
