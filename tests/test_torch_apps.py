"""whisper_tpu_torch's live-audio applications and tools against
whisper_tpu's, on the same f32 ggml file (the colors words in its vocab),
each context at float32 (the port's on the CPU):

  * audio/vad.py: vad_simple, high_pass_filter, the reference's filter
    and similarity on tests/test_vad_golden.py's LCG cases;
  * stream.py: StreamTranscriber fixed-step (with and without
    keep_context) and VAD mode with audio_ctx, events, segments and
    carried prompt tokens equal; both `main`s print the same stdout;
  * command.py: transcribe_utterance deterministic, at its reference
    defaults (beam 5 at t = 0.4, every draw's winner clear by > 1e-5) and
    under the colors grammar; match_command; both `main`s;
  * chessboard.py: tests/test_wchess.py's games and the grammar at every
    ply, on the port's board and on whisper_tpu's;
  * quantize.py: the same bytes for q4_0, q4_1, q5_0, q5_1 and q8_0;
  * weights/hf.py: the rename table on a synthetic state dict.
"""

import contextlib
import io
import os
import types
import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import test_vad_golden  # noqa: E402
import test_wchess  # noqa: E402
from test_torch_ggml import write_model  # noqa: E402
from test_torch_grammar import write_grammar_model  # noqa: E402
from whisper_tpu import chessboard as jchess  # noqa: E402
from whisper_tpu import command as jcmd  # noqa: E402
from whisper_tpu import quantize as jquant  # noqa: E402
from whisper_tpu import stream as jstream  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.audio import vad as jvad  # noqa: E402
from whisper_tpu.grammar import grammar_from_gbnf as jgrammar  # noqa: E402
from whisper_tpu.weights import hf as jhf  # noqa: E402
from whisper_tpu_torch import WhisperContext  # noqa: E402
from whisper_tpu_torch import chessboard as tchess  # noqa: E402
from whisper_tpu_torch import command as tcmd  # noqa: E402
from whisper_tpu_torch import quantize as tquant  # noqa: E402
from whisper_tpu_torch import stream as tstream  # noqa: E402
from whisper_tpu_torch.audio import vad as tvad  # noqa: E402
from whisper_tpu_torch.decode import rng  # noqa: E402
from whisper_tpu_torch.grammar import grammar_from_gbnf as tgrammar  # noqa: E402
from whisper_tpu_torch.weights import ggml_writer as twriter  # noqa: E402
from whisper_tpu_torch.weights import hf as thf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLORS = os.path.join(REPO, "grammars", "colors.gbnf")
GAP = 1e-5      # a draw's winner must lead its runner-up by more than this
SR = 16000


def _wav(path, pcm_f32):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((pcm_f32 * 32767).clip(-32768, 32767).astype(
            "<i2").tobytes())
    return str(path)


def _noise(seconds, seed, amp=0.1):
    return (np.random.RandomState(seed).randn(int(SR * seconds))
            * amp).astype(np.float32)


def _speech_then_silence(seed=4):
    """2 s of a tone under noise, then 1 s of silence: vad_simple fires on
    the last 2 s."""
    t = np.arange(2 * SR) / SR
    loud = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    loud += _noise(2, seed, 0.05)
    return np.concatenate([loud, np.zeros(SR, np.float32)])


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_grammar_model(tmp_path_factory.mktemp("apps") / "f32.bin")


@pytest.fixture(scope="module")
def contexts(model):
    return (JaxContext.from_file(model, compute_dtype=jnp.float32),
            WhisperContext.from_file(model, compute_dtype=torch.float32,
                                     device="cpu"))


@pytest.fixture
def f32_mains(monkeypatch):
    """Each package's applications load their context at float32."""
    for cls, dtype in ((JaxContext, jnp.float32),
                       (WhisperContext, torch.float32)):
        orig = cls.__dict__["from_file"]
        monkeypatch.setattr(cls, "from_file", classmethod(
            lambda c, path, _f=orig.__func__, _d=dtype, **kw:
            _f(c, path, compute_dtype=_d, **kw)))


def _run_main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    assert rc == 0
    return out.getvalue()


@pytest.fixture
def draw_gaps(monkeypatch):
    """The smallest lead of a winner over its runner-up in logits + Gumbel
    noise, for every categorical draw the port makes."""
    gaps = []
    orig = rng.categorical

    def categorical(key, logits, shape=None):
        gaps.append(rng.categorical_margin(key, logits, shape))
        return orig(key, logits, shape)

    monkeypatch.setattr(rng, "categorical", categorical)
    return gaps


# ---- audio/vad.py ----------------------------------------------------------

@pytest.mark.parametrize("case", test_vad_golden.CASES,
                         ids=[f"seed{c[0]}" for c in test_vad_golden.CASES])
def test_vad_matches_whisper_tpu(case):
    seed, n, amp, tail_ms, last_ms, vt, ft, ref_dec, _ = case
    pcm = test_vad_golden._lcg_noise(seed, n, amp)
    tail = SR * tail_ms // 1000
    if tail:
        pcm[n - tail:] = 0.0
    got = tvad.vad_simple(pcm.copy(), SR, last_ms, vt, ft, verbose=False)
    assert got == jvad.vad_simple(pcm.copy(), SR, last_ms, vt, ft,
                                  verbose=False)
    assert int(got) == ref_dec
    for cutoff in sorted({ft, 100.0} - {0.0}):    # 0: no filter
        np.testing.assert_array_equal(
            tvad.high_pass_filter(pcm.copy(), cutoff, SR),
            jvad.high_pass_filter(pcm.copy(), cutoff, SR))
        np.testing.assert_array_equal(
            tvad._reference_high_pass(pcm, cutoff, SR),
            jvad._reference_high_pass(pcm, cutoff, SR))


def test_similarity_matches_whisper_tpu():
    pairs = [("kitten", "sitting"), ("turn on the lights",
                                     "turn off the lights"),
             ("", "abc"), ("abc", ""), ("red", "red"),
             ("green and blue", "blue and green")]
    for a, b in pairs:
        assert tvad.similarity(a, b) == jvad.similarity(a, b)
    assert tvad.similarity("kitten", "sitting") == pytest.approx(0.571429,
                                                                 abs=1e-6)


# ---- stream.py -------------------------------------------------------------

@pytest.mark.parametrize("keep_context", [False, True],
                         ids=["no-context", "keep-context"])
def test_stream_fixed_step_matches_whisper_tpu(contexts, keep_context):
    """Four 3 s steps over a 10 s window (a line every 2 steps): the same
    events, segments and carried prompt tokens after each step."""
    pcm = _noise(12, 5)
    out = []
    for mod, ctx in zip((jstream, tstream), contexts):
        st = mod.StreamTranscriber(ctx, step_ms=3000, length_ms=10000,
                                   keep_ms=200, max_tokens=32,
                                   no_context=not keep_context)
        assert st.n_new_line == 2 and not st.use_vad
        steps = []
        for i in range(4):
            events = st.feed_fixed(pcm[i * 3 * SR:(i + 1) * 3 * SR])
            steps.append((events, list(st.prompt_tokens),
                          len(st.pcmf32_old)))
        out.append(steps)
    want, got = out
    assert got == want
    assert [ev[0][0] for ev, _, _ in got] == [False, True, False, True]
    assert all(ev[0][1] for ev, _, _ in got)       # segments every step
    if keep_context:
        assert got[-1][1]                          # tokens carried
    else:
        assert not any(toks for _, toks, _ in got)


def test_stream_vad_matches_whisper_tpu(contexts):
    """VAD mode with audio_ctx: no event while the last 2 s hold speech,
    then the whole buffer when it ends; the encoder runs at T = audio_ctx."""
    pcm = _speech_then_silence()
    out = []
    for mod, ctx in zip((jstream, tstream), contexts):
        st = mod.StreamTranscriber(ctx, step_ms=0, audio_ctx=16,
                                   no_context=False)
        assert st.use_vad and st.n_new_line == 1
        quiet = st.feed_vad(pcm[:2 * SR], pcm[:2 * SR])
        segs = st.feed_vad(pcm[-2 * SR:], pcm)
        out.append((quiet, segs, list(st.prompt_tokens),
                    ctx.exp_n_audio_ctx))
    assert out[1] == out[0]
    quiet, segs, tokens, n_ctx = out[1]
    assert quiet is None and segs and n_ctx == 16
    assert tokens == []            # VAD mode never carries context


@pytest.mark.parametrize("argv", [["--step", "2000", "--length", "4000"],
                                  ["--step", "0", "-ac", "16"]],
                         ids=["fixed-step", "vad"])
def test_stream_main_matches_whisper_tpu(model, f32_mains, tmp_path, argv):
    wav = _wav(tmp_path / "s.wav", np.concatenate(
        [_noise(3, 6), _speech_then_silence()]))
    want = _run_main(jstream, ["-m", model, "-f", wav, "-nf", *argv])
    got = _run_main(tstream, ["-m", model, "-f", wav, "-nf", *argv,
                              "--device", "cpu"])
    assert got == want and got.strip()


# ---- command.py ------------------------------------------------------------

@pytest.mark.parametrize("setting", ["deterministic", "defaults", "grammar"])
def test_transcribe_utterance_matches_whisper_tpu(contexts, draw_gaps,
                                                  setting):
    pcm = _noise(3, 3)
    out = []
    for mod, ctx, grammar in zip((jcmd, tcmd), contexts,
                                 (jgrammar, tgrammar)):
        kw = {"deterministic": True} if setting == "deterministic" else {}
        if setting == "grammar":
            kw["grammar"] = grammar(open(COLORS).read(), "root")
        out.append(mod.transcribe_utterance(ctx, pcm, **kw))
    assert out[1] == out[0] and out[1]
    if setting == "defaults":
        assert len(draw_gaps) >= 10 and min(draw_gaps) > GAP, (
            len(draw_gaps), min(draw_gaps, default=None))
    if setting == "grammar":
        words = out[1].replace(" and", "").split()
        assert words and set(words) <= {"red", "green", "blue", "yellow",
                                        "purple", "orange", "and"}


def test_match_command_matches_whisper_tpu():
    commands = ["turn on the lights", "turn off the lights", "stop",
                "red", "green and blue"]
    for heard in ("turn of the light", "stop it", "", "blue and green",
                  "RED"):
        assert tcmd.match_command(heard, commands) == \
            jcmd.match_command(heard, commands)
    assert tcmd.match_command("x", []) == (-1, -1.0)


@pytest.mark.parametrize("mode", ["guided", "grammar"])
def test_command_main_matches_whisper_tpu(model, f32_mains, tmp_path, mode):
    wav = _wav(tmp_path / "c.wav", _noise(2, 8))
    if mode == "guided":
        cmds = tmp_path / "commands.txt"
        cmds.write_text("# colors\nred\ngreen\nblue and green\n\n")
        argv = ["-cmd", str(cmds)]
    else:
        argv = ["--grammar", COLORS, "--grammar-rule", "root"]
    argv = ["-m", model, "-f", wav, "-mt", "8", *argv]
    want = _run_main(jcmd, argv)
    got = _run_main(tcmd, argv + ["--device", "cpu"])
    assert got == want and got.startswith("heard: '")


# ---- entry points: the card by default -------------------------------------

@pytest.mark.parametrize("mod", [tstream, tcmd], ids=["stream", "command"])
def test_main_runs_on_the_card_by_default(model, tmp_path, mod):
    assert mod.build_parser().parse_args(["-m", "x.bin"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    wav = _wav(tmp_path / "a.wav", _noise(1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["-m", model, "-f", wav])


# ---- chessboard.py ---------------------------------------------------------

WCHESS_TESTS = [name for name in dir(test_wchess) if name.startswith("test_")
                and name != "test_grammar_parses_with_engine"]


@pytest.mark.parametrize("name", WCHESS_TESTS)
def test_wchess_games_on_the_port(monkeypatch, name):
    """tests/test_wchess.py's game scripts and grammar checks, played on
    the port's Chessboard."""
    monkeypatch.setattr(test_wchess, "Chessboard", tchess.Chessboard)
    getattr(test_wchess, name)()


def test_chessboard_matches_whisper_tpu():
    """The same commands on both boards: the same results, boards and
    grammars at every ply, and each grammar loads in the port's engine."""
    cmds = ["e4", "e5", "knight f3", "knight c6", "bishop to c4",
            "bishop c5", "queen e2", "d6", "c3", "bishop g4", "d4", "f5",
            "king to e2", "pawn to z9", "castle", "h3"]
    boards = (jchess.Chessboard(), tchess.Chessboard())
    boards[0].set_prompt("knight to f3")
    boards[1].set_prompt("knight to f3")
    for cmd in cmds:
        got = [b.process(cmd) for b in boards]
        assert got[1] == got[0], cmd
        assert boards[1].grammar() == boards[0].grammar()
        assert boards[1].stringify_board() == boards[0].stringify_board()
        assert tgrammar(boards[1].grammar(), "move") is not None


# ---- quantize.py, weights/hf.py --------------------------------------------

@pytest.fixture(scope="module")
def f32_file(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("quant") / "f32.bin", "f32")


@pytest.mark.parametrize("qtype", ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"])
def test_quantize_writes_the_same_bytes(f32_file, tmp_path, qtype):
    want, got = tmp_path / "jax.bin", tmp_path / "torch.bin"
    stats = jquant.quantize_model(f32_file, str(want), qtype)
    assert tquant.quantize_model(f32_file, str(got), qtype) == stats
    assert got.read_bytes() == want.read_bytes()
    assert stats["out_bytes"] < stats["in_bytes"]


def test_quantize_main(f32_file, tmp_path):
    out = tmp_path / "q8.bin"
    assert tquant.main([f32_file, str(out), "q8_0"]) == 0
    want = tmp_path / "want.bin"
    jquant.quantize_model(f32_file, str(want), "q8_0")
    assert out.read_bytes() == want.read_bytes()
    with pytest.raises(ValueError, match="invalid quantization type"):
        tquant.quantize_model(f32_file, str(out), "q3_k")


def _hf_state_dict(n_layers=2, d=8):
    """A synthetic transformers Whisper state dict: every key the rename
    table reaches, plus the tied head and a key it drops."""
    g = torch.Generator().manual_seed(0)
    names = ["model.encoder.conv1.weight", "model.encoder.conv1.bias",
             "model.encoder.conv2.weight", "model.encoder.conv2.bias",
             "model.encoder.embed_positions.weight",
             "model.encoder.layer_norm.weight",
             "model.encoder.layer_norm.bias",
             "model.decoder.embed_tokens.weight",
             "model.decoder.embed_positions.weight",
             "model.decoder.layer_norm.weight",
             "model.decoder.layer_norm.bias", "proj_out.weight",
             "model.decoder.embed_tokens.weight_orig", "lm_scale"]
    for side, attns in (("encoder", ("self_attn",)),
                        ("decoder", ("self_attn", "encoder_attn"))):
        for i in range(n_layers):
            pre = f"model.{side}.layers.{i}."
            for a in attns:
                for p in ("q_proj", "v_proj", "out_proj"):
                    names += [pre + f"{a}.{p}.weight", pre + f"{a}.{p}.bias"]
                names += [pre + f"{a}.k_proj.weight",
                          pre + f"{a}_layer_norm.weight",
                          pre + f"{a}_layer_norm.bias"]
            for p in ("fc1", "fc2", "final_layer_norm"):
                names += [pre + f"{p}.weight", pre + f"{p}.bias"]
    return {n: torch.randn(d, d, generator=g) for n in names}


def test_hf_rename_table_matches_whisper_tpu():
    sd = _hf_state_dict()
    for name in sd:
        assert thf.hf_name_to_ggml(name) == jhf.hf_name_to_ggml(name), name
    got, want = (m.tensors_from_hf_state_dict(sd) for m in (thf, jhf))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # every ggml tensor of a 2-layer model, and nothing else
    hp = dict(zip(twriter.HPARAM_KEYS, (64, 4, 8, 2, 2, 4, 8, 2, 2, 80)))
    assert sorted(got) == sorted(n for n, _ in
                                 twriter.model_tensor_shapes(hp))
    cfg = types.SimpleNamespace(
        vocab_size=51865, max_source_positions=1500, d_model=384,
        encoder_attention_heads=6, encoder_layers=4, max_target_positions=448,
        decoder_attention_heads=6, decoder_layers=4, num_mel_bins=80)
    assert thf.hparams_from_hf_config(cfg) == jhf.hparams_from_hf_config(cfg)
