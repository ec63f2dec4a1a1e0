"""whisper_tpu_torch's output writers and audio loaders against
whisper_tpu's: every writer's bytes on the same segments (a `full` run of
the port with token timestamps, over an f32 ggml file), and `load_audio`
on WAV, FLAC, MP3 and Ogg Vorbis files made by the repo's encoders in
tools/, the samples bit for bit."""

import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_ggml import write_model  # noqa: E402
from tools import flacgen, mp3gen, vorbisgen  # noqa: E402
from whisper_tpu import outputs as jout  # noqa: E402
from whisper_tpu.audio import io as jio  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch import outputs as tout  # noqa: E402
from whisper_tpu_torch.audio import io as tio  # noqa: E402

SYSINFO = "system info"
PORT_SYSINFO = tout.ctx_system_info    # before the fixture below patches it


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The port's context after `full` with token timestamps, some
    segments' text given a quote, a comma and non-ASCII characters."""
    path = write_model(tmp_path_factory.mktemp("out") / "f32.bin", "f32")
    ctx = WhisperContext.from_file(path, compute_dtype=torch.float32,
                                   device="cpu")
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.token_timestamps = True
    p.max_len = 16
    pcm = (np.random.RandomState(2).randn(16000 * 33) * 0.1).astype(
        np.float32)
    assert ctx.full(p, pcm) == 0
    assert ctx.full_n_segments() >= 3
    ctx.result_all[0].text += ' say "hi", ünï'
    ctx.result_all[1].speaker_turn_next = True
    return ctx


@pytest.fixture(autouse=True)
def same_system_info(monkeypatch):
    for mod in (jout, tout):
        monkeypatch.setattr(mod, "ctx_system_info", lambda: SYSINFO)


def _stereo(ctx):
    n = 16000 * 40
    st = np.random.RandomState(4).randn(n, 2).astype(np.float32)
    st[: n // 2, 0] *= 3.0     # speaker 0 louder in the first half
    return st


WRITERS = {
    "txt": lambda m, c, f, st, font: m.output_txt(c, f),
    "txt_diarize": lambda m, c, f, st, font: m.output_txt(c, f, True, st),
    "vtt": lambda m, c, f, st, font: m.output_vtt(c, f),
    "vtt_diarize": lambda m, c, f, st, font: m.output_vtt(c, f, True, st),
    "srt": lambda m, c, f, st, font: m.output_srt(c, f, offset_n=3),
    "srt_diarize": lambda m, c, f, st, font: m.output_srt(c, f, True, st),
    "csv": lambda m, c, f, st, font: m.output_csv(c, f),
    "csv_diarize": lambda m, c, f, st, font: m.output_csv(c, f, True, st),
    "lrc": lambda m, c, f, st, font: m.output_lrc(c, f),
    "score": lambda m, c, f, st, font: m.output_score(c, f),
    "json": lambda m, c, f, st, font: m.output_json(c, f, {"k": 1}),
    "json_full": lambda m, c, f, st, font: m.output_json(
        c, f, {"k": 1}, full=True, diarize=True, tinydiarize=True,
        pcm_stereo=st),
    "wts": lambda m, c, f, st, font: m.output_wts(c, f, "in.wav", 33.0,
                                                   font),
}


@pytest.mark.parametrize("name", list(WRITERS))
def test_writer_bytes_match_whisper_tpu(ctx, tmp_path, name):
    st = _stereo(ctx)
    font = tmp_path / "font.ttf"    # output_wts needs its font to exist
    font.write_text("")
    out = {}
    for tag, mod in (("jax", jout), ("torch", tout)):
        f = tmp_path / f"{tag}.{name}"
        assert WRITERS[name](mod, ctx, str(f), st, str(font)) is True
        out[tag] = f.read_bytes()
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) > 20


def test_timestamp_helpers_match_whisper_tpu(ctx):
    for t in (0, 1, 99, 6000, 360123, 10**7 + 7):
        for comma in (False, True):
            assert tout.to_timestamp(t, comma) == jout.to_timestamp(t, comma)
    st = _stereo(ctx)
    for t0, t1 in ((0, 500), (1500, 3900), (2000, 2000)):
        for id_only in (False, True):
            assert (tout.estimate_diarization_speaker(st, t0, t1, id_only)
                    == jout.estimate_diarization_speaker(st, t0, t1,
                                                         id_only))


def test_system_info_names_torch():
    info = PORT_SYSINFO()
    assert info.startswith(f"PyTorch {torch.__version__} | backend ")
    assert "jax" not in info.lower()


# -- audio loaders -----------------------------------------------------------

def _pcm16(n, ch, seed):
    x = np.random.RandomState(seed).randn(n, ch) * 6000
    return x.clip(-32768, 32767).astype(np.int16)


def _write_wav(path, data, rate, width=2):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def _files(tmp_path):
    out = {}
    p = tmp_path / "mono16k.wav"
    _write_wav(p, _pcm16(16000 * 2, 1, 1), 16000)
    out["wav_16k_mono"] = p
    p = tmp_path / "stereo44k.wav"
    _write_wav(p, _pcm16(44100, 2, 2), 44100)
    out["wav_44k_stereo"] = p
    p = tmp_path / "u8.wav"
    _write_wav(p, (np.random.RandomState(3).randint(0, 256, (8000, 1))
                   .astype(np.uint8)), 8000, width=1)
    out["wav_8bit_8k"] = p
    p = tmp_path / "mislabeled.wav"            # FLAC bytes named .wav
    p.write_bytes(flacgen.encode_flac(_pcm16(16000, 1, 4), 16000, bits=16))
    out["flac_named_wav"] = p
    p = tmp_path / "a.flac"
    p.write_bytes(flacgen.encode_flac(_pcm16(22050, 2, 5), 22050, bits=16,
                                      stereo_mode="mid_side"))
    out["flac_22k_stereo"] = p
    p = tmp_path / "a.mp3"
    p.write_bytes(mp3gen.gen_l3(seed=7, mpeg=1, sr_idx=0, bitrate_idx=11,
                                mode=mp3gen.MODE_MONO))
    out["mp3_l3"] = p
    p = tmp_path / "noext"                     # found by content sniffing
    p.write_bytes(mp3gen.gen_l3(seed=8, n_frames=8, mpeg=1, sr_idx=0,
                                bitrate_idx=9, mode=mp3gen.MODE_JOINT))
    out["mp3_sniffed"] = p
    p = tmp_path / "a.ogg"
    p.write_bytes(vorbisgen.gen_stream(seed=3, secs=1.5))
    out["vorbis"] = p
    return out


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("audio"))


@pytest.mark.parametrize("kind", ["wav_16k_mono", "wav_44k_stereo",
                                  "wav_8bit_8k", "flac_named_wav",
                                  "flac_22k_stereo", "mp3_l3",
                                  "mp3_sniffed", "vorbis"])
def test_load_audio_matches_whisper_tpu(audio_files, kind):
    path = str(audio_files[kind])
    for stereo in (False, True):
        want_mono, want_st = jio.load_audio(path, stereo=stereo)
        got_mono, got_st = tio.load_audio(path, stereo=stereo)
        assert got_mono.dtype == np.float32
        assert got_mono.shape == want_mono.shape and len(got_mono) > 1000
        np.testing.assert_array_equal(got_mono, want_mono)
        if stereo:
            np.testing.assert_array_equal(got_st, want_st)
        else:
            assert got_st is None and want_st is None


def test_load_audio_rejects_garbage(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"not audio at all" * 64)
    import shutil
    if shutil.which("ffmpeg") is None:
        with pytest.raises(RuntimeError, match="cannot decode"):
            tio.load_audio(str(p))
    with pytest.raises(Exception):
        tio.load_audio(str(tmp_path / "missing.wav"))
