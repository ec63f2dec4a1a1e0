"""whisper_tpu_torch.audio.native, the port's native C++ audio front end,
built from native/*.cpp into build/whisper_tpu_torch/: its mel within 5e-5
of the numpy mel (and of whisper_tpu's native mel) and its energy within
1e-6 (tests/test_native.py's bounds), its FLAC, MPEG audio and Ogg Vorbis
decoders bit for bit equal to the Python decoders and to whisper_tpu's
load_audio; WTPU_NO_NATIVE=1, read at each call, and a failed build both
leave numpy and the Python decoders to run.  With the native mel on both
sides (the default) and with numpy on both, the serial `full` and the
host-mel BatchTranscriber emit whisper_tpu's segments."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
from tools import flacgen, mp3gen, vorbisgen  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.audio import io as jio  # noqa: E402
from whisper_tpu.audio import native as jnative  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.audio import flac, mp3, native, vorbis  # noqa: E402
from whisper_tpu_torch.audio import io as tio  # noqa: E402
from whisper_tpu_torch.audio.filters import mel_filterbank  # noqa: E402
from whisper_tpu_torch.audio.mel import (_mel_from_padded_np,  # noqa: E402
                                         log_mel_spectrogram, pad_audio)
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402
from whisper_tpu_torch.timestamps import get_signal_energy  # noqa: E402
from whisper_tpu_torch.utils.logging import log_set  # noqa: E402

MEL_TOL = 5e-5        # tests/test_native.py:23
ENERGY_TOL = 1e-6     # tests/test_native.py:29


def _pcm(seconds, seed, amp=0.1):
    return (np.random.RandomState(seed).randn(int(16000 * seconds))
            * amp).astype(np.float32)


def _numpy_mel(pcm, filters):
    padded, n_len, n_len_org = pad_audio(pcm)
    return _mel_from_padded_np(padded, n_len, filters), n_len_org


@pytest.fixture
def native_on(monkeypatch):
    monkeypatch.delenv("WTPU_NO_NATIVE", raising=False)
    assert native.available(), "the native audio front end did not build"


def test_library_lives_in_the_port_build_dir(native_on):
    path = native.native_build.library_path(
        "wtt_audio", native.BUILD_DIR, native.UNITS, native.LINK_FLAGS,
        native.HEADERS)
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libwtt_audio_")
    assert native._load_native()._name == str(path)
    # mp3 and vorbis keep IEEE operation order; no host-specific code
    flags = dict((src.name, f) for src, f in native.UNITS)
    for name in ("wtpu_mp3.cpp", "wtpu_vorbis.cpp"):
        assert "-ffp-contract=off" in flags[name]
        assert "-ffast-math" not in flags[name]
    for name in ("wtpu_audio.cpp", "wtpu_flac.cpp"):
        assert "-ffast-math" in flags[name]
    assert not any("-march" in f for fl in flags.values() for f in fl)


@pytest.mark.parametrize("n_mels,seconds,seed", [(80, 11, 0), (128, 33, 1),
                                                 (80, 0.5, 2)])
def test_native_mel_matches_numpy(native_on, n_mels, seconds, seed):
    filters = mel_filterbank(n_mels)
    pcm = _pcm(seconds, seed)
    want, want_org = _numpy_mel(pcm, filters)
    got, got_org = native.log_mel_spectrogram_native(pcm, filters)
    assert got_org == want_org and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)
    # log_mel_spectrogram takes the native path by default
    mel, org = log_mel_spectrogram(pcm, filters)
    np.testing.assert_array_equal(mel, got)
    assert org == got_org


def test_native_mel_matches_whisper_tpu_native(native_on, record_property):
    """Both packages' libraries compile the same sources (whisper_tpu's
    with -march=native): within the bound, the largest difference
    recorded."""
    if not jnative.available():
        pytest.skip("whisper_tpu's native library did not build")
    filters = mel_filterbank(80)
    pcm = _pcm(20, 3)
    got, got_org = native.log_mel_spectrogram_native(pcm, filters)
    want, want_org = jnative.log_mel_spectrogram_native(pcm, filters)
    diff = float(np.abs(got - want).max())
    record_property("max_abs_diff_vs_whisper_tpu_native", diff)
    print(f"port native mel vs whisper_tpu native mel: max |diff| {diff:.3e}")
    assert got_org == want_org and diff <= MEL_TOL


def test_native_energy_matches(native_on):
    pcm = _pcm(11, 4)
    np.testing.assert_allclose(native.signal_energy_native(pcm, 32),
                               get_signal_energy(pcm, 32), rtol=0,
                               atol=ENERGY_TOL)


def _pcm16(rate, channels, seconds, seed=0):
    t = np.arange(int(rate * seconds)) / rate
    x = 0.4 * np.sin(2 * np.pi * 330 * t)[:, None] * np.ones(channels)
    x += np.random.RandomState(seed).randn(len(t), channels) * 0.05
    return (x * 32767).clip(-32768, 32767).astype(np.int16)


def _encoded():
    return {
        "flac_mono": ("flac", flacgen.encode_flac(_pcm16(16000, 1, 2), 16000,
                                                  bits=16)),
        "flac_stereo": ("flac", flacgen.encode_flac(
            _pcm16(22050, 2, 2, 1), 22050, bits=16, stereo_mode="mid_side")),
        "mp3_mono": ("mp3", mp3gen.gen_l3(seed=7, mpeg=1, sr_idx=0,
                                          bitrate_idx=11,
                                          mode=mp3gen.MODE_MONO)),
        "mp3_joint": ("mp3", mp3gen.gen_l3(seed=8, n_frames=8, mpeg=1,
                                           sr_idx=0, bitrate_idx=9,
                                           mode=mp3gen.MODE_JOINT)),
        "vorbis": ("ogg", vorbisgen.gen_stream(seed=3, secs=1.5)),
    }


@pytest.mark.parametrize("kind", sorted(_encoded()))
def test_decoders_match_python_and_whisper_tpu(native_on, tmp_path, kind):
    ext, data = _encoded()[kind]
    if ext == "flac":
        got, want = native.decode_flac_native(data), flac.decode_flac(data)
        assert got[1:] == want[1:]
    elif ext == "mp3":
        got, want = native.decode_mp3_native(data), mp3.decode_mp3(data)
        assert got[1] == want[1]
    else:
        got = native.decode_ogg_vorbis_native(data)
        want = vorbis.decode_ogg_vorbis(data)
        assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype and got[0].size > 1000
    np.testing.assert_array_equal(got[0], want[0])
    path = tmp_path / f"a.{ext}"
    path.write_bytes(data)
    for stereo in (False, True):
        t_mono, t_st = tio.load_audio(str(path), stereo=stereo)
        j_mono, j_st = jio.load_audio(str(path), stereo=stereo)
        np.testing.assert_array_equal(t_mono, j_mono)
        if stereo:
            np.testing.assert_array_equal(t_st, j_st)


def test_native_decoders_reject_garbage(native_on):
    junk = b"\x00\x01garbage" * 100
    for decode in (native.decode_flac_native, native.decode_mp3_native,
                   native.decode_ogg_vorbis_native):
        with pytest.raises(ValueError, match="native rc="):
            decode(junk)


def test_no_native_is_read_at_each_call(monkeypatch):
    filters = mel_filterbank(80)
    pcm = _pcm(3, 5)
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")
    assert not native.available()
    assert native.log_mel_spectrogram_native(pcm, filters) is None
    assert native.decode_flac_native(b"fLaC") is None
    mel, org = log_mel_spectrogram(pcm, filters)
    want, want_org = _numpy_mel(pcm, filters)
    np.testing.assert_array_equal(mel, want)
    monkeypatch.setenv("WTPU_NO_NATIVE", "0")
    assert native.available()
    mel, _ = log_mel_spectrogram(pcm, filters)
    assert not np.array_equal(mel, want)
    np.testing.assert_allclose(mel, want, rtol=0, atol=MEL_TOL)


def test_build_failure_falls_back_with_a_warning(monkeypatch, tmp_path):
    """Without a C++ compiler the library cannot build: a warning says so,
    the numpy mel and the Python decoders run, and nothing is written into
    the build directory."""
    monkeypatch.delenv("WTPU_NO_NATIVE", raising=False)
    logged = []
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    log_set(lambda level, msg: logged.append(msg))
    native._load_native.cache_clear()
    try:
        assert not native.available()
        filters = mel_filterbank(80)
        pcm = _pcm(2, 6)
        mel, _ = log_mel_spectrogram(pcm, filters)
        np.testing.assert_array_equal(mel, _numpy_mel(pcm, filters)[0])
        _, data = _encoded()["flac_mono"]
        path = tmp_path.parent / f"{tmp_path.name}.flac"
        path.write_bytes(data)
        mono, _ = tio.load_audio(str(path))
        np.testing.assert_array_equal(mono, jio.load_audio(str(path))[0])
    finally:
        log_set(None)
        native._load_native.cache_clear()
    assert any("native audio front end unavailable" in m and "compiler" in m
               for m in logged), logged
    assert len(logged) == 1             # warned once: the failure is cached
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """Seed 3: its windows end in several segments (seed 0's in one)."""
    return write_model(tmp_path_factory.mktemp("native") / "f32.bin", "f32",
                       seed=3)


def _segments(segs):
    return [(s.t0, s.t1, s.text, tuple(t.id for t in s.tokens))
            for s in segs]


def _params(factory):
    p = factory()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.language = "en"
    return p


@pytest.mark.parametrize("mel", ["native", "numpy"])
def test_full_and_host_mel_batch_match_whisper_tpu(model, monkeypatch, mel):
    """whisper_tpu's default host mel is its native one whenever that is
    built; the port's is too.  `full` on 9 s and a host-mel batch of two
    streams, each side's mel the one asked for."""
    if mel == "numpy":
        monkeypatch.setenv("WTPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("WTPU_NO_NATIVE", raising=False)
        assert native.available()
    jctx = JaxContext.from_file(model, compute_dtype=jnp.float32)
    tctx = WhisperContext.from_file(model, compute_dtype=torch.float32,
                                    device="cpu")
    pcm = _pcm(9, 12)
    assert jctx.full(_params(jax_params), pcm) == 0
    assert tctx.full(_params(full_default_params), pcm) == 0
    filters = tctx.filters
    want_mel = (native.log_mel_spectrogram_native(pcm, filters)[0]
                if mel == "native" else _numpy_mel(pcm, filters)[0])
    np.testing.assert_array_equal(tctx.mel, want_mel)
    if mel == "numpy" or jnative.available():
        np.testing.assert_allclose(tctx.mel, np.asarray(jctx.mel), rtol=0,
                                   atol=MEL_TOL)
    assert len(tctx.result_all) >= 3
    assert _segments(tctx.result_all) == _segments(jctx.result_all)

    streams = [pcm, _pcm(5, 13)]
    want = JaxBatch(jctx, batch_size=2, device_mel=False,
                    params=_params(jax_params)).transcribe(streams)
    got = BatchTranscriber(tctx, batch_size=2, device_mel=False,
                           params=_params(full_default_params)).transcribe(
                               streams)
    assert all(got)
    assert [_segments(s) for s in got] == [_segments(s) for s in want]
