"""Audio loading utilities (copy of whisper_tpu.audio.io).

The reference decodes wav/mp3/flac/ogg via vendored miniaudio
(reference: examples/common-whisper.cpp:46).  Here WAV is read with the
stdlib, and FLAC, MPEG audio (mp3/mp2/mp1) and Ogg Vorbis through the
native C++ decoders (audio/native.py) when they are built, else the
from-scratch Python decoders (audio/flac.py, audio/mp3.py, audio/vorbis.py):
both give the same samples, bit for bit.  Anything else (e.g.
ogg/opus) shells out to ffmpeg when available (same fallback the
reference server uses, reference: examples/server/server.cpp:248).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import wave

import numpy as np

from ..constants import SAMPLE_RATE
from .resample import resample_ma


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Plain linear-interpolation resampler (mono or (n, ch)).  Kept for
    callers that want interpolation without the reference's low-pass (the
    loaders use resample_ma, which matches the reference's miniaudio
    pipeline — see audio/resample.py)."""
    if sr_in == sr_out:
        return x
    n_out = int(round(x.shape[0] * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    t_in = np.arange(x.shape[0], dtype=np.float64)
    if x.ndim == 1:
        return np.interp(t_out, t_in, x).astype(np.float32)
    return np.stack(
        [np.interp(t_out, t_in, x[:, c]) for c in range(x.shape[1])], axis=1
    ).astype(np.float32)


def load_wav(path: str, stereo: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a WAV file -> (mono f32 @16 kHz, optional (n, 2) stereo f32).

    Mirrors read_audio_data semantics: stereo is averaged to mono; when
    `stereo` is requested the two channels are also returned separately
    (used for diarization, reference: examples/cli/cli.cpp).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        raw = w.readframes(w.getnframes())
        data = _decode_pcm(raw, w.getsampwidth(), n_ch)

    if n_ch == 1:
        mono = data
        st = np.stack([data, data], axis=1) if stereo else None
    else:
        mono = data.mean(axis=1)
        st = data[:, :2] if stereo else None

    mono = resample_ma(mono, sr, SAMPLE_RATE)
    if st is not None:
        st = resample_ma(st, sr, SAMPLE_RATE)
    return mono.astype(np.float32), st


def _finish_decoded(data: np.ndarray, sr: int, stereo: bool
                    ) -> tuple[np.ndarray, np.ndarray | None]:
    """Shared downmix/split + resample tail for the (n, ch) decoders
    (flac/mpeg/vorbis), matching load_wav's contract."""
    n_ch = data.shape[1]
    if n_ch == 1:
        mono = data[:, 0]
        st = np.stack([mono, mono], axis=1) if stereo else None
    else:
        mono = data.mean(axis=1).astype(np.float32)
        st = data[:, :2] if stereo else None
    mono = resample_ma(mono, sr, SAMPLE_RATE)
    if st is not None:
        st = resample_ma(st, sr, SAMPLE_RATE)
    return mono.astype(np.float32), st


def load_flac(path: str, stereo: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a FLAC file -> (mono f32 @16 kHz, optional (n, 2) stereo f32),
    same contract as load_wav.  Uses the native decoder when built, the
    pure-Python one otherwise; sample conversion matches dr_flac exactly
    (see audio.flac.pcm_to_f32)."""
    from .flac import decode_flac, pcm_to_f32
    from .native import decode_flac_native

    with open(path, "rb") as f:
        raw = f.read()
    decoded = decode_flac_native(raw)
    if decoded is None:
        decoded = decode_flac(raw)
    pcm, sr, bits = decoded
    return _finish_decoded(pcm_to_f32(pcm, bits), sr, stereo)


def load_mpeg(path: str, stereo: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """Read an MPEG audio (mp3/mp2/mp1) file, same contract as load_wav.
    Uses the native decoder when built, the pure-Python one otherwise."""
    from .mp3 import decode_mp3
    from .native import decode_mp3_native

    with open(path, "rb") as f:
        raw = f.read()
    try:
        decoded = decode_mp3_native(raw)
    except ValueError:
        decoded = None   # let the Python path raise the precise Mp3Error
    if decoded is None:
        decoded = decode_mp3(raw)
    data, sr = decoded
    return _finish_decoded(data, sr, stereo)


def load_vorbis(path: str, stereo: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """Read an Ogg Vorbis file, same contract as load_wav.  Uses the native
    decoder when built, the pure-Python one otherwise."""
    from .native import decode_ogg_vorbis_native
    from .vorbis import decode_ogg_vorbis

    with open(path, "rb") as f:
        raw = f.read()
    decoded = decode_ogg_vorbis_native(raw)
    if decoded is None:
        decoded = decode_ogg_vorbis(raw)
    data, sr = decoded
    return _finish_decoded(data, sr, stereo)


def load_audio(path: str, stereo: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """Load any audio file; unknown containers go through ffmpeg when available."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            return load_wav(path, stereo=stereo)
        except wave.Error:
            pass  # mislabeled container; try content sniffing below
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    magic = head[:4]
    # route by container magic BEFORE the extension/content MPEG sniff, so a
    # vorbis/flac file named .mp3 (or whose high-entropy payload false-positives
    # the MPEG sync-chain scan) reaches its real decoder
    decode_err: Exception | None = None
    try:
        if magic == b"fLaC":
            return load_flac(path, stereo=stereo)
        if magic == b"OggS":
            from .vorbis import is_ogg_vorbis

            if is_ogg_vorbis(head):
                return load_vorbis(path, stereo=stereo)
            # non-vorbis ogg (e.g. opus): fall through to the ffmpeg fallback
        else:
            from .mp3 import is_mpeg_audio

            if ext in (".mp3", ".mp2", ".mp1") or is_mpeg_audio(head):
                return load_mpeg(path, stereo=stereo)
    except Exception as e:
        # the native decoder rejected the file (corrupt/unsupported stream):
        # prefer the ffmpeg fallback when present, else surface the precise
        # decoder error rather than a generic "install ffmpeg"
        decode_err = e
    if shutil.which("ffmpeg") is None:
        if decode_err is not None:
            raise decode_err
        raise RuntimeError(
            f"cannot decode '{path}': not a PCM wav and ffmpeg is not installed")
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-i", path, "-ar", str(SAMPLE_RATE),
             "-ac", "2" if stereo else "1", "-f", "wav", tmp_path],
            check=True, capture_output=True)
        return load_wav(tmp_path, stereo=stereo)
    finally:
        os.unlink(tmp_path)
