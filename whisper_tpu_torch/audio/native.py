"""ctypes bindings for the native (C++) audio front end (port of
whisper_tpu.audio.native): the log-mel, the signal energy, the linear
resampler, and the FLAC, MPEG audio and Ogg Vorbis decoders.

The library is compiled from native/wtpu_audio.cpp, wtpu_flac.cpp,
wtpu_mp3.cpp and wtpu_vorbis.cpp with the host's C++ compiler on first use
into build/whisper_tpu_torch/libwtt_audio_<hash>.so (utils/native_build),
with native/Makefile's flags but -march=native: wtpu_mp3 and wtpu_vorbis
without -ffast-math and with -ffp-contract=off (their arithmetic is pinned
bit for bit to the Python decoders, so IEEE operation order is kept: an
FMA-contracted a*b+c differs from numpy's separate mul and add by ~1 ulp),
the rest with -ffast-math.  Nothing is written into native/.

Every entry point has a numpy or pure-Python fallback (mel.py, flac.py,
mp3.py, vorbis.py), so the library is an accelerator, not a dependency:
WTPU_NO_NATIVE=1, read at each call, switches it off, and a build that
fails warns once and leaves the fallbacks to run.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil  # noqa: F401  (native_build's compiler lookup, shutil.which)
from pathlib import Path

import numpy as np

from ..utils import native_build

PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PKG_DIR.parent / "native"
BUILD_DIR = PKG_DIR.parent / "build" / "whisper_tpu_torch"
_BASE_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread"]
# native/Makefile:15-18, per file
EXACT_FLAGS = _BASE_FLAGS + ["-ffp-contract=off"]
FAST_FLAGS = _BASE_FLAGS + ["-ffast-math"]
UNITS = [(NATIVE_DIR / "wtpu_audio.cpp", FAST_FLAGS),
         (NATIVE_DIR / "wtpu_flac.cpp", FAST_FLAGS),
         (NATIVE_DIR / "wtpu_mp3.cpp", EXACT_FLAGS),
         (NATIVE_DIR / "wtpu_vorbis.cpp", EXACT_FLAGS)]
HEADERS = [NATIVE_DIR / "wtpu_mp3_tables.h"]
LINK_FLAGS = FAST_FLAGS + ["-shared"]


def _load():
    """The library, or None when WTPU_NO_NATIVE=1 or it cannot be built."""
    if os.environ.get("WTPU_NO_NATIVE") == "1":
        return None
    return _load_native()


@functools.lru_cache(maxsize=None)
def _load_native():
    """Build (once per source hash) and load the library; BUILD_DIR is
    read at call time."""
    lib = native_build.load("native audio front end", "wtt_audio", BUILD_DIR,
                            UNITS, LINK_FLAGS, HEADERS)
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32pp = ctypes.POINTER(f32p)
    lib.wtpu_mel_dims.argtypes = [ctypes.c_int, i32p, i32p]
    lib.wtpu_mel_dims.restype = None
    lib.wtpu_log_mel.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                                 f32p, ctypes.c_int]
    lib.wtpu_log_mel.restype = ctypes.c_int
    lib.wtpu_signal_energy.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.wtpu_signal_energy.restype = None
    lib.wtpu_resample_linear.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                         f32p, ctypes.c_int, ctypes.c_int]
    lib.wtpu_resample_linear.restype = ctypes.c_int
    lib.wtpu_flac_probe.argtypes = [u8p, ctypes.c_uint64]
    lib.wtpu_flac_probe.restype = ctypes.c_int
    lib.wtpu_flac_decode.argtypes = [
        u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        u64p, u32p, u32p, u32p, ctypes.c_int]
    lib.wtpu_flac_decode.restype = ctypes.c_int
    lib.wtpu_flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.wtpu_flac_free.restype = None
    for codec in ("mp3", "vorbis"):
        probe = getattr(lib, f"wtpu_{codec}_probe")
        probe.argtypes = [u8p, ctypes.c_uint64]
        probe.restype = ctypes.c_int
        decode = getattr(lib, f"wtpu_{codec}_decode")
        decode.argtypes = [u8p, ctypes.c_uint64, f32pp, u64p, u32p, u32p]
        decode.restype = ctypes.c_int
        free = getattr(lib, f"wtpu_{codec}_free")
        free.argtypes = [f32p]
        free.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(data: bytes) -> tuple:
    """(pointer, owner) over a bytes object: keep `owner` alive while the
    library reads."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf


def log_mel_spectrogram_native(samples: np.ndarray, filters: np.ndarray,
                               n_threads: int = 4):
    """-> ((n_len, n_mel) f32, n_len_org) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    if len(samples) < 201:
        return None  # too short for the reflect pad; numpy path handles it
    filters = np.ascontiguousarray(filters, dtype=np.float32)
    n_len = ctypes.c_int()
    n_len_org = ctypes.c_int()
    lib.wtpu_mel_dims(len(samples), ctypes.byref(n_len),
                      ctypes.byref(n_len_org))
    out = np.empty((n_len.value, filters.shape[0]), dtype=np.float32)
    rc = lib.wtpu_log_mel(_fptr(samples), len(samples), _fptr(filters),
                          filters.shape[0], _fptr(out), n_threads)
    if rc != 0:
        return None
    return out, n_len_org.value


def signal_energy_native(signal: np.ndarray, half_window: int):
    lib = _load()
    if lib is None:
        return None
    signal = np.ascontiguousarray(signal, dtype=np.float32)
    out = np.empty(len(signal), dtype=np.float32)
    lib.wtpu_signal_energy(_fptr(signal), len(signal), half_window, _fptr(out))
    return out


def decode_flac_native(data: bytes, verify_crc: bool = True):
    """Native FLAC decode -> ((n, ch) int32, rate, bits), or None when the
    library is unavailable.  Raises ValueError on malformed streams (same
    contract as audio.flac.decode_flac)."""
    lib = _load()
    if lib is None:
        return None
    ptr, _owner = _u8ptr(data)
    pcm_ptr = ctypes.POINTER(ctypes.c_int32)()
    frames = ctypes.c_uint64()
    channels = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    bits = ctypes.c_uint32()
    rc = lib.wtpu_flac_decode(
        ptr, len(data), ctypes.byref(pcm_ptr), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bits),
        int(verify_crc))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (native rc={rc})")
    try:
        n = frames.value * channels.value
        pcm = np.ctypeslib.as_array(pcm_ptr, shape=(n,)).reshape(
            frames.value, channels.value).copy()
    finally:
        lib.wtpu_flac_free(pcm_ptr)
    return pcm, rate.value, bits.value


def _decode_f32(lib, codec: str, name: str, data: bytes):
    """The MPEG audio and Ogg Vorbis decoders' shared call: -> ((n, ch)
    float32, rate); ValueError on a nonzero return."""
    ptr, _owner = _u8ptr(data)
    pcm_ptr = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_uint64()
    channels = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    rc = getattr(lib, f"wtpu_{codec}_decode")(
        ptr, len(data), ctypes.byref(pcm_ptr), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"{name} decode failed (native rc={rc})")
    try:
        n = frames.value * channels.value
        if n == 0:
            pcm = np.zeros((0, max(1, channels.value)), dtype=np.float32)
        else:
            pcm = np.ctypeslib.as_array(pcm_ptr, shape=(n,)).reshape(
                frames.value, channels.value).copy()
    finally:
        getattr(lib, f"wtpu_{codec}_free")(pcm_ptr)
    return pcm, rate.value


def decode_ogg_vorbis_native(data: bytes):
    """Native Ogg Vorbis decode -> ((n, ch) float32, rate), or None when the
    library is unavailable.  Raises ValueError on malformed streams, exactly
    where audio.vorbis.decode_ogg_vorbis raises."""
    lib = _load()
    if lib is None:
        return None
    return _decode_f32(lib, "vorbis", "Ogg Vorbis", data)


def decode_mp3_native(data: bytes):
    """Native MPEG audio decode -> ((n, ch) float32 = s16/32768, rate), or
    None when the library is unavailable.  Raises ValueError on streams with
    no decodable frames (same contract as audio.mp3.decode_mp3)."""
    lib = _load()
    if lib is None:
        return None
    return _decode_f32(lib, "mp3", "MPEG audio", data)
