"""Streaming transcription (whisper-stream equivalent; copy of
whisper_tpu.stream).

Mirrors examples/stream/stream.cpp: a sliding window over a live PCM feed
with two modes —

  * fixed-step: every `step_ms`, transcribe the last `length_ms` of audio
    (carrying `keep_ms` of overlap and the previous tokens as prompt);
    commit lines every `n_new_line` steps
  * VAD mode (step_ms <= 0): wait until `vad_simple` detects end of speech,
    then transcribe the utterance

The audio source is any iterator of float32 PCM chunks @16 kHz — a
microphone has no analog in this environment, so sources include a
file-playback simulator and raw s16le stdin (`--file` / stdin).

One flag more than whisper_tpu's: --device (default "cuda"; "cpu" runs on
the CPU, and a CUDA device without a card raises).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Iterator

import numpy as np

from .api import SamplingStrategy, WhisperContext, full_default_params
from .audio.vad import vad_simple
from .constants import SAMPLE_RATE
from .outputs import to_timestamp


class StreamTranscriber:
    """Incremental transcriber over a PCM chunk feed."""

    def __init__(self, ctx: WhisperContext, *,
                 step_ms: int = 3000, length_ms: int = 10000,
                 keep_ms: int = 200, max_tokens: int = 32,
                 vad_thold: float = 0.6, freq_thold: float = 100.0,
                 language: str = "en", translate: bool = False,
                 no_context: bool = True, audio_ctx: int = 0,
                 beam_size: int = -1, no_timestamps: bool | None = None,
                 print_special: bool = False, no_fallback: bool = True):
        self.ctx = ctx
        self.use_vad = step_ms <= 0
        self.step_ms = step_ms if not self.use_vad else 3000
        self.keep_ms = min(keep_ms, self.step_ms)
        self.length_ms = max(length_ms, self.step_ms)
        self.n_samples_step = (SAMPLE_RATE * self.step_ms) // 1000
        self.n_samples_len = (SAMPLE_RATE * self.length_ms) // 1000
        self.n_samples_keep = (SAMPLE_RATE * self.keep_ms) // 1000
        self.n_new_line = (max(1, self.length_ms // self.step_ms - 1)
                           if not self.use_vad else 1)
        self.vad_thold = vad_thold
        self.freq_thold = freq_thold
        self.no_timestamps = (not self.use_vad if no_timestamps is None
                              else no_timestamps)

        self.params = full_default_params(
            SamplingStrategy.BEAM_SEARCH if beam_size > 1
            else SamplingStrategy.GREEDY)
        p = self.params
        p.print_progress = False
        p.print_special = print_special
        p.print_realtime = False
        p.print_timestamps = not self.no_timestamps
        p.translate = translate
        p.single_segment = not self.use_vad
        p.max_tokens = max_tokens
        p.language = language
        p.beam_search.beam_size = beam_size
        p.audio_ctx = audio_ctx
        p.tdrz_enable = False
        # the reference stream KEEPS the temperature fallback unless -nf
        # (stream.cpp:328); the API default stays no-fallback for
        # deterministic streaming, the CLI below exposes -nf like the
        # reference
        if no_fallback:
            p.temperature_inc = 0.0
        p.no_context = True        # context carried via prompt_tokens below
        # VAD mode never carries context (stream.cpp:137 no_context |= use_vad)
        self._keep_context = (not no_context) and not self.use_vad

        self.pcmf32_old = np.zeros(0, np.float32)
        self.prompt_tokens: list[int] = []
        self.n_iter = 0

    def feed_fixed(self, pcmf32_new: np.ndarray):
        """Fixed-step mode: returns list of (final, segments) events."""
        events = []
        # carry formula (reference: stream.cpp:271)
        take = min(len(self.pcmf32_old),
                   max(0, self.n_samples_keep + self.n_samples_len
                       - len(pcmf32_new)))
        pcm = np.concatenate([self.pcmf32_old[len(self.pcmf32_old) - take:],
                              pcmf32_new]).astype(np.float32)
        self.pcmf32_old = pcm

        self.params.prompt_tokens = (list(self.prompt_tokens)
                                     if self._keep_context else None)
        if self.ctx.full(self.params, pcm) != 0:
            return events

        segs = [(self.ctx.full_get_segment_t0(i),
                 self.ctx.full_get_segment_t1(i),
                 self.ctx.full_get_segment_text(i))
                for i in range(self.ctx.full_n_segments())]

        self.n_iter += 1
        final = self.n_iter % self.n_new_line == 0
        if final:
            # keep part of the audio for the next iteration to mitigate
            # word boundary issues (reference: stream.cpp:400-410)
            self.pcmf32_old = pcm[len(pcm) - self.n_samples_keep:].copy()
            if self._keep_context:
                self.prompt_tokens = []
                for i in range(self.ctx.full_n_segments()):
                    for j in range(self.ctx.full_n_tokens(i)):
                        self.prompt_tokens.append(
                            self.ctx.full_get_token_id(i, j))
        events.append((final, segs))
        return events

    def feed_vad(self, window: np.ndarray, pcm_all: np.ndarray):
        """VAD mode: `window` is the last 2 s; transcribe when speech ends."""
        if not vad_simple(window, SAMPLE_RATE, 1000,
                          self.vad_thold, self.freq_thold):
            return None
        self.params.prompt_tokens = (list(self.prompt_tokens)
                                     if self._keep_context else None)
        if self.ctx.full(self.params, pcm_all) != 0:
            return None
        segs = [(self.ctx.full_get_segment_t0(i),
                 self.ctx.full_get_segment_t1(i),
                 self.ctx.full_get_segment_text(i))
                for i in range(self.ctx.full_n_segments())]
        if self._keep_context:
            self.prompt_tokens = []
            for i in range(self.ctx.full_n_segments()):
                for j in range(self.ctx.full_n_tokens(i)):
                    self.prompt_tokens.append(self.ctx.full_get_token_id(i, j))
        return segs


def _wav_chunks(path: str, chunk_ms: int, realtime: bool) -> Iterator[np.ndarray]:
    from .audio.io import load_audio
    pcm, _ = load_audio(path)
    n = (SAMPLE_RATE * chunk_ms) // 1000
    for i in range(0, len(pcm), n):
        if realtime:
            time.sleep(chunk_ms / 1000.0)
        yield pcm[i:i + n]


def _mic_chunks(device: int, chunk_ms: int) -> Iterator[np.ndarray]:
    """Live microphone capture (reference: stream.cpp:118-260 via SDL).

    Prefers the `sounddevice` PortAudio binding when importable (not baked
    into this image — optional); otherwise pipes s16le @16 kHz from an
    `arecord` or `ffmpeg` subprocess.  `device` is the capture device index
    (sounddevice) or ALSA card number (arecord); -1 = system default.
    """
    n = (SAMPLE_RATE * chunk_ms) // 1000
    sd_stream = None
    try:
        import queue

        import sounddevice as sd  # optional dependency

        q: "queue.Queue[np.ndarray]" = queue.Queue()

        def cb(indata, frames, t, status):
            q.put(indata[:, 0].copy())

        # open BEFORE yielding: importable sounddevice with no usable
        # capture device (headless PortAudio) must fall through to the
        # arecord/ffmpeg backends, not crash
        sd_stream = sd.InputStream(samplerate=SAMPLE_RATE, channels=1,
                                   dtype="float32", blocksize=n,
                                   device=None if device < 0 else device,
                                   callback=cb)
        sd_stream.start()
    except Exception:
        sd_stream = None
    if sd_stream is not None:
        try:
            while True:
                yield q.get()
        finally:
            sd_stream.stop()
            sd_stream.close()
        return

    import shutil
    import subprocess

    if shutil.which("arecord"):
        cmd = ["arecord", "-q", "-f", "S16_LE", "-r", str(SAMPLE_RATE),
               "-c", "1", "-t", "raw"]
        if device >= 0:
            cmd += ["-D", f"hw:{device}"]
    elif shutil.which("ffmpeg"):
        src = "default" if device < 0 else f"hw:{device}"
        cmd = ["ffmpeg", "-loglevel", "quiet", "-f", "alsa", "-i", src,
               "-ar", str(SAMPLE_RATE), "-ac", "1", "-f", "s16le", "-"]
    else:
        raise RuntimeError(
            "no capture backend: install `sounddevice`, `arecord` or "
            "`ffmpeg`, or pipe s16le PCM to stdin instead")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    try:
        while True:
            buf = proc.stdout.read(n * 2)
            if not buf:
                return
            yield np.frombuffer(buf, dtype="<i2").astype(np.float32) / 32768.0
    finally:
        proc.kill()


def _stdin_chunks(chunk_ms: int) -> Iterator[np.ndarray]:
    n = (SAMPLE_RATE * chunk_ms) // 1000 * 2  # s16le bytes
    while True:
        buf = sys.stdin.buffer.read(n)
        if not buf:
            return
        yield np.frombuffer(buf, dtype="<i2").astype(np.float32) / 32768.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="whisper-stream")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", default=None,
                    help="wav file to stream (default: raw s16le stdin)")
    ap.add_argument("-c", "--capture", type=int, default=None,
                    metavar="ID",
                    help="capture from microphone ID (-1 = default device; "
                         "needs sounddevice, arecord or ffmpeg)")
    ap.add_argument("--step", type=int, default=3000, dest="step_ms")
    ap.add_argument("--length", type=int, default=10000, dest="length_ms")
    ap.add_argument("--keep", type=int, default=200, dest="keep_ms")
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("-nf", "--no-fallback", action="store_true",
                    dest="no_fallback",
                    help="do not use temperature fallback while decoding")
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    ap.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-tr", "--translate", action="store_true")
    ap.add_argument("-kc", "--keep-context", action="store_true",
                    help="carry decoded tokens as context between steps")
    ap.add_argument("-ac", "--audio-ctx", type=int, default=0)
    ap.add_argument("-bs", "--beam-size", type=int, default=-1)
    ap.add_argument("--realtime", action="store_true",
                    help="simulate real-time playback of --file")
    ap.add_argument("--device", default="cuda",
                    help='torch device: "cuda" (the default) or "cpu"')
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    ctx = WhisperContext.from_file(args.model, device=args.device)
    st = StreamTranscriber(
        ctx, step_ms=args.step_ms, length_ms=args.length_ms,
        # the reference stream zeroes max_tokens post-parse regardless of
        # -mt (stream.cpp:139) and keeps the fallback unless -nf (:328)
        keep_ms=args.keep_ms, max_tokens=0,
        vad_thold=args.vad_thold, freq_thold=args.freq_thold,
        language=args.language, translate=args.translate,
        no_context=not args.keep_context, audio_ctx=args.audio_ctx,
        beam_size=args.beam_size, no_fallback=args.no_fallback)

    chunk_ms = st.step_ms if not st.use_vad else 100
    if args.capture is not None:
        source = _mic_chunks(args.capture, chunk_ms)
    elif args.file:
        source = _wav_chunks(args.file, chunk_ms, args.realtime)
    else:
        source = _stdin_chunks(chunk_ms)

    if st.use_vad:
        ring = np.zeros(0, np.float32)
        for chunk in source:
            ring = np.concatenate([ring, chunk])[-SAMPLE_RATE * 30:]
            window = ring[-SAMPLE_RATE * 2:]
            segs = st.feed_vad(window, ring)
            if segs:
                for t0, t1, text in segs:
                    print(f"[{to_timestamp(t0)} --> {to_timestamp(t1)}] {text}",
                          flush=True)
                ring = np.zeros(0, np.float32)
    else:
        buf = np.zeros(0, np.float32)
        for chunk in source:
            buf = np.concatenate([buf, chunk])
            while len(buf) >= st.n_samples_step:
                cur, buf = buf[:st.n_samples_step], buf[st.n_samples_step:]
                for final, segs in st.feed_fixed(cur):
                    line = "".join(text for _, _, text in segs)
                    end = "\n" if final else "\r"
                    print(line[:120].ljust(120), end=end, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
