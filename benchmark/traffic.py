"""The general traffic generator: a traffic file's parameters and the run's
seed in, the cell's inputs out.  Imports numpy only at module level (the
load generator's process reads it too); torch only where the device makes
the samples.

Two kinds of traffic, by the file's "entry":

  "transcribe"  sets of `streams` int16 streams of `stream_s` seconds
                each, one set a call, made on the device from the seed;
  "server"      an open loop of requests: clip lengths and the gaps
                between arrivals drawn once from the file's `base_seed`
                (so every seed gets the same work), put in an order drawn
                from the run's seed; each clip's samples from the run's
                seed.

The audio is white noise under a loudness that steps every `block_s`
seconds by up to `gain_db` decibels, so that windows differ from each
other as speech's do.
"""

from __future__ import annotations

import io
import wave

import numpy as np

SAMPLE_RATE = 16000


def seed_for(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use (`purpose`) of the run's seed, which may
    be any whole number."""
    words = [(seed >> s) & 0xFFFFFFFF for s in (0, 32, 64)]
    hi, lo = np.random.SeedSequence(words + [purpose]).generate_state(2)
    return int(hi) << 31 | int(lo) >> 1


def _gains(rng_uniform, n_samples: int, spec: dict):
    """Each sample's gain: one a block of spec["block_s"] seconds, uniform
    in decibels over [-spec["gain_db"], 0]."""
    block = int(spec["block_s"] * SAMPLE_RATE)
    n_blocks = -(-n_samples // block)
    db = -spec["gain_db"] * rng_uniform(n_blocks)
    return 10.0 ** (db / 20.0), block


def stream_sets(spec: dict, seed: int, device) -> list:
    """`spec["input_sets"]` lists of `spec["streams"]` int16 numpy streams:
    uniform white noise of amplitude `spec["amplitude"]` (of full scale)
    under a gain that changes every `block_s` seconds (see _gains), made
    on `device`."""
    import torch
    n = int(spec["stream_s"] * SAMPLE_RATE)
    amp = spec["amplitude"] * 32767
    out = []
    for k in range(spec["input_sets"]):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_for(seed, 10 + k))
        rows = spec["streams"]
        gain, block = _gains(lambda m: torch.rand(
            (rows, m), generator=gen, device=device, dtype=torch.float64),
            n, spec)
        gain = gain.repeat_interleave(block, dim=1)[:, :n]
        noise = torch.rand((rows, n), generator=gen, device=device)
        pcm = torch.round((2 * noise - 1) * amp * gain).to(torch.int16)
        arr = pcm.cpu().numpy()
        out.append([arr[i] for i in range(arr.shape[0])])
    return out


def schedule(spec: dict, seed: int, seconds: float) -> list:
    """The requests of one window: [(due seconds from the window's start,
    clip samples), ...].  The multiset of gaps (exponential, mean 1 /
    rate) and of clip lengths (lognormal, clipped) comes from
    spec["base_seed"]; the run's seed orders them."""
    base = np.random.default_rng(spec["base_seed"])
    rate = spec["rate_per_s"]
    clip = spec["clip_s"]
    gaps = []
    while True:
        g = float(base.exponential(1.0 / rate))
        if sum(gaps) + g > seconds:
            break
        gaps.append(g)
    lengths = np.exp(base.normal(np.log(clip["median"]), clip["sigma"],
                                 len(gaps)))
    lengths = np.clip(lengths, clip["min"], clip["max"])
    samples = np.round(lengths * SAMPLE_RATE).astype(np.int64)
    order = np.random.default_rng(seed_for(seed, 2))
    due = np.cumsum(np.asarray(gaps)[order.permutation(len(gaps))])
    samples = samples[order.permutation(len(samples))]
    return [(float(t), int(s)) for t, s in zip(due, samples)]


def clip_pcm(spec: dict, seed: int, index: int, n_samples: int) -> np.ndarray:
    """Request `index`'s int16 clip (index -1: the warm-up's), white noise
    under block gains as the streams'."""
    rng = np.random.default_rng(seed_for(seed, 1000 + index + 1))
    gain, block = _gains(rng.random, n_samples, spec)
    noise = rng.random(n_samples) * 2 - 1
    pcm = noise * spec["amplitude"] * 32767 * np.repeat(gain, block)[
        :n_samples]
    return np.round(pcm).astype(np.int16)


def wav_bytes(pcm: np.ndarray) -> bytes:
    """16 kHz mono 16-bit WAV."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def multipart(fields: dict, wav: bytes) -> tuple[bytes, str]:
    """(body, content type) of a multipart/form-data request with the
    form fields and `file` = the WAV."""
    boundary = "benchmarkboundary7d1c9a"
    parts = []
    for key, val in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{key}"\r\n\r\n{val}\r\n'.encode())
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="file"; filename="clip.wav"\r\nContent-Type: '
                 f'audio/wav\r\n\r\n'.encode() + wav + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"
