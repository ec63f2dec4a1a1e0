"""Segment parity of the port on the card against whisper_tpu's run on the
CPU: the configuration, and the comparison with the golden file.

whisper_tpu's BatchTranscriber decodes a small random-weight q8_0 file
(written by whisper_tpu_torch.weights.ggml_writer from a fixed seed, so
the card writes the same bytes) and streams of noise PCM from fixed
seeds, four greedy and eight beam 5, one 30 s window each, greedy and beam 5 at t = 0.  The
golden file (tests/golden/port_segments.json, written by
tests/test_torch_parity_golden.py with --write) holds each stream's
emitted tokens, each token's top-2 log-prob gap (the distance from the
emitted token's filtered log-prob to the nearest other token's at its
step, from a teacher-forced pass of whisper_tpu's decoder over the
window), and how many tokens are `held`.

bf16 moves a log-prob by up to BF16_NOISE at these dims, so a golden token
is decided only where its gap is at least twice that: the emitted token's
log-prob and its runner-up's may move in opposite directions.  That is
about half the steps, and rarely the first ones: a random-weight micro
model opens every stream with the same few near-tied tokens, so a
free-running bf16 run is vouched for only a few steps in.  Two checks:

- teacher-forced, greedy (check_decided): the port in bf16 on the card,
  each step given the golden tokens before it, must put the golden token
  first at every decided step, and every stream must have at least
  MIN_PREFIX decided steps;
- free-running, both configs (compare): BatchTranscriber must emit each
  stream's held golden tokens; past them a different token is no fault.
  Greedy holds the tokens before the first undecided one.  A beam
  decision is a top-5 over 5 x V candidate scores whose 5th and 6th lie
  closer than the noise at most steps, so no gap vouches for it: beam 5
  holds the tokens that whisper_tpu's own beam kept in each of
  BEAM_TRIALS runs with its filtered log-probs perturbed by uniform noise
  of +-BF16_NOISE, and they must sum to MIN_PREFIX over its streams (no
  stream holds that many alone at this noise).

Imports numpy and the port only: chip_smoke.py and tests/test_torch_gpu.py
use it on the card, which has no JAX.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "golden" / "port_segments.json"
# (n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
#  n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels): heads of
# 64 (K1), widths of 128 (whisper_tpu keeps the decoder packed at them),
# multilingual, 3 decoder layers (2 would mark a distilled model), a text
# context of 96 (room for 33 tokens a window)
DIMS = (51865, 32, 128, 2, 2, 96, 128, 2, 3, 80)
KIND, MODEL_SEED = "q8_0", 11
# the random weights' standard deviation: at the writer's default of 0.02
# the micro model's log-probs are all within ~1 of each other (near-ties
# everywhere); at 0.3 its tokens vary and most steps have a clear winner
WEIGHT_STD = 0.3
# each config's streams, from a scan of seeds 3000-3149 (--search 3000
# 150): greedy the four with the most decided steps (19-20 of
# 33); beam 5 the eight that held the most (4-8 each; the held counts
# move with the noise drawn, so two batches of four)
PCM_SEEDS = {"greedy": (3011, 3032, 3049, 3051),
             "beam5": (3035, 3072, 3114, 3121, 3136, 3137, 3139, 3143)}
PCM_SECONDS = 20
CROSS_MODE = "einsum_q8"
BATCH = 20          # four streams of five beams in one decode call
MAX_TOKENS = 32
MIN_PREFIX = 16     # fewer decided steps a stream (greedy), or held
                    # tokens over the streams (beam 5), fails
# bf16 noise in a log-prob at these dims: on an H100 the port took
# another token at a golden gap of 0.5941 (two log-probs moving ~0.3
# each), and its teacher-forced gaps moved by up to 0.286 (chip_smoke's
# parity phase)
BF16_NOISE = 0.35
BEAM_TRIALS = 12
CONFIGS = ("greedy", "beam5")


def write_model(path) -> str:
    """The random-weight q8_0 file, byte for byte the same on any host."""
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.weights import ggml_writer
    from whisper_tpu_torch.weights.vocab import synthetic_vocab
    hp = dict(zip(ggml_writer.HPARAM_KEYS, DIMS))
    ggml_writer.write_random_model(
        str(path), hp, mel_filterbank(hp["n_mels"]),
        synthetic_vocab(hp["n_vocab"]).id_to_token[:50257], KIND,
        seed=MODEL_SEED, std=WEIGHT_STD)
    return str(path)


def stream(seed: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(16000 * PCM_SECONDS) * 0.1
            * 32768).clip(-32768, 32767).astype(np.int16)


def streams(config: str) -> list[np.ndarray]:
    return [stream(s) for s in PCM_SEEDS[config]]


def params(factory, config: str):
    """bench.py's serving settings (language "en", no timestamps, a 64-token
    carried prompt), max_tokens 32, the ladder off: greedy, or beam 5."""
    p = factory(1 if config == "beam5" else 0)
    p.print_progress = False
    p.language = "en"
    p.no_timestamps = True
    p.n_max_text_ctx = 64
    p.max_tokens = MAX_TOKENS
    p.temperature_inc = 0.0
    if config == "beam5":
        p.beam_search.beam_size = 5
    return p


def stream_tokens(segments) -> list[int]:
    return [t.id for s in segments for t in s.tokens]


def load_golden() -> dict:
    return json.loads(GOLDEN.read_text())


def greedy_held(gaps) -> int:
    """Tokens before the first undecided one."""
    return next((i for i, g in enumerate(gaps) if g < 2 * BF16_NOISE),
                len(gaps))


def compare(config: str, results, golden: dict) -> dict:
    """Hold one config's per-stream segment lists to each stream's `held`
    golden tokens.  -> {"covered": tokens held over all streams, "held":
    each stream's, "agree": each stream's leading tokens equal to the
    golden ones, held or not, "of": golden tokens, "max_plog_diff": the
    largest log-prob difference on a held token}; raises past a mismatch,
    or where beam 5's streams hold fewer than MIN_PREFIX tokens in all."""
    want = golden[config]
    n_held = sum(ref["held"] for ref in want["streams"])
    if config == "beam5" and n_held < MIN_PREFIX:
        raise AssertionError(f"parity {config}: only {n_held} tokens held "
                             f"(< {MIN_PREFIX})")
    held, agree, total = [], [], 0
    max_diff = 0.0
    for si, (segs, ref) in enumerate(zip(results, want["streams"])):
        got = [t for s in segs for t in s.tokens]
        n = ref["held"]
        ids = [t.id for t in got[:n]]
        if ids != ref["tokens"][:n]:
            i = next(i for i, (a, b) in enumerate(
                zip(ids + [None] * n, ref["tokens"][:n])) if a != b)
            raise AssertionError(
                f"parity {config} stream {si}: token {i} is "
                f"{ids[i] if i < len(ids) else None}, golden "
                f"{ref['tokens'][i]} (golden gap {ref['gaps'][i]:.4g})")
        for t, plog in zip(got[:n], ref["plogs"][:n]):
            max_diff = max(max_diff, abs(t.plog - plog))
        held.append(n)
        agree.append(next((i for i, (a, b) in enumerate(
            zip(got, ref["tokens"])) if a.id != b), min(len(got),
                                                      len(ref["tokens"]))))
        total += len(ref["tokens"])
    return {"covered": sum(held), "held": held, "agree": agree, "of": total,
            "max_plog_diff": max_diff}


def decided(gaps) -> list[int]:
    """The steps whose golden gap is at least 2 x BF16_NOISE: no bf16 run
    can take another token there."""
    return [j for j, g in enumerate(gaps) if g >= 2 * BF16_NOISE]


def teacher_forced_gaps(ctx, bt, pcm, tokens) -> np.ndarray:
    """Each golden token's signed gap under the port's decoder and filter
    chain, each step given the golden tokens before it (one decode_prompt
    over the prompt and them, as the golden run's gaps were taken): the
    token's filtered log-prob less the largest other one's, > 0 where the
    port would emit it.  `bt` a BatchTranscriber of `ctx` in "greedy"."""
    import torch
    from whisper_tpu_torch.audio.mel import pad_audio
    from whisper_tpu_torch.constants import HOP_LENGTH, N_FFT
    from whisper_tpu_torch.decode.filters import (FilterConsts,
                                                  make_process_logits)
    from whisper_tpu_torch.models import whisper as wm
    n_ctx = ctx.config.n_audio_ctx
    S = 2 * n_ctx * HOP_LENGTH + N_FFT
    padded = torch.from_numpy(pad_audio(np.asarray(pcm))[0][:S]).to(
        ctx.device)
    (kq, ks), (vq, vs) = bt._encode_batch(padded[None])
    prompt = list(bt.prompt_init)
    T = len(prompt) + len(tokens) - 1
    seq = torch.tensor([prompt + list(tokens[:-1])], dtype=torch.int64,
                       device=ctx.device)
    process = make_process_logits(FilterConsts.from_vocab(ctx.vocab, n_ctx),
                                  bt.opts, device=ctx.device)
    out = []
    with torch.no_grad():
        logits, _, _ = wm.decode_prompt(
            ctx.params, seq, torch.arange(T, device=ctx.device),
            ("q8", kq, ks), ("q8", vq, vs), ctx.config.n_text_head,
            self_mask=wm.make_causal_mask(T, device=ctx.device),
            compute_dtype=ctx.compute_dtype)
        f = torch.zeros((1,), dtype=torch.bool, device=ctx.device)
        for j, tok in enumerate(tokens):
            _, lp, _ = process(
                logits[:, len(prompt) - 1 + j].float(), 0.0,
                is_initial=torch.full((1,), j == 0, device=ctx.device),
                last_was_ts=f, penult_was_ts=~f, has_ts=f,
                seek_delta=torch.zeros((1,), dtype=torch.int32,
                                       device=ctx.device))
            lp = lp[0].double().cpu().numpy()
            others = np.delete(lp, tok)
            out.append(lp[tok] - others.max())
    return np.asarray(out)


def check_decided(gaps_by_stream, golden: dict) -> dict:
    """Hold the port's teacher-forced greedy steps (teacher_forced_gaps,
    one array a stream) to the golden: at every decided step the golden
    token must lead (gap > 0), and each stream must have at least
    MIN_PREFIX decided steps.  -> {"decided": each stream's count,
    "max_gap_change": the largest |port gap - golden gap| over all
    steps}; raises otherwise."""
    counts, change = [], 0.0
    for si, (got, ref) in enumerate(zip(gaps_by_stream,
                                        golden["greedy"]["streams"])):
        steps = decided(ref["gaps"])
        if len(steps) < MIN_PREFIX:
            raise AssertionError(f"parity teacher-forced stream {si}: only "
                                 f"{len(steps)} decided steps "
                                 f"(< {MIN_PREFIX})")
        for j in steps:
            if not got[j] > 0:
                raise AssertionError(
                    f"parity teacher-forced stream {si}: step {j} gives "
                    f"another token (gap {got[j]:.4g}, golden "
                    f"{ref['gaps'][j]:.4g})")
        change = max(change, float(np.abs(np.asarray(got)
                                          - ref["gaps"]).max()))
        counts.append(len(steps))
    return {"decided": counts, "max_gap_change": change}
