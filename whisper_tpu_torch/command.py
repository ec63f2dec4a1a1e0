"""Voice-command recognition (examples/command equivalent; copy of
whisper_tpu.command).

Modes, mirroring reference examples/command/command.cpp:
  * guided  — match the spoken phrase against a fixed command list using
              Levenshtein similarity over an always-prompted context
  * grammar — constrain decoding with a GBNF grammar
  * free    — unconstrained short-utterance transcription

Audio comes from a wav file or raw s16le stdin (no SDL microphone in this
environment); utterances are segmented with the same energy VAD the
reference uses (vad_simple).  One flag more than whisper_tpu's: --device
(default "cuda"; "cpu" runs on the CPU, and a CUDA device without a card
raises).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .api import WhisperContext, full_default_params
from .audio.vad import similarity, vad_simple
from .constants import SAMPLE_RATE


def transcribe_utterance(ctx: WhisperContext, pcm: np.ndarray, *,
                         max_tokens: int = 32, grammar=None,
                         grammar_penalty: float = 100.0,
                         initial_prompt: str | None = None,
                         suppress_regex: str | None = None,
                         temperature: float = 0.4,
                         beam_size: int = 5,
                         deterministic: bool = False) -> str:
    """One utterance -> text, with the reference transcribe() decode
    configuration (command.cpp:149-186): beam-5 search at temperature
    0.4 with temperature_inc 1.0 (a single-rung ladder).  Pass
    deterministic=True for greedy t=0 instead (useful for tests)."""
    from .api import SamplingStrategy
    p = full_default_params(SamplingStrategy.GREEDY if deterministic
                            else SamplingStrategy.BEAM_SEARCH)
    p.print_progress = False
    p.single_segment = True
    p.no_timestamps = True
    p.max_tokens = max_tokens
    if deterministic:
        p.temperature = 0.0
        p.temperature_inc = 0.0
    else:
        p.temperature = temperature
        p.temperature_inc = 1.0
        p.greedy.best_of = 5
        p.beam_search.beam_size = beam_size
    p.translate = False
    p.no_context = True
    p.initial_prompt = initial_prompt
    if suppress_regex:
        p.suppress_regex = suppress_regex
    if grammar is not None:
        p.grammar_rules = grammar
        p.grammar_penalty = grammar_penalty
    if ctx.full(p, pcm) != 0:
        return ""
    return "".join(ctx.full_get_segment_text(i)
                   for i in range(ctx.full_n_segments())).strip()


def match_command(text: str, commands: list[str]) -> tuple[int, float]:
    """Best (index, similarity) like the reference's guided mode."""
    best, best_sim = -1, -1.0
    for i, cmd in enumerate(commands):
        sim = similarity(text.lower(), cmd.lower())
        if sim > best_sim:
            best, best_sim = i, sim
    return best, best_sim


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="whisper-command")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", default=None,
                    help="wav input (default: raw s16le stdin)")
    ap.add_argument("-cmd", "--commands", default=None,
                    help="file with one command per line (guided mode)")
    ap.add_argument("--grammar", default=None)
    ap.add_argument("--grammar-rule", default="root")
    ap.add_argument("--grammar-penalty", type=float, default=100.0)
    ap.add_argument("--prompt", default=None)
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    ap.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("--suppress-regex", default=None, dest="suppress_regex")
    ap.add_argument("--deterministic", action="store_true",
                    help="greedy t=0 decode instead of the reference's "
                         "beam-5 @ t=0.4")
    ap.add_argument("--device", default="cuda",
                    help='torch device: "cuda" (the default) or "cpu"')
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    ctx = WhisperContext.from_file(args.model, device=args.device)

    commands = None
    if args.commands:
        commands = [ln.strip() for ln in open(args.commands)
                    if ln.strip() and not ln.startswith("#")]
        print(f"guided mode: {len(commands)} commands", file=sys.stderr)

    grammar = None
    if args.grammar:
        from .grammar import grammar_from_gbnf
        grammar = grammar_from_gbnf(open(args.grammar).read(),
                                    args.grammar_rule)
        print("grammar mode", file=sys.stderr)

    # utterance source: segment audio at VAD boundaries
    if args.file:
        from .audio.io import load_audio
        pcm, _ = load_audio(args.file)
        chunks = [pcm]  # whole file = one utterance in offline mode
    else:
        chunks = _vad_utterances_stdin(args.vad_thold, args.freq_thold)

    for pcm in chunks:
        text = transcribe_utterance(
            ctx, pcm, max_tokens=args.max_tokens, grammar=grammar,
            grammar_penalty=args.grammar_penalty, initial_prompt=args.prompt,
            suppress_regex=args.suppress_regex,
            deterministic=args.deterministic)
        if commands is not None:
            idx, sim = match_command(text, commands)
            print(f"heard: '{text}' -> command [{idx}] "
                  f"'{commands[idx] if idx >= 0 else '?'}' (sim {sim:.2f})",
                  flush=True)
        else:
            print(f"heard: '{text}'", flush=True)
    return 0


def _vad_utterances_stdin(vad_thold: float, freq_thold: float):
    """Yield utterances from raw s16le stdin, split by vad_simple."""
    buf = np.zeros(0, np.float32)
    chunk_bytes = SAMPLE_RATE // 10 * 2  # 100 ms
    while True:
        raw = sys.stdin.buffer.read(chunk_bytes)
        if not raw:
            if len(buf) > SAMPLE_RATE // 2:
                yield buf
            return
        buf = np.concatenate(
            [buf, np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0])
        if len(buf) > 2 * SAMPLE_RATE and vad_simple(
                buf[-2 * SAMPLE_RATE:], SAMPLE_RATE, 1000,
                vad_thold, freq_thold):
            yield buf
            buf = np.zeros(0, np.float32)


if __name__ == "__main__":
    sys.exit(main())
