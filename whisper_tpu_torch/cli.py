"""whisper-cli equivalent (copy of whisper_tpu.cli; reference:
examples/cli/cli.cpp).

Same flags, same default behavior: transcribe input files, print segments
with timestamps, write any of txt/vtt/srt/csv/json/lrc/wts/score outputs.
One flag more than whisper_tpu's: --device (default "cuda"; "cpu" runs on
the CPU, and a CUDA device without a card raises).  -ng / --no-gpu means
--device cpu, as whisper.cpp's "no GPU", unless --device is given; -fa and
-oved are accepted and unused.

Usage:  python -m whisper_tpu_torch.cli -m model.bin -f audio.wav [options]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import outputs
from .api import FullParams, SamplingStrategy, WhisperContext, full_default_params
from .audio.io import load_audio
from .dtw import AHEADS_PRESETS
from .grammar import grammar_from_gbnf, parse_gbnf
from .languages import lang_id
from .outputs import to_timestamp
from .utils.logging import set_verbosity

_COLORS = ["\033[38;5;196m", "\033[38;5;202m", "\033[38;5;208m",
           "\033[38;5;214m", "\033[38;5;220m", "\033[38;5;226m",
           "\033[38;5;190m", "\033[38;5;154m", "\033[38;5;118m",
           "\033[38;5;82m"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="whisper-cli", description="whisper.cpp CLI on PyTorch + CUDA")
    a = p.add_argument
    a("-t", "--threads", type=int, default=4)
    a("-p", "--processors", type=int, default=1)
    a("-ot", "--offset-t", type=int, default=0, dest="offset_t_ms")
    a("-on", "--offset-n", type=int, default=0, dest="offset_n")
    a("-d", "--duration", type=int, default=0, dest="duration_ms")
    a("-mc", "--max-context", type=int, default=-1, dest="max_context")
    a("-ml", "--max-len", type=int, default=0, dest="max_len")
    a("-sow", "--split-on-word", action="store_true", dest="split_on_word")
    a("-bo", "--best-of", type=int, default=5, dest="best_of")
    # reference default: whisper_full_default_params(BEAM_SEARCH)
    # .beam_search.beam_size = 5 (cli.cpp:47) — the reference CLI runs
    # beam search by default
    a("-bs", "--beam-size", type=int, default=5, dest="beam_size")
    a("-ac", "--audio-ctx", type=int, default=0, dest="audio_ctx")
    a("-wt", "--word-thold", type=float, default=0.01, dest="word_thold")
    a("-et", "--entropy-thold", type=float, default=2.40, dest="entropy_thold")
    a("-lpt", "--logprob-thold", type=float, default=-1.0, dest="logprob_thold")
    a("-nth", "--no-speech-thold", type=float, default=0.6, dest="no_speech_thold")
    a("-tp", "--temperature", type=float, default=0.0)
    a("-tpi", "--temperature-inc", type=float, default=0.2, dest="temperature_inc")
    a("-debug", "--debug-mode", action="store_true", dest="debug_mode")
    a("-tr", "--translate", action="store_true")
    a("-di", "--diarize", action="store_true")
    a("-tdrz", "--tinydiarize", action="store_true")
    a("-nf", "--no-fallback", action="store_true", dest="no_fallback")
    a("-otxt", "--output-txt", action="store_true", dest="output_txt")
    a("-ovtt", "--output-vtt", action="store_true", dest="output_vtt")
    a("-osrt", "--output-srt", action="store_true", dest="output_srt")
    a("-owts", "--output-words", action="store_true", dest="output_wts")
    a("-olrc", "--output-lrc", action="store_true", dest="output_lrc")
    a("-fp", "--font-path", default="/System/Library/Fonts/Supplemental/Courier New Bold.ttf")
    a("-ocsv", "--output-csv", action="store_true", dest="output_csv")
    a("-oj", "--output-json", action="store_true", dest="output_jsn")
    a("-ojf", "--output-json-full", action="store_true", dest="output_jsn_full")
    a("-of", "--output-file", action="append", default=[], dest="fname_out")
    a("-np", "--no-prints", action="store_true", dest="no_prints")
    a("-ps", "--print-special", action="store_true", dest="print_special")
    a("-pc", "--print-colors", action="store_true", dest="print_colors")
    a("-pp", "--print-progress", action="store_true", dest="print_progress")
    a("-nt", "--no-timestamps", action="store_true", dest="no_timestamps")
    a("-l", "--language", default="en")
    a("-dl", "--detect-language", action="store_true", dest="detect_language")
    a("--prompt", default=None)
    a("-m", "--model", default="models/ggml-base.en.bin")
    a("-f", "--file", action="append", default=[], dest="fname_inp")
    a("-oved", "--ov-e-device", default="CPU")      # accepted, unused
    a("-dtw", "--dtw", default="")
    a("-ls", "--log-score", action="store_true", dest="log_score")
    a("-ng", "--no-gpu", action="store_true",
      help="run on the CPU (--device cpu) unless --device is given")
    a("-fa", "--flash-attn", action="store_true")    # accepted, unused
    a("-sns", "--suppress-nst", action="store_true", dest="suppress_nst")
    a("-kvq", "--kv-q8", action="store_true", dest="kv_q8",
      help="int8 cross-attention KV in the decode loop (halves the decode's "
           "cross-KV traffic)")
    a("-kvq4", "--kv-q4", action="store_true", dest="kv_q4",
      help="4-bit cross-attention KV (quarter traffic; opt-in accuracy "
           "trade — unlike -kvq this is not token-exact vs bf16)")
    a("--suppress-regex", default=None, dest="suppress_regex")
    a("--grammar", default="")
    a("--grammar-rule", default="")
    a("--grammar-penalty", type=float, default=100.0)
    a("--device", default="cuda",
      help='torch device: "cuda" (the default) or "cpu"')
    a("files", nargs="*", help="audio files (same as -f)")
    return p


def cli_params_to_full(args, use_grammar: bool = False) -> FullParams:
    # grammar forces beam search like the reference (cli.cpp:1114-1115:
    # strategy = beam_size > 1 || use_grammar ? BEAM : GREEDY)
    strategy = (SamplingStrategy.BEAM_SEARCH
                if args.beam_size > 1 or use_grammar
                else SamplingStrategy.GREEDY)
    p = full_default_params(strategy)
    p.print_realtime = False
    p.print_progress = args.print_progress
    p.print_timestamps = not args.no_timestamps
    p.print_special = args.print_special
    p.translate = args.translate
    p.language = args.language
    p.detect_language = args.detect_language
    p.n_threads = args.threads
    p.n_max_text_ctx = args.max_context if args.max_context >= 0 else 16384
    p.offset_ms = args.offset_t_ms
    p.duration_ms = args.duration_ms
    p.token_timestamps = args.output_wts or args.output_jsn_full or args.max_len > 0
    p.thold_pt = args.word_thold
    # -owts without -ml defaults to 60-char karaoke lines (cli.cpp:1131)
    p.max_len = 60 if args.output_wts and args.max_len == 0 else args.max_len
    p.split_on_word = args.split_on_word
    p.audio_ctx = args.audio_ctx
    p.debug_mode = args.debug_mode
    p.tdrz_enable = args.tinydiarize
    p.suppress_regex = args.suppress_regex
    p.initial_prompt = args.prompt
    p.greedy.best_of = args.best_of
    p.beam_search.beam_size = args.beam_size
    p.temperature = args.temperature
    p.temperature_inc = 0.0 if args.no_fallback else args.temperature_inc
    p.entropy_thold = args.entropy_thold
    p.logprob_thold = args.logprob_thold
    p.no_speech_thold = args.no_speech_thold
    # the engine-level flag (suppresses all timestamp tokens in the logit
    # chain, cli.cpp:1153) — distinct from print_timestamps above
    p.no_timestamps = args.no_timestamps
    p.suppress_nst = args.suppress_nst
    return p


def _print_segment_text(ctx, i, args, pcm_stereo):
    t0 = ctx.full_get_segment_t0(i)
    t1 = ctx.full_get_segment_t1(i)
    speaker = ""
    if args.diarize and pcm_stereo is not None:
        speaker = outputs.estimate_diarization_speaker(pcm_stereo, t0, t1)

    if args.print_colors:
        text = ""
        for j in range(ctx.full_n_tokens(i)):
            if not args.print_special and \
                    ctx.full_get_token_id(i, j) >= ctx.token_eot():
                continue
            p = ctx.full_get_token_p(i, j)
            col = max(0, min(len(_COLORS) - 1, int((p ** 3) * len(_COLORS))))
            text += _COLORS[col] + ctx.full_get_token_text(i, j) + "\033[0m"
    else:
        text = ctx.full_get_segment_text(i)

    if args.no_timestamps:
        print(speaker + text, end="", flush=True)
    else:
        line = f"[{to_timestamp(t0)} --> {to_timestamp(t1)}]  {speaker}{text}"
        if args.tinydiarize and ctx.full_get_segment_speaker_turn_next(i):
            line += " [SPEAKER_TURN]"
        print(line, flush=True)


def main(argv=None) -> int:
    parser = build_parser()
    parser.set_defaults(device=None)    # tells an explicit --device from -ng
    args = parser.parse_args(argv)
    if args.device is None:
        args.device = "cpu" if args.no_gpu else "cuda"
    args.fname_inp = args.fname_inp + args.files
    if not args.fname_inp:
        print("error: no input files specified", file=sys.stderr)
        return 1

    if args.language != "auto" and lang_id(args.language) == -1:
        print(f"error: unknown language '{args.language}'", file=sys.stderr)
        return 1
    if args.no_prints:
        set_verbosity(100)

    dtw_kwargs = {}
    if args.dtw:
        preset = args.dtw.replace("_", "-")
        if preset.endswith(".en") or preset in AHEADS_PRESETS:
            dtw_kwargs = {"dtw_token_timestamps": True,
                          "dtw_aheads_preset": preset}
        elif preset.startswith("top"):
            dtw_kwargs = {"dtw_token_timestamps": True,
                          "dtw_aheads_preset": "n_top_most",
                          "dtw_n_top": int(preset[3:])}
        else:
            print(f"error: unknown DTW preset '{args.dtw}'", file=sys.stderr)
            return 3

    if args.kv_q4:
        dtw_kwargs["cross_mode"] = "einsum_q4"
    elif args.kv_q8:
        dtw_kwargs["cross_mode"] = "einsum_q8"
    ctx = WhisperContext.from_file(args.model, device=args.device,
                                   **dtw_kwargs)

    if not ctx.is_multilingual():
        if args.language != "en" or args.translate:
            args.language = "en"
            args.translate = False
            print("WARNING: model is not multilingual, ignoring language and "
                  "translation options", file=sys.stderr)
    if args.detect_language:
        args.language = "auto"

    # grammar semantics mirror the reference CLI (cli.cpp:1045-1066,
    # 1114-1115, 1163-1172): --grammar is a file path OR an inline GBNF
    # string; a parse failure exits 4; sampling additionally requires a
    # non-empty --grammar-rule (its absence leaves the grammar unused but
    # STILL forces beam strategy); an unknown rule warns and skips.
    use_grammar = False
    grammar_src = symbols = None
    if args.grammar:
        grammar_src = (open(args.grammar).read()
                       if os.path.isfile(args.grammar) else args.grammar)
        try:
            _, symbols = parse_gbnf(grammar_src)
        except Exception:
            print(f'error: failed to parse grammar "{args.grammar}"',
                  file=sys.stderr)
            return 4
        use_grammar = bool(args.grammar_rule)

    params = cli_params_to_full(args, use_grammar=use_grammar)

    if use_grammar:
        if args.grammar_rule not in symbols:
            print(f"warning: grammar rule '{args.grammar_rule}' not found "
                  "- skipping grammar sampling", file=sys.stderr)
        else:
            params.grammar_rules = grammar_from_gbnf(
                grammar_src, args.grammar_rule)
            params.grammar_penalty = args.grammar_penalty

    for fname in args.fname_inp:
        pcm, pcm_stereo = load_audio(fname, stereo=args.diarize)

        if not args.no_prints:
            print(f"\nprocessing '{fname}' ({len(pcm)} samples, "
                  f"{len(pcm) / 16000:.1f} sec), lang = {args.language}, "
                  f"task = {'translate' if args.translate else 'transcribe'}, "
                  f"timestamps = {0 if args.no_timestamps else 1} ...\n",
                  file=sys.stderr)

        seg_printed = [0]

        def on_new_segment(c, n_new):
            n = c.full_n_segments()
            for i in range(n - n_new, n):
                _print_segment_text(c, i, args, pcm_stereo)
            seg_printed[0] = n

        # segment printing stays on under --no-prints, matching the
        # reference ("do not print anything other than the results")
        params.new_segment_callback = on_new_segment

        if ctx.full_parallel(params, pcm, args.processors) != 0:
            print(f"error: failed to process audio '{fname}'", file=sys.stderr)
            return 10

        base = args.fname_out[0] if args.fname_out else fname
        info = {"model": args.model, "language": args.language,
                "translate": args.translate}
        if args.output_txt:
            outputs.output_txt(ctx, base + ".txt", args.diarize, pcm_stereo)
        if args.output_vtt:
            outputs.output_vtt(ctx, base + ".vtt", args.diarize, pcm_stereo)
        if args.output_srt:
            outputs.output_srt(ctx, base + ".srt", args.diarize, pcm_stereo,
                               args.offset_n)
        if args.output_csv:
            outputs.output_csv(ctx, base + ".csv", args.diarize, pcm_stereo)
        if args.output_lrc:
            outputs.output_lrc(ctx, base + ".lrc", args.diarize, pcm_stereo)
        if args.output_jsn or args.output_jsn_full:  # -ojf implies -oj
            outputs.output_json(ctx, base + ".json", info,
                                full=args.output_jsn_full,
                                diarize=args.diarize,
                                tinydiarize=args.tinydiarize,
                                pcm_stereo=pcm_stereo)
        if args.output_wts:
            outputs.output_wts(ctx, base + ".wts", fname,
                               len(pcm) / 16000.0, args.font_path)
        if args.log_score:
            outputs.output_score(ctx, base + ".score.txt")

    if not args.no_prints:
        ctx.timings.print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
