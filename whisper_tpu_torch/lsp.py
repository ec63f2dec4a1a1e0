"""JSON-RPC transcription interface over stdin/stdout (examples/lsp
equivalent, reference: examples/lsp/lsp.cpp; copy of whisper_tpu.lsp).

Requests are Content-Length framed JSON-RPC 2.0 messages (LSP wire
format).  The reference method set (lsp.cpp:341-380) is implemented with
the same response shapes and error codes:

  "registerCommandset" -> params: ["word", ...]  (each must tokenize to a
                          single leading token; duplicates -> -31000).
                          Returns {"index": n}.
  "guided"      -> single-token decode against a registered commandset's
                   precomputed prompt; returns {"command_index",
                   "command_text", "timestamp"}  (lsp.cpp:203-287)
  "unguided"    -> free transcription, single segment; optional "prompt"
                   and "no_context" params; returns {"transcription",
                   "timestamp"}  (lsp.cpp:157-199)
  "seek"        -> error -32601 "Seeking is not yet supported."
  "echo"        -> returns params verbatim
  unknown       -> {"result": null}, matching the reference dispatcher

Deviation from the reference: there is no SDL microphone in this
environment, so instead of `wait_for_vad` pulling from a live capture
ring (lsp.cpp:113-155), every audio-consuming request carries its own
audio as {"file": path} or {"pcm_base64": s16le data}; the reference's
max-length clamps (10 s unguided, 2 s guided) are applied to the tail of
the provided audio.  The returned "timestamp" is the wall clock in ms,
like the reference's time_now.  One intentional fix: the reference's
commandset prompt builder concatenates the words with no separator and
chops the final two characters (lsp.cpp:296,320 — mangling the last
word); this build joins with ", " as that code clearly intended.

Extension methods (not in the reference, kept for the vim/nvim clients
shipped under examples/): "initialize", "transcribe", "shutdown",
"exit"; "guided" with a plain {"commands": [...]} param falls back to
similarity matching over a transcription instead of the commandset path.

The guided pass runs the port's `decode_prompt` on torch tensors on the
context's device.  One flag more than whisper_tpu's: --device (default
"cuda"; "cpu" runs on the CPU, and a CUDA device without a card raises).

Usage: python -m whisper_tpu_torch.lsp -m model.bin
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time

import numpy as np
import torch

from .api import SamplingStrategy, WhisperContext, full_default_params
from .command import match_command, transcribe_utterance
from .constants import SAMPLE_RATE


class _JsonRpcError(Exception):
    """Carries a reference-format error object ({"code", "message"})."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.obj = {"code": code, "message": message}


def _read_message(stdin) -> dict | None:
    headers = {}
    while True:
        line = stdin.readline()
        if not line:
            return None
        line = line.decode().strip()
        if not line:
            break
        key, _, value = line.partition(":")
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", 0))
    if length <= 0:
        return None
    return json.loads(stdin.read(length))


def _write_message(stdout, msg: dict) -> None:
    # reference framing (lsp.cpp:419-421): body followed by a newline that
    # is counted in Content-Length.
    data = json.dumps(msg).encode() + b"\n"
    stdout.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
    stdout.write(data)
    stdout.flush()


def _load_pcm(params: dict, maxlength_ms: int | None = None) -> np.ndarray:
    if "file" in params:
        from .audio.io import load_audio
        pcm = load_audio(params["file"])[0]
    elif "pcm_base64" in params:
        raw = base64.b64decode(params["pcm_base64"])
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError("need 'file' or 'pcm_base64'")
    if maxlength_ms is not None:
        n = maxlength_ms * SAMPLE_RATE // 1000
        if len(pcm) > n:   # reference clamps to the newest samples
            pcm = pcm[-n:]
    return pcm


class _Commandset:
    """One registered command list (lsp.cpp:43-47): first token of each
    command plus the precomputed selection prompt."""

    def __init__(self, tokens: list[int], plaintexts: list[str],
                 prompt_tokens: list[int]):
        self.tokens = tokens
        self.plaintexts = plaintexts
        self.prompt_tokens = prompt_tokens


def _register_commandset(ctx: WhisperContext, words) -> _Commandset:
    """lsp.cpp:289-331 — single-token-per-command set + selection prompt."""
    if not isinstance(words, list):
        raise ValueError("registerCommandset params must be a list of strings")
    k_prompt = " select one from the available words: "
    tokens, plaintexts = [], []
    seen: set[int] = set()
    for s in words:
        toks = ctx.tokenize(" " + s)
        if not toks:
            raise ValueError(f"failed to tokenize command '{s}'")
        if toks[0] in seen:
            raise _JsonRpcError(-31000, "Duplicate token in token set: " + s)
        seen.add(toks[0])
        tokens.append(toks[0])
        plaintexts.append(s)
        k_prompt += s + ", "
    # reference builds the prompt with ", " separators implied and chops
    # the trailing two characters (lsp.cpp:320)
    k_prompt = k_prompt[:-2] + ". Selected word:"
    return _Commandset(tokens, plaintexts, ctx.tokenize(k_prompt))


def _guided(ctx: WhisperContext, params: dict,
            commandsets: list[_Commandset], language: str,
            audio_ctx: int) -> dict:
    """lsp.cpp:203-287 — decode the prompt, softmax the raw first-token
    logits, rank commands by the probability of their first token."""
    if not commandsets:
        raise ValueError("no commandset registered")
    idx = int(params.get("commandset_index", len(commandsets) - 1))
    if not 0 <= idx < len(commandsets):
        raise ValueError(f"commandset_index {idx} out of range "
                         f"(registered: {len(commandsets)})")
    cs = commandsets[idx]
    pcm = _load_pcm(params, maxlength_ms=2000)

    from .models import whisper as wm
    ctx.pcm_to_mel(pcm)
    # the -ac flag reaches guided too (wparams.audio_ctx, lsp.cpp:224);
    # set explicitly so a previous full() call can't leak its value in
    if audio_ctx > ctx.n_audio_ctx():
        raise ValueError("audio_ctx is larger than the maximum allowed")
    ctx.exp_n_audio_ctx = audio_ctx
    _, kc, vc = ctx.encode_window(0)

    # prompt = [prev] + commandset prompt + prompt_init (the whisper_full
    # assembly with wparams.prompt_tokens, whisper.cpp:5759-5771; guided
    # mode leaves no_timestamps unset so token_not is not appended)
    prompt = [ctx.vocab.token_prev] + list(cs.prompt_tokens)
    prompt.append(ctx.vocab.token_sot)
    if ctx.is_multilingual():
        from .languages import lang_id
        prompt.append(ctx.vocab.token_lang(lang_id(language)))
        prompt.append(ctx.vocab.token_transcribe)
    dev = ctx.device
    tok = torch.tensor([prompt], dtype=torch.long, device=dev)
    T = tok.shape[1]
    positions = torch.arange(T, device=dev)[None]
    causal = wm.make_causal_mask(T, device=dev)
    with torch.no_grad():
        logits, _, _ = wm.decode_prompt(
            ctx.params, tok, positions, kc, vc, self_mask=causal,
            n_head=ctx.config.n_text_head, compute_dtype=ctx.compute_dtype)
    # the softmax and the ranking on the host in f32, as whisper_tpu's
    row = logits[0, -1].float().cpu().numpy()
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    cmd_probs = probs[np.asarray(cs.tokens)]
    best = int(np.argmax(cmd_probs))   # ties -> first, like std::sort desc
    return {"command_index": best,
            "command_text": cs.plaintexts[best],
            "timestamp": int(time.time() * 1000)}


def _unguided(ctx: WhisperContext, params: dict, *, language: str,
              translate: bool, max_tokens: int, audio_ctx: int) -> dict:
    """lsp.cpp:157-199 — greedy single-segment transcription."""
    pcm = _load_pcm(params, maxlength_ms=10000)
    p = full_default_params(SamplingStrategy.GREEDY)
    if "prompt" in params:
        p.prompt_tokens = ctx.tokenize(params["prompt"])
    p.print_progress = False
    p.translate = translate
    p.no_context = bool(params.get("no_context", True))
    p.single_segment = True
    p.max_tokens = max_tokens
    p.language = language
    p.audio_ctx = audio_ctx
    p.suppress_nst = True
    if ctx.full(p, pcm) != 0:
        raise _JsonRpcError(-32803, "ERROR: whisper_full() failed")
    text = (ctx.full_get_segment_text(0)
            if ctx.full_n_segments() > 0 else "")
    return {"transcription": text,
            "timestamp": int(time.time() * 1000)}


def serve(ctx: WhisperContext, stdin=None, stdout=None, *,
          language: str = "en", translate: bool = False,
          max_tokens: int = 32, audio_ctx: int = 0) -> int:
    stdin = stdin or sys.stdin.buffer
    stdout = stdout or sys.stdout.buffer
    commandsets: list[_Commandset] = []

    while True:
        msg = _read_message(stdin)
        if msg is None:
            return 0
        mid = msg.get("id")
        method = msg.get("method", "")
        params = msg.get("params", {})
        if params is None:
            params = {}

        def reply(result=None, error=None):
            out = {"jsonrpc": "2.0", "id": mid}
            if error is not None:
                out["error"] = error
            else:
                out["result"] = result
            _write_message(stdout, out)

        try:
            if msg.get("jsonrpc") != "2.0":
                # reference: -3260 "invalid jsonrpc version" (lsp.cpp:348)
                raise _JsonRpcError(-3260, "invalid jsonrpc version")
            # ---- reference methods (lsp.cpp:360-364) ----
            if method == "unguided":
                reply(_unguided(ctx, params, language=language,
                                translate=translate, max_tokens=max_tokens,
                                audio_ctx=audio_ctx))
            elif method == "guided" and "commands" not in params:
                reply(_guided(ctx, params, commandsets, language, audio_ctx))
            elif method == "seek":
                raise _JsonRpcError(-32601, "Seeking is not yet supported.")
            elif method == "registerCommandset":
                commandsets.append(_register_commandset(ctx, params))
                reply({"index": len(commandsets) - 1})
            elif method == "echo":
                reply(params)
            # ---- extensions for the examples/ vim clients ----
            elif method == "initialize":
                hp = ctx.hparams
                reply({"model": hp.model_type,
                       "multilingual": ctx.is_multilingual(),
                       "n_vocab": hp.n_vocab})
            elif method == "transcribe":
                pcm = _load_pcm(params)
                p = full_default_params()
                p.print_progress = False
                p.language = params.get("language", language)
                p.translate = bool(params.get("translate", translate))
                p.no_timestamps = bool(params.get("no_timestamps", False))
                p.max_tokens = int(params.get("max_tokens", 0))
                p.temperature = float(params.get("temperature", 0.0))
                if ctx.full(p, pcm) != 0:
                    raise _JsonRpcError(-32803, "ERROR: whisper_full() failed")
                segs = [{"t0": ctx.full_get_segment_t0(i),
                         "t1": ctx.full_get_segment_t1(i),
                         "text": ctx.full_get_segment_text(i)}
                        for i in range(ctx.full_n_segments())]
                reply({"segments": segs,
                       "text": "".join(s["text"] for s in segs)})
            elif method == "guided":
                # extension shape used by examples/whisper.vim: a plain
                # {"commands": [...]} list matched by Levenshtein
                # similarity (no commandset registration)
                pcm = _load_pcm(params)
                commands = params.get("commands", [])
                text = transcribe_utterance(
                    ctx, pcm, max_tokens=int(params.get("max_tokens", 32)),
                    deterministic=True)
                idx, sim = (match_command(text, commands)
                            if commands else (-1, 0.0))
                reply({"heard": text, "command_index": idx,
                       "command": commands[idx] if idx >= 0 else None,
                       "similarity": sim})
            elif method == "shutdown":
                reply(None)
            elif method == "exit":
                return 0
            else:
                # reference dispatcher falls through with a null result
                reply(None)
        except _JsonRpcError as e:
            reply(error=e.obj)
        except Exception as e:  # noqa: BLE001 — report over the wire
            reply(error={"code": -32000, "message": str(e)})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="whisper-lsp")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-tr", "--translate", action="store_true")
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("-ac", "--audio-ctx", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='torch device: "cuda" (the default) or "cpu"')
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return serve(WhisperContext.from_file(args.model, device=args.device),
                 language=args.language, translate=args.translate,
                 max_tokens=args.max_tokens, audio_ctx=args.audio_ctx)


if __name__ == "__main__":
    sys.exit(main())
