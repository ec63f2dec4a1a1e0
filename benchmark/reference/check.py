"""The comparison that decides `correct`.

A served window is judged token by token against the reference: at each
position the reference, teacher-forced on the window's prompt and the
tokens served before it, gives its logits; greedy decoding's rules
(whisper.cpp's suppressions) remove what no token may be.  Two readings
a window, each its widest over the positions:

  logit_gap    by how much the served token's logit lies below the
               reference's best there (infinite for a token the rules
               forbid);
  logprob_gap  how far the log-probability the program reported for the
               token it served lies from the reference's best
               log-probability there (positions whose log-probability the
               program does not report are skipped).

The control puts the reference itself, in the precision below the
configuration's (`whisper.Arith("fp8")`), in the program's place: at the
same positions it reads the logit gap of the token that the lower
precision ranks first, and how far its own best log-probability lies
from the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import whisper as ref


@dataclasses.dataclass
class Window:
    """One served 30 s window: the stream's PCM, the window's frame
    offset, whether the program's mel is the window's own (device mel),
    the prompt the decoding rules give it, the tokens served and the
    log-probability the program reported for each (None: not reported)."""
    pcm: np.ndarray
    seek: int
    per_window_mel: bool
    prompt: list
    served: list
    logprobs: list


def carried_prompts(init: list, served: list, tok: dict, n_max_text_ctx: int,
                    n_text_ctx: int, seeks: list, seek_end: int) -> list:
    """Each window's prompt under whisper.cpp's rules for a stream whose
    windows served `served[w]`, no window judged no-speech: the past is
    the prompt's own carried part plus the window's tokens; the next
    window takes [prev] + its last min(n_max_text_ctx, n_text_ctx / 2)
    tokens before `init`; the past is dropped before a window that starts
    within 5 s of the stream's end."""
    prompts, past = [], []
    for w, seek in enumerate(seeks):
        if seek > 0 and seek + 500 >= seek_end:
            past = []
        n_take = min(n_max_text_ctx, n_text_ctx // 2, len(past))
        carried = past[len(past) - n_take:] if past and n_max_text_ctx > 0 \
            else []
        prompt = ([tok["prev"]] + carried if carried else []) + list(init)
        prompts.append(prompt)
        past = carried + list(served[w])
    return prompts


def _filtered(logits: torch.Tensor, tok: dict, no_timestamps: bool):
    """(n, V) logits of the n served positions with the forbidden tokens
    at -inf (the first position is the window's initial token)."""
    n, v = logits.shape
    out = logits.clone()
    for initial in (True, False):
        rows = slice(0, 1) if initial else slice(1, n)
        mask = ref.suppressed(tok, v, no_timestamps, initial).to(out.device)
        out[rows] = out[rows].masked_fill(mask, float("-inf"))
    return out


def window_logits(params, cfg: dict, win: Window, ar: ref.Arith):
    """The (n_served, V) logits that judge each served token."""
    dev = params["decoder"]["tok_emb"].device
    mel = ref.window_mel(win.pcm, win.seek, win.per_window_mel,
                         cfg["num_mel_bins"], dev)
    enc = ref.encode(params, mel, cfg["encoder_attention_heads"], ar)
    kv = ref.cross_kv(params, enc, cfg["decoder_attention_heads"], ar)
    seq = list(win.prompt) + list(win.served[:-1])
    logits = ref.decode(params, seq, kv, cfg["decoder_attention_heads"], ar)
    return logits[len(win.prompt) - 1:]


def gaps(params, cfg: dict, windows: list, no_timestamps: bool,
         control: bool = False) -> dict:
    """Each window's widest logit gap and logprob gap (see the module's
    docstring), of the program's served tokens, or with `control` of the
    lower precision's: {"logit_gap": array, "logprob_gap": array}."""
    ref.no_tf32()
    tok = ref.special_tokens(cfg["vocab_size"])
    f32 = ref.Arith("f32")
    low = ref.Arith("fp8") if control else None
    out = {"logit_gap": [], "logprob_gap": []}
    with torch.no_grad():
        for win in windows:
            good = _filtered(window_logits(params, cfg, win, f32), tok,
                             no_timestamps)
            if good.shape[0] != len(win.served) or not win.served:
                out["logit_gap"].append(float("inf"))
                out["logprob_gap"].append(float("inf"))
                continue
            best_lp = torch.log_softmax(good, dim=-1).max(dim=-1).values
            if control:
                lows = _filtered(window_logits(params, cfg, win, low), tok,
                                 no_timestamps)
                picked = lows.argmax(dim=-1)
                lp = torch.log_softmax(lows, dim=-1).max(dim=-1).values
                lp_gap = (lp - best_lp).abs().max()
            else:
                picked = torch.as_tensor(win.served, device=good.device)
                have = [i for i, x in enumerate(win.logprobs) if x is not None]
                rep = torch.as_tensor([win.logprobs[i] for i in have],
                                      dtype=torch.float64)
                lp_gap = (rep - best_lp[have].double().cpu()).abs().max() \
                    if have else torch.tensor(float("inf"))
            taken = good.gather(1, picked[:, None].long())[:, 0]
            out["logit_gap"].append(float((good.max(dim=-1).values
                                           - taken).max()))
            out["logprob_gap"].append(float(lp_gap))
    return {k: np.asarray(v) for k, v in out.items()}
