"""The comparison that decides `correct` in the audio-LLM's cells.

A served window is judged token by token against the reference
(uni_moe_omni.py), teacher-forced on the window's audio, the prompt
template and the tokens served before each; greedy decoding over the
whole vocabulary has no suppression rules.  Per window, each its widest
over the positions:

  logit_gap    by how much the served token's logit lies below the
               reference's best there;
  logprob_gap  how far the log-probability the program reported for the
               token lies from the reference's best log-probability.

Routing: the program's kept sets of the window's positions are handed to
the reference, which takes them where its own margin to a routing
boundary is below the configuration's `route_delta` (one flipped expert
moves the logits by far more than rounding does).  What the program
hands is held to the rule on its own router probabilities, exactly, so
that a set taken near a boundary is still the rule's.  Per window:

  routes_rule_broken    the rows whose kept set is not the one the routing
                        rule gives on the program's own probabilities;
  routes_handed         the share of (position, layer) rows whose set the
                        reference took from the program;
  routes_wide_disagree  the rows where the program's set differs from the
                        reference's own at a margin of route_delta or more;
  route_prob_gap        the widest distance between the program's router
                        probabilities and the reference's;
  route_flip_margin     the widest margin of a row whose set the program
                        and the reference chose differently (what
                        route_delta must stay above, with room).

The control puts the reference in float8 (Arith("fp8"), its own routing)
in the program's place: the float32 reference is handed the control's
sets, and reads the logit gap of the token the control ranks first, how
far the control's best log-probability lies from its own, and the same
routing readings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import uni_moe_omni as ref
from . import whisper as wref


@dataclasses.dataclass
class Window:
    """One served 30 s window: the stream's PCM, the window's frame
    offset, the tokens served and the log-probability reported for each,
    and the program's routing of its positions: kept ids (T, L, top_k)
    and router probabilities (T, L, E + N0), T the prompt and the served
    tokens but the last."""
    pcm: np.ndarray
    seek: int
    served: list
    logprobs: list
    kept: np.ndarray
    probs: np.ndarray


def _audio(params, cfg: dict, win: Window, ar: ref.Arith):
    enc = cfg["whisper_encoder"]
    dev = params["llm"]["embed"].device
    mel = wref.window_mel(win.pcm, win.seek, True, enc["num_mel_bins"], dev)
    return ref.connect(params["connector"],
                       ref.encode(params["encoder"], mel,
                                  enc["encoder_attention_heads"], ar),
                       cfg["whisper_query_tokens_size"], ar)


def _prompt_len(cfg: dict) -> int:
    return len(cfg["prompt_head"]) + cfg["whisper_query_tokens_size"] + \
        len(cfg["prompt_tail"])


def _rule_broken(kept: np.ndarray, probs: np.ndarray, cfg: dict) -> int:
    """Rows of a kept table (T, L, top_k) that are not the routing rule's
    sets on the probabilities (T, L, E + N0) they were chosen from."""
    p = torch.as_tensor(probs).reshape(-1, probs.shape[-1])
    want, _ = ref.route(p, cfg["mlp_dynamic_top_p"], cfg["mlp_dynamic_top_k"])
    got = torch.as_tensor(kept).reshape(want.shape).long()
    return int((~ref._same(want, got)).sum())


def passes(params, cfg: dict, windows: list, ar: ref.Arith, handed=None):
    """The reference's pass over every window in `ar`'s precision; handed:
    each window's kept table to take near a boundary (None: its own)."""
    audio = [_audio(params, cfg, w, ar) for w in windows]
    ids = [list(cfg["prompt_tail"]) + list(w.served[:-1]) for w in windows]
    first = [_prompt_len(cfg) - 1] * len(windows)
    return ref.forward(params, cfg, audio, ids, first, ar, handed,
                       cfg["route_delta"])


def gaps(params, cfg: dict, windows: list, control: bool = False) -> dict:
    """Each window's readings (see the module's docstring), of the
    program's served tokens or with `control` of the float8 control's:
    {name: array over the windows}."""
    ref.no_tf32()
    f32 = ref.Arith("f32")
    out = {k: [] for k in ("logit_gap", "logprob_gap", "routes_handed",
                           "routes_wide_disagree", "route_prob_gap",
                           "route_flip_margin", "routes_rule_broken")}
    with torch.no_grad():
        if control:
            low = passes(params, cfg, windows, ref.Arith("fp8"))
            theirs = [k.cpu().numpy() for k in low["kept"]]
            theirs_p = [p.cpu().numpy() for p in low["probs"]]
        else:
            theirs = [w.kept for w in windows]
            theirs_p = [w.probs for w in windows]
        res = passes(params, cfg, windows, f32, theirs)
        for i, win in enumerate(windows):
            good = res["logits"][i]
            if good.shape[0] != len(win.served) or not win.served:
                for k in out:
                    out[k].append(float("inf"))
                continue
            best_lp = torch.log_softmax(good, dim=-1).max(dim=-1).values
            if control:
                lows = low["logits"][i]
                picked = lows.argmax(dim=-1)
                lp = torch.log_softmax(lows, dim=-1).max(dim=-1).values
                lp_gap = float((lp - best_lp).abs().max())
            else:
                picked = torch.as_tensor(win.served, device=good.device)
                rep = torch.as_tensor(win.logprobs, dtype=torch.float64)
                lp_gap = float((rep - best_lp.double().cpu()).abs().max())
            taken = good.gather(1, picked[:, None].long())[:, 0]
            out["logit_gap"].append(float((good.max(dim=-1).values
                                           - taken).max()))
            out["logprob_gap"].append(lp_gap)
            out["routes_handed"].append(res["handed"][i] / res["rows"][i])
            out["routes_wide_disagree"].append(float(res["wide"][i]))
            out["route_flip_margin"].append(res["flip_margin"][i])
            mine = res["probs"][i].cpu().numpy()
            out["route_prob_gap"].append(
                float(np.abs(theirs_p[i] - mine).max()))
            out["routes_rule_broken"].append(float(_rule_broken(
                theirs[i], theirs_p[i], cfg)))
    return {k: np.asarray(v) for k, v in out.items()}
