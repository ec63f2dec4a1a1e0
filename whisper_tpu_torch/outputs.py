"""Transcript output writers: txt / vtt / srt / csv / json / lrc / wts / score
(copy of whisper_tpu.outputs).

Byte-compatible with the reference CLI writers
(reference: examples/cli/cli.cpp:382-883).  Timestamps are in 10 ms ticks.
"""

from __future__ import annotations

import json

import numpy as np

from .timestamps import timestamp_to_sample


def to_timestamp(t: int, comma: bool = False) -> str:
    """Ticks -> "HH:MM:SS.mmm" (vtt) or "HH:MM:SS,mmm" (srt).
    (reference: examples/common.cpp to_timestamp)"""
    msec = t * 10
    hr = msec // (1000 * 60 * 60)
    msec -= hr * 1000 * 60 * 60
    minute = msec // (1000 * 60)
    msec -= minute * 1000 * 60
    sec = msec // 1000
    msec -= sec * 1000
    sep = "," if comma else "."
    return f"{hr:02d}:{minute:02d}:{sec:02d}{sep}{msec:03d}"


def estimate_diarization_speaker(pcm_stereo: np.ndarray, t0: int, t1: int,
                                 id_only: bool = False) -> str:
    """Two-channel energy comparison (reference: cli.cpp:271-303)."""
    n = pcm_stereo.shape[0]
    is0 = timestamp_to_sample(t0, n)
    is1 = timestamp_to_sample(t1, n)
    e0 = float(np.abs(pcm_stereo[is0:is1, 0]).sum())
    e1 = float(np.abs(pcm_stereo[is0:is1, 1]).sum())
    if e0 > 1.1 * e1:
        speaker = "0"
    elif e1 > 1.1 * e0:
        speaker = "1"
    else:
        speaker = "?"
    if not id_only:
        speaker = f"(speaker {speaker})"
    return speaker


def _speaker(ctx, i, diarize, pcm_stereo, id_only=False):
    if diarize and pcm_stereo is not None:
        return estimate_diarization_speaker(
            pcm_stereo, ctx.full_get_segment_t0(i), ctx.full_get_segment_t1(i),
            id_only)
    return ""


def output_txt(ctx, fname, diarize=False, pcm_stereo=None) -> bool:
    with open(fname, "w") as f:
        for i in range(ctx.full_n_segments()):
            f.write(_speaker(ctx, i, diarize, pcm_stereo)
                    + ctx.full_get_segment_text(i) + "\n")
    return True


def output_vtt(ctx, fname, diarize=False, pcm_stereo=None) -> bool:
    with open(fname, "w") as f:
        f.write("WEBVTT\n\n")
        for i in range(ctx.full_n_segments()):
            t0 = ctx.full_get_segment_t0(i)
            t1 = ctx.full_get_segment_t1(i)
            speaker = ""
            if diarize and pcm_stereo is not None:
                speaker = "<v Speaker" + _speaker(
                    ctx, i, diarize, pcm_stereo, id_only=True) + ">"
            f.write(f"{to_timestamp(t0)} --> {to_timestamp(t1)}\n")
            f.write(speaker + ctx.full_get_segment_text(i) + "\n\n")
    return True


def output_srt(ctx, fname, diarize=False, pcm_stereo=None,
               offset_n: int = 0) -> bool:
    with open(fname, "w") as f:
        for i in range(ctx.full_n_segments()):
            t0 = ctx.full_get_segment_t0(i)
            t1 = ctx.full_get_segment_t1(i)
            f.write(f"{i + 1 + offset_n}\n")
            f.write(f"{to_timestamp(t0, True)} --> {to_timestamp(t1, True)}\n")
            f.write(_speaker(ctx, i, diarize, pcm_stereo)
                    + ctx.full_get_segment_text(i) + "\n\n")
    return True


def output_csv(ctx, fname, diarize=False, pcm_stereo=None) -> bool:
    with open(fname, "w") as f:
        header = "start,end,"
        if diarize and pcm_stereo is not None:
            header += "speaker,"
        f.write(header + "text\n")
        for i in range(ctx.full_n_segments()):
            t0 = ctx.full_get_segment_t0(i)
            t1 = ctx.full_get_segment_t1(i)
            text = ctx.full_get_segment_text(i).replace('"', '""')
            row = f"{10 * t0},{10 * t1},"
            if diarize and pcm_stereo is not None:
                row += _speaker(ctx, i, diarize, pcm_stereo, id_only=True) + ","
            f.write(row + f'"{text}"\n')
    return True


def output_lrc(ctx, fname, diarize=False, pcm_stereo=None) -> bool:
    with open(fname, "w") as f:
        f.write("[by:whisper.cpp]\n")
        for i in range(ctx.full_n_segments()):
            t = ctx.full_get_segment_t0(i)
            msec = t * 10
            minute = msec // (1000 * 60)
            msec -= minute * 1000 * 60
            sec = msec // 1000
            msec -= sec * 1000
            stamp = f"{minute:02d}:{sec:02d}.{msec // 10:02d}"
            f.write(f"[{stamp}]" + _speaker(ctx, i, diarize, pcm_stereo)
                    + ctx.full_get_segment_text(i) + "\n")
    return True


def output_score(ctx, fname) -> bool:
    with open(fname, "w") as f:
        for i in range(ctx.full_n_segments()):
            for j in range(ctx.full_n_tokens(i)):
                f.write(f"{ctx.full_get_token_text(i, j)}\t"
                        f"{ctx.full_get_token_p(i, j)}\n")
    return True


def output_json(ctx, fname, params_info: dict | None = None, full=False,
                diarize=False, tinydiarize=False, pcm_stereo=None) -> bool:
    """JSON output matching the reference's structure (cli.cpp:587-760)."""
    from .languages import lang_str
    hp = ctx.hparams
    doc = {
        "systeminfo": ctx_system_info(),
        "model": {
            "type": hp.model_type,
            "multilingual": ctx.is_multilingual(),
            "vocab": hp.n_vocab,
            "audio": {"ctx": hp.n_audio_ctx, "state": hp.n_audio_state,
                      "head": hp.n_audio_head, "layer": hp.n_audio_layer},
            "text": {"ctx": hp.n_text_ctx, "state": hp.n_text_state,
                     "head": hp.n_text_head, "layer": hp.n_text_layer},
            "mels": hp.n_mels,
            "ftype": hp.ftype,
        },
        "params": params_info or {},
        "result": {"language": lang_str(ctx.full_lang_id())},
        "transcription": [],
    }
    for i in range(ctx.full_n_segments()):
        t0 = ctx.full_get_segment_t0(i)
        t1 = ctx.full_get_segment_t1(i)
        seg = {
            "timestamps": {"from": to_timestamp(t0, True),
                           "to": to_timestamp(t1, True)},
            "offsets": {"from": t0 * 10, "to": t1 * 10},
            "text": ctx.full_get_segment_text(i),
        }
        if full:
            toks = []
            for j in range(ctx.full_n_tokens(i)):
                td = ctx.full_get_token_data(i, j)
                tok = {"text": ctx.token_to_str(td.id)}
                if td.t0 > -1 and td.t1 > -1:
                    tok["timestamps"] = {"from": to_timestamp(td.t0, True),
                                         "to": to_timestamp(td.t1, True)}
                    tok["offsets"] = {"from": td.t0 * 10, "to": td.t1 * 10}
                tok.update({"id": td.id, "p": td.p, "t_dtw": td.t_dtw})
                toks.append(tok)
            seg["tokens"] = toks
        if diarize and pcm_stereo is not None:
            seg["speaker"] = _speaker(ctx, i, diarize, pcm_stereo, id_only=True)
        if tinydiarize:
            seg["speaker_turn_next"] = ctx.full_get_segment_speaker_turn_next(i)
        doc["transcription"].append(seg)

    with open(fname, "w") as f:
        json.dump(doc, f, indent=2, ensure_ascii=False)
        f.write("\n")
    return True


def output_wts(ctx, fname, fname_inp, t_sec, font_path) -> bool:
    """Karaoke bash/ffmpeg script (reference: cli.cpp:766-883)."""
    import os
    import sys
    if not os.path.exists(font_path):
        print(f"output_wts: font not found at '{font_path}', please "
              "specify a monospace font with -fp", file=sys.stderr)
        return False
    with open(fname, "w") as f:
        f.write("#!/bin/bash\n\n")
        f.write(f"ffmpeg -i {fname_inp} -f lavfi -i "
                f"color=size=1200x120:duration={t_sec}:rate=25:color=black "
                f"-vf \"")
        for i in range(ctx.full_n_segments()):
            t0 = ctx.full_get_segment_t0(i)
            t1 = ctx.full_get_segment_t1(i)
            n = ctx.full_n_tokens(i)
            words = [ctx.full_get_token_text(i, j) for j in range(n)
                     if ctx.full_get_token_id(i, j) < ctx.token_eot()]
            txt = "".join(words).replace("'", "’").replace('"', "\\\"")
            f.write(f"drawtext=fontfile='{font_path}':fontsize=24:"
                    f"fontcolor=white:x=(w-text_w)/2:y=h/2:text='{txt}':"
                    f"enable='between(t,{t0 / 100.0},{t1 / 100.0})',")
        f.write("\"\n")
    return True


def ctx_system_info() -> str:
    """whisper_print_system_info equivalent."""
    import torch
    if torch.cuda.is_available():
        n, kind = torch.cuda.device_count(), torch.cuda.get_device_name(0)
        backend = f"cuda {torch.version.cuda}"
    else:
        n, kind, backend = 1, "cpu", "cpu"
    return (f"PyTorch {torch.__version__} | backend {backend} | "
            f"{n} device(s) | {kind}")
