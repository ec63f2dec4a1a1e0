"""Entry "transcribe": offline batch transcription through the port's
BatchTranscriber.transcribe.

Set-up builds the model from the seed, the transcriber at the traffic's
batch, warms it (the program's own warmup: the encoder and both prompt
buckets of the window decode) and makes the input sets.  The window is
made of whole calls, each transcribing one set of streams: it starts at
the first call and closes at the end of the first call that ends after
`seconds`.  audio_s_per_s is every stream-second of those calls over the
window's wall.

Once the window has closed and the program's state is freed, a sample of
the streams it finished, drawn from the seed, is judged window by window
against the reference (benchmark/reference/check.py).  The traced run
records spans over the whole window (the encoder's fenced) and the
device trace over the whole iterations of one call (traffic
"trace_call"); the metrics read from spans and host clocks are taken
over the other calls, which the profiler neither slows nor stalls.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import flops, harness, model, tracing, traffic
from benchmark.reference import check


def _decoded(segments: list, n_windows: int):
    """The served (token ids, log-probabilities) of each window of a
    stream, or None when the stream has not one segment a window (no
    timestamps: a window is one segment)."""
    if len(segments) != n_windows:
        return None
    return [([t.id for t in seg.tokens], [t.plog for t in seg.tokens])
            for seg in segments]


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    """Drive the cell; -> the entry's result (see benchmark/run.py).
    control: also read the control's gaps on the same sample (the
    calibration, never a benchmark run)."""
    from whisper_tpu_torch.api import full_default_params
    from whisper_tpu_torch.models import whisper as wm
    from whisper_tpu_torch.parallel.batch import BatchTranscriber

    cfg, spec = cell.config, cell.traffic
    params = model.make_params(cfg, seed, device)
    ctx = model.make_context(cfg, params, device)
    p = full_default_params()
    for key, val in spec["params"].items():
        setattr(p, key, val)
    bt = BatchTranscriber(ctx, batch_size=spec["batch"], params=p,
                          device_mel=spec["device_mel"])
    bt.warmup(pcm_dtype=np.int16)
    sets = traffic.stream_sets(spec, seed, device)
    # the stream's frames (whisper.cpp's seek_end) and its windows: one a
    # 3000 frames, no timestamps
    seek_end = 1 + (int(spec["stream_s"] * 16000) - 200) // 160
    seeks = list(range(0, seek_end - 10, 3000))

    spans = tracing.Spans()
    dtrace = tracing.DeviceTrace()
    shapes = harness.LaunchShapes(cell.rooflines(), dtrace)
    if trace:
        spans.fence = lambda: harness.fence(device)
        spans.wrap(bt, "_iterate", "iterate")
        spans.wrap(bt, "_encode_batch", "encode", fenced=True,
                   value=lambda a, k, out: a[0].shape[0])
        spans.wrap(bt, "_decode_rows", "decode",
                   value=lambda a, k, out: int(out["n_tokens"]))
        spans.wrap(bt, "_finish_groups", "finish")
        spans.wrap(wm, "decode_prompt", "prompt")
        spans.wrap(wm, "decode_step", "step")
        if harness.is_cuda(device):
            shapes.install()
    harness.fence(device)
    setup_s = tracing.process_age_s()

    calls = []                      # (input set, its segments)
    plain = []                      # (call, t0_ns, t1_ns), untraced calls
    t_start = time.perf_counter()
    traced_call = spec["trace_call"] if trace else -1
    while True:
        k = len(calls)
        if k == traced_call and harness.is_cuda(device):
            dtrace.start()
        t0_ns = time.time_ns()
        segs = bt.transcribe(sets[k % len(sets)])
        t1_ns = time.time_ns()
        if trace:
            spans.records.append(("transcribe", t0_ns, t1_ns, 1))
        if dtrace.active:
            dtrace.stop()
        else:
            plain.append((k, t0_ns, t1_ns))
        calls.append((k % len(sets), segs))
        t_end = time.perf_counter()
        if t_end - t_start >= seconds and len(calls) > traced_call:
            break
    window_s = t_end - t_start
    peak = harness.memory_peak(device)
    spans.restore()
    shapes.restore()

    n_streams = sum(len(segs) for _, segs in calls)
    decoded = [[_decoded(s, len(seeks)) for s in segs] for _, segs in calls]
    failed = sum(d is None for c in decoded for d in c)

    # the sample the reference judges: drawn from the seed, with the
    # stream that served the most tokens
    pairs = [(c, s) for c in range(len(calls))
             for s in range(len(decoded[c])) if decoded[c][s] is not None]
    rng = np.random.default_rng(traffic.seed_for(seed, 3))
    n_sample = min(spec["sample_streams"], len(pairs))
    longest = max(pairs, key=lambda cs: sum(len(ids) for ids, _ in
                                            decoded[cs[0]][cs[1]]),
                  default=None)
    picked = [pairs[i] for i in rng.choice(len(pairs), n_sample,
                                           replace=False)]
    if longest is not None and longest not in picked:
        picked[-1] = longest
    sample = [(sets[calls[c][0]][s], decoded[c][s]) for c, s in picked]
    out_rec = None
    if trace:
        out_rec = _record(cell, spans, dtrace, shapes, decoded, p, seeks,
                          seek_end, plain)
    del bt, ctx, params, sets, calls
    harness.free_memory(device)

    # the reference, on the same weights made again from the seed
    params = model.make_params(cfg, seed, device)
    windows = _windows(cfg, p, sample, seeks, seek_end, spec["device_mel"])
    gaps = check.gaps(params, cfg, windows, p.no_timestamps)
    control_gaps = (check.gaps(params, cfg, windows, p.no_timestamps,
                               control=True) if control else None)
    del params
    harness.free_memory(device)
    correct, checks = harness.judge(
        harness.readings(gaps, failed, "streams_failed"), cell.limits)
    return {
        "correct": correct and len(windows) > 0, "attempted": n_streams,
        "failed": failed, "device": harness.device_info(device, peak),
        "end_to_end": {
            "audio_s_per_s": n_streams * spec["stream_s"] / window_s,
            "setup_s": setup_s},
        "record": out_rec, "checks": checks, "gaps": gaps,
        "control_gaps": control_gaps,
        "breakdown": (tracing.breakdown(out_rec["trace"])
                      if out_rec and out_rec["trace"] else None),
    }


def _prompts(cfg: dict, p, served: list, seeks: list, seek_end: int):
    """Each window's prompt by whisper.cpp's rules (the reference's)."""
    from benchmark.reference import whisper as ref
    tok = ref.special_tokens(cfg["vocab_size"])
    init = ref.initial_prompt(tok, p.language, p.no_timestamps)
    return check.carried_prompts(init, served, tok, p.n_max_text_ctx,
                                 cfg["max_target_positions"], seeks, seek_end)


def _windows(cfg: dict, p, sample: list, seeks: list, seek_end: int,
             device_mel: bool) -> list:
    """The reference's view of each sampled stream's windows: PCM, seek,
    whose mel, prompt, the tokens served."""
    out = []
    for pcm, served in sample:
        prompts = _prompts(cfg, p, [ids for ids, _ in served], seeks,
                           seek_end)
        out += [check.Window(pcm, s, device_mel, q, ids, lps)
                for s, q, (ids, lps) in zip(seeks, prompts, served)]
    return out


def _record(cell, spans, dtrace, shapes, decoded, p, seeks, seek_end,
            plain) -> dict:
    """What the per-layer metrics of a traced run read: the device trace
    of the traced call, and over the untraced calls (`plain`: (call,
    t0_ns, t1_ns)) their wall, spans and model operations."""
    cfg = cell.config
    work = 0.0
    for k, _, _ in plain:
        for served in decoded[k]:
            if served is not None:
                ids = [i for i, _ in served]
                prompts = _prompts(cfg, p, ids, seeks, seek_end)
                work += sum(flops.window(cfg, len(q) + len(t) - 1)
                            for q, t in zip(prompts, ids))
    red = None
    if dtrace.done:
        red = tracing.reduce_trace(
            dtrace, spans, gap_names=("transcribe", "iterate", "encode",
                                      "decode", "prompt", "step", "finish"),
            count_in=("decode",))
        tracing.log_trace(red)
    return {"window_s": sum(b - a for _, a, b in plain) / 1e9, "flops": work,
            "spans": spans.summary([(a, b) for _, a, b in plain]),
            "trace": red,
            "kernels": shapes.summary(), "batch": cell.traffic["batch"]}
