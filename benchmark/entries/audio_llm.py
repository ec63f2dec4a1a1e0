"""Entry "audio_llm": offline batch transcription on an audio-LLM through
the port's BatchTranscriber.transcribe on an AudioLLMContext (Whisper's
encoder, a connector, a language model with a mixture of experts; the
configuration's file names its parts).

Set-up builds the model from the seed (benchmark/model_omni.py), the
transcriber at the traffic's batch, warms it (the program's own warm-up:
an encode and one whole window's prefill and greedy steps) and makes the
input sets.  The window is made of whole calls, each transcribing one set
of streams; it starts at the first call and closes at the end of the
first call that ends after `seconds`.  audio_s_per_s is every
stream-second of those calls over the window's wall.

Once the window has closed, a sample of one call's streams, drawn from
the seed, is judged window by window against the float32 reference
(benchmark/reference/check_omni.py).  The reference is handed the
program's kept expert sets near a routing boundary: they come from one
more call, untimed, on the same input set and batch, with the program's
route record on.  The program's state is freed before the reference
runs on the weights made again from the seed.

The traced run records the program's spans and counters
(benchmark/program.py) over the whole run, the benchmark's wrappers over
the window, and the device trace over one window round of one call
(traffic "trace_call"; a round is some 9,000 launches a step times the
steps, too many to trace a whole call); the metrics read from spans,
counters and host clocks are taken over the other calls, which the
profiler neither slows nor stalls.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark import (flops_omni, harness, model_omni, program, tracing,
                       traffic)
from benchmark.reference import check_omni


def _decoded(segments: list, n_windows: int):
    """The served (token ids, log-probabilities) of each window of a
    stream, or None when the stream has not one segment a window."""
    if len(segments) != n_windows:
        return None
    return [([t.id for t in seg.tokens], [t.plog for t in seg.tokens])
            for seg in segments]


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    """Drive the cell; -> the entry's result (see benchmark/run.py).
    control: also read the control's gaps on the same sample (the
    calibration, never a benchmark run)."""
    # a program without the audio-LLM path fails here, before any weight
    # is made
    from whisper_tpu_torch.api import AudioLLMContext  # noqa: F401
    from whisper_tpu_torch.api import full_default_params
    from whisper_tpu_torch.models import uni_moe_omni as omni
    from whisper_tpu_torch.parallel.batch import BatchTranscriber

    cfg, spec = cell.config, cell.traffic
    tracer = program.start() if trace else None
    params = model_omni.make_params(cfg, seed, device)
    ctx = model_omni.make_context(cfg, params, device)
    p = full_default_params()
    for key, val in spec["params"].items():
        setattr(p, key, val)
    bt = BatchTranscriber(ctx, batch_size=spec["batch"], params=p,
                          device_mel=spec["device_mel"])
    bt.warmup(pcm_dtype=np.int16)
    sets = traffic.stream_sets(spec, seed, device)
    seek_end = 1 + (int(spec["stream_s"] * 16000) - 200) // 160
    seeks = list(range(0, seek_end - 10, 3000))

    spans = tracing.Spans()
    dtrace = tracing.DeviceTrace()
    armed = [False]
    if trace:
        # the device trace over the first window round of the armed call
        round_fn = bt._iterate_llm

        def traced_round(*a, **k):
            if armed[0] and harness.is_cuda(device):
                dtrace.start()
            out = round_fn(*a, **k)
            if dtrace.active:
                dtrace.stop()
                armed[0] = False
            return out
        bt._iterate_llm = traced_round
        spans.wrap(bt, "_iterate_llm", "iterate",
                   value=lambda a, k, out: len(a[1]))
        spans.wrap(bt, "_encode_batch", "encode",
                   value=lambda a, k, out: a[0].shape[0])
        spans.wrap(omni, "prefill", "prefill",
                   value=lambda a, k, out: out.shape[0])
        spans.wrap(omni, "step", "step",
                   value=lambda a, k, out: out.shape[0])
    harness.fence(device)
    setup_s = tracing.process_age_s()
    setup_end_ns = time.time_ns()

    calls = []                      # (input set, its segments)
    plain = []                      # (call, t0_ns, t1_ns), untraced calls
    t_start = time.perf_counter()
    traced_call = spec["trace_call"] if trace else -1
    while True:
        k = len(calls)
        armed[0] = k == traced_call
        t0_ns = time.time_ns()
        segs = bt.transcribe(sets[k % len(sets)])
        t1_ns = time.time_ns()
        if trace:
            spans.records.append(("transcribe", t0_ns, t1_ns, 1))
        if k != traced_call:
            plain.append((k, t0_ns, t1_ns))
        calls.append((k % len(sets), segs))
        t_end = time.perf_counter()
        if t_end - t_start >= seconds and len(calls) > traced_call:
            break
    window_s = t_end - t_start
    peak = harness.memory_peak(device)
    spans.restore()
    if trace:
        # the wrapper holds the transcriber (and through it the weights)
        del bt._iterate_llm, round_fn, traced_round
    prog = program.collect(tracer, spans, [(a, b) for _, a, b in plain],
                           setup_end_ns)

    n_streams = sum(len(segs) for _, segs in calls)
    decoded = [[_decoded(s, len(seeks)) for s in segs] for _, segs in calls]
    failed = sum(d is None for c in decoded for d in c)

    # the sample: one call drawn from the seed, and streams of it it
    # served whole
    rng = np.random.default_rng(traffic.seed_for(seed, 3))
    c = int(rng.integers(len(calls)))
    whole = [s for s in range(len(decoded[c])) if decoded[c][s] is not None]
    picked = sorted(int(s) for s in rng.choice(
        whole, min(spec["sample_streams"], len(whole)), replace=False))
    # the program's routing of the sample, from the call made again
    bt.routes = {}
    replay = bt.transcribe(sets[calls[c][0]])
    routes, bt.routes = bt.routes, None
    pcm_set = sets[calls[c][0]]
    n_prompt = model_omni.llm_config(cfg).prompt_len
    windows = []
    for s in picked:
        again = _decoded(replay[s], len(seeks))
        if again is None or [i for i, _ in again] != \
                [i for i, _ in decoded[c][s]]:
            print(f"audio_llm: the routing call served stream {s} other "
                  "tokens than the timed call", file=sys.stderr)
        for seek, (ids, lps) in zip(seeks, decoded[c][s]):
            kept, probs = routes[(s, seek)]
            t = n_prompt + len(ids) - 1
            windows.append(check_omni.Window(pcm_set[s], seek, ids, lps,
                                              kept[:t], probs[:t]))
    out_rec = None
    if trace:
        out_rec = _record(cell, spans, dtrace, decoded, plain, prog,
                          n_prompt)
    del bt, ctx, params, sets, calls, replay, routes
    harness.free_memory(device)

    # the reference, on the same weights made again from the seed
    params = model_omni.make_params(cfg, seed, device)
    gaps = check_omni.gaps(params, cfg, windows)
    control_gaps = (check_omni.gaps(params, cfg, windows, control=True)
                    if control else None)
    del params
    harness.free_memory(device)
    readings = harness.readings(gaps, failed, "streams_failed")
    readings["routes_handed"] = float(np.mean(gaps["routes_handed"])) \
        if len(windows) else None
    for key in ("routes_wide_disagree", "routes_rule_broken"):
        readings[key] = float(np.sum(gaps[key]))
    readings["route_prob_gap"] = float(np.max(gaps["route_prob_gap"])) \
        if len(windows) else None
    correct, checks = harness.judge(readings, cell.limits)
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


def _record(cell, spans, dtrace, decoded, plain, prog, n_prompt) -> dict:
    """What the per-layer metrics of a traced run read: the device trace
    of the traced round, and over the untraced calls (`plain`: (call,
    t0_ns, t1_ns)) their wall, spans, the program's spans and counters
    (`prog`, program.collect's) and model operations: each served
    window's dense work (flops_omni.window) and the routed experts the
    program's counter says it computed."""
    cfg = cell.config
    work = 0.0
    for k, _, _ in plain:
        for served in decoded[k]:
            if served is not None:
                work += sum(flops_omni.window(cfg, n_prompt + len(ids) - 1,
                                              len(ids)) for ids, _ in served)
    routed = prog and prog["window"].get("moe_routed")
    if routed:
        work += flops_omni.routed(cfg, routed["value"])
    red = None
    if dtrace.done:
        red = tracing.reduce_trace(
            dtrace, spans, gap_names=("transcribe", "iterate", "encode",
                                      "prefill", "step") + program.GAPS,
            count_in=("step",))
        tracing.log_trace(red)
    return {"window_s": sum(b - a for _, a, b in plain) / 1e9,
            "flops": work if routed else None,
            "spans": spans.summary([(a, b) for _, a, b in plain]),
            "program": prog, "trace": red, "kernels": {},
            "batch": cell.traffic["batch"], "d_model": cfg["hidden_size"]}
