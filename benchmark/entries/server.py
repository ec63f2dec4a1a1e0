"""Entry "server": whisper-server in process, under an open loop of
`POST /inference` requests from a load generator in a process of its own
(benchmark/loadgen.py).

Set-up builds the model from the seed, installs it as the served model
with --batch's worker (`server.install(ctx, batch=B, warmup=False)`),
serves `server.Handler` on a ThreadingHTTPServer at 127.0.0.1 (a free
port), and sends one warm request with the traffic's fields, which makes
the engine of the requests' signature and runs every shape they use.
The window opens when the generator is ready: it sends each request at
its due time until `seconds`, then waits for every response.
request_p95_s is the 95th percentile of every request's latency, from
its due time to its last byte (a failed request counts as infinitely
late).

Once every response is in and the program's state is freed, a sample of
the requests, drawn from the seed, with the longest clip in it, is
judged against the reference: the host mel of the request's own audio,
the bare prompt, the tokens of its response (and the end of text that
closed a window shorter than the loop's bound).  The traced run records
spans over the window (the encoder's fenced) and the device trace over
whole engine iterations (traffic "trace_iterations", counted from the
window's start by the engine's iteration_hook); the metrics read from
spans and host clocks are taken over the window up to the trace's
start, which the profiler neither slows nor stalls (its stop holds the
interpreter while it collects the events).
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from benchmark import harness, model, tracing, traffic
from benchmark.reference import check

ROOT = Path(harness.__file__).resolve().parents[1]   # holds benchmark/


def _post(host, port, fields: dict, pcm: np.ndarray) -> tuple[int, bytes]:
    body, ctype = traffic.multipart(fields, traffic.wav_bytes(pcm))
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        conn.request("POST", "/inference", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _loop_bound(cfg: dict, max_tokens: int) -> int:
    """Tokens a window may decode: whisper.cpp's n_text_ctx / 2 - 4, or
    max_tokens + 1 under a max_tokens."""
    n = cfg["max_target_positions"] // 2 - 4
    return min(n, max_tokens + 1) if max_tokens > 0 else n


class Served:
    """whisper-server in this process, warm, on a free local port."""

    def __init__(self, cell, seed: int, device):
        from http.server import ThreadingHTTPServer

        from whisper_tpu_torch import server
        cfg, spec = cell.config, cell.traffic
        self.server = server
        self.params = model.make_params(cfg, seed, device)
        self.ctx = model.make_context(cfg, self.params, device)
        server.install(self.ctx, batch=spec["batch"], warmup=False)
        self.http = ThreadingHTTPServer(("127.0.0.1", 0), server.Handler)
        self.thread = threading.Thread(target=self.http.serve_forever,
                                       daemon=True, name="benchmark-http")
        self.thread.start()
        self.host, self.port = self.http.server_address[:2]
        warm = traffic.clip_pcm(spec, seed, -1,
                                int(spec["clip_s"]["median"] * 16000))
        status, body = _post(self.host, self.port, spec["fields"], warm)
        if status != 200:
            raise RuntimeError(f"warm request: HTTP {status}: {body[:300]!r}")
        self.worker = server.STATE.batcher
        (self.engine,) = self.worker.engines.values()

    def window(self, spec: dict, seed: int, seconds: float,
               on_ready=None) -> list:
        """Run the load generator over one window; -> its request records.
        on_ready() is called as the generator starts sending."""
        job = {"host": self.host, "port": self.port, "spec": spec,
               "seed": seed, "seconds": seconds, "timeout_s": 600}
        gen = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen",
                                json.dumps(job)], cwd=ROOT,
                               stdout=subprocess.PIPE, text=True)
        try:
            ready = gen.stdout.readline().strip()
            if ready != "READY":
                raise RuntimeError(f"load generator: {ready!r}")
            if on_ready is not None:
                on_ready()
            out, _ = gen.communicate(timeout=seconds + 900)
        finally:
            if gen.poll() is None:
                gen.kill()
                gen.wait()
        if gen.returncode != 0:
            raise RuntimeError(f"load generator exited {gen.returncode}")
        return json.loads(out.strip().splitlines()[-1])["requests"]

    def close(self) -> None:
        self.worker.close()
        self.http.shutdown()
        self.http.server_close()
        self.thread.join(timeout=30)
        self.server.STATE.batcher = self.server.STATE.ctx = None
        self.worker = self.engine = self.ctx = self.params = None


def p95(reqs: list) -> float:
    """95th percentile (linear between order statistics) of every
    request's latency from its due time; a failed request is infinitely
    late."""
    lat = np.asarray([r["done"] - r["due"] if r["status"] == 200
                      else np.inf for r in reqs])
    return float(np.percentile(lat, 95)) if len(lat) else float("nan")


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    """Drive the cell; -> the entry's result (see benchmark/run.py).
    control: also read the control's gaps on the same sample (the
    calibration, never a benchmark run)."""
    from whisper_tpu_torch.models import whisper as wm
    from whisper_tpu_torch.parallel import batch as batch_mod

    cfg, spec = cell.config, cell.traffic
    served = Served(cell, seed, device)
    eng, worker = served.engine, served.worker

    spans = tracing.Spans()
    dtrace = tracing.DeviceTrace()
    shapes = harness.LaunchShapes(cell.rooflines(), dtrace)
    first, last = spec["trace_iterations"]
    n0 = [eng.n_iterations]
    if trace:
        spans.fence = lambda: harness.fence(device)
        spans.wrap(batch_mod, "log_mel_spectrogram", "mel")
        spans.wrap(eng.bt, "_iterate", "iterate",
                   value=lambda a, k, out: len(a[1]))
        spans.wrap(eng.bt, "_encode_batch", "encode", fenced=True,
                   value=lambda a, k, out: a[0].shape[0])
        spans.wrap(eng.bt, "_decode_rows", "decode",
                   value=lambda a, k, out: int(out["n_tokens"]))
        spans.wrap(wm, "decode_prompt", "prompt")
        spans.wrap(wm, "decode_step", "step")
        spans.wrap(worker, "submit", "submit")
        if harness.is_cuda(device):
            shapes.install()

            def hook(n):
                if n - n0[0] == first and dtrace.prof is None:
                    dtrace.start()
                elif n - n0[0] == last and dtrace.active:
                    dtrace.stop()
            eng.iteration_hook = hook

    opened = {}

    def ready():
        n0[0] = eng.n_iterations
        opened["setup_s"] = tracing.process_age_s()
        opened["w0_ns"] = time.time_ns()

    reqs = served.window(spec, seed, seconds, ready)
    w1_ns = time.time_ns()
    n_iter = eng.n_iterations - n0[0]
    eng.iteration_hook = None
    if dtrace.active:
        dtrace.stop()
    peak = harness.memory_peak(device)
    spans.restore()
    shapes.restore()
    served.close()

    ok = [r for r in reqs if r["status"] == 200]
    failed = len(reqs) - len(ok)
    rng = np.random.default_rng(traffic.seed_for(seed, 3))
    n_sample = min(spec["sample_requests"], len(ok))
    picked = [ok[i] for i in rng.choice(len(ok), n_sample, replace=False)]
    longest = max(ok, key=lambda r: r["samples"], default=None)
    if longest is not None and longest not in picked:
        picked[-1] = longest
    rec = None
    if trace:
        # the span metrics' interval: the window up to the device trace
        end_ns = dtrace.t0_ns if dtrace.prof is not None else w1_ns
        rec = _record(cell, spans, dtrace, shapes, reqs, opened["w0_ns"],
                      end_ns, first if dtrace.prof is not None else n_iter)
    del served, eng, worker
    harness.free_memory(device)

    params = model.make_params(cfg, seed, device)
    windows = _windows(cfg, spec, seed, picked)
    no_ts = spec["fields"].get("no_timestamps") in ("1", "true", "True")
    gaps = check.gaps(params, cfg, windows, no_ts)
    control_gaps = (check.gaps(params, cfg, windows, no_ts, control=True)
                    if control else None)
    del params
    harness.free_memory(device)
    correct, checks = harness.judge(
        harness.readings(gaps, failed, "requests_failed"), cell.limits)
    late = [r["sent"] - r["due"] for r in reqs]
    print(f"server: {len(reqs)} requests, {failed} failed, p95 "
          f"{p95(reqs):.4f} s, {n_iter} iterations, generator late by at "
          f"most {max(late, default=0.0):.4f} s", file=sys.stderr)
    return {
        "correct": correct and len(windows) > 0, "attempted": len(reqs),
        "failed": failed, "device": harness.device_info(device, peak),
        "end_to_end": {"request_p95_s": p95(reqs),
                       "setup_s": opened["setup_s"]},
        "record": rec, "checks": checks, "gaps": gaps,
        "control_gaps": control_gaps,
        "breakdown": (tracing.breakdown(rec["trace"])
                      if rec and rec["trace"] else None),
    }


def _windows(cfg: dict, spec: dict, seed: int, picked: list) -> list:
    """The reference's view of each sampled request: its clip, the host
    mel, the bare prompt, the tokens of its response with the
    log-probability of each (verbose_json's "probability"), and the end of
    text that closed a window shorter than the loop's bound (whose
    probability the response does not carry)."""
    from benchmark.reference import whisper as ref
    tok = ref.special_tokens(cfg["vocab_size"])
    fields = spec["fields"]
    no_ts = fields.get("no_timestamps") in ("1", "true", "True")
    init = ref.initial_prompt(tok, fields["language"], no_ts)
    bound = _loop_bound(cfg, int(fields.get("max_tokens", 0)))
    out = []
    for r in picked:
        served = [t for seg in r["tokens"] for t in seg]
        logprobs = [float(np.log(p)) if p > 0 else float("-inf")
                    for seg in r["probs"] for p in seg]
        if len(served) < bound:
            served.append(tok["eot"])
            logprobs.append(None)
        pcm = traffic.clip_pcm(spec, seed, r["index"], r["samples"])
        out.append(check.Window(pcm, 0, False, init, served, logprobs))
    return out


def _record(cell, spans, dtrace, shapes, reqs, w0_ns, end_ns,
            n_iter) -> dict:
    """What the per-layer metrics of a traced run read: the device trace,
    and over [w0_ns, end_ns) (n_iter engine iterations) the spans, the
    wall and the client latencies of the requests done in it."""
    red = None
    if dtrace.done:
        red = tracing.reduce_trace(
            dtrace, spans, gap_names=("iterate", "mel", "encode", "decode",
                                      "prompt", "step"),
            count_in=("decode",))
        tracing.log_trace(red)
    span_s = (end_ns - w0_ns) / 1e9
    client = [r["done"] - r["sent"] for r in reqs
              if r["status"] == 200 and r["done"] <= span_s]
    return {"window_s": span_s, "iterations": n_iter,
            "spans": spans.summary([(w0_ns, end_ns)]), "trace": red,
            "kernels": shapes.summary(), "batch": cell.traffic["batch"],
            "client_s": client}
