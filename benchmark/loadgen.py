"""The open-loop load generator of the server cells, run in a process of
its own so that it shares no interpreter lock with the server:

    python -m benchmark.loadgen '<job json>'

The job names the server's address, the traffic file's parameters, the
seed and the window's seconds.  The generator builds every request's WAV
first, prints READY, then sends each `POST /inference` at its due time
(one thread a request, so a slow response delays no later send) and
waits for every response.  Its last line on standard output is a JSON
object: per request its index, clip samples, due / sent / done seconds
from the window's start, HTTP status, and the token ids of each segment
of a verbose_json body with their probabilities (or the error).
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time

from . import traffic


def _send(host, port, body, ctype, timeout, rec) -> None:
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request("POST", "/inference", body=body,
                         headers={"Content-Type": ctype})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        rec["status"] = resp.status
        doc = json.loads(data)
        if resp.status == 200:
            segs = doc.get("segments", [])
            rec["tokens"] = [seg.get("tokens", []) for seg in segs]
            rec["probs"] = [[w["probability"] for w in seg.get("words", [])]
                            for seg in segs]
        else:
            rec["error"] = str(doc.get("error", data[:200]))
    except Exception as e:  # noqa: BLE001 - every failure is recorded
        rec["status"] = 0
        rec["error"] = f"{type(e).__name__}: {e}"
    rec["done"] = time.perf_counter()


def main(argv=None) -> int:
    job = json.loads((argv or sys.argv[1:])[0])
    spec, seed = job["spec"], job["seed"]
    plan = traffic.schedule(spec, seed, job["seconds"])
    bodies = [traffic.multipart(spec["fields"], traffic.wav_bytes(
        traffic.clip_pcm(spec, seed, i, n))) for i, (_, n) in enumerate(plan)]
    recs = [{"index": i, "samples": n, "due": due}
            for i, (due, n) in enumerate(plan)]
    print("READY", flush=True)
    t0 = time.perf_counter()
    threads = []
    for rec, (body, ctype) in zip(recs, bodies):
        wait = t0 + rec["due"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec["sent"] = time.perf_counter()
        th = threading.Thread(target=_send, args=(
            job["host"], job["port"], body, ctype, job["timeout_s"], rec))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    for rec in recs:
        rec["sent"] -= t0
        rec["done"] -= t0
    print(json.dumps({"requests": recs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
