"""HTTP transcription server (whisper-server equivalent; port of
whisper_tpu.server, with the same response bodies).

Same routes and request/response shapes as the reference server
(reference: examples/server/server.cpp:686-1035):

  POST /inference — multipart form: file=<audio>, plus any whisper_full
                    parameter overrides (temperature, language,
                    response_format, ...)
  POST /stream    — the same form; Server-Sent Events, one per segment
  POST /load      — {"model": path} switch the loaded model
  GET  /health    — {"status": "ok"}

Implemented on the stdlib http.server (the reference vendors httplib).
Without --batch, requests are serialized through one lock: the card is a
single shared resource, like the reference's single whisper_context.
With --batch N, compatible requests ride a ContinuousBatcher.

    python -m whisper_tpu_torch.server -m MODEL.bin --batch 4
    python -m whisper_tpu_torch.server -m MODEL.bin --device cpu

The model runs on --device (the card by default), in bfloat16.

Over a tensor-parallel mesh (parallel/mesh.py; one process a card, e.g.
under torchrun) the server is built in process: every rank builds the same
context, attaches the mesh with BatchTranscriber(ctx, mesh=...) and calls
`install(ctx, batch=N)`; rank 0 then serves Handler on a
ThreadingHTTPServer and every other rank calls `follow()`, which replays
rank 0's work (parallel/conductor.py) until rank 0 closes its worker or
loads another model.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import re
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .api import SamplingStrategy, WhisperContext, full_default_params
from .audio.io import load_audio
from .outputs import to_timestamp
from .parallel.conductor import Conductor, full_streaming
from .utils.trace import TRACE


class _State:
    ctx: WhisperContext | None = None
    model_path: str = ""
    lock = threading.Lock()
    batcher: "_BatchWorker | None" = None
    # the serial server over a mesh: its requests' full() on every rank
    conductor: Conductor | None = None


STATE = _State()


class _BatchWorker:
    """Cross-request CONTINUOUS batching: concurrent /inference requests
    with compatible decode parameters ride one persistent device batch
    whose rows are refilled between window iterations
    (parallel/batch.ContinuousBatcher), in place of the reference's
    one-context-one-request server (server.cpp:694).

    A long stream never head-of-line-blocks later requests: a request
    arriving mid-batch joins at the next window iteration and finished
    streams free their slot immediately.

    Engines are keyed by the decode-parameter signature; at most
    MAX_ENGINES live at once (each holds its decode functions and a
    scheduler thread), further signatures fall back to serial ctx.full
    under a lock.  window_ms is kept for CLI compatibility; continuous
    admission makes a collection window unnecessary.

    Over a tensor-parallel mesh (ctx.mesh with n_data = n_slice = 1) every
    rank constructs the worker with the same arguments; its engines start
    no thread, and one Conductor (parallel/conductor.py) a rank runs them
    and the serial fallback: rank 0's routes each request (`route`) and
    schedules, the other ranks replay its plans until `follow()` returns.
    """

    MAX_ENGINES = 4

    def __init__(self, ctx: WhisperContext, batch_size: int = 8,
                 window_ms: int = 50, warmup: bool = True):
        mesh = ctx.mesh
        if mesh is not None and mesh.n_data > 1:
            raise NotImplementedError(
                f"the batched server over a data-parallel mesh "
                f"({mesh.shape}): whisper_tpu's engine fails every job there "
                "(ContinuousBatcher); only n_data = n_slice = 1 runs")
        self.ctx = ctx
        self.batch_size = batch_size
        self.window_s = window_ms / 1000.0
        self._elock = threading.Lock()   # engine registry
        self._slock = threading.Lock()   # serial-fallback requests
        self.engines: dict = {}
        self.conductor = (None if mesh is None
                          else Conductor(ctx, self.engines, router=self))
        if warmup and ctx.n_loaded > 0:
            # pre-build the default-signature engine and run the encoder
            # and both decode prompt buckets once, so no live request on
            # the default configuration pays the one-time set-up (over a
            # mesh every rank's constructor does so at the same point)
            t0 = time.perf_counter()
            self.new_engine(self._default_params(), warmup=True)
            print(f"server: warmed the default engine in "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        if self.conductor is not None:
            self.conductor.start()

    @staticmethod
    def _default_params():
        p = full_default_params()
        p.print_progress = False
        # match the handler's server-level defaults so the warmup compiles
        # the same decode configuration live requests use
        p.greedy.best_of = 2
        p.no_context = False
        return p

    @staticmethod
    def _signature(p) -> tuple:
        """Requests may share one device batch ONLY if every decode-
        affecting parameter matches — the engine applies its own params
        to every stream it carries, so anything missing here silently
        leaks settings between requests."""
        return (p.language, p.translate, p.no_timestamps, p.single_segment,
                p.no_context,
                p.max_tokens, p.temperature, p.temperature_inc,
                p.strategy,
                p.beam_search.beam_size, p.greedy.best_of,
                p.offset_ms, p.duration_ms,
                p.initial_prompt, p.suppress_regex, p.suppress_blank,
                p.suppress_nst, p.max_len, p.split_on_word,
                p.token_timestamps, p.thold_pt, p.thold_ptsum,
                p.entropy_thold, p.logprob_thold, p.no_speech_thold,
                p.n_max_text_ctx, p.audio_ctx, p.tdrz_enable,
                p.detect_language, p.max_initial_ts, p.length_penalty)

    def _batchable(self, p) -> bool:
        """Configs the batched engine carries: the full quality surface —
        best_of ladder diversity, token
        timestamps, beam search (S streams x K beams in one device
        batch), AND language auto-detect (a batched [sot] pre-pass per
        stream); only host-looped grammar/logit-filter decoding and beam
        requests wider than the device batch (beam rows are coupled
        within a step) go serial."""
        if p.strategy == SamplingStrategy.BEAM_SEARCH:
            need = p.beam_search.beam_size
            if p.temperature_inc > 0.0:
                need = max(need, p.greedy.best_of)
            if need > self.batch_size:
                return False
        return (p.strategy in (SamplingStrategy.GREEDY,
                               SamplingStrategy.BEAM_SEARCH)
                and p.grammar_rules is None
                and p.logits_filter_callback is None)

    def route(self, params, make=None):
        """The engine that carries a request with these params, made when
        its signature has none and there is room (by make(params): over a
        mesh the conductor's engine plan), or None: the request runs as a
        serial full()."""
        if not self._batchable(params):
            return None
        with self._elock:
            eng = self.engines.get(self._signature(params))
            if eng is None and len(self.engines) < self.MAX_ENGINES:
                eng = (make or self.new_engine)(params)
        return eng

    def new_engine(self, params, warmup: bool = False):
        """Make and register the engine of params' signature (over a mesh,
        on every rank, under the conductor)."""
        from .parallel.batch import ContinuousBatcher
        eng = ContinuousBatcher(
            self.ctx, batch_size=self.batch_size,
            params=copy.deepcopy(params), warmup=warmup,
            conductor=self.conductor)
        self.engines[self._signature(params)] = eng
        return eng

    def submit(self, pcm, params, on_segment=None):
        """Blocks until this request's segments are ready -> (segments,
        lang_id).  on_segment(Segment), if given, is called for each
        segment AS THE ENGINE PRODUCES IT (between window iterations on
        the batched path, per emission on the serial path)."""
        if self.conductor is not None:
            return self.conductor.submit(pcm, params, on_segment)
        eng = self.route(params)
        if eng is not None:
            job = eng.submit_async(pcm, on_segment=on_segment)
            job.done.wait()
            if job.error is not None:
                raise RuntimeError(job.error)
            return list(job.st.result_all), job.st.full_lang_id()
        with self._slock:
            state = self.ctx.init_state()
            if full_streaming(self.ctx, params, pcm, state, on_segment) != 0:
                raise RuntimeError("failed to process audio")
            return list(state.result_all), state.full_lang_id()

    def submit_stream(self, pcm, params, on_segment):
        """submit() with on_segment, -> the segments: the transport behind
        the server's SSE /stream endpoint."""
        return self.submit(pcm, params, on_segment)[0]

    def follow(self) -> None:
        """A rank other than 0 of a mesh: replay rank 0's work until it
        closes the worker or loads another model."""
        if self.conductor is None:
            raise RuntimeError("follow() is for the ranks of a mesh")
        self.conductor.follow()

    def rebind(self, ctx: WhisperContext) -> None:
        """Swap the model (POST /load): drain and drop every engine --
        they hold the old weights.  Over a mesh the conductor drains them
        and its close plan releases the other ranks; `ctx` (from_file's,
        with no mesh, as whisper_tpu's /load gives) is then served by
        engines with threads of their own."""
        if ctx.mesh is not None:
            raise NotImplementedError(
                "rebinding the server to a mesh-attached context: the other "
                "ranks cannot follow a context that rank 0 loads")
        self._drop(ctx)

    def close(self) -> None:
        self._drop(self.ctx)

    def _drop(self, ctx: WhisperContext) -> None:
        if self.conductor is not None:
            self.conductor.close()   # every rank's engines end with it
        with self._elock:
            engines = list(self.engines.values())
            self.engines.clear()
            self.ctx = ctx
            if ctx.mesh is None:
                self.conductor = None
        for eng in engines:
            eng.close()


class _SegmentsView:
    """Read-only accessor facade over a segment list (for formatters)."""

    def __init__(self, segments, lang_id=0, ctx=None):
        self._segs = segments
        self._lang = lang_id
        self._ctx = ctx

    def full_n_segments(self): return len(self._segs)
    def full_lang_id(self): return self._lang
    def full_get_segment_t0(self, i): return self._segs[i].t0
    def full_get_segment_t1(self, i): return self._segs[i].t1
    def full_get_segment_text(self, i): return self._segs[i].text
    def full_get_segment_no_speech_prob(self, i):
        return self._segs[i].no_speech_prob
    def full_n_tokens(self, i): return len(self._segs[i].tokens)
    def full_get_token_id(self, i, j): return self._segs[i].tokens[j].id
    def full_get_token_data(self, i, j): return self._segs[i].tokens[j]
    def full_get_token_text(self, i, j):
        return self._ctx.token_to_str(self._segs[i].tokens[j].id)
    def token_eot(self):
        return self._ctx.token_eot()


def _parse_multipart(body: bytes, content_type: str) -> dict:
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    parts: dict[str, bytes] = {}
    for chunk in body.split(b"--" + boundary):
        # exactly one CRLF follows the boundary and one precedes the next;
        # binary payloads may legitimately start/end with 0x0D/0x0A bytes,
        # so never strip() the data itself
        if chunk.startswith(b"\r\n"):
            chunk = chunk[2:]
        if b"\r\n\r\n" not in chunk:
            continue
        head, _, data = chunk.partition(b"\r\n\r\n")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        mname = re.search(rb'name="([^"]+)"', head)
        if mname:
            parts[mname.group(1).decode()] = data
    return parts


def _apply_request_params(params, form: dict):
    """Per-request overrides (reference: server.cpp:410-518)."""
    def get(key, cast=str):
        if key in form:
            try:
                return cast(form[key].decode().strip())
            except (ValueError, UnicodeDecodeError):
                return None
        return None

    for key, attr, cast in [
        ("offset_t", "offset_ms", int), ("offset_n", None, int),
        ("duration", "duration_ms", int), ("max_context", "n_max_text_ctx", int),
        ("max_len", "max_len", int), ("best_of", None, int),
        ("beam_size", None, int), ("audio_ctx", "audio_ctx", int),
        ("word_thold", "thold_pt", float),
        ("entropy_thold", "entropy_thold", float),
        ("logprob_thold", "logprob_thold", float),
        ("temperature", "temperature", float),
        ("temperature_inc", "temperature_inc", float),
        ("no_speech_thold", "no_speech_thold", float),
    ]:
        v = get(key, cast)
        if v is not None and attr:
            setattr(params, attr, v)
    v = get("best_of", int)
    if v is not None:
        params.greedy.best_of = v
    v = get("beam_size", int)
    if v is not None:
        params.beam_search.beam_size = v
        if v > 1:
            params.strategy = SamplingStrategy.BEAM_SEARCH
    for key, attr in [("translate", "translate"),
                      ("diarize", None), ("tinydiarize", "tdrz_enable"),
                      ("split_on_word", "split_on_word"),
                      ("no_timestamps", "no_timestamps"),
                      ("detect_language", "detect_language"),
                      ("no_context", "no_context"),
                      # both spellings accepted (server.cpp:504-511)
                      ("suppress_non_speech", "suppress_nst"),
                      ("suppress_nst", "suppress_nst")]:
        v = get(key)
        if v is not None and attr:
            setattr(params, attr, v in ("1", "true", "True"))
    v = get("language")
    if v:
        params.language = v
    v = get("prompt")
    if v:
        params.initial_prompt = v
    v = get("suppress_regex")
    if v:
        params.suppress_regex = v
    # srt numbering offset (server.cpp srt branch: i + 1 + params.offset_n)
    offset_n = get("offset_n", int) or 0
    return get("response_format") or "json", offset_n


def _output_str(ctx) -> str:
    """Reference output_str (server.cpp:384-399): every segment's text
    followed by ONE newline — the "text" body and the json "text" field
    are byte-compatible with the reference server."""
    return "".join(ctx.full_get_segment_text(i) + "\n"
                   for i in range(ctx.full_n_segments()))


def _format_response(ctx, fmt: str, params=None,
                     duration_s: float | None = None,
                     offset_n: int = 0) -> tuple[str, str]:
    """-> (content_type, body).  Bodies are byte-identical to the
    reference whisper-server's (server.cpp:879-993): per-segment newlines
    in text, nlohmann-compact json, srt numbering honoring offset_n.
    (verbose_json is structurally identical; float formatting differs —
    nlohmann shortest-round-trip f32 vs Python double repr.)"""
    n = ctx.full_n_segments()
    if fmt == "text":
        # the reference serves text as text/html (server.cpp:882)
        return "text/html; charset=utf-8", _output_str(ctx)
    if fmt == "srt":
        out = io.StringIO()
        for i in range(n):
            out.write(f"{i + 1 + offset_n}\n"
                      f"{to_timestamp(ctx.full_get_segment_t0(i), True)}"
                      f" --> {to_timestamp(ctx.full_get_segment_t1(i), True)}\n"
                      f"{ctx.full_get_segment_text(i)}\n\n")
        return "application/x-subrip", out.getvalue()
    if fmt == "vtt":
        out = io.StringIO()
        out.write("WEBVTT\n\n")
        for i in range(n):
            out.write(f"{to_timestamp(ctx.full_get_segment_t0(i))}"
                      f" --> {to_timestamp(ctx.full_get_segment_t1(i))}\n"
                      f"{ctx.full_get_segment_text(i)}\n\n")
        return "text/vtt", out.getvalue()
    if fmt == "verbose_json":
        # field semantics follow the reference server (server.cpp:927-980):
        # full language name, translate-aware task, pcm-length duration,
        # per-segment token ids + "words" array with per-token timing
        # (present only for non-special tokens, timestamps gated on
        # no_timestamps), temperature, avg_logprob (the reference divides
        # the non-special logprob sum by the FULL token count — kept)
        from .languages import lang_str_full
        no_ts = params is not None and params.no_timestamps
        eot = ctx.token_eot()
        segments = []
        for i in range(n):
            seg = {"id": i, "text": ctx.full_get_segment_text(i)}
            if not no_ts:
                seg["start"] = ctx.full_get_segment_t0(i) / 100.0
                seg["end"] = ctx.full_get_segment_t1(i) / 100.0
            tok_ids, words, total_logprob = [], [], 0.0
            n_tok = ctx.full_n_tokens(i)
            for j in range(n_tok):
                tok = ctx.full_get_token_data(i, j)
                if tok.id >= eot:
                    continue
                tok_ids.append(tok.id)
                word = {"word": ctx.full_get_token_text(i, j)}
                if not no_ts:
                    word["start"] = tok.t0 / 100.0
                    word["end"] = tok.t1 / 100.0
                    word["t_dtw"] = tok.t_dtw
                word["probability"] = tok.p
                total_logprob += tok.plog
                words.append(word)
            if tok_ids:
                seg["tokens"] = tok_ids
                seg["words"] = words
            seg["temperature"] = (params.temperature
                                  if params is not None else 0.0)
            seg["avg_logprob"] = total_logprob / max(n_tok, 1)
            seg["no_speech_prob"] = ctx.full_get_segment_no_speech_prob(i)
            segments.append(seg)
        doc = {
            "task": ("translate" if params is not None and params.translate
                     else "transcribe"),
            "language": lang_str_full(ctx.full_lang_id()) or "english",
            "duration": (duration_s if duration_s is not None
                         else (ctx.full_get_segment_t1(n - 1) / 100.0
                               if n else 0.0)),
            "text": _output_str(ctx),
            "segments": segments,
        }
        return "application/json", json.dumps(doc, ensure_ascii=False,
                                              separators=(",", ":"))
    # default: simple json — nlohmann-compact, output_str text
    return "application/json", json.dumps(
        {"text": _output_str(ctx)}, ensure_ascii=False,
        separators=(",", ":"))


def _worker():
    """What the requests go through: the batched worker, or over a mesh
    the serial server's conductor; None: full() here, under the lock."""
    return STATE.batcher if STATE.batcher is not None else STATE.conductor


class Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, content_type: str, body: str):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # quiet
        print(f"server: {fmt % args}", file=sys.stderr)

    def do_GET(self):
        if self.path == "/health":
            # byte-identical to the reference (server.cpp:1036)
            self._send(200, "application/json", '{"status":"ok"}')
        else:
            self._send(404, "application/json", '{"error": "not found"}')

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        if self.path == "/inference":
            # a request enters the program here (traced: its id and the
            # span `http`, whose self time is the handler's own)
            with TRACE.request(), TRACE.span("http", length):
                self._do_inference(self.rfile.read(length))
            return
        body = self.rfile.read(length)

        if self.path == "/load":
            try:
                req = json.loads(body)
                with STATE.lock:
                    # the new model goes where the one it replaces was
                    STATE.ctx = WhisperContext.from_file(
                        req["model"], device=STATE.ctx.device,
                        compute_dtype=STATE.ctx.compute_dtype)
                    STATE.model_path = req["model"]
                    if STATE.batcher is not None:
                        # engines hold the old weights; drain them and
                        # rebind to the new model
                        STATE.batcher.rebind(STATE.ctx)
                    if STATE.conductor is not None:
                        # the serial server over a mesh: its close plan
                        # releases the other ranks; the new context has
                        # no mesh, and is served as without one
                        STATE.conductor.close()
                        STATE.conductor = None
                # reference responds with this exact text (server.cpp:1029)
                self._send(200, "application/text", "Load was successful!")
            except Exception as e:
                self._send(400, "application/json",
                           json.dumps({"error": str(e)}))
            return

        if self.path == "/stream":
            self._do_stream(body)
            return
        self._send(404, "application/json", '{"error": "not found"}')

    def _do_inference(self, body: bytes):
        """POST /inference: one multipart form, one transcription."""
        try:
            form = _parse_multipart(body, self.headers.get("Content-Type", ""))
            if "file" not in form:
                raise ValueError("no 'file' field in the request")
            with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                tmp.write(form["file"])
                tmp.flush()
                pcm, _ = load_audio(tmp.name)

            params = full_default_params()
            params.print_progress = False
            # server-level defaults that differ from whisper_full_default_
            # params (reference server.cpp:56, 82): best_of 2, and context
            # IS carried across windows within a request
            params.greedy.best_of = 2
            params.no_context = False
            fmt, offset_n = _apply_request_params(params, form)
            # post-parse rules (server.cpp:808, 833): max_len defaults to
            # 60, token timestamps only for verbose_json responses
            if params.max_len == 0:
                params.max_len = 60
            params.token_timestamps = (not params.no_timestamps
                                       and fmt == "verbose_json")

            if STATE.ctx is None:
                raise RuntimeError("no model loaded")
            duration_s = len(pcm) / 16000.0
            worker = _worker()
            if worker is not None:
                # the serial server's conductor: the language of the
                # context's own state, as full() here would leave it
                segs, lid = worker.submit(pcm, params)
                if (STATE.batcher is not None
                        and params.language not in (None, "", "auto")):
                    from .languages import lang_id as _lang_id
                    lid = _lang_id(params.language)
                view = _SegmentsView(segs, max(lid, 0), ctx=STATE.ctx)
                ctype, out = _format_response(view, fmt, params, duration_s,
                                              offset_n)
            else:
                with STATE.lock:
                    if STATE.ctx.full(params, pcm) != 0:
                        raise RuntimeError("failed to process audio")
                    ctype, out = _format_response(STATE.ctx, fmt, params,
                                                  duration_s, offset_n)
            self._send(200, ctype, out)
        except Exception as e:
            self._send(500, "application/json", json.dumps({"error": str(e)}))

    def _do_stream(self, body: bytes):
        """POST /stream — Server-Sent Events transcription: one `data:`
        event per segment AS IT IS PRODUCED (the continuous-batching
        engine finalizes segments between window iterations; a long file
        streams its text progressively instead of landing all at once).
        This endpoint has no reference-server counterpart — the reference
        returns only complete responses (server.cpp:694) — it is the
        serving-shaped answer to whisper-stream's incremental printing
        (reference: examples/stream/stream.cpp:118-260).

        Events:  data: {"start": s, "end": s, "text": "..."}\n\n  per
        segment, then  data: [DONE]\n\n.  Errors before the first byte
        are normal HTTP 500s; later ones become an `event: error` frame.
        """
        import queue as _q

        try:
            form = _parse_multipart(body, self.headers.get("Content-Type", ""))
            if "file" not in form:
                raise ValueError("no 'file' field in the request")
            with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                tmp.write(form["file"])
                tmp.flush()
                pcm, _ = load_audio(tmp.name)
            params = full_default_params()
            params.print_progress = False
            params.greedy.best_of = 2
            params.no_context = False
            _apply_request_params(params, form)
            if params.max_len == 0:
                params.max_len = 60
            if STATE.ctx is None:
                raise RuntimeError("no model loaded")
        except Exception as e:
            self._send(500, "application/json", json.dumps({"error": str(e)}))
            return

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Connection", "close")
        self.end_headers()

        def _event(seg) -> bytes:
            return ("data: " + json.dumps(
                {"start": seg.t0 / 100.0, "end": seg.t1 / 100.0,
                 "text": seg.text}, ensure_ascii=False,
                separators=(",", ":")) + "\n\n").encode("utf-8")

        try:
            worker = _worker()
            if worker is not None:
                # segments arrive from the engine's scheduler thread (or
                # the conductor's); hand them to this handler thread
                # through a queue
                chan: "_q.Queue" = _q.Queue()
                done = object()

                def _pump():
                    try:
                        worker.submit(pcm, params, chan.put)
                        chan.put(done)
                    except Exception as e:  # noqa: BLE001
                        chan.put(RuntimeError(str(e)))

                t = threading.Thread(target=_pump, daemon=True)
                t.start()
                while True:
                    item = chan.get()
                    if item is done:
                        break
                    if isinstance(item, Exception):
                        raise item
                    self.wfile.write(_event(item))
                    self.wfile.flush()
            else:
                with STATE.lock:
                    n_seen = 0

                    def _cb(st, n_new, _=None):
                        nonlocal n_seen
                        segs = st.result_all
                        while n_seen < len(segs):
                            self.wfile.write(_event(segs[n_seen]))
                            n_seen += 1
                        self.wfile.flush()

                    params.new_segment_callback = _cb
                    if STATE.ctx.full(params, pcm) != 0:
                        raise RuntimeError("failed to process audio")
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except Exception as e:  # headers already sent: emit an error frame
            try:
                self.wfile.write(
                    b"event: error\ndata: " +
                    json.dumps({"error": str(e)}).encode() + b"\n\n")
                self.wfile.flush()
            except OSError:
                pass


def _arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="whisper-server")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch", type=int, default=0,
                    help="cross-request batching: max requests per device "
                         "batch (0 = serial, reference behavior)")
    ap.add_argument("--batch-window-ms", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model: cuda (default) or cpu")
    return ap


def install(ctx: WhisperContext, model_path: str = "", batch: int = 0,
            window_ms: int = 50, warmup: bool = True) -> None:
    """Make `ctx` the served model, with --batch's worker: a _BatchWorker
    when batch > 0, else (over a mesh) a Conductor for the serial
    server.  Over a mesh every rank calls it with the same arguments;
    rank 0 then serves Handler, the others call follow()."""
    STATE.ctx, STATE.model_path = ctx, model_path
    STATE.batcher = STATE.conductor = None
    if batch > 0:
        STATE.batcher = _BatchWorker(ctx, batch_size=batch,
                                     window_ms=window_ms, warmup=warmup)
    elif ctx.mesh is not None:
        # the context's own state, as full() without a mesh decodes into
        STATE.conductor = Conductor(ctx, state=ctx._default_state)
        STATE.conductor.start()


def follow() -> None:
    """A rank other than 0 of a mesh, after install(): replay rank 0's
    work until rank 0 closes its worker or loads another model."""
    worker = _worker()
    if worker is None:
        raise RuntimeError("follow() is for the ranks of a mesh")
    worker.follow()


def main(argv=None) -> int:
    args = _arg_parser().parse_args(argv)

    install(WhisperContext.from_file(args.model, device=args.device),
            args.model, args.batch, args.batch_window_ms)
    if args.batch > 0:
        print(f"cross-request batching: up to {args.batch} per step",
              file=sys.stderr)

    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"whisper-server listening on http://{args.host}:{args.port}",
          file=sys.stderr)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
