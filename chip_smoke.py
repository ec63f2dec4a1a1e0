"""Drive the PyTorch/CUDA port (whisper_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root; one card
    python3 chip_smoke.py --profile     # path A's full() profiled, see below

Phases, each of which must pass (the script exits nonzero otherwise):
  1. require CUDA; print the card's name and power limit
  2. build kernels K1-K7, the encoder block's five row-wise epilogues
     (csrc/encoder_epilogue.cu; the decode step's layers run them too),
     the decode step's self-attention (csrc/self_attn_step.cu) and the
     cross-KV quantizer (csrc/cross_kv_quant.cu) from
     whisper_tpu_torch/csrc with nvcc (one process per source, in
     parallel)
  3. compare each kernel with its plain PyTorch version on the card at
     every shape the paths below give it, taken from the models they load
     (K2 also with G = 5 queries a (b, h), batched beam search's form; the
     epilogues and cross_kv_quant at the batch cells' 256 windows of
     large-v3's encoder, self_attn_step at their decode step's 256 rows and
     full cache)
     (and K3 at the prompt passes of serving batches of 4 and 64 streams),
     and, after the paths, at every other shape they launched (each
     launch's shape noted from its entry point's arguments; compared,
     not timed),
     each within its own bound (KERNEL_TOL), and time both (CUDA-graph
     replay between CUDA events, median of 20 runs after 3 warm-ups, L2
     flushed before each run), and where one PyTorch call computes the same
     function (scaled_dot_product_attention for K1 in both layouts, K4, K6)
     that call too, and for K3 the `dense_ms` yardstick (F.linear of the
     bf16 x over the dequantized bf16 weight: it reads twice K3's bytes, so
     it is no library call of the same function), for K2 and K5 the same
     (scaled_dot_product_attention over the dequantized bf16 K/V in
     (B, H, Ta, Dh), twice their bytes); each kernel's bound (the
     least time the card could take) is computed from its first shape and
     the card's data-sheet peaks, and each attention kernel's TFLOP/s and
     every kernel's share of its bound are printed at every shape; the
     kernel and its yardsticks are timed once more back to back on cold
     inputs of their own (stream_ms: no graph launch latency in the count)
  4. model checks, bf16 on the card against float32 on the CPU (plain
     versions): large-v3 width cut to 2+2 layers, the prompt pass and one
     decode step in the serving path's einsum_q8 (K1, K2) and in cross
     modes einsum, pallas_q8dt (K2), einsum_q8i and einsum_q4; and a small
     q5_1 file through K1, K3 and K4 ("pallas") or K5 ("pallas_q8")
  5. path A: a large-v3 q5_0 file (random valid blocks, seed 0, written
     once into build/, ~1 GB) through WhisperContext.from_file(...,
     cross_mode="pallas_q8") + full on 30 s of PCM: K1, K3 and K5 launch
  6. path B: a small q5_1 file through from_file(..., cross_mode="pallas")
     + full: K1, K3 with mins and K4 launch
  7. the serving path: BatchTranscriber.transcribe on 4 int16 streams of
     45 s with large-v3 random weights (seed 0), greedy with the bench's
     serving settings: K1, K2 and cross_kv_quant launch; then once more
     with 4-bit cross-KV
     (cross_mode="einsum_q4", bench.py's kv=q4): K1 launches
  8. path C, the CLI's --kv-q8 / --kv-q4: path A's file through
     from_file(..., cross_mode="einsum_q8") + full on 15 s of PCM (K1, K2,
     K3 launch), then cross_mode="einsum_q4" (K1, K3)
  9. path D, the encoder front end: 60 s of PCM through log_mel_pallas
     (K7), then large-v3 `encode` (32 layers, random weights, seed 0) on
     the first window with attn_impl einsum (plain torch), pallas,
     pallas_dt, pallas_pf, pallas_btd (K6) and flash (each timed as the
     median of 5 fenced calls after a warm-up, and on the device alone by
     CUDA-graph replay), each held against pallas and against einsum,
     which never runs a kernel; and
     cross_kv_q8(enc_layout="bdt") from encode(out_layout="bdt") against
     the btd route: K1, K6 and K7 launch
 10. the serving path in bench.py's other quality tiers at 20 rows: bo5
     (best_of 5, the ladder live; its t > 0 rungs must run, logprob_thold
     raised to 0 where the random weights fail no window: K1, K2) and
     beam5 (beam 5: four streams x five beams, K1 and K2 with G = 5)
 11. path A with the CLI's defaults (beam 5, best_of 5, the ladder live) on
     15 s: K1 and K3 (whisper_tpu's serial beam reads the dense cross-KV
     through the einsum, so no cross-attention kernel); 10 and 11 run once
     more twice, each cut short after 16 decode steps of one rung (from
     its 9th step; bo5's first t > 0 rung), timed alone and under
     torch.profiler: device launches, busy time, wall and idle share a
     step
 12. segment parity: the port in bf16 on a small random-weight q8_0 file
     and fixed PCM, greedy and beam 5, against whisper_tpu's segments on
     the CPU (tests/golden/port_segments.json, tests/port_parity.py), and
     greedy teacher-forced at each decided step: K1, K2, K2 with G = 5,
     K3
 13. "continuous": ContinuousBatcher(batch_size=4) on the serving path's
     context (einsum_q8: K1, K2) with 4 int16 streams of 45 s, greedy with
     the ladder off: held at its first iteration until all are queued, it
     must equal BatchTranscriber.transcribe token for token, with the
     resident PCM pool (device_mel) and with host mel; 2 more streams
     submitted while the 4 decode must get their first segment within one
     iteration of joining, every stream holding a pool row; time to first
     segment, iterations, wall and audio-s per wall-s go to stderr
 14. "server": whisper_tpu_torch.server in this process (--batch 4) over
     path A's q5_0 file (K1, K3), WAVs of 30 s: 4 concurrent /inference
     json requests, a /stream request joining them mid-flight, then
     verbose_json with language=auto (token timestamps, language
     detection) and srt with offset_n=3, then /health: every response 200
     and well formed; request times to stderr
 15. "cli": whisper_tpu_torch.cli.main as a user runs it, five runs
     (check_cli): large-v3 q5_0 with -dtw large-v3 -kvq -bs 5 -nf -p 2 and
     every writer on 20 s (DTW stamps inside their windows, chunk 2 after
     10 s; K1, K3 at M = T_pad), a small q5_1 file with
     grammars/colors.gbnf's pieces in its vocab under that grammar with
     -bs 1 (speculative chunks) and -bs 5 (the host beam) on 10 s (the
     native engine; the tokens replay through a fresh grammar), -p 2
     batched with -kvq on 20 s (K1, K2), and BatchTranscriber with DTW
     on two 10 s streams (K1, K2, K3 at M = 2 x T_pad); figures on stderr
 16. "apps": whisper-stream, whisper-command and whisper-lsp
     (whisper_tpu_torch.stream / command / lsp; check_apps) on the native
     host mel, which must have built (its time for 30 s against numpy's on
     stderr): path A's file (pallas_q8) through StreamTranscriber
     fixed-step on 12 s and in VAD mode at audio_ctx 750 (K1 at T = 750, K5
     at Ta = 750), transcribe_utterance at its defaults (beam 5 at t =
     0.4) and lsp unguided; the small q5_1 file with the colors words
     (pallas) through lsp registerCommandset + guided (K3 at M = the
     commandset prompt, with mins) + unguided (K4) and command's grammar
     mode; then the three `main`s on their default device; the shapes
     this phase launches first are timed against their plain versions
 17. the port's draws (decode/rng.py) on the card against the CPU for the
     same keys and logits, and one step's draw cost at the bo5 and beam5
     shapes from a torch.profiler trace
 18. "capi": whisper.h (check_capi): the port's C ABI library
     (whisper_tpu_torch.capi.library_path, from
     whisper_tpu_torch/native/wtpu_capi.cpp) builds and exports every
     whisper.h function; examples/c_demo.c and tests/c_abi_ext.c compiled
     against it run on the card over the small q5_1 file with the colors
     words (c_demo's segments equal to whisper_full in this process,
     c_abi_ext's callbacks, states, logits and in-struct grammar checked as
     tests/test_cabi.py does; their launches are their processes' own);
     whisper_tpu_torch.capi in this process on path A's file: mel, encode,
     a 4-token prompt and 8 steps of whisper_decode (finite logits, the
     same rows teacher-forced within MODEL_TOL), whisper_full and its
     accessors (K1, K3); then whisper-bench (bench_tool.main) -m path A's
     file (K1; K3 at M = 1, 5 and 256), -w 1, -w 2 and -w 3 --size
     large-v3 (K1 at T = 512), each table on stderr; the shapes this phase
     launches first are timed against their plain versions
 19. "mesh": parallel/mesh.py on the one card (check_mesh): two spawned
     ranks over gloo, each with large-v3's random weights (dense bf16,
     einsum_q8), run BatchTranscriber on 4 int16 streams of 15 s (greedy,
     the serving settings) with mesh=None, then over a 1 x 2 mesh (tensor
     parallel: K1 and K2 at 10 heads) and a 2 x 1 mesh (data parallel),
     each held against mesh=None (teacher-forced logits within MESH_TOL,
     tokens equal where the mesh=None margin exceeds it); after the 1 x 2
     run, ContinuousBatcher(batch_size=4) over the same context on both
     ranks (rank 0 schedules, rank 1 replays its plans): the same streams'
     segments equal to the 1 x 2 transcribe's token for token, 2 late
     streams, an idle gap, both ranks' iterations and plan digests equal;
     then the port's server over 1 x 2 on both ranks, with a context of
     its own at large-v3's widths cut to 8 + 8 layers (--batch 4: rank 0
     serves Handler on loopback, rank 1 follows its conductor's plans):
     two streams at once through /inference and /stream (one engine;
     whisper-server's defaults: timestamps, the temperature ladder) and,
     with MAX_ENGINES at 1, a third of another signature (the serial
     full() over the mesh), each response's segments equal token for
     token to that context run directly (BatchTranscriber for the pair,
     full() for the third), both ranks' plans equal, each rank through
     K1 and K2;
     then the script itself, one rank over NCCL, runs
     parallel/mesh.dryrun_multichip at float32; the shapes
     this phase launches first are timed against their plain versions
In 5-8, 10, 11, 13 and 19 every segment list must be non-empty and every
probability finite.
The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.

--profile [--profile-seconds S] runs only path A's full() on the first S
seconds (default 30) of its PCM: with the packed decoder (K3) and with the
same file densified (keep_quantized=False), timed in turns after a warm-up
each, then once more packed under torch.profiler, and prints device time
by kernel, the device's idle share, and launches and device busy time per
decode step (the window's encode and prompt pass spread over its steps;
tools/profile_encoder_torch.py step times the step alone).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# K3's rows: 1 (one token of `full`), 4 (the serving batch), 8 (the bare
# prompt pass) and 232 (n_text_ctx // 2 + 8, the carried-prompt pass)
K3_M = (1, 4, 8, 232)
BENCH_BATCH = 64     # bench.py's default serving batch (K2's largest shape)
# a serving batch's prompt pass through K3: B streams x 232 rows
# (parallel/batch.py `_prompt_bucket` at the default n_max_text_ctx), at
# the serving path's 4 streams and bench.py's 64, over large-v3's linears
K3_SERVE_M = (4 * 232, BENCH_BATCH * 232)
# max |kernel - plain| / max |plain|, per kernel.  K2, K3, K4 and K5 round
# to bf16 exactly where their plain versions do, so only the f32 summation
# order differs.  K3 reads <= 8.1e-7 on the card up to M = 232 and <= 6.3e-6
# at the serving prompt passes (the largest at (14848, 5120, 1280), sums of
# 5120 products in wgmma's order); the plain version against a copy of
# itself that drops one rounding (x, a scale, a weight, or adds the min
# before rounding) reads >= 9.7e-4 at these shapes.  In K2/K4/K5 a
# softmax weight a summation order apart can round to the neighbouring
# bf16 value: they read <= 1.4e-4, and dropping the rounding of the
# weights (times the V scale, in K2 and K5) reads >= 1.7e-3.
# K1's and K6's plain versions compute through bf16 cuBLAS products, not
# at the kernels' rounding points (they read <= 5.0e-3).  K7 is f32
# against f32: it read 4.8e-8, and f32 products on TF32-rounded operands
# read 8.8e-3.
# The encoder's epilogues: the bias casts and residual sums equal their
# plain versions bit for bit (0); the layernorms' bf16 outputs may sit one
# bf16 ulp away (their mean and variance summed in another order than
# PyTorch's Welford), at most 2^-7 of the largest output, and GELU's
# likewise (tanhf compiled otherwise); tests/test_torch_gpu.py counts the
# elements.
# cross_kv_quant's codes and scales equal its plain version's bit for bit.
# The decoder's self_attn_step: its bf16 outputs against the plain step's
# (cuBLAS products, an f32 softmax), which make the same roundings in
# another order: a score within an f32 rounding of a bf16 tie may round
# the other way, and with it the weights, moving an output by about one
# bf16 ulp (2^-8 of the largest output at most); tests/test_torch_gpu.py
# counts the elements.
KERNEL_TOL = {"K1": 2e-2, "K1dt": 2e-2, "K2": 5e-4, "K2G": 5e-4, "K3": 1e-5,
              "K3+mins": 1e-5, "K4": 5e-4, "K5": 5e-4, "K6": 2e-2,
              "K7": 1e-5, "ln_cast": 2 ** -7, "bias_cast": 0.0,
              "bias_residual_ln": 2 ** -7, "bias_gelu_cast": 2 ** -7,
              "bias_residual": 0.0, "self_attn_step": 1e-2,
              "cross_kv_quant": 0.0}
# the encoder block's row-wise epilogue kernels (ops/encoder_epilogue.py)
EPILOGUES = ("ln_cast", "bias_cast", "bias_residual_ln", "bias_gelu_cast",
             "bias_residual")
# the batch cells' encode: 256 windows of 1,500 rows
XKV_WINDOWS = 256
EPILOGUE_ROWS = XKV_WINDOWS * 1500
# the batch cells' decode step: 256 rows over a cache of 72 prompt slots
# (n_max_text_ctx 64 carried), 220 tokens and one (parallel/batch.py
# `_prompt_bucket`, decode/loop.py)
STEP_ROWS, STEP_CACHE = 256, 72 + 220 + 1
# bf16 on the card against f32 on the CPU through two encoder and two
# decoder layers at full width: bf16 keeps ~3 significant digits per
# rounding and the errors add over ~20 roundings in series.  einsum_q4 is
# held to it too: both sides quantize to 4 bits, so q4 is compared with
# q4 (it read 6.9e-3, like the other modes); q4 against bf16 K/V is not
# token-exact and is not what this checks
MODEL_TOL = 5e-2
# encode at large-v3's 32 layers: each attn_impl against "pallas" and
# against "einsum" (plain torch), bf16
ENCODE_TOL = 5e-2
ENCODE_RUNS = 5      # path D's encode walls: median of 5 after a warm-up
# data-sheet peaks of one H100 SXM: bytes
# per second of HBM3, and operations per second for bf16 on the tensor
# cores and f32 on the CUDA cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
ATTENTION = ("K1", "K1dt", "K6")   # the encoder attention entries
N_STREAMS, STREAM_S = 4, 45
BEAM = 5                           # beam_size and best_of of bench.py's tiers
QUALITY_BATCH = N_STREAMS * BEAM   # bo5 and beam5: four streams of five rows
# K3's rows in path A with the CLI's defaults: the serial beam's (and the
# best_of ladder's) five decoders a step, and their prompt passes
K3_CLI_M = (BEAM, BEAM * 8, BEAM * 232)
# paths A and B (once 60 s) and path A with the CLI's defaults (once 30 s)
# were shortened when the serving phases came, path C (once 30 s) when
# the phase "cli" came, to keep the script's total
CLI_S = 15                         # seconds of PCM for path A's CLI defaults
FULL_S = 30                        # seconds of PCM for paths A and B
PATH_C_S = 15                      # seconds of PCM for path C
MEL_S = 60                         # seconds of PCM for path D's mel
CONT_LATE = 2                      # continuous run 2: streams joining late
SERVER_S = 30                      # seconds of each WAV the server gets
# every server request's one field past the server's defaults: on random
# weights every rung of the ladder fails its log-prob test (a window then
# decodes 6 rungs of ~220 steps; the phase took 453 s on an H100 80GB
# HBM3 at 700 W), where a trained model's windows mostly pass at t = 0.  A
# threshold of -1000 lets them pass at t = 0; the ladder stays live (the
# entropy test still sends windows to the t > 0 rungs at best_of 2, and
# the phase asserts that some did)
SERVER_FIELDS = {"logprob_thold": "-1000"}
BUILD = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the phase "cli": seconds of the WAVs of runs 1 and 4 (-p 2: two chunks of
# 10 s) and of runs 2, 3 and 5; grammars/colors.gbnf's pieces, written into
# the small grammar file's vocab from PIECE_ID0 on
CLI_RUN_S, CLI_SHORT_S = 20, 10
COLORS = Path(__file__).resolve().parent / "grammars" / "colors.gbnf"
PIECE_ID0 = 1000
GRAMMAR_PIECES = [b" ", b"red", b"green", b"blue", b"yellow", b"purple",
                  b"orange", b" and ", b" red", b" green", b" blue", b" and",
                  b" yellow", b"and ", b"and", b" and red", b"blue and "]
# the phase "apps": seconds of PCM for whisper-stream's fixed steps and of
# the WAV the lsp requests and the `main`s read (at 6 s chip_smoke took
# 677 s on an H100 80GB HBM3 at 700 W: stream's `main` decodes ~220 tokens
# a step on the small pieces file); the fixed-step window; the VAD run's
# audio_ctx (half of large-v3's 1500: K1 at T = 750, K5 at Ta = 750); the
# lsp words
APPS_STREAM_S, APPS_MAIN_S = 12, 3
APPS_STEP_MS, APPS_LENGTH_MS = 3000, 10000
APPS_AUDIO_CTX = 750
APPS_WORDS = ["red", "green", "blue", "yellow"]
# the phase "capi": seconds of PCM for c_demo and the in-process calls;
# the C programs' time limit (each starts an interpreter that imports
# torch and loads the small file on the card)
CAPI_S = 10
CAPI_C_TIMEOUT = 300
# the phase "mesh": seconds of each int16 stream; the meshes (n_data,
# n_model) its two gloo ranks run, tensor then data parallel; the bound on
# |teacher-forced logits - mesh=None's| (bf16 at 32 + 32 layers: the
# tensor-parallel sums are f32 partials reduced, not bf16 products); the
# spawned processes' time limit
MESH_S = 15
MESH_SHAPES = ((1, 2), (2, 1))
MESH_TOL = 5e-2
MESH_TIMEOUT = 300
# the engine run over 1 x 2: the seconds its rank 0 idles before the
# streams come (empty plans at every 0.25 s wakeup), and the streams that
# arrive while the first N_STREAMS decode
MESH_IDLE_S = 1.5
MESH_LATE = 2
# the server over 1 x 2 runs a context of its own: large-v3's widths cut
# to this many encoder and decoder layers (over gloo every decode step
# crosses the host ~3 times a layer: at 32 + 32 the server's requests and
# their references took 224 s); the form fields of the pair of requests
# (none: whisper-server's defaults, timestamps and the temperature ladder
# on) and of the third (a second signature: no timestamps, the ladder off,
# so its window decodes to EOT or the loop's end)
MESH_SERVER_LAYERS = 8
MESH_SERVER_FIELDS: dict = {}
MESH_SERVER_SERIAL = {"no_timestamps": "true", "temperature_inc": "0"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n_warm: int = 3, n_runs: int = 20) -> float:
    """Median device time of one call: the call is captured once in a CUDA
    graph and each run replays it between two CUDA events, so the host's
    time to issue it (the Python wrapper, tens of microseconds) is not
    counted.  The 50 MB L2 is flushed before each run by writing 128 MB:
    on the serving path every layer's inputs arrive cold."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(n_runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def stream_ms(make_call, nbytes: int, n_runs: int = 5) -> float:
    """Device time of one call among many back to back, each on inputs of
    its own: make_call() gives a call on fresh inputs; enough of them that
    their bytes (nbytes each) exceed the 50 MB L2 twice over, so every call
    finds its inputs cold, as each layer of a decode step does; all of them
    captured in one CUDA graph, replayed between two CUDA events, the time
    over their count (median of n_runs).  Unlike time_ms, the latency of
    launching the graph (~5 us for an empty kernel on an H100) is spread
    over the calls, not added to each."""
    n = min(256, max(2, -(-(100 << 20) // nbytes)))
    calls = [make_call() for _ in range(n)]
    for call in calls:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    times = []
    for _ in range(n_runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph, calls
    return statistics.median(times)


def errors(name, out, ref) -> tuple[float, float]:
    """(max abs err, max rel err) of a kernel's output or tuple of outputs
    against its plain version's; raises on a non-finite output."""
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err = rel = 0.0
    for o, r in zip(outs, refs):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        e = float((o.float() - r.float()).abs().max())
        err, rel = max(err, e), max(rel, e / float(r.float().abs().max()))
    return err, rel


def compare(name, tol, kernel, plain, args, library=None, dense=None):
    """-> (max abs err, rel err, kernel ms, plain ms, library ms or None,
    dense ms or None); raises past tol.  `library` is one PyTorch call that
    computes the same function on the same inputs, `dense` (K2, K3, K5) the
    library call of the same shape over dequantized bf16 operands: both
    timed only, as yardsticks.  The plain version runs first: two of the
    epilogues write into their input."""
    ref = plain(*args)
    out = kernel(*args)
    torch.cuda.synchronize()
    err, rel = errors(name, out, ref)
    del out, ref
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    lib_ms = time_ms(library) if library is not None else None
    dense_ms = time_ms(dense) if dense is not None else None
    log(f"{name}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
        + (f", dense {dense_ms:.4f} ms" if dense_ms is not None else ""))
    if rel > tol:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {tol}")
    return err, rel, ms, plain_ms, lib_ms, dense_ms


def path_shapes() -> dict:
    """Each kernel's check shapes, from the models its paths load, the
    shape of the path that runs it first (its time is the one reported):
    K1 (B, T, H, Dh) of the encoders, K1dt (B, H, Dh, Tp, t_valid) and K6
    (B, Tp, D, H, t_valid) of path D's padded encoders (and K6 at small's
    width and the serving batch); K1 and K2 (B, H, Dh, Ta) also at the 20
    rows of bo5 and beam5; K2 (B, H, Dh, Ta) of the serving batch, of path
    C (batch 1) and of bench.py's batch of 64; K3 (M, K, N) of the decoder
    linears, and of large-v3's at the prompt passes of serving batches of
    4 and 64 streams and at the CLI defaults' five decoders; K4/K5
    (B, H, Ta, Dh); K7 (seconds of PCM, n_mels); K1, K2, K4, K5 and K6
    also at the serving batch with large-v3's heads split over two "model"
    ranks (the phase "mesh"); the encoder's epilogues (rows, width) at the
    batch cells' 256 windows of large-v3 (bias_cast with its q and v
    pairs: (rows, width, 2)), and cross_kv_quant (B, Ta, D, H) at the
    same windows and large-v3's decoder heads.  A shape that a main path launches and this
    list lacks is checked after the paths (check_launched)."""
    from whisper_tpu_torch.models.whisper import MODEL_DIMS, WhisperConfig
    from whisper_tpu_torch.ops.encoder_attention import BLOCK_Q
    big, small = (WhisperConfig(*MODEL_DIMS[s]) for s in ("large-v3",
                                                            "small"))

    def enc(c, B):
        return (B, c.n_audio_ctx, c.n_audio_head,
                c.n_audio_state // c.n_audio_head)

    def padded(c, B):
        Tp = -(-c.n_audio_ctx // BLOCK_Q) * BLOCK_Q
        return (B, Tp, c.n_audio_state, c.n_audio_head, c.n_audio_ctx)

    def xattn(c, B):
        return (B, c.n_text_head, c.n_audio_ctx,
                c.n_text_state // c.n_text_head)

    def linears(*cfgs, ms=K3_M):
        return [(M, K, N) for c in cfgs for d in (c.n_text_state,)
                for M in ms for K, N in ((d, d), (d, 4 * d), (4 * d, d))]

    def q8dt(B):
        B, H, Ta, Dh = xattn(big, B)
        return (B, H, Dh, Ta)

    def q8dt_grouped(S):
        return q8dt(S) + (BEAM,)

    # the phase "mesh": large-v3's heads split over n_model = 2, 10 a rank
    half = dataclasses.replace(
        big, n_audio_state=big.n_audio_state // 2,
        n_audio_head=big.n_audio_head // 2,
        n_text_state=big.n_text_state // 2, n_text_head=big.n_text_head // 2)
    hB, hH, hTa, hDh = xattn(half, N_STREAMS)
    b, tp, d, h, tv = padded(big, 1)
    return {"K1": [enc(big, 1), enc(small, 1), enc(big, N_STREAMS),
                   enc(big, QUALITY_BATCH), enc(half, N_STREAMS)],
            "K1dt": [(b, h, d // h, tp, tv)],
            "K2": [q8dt(N_STREAMS), q8dt(1), q8dt(BENCH_BATCH),
                   q8dt(QUALITY_BATCH), (hB, hH, hDh, hTa)],
            # the batched beam: S streams x BEAM beams as BEAM queries on
            # each stream's cross-KV row
            "K2G": [q8dt_grouped(N_STREAMS), q8dt_grouped(1)],
            # path A: large-v3 q5_0; then serving prompt passes and the
            # CLI defaults' five decoders
            "K3": linears(big, small) + linears(big, ms=K3_SERVE_M
                                                + K3_CLI_M),
            # path B: small q5_1
            "K3+mins": linears(small, big) + linears(big, ms=K3_SERVE_M
                                                     + K3_CLI_M),
            "K4": [xattn(small, 1), xattn(big, 1), xattn(big, N_STREAMS),
                   xattn(half, N_STREAMS)],
            "K5": [xattn(big, 1), xattn(small, 1), xattn(big, N_STREAMS),
                   xattn(half, N_STREAMS)],
            "K6": [padded(big, 1), padded(small, 1), padded(big, N_STREAMS),
                   padded(half, N_STREAMS)],
            "K7": [(MEL_S, big.n_mels), (MEL_S, small.n_mels)],
            "ln_cast": [(EPILOGUE_ROWS, d)],
            "bias_cast": [(EPILOGUE_ROWS, d, 2)],
            "bias_residual_ln": [(EPILOGUE_ROWS, d)],
            "bias_gelu_cast": [(EPILOGUE_ROWS, 4 * d)],
            "bias_residual": [(EPILOGUE_ROWS, d)],
            # the decoder's self-attention over its cache (B, H, Dh, C)
            "self_attn_step": [(STEP_ROWS, big.n_text_head,
                                big.n_text_state // big.n_text_head,
                                STEP_CACHE)],
            # one decoder layer's cross-K/V of the batch cells' windows
            "cross_kv_quant": [(XKV_WINDOWS, big.n_audio_ctx,
                                big.n_text_state, big.n_text_head)]}


def step_pad(B: int) -> list[int]:
    """self_attn_step's check inputs: row b's pad slots (its keys start
    there; every key up to the cache's end is valid)."""
    return [b * 7 % 16 for b in range(B)]


def work(key, shape) -> tuple[int, int, str]:
    """(bytes the call must move, each input read once and each output
    written once; its operations; their type) at `shape`.  Attention
    counts the keys it needs (t_valid), not the padded ones."""
    if key in ATTENTION:
        if key == "K1":
            B, T, H, Dh = shape
            rows = keys = T
        elif key == "K1dt":
            B, H, Dh, rows, keys = shape
        else:
            B, rows, D, H, keys = shape
            Dh = D // H
        nbytes = B * H * rows * Dh * (3 * 2 + 4)         # bf16 q/k/v, f32 out
        ops, kind = 4 * B * H * rows * keys * Dh, "bf16"
    elif key in ("K2", "K2G"):
        B, H, Dh, Ta, G = shape if key == "K2G" else shape + (1,)
        nbytes = B * H * (G * Dh * 2 + 2 * Dh * Ta + 2 * Ta * 4 + G * Dh * 4)
        ops, kind = 4 * B * H * G * Dh * Ta, "bf16"
    elif key in ("K3", "K3+mins"):
        M, K, N = shape[:3]
        x_size = 2 if shape[3:] == ("bf16",) else 4
        n_scale = 2 if key == "K3+mins" else 1
        nbytes = (M * K * x_size + K * N + n_scale * (K // 32) * N * 4
                  + M * N * 4)
        ops, kind = 2 * M * K * N, "bf16"
    elif key in ("K4", "K5"):
        B, H, Ta, Dh = shape
        kv = 2 * Ta * Dh * (2 if key == "K4" else 1)
        scales = 0 if key == "K4" else 2 * Ta * 4
        nbytes = B * H * (Dh * 2 + kv + scales + Dh * 4)
        ops, kind = 4 * B * H * Ta * Dh, "bf16"
    elif key == "K7":
        seconds, n_mel = shape
        n = mel_frames(seconds)
        bins = 201
        nbytes = 4 * (n * 400 + 400 + 2 * 400 * bins + bins * n_mel
                      + n * n_mel)
        ops, kind = n * (2 * 2 * 400 * bins + 3 * bins
                         + 2 * bins * n_mel), "f32"
    elif key in EPILOGUES:
        # bytes a row element (f32 x, bf16 y and outputs) and f32 operations
        # an element (a layernorm's two sums and its affine map; GELU's
        # tanh counted as ten), plus the (D,) f32 vectors
        rows, D, pairs = shape + (1,) * (3 - len(shape))
        per, n_vec, op = {"ln_cast": (6, 2, 7), "bias_cast": (4, 1, 1),
                          "bias_residual_ln": (12, 3, 9),
                          "bias_gelu_cast": (4, 1, 18),
                          "bias_residual": (10, 1, 2)}[key]
        nbytes = pairs * (rows * D * per + n_vec * D * 4)
        ops, kind = pairs * rows * D * op, "f32"
    elif key == "self_attn_step":
        # the valid keys' K and V, the q/k/v row in, q and v back, the two
        # cache columns, the output, biases and pad lengths; f32 dots
        B, H, Dh, C = shape
        keys = sum(C - p for p in step_pad(B))
        D = H * Dh
        nbytes = (H * Dh * keys * 2 * 2 + B * D * 2 * (3 + 2 + 2 + 1)
                  + 2 * D * 4 + B * 8)
        ops, kind = 4 * H * Dh * keys, "f32"
    elif key == "cross_kv_quant":
        # K and V: bf16 rows in, int8 codes and f32 scales out, V's f32
        # bias; an element's abs, max, product, rint and clamp, and V's
        # bias add
        B, Ta, D, H = shape
        nbytes = 2 * B * Ta * (D * (2 + 1) + H * 4) + D * 4
        ops, kind = B * Ta * D * (6 + 7), "f32"
    else:
        raise KeyError(key)
    return nbytes, ops, kind


def bound(key, shape) -> tuple[float, str]:
    """(least ms the card could take for one call at `shape`, "bytes" or
    "operations"): the larger of `work`'s bytes over the memory rate and
    its operations over the peak rate for their type."""
    nbytes, ops, kind = work(key, shape)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mel_pcm(seconds: int) -> np.ndarray:
    return (np.random.RandomState(7).randn(16000 * seconds) * 0.1).astype(
        np.float32)


def mel_frames(seconds: int) -> int:
    """K7's frame count for `seconds` of PCM (log_mel_pallas)."""
    from whisper_tpu_torch.audio.mel import pad_audio
    from whisper_tpu_torch.ops.mel_pallas import FRAMES_PER_BLOCK
    n_len = (len(pad_audio(mel_pcm(seconds))[0]) - 400) // 160
    return n_len // FRAMES_PER_BLOCK * FRAMES_PER_BLOCK


def kernel_cases(gen):
    """-> ({key: (name, kernel, plain, make)}, {key: dense yardstick}):
    make(*shape) gives a call's inputs on the card and its library call
    (or None); a K3 shape may end in "bf16", its x's dtype (else f32)."""
    import torch.nn.functional as F
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.audio.mel import pad_audio
    from whisper_tpu_torch.ops import cross_attention as xa
    from whisper_tpu_torch.ops import decoder_attention as da
    from whisper_tpu_torch.ops import encoder_attention as ea
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    from whisper_tpu_torch.ops import mel_pallas as mp
    from whisper_tpu_torch.ops import quantized as qm

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda") * 0.3

    def bf16(*shape):
        return randn(*shape).to(torch.bfloat16)

    def k1(B, T, H, Dh):
        q, k, v = (bf16(B, T, H, Dh) for _ in range(3))
        # (B, H, T, Dh) views of the same tensors for the library call
        views = [x.transpose(1, 2) for x in (q, k, v)]
        return [q, k, v], lambda: F.scaled_dot_product_attention(*views)

    def k1dt(B, H, Dh, Tp, t_valid):
        q, k, v = (bf16(B, H, Dh, Tp) for _ in range(3))
        # (B, H, Tp, Dh) views of the same tensors, keys past t_valid masked
        views = [x.transpose(-1, -2) for x in (q, k, v)]
        keep = (torch.arange(Tp, device="cuda") < t_valid)[None, :]
        return [q, k, v, t_valid], lambda: F.scaled_dot_product_attention(
            *views, attn_mask=keep)

    def k2(B, H, Dh, Ta, G=1):
        (kq, ks), (vq, vs) = (xa.quantize_kv_bhdt(randn(B, H, Dh, Ta))
                              for _ in range(2))
        return [bf16(B, H, G, Dh), kq, ks, vq, vs], None

    def k3(mins):
        def make(M, K, N, x_dtype="f32"):
            # q5-like codes; mins as in q5_1 (w = code * d + m)
            codes = torch.randint(-16, 16, (K, N), generator=gen,
                                  device="cuda", dtype=torch.int8)
            scales = (torch.rand(K // 32, N, generator=gen, device="cuda")
                      * 2e-3 + 1e-4)
            x = torch.randn(M, K, generator=gen, device="cuda")
            if x_dtype == "bf16":
                x = x.to(torch.bfloat16)
            return [x, codes, scales, -16 * scales if mins else None], None
        return make

    def k3_dense(x, codes, scales, mins):
        """The yardstick: the bf16 x over the dequantized bf16 (N, K)
        weight, one cuBLAS product."""
        xb = x.to(torch.bfloat16)
        w = qm.dequantize_t(codes, scales, mins).t().contiguous().to(
            torch.bfloat16)
        return lambda: F.linear(xb, w)

    def k4(B, H, Ta, Dh):
        q, k, v = bf16(B, H, 1, Dh), bf16(B, H, Ta, Dh), bf16(B, H, Ta, Dh)
        return [q, k, v], lambda: F.scaled_dot_product_attention(q, k, v)

    def xattn_dense(q, k_q, k_s, v_q, v_s):
        """The yardstick of K2 and K5: SDPA over the dequantized bf16 K/V in
        (B, H, Ta, Dh), twice their bytes and without their rounding of
        the weights (with K2's G queries a (b, h) as SDPA's queries)."""
        if k_s.dim() == 3:          # K2's (B, H, Dh, Ta) codes
            k, v = ((c.float() * s[..., None, :]).transpose(-1, -2)
                    for c, s in ((k_q, k_s), (v_q, v_s)))
        else:
            k, v = (c.float() * s for c, s in ((k_q, k_s), (v_q, v_s)))
        k, v = (x.to(torch.bfloat16).contiguous() for x in (k, v))
        return lambda: F.scaled_dot_product_attention(q, k, v)

    def k5(B, H, Ta, Dh):
        (q, k, v), _ = k4(B, H, Ta, Dh)
        (kq, ks), (vq, vs) = (xa.quantize_kv(t.float()) for t in (k, v))
        return [q, kq, ks, vq, vs], None

    def k6(B, Tp, D, H, t_valid):
        q, k, v = (bf16(B, Tp, D) for _ in range(3))
        views = [x.reshape(B, Tp, H, D // H).transpose(1, 2)
                 for x in (q, k, v)]
        # keys to keep, broadcast over (B, H, queries)
        keep = (torch.arange(Tp, device="cuda") < t_valid)[None, :]
        return [q, k, v, H, t_valid], lambda: F.scaled_dot_product_attention(
            *views, attn_mask=keep)

    def k7(seconds, n_mel):
        padded = torch.from_numpy(pad_audio(mel_pcm(seconds))[0]).cuda()
        return list(mp.mel_block_inputs(padded, mel_filterbank(n_mel))), None

    def epilogue(key):
        # x: the residual stream (f32), y: a GEMM's bf16 output; biases and
        # layernorm weights f32
        def make(rows, D, pairs=1):
            def x():
                return randn(rows, D) * 20 + 1

            def y():
                return (randn(rows, D) * 10).to(torch.bfloat16)
            bias, w, b = randn(D), randn(D) + 1, randn(D)
            return {"ln_cast": lambda: [x(), w, b],
                    "bias_cast": lambda: [(y(), bias), (y(), b)][:pairs],
                    "bias_residual_ln": lambda: [x(), y(), bias, w, b],
                    "bias_gelu_cast": lambda: [y(), bias],
                    "bias_residual": lambda: [x(), y(), bias]}[key](), None
        return make

    def self_attn(B, H, Dh, C):
        # q, k, v at unit scale (scores of unit spread), the full cache
        # valid past each row's pad slots, the new column the last
        D = H * Dh
        qkv = (randn(B, 3 * D) / 0.3).to(torch.bfloat16)
        caches = [(randn(B, H, Dh, C) / 0.3).to(torch.bfloat16)
                  for _ in range(2)]
        pad = torch.tensor(step_pad(B), device="cuda")
        return [qkv, randn(D), randn(D), *caches, C - 1, C, pad, H], None

    def xkv(B, Ta, D, H):
        # a layer's two projection outputs at the spread of cross-K/V, and
        # V's bias
        return [bf16(B, Ta, D) * 8, bf16(B, Ta, D) * 8, randn(D), H], None

    def flat(fn):
        # ((K codes, K scales), (V codes, V scales)) -> a 4-tuple
        return lambda *a: tuple(t for pair in fn(*a) for t in pair)

    def self_attn_plain(qkv, *rest):
        # the kernel and its plain version write q and v into qkv: the
        # plain one, which runs first, works on a copy
        return da.self_attn_step_ref(qkv.clone(), *rest)

    cases = {
        "K1": ("encoder_attention", ea.self_attention, ea.self_attention_ref,
               k1),
        "K1dt": ("encoder_attention (B,H,Dh,Tp)", ea.encoder_attention,
                 ea.encoder_attention_ref, k1dt),
        "K2": ("cross_attention_q8", xa.cross_attention_decode_q8dt,
               xa.cross_attention_decode_q8dt_ref, k2),
        "K2G": ("cross_attention_q8, G queries",
                xa.cross_attention_decode_q8dt,
                xa.cross_attention_decode_q8dt_ref, k2),
        "K3": ("quantized_matmul", qm.quantized_matmul,
               qm.quantized_matmul_ref, k3(False)),
        "K3+mins": ("quantized_matmul +mins", qm.quantized_matmul,
                    qm.quantized_matmul_ref, k3(True)),
        "K4": ("cross_attention_decode", xa.cross_attention_decode,
               xa.cross_attention_decode_ref, k4),
        "K5": ("cross_attention_decode_q8", xa.cross_attention_decode_q8,
               xa.cross_attention_decode_q8_ref, k5),
        "K6": ("encoder_attention_btd", ea.encoder_attention_btd,
               ea.encoder_attention_btd_ref, k6),
        "K7": ("log_mel (_mel_blocks)", mp._mel_blocks, mp._mel_blocks_ref,
               k7),
    }
    for key in EPILOGUES:
        cases[key] = (f"encoder epilogue {key}", getattr(ee, key),
                      getattr(ee, f"{key}_ref"), epilogue(key))
    cases["self_attn_step"] = ("decoder self_attn_step", da.self_attn_step,
                               self_attn_plain, self_attn)
    cases["cross_kv_quant"] = ("cross_kv_quant", flat(xa.cross_kv_quant),
                               flat(xa.cross_kv_quant_ref), xkv)
    dense_of = {"K2": xattn_dense, "K2G": xattn_dense, "K3": k3_dense,
                "K3+mins": k3_dense, "K5": xattn_dense}
    return cases, dense_of


def check_kernels(gen):
    """Each kernel against its plain version at each of its path_shapes
    -> {kernel: {max_abs_err, max_rel_err, ms, plain_ms, library_ms,
    bound_ms, bound_by, shape, shapes}}, the times and the bound at the
    first shape."""
    cases, dense_of = kernel_cases(gen)
    res = {}
    for key, shapes in path_shapes().items():
        name, kernel, plain, make = cases[key]
        to_dense = dense_of.get(key)
        rows = []
        for shape in shapes:
            args, library = make(*shape)
            dense = to_dense(*args) if to_dense else None
            rows.append(compare(f"{key} {name} {shape}", KERNEL_TOL[key],
                                kernel, plain, args, library, dense))
            del args, library, dense

            # the same calls back to back on cold inputs of their own
            def fresh(which, shape=shape, make=make, kernel=kernel,
                      to_dense=to_dense):
                def make_call():
                    a, lib = make(*shape)
                    if which == "dense":
                        return to_dense(*a)
                    return {"kernel": lambda: kernel(*a),
                            "library": lib}[which]
                return make_call
            nbytes = work(key, shape)[0]
            streams = [stream_ms(fresh("kernel"), nbytes),
                       stream_ms(fresh("library"), nbytes)
                       if rows[-1][4] is not None else None,
                       stream_ms(fresh("dense"), nbytes) if to_dense
                       else None]
            rows[-1] = rows[-1] + tuple(streams)
            ms, (b_ms, _) = rows[-1][2], bound(key, shape)
            log(f"{key} {shape}: {work(key, shape)[1] / ms / 1e9:.1f} "
                f"TFLOP/s, {b_ms / ms:.3f} of the bound ({b_ms:.5f} ms); "
                f"back to back on cold inputs: kernel {streams[0]:.4f} ms "
                f"({b_ms / streams[0]:.3f} of the bound)"
                + (f", library {streams[1]:.4f} ms" if streams[1] else "")
                + (f", dense {streams[2]:.4f} ms" if streams[2] else ""))
        bound_ms, bound_by = bound(key, shapes[0])
        ms = rows[0][2]
        res[key] = {"max_abs_err": max(r[0] for r in rows),
                    "max_rel_err": max(r[1] for r in rows),
                    "tol": KERNEL_TOL[key], "ms": ms,
                    "plain_ms": rows[0][3], "library_ms": rows[0][4],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "share_of_bound": bound_ms / ms,
                    "tflops": work(key, shapes[0])[1] / ms / 1e9,
                    "shape": list(shapes[0]),
                    "shapes": [list(x) for x in shapes],
                    # back to back on cold inputs (stream_ms)
                    "ms_stream": rows[0][6], "library_ms_stream": rows[0][7],
                    "share_of_bound_stream": bound_ms / rows[0][6],
                    # at every shape: kernel, plain, library, dense ms, then
                    # kernel, library, dense back to back on cold inputs
                    "ms_by_shape": [list(r[2:]) for r in rows]}
        if to_dense:
            res[key]["dense_ms"] = rows[0][5]
            res[key]["dense_ms_stream"] = rows[0][8]
        log(f"{key} bound at {shapes[0]}: {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.3f} of it reached")
    torch.cuda.empty_cache()
    return res


# (kernel key, shape) of every launch on the main paths, as path_shapes
# writes them, while LAUNCHED["on"], in all and by the phase running
# (LAUNCHED["phase"]); filled by record_launches
LAUNCHED = {"on": False, "shapes": {}, "phase": None, "by_phase": {}}


def launch_shape(entry: str, args) -> tuple[str, tuple]:
    """The path_shapes key and shape of one call of a C entry point, from
    the arguments the wrappers pass it (whisper_tpu_torch/ops)."""
    if entry == "wtt_encoder_attention":
        return "K1", tuple(args[4:8])                    # B, T, H, Dh
    if entry == "wtt_encoder_attention_bhdt":
        return "K1dt", tuple(args[4:9])                  # B, H, Dh, Tp, tv
    if entry == "wtt_encoder_attention_btd":
        B, Tp, H, Dh, t_valid = args[4:9]
        return "K6", (B, Tp, H * Dh, H, t_valid)
    if entry == "wtt_cross_attention_q8":
        B, H, G, Dh, Ta = args[6:11]
        return ("K2", (B, H, Dh, Ta)) if G == 1 else ("K2G",
                                                      (B, H, Dh, Ta, G))
    if entry == "wtt_cross_attention":
        B, H, Dh, Ta = args[4:8]
        return "K4", (B, H, Ta, Dh)
    if entry == "wtt_cross_attention_bhtd_q8":
        B, H, Dh, Ta = args[6:10]
        return "K5", (B, H, Ta, Dh)
    if entry in ("wtt_quantized_matmul", "wtt_quantized_matmul_decode"):
        M, N, K = args[6:9]
        return ("K3+mins" if args[4] else "K3",
                (M, K, N) + (("bf16",) if args[1] else ()))
    if entry == "wtt_log_mel":
        return "K7", ("frames",) + tuple(args[11:13])    # n, n_mel
    if entry == "wtt_bias_cast":
        return "bias_cast", (args[5], args[6], args[4])  # rows, D, pairs
    if entry == "wtt_self_attn_step":
        return "self_attn_step", tuple(args[7:11])       # B, H, Dh, C
    if entry == "wtt_cross_kv_quant":
        B, H, Ta = args[7:10]
        return "cross_kv_quant", (B, Ta, H * 64, H)
    rows_at = {"wtt_ln_cast": 4, "wtt_bias_residual_ln": 7,
               "wtt_bias_gelu_cast": 2, "wtt_bias_residual": 4}
    if entry in rows_at:
        i = rows_at[entry]
        return entry.removeprefix("wtt_"), tuple(args[i:i + 2])  # rows, D
    raise KeyError(f"no launch shape for {entry}")


def record_launches(lib) -> None:
    """Have `lib.call` note each launch's kernel and shape in LAUNCHED."""
    call = lib.call

    def recording(entry, *args):
        if LAUNCHED["on"]:
            key, shape = launch_shape(entry, args)
            LAUNCHED["shapes"].setdefault(key, set()).add(shape)
            LAUNCHED["by_phase"].setdefault(LAUNCHED["phase"], {}).setdefault(
                key, set()).add(shape)
        return call(entry, *args)
    lib.call = recording


def check_launched(gen, res) -> dict:
    """Every shape the main paths launched that check_kernels did not
    check, against its plain version within the kernel's KERNEL_TOL
    (compared once, not timed); adds them and every launched shape to
    `res`.  -> {key: shapes checked here}."""
    cases, dense_of = kernel_cases(gen)
    checked = {k: {tuple(x) for x in v["shapes"]} for k, v in res.items()}
    checked["K7"] = {("frames", mel_frames(s), n)
                     for s, n in checked["K7"]}
    # the phases "apps", "capi" and "mesh" launch shapes no earlier phase
    # does (stream's -ac, lsp's commandset prompt; whisper-bench's PP at
    # M = 256 and -w 3's T = 512; the data-parallel rank's 2 rows): those
    # are timed too, kernel, plain and K3's dense yardstick
    timed = {phase: LAUNCHED["by_phase"].get(phase, {})
             for phase in ("apps", "capi", "mesh")}
    extra = {}
    for key, shapes in sorted(LAUNCHED["shapes"].items()):
        res[key]["launched_shapes"] = sorted(list(x) for x in shapes)
        for shape in sorted(shapes - checked[key]):
            if key == "K7":
                raise AssertionError(f"K7 launched at {shape}, a length "
                                     "check_kernels does not check")
            name, kernel, plain, make = cases[key]
            args, _ = make(*shape)
            ref = plain(*args)
            out = kernel(*args)
            torch.cuda.synchronize()
            err, rel = errors(f"{key} {shape}", out, ref)
            log(f"{key} {name} {shape} (launched on a main path): "
                f"max_abs_err {err:.3e} rel {rel:.3e} (tol "
                f"{KERNEL_TOL[key]})")
            if rel > KERNEL_TOL[key]:
                raise AssertionError(f"{key} {shape}: rel err {rel:.3e} > "
                                     f"{KERNEL_TOL[key]}")
            r = res[key]
            phase = next((ph for ph, by in timed.items()
                          if shape in by.get(key, ())), None)
            if phase is not None:
                ms = time_ms(lambda: kernel(*args))
                plain_ms = time_ms(lambda: plain(*args))
                to_dense = dense_of.get(key)
                dense_ms = time_ms(to_dense(*args)) if to_dense else None
                b_ms, b_by = bound(key, shape)
                log(f"{key} {shape} (phase {phase}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms"
                    + (f", dense {dense_ms:.4f} ms" if dense_ms else "")
                    + f", bound {b_ms:.5f} ms ({b_by}), {b_ms / ms:.3f} of "
                    "it")
                r.setdefault(f"{phase}_ms_by_shape", []).append(
                    [list(shape), ms, plain_ms, b_ms, dense_ms])
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            r["shapes"].append(list(shape))
            extra.setdefault(key, []).append(list(shape))
            del args, out, ref
    torch.cuda.empty_cache()
    log(f"shapes launched on the main paths beyond path_shapes, checked: "
        f"{json.dumps(extra)}")
    return extra


def check_model(gen):
    """Full-width large-v3 cut to 2+2 layers: bf16 on the card against the
    same weights in float32 on the CPU (plain versions).  The serving
    path's form first (prompt over the int8 cross_kv_q8, one einsum_q8
    step: K1, K2); then one step in each of cross modes einsum,
    pallas_q8dt (K2), einsum_q8i and einsum_q4 from the dense cross-KV
    quantized once, as `full` runs them."""
    from whisper_tpu_torch.audio.mel import log_mel_spectrogram_torch, pad_audio
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.decode.loop import loop_cross_kv
    from whisper_tpu_torch.models import whisper as wm
    from whisper_tpu_torch.weights.convert import random_params

    dims = list(wm.MODEL_DIMS["large-v3"])
    dims[4] = dims[8] = 2
    cfg = wm.WhisperConfig(*dims, model_type="large-v3-2+2")
    params = random_params(cfg, seed=1, dtype=torch.bfloat16, device="cuda")

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.float().cpu()
                for k, v in tree.items()}

    ref_params = to_cpu(params)
    rng = np.random.RandomState(1)
    pcm, _, _ = pad_audio(rng.randn(16000 * 20).astype(np.float32) * 0.1)
    n_ctx, nh = cfg.n_audio_ctx, cfg.n_text_head
    tokens = torch.tensor([[50258, 50259, 50360, 50364, 1000, 2000]])
    pos = torch.arange(tokens.shape[1])
    modes = ("einsum", "pallas_q8dt", "einsum_q8i", "einsum_q4")

    def step(p, device, cd, k_self, v_self, kc, vc):
        L, B, P, H, Dh = k_self.shape
        cache = {n: torch.zeros((L, B, H, Dh, P + 1), dtype=cd, device=device)
                 for n in ("k", "v")}
        cache["k"][..., :P] = k_self.permute(0, 1, 3, 4, 2).to(cd)
        cache["v"][..., :P] = v_self.permute(0, 1, 3, 4, 2).to(cd)
        logits, _ = wm.decode_step(
            p, tokens[:, -1].to(device), torch.tensor([P], device=device), P,
            cache, kc, vc, kv_len=P + 1, n_head=nh, compute_dtype=cd)
        return logits

    def run(p, device, cd):
        samples = torch.from_numpy(pcm[:2 * n_ctx * 160 + 400]).to(device)
        filters = torch.from_numpy(mel_filterbank(cfg.n_mels)).to(device)
        mel = log_mel_spectrogram_torch(samples[None], filters)[:, :2 * n_ctx]
        enc = wm.encode(p, mel, n_head=cfg.n_audio_head, compute_dtype=cd)
        (kq, ks), (vq, vs) = wm.cross_kv_q8(p, enc, n_head=nh,
                                            compute_dtype=cd)
        mask = wm.make_causal_mask(tokens.shape[1], device=device)
        logits, k_self, v_self = wm.decode_prompt(
            p, tokens.to(device), pos.to(device), ("q8", kq, ks),
            ("q8", vq, vs), nh, self_mask=mask, compute_dtype=cd)
        out = {"mel": mel, "encoder": enc, "prompt logits": logits,
               "step logits einsum_q8": step(p, device, cd, k_self, v_self,
                                             ("q8e", kq, ks),
                                             ("q8e", vq, vs))}
        kc, vc = wm.cross_kv(p, enc, n_head=nh, compute_dtype=cd)
        for mode in modes:
            out[f"step logits {mode}"] = step(
                p, device, cd, k_self, v_self,
                *loop_cross_kv(mode, kc, vc, cd))
        return {k: x.float().cpu() for k, x in out.items()}

    with torch.no_grad():
        got = run(params, "cuda", torch.bfloat16)
        ref = run(ref_params, "cpu", torch.float32)
    for name, g in got.items():
        r = ref[name]
        tol = MODEL_TOL
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"model check {name}: shape {tuple(g.shape)}"
                                 f" vs {tuple(r.shape)} or non-finite")
        rel = float((g - r).abs().max() / r.abs().max())
        log(f"model check {name} {tuple(g.shape)}: rel err vs f32 CPU "
            f"{rel:.3e} (tol {tol})")
        if rel > tol:
            raise AssertionError(f"model check {name}: {rel:.3e} > {tol}")
    del params
    torch.cuda.empty_cache()


def counters() -> dict:
    """Each kernel's wrappers, whose `launches` count their launches; K1
    has two entries, (B, T, H, Dh) and (B, H, Dh, Tp)."""
    from whisper_tpu_torch.ops import cross_attention as xa
    from whisper_tpu_torch.ops import decoder_attention as da
    from whisper_tpu_torch.ops import encoder_attention as ea
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    from whisper_tpu_torch.ops import mel_pallas as mp
    from whisper_tpu_torch.ops import quantized as qm
    return {"K1": (ea.self_attention, ea.encoder_attention),
            "K2": (xa.cross_attention_decode_q8dt,),
            "K3": (qm.quantized_matmul,), "K4": (xa.cross_attention_decode,),
            "K5": (xa.cross_attention_decode_q8,),
            "K6": (ea.encoder_attention_btd,), "K7": (mp._mel_blocks,),
            **{k: (getattr(ee, k),) for k in EPILOGUES},
            "self_attn_step": (da.self_attn_step,),
            "cross_kv_quant": (xa.cross_kv_quant,)}


def reset_counts() -> None:
    for fns in counters().values():
        for fn in fns:
            fn.launches = 0
    counters()["K3"][0].launches_mins = 0
    counters()["K2"][0].launches_grouped = 0


def read_counts() -> dict:
    """Launches by kernel; "K2G" counts K2's launches with G > 1 queries a
    (b, h), "K2" the others."""
    counts = {k: sum(fn.launches for fn in fns)
              for k, fns in counters().items()}
    counts["K3+mins"] = counters()["K3"][0].launches_mins
    counts["K2G"] = counters()["K2"][0].launches_grouped
    counts["K2"] -= counts["K2G"]
    return counts


def require_launches(path: str, counts: dict, names) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on {path}")


def check_segments(path: str, results) -> None:
    """Every stream got segments, and every probability is finite."""
    for i, segs in enumerate(results):
        log(f"{path} stream {i}: {len(segs)} segments, "
            f"{sum(len(s.tokens) for s in segs)} tokens")
        if not segs:
            raise AssertionError(f"{path} stream {i} produced no segments")
        vals = [v for s in segs for t in s.tokens for v in (t.p, t.plog)]
        vals += [s.no_speech_prob for s in segs]
        if not np.isfinite(vals).all():
            raise AssertionError(f"{path} stream {i}: non-finite "
                                 "probabilities (NaN logits)")


def model_file(size: str, kind: str, pieces: bool = False) -> Path:
    """A random-weight ggml file at `size`'s published dims in block type
    `kind`, written once (tensor by tensor, random valid blocks, seed 0)
    and reused.  pieces: the vocab holds GRAMMAR_PIECES from id
    PIECE_ID0 on (the synthetic " t<i>" tokens alone match no grammar)."""
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.models.whisper import MODEL_DIMS
    from whisper_tpu_torch.weights import ggml_writer
    from whisper_tpu_torch.weights.vocab import synthetic_vocab

    path = BUILD / f"{size}-{kind}{'-pieces' if pieces else ''}.bin"
    if path.is_file():
        log(f"reusing {path.name} ({path.stat().st_size / 2**20:.1f} MiB)")
        return path
    BUILD.mkdir(parents=True, exist_ok=True)
    dims = MODEL_DIMS[size]
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    tmp = path.with_suffix(".tmp")
    t0 = time.perf_counter()
    tokens = synthetic_vocab(hp["n_vocab"]).id_to_token[:50257]
    if pieces:
        tokens[PIECE_ID0:PIECE_ID0 + len(GRAMMAR_PIECES)] = GRAMMAR_PIECES
    ggml_writer.write_random_model(
        str(tmp), hp, mel_filterbank(hp["n_mels"]), tokens, kind, seed=0)
    if pieces:
        raise_pieces(tmp)
    tmp.replace(path)
    log(f"wrote {path.name}: {path.stat().st_size / 2**20:.1f} MiB in "
        f"{time.perf_counter() - t0:.2f} s")
    return path


def raise_pieces(path: Path, scale: float = 80.0) -> None:
    """Raise GRAMMAR_PIECES' logits in a random-weight file: the decoder's
    final layernorm bias (f32, zero as written) becomes `scale` times the
    unit vector u along the sum of the pieces' token-embedding rows, so
    each piece's logit gains scale * (row . u) (~ +10 at small's widths:
    rows of norm ~0.55, 17 pieces) and every other token's ~ scale * 0.02
    * N(0, 1).  The pieces then outrank the end-of-text token and the
    timestamps' summed mass, and the grammar picks among them for a whole
    window: runs 2-3 measure ~220 host grammar steps, not two.  The bias
    is patched in place: its 4 * n_text_state bytes follow its name."""
    from whisper_tpu_torch.weights import quant
    from whisper_tpu_torch.weights.ggml_reader import read_ggml_file

    mf = read_ggml_file(str(path))
    emb = mf.tensors["decoder.token_embedding.weight"]
    width = emb.shape[1]
    row_bytes = quant.type_nbytes(emb.ttype, width)
    rows = np.stack([quant.decode_tensor(
        emb.data[i * row_bytes:(i + 1) * row_bytes], emb.ttype, (width,))
        for i in range(PIECE_ID0, PIECE_ID0 + len(GRAMMAR_PIECES))])
    u = rows.sum(axis=0)
    u /= np.linalg.norm(u)
    blob = path.read_bytes()
    name = b"decoder.ln.bias"
    at = blob.index(name) + len(name)
    if blob.count(name) != 1 or mf.tensors["decoder.ln.bias"].data != \
            blob[at:at + 4 * width]:
        raise AssertionError("raise_pieces: decoder.ln.bias not found once")
    with open(path, "r+b") as f:
        f.seek(at)
        f.write((scale * u).astype("<f4").tobytes())
    others = quant.decode_tensor(emb.data[:row_bytes * 200], emb.ttype,
                                 (200, width))
    log(f"{path.name}: the grammar pieces' logits raised by "
        f"{float(scale * (rows @ u).mean()):.2f} on average, 200 other "
        f"tokens' by {float(scale * (others @ u).std()):.2f} std")


def check_file_model(path: Path) -> None:
    """A block-quantized file in bf16 on the card (K1, K3, then K4 or K5
    in one decode step) against the same file in float32 on the CPU, whose
    packed linears run K3's plain version: encoder, prompt logits, and one
    step in each of cross modes "pallas" and "pallas_q8"."""
    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch.decode.loop import loop_cross_kv
    from whisper_tpu_torch.models import whisper as wm

    pcm = (np.random.RandomState(2).randn(16000 * 20) * 0.1).astype(
        np.float32)

    def run(device, cd):
        ctx = WhisperContext.from_file(str(path), device=device,
                                       compute_dtype=cd)
        v, nh = ctx.vocab, ctx.config.n_text_head
        ctx.pcm_to_mel(pcm)
        enc, kc, vc = ctx.encode_window(0)
        tokens = torch.tensor([[v.token_sot, v.token_lang(0),
                                v.token_transcribe, v.token_beg]],
                              device=device)
        P = tokens.shape[1]
        with torch.no_grad():
            logits, k_self, v_self = wm.decode_prompt(
                ctx.params, tokens, torch.arange(P, device=device), kc, vc,
                nh, self_mask=wm.make_causal_mask(P, device=device),
                compute_dtype=cd)
            out = [enc, logits]
            for mode in ("pallas", "pallas_q8"):
                kl, vl = loop_cross_kv(mode, kc, vc, cd)
                L, B, _, H, Dh = k_self.shape
                cache = {n: torch.zeros((L, B, H, Dh, P + 1), dtype=cd,
                                        device=device) for n in ("k", "v")}
                cache["k"][..., :P] = k_self.permute(0, 1, 3, 4, 2).to(cd)
                cache["v"][..., :P] = v_self.permute(0, 1, 3, 4, 2).to(cd)
                step, _ = wm.decode_step(
                    ctx.params, tokens[:, -1], torch.tensor([P],
                                                            device=device),
                    P, cache, kl, vl, kv_len=P + 1, n_head=nh,
                    compute_dtype=cd)
                out.append(step)
        return [x.float().cpu() for x in out]

    got = run("cuda", torch.bfloat16)
    ref = run("cpu", torch.float32)
    for name, g, r in zip(("encoder", "prompt logits", "step logits pallas",
                           "step logits pallas_q8"), got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"file model check {name}: shape "
                                 f"{tuple(g.shape)} vs {tuple(r.shape)} or "
                                 "non-finite")
        rel = float((g - r).abs().max() / r.abs().max())
        log(f"file model check ({path.name}) {name} {tuple(g.shape)}: rel "
            f"err vs f32 CPU {rel:.3e} (tol {MODEL_TOL})")
        if rel > MODEL_TOL:
            raise AssertionError(f"file model check {name}: {rel:.3e} > "
                                 f"{MODEL_TOL}")
    torch.cuda.empty_cache()


def full_params(seconds: int = 0):
    """Greedy at t = 0, language "en", timestamps on; the first `seconds`
    of the audio when seconds > 0."""
    from whisper_tpu_torch import full_default_params
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.duration_ms = seconds * 1000
    return p


def cli_params(seconds: int):
    """The CLI's defaults (whisper_tpu/cli.py:40-44, :97-103): beam search,
    beam 5, best_of 5, the temperature ladder live; language "en", the
    first `seconds` of the audio."""
    from whisper_tpu_torch import SamplingStrategy, full_default_params
    p = full_default_params(SamplingStrategy.BEAM_SEARCH)
    p.beam_search.beam_size = p.greedy.best_of = BEAM
    p.print_progress = False
    p.language = "en"
    p.duration_ms = seconds * 1000
    return p


def full_pcm(seconds: int = FULL_S) -> np.ndarray:
    return (np.random.RandomState(7).randn(16000 * seconds) * 0.1).astype(
        np.float32)


TRACE_SKIP, TRACE_STEPS = 8, 16   # the traced decode steps: 16, from
                                  # the 9th of a rung


class _TraceDone(Exception):
    """Ends a traced rerun once its steps are taken."""


def traced(card_line: str, label: str, run, after_prompts: int = 1) -> dict:
    """TRACE_STEPS decode steps of `run()`, a rerun of a phase as it ran
    (its rows, its params): the steps from the TRACE_SKIP-th on of the
    first rung, at or after the `after_prompts`-th prompt pass, that runs
    that long, with no encode or prompt pass among them.  `run()` goes
    twice, each cut short once the steps are taken: timed alone (the
    steps' wall, fenced by a synchronize at each end), then under
    torch.profiler (device activity only) for the steps' device launches
    and busy time.  -> per step: launches, busy_ms, wall_ms and the
    device's idle share 1 - busy / wall, the wall the untraced one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from whisper_tpu_torch.models import whisper as wm

    def window(prof):
        st = {"prompts": 0, "seen": 0, "steps": 0, "t0": None, "wall": None}
        orig = {f: getattr(wm, f) for f in ("decode_step", "decode_prompt",
                                            "encode")}

        def close():
            torch.cuda.synchronize()
            st["wall"] = time.perf_counter() - st["t0"]
            if prof is not None:
                prof.stop()
            raise _TraceDone

        def step(*a, **k):
            if st["t0"] is not None:
                if st["steps"] == TRACE_STEPS:
                    close()
                st["steps"] += 1
            elif st["prompts"] >= after_prompts:
                if st["seen"] == TRACE_SKIP:
                    torch.cuda.synchronize()
                    if prof is not None:
                        prof.start()
                    st["t0"] = time.perf_counter()
                    st["steps"] = 1
                st["seen"] += 1
            return orig["decode_step"](*a, **k)

        def prompt(*a, **k):
            if st["t0"] is not None:
                close()
            st["prompts"] += 1
            st["seen"] = 0
            return orig["decode_prompt"](*a, **k)

        def encode(*a, **k):
            if st["t0"] is not None:
                close()
            return orig["encode"](*a, **k)

        wm.decode_step, wm.decode_prompt, wm.encode = step, prompt, encode
        try:
            run()
            if st["t0"] is None:
                raise AssertionError(f"{label}: no rung ran "
                                     f"{TRACE_SKIP + TRACE_STEPS} steps")
            close()
        except _TraceDone:
            pass
        finally:
            for f, fn in orig.items():
                setattr(wm, f, fn)
        return st["steps"], st["wall"]

    reset_counts()
    n, wall = window(None)
    prof = torch_profile(activities=[ProfilerActivity.CUDA])
    n_traced, _ = window(prof)
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    out = {"steps": n, "launches": len(evs) / n_traced,
           "busy_ms": busy / n_traced, "wall_ms": wall * 1e3 / n,
           "idle": 1 - busy / n_traced / (wall * 1e3 / n)}
    log(f"[{card_line}] {label} traced: {n} decode steps (from the "
        f"{TRACE_SKIP + 1}th of a rung after prompt pass {after_prompts}; "
        f"no encode or prompt pass among them), per step "
        f"{out['launches']:.1f} device launches, {out['busy_ms']:.4f} ms "
        f"device busy (torch.profiler), {out['wall_ms']:.4f} ms wall "
        f"untraced: idle {out['idle']:.3f}")
    return out


def run_full(label: str, path: Path, cross_mode: str, need, card_line,
             seconds: int = FULL_S, params=None, trace: bool = False):
    """from_file + full on `seconds` s of noise PCM (full_params, or
    `params`); `trace`: once more under the profiler (`traced`).  -> the
    kernel launch counts of `full` (the timed run's)."""
    from whisper_tpu_torch import WhisperContext

    t0 = time.perf_counter()
    ctx = WhisperContext.from_file(str(path), device="cuda",
                                   cross_mode=cross_mode)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p, pcm = params or full_params(), full_pcm(seconds)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rc = ctx.full(p, pcm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    tm = ctx.timings
    n_tok = sum(len(s.tokens) for s in ctx.result_all)
    log(f"[{card_line}] {label}: {path.name}, cross_mode {cross_mode}: load "
        f"{load_s:.3f} s; full of {seconds} s: rc {rc}, wall {wall:.3f} s, "
        f"{seconds / wall:.2f} audio-s per wall-s, {tm.n_encode} windows, "
        f"{tm.n_decode} decode steps, {n_tok} tokens emitted, "
        f"{tm.t_decode_us / 1e3 / max(1, tm.n_decode):.3f} ms per decode "
        f"step (prompt pass included), {tm.n_fail_p} failed rungs, peak "
        f"device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{card_line}] {label} timings (us / counts): " + json.dumps(
        {f: getattr(tm, f) for f in ("t_mel_us", "t_encode_us",
                                     "t_decode_us", "n_encode", "n_decode",
                                     "n_prompt", "n_fail_h", "n_fail_p")}))
    log(f"{label} kernel launches in full: {counts}")
    if rc != 0:
        raise AssertionError(f"{label}: full returned {rc}")
    check_segments(label, [ctx.result_all])
    require_launches(label, counts, need)
    if trace:
        traced(card_line, label, lambda: ctx.full(p, pcm))
    del ctx
    torch.cuda.empty_cache()
    return counts


# device kernels by name fragment, for --profile: K3's one-launch paths at
# M <= 8 and at M > 8 (the prompt pass, wgmma); K4 and K5, the two
# instances of one template, by their template arguments as the profiler
# prints them (demangled or not)
PROFILE_GROUPS = (("K3 M<=8", "qmm_decode_kernel"),
                  ("K3 M>8", "qmm_prompt_kernel"),
                  ("K2", "xattn_q8dt_kernel"),
                  ("K5", ("xattn_cluster_kernel<signed char",
                          "xattn_cluster_kernelIaLb1")),
                  ("K4", ("xattn_cluster_kernel<__nv_bfloat16",
                          "xattn_cluster_kernelI13__nv_bfloat16")),
                  ("K4/K5 (name not matched)", "xattn_cluster_kernel"),
                  ("K1/K6", "encoder_attention_kernel"),
                  ("cuBLAS GEMM/GEMV", ("gemm", "gemv", "nvjet")))


def profile(card_line: str, seconds: int) -> dict:
    """Path A's `full` (large-v3 q5_0, pallas_q8) on the first `seconds` s
    of its PCM, with the packed decoder (K3) and the same file densified
    (keep_quantized=False: bf16 weights, cuBLAS GEMVs).  Each context runs
    once to warm up; then the timed runs go in turns, packed, dense, dense,
    packed; then one packed run under torch.profiler.

    Device busy time is the sum of the device events' durations in the
    profiled run (one stream, so they do not overlap).  The idle share is
    1 - busy / wall, given against the profiled run's wall and against the
    median of the unprofiled packed walls: the profiler slows the host's
    issue of each launch, not the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from whisper_tpu_torch import WhisperContext

    path = model_file("large-v3", "q5_0")
    pcm = full_pcm()
    ctxs, runs = {}, {}
    for name, keep in (("packed", True), ("dense", False)):
        t0 = time.perf_counter()
        ctxs[name] = WhisperContext.from_file(
            str(path), device="cuda", cross_mode="pallas_q8",
            keep_quantized=keep)
        torch.cuda.synchronize()
        runs[name] = {"load_s": time.perf_counter() - t0, "walls": [],
                      "steps": [], "ms_per_step": []}

    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else
                   v.numel() * v.element_size() for v in tree.values())

    def run(name):
        ctx = ctxs[name]
        # the other context's weights stay on the card: leave them out of
        # this one's peak
        other = torch.cuda.memory_allocated() - nbytes(ctx.params)
        torch.cuda.reset_peak_memory_stats()
        n0 = ctx.timings.n_decode
        t0 = time.perf_counter()
        if ctx.full(full_params(seconds), pcm) != 0:
            raise AssertionError(f"profile {name}: full failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_segments(f"profile {name}", [ctx.result_all])
        steps = ctx.timings.n_decode - n0
        runs[name]["peak_GiB"] = (torch.cuda.max_memory_allocated()
                                  - other) / 2**30
        runs[name]["segments"] = len(ctx.result_all)
        return wall, steps

    for name in ctxs:
        run(name)                                  # warm-up
    for name in ("packed", "dense", "dense", "packed"):
        wall, steps = run(name)
        runs[name]["walls"].append(wall)
        runs[name]["steps"].append(steps)
        runs[name]["ms_per_step"].append(wall * 1e3 / steps)
        log(f"[{card_line}] profile {name}: wall {wall:.6f} s, {steps} "
            f"decode steps, {wall * 1e3 / steps:.6f} ms per step")

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        wall_prof, steps_prof = run("packed")
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            t, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (t + ev.time_range.elapsed_us() / 1e6, n + 1)
    busy = sum(t for t, _ in kernels.values())
    if busy <= 0:
        raise AssertionError("profile: the profiler saw no device time")
    groups = {}
    for kname, (t, n) in kernels.items():
        group = next((g for g, frags in PROFILE_GROUPS
                      if any(f in kname for f in (
                          (frags,) if isinstance(frags, str) else frags))),
                     "other (elementwise, layernorm, softmax, copies)")
        gt, gn = groups.get(group, (0.0, 0))
        groups[group] = (gt + t, gn + n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    for kname, (t, n) in top:
        log(f"{t * 1e3:10.3f} ms {n:8d} x {t * 1e6 / n:9.3f} us  {kname[:90]}")
    median_wall = statistics.median(runs["packed"]["walls"])
    launches = sum(n for _, n in kernels.values())
    log(f"[{card_line}] profile packed: {launches / steps_prof:.1f} device "
        f"launches and {busy * 1e3 / steps_prof:.4f} ms device busy per decode "
        f"step ({launches} and {busy * 1e3:.3f} ms over {steps_prof} steps, "
        "the windows' encode and prompt passes included)")
    out = {"card": card_line, "seconds": seconds, "runs": runs,
           "profiled_wall_s": wall_prof, "device_busy_s": busy,
           "profiled_steps": steps_prof,
           "launches_per_step": launches / steps_prof,
           "device_busy_ms_per_step": busy * 1e3 / steps_prof,
           "idle_vs_profiled_wall": 1 - busy / wall_prof,
           "idle_vs_median_unprofiled_wall": 1 - busy / median_wall,
           "groups": {g: {"s": t, "launches": n, "share": t / busy}
                      for g, (t, n) in sorted(groups.items(),
                                              key=lambda kv: -kv[1][0])}}
    del ctxs
    torch.cuda.empty_cache()
    return out


def serving_params(quality: str = "greedy"):
    """bench.py's serving settings (`_serving_params`): language "en",
    max_tokens 64, no timestamps, a 64-token carried prompt; "greedy" with
    the ladder off, "bo5" best_of 5 with the ladder live, "beam5" beam 5
    with the ladder off."""
    from whisper_tpu_torch import SamplingStrategy, full_default_params
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.max_tokens = 64
    p.no_timestamps = True
    p.n_max_text_ctx = 64
    if quality == "bo5":
        p.greedy.best_of = BEAM
    elif quality == "beam5":
        p.strategy = SamplingStrategy.BEAM_SEARCH
        p.beam_search.beam_size = BEAM
        p.temperature_inc = 0.0
    else:
        p.temperature_inc = 0.0
    return p


def serve(card_line: str, ctx, label: str, need, quality: str = "greedy",
          batch: int = N_STREAMS, trace: bool = False):
    """BatchTranscriber.transcribe of N_STREAMS int16 streams of STREAM_S s
    with bench.py's serving settings of tier `quality`, in ctx's cross
    mode, at `batch` rows.  bo5 must retry windows (t > 0 rungs, best_of
    candidates): where the random weights fail none, logprob_thold is
    raised to 0 until they do, and the log says so.  -> the kernel launch
    counts of transcribe; `trace` (einsum_q8 only): one window of the first
    stream once more under the profiler (`traced`)."""
    from whisper_tpu_torch import BatchTranscriber
    from whisper_tpu_torch.utils.trace import TRACE

    p = serving_params(quality)
    bt = BatchTranscriber(ctx, batch_size=batch, params=p, device_mel=True)
    t0 = time.perf_counter()
    bt.warmup(pcm_dtype=np.int16)
    torch.cuda.synchronize()
    log(f"{label} warmup: {time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(7)
    streams = [(rng.randn(16000 * STREAM_S) * 0.1 * 32768).clip(
        -32768, 32767).astype(np.int16) for _ in range(N_STREAMS)]
    while True:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        TRACE.drain()
        TRACE.enable()
        t0 = time.perf_counter()
        result = bt.transcribe(streams)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        TRACE.disable()
        spans = TRACE.summary()
        iterations = [round((r.t1 - r.t0) / 1e9, 4) for r in TRACE.drain()
                      if r.name == "iterate"]
        launches = read_counts()
        if quality != "bo5" or bt.n_retried_windows or p.logprob_thold >= 0:
            break
        log(f"{label}: no window failed at logprob_thold "
            f"{p.logprob_thold}; raising it to 0 so that the t > 0 rungs "
            "run")
        p.logprob_thold = 0.0

    audio_s = float(N_STREAMS * STREAM_S)
    log(f"[{card_line}] {label} ({ctx.cross_mode}, {quality}, batch "
        f"{batch}) {N_STREAMS} x {STREAM_S} s int16: wall {wall:.3f} s, "
        f"{audio_s / wall:.2f} audio-s per wall-s, {bt.n_windows} windows, "
        f"{bt.n_retried_windows} retried, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{card_line}] {label} spans (s; encode on the stream): "
        + json.dumps({k: round(v.get("stream_seconds", v["seconds"]), 4)
                      for k, v in spans.items()}))
    log(f"[{card_line}] {label} iterations (s): " + json.dumps(iterations))
    log(f"kernel launches in {label}: {launches}")
    check_segments(label, result)
    require_launches(label, launches, need)
    if quality == "bo5" and not bt.n_retried_windows:
        raise AssertionError(f"{label}: no window ran a t > 0 rung")
    if trace:   # bo5: the steps of its first t > 0 rung (2nd prompt pass)
        traced(card_line, label, lambda: bt.transcribe(streams),
               2 if quality == "bo5" else 1)
    del bt
    torch.cuda.empty_cache()
    return launches


def check_draws(card_line: str):
    """decode/rng.py on the card against the CPU for the same keys and f32
    logits: bits, split keys and uniforms the same bits; categorical draws
    the same wherever the winner leads by more than 1e-5 (asserted) in the
    three forms the loops use.  Then what a draw costs at the serving
    shapes, from a torch.profiler trace: device time and launches of one
    step's draw for bo5's 20 rows (per-row keys over (20, V)) and for
    beam5's t > 0 rung (S = 4 streams, (K, K) draws over (K, V) each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from whisper_tpu_torch.decode import rng

    V = 51866
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    keys = np.array([[4500, 515], [2**31 + 7, 2**32 - 1], [0, 0],
                     [12, 1 << 8]], np.uint32)
    for key in (keys[0], keys):
        for name, fn in (("bits", lambda k: rng.random_bits(k, (7, 333))),
                         ("split", lambda k: rng.split(k, 3)),
                         ("uniform", lambda k: rng.uniform(k, (5, 1000)))):
            card_out = fn(rng.as_key(key, "cuda")).cpu()
            if not torch.equal(card_out, fn(rng.as_key(key, "cpu"))):
                raise AssertionError(f"draws: {name} differ on the card")
    logits = torch.randn(4, BEAM, V, generator=gen, device="cuda") * 2.0
    logits[..., ::3] = float("-inf")
    n_draws = 0
    for key, lg, shape in ((keys[0], logits[0], None),
                           (keys, logits[:, 0], None),
                           (keys[1], logits[0], (BEAM, BEAM)),
                           (keys, logits, (BEAM, BEAM))):
        gap = rng.categorical_margin(key, lg.cpu(), shape)
        on_card = rng.categorical(key, lg, shape).cpu()
        if gap <= 1e-5 or not torch.equal(on_card,
                                          rng.categorical(key, lg.cpu(),
                                                          shape)):
            raise AssertionError(f"draws: categorical {tuple(on_card.shape)}"
                                 f" differs (min gap {gap:.3g})")
        n_draws += on_card.numel()
    log(f"draws: bits, split, uniform equal on the card and the CPU; "
        f"{n_draws} categorical draws equal (every gap > 1e-5)")

    rows = torch.randn(QUALITY_BATCH, V, generator=gen, device="cuda")
    row_keys = rng.as_key(np.tile(keys[:1], (QUALITY_BATCH, 1)), "cuda")
    stream_keys = rng.as_key(keys, "cuda")
    cases = {"bo5 (20 rows, per-row keys)":
             lambda: rng.categorical(row_keys, rows),
             "beam5 t > 0 (4 streams, 5 x 5 draws over 5 x V)":
             lambda: rng.categorical(stream_keys, logits, (BEAM, BEAM))}
    out = {}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        n = 10
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in evs) / n / 1e3
        out[name] = {"device_ms": busy, "launches": len(evs) / n}
        log(f"[{card_line}] draws: one step's draw, {name}: {busy:.4f} ms "
            f"of device time, {len(evs) / n:.0f} launches (torch.profiler, "
            f"mean of {n})")
    torch.cuda.empty_cache()
    return out


def check_parity(card_line: str):
    """The port in bf16 on the card against whisper_tpu's segments on the
    CPU (tests/golden/port_segments.json, tests/port_parity.py): the same
    random-weight q8_0 file and PCM, BatchTranscriber greedy and beam 5
    (einsum_q8, the decoder packed: K1, K2, K2 with G = 5, K3); each
    stream's held golden tokens must be emitted (port_parity.compare),
    and, teacher-forced, the golden token must come first at each greedy
    stream's decided steps (port_parity.check_decided).  -> the kernel
    launch counts."""
    import hashlib
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import port_parity as pp
    from whisper_tpu_torch import (BatchTranscriber, WhisperContext,
                                   full_default_params)

    golden = pp.load_golden()
    BUILD.mkdir(parents=True, exist_ok=True)
    path = pp.write_model(BUILD / "parity.bin")
    digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()
    if digest != golden["model_sha256"]:
        raise AssertionError("parity: the model file differs from the "
                             "golden run's")
    ctx = WhisperContext.from_file(path, cross_mode=pp.CROSS_MODE)
    reset_counts()
    for config in pp.CONFIGS:
        bt = BatchTranscriber(ctx, batch_size=pp.BATCH,
                              params=pp.params(full_default_params, config),
                              device_mel=True)
        held = pp.compare(config, bt.transcribe(pp.streams(config)),
                          golden)
        log(f"[{card_line}] parity {config}: {held['covered']} of "
            f"{held['of']} golden tokens held (by stream {held['held']}; "
            f"leading tokens equal, held or not: {held['agree']}), all "
            f"equal (stated bf16 noise {pp.BF16_NOISE}); largest log-prob "
            f"difference on them {held['max_plog_diff']:.4g}")
        if config == "greedy":
            gaps = [pp.teacher_forced_gaps(ctx, bt, pcm, ref["tokens"])
                    for pcm, ref in zip(pp.streams(config),
                                        golden[config]["streams"])]
            tf = pp.check_decided(gaps, golden)
            log(f"[{card_line}] parity greedy teacher-forced: decided "
                f"steps by stream {tf['decided']} (golden gap >= "
                f"{2 * pp.BF16_NOISE:.2f}, each >= {pp.MIN_PREFIX}), the "
                f"golden token first at each; largest gap change "
                f"{tf['max_gap_change']:.4g}")
    counts = read_counts()
    log(f"kernel launches in parity: {counts}")
    require_launches("parity", counts, ("K1", "K2", "K2G", "K3"))
    del ctx
    torch.cuda.empty_cache()
    return counts


def elog(msg: str) -> None:
    """A line of the serving phases' figures, on stderr."""
    print(msg, file=sys.stderr, flush=True)


def int16_noise(seconds: int, seed: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(16000 * seconds) * 0.1
            * 32768).clip(-32768, 32767).astype(np.int16)


def _token_ids(results) -> list:
    return [[(s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]
            for segs in results]


def _wait_jobs(label: str, jobs, timeout: float = 600) -> None:
    for j in jobs:
        if not j.done.wait(timeout):
            raise AssertionError(f"{label}: a job did not finish")
        if j.error is not None:
            raise AssertionError(f"{label}: job error: {j.error}")


def check_continuous(card_line: str, ctx) -> dict:
    """The phase "continuous": ContinuousBatcher(batch_size=4) on the
    serving path's large-v3 context (einsum_q8: K1, K2) with
    serving_params(), N_STREAMS int16 streams of STREAM_S s.  Run 1
    (device_mel, the resident pool): the first iteration held by the
    iteration hook until the streams are queued, so every batch holds
    transcribe's rows: the segments must equal
    BatchTranscriber.transcribe's of the same streams token for token.
    Run 2: CONT_LATE more streams submitted while the first decode: each
    late stream's first segment within one iteration of its joining, and
    every stream held a pool row.  Run 3: run 1 with device_mel=False (host
    mel, no pool) against transcribe(device_mel=False).  -> the kernel
    launch counts of the three runs (the transcribe references run before
    the counts are set to 0)."""
    import threading

    from whisper_tpu_torch import BatchTranscriber
    from whisper_tpu_torch.parallel.batch import ContinuousBatcher

    p = serving_params()
    streams = [int16_noise(STREAM_S, 11 + i) for i in range(N_STREAMS)]
    late = [int16_noise(STREAM_S, 21 + i) for i in range(CONT_LATE)]
    want = {dm: BatchTranscriber(ctx, batch_size=N_STREAMS, params=p,
                                 device_mel=dm).transcribe(streams)
            for dm in (True, False)}
    torch.cuda.synchronize()

    def run_gated(device_mel: bool, label: str):
        eng = ContinuousBatcher(ctx, batch_size=N_STREAMS, params=p,
                                device_mel=device_mel)
        parked, go = threading.Event(), threading.Event()

        def hook(n):   # the idle engine waits here while the streams queue
            parked.set()
            go.wait(timeout=600)

        eng.iteration_hook = hook
        try:
            if not parked.wait(timeout=60):
                raise AssertionError(f"{label}: the engine never reached "
                                     "its iteration hook")
            jobs = [eng.submit_async(pcm) for pcm in streams]
            t0 = time.time_ns()
            go.set()
            _wait_jobs(label, jobs)
            wall = (time.time_ns() - t0) / 1e9
        finally:
            eng.close()
        got = [j.st.result_all for j in jobs]
        check_segments(label, got)
        if _token_ids(got) != _token_ids(want[device_mel]):
            raise AssertionError(f"{label}: segments differ from "
                                 "BatchTranscriber.transcribe's")
        ttfs = [(j.t_first_segment - t0) / 1e9 for j in jobs]
        elog(f"[{card_line}] {label}: {len(jobs)} x {STREAM_S} s int16, "
             f"batch {N_STREAMS}: equal to transcribe token for token; "
             f"wall {wall:.3f} s, {len(jobs) * STREAM_S / wall:.2f} audio-s "
             f"per wall-s, {eng.n_iterations} iterations, time to first "
             f"segment {min(ttfs):.3f}-{max(ttfs):.3f} s")
        return eng

    reset_counts()
    eng = run_gated(True, "continuous run 1 (pool)")
    if len(eng._pool_free) != eng.max_active:
        raise AssertionError("continuous run 1: pool rows not recycled")

    # run 2: late streams join while the first ones decode
    eng = ContinuousBatcher(ctx, batch_size=N_STREAMS, params=p,
                            device_mel=True)
    rows, late_jobs = [], []
    orig = eng.bt._iterate

    def spy(states, batch, pcm_dev=None):
        rows.extend(states[i].pcm_row for i in batch)
        return orig(states, batch, pcm_dev)

    def hook(n):
        if n == 1 and not late_jobs:
            late_jobs.extend(eng.submit_async(pcm) for pcm in late)

    eng.bt._iterate = spy
    eng.iteration_hook = hook
    try:
        t0 = time.perf_counter()
        jobs = [eng.submit_async(pcm) for pcm in streams]
        while not late_jobs:
            time.sleep(0.01)
        _wait_jobs("continuous run 2", jobs + late_jobs)
        wall = time.perf_counter() - t0
    finally:
        eng.close()
    check_segments("continuous run 2", [j.st.result_all
                                        for j in jobs + late_jobs])
    for j in late_jobs:
        if j.iter_first is None or j.iter_first > j.iter_joined + 1:
            raise AssertionError(
                f"continuous run 2: a late stream joined at iteration "
                f"{j.iter_joined}, first segment at {j.iter_first}")
    if None in rows:
        raise AssertionError("continuous run 2: a stream held no pool row")
    late_ttfs = [round((j.t_first_segment - j.t_submit) / 1e9, 3)
                 for j in late_jobs]
    elog(f"[{card_line}] continuous run 2: {N_STREAMS} + {CONT_LATE} late "
         f"streams of {STREAM_S} s, batch {N_STREAMS}: wall {wall:.3f} s, "
         f"{(N_STREAMS + CONT_LATE) * STREAM_S / wall:.2f} audio-s per "
         f"wall-s, {eng.n_iterations} iterations; late streams joined at "
         f"iterations {[j.iter_joined for j in late_jobs]}, first segments "
         f"at {[j.iter_first for j in late_jobs]}, time to first segment "
         f"{late_ttfs} "
         f"s; every scheduled stream held a pool row")

    run_gated(False, "continuous run 3 (host mel)")
    counts = read_counts()
    elog(f"[{card_line}] continuous: kernel launches K1 {counts['K1']}, "
         f"K2 {counts['K2']} ({counts})")
    require_launches("continuous", counts, ("K1", "K2"))
    torch.cuda.empty_cache()
    return counts


def wav_bytes(pcm: np.ndarray) -> bytes:
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def http(port: int, path: str, fields: dict | None = None,
         wav: bytes | None = None) -> tuple[int, str, bytes, float]:
    """One request to the server: GET without fields, else a multipart
    POST.  -> (status, content type, body, seconds)."""
    import urllib.error
    import urllib.request
    data, headers = None, {}
    if fields is not None:
        b = "chipsmoke"
        parts = [(f'--{b}\r\nContent-Disposition: form-data; name="file"; '
                  f'filename="a.wav"\r\n\r\n').encode() + wav]
        parts += [(f'--{b}\r\nContent-Disposition: form-data; '
                   f'name="{k}"\r\n\r\n{v}').encode()
                  for k, v in fields.items()]
        data = b"\r\n".join(parts) + f"\r\n--{b}--\r\n".encode()
        headers = {"Content-Type": f'multipart/form-data; boundary="{b}"'}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            out = (r.status, r.headers.get("Content-Type"), r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers.get("Content-Type"), e.read())
    return (*out, time.perf_counter() - t0)


def check_server(card_line: str, path: Path) -> dict:
    """The phase "server": the port's server in this process
    (ThreadingHTTPServer on a free port, whisper_tpu_torch.server.Handler)
    over path A's large-v3 q5_0 file through from_file (K1, K3) with
    --batch 4, on WAVs of SERVER_S s of int16 noise, with the server's own
    defaults (best_of 2, the ladder live, no_context false, max_len 60)
    but for SERVER_FIELDS: 4 concurrent /inference json requests (one
    decode signature: one engine, one batch), a /stream request sent while
    they decode (it joins that engine), then a verbose_json request with
    language=auto (token timestamps and language detection, an engine of
    its own) and an srt request with offset_n=3, then /health.  Every
    response must be 200 and parse; the /stream request must ride the
    json requests' engine and have its first segment within one iteration
    of joining; that engine must have retried a window on the ladder's
    t > 0 rungs.  -> the kernel launch counts of the requests."""
    import socket
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    import whisper_tpu_torch.server as srv
    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch.languages import NAME_TO_ID

    t0 = time.perf_counter()
    srv.STATE.ctx = WhisperContext.from_file(str(path))
    srv.STATE.model_path = str(path)
    # --batch 4; the engines are built by the first requests (the counts
    # and times below start after the set-up either way)
    srv.STATE.batcher = srv._BatchWorker(srv.STATE.ctx, batch_size=4,
                                         warmup=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = ThreadingHTTPServer(("127.0.0.1", port), srv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    wavs = [wav_bytes(int16_noise(SERVER_S, 31 + i)) for i in range(7)]
    results = {}
    reset_counts()
    t_start = time.perf_counter()
    try:
        with ThreadPoolExecutor(8) as pool:
            first = [pool.submit(http, port, "/inference",
                                 {"response_format": "json",
                                  **SERVER_FIELDS}, wavs[i])
                     for i in range(4)]
            # the /stream request once the four are in the engine's batch
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                engs = list(srv.STATE.batcher.engines.values())
                if engs and len(engs[0].active) == 4:
                    break
                time.sleep(0.01)
            else:
                raise AssertionError("server: the four requests never "
                                     "filled the engine's batch")
            json_eng, stream_jobs = engs[0], []
            submit_async = json_eng.submit_async

            def note_stream(pcm, on_segment=None):
                job = submit_async(pcm, on_segment=on_segment)
                if on_segment is not None:
                    stream_jobs.append(job)
                return job

            json_eng.submit_async = note_stream
            joined_at = json_eng.n_iterations
            stream = pool.submit(http, port, "/stream", SERVER_FIELDS,
                                 wavs[4])
            for i, f in enumerate(first):
                results[f"json {i}"] = f.result()
            results["stream"] = stream.result()
            later = {
                "verbose_json auto": pool.submit(
                    http, port, "/inference",
                    {"response_format": "verbose_json", "language": "auto",
                     **SERVER_FIELDS}, wavs[5]),
                "srt offset_n 3": pool.submit(
                    http, port, "/inference",
                    {"response_format": "srt", "offset_n": "3",
                     **SERVER_FIELDS}, wavs[6])}
            for k, f in later.items():
                results[k] = f.result()
        results["health"] = http(port, "/health")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        counts = read_counts()
        engines = list(srv.STATE.batcher.engines.values())
        iters = [e.n_iterations for e in engines]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.STATE.batcher.close()
        srv.STATE.batcher = srv.STATE.ctx = None

    for name, (status, ctype, body, secs) in results.items():
        elog(f"[{card_line}] server {name}: {status} {ctype}, "
             f"{len(body)} bytes in {secs:.3f} s")
        if status != 200:
            raise AssertionError(f"server {name}: HTTP {status}: "
                                 f"{body[:500]!r}")
    for i in range(4):
        if not json.loads(results[f"json {i}"][2])["text"]:
            raise AssertionError(f"server json {i}: empty text")
    if len(stream_jobs) != 1:
        raise AssertionError("server stream: the /stream request did not "
                             "ride the json requests' engine")
    sj = stream_jobs[0]
    if sj.iter_first is None or sj.iter_first > sj.iter_joined + 1:
        raise AssertionError(f"server stream: joined at iteration "
                             f"{sj.iter_joined}, first segment at "
                             f"{sj.iter_first}")
    retried = {("json" if e is json_eng else "verbose_json"):
               (e.bt.n_windows, e.bt.n_retried_windows) for e in engines}
    if json_eng.bt.n_retried_windows <= 0:
        raise AssertionError(f"server: the json engine retried no window "
                             f"at t > 0 (windows, retried by engine: "
                             f"{retried})")
    events = results["stream"][2].decode().split("\n\n")
    if "event: error" in results["stream"][2].decode() or \
            events[-2:] != ["data: [DONE]", ""] or len(events) < 3:
        raise AssertionError(f"server stream: bad events {events[:3]}...")
    for ev in events[:-2]:
        seg = json.loads(ev.removeprefix("data: "))
        if set(seg) != {"start", "end", "text"}:
            raise AssertionError(f"server stream: bad event {ev}")
    doc = json.loads(results["verbose_json auto"][2])
    words = [w for s in doc["segments"] for w in s.get("words", [])]
    if not words:
        raise AssertionError("server verbose_json: no words")
    for w in words:
        if not ({"word", "start", "end", "t_dtw", "probability"} <= set(w)
                and w["t_dtw"] == -1 and 0.0 <= w["probability"] <= 1.0):
            raise AssertionError(f"server verbose_json: bad word {w}")
    if all(w["start"] == -0.01 for w in words):
        raise AssertionError("server verbose_json: no token timestamp set")
    if doc["language"] not in NAME_TO_ID:
        raise AssertionError(f"server verbose_json: language "
                             f"{doc['language']!r}")
    if not results["srt offset_n 3"][2].startswith(b"4\n"):
        raise AssertionError("server srt: numbering does not start at 4")
    if results["health"][2] != b'{"status":"ok"}':
        raise AssertionError("server health: bad body")
    audio_s = 7 * SERVER_S
    elog(f"[{card_line}] server (large-v3 q5_0, --batch 4, {len(iters)} "
         f"engines of {iters} iterations; windows and retried windows by "
         f"engine {retried}): load {load_s:.3f} s; 7 requests of "
         f"{SERVER_S} s in {wall:.3f} s, "
         f"{audio_s / wall:.2f} audio-s per wall-s; /stream sent during "
         f"iteration {joined_at}, joined the json engine at iteration "
         f"{sj.iter_joined}, first segment at {sj.iter_first}; "
         f"{len(events) - 2} SSE events; verbose_json language "
         f"{doc['language']!r}, {len(words)} words")
    elog(f"[{card_line}] server: kernel launches K1 {counts['K1']}, K3 "
         f"{counts['K3']} ({counts})")
    require_launches("server", counts, ("K1", "K3"))
    torch.cuda.empty_cache()
    return counts


def _replay_grammar(label: str, vocab, tokens) -> int:
    """A fresh grammar (native) over one window's tokens: no text token
    may be penalized at its step.  -> text tokens replayed."""
    from whisper_tpu_torch.grammar import grammar_from_gbnf
    g = grammar_from_gbnf(COLORS.read_text())
    n = 0
    for tid in tokens:
        if tid >= vocab.token_eot:
            continue
        mask = np.zeros(vocab.n_vocab, np.float32)
        g.suppress_invalid(vocab, mask, 100.0)
        if mask[tid] != 0.0:
            raise AssertionError(f"{label}: token {tid} "
                                 f"({vocab.token_str(tid)!r}) violates the "
                                 "grammar")
        g.accept_token(vocab, tid)
        n += 1
    return n


def check_cli(card_line: str, big_file: Path, small_file: Path) -> dict:
    """The phase "cli": whisper_tpu_torch.cli.main as a user runs it, and
    the batched DTW pass.  Five runs, each read with the counts set to 0
    just before it:
      1. large-v3 q5_0 (path A's file), -dtw large-v3 -kvq -bs 5 -nf -p 2
         on CLI_RUN_S s, every writer on: DTW forces full_parallel's serial
         chunks; every output file non-empty, every text token's t_dtw >= 0
         and, within a window, nondecreasing and inside it; chunk 2's
         segments start at or after its 10 s; K1 and K3 launch (K3 at
         M = T_pad in the re-decode).  ("large.v3", the reference's
         spelling, is not a preset in whisper_tpu's CLI: exit 3.)
      2. small q5_1 with grammars/colors.gbnf's pieces in its vocab,
         -bs 1 --grammar colors --grammar-rule root -nf -oj on
         CLI_SHORT_S s: the speculative greedy path, the native engine;
         the first segment's tokens replay through a fresh grammar
         unpenalized
      3. the same with -bs 5: the host beam, held the same way
      4. the same file, -p 2 -bs 1 -kvq -nf on CLI_RUN_S s: the batched
         route (K1, K2), chunk 2's segments shifted by 10 s
      5. BatchTranscriber(small file, einsum_q8, DTW preset "small"),
         batch 2, two CLI_SHORT_S s streams: t_dtw >= 0 on every text
         token; K1, K2 and K3 (M = 2 x T_pad) launch.
    Each run's wall, load, audio-s per wall-s, tokens, grammar ms a step
    and DTW host ms a window go to stderr.  -> the phase's launch counts."""
    import contextlib
    import io

    from whisper_tpu_torch import api as tapi
    from whisper_tpu_torch import cli
    from whisper_tpu_torch.grammar import NativeGrammar
    from whisper_tpu_torch.parallel.batch import BatchTranscriber

    out_dir = BUILD / "cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    wavs = {}
    for sec in (CLI_RUN_S, CLI_SHORT_S):
        wavs[sec] = out_dir / f"noise{sec}.wav"
        wavs[sec].write_bytes(wav_bytes(int16_noise(sec, 40 + sec)))

    # what the CLI builds inside main(): its context (and load time), its
    # params, the DTW windows and the batched route's chunks
    seen: dict = {}
    cls = tapi.WhisperContext
    orig_from_file = cls.__dict__["from_file"]
    orig_fp = cls.full_parallel
    orig_full = cls.full
    orig_dtw = tapi.compute_token_level_timestamps_dtw
    orig_transcribe = BatchTranscriber.transcribe

    def from_file(c, path, **kw):
        t0 = time.perf_counter()
        ctx = orig_from_file.__func__(c, path, **kw)
        torch.cuda.synchronize()
        seen["ctx"], seen["load"] = ctx, time.perf_counter() - t0
        return ctx

    def full_parallel(self, params, samples, n_processors=1):
        seen["params"] = params
        return orig_fp(self, params, samples, n_processors)

    def full(self, params, samples, state=None):
        rc = orig_full(self, params, samples, state)
        seen.setdefault("full_segments", []).append(
            len((state or self).result_all))
        return rc

    def dtw(ctx, params, i_seg, n_new, seek, n_frames, **kw):
        host0 = ctx.timings.t_dtw_host_us
        orig_dtw(ctx, params, i_seg, n_new, seek, n_frames, **kw)
        seen.setdefault("windows", []).append((
            seek, n_frames, [t.t_dtw for s in ctx.result_all[i_seg:i_seg + n_new]
                             for t in s.tokens if t.id < ctx.token_eot()],
            ctx.timings.t_dtw_host_us - host0))

    def transcribe(self, streams):
        res = orig_transcribe(self, streams)
        seen.setdefault("chunks", []).append([list(segs) for segs in res])
        return res

    def run_cli(label, model, sec, argv):
        for k in ("ctx", "params", "windows", "chunks", "full_segments"):
            seen.pop(k, None)
        base = out_dir / label.replace(" ", "_")
        reset_counts()
        t0 = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["-m", str(model), "-f", str(wavs[sec]), "-of",
                           str(base), *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"cli {label}: exit {rc}")
        ctx = seen["ctx"]
        tm = ctx.timings
        n_tok = sum(len(s.tokens) for s in ctx.result_all)
        win = seen.get("windows", [])
        run_s = wall - seen["load"]
        elog(f"[{card_line}] cli {label}: load {seen['load']:.3f} s; wall "
             f"{wall:.3f} s, {run_s:.3f} s past the load, "
             f"{sec / run_s:.2f} audio-s per wall-s; {len(ctx.result_all)} "
             f"segments, {n_tok} tokens, "
             f"{len(stdout.getvalue().splitlines())} lines printed; host "
             f"filter chain with the grammar mask "
             f"{tm.t_grammar_us / 1e3 / max(1, tm.n_grammar):.3f} ms a "
             f"decoder step over {tm.n_grammar} ({tm.n_grammar_chunk} device "
             f"chunks, {tm.n_grammar_restart} restarts); DTW host "
             + (f"{sum(w[3] for w in win) / 1e3 / len(win):.3f} ms a window "
                f"over {len(win)}" if win else "none")
             + f"; launches {counts}")
        return base, ctx, counts

    cls.from_file = classmethod(from_file)
    cls.full_parallel = full_parallel
    cls.full = full
    tapi.compute_token_level_timestamps_dtw = dtw
    BatchTranscriber.transcribe = transcribe
    total: dict = {}
    try:
        # 1. large-v3, DTW, beam 5, -p 2 (serial chunks), every writer
        base, ctx, counts = run_cli(
            "run 1 large-v3 dtw", big_file, CLI_RUN_S,
            ["-dtw", "large-v3", "-kvq", "-bs", "5", "-nf", "-p", "2",
             "-otxt", "-ovtt", "-osrt", "-ocsv", "-olrc", "-ojf", "-owts",
             "-ls", "-fp", str(Path(__file__).resolve())])
        require_launches("cli run 1", counts, ("K1", "K3"))
        for ext in (".txt", ".vtt", ".srt", ".csv", ".lrc", ".json", ".wts",
                    ".score.txt"):
            f = Path(str(base) + ext)
            if not f.is_file() or f.stat().st_size == 0:
                raise AssertionError(f"cli run 1: {f.name} missing or empty")
        doc = json.loads(Path(str(base) + ".json").read_text())
        text = [t for s in doc["transcription"] for t in s["tokens"]
                if t["id"] < ctx.token_eot()]
        if not text or any(t["t_dtw"] < 0 for t in text):
            raise AssertionError("cli run 1: a text token without t_dtw")
        windows = seen.get("windows", [])
        if len(windows) < 2:
            raise AssertionError(f"cli run 1: {len(windows)} DTW windows")
        for seek, n_frames, stamps, _ in windows:
            if not stamps or stamps != sorted(stamps) or not (
                    seek <= stamps[0] and stamps[-1] < seek + n_frames):
                raise AssertionError(f"cli run 1: window at {seek} "
                                     f"({n_frames} frames): stamps {stamps}")
        # the serial chunks: chunk 1 on the context's state, chunk 2 on a
        # fresh one
        n_chunk1 = seen["full_segments"][0]
        chunk2 = doc["transcription"][n_chunk1:]
        if not chunk2 or any(s["offsets"]["from"] < CLI_RUN_S // 2 * 1000
                             for s in chunk2):
            raise AssertionError(f"cli run 1: chunk 2's segments "
                                 f"{[s['offsets'] for s in chunk2]}")
        total = counts

        # 2, 3. grammar: speculative greedy, then the host beam
        small_g = model_file("small", "q5_1", pieces=True)
        for label, bs in (("run 2 grammar greedy", "1"),
                          ("run 3 grammar beam 5", "5")):
            _, ctx, counts = run_cli(
                label, small_g, CLI_SHORT_S,
                ["-bs", bs, "--grammar", str(COLORS), "--grammar-rule",
                 "root", "-nf", "-oj"])
            if not isinstance(seen["params"].grammar_rules, NativeGrammar):
                raise AssertionError(f"cli {label}: grammar engine "
                                     f"{type(seen['params'].grammar_rules)}")
            if ctx.timings.n_grammar <= 0 or (
                    bs == "1" and ctx.timings.n_grammar_chunk <= 0):
                raise AssertionError(f"cli {label}: the host loop did not "
                                     "run")
            n_text = (_replay_grammar(label, ctx.vocab,
                                      [t.id for t in ctx.result_all[0].tokens])
                      if ctx.result_all else 0)
            elog(f"cli {label}: {n_text} text tokens of the first segment "
                 "replayed through a fresh grammar")
            require_launches(f"cli {label}", counts, ("K1", "K3"))
            total = {k: total.get(k, 0) + v for k, v in counts.items()}

        # 4. -p 2 batched: the chunks ride one BatchTranscriber batch
        _, ctx, counts = run_cli("run 4 p2 batched", small_g, CLI_RUN_S,
                                 ["-p", "2", "-bs", "1", "-kvq", "-nf"])
        chunks = seen.get("chunks", [])
        if len(chunks) != 1 or len(chunks[0]) != 2:
            raise AssertionError(f"cli run 4: batched route not taken "
                                 f"({len(chunks)} transcribe calls)")
        first, second = chunks[0]
        if not second or any(s.t0 < CLI_RUN_S // 2 * 100 for s in second) \
                or ctx.result_all != first + second:
            raise AssertionError("cli run 4: chunk 2 not shifted or not "
                                 "merged")
        require_launches("cli run 4", counts, ("K1", "K2"))
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    finally:
        cls.from_file = orig_from_file
        cls.full_parallel = orig_fp
        cls.full = orig_full
        tapi.compute_token_level_timestamps_dtw = orig_dtw
        BatchTranscriber.transcribe = orig_transcribe

    # 5. the batched DTW pass
    t0 = time.perf_counter()
    ctx = tapi.WhisperContext.from_file(
        str(small_file), cross_mode="einsum_q8", dtw_token_timestamps=True,
        dtw_aheads_preset="small")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    streams = [int16_noise(CLI_SHORT_S, 60 + i) for i in range(2)]
    reset_counts()
    t0 = time.perf_counter()
    res = BatchTranscriber(ctx, batch_size=2,
                           params=full_params()).transcribe(streams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_segments("cli run 5 batched dtw", res)
    stamps = [t.t_dtw for segs in res for s in segs for t in s.tokens
              if t.id < ctx.token_eot()]
    if not stamps or min(stamps) < 0:
        raise AssertionError("cli run 5: a text token without t_dtw")
    tm = ctx.timings
    elog(f"[{card_line}] cli run 5 batched dtw (small q5_1, einsum_q8, "
         f"batch 2): load {load_s:.3f} s; wall {wall:.3f} s, "
         f"{2 * CLI_SHORT_S / wall:.2f} audio-s per wall-s; "
         f"{sum(len(s.tokens) for segs in res for s in segs)} tokens; DTW "
         f"{tm.n_dtw} windows, re-decode "
         f"{tm.t_dtw_qk_us / 1e3:.3f} ms, host "
         f"{tm.t_dtw_host_us / 1e3 / max(1, tm.n_dtw):.3f} ms a window; "
         f"launches {counts}")
    require_launches("cli run 5", counts, ("K1", "K2", "K3"))
    del ctx
    torch.cuda.empty_cache()
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def _speech_then_silence(seed: int) -> np.ndarray:
    """2 s of a 440 Hz tone under noise, then 1 s of silence: whisper's
    energy VAD (vad_simple) fires on the last 2 s."""
    t = np.arange(2 * 16000) / 16000
    loud = (0.3 * np.sin(2 * np.pi * 440 * t)
            + np.random.RandomState(seed).randn(len(t)) * 0.05)
    return np.concatenate([loud, np.zeros(16000)]).astype(np.float32)


def _lsp_session(serve, ctx, requests: list, **kw) -> list:
    """Frame JSON-RPC requests into an in-memory stdin, run `serve` (an
    lsp.serve or a wrapper of lsp.main), parse every framed response."""
    import io
    stdin, stdout = io.BytesIO(), io.BytesIO()
    for req in requests:
        data = json.dumps(req).encode()
        stdin.write(f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    stdin.seek(0)
    rc = serve(ctx, stdin, stdout, **kw)
    if rc != 0:
        raise AssertionError(f"lsp: exit {rc}")
    stdout.seek(0)
    out = []
    while (header := stdout.readline()):
        n = int(header.split(b":")[1])
        stdout.readline()
        out.append(json.loads(stdout.read(n)))
    for r in out:
        if "error" in r:
            raise AssertionError(f"lsp: request {r['id']}: {r['error']}")
    return out


def check_apps(card_line: str, big_file: Path) -> dict:
    """The phase "apps": whisper-stream, whisper-command and whisper-lsp
    (whisper_tpu_torch.stream / command / lsp) as their users run them,
    with the native host mel.
      0. the native audio front end (audio/native.py) must have built; the
         host mel of 30 s, native against numpy (median of 5, ms)
      1. large-v3 q5_0 (path A's file), pallas_q8 (K1, K3, K5), loaded
         once: StreamTranscriber fixed-step (3 s steps over a 10 s window,
         200 ms kept, 32 tokens, keep_context) over APPS_STREAM_S s of
         noise: 4 events, a line every 2nd; the VAD mode at audio_ctx 750
         over 2 s of tone and noise and 1 s of silence (K1 at T = 750, K5
         at Ta = 750); command's transcribe_utterance at its reference
         defaults (beam 5 at t = 0.4, best_of 5) on 3 s; lsp unguided
         through `serve`
      2. small q5_1 with the colors words in its vocab, pallas (K1, K3
         with mins, K4): lsp registerCommandset over the colors words, then
         guided (K3 at M = the commandset prompt) and unguided; command's
         grammar mode with grammars/colors.gbnf; then the `main`s of
         stream (-nf on a 3 s WAV: one step), command (-f) and lsp
         (in-memory stdin), each on its default --device.
    Each run's wall, audio-s per wall-s and tokens go to stderr.  -> the
    phase's launch counts."""
    import contextlib
    import io

    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch import command, lsp, stream
    from whisper_tpu_torch.audio import mel as tmel
    from whisper_tpu_torch.audio import native
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.grammar import NativeGrammar, grammar_from_gbnf

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("apps: the native audio front end did not "
                             "build (see the warning above)")
    pcm30 = full_pcm(30)
    filters = mel_filterbank(128)
    times = {"native": [], "numpy": []}
    for _ in range(5):
        for kind in times:
            t0 = time.perf_counter()
            if kind == "native":
                mel, _ = native.log_mel_spectrogram_native(pcm30, filters)
            else:
                padded, n_len, _ = tmel.pad_audio(pcm30)
                ref = tmel._mel_from_padded_np(padded, n_len, filters)
            times[kind].append((time.perf_counter() - t0) * 1e3)
    mel_err = float(np.abs(mel - ref).max())
    mel_ms = {k: statistics.median(v) for k, v in times.items()}
    elog(f"[{card_line}] apps host mel of 30 s, 128 mels (median of 5): "
         f"native {mel_ms['native']:.3f} ms, numpy {mel_ms['numpy']:.3f} ms "
         f"({mel_ms['numpy'] / mel_ms['native']:.2f}x); max |native - "
         f"numpy| {mel_err:.3e} (tol 5e-5)")
    if mel_err > 5e-5:
        raise AssertionError(f"apps: native mel off numpy by {mel_err:.3e}")

    total: dict = {}

    def timed(label, seconds, run, ctx):
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        n_tok = sum(len(s.tokens) for s in ctx.result_all)
        elog(f"[{card_line}] apps {label}: wall {wall:.3f} s, "
             f"{seconds / wall:.2f} audio-s per wall-s, {n_tok} tokens in "
             f"the last result; launches {counts}")
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        return out

    # 1. large-v3 q5_0, pallas_q8
    t0 = time.perf_counter()
    big = WhisperContext.from_file(str(big_file), cross_mode="pallas_q8")
    torch.cuda.synchronize()
    elog(f"[{card_line}] apps large-v3 load: "
         f"{time.perf_counter() - t0:.3f} s")
    pcm = full_pcm(APPS_STREAM_S)
    st = stream.StreamTranscriber(big, step_ms=APPS_STEP_MS,
                                  length_ms=APPS_LENGTH_MS, keep_ms=200,
                                  max_tokens=32, no_context=False)
    n_step = 16 * APPS_STEP_MS
    events = timed("stream fixed-step", APPS_STREAM_S, lambda: [
        ev for i in range(APPS_STREAM_S * 1000 // APPS_STEP_MS)
        for ev in st.feed_fixed(pcm[i * n_step:(i + 1) * n_step])], big)
    finals = [final for final, _ in events]
    if finals != [(i + 1) % st.n_new_line == 0 for i in range(4)] \
            or st.n_new_line != 2 or not all(segs for _, segs in events):
        raise AssertionError(f"apps stream fixed-step: events {events}")
    if not st.prompt_tokens:
        raise AssertionError("apps stream fixed-step: no carried tokens")

    vad_pcm = _speech_then_silence(5)
    st = stream.StreamTranscriber(big, step_ms=0, audio_ctx=APPS_AUDIO_CTX)
    segs = timed("stream vad, audio_ctx 750", 3, lambda: st.feed_vad(
        vad_pcm[-2 * 16000:], vad_pcm), big)
    if not segs or big.exp_n_audio_ctx != APPS_AUDIO_CTX:
        raise AssertionError(f"apps stream vad: {segs}")

    cmd_pcm = full_pcm(3)
    text = timed("command, reference defaults (beam 5, t 0.4)", 3,
                 lambda: command.transcribe_utterance(big, cmd_pcm), big)
    elog(f"apps command heard {text!r}")
    wav = BUILD / "apps" / "noise.wav"
    wav.parent.mkdir(parents=True, exist_ok=True)
    wav.write_bytes(wav_bytes(int16_noise(APPS_MAIN_S, 70)))
    rs = timed("lsp unguided", APPS_MAIN_S, lambda: _lsp_session(
        lsp.serve, big, [{"jsonrpc": "2.0", "id": 1, "method": "unguided",
                          "params": {"file": str(wav)}}]), big)
    if not isinstance(rs[0]["result"]["transcription"], str):
        raise AssertionError(f"apps lsp unguided: {rs}")
    require_launches("apps large-v3", total, ("K1", "K3", "K5"))
    del big
    torch.cuda.empty_cache()

    # 2. small q5_1 with the colors words, pallas
    small_g = model_file("small", "q5_1", pieces=True)
    small = WhisperContext.from_file(str(small_g), cross_mode="pallas")
    reg = {"jsonrpc": "2.0", "id": 1, "method": "registerCommandset",
           "params": APPS_WORDS}
    rs = timed("lsp guided + unguided", 2 + APPS_MAIN_S,
               lambda: _lsp_session(lsp.serve, small, [
                   reg, {"jsonrpc": "2.0", "id": 2, "method": "guided",
                         "params": {"file": str(wav)}},
                   {"jsonrpc": "2.0", "id": 3, "method": "unguided",
                    "params": {"file": str(wav)}}]), small)
    if rs[1]["result"]["command_text"] not in APPS_WORDS:
        raise AssertionError(f"apps lsp guided: {rs}")
    elog(f"apps lsp guided chose {rs[1]['result']['command_text']!r}")
    grammar = grammar_from_gbnf(COLORS.read_text(), "root")
    if not isinstance(grammar, NativeGrammar):
        raise AssertionError("apps command: the native grammar engine did "
                             "not build")
    text = timed("command grammar (colors, beam 5, t 0.4)", 3,
                 lambda: command.transcribe_utterance(small, cmd_pcm,
                                                      grammar=grammar),
                 small)
    words = set(text.replace(",", " ").split()) - {"and"}
    if not words or not words <= {"red", "green", "blue", "yellow",
                                  "purple", "orange"}:
        raise AssertionError(f"apps command grammar: heard {text!r}")
    elog(f"apps command grammar heard {text!r}")
    require_launches("apps small", total, ("K1", "K3+mins", "K4"))
    del small
    torch.cuda.empty_cache()

    # the mains, each on its default device (the card)
    mains = {}
    for label, mod, argv in (
            ("stream main -nf", stream, ["-f", str(wav), "-nf"]),
            ("command main -f", command, ["-f", str(wav), "-mt", "16"])):
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(["-m", str(small_g), *argv])
        torch.cuda.synchronize()
        mains[label] = (time.perf_counter() - t0, read_counts())
        if rc != 0 or not out.getvalue().strip():
            raise AssertionError(f"apps {label}: exit {rc}, printed "
                                 f"{out.getvalue()!r}")
        elog(f"apps {label} printed {out.getvalue().strip()[:160]!r}")

    def lsp_main(ctx, stdin, stdout):
        saved = sys.stdin, sys.stdout
        sys.stdin = type("In", (), {"buffer": stdin})()
        sys.stdout = type("Out", (), {"buffer": stdout})()
        try:
            return lsp.main(["-m", str(small_g)])
        finally:
            sys.stdin, sys.stdout = saved

    reset_counts()
    t0 = time.perf_counter()
    rs = _lsp_session(lsp_main, None, [
        reg, {"jsonrpc": "2.0", "id": 2, "method": "guided",
              "params": {"file": str(wav)}}])
    torch.cuda.synchronize()
    mains["lsp main"] = (time.perf_counter() - t0, read_counts())
    for label, (wall, counts) in mains.items():
        elog(f"[{card_line}] apps {label} (small q5_1, load included): wall "
             f"{wall:.3f} s; launches {counts}")
        if counts["K1"] <= 0 or counts["K3"] <= 0:
            raise AssertionError(f"apps {label}: ran off the card ({counts})")
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    elog(f"[{card_line}] apps: the phase in "
         f"{time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def _lcg_noise(n: int) -> np.ndarray:
    """fill_noise() of tests/c_abi_ext.c (LCG, seed 12345)."""
    out = np.empty(n, np.float32)
    s = 12345
    for i in range(n):
        s = (s * 1664525 + 1013904223) & 0xFFFFFFFF
        out[i] = ((s >> 8) / float(1 << 24) - 0.5) * 0.2
    return out


def _run_c(label: str, argv, env, out_dir: Path) -> subprocess.Popen:
    """Start a C program with its output in files (stdout, stderr)."""
    out = open(out_dir / f"{label}.out", "w")
    err = open(out_dir / f"{label}.err", "w")
    proc = subprocess.Popen([str(a) for a in argv], env=env, stdout=out,
                            stderr=err, cwd=out_dir)
    out.close()
    err.close()
    return proc


def _wait_c(label: str, proc: subprocess.Popen, out_dir: Path) -> str:
    try:
        proc.wait(timeout=CAPI_C_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"capi {label}: no exit in {CAPI_C_TIMEOUT} s")
    out = (out_dir / f"{label}.out").read_text()
    if proc.returncode != 0:
        err = (out_dir / f"{label}.err").read_text()
        raise AssertionError(f"capi {label}: exit {proc.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    return out


def check_capi(card_line: str, big_file: Path) -> dict:
    """The phase "capi": whisper.h's surface on the card.
      1. the port's C ABI library (capi.library_path: build/whisper_tpu_torch/
         capi/libwhisper_tpu.so from whisper_tpu_torch/native/wtpu_capi.cpp)
         builds and exports every function of tests/golden/
         whisper_h_functions.txt
      2. examples/c_demo.c and tests/c_abi_ext.c, compiled with gcc against
         it, run at once (beside step 3) on the small q5_1 file with the
         colors words (on the card: their params say use_gpu): c_demo on
         CAPI_S s of raw f32 PCM, its SEG| lines equal to whisper_full in
         this process on the same file, PCM and params; c_abi_ext's lines
         checked as
         tests/test_cabi.py checks them, its in-struct grammar's segments
         equal to the Python GBNF path's here.  Their launches are made in
         their own processes and are not counted
      3. whisper_tpu_torch.capi in this process on path A's q5_0 file:
         whisper_pcm_to_mel, whisper_encode (K1), whisper_decode of a
         4-token prompt and then 8 single-token steps (K3 at M = 4 and 1),
         every logits row finite; the 12 tokens decoded at once as one
         prompt (K3 at M = 12) give the stepped rows within MODEL_TOL;
         then whisper_full and its accessors: K1 and K3 must launch
      4. whisper_tpu_torch.bench_tool.main as a user runs it: -m path A's
         file (Enc / Dec / Bch5 / PP: K1, K3 at M = 1, 5 and 256), -w 1,
         -w 2, and -w 3 --size large-v3 (random weights: K1); each table
         on stderr with the card's name and power limit.
    -> the phase's launch counts (in this process)."""
    import contextlib
    import io
    import os

    from whisper_tpu_torch import bench_tool, capi
    from whisper_tpu_torch.grammar import grammar_from_gbnf

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    lib = capi.library_path()
    log(f"capi: C ABI library in {time.perf_counter() - t0:.2f} s: {lib} "
        f"-> {os.readlink(lib)}")
    want = set((root / "tests" / "golden" / "whisper_h_functions.txt")
               .read_text().split())
    nm = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                        capture_output=True, text=True, check=True,
                        timeout=60).stdout
    missing = sorted(want - {line.split()[-1] for line in nm.splitlines()
                             if line.strip()})
    if missing:
        raise AssertionError(f"capi: the library lacks {missing}")
    log(f"capi: the library exports all {len(want)} whisper.h functions")

    # 2. the C programs, both at once, on the card
    out_dir = BUILD / "capi"
    out_dir.mkdir(parents=True, exist_ok=True)
    exes = {}
    for name, src in (("c_demo", root / "examples" / "c_demo.c"),
                      ("c_abi_ext", root / "tests" / "c_abi_ext.c")):
        exes[name] = out_dir / name
        subprocess.run(["gcc", str(src), f"-I{root / 'native'}",
                        f"-L{lib.parent}", "-lwhisper_tpu", "-o",
                        str(exes[name])], check=True, timeout=120)
    small_g = model_file("small", "q5_1", pieces=True)
    pcm = full_pcm(CAPI_S)
    raw = out_dir / "pcm.f32"
    pcm.tofile(raw)
    env = dict(os.environ, LD_LIBRARY_PATH=str(lib.parent),
               WHISPER_TPU_ROOT=str(root),
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    env.pop(capi.DEVICE_ENV, None)
    log("capi: c_demo and c_abi_ext launch the kernels in their own "
        "processes: those launches are not counted here")
    total: dict = {}

    def add(counts):
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})

    def greedy():
        p = capi.whisper_full_default_params(capi.WHISPER_SAMPLING_GREEDY)
        p.print_progress = False
        p.temperature_inc = 0.0
        return p

    t_c = time.perf_counter()
    procs = {"c_demo": _run_c("c_demo", [exes["c_demo"], small_g, raw], env,
                              out_dir),
             "c_abi_ext": _run_c("c_abi_ext", [exes["c_abi_ext"], small_g],
                                 env, out_dir)}
    try:
        # 3. the module in process on path A's file, while the C
        # programs run
        reset_counts()
        t0 = time.perf_counter()
        ctx = capi.whisper_init_from_file_with_params(
            str(big_file), capi.whisper_context_default_params())
        torch.cuda.synchronize()
        elog(f"[{card_line}] capi large-v3 load: "
             f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        if (capi.whisper_pcm_to_mel(ctx, pcm, len(pcm)) != 0
                or capi.whisper_encode(ctx, 0) != 0):
            raise AssertionError("capi: whisper_pcm_to_mel, whisper_encode")
        toks = [ctx.token_sot(), ctx.token_lang(0), ctx.token_transcribe(),
                ctx.token_beg()]
        if capi.whisper_decode(ctx, toks, len(toks), 0) != 0:
            raise AssertionError("capi: whisper_decode of the prompt")
        rows = [capi.whisper_get_logits(ctx)]
        for _ in range(8):
            nxt = int(np.argmax(rows[-1][-1][:ctx.token_eot()]))
            if capi.whisper_decode(ctx, [nxt], 1, len(toks)) != 0:
                raise AssertionError("capi: whisper_decode of a step")
            toks.append(nxt)
            rows.append(capi.whisper_get_logits(ctx))
        stepped = np.concatenate(rows)
        torch.cuda.synchronize()
        t_raw = time.perf_counter() - t0
        if stepped.shape != (len(toks), ctx.n_vocab()) \
                or not np.isfinite(stepped).all():
            raise AssertionError(f"capi: logits {stepped.shape}, finite "
                                 f"{np.isfinite(stepped).all()}")
        if capi.whisper_decode(ctx, toks, len(toks), 0) != 0:
            raise AssertionError("capi: whisper_decode of the sequence")
        forced = capi.whisper_get_logits(ctx)
        rel = float(np.abs(forced - stepped).max() / np.abs(stepped).max())
        log(f"capi whisper_decode: {len(toks)} rows, teacher-forced against "
            f"stepped rel err {rel:.3e} (tol {MODEL_TOL}); tokens {toks}")
        if rel > MODEL_TOL:
            raise AssertionError(f"capi teacher forcing: {rel:.3e} > "
                                 f"{MODEL_TOL}")
        t0 = time.perf_counter()
        if capi.whisper_full(ctx, greedy(), pcm, len(pcm)) != 0:
            raise AssertionError("capi: whisper_full on path A's file")
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        n = capi.whisper_full_n_segments(ctx)
        segs = [(capi.whisper_full_get_segment_t0(ctx, i),
                 capi.whisper_full_get_segment_t1(ctx, i),
                 capi.whisper_full_get_segment_text(ctx, i),
                 [capi.whisper_full_get_token_p(ctx, i, j)
                  for j in range(capi.whisper_full_n_tokens(ctx, i))])
                for i in range(n)]
        check_segments("capi whisper_full", [ctx.result_all])
        if not all(t0_ <= t1_ for t0_, t1_, _, _ in segs):
            raise AssertionError(f"capi: segment times {segs}")
        counts = read_counts()
        elog(f"[{card_line}] capi in process (large-v3 q5_0): mel + "
             f"encode + prompt + 8 steps {t_raw:.3f} s; whisper_full of "
             f"{CAPI_S} s {t_full:.3f} s, {n} segments; launches {counts}")
        require_launches("capi in process", counts, ("K1", "K3"))
        add(counts)
        del ctx
        torch.cuda.empty_cache()
    except BaseException:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        raise
    outs = {name: _wait_c(name, proc, out_dir)
            for name, proc in procs.items()}
    elog(f"[{card_line}] capi: c_demo and c_abi_ext (small q5_1, run at "
         f"once, beside the in-process run) in "
         f"{time.perf_counter() - t_c:.1f} s")

    # 2 (continued). the C programs' output against this process
    reset_counts()
    ctx = capi.whisper_init_from_file_with_params(
        str(small_g), capi.whisper_context_default_params())
    if ctx.device.type != "cuda":
        raise AssertionError(f"capi: a default context on {ctx.device}")
    out = outs["c_demo"]
    c_segs = [line.split("|")[1:4] for line in out.splitlines()
              if line.startswith("SEG|")]
    if capi.whisper_full(ctx, greedy(), pcm, len(pcm)) != 0:
        raise AssertionError("capi: whisper_full failed")
    py_segs = [[str(s.t0), str(s.t1), s.text] for s in ctx.result_all]
    if not c_segs or c_segs != py_segs or "callback_segments=" not in out:
        raise AssertionError(f"capi c_demo: {c_segs} != in process "
                             f"{py_segs}\n{out[-2000:]}")
    log(f"capi c_demo: {len(c_segs)} segments equal to whisper_full in "
        f"process; {out.splitlines()[0]}")

    out = outs["c_abi_ext"]
    lines = dict(line.split("|", 1) for line in out.splitlines()
                 if "|" in line and not line.startswith("GSEG|"))
    hp = ctx.hparams
    want_lines = {"MODEL": f"{hp.n_vocab}|{hp.n_audio_layer}|"
                           f"{hp.n_text_layer}|{hp.n_mels}|{hp.model_type}",
                  "LANG": "99|en|english", "NLEN": "99", "NLEN_ST": "99",
                  "LOGITS": f"{hp.n_vocab}|ok", "LOGITS_ST": "ok",
                  "TIMINGS": "ok", "LOGS": "captured", "ABORT": "1|0"}
    bad = {k: lines.get(k) for k, v in want_lines.items()
           if lines.get(k) != v}
    encb = [int(x) for x in lines.get("ENCB", "0|1|-1").split("|")]
    lfilt = lines.get("LFILT", "0|bad").split("|")
    gram = lines.get("GRAMMAR", "bad|0").split("|")
    if (bad or "DONE" not in out or int(lines.get("BASE_SEGS", 0)) <= 0
            or encb[0] != 1 or encb[1] != 0 or encb[2] < 0
            or int(lfilt[0]) <= 0 or lfilt[1] != "ok" or gram[0] != "ok"
            or int(gram[1]) <= 0):
        raise AssertionError(f"capi c_abi_ext: {bad}\n{out[-3000:]}")
    p = greedy()
    p.greedy.best_of = 1
    p.grammar_rules = grammar_from_gbnf("root ::= [a-z ]*")
    p.grammar_penalty = 100.0
    noise = _lcg_noise(16000 * 8)
    if capi.whisper_full(ctx, p, noise, len(noise)) != 0:
        raise AssertionError("capi: whisper_full with the grammar failed")
    c_gsegs = [line[len("GSEG|"):] for line in out.splitlines()
               if line.startswith("GSEG|")]
    py_gsegs = [s.text for s in ctx.result_all]
    if c_gsegs != py_gsegs:
        raise AssertionError(f"capi c_abi_ext grammar: {c_gsegs} != in "
                             f"process {py_gsegs}")
    log(f"capi c_abi_ext: every check passed; {len(c_gsegs)} grammar "
        f"segments, equal to the GBNF path in process: "
        f"{[t[:40] for t in c_gsegs[:3]]}")
    del ctx
    add(read_counts())

    # 4. whisper-bench
    for argv, need in ((["-m", str(big_file)], ("K1", "K3")),
                       (["-w", "1"], ()), (["-w", "2"], ()),
                       (["-w", "3", "--size", "large-v3"], ("K1",))):
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench_tool.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if rc != 0 or not out.getvalue().strip():
            raise AssertionError(f"whisper-bench {argv}: exit {rc}, printed "
                                 f"{out.getvalue()!r}")
        label = " ".join(Path(a).name for a in argv)
        elog(f"[{card_line}] whisper-bench {label} ({wall:.1f} s, load "
             f"included; launches {counts}):\n" + out.getvalue().rstrip())
        require_launches(f"whisper-bench {label}", counts, need)
        add(counts)
        torch.cuda.empty_cache()
    elog(f"[{card_line}] capi: the phase in "
         f"{time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def _mesh_forced(ctx, bt, seqs, n_prompt: int):
    """Each stream's first window teacher-forced over its prompt and
    emitted tokens (`seqs`, padded with EOT), for this rank's rows: ->
    (rows, logits (R, T, V) f32, the filter chain's log-probs at each
    emitted step (R, n_steps, V) f32), on the host.  The streams' mel
    comes from bt.last_states at seek 0, encoded as the batch encodes
    (this rank's rows on a data-parallel mesh)."""
    from whisper_tpu_torch.decode.filters import (FilterConsts,
                                                  make_process_logits)
    from whisper_tpu_torch.models import whisper as wm
    from whisper_tpu_torch.parallel.mesh import row_slice
    n = len(seqs)
    sl = row_slice(bt.mesh, n) or slice(0, n)
    dev = ctx.device
    (kq, ks), (vq, vs) = bt._encode_slots(bt.last_states, list(range(n)),
                                          None, seeks=np.zeros((n,), np.int64))
    T = max(len(s) for s in seqs)
    toks = np.full((n, T), ctx.vocab.token_eot, np.int64)
    for r, s in enumerate(seqs):
        toks[r, :len(s)] = s
    toks = torch.from_numpy(toks[sl]).to(dev)
    R = toks.shape[0]
    process = make_process_logits(
        FilterConsts.from_vocab(ctx.vocab, ctx.config.n_audio_ctx), bt.opts,
        device=dev)
    f = torch.zeros((R,), dtype=torch.bool, device=dev)
    lps = []
    with torch.no_grad():
        logits, _, _ = wm.decode_prompt(
            ctx.params, toks, torch.arange(T, device=dev), ("q8", kq, ks),
            ("q8", vq, vs), ctx.config.n_text_head,
            self_mask=wm.make_causal_mask(T, device=dev),
            compute_dtype=ctx.compute_dtype)
        for j in range(T - n_prompt + 1):
            _, lp, _ = process(
                logits[:, n_prompt - 1 + j].float(), 0.0,
                is_initial=torch.full((R,), j == 0, device=dev),
                last_was_ts=f, penult_was_ts=~f, has_ts=f,
                seek_delta=torch.zeros((R,), dtype=torch.int32, device=dev))
            lps.append(lp.cpu())
    return (list(range(n))[sl], logits.float().cpu(),
            torch.stack(lps, dim=1))


def _mesh_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One of the phase "mesh"'s two ranks on the one card (gloo): the
    large-v3 context's mesh=None run, then BatchTranscriber over each of
    MESH_SHAPES, each held against it; pickles its results (or the
    traceback) to out_dir."""
    import pickle
    import traceback
    try:
        out = _mesh_rank_body(rank, world, rdv)
    except Exception:  # noqa: BLE001 - reported by the parent
        out = {"error": traceback.format_exc()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


def _mesh_rank_body(rank: int, world: int, rdv: str) -> dict:
    import torch.distributed as dist
    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch.audio.mel import full_f32_matmuls
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    from whisper_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    full_f32_matmuls()
    record_launches(_build.library())
    streams = [int16_noise(MESH_S, 300 + i) for i in range(N_STREAMS)]
    p = serving_params()
    base = WhisperContext.from_random("large-v3", seed=0,
                                      cross_mode="einsum_q8")
    whole = base.params
    t0 = time.perf_counter()
    bt = BatchTranscriber(base, batch_size=N_STREAMS, params=p)
    ref_segs = bt.transcribe(streams)
    torch.cuda.synchronize()
    out = {"walls": {"mesh=None": time.perf_counter() - t0}, "counts": {},
           "checks": {}, "tokens": {}}
    check_segments("mesh=None", ref_segs)
    ref_tok = [[t.id for s in segs for t in s.tokens] for segs in ref_segs]
    n_prompt = len(bt.prompt_init)
    seqs = [list(bt.prompt_init) + toks[:-1] for toks in ref_tok]
    _, ref_logits, ref_lp = _mesh_forced(base, bt, seqs, n_prompt)
    out["tokens"]["mesh=None"] = ref_tok
    scale = float(ref_logits.abs().max())

    for n_data, n_model in MESH_SHAPES:
        name = f"{n_data}x{n_model}"
        mesh = make_mesh(n_data, n_model, device="cuda:0", backend="gloo",
                         init_method=f"file://{rdv}", world_size=world,
                         rank=rank)
        ctx = WhisperContext(config=base.config, vocab=base.vocab,
                             filters=base.filters, params=whole,
                             cross_mode="einsum_q8")
        dist.barrier()
        reset_counts()
        LAUNCHED["on"] = True
        t0 = time.perf_counter()
        bt = BatchTranscriber(ctx, batch_size=N_STREAMS, params=p, mesh=mesh)
        segs = bt.transcribe(streams)
        torch.cuda.synchronize()
        out["walls"][name] = time.perf_counter() - t0
        LAUNCHED["on"] = False
        out["counts"][name] = read_counts()
        check_segments(f"mesh {name}", segs)
        toks = [[t.id for s in ss for t in s.tokens] for ss in segs]
        out["tokens"][name] = toks
        rows, logits, lp = _mesh_forced(ctx, bt, seqs, n_prompt)
        # logits: within MESH_TOL of the unsharded ones
        err = float((logits - ref_logits[rows]).abs().max())
        if not torch.isfinite(logits).all() or err > MESH_TOL:
            raise AssertionError(f"mesh {name}: teacher-forced logits "
                                 f"{err:.4g} from mesh=None (tol {MESH_TOL})")
        decided, held = [], []
        for i, r in enumerate(rows):
            tok = ref_tok[r]
            n_dec, n_held, free = 0, None, True
            for j, t in enumerate(tok):
                lr, lm = ref_lp[r, j].clone(), lp[i, j].clone()
                gap_ref = float(lr[t] - lr.index_fill(0, torch.tensor(t),
                                                      -float("inf")).max())
                gap = float(lm[t] - lm.index_fill(0, torch.tensor(t),
                                                  -float("inf")).max())
                if gap_ref > 2 * MESH_TOL:
                    n_dec += 1
                    if not gap > 0:
                        raise AssertionError(
                            f"mesh {name} stream {r} step {j}: another token"
                            f" teacher-forced (gap {gap:.4g}, mesh=None "
                            f"{gap_ref:.4g})")
                    if free and (j >= len(toks[r]) or toks[r][j] != t):
                        raise AssertionError(
                            f"mesh {name} stream {r} step {j}: free-running"
                            " token differs at a decided step")
                elif free:
                    free, n_held = False, j
            decided.append(n_dec)
            held.append(len(tok) if n_held is None else n_held)
        out["checks"][name] = {"logits_max_abs_err": err,
                               "logits_scale": scale, "rows": rows,
                               "decided": decided, "held": held,
                               "of": [len(ref_tok[r]) for r in rows]}
        if (n_data, n_model) == (1, 2):
            dist.barrier()
            reset_counts()
            LAUNCHED["on"] = True
            out["engine"] = _mesh_engine(ctx, p, streams, segs)
            LAUNCHED["on"] = False
            out["counts"]["1x2 engine"] = read_counts()
        del ctx, bt
        torch.cuda.empty_cache()
        if (n_data, n_model) == (1, 2):
            dist.barrier()
            LAUNCHED["on"] = True
            out["server"] = _mesh_server(mesh, streams)
            LAUNCHED["on"] = False
            out["counts"]["1x2 server"] = out["server"].pop("counts")
    out["shapes"] = {k: sorted(v) for k, v in LAUNCHED["shapes"].items()}
    dist.destroy_process_group()
    return out


def _mesh_engine(ctx, p, streams, want) -> dict:
    """ContinuousBatcher(batch_size=N_STREAMS) over the 1 x 2 context, on
    both ranks.  Rank 0 idles MESH_IDLE_S, then takes `streams` together
    (the iteration hook holds the engine until they are queued), so its
    first iteration holds BatchTranscriber's rows: their segments must
    equal `want` (the 1 x 2 transcribe's) token for token.  MESH_LATE more
    streams arrive while those decode and must finish with no error.  The
    follower replays the plans and must refuse a request.  -> walls, the
    iteration count, the plan digests at each iteration, the plan sync's
    host seconds (sync_s, n_idle) and, on rank 0, the late streams'
    iter_joined."""
    import threading
    from whisper_tpu_torch.parallel.batch import ContinuousBatcher
    late = [int16_noise(MESH_S, 320 + i) for i in range(MESH_LATE)]
    t0 = time.perf_counter()
    eng = ContinuousBatcher(ctx, batch_size=N_STREAMS, params=p)
    digests = []

    def record(n):   # the digest of iterations 0..n-1
        if n and (not digests or digests[-1][0] != n):
            digests.append((n, eng.plan_digest))

    out = {}
    try:
        if not eng.leader:
            eng.iteration_hook = record
            try:
                eng.submit_async(streams[0])
                raise AssertionError("mesh engine: a follower took a request")
            except RuntimeError:
                pass
        else:
            time.sleep(MESH_IDLE_S)   # the engine idles: empty plans
            parked, go = threading.Event(), threading.Event()

            def hook(n):
                record(n)
                parked.set()
                go.wait(timeout=600)

            eng.iteration_hook = hook
            if not parked.wait(timeout=60):
                raise AssertionError("mesh engine: the engine never reached "
                                     "its iteration hook")
            t1 = time.perf_counter()
            jobs = [eng.submit_async(pcm) for pcm in streams]
            go.set()
            # the first N_STREAMS fill the first iteration's rows; the late
            # ones come once that iteration has its rows
            while jobs[-1].iter_joined is None and not jobs[-1].done.is_set():
                time.sleep(0.005)
            late_jobs = [eng.submit_async(pcm) for pcm in late]
            _wait_jobs("mesh engine", jobs)
            out["wall_first"] = time.perf_counter() - t1
            _wait_jobs("mesh engine late", late_jobs)
            got = [j.st.result_all for j in jobs]
            check_segments("mesh engine", got)
            check_segments("mesh engine late",
                           [j.st.result_all for j in late_jobs])
            if _token_ids(got) != _token_ids(want):
                raise AssertionError("mesh engine: segments differ from the "
                                     "1 x 2 BatchTranscriber's")
            out["late_joined"] = [j.iter_joined for j in late_jobs]
            if min(out["late_joined"]) < 1:
                raise AssertionError("mesh engine: a late stream joined the "
                                     "first iteration")
    finally:
        eng.close()
    torch.cuda.synchronize()
    record(eng.n_iterations)
    out.update(wall=time.perf_counter() - t0, iterations=eng.n_iterations,
               digests=digests, sync_s=dict(eng.conductor.sync_s),
               n_idle=eng.conductor.n_idle)
    if eng.thread.is_alive():
        raise AssertionError("mesh engine: close() left the engine running")
    return out


def _server_params(fields: dict):
    """The params the server's Handler makes for a /inference json or a
    /stream request with these form fields."""
    from whisper_tpu_torch import full_default_params
    from whisper_tpu_torch.server import _apply_request_params
    p = full_default_params()
    p.print_progress = False
    p.greedy.best_of = 2
    p.no_context = False
    _apply_request_params(p, {k: v.encode() for k, v in fields.items()})
    if p.max_len == 0:
        p.max_len = 60
    return p


def _mesh_server(mesh, streams) -> dict:
    """The port's server over the 1 x 2 mesh, on both ranks, with a
    context of its own: large-v3's widths cut to MESH_SERVER_LAYERS +
    MESH_SERVER_LAYERS layers (seed 0, dense bf16, einsum_q8), attached to
    `mesh`.  First the references, on both ranks: BatchTranscriber
    .transcribe of streams 0 and 1 with whisper-server's default params
    (timestamps and the temperature ladder on), and full() of stream 2
    with a second signature (MESH_SERVER_SERIAL).  Then every rank
    installs the server (--batch N_STREAMS); rank 1 checks that its worker
    refuses a request and follows; rank 0 serves Handler on loopback and
    sends streams 0 and 1 at once through /inference (json) and /stream
    (the conductor's plan hook holds the pair's engine until both are
    queued, so they share its first iteration, as transcribe's rows do),
    then, with the worker's MAX_ENGINES at 1, stream 2 through
    /inference: the serial full() over the mesh.  Each request's segments
    (recorded on rank 0 from the worker) must equal its reference token
    for token, and its body their json or SSE events; then rank 0 closes
    the worker, whose close plan ends rank 1's follow().  -> walls, the
    plans run (by op), their digest, rank 0's sync seconds and the
    kernel launches of the server's run."""
    import copy
    import socket
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    import whisper_tpu_torch.server as srv
    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch.models.whisper import MODEL_DIMS
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    dims = list(MODEL_DIMS["large-v3"])
    dims[4] = dims[8] = MESH_SERVER_LAYERS
    t0 = time.perf_counter()
    ctx = WhisperContext.from_random("large-v3", seed=0,
                                     cross_mode="einsum_q8", dims=tuple(dims))
    BatchTranscriber(ctx, batch_size=N_STREAMS, mesh=mesh)
    torch.cuda.synchronize()
    wall_context = time.perf_counter() - t0
    pcm = [s.astype(np.float32) / 32768.0 for s in streams[:3]]
    p_pair = _server_params(MESH_SERVER_FIELDS)
    p_serial = _server_params({**MESH_SERVER_FIELDS, **MESH_SERVER_SERIAL})
    t0 = time.perf_counter()
    want = BatchTranscriber(ctx, batch_size=N_STREAMS,
                            params=copy.deepcopy(p_pair)).transcribe(pcm[:2])
    st = ctx.init_state()
    if ctx.full(copy.deepcopy(p_serial), pcm[2], state=st) != 0:
        raise AssertionError("mesh server: the reference full() failed")
    want.append(st.result_all)
    torch.cuda.synchronize()
    out = {"wall_context": wall_context,
           "wall_reference": time.perf_counter() - t0}

    reset_counts()
    t0 = time.perf_counter()
    srv.install(ctx, batch=N_STREAMS, warmup=False)
    worker = srv.STATE.batcher
    cond = worker.conductor
    ops = {}

    def count(plan):
        op = "close" if plan is None else plan["op"]
        ops[op] = ops.get(op, 0) + 1

    if not cond.leader:
        cond.plan_hook = count
        try:
            worker.submit(pcm[0], copy.deepcopy(p_pair))
            raise AssertionError("mesh server: a follower took a request")
        except RuntimeError:
            pass
        srv.follow()
    else:
        got = {}
        submit = cond.submit

        def record(x, params, on_segment=None):
            segs, lid = submit(x, params, on_segment)
            got[next(i for i in range(3) if len(x) == len(pcm[i])
                     and np.array_equal(x, pcm[i]))] = segs
            return segs, lid

        def hold(plan):
            count(plan)
            # the pair's engine: wait for the second request
            if plan is not None and plan["op"] == "engine":
                end = time.monotonic() + 60
                while cond.inbox.empty() and time.monotonic() < end:
                    time.sleep(0.005)

        cond.submit, cond.plan_hook = record, hold
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        httpd = ThreadingHTTPServer(("127.0.0.1", port), srv.Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        wavs = [wav_bytes(s) for s in streams[:3]]
        try:
            t1 = time.perf_counter()
            with ThreadPoolExecutor(2) as pool:
                # /inference first: the engine's rows in transcribe's order
                pair = [pool.submit(http, port, "/inference",
                                    MESH_SERVER_FIELDS, wavs[0])]
                time.sleep(0.2)
                pair.append(pool.submit(http, port, "/stream",
                                        MESH_SERVER_FIELDS, wavs[1]))
                res = [f.result() for f in pair]
            out["wall_pair"] = time.perf_counter() - t1
            worker.MAX_ENGINES = 1
            res.append(http(port, "/inference",
                            {**MESH_SERVER_FIELDS, **MESH_SERVER_SERIAL},
                            wavs[2]))
            out["wall_serial"] = res[2][3]
            out["request_s"] = [r[3] for r in res]
        finally:
            httpd.shutdown()
            httpd.server_close()
            worker.close()
        for i, (status, ctype, body, _) in enumerate(res):
            if status != 200:
                raise AssertionError(f"mesh server request {i}: HTTP "
                                     f"{status}: {body[:500]!r}")
        check_segments("mesh server", [got[i] for i in range(3)])
        if _token_ids([got[i] for i in range(3)]) != _token_ids(want):
            raise AssertionError("mesh server: segments differ from the "
                                 "1 x 2 context's run directly")
        for i in (0, 2):
            if json.loads(res[i][2])["text"] != "".join(
                    s.text + "\n" for s in want[i]):
                raise AssertionError(f"mesh server request {i}: the json "
                                     "body is not its segments' text")
        events = [json.loads(ev.removeprefix("data: "))
                  for ev in res[1][2].decode().split("\n\n")[:-2]]
        if events != [{"start": s.t0 / 100.0, "end": s.t1 / 100.0,
                       "text": s.text} for s in want[1]]:
            raise AssertionError("mesh server: the /stream events are not "
                                 "its segments")
        if (ops.get("engine"), ops.get("full")) != (1, 1):
            raise AssertionError(f"mesh server: plans {ops} (one engine, "
                                 "one serial full() expected)")
        out["tokens"] = [sum(len(s.tokens) for s in segs) for segs in want]
        out["segments"] = [len(segs) for segs in want]
    torch.cuda.synchronize()
    out.update(wall=time.perf_counter() - t0, counts=read_counts(),
               ops=ops, n_plans=cond.n_plans, digest=cond.plan_digest,
               sync_s=dict(cond.sync_s), n_idle=cond.n_idle)
    if cond.thread is not None and cond.thread.is_alive():
        raise AssertionError("mesh server: close() left the conductor "
                             "running")
    return out


def _mesh_dryrun(rdv: str) -> dict:
    """The one-rank NCCL mesh, in this process: dryrun_multichip on
    cuda:0.  -> its backend, step counts and wall."""
    import torch.distributed as dist
    from whisper_tpu_torch.parallel.mesh import dryrun_multichip, make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh(device="cuda:0", init_method=f"file://{rdv}",
                     world_size=1, rank=0)
    try:
        out = {"backend": mesh.backend, "steps": dryrun_multichip(mesh)}
    finally:
        dist.destroy_process_group()
    out["wall"] = time.perf_counter() - t0
    return out


def _spawn_wait(label: str, procs, out_dir: Path, names) -> list:
    """Start `procs`, wait for them (MESH_TIMEOUT in all, then terminate)
    and load each one's pickle (out_dir/{name}.pkl)."""
    import pickle
    for proc in procs:
        proc.start()
    end = time.monotonic() + MESH_TIMEOUT
    try:
        for proc in procs:
            proc.join(max(0.0, end - time.monotonic()))
        if any(proc.is_alive() for proc in procs):
            raise AssertionError(f"{label}: ranks still running after "
                                 f"{MESH_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    results = []
    for proc, name in zip(procs, names):
        path = out_dir / f"{name}.pkl"
        if not path.is_file():
            raise AssertionError(f"{label} {name}: exit {proc.exitcode}, "
                                 "no result")
        res = pickle.loads(path.read_bytes())
        if "error" in res:
            raise AssertionError(f"{label} {name}:\n{res['error']}")
        results.append(res)
    return results


def check_mesh(card_line: str) -> dict:
    """The phase "mesh": parallel/mesh.py on the one card.  Two spawned
    ranks over gloo (NCCL refuses two ranks on one device) build
    large-v3's random-weight context (seed 0, dense bf16, einsum_q8) and
    run BatchTranscriber on N_STREAMS int16 streams of MESH_S s at
    batch_size N_STREAMS, greedy with the serving settings: mesh=None,
    then over 1 x 2 (tensor parallel: K1 at 10 heads, K2 at 10 heads)
    and 2 x 1 (data parallel: 2 rows a rank).  Each mesh run is held
    against mesh=None: the teacher-forced logits of each stream's first
    window within MESH_TOL, the same winner teacher-forced, and the same
    free-running tokens, at every step whose mesh=None top-two margin of
    the filtered log-probs exceeds 2 x MESH_TOL (each logit may move by
    MESH_TOL).  After the 1 x 2 run both ranks run ContinuousBatcher over
    the same context (_mesh_engine): rank 0's segments equal to the 1 x 2
    transcribe's, both ranks in lockstep (iterations, plan digests), each
    through K1 and K2; then the server over 1 x 2 (_mesh_server, on a
    context of its own cut to MESH_SERVER_LAYERS + MESH_SERVER_LAYERS
    layers): its responses equal to that context run directly, both
    ranks' plans equal, each rank through K1 and K2.  Then this process, one rank over
    NCCL, runs dryrun_multichip at float32.
    Walls and checks go to stderr.  -> the launch counts of the mesh runs
    (both ranks, both meshes); their launch shapes join LAUNCHED."""
    import multiprocessing
    import shutil
    spawn = multiprocessing.get_context("spawn")
    out_dir = BUILD / "mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    ranks = _spawn_wait(
        "mesh", [spawn.Process(target=_mesh_rank,
                               args=(r, 2, str(out_dir / "rdv"),
                                     str(out_dir)))
                 for r in range(2)], out_dir, ["rank0", "rank1"])
    wall_gloo = time.perf_counter() - t0
    counts = {}
    for r, res in enumerate(ranks):
        for name, c in res["counts"].items():
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        for key, shapes in res["shapes"].items():
            for shape in shapes:
                LAUNCHED["shapes"].setdefault(key, set()).add(tuple(shape))
                LAUNCHED["by_phase"].setdefault("mesh", {}).setdefault(
                    key, set()).add(tuple(shape))
        elog(f"[{card_line}] mesh rank {r}: walls (s) "
             + json.dumps({k: round(v, 3) for k, v in res["walls"].items()})
             + "; checks " + json.dumps(res["checks"])
             + "; launches " + json.dumps(res["counts"]))
    for name in ("1x2", "2x1"):
        if ranks[0]["tokens"][name] != ranks[1]["tokens"][name]:
            raise AssertionError(f"mesh {name}: the ranks' segments differ")
    # the engine over 1 x 2: the ranks in lockstep, each through K1 and K2
    lead, follow = (res["engine"] for res in ranks)
    if (lead["iterations"], lead["digests"]) != (follow["iterations"],
                                                 follow["digests"]):
        raise AssertionError(f"mesh engine: the ranks' iterations or plan "
                             f"digests differ: {lead['digests']} vs "
                             f"{follow['digests']}")
    for r, res in enumerate(ranks):
        require_launches(f"mesh engine rank {r}", res["counts"]["1x2 engine"],
                         ("K1", "K2"))
    sync = lead["sync_s"]
    elog(f"[{card_line}] mesh engine (1 x 2, batch {N_STREAMS}): "
        f"{N_STREAMS} x {MESH_S} s equal to the 1 x 2 transcribe token for "
        f"token in {lead['wall_first']:.3f} s, {MESH_LATE} late streams "
        f"joined at iterations {lead['late_joined']}; {lead['iterations']} "
        f"iterations, digests equal on both ranks; on rank 0 an iteration's "
        f"plan broadcast {1e3 * sync['plan'] / lead['iterations']:.3f} ms, "
        f"its two failure flags (the follower's wait included) "
        f"{1e3 * sync['flags'] / lead['iterations']:.3f} ms, an idle "
        f"wakeup's empty plan "
        f"{1e3 * sync['idle'] / max(1, lead['n_idle']):.3f} ms "
        f"({lead['n_idle']} wakeups); the run {lead['wall']:.2f} s")
    if lead["n_idle"] < 4:
        raise AssertionError(f"mesh engine: {lead['n_idle']} idle plans in "
                             f"{MESH_IDLE_S} s")
    # the server over 1 x 2: the ranks ran the same plans (the plan hook,
    # set once install() has started the conductors, may miss a first
    # idle plan), each through K1 and K2
    lead, follow = (res["server"] for res in ranks)
    for r in (lead, follow):
        r["busy"] = {k: v for k, v in r["ops"].items() if k != "idle"}
    for key in ("n_plans", "digest", "busy"):
        if lead[key] != follow[key]:
            raise AssertionError(f"mesh server: the ranks' {key} differ: "
                                 f"{lead[key]} vs {follow[key]}")
    for r, res in enumerate(ranks):
        require_launches(f"mesh server rank {r}",
                         res["counts"]["1x2 server"], ("K1", "K2"))
    sync = lead["sync_s"]
    elog(f"[{card_line}] mesh server (1 x 2, --batch {N_STREAMS}, "
         f"{MESH_SERVER_LAYERS} + {MESH_SERVER_LAYERS} layers, the context "
         f"{lead['wall_context']:.3f} s): /inference + /stream of {MESH_S} s "
         f"at once {lead['wall_pair']:.3f} s (each "
         f"{lead['request_s'][0]:.3f} / {lead['request_s'][1]:.3f} s), the "
         f"serial full() of a second signature {lead['wall_serial']:.3f} s; "
         f"segments {lead['segments']}, tokens {lead['tokens']}, equal to "
         f"the context run directly (references "
         f"{lead['wall_reference']:.3f} s); plans {lead['ops']}"
         f" ({lead['n_plans']}), digests equal on both ranks; rank 0's sync "
         f"(s): plans {sync['plan']:.4f}, failure flags {sync['flags']:.4f},"
         f" idle plans {sync['idle']:.4f} ({lead['n_idle']}); the run "
         f"{lead['wall']:.2f} s; launches rank 0 "
         f"{ranks[0]['counts']['1x2 server']}, rank 1 "
         f"{ranks[1]['counts']['1x2 server']}")
    dry = _mesh_dryrun(str(out_dir / "rdv_nccl"))
    if dry["backend"] != "nccl" or min(dry["steps"].values()) <= 0:
        raise AssertionError(f"mesh dryrun: {dry}")
    elog(f"[{card_line}] mesh: gloo ranks {wall_gloo:.2f} s, nccl dryrun "
         f"{dry['wall']:.2f} s (steps {dry['steps']}); launches {counts}; "
         "shapes "
         + json.dumps({k: sorted(list(s) for s in v) for k, v in
                       LAUNCHED["by_phase"].get("mesh", {}).items()}))
    require_launches("mesh", counts, ("K1", "K2"))
    return counts


def front_end(card_line: str, params, cfg):
    """Path D: MEL_S s of PCM through log_mel_pallas (K7); large-v3 encode
    of the first window at B = 1 in each attn_impl, held against "pallas"
    and against "einsum" (plain torch, no kernel) and timed;
    cross_kv_q8(enc_layout="bdt") from encode(out_layout="bdt") against
    the btd route.  -> the kernel launch counts."""
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.audio.mel import pad_audio
    from whisper_tpu_torch.models import whisper as wm
    from whisper_tpu_torch.ops.mel_pallas import log_mel_pallas

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    padded = torch.from_numpy(pad_audio(mel_pcm(MEL_S))[0]).cuda()
    filters = mel_filterbank(cfg.n_mels)
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        mel = log_mel_pallas(padded, filters)
        torch.cuda.synchronize()
        mel_s = time.perf_counter() - t0
        if not torch.isfinite(mel).all():
            raise AssertionError("path D: non-finite log-mel")
        window = mel[None, :2 * cfg.n_audio_ctx]
        log(f"[{card_line}] path D: log_mel_pallas of {MEL_S} s -> "
            f"{tuple(mel.shape)} in {mel_s * 1e3:.3f} ms (first call); "
            f"window {tuple(window.shape)}")
        outs, times = {}, {}
        for impl in ("einsum", "pallas", "pallas_dt", "pallas_pf",
                     "pallas_btd", "flash"):
            walls = []
            for _ in range(1 + ENCODE_RUNS):   # the first call warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[impl] = wm.encode(params, window, n_head=cfg.n_audio_head,
                                       attn_impl=impl)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            times[impl] = statistics.median(walls[1:])
            if not torch.isfinite(outs[impl]).all():
                raise AssertionError(f"path D: encode {impl} non-finite")
        for impl, out in outs.items():
            errs = {ref: rel(out, outs[ref]) for ref in ("pallas", "einsum")}
            log(f"[{card_line}] path D: encode large-v3 B=1 {impl}: "
                f"{times[impl] * 1e3:.3f} ms (median of {ENCODE_RUNS}), "
                f"rel err vs pallas "
                f"{errs['pallas']:.3e}, vs einsum {errs['einsum']:.3e} "
                f"(tol {ENCODE_TOL})")
            for ref, err in errs.items():
                if err > ENCODE_TOL:
                    raise AssertionError(f"path D: encode {impl} vs {ref} "
                                         f"{err:.3e} > {ENCODE_TOL}")
        bdt = wm.encode(params, window, n_head=cfg.n_audio_head,
                        attn_impl="pallas_dt", out_layout="bdt")
        (kq, ks), (vq, vs) = wm.cross_kv_q8(params, bdt,
                                            n_head=cfg.n_text_head,
                                            enc_layout="bdt")
        (kq2, ks2), (vq2, vs2) = wm.cross_kv_q8(
            params, outs["pallas_dt"], n_head=cfg.n_text_head)
        for name, a, b in (("K", (kq, ks), (kq2, ks2)),
                           ("V", (vq, vs), (vq2, vs2))):
            err = rel(a[0].float() * a[1][..., None, :],
                      b[0].float() * b[1][..., None, :])
            log(f"[{card_line}] path D: cross_kv_q8 {name} bdt vs btd: rel "
                f"err {err:.3e} (tol {ENCODE_TOL})")
            if err > ENCODE_TOL:
                raise AssertionError(f"path D: cross_kv_q8 bdt {name} "
                                     f"{err:.3e} > {ENCODE_TOL}")
    counts = read_counts()
    log(f"kernel launches in path D: {counts}")
    require_launches("path D", counts, ("K1", "K6", "K7"))
    # each window's device time, the host's issue of ~700 launches left out:
    # encode captured in a CUDA graph and replayed (time_ms), after the
    # counts above since the capture passes through the wrappers
    with torch.no_grad():
        for impl in outs:
            dev_ms = time_ms(lambda: wm.encode(
                params, window, n_head=cfg.n_audio_head, attn_impl=impl))
            log(f"[{card_line}] path D: encode large-v3 B=1 {impl}: device "
                f"{dev_ms:.3f} ms per window (CUDA-graph replay, median of "
                f"20, L2 flushed)")
    del outs, bdt
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile path A's full() instead of the phases")
    ap.add_argument("--profile-seconds", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    t_start = time.perf_counter()
    card_line = card()
    log(card_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from whisper_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.library()
    record_launches(lib)
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s): {lib.path.name}")
    log(lib.compiler_log.strip())

    from whisper_tpu_torch.audio.mel import full_f32_matmuls
    full_f32_matmuls()     # the plain versions' f32 matmuls, not TF32
    if args.profile:
        print(json.dumps(profile(card_line, args.profile_seconds)),
              flush=True)
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = check_kernels(gen)
    check_model(gen)
    small = model_file("small", "q5_1")
    check_file_model(small)
    big_file = model_file("large-v3", "q5_0")

    from whisper_tpu_torch import WhisperContext
    t0 = time.perf_counter()
    big = WhisperContext.from_random("large-v3", seed=0,
                                     cross_mode="einsum_q8")
    big_q4 = WhisperContext(config=big.config, vocab=big.vocab,
                            filters=big.filters, params=big.params,
                            cross_mode="einsum_q4")
    torch.cuda.synchronize()
    log(f"large-v3 random weights on the card: "
        f"{time.perf_counter() - t0:.2f} s")

    # the main paths, each read with the counts set to 0 just before it;
    # the shapes they launch are noted, for check_launched
    LAUNCHED["on"] = True
    phases = {
        "path A": lambda: run_full("path A", big_file, "pallas_q8",
                                   ("K1", "K3", "K5"), card_line),
        "path B": lambda: run_full("path B", small, "pallas",
                                   ("K1", "K3", "K3+mins", "K4"), card_line),
        "transcribe": lambda: serve(card_line, big, "transcribe",
                                    ("K1", "K2", "cross_kv_quant")),
        "transcribe q4": lambda: serve(card_line, big_q4, "transcribe q4",
                                       ("K1",)),
        "path C q8": lambda: run_full("path C q8", big_file, "einsum_q8",
                                      ("K1", "K2", "K3"), card_line,
                                      PATH_C_S),
        "path C q4": lambda: run_full("path C q4", big_file, "einsum_q4",
                                      ("K1", "K3"), card_line, PATH_C_S),
        "path D": lambda: front_end(card_line, big.params, big.config),
        # bench.py's other quality tiers at 20 rows: best_of 5 with the
        # ladder live (t > 0 rungs: K2 at G = 1), beam 5 (4 streams x 5
        # beams: K2 at G = 5)
        "transcribe bo5": lambda: serve(card_line, big, "transcribe bo5",
                                        ("K1", "K2"), "bo5", QUALITY_BATCH,
                                        True),
        "transcribe beam5": lambda: serve(card_line, big, "transcribe beam5",
                                          ("K1", "K2G"), "beam5",
                                          QUALITY_BATCH, True),
        # the CLI's defaults: whisper_tpu's serial beam reads the window's
        # dense cross-KV through the einsum in every cross mode
        # (decode/beam.py passes it to decode_step as it comes), so K5
        # does not run here; K1 and K3 (M = 5 and 5 x P) do
        "path A cli": lambda: run_full("path A cli", big_file, "pallas_q8",
                                       ("K1", "K3"), card_line, CLI_S,
                                       cli_params(CLI_S), trace=True),
        "parity": lambda: check_parity(card_line),
        # the serving engine and the server (whisper_tpu_torch/server.py)
        "continuous": lambda: check_continuous(card_line, big),
        "server": lambda: check_server(card_line, big_file),
        # whisper-cli: DTW, grammars, -p 2 (serial and batched), and the
        # batched DTW pass (K3 at M = B x T_pad)
        "cli": lambda: check_cli(card_line, big_file, small),
        # whisper-stream, whisper-command and whisper-lsp on the native
        # host mel: K1 at T = 750 and K5 at Ta = 750 (stream's -ac), K3 at
        # M = the lsp commandset prompt (with mins)
        "apps": lambda: check_apps(card_line, big_file),
        # whisper.h: the C ABI library under C programs, capi in process
        # (K1; K3 at M = 4, 1 and 12) and whisper-bench (K3 at M = 5 and
        # 256, K1 at T = 512)
        "capi": lambda: check_capi(card_line, big_file),
        # parallel/mesh.py: two gloo ranks on the card, tensor (1 x 2: K1
        # and K2 at 10 heads) and data (2 x 1) parallel, and a one-rank
        # NCCL dry run
        "mesh": lambda: check_mesh(card_line),
    }
    paths = {}
    for name, run in phases.items():
        LAUNCHED["phase"] = name
        paths[name] = run()
    LAUNCHED["on"] = False
    # which phase launches K3's prompt passes (M > 8), at which shapes
    log("K3 shapes at M > 8 by phase: " + json.dumps(
        {name: {key: sorted(list(x) for x in shapes if x[0] > 8)
                for key, shapes in by.items() if key in ("K3", "K3+mins")}
         for name, by in LAUNCHED["by_phase"].items()}))
    del big, big_q4
    torch.cuda.empty_cache()
    check_launched(gen, res)
    draws = check_draws(card_line)
    keys = ("K1", "K2", "K2G", "K3", "K4", "K5", "K6", "K7", *EPILOGUES,
            "self_attn_step", "cross_kv_quant")
    launches = {k: sum(c.get(k, 0) for c in paths.values()) for k in keys}
    log(f"kernel launches, all paths: {launches}")
    log("kernel launches by path: " + json.dumps(
        {name: {k: c.get(k, 0) for k in keys} for name, c in paths.items()}))

    def entry(key, name, source, replaces, extra=None):
        out = {"name": name, "route": "cuda",
               "source": f"whisper_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[key]}
        out.update(res[key])
        out.update(extra or {})
        return out

    k1dt, k3m = res["K1dt"], res["K3+mins"]
    k3 = res["K3"]
    kernels = [
        entry("K1", "encoder_attention", "encoder_attention.cu",
              "whisper_tpu/ops/encoder_attention.py:77",
              {"max_abs_err": max(res["K1"]["max_abs_err"],
                                  k1dt["max_abs_err"]),
               "max_rel_err": max(res["K1"]["max_rel_err"],
                                  k1dt["max_rel_err"]),
               "ms_bhdt": k1dt["ms"], "plain_ms_bhdt": k1dt["plain_ms"],
               "library_ms_bhdt": k1dt["library_ms"],
               "bound_ms_bhdt": k1dt["bound_ms"],
               "share_of_bound_bhdt": k1dt["share_of_bound"],
               "tflops_bhdt": k1dt["tflops"], "shape_bhdt": k1dt["shape"],
               "shapes_bhdt": k1dt["shapes"],
               "launched_shapes_bhdt": k1dt.get("launched_shapes", [])}),
        entry("K2", "cross_attention_q8", "cross_attention.cu",
              "whisper_tpu/ops/cross_attention.py:142"),
        entry("K2G", "cross_attention_q8, G = 5 queries a (b, h)",
              "cross_attention.cu", "whisper_tpu/ops/cross_attention.py:142",
              {"draws_per_step": draws}),
        entry("K3", "quantized_matmul", "quantized_matmul.cu",
              "whisper_tpu/ops/quantized.py:179",
              {"max_abs_err": max(k3["max_abs_err"], k3m["max_abs_err"]),
               "max_rel_err": max(k3["max_rel_err"], k3m["max_rel_err"]),
               "ms_mins": k3m["ms"], "plain_ms_mins": k3m["plain_ms"],
               "bound_ms_mins": k3m["bound_ms"], "dense_ms_mins": k3m["dense_ms"],
               "shape_mins": k3m["shape"], "shapes_mins": k3m["shapes"],
               "launched_shapes_mins": k3m.get("launched_shapes", []),
               "ms_by_shape_mins": k3m["ms_by_shape"]}),
        entry("K4", "cross_attention_decode", "cross_attention.cu",
              "whisper_tpu/ops/cross_attention.py:68"),
        entry("K5", "cross_attention_decode_q8", "cross_attention.cu",
              "whisper_tpu/ops/cross_attention.py:89"),
        entry("K6", "encoder_attention_btd", "encoder_attention.cu",
              "whisper_tpu/ops/encoder_attention.py:165"),
        entry("K7", "log_mel", "log_mel.cu",
              "whisper_tpu/ops/mel_pallas.py:58"),
        *(entry(key, key, "encoder_epilogue.cu",
                "none: XLA fused the encoder block's elementwise passes")
          for key in EPILOGUES),
        entry("self_attn_step", "self_attn_step", "self_attn_step.cu",
              "none: the decode step is one XLA program on the TPU"),
        entry("cross_kv_quant", "cross_kv_quant", "cross_kv_quant.cu",
              "none: XLA fused quantize_kv_bhdt under jit"),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} launched on no path")
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
