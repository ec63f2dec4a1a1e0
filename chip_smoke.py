"""Drive the PyTorch/CUDA port (whisper_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root; one card
    python3 chip_smoke.py --profile     # path A's full() profiled, see below

Phases, each of which must pass (the script exits nonzero otherwise):
  1. require CUDA; print the card's name and power limit
  2. build kernels K1-K7 from whisper_tpu_torch/csrc with nvcc (one process
     per source, in parallel)
  3. compare each kernel with its plain PyTorch version on the card at
     every shape the paths below give it, taken from the models they load
     (K2 also with G = 5 queries a (b, h), batched beam search's form)
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
     cross_mode="pallas_q8") + full on 60 s of PCM: K1, K3 and K5 launch
  6. path B: a small q5_1 file through from_file(..., cross_mode="pallas")
     + full: K1, K3 with mins and K4 launch
  7. the serving path: BatchTranscriber.transcribe on 4 int16 streams of
     45 s with large-v3 random weights (seed 0), greedy with the bench's
     serving settings: K1 and K2 launch; then once more with 4-bit cross-KV
     (cross_mode="einsum_q4", bench.py's kv=q4): K1 launches
  8. path C, the CLI's --kv-q8 / --kv-q4: path A's file through
     from_file(..., cross_mode="einsum_q8") + full on 30 s of PCM (K1, K2,
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
     30 s: K1 and K3 (whisper_tpu's serial beam reads the dense cross-KV
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
 13. the port's draws (decode/rng.py) on the card against the CPU for the
     same keys and logits, and one step's draw cost at the bo5 and beam5
     shapes from a torch.profiler trace
In 5-8, 10 and 11 every segment list must be non-empty and every
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
KERNEL_TOL = {"K1": 2e-2, "K1dt": 2e-2, "K2": 5e-4, "K2G": 5e-4, "K3": 1e-5,
              "K3+mins": 1e-5, "K4": 5e-4, "K5": 5e-4, "K6": 2e-2,
              "K7": 1e-5}
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
CLI_S = 30                         # seconds of PCM for path A's CLI defaults
FULL_S = 60                        # seconds of PCM for paths A and B
PATH_C_S = 30                      # seconds of PCM for path C
MEL_S = 60                         # seconds of PCM for path D's mel
BUILD = Path(__file__).resolve().parent / "build" / "chip_smoke"


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


def compare(name, tol, kernel, plain, args, library=None, dense=None):
    """-> (max abs err, rel err, kernel ms, plain ms, library ms or None,
    dense ms or None); raises past tol.  `library` is one PyTorch call that
    computes the same function on the same inputs, `dense` (K2, K3, K5) the
    library call of the same shape over dequantized bf16 operands: both
    timed only, as yardsticks."""
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
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
    (B, H, Ta, Dh); K7 (seconds of PCM, n_mels).  A shape that a main
    path launches and this list lacks is checked after the paths
    (check_launched)."""
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

    b, tp, d, h, tv = padded(big, 1)
    return {"K1": [enc(big, 1), enc(small, 1), enc(big, N_STREAMS),
                   enc(big, QUALITY_BATCH)],
            "K1dt": [(b, h, d // h, tp, tv)],
            "K2": [q8dt(N_STREAMS), q8dt(1), q8dt(BENCH_BATCH),
                   q8dt(QUALITY_BATCH)],
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
            "K4": [xattn(small, 1), xattn(big, 1), xattn(big, N_STREAMS)],
            "K5": [xattn(big, 1), xattn(small, 1), xattn(big, N_STREAMS)],
            "K6": [padded(big, 1), padded(small, 1), padded(big, N_STREAMS)],
            "K7": [(MEL_S, big.n_mels), (MEL_S, small.n_mels)]}


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
    from whisper_tpu_torch.ops import encoder_attention as ea
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
# writes them, while LAUNCHED["on"]; filled by record_launches
LAUNCHED = {"on": False, "shapes": {}}


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
    raise KeyError(f"no launch shape for {entry}")


def record_launches(lib) -> None:
    """Have `lib.call` note each launch's kernel and shape in LAUNCHED."""
    call = lib.call

    def recording(entry, *args):
        if LAUNCHED["on"]:
            key, shape = launch_shape(entry, args)
            LAUNCHED["shapes"].setdefault(key, set()).add(shape)
        return call(entry, *args)
    lib.call = recording


def check_launched(gen, res) -> dict:
    """Every shape the main paths launched that check_kernels did not
    check, against its plain version within the kernel's KERNEL_TOL
    (compared once, not timed); adds them and every launched shape to
    `res`.  -> {key: shapes checked here}."""
    cases, _ = kernel_cases(gen)
    checked = {k: {tuple(x) for x in v["shapes"]} for k, v in res.items()}
    checked["K7"] = {("frames", mel_frames(s), n)
                     for s, n in checked["K7"]}
    extra = {}
    for key, shapes in sorted(LAUNCHED["shapes"].items()):
        res[key]["launched_shapes"] = sorted(list(x) for x in shapes)
        for shape in sorted(shapes - checked[key]):
            if key == "K7":
                raise AssertionError(f"K7 launched at {shape}, a length "
                                     "check_kernels does not check")
            name, kernel, plain, make = cases[key]
            args, _ = make(*shape)
            out = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            if not torch.isfinite(out).all():
                raise AssertionError(f"{key} {shape}: non-finite output")
            err = float((out - ref).abs().max())
            rel = err / float(ref.abs().max())
            log(f"{key} {name} {shape} (launched on a main path): "
                f"max_abs_err {err:.3e} rel {rel:.3e} (tol "
                f"{KERNEL_TOL[key]})")
            if rel > KERNEL_TOL[key]:
                raise AssertionError(f"{key} {shape}: rel err {rel:.3e} > "
                                     f"{KERNEL_TOL[key]}")
            r = res[key]
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
    from whisper_tpu_torch.ops import encoder_attention as ea
    from whisper_tpu_torch.ops import mel_pallas as mp
    from whisper_tpu_torch.ops import quantized as qm
    return {"K1": (ea.self_attention, ea.encoder_attention),
            "K2": (xa.cross_attention_decode_q8dt,),
            "K3": (qm.quantized_matmul,), "K4": (xa.cross_attention_decode,),
            "K5": (xa.cross_attention_decode_q8,),
            "K6": (ea.encoder_attention_btd,), "K7": (mp._mel_blocks,)}


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


def model_file(size: str, kind: str) -> Path:
    """A random-weight ggml file at `size`'s published dims in block type
    `kind`, written once (tensor by tensor, random valid blocks, seed 0)
    and reused."""
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.models.whisper import MODEL_DIMS
    from whisper_tpu_torch.weights import ggml_writer
    from whisper_tpu_torch.weights.vocab import synthetic_vocab

    path = BUILD / f"{size}-{kind}.bin"
    if path.is_file():
        log(f"reusing {path.name} ({path.stat().st_size / 2**20:.1f} MiB)")
        return path
    BUILD.mkdir(parents=True, exist_ok=True)
    dims = MODEL_DIMS[size]
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    tmp = path.with_suffix(".tmp")
    t0 = time.perf_counter()
    ggml_writer.write_random_model(
        str(tmp), hp, mel_filterbank(hp["n_mels"]),
        synthetic_vocab(hp["n_vocab"]).id_to_token[:50257], kind, seed=0)
    tmp.replace(path)
    log(f"wrote {path.name}: {path.stat().st_size / 2**20:.1f} MiB in "
        f"{time.perf_counter() - t0:.2f} s")
    return path


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
        t0 = time.perf_counter()
        result = bt.transcribe(streams)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    log(f"[{card_line}] {label} phase_times (s): "
        + json.dumps({k: round(v, 4) for k, v in bt.phase_times.items()}))
    log(f"[{card_line}] {label} window_times (batch, s): "
        + json.dumps([(b, round(t, 4)) for b, t in bt.window_times]))
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
    paths = {
        "path A": run_full("path A", big_file, "pallas_q8",
                           ("K1", "K3", "K5"), card_line),
        "path B": run_full("path B", small, "pallas",
                           ("K1", "K3", "K3+mins", "K4"), card_line),
        "transcribe": serve(card_line, big, "transcribe", ("K1", "K2")),
        "transcribe q4": serve(card_line, big_q4, "transcribe q4", ("K1",)),
        "path C q8": run_full("path C q8", big_file, "einsum_q8",
                              ("K1", "K2", "K3"), card_line, PATH_C_S),
        "path C q4": run_full("path C q4", big_file, "einsum_q4",
                              ("K1", "K3"), card_line, PATH_C_S),
        "path D": front_end(card_line, big.params, big.config),
        # bench.py's other quality tiers at 20 rows: best_of 5 with the
        # ladder live (t > 0 rungs: K2 at G = 1), beam 5 (4 streams x 5
        # beams: K2 at G = 5)
        "transcribe bo5": serve(card_line, big, "transcribe bo5",
                                ("K1", "K2"), "bo5", QUALITY_BATCH, True),
        "transcribe beam5": serve(card_line, big, "transcribe beam5",
                                  ("K1", "K2G"), "beam5", QUALITY_BATCH,
                                  True),
        # the CLI's defaults: whisper_tpu's serial beam reads the window's
        # dense cross-KV through the einsum in every cross mode
        # (decode/beam.py passes it to decode_step as it comes), so K5
        # does not run here; K1 and K3 (M = 5 and 5 x P) do
        "path A cli": run_full("path A cli", big_file, "pallas_q8",
                               ("K1", "K3"), card_line, CLI_S,
                               cli_params(CLI_S), trace=True),
        "parity": check_parity(card_line),
    }
    LAUNCHED["on"] = False
    del big, big_q4
    torch.cuda.empty_cache()
    check_launched(gen, res)
    draws = check_draws(card_line)
    keys = ("K1", "K2", "K2G", "K3", "K4", "K5", "K6", "K7")
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
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} launched on no path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
