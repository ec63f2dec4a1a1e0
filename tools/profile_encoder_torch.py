#!/usr/bin/env python3
"""Where the port's encoder and decode-step time goes on one NVIDIA GPU
(torch only, no JAX).

    python3 tools/profile_encoder_torch.py encode [--root DIR] [--runs N]
    python3 tools/profile_encoder_torch.py ablate
    python3 tools/profile_encoder_torch.py ablate-decode
    python3 tools/profile_encoder_torch.py kernels --root DIR
    python3 tools/profile_encoder_torch.py step --root DIR [--steps N]

encode: large-v3 `encode` of one 30 s window at B = 1 (random weights,
seed 0) in attn_impl pallas and pallas_btd, with whisper_tpu_torch imported
from DIR (default: this checkout; give an unpacked older commit to compare
in one run).  Per impl: the fenced wall (median of N calls after two
warm-ups), the host's time to issue the calls (the same calls timed before
the fence), and one call under torch.profiler: device busy time, kernel
launches and the heaviest kernels.

ablate: K1 (B, T, H, Dh) at (1,1500,20), (4,1500,20), (1,1500,12), K6 at
(1,1536,1280,H20,t1500) and K1's Dh-major entry at (1,20,64,1536,t1500),
each timed as chip_smoke times kernels (CUDA-graph replay, L2 flushed),
built from csrc/encoder_attention.cu as it is and with one part of its
device code cut out: the exp2 (`no_exp2`: a multiply-add instead), the
whole online softmax (`no_softmax`), the K/V refills after the first
two tiles (`no_refill`: later tiles reuse stale stages).  The cut builds
compute wrong results; they time what the cut part costs.  Each variant
builds into build/ablate/<variant>/ in its own process.

ablate-decode: the same for K3's one-launch path (csrc/quantized_matmul.cu)
and K4 (csrc/cross_attention.cu) at their M = 1 / batch-1 shapes and B = 4:
`empty` (each CTA returns at once: the launch of the same cluster grid),
`no_cluster` (no cluster barrier and no exchange through distributed
shared memory: each CTA keeps its own max, sum and output),
`k4_no_exchange` (K4 without the softmax exchange; the cut is in
`cluster_softmax`, which K2 and K5 share, untimed here), and `library`, the
yardsticks in place of the kernels (K3's shapes: a max over the codes, a
read of the same bytes, and the dense bf16 GEMV of twice the bytes; K4's:
scaled_dot_product_attention on the same q, K, V).  Each shape is timed as
one call (time_ms) and back to back on cold inputs (stream_ms); the
unchanged build runs first and last, so K4 and SDPA are read in turns.

kernels: K2, K3 (with and without mins, f32 and bf16 x), K4, K5 and K7 (80
and 128 mels) timed at every shape that this checkout's chip_smoke.py
checks them at (`path_shapes`: K3 at M = 1, 4, 232 and the serving prompt
passes of 4 x 232 and 64 x 232 rows; its `time_ms`: CUDA-graph replay, L2
flushed, median of 20; and `stream_ms`, back to back on cold inputs), with
K3's dense yardstick (F.linear of the bf16 x over the dequantized bf16
weight) beside it, for whisper_tpu_torch imported from DIR (an unpacked
older commit) and from this checkout in turns, DIR, this, this, DIR, each
in a process of its own (one kernel library each); then the medians side
by side.

step: one decode step (`decode_step`) of path A (large-v3 q5_0 file,
cross mode pallas_q8: K3, K5), of path B (small q5_1, pallas: K3 with
mins, K4) and of path C (path A's file, einsum_q8: K3, K2) at batch 1
after a prompt pass over the first window of noise,
in the same turns.  Per tree: the step's host issue time (the call, timed
before the fence) and fenced wall (medians of N steps), and N more steps
under torch.profiler: device launches and device busy time per step.
Then the carried-prompt pass of the same path (`decode_prompt` over 232
tokens, n_text_ctx // 2 + 8 as `full` pads a carried prompt: every decoder
linear at M = 232): its fenced wall (median of N) and, over N more under
torch.profiler, launches and device busy time per pass.  The
model files are chip_smoke.py's (random valid blocks, seed 0, written once
into build/chip_smoke/).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "whisper_tpu_torch" / "csrc"
ABLATE_DIR = ROOT / "build" / "ablate"

# variant -> (old, new) replacements in encoder_attention.cu; each old
# text must occur exactly once
CUTS = {
    "as_is": [],
    "no_exp2": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                 "  y = fmaf(x, 0.01f, 1.f);")],
    "no_softmax": [("    // online softmax on the fragments\n",
                    "    l0 = l1 = 1.f;\n#if 0\n"),
                   ("    // P in bf16: registers", "#endif\n    // P in bf16: registers")],
    "no_refill": [("    mbar_wait(bar_q + 8 * (1 + s), (it / kStages) & 1);",
                   "    if (it < kStages) mbar_wait(bar_q + 8 * (1 + s), 0);"),
                  ("load_kv(it + kStages);", ";")],
}


def encode(root: Path, runs: int) -> None:
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch.models import whisper as wm

    ctx = WhisperContext.from_random("large-v3", seed=0, cross_mode="einsum_q8")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mel = torch.randn(1, 3000, ctx.config.n_mels, generator=gen, device="cuda")

    def run(impl):
        return wm.encode(ctx.params, mel, n_head=ctx.config.n_audio_head,
                         attn_impl=impl)

    with torch.no_grad():
        for impl in ("pallas", "pallas_btd"):
            for _ in range(2):
                run(impl)
            torch.cuda.synchronize()
            walls, issue = [], []
            for _ in range(runs):
                t0 = time.perf_counter()
                run(impl)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                issue.append(t1 - t0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(impl)
                torch.cuda.synchronize()
            kernels = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    t, n = kernels.get(ev.name, (0.0, 0))
                    kernels[ev.name] = (t + ev.time_range.elapsed_us() / 1e3,
                                        n + 1)
            busy = sum(t for t, _ in kernels.values())
            print(f"[{root}] encode {impl}: wall {statistics.median(walls) * 1e3:.3f}"
                  f" ms (median of {runs}), host issue "
                  f"{statistics.median(issue) * 1e3:.3f} ms, device busy "
                  f"{busy:.3f} ms in {sum(n for _, n in kernels.values())} "
                  "launches", flush=True)
            for name, (t, n) in sorted(kernels.items(),
                                       key=lambda kv: -kv[1][0])[:6]:
                print(f"    {t:8.3f} ms {n:5d} x {name[:100]}")


# variant -> (source, old, new) replacements for ablate-decode
QMM, XATTN = "quantized_matmul.cu", "cross_attention.cu"
# the body of cluster_softmax, the exchange K2, K4 and K5 share
K4_EXCHANGE = (
    "  cluster_wait();\n"
    "  if (threadIdx.x < n_ranks)\n"
    "    st_async(map_rank(smem_u32(&stats[rank]), threadIdx.x), make_float2(m_cta, "
    "s_cta),\n"
    "             map_rank(stats_bar, threadIdx.x));\n"
    "  mbar_wait(stats_bar, 0);\n"
    "  float m = stats[0].x;\n"
    "#pragma unroll\n"
    "  for (int r = 1; r < kMaxCluster; ++r)\n"
    "    if (r < n_ranks) m = fmaxf(m, stats[r].x);\n"
    "  float sum = 0.f;\n"
    "#pragma unroll\n"
    "  for (int r = 0; r < kMaxCluster; ++r)\n"
    "    if (r < n_ranks) sum += stats[r].y * expf(stats[r].x - m);\n"
    "  return make_float2(m, 1.f / sum);")
K4_LOCAL_STATS = "  return make_float2(m_cta, 1.f / s_cta);"
K4_MERGE_STORE = (
    "    st_async(map_rank(smem_u32(&parts[rank][4 * threadIdx.x]), 0),\n"
    "             make_float4(s[0], s[1], s[2], s[3]), "
    "map_rank(smem_u32(&parts_bar), 0));")
K4_LOCAL_STORE = ("    *reinterpret_cast<float4*>(&parts[0][4 * threadIdx.x]) = "
                  "make_float4(s[0], s[1], s[2], s[3]);")
K4_MERGE_WAIT = "  if (rank != 0) return;\n  mbar_wait(smem_u32(&parts_bar), 0);"
DECODE_CUTS = {
    "as_is": [],
    "empty": [(QMM, "  const int n_ranks = (int)cluster.num_blocks();\n",
               "  const int n_ranks = (int)cluster.num_blocks();\n"
               "  if (M > 0) return;\n"),
              (XATTN, "  const int n_ranks = (int)cluster.num_blocks();\n",
               "  const int n_ranks = (int)cluster.num_blocks();\n"
               "  if (Ta > 0) return;\n")],
    "no_cluster": [
        (QMM, "  cluster_arrive_relaxed();\n", ""),
        (QMM, "  cluster_wait();\n  // 4 columns a thread\n", ""),
        (QMM, "    st_async(map_rank(smem_u32(slots + rank * kM * kDecCols + 4 * i), 0), "
              "sum,\n             map_rank(slots_bar, 0));",
         "    *reinterpret_cast<float4*>(slots + 4 * i) = sum;"),
        (QMM, "  if (rank != 0) return;\n  // rank 0: every slot is in; add them in "
              "rank order\n  mbar_wait(slots_bar, 0);", "  __syncthreads();"),
        (XATTN, "  cluster_arrive_relaxed();\n", ""),
        (XATTN, K4_EXCHANGE, K4_LOCAL_STATS),
        (XATTN, K4_MERGE_STORE, K4_LOCAL_STORE),
        (XATTN, K4_MERGE_WAIT, "  __syncthreads();")],
    "k4_no_exchange": [(XATTN, K4_EXCHANGE.replace("  cluster_wait();\n", "", 1),
                        K4_LOCAL_STATS)],
    "library": [],
}


def _chip_smoke():
    """This checkout's chip_smoke.py as a module, whichever tree
    whisper_tpu_torch is imported from (an older tree has its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def kernels_one(root: Path) -> None:
    """Time K2, K3 (and its dense yardstick), K4, K5 and K7 at their
    chip_smoke shapes with the package of `root`; print one JSON line
    {kernel: [[shape, ms, back-to-back ms], ...]}."""
    sys.path.insert(0, str(root))
    import torch

    cs = _chip_smoke()
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.audio.mel import full_f32_matmuls, pad_audio
    from whisper_tpu_torch.ops import cross_attention as xa
    from whisper_tpu_torch.ops import mel_pallas as mp
    from whisper_tpu_torch.ops import quantized as qm
    full_f32_matmuls()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def bf16(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.3).to(
            torch.bfloat16)

    def k3(mins, x_dtype, M, K, N):
        codes = torch.randint(-16, 16, (K, N), generator=gen, device="cuda",
                              dtype=torch.int8)
        scales = torch.rand(K // 32, N, generator=gen, device="cuda") * 2e-3 + 1e-4
        x = torch.randn(M, K, generator=gen, device="cuda").to(x_dtype)
        args = (x, codes, scales, -16 * scales if mins else None)
        return lambda: qm.quantized_matmul(*args)

    def k4(B, H, Ta, Dh):
        q, k, v = bf16(B, H, 1, Dh), bf16(B, H, Ta, Dh), bf16(B, H, Ta, Dh)
        return lambda: xa.cross_attention_decode(q, k, v)

    def k5(B, H, Ta, Dh):
        q = bf16(B, H, 1, Dh)
        (kq, ks), (vq, vs) = (xa.quantize_kv(bf16(B, H, Ta, Dh).float())
                              for _ in range(2))
        return lambda: xa.cross_attention_decode_q8(q, kq, ks, vq, vs)

    def k3_dense(M, K, N):
        codes = torch.randint(-16, 16, (K, N), generator=gen, device="cuda",
                              dtype=torch.int8)
        scales = torch.rand(K // 32, N, generator=gen, device="cuda") * 2e-3 + 1e-4
        xb = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = qm.dequantize_t(codes, scales).t().contiguous().to(torch.bfloat16)
        return lambda: torch.nn.functional.linear(xb, w)

    def k7(seconds, n_mel):
        padded = torch.from_numpy(pad_audio(cs.mel_pcm(seconds))[0]).cuda()
        args = mp.mel_block_inputs(padded, mel_filterbank(n_mel))
        return lambda: mp._mel_blocks(*args)

    def k2(B, H, Dh, Ta):
        q = bf16(B, H, 1, Dh)
        (kq, ks), (vq, vs) = (xa.quantize_kv_bhdt(bf16(B, H, Dh, Ta).float())
                              for _ in range(2))
        return lambda: xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)

    # K3 on an f32 x as chip_smoke gives it (an older wrapper casts it to
    # bf16 first, one more launch) and on a bf16 x (the kernel alone)
    f32, bf = torch.float32, torch.bfloat16
    makers = {"K3": ("K3", lambda *s: k3(False, f32, *s)),
              "K3 bf16 x": ("K3", lambda *s: k3(False, bf, *s)),
              "K3+mins": ("K3+mins", lambda *s: k3(True, f32, *s)),
              "K3+mins bf16 x": ("K3+mins", lambda *s: k3(True, bf, *s)),
              "K3 dense": ("K3", k3_dense),
              "K4": ("K4", k4), "K5": ("K5", k5), "K2": ("K2", k2),
              "K7": ("K7", k7)}
    shapes = cs.path_shapes()
    # [shape, one call (time_ms), back to back on cold inputs (stream_ms)]
    out = {key: [[list(s), cs.time_ms(make(*s)),
                  cs.stream_ms(lambda: make(*s), cs.work(of, s)[0])]
                 for s in shapes[of]]
           for key, (of, make) in makers.items()}
    print("KERNELS " + json.dumps({"root": str(root), "times": out}), flush=True)


def step_one(root: Path, path: str, cross_mode: str, steps: int) -> None:
    """Path A's, B's or C's decode step with the package of `root`: prompt pass
    over the first window, then `steps` timed steps and `steps` profiled
    ones, then the carried-prompt pass; print one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import WhisperContext
    from whisper_tpu_torch.decode.loop import loop_cross_kv
    from whisper_tpu_torch.models import whisper as wm

    cd = torch.bfloat16
    dev = "cuda"
    t0 = time.perf_counter()
    ctx = WhisperContext.from_file(path, device=dev, compute_dtype=cd,
                                   cross_mode=cross_mode)
    load_s = time.perf_counter() - t0
    v, nh = ctx.vocab, ctx.config.n_text_head
    ctx.pcm_to_mel((np.random.RandomState(7).randn(16000 * 30) * 0.1).astype(
        np.float32))
    with torch.no_grad():
        _, kc, vc = ctx.encode_window(0)
        tokens = torch.tensor([[v.token_sot, v.token_lang(0), v.token_transcribe,
                                v.token_beg]], device=dev)
        P = tokens.shape[1]
        _, k_self, v_self = wm.decode_prompt(
            ctx.params, tokens, torch.arange(P, device=dev), kc, vc, nh,
            self_mask=wm.make_causal_mask(P, device=dev), compute_dtype=cd)
        kl, vl = loop_cross_kv(cross_mode, kc, vc, cd)
        L, B, _, H, Dh = k_self.shape
        n_all = 3 * steps + 2
        cache = {n: torch.zeros((L, B, H, Dh, P + n_all + 1), dtype=cd,
                                device=dev) for n in ("k", "v")}
        cache["k"][..., :P] = k_self.permute(0, 1, 3, 4, 2)
        cache["v"][..., :P] = v_self.permute(0, 1, 3, 4, 2)
        tok = torch.tensor([v.token_beg + 1], device=dev)
        i = 0

        def step():
            nonlocal i
            pos = torch.tensor([P + i], device=dev)
            wm.decode_step(ctx.params, tok, pos, P + i, cache, kl, vl,
                           kv_len=P + i + 1, n_head=nh, compute_dtype=cd)
            i += 1

        for _ in range(steps):           # warm-up
            step()
        torch.cuda.synchronize()
        issue, walls = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            issue.append(t1 - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy = sum(t for t, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]

    # the carried-prompt pass: 232 tokens, every decoder linear at M = 232
    Pc = ctx.config.n_text_ctx // 2 + 8
    ptok = torch.from_numpy(np.random.RandomState(1).randint(
        0, v.token_eot, (1, Pc))).to(dev)
    ppos = torch.arange(Pc, device=dev)
    pmask = wm.make_causal_mask(Pc, device=dev)

    def prompt():
        wm.decode_prompt(ctx.params, ptok, ppos, kc, vc, nh, self_mask=pmask,
                         compute_dtype=cd)

    with torch.no_grad():
        for _ in range(2):              # warm-up
            prompt()
        torch.cuda.synchronize()
        pwalls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            prompt()
            torch.cuda.synchronize()
            pwalls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pprof:
            for _ in range(steps):
                prompt()
            torch.cuda.synchronize()
    pk = _device_kernels(pprof)
    pbusy = sum(t for t, _ in pk.values())
    ptop = sorted(pk.items(), key=lambda kv: -kv[1][0])[:6]
    print("STEP " + json.dumps({
        "root": str(root), "file": Path(path).name, "cross_mode": cross_mode,
        "load_s": load_s, "steps": steps,
        "host_issue_ms": statistics.median(issue) * 1e3,
        "wall_ms": statistics.median(walls) * 1e3,
        "launches_per_step": sum(n for _, n in kernels.values()) / steps,
        "device_busy_ms_per_step": busy / steps,
        "top": [[name[:80], t / steps, n / steps] for name, (t, n) in top],
        "prompt_rows": Pc,
        "prompt_wall_ms": statistics.median(pwalls) * 1e3,
        "prompt_launches": sum(n for _, n in pk.values()) / steps,
        "prompt_device_busy_ms": pbusy / steps,
        "prompt_top": [[name[:80], t / steps, n / steps]
                       for name, (t, n) in ptop]}),
        flush=True)


def _device_kernels(prof) -> dict:
    """{device kernel name: (ms, launches)} of a torch.profiler run."""
    from torch.autograd import DeviceType
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            t, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (t + ev.time_range.elapsed_us() / 1e3, n + 1)
    return kernels


def in_turns(what: str, other: Path, extra: list[str]) -> None:
    """Run `what`-one for `other`, this checkout, this checkout, `other`,
    each in its own process; print the medians side by side."""
    card = _card()
    print(card, flush=True)
    order = [other, ROOT, ROOT, other]
    lines = []
    for root in order:
        proc = subprocess.run(
            [sys.executable, __file__, f"{what}-one", "--root", str(root), *extra],
            capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{what}-one for {root} failed:\n{proc.stdout[-4000:]}")
        tag = "KERNELS " if what == "kernels" else "STEP "
        lines.append([json.loads(ln[len(tag):]) for ln in proc.stdout.splitlines()
                      if ln.startswith(tag)])
        for rec in lines[-1]:
            print(json.dumps(rec), flush=True)
    names = ["parent", "this", "this", "parent"] if other != ROOT else ["this"] * 4
    if what == "kernels":
        for key, rows in lines[0][0]["times"].items():
            for j, (shape, *_) in enumerate(rows):
                for col, how in ((1, "one call"), (2, "back to back")):
                    ms = [run[0]["times"][key][j][col] for run in lines]
                    print(f"[{card}] {key} {tuple(shape)} {how}: " + " / ".join(
                        f"{n} {m:.4f}" for n, m in zip(names, ms)) + " ms",
                        flush=True)
    else:
        for j, rec in enumerate(lines[0]):
            runs = [run[j] for run in lines]
            for field in ("launches_per_step", "device_busy_ms_per_step",
                          "host_issue_ms", "wall_ms", "prompt_launches",
                          "prompt_device_busy_ms", "prompt_wall_ms"):
                print(f"[{card}] step {rec['file']} {rec['cross_mode']} {field}: "
                      + " / ".join(f"{n} {r[field]:.4f}" for n, r in zip(names, runs)),
                      flush=True)


def step_files() -> list[tuple[str, str]]:
    """(model file, cross mode) of paths A, B and C, written once by this
    checkout's chip_smoke.py."""
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    big = str(cs.model_file("large-v3", "q5_0"))
    return [(big, "pallas_q8"), (str(cs.model_file("small", "q5_1")), "pallas"),
            (big, "einsum_q8")]


def ablate_one(variant: str) -> None:
    """Build `variant` into its own directory and time the entries."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops import encoder_attention as ea

    src = ABLATE_DIR / variant / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in SRC.glob("*.cu"):
        text = f.read_text()
        if f.name == "encoder_attention.cu":
            for old, new in CUTS[variant]:
                if text.count(old) != 1:
                    raise SystemExit(f"{variant}: {old!r} not found once")
                text = text.replace(old, new)
        (src / f.name).write_text(text)
    _build.CSRC_DIR = src
    _build.BUILD_DIR = ABLATE_DIR / variant / "lib"
    log = _build.library().compiler_log.splitlines()
    regs = next((log[i + 2].strip() for i, line in enumerate(log)
                 if "Function properties for" in line
                 and "encoder_attention_kernelILb0" in line), "")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def bf16(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.3).to(
            torch.bfloat16)

    cells = []
    for B, H in ((1, 20), (4, 20), (1, 12)):
        q, k, v = (bf16(B, 1500, H, 64) for _ in range(3))
        err = float((ea.self_attention(q, k, v)
                     - ea.self_attention_ref(q, k, v)).abs().max())
        ms = chip_smoke.time_ms(lambda: ea.self_attention(q, k, v))
        cells.append(f"K1 ({B},1500,{H}) {ms:.4f} ms (max err {err:.1e})")
    q, k, v = (bf16(1, 1536, 1280) for _ in range(3))
    ms = chip_smoke.time_ms(lambda: ea.encoder_attention_btd(q, k, v, 20, 1500))
    cells.append(f"K6 {ms:.4f} ms")
    q, k, v = (bf16(1, 20, 64, 1536) for _ in range(3))
    ms = chip_smoke.time_ms(lambda: ea.encoder_attention(q, k, v, 1500))
    cells.append(f"K1dt {ms:.4f} ms")
    print(f"ablate {variant}: " + "; ".join(cells) + f" [{regs}]", flush=True)


def ablate_decode_one(variant: str) -> None:
    """Build `variant` of the decode kernels into its own directory and time
    K3 and K4 as chip_smoke does."""
    sys.path.insert(0, str(ROOT))
    import torch

    cs = _chip_smoke()
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops import cross_attention as xa
    from whisper_tpu_torch.ops import quantized as qm

    src = ABLATE_DIR / variant / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    texts = {f.name: f.read_text() for f in SRC.glob("*.cu")}
    for name, old, new in DECODE_CUTS[variant]:
        if texts[name].count(old) != 1:
            raise SystemExit(f"{variant}: {old!r} not found once in {name}")
        texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        (src / name).write_text(text)
    _build.CSRC_DIR = src
    _build.BUILD_DIR = ABLATE_DIR / variant / "lib"
    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def k3(M, K, N):
        codes = torch.randint(-16, 16, (K, N), generator=gen, device="cuda",
                              dtype=torch.int8)
        scales = torch.rand(K // 32, N, generator=gen, device="cuda") * 2e-3 + 1e-4
        x = torch.randn(M, K, generator=gen, device="cuda")
        return lambda: qm.quantized_matmul(x, codes, scales)

    def k4(B, H):
        q, k, v = ((torch.randn(B, H, n, 64, generator=gen, device="cuda") * 0.3
                    ).to(torch.bfloat16) for n in (1, 1500, 1500))
        return lambda: xa.cross_attention_decode(q, k, v)

    # library yardsticks (variant "library"): for K3's shapes a max over the
    # codes (a read of the same bytes) and the dense bf16 GEMV; for K4's
    # scaled_dot_product_attention on the same q, K, V
    def k3_lib(M, K, N):
        codes = torch.randint(-16, 16, (K, N), generator=gen, device="cuda",
                              dtype=torch.int8)
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(N, K, generator=gen, device="cuda").to(torch.bfloat16)
        words = codes.view(torch.int32)
        return (lambda: words.amax()), (lambda: torch.nn.functional.linear(x, w))

    def k4_lib(B, H):
        q, k, v = ((torch.randn(B, H, n, 64, generator=gen, device="cuda") * 0.3
                    ).to(torch.bfloat16) for n in (1, 1500, 1500))
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)

    cells = []
    for key, shape, make in (
            [("K3", s, k3) for s in ((1, 1280, 1280), (1, 1280, 5120),
                                     (1, 5120, 1280), (4, 1280, 1280))]
            + [("K4", s, k4) for s in ((1, 12), (1, 20), (4, 20))]):
        full = shape if key == "K3" else (*shape, 1500, 64)
        nbytes = cs.work(key, full)[0]
        if variant == "library" and key == "K3":
            for i, name in ((0, "read of the codes"), (1, "dense GEMV")):
                ms = cs.stream_ms(lambda: k3_lib(*shape)[i], nbytes * (1 + i))
                cells.append(f"K3 {full} {name} back to back {ms:.4f}")
            continue
        if variant == "library":
            make = k4_lib
        ms = cs.time_ms(make(*shape))
        ms_b2b = cs.stream_ms(lambda: make(*shape), nbytes)
        cells.append(f"{key} {full} {ms:.4f} (back to back {ms_b2b:.4f})")
    print(f"ablate-decode {variant}: " + "; ".join(cells) + " ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("encode", "ablate", "ablate-one",
                                     "ablate-decode", "ablate-decode-one",
                                     "kernels", "kernels-one", "step",
                                     "step-one"))
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--variant", choices=(*CUTS, *DECODE_CUTS),
                    default="as_is")
    ap.add_argument("--only", default="",
                    help="(ablate-decode) comma-separated variants to run")
    ap.add_argument("--file", action="append", default=[],
                    help="(step-one) FILE:CROSS_MODE, repeatable")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_encoder_torch: CUDA is not available")
    root = args.root.resolve()
    if args.what == "encode":
        encode(root, args.runs)
    elif args.what == "ablate-one":
        ablate_one(args.variant)
    elif args.what == "ablate-decode-one":
        ablate_decode_one(args.variant)
    elif args.what == "ablate-decode":
        print(_card(), flush=True)
        chosen = args.only.split(",") if args.only else [
            v for v in DECODE_CUTS if v != "as_is"]
        for variant in ("as_is", *chosen, "as_is"):
            subprocess.run([sys.executable, __file__, "ablate-decode-one",
                            "--variant", variant], check=True)
    elif args.what == "kernels-one":
        kernels_one(root)
    elif args.what == "step-one":
        for spec in args.file:
            path, mode = spec.rsplit(":", 1)
            step_one(root, path, mode, args.steps)
    elif args.what == "kernels":
        in_turns("kernels", root, [])
    elif args.what == "step":
        files = [f"{path}:{mode}" for path, mode in step_files()]
        in_turns("step", root, [f"--steps={args.steps}"]
                 + [f"--file={f}" for f in files])
    else:
        # in turns, each variant in a process of its own (one library each)
        for variant in ("as_is", *(v for v in CUTS if v != "as_is"), "as_is"):
            subprocess.run([sys.executable, __file__, "ablate-one",
                            "--variant", variant], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
