#!/usr/bin/env python3
"""Where the port's encoder time goes on one NVIDIA GPU (torch only, no JAX).

    python3 tools/profile_encoder_torch.py encode [--root DIR] [--runs N]
    python3 tools/profile_encoder_torch.py ablate

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
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("encode", "ablate", "ablate-one"))
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--variant", choices=tuple(CUTS), default="as_is")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_encoder_torch: CUDA is not available")
    if args.what == "encode":
        encode(args.root.resolve(), args.runs)
    elif args.what == "ablate-one":
        ablate_one(args.variant)
    else:
        # in turns, each variant in a process of its own (one library each)
        for variant in ("as_is", *(v for v in CUTS if v != "as_is"), "as_is"):
            subprocess.run([sys.executable, __file__, "ablate-one",
                            "--variant", variant], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
