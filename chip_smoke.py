"""Drive the PyTorch/CUDA port (whisper_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA card

Phases, each of which must pass (the script exits nonzero otherwise):
  1. require CUDA; print the card's name and power limit
  2. build kernels K1 and K2 from whisper_tpu_torch/csrc with nvcc
  3. compare each kernel with its plain PyTorch version on the card at the
     serving path's shapes, and time both (CUDA events, median of 20 runs
     after 3 warm-ups, L2 flushed before each run)
  4. model check at large-v3 width, depth cut to 2+2 layers: mel, encoder,
     int8 cross-KV, prompt pass and one decode step in bf16 on the card
     against the same weights in float32 on the CPU (plain versions)
  5. the serving path: BatchTranscriber.transcribe on 4 int16 streams of
     45 s with large-v3 random weights (seed 0), greedy with the bench's
     serving settings; every stream must get segments, every token
     probability must be finite, and both kernels must have launched
The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

K1_SHAPE = (4, 1500, 20, 64)       # B, T, H, Dh: large-v3 encoder, batch 4
K2_SHAPE = (4, 20, 64, 1500)       # B, H, Dh, Ta: large-v3 decode, batch 4
KERNEL_TOL = 2e-2                  # max |kernel - plain| / max |plain|, bf16
# bf16 on the card against f32 on the CPU through two encoder and two
# decoder layers at full width: bf16 keeps ~3 significant digits per
# rounding and the errors add over ~20 roundings in series
MODEL_TOL = 5e-2
N_STREAMS, STREAM_S = 4, 45


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n_warm: int = 3, n_runs: int = 20) -> float:
    """Median device time of one call, CUDA events around each call.  The
    50 MB L2 is flushed before each call: on the serving path every
    layer's inputs arrive cold."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel, plain, args):
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: plain(*args))
    log(f"{name}: max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if rel > KERNEL_TOL:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {KERNEL_TOL}")
    return err, ms, plain_ms


def check_kernels(gen):
    from whisper_tpu_torch.ops import cross_attention as xa
    from whisper_tpu_torch.ops import encoder_attention as ea

    B, T, H, Dh = K1_SHAPE
    qkv = [(torch.randn(B, T, H, Dh, generator=gen, device="cuda") * 0.3)
           .to(torch.bfloat16) for _ in range(3)]
    k1 = compare("K1 encoder_attention", ea.self_attention,
                 ea.self_attention_ref, qkv)

    B, H, Dh, Ta = K2_SHAPE
    q = (torch.randn(B, H, 1, Dh, generator=gen, device="cuda") * 0.3
         ).to(torch.bfloat16)
    kq, ks = xa.quantize_kv_bhdt(
        torch.randn(B, H, Dh, Ta, generator=gen, device="cuda") * 0.3)
    vq, vs = xa.quantize_kv_bhdt(
        torch.randn(B, H, Dh, Ta, generator=gen, device="cuda") * 0.3)
    k2 = compare("K2 cross_attention_q8", xa.cross_attention_decode_q8dt,
                 xa.cross_attention_decode_q8dt_ref, [q, kq, ks, vq, vs])
    return k1, k2


def check_model(gen):
    """Full-width large-v3 cut to 2+2 layers: bf16 on the card (K1, K2)
    against the same weights in float32 on the CPU (plain versions)."""
    from whisper_tpu_torch.audio.mel import log_mel_spectrogram_torch, pad_audio
    from whisper_tpu_torch.audio.filters import mel_filterbank
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
        L, B, P, H, Dh = k_self.shape
        cache = {n: torch.zeros((L, B, H, Dh, P + 1), dtype=cd, device=device)
                 for n in ("k", "v")}
        cache["k"][..., :P] = k_self.permute(0, 1, 3, 4, 2).to(cd)
        cache["v"][..., :P] = v_self.permute(0, 1, 3, 4, 2).to(cd)
        step_logits, _ = wm.decode_step(
            p, tokens[:, -1].to(device), torch.tensor([P], device=device), P,
            cache, ("q8e", kq, ks), ("q8e", vq, vs), kv_len=P + 1,
            n_head=nh, compute_dtype=cd)
        return [x.float().cpu() for x in (mel, enc, logits, step_logits)]

    with torch.no_grad():
        got = run(params, "cuda", torch.bfloat16)
        ref = run(ref_params, "cpu", torch.float32)
    for name, g, r in zip(("mel", "encoder", "prompt logits",
                           "step logits"), got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"model check {name}: shape {tuple(g.shape)}"
                                 f" vs {tuple(r.shape)} or non-finite")
        rel = float((g - r).abs().max() / r.abs().max())
        log(f"model check {name} {tuple(g.shape)}: rel err vs f32 CPU "
            f"{rel:.3e} (tol {MODEL_TOL})")
        if rel > MODEL_TOL:
            raise AssertionError(f"model check {name}: {rel:.3e} > "
                                 f"{MODEL_TOL}")


def serve(card_line: str):
    from whisper_tpu_torch import (BatchTranscriber, WhisperContext,
                                   full_default_params)
    from whisper_tpu_torch.ops import cross_attention as xa
    from whisper_tpu_torch.ops import encoder_attention as ea

    t0 = time.perf_counter()
    ctx = WhisperContext.from_random("large-v3", seed=0, device="cuda",
                                     cross_mode="einsum_q8")
    torch.cuda.synchronize()
    log(f"large-v3 random weights on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    # bench.py's greedy serving settings
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.max_tokens = 64
    p.no_timestamps = True
    p.n_max_text_ctx = 64
    p.temperature_inc = 0.0
    bt = BatchTranscriber(ctx, batch_size=N_STREAMS, params=p,
                          device_mel=True)
    t0 = time.perf_counter()
    bt.warmup(pcm_dtype=np.int16)
    torch.cuda.synchronize()
    log(f"warmup: {time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(7)
    streams = [(rng.randn(16000 * STREAM_S) * 0.1 * 32768).clip(
        -32768, 32767).astype(np.int16) for _ in range(N_STREAMS)]
    torch.cuda.reset_peak_memory_stats()
    ea.self_attention.launches = 0
    xa.cross_attention_decode_q8dt.launches = 0
    t0 = time.perf_counter()
    result = bt.transcribe(streams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": ea.self_attention.launches,
                "K2": xa.cross_attention_decode_q8dt.launches}

    audio_s = float(N_STREAMS * STREAM_S)
    log(f"[{card_line}] transcribe {N_STREAMS} x {STREAM_S} s int16: wall "
        f"{wall:.3f} s, {audio_s / wall:.2f} audio-s per wall-s, "
        f"{bt.n_windows} windows, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{card_line}] phase_times (s): "
        + json.dumps({k: round(v, 4) for k, v in bt.phase_times.items()}))
    log(f"[{card_line}] window_times (batch, s): "
        + json.dumps([(b, round(t, 4)) for b, t in bt.window_times]))
    log(f"kernel launches in transcribe: {launches}")
    for i, segs in enumerate(result):
        log(f"stream {i}: {len(segs)} segments, "
            f"{sum(len(s.tokens) for s in segs)} tokens")
        if not segs:
            raise AssertionError(f"stream {i} produced no segments")
        vals = [v for s in segs for t in s.tokens for v in (t.p, t.plog)]
        vals += [s.no_speech_prob for s in segs]
        if not np.isfinite(vals).all():
            raise AssertionError(f"stream {i}: non-finite probabilities "
                                 "(NaN logits)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card_line = card()
    log(card_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from whisper_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s): {lib.path.name}")
    log(lib.compiler_log.strip())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    (e1, ms1, pms1), (e2, ms2, pms2) = check_kernels(gen)
    check_model(gen)
    launches = serve(card_line)

    kernels = [
        {"name": "encoder_attention", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "whisper_tpu/ops/encoder_attention.py:77",
         "launches": launches["K1"], "max_abs_err": e1, "ms": ms1,
         "plain_ms": pms1},
        {"name": "cross_attention_q8", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/cross_attention_q8.cu",
         "replaces": "whisper_tpu/ops/cross_attention.py:142",
         "launches": launches["K2"], "max_abs_err": e2, "ms": ms2,
         "plain_ms": pms2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
