"""whisper-bench equivalent (reference: examples/bench/bench.cpp; port of
whisper_tpu.bench_tool).

Measures the same four metrics the reference publishes in
scripts/bench-all-gg.txt (columns defined at bench.cpp:111-139):

  Enc.  — one full encoder pass (+cross-KV), ms
  Dec.  — single-token decode with full context, ms/token (64 reps)
  Bch5  — 5-sequence batched decode, ms/token (64 reps)
  PP    — 256-token prompt processing, ms/token (8 reps)

Modes: -w 0 full bench (default), -w 1 memcpy, -w 2 mul_mat
(same whisper_bench_memcpy / whisper_bench_ggml_mul_mat split), -w 3
single-stream latency (whisper-stream's step at a shrunk audio_ctx).

Usage: python -m whisper_tpu_torch.bench_tool -m model.bin [-w N]
Without -m, uses random weights at --size dims (default tiny).  --device
defaults to cuda: the bench runs on the card, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .models import whisper as wm
from .models.whisper import MODEL_DIMS, WhisperConfig
from .utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, reps: int, device: torch.device) -> float:
    """ms per call of fn(i) over `reps` calls after one warm-up call,
    fenced by a synchronize on each side."""
    fn(-1)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1000.0


def _device_of(params) -> torch.device:
    return params["decoder"]["tok_emb"].device


@torch.no_grad()
def bench_full(params, cfg: WhisperConfig, fast: bool = False) -> dict:
    """The Enc / Dec / Bch5 / PP table on the device that holds `params`.
    fast=True cuts every rep count to 2 — for tests exercising the
    plumbing (layouts, signatures), not for timing."""
    dev = _device_of(params)
    nh_a, nh_t = cfg.n_audio_head, cfg.n_text_head
    H, Dh, L = cfg.n_text_head, cfg.head_dim_text, cfg.n_text_layer
    r8, r64 = (2, 2) if fast else (8, 64)

    rng = np.random.RandomState()
    mel = torch.from_numpy(rng.rand(1, 2 * cfg.n_audio_ctx, cfg.n_mels)
                           .astype(np.float32)).to(dev)

    def encode(m):
        return wm.cross_kv(params, wm.encode(params, m, n_head=nh_a),
                           n_head=nh_t)

    t_enc = _timeit(lambda i: encode(mel), r8, dev)
    kc, vc = encode(mel)

    def make_dec(B, T_step, n_past):
        C = n_past + T_step + 8
        # the (L, B, H, Dh, C) self-KV of models/whisper.py decode_step
        kv = {"k": torch.zeros((L, B, H, Dh, C), dtype=torch.bfloat16,
                               device=dev),
              "v": torch.zeros((L, B, H, Dh, C), dtype=torch.bfloat16,
                               device=dev)}
        kcb = kc.expand(L, B, *kc.shape[2:])
        vcb = vc.expand(L, B, *vc.shape[2:])
        salt = int(rng.randint(0, cfg.n_vocab - 300))
        if T_step == 1:
            pos = torch.full((B,), n_past, dtype=torch.long, device=dev)
            state = {"tok": torch.full((B,), salt, dtype=torch.long,
                                       device=dev)}

            def step(i):
                # the next token comes from this step's logits, as in a
                # decode
                logits, _ = wm.decode_step(params, state["tok"], pos, n_past,
                                           kv, kcb, vcb, n_past + 1,
                                           n_head=nh_t)
                state["tok"] = logits.argmax(-1) % 1000 + i + 2

            return step
        mask = wm.make_causal_mask(T_step, device=dev)
        positions = torch.arange(T_step, device=dev)
        state = {"tok": torch.full((B, T_step), salt, dtype=torch.long,
                                   device=dev)}

        def step(i):
            logits, _, _ = wm.decode_prompt(params, state["tok"], positions,
                                            kcb, vcb, n_head=nh_t,
                                            self_mask=mask)
            state["tok"] = logits.argmax(-1) % 1000 + i + 2

        return step

    # Dec: 1 token at full context (reference: 256 runs at n_past=n_ctx/2)
    t_dec = _timeit(make_dec(1, 1, cfg.n_text_ctx // 2), r64, dev)
    # Bch5: 5 sequences, 1 token each
    t_bch5 = _timeit(make_dec(5, 1, cfg.n_text_ctx // 2), r64, dev)
    # PP: 256-token prompt
    t_pp = _timeit(make_dec(1, 256, 0), r8, dev) / 256.0
    del kc, vc

    return {"enc_ms": t_enc, "dec_ms": t_dec, "bch5_ms": t_bch5,
            "pp_ms_per_tok": t_pp}


def build_pipeline(params, cfg: WhisperConfig, B: int, n_tokens: int,
                   prompt_len: int = 4):
    """run(audio (B, S) padded PCM, prompt (B, P)) -> (B,) token sums: the
    step a streaming client pays, on the device that holds `params`: mel
    on the device, encode at cfg.n_audio_ctx frames, dense cross-KV, the
    prompt pass, then n_tokens greedy steps through the filter chain."""
    from .audio.filters import mel_filterbank
    from .audio.mel import log_mel_spectrogram_torch
    from .decode.filters import (FilterConsts, FilterOptions,
                                 make_process_logits)
    from .weights.vocab import synthetic_vocab

    dev = _device_of(params)
    filters = torch.from_numpy(mel_filterbank(cfg.n_mels)).to(dev)
    consts = FilterConsts.from_vocab(synthetic_vocab(cfg.n_vocab),
                                     cfg.n_audio_ctx)
    process = make_process_logits(consts, FilterOptions(), device=dev)
    P = prompt_len
    C = P + n_tokens + 1
    H, Dh, L = cfg.n_text_head, cfg.head_dim_text, cfg.n_text_layer
    nh = cfg.n_text_head
    mask = wm.make_causal_mask(P, device=dev)
    true_b = torch.ones((B,), dtype=torch.bool, device=dev)
    false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((B,), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def run(audio, prompt):
        mel = log_mel_spectrogram_torch(audio, filters)[:, :2 * cfg.n_audio_ctx]
        enc = wm.encode(params, mel, n_head=cfg.n_audio_head)
        kc, vc = wm.cross_kv(params, enc, n_head=nh)
        logits, ks, vs = wm.decode_prompt(
            params, prompt, torch.arange(P, device=dev), kc, vc, n_head=nh,
            self_mask=mask)
        kv = {"k": torch.zeros((L, B, H, Dh, C), dtype=torch.bfloat16,
                               device=dev),
              "v": torch.zeros((L, B, H, Dh, C), dtype=torch.bfloat16,
                               device=dev)}
        kv["k"][..., :P] = ks.permute(0, 1, 3, 4, 2).to(torch.bfloat16)
        kv["v"][..., :P] = vs.permute(0, 1, 3, 4, 2).to(torch.bfloat16)
        lg, _, _ = process(logits[:, -1], 0.0, true_b, false_b, true_b,
                           false_b, zero_i)
        acc = torch.zeros((B,), dtype=torch.long, device=dev)
        for i in range(n_tokens):
            tok = lg.argmax(-1)
            lg_raw, kv = wm.decode_step(
                params, tok, torch.full((B,), P + i, dtype=torch.long,
                                        device=dev), P + i, kv, kc, vc,
                kv_len=P + i + 1, n_head=nh)
            lg, _, _ = process(lg_raw, 0.0, false_b,
                               tok >= consts.token_beg, false_b, false_b,
                               zero_i)
            acc = acc + tok
        return acc

    return run


def bench_latency(size: str, Bs=(1, 2, 4), audio_ctx: int = 512,
                  n_tokens: int = 24, iters: int = 5,
                  device="cuda") -> dict:
    """Single-stream LOW-LATENCY mode (reference: examples/stream/stream.cpp
    targets sub-second steps with audio_ctx shrink, stream.cpp:118-260).

    Measures the full step a streaming client pays per iteration: mel +
    encoder at a shrunk audio_ctx (512 frames ~ 10.2 s context) + cross-KV
    + n_tokens greedy decode with the filter chain, at tiny batch sizes,
    with random weights (seed 0) at `size`'s dims (MODEL_DIMS).
    Returns {"b{B}_step_ms": ...} per batch size: the fastest of `iters`
    steps, each ended by a synchronize."""
    from .constants import HOP_LENGTH, N_FFT
    from .weights.convert import random_params

    dev = resolve_device(device)
    cfg = WhisperConfig(*MODEL_DIMS[size], model_type=size)
    cfg_small = dataclasses.replace(cfg, n_audio_ctx=audio_ctx)
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    n_samples = 2 * audio_ctx * HOP_LENGTH + N_FFT
    rng = np.random.RandomState()
    sot = 50258 if cfg.n_vocab >= 51865 else 50257
    out = {}
    for B in Bs:
        run = build_pipeline(params, cfg_small, B, n_tokens)
        audios = [torch.from_numpy(
            (rng.rand(B, n_samples) - 0.5).astype(np.float32) * 0.1).to(dev)
            for _ in range(iters + 1)]
        prompt = torch.tensor([[sot, sot + 1, sot + 100, sot + 105]],
                              device=dev).repeat(B, 1)
        run(audios[0], prompt).cpu()                 # warm-up
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            run(audios[i + 1], prompt).cpu()
            times.append(time.perf_counter() - t0)
        out[f"b{B}_step_ms"] = round(min(times) * 1000, 2)
    return out


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    from . import capi

    ap = argparse.ArgumentParser(prog="whisper-bench")
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-w", "--what", type=int, default=0,
                    help="0=full, 1=memcpy, 2=mul_mat, 3=latency "
                         "(single-stream stream-mode step times)")
    ap.add_argument("--size", default="tiny")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run without "
                         "a card)")
    args = ap.parse_args(argv)

    if args.what == 1:
        print(capi.whisper_bench_memcpy_str(args.threads))
        return 0
    dev = resolve_device(args.device)
    if args.what == 2:
        print(capi.mul_mat_lines(dev))
        return 0
    if args.what == 3:
        lat = bench_latency(args.size, device=dev)
        print("| model | device | " +
              " | ".join(k for k in lat) + " |")
        print("| ----- | ------ | " +
              " | ".join("-" * len(k) for k in lat) + " |")
        print(f"| {args.size} | {_device_name(dev)} | " +
              " | ".join(f"{v:.1f}" for v in lat.values()) + " |")
        return 0

    if args.model:
        from .api import WhisperContext
        ctx = WhisperContext.from_file(args.model, device=dev)
        params, cfg = ctx.params, ctx.config
        name = ctx.hparams.model_type
    else:
        from .weights.convert import random_params
        cfg = WhisperConfig(*MODEL_DIMS[args.size], model_type=args.size)
        params = random_params(cfg, dtype=torch.bfloat16, device=dev)
        name = f"{args.size} (random)"

    r = bench_full(params, cfg)
    print("| model | device | Enc. | Dec. | Bch5 | PP |")
    print("| ----- | ------ | ---- | ---- | ---- | -- |")
    print(f"| {name} | {_device_name(dev)} | {r['enc_ms']:.2f} | "
          f"{r['dec_ms']:.2f} | {r['bch5_ms']:.2f} | "
          f"{r['pp_ms_per_tok']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
