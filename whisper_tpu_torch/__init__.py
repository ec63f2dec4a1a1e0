"""whisper_tpu_torch — the PyTorch + CUDA port of whisper_tpu.

The package mirrors whisper_tpu's module names.  It imports torch and
numpy only (never jax, never whisper_tpu), so it runs on a machine that
has no JAX.  Its entry points run on the card (device="cuda") unless the
caller asks for the CPU.  Two paths are ported:

    WhisperContext.from_file + full (api.py): whisper_full
      -> ggml reader, block codecs, packed decoder weights
         (weights/ggml_reader.py, quant.py, convert.py)
      -> host log-mel (audio/mel.py)
      -> conv stem + encoder, self-attention through kernel K1, or K6 for
         attn_impl "pallas_btd" (ops/encoder_attention.py,
         csrc/encoder_attention.cu)
      -> dense cross-KV (models/whisper.py cross_kv), quantized once per
         window for the quantized cross modes (decode/loop.py)
      -> window decode (decode/loop.py greedy, with draws from JAX's
         threefry stream at t > 0, decode/rng.py; decode/beam.py beam
         search), the temperature-fallback ladder; every packed decoder linear
         through kernel K3 (ops/quantized.py, csrc/quantized_matmul.cu),
         the per-token cross-attention through K2 ("einsum_q8",
         "pallas_q8dt"), K4 ("pallas") or K5 ("pallas_q8")
         (csrc/cross_attention.cu), or plain torch
         ("einsum", "einsum_q8i", "einsum_q4")
      -> host segment assembly (api.py)

    BatchTranscriber.transcribe (parallel/batch.py): batched serving
      -> device log-mel, encoder (K1), the cross-KV of the cross mode
         (cross_kv, cross_kv_q8 or cross_kv_q4), window decode loop with
         the ladder and best_of candidates, or batched beam search (a
         stream's beams as K2's G queries on its cross-KV row)

The fused log-mel kernel K7 (ops/mel_pallas.py, csrc/log_mel.cu) runs in
`log_mel_pallas`, as whisper_tpu's Pallas mel kernel does.  On CPU tensors
every kernel wrapper runs its plain PyTorch version; on CUDA tensors it
launches the hand-written kernel or raises.
"""

from .api import (BeamSearchParams, FullParams, GreedyParams,
                  SamplingStrategy, Segment, TokenData, WhisperContext,
                  WhisperState, full_default_params)
from .parallel.batch import BatchTranscriber

__all__ = ["BatchTranscriber", "BeamSearchParams", "FullParams",
           "GreedyParams", "SamplingStrategy", "Segment", "TokenData",
           "WhisperContext", "WhisperState", "full_default_params"]
