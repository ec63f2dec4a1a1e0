"""whisper_tpu_torch — the PyTorch + CUDA port of whisper_tpu.

The package mirrors whisper_tpu's module names.  It imports torch and
numpy only (never jax, never whisper_tpu), so it runs on a machine that
has no JAX.  Two paths are ported:

    WhisperContext.from_file + full (api.py): whisper_full
      -> ggml reader, block codecs, packed decoder weights
         (weights/ggml_reader.py, quant.py, convert.py)
      -> host log-mel (audio/mel.py)
      -> conv stem + encoder, self-attention through kernel K1
         (ops/encoder_attention.py, csrc/encoder_attention.cu)
      -> dense cross-KV (models/whisper.py cross_kv)
      -> window decode loop (decode/loop.py); every packed decoder linear
         through kernel K3 (ops/quantized.py, csrc/quantized_matmul.cu),
         the per-token cross-attention through K4 ("pallas") or K5
         ("pallas_q8") (ops/cross_attention.py, csrc/cross_attention.cu)
         or the einsum ("einsum")
      -> host segment assembly (api.py)

    BatchTranscriber.transcribe (parallel/batch.py): batched serving
      -> device log-mel, encoder (K1), int8 cross-KV (cross_kv_q8),
         window decode loop with the cross-attention through K2
         (csrc/cross_attention_q8.cu) and packed linears through K3

On CPU tensors every kernel wrapper runs its plain PyTorch version; on
CUDA tensors it launches the hand-written kernel or raises.
"""

from .api import (FullParams, GreedyParams, Segment, TokenData,
                  WhisperContext, WhisperState, full_default_params)
from .parallel.batch import BatchTranscriber

__all__ = ["BatchTranscriber", "FullParams", "GreedyParams", "Segment",
           "TokenData", "WhisperContext", "WhisperState",
           "full_default_params"]
