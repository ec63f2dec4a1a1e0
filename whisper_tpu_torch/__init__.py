"""whisper_tpu_torch — the PyTorch + CUDA port of whisper_tpu.

The package mirrors whisper_tpu's module names.  It imports torch and
numpy only (never jax, never whisper_tpu), so it runs on a machine that
has no JAX.  This slice covers the batched greedy serving path:

    BatchTranscriber.transcribe (parallel/batch.py)
      -> device log-mel (audio/mel.py)
      -> conv stem + encoder, self-attention through kernel K1
         (ops/encoder_attention.py, csrc/encoder_attention.cu)
      -> int8 cross-KV (models/whisper.py cross_kv_q8)
      -> window decode loop (decode/loop.py), whose per-token
         cross-attention runs through kernel K2
         (ops/cross_attention.py, csrc/cross_attention_q8.cu)
      -> host segment assembly (api.py)

On CPU tensors every kernel wrapper runs its plain PyTorch version; on
CUDA tensors it launches the hand-written kernel or raises.
"""

from .api import (FullParams, GreedyParams, Segment, TokenData,
                  WhisperContext, WhisperState, full_default_params)
from .parallel.batch import BatchTranscriber

__all__ = ["BatchTranscriber", "FullParams", "GreedyParams", "Segment",
           "TokenData", "WhisperContext", "WhisperState",
           "full_default_params"]
