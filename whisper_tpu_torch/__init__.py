"""whisper_tpu_torch — the PyTorch + CUDA port of whisper_tpu.

The package mirrors whisper_tpu's module names.  It imports torch and
numpy only (never jax, never whisper_tpu), so it runs on a machine that
has no JAX.  Its entry points run on the card (device="cuda") unless the
caller asks for the CPU.  These paths are ported:

    WhisperContext.from_file + full (api.py): whisper_full
      -> ggml reader, block codecs, packed decoder weights
         (weights/ggml_reader.py, quant.py, convert.py)
      -> host log-mel (audio/mel.py: the native C++ front end of
         audio/native.py when it builds, else numpy)
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
      -> host or device log-mel, encoder (K1), the cross-KV of the cross
         mode (cross_kv, cross_kv_q8 or cross_kv_q4), a batched [sot] step
         for language "auto", window decode loop with the ladder and
         best_of candidates, or batched beam search (a stream's beams as
         K2's G queries on its cross-KV row); energy token timestamps

    python -m whisper_tpu_torch.server (server.py): whisper-server
      -> audio/io.load_audio (WAV, FLAC, MP3, Ogg Vorbis), then with
         --batch N a ContinuousBatcher (parallel/batch.py) per decode
         signature, its batch refilled between window iterations, else
         `full` under a lock; bodies formatted as whisper_tpu's

    python -m whisper_tpu_torch.cli (cli.py): whisper-cli
      -> load_audio, then WhisperContext.full_parallel (api.py): `full`,
         or with -p N the chunks batched through BatchTranscriber, or run
         serially on fresh states when the params need the serial path
      -> DTW token timestamps (dtw.py): a teacher-forced re-decode of each
         window that captures the alignment heads' cross-attention
         (models/whisper.py decode_prompt_cross_qk, its linears through
         K3), then a host DTW
      -> GBNF grammars (grammar.py, the native C++ engine built from
         native/wtpu_grammar.cpp) and logits-filter callbacks on the host
         loops of decode/grammar_loop.py (speculative device chunks at
         t = 0) and decode/host_beam.py
      -> the writers of outputs.py

    python -m whisper_tpu_torch.stream / .command / .lsp (stream.py,
    command.py, lsp.py): whisper-stream, whisper-command, whisper-lsp
      -> PCM from a file, stdin or a microphone, cut by the energy VAD
         (audio/vad.py) or in fixed steps, then `full`; lsp's guided mode
         a prompt pass (models/whisper.py decode_prompt, K3) over a
         commandset prompt

    python -m whisper_tpu_torch.quantize (quantize.py), chessboard.py and
    weights/hf.py are copies of whisper_tpu's JAX-free tools.

    whisper_tpu_torch.capi (capi.py): whisper.h's functions by name, over
    `WhisperContext` (use_gpu / gpu_device choose the device); its
    `library_path()` builds libwhisper_tpu.so, the whisper.h C ABI over
    this module (native/wtpu_capi.cpp), for C programs and the bindings
      -> whisper_encode (K1) and whisper_decode (the prompt pass and
         decode steps, the packed linears through K3)

    python -m whisper_tpu_torch.bench_tool (bench_tool.py): whisper-bench
      -> Enc / Dec / Bch5 / PP on the model's encode, decode_step and
         decode_prompt (K1; K3 at M = 1, 5 and 256 over a packed file),
         memcpy and mul_mat, and the stream step's latency (-w 3)

The fused log-mel kernel K7 (ops/mel_pallas.py, csrc/log_mel.cu) runs in
`log_mel_pallas`, as whisper_tpu's Pallas mel kernel does.  On CPU tensors
every kernel wrapper runs its plain PyTorch version; on CUDA tensors it
launches the hand-written kernel or raises.
"""

from .api import (BeamSearchParams, FullParams, GreedyParams,
                  SamplingStrategy, Segment, TokenData, WhisperContext,
                  WhisperState, full_default_params)
from .constants import CHUNK_SIZE, HOP_LENGTH, N_FFT, SAMPLE_RATE
from .languages import lang_id, lang_max_id, lang_str, lang_str_full
from .parallel.batch import BatchTranscriber, ContinuousBatcher
from .utils.logging import log_set

__all__ = ["BatchTranscriber", "BeamSearchParams", "ContinuousBatcher",
           "FullParams", "GreedyParams", "SamplingStrategy", "Segment",
           "TokenData", "WhisperContext", "WhisperState",
           "full_default_params", "SAMPLE_RATE", "N_FFT", "HOP_LENGTH",
           "CHUNK_SIZE", "lang_id", "lang_str", "lang_str_full",
           "lang_max_id", "log_set"]
