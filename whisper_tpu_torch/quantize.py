"""Model quantization tool (examples/quantize equivalent; copy of
whisper_tpu.quantize).

Rewrites a ggml Whisper model with 2-D weights quantized to
q4_0/q4_1/q5_0/q5_1/q8_0, skipping conv weights, positional embeddings,
norms and biases (reference: examples/quantize/quantize.cpp +
examples/common-ggml.cpp ggml_common_quantize_0).

Usage: python -m whisper_tpu_torch.quantize model-f32.bin model-q5_0.bin q5_0
"""

from __future__ import annotations

import argparse
import sys

from .weights import quant
from .weights.ggml_reader import read_ggml_file
from .weights.ggml_writer import write_ggml

QTYPE_BY_NAME = {
    "q4_0": quant.GGML_TYPE_Q4_0,
    "q4_1": quant.GGML_TYPE_Q4_1,
    "q5_0": quant.GGML_TYPE_Q5_0,
    "q5_1": quant.GGML_TYPE_Q5_1,
    "q8_0": quant.GGML_TYPE_Q8_0,
}
# ftype ids as used by the quantize example (ggml_ftype values)
FTYPE_BY_NAME = {"q4_0": 2, "q4_1": 3, "q8_0": 7, "q5_0": 8, "q5_1": 9}


def quantize_model(fname_in: str, fname_out: str, qname: str) -> dict:
    if qname not in QTYPE_BY_NAME:
        raise ValueError(f"invalid quantization type '{qname}' "
                         f"(expected one of {list(QTYPE_BY_NAME)})")
    mf = read_ggml_file(fname_in)
    hp = mf.hparams

    tensors = {}
    for name, rt in mf.tensors.items():
        tensors[name] = rt.to_numpy()

    # vocab as stored in the file (synthesized specials are not written)
    n_file_tokens = _count_file_tokens(fname_in)
    tokens = [mf.vocab.id_to_token[i] for i in range(n_file_tokens)]

    hparams = {
        "n_vocab": hp.n_vocab, "n_audio_ctx": hp.n_audio_ctx,
        "n_audio_state": hp.n_audio_state, "n_audio_head": hp.n_audio_head,
        "n_audio_layer": hp.n_audio_layer, "n_text_ctx": hp.n_text_ctx,
        "n_text_state": hp.n_text_state, "n_text_head": hp.n_text_head,
        "n_text_layer": hp.n_text_layer, "n_mels": hp.n_mels,
    }
    write_ggml(fname_out, hparams, mf.filters, tokens, tensors,
               ftype=FTYPE_BY_NAME[qname], qtype=QTYPE_BY_NAME[qname])

    import os
    return {
        "in_bytes": os.path.getsize(fname_in),
        "out_bytes": os.path.getsize(fname_out),
        "n_tensors": len(tensors),
    }


def _count_file_tokens(path: str) -> int:
    """Number of vocab entries physically present in the file."""
    import struct
    with open(path, "rb") as f:
        f.read(4 + 44)
        n_mel, n_fft = struct.unpack("<2i", f.read(8))
        f.seek(4 * n_mel * n_fft, 1)
        return struct.unpack("<i", f.read(4))[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-quantize")
    ap.add_argument("model_in")
    ap.add_argument("model_out")
    ap.add_argument("type", choices=list(QTYPE_BY_NAME))
    args = ap.parse_args(argv)
    stats = quantize_model(args.model_in, args.model_out, args.type)
    print(f"quantized '{args.model_in}' -> '{args.model_out}' ({args.type}): "
          f"{stats['in_bytes'] / 1e6:.1f} MB -> {stats['out_bytes'] / 1e6:.1f} MB",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
