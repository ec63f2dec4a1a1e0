"""Writer for the legacy ggml Whisper container (copy of
whisper_tpu.weights.ggml_writer).

Produces the reference converter's layout (models/convert-pt-to-ggml.py:
265-342): f32 tensors for 1-D / conv-bias / positional embeddings, f16
(or quantized) for the rest.  `write_ggml` takes whole arrays, as the
original does; `write_header` and `write_tensor` are its two halves, for
callers that stream a large file one tensor at a time, as
`write_random_model` does to make a full-size random-weight file without
quantizing floats.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterable

import numpy as np

from ..constants import GGML_FILE_MAGIC
from . import quant

# tensors that always stay f32 (reference: convert-pt-to-ggml.py:306-317)
_ALWAYS_F32 = {
    "encoder.conv1.bias",
    "encoder.conv2.bias",
    "encoder.positional_embedding",
    "decoder.positional_embedding",
}

# tensors never quantized by the quantize tool
# (reference: examples/common-ggml.cpp ggml_common_quantize_0 skip list)
QUANTIZE_SKIP_SUFFIXES = (".bias",)
QUANTIZE_SKIP_NAMES = {
    "encoder.conv1.weight",
    "encoder.conv2.weight",
    "encoder.positional_embedding",
    "decoder.positional_embedding",
}

HPARAM_KEYS = ("n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
               "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head",
               "n_text_layer", "n_mels")


def write_header(f: BinaryIO, hparams: dict, filters: np.ndarray,
                 tokens: Iterable[bytes], ftype: int = 1) -> None:
    """Magic, hparams, mel filters and vocab: everything before the
    tensors."""
    tokens = list(tokens)
    f.write(struct.pack("<I", GGML_FILE_MAGIC))
    for key in HPARAM_KEYS:
        f.write(struct.pack("<i", hparams[key]))
    f.write(struct.pack("<i", ftype))

    f.write(struct.pack("<i", filters.shape[0]))
    f.write(struct.pack("<i", filters.shape[1]))
    f.write(np.ascontiguousarray(filters, dtype="<f4").tobytes())

    f.write(struct.pack("<i", len(tokens)))
    for tok in tokens:
        if isinstance(tok, str):
            tok = tok.encode("utf-8")
        f.write(struct.pack("<I", len(tok)))
        f.write(tok)


def write_tensor(f: BinaryIO, name: str, ttype: int, shape: tuple[int, ...],
                 payload: bytes) -> None:
    """One tensor record: `payload` is the raw data of numpy-order `shape`
    stored as ggml type `ttype`."""
    if len(payload) != quant.type_nbytes(ttype, int(np.prod(shape))):
        raise ValueError(f"{name}: {len(payload)} bytes do not hold {shape} "
                         f"as ggml type {ttype}")
    name_b = name.encode("utf-8")
    f.write(struct.pack("<3i", len(shape), len(name_b), ttype))
    for i in range(len(shape)):
        f.write(struct.pack("<i", shape[len(shape) - 1 - i]))
    f.write(name_b)
    f.write(payload)


def encode_tensor(name: str, data: np.ndarray, ftype: int = 1,
                  qtype: int | None = None) -> tuple[int, tuple, bytes]:
    """The type, shape and bytes `write_ggml` stores for one array."""
    data = np.squeeze(np.asarray(data))
    if name in ("encoder.conv1.bias", "encoder.conv2.bias"):
        data = data.reshape(-1, 1)

    if qtype is not None and data.ndim == 2 \
            and name not in QUANTIZE_SKIP_NAMES \
            and not name.endswith(QUANTIZE_SKIP_SUFFIXES) \
            and data.shape[-1] % quant.QK == 0:
        ttype = qtype
        payload = quant.QUANTIZERS[qtype](data.astype(np.float32))
    elif ftype == 0 or data.ndim < 2 or name in _ALWAYS_F32:
        ttype = quant.GGML_TYPE_F32
        payload = np.ascontiguousarray(data, dtype="<f4").tobytes()
    else:
        ttype = quant.GGML_TYPE_F16
        payload = np.ascontiguousarray(data, dtype="<f2").tobytes()
    return ttype, data.shape, payload


def write_ggml(path: str,
               hparams: dict,
               filters: np.ndarray,
               tokens: Iterable[bytes],
               tensors: dict[str, np.ndarray],
               ftype: int = 1,
               qtype: int | None = None) -> None:
    """Write a Whisper ggml file.

    hparams keys: n_vocab n_audio_ctx n_audio_state n_audio_head
    n_audio_layer n_text_ctx n_text_state n_text_head n_text_layer n_mels.
    ftype: 0=f32, 1=f16, or a quantized ggml_ftype (2,3,7,8,9) with `qtype`
    the matching ggml_type for 2-D weights.
    """
    with open(path, "wb") as f:
        write_header(f, hparams, filters, tokens, ftype)
        for name, data in tensors.items():
            write_tensor(f, name, *encode_tensor(name, data, ftype, qtype))


# ggml file type name -> (ftype, ggml type of the 2-D weights)
FILE_TYPES = {"f32": (0, None), "f16": (1, None),
              "q4_0": (2, quant.GGML_TYPE_Q4_0),
              "q4_1": (3, quant.GGML_TYPE_Q4_1),
              "q5_0": (8, quant.GGML_TYPE_Q5_0),
              "q5_1": (9, quant.GGML_TYPE_Q5_1),
              "q8_0": (7, quant.GGML_TYPE_Q8_0)}

# per block type: (first code, number of codes, 2 if the block stores a
# min after its scale); codes are uniform over their range in random bytes
_CODE_RANGE = {quant.GGML_TYPE_Q4_0: (-8, 16, 0),
               quant.GGML_TYPE_Q4_1: (0, 16, 2),
               quant.GGML_TYPE_Q5_0: (-16, 32, 0),
               quant.GGML_TYPE_Q5_1: (0, 32, 2),
               quant.GGML_TYPE_Q8_0: (-128, 256, 0)}


def model_tensor_shapes(hp: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(ggml name, numpy shape) of every tensor of a Whisper model
    (reference: src/whisper-arch.h:42-141)."""
    da, dt = hp["n_audio_state"], hp["n_text_state"]

    def block(pre, d, cross):
        out = [(f"{pre}.attn_ln.weight", (d,)), (f"{pre}.attn_ln.bias", (d,)),
               (f"{pre}.attn.query.weight", (d, d)),
               (f"{pre}.attn.query.bias", (d,)),
               (f"{pre}.attn.key.weight", (d, d)),
               (f"{pre}.attn.value.weight", (d, d)),
               (f"{pre}.attn.value.bias", (d,)),
               (f"{pre}.attn.out.weight", (d, d)),
               (f"{pre}.attn.out.bias", (d,))]
        if cross:
            x = f"{pre}.cross_attn"
            out += [(f"{x}_ln.weight", (d,)), (f"{x}_ln.bias", (d,)),
                    (f"{x}.query.weight", (d, d)), (f"{x}.query.bias", (d,)),
                    (f"{x}.key.weight", (d, d)),
                    (f"{x}.value.weight", (d, d)), (f"{x}.value.bias", (d,)),
                    (f"{x}.out.weight", (d, d)), (f"{x}.out.bias", (d,))]
        return out + [(f"{pre}.mlp_ln.weight", (d,)),
                      (f"{pre}.mlp_ln.bias", (d,)),
                      (f"{pre}.mlp.0.weight", (4 * d, d)),
                      (f"{pre}.mlp.0.bias", (4 * d,)),
                      (f"{pre}.mlp.2.weight", (d, 4 * d)),
                      (f"{pre}.mlp.2.bias", (d,))]

    shapes = [("encoder.conv1.weight", (da, hp["n_mels"], 3)),
              ("encoder.conv1.bias", (da,)),
              ("encoder.conv2.weight", (da, da, 3)),
              ("encoder.conv2.bias", (da,)),
              ("encoder.positional_embedding", (hp["n_audio_ctx"], da)),
              ("encoder.ln_post.weight", (da,)),
              ("encoder.ln_post.bias", (da,)),
              ("decoder.token_embedding.weight", (hp["n_vocab"], dt)),
              ("decoder.positional_embedding", (hp["n_text_ctx"], dt)),
              ("decoder.ln.weight", (dt,)), ("decoder.ln.bias", (dt,))]
    for i in range(hp["n_audio_layer"]):
        shapes += block(f"encoder.blocks.{i}", da, False)
    for i in range(hp["n_text_layer"]):
        shapes += block(f"decoder.blocks.{i}", dt, True)
    return shapes


def random_blocks(qtype: int, n: int, rng: np.random.Generator,
                  std: float) -> bytes:
    """`n` values as valid random blocks of ggml type `qtype`: codes drawn
    uniformly from random bytes, one f16 scale chosen so the weights have
    standard deviation ~`std` and, for the types with a min, mean ~0."""
    lo, count, has_min = _CODE_RANGE[qtype]
    bs = quant.TYPE_SIZES[qtype][0]
    nb = n // quant.QK
    blocks = np.frombuffer(rng.bytes(nb * bs), np.uint8).reshape(nb, bs).copy()
    code_std = count / np.sqrt(12.0)
    d = np.float16(std / code_std)
    blocks[:, 0:2] = np.frombuffer(d.tobytes(), np.uint8)
    if has_min:
        mid = lo + (count - 1) / 2.0
        blocks[:, 2:4] = np.frombuffer(np.float16(-mid * float(d)).tobytes(),
                                       np.uint8)
    return blocks.tobytes()


def write_random_model(path: str, hparams: dict, filters: np.ndarray,
                       tokens: Iterable[bytes], kind: str = "q5_0",
                       seed: int = 0, std: float = 0.02) -> None:
    """A random-weight model file of type `kind` (a FILE_TYPES key),
    written tensor by tensor: weights the quantize tool would quantize
    become random valid blocks (random_blocks), other weights N(0, std^2)
    in f16/f32, layernorm scales one and biases zero.  Only one tensor is
    in memory at a time."""
    ftype, qtype = FILE_TYPES[kind]
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        write_header(f, hparams, filters, tokens, ftype)
        for name, shape in model_tensor_shapes(hparams):
            if name in ("encoder.conv1.bias", "encoder.conv2.bias"):
                shape = shape + (1,)
            packed = (qtype is not None and len(shape) == 2
                      and name not in QUANTIZE_SKIP_NAMES
                      and not name.endswith(QUANTIZE_SKIP_SUFFIXES)
                      and shape[-1] % quant.QK == 0)
            if packed:
                write_tensor(f, name, qtype, shape,
                             random_blocks(qtype, int(np.prod(shape)), rng,
                                           std))
                continue
            if name.endswith(("ln.weight", "ln_post.weight")):
                data = np.ones(shape, np.float32)
            elif name.endswith(".bias"):
                data = np.zeros(shape, np.float32)
            else:
                data = rng.standard_normal(shape, np.float32) * np.float32(std)
            write_tensor(f, name, *encode_tensor(name, data, ftype))
