"""Reader for the legacy ggml Whisper model container (copy of
whisper_tpu.weights.ggml_reader; `Vocab` and `special_token_ids` come from
weights/vocab.py, so the port has one Vocab class).

File layout (reference: src/whisper.cpp:1487-1969, writer
models/convert-pt-to-ggml.py:265-342):

    uint32  magic = 0x67676d6c ("ggml" LE)
    int32   n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
            n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels, ftype
    int32   filters.n_mel, filters.n_fft
    f32     filters[n_mel * n_fft]
    int32   n_vocab_in_file
    repeat: uint32 len; bytes token[len]
    repeat until EOF:
        int32 n_dims, name_len, ttype
        int32 ne[n_dims]            (ggml order: ne[0] is contiguous)
        bytes name[name_len]
        raw tensor data (ggml type `ttype`), NO alignment padding

All integers little-endian.  Tensor numpy shape = reversed(ne).
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO

import numpy as np

from ..constants import GGML_FILE_MAGIC, MODEL_TYPE_BY_AUDIO_LAYERS
from ..languages import lang_str
from . import quant
from .vocab import Vocab, special_token_ids

GGML_QNT_VERSION_FACTOR = 1000  # reference: ggml/include/ggml.h GGML_QNT_VERSION_FACTOR


@dataclasses.dataclass
class Hparams:
    """Model hyper-parameters (reference: src/whisper.cpp:634-647)."""
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_mels: int
    ftype: int

    @property
    def model_type(self) -> str:
        base = MODEL_TYPE_BY_AUDIO_LAYERS.get(self.n_audio_layer, "unknown")
        if base == "large" and self.n_vocab == 51866:
            return "large-v3"
        return base


@dataclasses.dataclass
class RawTensor:
    name: str
    ttype: int           # ggml type id
    ne: tuple[int, ...]  # ggml order (ne[0] contiguous)
    data: bytes          # raw on-disk bytes

    @property
    def shape(self) -> tuple[int, ...]:
        """Numpy row-major shape."""
        return tuple(reversed(self.ne))

    def to_numpy(self) -> np.ndarray:
        return quant.decode_tensor(self.data, self.ttype, self.shape)


@dataclasses.dataclass
class GgmlModelFile:
    hparams: Hparams
    filters: np.ndarray          # (n_mel, n_fft) f32 mel filterbank
    vocab: Vocab
    tensors: dict[str, RawTensor]
    wtype: int                   # ggml type of the "mostly" weights

    @property
    def n_loaded(self) -> int:
        return len(self.tensors)


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", f.read(4))[0]


def _read_u32(f: BinaryIO) -> int:
    return struct.unpack("<I", f.read(4))[0]


def _build_vocab(hparams: Hparams, tokens_in_file: list[bytes]) -> Vocab:
    """Replicates reference vocab construction (src/whisper.cpp:1601-1688)."""
    id_to_token = list(tokens_in_file)
    vocab = Vocab(
        n_vocab=hparams.n_vocab,
        id_to_token=id_to_token,
        token_to_id={},
        **special_token_ids(hparams.n_vocab),
    )

    # synthesize names for special tokens not present in the file
    if len(id_to_token) < hparams.n_vocab:
        for i in range(len(id_to_token), hparams.n_vocab):
            if i > vocab.token_beg:
                word = f"[_TT_{i - vocab.token_beg}]"
            elif i == vocab.token_eot:
                word = "[_EOT_]"
            elif i == vocab.token_sot:
                word = "[_SOT_]"
            elif i == vocab.token_translate:
                word = "[_TRANSLATE_]"
            elif i == vocab.token_transcribe:
                word = "[_TRANSCRIBE_]"
            elif i == vocab.token_solm:
                word = "[_SOLM_]"
            elif i == vocab.token_prev:
                word = "[_PREV_]"
            elif i == vocab.token_nosp:
                word = "[_NOSP_]"
            elif i == vocab.token_not:
                word = "[_NOT_]"
            elif i == vocab.token_beg:
                word = "[_BEG_]"
            elif vocab.token_sot < i <= vocab.token_sot + vocab.num_languages:
                word = f"[_LANG_{lang_str(i - vocab.token_sot - 1)}]"
            else:
                word = f"[_extra_token_{i}]"
            id_to_token.append(word.encode("utf-8"))

    vocab.token_to_id = {tok: i for i, tok in enumerate(id_to_token)}
    return vocab


def read_ggml_file(path_or_file) -> GgmlModelFile:
    """Parse a legacy ggml Whisper model file (or file-like / bytes)."""
    if isinstance(path_or_file, (str, bytes)) and not hasattr(path_or_file, "read"):
        if isinstance(path_or_file, bytes):
            f: BinaryIO = io.BytesIO(path_or_file)
        else:
            f = open(path_or_file, "rb")
    else:
        f = path_or_file

    magic = _read_u32(f)
    if magic != GGML_FILE_MAGIC:
        raise ValueError(f"invalid model data (bad magic 0x{magic:08x})")

    fields = struct.unpack("<11i", f.read(44))
    hparams = Hparams(*fields)
    # quantization version is folded into ftype (reference: whisper.cpp:1562-1565)
    hparams.ftype = hparams.ftype % GGML_QNT_VERSION_FACTOR
    if hparams.ftype not in quant.FTYPE_TO_TYPE:
        raise ValueError(f"invalid model (bad ftype value {hparams.ftype})")
    wtype = quant.FTYPE_TO_TYPE[hparams.ftype]

    n_mel = _read_i32(f)
    n_fft = _read_i32(f)
    filters = np.frombuffer(f.read(4 * n_mel * n_fft), dtype="<f4").reshape(n_mel, n_fft)

    n_vocab_file = _read_i32(f)
    tokens = []
    for _ in range(n_vocab_file):
        ln = _read_u32(f)
        tokens.append(f.read(ln) if ln else b"")
    vocab = _build_vocab(hparams, tokens)

    tensors: dict[str, RawTensor] = {}
    while True:
        head = f.read(12)
        if len(head) < 12:
            break
        n_dims, name_len, ttype = struct.unpack("<3i", head)
        ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
        name = f.read(name_len).decode("utf-8")
        nelements = int(np.prod(ne))
        nbytes = quant.type_nbytes(ttype, nelements)
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(f"truncated tensor data for '{name}'")
        tensors[name] = RawTensor(name=name, ttype=ttype, ne=tuple(ne), data=data)

    if hasattr(f, "close") and f is not path_or_file:
        f.close()

    return GgmlModelFile(hparams=hparams, filters=filters.copy(), vocab=vocab,
                         tensors=tensors, wtype=wtype)
