"""Vocab and special-token layout (copied from whisper_tpu.weights.ggml_reader).

Importing the original module runs whisper_tpu/__init__.py, which imports
JAX, so the port keeps its own copy of these JAX-free pieces.  The ggml
reader (weights/ggml_reader.py) builds its vocab with this class.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Vocab:
    """Token table + special ids (reference: src/whisper.cpp:473-502)."""
    n_vocab: int
    id_to_token: list[bytes]
    token_to_id: dict[bytes, int]
    token_eot: int = 50256
    token_sot: int = 50257
    token_translate: int = 50357
    token_transcribe: int = 50358
    token_solm: int = 50359
    token_prev: int = 50360
    token_nosp: int = 50361
    token_not: int = 50362
    token_beg: int = 50363

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)

    def token_lang(self, lang_id: int) -> int:
        """whisper_token_lang (reference: src/whisper.cpp:4231)."""
        return self.token_sot + 1 + lang_id

    def token_str(self, tid: int) -> str:
        return self.id_to_token[tid].decode("utf-8", errors="replace")

    def token_bytes(self, tid: int) -> bytes:
        return self.id_to_token[tid]


def special_token_ids(n_vocab: int) -> dict[str, int]:
    """The special-token layout for a vocab size.

    Reference: src/whisper.cpp:473-502 (GPT-2 defaults) and :1637-1652
    (multilingual adjustment): multilingual shifts eot/sot by ONE and the
    later specials by dt = num_languages - 98.
    """
    multilingual = n_vocab >= 51865
    shift = 1 if multilingual else 0
    dt = (n_vocab - 51864) if multilingual else 0
    return dict(
        token_eot=50256 + shift, token_sot=50257 + shift,
        token_translate=50357 + dt, token_transcribe=50358 + dt,
        token_solm=50359 + dt, token_prev=50360 + dt,
        token_nosp=50361 + dt, token_not=50362 + dt,
        token_beg=50363 + dt)


def synthetic_vocab(n_vocab: int) -> Vocab:
    """Vocab with correct special ids but synthetic token strings."""
    id_to_token = [b" t%d" % i for i in range(n_vocab)]
    return Vocab(
        n_vocab=n_vocab, id_to_token=id_to_token,
        token_to_id={t: i for i, t in enumerate(id_to_token)},
        **special_token_ids(n_vocab))
