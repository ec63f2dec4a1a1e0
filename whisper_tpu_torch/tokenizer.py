"""Tokenization (copy of whisper_tpu.tokenizer: `tokenize`, `detokenize`
and the GPT-2 byte table behind `hf_token_to_bytes`).

The reference tokenizer (reference: src/whisper.cpp:3283-3331) is a
GPT-2-style regex word split followed by greedy longest-substring matching
against the vocab (no BPE merges table is stored in ggml files).  It is used
only for `initial_prompt`; decoding needs just the id -> bytes table.
"""

from __future__ import annotations

import re

from .weights.vocab import Vocab

# GPT-2 word-split pattern.  The reference runs std::regex with default
# (C-locale) traits over the raw BYTES of the string, so [[:alpha:]] and
# [[:digit:]] are ASCII-only and every non-ASCII utf-8 byte falls into the
# "punct" class [^\s[:alpha:][:digit:]]+ — replicated here as a BYTES
# regex with explicit ASCII classes.
_SPLIT_RE = re.compile(
    rb"'s|'t|'re|'ve|'m|'ll|'d"
    rb"| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+",
)


def tokenize(vocab: Vocab, text: str) -> list[int]:
    """Text -> token ids by greedy longest-substring match per word."""
    tokens: list[int] = []
    for data in _SPLIT_RE.findall(text.encode("utf-8")):
        if not data:
            continue
        i, n = 0, len(data)
        while i < n:
            j = n
            found = False
            while j > i:
                tid = vocab.token_to_id.get(data[i:j])
                if tid is not None:
                    tokens.append(tid)
                    i = j
                    found = True
                    break
                j -= 1
            if not found:
                i += 1  # skip one byte, like the reference's "unknown token"
    return tokens


def detokenize(vocab: Vocab, ids, skip_special: bool = True) -> str:
    """Token ids -> text (bytes concatenated, then utf-8 decoded)."""
    buf = b""
    for tid in ids:
        tid = int(tid)
        if skip_special and tid >= vocab.token_eot:
            continue
        buf += vocab.id_to_token[tid]
    return buf.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# GPT-2 byte <-> unicode mapping (needed when importing HF vocab files, which
# store tokens in the escaped byte-level representation; reference converter:
# models/convert-pt-to-ggml.py bytes_to_unicode)
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\u00a1"), ord("\u00ac") + 1))
          + list(range(ord("\u00ae"), ord("\u00ff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_ENCODER = _bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


def hf_token_to_bytes(token: str) -> bytes:
    """Convert an HF byte-level BPE token string to raw bytes."""
    return bytes(_BYTE_DECODER[ch] for ch in token)
