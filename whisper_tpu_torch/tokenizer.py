"""Tokenization (copy of whisper_tpu.tokenizer's `tokenize`).

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
