"""GBNF grammar-constrained decoding (copy of whisper_tpu.grammar).

Pushdown-automaton grammar engine equivalent to the reference's
(reference: src/whisper.cpp:4355-4768) plus a GBNF text parser equivalent
to examples/grammar-parser.cpp.  Grammar state advances on the host between
device steps; rejected tokens get `grammar_penalty` subtracted from their
logits (reference: whisper_suppress_invalid_grammar, whisper.cpp:4695-4737).

Element encoding matches whisper_grammar_element
(reference: include/whisper.h:117-141).  The native engine is the same
pushdown automaton in C++ (native/wtpu_grammar.cpp), which this module
compiles with the host's C++ compiler on first use into the port's build
directory (build/whisper_tpu_torch/, next to the CUDA kernels).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import shutil  # noqa: F401  (native_build's compiler lookup, shutil.which)
from pathlib import Path

import numpy as np

from .utils import native_build
from .utils.logging import log_warn

PKG_DIR = Path(__file__).resolve().parent
NATIVE_SRC = PKG_DIR.parent / "native" / "wtpu_grammar.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "whisper_tpu_torch"
# native/Makefile's flags for libwtpu_grammar.so but -march=native: the
# build directory travels with a copy of the checkout to other hosts, and
# the library's name keys on the source and these flags, not the host CPU
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread"]

# whisper_gretype (reference: include/whisper.h:117-134)
END = 0
ALT = 1
RULE_REF = 2
CHAR = 3
CHAR_NOT = 4
CHAR_RNG_UPPER = 5
CHAR_ALT = 6


@dataclasses.dataclass(frozen=True)
class Element:
    type: int
    value: int


@dataclasses.dataclass
class PartialUtf8:
    value: int = 0
    n_remain: int = 0


def decode_utf8(data: bytes, partial: PartialUtf8) -> tuple[list[int], PartialUtf8]:
    """UTF-8 -> code points, resuming/producing partial multibyte state
    (reference: src/whisper.cpp:4355-4410).  Appends a 0 sentinel."""
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4]
    pos = 0
    code_points: list[int] = []
    value = partial.value
    n_remain = partial.n_remain

    while pos < len(data) and n_remain > 0:
        byte = data[pos]
        if (byte >> 6) != 2:
            return [0], PartialUtf8(0, -1)
        value = (value << 6) + (byte & 0x3F)
        pos += 1
        n_remain -= 1

    if partial.n_remain > 0 and n_remain == 0:
        code_points.append(value)

    while pos < len(data):
        first = data[pos]
        highbits = first >> 4
        n_remain = lookup[highbits] - 1
        if n_remain < 0:
            return [0], PartialUtf8(0, n_remain)
        mask = (1 << (7 - n_remain)) - 1
        value = first & mask
        pos += 1
        while pos < len(data) and n_remain > 0:
            value = (value << 6) + (data[pos] & 0x3F)
            pos += 1
            n_remain -= 1
        if n_remain == 0:
            code_points.append(value)

    code_points.append(0)
    return code_points, PartialUtf8(value, n_remain)


def _is_end_of_sequence(elem: Element) -> bool:
    return elem.type in (END, ALT)


def _match_char(rule: list[Element], pos: int, chr_: int) -> tuple[bool, int]:
    """-> (matched, pos after the char-range group)."""
    found = False
    is_positive = rule[pos].type == CHAR
    assert is_positive or rule[pos].type == CHAR_NOT
    while True:
        if pos + 1 < len(rule) and rule[pos + 1].type == CHAR_RNG_UPPER:
            found = found or (rule[pos].value <= chr_ <= rule[pos + 1].value)
            pos += 2
        else:
            found = found or rule[pos].value == chr_
            pos += 1
        if pos >= len(rule) or rule[pos].type != CHAR_ALT:
            break
    return found == is_positive, pos


def _match_partial_char(rule: list[Element], pos: int,
                        partial: PartialUtf8) -> bool:
    is_positive = rule[pos].type == CHAR
    value, n_remain = partial.value, partial.n_remain
    if n_remain < 0 or (n_remain == 1 and value < 2):
        return False
    low = value << (n_remain * 6)
    high = low | ((1 << (n_remain * 6)) - 1)
    if low == 0:
        if n_remain == 2:
            low = 1 << 11
        elif n_remain == 3:
            low = 1 << 16
    while True:
        if pos + 1 < len(rule) and rule[pos + 1].type == CHAR_RNG_UPPER:
            if rule[pos].value <= high and low <= rule[pos + 1].value:
                return is_positive
            pos += 2
        else:
            if low <= rule[pos].value <= high:
                return is_positive
            pos += 1
        if pos >= len(rule) or rule[pos].type != CHAR_ALT:
            break
    return not is_positive


# A stack entry is (rule_id, pos) pointing into rules[rule_id].
Stack = tuple  # tuple of (rule_id, pos) pairs; top is last


class Grammar:
    """whisper_grammar: rules + set of possible pushdown stacks."""

    def __init__(self, rules: list[list[Element]], start_rule: int = 0):
        self.rules = rules
        self.partial_utf8 = PartialUtf8()
        self.stacks: list[Stack] = []
        pos = 0
        rule = rules[start_rule]
        while True:
            stack: list = []
            if not _is_end_of_sequence(rule[pos]):
                stack.append((start_rule, pos))
            self._advance_stack(tuple(stack), self.stacks)
            while not _is_end_of_sequence(rule[pos]):
                pos += 1
            if rule[pos].type == ALT:
                pos += 1
            else:
                break

    def _elem(self, ref):
        rule_id, pos = ref
        return self.rules[rule_id][pos]

    def _advance_stack(self, stack: Stack, new_stacks: list) -> None:
        """reference: whisper_grammar_advance_stack (whisper.cpp:4498-4550)."""
        if not stack:
            if stack not in new_stacks:
                new_stacks.append(stack)
            return
        rule_id, pos = stack[-1]
        elem = self.rules[rule_id][pos]
        if elem.type == RULE_REF:
            sub_id = elem.value
            sub_rule = self.rules[sub_id]
            subpos = 0
            while True:
                new_stack = list(stack[:-1])
                nxt = self.rules[rule_id][pos + 1]
                if not _is_end_of_sequence(nxt):
                    new_stack.append((rule_id, pos + 1))
                if not _is_end_of_sequence(sub_rule[subpos]):
                    new_stack.append((sub_id, subpos))
                self._advance_stack(tuple(new_stack), new_stacks)
                while not _is_end_of_sequence(sub_rule[subpos]):
                    subpos += 1
                if sub_rule[subpos].type == ALT:
                    subpos += 1
                else:
                    break
        elif elem.type in (CHAR, CHAR_NOT):
            if stack not in new_stacks:
                new_stacks.append(stack)
        else:
            raise AssertionError("malformed grammar stack")

    def _accept_char(self, stacks: list[Stack], chr_: int) -> list[Stack]:
        """reference: whisper_grammar_accept (whisper.cpp:4556-4581)."""
        new_stacks: list[Stack] = []
        for stack in stacks:
            if not stack:
                continue
            rule_id, pos = stack[-1]
            matched, after = _match_char(self.rules[rule_id], pos, chr_)
            if matched:
                new_stack = list(stack[:-1])
                if not _is_end_of_sequence(self.rules[rule_id][after]):
                    new_stack.append((rule_id, after))
                self._advance_stack(tuple(new_stack), new_stacks)
        return new_stacks

    def _reject_candidates(self, stacks: list[Stack], candidates: list) -> list:
        """candidates: list of (token_id, code_points tuple w/ 0 sentinel,
        cp_offset, PartialUtf8).  Returns rejected candidates."""
        if not candidates or not stacks:
            return []
        rejects = self._reject_for_stack(stacks[0], candidates)
        for stack in stacks[1:]:
            rejects = self._reject_for_stack(stack, rejects)
        return rejects

    def _reject_for_stack(self, stack: Stack, candidates: list) -> list:
        """reference: whisper_grammar_reject_candidates_for_stack
        (whisper.cpp:4588-4634)."""
        rejects = []
        if not stack:
            return [c for c in candidates
                    if c[1][c[2]] != 0 or c[3].n_remain != 0]

        rule_id, pos = stack[-1]
        rule = self.rules[rule_id]
        next_candidates = []
        for c in candidates:
            tid, cps, off, partial = c
            if cps[off] == 0:
                if partial.n_remain != 0 and \
                        not _match_partial_char(rule, pos, partial):
                    rejects.append(c)
            elif _match_char(rule, pos, cps[off])[0]:
                next_candidates.append((tid, cps, off + 1, partial))
            else:
                rejects.append(c)

        _, after = _match_char(rule, pos, 0)
        stack_after = list(stack[:-1])
        if not _is_end_of_sequence(rule[after]):
            stack_after.append((rule_id, after))
        next_stacks: list[Stack] = []
        self._advance_stack(tuple(stack_after), next_stacks)

        for tid, cps, off, partial in self._reject_candidates(
                next_stacks, next_candidates):
            rejects.append((tid, cps, off - 1, partial))
        return rejects

    # -- public API ------------------------------------------------------

    def suppress_invalid(self, vocab, logits: np.ndarray,
                         penalty: float) -> None:
        """Subtract `penalty` from logits of grammar-rejected tokens."""
        if not self.rules or not self.stacks:
            return
        candidates = []
        for tid in range(vocab.token_eot):
            text = vocab.id_to_token[tid]
            if not text:
                continue
            cps, partial = decode_utf8(text, self.partial_utf8)
            candidates.append((tid, tuple(cps), 0, partial))
        for tid, _, _, _ in self._reject_candidates(self.stacks, candidates):
            logits[tid] -= penalty

    def accept_token(self, vocab, token: int) -> None:
        """reference: whisper_grammar_accept_token (whisper.cpp:4739-4768)."""
        if not self.rules or not self.stacks:
            return
        text = vocab.id_to_token[token]
        if text.startswith(b"[_"):
            return
        cps, partial = decode_utf8(text, self.partial_utf8)
        for cp in cps[:-1]:
            self.stacks = self._accept_char(self.stacks, cp)
        self.partial_utf8 = partial

    def copy(self) -> "Grammar":
        g = Grammar.__new__(Grammar)
        g.rules = self.rules
        g.stacks = list(self.stacks)
        g.partial_utf8 = PartialUtf8(self.partial_utf8.value,
                                     self.partial_utf8.n_remain)
        return g


# ---------------------------------------------------------------------------
# GBNF text parser (reference: examples/grammar-parser.cpp)
# ---------------------------------------------------------------------------

class GrammarParseError(ValueError):
    pass


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.symbol_ids: dict[str, int] = {}
        self.rules: dict[int, list[Element]] = {}

    # -- lexing helpers
    def _ws(self):
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "#":
                while self.pos < len(self.src) and self.src[self.pos] != "\n":
                    self.pos += 1
            else:
                break

    def _peek(self):
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def _get_symbol_id(self, name: str) -> int:
        return self.symbol_ids.setdefault(name, len(self.symbol_ids))

    def _generate_symbol_id(self, base: str) -> int:
        idx = len(self.symbol_ids)
        self.symbol_ids[f"{base}_{idx}"] = idx
        return idx

    def _parse_name(self) -> str:
        start = self.pos
        # NB: membership must be tuple-based: _peek() returns "" at EOF
        # and '"" in "-_"' is True (empty-substring), which loops forever
        while self._peek().isalnum() or self._peek() in ("-", "_"):
            self.pos += 1
        if self.pos == start:
            raise GrammarParseError(f"expecting name at {start}")
        return self.src[start:self.pos]

    def _parse_char(self) -> int:
        c = self._peek()
        if c == "\\":
            self.pos += 1
            esc = self._peek()
            self.pos += 1
            table = {"x": 2, "u": 4, "U": 8}
            if esc in table:
                n = table[esc]
                hexs = self.src[self.pos:self.pos + n]
                self.pos += n
                return int(hexs, 16)
            mapping = {"t": 9, "r": 13, "n": 10, '"': 34, "[": 91, "]": 93,
                       "\\": 92}
            if esc in mapping:
                return mapping[esc]
            raise GrammarParseError(f"unknown escape \\{esc}")
        if c == "":
            raise GrammarParseError("unexpected end of grammar")
        self.pos += 1
        return ord(c)

    # -- grammar structure
    def parse(self) -> tuple[list[list[Element]], dict[str, int]]:
        self._ws()
        while self.pos < len(self.src):
            self._parse_rule()
            self._ws()
        # build dense rule table
        n = len(self.symbol_ids)
        out: list[list[Element]] = [[Element(END, 0)] for _ in range(n)]
        for rid, elems in self.rules.items():
            out[rid] = elems
        for name, rid in self.symbol_ids.items():
            if rid not in self.rules:
                raise GrammarParseError(f"undefined rule '{name}'")
        return out, dict(self.symbol_ids)

    def _parse_rule(self):
        name = self._parse_name()
        self._ws()
        rule_id = self._get_symbol_id(name)
        if self.src[self.pos:self.pos + 3] != "::=":
            raise GrammarParseError(f"expecting ::= at {self.pos}")
        self.pos += 3
        self._ws()
        self._parse_alternates(name, rule_id)
        if self._peek() == "\r":
            self.pos += 1
        if self._peek() == "\n":
            self.pos += 1

    def _parse_alternates(self, name: str, rule_id: int):
        elems: list[Element] = []
        self._parse_sequence(name, elems)
        while self._peek() == "|":
            self.pos += 1
            self._ws_nl()
            elems.append(Element(ALT, 0))
            self._parse_sequence(name, elems)
        elems.append(Element(END, 0))
        self.rules[rule_id] = elems

    def _ws_nl(self):
        # whitespace incl. newlines (used inside alternates/parens)
        self._ws()

    def _parse_sequence(self, name: str, out: list[Element]):
        last_sym_start = len(out)
        while True:
            self._ws_inline()
            c = self._peek()
            if c == '"':
                self.pos += 1
                last_sym_start = len(out)
                while self._peek() != '"':
                    out.append(Element(CHAR, self._parse_char()))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                start_type = CHAR
                if self._peek() == "^":
                    self.pos += 1
                    start_type = CHAR_NOT
                last_sym_start = len(out)
                first = True
                while self._peek() != "]":
                    ch = self._parse_char()
                    out.append(Element(
                        start_type if first else CHAR_ALT, ch))
                    first = False
                    if self._peek() == "-" and \
                            self.src[self.pos + 1:self.pos + 2] != "]":
                        self.pos += 1
                        out.append(Element(CHAR_RNG_UPPER, self._parse_char()))
                self.pos += 1
            elif c.isalnum() or c in ("-", "_"):
                name_start = self.pos
                ref = self._parse_name()
                del name_start
                last_sym_start = len(out)
                out.append(Element(RULE_REF, self._get_symbol_id(ref)))
            elif c == "(":
                self.pos += 1
                self._ws_nl()
                sub_id = self._generate_symbol_id(name)
                self._parse_alternates_into(name, sub_id)
                if self._peek() != ")":
                    raise GrammarParseError(f"expecting ) at {self.pos}")
                self.pos += 1
                last_sym_start = len(out)
                out.append(Element(RULE_REF, sub_id))
            elif c in ("*", "+", "?"):
                if last_sym_start == len(out):
                    raise GrammarParseError(
                        f"expecting preceding item to */+/? at {self.pos}")
                sub = out[last_sym_start:]
                del out[last_sym_start:]
                sub_id = self._generate_symbol_id(name)
                sub_rule = list(sub)
                if c in "*+":
                    sub_rule.append(Element(RULE_REF, sub_id))
                sub_rule.append(Element(ALT, 0))
                if c == "+":
                    sub_rule.extend(sub)
                sub_rule.append(Element(END, 0))
                self.rules[sub_id] = sub_rule
                out.append(Element(RULE_REF, sub_id))
                self.pos += 1
            else:
                break
        return

    def _ws_inline(self):
        while self._peek() in (" ", "\t"):   # tuple: "" at EOF must not match
            self.pos += 1
        if self._peek() == "#":
            while self.pos < len(self.src) and self.src[self.pos] != "\n":
                self.pos += 1

    def _parse_alternates_into(self, name: str, rule_id: int):
        elems: list[Element] = []
        self._parse_sequence(name, elems)
        while self._peek() == "|":
            self.pos += 1
            self._ws_nl()
            elems.append(Element(ALT, 0))
            self._parse_sequence(name, elems)
        elems.append(Element(END, 0))
        self.rules[rule_id] = elems


def parse_gbnf(src: str) -> tuple[list[list[Element]], dict[str, int]]:
    """GBNF text -> (rules table, symbol name -> rule id)."""
    return _Parser(src).parse()




class NativeGrammar:
    """ctypes wrapper over the native engine (native/wtpu_grammar.cpp,
    built by `_load_native`).

    Same duck-type as Grammar (suppress_invalid / accept_token / copy);
    vocab code-point tables are loaded into the native engine on first use.
    """

    def __init__(self, rules: list[list[Element]], start_rule: int = 0,
                 _handle=None, _lib=None):
        self.rules = rules
        if _handle is not None:
            self._lib = _lib
            self._h = _handle
            self._vocab_loaded = False  # set by copy()
            return
        self._lib = _load_native()
        if self._lib is None:
            raise RuntimeError("native grammar library unavailable")
        types, values, offsets = [], [], [0]
        for rule in rules:
            for e in rule:
                types.append(e.type)
                values.append(e.value)
            offsets.append(len(types))
        t = (ctypes.c_uint32 * len(types))(*types)
        v = (ctypes.c_uint32 * len(values))(*values)
        o = (ctypes.c_int32 * len(offsets))(*offsets)
        self._h = self._lib.wtpu_grammar_init(
            t, v, len(types), o, len(rules), start_rule)
        self._vocab_loaded = False

    @property
    def stacks(self):
        # truthiness probe used by callers; count lives in the engine
        return [None] * self._lib.wtpu_grammar_n_stacks(self._h)

    def _ensure_vocab(self, vocab):
        if self._vocab_loaded:
            return
        # blob build cached ON the vocab object (suppressing per window
        # would otherwise rebuild ~0.5 MB of token bytes every copy).
        # Deliberately not an id()-keyed dict: CPython reuses freed
        # object addresses, so a global id->blob map can serve model A's
        # token table to model B after A is garbage-collected.
        cached = getattr(vocab, "_grammar_vocab_blob", None)
        if cached is None or cached[2] != vocab.token_eot:
            parts = vocab.id_to_token[:vocab.token_eot]
            blob = b"".join(parts)
            offsets = [0]
            for p in parts:
                offsets.append(offsets[-1] + len(p))
            buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
            off = (ctypes.c_int32 * len(offsets))(*offsets)
            cached = (buf, off, vocab.token_eot)
            vocab._grammar_vocab_blob = cached
        buf, off, n = cached
        self._lib.wtpu_grammar_set_vocab(self._h, buf, off, n, n)
        self._vocab_loaded = True

    def suppress_invalid(self, vocab, logits: np.ndarray,
                         penalty: float) -> None:
        self._ensure_vocab(vocab)
        assert logits.dtype == np.float32 and logits.flags["C_CONTIGUOUS"]
        self._lib.wtpu_grammar_suppress(
            self._h, logits.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(logits), ctypes.c_float(penalty))

    def accept_token(self, vocab, token: int) -> None:
        self._ensure_vocab(vocab)
        self._lib.wtpu_grammar_accept(self._h, int(token))

    def copy(self) -> "NativeGrammar":
        h = self._lib.wtpu_grammar_clone(self._h)
        g = NativeGrammar(self.rules, _handle=h, _lib=self._lib)
        g._vocab_loaded = self._vocab_loaded
        return g

    def __del__(self):
        try:
            self._lib.wtpu_grammar_free(self._h)
        except Exception:
            pass


@functools.lru_cache(maxsize=None)
def _load_native():
    """Build (once per source hash) and load the native grammar library
    (utils/native_build); None, with a warning, when the host has no C++
    compiler or the build or load fails.  BUILD_DIR is read at call
    time."""
    lib = native_build.load("native grammar engine", "wtt_grammar",
                            BUILD_DIR, [(NATIVE_SRC, CXX_FLAGS)],
                            CXX_FLAGS + ["-shared"])
    if lib is not None:
        _declare(lib)
    return lib


def _declare(lib) -> None:
    lib.wtpu_grammar_init.restype = ctypes.c_void_p
    lib.wtpu_grammar_init.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int]
    lib.wtpu_grammar_set_vocab.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int]
    lib.wtpu_grammar_set_vocab.restype = None
    lib.wtpu_grammar_suppress.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float]
    lib.wtpu_grammar_suppress.restype = None
    lib.wtpu_grammar_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wtpu_grammar_accept.restype = None
    lib.wtpu_grammar_n_stacks.argtypes = [ctypes.c_void_p]
    lib.wtpu_grammar_n_stacks.restype = ctypes.c_int
    lib.wtpu_grammar_clone.argtypes = [ctypes.c_void_p]
    lib.wtpu_grammar_clone.restype = ctypes.c_void_p
    lib.wtpu_grammar_free.argtypes = [ctypes.c_void_p]
    lib.wtpu_grammar_free.restype = None


def grammar_from_gbnf(src: str, start_rule_name: str = "root",
                      prefer_native: bool = True):
    """GBNF text -> grammar engine: the native C++ one when it builds and
    loads, else the Python one (the same masks, ~100x slower a step),
    with a warning."""
    rules, symbols = parse_gbnf(src)
    if start_rule_name not in symbols:
        raise GrammarParseError(f"start rule '{start_rule_name}' not found")
    if prefer_native:
        try:
            return NativeGrammar(rules, symbols[start_rule_name])
        except RuntimeError:
            log_warn("native grammar engine unavailable: decoding with the "
                     "Python engine")
    return Grammar(rules, symbols[start_rule_name])
