"""From-scratch Vorbis I decoder (pure Python + numpy).

The reference plays ogg/vorbis through its vendored stb_vorbis inside
miniaudio (reference: examples/common-whisper.cpp:11-12,171-172); this module
is the framework's native replacement, written from the Vorbis I
specification and pinned against the reference's own stb_vorbis compiled
unmodified in tests/test_vorbis_golden.py.

This is the readable reference implementation and the fallback path; the
request-path fast path is its C++ twin (native/wtpu_vorbis.cpp, ~20-40x
faster, 300-1400x realtime), pinned against this module within 1 s16 LSB and
against stb_vorbis in tests/test_vorbis_native.py.  Loader routing prefers
the native decoder when built (audio/io.py load_vorbis).

Where the specification and stb_vorbis disagree, this decoder follows
stb_vorbis (the oracle every reference example actually ships):
  * floor1 Y[0]/Y[1] are read with ilog(range)-1 bits (stb_vorbis.c:3210);
    the spec text says ilog(range-1).  The two differ only for
    multiplier==3 (range 86: 6 vs 7 bits).
  * draw_line indexes the inverse-dB table with y & 255 (wrap, not clamp)
    (stb_vorbis.c draw_line), reachable only for multiplier==3.
  * residue type 2 clamps begin/end against n/2*2 regardless of channel
    count (stb_vorbis.c decode_residue 'actual_size = n*2'); the spec says
    ch*n/2.  Differs only for >2-channel coupled submaps with large
    begin/end.
  * sequence_p VQ chaining matches stb's per-context arithmetic
    (codebook_decode adds minimum_value into the chain; the step/
    deinterleave forms do not).  Real-world encoders do not emit
    sequence_p on audio books (libvorbis uses it only for floor 0, which
    stb_vorbis rejects - stb_vorbis.c:382).

The inverse-dB table and window are generated from their defining formulas
(floor1 table: 10^(7*(i-255)/256), Vorbis I spec 10.1; window:
sin(pi/2*sin^2(pi*(i+.5)/n)), spec 4.3.1) rather than copied as constants;
f32 rounding agrees with the spec's printed table to <=1 ulp.

Packets stream out of audio/ogg.py; sample positioning/truncation follows
the granule rules (spec A.2) exactly as stb_vorbis applies them, including
its unsigned-32-bit current_loc bookkeeping.
"""

from __future__ import annotations

import math

import numpy as np

from .ogg import OggError, is_ogg, iter_packets

__all__ = ["VorbisError", "decode_ogg_vorbis", "is_ogg_vorbis",
           "assign_codewords", "ilog", "float32_unpack", "lookup1_values"]


class VorbisError(ValueError):
    pass


class _EndOfPacket(Exception):
    """Raised when a huffman walk runs out of packet bits (stb: EOP)."""


def ilog(n: int) -> int:
    """Vorbis ilog: number of bits in n (ilog(0)=0, ilog(1)=1, ilog(7)=3)."""
    return n.bit_length() if n > 0 else 0


def float32_unpack(x: int) -> np.float32:
    """Vorbis 32-bit packed float (spec 9.2.2)."""
    mantissa = x & 0x1FFFFF
    exp = (x & 0x7FE00000) >> 21
    val = math.ldexp(float(mantissa), exp - 788)
    if x & 0x80000000:
        val = -val
    return np.float32(val)


def lookup1_values(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries (spec 9.2.3)."""
    v = int(math.floor(math.exp(math.log(entries) / dims))) if entries > 0 else 0
    if (v + 1) ** dims <= entries:
        v += 1
    if (v + 1) ** dims <= entries or v ** dims > entries:
        raise VorbisError("bad lookup1 geometry")
    return v


def assign_codewords(lengths: list[int | None]) -> list[tuple[int, int] | None]:
    """Assign canonical Vorbis codewords to entry lengths (spec 3.2.1).

    lengths[i] is the codeword length of entry i, or None for unused
    (sparse) entries.  Returns (code, length) per entry with the code held
    MSB-first (the first bit read from the stream is the code's top bit),
    or None for unused entries.  Raises VorbisError on an overspecified
    tree.  Underspecified trees are accepted (decode errors at runtime),
    matching stb_vorbis.
    """
    out: list[tuple[int, int] | None] = [None] * len(lengths)
    available = [0] * 33          # left-justified-in-32-bits sibling marks
    first = True
    for i, ln in enumerate(lengths):
        if ln is None:
            continue
        if not (1 <= ln <= 32):
            raise VorbisError(f"bad codeword length {ln}")
        if first:
            out[i] = (0, ln)
            for d in range(1, ln + 1):
                available[d] = 1 << (32 - d)
            first = False
            continue
        z = ln
        while z > 0 and not available[z]:
            z -= 1
        if z == 0:
            raise VorbisError("overspecified huffman tree")
        res = available[z]
        available[z] = 0
        out[i] = (res >> (32 - ln), ln)
        for y in range(ln, z, -1):
            available[y] = res + (1 << (32 - y))
    return out


class _BitReader:
    """LSB-first bit reader over one packet (Vorbis bitpacking, spec 2).

    read() past the packet end returns 0 and latches `eop` (mirroring
    stb_vorbis get_bits); huffman walks raise _EndOfPacket instead.
    """

    __slots__ = ("bits", "n", "pos", "eop", "words")

    def __init__(self, packet: bytes):
        self.bits = np.unpackbits(
            np.frombuffer(packet, dtype=np.uint8), bitorder="little")
        self.n = len(self.bits)
        self.pos = 0
        self.eop = False
        # 32-bit little-endian windows at every byte offset: peek_word(pos)
        # exposes the next >=25 stream bits in one integer, powering the
        # accelerated huffman decode (same idea as stb's prep_huffman)
        b = np.frombuffer(packet + b"\x00\x00\x00\x00", dtype=np.uint8
                          ).astype(np.uint32)
        self.words = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16)
                      | (b[3:] << 24)).tolist()

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        p = self.pos
        if self.eop or p + nbits > self.n:
            self.eop = True
            self.pos = self.n
            return 0
        self.pos = p + nbits
        chunk = self.bits[p:p + nbits]
        val = 0
        for i in range(nbits - 1, -1, -1):
            val = (val << 1) | int(chunk[i])
        return val

    def read1(self) -> int:
        if self.eop or self.pos >= self.n:
            self.eop = True
            raise _EndOfPacket
        b = int(self.bits[self.pos])
        self.pos += 1
        return b


_FAST_BITS = 12      # acceleration-table width (stb: FAST_HUFFMAN_LENGTH=10)

# setup-allocation caps shared (exactly) with native/wtpu_vorbis.cpp
_MAX_CB_ENTRIES = 1 << 20    # huffman/lengths tables
_MAX_CB_CELLS = 1 << 24      # entries * dims f32 cells in the VQ table


class _Codebook:
    __slots__ = ("dims", "entries", "lengths", "table", "lookup_type",
                 "sequence_p", "minimum", "delta", "vq", "maxlen",
                 "fast_entry", "fast_len", "fast_mask")

    def __init__(self, r: _BitReader):
        if r.read(24) != 0x564342:           # 'BCV'
            raise VorbisError("codebook sync lost")
        self.dims = r.read(16)
        self.entries = r.read(24)
        if self.dims == 0 and self.entries != 0:
            raise VorbisError("dimensionless codebook")
        # Hardening, not spec: entries(24b) x dims(16b) are attacker-
        # controlled and size the huffman map + the (entries, dims) VQ
        # table; a ~40-byte setup header could otherwise demand multi-GB
        # allocations on the server request path.  Real codebooks are
        # ~1e3 entries x <=8 dims; the caps leave 100x headroom.  The
        # native decoder applies the SAME caps at the same parse point so
        # error parity holds (stb_vorbis instead relies on its optional
        # setup_memory budget).
        if self.entries > _MAX_CB_ENTRIES \
                or self.entries * self.dims > _MAX_CB_CELLS:
            raise VorbisError("codebook too large")
        ordered = r.read1()
        lengths: list[int | None] = []
        if ordered:
            cur_len = r.read(5) + 1
            while len(lengths) < self.entries:
                limit = self.entries - len(lengths)
                count = r.read(ilog(limit))
                if cur_len >= 32 or len(lengths) + count > self.entries:
                    raise VorbisError("bad ordered codebook")
                lengths.extend([cur_len] * count)
                cur_len += 1
        else:
            sparse = r.read1()
            for _ in range(self.entries):
                if sparse and not r.read1():
                    lengths.append(None)
                else:
                    ln = r.read(5) + 1
                    if ln == 32:
                        raise VorbisError("codeword length 32")
                    lengths.append(ln)
        if r.eop:
            raise VorbisError("EOP in codebook header")
        self.lengths = lengths
        codes = assign_codewords(lengths)
        self.table = {}
        self.maxlen = 0
        for entry, cw in enumerate(codes):
            if cw is not None:
                code, ln = cw
                self.table[(ln, code)] = entry
                self.maxlen = max(self.maxlen, ln)
        # acceleration table: stream-order (LSB-first) K-bit peek -> entry
        k = min(_FAST_BITS, self.maxlen) if self.maxlen else 0
        size = 1 << k
        fe = [-1] * size
        fl = [0] * size
        for entry, cw in enumerate(codes):
            if cw is None:
                continue
            code, ln = cw
            if ln > k:
                continue
            pat = 0                     # codeword bits as they appear on wire
            for i in range(ln):
                pat |= ((code >> (ln - 1 - i)) & 1) << i
            for v in range(pat, size, 1 << ln):
                fe[v] = entry
                fl[v] = ln
        self.fast_entry = fe
        self.fast_len = fl
        self.fast_mask = size - 1

        self.lookup_type = r.read(4)
        if self.lookup_type > 2:
            raise VorbisError(f"lookup type {self.lookup_type}")
        self.vq = None
        if self.lookup_type:
            self.minimum = float32_unpack(r.read(32))
            self.delta = float32_unpack(r.read(32))
            value_bits = r.read(4) + 1
            self.sequence_p = bool(r.read1())
            if self.lookup_type == 1:
                lv = lookup1_values(self.entries, self.dims)
            else:
                lv = self.entries * self.dims
            if lv == 0:
                raise VorbisError("empty lookup table")
            mults = np.array([r.read(value_bits) for _ in range(lv)],
                             dtype=np.float32)
            if r.eop:
                raise VorbisError("EOP in codebook lookup")
            # Pre-expand to a per-entry (entries, dims) f32 table with the
            # exact arithmetic stb_vorbis bakes at setup (incl. its
            # `last` carrying across entries when sequence_p is set).
            vq = np.zeros((self.entries, self.dims), dtype=np.float32)
            last = np.float32(0)
            if self.lookup_type == 1:
                for e in range(self.entries):
                    if codes[e] is None:
                        continue
                    div = 1
                    for k in range(self.dims):
                        off = (e // div) % lv
                        val = np.float32(
                            mults[off] * self.delta + self.minimum + last)
                        vq[e, k] = val
                        if self.sequence_p:
                            last = val
                        div *= lv
            else:
                flat = np.zeros(lv, dtype=np.float32)
                for j in range(lv):
                    val = np.float32(mults[j] * self.delta + self.minimum + last)
                    flat[j] = val
                    if self.sequence_p:
                        last = val
                vq = flat.reshape(self.entries, self.dims)
            self.vq = vq
        else:
            self.sequence_p = False
            self.minimum = np.float32(0)
            self.delta = np.float32(0)

    def decode_scalar(self, r: _BitReader) -> int:
        pos = r.pos
        if pos < r.n:
            v = (r.words[pos >> 3] >> (pos & 7)) & self.fast_mask
            entry = self.fast_entry[v]
            if entry >= 0:
                ln = self.fast_len[v]
                end = pos + ln
                if end <= r.n:
                    r.pos = end
                    return entry
                # codeword extends past the packet: EOP (stb: valid_bits<len)
                r.eop = True
                r.pos = r.n
                raise _EndOfPacket
        # slow path: codewords longer than the acceleration width
        code = 0
        table = self.table
        for ln in range(1, self.maxlen + 1):
            code = (code << 1) | r.read1()
            entry = table.get((ln, code))
            if entry is not None:
                return entry
        raise VorbisError("invalid codeword (underspecified tree)")


def _decode_run(r: _BitReader, book: _Codebook, nsyms: int, fpos: int,
                limit: int, dims: int):
    """Decode up to nsyms VQ codewords with the huffman walk inlined
    (hot path of residue decode).  Returns (entries, advanced fpos); fewer
    than nsyms entries means end-of-packet (the caller writes the partial
    run first, mirroring stb's consume-then-stop order)."""
    words = r.words
    n = r.n
    pos = r.pos
    fe = book.fast_entry
    fl = book.fast_len
    mask = book.fast_mask
    entries = []
    append = entries.append
    for _ in range(nsyms):
        if fpos >= limit:
            r.pos = pos
            raise VorbisError("residue write past vector end")
        if pos < n:
            v = (words[pos >> 3] >> (pos & 7)) & mask
            e = fe[v]
            if e >= 0:
                end = pos + fl[v]
                if end <= n:
                    pos = end
                    append(e)
                    fpos += dims if fpos + dims <= limit else limit - fpos
                    continue
                r.pos = r.n
                r.eop = True
                break
            # long codeword: fall back to the tree walk
            r.pos = pos
            try:
                e = book.decode_scalar(r)
            except _EndOfPacket:
                pos = r.pos
                break
            pos = r.pos
            append(e)
            fpos += dims if fpos + dims <= limit else limit - fpos
            continue
        r.eop = True
        break
    r.pos = pos if not r.eop else r.n
    return entries, fpos


_RANGE_LIST = (256, 128, 86, 64)
# floor1 inverse-dB lookup, spec 10.1: 10^(7*(i-255)/256), stored f32
_INVERSE_DB = (10.0 ** (7.0 * (np.arange(256) - 255) / 256.0)).astype(np.float32)


def _neighbors(xs: list[int], j: int) -> tuple[int, int]:
    """Indices (into xs[:j]) of the nearest X below/above xs[j] (spec 9.2.4/5)."""
    low_v, low_i = -1, -1
    high_v, high_i = 65536, -1
    for i in range(j):
        if low_v < xs[i] < xs[j]:
            low_v, low_i = xs[i], i
        if xs[j] < xs[i] < high_v:
            high_v, high_i = xs[i], i
    return low_i, high_i


def _predict_point(x: int, x0: int, x1: int, y0: int, y1: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


class _Floor1:
    __slots__ = ("partitions", "partition_class", "class_dims",
                 "class_subclasses", "class_masterbooks", "subclass_books",
                 "multiplier", "xlist", "sorted_order", "neigh")

    def __init__(self, r: _BitReader, n_books: int):
        self.partitions = r.read(5)
        self.partition_class = [r.read(4) for _ in range(self.partitions)]
        max_class = max(self.partition_class, default=-1)
        self.class_dims = []
        self.class_subclasses = []
        self.class_masterbooks = []
        self.subclass_books = []
        for _ in range(max_class + 1):
            dim = r.read(3) + 1
            sub = r.read(2)
            master = -1
            if sub:
                master = r.read(8)
                if master >= n_books:
                    raise VorbisError("floor1 masterbook out of range")
            books = []
            for _ in range(1 << sub):
                b = r.read(8) - 1
                if b >= n_books:
                    raise VorbisError("floor1 subclass book out of range")
                books.append(b)
            self.class_dims.append(dim)
            self.class_subclasses.append(sub)
            self.class_masterbooks.append(master)
            self.subclass_books.append(books)
        self.multiplier = r.read(2) + 1
        rangebits = r.read(4)
        xs = [0, 1 << rangebits]
        for j in range(self.partitions):
            c = self.partition_class[j]
            for _ in range(self.class_dims[c]):
                xs.append(r.read(rangebits))
        if len(set(xs)) != len(xs):
            raise VorbisError("duplicate floor1 X value")
        self.xlist = xs
        self.sorted_order = sorted(range(len(xs)), key=lambda i: xs[i])
        self.neigh = [(0, 0), (0, 0)] + [
            _neighbors(xs, j) for j in range(2, len(xs))]

    def decode(self, r: _BitReader, books: list[_Codebook]):
        """Read one channel's floor -> (final_Y, step2_flag) or None (unused).

        The curve itself is rendered later (after residue/coupling) by
        `render`, mirroring stb's deferred-floor order of operations.
        """
        try:
            if not r.read1():
                return None
        except _EndOfPacket:
            return None
        rng = _RANGE_LIST[self.multiplier - 1]
        ybits = ilog(rng) - 1        # stb semantics; see module docstring
        final_y = [r.read(ybits), r.read(ybits)]
        try:
            for j in range(self.partitions):
                pclass = self.partition_class[j]
                cdim = self.class_dims[pclass]
                cbits = self.class_subclasses[pclass]
                csub = (1 << cbits) - 1
                cval = 0
                if cbits:
                    cval = books[self.class_masterbooks[pclass]].decode_scalar(r)
                for _ in range(cdim):
                    book = self.subclass_books[pclass][cval & csub]
                    cval >>= cbits
                    if book >= 0:
                        final_y.append(books[book].decode_scalar(r))
                    else:
                        final_y.append(0)
        except _EndOfPacket:
            return None
        if r.eop:
            return None               # stb: valid_bits==INVALID_BITS -> unused
        values = len(self.xlist)
        step2 = [False] * values
        step2[0] = step2[1] = True
        for j in range(2, values):
            low, high = self.neigh[j]
            pred = _predict_point(self.xlist[j], self.xlist[low],
                                  self.xlist[high], final_y[low], final_y[high])
            val = final_y[j]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[low] = step2[high] = step2[j] = True
                if val >= room:
                    if highroom > lowroom:
                        final_y[j] = val - lowroom + pred
                    else:
                        final_y[j] = pred - val + highroom - 1
                elif val & 1:
                    final_y[j] = pred - ((val + 1) >> 1)
                else:
                    final_y[j] = pred + (val >> 1)
            else:
                step2[j] = False
                final_y[j] = pred
        return final_y, step2

    def render(self, final_y: list[int], step2: list[bool], n2: int,
               target: np.ndarray) -> None:
        """Multiply the rendered floor curve into target[:n2] (spec 7.2.4)."""
        mult = self.multiplier
        lx, ly = 0, final_y[0] * mult
        for q in range(1, len(self.xlist)):
            j = self.sorted_order[q]
            # stb's deferred-floor render keys on finalY[j] >= 0, which both
            # drops non-step2 posts (stb forces them to -1) AND any post whose
            # amplitude arithmetic landed negative — mirror exactly.
            if not step2[j] or final_y[j] < 0:
                continue
            hy = final_y[j] * mult
            hx = self.xlist[j]
            if lx != hx:
                _draw_line(target, lx, ly, hx, hy, n2)
            lx, ly = hx, hy
        if lx < n2:
            target[lx:n2] *= _INVERSE_DB[ly & 255]


def _draw_line(out: np.ndarray, x0: int, y0: int, x1: int, y1: int, n: int):
    """Bresenham floor-line render; bit-exact integer walk required by the
    format (every decoder must produce these exact quantized y's)."""
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    base = -(-dy // adx) if dy < 0 else dy // adx   # C truncating division
    sy = base - 1 if dy < 0 else base + 1
    ady -= abs(base) * adx
    if x1 > n:
        x1 = n
    if x0 >= x1:
        return
    # vectorized: y[x] follows err accumulation; compute the step pattern
    xs = np.arange(1, x1 - x0)
    # y increments: at each step either +sy (carry) or +base
    carries = (xs * ady) // adx
    ys = y0 + carries * sy + (xs - carries) * base
    ys_full = np.concatenate(([y0], ys)).astype(np.int64)
    out[x0:x1] *= _INVERSE_DB[ys_full & 255]


class _Residue:
    __slots__ = ("rtype", "begin", "end", "part_size", "classifications",
                 "classbook", "books", "classdata")

    def __init__(self, r: _BitReader, rtype: int, codebooks: list[_Codebook]):
        self.rtype = rtype
        self.begin = r.read(24)
        self.end = r.read(24)
        if self.end < self.begin:
            raise VorbisError("residue end < begin")
        self.part_size = r.read(24) + 1
        self.classifications = r.read(6) + 1
        self.classbook = r.read(8)
        if self.classbook >= len(codebooks):
            raise VorbisError("residue classbook out of range")
        if codebooks[self.classbook].dims <= 0:
            # a dims=0/entries=0 book is a legal *unused* book; referencing it
            # as a classbook would divide/step by zero in decode
            raise VorbisError("residue classbook has zero dimensions")
        cascade = []
        for _ in range(self.classifications):
            low = r.read(3)
            high = r.read(5) if r.read1() else 0
            cascade.append(high * 8 + low)
        self.books = []
        for j in range(self.classifications):
            row = []
            for k in range(8):
                if cascade[j] & (1 << k):
                    b = r.read(8)
                    if b >= len(codebooks):
                        raise VorbisError("residue book out of range")
                    if codebooks[b].dims <= 0:
                        raise VorbisError("residue value book has zero dimensions")
                    row.append(b)
                else:
                    row.append(-1)
            self.books.append(row)
        # per-classword-entry class sequences (stb: classdata)
        cb = codebooks[self.classbook]
        self.classdata = []
        for e in range(cb.entries):
            temp = e
            seq = [0] * cb.dims
            for k in range(cb.dims - 1, -1, -1):
                seq[k] = temp % self.classifications
                temp //= self.classifications
            self.classdata.append(seq)

    # -- partition decoders -------------------------------------------------

    def _vq_entry(self, r: _BitReader, book: _Codebook) -> np.ndarray:
        if book.lookup_type == 0:
            raise VorbisError("scalar book used in VQ context")
        z = book.decode_scalar(r)
        return book.vq[z]

    def _decode_partition(self, r, book: _Codebook, target: np.ndarray,
                          offset: int, n: int, rtype: int):
        """Decode one partition at absolute `offset`, length n=part_size.

        rtype 0 replicates stb_vorbis's interleave length computation
        (residue_decode: len = n - offset - k with `offset` absolute), which
        silently discards decoded values for partitions past the first —
        symbols are still consumed, so bitstream position stays in sync.
        Residue type 0 does not occur in real-world streams (libvorbis
        never emits it); parity with the oracle is what matters here.
        """
        dims = book.dims
        if rtype == 0:
            step = n // dims
            for k in range(step):
                vals = self._vq_entry(r, book)
                lim = min(dims, n - offset - k)
                if lim > 0:
                    if book.sequence_p:
                        vals = np.cumsum(vals, dtype=np.float32)
                    idx = offset + k + np.arange(lim) * step
                    target[idx] += vals[:lim]
        else:
            k = 0
            off = offset
            while k < n:
                vals = self._vq_entry(r, book)
                lim = min(dims, n - k)
                if book.sequence_p:
                    # stb codebook_decode: last = val + minimum each step
                    acc = np.float32(0)
                    for i in range(lim):
                        v = np.float32(vals[i] + acc)
                        target[off + i] += v
                        acc = np.float32(v + book.minimum)
                else:
                    target[off:off + lim] += vals[:lim]
                k += dims
                off += dims

    def decode(self, r: _BitReader, codebooks: list[_Codebook], ch: int,
               n2: int, do_not_decode: list[bool]) -> list[np.ndarray]:
        """Decode this residue for `ch` channel slots -> list of f32[n2]."""
        rtype = self.rtype
        cb = codebooks[self.classbook]
        classwords = cb.dims
        actual = n2 * 2 if rtype == 2 else n2
        # residue-2 mono decodes through the generic path over a 2*n2-long
        # vector (stb: channel buffers are blocksize long); writes past n2
        # land in scratch and are discarded below, exactly like the oracle.
        buf_len = actual if (rtype == 2 and ch == 1) else n2
        bufs = [np.zeros(buf_len, dtype=np.float32) for _ in range(ch)]
        lb = min(self.begin, actual)
        le = min(self.end, actual)
        part_read = (le - lb) // self.part_size
        if part_read <= 0:
            return [b[:n2] for b in bufs]

        try:
            if rtype == 2 and ch > 1:
                if all(do_not_decode):
                    return bufs
                self._decode_interleaved(r, codebooks, bufs, ch, n2,
                                         do_not_decode, lb, part_read,
                                         classwords, cb)
            else:
                self._decode_generic(r, codebooks, bufs, ch, do_not_decode,
                                     lb, part_read, classwords, cb)
        except _EndOfPacket:
            pass                         # spec 8.6.2: stop, keep partial
        return [b[:n2] for b in bufs]

    def _decode_generic(self, r, codebooks, bufs, ch, dnd, lb, part_read,
                        classwords, cb):
        classes = [[0] * ((part_read // classwords + 1) * classwords)
                   for _ in range(ch)]
        for p in range(8):
            pcount = 0
            while pcount < part_read:
                if p == 0:
                    for j in range(ch):
                        if not dnd[j]:
                            temp = cb.decode_scalar(r)
                            seq = self.classdata[temp]
                            classes[j][pcount:pcount + classwords] = seq
                i = 0
                while i < classwords and pcount < part_read:
                    for j in range(ch):
                        if dnd[j]:
                            continue
                        c = classes[j][pcount]
                        b = self.books[c][p]
                        if b >= 0:
                            self._decode_partition(
                                r, codebooks[b], bufs[j],
                                lb + pcount * self.part_size,
                                self.part_size,
                                1 if self.rtype == 2 else self.rtype)
                    i += 1
                    pcount += 1

    def _decode_interleaved(self, r, codebooks, bufs, ch, n2, dnd, lb,
                            part_read, classwords, cb):
        """Residue-2 coded vector decoded into one flat interleaved buffer
        (index = sample*ch + channel, i.e. stb's p_inter*ch + c_inter),
        deinterleaved into the channel buffers afterwards.  do-not-decode
        channels receive values here exactly like channels stb leaves NULL
        consume them — their output is zeroed later by really_zero, so the
        bitstream walk and the audible result match the oracle."""
        classes = [0] * ((part_read // classwords + 1) * classwords)
        ps = self.part_size
        flat = np.zeros(n2 * ch, dtype=np.float32)
        limit = n2 * ch
        try:
            for p in range(8):
                pcount = 0
                while pcount < part_read:
                    fpos = lb + pcount * ps     # == p_inter*ch + c_inter
                    if p == 0:
                        temp = cb.decode_scalar(r)
                        classes[pcount:pcount + classwords] = \
                            self.classdata[temp]
                    i = 0
                    while i < classwords and pcount < part_read:
                        b = self.books[classes[pcount]][p]
                        if b >= 0:
                            book = codebooks[b]
                            if book.lookup_type == 0:
                                raise VorbisError(
                                    "scalar book used in VQ context")
                            dims = book.dims
                            nsyms = -(-ps // dims)
                            entries, fpos_new = _decode_run(r, book, nsyms,
                                                            fpos, limit, dims)
                            if entries:
                                vals = book.vq[entries]
                                if book.sequence_p:
                                    vals = np.cumsum(vals, axis=1,
                                                     dtype=np.float32)
                                vals = vals.ravel()
                                end = min(fpos + vals.size, limit)
                                flat[fpos:end] += vals[:end - fpos]
                            fpos = fpos_new
                            if len(entries) < nsyms:
                                raise _EndOfPacket
                        else:
                            fpos = lb + pcount * ps + ps
                        i += 1
                        pcount += 1
        finally:
            for j in range(ch):
                bufs[j][:] = flat[j::ch]


class _Mapping:
    __slots__ = ("submaps", "coupling", "mux", "submap_floor", "submap_residue")

    def __init__(self, r: _BitReader, channels: int, n_floors: int,
                 n_residues: int):
        if r.read(16) != 0:
            raise VorbisError("nonzero mapping type")
        self.submaps = r.read(4) + 1 if r.read1() else 1
        self.coupling = []
        if r.read1():
            steps = r.read(8) + 1
            if steps > channels:
                raise VorbisError("too many coupling steps")
            bits = ilog(channels - 1)
            for _ in range(steps):
                mag = r.read(bits)
                ang = r.read(bits)
                if mag >= channels or ang >= channels or mag == ang:
                    raise VorbisError("bad coupling pair")
                self.coupling.append((mag, ang))
        if r.read(2):
            raise VorbisError("nonzero mapping reserved bits")
        if self.submaps > 1:
            self.mux = [r.read(4) for _ in range(channels)]
            if any(m >= self.submaps for m in self.mux):
                raise VorbisError("mux out of range")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            r.read(8)                     # discarded time config
            fl = r.read(8)
            rs = r.read(8)
            if fl >= n_floors or rs >= n_residues:
                raise VorbisError("submap floor/residue out of range")
            self.submap_floor.append(fl)
            self.submap_residue.append(rs)


class _Mode:
    __slots__ = ("blockflag", "mapping")

    def __init__(self, r: _BitReader, n_mappings: int):
        self.blockflag = r.read1()
        if r.read(16) != 0 or r.read(16) != 0:
            raise VorbisError("nonzero window/transform type")
        self.mapping = r.read(8)
        if self.mapping >= n_mappings:
            raise VorbisError("mode mapping out of range")


# ---------------------------------------------------------------------------
# IMDCT (spec 4.3.5): y[i] = sum_k X[k] cos(2pi/n (i+0.5+n/4)(k+0.5)),
# computed exactly in f64 via a DCT-IV + FFT factorization.

def _dct4(x: np.ndarray) -> np.ndarray:
    """DCT-IV along the last axis: C[i] = sum_k x[k] cos(pi/M (i+.5)(k+.5))."""
    m = x.shape[-1]
    k = np.arange(m)
    pre = x * np.exp(-1j * np.pi * k / (2 * m))
    padded = np.zeros(x.shape[:-1] + (2 * m,), dtype=np.complex128)
    padded[..., :m] = pre
    ft = np.fft.fft(padded, axis=-1)[..., :m]
    i = np.arange(m)
    return (ft * np.exp(-1j * np.pi * (2 * i + 1) / (4 * m))).real


def imdct(x: np.ndarray) -> np.ndarray:
    """Vorbis IMDCT: (..., n/2) spectral f32/f64 -> (..., n) time f64."""
    x = np.asarray(x, dtype=np.float64)
    m = x.shape[-1]                      # n/2
    c = _dct4(x)
    h = m // 2
    y = np.empty(x.shape[:-1] + (2 * m,), dtype=np.float64)
    y[..., :h] = c[..., h:]
    y[..., h:h + m] = -c[..., ::-1]
    y[..., h + m:] = -c[..., :h]
    return y


def _window_half(n2: int) -> np.ndarray:
    i = np.arange(n2, dtype=np.float64)
    return np.sin(0.5 * np.pi * np.sin((i + 0.5) / n2 * 0.5 * np.pi) ** 2
                  ).astype(np.float32)


# ---------------------------------------------------------------------------

class _VorbisStream:
    def __init__(self):
        self.headers_seen = 0
        self.channels = 0
        self.rate = 0
        self.blocksizes = (0, 0)
        self.codebooks: list[_Codebook] = []
        self.floors: list[tuple[int, _Floor1 | None]] = []
        self.residues: list[_Residue] = []
        self.mappings: list[_Mapping] = []
        self.modes: list[_Mode] = []
        # decode state
        self.previous: list[np.ndarray] | None = None
        self.previous_length = 0
        self.first_decode = True
        self.current_loc = 0
        self.current_loc_valid = False
        self.discard_deferred = 0
        self.windows: dict[int, np.ndarray] = {}

    # -- headers ------------------------------------------------------------

    def parse_header(self, packet: bytes) -> None:
        # read1()/huffman walks raise _EndOfPacket, which is internal-only:
        # surface truncated headers as VorbisError so callers see the same
        # ValueError the native decoder (rc=1) maps to.
        try:
            self._parse_header(packet)
        except _EndOfPacket:
            raise VorbisError("EOP in header packet") from None

    def _parse_header(self, packet: bytes) -> None:
        if len(packet) < 7 or packet[1:7] != b"vorbis":
            raise VorbisError("bad header packet")
        kind = packet[0]
        expect = (1, 3, 5)[self.headers_seen]
        if kind != expect:
            raise VorbisError(f"header packet {kind}, expected {expect}")
        r = _BitReader(packet[7:])
        if kind == 1:
            if r.read(32) != 0:
                raise VorbisError("vorbis version != 0")
            self.channels = r.read(8)
            self.rate = r.read(32)
            if not self.channels or not self.rate:
                raise VorbisError("bad channels/rate")
            r.read(32), r.read(32), r.read(32)       # bitrate hints
            b0 = 1 << r.read(4)
            b1 = 1 << r.read(4)
            if not (64 <= b0 <= 8192 and 64 <= b1 <= 8192 and b0 <= b1):
                raise VorbisError(f"bad blocksizes {b0}/{b1}")
            if not r.read1():
                raise VorbisError("missing framing bit")
            self.blocksizes = (b0, b1)
        elif kind == 3:
            pass                                      # comments: ignored
        else:
            self._parse_setup(r)
        self.headers_seen += 1

    def _parse_setup(self, r: _BitReader) -> None:
        for _ in range(r.read(8) + 1):
            self.codebooks.append(_Codebook(r))
        for _ in range(r.read(6) + 1):                # time transforms
            if r.read(16) != 0:
                raise VorbisError("nonzero time transform")
        for _ in range(r.read(6) + 1):
            ftype = r.read(16)
            if ftype > 1:
                raise VorbisError(f"floor type {ftype}")
            if ftype == 0:
                # parse past the header, then refuse like stb (:382)
                r.read(8), r.read(16), r.read(16), r.read(6), r.read(8)
                for _ in range(r.read(4) + 1):
                    r.read(8)
                raise VorbisError("floor 0 not supported (matches stb_vorbis)")
            self.floors.append((1, _Floor1(r, len(self.codebooks))))
        for _ in range(r.read(6) + 1):
            rtype = r.read(16)
            if rtype > 2:
                raise VorbisError(f"residue type {rtype}")
            self.residues.append(_Residue(r, rtype, self.codebooks))
        for _ in range(r.read(6) + 1):
            self.mappings.append(
                _Mapping(r, self.channels, len(self.floors),
                         len(self.residues)))
        for _ in range(r.read(6) + 1):
            self.modes.append(_Mode(r, len(self.mappings)))
        if r.eop:
            raise VorbisError("EOP in setup header")
        if not r.read1():
            raise VorbisError("missing setup framing bit")

    # -- audio --------------------------------------------------------------

    def window_geometry(self, mode: _Mode, prev_flag: int, next_flag: int):
        b0, b1 = self.blocksizes
        n = b1 if mode.blockflag else b0
        wc = n >> 1
        if mode.blockflag and not prev_flag:
            left = ((n - b0) >> 2, (n + b0) >> 2)
        else:
            left = (0, wc)
        if mode.blockflag and not next_flag:
            right = ((n * 3 - b0) >> 2, (n * 3 + b0) >> 2)
        else:
            right = (wc, n)
        return n, left, right

    def decode_audio_packet(self, packet: bytes):
        """-> (pcm_block list per channel f32[n], n, left, right) or None."""
        r = _BitReader(packet)
        try:
            if r.read1() != 0:
                return None                            # non-audio packet
            mode_idx = r.read(ilog(len(self.modes) - 1))
        except _EndOfPacket:
            return None
        if r.eop or mode_idx >= len(self.modes):
            return None
        mode = self.modes[mode_idx]
        prev_flag = next_flag = 0
        if mode.blockflag:
            prev_flag = r.read(1)
            next_flag = r.read(1)
        n, (left_start, left_end), (right_start, right_end) = \
            self.window_geometry(mode, prev_flag, next_flag)
        n2 = n >> 1
        mapping = self.mappings[mode.mapping]
        ch = self.channels

        # floors
        floor_data: list = [None] * ch
        zero_channel = [False] * ch
        for i in range(ch):
            fl = self.floors[mapping.submap_floor[mapping.mux[i]]][1]
            got = fl.decode(r, self.codebooks)
            if got is None:
                zero_channel[i] = True
            floor_data[i] = got
        really_zero = list(zero_channel)
        for mag, ang in mapping.coupling:
            if not zero_channel[mag] or not zero_channel[ang]:
                zero_channel[mag] = zero_channel[ang] = False

        # residues, per submap
        residue_out: list = [None] * ch
        for s in range(mapping.submaps):
            idxs = [j for j in range(ch) if mapping.mux[j] == s]
            dnd = [zero_channel[j] for j in idxs]
            res = self.residues[mapping.submap_residue[s]]
            bufs = res.decode(r, self.codebooks, len(idxs), n2, dnd)
            for k, j in enumerate(idxs):
                residue_out[j] = bufs[k]

        # inverse coupling (spec 4.3.5), f32 like the oracle
        for mag, ang in reversed(mapping.coupling):
            m = residue_out[mag]
            a = residue_out[ang]
            pos_m = m > 0
            pos_a = a > 0
            new_m = np.where(pos_m, np.where(pos_a, m, m + a),
                             np.where(pos_a, m, m - a)).astype(np.float32)
            new_a = np.where(pos_m, np.where(pos_a, m - a, m),
                             np.where(pos_a, m + a, m)).astype(np.float32)
            residue_out[mag] = new_m
            residue_out[ang] = new_a

        # floor curve multiply + IMDCT
        blocks = []
        for i in range(ch):
            if really_zero[i]:
                blocks.append(np.zeros(n, dtype=np.float32))
                continue
            spec = residue_out[i]
            fl = self.floors[mapping.submap_floor[mapping.mux[i]]][1]
            final_y, step2 = floor_data[i]
            fl.render(final_y, step2, n2, spec)
            blocks.append(imdct(spec).astype(np.float32))
        return blocks, n, (left_start, left_end), (right_start, right_end)

    def get_window(self, length: int) -> np.ndarray:
        w = self.windows.get(length)
        if w is None:
            w = _window_half(length)
            self.windows[length] = w
        return w

    def finish_frame(self, blocks, length, left, right):
        """Overlap-add one frame -> list of f32 arrays to emit per channel
        (stb vorbis_finish_frame semantics)."""
        ch = self.channels
        if self.previous_length:
            nprev = self.previous_length
            w = self.get_window(nprev)
            wr = w[::-1]
            for i in range(ch):
                seg = blocks[i][left:left + nprev]
                blocks[i][left:left + nprev] = (
                    seg * w + self.previous[i] * wr).astype(np.float32)
        prev = self.previous_length
        self.previous_length = max(0, length - right)
        self.previous = [blocks[i][right:length].copy() for i in range(ch)]
        if not prev:
            return [np.zeros(0, dtype=np.float32)] * ch
        if length < right:
            right = length
        return [blocks[i][left:right] for i in range(ch)]


def is_ogg_vorbis(data: bytes) -> bool:
    """True when `data` is an Ogg stream whose first packet is a Vorbis ID."""
    if not is_ogg(data):
        return False
    try:
        for packet, _info in iter_packets(data[:65536]):
            return len(packet) >= 7 and packet[0] == 1 and packet[1:7] == b"vorbis"
    except OggError:
        return False
    return False


_U32 = 0xFFFFFFFF


def decode_ogg_vorbis(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an Ogg Vorbis stream -> ((n, channels) f32 PCM, sample_rate)."""
    if not is_ogg(data):
        raise VorbisError("not an Ogg stream")
    st = _VorbisStream()
    out_parts: list[list[np.ndarray]] = []
    done = False
    n_frames = 0
    for packet, info in iter_packets(data):
        if done:
            break
        if st.headers_seen < 3:
            st.parse_header(packet)
            continue
        decoded = st.decode_audio_packet(packet)
        if decoded is None:
            continue
        blocks, n, (left_start, left_end), (right_start, right_end) = decoded
        n2 = n >> 1
        length = right_end
        truncated = False

        if st.first_decode:
            st.current_loc = (-n2) & _U32
            st.discard_deferred = n - right_end
            st.current_loc_valid = True
            st.first_decode = False
        elif st.discard_deferred:
            if st.discard_deferred >= right_start - left_start:
                st.discard_deferred -= (right_start - left_start)
                left_start = right_start
            else:
                left_start += st.discard_deferred
                st.discard_deferred = 0

        if info.granule is not None:
            if st.current_loc_valid and info.page_is_last:
                current_end = info.granule & _U32
                if current_end < (st.current_loc + (right_end - left_start)) & _U32:
                    if current_end < st.current_loc:
                        length = 0
                    else:
                        length = current_end - st.current_loc
                    length += left_start
                    if length > right_end:
                        length = right_end
                    st.current_loc = (st.current_loc + length) & _U32
                    truncated = True
            if not truncated:
                st.current_loc = (info.granule - (n2 - left_start)) & _U32
                st.current_loc_valid = True
        if st.current_loc_valid and not truncated:
            st.current_loc = (st.current_loc + (right_start - left_start)) & _U32

        emitted = st.finish_frame(blocks, length, left_start, right_start)
        if emitted[0].size:
            out_parts.append(emitted)
        elif n_frames > 0:
            # File-path oracle semantics: the reference decodes files through
            # stb_vorbis PULL mode (miniaudio ma_stbvorbis_init_file), where
            # get_frame_float() returning 0 samples ends the stream — so a
            # mid-stream frame fully swallowed by the start-discard
            # terminates decode.  (stdin/memory inputs go through push mode,
            # which would keep going; we mirror the file path.)
            done = True
        n_frames += 1
        if truncated and info.page_is_last:
            done = True

    if st.headers_seen < 3:
        raise VorbisError("incomplete vorbis headers")
    if not out_parts:
        return np.zeros((0, st.channels), dtype=np.float32), st.rate
    chans = [np.concatenate([p[i] for p in out_parts]) for i in range(st.channels)]
    return np.stack(chans, axis=1), st.rate
