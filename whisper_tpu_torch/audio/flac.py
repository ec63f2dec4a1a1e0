"""From-scratch FLAC decoder (pure Python reference implementation).

The reference decodes FLAC through the dr_flac decoder vendored inside
miniaudio (reference: examples/common-whisper.cpp:27,46 ``read_audio_data``
-> ``ma_decoder``).  This module is an independent implementation of the
FLAC bitstream format so the framework can ingest FLAC natively with no
external tools; a C++ fast path with the identical contract lives in
``native/wtpu_flac.cpp`` (loaded via ``audio.native``), and both are pinned
bit-exact against the reference's own vendored decoder in
``tests/test_flac_golden.py``.

Supported (everything a spec-compliant encoder emits for 8/16/24-bit PCM):
  - STREAMINFO + arbitrary metadata blocks (skipped)
  - fixed and variable blocking strategies, UTF-8 coded frame/sample numbers
  - all block-size / sample-rate / bit-depth header codes
  - channel modes: 1..8 independent, left/side, right/side, mid/side
  - subframes: CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32)
  - Rice residual methods 0 (4-bit) and 1 (5-bit), escape partitions,
    partition orders 0-15, wasted bits
  - CRC-8 (frame header) and CRC-16 (whole frame) verification

Output samples are sign-extended integers at the stream's bit depth, in a
``(n_frames, channels) int32`` array; ``pcm_to_f32`` applies the exact
scaling dr_flac uses (``x / 2**31`` after an MSB-align shift).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FlacError", "decode_flac", "pcm_to_f32", "is_flac"]


class FlacError(ValueError):
    pass


def is_flac(data: bytes) -> bool:
    return data[:4] == b"fLaC"


# ---------------------------------------------------------------------------
# bit reader
# ---------------------------------------------------------------------------

class _Bits:
    __slots__ = ("data", "byte", "bit")

    def __init__(self, data: bytes, byte: int = 0):
        self.data = data
        self.byte = byte
        self.bit = 0

    def eof(self) -> bool:
        return self.byte >= len(self.data)

    def read(self, n: int) -> int:
        v = 0
        data, byte, bit = self.data, self.byte, self.bit
        while n:
            if byte >= len(data):
                raise FlacError("unexpected end of stream")
            avail = 8 - bit
            take = n if n < avail else avail
            v = (v << take) | ((data[byte] >> (avail - take)) & ((1 << take) - 1))
            bit += take
            if bit == 8:
                bit = 0
                byte += 1
            n -= take
        self.byte, self.bit = byte, bit
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        if self.bit:
            self.bit = 0
            self.byte += 1


# ---------------------------------------------------------------------------
# CRCs (FLAC frame header CRC-8 poly 0x07, frame CRC-16 poly 0x8005)
# ---------------------------------------------------------------------------

def _make_crc8_table():
    tab = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        tab.append(c)
    return tab


def _make_crc16_table():
    tab = []
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        tab.append(c)
    return tab


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# frame header tables
# ---------------------------------------------------------------------------

_SR_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
             7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# fixed-predictor reconstruction coefficients per order (applied to the
# previous samples, newest first)
_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_number(bits: _Bits) -> int:
    b0 = bits.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise FlacError("invalid UTF-8 coded number")
    v = b0 & (mask - 1)
    for _ in range(n_extra):
        b = bits.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("invalid UTF-8 continuation")
        v = (v << 6) | (b & 0x3F)
    return v


# ---------------------------------------------------------------------------
# subframe + residual decoding
# ---------------------------------------------------------------------------

def _read_residual(bits: _Bits, block_size: int, pred_order: int) -> list[int]:
    method = bits.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    plen = 5 if method else 4
    escape = (1 << plen) - 1
    part_order = bits.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise FlacError("block size not divisible by partition count")
    out: list[int] = []
    for p in range(n_parts):
        n = (block_size >> part_order) - (pred_order if p == 0 else 0)
        if n < 0:
            raise FlacError("predictor order exceeds first partition")
        param = bits.read(plen)
        if param == escape:
            raw_bits = bits.read(5)
            if raw_bits == 0:
                out.extend([0] * n)
            else:
                for _ in range(n):
                    out.append(bits.read_signed(raw_bits))
        else:
            for _ in range(n):
                q = bits.unary()
                r = bits.read(param) if param else 0
                v = (q << param) | r
                out.append((v >> 1) ^ -(v & 1))
    return out


def _decode_subframe(bits: _Bits, block_size: int, bps: int) -> list[int]:
    if bits.read(1):
        raise FlacError("subframe padding bit set")
    ftype = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = bits.unary() + 1
        bps -= wasted
        if bps <= 0:
            raise FlacError("wasted bits exceed sample size")

    if ftype == 0:  # CONSTANT
        v = bits.read_signed(bps)
        samples = [v] * block_size
    elif ftype == 1:  # VERBATIM
        samples = [bits.read_signed(bps) for _ in range(block_size)]
    elif 8 <= ftype <= 12:  # FIXED, order = ftype - 8
        order = ftype - 8
        samples = [bits.read_signed(bps) for _ in range(order)]
        resid = _read_residual(bits, block_size, order)
        coef = _FIXED_COEF[order]
        for r in resid:
            acc = r
            for j, c in enumerate(coef):
                acc += c * samples[-1 - j]
            samples.append(acc)
    elif ftype >= 32:  # LPC, order = (ftype & 0x1F) + 1
        order = (ftype & 0x1F) + 1
        samples = [bits.read_signed(bps) for _ in range(order)]
        prec = bits.read(4) + 1
        if prec == 16:
            raise FlacError("invalid LPC precision code")
        shift = bits.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coef = [bits.read_signed(prec) for _ in range(order)]
        resid = _read_residual(bits, block_size, order)
        for r in resid:
            acc = 0
            for j in range(order):
                acc += coef[j] * samples[-1 - j]
            samples.append(r + (acc >> shift))
    else:
        raise FlacError(f"reserved subframe type {ftype}")

    if wasted:
        samples = [s << wasted for s in samples]
    return samples


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _parse_streaminfo(block: bytes):
    bits = _Bits(block)
    bits.read(16)  # min block size
    bits.read(16)  # max block size
    bits.read(24)  # min frame size
    bits.read(24)  # max frame size
    rate = bits.read(20)
    channels = bits.read(3) + 1
    bps = bits.read(5) + 1
    total = bits.read(36)
    return rate, channels, bps, total


def decode_flac(data: bytes, verify_crc: bool = True):
    """Decode a FLAC stream -> ((n, channels) int32, sample_rate, bits).

    Samples are sign-extended to int32 at the stream bit depth (wasted-bit
    shifts already applied, matching dr_flac's output convention).
    """
    if not is_flac(data):
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    rate = channels = bps = None
    total = 0
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        blen = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:
            if blen < 34:
                raise FlacError("short STREAMINFO")
            rate, channels, bps, total = _parse_streaminfo(body)
        pos += 4 + blen
        if last:
            break
    if rate is None:
        raise FlacError("missing STREAMINFO")

    out: list[list[int]] = []
    n_decoded = 0
    bits = _Bits(data, pos)
    while not bits.eof() and (total == 0 or n_decoded < total):
        frame_start = bits.byte
        sync = bits.read(14)
        if sync != 0x3FFE:
            raise FlacError(f"bad frame sync at byte {frame_start}")
        if bits.read(1):
            raise FlacError("frame header reserved bit set")
        bits.read(1)  # blocking strategy (informational)
        bs_code = bits.read(4)
        sr_code = bits.read(4)
        ch_code = bits.read(4)
        bps_code = bits.read(3)
        if bits.read(1):
            raise FlacError("frame header reserved bit 2 set")
        _read_utf8_number(bits)

        if bs_code == 0:
            raise FlacError("reserved block size code 0")
        elif bs_code == 1:
            block_size = 192
        elif bs_code <= 5:
            block_size = 576 << (bs_code - 2)
        elif bs_code == 6:
            block_size = bits.read(8) + 1
        elif bs_code == 7:
            block_size = bits.read(16) + 1
        else:
            block_size = 256 << (bs_code - 8)

        if sr_code == 0:
            pass
        elif sr_code in _SR_TABLE:
            pass
        elif sr_code == 12:
            bits.read(8)
        elif sr_code in (13, 14):
            bits.read(16)
        else:
            raise FlacError("invalid sample rate code 15")

        frame_bps = bps if bps_code == 0 else _BPS_TABLE.get(bps_code)
        if frame_bps is None:
            raise FlacError(f"reserved bit depth code {bps_code}")

        if verify_crc:
            hdr_crc = crc8(data[frame_start:bits.byte])
            if bits.read(8) != hdr_crc:
                raise FlacError("frame header CRC-8 mismatch")
        else:
            bits.read(8)

        if ch_code < 8:
            n_ch = ch_code + 1
            chans = [_decode_subframe(bits, block_size, frame_bps)
                     for _ in range(n_ch)]
        elif ch_code in (8, 9, 10):
            n_ch = 2
            side0 = frame_bps + (1 if ch_code == 9 else 0)
            side1 = frame_bps + (1 if ch_code in (8, 10) else 0)
            c0 = _decode_subframe(bits, block_size, side0)
            c1 = _decode_subframe(bits, block_size, side1)
            if ch_code == 8:  # left/side: right = left - side
                chans = [c0, [l - s for l, s in zip(c0, c1)]]
            elif ch_code == 9:  # side/right: left = right + side
                chans = [[r + s for s, r in zip(c0, c1)], c1]
            else:  # mid/side
                left, right = [], []
                for m, s in zip(c0, c1):
                    m = (m << 1) | (s & 1)
                    left.append((m + s) >> 1)
                    right.append((m - s) >> 1)
                chans = [left, right]
        else:
            raise FlacError(f"reserved channel assignment {ch_code}")
        if channels != n_ch:
            raise FlacError("frame channel count differs from STREAMINFO")

        bits.align()
        if verify_crc:
            frame_crc = crc16(data[frame_start:bits.byte])
            if bits.read(16) != frame_crc:
                raise FlacError("frame CRC-16 mismatch")
        else:
            bits.read(16)

        out.append(chans)
        n_decoded += block_size

    if total and n_decoded < total:
        raise FlacError("stream ended before total_samples")

    if not out:
        return np.zeros((0, channels), np.int32), rate, bps
    pcm = np.concatenate(
        [np.array(chans, dtype=np.int64).T for chans in out], axis=0)
    if total:
        pcm = pcm[:total]
    return pcm.astype(np.int32), rate, bps


def pcm_to_f32(pcm: np.ndarray, bits: int) -> np.ndarray:
    """int samples at `bits` depth -> f32, exactly as dr_flac converts
    (MSB-align to 32 bits, then /2^31 in double, cast to f32 —
    reference: examples/miniaudio.h:82143)."""
    shifted = pcm.astype(np.int64) << (32 - bits)
    return (shifted.astype(np.float64) / 2147483648.0).astype(np.float32)
