"""Ogg container framing (RFC 3533) — the transport under Vorbis audio.

From-scratch page parser/assembler used by the framework's Vorbis decoder
(audio/vorbis.py) and the test-corpus generator (tools/vorbisgen.py).  The
reference decodes ogg/vorbis through its vendored stb_vorbis (reference:
examples/common-whisper.cpp:11-12 enables it inside miniaudio); this module
plus audio/vorbis.py is the framework's native replacement for that path,
pinned against the reference's own stb_vorbis in tests/test_vorbis_golden.py.

Semantics notes (mirroring stb_vorbis's pull reader, the golden oracle):
  * serial numbers are not demultiplexed — pages are consumed in file order
    (stb_vorbis does the same; whisper inputs are single-stream).
  * each page's granule position is attached to the LAST packet that
    completes on that page (stb: end_seg_with_known_loc); the Vorbis layer
    uses it for sample positioning and final-frame truncation.
  * a packet left incomplete at end-of-data is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["is_ogg", "OggError", "PacketInfo", "iter_packets",
           "crc32_ogg", "build_page", "pack_pages"]


class OggError(ValueError):
    pass


def is_ogg(data: bytes) -> bool:
    return len(data) >= 4 and data[:4] == b"OggS"


# CRC-32 with polynomial 0x04c11db7, MSB-first, init 0, no final xor
# (RFC 3533 §6; same table stb_vorbis builds in crc32_init).
_CRC_TABLE = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        t = np.zeros(256, dtype=np.uint64)  # u64 to dodge overflow warnings
        for i in range(256):
            s = i << 24
            for _ in range(8):
                s = ((s << 1) ^ (0x04C11DB7 if s & 0x80000000 else 0)) & 0xFFFFFFFF
            t[i] = s
        _CRC_TABLE = t.astype(np.uint32)
    return _CRC_TABLE


def crc32_ogg(data: bytes, crc: int = 0) -> int:
    table = _crc_table()
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(table[((crc >> 24) & 0xFF) ^ b])
    return crc


@dataclass
class PacketInfo:
    """Positioning info for one assembled packet."""
    granule: int | None      # page granule if this packet is the last one
    #                          completing on its page, else None
    page_is_last: bool       # that page carried the EOS flag
    page_seq: int            # sequence number of the completing page


def _parse_page(data: bytes, off: int, verify_crc: bool = False):
    """Parse one page at `off` -> (header_type, granule, seq, segments,
    payload, next_off).  Raises OggError on malformed framing.

    CRC is verified only when `verify_crc` is set: the golden oracle
    (stb_vorbis) reads and discards the CRC field (stb_vorbis.c
    start_page_no_capturepattern), so slightly-damaged real-world files
    still decode — and the read path skips the per-byte CRC cost."""
    if data[off:off + 4] != b"OggS":
        raise OggError(f"missing capture pattern at {off}")
    if off + 27 > len(data):
        raise OggError("truncated page header")
    version = data[off + 4]
    if version != 0:
        raise OggError(f"unsupported ogg version {version}")
    header_type = data[off + 5]
    granule = int.from_bytes(data[off + 6:off + 14], "little")
    # serial = data[off+14:off+18] (unused, see module docstring)
    seq = int.from_bytes(data[off + 18:off + 22], "little")
    crc = int.from_bytes(data[off + 22:off + 26], "little")
    nsegs = data[off + 26]
    lace_end = off + 27 + nsegs
    if lace_end > len(data):
        raise OggError("truncated lacing table")
    lacing = data[off + 27:lace_end]
    body_len = sum(lacing)
    next_off = lace_end + body_len
    if next_off > len(data):
        raise OggError("truncated page body")
    if verify_crc:
        page = bytearray(data[off:next_off])
        page[22:26] = b"\x00\x00\x00\x00"
        if crc32_ogg(bytes(page)) != crc:
            raise OggError(f"page {seq}: CRC mismatch")
    payload = data[lace_end:next_off]
    return header_type, granule, seq, lacing, payload, next_off


def iter_packets(data: bytes, verify_crc: bool = False):
    """Yield (packet_bytes, PacketInfo) for every complete packet, in order."""
    off = 0
    partial = bytearray()
    have_partial = False
    while off < len(data):
        # tolerate trailing garbage only if no capture pattern (e.g. ID3 tail)
        if data[off:off + 4] != b"OggS":
            break
        header_type, granule, seq, lacing, payload, off = _parse_page(
            data, off, verify_crc=verify_crc)
        continued = bool(header_type & 0x01)
        is_last = bool(header_type & 0x04)
        if not continued and have_partial:
            # lost continuation: drop the partial packet (stb resyncs the same way)
            partial = bytearray()
            have_partial = False
        start = 0
        if continued and not have_partial:
            # continuation of a packet we never started (its earlier pages were
            # lost): discard segments up to the orphan's terminating lacing,
            # like stb's resync to the next packet boundary
            term = next((i for i, lv in enumerate(lacing) if lv < 255), None)
            if term is None:
                continue  # the whole page is the orphan's middle; stay unsynced
            start = term + 1
        # find the last lacing index that completes a packet on this page
        last_completing = -1
        for i, lv in enumerate(lacing):
            if lv < 255:
                last_completing = i
        pos = sum(lacing[:start])
        for i in range(start, len(lacing)):
            lv = lacing[i]
            partial += payload[pos:pos + lv]
            have_partial = True
            pos += lv
            if lv < 255:
                info = PacketInfo(
                    granule=granule if i == last_completing else None,
                    page_is_last=is_last, page_seq=seq)
                yield bytes(partial), info
                partial = bytearray()
                have_partial = False
        # a page ending on lv==255 leaves `partial` to continue on next page


# ---------------------------------------------------------------------------
# Page assembly (used by tools/vorbisgen.py to build test streams)

def build_page(payload_segments: list[bytes], *, granule: int, serial: int,
               seq: int, bos: bool = False, eos: bool = False,
               continued: bool = False) -> bytes:
    """Build one page whose lacing is exactly `payload_segments` (each
    segment must be <= 255 bytes; a 255-byte final segment marks the packet
    as continued on the next page)."""
    if len(payload_segments) > 255:
        raise OggError("too many segments for one page")
    header_type = (0x01 if continued else 0) | (0x02 if bos else 0) | (0x04 if eos else 0)
    lacing = bytes(len(s) for s in payload_segments)
    body = b"".join(payload_segments)
    head = (b"OggS" + bytes([0, header_type])
            + (granule & ((1 << 64) - 1)).to_bytes(8, "little")
            + serial.to_bytes(4, "little")
            + seq.to_bytes(4, "little")
            + b"\x00\x00\x00\x00"
            + bytes([len(payload_segments)]) + lacing)
    crc = crc32_ogg(head + body)
    return head[:22] + crc.to_bytes(4, "little") + head[26:] + body


def _segments_of(packet: bytes) -> list[bytes]:
    """Split a packet into its lacing segments (255-byte chunks plus a final
    short chunk; a packet of length k*255 gets a trailing empty segment)."""
    segs = []
    i = 0
    while True:
        seg = packet[i:i + 255]
        segs.append(seg)
        i += 255
        if len(seg) < 255:
            break
    return segs


def pack_pages(packets: list[tuple[bytes, int]], *, serial: int = 0x5754,
               max_segs_per_page: int = 32, first_seq: int = 0,
               bos_first: bool = True, eos_last: bool = True,
               flush_after: tuple[int, ...] = (0, 2)) -> bytes:
    """Assemble (packet, granule_after_packet) pairs into pages.

    A page's granule is the granule of the last packet completing on it
    (-1 encoded as 2^64-1 when none completes, per RFC 3533).  Packets are
    split across pages whenever the per-page segment budget runs out, which
    exercises the reader's continued-packet path.  `flush_after` forces a
    page boundary after the given packet indices — the defaults put the
    Vorbis ID header alone on the first page and end the header pages
    before audio starts, as the Vorbis-over-Ogg mapping requires.
    """
    pages = []
    seq = first_seq
    pending: list[bytes] = []       # segments queued for the current page
    pending_granule = None
    pending_continued = False
    next_continued = False

    def flush(eos=False):
        nonlocal seq, pending, pending_granule, pending_continued
        if not pending and not eos:
            return
        g = pending_granule if pending_granule is not None else (1 << 64) - 1
        pages.append(build_page(
            pending, granule=g, serial=serial, seq=seq,
            bos=(seq == first_seq and bos_first), eos=eos,
            continued=pending_continued))
        seq += 1
        pending = []
        pending_granule = None
        pending_continued = next_continued

    for idx, (packet, granule) in enumerate(packets):
        mid_packet = False     # True once some segment of this packet is out
        for seg in _segments_of(packet):
            if len(pending) >= max_segs_per_page:
                # the page we're about to start is a continuation only if
                # this packet already has segments on the previous page
                next_continued = mid_packet
                flush()
                next_continued = False
            pending.append(seg)
            mid_packet = True
        pending_granule = granule
        if idx in flush_after:
            flush()
    flush(eos=eos_last)
    return b"".join(pages)
