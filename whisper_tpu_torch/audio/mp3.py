"""From-scratch MPEG audio (MP3/MP2/MP1) decoder.

The reference decodes mp3 through its vendored miniaudio/dr_mp3
(reference: examples/common-whisper.cpp:46 — the decode path every
reference example and the server use).  This is an independent textbook
implementation of the ISO/IEC 11172-3 (MPEG-1) and 13818-3 (MPEG-2 LSF,
incl. the 2.5 extension) decode pipeline:

  frame sync / free-format detection → side info → bit reservoir →
  scalefactors (MPEG-1 scfsi + LSF partitions) → huffman + requantization →
  MS/intensity stereo → short-block reordering → alias reduction →
  IMDCT (36/12, block-type windows, overlap-add) → frequency inversion →
  polyphase synthesis filterbank (matrixing + ISO Table 3-B.3 window),

plus the Layer I/II path (bit allocation, grouped quantization, the shared
synthesis filterbank).

Canonical constant tables (huffman codebooks, scalefactor-band widths, the
synthesis window) live in `_mp3_tables.py` (see tools/mp3_tables.py for
provenance).  DSP runs vectorized in float64; the final PCM is quantized to
s16 with the reference decoder's exact rounding rule, so output is
bit-comparable against the reference binary (tests/test_mp3_golden.py pins
that on real and generated bitstreams).
"""

from __future__ import annotations

import numpy as np

from . import _mp3_tables as T


class Mp3Error(Exception):
    pass


# ---------------------------------------------------------------------------
# header parsing (ISO 11172-3 §2.4.1.3)

_HZ = (44100, 48000, 32000)
_HALFRATE = (
    # MPEG-2/2.5: layer III, II, I  (kbps/2)
    ((0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80),
     (0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80),
     (0, 16, 24, 28, 32, 40, 48, 56, 64, 72, 80, 88, 96, 112, 128)),
    # MPEG-1
    ((0, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160),
     (0, 16, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192),
     (0, 16, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224)),
)

MODE_STEREO, MODE_JOINT, MODE_DUAL, MODE_MONO = 0, 1, 2, 3
SHORT_BLOCK, STOP_BLOCK = 2, 3
MAX_RESERVOIR = 511
MAX_FREE_FORMAT_FRAME = 2304
FRAME_SYNC_MATCHES = 10


def _hdr_valid(h) -> bool:
    return (len(h) >= 4 and h[0] == 0xFF
            and ((h[1] & 0xF0) == 0xF0 or (h[1] & 0xFE) == 0xE2)
            and ((h[1] >> 1) & 3) != 0          # layer
            and (h[2] >> 4) != 15               # bitrate
            and ((h[2] >> 2) & 3) != 3)         # samplerate


def _hdr_is_free_format(h) -> bool:
    return (h[2] & 0xF0) == 0


def _hdr_compare(h1, h2) -> bool:
    return (_hdr_valid(h2)
            and ((h1[1] ^ h2[1]) & 0xFE) == 0
            and ((h1[2] ^ h2[2]) & 0x0C) == 0
            and _hdr_is_free_format(h1) == _hdr_is_free_format(h2))


def _hdr_mpeg1(h) -> bool:
    return bool(h[1] & 0x8)


def _hdr_layer(h) -> int:
    """1, 2 or 3."""
    return 4 - ((h[1] >> 1) & 3)


def _hdr_bitrate_kbps(h) -> int:
    return 2 * _HALFRATE[int(_hdr_mpeg1(h))][((h[1] >> 1) & 3) - 1][h[2] >> 4]


def _hdr_sample_rate(h) -> int:
    hz = _HZ[(h[2] >> 2) & 3]
    if not _hdr_mpeg1(h):
        hz >>= 1
    if not (h[1] & 0x10):   # MPEG-2.5
        hz >>= 1
    return hz


def _hdr_frame_samples(h) -> int:
    if _hdr_layer(h) == 1:
        return 384
    return 576 if (h[1] & 14) == 2 else 1152   # MPEG-2/2.5 L3: one granule


def _hdr_frame_bytes(h, free_format_size: int) -> int:
    n = _hdr_frame_samples(h) * _hdr_bitrate_kbps(h) * 125 // _hdr_sample_rate(h)
    if _hdr_layer(h) == 1:
        n &= ~3
    return n if n else free_format_size


def _hdr_padding(h) -> int:
    return (4 if _hdr_layer(h) == 1 else 1) if (h[2] & 0x2) else 0


def _my_sr_index(h) -> int:
    """0..8: MPEG2.5 rates 0-2, MPEG2 3-5, MPEG1 6-8."""
    return ((h[2] >> 2) & 3) + (((h[1] >> 3) & 1) + ((h[1] >> 4) & 1)) * 3


# ---------------------------------------------------------------------------
# bit reader (MSB first)

class _Bits:
    __slots__ = ("data", "pos", "limit")

    def __init__(self, data, limit_bits=None):
        self.data = data
        self.pos = 0
        self.limit = len(data) * 8 if limit_bits is None else limit_bits

    def get(self, n: int) -> int:
        pos = self.pos
        self.pos = pos + n
        if self.pos > self.limit:
            return 0
        end = (self.pos + 7) >> 3
        word = int.from_bytes(self.data[pos >> 3:end], "big")
        return (word >> ((end << 3) - self.pos)) & ((1 << n) - 1)

    def get1(self) -> int:
        p = self.pos
        self.pos = p + 1
        if self.pos > self.limit:
            return 0
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1


# ---------------------------------------------------------------------------
# precomputed DSP constants

_i = np.arange(64)[:, None]
_k = np.arange(32)[None, :]
_N64 = np.cos((16 + _i) * (2 * _k + 1) * np.pi / 64.0)              # (64, 32)
_D = np.asarray(T.SYNTH_WINDOW_D65536, dtype=np.float64) / 65536.0

_n36 = np.arange(36)[:, None]
_k18 = np.arange(18)[None, :]
_M36 = np.cos(np.pi / 72.0 * (2 * _n36 + 1 + 18) * (2 * _k18 + 1))  # (36, 18)
_n12 = np.arange(12)[:, None]
_k6 = np.arange(6)[None, :]
_M12 = np.cos(np.pi / 24.0 * (2 * _n12 + 1 + 6) * (2 * _k6 + 1))    # (12, 6)

_WIN_NORMAL = np.sin(np.pi / 36.0 * (np.arange(36) + 0.5))
_WIN_START = _WIN_NORMAL.copy()
_WIN_START[18:24] = 1.0
_WIN_START[24:30] = np.sin(np.pi / 12.0 * (np.arange(6) + 6.5))
_WIN_START[30:] = 0.0
_WIN_STOP = _WIN_NORMAL.copy()
_WIN_STOP[:6] = 0.0
_WIN_STOP[6:12] = np.sin(np.pi / 12.0 * (np.arange(6) + 0.5))
_WIN_STOP[12:18] = 1.0
_WIN12 = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))
# window by block type (short handled separately)
_WINDOWS = {0: _WIN_NORMAL, 1: _WIN_START, 3: _WIN_STOP}

_AA_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_AA_CS = 1.0 / np.sqrt(1.0 + _AA_CI * _AA_CI)
_AA_CA = np.abs(_AA_CI) * _AA_CS

# intensity-stereo pan pairs (MPEG-1): r = tan(pos*pi/12); (r, 1)/(1+r)
_PAN = np.zeros((7, 2))
for _p in range(7):
    if _p == 6:
        _PAN[_p] = (1.0, 0.0)
    else:
        _r = np.tan(_p * np.pi / 12.0)
        _PAN[_p] = (_r / (1.0 + _r), 1.0 / (1.0 + _r))

_POW43 = np.arange(8208, dtype=np.float64) ** (4.0 / 3.0)   # 15 + 2^13 max


def _build_huff():
    tables = {}
    for t, entries in T.HUFF_TABLES.items():
        tables[t] = {(length, code): (x, y) for code, length, x, y in entries}
    c1 = [{(length, code): flags for code, length, flags in entries}
          for entries in T.COUNT1_TABLES]
    return tables, c1


_HUFF, _COUNT1 = _build_huff()


# ---------------------------------------------------------------------------
# Layer III: side info (ISO 11172-3 §2.4.1.7 field layout, §2.4.2.7
# semantics; MPEG-2 LSF differences per ISO 13818-3 §2.4.1.7)

class _GrInfo:
    __slots__ = ("sfbtab", "part_23_length", "big_values", "global_gain",
                 "scalefac_compress", "block_type", "mixed_block_flag",
                 "n_long_sfb", "n_short_sfb", "regions",
                 "subblock_gain", "preflag", "scalefac_scale", "count1_table",
                 "scfsi")


def _leaked_scfsi(priv: int, mono: bool, ch: int):
    """Granule-0 'scfsi' (oracle-parity quirk).

    Granule 0 has no earlier granule to copy scalefactors from, so its
    scfsi is undefined by the spec.  The reference's vendored decoder
    shifts the side info's private bits through the same register it
    holds scfsi in, and they leak into granule 0's scfsi groups: for
    mono, the top private bit lands on group 3; for stereo, the three
    private bits land on channel 1's groups 1..3.  A set bit makes
    granule 0 copy from the (zero-initialised) scalefactor store instead
    of reading bits, changing all subsequent bit positions.  Mirrored
    here because the goldens pin s16 parity with that decoder on
    arbitrary bitstreams (any set private bit is encoder garbage either
    way — the spec defines none)."""
    if mono:
        return [0, 0, 0, (priv >> 4) & 1]
    if ch == 1:
        return [0, (priv >> 2) & 1, (priv >> 1) & 1, priv & 1]
    return [0, 0, 0, 0]


def _read_side_info(bits: _Bits, h):
    mpeg1 = _hdr_mpeg1(h)
    mono = (h[3] & 0xC0) == 0xC0
    nch = 1 if mono else 2
    # 11.025 and 12 kHz share scalefactor-band tables (8 rows for 9 rates)
    sfb_row = max(_my_sr_index(h) - 1, 0)

    if mpeg1:
        main_data_begin = bits.get(9)
        priv = bits.get(5 if mono else 3)
        # scfsi[ch][group 0..3]: granule 1 reuses granule 0's scalefactors
        # for the groups whose bit is set (§2.4.2.7)
        scfsi = [[bits.get1() for _ in range(4)] for _ in range(nch)]
        n_granules = 2
    else:
        main_data_begin = bits.get(8)
        priv = bits.get(nch)
        scfsi = [[0] * 4 for _ in range(nch)]
        n_granules = 1

    grs = []
    part_23_sum = 0
    # scfsi is undefined for short blocks; like the reference's vendored
    # decoder, a channel whose granule 0 is short-windowed also has its
    # granule-1 scfsi ignored (there are no granule-0 long-block
    # scalefactors to copy)
    blocked = [False] * nch
    for igr in range(n_granules):
        for ch in range(nch):
            gr = _GrInfo()
            gr.part_23_length = bits.get(12)
            part_23_sum += gr.part_23_length
            gr.big_values = bits.get(9)
            if gr.big_values > 288:    # §2.4.2.7: big_values <= 288
                raise Mp3Error("big_values > 288")
            gr.global_gain = bits.get(8)
            gr.scalefac_compress = bits.get(4 if mpeg1 else 9)
            gr.sfbtab = T.SFB_LONG[sfb_row]
            gr.n_long_sfb = 22
            gr.n_short_sfb = 0
            use_scfsi = (scfsi[ch] if igr else
                         _leaked_scfsi(priv, mono, ch))
            if bits.get1():            # window_switching_flag
                gr.block_type = bits.get(2)
                if gr.block_type == 0:
                    raise Mp3Error("block_type 0 with window switching")
                gr.mixed_block_flag = bits.get1()
                # window-switching frames fix region 0 at 8 bands (9 in
                # the window-split counting of non-mixed short blocks)
                # and region 1 runs to the end of the spectrum
                region0_sfb = 8
                if gr.block_type == SHORT_BLOCK:
                    use_scfsi = [0] * 4
                    if igr == 0:
                        blocked[ch] = True
                    if gr.mixed_block_flag:
                        gr.sfbtab = T.SFB_MIXED[sfb_row]
                        gr.n_long_sfb = 8 if mpeg1 else 6
                        gr.n_short_sfb = 30
                    else:
                        region0_sfb = 9
                        gr.sfbtab = T.SFB_SHORT[sfb_row]
                        gr.n_long_sfb = 0
                        gr.n_short_sfb = 39
                tsel0, tsel1 = bits.get(5), bits.get(5)
                gr.subblock_gain = [bits.get(3), bits.get(3), bits.get(3)]
                gr.regions = ((tsel0, region0_sfb), (tsel1, 40), (0, 0))
            else:
                gr.block_type = 0
                gr.mixed_block_flag = 0
                tsel0, tsel1, tsel2 = bits.get(5), bits.get(5), bits.get(5)
                r0 = bits.get(4) + 1   # region0_count+1 bands (§2.4.2.7)
                r1 = bits.get(3) + 1
                gr.subblock_gain = [0, 0, 0]
                gr.regions = ((tsel0, r0), (tsel1, r1), (tsel2, 40))
            gr.scfsi = [0] * 4 if blocked[ch] else use_scfsi
            # LSF transmits no preflag bit; pretab application is decided
            # during scalefactor decode (see _decode_scalefactors)
            gr.preflag = bits.get1() if mpeg1 else 0
            gr.scalefac_scale = bits.get1()
            gr.count1_table = bits.get1()
            grs.append(gr)
    if part_23_sum + bits.pos > bits.limit + main_data_begin * 8:
        raise Mp3Error("part_23 overflow")
    return grs, main_data_begin


# ---------------------------------------------------------------------------
# Layer III: scalefactors

# ISO 11172-3 Table B.8: scalefac_compress -> (slen1, slen2).  slen1 codes
# scalefactor groups 0-1 (sfb 0-10 long), slen2 groups 2-3 (sfb 11-20).
_SLEN_L3 = ((0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
            (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3))


def _lsf_slens(sfc: int, intensity: bool):
    """ISO 13818-3 §2.4.3.2: decompose the 9-bit LSF scalefac_compress
    into four code lengths + the partition block (0..2) selecting the
    per-group scalefactor counts.  The intensity scheme applies to the
    right channel of an intensity-stereo frame (sfc pre-shifted by 1;
    the dropped bit is intensity_scale)."""
    if intensity:
        if sfc < 180:
            return (sfc // 36, (sfc % 36) // 6, sfc % 6, 0), 0
        if sfc < 244:
            sfc -= 180
            return (sfc // 16, (sfc // 4) % 4, sfc % 4, 0), 1
        sfc -= 244
        return (sfc // 3, sfc % 3, 0, 0), 2
    if sfc < 400:
        return ((sfc // 16) // 5, (sfc // 16) % 5, (sfc % 16) // 4, sfc % 4), 0
    if sfc < 500:
        sfc -= 400
        return ((sfc // 4) // 5, (sfc // 4) % 5, sfc % 4, 0), 1
    sfc -= 500
    return (sfc // 3, sfc % 3, 0, 0), 2


def _read_scf_codes(bits: _Bits, slens, counts, ist_pos, copy, sentinel):
    """Walk the four scalefactor groups: read `slen`-bit codes, or (MPEG-1
    scfsi) copy the channel's stored granule-0 codes.  -> iscf ints (40,).

    ist_pos persists per channel: it stores the raw codes because the
    right channel's scalefactors ARE the intensity positions
    (§2.4.3.4.9.3) and scfsi copies granule-0 values out of it again.
    Under LSF (`sentinel`), an all-ones code marks the 'illegal intensity
    position' and is stored as 255 (13818-3 §2.4.3.4.9.3)."""
    iscf = np.zeros(40, dtype=np.int64)
    k = 0
    for slen, cnt, cp in zip(slens, counts, copy):
        if cnt == 0:
            break
        if cp:
            iscf[k:k + cnt] = ist_pos[k:k + cnt]
        elif slen == 0:
            ist_pos[k:k + cnt] = 0
        else:
            top = (1 << slen) - 1
            for j in range(k, k + cnt):
                s = bits.get(slen)
                iscf[j] = s
                ist_pos[j] = 255 if (sentinel and s == top) else s
        k += cnt
    return iscf


def _decode_scalefactors(h, ist_pos, bits, gr: _GrInfo, ch: int):
    # partition rows are [long, mixed, short]; counts per group come from
    # ISO 11172-3 §2.4.2.7 (MPEG-1) / 13818-3 Table B.2-style nr_of_sfb
    part_row = T.SCF_PARTITIONS[
        (1 if gr.n_short_sfb else 0) + (1 if not gr.n_long_sfb else 0)]
    scf_shift = gr.scalefac_scale + 1
    preflag = gr.preflag
    if _hdr_mpeg1(h):
        s1, s2 = _SLEN_L3[gr.scalefac_compress]
        slens = (s1, s1, s2, s2)
        counts = part_row[0:4]
        iscf = _read_scf_codes(bits, slens, counts, ist_pos,
                               gr.scfsi, sentinel=False)
    else:
        ist = bool(h[3] & 0x10) and ch == 1
        slens, block = _lsf_slens(gr.scalefac_compress >> int(ist), ist)
        # partition rows: [mpeg1, lsf block 0-2, lsf-intensity block 0-2]
        base = (1 + 3 * int(ist) + block) * 4
        counts = part_row[base:base + 4]
        iscf = _read_scf_codes(bits, slens, counts, ist_pos,
                               (0, 0, 0, 0), sentinel=True)
        # 13818-3 applies pretab in the third non-intensity partition
        # block (scalefac_compress >= 500); the reference's vendored
        # decoder tests the RAW value, which also catches the intensity
        # channel at raw >= 500 — mirrored for golden parity
        preflag = gr.scalefac_compress >= 500
    if gr.n_short_sfb:
        sh = 3 - scf_shift
        for i in range(gr.n_long_sfb, gr.n_long_sfb + gr.n_short_sfb, 3):
            iscf[i + 0] += gr.subblock_gain[0] << sh
            iscf[i + 1] += gr.subblock_gain[1] << sh
            iscf[i + 2] += gr.subblock_gain[2] << sh
    elif preflag:
        iscf[11:21] += np.asarray(T.PREAMP, dtype=np.int64)
    return iscf


# ---------------------------------------------------------------------------
# Layer III: huffman + requantization

def _huffman_decode(bits: _Bits, gr: _GrInfo, limit: int):
    """Decode raw quantized magnitudes + signs; requantization is
    vectorized afterwards.  (ISO 11172-3 §2.4.3.4.)"""
    vals = np.zeros(576, dtype=np.int64)
    neg = np.zeros(576, dtype=bool)
    widths = gr.sfbtab
    pos = 0
    sfb_i = 0
    big_pairs = gr.big_values

    # big_values region: §2.4.2.7 splits the spectrum into three regions,
    # each with its own codebook, sized in scalefactor bands
    for tab_num, region_sfbs in gr.regions:
        if big_pairs <= 0:
            break
        table = _HUFF.get(tab_num)
        linbits = T.LINBITS[tab_num]
        for _ in range(region_sfbs):
            np_pairs = widths[sfb_i] // 2
            sfb_i += 1
            decode = min(big_pairs, np_pairs)
            for _ in range(decode):
                if table is None:
                    x = y = 0
                else:
                    code = 0
                    length = 0
                    while True:
                        code = (code << 1) | bits.get1()
                        length += 1
                        hit = table.get((length, code))
                        if hit is not None:
                            x, y = hit
                            break
                        if length > 24:
                            # over-long codeword (unreachable with the
                            # canonical tables): abandon the granule's
                            # remaining data but keep what decoded, the
                            # same recovery the reference applies
                            bits.pos = limit
                            return vals, neg
                for v in (x, y):
                    if v == 15 and linbits:
                        v += bits.get(linbits)
                    if v and bits.get1():
                        neg[pos] = True
                    vals[pos] = v
                    pos += 1
            big_pairs -= np_pairs
            if big_pairs <= 0:
                break

    # count1 region: quads until the part_23 limit (a quad decoded across
    # the boundary is discarded, like the reference)
    c1 = _COUNT1[gr.count1_table]
    while pos <= 572:
        code = 0
        length = 0
        while True:
            code = (code << 1) | bits.get1()
            length += 1
            flags = c1.get((length, code))
            if flags is not None:
                break
            if length > 8:
                flags = 0
                break
        if bits.pos > limit:
            break
        for s in range(4):
            if flags & (8 >> s):
                vals[pos + s] = 1
                if bits.get1():
                    neg[pos + s] = True
        pos += 4
    bits.pos = limit
    return vals, neg


def _requantize(gr: _GrInfo, iscf, vals, neg, ms_stereo: bool):
    """xr = sign * |v|^(4/3) * 2^((gg-210)/4 - (iscf<<shift)/4)  (-2 q-steps
    more under MS stereo: the (a±b)/sqrt(2) normalization)."""
    scf_shift = gr.scalefac_scale + 1
    gain_q = gr.global_gain - 210 - (2 if ms_stereo else 0)
    n_bands = gr.n_long_sfb + gr.n_short_sfb
    widths = np.asarray(gr.sfbtab[:n_bands], dtype=np.int64)
    band_exp = gain_q - (iscf[:n_bands] << scf_shift)
    exps = np.full(576, float(gain_q))
    flat = np.repeat(band_exp.astype(np.float64), widths)
    exps[:flat.shape[0]] = flat
    mag = _POW43[np.minimum(vals, len(_POW43) - 1)]
    xr = mag * np.exp2(exps * 0.25)
    xr[neg] = -xr[neg]
    return xr


# ---------------------------------------------------------------------------
# Layer III: stereo

def _stereo_top_band(right, sfbtab, n_bands):
    """Last band (per short sub-block) where the right channel is nonzero."""
    max_band = [-1, -1, -1]
    k = 0
    for i in range(n_bands):
        w = sfbtab[i]
        if np.any(right[k:k + w] != 0):
            max_band[i % 3] = i
        k += w
    return max_band


def _stereo_process(left, right, ist_pos, sfbtab, h, max_band, mpeg2_sh):
    max_pos = 7 if _hdr_mpeg1(h) else 64
    ms = (h[3] & 0xE0) == 0x60
    k = 0
    i = 0
    while sfbtab[i]:
        w = sfbtab[i]
        ipos = int(ist_pos[i])
        if i > max_band[i % 3] and ipos < max_pos:
            s = np.sqrt(2.0) if ms else 1.0
            if _hdr_mpeg1(h):
                kl, kr = _PAN[ipos]
            else:
                kl = 1.0
                kr = np.exp2(-0.25 * (((ipos + 1) >> 1) << mpeg2_sh))
                if ipos & 1:
                    kl, kr = kr, 1.0
            seg = left[k:k + w].copy()
            left[k:k + w] = seg * (kl * s)
            right[k:k + w] = seg * (kr * s)
        elif ms:
            a = left[k:k + w].copy()
            left[k:k + w] = a + right[k:k + w]
            right[k:k + w] = a - right[k:k + w]
        k += w
        i += 1


def _intensity_stereo(left, right, ist_pos, gr_pair, h):
    gr = gr_pair[0]
    n_sfb = gr.n_long_sfb + gr.n_short_sfb
    max_blocks = 3 if gr.n_short_sfb else 1
    max_band = _stereo_top_band(right, gr.sfbtab, n_sfb)
    if gr.n_long_sfb:
        m = max(max_band)
        max_band = [m, m, m]
    for i in range(max_blocks):
        default_pos = 3 if _hdr_mpeg1(h) else 0
        itop = n_sfb - max_blocks + i
        prev = itop - max_blocks
        ist_pos[itop] = default_pos if max_band[i] >= prev else ist_pos[prev]
    _stereo_process(left, right, ist_pos, gr.sfbtab, h, max_band,
                    gr_pair[-1].scalefac_compress & 1)


def _midside(left, right):
    a = left.copy()
    left += right
    right[:] = a - right


# ---------------------------------------------------------------------------
# Layer III: reorder / antialias / IMDCT / inversion

def _reorder(grbuf, start, sfb_widths):
    """Short-block reordering: per-window runs -> per-coefficient triples."""
    src = grbuf[start:]
    out = []
    k = 0
    i = 0
    while sfb_widths[i]:
        w = sfb_widths[i]
        block = src[k:k + 3 * w].reshape(3, w)
        out.append(block.T.reshape(-1))
        k += 3 * w
        i += 3
    flat = np.concatenate(out)
    grbuf[start:start + flat.shape[0]] = flat


def _antialias(grbuf, nbands):
    """Butterflies across each long-block subband boundary (ISO §2.4.3.4.10.1)."""
    for b in range(nbands):
        base = 18 * (b + 1)
        u = grbuf[base:base + 8].copy()
        d = grbuf[base - 8:base][::-1].copy()
        grbuf[base:base + 8] = u * _AA_CS - d * _AA_CA
        grbuf[base - 8:base] = (u * _AA_CA + d * _AA_CS)[::-1]


_W2_LONG = _WIN_NORMAL[18:]     # consumption window, long-type consumer
_W2_SHORT = _WIN_START[18:]     # consumption window, short/stop consumer
_W2_SHORT_INV = np.where(_W2_SHORT > 0, 1.0 / np.where(_W2_SHORT > 0, _W2_SHORT, 1.0), 0.0)


def _imdct_bands(grbuf, overlap, block_type, n_long_bands):
    """IMDCT + window + overlap-add, in place over the (32, 18) grid.

    Overlap convention (mirrors the reference decoder's): the stored tail is
    UNWINDOWED; the consuming granule applies the previous block's tail
    window by assumption — the normal tail when the consuming band is
    long-windowed (block types 0/1, and the long bands of a mixed block),
    the start-block tail when it is short-windowed or a stop block.  For
    spec-valid window sequences this equals the textbook
    `out[n] = ovl[n] + z[n]*w[n]` overlap-add exactly; on invalid
    transitions it reproduces the reference's behavior bit-for-bit instead
    of the textbook's.  Short blocks store their (windowed, overlap-added)
    tail pre-divided by the start tail so the same consumption rule holds."""
    X = grbuf.reshape(32, 18)

    def imdct36(rows, win, w2):
        z = _M36 @ X[rows].T                        # (36, n), unwindowed
        buf = overlap[rows] * w2[None, :] + (z[:18] * win[:18, None]).T
        overlap[rows] = z[18:].T
        X[rows] = buf

    if block_type == SHORT_BLOCK:
        if n_long_bands:
            imdct36(slice(0, n_long_bands), _WIN_NORMAL, _W2_LONG)
        rest = slice(n_long_bands, 32)
        nb = 32 - n_long_bands
        Xs = X[rest].reshape(nb, 6, 3)              # (band, coeff, window)
        z = np.einsum("nk,bkw->bwn", _M12, Xs) * _WIN12[None, None, :]
        out = np.zeros((nb, 36))
        out[:, 6:18] += z[:, 0]
        out[:, 12:24] += z[:, 1]
        out[:, 18:30] += z[:, 2]
        buf = overlap[rest] * _W2_SHORT[None, :] + out[:, :18]
        overlap[rest] = out[:, 18:] * _W2_SHORT_INV[None, :]
        X[rest] = buf
    else:
        win = _WINDOWS[block_type]
        w2 = _W2_LONG if block_type in (0, 1) else _W2_SHORT
        if n_long_bands:
            imdct36(slice(0, n_long_bands), _WIN_NORMAL, _W2_LONG)
            imdct36(slice(n_long_bands, 32), win, w2)
        else:
            imdct36(slice(0, 32), win, w2)


def _freq_inversion(grbuf):
    X = grbuf.reshape(32, 18)
    X[1::2, 1::2] = -X[1::2, 1::2]


# ---------------------------------------------------------------------------
# polyphase synthesis (shared by all layers)

def _scale_pcm_s16(x: np.ndarray) -> np.ndarray:
    """The reference decoder's exact f32->s16 rounding."""
    x32 = x.astype(np.float32).astype(np.float64)
    s = np.trunc(x32 + 0.5)
    s = s - (s < 0)
    s = np.where(x32 >= 32766.5, 32767.0, s)
    s = np.where(x32 <= -32767.5, -32768.0, s)
    return np.clip(s, -32768, 32767).astype(np.int16)


class _Synth:
    """V-FIFO state + the textbook windowed matrixing:

    PCM_t[j] = sum_{a=0}^{15} D[j+32a] * V_{t-a}[j if a even else 32+j]."""

    def __init__(self):
        self.hist = np.zeros((2, 15, 64))   # per channel

    def run(self, S, ch: int) -> np.ndarray:
        """S: (T, 32) subband slots -> (T*32,) PCM in +-32768 scale."""
        Tn = S.shape[0]
        V = S @ _N64.T                                      # (T, 64)
        Vall = np.concatenate([self.hist[ch], V], axis=0)   # (15+T, 64)
        self.hist[ch] = Vall[-15:]
        pcm = np.zeros((Tn, 32))
        for a in range(16):
            cols = slice(0, 32) if a % 2 == 0 else slice(32, 64)
            pcm += Vall[15 - a:15 - a + Tn, cols] * _D[32 * a:32 * a + 32][None, :]
        return pcm.reshape(-1) * 32768.0    # s16 scale for _scale_pcm_s16


# ---------------------------------------------------------------------------
# Layer I/II (ISO 11172-3 §2.4.2.5-2.4.2.6 bit allocation + scalefactors,
# §2.4.3.3 requantization; class/width data from Annex B Tables 3-B.2/3-B.4)

_L12_DEQ_BASE = (2.0 ** -20, 2.0 ** -20 * 2.0 ** (-1.0 / 3.0),
                 2.0 ** -20 * 2.0 ** (-2.0 / 3.0))

# quantization-class codes (the values in L12_BITALLOC_CODES): 0 = band not
# transmitted; 1..16 = ungrouped, code-length == class, (1<<c)-1 steps;
# 17..19 = the grouped classes where ONE code word carries 3 consecutive
# samples in base-`steps` digits (ISO §2.4.3.3.3): {class: (steps, bits)}
_L12_GROUPED = {17: (3, 5), 18: (5, 7), 19: (9, 10)}

# ISO 11172-3 §2.4.2.6 scfsi -> which of the three 12-sample parts carry a
# transmitted scalefactor (an unset part reuses the last one read):
# 0 = all three; 1 = parts 0 and 2 (1 copies 0); 2 = one for all three;
# 3 = parts 0 and 1 (2 copies 1)
_L12_SCF_READ = ((1, 1, 1), (1, 0, 1), (1, 0, 0), (1, 1, 0))


def _l12_steps(cls: int) -> int:
    return _L12_GROUPED[cls][0] if cls >= 17 else (1 << cls) - 1


def _l12_scale(cls: int, idx: int) -> float:
    """scalefactor(idx) / steps, with scalefactor(idx) = 2^(2 - idx/3).

    ISO Table 3-B.1 defines scalefactor(idx) = 2^(1 - idx/3); the extra
    x2 is this decoder's synthesis-gain convention — the polyphase stage
    carries the plain ISO-D window gain, half the reference's
    window-folded gain (Layer III compensates in _requantize, gg-210 vs
    gg-214).  Computed as an exact power-of-two shift times a 3-entry
    cube-root table so the native twin reproduces it bit-for-bit."""
    return (2.0 * _L12_DEQ_BASE[idx % 3] / _l12_steps(cls)
            * float(1 << 21 >> (idx // 3)))


def _l12_subband_alloc(h):
    """Pick the bit-allocation table + band counts (ISO 11172-3 §2.4.2.5:
    Layer I uses the uniform 4-bit table; Layer II selects among Annex B
    Tables 3-B.2a-d by sampling rate and per-channel bitrate; MPEG-2 LSF
    Layer II uses the single 13818-3 Table B.1).  Joint stereo shares
    sample data above `stereo_bands` = 4*(mode_extension+1) subbands
    (§2.4.2.3 bound)."""
    mode = (h[3] >> 6) & 3
    mode_ext = (h[3] >> 4) & 3
    stereo_bands = 0 if mode == MODE_MONO else (
        (mode_ext << 2) + 4 if mode == MODE_JOINT else 32)
    if _hdr_layer(h) == 1:
        alloc, nbands = T.L12_ALLOC_L1, 32
    elif not _hdr_mpeg1(h):
        alloc, nbands = T.L12_ALLOC_L2M2, 30
    else:
        sr = (h[2] >> 2) & 3
        kbps = _hdr_bitrate_kbps(h) >> int(mode != MODE_MONO)
        if not kbps:        # free format: treated as the high-rate table
            kbps = 192
        alloc, nbands = T.L12_ALLOC_L2M1, 27
        if kbps < 56:
            alloc, nbands = T.L12_ALLOC_L2M1_LOW, (12 if sr == 2 else 8)
        elif kbps >= 96 and sr != 1:
            nbands = 30
    return alloc, nbands, min(stereo_bands, nbands)


def _l12_read_scale_info(h, bits: _Bits):
    """-> (classes (bands, 2) int, scf (bands, 2, 3) float, total_bands,
    stereo_bands).  classes[:, 1] is zeroed above stereo_bands (those
    bands share channel-0 samples; see _l12_apply_scf) and everywhere for
    mono.  Bit order: allocation (ch0[, ch1] per band), then scfsi per
    transmitted band/channel, then 6-bit scalefactor indices."""
    alloc, total_bands, stereo_bands = _l12_subband_alloc(h)
    layer1 = _hdr_layer(h) == 1

    classes = np.zeros((total_bands, 2), dtype=np.int64)
    next_seg = seg = 0
    tab_off = nbal = 0
    for sb in range(total_bands):
        if sb == next_seg:              # advance to the next (nbal, codes) run
            tab_off, nbal, cnt = alloc[seg]
            next_seg += cnt
            seg += 1
        c = T.L12_BITALLOC_CODES[tab_off + bits.get(nbal)]
        classes[sb, 0] = c
        if sb < stereo_bands:
            c = T.L12_BITALLOC_CODES[tab_off + bits.get(nbal)]
        classes[sb, 1] = c if stereo_bands else 0

    # Layer I has one scalefactor per band (pattern 2 = first part only,
    # held for the whole frame); Layer II transmits scfsi per band/channel
    scfsi = np.zeros((total_bands, 2), dtype=np.int64)
    for sb in range(total_bands):
        for ch in range(2):
            if classes[sb, ch]:
                scfsi[sb, ch] = 2 if layer1 else bits.get(2)

    scf = np.zeros((total_bands, 2, 3))
    for sb in range(total_bands):
        for ch in range(2):
            cls = int(classes[sb, ch])
            if not cls:
                continue
            s = 0.0
            for part, rd in enumerate(_L12_SCF_READ[scfsi[sb, ch]]):
                if rd:
                    s = _l12_scale(cls, bits.get(6))
                scf[sb, ch, part] = s

    classes[stereo_bands:, 1] = 0
    return classes, scf, total_bands, stereo_bands


def _l12_dequantize_granule(grbuf, slot_off, bits: _Bits, classes,
                            group_size):
    """Read one granule group — 4 granules of `group_size` samples per
    transmitted band/channel (group_size 1 = Layer I, 3 = Layer II) —
    centering codes to signed integers; grouped classes unpack one code
    word into base-`steps` digits (ISO §2.4.3.3)."""
    total_bands = classes.shape[0]
    for j in range(4):
        off = slot_off + group_size * j
        for sb in range(total_bands):
            base = sb * 18 + off
            for ch in range(2):
                cls = int(classes[sb, ch])
                if not cls:
                    continue
                if cls < 17:
                    half = (1 << (cls - 1)) - 1
                    for k in range(group_size):
                        grbuf[ch, base + k] = float(bits.get(cls) - half)
                else:
                    steps, nbits = _L12_GROUPED[cls]
                    code = bits.get(nbits)
                    for k in range(group_size):
                        grbuf[ch, base + k] = float(code % steps
                                                    - steps // 2)
                        code //= steps
    return group_size * 4


def _l12_apply_scf(grbuf, scf, part, total_bands, stereo_bands):
    # bands >= stereo_bands carry shared samples but separate scalefactors
    for b in range(stereo_bands, total_bands):
        grbuf[1, b * 18:b * 18 + 12] = grbuf[0, b * 18:b * 18 + 12]
    for b in range(total_bands):
        sl = slice(b * 18, b * 18 + 12)
        grbuf[0, sl] *= scf[b, 0, part]
        grbuf[1, sl] *= scf[b, 1, part]


# ---------------------------------------------------------------------------
# frame walking + decoder state

def _match_frame(data, off, frame_bytes) -> bool:
    i = 0
    for nmatch in range(FRAME_SYNC_MATCHES):
        h = data[off + i:off + i + 4]
        i += _hdr_frame_bytes(h, frame_bytes) + _hdr_padding(h)
        if off + i + 4 > len(data):
            # ran off the buffer: a candidate is accepted only if at least
            # one follow-up header already matched (the reference rejects a
            # first frame whose successor lies beyond the data)
            return nmatch > 0
        if not _hdr_compare(data[off:off + 4], data[off + i:off + i + 4]):
            return False
    return True


def _find_frame(data, free_format_bytes: int):
    """-> (offset, frame_bytes_incl_padding, free_format_bytes)."""
    n = len(data)
    for i in range(max(0, n - 4)):
        h = data[i:i + 4]
        if not _hdr_valid(h):
            continue
        frame_bytes = _hdr_frame_bytes(h, free_format_bytes)
        frame_and_padding = frame_bytes + _hdr_padding(h)
        k = 4
        while not frame_bytes and k < MAX_FREE_FORMAT_FRAME and i + 2 * k < n - 4:
            if _hdr_compare(h, data[i + k:i + k + 4]):
                fb = k - _hdr_padding(h)
                nextfb = fb + _hdr_padding(data[i + k:i + k + 4])
                if (i + k + nextfb + 4 <= n
                        and _hdr_compare(h, data[i + k + nextfb:i + k + nextfb + 4])):
                    frame_and_padding = k
                    frame_bytes = fb
                    free_format_bytes = fb
            k += 1
        if ((frame_bytes and i + frame_and_padding <= n
             and _match_frame(data, i, frame_bytes))
                or (i == 0 and frame_and_padding == n)):
            return i, frame_and_padding, free_format_bytes
        free_format_bytes = 0
    return n, 0, free_format_bytes


class Mp3Decoder:
    """Stateful frame decoder (bit reservoir, IMDCT overlap, synthesis FIFO)."""

    def __init__(self):
        self.header = b"\x00\x00\x00\x00"
        self.free_format_bytes = 0
        self.reservoir = b""
        self.overlap = np.zeros((2, 32, 18))
        self.synth = _Synth()

    def _reset(self):
        self.__init__()

    def decode_frame(self, data):
        """-> (s16 ndarray (n, ch) or None, consumed_bytes, hz, nch)."""
        frame_size = 0
        i = 0
        if (len(data) > 4 and self.header[0] == 0xFF
                and _hdr_compare(self.header, data)):
            frame_size = (_hdr_frame_bytes(data, self.free_format_bytes)
                          + _hdr_padding(data))
            if frame_size != len(data) and (
                    frame_size + 4 > len(data)
                    or not _hdr_compare(data, data[frame_size:frame_size + 4])):
                frame_size = 0
        if not frame_size:
            self._reset()
            i, frame_size, self.free_format_bytes = _find_frame(
                data, self.free_format_bytes)
            if not frame_size or i + frame_size > len(data):
                return None, i, 0, 0
        h = bytes(data[i:i + 4])
        self.header = h
        consumed = i + frame_size
        nch = 1 if (h[3] & 0xC0) == 0xC0 else 2
        hz = _hdr_sample_rate(h)
        layer = _hdr_layer(h)
        bits = _Bits(data[i + 4:i + frame_size])
        if not (h[1] & 1):     # CRC present: skipped, unverified (as the reference)
            bits.get(16)
        if layer == 3:
            try:
                grs, main_data_begin = _read_side_info(bits, h)
            except Mp3Error:
                self._reset()
                return None, consumed, hz, nch
            if bits.pos > bits.limit:
                # frame too small to hold its own side info (reachable via
                # tiny free-format frames): drop it without touching the
                # bit reservoir, as the native twin does
                self._reset()
                return None, consumed, hz, nch
            pcm = self._decode_l3(h, bits, grs, main_data_begin, nch)
        else:
            try:
                pcm = self._decode_l12(h, bits, layer, nch)
            except Mp3Error:
                self._reset()
                pcm = None
        return pcm, consumed, hz, nch

    # -- layer III ----------------------------------------------------------

    def _decode_l3(self, h, bits: _Bits, grs, main_data_begin, nch):
        # bit reservoir splice
        frame_rest = bytes(bits.data[bits.pos // 8:])
        have = min(len(self.reservoir), main_data_begin)
        maindata = self.reservoir[len(self.reservoir) - have:] + frame_rest
        ok = len(self.reservoir) >= main_data_begin
        out = None
        end_bits = 0
        if ok:
            md = _Bits(maindata)
            n_gran = 2 if _hdr_mpeg1(h) else 1
            out = np.zeros((n_gran * 576, nch), dtype=np.int16)
            ist_pos = np.zeros((2, 40), dtype=np.int64)
            ms = (h[3] & 0xE0) == 0x60
            for igr in range(n_gran):
                grbuf = np.zeros((2, 576))
                gr_pair = grs[igr * nch:igr * nch + nch]
                for ch in range(nch):
                    gr = gr_pair[ch]
                    limit = md.pos + gr.part_23_length
                    iscf = _decode_scalefactors(h, ist_pos[ch], md, gr, ch)
                    vals, neg = _huffman_decode(md, gr, limit)
                    grbuf[ch] = _requantize(gr, iscf, vals, neg, ms)
                if h[3] & 0x10:          # intensity (possibly combined with MS)
                    _intensity_stereo(grbuf[0], grbuf[1], ist_pos[1], gr_pair, h)
                elif ms:
                    _midside(grbuf[0], grbuf[1])
                for ch in range(nch):
                    gr = gr_pair[ch]
                    n_long_bands = ((2 if gr.mixed_block_flag else 0)
                                    << (1 if _my_sr_index(h) == 2 else 0))
                    if gr.n_short_sfb:
                        aa_bands = n_long_bands - 1
                        _reorder(grbuf[ch], n_long_bands * 18,
                                 gr.sfbtab[gr.n_long_sfb:])
                    else:
                        aa_bands = 31
                    _antialias(grbuf[ch], aa_bands)
                    _imdct_bands(grbuf[ch], self.overlap[ch], gr.block_type,
                                 n_long_bands)
                    _freq_inversion(grbuf[ch])
                    S = grbuf[ch].reshape(32, 18).T      # (slots, bands)
                    out[igr * 576:(igr + 1) * 576, ch] = _scale_pcm_s16(
                        self.synth.run(S, ch))
            end_bits = md.pos
        keep = maindata[(end_bits + 7) // 8:]
        if len(keep) > MAX_RESERVOIR:
            keep = keep[len(keep) - MAX_RESERVOIR:]
        self.reservoir = bytes(keep)
        return out

    # -- layer I/II ---------------------------------------------------------

    def _decode_l12(self, h, bits: _Bits, layer, nch):
        classes, scf, total_bands, stereo_bands = _l12_read_scale_info(h, bits)
        group_size = 1 if layer == 1 else 3
        grbuf = np.zeros((2, 576))
        out = np.zeros((_hdr_frame_samples(h), nch), dtype=np.int16)
        slot_off = 0
        pcm_off = 0
        for igr in range(3):
            slot_off += _l12_dequantize_granule(
                grbuf, slot_off, bits, classes, group_size)
            if slot_off == 12:
                _l12_apply_scf(grbuf, scf, igr, total_bands, stereo_bands)
                for ch in range(nch):
                    S = grbuf[ch].reshape(32, 18).T[:12]
                    out[pcm_off:pcm_off + 384, ch] = _scale_pcm_s16(
                        self.synth.run(S, ch))
                grbuf[:] = 0.0
                pcm_off += 384
                slot_off = 0
            if bits.pos > bits.limit:
                raise Mp3Error("layer 1/2 frame overrun")
        return out[:pcm_off] if pcm_off else None


def is_mpeg_audio(data) -> bool:
    """Cheap sniff: ID3v2 tag, or a verified frame-sync chain near the start."""
    if bytes(data[:3]) == b"ID3":
        return True
    off, size, _ = _find_frame(bytes(data[:64 * 1024]), 0)
    return size > 0


def decode_mp3(data):
    """Decode a whole MP3/MP2/MP1 stream.

    Returns (pcm float32 (n, ch), sample_rate).  f32 = s16/32768, matching
    the reference's dr_mp3 (s16 output mode) bit-for-bit at the s16 level."""
    dec = Mp3Decoder()
    data = bytes(data)
    chunks = []
    hz = 0
    nch = 0
    pos = 0
    while pos < len(data):
        pcm, consumed, fhz, fch = dec.decode_frame(data[pos:])
        if consumed == 0:
            break
        pos += consumed
        if pcm is not None and pcm.shape[0]:
            if hz == 0:
                hz, nch = fhz, fch
            if fhz == hz and fch == nch:
                chunks.append(pcm)
    if not chunks:
        raise Mp3Error("no decodable MPEG audio frames")
    pcm = np.concatenate(chunks, axis=0).astype(np.float32) / 32768.0
    return pcm, hz
