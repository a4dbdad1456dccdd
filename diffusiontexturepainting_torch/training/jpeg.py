"""JPEG decoding in numpy: what Pillow's Image.open(...).convert("RGB")
gives, byte for byte.

The card's machine has no Pillow, and the reference's texture set (DTD) is
JPEG. Pillow decodes through libjpeg(-turbo) at its defaults, so this
module follows libjpeg's arithmetic step by step:

  entropy decoding   Huffman, 8-bit samples, frames SOF0, SOF1 and SOF2:
                     sequential scans, and progressive ones (DC first and
                     refine, AC first and refine with end-of-band runs);
                     restart intervals; any MCU layout of sampling factors
                     1-2. A 12-bit lookahead table gives a code, its extra
                     bits and the value they extend to in one lookup; a
                     code whose extra bits run past 12 bits takes the
                     table's code and reads them after it, and a code
                     longer than 12 bits is found as libjpeg's
                     jpeg_huff_decode finds it (maxcode by length)
  dequantization     the accurate integer IDCT of jidctint.c
  + IDCT             (jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, the
                     descale with rounding, the clamp through the sample
                     range-limit table with its RANGE_MASK wrap), over every
                     block of a component at once
  upsampling         jdsample.c's fancy (triangle) upsamplers,
                     h2v1_fancy_upsample and h2v2_fancy_upsample (biases 8
                     and 7 alternating), edge samples replicated as
                     libjpeg's context rows are; the box upsamplers where a
                     component is at most 2 samples wide, as libjpeg
                     chooses them
  colour             jdcolor.c's fixed-point YCbCr -> RGB tables
                     (SCALEBITS 16); three components are RGB where a JFIF
                     marker is absent and an Adobe APP14 marker says
                     transform 0 (or the component ids spell R, G, B);
                     one component is gray, repeated into three channels

APPn, COM and EXIF are skipped; no orientation is applied (Image.open
applies none). These raise ValueError: arithmetic coding (SOF9-SOF15),
lossless (SOF3), 12-bit and hierarchical frames, 4-component CMYK/YCCK,
upsampling ratios other than 1x1, 2x1 and 2x2 (4:4:0's h1v2 among them),
a progressive file whose scans leave coefficient bits unknown (where
libjpeg's block smoothing, jdcoefct.c, would apply), and a truncated or
corrupt stream.
"""

from __future__ import annotations

import functools
import re
from array import array

import numpy as np

# the position in the 8x8 block (row-major) of the k-th coefficient in
# zig-zag order (jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# zig-zag index of each block position
_ZIGZAG_OF = np.argsort(NATURAL_ORDER)

_SOF_SUPPORTED = {0xC0: "baseline", 0xC1: "extended", 0xC2: "progressive"}
_SOF_REFUSED = {
    0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
    0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
    0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical",
    0xCF: "arithmetic-coded hierarchical"}
_MARKER_AFTER_SCAN = re.compile(rb"\xff[^\x00]")

# jidctint.c's constants: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX_0_298631336, _FIX_0_390180644 = 2446, 3196
_FIX_0_541196100, _FIX_0_765366865 = 4433, 6270
_FIX_0_899976223, _FIX_1_175875602 = 7373, 9633
_FIX_1_501321110, _FIX_1_847759065 = 12299, 15137
_FIX_1_961570560, _FIX_2_053119869 = 16069, 16819
_FIX_2_562915447, _FIX_3_072711026 = 20995, 25172
_RANGE_MASK = 1023  # MAXJSAMPLE * 4 + 3


def _idct_range_limit() -> np.ndarray:
    """jdmaster.c prepare_range_limit_table's post-IDCT part: the level-
    shifted sample x & RANGE_MASK -> x + 128 for x in [-128, 127], 255
    above up to 383, 0 below down to -384 (x read modulo 1024)."""
    x = np.arange(1024)
    v = np.where(x >= 512, x - 1024, x)
    out = np.where(v > 127, 255, np.where(v < -128, 0, v + 128))
    out[(x >= 384) & (x < 512)] = 255  # x in [128, 512): 255
    out[(x >= 512) & (x < 896)] = 0  # the table's zero half
    return out.astype(np.uint8)


_IDCT_LIMIT = _idct_range_limit()


# --- Huffman tables ---


LOOKAHEAD = 12  # bits of the fast table's index


class _Huffman:
    """One DHT table as the decoder reads it: `fast[i]` for the LOOKAHEAD
    bits i ahead of the read position is a tuple

      DC:  (n, diff)   n bits of code and extra bits consumed, the
                       extended difference
      AC:  (n, r, v)   v != 0: skip r zeros, then v; v == 0: r == 15 is
                       ZRL (16 zeros), r < 0 an end of band covering -r
                       blocks (this one included)

    with n < 0 where code and extra bits run past LOOKAHEAD bits (-n is
    the code's length, the second field its symbol) and n == 0 where the
    code is longer than that: `long(words, pos)` then gives (-length,
    symbol), or raises where no code starts there."""

    def __init__(self, counts, symbols, is_dc: bool, progressive: bool):
        lengths = np.repeat(np.arange(1, 17), counts)
        if len(lengths) != len(symbols):
            raise _corrupt("a DHT table with fewer symbols than codes")
        if is_dc and max(symbols, default=0) > 15:
            raise _corrupt("a DC Huffman symbol above 15")
        codes, code = [], 0
        for n in range(1, 17):  # canonical codes, as jdhuff.c builds them
            for _ in range(counts[n - 1]):
                codes.append(code)
                code += 1
            if code > (1 << n):
                raise _corrupt("bad Huffman table")
            code <<= 1
        bits = LOOKAHEAD
        index = np.arange(1 << bits)
        length = np.zeros(1 << bits, np.int64)
        symbol = np.zeros(1 << bits, np.int64)
        # jdhuff.c's maxcode / valoffset for the codes past the lookahead
        self.maxcode = [-1] * 18
        self.valoffset = [0] * 18
        first = 0
        for n in range(1, 17):
            count = counts[n - 1]
            if count:
                self.valoffset[n] = first - codes[first]
                self.maxcode[n] = codes[first + count - 1]
            first += count
        self.symbols = list(symbols)
        for c, n, s in zip(codes, lengths.tolist(), symbols):
            if n > bits:
                continue
            lo = c << (bits - n)
            length[lo:lo + (1 << (bits - n))] = n
            symbol[lo:lo + (1 << (bits - n))] = s
        size = symbol if is_dc else symbol & 15
        run = symbol >> 4
        if is_dc:
            extra_bits = size
        elif progressive:  # EOBr appends r bits to the run length
            extra_bits = np.where(size == 0, np.where(run == 15, 0, run), size)
        else:  # a sequential scan's EOB reads no bits whatever r says
            extra_bits = size
        total = length + extra_bits
        fits = (length > 0) & (total <= bits)
        shift = np.where(fits, bits - total, 0)
        raw = (index >> shift) & ((1 << extra_bits) - 1)
        value = _extend(raw, size)
        n = np.where(fits, total, -length)
        if is_dc:
            second = np.where(fits, value, symbol)
            self.fast = list(zip(n.tolist(), second.tolist()))
        else:
            eob = (size == 0) & (run != 15)
            eobrun = np.where(progressive, (1 << run) + raw, 1)
            r = np.where(eob, -eobrun, run)
            r = np.where(fits, r, symbol)
            v = np.where(fits & ~eob, value, 0)
            self.fast = list(zip(n.tolist(), r.tolist(), v.tolist()))

    def long(self, words, pos):
        """(-length, symbol) of the code at `pos` longer than LOOKAHEAD
        bits, as jpeg_huff_decode reads it."""
        code = (words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
        for n in range(LOOKAHEAD + 1, 17):
            c = code >> (16 - n)
            if c <= self.maxcode[n]:
                return -n, self.symbols[self.valoffset[n] + c]
        raise _corrupt("bad Huffman code")


@functools.lru_cache(maxsize=64)
def _huffman(counts: bytes, symbols: bytes, is_dc: bool,
             progressive: bool) -> _Huffman:
    """A _Huffman, built once for each table's contents (files written with
    the standard tables share them)."""
    return _Huffman(list(counts), list(symbols), is_dc, progressive)


def _extend(raw, size):
    """The JPEG EXTEND of `raw` read as a `size`-bit magnitude category."""
    return np.where((size > 0) & (raw < (1 << np.maximum(size - 1, 0))),
                    raw - (1 << size) + 1, raw) * (size > 0)


def _extend1(raw: int, size: int) -> int:
    return raw - (1 << size) + 1 if raw < (1 << (size - 1)) else raw


# --- the stream ---


class _Frame:
    def __init__(self, kind, height, width, comps):
        self.kind, self.height, self.width = kind, height, width
        self.comps = comps  # [{id, h, v, tq}]
        self.hmax = max(c["h"] for c in comps)
        self.vmax = max(c["v"] for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        offset = 0
        for c in comps:
            c["dw"] = -(-width * c["h"] // self.hmax)  # downsampled size
            c["dh"] = -(-height * c["v"] // self.vmax)
            c["bw"], c["bh"] = -(-c["dw"] // 8), -(-c["dh"] // 8)
            c["pw"], c["ph"] = self.mcux * c["h"], self.mcuy * c["v"]
            c["offset"] = offset
            offset += c["pw"] * c["ph"] * 64
        self.coefs = array("i", bytes(4 * offset))
        # progressive: the lowest known bit of each coefficient, -1 none
        self.coef_bits = [[-1] * 64 for _ in comps]


def _segments(data: bytes, start: int):
    """The entropy-coded data from `start` to the next marker other than
    RSTn, cut at the restart markers: ([segment bytes, stuffing
    removed], [their RST numbers], the end offset)."""
    segs, rsts, pos = [], [], start
    for m in _MARKER_AFTER_SCAN.finditer(data, start):
        code = data[m.start() + 1]
        if 0xD0 <= code <= 0xD7:
            segs.append(data[pos:m.start()])
            rsts.append(code - 0xD0)
            pos = m.end()
            continue
        segs.append(data[pos:m.start()])
        return segs, rsts, m.start()
    segs.append(data[pos:])
    return segs, rsts, len(data)


def _words(seg: bytes):
    """(words, bits): words[i] holds the 32 bits from byte i on (zeros
    past the end), `bits` the segment's length in bits."""
    seg = seg.replace(b"\xff\x00", b"\xff")
    b = np.frombuffer(seg + bytes(8), np.uint8).astype(np.int64)
    n = len(seg) + 4
    w = (b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]
    return w.tolist(), 8 * len(seg)


def _corrupt(what: str):
    return ValueError(f"JPEG: corrupt data ({what})")


def _scan_units(frame: _Frame, comps: list):
    """The coefficient offsets of a scan's blocks in decode order, with
    each block's index in `comps`, and the blocks an MCU: ([offset],
    [component], blocks per MCU)."""
    if len(comps) == 1:  # non-interleaved: the component's own blocks
        c = frame.comps[comps[0]]
        rows, cols = np.mgrid[0:c["bh"], 0:c["bw"]]
        offs = c["offset"] + (rows * c["pw"] + cols).ravel() * 64
        return offs.tolist(), [0] * offs.size, 1
    offs, which = [], []
    my, mx = np.mgrid[0:frame.mcuy, 0:frame.mcux]
    my, mx = my.ravel(), mx.ravel()
    per_mcu = []
    for j, ci in enumerate(comps):
        c = frame.comps[ci]
        for v in range(c["v"]):
            for h in range(c["h"]):
                per_mcu.append(c["offset"] + ((my * c["v"] + v) * c["pw"]
                                              + mx * c["h"] + h) * 64)
                which.append(j)
    offs = np.stack(per_mcu, 1).ravel()
    n = len(per_mcu)
    return offs.tolist(), which * (frame.mcux * frame.mcuy), n


def _decode_scan(frame, comps, tables, ss, se, ah, al, segs, restart):
    """Decodes one scan's segments into frame.coefs (zig-zag order)."""
    offs, which, per_mcu = _scan_units(frame, comps)
    n_units = len(offs) // per_mcu
    per_seg = restart * per_mcu if restart else len(offs)
    expect = -(-n_units // restart) if restart else 1
    if len(segs) != expect:
        raise _corrupt(f"{len(segs)} restart intervals, expected {expect}")
    coefs = frame.coefs
    progressive = frame.kind == "progressive"
    for i in range(expect):
        lo = i * per_seg
        words, bits = _words(segs[i])
        args = (coefs, words, offs[lo:lo + per_seg],
                which[lo:lo + per_seg])
        try:
            if not progressive:
                used = _sequential(*args, *tables)
            elif ss == 0 and ah == 0:
                used = _dc_first(*args, tables[0], al)
            elif ss == 0:
                used = _dc_refine(*args, al)
            elif ah == 0:
                used = _ac_first(*args, tables[1][0], ss, se, al)
            else:
                used = _ac_refine(*args, tables[1][0], ss, se, al)
        except IndexError:  # read far past the segment's end
            used = bits + 1
        if used > bits:
            raise _corrupt("the entropy-coded data ended early")


def _sequential(coefs, words, offs, which, dc_tabs, ac_tabs):
    pos = 0
    pred = [0] * len(dc_tabs)
    dcf = [t.fast for t in dc_tabs]
    acf = [t.fast for t in ac_tabs]
    for base, ci in zip(offs, which):
        n, diff = dcf[ci][(words[pos >> 3] >> (20 - (pos & 7))) & 0xFFF]
        if n > 0:
            pos += n
        else:
            if n == 0:
                n, diff = dc_tabs[ci].long(words, pos)
            pos -= n
            if diff:
                raw = (words[pos >> 3] >> (32 - (pos & 7) - diff)) & (
                    (1 << diff) - 1)
                pos += diff
                diff = _extend1(raw, diff)
        p = pred[ci] + diff
        pred[ci] = p
        coefs[base] = p
        table, tab = acf[ci], ac_tabs[ci]
        k = 1
        while k < 64:
            n, r, v = table[(words[pos >> 3] >> (20 - (pos & 7))) & 0xFFF]
            if n > 0:
                pos += n
                if v:
                    k += r
                    if k > 63:
                        raise _corrupt("coefficient index past 63")
                    coefs[base + k] = v
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            else:  # r is the symbol
                if n == 0:
                    n, r = tab.long(words, pos)
                pos -= n
                s, r = r & 15, r >> 4
                if s:
                    raw = (words[pos >> 3] >> (32 - (pos & 7) - s)) & (
                        (1 << s) - 1)
                    pos += s
                    k += r
                    if k > 63:
                        raise _corrupt("coefficient index past 63")
                    coefs[base + k] = _extend1(raw, s)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
        if k > 64:
            raise _corrupt("zero run past the block's end")
    return pos


def _dc_first(coefs, words, offs, which, dc_tabs, al):
    pos = 0
    pred = [0] * len(dc_tabs)
    dcf = [t.fast for t in dc_tabs]
    for base, ci in zip(offs, which):
        n, diff = dcf[ci][(words[pos >> 3] >> (20 - (pos & 7))) & 0xFFF]
        if n > 0:
            pos += n
        else:
            if n == 0:
                n, diff = dc_tabs[ci].long(words, pos)
            pos -= n
            if diff:
                raw = (words[pos >> 3] >> (32 - (pos & 7) - diff)) & (
                    (1 << diff) - 1)
                pos += diff
                diff = _extend1(raw, diff)
        p = pred[ci] + diff
        pred[ci] = p
        coefs[base] = p << al
    return pos


def _dc_refine(coefs, words, offs, which, al):
    bit = 1 << al
    pos = 0
    for base in offs:
        if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
            coefs[base] |= bit
        pos += 1
    return pos


def _ac_first(coefs, words, offs, which, tab, ss, se, al):
    table = tab.fast
    pos = 0
    eobrun = 0
    for base in offs:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            n, r, v = table[(words[pos >> 3] >> (20 - (pos & 7))) & 0xFFF]
            if n > 0:
                pos += n
                if v:
                    k += r
                    if k > se:
                        raise _corrupt("coefficient index past the band")
                    coefs[base + k] = v << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = -r - 1
                    break
            else:
                if n == 0:
                    n, r = tab.long(words, pos)
                pos -= n
                s, r = r & 15, r >> 4
                if s:
                    raw = (words[pos >> 3] >> (32 - (pos & 7) - s)) & (
                        (1 << s) - 1)
                    pos += s
                    k += r
                    if k > se:
                        raise _corrupt("coefficient index past the band")
                    coefs[base + k] = _extend1(raw, s) << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    run = 1 << r
                    if r:
                        run += (words[pos >> 3] >> (32 - (pos & 7) - r)) & (
                            (1 << r) - 1)
                        pos += r
                    eobrun = run - 1
                    break
        if k > se + 1:
            raise _corrupt("zero run past the band's end")
    return pos


def _nonzero_bands(coefs, offs, ss, se):
    """For each block of `offs`, the band positions k in [ss, se] whose
    coefficient is nonzero before a refinement scan, as one flat list and
    each block's start in it (a refinement scan creates coefficients only
    behind its read position, so what lies ahead is this)."""
    flat = np.frombuffer(coefs, np.int32)
    band = flat[np.asarray(offs)[:, None] + np.arange(ss, se + 1)] != 0
    blocks, ks = np.nonzero(band)
    starts = np.searchsorted(blocks, np.arange(len(offs) + 1))
    return (ks + ss).tolist(), starts.tolist()


def _ac_refine(coefs, words, offs, which, tab, ss, se, al):
    """jdphuff.c decode_mcu_AC_refine, block by block; the zero runs are
    skipped in one step each, from the block's nonzero positions."""
    table = tab.fast
    p1, m1 = 1 << al, -1 << al
    nz, starts = _nonzero_bands(coefs, offs, ss, se)
    pos = 0
    eobrun = 0
    for b, base in enumerate(offs):
        k = ss
        i, end = starts[b], starts[b + 1]
        if not eobrun:
            while k <= se:
                n, r, v = table[(words[pos >> 3] >> (20 - (pos & 7)))
                                & 0xFFF]
                if n == 0:
                    n, r = tab.long(words, pos)
                if n > 0:
                    if v:  # a new coefficient of size 1: its sign bit
                        if v != 1 and v != -1:
                            raise _corrupt("refinement coefficient of "
                                           "size > 1")
                        pos += n - 1
                        s = 1
                    elif r == 15:
                        pos += n
                        s = 0
                    else:
                        pos += n
                        eobrun = -r
                        break
                else:
                    pos -= n
                    s, r = r & 15, r >> 4
                    if not s and r != 15:
                        run = 1 << r
                        if r:
                            run += (words[pos >> 3] >> (32 - (pos & 7) - r)) \
                                & ((1 << r) - 1)
                            pos += r
                        eobrun = run
                        break
                if s:
                    if s != 1:
                        raise _corrupt("refinement coefficient of size > 1")
                    s = p1 if (words[pos >> 3] >> (31 - (pos & 7))) & 1 \
                        else m1
                    pos += 1
                # advance over nonzero coefficients (a correction bit
                # each) and r zero ones, to the zero that comes next
                while True:
                    nk = nz[i] if i < end else se + 1
                    if r < nk - k:  # the (r + 1)-th zero lies before nk
                        k += r
                        break
                    r -= nk - k
                    k = nk
                    if k > se:
                        break
                    at = base + k
                    if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                        c = coefs[at]
                        if not c & p1:
                            coefs[at] = c + p1 if c >= 0 else c + m1
                    pos += 1
                    i += 1
                    k += 1
                if s:
                    if k > se:
                        raise _corrupt("refinement past the band")
                    coefs[base + k] = s
                k += 1
        if eobrun:
            # correction bits for the nonzero coefficients left in the band
            while i < end and nz[i] < k:
                i += 1
            for j in range(i, end):
                if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                    at = base + nz[j]
                    c = coefs[at]
                    if not c & p1:
                        coefs[at] = c + p1 if c >= 0 else c + m1
                pos += 1
            eobrun -= 1
    return pos


# --- the pixel passes ---


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow over every block at once: (N, 64) coefficients in
    natural order and a (64,) quantization table -> (N, 8, 8) uint8."""
    x = coefs.reshape(-1, 8, 8).astype(np.int64) * quant.reshape(8, 8)
    ws = _idct_1d(x, axis=1, shift=_CONST_BITS - _PASS1_BITS)
    out = _idct_1d(ws, axis=2, shift=_CONST_BITS + _PASS1_BITS + 3)
    return _IDCT_LIMIT[out & _RANGE_MASK]


def _idct_1d(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One pass of jidctint.c along `axis` (1: the columns of pass 1, 2:
    the rows of pass 2), descaled by `shift` with rounding."""
    def at(i):
        return x[:, i, :] if axis == 1 else x[:, :, i]

    z2, z3 = at(2), at(6)
    z1 = (z2 + z3) * _FIX_0_541196100
    tmp2 = z1 - z3 * _FIX_1_847759065
    tmp3 = z1 + z2 * _FIX_0_765366865
    z2, z3 = at(0), at(4)
    tmp0 = (z2 + z3) << _CONST_BITS
    tmp1 = (z2 - z3) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = at(7), at(5), at(3), at(1)
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp0 = tmp0 * _FIX_0_298631336
    tmp1 = tmp1 * _FIX_2_053119869
    tmp2 = tmp2 * _FIX_3_072711026
    tmp3 = tmp3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4

    half = 1 << (shift - 1)
    outs = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    return np.stack([(o + half) >> shift for o in outs], axis=axis)


def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: each sample 3/4 itself + 1/4 its left or
    right neighbour, biases 1 and 2, the edge samples their own
    neighbours."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3/4 the row + 1/4 the row above
    (upper output row) or below (lower), then 3/4 + 1/4 across columns,
    biases 8 and 7; the first and last rows and columns their own
    neighbours (libjpeg's context rows)."""
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for r, near in ((0, up), (1, down)):
        cs = 3 * p + near
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * cs + left + 8) >> 4
        out[r::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """A component's (dh, dw) samples brought to the full (2x) grid as
    libjpeg's jinit_upsampler picks: fancy where the component is more
    than 2 samples wide, else the box."""
    if (rh, rv) == (1, 1):
        return plane
    if (rh, rv) not in ((2, 1), (2, 2)):
        raise ValueError(f"JPEG: upsampling by {rh}x{rv} (h x v) is not "
                         "supported (1x1, 2x1 and 2x2 only)")
    if plane.shape[1] > 2:
        return _fancy_h2v1(plane) if rv == 1 else _fancy_h2v2(plane)
    return np.repeat(np.repeat(plane, rh, axis=1), rv, axis=0)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16,  # Cr -> R
            (fix(1.77200) * x + half) >> 16,  # Cb -> B
            -fix(0.71414) * x,  # Cr -> G
            -fix(0.34414) * x + half)  # Cb -> G


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """ycc_rgb_convert: (H, W) uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --- the file ---


def _u16(data, pos):
    return (data[pos] << 8) | data[pos + 1]


def _parse_dht(body, tables):
    p = 0
    while p < len(body):
        tc, th = body[p] >> 4, body[p] & 15
        if tc > 1 or th > 3:
            raise _corrupt(f"DHT class {tc} id {th}")
        counts = list(body[p + 1:p + 17])
        n = sum(counts)
        symbols = list(body[p + 17:p + 17 + n])
        if len(symbols) != n:
            raise _corrupt("short DHT segment")
        tables[(tc, th)] = (counts, symbols)
        p += 17 + n


def _parse_dqt(body, quant):
    p = 0
    while p < len(body):
        pq, tq = body[p] >> 4, body[p] & 15
        if tq > 3 or pq > 1:
            raise _corrupt(f"DQT precision {pq} id {tq}")
        n = 64 * (1 + pq)
        raw = np.frombuffer(body[p + 1:p + 1 + n], ">u2" if pq else np.uint8)
        if raw.size != 64:
            raise _corrupt("short DQT segment")
        table = np.empty(64, np.int64)
        table[NATURAL_ORDER] = raw
        quant[tq] = table
        p += 1 + n


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8, Pillow's
    Image.open(...).convert("RGB") of it."""
    data = bytes(data)
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    pos = 2
    frame = None
    huff, quant = {}, {}
    restart = 0
    jfif = adobe = False
    transform = None
    scans = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            raise _corrupt(f"expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1  # fill bytes
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # RSTn out of a scan, TEM: no segment
        if pos + 2 > len(data):
            raise _corrupt("truncated marker segment")
        length = _u16(data, pos)
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise _corrupt("truncated marker segment")
        pos += length
        if marker in _SOF_REFUSED or marker in (0xDE, 0xDF):
            kind = _SOF_REFUSED.get(marker, "hierarchical")
            raise ValueError(f"JPEG: {kind} frames (marker 0x{marker:02X}) "
                             "are not supported")
        if marker == 0xCC:
            raise ValueError("JPEG: arithmetic coding is not supported")
        if marker in _SOF_SUPPORTED:
            if frame is not None:
                raise _corrupt("a second frame header")
            precision = body[0]
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples are not "
                                 "supported (8-bit only)")
            height, width, nf = _u16(body, 1), _u16(body, 3), body[5]
            if nf not in (1, 3):
                raise ValueError(f"JPEG: {nf}-component images (CMYK/YCCK) "
                                 "are not supported" if nf == 4 else
                                 f"JPEG: {nf}-component images are not "
                                 "supported")
            if height == 0 or width == 0:
                raise ValueError("JPEG: zero height (DNL) or width is not "
                                 "supported")
            comps = []
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 2 and 1 <= v <= 2):
                    raise ValueError(f"JPEG: sampling factors {h}x{v} are "
                                     "not supported (1-2 only)")
                comps.append({"id": cid, "h": h, "v": v, "tq": tq})
            frame = _Frame(_SOF_SUPPORTED[marker], height, width, comps)
            for c in comps:
                _upsample_check(frame, c)
        elif marker == 0xC4:
            _parse_dht(body, huff)
        elif marker == 0xDB:
            _parse_dqt(body, quant)
        elif marker == 0xDD:
            restart = _u16(body, 0)
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, transform = True, body[11]
        elif 0xE0 <= marker <= 0xEF or marker == 0xFE:
            pass  # APPn (EXIF, ICC, ...) and COM
        elif marker == 0xDA:
            if frame is None:
                raise _corrupt("scan before the frame header")
            pos = _scan(data, pos, body, frame, huff, restart)
            scans += 1
        elif marker == 0xDC:
            pass  # DNL after a frame whose height was given
        else:
            raise _corrupt(f"unknown marker 0x{marker:02X}")
    if frame is None or not scans:
        raise _corrupt("no frame or no scan")
    _check_complete(frame)
    return _pixels(frame, quant, jfif, adobe, transform)


def _upsample_check(frame, c):
    rh, rv = frame.hmax // c["h"], frame.vmax // c["v"]
    if frame.hmax % c["h"] or frame.vmax % c["v"] or (rh, rv) not in (
            (1, 1), (2, 1), (2, 2)):
        raise ValueError(
            f"JPEG: component sampling {c['h']}x{c['v']} in a "
            f"{frame.hmax}x{frame.vmax} frame needs {rh}x{rv} (h x v) "
            "upsampling, which is not supported (1x1, 2x1 and 2x2 only; "
            "4:4:0 is 1x2)")


def _scan(data, pos, body, frame, huff, restart):
    """Reads one SOS header and its entropy-coded data; returns the offset
    of the marker that ends it."""
    ns = body[0]
    comps, dc_tabs, ac_tabs = [], [], []
    ids = {c["id"]: i for i, c in enumerate(frame.comps)}
    progressive = frame.kind == "progressive"
    for i in range(ns):
        cid, td_ta = body[1 + 2 * i:3 + 2 * i]
        if cid not in ids:
            raise _corrupt(f"scan names component {cid}")
        comps.append(ids[cid])
        dc_tabs.append(td_ta >> 4)
        ac_tabs.append(td_ta & 15)
    ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    if progressive:
        if ss == 0 and se != 0 or ss > se or se > 63 or (ss and ns != 1):
            raise _corrupt(f"progressive scan Ss {ss} Se {se} Ns {ns}")
        for ci in comps:
            bits = frame.coef_bits[ci]
            for k in range(ss, se + 1):
                if bits[k] != (-1 if ah == 0 else ah):
                    raise _corrupt("bogus progression")
                bits[k] = al
    else:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise _corrupt(f"sequential scan Ss {ss} Se {se} Ah {ah} Al {al}")
        for ci in comps:
            if frame.coef_bits[ci][0] == 0:
                raise _corrupt("a component in two sequential scans")
            frame.coef_bits[ci] = [0] * 64

    def table(tc, th):
        if (tc, th) not in huff:
            raise _corrupt(f"undefined Huffman table {tc}/{th}")
        counts, symbols = huff[(tc, th)]
        return _huffman(bytes(counts), bytes(symbols), tc == 0, progressive)

    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or ss > 0
    tables = ([table(0, t) for t in dc_tabs] if need_dc else None,
              [table(1, t) for t in ac_tabs] if need_ac else None)
    segs, rsts, end = _segments(data, pos)
    if any(r != i % 8 for i, r in enumerate(rsts)):
        raise _corrupt("restart markers out of sequence")
    _decode_scan(frame, comps, tables, ss, se, ah, al, segs, restart)
    return end


def _check_complete(frame):
    for c, bits in zip(frame.comps, frame.coef_bits):
        if any(b != 0 for b in bits):
            if frame.kind == "progressive":
                raise ValueError(
                    "JPEG: the progressive scans leave coefficient bits "
                    "unknown (libjpeg would smooth the blocks); not "
                    "supported")
            raise _corrupt(f"component {c['id']} has no scan")


def _pixels(frame, quant, jfif, adobe, transform) -> np.ndarray:
    planes = []
    coefs = np.frombuffer(frame.coefs, np.int32)
    for c in frame.comps:
        if c["tq"] not in quant:
            raise _corrupt(f"undefined quantization table {c['tq']}")
        n = c["pw"] * c["ph"]
        zz = coefs[c["offset"]:c["offset"] + 64 * n].reshape(n, 64)
        # JCOEF is 16-bit: the stored coefficient wraps as libjpeg's does
        natural = zz[:, _ZIGZAG_OF].astype(np.int16)
        blocks = idct_islow(natural, quant[c["tq"]])
        plane = blocks.reshape(c["ph"], c["pw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["ph"] * 8, c["pw"] * 8)
        plane = plane[:c["dh"], :c["dw"]].astype(np.int32)
        up = _upsample(plane, frame.hmax // c["h"], frame.vmax // c["v"])
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        gray = planes[0].astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=-1)
    if jfif:
        rgb = False
    elif adobe:
        rgb = transform == 0
    else:
        rgb = [c["id"] for c in frame.comps] == [82, 71, 66]
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)
