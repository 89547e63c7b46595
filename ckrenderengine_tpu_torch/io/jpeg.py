"""JPEG files, decoded as Pillow decodes them through libjpeg-turbo.

Baseline, extended and progressive Huffman JPEG of 8-bit samples with one
(grey, "L") or three components ("RGB"), every sampling factor a file may
carry (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), restart intervals, and the JFIF
and Adobe APP14 colour-transform flags. The numbers follow libjpeg-turbo's
defaults as Pillow calls it:

- the entropy-coded data is read through 16-bit lookahead tables (one
  table read per Huffman symbol);
- the integer slow IDCT (``jidctint.c``), in numpy integer arithmetic over
  all blocks at once, which makes it exact;
- fancy upsampling (``jdsample.c``: the h2v1, h1v2 and h2v2 triangle
  filters, with libjpeg's edge rows and columns; plain replication for
  other integer ratios and for chroma 2 samples wide or less);
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` and their rounding.

EXIF orientation is not applied, as ``Image.open`` does not apply it.
Files of 4 components (CMYK, YCCK), arithmetic coding, 12-bit samples,
hierarchical or lossless coding, multi-picture (MPO) files, and
progressive files whose scans leave the first AC coefficients unrefined
(where libjpeg smooths the blocks) raise item 14 of the port queue
(``imagefile.unsupported``).
"""

from __future__ import annotations

import struct
from array import array
from typing import Iterator

import numpy as np

from .imagefile import Frame, Refused, unsupported

# Zigzag index -> natural (row-major) index.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


class _Huffman:
    """A Huffman table as a 16-bit lookahead: entry ``(symbol << 8) |
    code length`` for every 16-bit window that starts with a code; 0 where
    none does."""

    def __init__(self, counts: bytes, symbols: bytes):
        look = np.zeros(1 << 16, np.int64)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if k >= len(symbols) or code >= 1 << length:
                    raise unsupported("JPEG with a malformed Huffman table")
                lo = code << (16 - length)
                look[lo:lo + (1 << (16 - length))] = (symbols[k] << 8) | length
                code += 1
                k += 1
            code <<= 1
        self.look = look.tolist()


# Zero bytes after an interval's data. One block reads at most 64 codes
# of 16 bits, each with up to 15 more bits, and 63 correction bits: under
# 2,100 bits. The decoder checks that a block starts inside the data, so
# no block reads past the padding.
_PAD = 512


def _window(seg: bytes) -> array:
    """32-bit big-endian windows at each byte of ``seg`` (zero padded by
    ``_PAD`` bytes): the bits from position p are ``W[p >> 3]`` shifted by
    ``p & 7``."""
    b = np.frombuffer(seg + b"\0" * _PAD, np.uint8).astype(np.uint32)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    return array("I", w.astype(np.uint32).tobytes())


class _Exhausted(Exception):
    """The decoder read past the end of a restart interval's data."""


def _corrupt(p: int, limit: int) -> Exception:
    """The error for a code the tables do not hold at bit ``p``: past the
    data's end, the data ran out; before it, the data is corrupt."""
    if p > limit - 16:
        return _Exhausted()
    return unsupported("corrupt JPEG data")


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


class _Decoder:
    """The entropy decoder of one file: coefficients per component."""

    def __init__(self, data: bytes):
        self.data = data
        self.qt: dict[int, np.ndarray] = {}
        self.dc: dict[int, _Huffman] = {}
        self.ac: dict[int, _Huffman] = {}
        self.restart = 0
        self.comps: list[_Component] = []
        self.progressive = False
        self.jfif = False
        self.adobe = None
        self.width = self.height = 0
        self.coef_bits = None
        self.scans = 0

    # -- markers ---------------------------------------------------------
    def parse(self) -> None:
        data = self.data
        pos = 2
        n = len(data)
        seen_sof = False
        while True:
            # The next marker, past fill bytes.
            while pos < n and data[pos] != 0xFF:
                pos += 1
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                if not seen_sof:
                    raise Refused("JPEG without a frame header")
                if self.scans == 1 and not self.progressive and all(
                        b[0] >= 0 for b in self.coef_bits):
                    # libjpeg reads such a file or suspends, by how far
                    # its bit buffer reads ahead near the end.
                    raise unsupported("JPEG whose data ends without an "
                                      "end-of-image marker")
                raise Refused("image file is truncated")
            m = data[pos]
            pos += 1
            if m == 0xD9:                               # EOI
                if not seen_sof:
                    raise Refused("JPEG without a frame header")
                return
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            if pos + 2 > n:
                raise Refused("image file is truncated")
            length = struct.unpack_from(">H", data, pos)[0]
            seg = data[pos + 2:pos + length]
            if len(seg) < length - 2:
                raise Refused("image file is truncated")
            pos += length
            if m in (0xC0, 0xC1, 0xC2):
                if seen_sof:
                    raise unsupported("JPEG with two frame headers")
                seen_sof = True
                self._sof(seg, m == 0xC2)
            elif 0xC3 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                raise unsupported(f"JPEG coding process SOF{m - 0xC0} "
                                  f"(lossless, hierarchical or arithmetic)")
            elif m == 0xCC:
                raise unsupported("arithmetic-coded JPEG")
            elif m == 0xC4:
                self._dht(seg)
            elif m == 0xDB:
                self._dqt(seg)
            elif m == 0xDD:
                self.restart = struct.unpack(">H", seg[:2])[0]
            elif m == 0xDA:
                if not seen_sof:
                    raise unsupported("JPEG scan before its frame header")
                pos = self._scan(seg, pos)
            elif m == 0xE0 and seg[:5] == b"JFIF\0" and length >= 16:
                self.jfif = True
            elif m == 0xEE and seg[:5] == b"Adobe" and length >= 14:
                self.adobe = seg[11]
            elif m == 0xE2 and seg[:4] == b"MPF\0":
                raise unsupported("multi-picture (MPO) JPEG")
            elif m == 0xDC:
                raise unsupported("JPEG with a DNL marker")

    def _sof(self, s: bytes, progressive: bool) -> None:
        bits, h, w, nc = struct.unpack_from(">BHHB", s)
        if bits != 8:
            raise unsupported(f"{bits}-bit JPEG")
        if nc not in (1, 3):
            raise unsupported(f"JPEG of {nc} components (CMYK or YCCK)")
        if not w or not h:
            raise unsupported("JPEG whose height is given by a DNL marker")
        self.width, self.height = w, h
        self.progressive = progressive
        for i in range(nc):
            cid, hv, tq = s[6 + 3 * i:9 + 3 * i]
            hh, vv = hv >> 4, hv & 15
            if not (1 <= hh <= 4 and 1 <= vv <= 4):
                raise unsupported("JPEG sampling factor out of range")
            self.comps.append(_Component(cid, hh, vv, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        for c in self.comps:
            c.bw = -(-(-(-w * c.h // self.hmax)) // 8)   # blocks with data
            c.bh = -(-(-(-h * c.v // self.vmax)) // 8)
            c.pw, c.ph = self.mcux * c.h, self.mcuy * c.v   # padded
            c.coef = [0] * (c.pw * c.ph * 64)
        self.coef_bits = [[-1] * 64 for _ in self.comps]

    def _dht(self, s: bytes) -> None:
        pos = 0
        while pos < len(s):
            tc_th = s[pos]
            counts = s[pos + 1:pos + 17]
            total = sum(counts)
            syms = s[pos + 17:pos + 17 + total]
            pos += 17 + total
            table = _Huffman(counts, syms)
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = table

    def _dqt(self, s: bytes) -> None:
        pos = 0
        while pos < len(s):
            pq, tq = s[pos] >> 4, s[pos] & 15
            if pq:
                q = np.frombuffer(s[pos + 1:pos + 129], ">u2").astype(np.int64)
                pos += 129
            else:
                q = np.frombuffer(s[pos + 1:pos + 65], np.uint8).astype(
                    np.int64)
                pos += 65
            self.qt[tq] = q

    # -- entropy-coded data -----------------------------------------------
    def _intervals(self, pos: int):
        """The scan's restart intervals (unstuffed bytes) from ``pos``, and
        the position of the marker that ends the scan (None at EOF)."""
        data = self.data
        out = []
        start = pos
        n = len(data)
        while True:
            i = data.find(b"\xff", pos)
            if i < 0 or i + 1 >= n:
                out.append(data[start:].replace(b"\xff\x00", b"\xff"))
                return out, None
            nxt = data[i + 1]
            if nxt == 0x00:
                pos = i + 2
                continue
            if nxt == 0xFF:
                pos = i + 1
                continue
            out.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            if 0xD0 <= nxt <= 0xD7:
                start = pos = i + 2
                continue
            return out, i

    def _scan(self, s: bytes, pos: int) -> int:
        self.scans += 1
        ns = s[0]
        comps = []
        for i in range(ns):
            cid, t = s[1 + 2 * i], s[2 + 2 * i]
            comp = next((c for c in self.comps if c.id == cid), None)
            if comp is None:
                raise unsupported("JPEG scan of an unknown component")
            comps.append((comp, t >> 4, t & 15))
        ss, se, ahl = s[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahl >> 4, ahl & 15
        for comp, _td, _ta in comps:
            if comp.qt is None:
                if comp.tq not in self.qt:
                    raise unsupported("JPEG component without its "
                                      "quantization table")
                comp.qt = self.qt[comp.tq]            # latched, as libjpeg
        if not self.progressive:
            if (ss, se, ah, al) != (0, 63, 0, 0):
                raise unsupported("sequential JPEG scan with a spectral "
                                  "selection")
        elif ss > se or se > 63 or (ss == 0 and se) or (ss and ns != 1):
            raise unsupported("progressive JPEG scan out of order")
        for comp, _td, _ta in comps:
            bits = self.coef_bits[self.comps.index(comp)]
            for k in range(ss, se + 1):
                if (bits[k] >= 0) if ah == 0 else (bits[k] != ah
                                                   or al != ah - 1):
                    raise unsupported("progressive JPEG scan that libjpeg "
                                      "warns about")
                bits[k] = al
        intervals, end = self._intervals(pos)
        # Units: interleaved scans by the frame's MCUs (one unit per
        # component of each MCU), single-component scans by the
        # component's own blocks.
        if ns == 1:
            comp = comps[0][0]
            units = [(comp, ((by, bx),)) for by in range(comp.bh)
                     for bx in range(comp.bw)]
            per = 1
        else:
            units = [(comp, tuple((my * comp.v + y, mx * comp.h + x)
                                  for y in range(comp.v)
                                  for x in range(comp.h)))
                     for my in range(self.mcuy) for mx in range(self.mcux)
                     for comp, _td, _ta in comps]
            per = ns
        n_mcu = len(units) // per
        step = self.restart or n_mcu
        done = 0
        for i, seg in enumerate(intervals):
            if done >= n_mcu:
                break
            count = min(step, n_mcu - done)
            last = i == len(intervals) - 1 and end is None
            try:
                self._decode(seg, units[done * per:(done + count) * per],
                             comps, ss, se, ah, al)
            except _Exhausted:                    # read past the data
                if last:
                    raise Refused("image file is truncated") from None
                raise unsupported("corrupt JPEG data (premature end of a "
                                  "data segment)") from None
            done += count
        if done < n_mcu:
            if end is None:
                raise Refused("image file is truncated")
            raise unsupported("corrupt JPEG data (missing restart "
                              "intervals)")
        if end is None:
            if self.progressive:
                raise Refused("image file is truncated")
            return len(self.data)
        return end

    def _decode(self, seg, units, comps, ss, se, ah, al) -> None:
        """Decode one restart interval into the components' coefficients.
        Raises _Exhausted where it reads past the interval's data."""
        W = _window(seg)
        limit = len(seg) * 8
        tables = {}
        for comp, td, ta in comps:
            dc = self.dc.get(td)
            ac = self.ac.get(ta)
            if (ss == 0 and ah == 0 and dc is None) or (se and ac is None):
                raise unsupported("JPEG scan without its Huffman table")
            tables[id(comp)] = (dc.look if dc else None,
                                ac.look if ac else None)
        pred = {id(c): 0 for c, _td, _ta in comps}
        p = 0
        eobrun = 0
        for comp, blocks in units:
            dct, act = tables[id(comp)]
            coef = comp.coef
            pw = comp.pw
            for by, bx in blocks:
                if p > limit:
                    raise _Exhausted
                base = (by * pw + bx) * 64
                if ss == 0:
                    if ah == 0:
                        e = dct[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise _corrupt(p, limit)
                        p += e & 0xFF
                        s = e >> 8
                        v = 0
                        if s:
                            v = (W[p >> 3] >> (32 - (p & 7) - s)) & (
                                (1 << s) - 1)
                            p += s
                            if v < 1 << (s - 1):
                                v += 1 - (1 << s)
                        pr = pred[id(comp)] + v
                        pred[id(comp)] = pr
                        coef[base] = pr << al if self.progressive else pr
                    else:
                        if (W[p >> 3] >> (31 - (p & 7))) & 1:
                            coef[base] |= 1 << al
                        p += 1
                    if self.progressive:
                        continue
                    k = 1
                    while k < 64:
                        e = act[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise _corrupt(p, limit)
                        p += e & 0xFF
                        rs = e >> 8
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            v = (W[p >> 3] >> (32 - (p & 7) - s)) & (
                                (1 << s) - 1)
                            p += s
                            if v < 1 << (s - 1):
                                v += 1 - (1 << s)
                            if k > 63:
                                raise _corrupt(p, limit)
                            coef[base + k] = v
                            k += 1
                        elif rs == 0xF0:
                            k += 16
                        else:
                            break
                elif ah == 0:
                    # AC first pass.
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        e = act[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise _corrupt(p, limit)
                        p += e & 0xFF
                        rs = e >> 8
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            v = (W[p >> 3] >> (32 - (p & 7) - s)) & (
                                (1 << s) - 1)
                            p += s
                            if v < 1 << (s - 1):
                                v += 1 - (1 << s)
                            if k > se:
                                raise _corrupt(p, limit)
                            coef[base + k] = v << al
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += (W[p >> 3] >> (32 - (p & 7) - r)) & (
                                    (1 << r) - 1)
                                p += r
                            eobrun -= 1
                            break
                else:
                    # AC refinement (jdphuff.c decode_mcu_AC_refine).
                    p1 = 1 << al
                    m1 = -1 << al
                    k = ss
                    if not eobrun:
                        while k <= se:
                            e = act[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if not e:
                                raise _corrupt(p, limit)
                            p += e & 0xFF
                            rs = e >> 8
                            r, s = rs >> 4, rs & 15
                            if s:
                                bit = (W[p >> 3] >> (31 - (p & 7))) & 1
                                p += 1
                                s = p1 if bit else m1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += (W[p >> 3] >> (
                                        32 - (p & 7) - r)) & ((1 << r) - 1)
                                    p += r
                                break
                            while k <= se:
                                i = base + k
                                c = coef[i]
                                if c:
                                    if (W[p >> 3] >> (31 - (p & 7))) & 1:
                                        if not c & p1:
                                            coef[i] = c + (p1 if c >= 0
                                                           else m1)
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                if k > se:
                                    raise _corrupt(p, limit)
                                coef[base + k] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            i = base + k
                            c = coef[i]
                            if c:
                                if (W[p >> 3] >> (31 - (p & 7))) & 1:
                                    if not c & p1:
                                        coef[i] = c + (p1 if c >= 0 else m1)
                                p += 1
                            k += 1
                        eobrun -= 1
        if p > limit:
            raise _Exhausted


# -- sample reconstruction ---------------------------------------------------

_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
      "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
      "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_pass(x0, x1, x2, x3, x4, x5, x6, x7, shift):
    """One pass of ``jpeg_idct_islow`` on eight int64 arrays; the eight
    outputs descaled by ``shift`` bits with rounding."""
    z1 = (x2 + x6) * _F["0_541196100"]
    tmp2 = z1 + x6 * -_F["1_847759065"]
    tmp3 = z1 + x2 * _F["0_765366865"]
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` of dequantized (N, 8, 8) natural-order
    int64 coefficients: (N, 8, 8) uint8 samples (the post-IDCT range limit
    clamps, as libjpeg-turbo's SIMD routines do)."""
    c = coef.astype(np.int64)
    cols = _idct_pass(*[c[:, k, :] for k in range(8)], shift=11)
    ws = np.stack(cols, axis=1)                        # (N, 8 rows, 8 cols)
    rows = _idct_pass(*[ws[:, :, k] for k in range(8)], shift=18)
    out = np.stack(rows, axis=2) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def _plane(comp) -> np.ndarray:
    """The component's samples (padded to whole MCUs)."""
    n = comp.ph * comp.pw
    coef = np.asarray(comp.coef, np.int64).reshape(n, 64)
    deq = np.zeros((n, 64), np.int64)
    deq[:, ZIGZAG] = coef * comp.qt[None, :]
    blocks = idct_islow(deq.reshape(n, 8, 8))
    return blocks.reshape(comp.ph, comp.pw, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(comp.ph * 8, comp.pw * 8)


def _upsample(x: np.ndarray, dw: int, dh: int, hr: int, vr: int,
              width: int, height: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (dh, dw) component by (hr, vr) to
    (height, width)."""
    x = x[:dh, :dw].astype(np.int32)
    if (hr, vr) == (1, 1):
        out = x
    elif (hr, vr) == (2, 1) and dw > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
    elif (hr, vr) == (1, 2):
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
    elif (hr, vr) == (2, 2) and dw > 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for rows, near in ((slice(0, None, 2), up), (slice(1, None, 2),
                                                     down)):
            col = 3 * x + near                      # the column sums
            lcol = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
            rcol = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
            sub = np.empty((dh, 2 * dw), np.int32)
            sub[:, 0::2] = (3 * col + lcol + 8) >> 4
            sub[:, 1::2] = (3 * col + rcol + 7) >> 4
            out[rows] = sub
    else:
        out = np.repeat(np.repeat(x, vr, axis=0), hr, axis=1)
    return out[:height, :width]


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16,
            (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x,
            -fix(0.34414) * x + one_half)


def read_jpeg(data: bytes) -> Iterator[Frame]:
    """The one frame of a JPEG file: "L" or "RGB"."""
    dec = _Decoder(data)
    dec.parse()
    for ci, bits in enumerate(dec.coef_bits):
        if bits[0] < 0:
            raise unsupported("JPEG whose DC coefficients are never coded")
        if dec.progressive and any(b != 0 for b in bits[1:10]):
            raise unsupported("progressive JPEG with unrefined AC "
                              "coefficients (libjpeg smooths its blocks)")
    w, h = dec.width, dec.height
    planes = []
    for c in dec.comps:
        if dec.hmax % c.h or dec.vmax % c.v:
            raise unsupported("JPEG with a fractional sampling ratio")
        dw = -(-w * c.h // dec.hmax)
        dh = -(-h * c.v // dec.vmax)
        planes.append(_upsample(_plane(c), dw, dh, dec.hmax // c.h,
                                dec.vmax // c.v, w, h))
    if len(planes) == 1:
        yield Frame(planes[0].astype(np.uint8), "L", {})
        return
    ids = tuple(c.id for c in dec.comps)
    if dec.jfif:
        rgb = False
    elif dec.adobe is not None:
        rgb = dec.adobe == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        px = np.stack(planes, axis=2)
    else:
        cr_r, cb_b, cr_g, cb_g = _ycc_tables()
        y, cb, cr = planes
        r = y + cr_r[cr]
        g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
        b = y + cb_b[cb]
        px = np.stack([r, g, b], axis=2)
    yield Frame(np.clip(px, 0, 255).astype(np.uint8), "RGB", {})
