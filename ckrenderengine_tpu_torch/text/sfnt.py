"""The TrueType font file: the tables that hinting, rasterising and shaping
read, parsed with the standard library and numpy.

What FreeType opens and this module does not (CFF outlines, collections,
variable fonts, bitmap-only fonts) raises :func:`roadmap.unported` naming
it. Offsets and formats follow the OpenType specification; where a choice
is FreeType's own (the character map it picks, the face's ascender), the
docstring says so.
"""

from __future__ import annotations

import struct

import numpy as np

from ..roadmap import unported

# glyf simple-glyph flags
ON_CURVE = 0x01
X_SHORT = 0x02
Y_SHORT = 0x04
REPEAT = 0x08
X_SAME = 0x10
Y_SAME = 0x20
# glyf component flags
ARG_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
ROUND_XY_TO_GRID = 0x0004
HAVE_SCALE = 0x0008
MORE_COMPONENTS = 0x0020
HAVE_XY_SCALE = 0x0040
HAVE_2X2 = 0x0080
HAVE_INSTRUCTIONS = 0x0100
USE_MY_METRICS = 0x0200
SCALED_COMPONENT_OFFSET = 0x0800
UNSCALED_COMPONENT_OFFSET = 0x1000


class SimpleGlyph:
    """Points in font units, their on-curve flags, contour ends and the
    glyph program."""

    __slots__ = ("xs", "ys", "on", "ends", "program", "bbox")

    def __init__(self, xs, ys, on, ends, program, bbox):
        self.xs, self.ys, self.on, self.ends = xs, ys, on, ends
        self.program, self.bbox = program, bbox


class Component:
    """One part of a composite: its glyph, flags, the two arguments (an
    offset or two point numbers) and the 2x2 transform in 2.14."""

    __slots__ = ("gid", "flags", "arg1", "arg2", "xx", "xy", "yx", "yy")

    def __init__(self, gid, flags, arg1, arg2, xx, xy, yx, yy):
        self.gid, self.flags, self.arg1, self.arg2 = gid, flags, arg1, arg2
        self.xx, self.xy, self.yx, self.yy = xx, xy, yx, yy


class CompositeGlyph:
    __slots__ = ("components", "program", "bbox")

    def __init__(self, components, program, bbox):
        self.components, self.program, self.bbox = components, program, bbox


def _u16(b, o):
    return (b[o] << 8) | b[o + 1]


def _s16(b, o):
    v = (b[o] << 8) | b[o + 1]
    return v - 0x10000 if v & 0x8000 else v


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


class Font:
    """One TrueType face, read from ``data`` (the bytes of a .ttf)."""

    def __init__(self, data: bytes, name: str = "font"):
        self.data = data
        self.name = name
        tag = data[:4]
        if tag == b"ttcf":
            raise unported(f"font collection (.ttc) {name!r}", 14)
        if tag == b"OTTO":
            raise unported(f"CFF outlines (.otf) in {name!r}", 14)
        if tag not in (b"\x00\x01\x00\x00", b"true"):
            raise unported(f"font file {name!r} (not a TrueType sfnt)", 14)
        n = _u16(data, 4)
        self.tables = {}
        for i in range(n):
            o = 12 + 16 * i
            t = data[o:o + 4].decode("latin-1")
            self.tables[t] = (_u32(data, o + 8), _u32(data, o + 12))
        if "fvar" in self.tables or "gvar" in self.tables:
            raise unported(f"variable font {name!r}", 14)
        if "glyf" not in self.tables:
            if any(t in self.tables for t in ("EBDT", "CBDT", "sbix", "bdat")):
                raise unported(f"bitmap-only font {name!r}", 14)
            raise unported(f"font {name!r} without glyf outlines", 14)
        self._head()
        self._hhea()
        self._maxp()
        self._hmtx()
        self._os2()
        self._cmap()
        self._loca()
        self.cvt = self._cvt()
        self.fpgm = self.table("fpgm")
        self.prep = self.table("prep")
        self.gasp = self._gasp()
        self._glyph_cache = {}

    def table(self, tag: str) -> bytes:
        """The table's bytes (empty where the font has no such table)."""
        if tag not in self.tables:
            return b""
        off, ln = self.tables[tag]
        return self.data[off:off + ln]

    # -- fixed tables ------------------------------------------------------
    def _head(self):
        b = self.table("head")
        self.flags = _u16(b, 16)
        self.units_per_em = _u16(b, 18)
        self.loca_long = _s16(b, 50) == 1

    def _hhea(self):
        b = self.table("hhea")
        self.hhea_ascender = _s16(b, 4)
        self.hhea_descender = _s16(b, 6)
        self.hhea_line_gap = _s16(b, 8)
        self.num_hmetrics = _u16(b, 34)

    def _maxp(self):
        b = self.table("maxp")
        self.num_glyphs = _u16(b, 4)
        if _u32(b, 0) >= 0x10000 and len(b) >= 32:
            (self.max_twilight, self.max_storage, self.max_fdefs,
             self.max_stack, self.max_ins_size) = (
                _u16(b, o) for o in (16, 18, 20, 24, 26))
        else:
            self.max_twilight = self.max_storage = self.max_fdefs = 0
            self.max_stack = self.max_ins_size = 0

    def _hmtx(self):
        b = self.table("hmtx")
        n = self.num_hmetrics
        m = np.frombuffer(b, ">u2", count=2 * n).reshape(n, 2)
        adv = m[:, 0].astype(np.int64)
        lsb = m[:, 1].astype(np.int16).astype(np.int64)
        rest = self.num_glyphs - n
        if rest > 0:
            extra = np.frombuffer(b, ">i2", count=rest, offset=4 * n)
            adv = np.concatenate([adv, np.full(rest, adv[-1], np.int64)])
            lsb = np.concatenate([lsb, extra.astype(np.int64)])
        self.advances, self.lsbs = adv, lsb

    def _os2(self):
        b = self.table("OS/2")
        self.os2 = None
        if len(b) >= 78:
            self.os2 = {"typo_ascender": _s16(b, 68),
                        "typo_descender": _s16(b, 70),
                        "typo_line_gap": _s16(b, 72),
                        "win_ascent": _u16(b, 74),
                        "win_descent": _u16(b, 76)}
        # FreeType's face metrics (sfobjs.c): hhea, else OS/2 typo, else
        # OS/2 win.
        asc, desc, gap = (self.hhea_ascender, self.hhea_descender,
                          self.hhea_line_gap)
        if asc == 0 and desc == 0 and self.os2 is not None:
            o = self.os2
            if o["typo_ascender"] or o["typo_descender"]:
                asc, desc, gap = (o["typo_ascender"], o["typo_descender"],
                                  o["typo_line_gap"])
            else:
                asc, desc, gap = o["win_ascent"], -o["win_descent"], 0
        self.ascender, self.descender = asc, desc
        self.height = asc - desc + gap

    def _cmap(self):
        """The subtable FreeType selects as the face's charmap: a UCS-4 one
        (3,10 or 0,4 / 0,6) first, else the first Unicode one (3,1 or 0,*);
        formats 4 and 12."""
        b = self.table("cmap")
        n = _u16(b, 2)
        subs = []
        for i in range(n):
            o = 4 + 8 * i
            subs.append((_u16(b, o), _u16(b, o + 2), _u32(b, o + 4)))
        # A (0, 5) subtable (format 14) maps variation sequences.
        self.variation_sequences = any((pid, eid) == (0, 5)
                                       for pid, eid, _o in subs)
        pick = None
        for pid, eid, off in subs:
            if (pid, eid) in ((3, 10), (0, 4), (0, 6)):
                pick = off
                break
        if pick is None:
            for pid, eid, off in subs:
                if (pid, eid) == (3, 1) or pid == 0:
                    pick = off
                    break
        self.cmap = {}
        if pick is None:
            raise unported(f"font {self.name!r} without a Unicode cmap", 14)
        fmt = _u16(b, pick)
        if fmt == 4:
            seg2 = _u16(b, pick + 6)
            ends = np.frombuffer(b, ">u2", seg2 // 2, pick + 14)
            starts = np.frombuffer(b, ">u2", seg2 // 2, pick + 16 + seg2)
            deltas = np.frombuffer(b, ">u2", seg2 // 2, pick + 16 + 2 * seg2)
            ro = pick + 16 + 3 * seg2
            ranges = np.frombuffer(b, ">u2", seg2 // 2, ro)
            for s in range(seg2 // 2):
                e, st, d, r = (int(ends[s]), int(starts[s]), int(deltas[s]),
                               int(ranges[s]))
                for c in range(st, e + 1):
                    if c == 0xFFFF:
                        continue
                    if r == 0:
                        g = (c + d) & 0xFFFF
                    else:
                        a = ro + 2 * s + r + 2 * (c - st)
                        g = _u16(b, a)
                        if g:
                            g = (g + d) & 0xFFFF
                    if g:
                        self.cmap[c] = g
        elif fmt == 12:
            ng = _u32(b, pick + 12)
            for i in range(ng):
                o = pick + 16 + 12 * i
                s, e, g = _u32(b, o), _u32(b, o + 4), _u32(b, o + 8)
                for c in range(s, e + 1):
                    if g + c - s:
                        self.cmap[c] = g + c - s
        else:
            raise unported(f"cmap format {fmt} in {self.name!r}", 14)

    def _loca(self):
        b = self.table("loca")
        n = self.num_glyphs + 1
        if self.loca_long:
            self.loca = np.frombuffer(b, ">u4", n).astype(np.int64)
        else:
            self.loca = np.frombuffer(b, ">u2", n).astype(np.int64) * 2

    def _cvt(self):
        b = self.table("cvt ")
        return np.frombuffer(b, ">i2", len(b) // 2).astype(np.int64)

    def _gasp(self):
        b = self.table("gasp")
        if not b:
            return []
        n = _u16(b, 2)
        return [(_u16(b, 4 + 4 * i), _u16(b, 6 + 4 * i)) for i in range(n)]

    # -- glyphs ------------------------------------------------------------
    def glyph(self, gid: int):
        """The glyph's outline: a :class:`SimpleGlyph`, a
        :class:`CompositeGlyph`, or None for an empty glyph."""
        g = self._glyph_cache.get(gid, False)
        if g is False:
            g = self._parse_glyph(gid)
            self._glyph_cache[gid] = g
        return g

    def _parse_glyph(self, gid):
        if gid < 0 or gid >= self.num_glyphs:
            raise ValueError(f"glyph {gid} out of range")
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        if end <= start:
            return None
        base = self.tables["glyf"][0] + start
        b = self.data
        nc = _s16(b, base)
        bbox = tuple(_s16(b, base + o) for o in (2, 4, 6, 8))
        o = base + 10
        if nc >= 0:
            ends = np.frombuffer(b, ">u2", nc, o).astype(np.int64)
            o += 2 * nc
            nins = _u16(b, o)
            program = b[o + 2:o + 2 + nins]
            o += 2 + nins
            npts = int(ends[-1]) + 1 if nc else 0
            flags = bytearray(npts)
            i = 0
            while i < npts:
                f = b[o]
                o += 1
                flags[i] = f
                i += 1
                if f & REPEAT:
                    r = b[o]
                    o += 1
                    flags[i:i + r] = bytes([f]) * r
                    i += r
            xs = np.zeros(npts, np.int64)
            ys = np.zeros(npts, np.int64)
            v = 0
            for i in range(npts):
                f = flags[i]
                if f & X_SHORT:
                    d = b[o]
                    o += 1
                    v += d if f & X_SAME else -d
                elif not f & X_SAME:
                    v += _s16(b, o)
                    o += 2
                xs[i] = v
            v = 0
            for i in range(npts):
                f = flags[i]
                if f & Y_SHORT:
                    d = b[o]
                    o += 1
                    v += d if f & Y_SAME else -d
                elif not f & Y_SAME:
                    v += _s16(b, o)
                    o += 2
                ys[i] = v
            on = np.frombuffer(bytes(flags), np.uint8) & ON_CURVE
            return SimpleGlyph(xs, ys, on.astype(np.uint8), ends, program,
                               bbox)
        comps = []
        while True:
            flags, cg = _u16(b, o), _u16(b, o + 2)
            o += 4
            if flags & ARG_WORDS:
                if flags & ARGS_ARE_XY_VALUES:
                    a1, a2 = _s16(b, o), _s16(b, o + 2)
                else:
                    a1, a2 = _u16(b, o), _u16(b, o + 2)
                o += 4
            else:
                if flags & ARGS_ARE_XY_VALUES:
                    a1 = b[o] - 256 if b[o] > 127 else b[o]
                    a2 = b[o + 1] - 256 if b[o + 1] > 127 else b[o + 1]
                else:
                    a1, a2 = b[o], b[o + 1]
                o += 2
            xx, xy, yx, yy = 0x10000, 0, 0, 0x10000
            # F2Dot14 scales, kept as 16.16 as FreeType keeps them.
            if flags & HAVE_SCALE:
                xx = yy = _s16(b, o) * 4
                o += 2
            elif flags & HAVE_XY_SCALE:
                xx, yy = _s16(b, o) * 4, _s16(b, o + 2) * 4
                o += 4
            elif flags & HAVE_2X2:
                xx, yx, xy, yy = (_s16(b, o + k) * 4 for k in (0, 2, 4, 6))
                o += 8
            comps.append(Component(cg, flags, a1, a2, xx, xy, yx, yy))
            if not flags & MORE_COMPONENTS:
                break
        program = b""
        if comps[-1].flags & HAVE_INSTRUCTIONS:
            nins = _u16(b, o)
            program = b[o + 2:o + 2 + nins]
        return CompositeGlyph(comps, program, bbox)


def load(path: str) -> Font:
    """The font at ``path``."""
    with open(path, "rb") as f:
        return Font(f.read(), path)
