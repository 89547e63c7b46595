"""Text shaping: what Raqm asks HarfBuzz for when Pillow lays out a
left-to-right line with the default features.

The line is split into script runs as Raqm splits it (Common and Inherited
characters take the script around them); each run is mapped through the
cmap with HarfBuzz's normaliser (a character without a glyph decomposes
canonically, marks reorder by combining class and recompose where the font
has the composed glyph), then through the GSUB lookups of the features the
default shaper enables (``ccmp``, ``locl``, ``rlig``, ``calt``, ``clig``,
``liga``, ``rclt`` and the script's required feature) and the GPOS lookups
of ``kern``, ``mark``, ``mkmk``, ``curs``, ``dist``, ``abvm`` and ``blwm``,
in lookup order. Advances are hb-ft's: the unhinted advance scaled to 26.6;
GPOS values scale by HarfBuzz's ``em_scale`` at the font's 26.6 scale.

Text that needs what this module does not do raises
:func:`roadmap.unported` naming the character: right-to-left text,
scripts other than Latin, Greek and Cyrillic (and their Common and
Inherited characters), format characters, and characters the font has
neither a glyph nor a canonical decomposition for.
"""

from __future__ import annotations

import struct
import unicodedata

import numpy as np

from ..roadmap import unported
from . import sfnt

GSUB_FEATURES = ("rvrn", "ltra", "ltrm", "ccmp", "locl", "rlig", "calt",
                 "clig", "liga", "rclt")
GPOS_FEATURES = ("abvm", "blwm", "mark", "mkmk", "curs", "dist", "kern")

# GDEF glyph classes
BASE, LIGATURE, MARK, COMPONENT = 1, 2, 3, 4

LATIN, GREEK, CYRILLIC, COMMON, INHERITED, UNKNOWN = "Latn", "Grek", \
    "Cyrl", "Zyyy", "Zinh", "Zzzz"
OT_SCRIPT = {LATIN: "latn", GREEK: "grek", CYRILLIC: "cyrl"}

# Unicode Script property over the blocks this module lays out: ranges of
# Latin, Greek, Cyrillic and Inherited; Common is what is left of them.
_SCRIPT_RANGES = (
    (0x0041, 0x005A, LATIN), (0x0061, 0x007A, LATIN), (0x00AA, 0x00AA, LATIN),
    (0x00BA, 0x00BA, LATIN), (0x00C0, 0x00D6, LATIN), (0x00D8, 0x00F6, LATIN),
    (0x00F8, 0x02B8, LATIN), (0x02E0, 0x02E4, LATIN), (0x0300, 0x036F,
                                                       INHERITED),
    (0x0370, 0x0373, GREEK), (0x0375, 0x0377, GREEK), (0x037A, 0x037D, GREEK),
    (0x037F, 0x037F, GREEK), (0x0384, 0x0384, GREEK), (0x0386, 0x0386, GREEK),
    (0x0388, 0x03E1, GREEK), (0x03F0, 0x03FF, GREEK), (0x0400, 0x0484,
                                                       CYRILLIC),
    (0x0485, 0x0486, INHERITED), (0x0487, 0x052F, CYRILLIC),
    (0x1C80, 0x1C88, CYRILLIC), (0x1D00, 0x1D25, LATIN), (0x1D26, 0x1D2A,
                                                          GREEK),
    (0x1D2B, 0x1D2B, CYRILLIC), (0x1D2C, 0x1D5C, LATIN), (0x1D5D, 0x1D61,
                                                          GREEK),
    (0x1D62, 0x1D65, LATIN), (0x1D66, 0x1D6A, GREEK), (0x1D6B, 0x1D77, LATIN),
    (0x1D78, 0x1D78, CYRILLIC), (0x1D79, 0x1DBE, LATIN), (0x1DBF, 0x1DBF,
                                                          GREEK),
    (0x1DC0, 0x1DFF, INHERITED), (0x1E00, 0x1EFF, LATIN), (0x1F00, 0x1FFE,
                                                           GREEK),
    (0x200C, 0x200D, INHERITED), (0x2071, 0x2071, LATIN), (0x207F, 0x207F,
                                                           LATIN),
    (0x2090, 0x209C, LATIN), (0x20D0, 0x20F0, INHERITED), (0x2126, 0x2126,
                                                           GREEK),
    (0x212A, 0x212B, LATIN), (0x2132, 0x2132, LATIN), (0x214E, 0x214E, LATIN),
    (0x2160, 0x2188, LATIN), (0x2C60, 0x2C7F, LATIN), (0x2DE0, 0x2DFF,
                                                       CYRILLIC),
    (0xA640, 0xA69F, CYRILLIC), (0xA722, 0xA787, LATIN), (0xA78B, 0xA7FF,
                                                          LATIN),
    (0xAB30, 0xAB5A, LATIN), (0xAB5C, 0xAB64, LATIN), (0xAB65, 0xAB65, GREEK),
    (0xFB00, 0xFB06, LATIN), (0xFE00, 0xFE0F, INHERITED), (0xFE20, 0xFE2D,
                                                           INHERITED),
    (0xFE2E, 0xFE2F, CYRILLIC), (0xFF21, 0xFF3A, LATIN), (0xFF41, 0xFF5A,
                                                          LATIN))
# Blocks whose characters are Common unless listed above.
_COMMON_BLOCKS = ((0x0000, 0x036F), (0x0370, 0x03FF), (0x0400, 0x052F),
                  (0x1C80, 0x1C8F), (0x1D00, 0x1DFF), (0x1E00, 0x2BFF),
                  (0x2C60, 0x2C7F), (0x2DE0, 0x2DFF), (0x2E00, 0x2E7F),
                  (0xA640, 0xA69F), (0xA700, 0xA7FF), (0xAB30, 0xAB6F),
                  (0xFB00, 0xFB06), (0xFE00, 0xFE0F), (0xFE20, 0xFE2F),
                  (0xFE30, 0xFE4F), (0xFEFF, 0xFEFF), (0xFF00, 0xFFEF))
# Raqm's paired brackets (open, close).
_PAIRS = "()<>[]{}«»‹›⁅⁆⁽⁾₍₎⌈⌉⌊⌋〈〉❨❩❪❫❬❭❮❯❰❱❲❳❴❵⟅⟆⟦⟧⟨⟩⟪⟫"


def script_of(ch: str) -> str:
    c = ord(ch)
    if unicodedata.category(ch) in ("Cn", "Co"):
        return UNKNOWN
    for lo, hi, s in _SCRIPT_RANGES:
        if lo <= c <= hi:
            return s
    for lo, hi in _COMMON_BLOCKS:
        if lo <= c <= hi:
            # Greek and Coptic's Coptic letters, and the like.
            if 0x03E2 <= c <= 0x03EF:
                break
            return COMMON
    raise unported(f"text layout of {ch!r} (U+{c:04X}): its script needs "
                   "a shaper or a script run this port does not lay out",
                   14)


# Default-ignorable characters HarfBuzz lays out as an invisible glyph of
# no advance (hb_ot_hide_default_ignorables), skipped in lookup matching.
IGNORABLE = frozenset([0x00AD, 0x034F, 0x200B, 0x2060, 0x2061, 0x2062,
                       0x2063, 0x2064, 0xFEFF])


def check_char(ch: str):
    """Raise for a character this module does not lay out."""
    c = ord(ch)
    if c in IGNORABLE:
        return
    bidi = unicodedata.bidirectional(ch)
    if bidi in ("R", "AL", "AN", "RLE", "RLO", "RLI", "LRE", "LRO", "LRI",
                "FSI", "PDF", "PDI"):
        raise unported(f"right-to-left or bidi text {ch!r} (U+{c:04X})", 14)
    if unicodedata.category(ch) in ("Cf", "Cs"):
        raise unported(f"text layout of the format character U+{c:04X}",
                       14)
    script_of(ch)


def resolve_scripts(text: str) -> list[str]:
    """Raqm's script of each character (``_raqm_resolve_scripts``)."""
    scripts = [script_of(ch) for ch in text]
    last_value = None
    last_index = -1
    last_set = -1
    stack = []
    for i, ch in enumerate(text):
        s = scripts[i]
        if s == COMMON and last_index != -1:
            k = _PAIRS.find(ch)
            if k >= 0:
                if k % 2 == 0:
                    scripts[i] = last_value
                    last_set = i
                    stack.append((last_value, k))
                else:
                    while stack and stack[-1][1] != k - 1:
                        stack.pop()
                    if stack:
                        scripts[i] = stack[-1][0]
                        last_value = scripts[i]
                    else:
                        scripts[i] = last_value
                    last_set = i
            else:
                scripts[i] = last_value
                last_set = i
        elif s == INHERITED and last_index != -1:
            scripts[i] = last_value
            last_set = i
        else:
            for j in range(last_set + 1, i):
                scripts[j] = s
            last_value = s
            last_index = i
            last_set = i
    for i in range(len(text) - 2, -1, -1):
        if scripts[i] in (INHERITED, COMMON):
            scripts[i] = scripts[i + 1]
    return scripts


# -- OpenType layout tables --------------------------------------------------

def _u16(b, o):
    return (b[o] << 8) | b[o + 1]


def _s16(b, o):
    v = (b[o] << 8) | b[o + 1]
    return v - 0x10000 if v & 0x8000 else v


def _coverage(b, o) -> dict:
    fmt = _u16(b, o)
    out = {}
    if fmt == 1:
        n = _u16(b, o + 2)
        for i in range(n):
            out[_u16(b, o + 4 + 2 * i)] = i
    elif fmt == 2:
        n = _u16(b, o + 2)
        for r in range(n):
            p = o + 4 + 6 * r
            s, e, idx = _u16(b, p), _u16(b, p + 2), _u16(b, p + 4)
            for g in range(s, e + 1):
                out[g] = idx + g - s
    return out


def _classdef(b, o) -> dict:
    out = {}
    if not o:
        return out
    fmt = _u16(b, o)
    if fmt == 1:
        start, n = _u16(b, o + 2), _u16(b, o + 4)
        for i in range(n):
            out[start + i] = _u16(b, o + 6 + 2 * i)
    elif fmt == 2:
        n = _u16(b, o + 2)
        for r in range(n):
            p = o + 4 + 6 * r
            s, e, c = _u16(b, p), _u16(b, p + 2), _u16(b, p + 4)
            for g in range(s, e + 1):
                out[g] = c
    return out


class Lookup:
    __slots__ = ("type", "flag", "mark_set", "subtables")

    def __init__(self, type_, flag, mark_set, subtables):
        self.type, self.flag, self.mark_set = type_, flag, mark_set
        self.subtables = subtables


class LayoutTable:
    """GSUB or GPOS: scripts, features and lookups (subtables parsed on
    first use)."""

    def __init__(self, data: bytes, gpos: bool):
        self.b = b = data
        self.gpos = gpos
        self.scripts = {}
        self.features = []
        self.lookups = []
        if not b:
            return
        sl, fl, ll = _u16(b, 4), _u16(b, 6), _u16(b, 8)
        for i in range(_u16(b, sl)):
            p = sl + 2 + 6 * i
            tag = b[p:p + 4].decode("latin-1")
            so = sl + _u16(b, p + 4)
            langs = {}
            d = _u16(b, so)
            if d:
                langs[None] = self._langsys(so + d)
            for k in range(_u16(b, so + 2)):
                q = so + 4 + 6 * k
                langs[b[q:q + 4].decode("latin-1")] = self._langsys(
                    so + _u16(b, q + 4))
            self.scripts[tag] = langs
        for i in range(_u16(b, fl)):
            p = fl + 2 + 6 * i
            tag = b[p:p + 4].decode("latin-1")
            fo = fl + _u16(b, p + 4)
            n = _u16(b, fo + 2)
            self.features.append(
                (tag, [_u16(b, fo + 4 + 2 * k) for k in range(n)]))
        for i in range(_u16(b, ll)):
            lo = ll + _u16(b, ll + 2 + 2 * i)
            t, flag, n = _u16(b, lo), _u16(b, lo + 2), _u16(b, lo + 4)
            offs = [lo + _u16(b, lo + 6 + 2 * k) for k in range(n)]
            mark_set = _u16(b, lo + 6 + 2 * n) if flag & 0x10 else None
            ext = 9 if gpos else 7
            if t == ext:
                real = []
                for o in offs:
                    t = _u16(b, o + 2)
                    real.append(o + struct.unpack_from(">I", b, o + 4)[0])
                offs = real
            self.lookups.append(Lookup(t, flag, mark_set, offs))
        self._parsed = {}

    def _langsys(self, o):
        b = self.b
        req = _u16(b, o + 2)
        n = _u16(b, o + 4)
        return (None if req == 0xFFFF else req,
                [_u16(b, o + 6 + 2 * k) for k in range(n)])

    def select(self, script: str | None):
        """The LangSys HarfBuzz picks for ``script`` (then DFLT, dflt,
        latn) with the default language."""
        tags = ([OT_SCRIPT[script]] if script in OT_SCRIPT else []) + [
            "DFLT", "dflt", "latn"]
        for t in tags:
            if t in self.scripts:
                return self.scripts[t].get(None)
        return None

    def lookups_for(self, script, wanted) -> list[int]:
        ls = self.select(script)
        if ls is None:
            return []
        req, feats = ls
        out = set()
        if req is not None:
            out.update(self.features[req][1])
        for fi in feats:
            tag, lks = self.features[fi]
            if tag in wanted:
                out.update(lks)
        return sorted(out)

    def subtables(self, li: int) -> list:
        got = self._parsed.get(li)
        if got is None:
            lk = self.lookups[li]
            parse = _GPOS_PARSERS if self.gpos else _GSUB_PARSERS
            p = parse.get(lk.type)
            if p is None:
                kind = "GPOS" if self.gpos else "GSUB"
                raise unported(f"{kind} lookup type {lk.type}", 14)
            got = [p(self.b, o) for o in lk.subtables]
            self._parsed[li] = got
        return got


# GSUB subtable parsers: each returns a tuple whose first item names it.

def _gsub_single(b, o):
    fmt = _u16(b, o)
    cov = _coverage(b, o + _u16(b, o + 2))
    if fmt == 1:
        d = _s16(b, o + 4)
        return ("single", {g: (g + d) & 0xFFFF for g in cov})
    n = _u16(b, o + 4)
    subs = [_u16(b, o + 6 + 2 * i) for i in range(n)]
    return ("single", {g: subs[i] for g, i in cov.items() if i < n})


def _gsub_multiple(b, o):
    cov = _coverage(b, o + _u16(b, o + 2))
    n = _u16(b, o + 4)
    seqs = []
    for i in range(n):
        so = o + _u16(b, o + 6 + 2 * i)
        m = _u16(b, so)
        seqs.append([_u16(b, so + 2 + 2 * k) for k in range(m)])
    return ("multiple", {g: seqs[i] for g, i in cov.items() if i < n})


def _gsub_alternate(b, o):
    cov = _coverage(b, o + _u16(b, o + 2))
    n = _u16(b, o + 4)
    alts = []
    for i in range(n):
        so = o + _u16(b, o + 6 + 2 * i)
        m = _u16(b, so)
        alts.append([_u16(b, so + 2 + 2 * k) for k in range(m)])
    return ("alternate", {g: alts[i] for g, i in cov.items() if i < n})


def _gsub_ligature(b, o):
    cov = _coverage(b, o + _u16(b, o + 2))
    n = _u16(b, o + 4)
    sets = []
    for i in range(n):
        so = o + _u16(b, o + 6 + 2 * i)
        ligs = []
        for k in range(_u16(b, so)):
            lo = so + _u16(b, so + 2 + 2 * k)
            glyph, cc = _u16(b, lo), _u16(b, lo + 2)
            ligs.append((glyph, [_u16(b, lo + 4 + 2 * j)
                                 for j in range(cc - 1)]))
        sets.append(ligs)
    return ("ligature", {g: sets[i] for g, i in cov.items() if i < n})


def _records(b, o, n):
    return [(_u16(b, o + 4 * k), _u16(b, o + 4 * k + 2)) for k in range(n)]


def _context(b, o):
    """Context subtables (formats 1-3) as rules: ("context", fmt, data)."""
    fmt = _u16(b, o)
    if fmt == 1:
        cov = _coverage(b, o + _u16(b, o + 2))
        n = _u16(b, o + 4)
        sets = []
        for i in range(n):
            so = o + _u16(b, o + 6 + 2 * i)
            rules = []
            if so != o:
                for k in range(_u16(b, so)):
                    ro = so + _u16(b, so + 2 + 2 * k)
                    gc, sc = _u16(b, ro), _u16(b, ro + 2)
                    inp = [_u16(b, ro + 4 + 2 * j) for j in range(gc - 1)]
                    rules.append(((), inp, (), _records(
                        b, ro + 4 + 2 * (gc - 1), sc)))
            sets.append(rules)
        return ("context", 1, cov, sets, None)
    if fmt == 2:
        cov = _coverage(b, o + _u16(b, o + 2))
        cd = _classdef(b, o + _u16(b, o + 4))
        n = _u16(b, o + 6)
        sets = []
        for i in range(n):
            off = _u16(b, o + 8 + 2 * i)
            rules = []
            if off:
                so = o + off
                for k in range(_u16(b, so)):
                    ro = so + _u16(b, so + 2 + 2 * k)
                    gc, sc = _u16(b, ro), _u16(b, ro + 2)
                    inp = [_u16(b, ro + 4 + 2 * j) for j in range(gc - 1)]
                    rules.append(((), inp, (), _records(
                        b, ro + 4 + 2 * (gc - 1), sc)))
            sets.append(rules)
        return ("context", 2, cov, sets, (None, cd, None))
    gc, sc = _u16(b, o + 2), _u16(b, o + 4)
    covs = [_coverage(b, o + _u16(b, o + 6 + 2 * j)) for j in range(gc)]
    recs = _records(b, o + 6 + 2 * gc, sc)
    return ("context", 3, covs[0], [((), covs[1:], (), recs)], None)


def _chain(b, o):
    fmt = _u16(b, o)

    def rule(ro):
        n = _u16(b, ro)
        back = [_u16(b, ro + 2 + 2 * j) for j in range(n)]
        ro += 2 + 2 * n
        n = _u16(b, ro)
        inp = [_u16(b, ro + 2 + 2 * j) for j in range(n - 1)]
        ro += 2 + 2 * (n - 1)
        n = _u16(b, ro)
        ahead = [_u16(b, ro + 2 + 2 * j) for j in range(n)]
        ro += 2 + 2 * n
        return (back, inp, ahead, _records(b, ro + 2, _u16(b, ro)))

    if fmt in (1, 2):
        cov = _coverage(b, o + _u16(b, o + 2))
        if fmt == 1:
            n, base, cds = _u16(b, o + 4), o + 6, None
        else:
            cds = tuple(_classdef(b, o + _u16(b, o + k)) for k in (4, 6, 8))
            n, base = _u16(b, o + 10), o + 12
        sets = []
        for i in range(n):
            off = _u16(b, base + 2 * i)
            rules = []
            if off:
                so = o + off
                for k in range(_u16(b, so)):
                    rules.append(rule(so + _u16(b, so + 2 + 2 * k)))
            sets.append(rules)
        return ("context", fmt, cov, sets, cds)
    p = o + 2
    n = _u16(b, p)
    back = [_coverage(b, o + _u16(b, p + 2 + 2 * j)) for j in range(n)]
    p += 2 + 2 * n
    n = _u16(b, p)
    inp = [_coverage(b, o + _u16(b, p + 2 + 2 * j)) for j in range(n)]
    p += 2 + 2 * n
    n = _u16(b, p)
    ahead = [_coverage(b, o + _u16(b, p + 2 + 2 * j)) for j in range(n)]
    p += 2 + 2 * n
    recs = _records(b, p + 2, _u16(b, p))
    return ("context", 3, inp[0], [(back, inp[1:], ahead, recs)], None)


_GSUB_PARSERS = {1: _gsub_single, 2: _gsub_multiple, 3: _gsub_alternate,
                 4: _gsub_ligature, 5: _context, 6: _chain}


def _value(b, o, fmt, base):
    """A ValueRecord at ``o``: ({field: value}, size in bytes)."""
    out = {}
    p = o
    for bit, name in ((1, "xpla"), (2, "ypla"), (4, "xadv"), (8, "yadv")):
        if fmt & bit:
            out[name] = _s16(b, p)
            p += 2
    for bit, name in ((0x10, "xpla_dev"), (0x20, "ypla_dev"),
                      (0x40, "xadv_dev"), (0x80, "yadv_dev")):
        if fmt & bit:
            off = _u16(b, p)
            if off:
                out[name] = _device(b, base + off)
            p += 2
    return out, p - o


def _value_size(fmt):
    return 2 * bin(fmt & 0xFF).count("1")


def _device(b, o):
    start, end, fmt = _u16(b, o), _u16(b, o + 2), _u16(b, o + 4)
    if fmt not in (1, 2, 3):
        return None
    return (start, end, fmt, b[o + 6:o + 6 + 2 * ((end - start + 1) * (
        1 << fmt) // 16 + 1)])


def _device_pixels(dev, ppem):
    """HarfBuzz's Device::get_delta_pixels."""
    start, end, f, data = dev
    if ppem < start or ppem > end:
        return 0
    s = ppem - start
    k = s >> (4 - f)
    if 2 * k + 1 >= len(data):
        return 0
    word = _u16(data, 2 * k)
    bits = word >> (16 - (((s & ((1 << (4 - f)) - 1)) + 1) << f))
    mask = 0xFFFF >> (16 - (1 << f))
    d = bits & mask
    if d >= (mask + 1) >> 1:
        d -= mask + 1
    return d


def _gpos_single(b, o):
    fmt = _u16(b, o)
    cov = _coverage(b, o + _u16(b, o + 2))
    vf = _u16(b, o + 4)
    if fmt == 1:
        v, _ = _value(b, o + 6, vf, o)
        return ("single", {g: v for g in cov})
    n = _u16(b, o + 6)
    sz = _value_size(vf)
    vals = [_value(b, o + 8 + sz * i, vf, o)[0] for i in range(n)]
    return ("single", {g: vals[i] for g, i in cov.items() if i < n})


def _gpos_pair(b, o):
    fmt = _u16(b, o)
    cov = _coverage(b, o + _u16(b, o + 2))
    vf1, vf2 = _u16(b, o + 4), _u16(b, o + 6)
    s1, s2 = _value_size(vf1), _value_size(vf2)
    if fmt == 1:
        n = _u16(b, o + 8)
        sets = []
        for i in range(n):
            so = o + _u16(b, o + 10 + 2 * i)
            pairs = {}
            for k in range(_u16(b, so)):
                p = so + 2 + k * (2 + s1 + s2)
                v1, _ = _value(b, p + 2, vf1, so)
                v2, _ = _value(b, p + 2 + s1, vf2, so)
                pairs.setdefault(_u16(b, p), (v1, v2))
            sets.append(pairs)
        return ("pair", 1, cov, vf2, {g: sets[i] for g, i in cov.items()
                                      if i < n})
    cd1 = _classdef(b, o + _u16(b, o + 8))
    cd2 = _classdef(b, o + _u16(b, o + 10))
    c1, c2 = _u16(b, o + 12), _u16(b, o + 14)
    table = {}
    p = o + 16
    for i in range(c1):
        for k in range(c2):
            v1, _ = _value(b, p, vf1, o)
            v2, _ = _value(b, p + s1, vf2, o)
            if v1 or v2:
                table[(i, k)] = (v1, v2)
            p += s1 + s2
    return ("pair", 2, cov, vf2, (cd1, cd2, table))


def _anchor(b, o):
    fmt = _u16(b, o)
    x, y = _s16(b, o + 2), _s16(b, o + 4)
    if fmt == 2:
        return (x, y, _u16(b, o + 6))
    return (x, y, None)


def _mark_array(b, o):
    n = _u16(b, o)
    return [(_u16(b, o + 2 + 4 * i), _anchor(b, o + _u16(b, o + 4 + 4 * i)))
            for i in range(n)]


def _anchor_matrix(b, o, classes):
    n = _u16(b, o)
    rows = []
    for i in range(n):
        row = []
        for c in range(classes):
            off = _u16(b, o + 2 + 2 * (i * classes + c))
            row.append(_anchor(b, o + off) if off else None)
        rows.append(row)
    return rows


def _gpos_mark(b, o, kind):
    mcov = _coverage(b, o + _u16(b, o + 2))
    bcov = _coverage(b, o + _u16(b, o + 4))
    classes = _u16(b, o + 6)
    marks = _mark_array(b, o + _u16(b, o + 8))
    ao = o + _u16(b, o + 10)
    if kind == "lig":
        n = _u16(b, ao)
        ligs = []
        for i in range(n):
            lo = ao + _u16(b, ao + 2 + 2 * i)
            ligs.append(_anchor_matrix(b, lo, classes))
        bases = ligs
    else:
        bases = _anchor_matrix(b, ao, classes)
    return ("mark_" + kind, mcov, bcov, marks, bases)


_GPOS_PARSERS = {1: _gpos_single, 2: _gpos_pair,
                 4: lambda b, o: _gpos_mark(b, o, "base"),
                 5: lambda b, o: _gpos_mark(b, o, "lig"),
                 6: lambda b, o: _gpos_mark(b, o, "mark"),
                 7: _context, 8: _chain}


class GDEF:
    def __init__(self, data: bytes):
        self.classes = {}
        self.attach = {}
        self.mark_sets = []
        if not data:
            return
        b = data
        self.classes = _classdef(b, _u16(b, 4))
        self.attach = _classdef(b, _u16(b, 10))
        if _u16(b, 2) >= 2 and len(b) >= 14 and _u16(b, 12):
            so = _u16(b, 12)
            n = _u16(b, so + 2)
            self.mark_sets = [set(_coverage(b, so + struct.unpack_from(
                ">I", b, so + 4 + 4 * i)[0])) for i in range(n)]


# -- the buffer --------------------------------------------------------------

class Glyph:
    __slots__ = ("gid", "cluster", "cls", "lig_id", "lig_comp", "lig_comps",
                 "multiplied", "xa", "ya", "xo", "yo", "chain", "char",
                 "ignorable")

    def __init__(self, gid, cluster, char):
        self.gid, self.cluster, self.char = gid, cluster, char
        self.ignorable = ord(char) in IGNORABLE
        self.cls = BASE
        self.lig_id = self.lig_comp = 0
        self.lig_comps = 1
        self.multiplied = False
        self.xa = self.ya = self.xo = self.yo = 0
        self.chain = 0


class Shaper:
    """Shaping for one face at one size (26.6 scale ``x_scale`` per em,
    as hb-ft sets it)."""

    def __init__(self, font: sfnt.Font, ppem: int, x_scale_16: int):
        self.font = font
        self.ppem = ppem
        upem = font.units_per_em
        # hb-ft: the font's scale is the size's 16.16 scale times the em.
        self.scale = (x_scale_16 * upem + (1 << 15)) >> 16
        self.x_scale_16 = x_scale_16
        self.mult = (self.scale << 16) // upem
        self.gsub = _tables(font, "GSUB")
        self.gpos = _tables(font, "GPOS")
        self.gdef = _tables(font, "GDEF")
        self._plans = {}
        self._unhinted = None

    def em(self, v: int) -> int:
        """HarfBuzz's em_scale_x: font units to 26.6."""
        return (v * self.mult + 32768) >> 16

    def advance(self, gid: int) -> int:
        """hb-ft's horizontal advance: FT_Get_Advance unhinted (16.16
        pixels) rounded to 26.6."""
        v = _mul_div(int(self.font.advances[gid]), self.x_scale_16, 64)
        return (v + (1 << 9)) >> 10

    def _class(self, gid, ch, old=BASE):
        """The glyph's GDEF class; without GDEF classes, a guess from the
        character (a substituted glyph keeps its class)."""
        cls = self.gdef.classes
        if cls:
            return cls.get(gid, 0)
        if ch is None:
            return old
        return MARK if unicodedata.category(ch) == "Mn" else BASE

    def _has_fractions(self, script) -> bool:
        ls = self.gsub.select(script)
        tags = {self.gsub.features[i][0] for i in (ls[1] if ls else [])}
        return "frac" in tags or {"numr", "dnom"} <= tags

    def plan(self, script):
        p = self._plans.get(script)
        if p is None:
            p = (self.gsub.lookups_for(script, GSUB_FEATURES),
                 self.gpos.lookups_for(script, GPOS_FEATURES))
            self._plans[script] = p
        return p

    # -- the whole line --------------------------------------------------
    def shape(self, text: str) -> list[Glyph]:
        """Glyphs of ``text`` (one line) in visual (= logical) order, each
        with its gid, cluster, advance and offsets in 26.6."""
        for ch in text:
            check_char(ch)
        scripts = resolve_scripts(text)
        out = []
        i = 0
        while i < len(text):
            j = i
            while j < len(text) and scripts[j] == scripts[i]:
                j += 1
            out.extend(self.shape_run(text, i, j, scripts[i]))
            i = j
        return out

    def shape_run(self, text, start, end, script):
        if "\u2044" in text[start:end] and self._has_fractions(script):
            raise unported("automatic fractions (U+2044 with the font's "
                           "frac, numr and dnom features)", 14)
        buf = self._normalize(text, start, end)
        for g in buf:
            g.cls = self._class(g.gid, g.char)
        gsub_lookups, gpos_lookups = self.plan(script)
        self._lig_id = 0
        for li in gsub_lookups:
            lk = self.gsub.lookups[li]
            if lk.type == 8:
                raise unported("GSUB reverse chaining lookups", 14)
            i = 0
            while i < len(buf):
                if self._skip(buf[i], lk):
                    i += 1
                    continue
                r = self._apply_gsub(buf, i, li)
                i = r if r is not None else i + 1
        for g in buf:
            g.xa = self.advance(g.gid)
        for li in gpos_lookups:
            lk = self.gpos.lookups[li]
            i = 0
            while i < len(buf):
                if self._skip(buf[i], lk):
                    i += 1
                    continue
                r = self._apply_gpos(buf, i, li)
                i = r if r is not None else i + 1
        space = self.font.cmap.get(0x20, 0)
        for g in buf:
            if g.cls == MARK:
                g.xa = g.ya = 0
            if g.ignorable:
                g.xa = g.ya = g.xo = g.yo = 0
        for i in range(len(buf)):
            self._propagate(buf, i)
        for g in buf:
            if g.ignorable:
                g.gid = space
        return buf

    def _propagate(self, buf, i):
        g = buf[i]
        if not g.chain:
            return
        j = i + g.chain
        g.chain = 0
        if not 0 <= j < len(buf):
            return
        self._propagate(buf, j)
        b = buf[j]
        g.xo += b.xo
        g.yo += b.yo
        for k in range(j, i):
            g.xo -= buf[k].xa
            g.yo -= buf[k].ya

    # -- normalisation -------------------------------------------------------
    def _normalize(self, text, start, end) -> list[Glyph]:
        """HarfBuzz's normaliser in its composed-diacritics mode: a
        character alone keeps its glyph or decomposes as little as it must;
        the base of a cluster of marks decomposes as far as the font has
        glyphs; marks reorder by combining class; then each mark composes
        with its starter where the font has the composed glyph."""
        chars = [(c, i) for i, c in zip(range(start, end), text[start:end])]
        # A line that starts with a mark gets a dotted circle to carry it
        # (hb_insert_dotted_circle at the beginning of text).
        if start == 0 and chars and _is_mark(chars[0][0]) and \
                0x25CC in self.font.cmap:
            chars.insert(0, ("\u25cc", 0))
        out = []
        n = len(chars)
        i = 0
        while i < n:
            j = i + 1
            while j < n and not _is_mark(chars[j][0]):
                j += 1
            if j < n:
                j -= 1
            for k in range(i, j):
                out.extend(self._decompose_char(*chars[k], True))
            if j >= n:
                break
            e = j + 1
            while e < n and _is_mark(chars[e][0]):
                e += 1
            for k in range(j, e):
                out.extend(self._decompose_char(*chars[k], False))
            i = e
        # Reorder runs of marks by canonical combining class.
        i = 0
        while i < len(out):
            if unicodedata.combining(out[i].char) == 0:
                i += 1
                continue
            j = i + 1
            while j < len(out) and unicodedata.combining(out[j].char):
                j += 1
            if j - i <= 32:
                out[i:j] = sorted(
                    out[i:j], key=lambda g: unicodedata.combining(g.char))
            i = j
        # Recompose marks onto their starter.
        cmap = self.font.cmap
        res = out[:1]
        starter = 0
        for g in out[1:]:
            ccc = unicodedata.combining(g.char)
            if _is_mark(g.char) and (
                    starter == len(res) - 1
                    or unicodedata.combining(res[-1].char) < ccc):
                s = res[starter]
                comp = unicodedata.normalize("NFC", s.char + g.char)
                if len(comp) == 1 and ord(comp) in cmap and \
                        unicodedata.normalize("NFD", comp) == \
                        unicodedata.normalize("NFD", s.char + g.char):
                    s.char = comp
                    s.gid = cmap[ord(comp)]
                    s.cluster = min(s.cluster, g.cluster)
                    continue
            res.append(g)
            if ccc == 0:
                starter = len(res) - 1
        return res

    def _decompose_char(self, ch, cluster, shortest):
        """HarfBuzz's decompose_current_character: the character's glyph,
        or its decomposition's, or the hyphen for a non-breaking hyphen,
        else the font's .notdef glyph."""
        cmap = self.font.cmap
        if (shortest and ord(ch) in cmap) or ord(ch) in IGNORABLE:
            return [Glyph(cmap.get(ord(ch), 0), cluster, ch)]
        seq = self._decompose(ch, shortest)
        if seq is None and ord(ch) in cmap:
            seq = [ch]
        if seq is not None:
            return [Glyph(cmap[ord(c)], cluster, c) for c in seq]
        if unicodedata.category(ch) == "Zs":
            raise unported(f"the space fallback for U+{ord(ch):04X}, which "
                           f"{self.font.name!r} has no glyph for", 14)
        if ord(ch) == 0x2011 and 0x2010 in cmap:
            return [Glyph(cmap[0x2010], cluster, ch)]
        return [Glyph(0, cluster, ch)]

    def _decompose(self, ch, shortest):
        """HarfBuzz's decompose(): the canonical decomposition of ``ch``
        into characters the font has (the shortest one, or the longest),
        or None."""
        d = unicodedata.decomposition(ch)
        if not d or d.startswith("<"):
            return None
        parts = [chr(int(x, 16)) for x in d.split()]
        cmap = self.font.cmap
        a, rest = parts[0], parts[1:]
        if any(ord(c) not in cmap for c in rest):
            return None
        has_a = ord(a) in cmap
        if shortest and has_a:
            return [a] + rest
        sub = self._decompose(a, shortest)
        if sub is not None:
            return sub + rest
        if has_a:
            return [a] + rest
        return None

    # -- skipping ------------------------------------------------------------
    def _skip(self, g, lk_or_flag, mark_set=None) -> bool:
        if isinstance(lk_or_flag, Lookup):
            flag, mark_set = lk_or_flag.flag, lk_or_flag.mark_set
        else:
            flag = lk_or_flag
        c = g.cls
        if c == BASE and flag & 2:
            return True
        if c == LIGATURE and flag & 4:
            return True
        if c == MARK:
            if flag & 8:
                return True
            if flag & 0x10:
                sets = self.gdef.mark_sets
                return mark_set is None or mark_set >= len(sets) or \
                    g.gid not in sets[mark_set]
            if flag & 0xFF00:
                return self.gdef.attach.get(g.gid, 0) != flag >> 8
        return False

    def _next(self, buf, i, lk, end=None):
        """The next glyph a lookup sees: past those its flags skip and
        past default ignorables."""
        end = len(buf) if end is None else end
        i += 1
        while i < end and (buf[i].ignorable or self._skip(buf[i], lk)):
            i += 1
        return i if i < end else None

    def _prev(self, buf, i, lk):
        i -= 1
        while i >= 0 and (buf[i].ignorable or self._skip(buf[i], lk)):
            i -= 1
        return i if i >= 0 else None

    # -- GSUB ----------------------------------------------------------------
    def _apply_gsub(self, buf, i, li, end=None):
        lk = self.gsub.lookups[li]
        g = buf[i]
        for st in self.gsub.subtables(li):
            kind = st[0]
            if kind == "single":
                s = st[1].get(g.gid)
                if s is not None:
                    g.gid = s
                    g.cls = self._class(s, None, g.cls)
                    return i + 1
            elif kind == "multiple":
                seq = st[1].get(g.gid)
                if seq is not None:
                    new = []
                    for k, s in enumerate(seq):
                        n = Glyph(s, g.cluster, g.char)
                        n.cls = self._class(s, None, g.cls)
                        n.lig_id, n.lig_comp = g.lig_id, (
                            k + 1 if len(seq) > 1 else g.lig_comp)
                        n.multiplied = len(seq) > 1
                        new.append(n)
                    buf[i:i + 1] = new
                    return i + len(new)
            elif kind == "alternate":
                alts = st[1].get(g.gid)
                if alts:
                    g.gid = alts[0]
                    g.cls = self._class(alts[0], None, g.cls)
                    return i + 1
            elif kind == "ligature":
                ligs = st[1].get(g.gid)
                if not ligs:
                    continue
                for lig, comps in ligs:
                    pos = [i]
                    k = i
                    ok = True
                    for c in comps:
                        k = self._next(buf, k, lk, end)
                        if k is None or buf[k].gid != c:
                            ok = False
                            break
                        pos.append(k)
                    if ok:
                        return self._ligate(buf, pos, lig)
            elif kind == "context":
                r = self._apply_context(buf, i, lk, st, gsub=True)
                if r is not None:
                    return r
        return None

    def _ligate(self, buf, pos, lig):
        first = buf[pos[0]]
        is_mark = first.cls == MARK and all(buf[p].cls == MARK for p in pos)
        is_base = first.cls == BASE and all(buf[p].cls == MARK
                                            for p in pos[1:])
        is_lig = not is_mark and not is_base
        comps = sum(buf[p].lig_comps for p in pos)
        lig_id = 0
        if is_lig:
            self._lig_id = (self._lig_id % 7) + 1
            lig_id = self._lig_id
        first.gid = lig
        first.cls = self._class(lig, None, LIGATURE if is_lig else first.cls)
        if is_lig:
            first.lig_id, first.lig_comp, first.lig_comps = lig_id, 0, comps
        # Marks between the components follow the ligature.
        so_far = 1
        for a, b in zip(pos, pos[1:]):
            for k in range(a + 1, b):
                if is_lig:
                    buf[k].lig_id = lig_id
                    buf[k].lig_comp = so_far
            so_far += 1
        for p in reversed(pos[1:]):
            del buf[p]
        return pos[0] + 1 + (pos[-1] - pos[0] - (len(pos) - 1))

    # -- contexts ------------------------------------------------------------
    def _apply_context(self, buf, i, lk, st, gsub):
        _k, fmt, cov, sets, cds = st
        g = buf[i]
        if g.gid not in cov:
            return None
        if fmt == 1:
            rules = sets[cov[g.gid]] if cov[g.gid] < len(sets) else []

            def match(gl, v, which):
                return gl.gid == v
        elif fmt == 2:
            cd_back, cd_in, cd_ahead = cds
            c = cd_in.get(g.gid, 0)
            rules = sets[c] if c < len(sets) else []

            def match(gl, v, which):
                return {0: cd_back, 1: cd_in, 2: cd_ahead}[which].get(
                    gl.gid, 0) == v
        else:
            rules = sets

            def match(gl, v, which):
                return gl.gid in v
        for back, inp, ahead, recs in rules:
            pos = [i]
            k = i
            ok = True
            for v in inp:
                k = self._next(buf, k, lk)
                if k is None or not match(buf[k], v, 1):
                    ok = False
                    break
                pos.append(k)
            if not ok:
                continue
            k = i
            for v in back:
                k = self._prev(buf, k, lk)
                if k is None or not match(buf[k], v, 0):
                    ok = False
                    break
            if not ok:
                continue
            k = pos[-1]
            for v in ahead:
                k = self._next(buf, k, lk)
                if k is None or not match(buf[k], v, 2):
                    ok = False
                    break
            if not ok:
                continue
            return self._apply_records(buf, pos, recs, gsub)
        return None

    def _apply_records(self, buf, pos, recs, gsub):
        """HarfBuzz's apply_lookup: nested lookups at the matched
        positions, the positions kept up with length changes. Returns
        where the buffer goes on."""
        pos = list(pos)
        count = len(pos)
        end = pos[-1] + 1
        for seq, li in recs:
            if seq >= count:
                continue
            orig = len(buf)
            if pos[seq] >= orig:
                continue
            if gsub:
                self._apply_gsub(buf, pos[seq], li)
            else:
                self._apply_gpos(buf, pos[seq], li)
            delta = len(buf) - orig
            if not delta:
                continue
            end += delta
            if end < pos[seq]:
                delta += pos[seq] - end
                end = pos[seq]
            nxt = seq + 1
            if delta > 0:
                pos = pos[:nxt] + [0] * delta + pos[nxt:count]
            else:
                delta = max(delta, nxt - count)
                pos = pos[:nxt] + pos[nxt - delta:count]
            nxt += max(delta, 0)
            count += delta
            for j in range(seq + 1, nxt):
                pos[j] = pos[j - 1] + 1
            for j in range(nxt, count):
                pos[j] += delta
        return end

    # -- GPOS ----------------------------------------------------------------
    def _value_apply(self, g, v):
        if not v:
            return
        if "xpla" in v:
            g.xo += self.em(v["xpla"])
        if "ypla" in v:
            g.yo += self.em(v["ypla"])
        if "xadv" in v:
            g.xa += self.em(v["xadv"])
        for name, attr in (("xpla_dev", "xo"), ("ypla_dev", "yo"),
                           ("xadv_dev", "xa")):
            dev = v.get(name)
            if dev is not None:
                px = _device_pixels(dev, self.ppem)
                d = abs(px * self.scale) // self.ppem
                setattr(g, attr, getattr(g, attr) + (d if px >= 0 else -d))

    def _apply_gpos(self, buf, i, li):
        lk = self.gpos.lookups[li]
        g = buf[i]
        for st in self.gpos.subtables(li):
            kind = st[0]
            if kind == "single":
                v = st[1].get(g.gid)
                if v is not None:
                    self._value_apply(g, v)
                    return i + 1
            elif kind == "pair":
                _k, fmt, cov, vf2, data = st
                if g.gid not in cov:
                    continue
                j = self._next(buf, i, lk)
                if j is None:
                    continue
                h = buf[j]
                if fmt == 1:
                    rec = data[g.gid].get(h.gid)
                else:
                    cd1, cd2, table = data
                    rec = table.get((cd1.get(g.gid, 0), cd2.get(h.gid, 0)))
                    if rec is None:
                        # A pair of classes with all-zero values applies.
                        return j + 1 if vf2 else j
                if rec is None:
                    continue
                self._value_apply(g, rec[0])
                self._value_apply(h, rec[1])
                return j + 1 if vf2 else j
            elif kind.startswith("mark_"):
                r = self._apply_mark(buf, i, lk, st)
                if r is not None:
                    return r
            elif kind == "context":
                r = self._apply_context(buf, i, lk, st, gsub=False)
                if r is not None:
                    return r
        return None

    def _anchor_xy(self, gid, anchor):
        """The anchor in 26.6 as HarfBuzz takes it: em_fscale in single
        precision, or the unhinted outline's point."""
        x, y, point = anchor
        if point is not None:
            xy = self._contour_point(gid, point)
            if xy is not None:
                return xy
        m = np.float32(self.scale) / np.float32(self.font.units_per_em)
        return np.float32(x) * m, np.float32(y) * m

    def _contour_point(self, gid, point):
        if self._unhinted is None:
            from .hinting import Face
            self._unhinted = Face(self.font).size(self.ppem, hint=False)
        o = self._unhinted.glyph(gid)
        if point >= len(o.xs):
            return None
        return np.float32(o.xs[point]), np.float32(o.ys[point])

    def _apply_mark(self, buf, i, lk, st):
        kind, mcov, bcov, marks, bases = st
        g = buf[i]
        mi = mcov.get(g.gid)
        if mi is None:
            return None
        if kind == "mark_mark":
            j = i - 1
            while j >= 0 and self._skip(buf[j], lk.flag & ~0x0E,
                                        lk.mark_set):
                j -= 1
            if j < 0 or buf[j].cls != MARK:
                return None
            b = buf[j]
            id1, id2 = g.lig_id, b.lig_id
            c1, c2 = g.lig_comp, b.lig_comp
            good = (id1 == id2 and (id1 == 0 or c1 == c2)) or (
                id1 != id2 and ((id1 > 0 and not c1) or (id2 > 0 and not c2)))
            if not good:
                return None
            bi = bcov.get(b.gid)
            if bi is None:
                return None
            row = bases[bi]
        else:
            j = i - 1
            while j >= 0 and buf[j].cls == MARK:
                j -= 1
            if j < 0:
                return None
            b = buf[j]
            bi = bcov.get(b.gid)
            if bi is None:
                return None
            if kind == "mark_lig":
                comps = bases[bi]
                if not comps:
                    return None
                if b.lig_id and b.lig_id == g.lig_id and g.lig_comp > 0:
                    ci = min(len(comps), g.lig_comp) - 1
                else:
                    ci = len(comps) - 1
                row = comps[ci]
            else:
                row = bases[bi]
        cls, manchor = marks[mi]
        if cls >= len(row) or row[cls] is None:
            return None
        mx, my = self._anchor_xy(g.gid, manchor)
        bx, by = self._anchor_xy(b.gid, row[cls])
        g.xo = _roundf(bx - mx)
        g.yo = _roundf(by - my)
        g.chain = j - i
        return i + 1


def _is_mark(ch: str) -> bool:
    return unicodedata.category(ch) in ("Mn", "Mc", "Me")


def _roundf(v) -> int:
    """HarfBuzz's _hb_roundf, floor(v + 0.5), in single precision."""
    return int(np.floor(np.float32(v) + np.float32(0.5)))


def _mul_div(a, b, c):
    s = -1 if (a < 0) != (b < 0) else 1
    a, b = abs(a), abs(b)
    return s * ((a * b + c // 2) // c)


_LAYOUT: dict = {}


def _tables(font: sfnt.Font, tag: str):
    """The font's GSUB, GPOS or GDEF, parsed once per font."""
    key = (id(font), tag)
    got = _LAYOUT.get(key)
    if got is None or got[0] is not font:
        data = font.table(tag)
        got = _LAYOUT[key] = (font, GDEF(data) if tag == "GDEF"
                              else LayoutTable(data, tag == "GPOS"))
    return got[1]
