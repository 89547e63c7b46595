"""Text shaping: what Raqm asks HarfBuzz for when Pillow lays out a line
of text with the default features and direction.

The line's embedding levels come from fribidi's algorithm (:mod:`bidi`);
the line is split into runs of one level, ordered visually as Raqm's
``_raqm_reorder_runs`` orders them (L2 over runs, not characters), and
each run into script runs as Raqm splits them (Common and Inherited
characters take the script around them), the script runs of a
right-to-left run in reverse. Each script run is shaped as HarfBuzz shapes
a buffer of that script and direction, with the line around it as context:

- a run whose direction is not its script's own has its graphemes
  reversed and is shaped in the script's direction (digits alone in an
  Arabic run stay left-to-right);
- in a right-to-left run, a mirrored character takes its mirror's glyph
  where the font has one, else the ``rtlm`` mask;
- the normaliser maps the run through the cmap (a character without a
  glyph decomposes canonically, marks reorder by HarfBuzz's modified
  combining class, with the Arabic and Hebrew shapers' own reorderings,
  and recompose where the font has the composed glyph);
- the Arabic shaper gives each glyph the mask of its joining form
  (:mod:`arabic`);
- GSUB applies the lookups of the features HarfBuzz enables for the
  script (the default plan: ``rvrn``, then ``ltra``/``ltrm`` or
  ``rtla``/``rtlm``, ``ccmp``, ``locl``, ``rlig``, ``calt``, ``clig``,
  ``liga``, ``rclt`` and the script's required feature; the Arabic plan:
  ``ccmp`` and ``locl``, then ``isol``, ``fina``, ``fin2``, ``fin3``,
  ``medi``, ``med2`` and ``init`` one stage each, then ``rclt`` and
  ``rlig``, ``calt``, ``mset``, ``clig`` and ``liga``), each stage in
  lookup order, each lookup on the glyphs its mask selects, with
  HarfBuzz's rules for skipping marks, default ignorables, ZWJ and ZWNJ;
- GPOS applies ``kern``, ``mark``, ``mkmk``, ``curs``, ``dist``, ``abvm``
  and ``blwm`` in lookup order, in logical order; marks are zeroed by
  GDEF, default ignorables hidden, attachments resolved for the run's
  direction, and a right-to-left run comes out in visual order.

Advances are hb-ft's: the unhinted advance scaled to 26.6; GPOS values
scale by HarfBuzz's ``em_scale`` at the font's 26.6 scale.

Text that needs what this module does not do raises
:func:`roadmap.unported` naming the character or the feature: scripts
other than Latin, Greek, Cyrillic, Arabic and Hebrew (and their Common and
Inherited characters), format characters other than the bidi controls,
ZWJ, ZWNJ and the default ignorables, a paragraph separator inside a line
that needs bidi, more than one isolate in a line, Arabic in a face
without Arabic forms in GSUB (HarfBuzz's fallback shaping), Hebrew in a
face without Hebrew in GPOS (its fallback positioning), and the lookup
types and features listed where they are refused.
"""

from __future__ import annotations

import struct
import unicodedata

import numpy as np

from ..roadmap import unported
from . import arabic, bidi, sfnt
from .ucd import (ARABIC, COMMON, CYRILLIC, GRAPHEME_EXTEND, GREEK, HEBREW,
                  INHERITED, LATIN, MIRROR, ZWJ_PICTOGRAPHIC, bidi_class,
                  modified_class)
from .ucd import script_of as _script_of

GPOS_FEATURES = ("abvm", "blwm", "mark", "mkmk", "curs", "dist", "kern")
# GPOS features HarfBuzz enables with manual joiners: their lookups do not
# skip a ZWJ.
MANUAL_JOINERS = ("mark", "mkmk")

# GDEF glyph classes
BASE, LIGATURE, MARK, COMPONENT = 1, 2, 3, 4

OT_SCRIPT = {LATIN: "latn", GREEK: "grek", CYRILLIC: "cyrl",
             ARABIC: "arab", HEBREW: "hebr"}
RTL_SCRIPTS = (ARABIC, HEBREW)

# Raqm's paired brackets (open, close).
_PAIRS = "()<>[]{}«»‹›⁅⁆⁽⁾₍₎⌈⌉⌊⌋〈〉❨❩❪❫❬❭❮❯❰❱❲❳❴❵⟅⟆⟦⟧⟨⟩⟪⟫"


def script_of(ch: str) -> str:
    """The character's script, raising for one outside the scripts this
    module lays out."""
    s = _script_of(ch)
    c = ord(ch)
    if s is None:
        if unicodedata.bidirectional(ch) in ("R", "AL"):
            raise unported(f"right-to-left text {ch!r} (U+{c:04X}) in a "
                           "script other than Arabic and Hebrew or outside "
                           "their blocks (U+0590-06FF)", 14)
        raise unported(f"text layout of {ch!r} (U+{c:04X}): its "
                       "script needs a shaper or a script run this port "
                       "does not lay out", 14)
    return s


# Default-ignorable characters HarfBuzz lays out as an invisible glyph of
# no advance (hb_ot_hide_default_ignorables): the soft hyphen, CGJ, ALM,
# ZWSP, ZWNJ, ZWJ, LRM, RLM, the embeddings and overrides, the invisible
# operators, the isolates, the variation selectors and ZWNBSP.
VARIATION_SELECTORS = frozenset(range(0xFE00, 0xFE10))
IGNORABLE = frozenset([0x00AD, 0x034F, 0x061C, 0x200B, 0x200C, 0x200D,
                       0x200E, 0x200F, 0x202A, 0x202B, 0x202C, 0x202D,
                       0x202E, 0x2060, 0x2061, 0x2062, 0x2063, 0x2064,
                       0x2066, 0x2067, 0x2068, 0x2069,
                       0xFEFF]) | VARIATION_SELECTORS
ZWNJ, ZWJ, CGJ = 0x200C, 0x200D, 0x034F
# Bidi classes whose presence makes a line need the bidi algorithm.
_BIDI = frozenset(("R", "AL", "AN", "LRE", "RLE", "LRO", "RLO", "PDF",
                   "LRI", "RLI", "FSI", "PDI"))


def check_char(ch: str):
    """Raise for a character this module does not lay out."""
    c = ord(ch)
    if c in IGNORABLE:
        return
    if unicodedata.category(ch) in ("Cf", "Cs"):
        raise unported(f"text layout of the format character U+{c:04X}",
                       14)
    script_of(ch)


def line_levels(text: str) -> list[int]:
    """The embedding level of each character of one line, as Raqm gets
    them from fribidi (all 0 for a line with nothing right-to-left or
    explicit in it)."""
    classes = [bidi_class(ch) for ch in text]
    if not _BIDI.intersection(classes):
        return [0] * len(text)
    for ch, cls in zip(text, classes):
        if cls == "B":
            raise unported(f"a paragraph separator {ch!r} inside a line "
                           "that needs bidi reordering", 14)
    if sum(cls in ("LRI", "RLI", "FSI") for cls in classes) > 1:
        raise unported("more than one bidi isolate (LRI, RLI, FSI) in a "
                       "line: fribidi 1.0.8 carries state from one to the "
                       "next", 14)
    return bidi.line_levels(text)[0]


def visual_runs(levels: list[int]) -> list[tuple[int, int, int]]:
    """Raqm's ``_raqm_reorder_runs``: the runs of equal level as (start,
    end, level), reordered by L2 over runs from the highest level down
    to 1."""
    runs = []
    for i, lv in enumerate(levels):
        if runs and runs[-1][2] == lv:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1, lv])
    top = max(levels, default=0)
    for level in range(top, 0, -1):
        i = len(runs) - 1
        while i >= 0:
            if runs[i][2] >= level:
                end = i
                while i >= 0 and runs[i][2] >= level:
                    i -= 1
                runs[i + 1:end + 1] = runs[i + 1:end + 1][::-1]
            else:
                i -= 1
    return [tuple(r) for r in runs]


def resolve_scripts(text: str) -> list[str]:
    """Raqm's script of each character (``_raqm_resolve_scripts``): a
    nonspacing mark counts as Inherited whatever its script (a Hebrew point
    after an Arabic letter joins the Arabic run), then Common and Inherited
    characters take the script around them."""
    scripts = [INHERITED if unicodedata.category(ch) == "Mn" else s
               for ch, s in zip(text, map(script_of, text))]
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

    def chosen(self, script: str | None) -> str | None:
        """The script tag HarfBuzz picks for ``script``: its own, then
        DFLT, dflt, latn."""
        tags = ([OT_SCRIPT[script]] if script in OT_SCRIPT else []) + [
            "DFLT", "dflt", "latn"]
        return next((t for t in tags if t in self.scripts), None)

    def select(self, script: str | None):
        """The LangSys HarfBuzz picks for ``script`` with the default
        language: (required feature index or None, feature indices)."""
        tag = self.chosen(script)
        return None if tag is None else self.scripts[tag].get(None)

    def feature(self, script, tag) -> list[int] | None:
        """The lookups of the first feature ``tag`` of the LangSys, or None
        where it has no such feature."""
        ls = self.select(script)
        for fi in (ls[1] if ls else ()):
            if self.features[fi][0] == tag:
                return self.features[fi][1]
        return None

    def required(self, script) -> list[int]:
        ls = self.select(script)
        if ls is None or ls[0] is None:
            return []
        return self.features[ls[0]][1]

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

GLOBAL = 1
# Mask bits of the features that are not on every glyph.
MASK = {tag: 1 << (k + 1) for k, tag in enumerate(arabic.FORMS + ("rtlm",))}
# A glyph's answer to a lookup's skipping rules (HarfBuzz's may_skip).
_SKIP_NO, _SKIP_MAYBE, _SKIP_YES = range(3)


class Glyph:
    __slots__ = ("gid", "cluster", "char", "cls", "lig_id", "lig_comp",
                 "lig_comps", "multiplied", "xa", "ya", "xo", "yo", "chain",
                 "ignorable", "hidden", "substituted", "mask", "mcc")

    def __init__(self, gid, cluster, char, mask=GLOBAL):
        self.gid, self.cluster, self.char = gid, cluster, char
        self.ignorable = ord(char) in IGNORABLE
        self.hidden = ord(char) == CGJ
        self.substituted = False
        self.mask = mask
        self.mcc = modified_class(char)
        self.cls = BASE
        self.lig_id = self.lig_comp = 0
        self.lig_comps = 1
        self.multiplied = False
        self.xa = self.ya = self.xo = self.yo = 0
        self.chain = 0

    @property
    def default_ignorable(self) -> bool:
        return self.ignorable and not self.substituted


class Plan:
    """What HarfBuzz's shape plan holds for one script and direction: the
    shaper, the GSUB stages (each [(lookup, mask, auto ZWJ)] in lookup
    order) and the GPOS lookups [(lookup, auto ZWJ)] (all global)."""

    __slots__ = ("shaper", "gsub", "gpos")

    def __init__(self, shaper, gsub, gpos):
        self.shaper, self.gsub, self.gpos = shaper, gsub, gpos


def _reverse_graphemes(items: list) -> list:
    """HarfBuzz's _hb_ot_layout_reverse_graphemes: the graphemes (a
    character and the marks, ZWJs and continuations after it, as
    hb_set_unicode_props marks them) in reverse order, each in its own
    order."""
    groups = []
    after_zwj = False
    for it in items:
        c = ord(it[0])
        cont = c >= 0x80 and (_is_mark(it[0]) or c == ZWJ
                              or c in GRAPHEME_EXTEND
                              or (after_zwj and c in ZWJ_PICTOGRAPHIC))
        after_zwj = c == ZWJ
        if groups and cont:
            groups[-1].append(it)
        else:
            groups.append([it])
    return [it for grp in reversed(groups) for it in grp]


def _reorder_hebrew(buf, start, end):
    """HarfBuzz's reorder_marks_hebrew: patah or qamats, then sheva or
    hiriq, then meteg or a below mark: the last two swap."""
    for i in range(start + 2, end):
        c0, c1, c2 = buf[i - 2].mcc, buf[i - 1].mcc, buf[i].mcc
        if c0 in (20, 21) and c1 in (22, 23) and c2 in (25, 220):
            buf[i - 1], buf[i] = buf[i], buf[i - 1]
            break


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
        # The lookup being applied: its mask, auto-ZWJ and table.
        self._mask = GLOBAL
        self._auto_zwj = True
        self._in_gpos = False
        self._lig_id = 0

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

    def plan(self, script, rtl: bool) -> Plan:
        """HarfBuzz's plan for ``script`` in the direction ``rtl``: its
        features and pauses (hb_ot_shape_collect_features and the
        shaper's collect_features), each feature's lookups in the stage
        of its first appearance."""
        key = (script, rtl)
        got = self._plans.get(key)
        if got is not None:
            return got
        if script == ARABIC:
            shaper = "arabic"
        elif script == HEBREW:
            shaper = "hebrew"
        else:
            shaper = "default"
        dirs = ((("rtla", GLOBAL), ("rtlm", MASK["rtlm"])) if rtl else
                (("ltra", GLOBAL), ("ltrm", GLOBAL)))
        # Stages of (tag, mask, auto ZWJ).
        if shaper == "arabic":
            if all(self.gsub.feature(script, t) is None and
                   self.gpos.feature(script, t) is None
                   for t in ("isol", "fina", "medi", "init")):
                raise unported(f"Arabic text in {self.font.name!r}, which "
                               "has no Arabic forms in GSUB (HarfBuzz's "
                               "fallback shaping from presentation forms)",
                               14)
            if self.gsub.feature(script, "stch") is not None:
                raise unported("the Arabic stch feature", 14)
            stages = [[("rvrn", GLOBAL, True)],
                      [(t, m, True) for t, m in dirs],
                      [("ccmp", GLOBAL, False), ("locl", GLOBAL, False)]]
            stages += [[(t, MASK[t], True)] for t in arabic.FORMS]
            # The ligating features take ZWJ manually in the Arabic plan
            # (a ZWJ keeps HarfBuzz 12.3.0 from ligating liga's pairs too).
            stages += [[("rclt", GLOBAL, False), ("rlig", GLOBAL, False)],
                       [("calt", GLOBAL, False)],
                       [("mset", GLOBAL, False), ("clig", GLOBAL, False),
                        ("liga", GLOBAL, False)]]
        else:
            if shaper == "hebrew" and self.gpos.chosen(script) != "hebr":
                raise unported(f"Hebrew text in {self.font.name!r}, whose "
                               "GPOS has no Hebrew script (HarfBuzz's "
                               "fallback mark positioning)", 14)
            if shaper == "hebrew" and self.gpos.feature(script,
                                                        "mark") is None:
                raise unported(f"Hebrew text in {self.font.name!r}, whose "
                               "GPOS has no mark feature (HarfBuzz's "
                               "presentation-form composition)", 14)
            stages = [[("rvrn", GLOBAL, True)],
                      [(t, m, True) for t, m in dirs] + [
                          (t, GLOBAL, True) for t in (
                              "ccmp", "locl", "rlig", "calt", "clig", "liga",
                              "rclt")]]
        gsub = []
        req = self.gsub.select(script)
        req_tag = self.gsub.features[req[0]][0] if req and req[0] is not None \
            else None
        req_stage = next((k for k, st in enumerate(stages)
                          if any(f[0] == req_tag for f in st)), 0)
        for k, st in enumerate(stages):
            found = {}
            if k == req_stage:
                for li in self.gsub.required(script):
                    found[li] = (GLOBAL, True)
            for tag, mask, zwj in st:
                for li in self.gsub.feature(script, tag) or ():
                    m, z = found.get(li, (0, True))
                    found[li] = (m | mask, z and zwj)
            gsub.append([(li, m, z) for li, (m, z) in sorted(found.items())])
        gpos = dict.fromkeys(self.gpos.required(script), True)
        for tag in GPOS_FEATURES:
            for li in self.gpos.feature(script, tag) or ():
                gpos[li] = gpos.get(li, True) and tag not in MANUAL_JOINERS
        got = self._plans[key] = Plan(shaper, gsub, sorted(gpos.items()))
        return got

    # -- the whole line --------------------------------------------------
    def shape(self, text: str) -> list[Glyph]:
        """Glyphs of ``text`` (one line) in visual order, each with its
        gid, cluster, advance and offsets in 26.6."""
        for ch in text:
            check_char(ch)
        levels = line_levels(text)
        scripts = resolve_scripts(text)
        out = []
        for start, end, level in visual_runs(levels):
            subs = []
            i = start
            while i < end:
                j = i
                while j < end and scripts[j] == scripts[i]:
                    j += 1
                subs.append((i, j))
                i = j
            rtl = bool(level & 1)
            for a, b in (reversed(subs) if rtl else subs):
                out.extend(self.shape_run(text, a, b, scripts[a], rtl))
        return out

    def shape_run(self, text, start, end, script, rtl=False):
        """One HarfBuzz buffer: text[start:end] in ``script``, right to
        left where ``rtl``, the rest of the line its context. Glyphs in
        visual order."""
        if "\u2044" in text[start:end] and self._has_fractions(script):
            raise unported("automatic fractions (U+2044 with the font's "
                           "frac, numr and dnom features)", 14)
        pl = self.plan(script, rtl)
        cmap = self.font.cmap
        items = [(text[k], k) for k in range(start, end)]
        # A line that starts with a mark gets a dotted circle to carry it
        # (hb_insert_dotted_circle at the beginning of text).
        if start == 0 and items and _is_mark(items[0][0]) and \
                0x25CC in cmap:
            items.insert(0, ("\u25cc", 0))
        # hb_ensure_native_direction: digits alone in a right-to-left
        # script run are left-to-right.
        native_rtl = script in RTL_SCRIPTS
        if native_rtl and not rtl:
            cats = [unicodedata.category(c) for c, _k in items]
            if "Nd" in cats and not any(c[0] == "L" for c in cats):
                native_rtl = False
        backward = rtl
        if native_rtl != rtl:
            items = _reverse_graphemes(items)
            backward = native_rtl
        # hb_ot_mirror_chars.
        chars = []
        for ch, k in items:
            mask = GLOBAL
            if rtl:
                m = MIRROR.get(ord(ch))
                if m is not None and m in cmap:
                    ch = chr(m)
                else:
                    mask |= MASK["rtlm"]
            chars.append((ch, k, mask))
        reorder = {"arabic": arabic.reorder_marks,
                   "hebrew": _reorder_hebrew}.get(pl.shaper)
        buf = self._normalize(chars, reorder)
        if pl.shaper == "arabic":
            before = text[max(start - 5, 0):start][::-1]
            after = text[end:end + 5]
            acts = arabic.joining([g.char for g in buf], before, after)
            for g, a in zip(buf, acts):
                if a != arabic.NONE:
                    g.mask |= MASK[arabic.FORMS[a]]
        for g in buf:
            g.cls = self._class(g.gid, g.char)
        self._lig_id = 0
        self._in_gpos = False
        for stage in pl.gsub:
            for li, mask, zwj in stage:
                lk = self.gsub.lookups[li]
                if lk.type == 8:
                    raise unported("GSUB reverse chaining lookups", 14)
                self._mask, self._auto_zwj = mask, zwj
                i = 0
                while i < len(buf):
                    if not buf[i].mask & mask or self._skip(buf[i], lk):
                        i += 1
                        continue
                    r = self._apply_gsub(buf, i, li)
                    i = r if r is not None else i + 1
        for g in buf:
            g.xa = self.advance(g.gid)
        self._in_gpos = True
        self._mask = GLOBAL
        for li, zwj in pl.gpos:
            self._auto_zwj = zwj
            lk = self.gpos.lookups[li]
            i = 0
            while i < len(buf):
                if self._skip(buf[i], lk):
                    i += 1
                    continue
                r = self._apply_gpos(buf, i, li)
                i = r if r is not None else i + 1
        space = cmap.get(0x20, 0)
        for g in buf:
            if g.cls == MARK:
                g.xa = g.ya = 0
            if g.default_ignorable:
                g.xa = g.ya = g.xo = g.yo = 0
        for i in range(len(buf)):
            self._propagate(buf, i, backward)
        if backward:
            buf.reverse()
        for g in buf:
            if g.default_ignorable:
                g.gid = space
        return buf

    def _propagate(self, buf, i, backward):
        """HarfBuzz's propagate_attachment_offsets for a mark: the base's
        offset, less the advances between them (forward) or plus the
        advances after the base up to the mark (backward)."""
        g = buf[i]
        if not g.chain:
            return
        j = i + g.chain
        g.chain = 0
        if not 0 <= j < len(buf):
            return
        self._propagate(buf, j, backward)
        b = buf[j]
        g.xo += b.xo
        g.yo += b.yo
        if backward:
            for k in range(j + 1, i + 1):
                g.xo += buf[k].xa
                g.yo += buf[k].ya
        else:
            for k in range(j, i):
                g.xo -= buf[k].xa
                g.yo -= buf[k].ya

    # -- normalisation -------------------------------------------------------
    def _normalize(self, chars, reorder=None) -> list[Glyph]:
        """HarfBuzz's normaliser in its composed-diacritics mode on
        [(char, cluster, mask)]: a character alone keeps its glyph or
        decomposes as little as it must; the base of a cluster of marks
        decomposes as far as the font has glyphs; marks reorder by
        modified combining class (then by the shaper's ``reorder``); then
        each mark composes with its starter where the font has the
        composed glyph."""
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
            if any(ord(c) in VARIATION_SELECTORS for c, _k, _m in
                   chars[j:e]):
                # handle_variation_selector_cluster: nominal glyphs, no
                # decomposition (a face without variation sequences).
                if self.font.variation_sequences:
                    raise unported("a variation sequence in a face with a "
                                   "format 14 cmap", 14)
                out.extend(Glyph(self.font.cmap.get(ord(c), 0), k, c, m)
                           for c, k, m in chars[j:e])
            else:
                for k in range(j, e):
                    out.extend(self._decompose_char(*chars[k], False))
            i = e
        # Reorder runs of marks by modified combining class.
        i = 0
        while i < len(out):
            if out[i].mcc == 0:
                i += 1
                continue
            j = i + 1
            while j < len(out) and out[j].mcc:
                j += 1
            if j - i <= 32:
                out[i:j] = sorted(out[i:j], key=lambda g: g.mcc)
                if reorder is not None:
                    reorder(out, i, j)
            i = j
        # A CGJ that kept no marks apart is skippable again.
        for i in range(1, len(out) - 1):
            if ord(out[i].char) == CGJ and (
                    out[i + 1].mcc == 0 or out[i - 1].mcc <= out[i + 1].mcc):
                out[i].hidden = False
        # Recompose marks onto their starter.
        cmap = self.font.cmap
        res = out[:1]
        starter = 0
        for g in out[1:]:
            if _is_mark(g.char) and (starter == len(res) - 1
                                     or res[-1].mcc < g.mcc):
                s = res[starter]
                # Primary composition: the character whose canonical
                # decomposition is exactly this pair.
                comp = unicodedata.normalize("NFC", s.char + g.char)
                if len(comp) == 1 and ord(comp) in cmap and \
                        unicodedata.decomposition(comp) == \
                        f"{ord(s.char):04X} {ord(g.char):04X}":
                    s.char = comp
                    s.gid = cmap[ord(comp)]
                    s.cluster = min(s.cluster, g.cluster)
                    s.mcc = modified_class(comp)
                    continue
            res.append(g)
            if g.mcc == 0:
                starter = len(res) - 1
        return res

    def _decompose_char(self, ch, cluster, mask, shortest):
        """HarfBuzz's decompose_current_character: the character's glyph,
        or its decomposition's, or the hyphen for a non-breaking hyphen,
        else the font's .notdef glyph."""
        cmap = self.font.cmap
        if (shortest and ord(ch) in cmap) or ord(ch) in IGNORABLE:
            return [Glyph(cmap.get(ord(ch), 0), cluster, ch, mask)]
        seq = self._decompose(ch, shortest)
        if seq is None and ord(ch) in cmap:
            seq = [ch]
        if seq is not None:
            return [Glyph(cmap[ord(c)], cluster, c, mask) for c in seq]
        if unicodedata.category(ch) == "Zs":
            raise unported(f"the space fallback for U+{ord(ch):04X}, which "
                           f"{self.font.name!r} has no glyph for", 14)
        if ord(ch) == 0x2011 and 0x2010 in cmap:
            return [Glyph(cmap[0x2010], cluster, ch, mask)]
        return [Glyph(0, cluster, ch, mask)]

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
        """Whether the lookup flag (and mark filtering set) skips ``g``
        by its GDEF class."""
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

    def _may_skip(self, g, lk, context) -> int:
        """HarfBuzz's matcher may_skip: by the lookup flag, then as a
        default ignorable (:meth:`_ignored`)."""
        if self._skip(g, lk):
            return _SKIP_YES
        return _SKIP_MAYBE if self._ignored(g, context) else _SKIP_NO

    def _ignored(self, g, context=False) -> bool:
        """Whether the lookup may skip ``g`` as a default ignorable: not a
        ZWJ where the feature takes joiners manually (outside a context),
        nor, in GSUB, a ZWNJ in an input sequence or a hidden CGJ."""
        if not g.default_ignorable:
            return False
        c = ord(g.char)
        if c == ZWJ and not (context or self._auto_zwj):
            return False
        return self._in_gpos or not ((c == ZWNJ and not context)
                                     or g.hidden)

    def _step(self, buf, k, lk, want, context):
        """HarfBuzz's skipping iterator at ``buf[k]``: True (matched),
        False (stop) or None (skip it)."""
        g = buf[k]
        skip = self._may_skip(g, lk, context)
        if skip == _SKIP_YES:
            return None
        if not context and not g.mask & self._mask:
            match = False
        else:
            match = None if want is None else want(g)
        if match or (match is None and skip == _SKIP_NO):
            return True
        if skip == _SKIP_NO:
            return False
        return None

    def _next(self, buf, i, lk, want=None, context=False, end=None):
        """The next glyph after ``i`` that matches ``want`` (or any glyph
        a lookup does not skip), or None."""
        end = len(buf) if end is None else end
        for k in range(i + 1, end):
            r = self._step(buf, k, lk, want, context)
            if r is not None:
                return k if r else None
        return None

    def _prev(self, buf, i, lk, want=None, context=False):
        for k in range(i - 1, -1, -1):
            r = self._step(buf, k, lk, want, context)
            if r is not None:
                return k if r else None
        return None

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
                    g.substituted = True
                    return i + 1
            elif kind == "multiple":
                seq = st[1].get(g.gid)
                if seq is not None:
                    new = []
                    for k, s in enumerate(seq):
                        n = Glyph(s, g.cluster, g.char, g.mask)
                        n.cls = self._class(s, None, g.cls)
                        n.mcc = g.mcc
                        n.substituted = True
                        n.lig_id, n.lig_comp = g.lig_id, (
                            k + 1 if len(seq) > 1 and not g.lig_id
                            else g.lig_comp)
                        n.multiplied = len(seq) > 1
                        new.append(n)
                    buf[i:i + 1] = new
                    return i + len(new)
            elif kind == "alternate":
                alts = st[1].get(g.gid)
                if alts:
                    g.gid = alts[0]
                    g.cls = self._class(alts[0], None, g.cls)
                    g.substituted = True
                    return i + 1
            elif kind == "ligature":
                ligs = st[1].get(g.gid)
                if not ligs:
                    continue
                for lig, comps in ligs:
                    pos = self._match_ligature(buf, i, lk, comps, end)
                    if pos is not None:
                        return self._ligate(buf, pos, lig)
            elif kind == "context":
                r = self._apply_context(buf, i, lk, st, gsub=True)
                if r is not None:
                    return r
        return None

    def _match_ligature(self, buf, i, lk, comps, end):
        """HarfBuzz's match_input for a ligature: the positions of its
        components, none attached to another ligature's component."""
        pos = [i]
        k = i
        first = buf[i]
        for c in comps:
            k = self._next(buf, k, lk, lambda gl, c=c: gl.gid == c,
                           end=end)
            if k is None:
                return None
            h = buf[k]
            if first.lig_id and first.lig_comp:
                if (h.lig_id, h.lig_comp) != (first.lig_id,
                                              first.lig_comp):
                    return None
            elif h.lig_id and h.lig_comp and h.lig_id != first.lig_id:
                return None
            pos.append(k)
        return pos

    def _ligate(self, buf, pos, lig):
        """HarfBuzz's ligate_input: the first component becomes the
        ligature, the marks between the components (and those after the
        last that belonged to it) are numbered onto its components."""
        first = buf[pos[0]]
        rest = [buf[p] for p in pos[1:]]
        is_base = first.cls == BASE and all(h.cls == MARK for h in rest)
        is_mark = first.cls == MARK and all(h.cls == MARK for h in rest)
        is_lig = not is_base and not is_mark
        total = first.lig_comps + sum(h.lig_comps for h in rest)
        lig_id = 0
        if is_lig:
            self._lig_id = (self._lig_id % 7) + 1
            lig_id = self._lig_id
        last_lig_id = first.lig_id
        last_comps = first.lig_comps
        so_far = last_comps
        if is_lig:
            first.lig_id, first.lig_comp, first.lig_comps = lig_id, 0, total
        first.gid = lig
        first.cls = self._class(lig, None, LIGATURE if is_lig else first.cls)
        first.substituted = True
        for a, b in zip(pos, pos[1:]):
            for k in range(a + 1, b):
                if is_lig:
                    h = buf[k]
                    this = h.lig_comp or last_comps
                    h.lig_id = lig_id
                    h.lig_comp = so_far - last_comps + min(this, last_comps)
            last_lig_id = buf[b].lig_id
            last_comps = buf[b].lig_comps
            so_far += last_comps
        if not is_mark and last_lig_id:
            for k in range(pos[-1] + 1, len(buf)):
                h = buf[k]
                if h.lig_id != last_lig_id or not h.lig_comp:
                    break
                h.lig_comp = so_far - last_comps + min(h.lig_comp,
                                                       last_comps)
                h.lig_id = lig_id
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
                k = self._next(buf, k, lk, lambda gl, v=v: match(gl, v, 1))
                if k is None:
                    ok = False
                    break
                pos.append(k)
            if not ok:
                continue
            k = i
            for v in back:
                k = self._prev(buf, k, lk, lambda gl, v=v: match(gl, v, 0),
                               context=True)
                if k is None:
                    ok = False
                    break
            if not ok:
                continue
            k = pos[-1]
            for v in ahead:
                k = self._next(buf, k, lk, lambda gl, v=v: match(gl, v, 2),
                               context=True)
                if k is None:
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
            while j >= 0 and (self._ignored(buf[j]) or self._skip(
                    buf[j], lk.flag & ~0x0E, lk.mark_set)):
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
            # The base: the nearest glyph before that is neither a mark nor
            # a default ignorable (for mark-to-base, not a later glyph of a
            # multiple substitution's sequence unless the subtable covers
            # it).
            j = i - 1
            while j >= 0 and (buf[j].cls == MARK or self._ignored(buf[j])
                              or (kind == "mark_base" and not _accept(buf, j)
                                  and buf[j].gid not in bcov)):
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


def _accept(buf, j) -> bool:
    """HarfBuzz's MarkBasePos accept(): marks attach to the first glyph of
    a multiple substitution's sequence."""
    g = buf[j]
    if not g.multiplied or not g.lig_comp or j == 0:
        return True
    h = buf[j - 1]
    return (h.cls == MARK or not h.multiplied or g.lig_id != h.lig_id
            or g.lig_comp != h.lig_comp + 1)


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
