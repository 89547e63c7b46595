"""A TrueType face at one size: the counterpart of Pillow's
``ImageFont.FreeTypeFont`` as ``ImageDraw`` uses it to draw a line of text
(Raqm layout, hinted glyphs, 8-bit coverage).

The size is requested as Pillow requests it (a nominal height of ``size``
pixels, so the ppem is ``size``); each glyph's bitmap sits at its pen
rounded to the pixel (FreeType's ``PIXEL`` of the 26.6 pen plus the GPOS
offset), its rows counted down from the line's ascender, which is the
size's ascender rounded up to the pixel. Text boxes are the union of the
glyphs' control boxes (floored and ceiled to pixels) with the pen line, as
Pillow's ``getbbox`` takes them. Glyphs are hinted and rasterised once per
(file, size) and kept in :attr:`TrueTypeFont.glyphs`; :func:`truetype`
keeps one face per (file, modification time, size), the file parsed and
its ``fpgm`` run once for all its sizes.
"""

from __future__ import annotations

import os
import time

import numpy as np

from . import hinting, raster, sfnt, shaping
from .hinting import div_fix, mul_fix

# Extra pixels between the lines of multi-line text (ImageDraw's spacing).
LINE_SPACING = 4


def pixel(v: int) -> int:
    """FreeType's PIXEL: 26.6 to the nearest pixel."""
    return (v + 32) >> 6


class Glyph:
    """One rasterised glyph: the bitmap's left and top (pixels, y up, from
    the pen), its coverage (rows, width) uint8 and its control box in whole
    pixels (x0, y0, x1, y1), y up."""

    __slots__ = ("left", "top", "coverage", "box")

    def __init__(self, left, top, coverage, box):
        self.left, self.top, self.coverage, self.box = left, top, \
            coverage, box


class TrueTypeFont:
    """``path`` at ``size`` pixels; ``face`` is the file's hinting face
    where another size has opened it already."""

    def __init__(self, path: str, size: int,
                 face: hinting.Face | None = None):
        self.path = path
        self.size = int(size)
        self.face = face or hinting.Face(sfnt.load(path))
        self.font = self.face.font
        ppem = self.size
        self.scale = div_fix(ppem << 6, self.font.units_per_em)
        self.sized = self.face.size(ppem)
        self.shaper = shaping.Shaper(self.font, ppem, self.scale)
        asc = mul_fix(self.font.ascender, self.scale)
        self.ascender = ((asc + 63) & -64) >> 6
        self.glyphs: dict[int, Glyph] = {}
        self.hint_s = 0.0
        self.raster_s = 0.0
        self.pitch = self.bbox("A")[3] + LINE_SPACING

    def glyph(self, gid: int) -> Glyph:
        g = self.glyphs.get(gid)
        if g is None:
            t0 = time.perf_counter()
            outline = self.sized.glyph(gid)
            t1 = time.perf_counter()
            left, top, cov = raster.render(outline)
            t2 = time.perf_counter()
            self.hint_s += t1 - t0
            self.raster_s += t2 - t1
            if outline.xs:
                x0, y0, x1, y1 = outline.cbox()
                box = (x0 >> 6, y0 >> 6, (x1 + 63) >> 6, (y1 + 63) >> 6)
            else:
                box = (0, 0, 0, 0)
            g = Glyph(left, top, cov, box)
            self.glyphs[gid] = g
        return g

    def cache_bytes(self) -> int:
        """Bytes the glyph cache holds (coverage and the four-int box)."""
        return sum(g.coverage.nbytes + 32 for g in self.glyphs.values())

    # -- one line ------------------------------------------------------------
    def layout(self, line: str):
        """[(gid, pen x in pixels, pen y offset in pixels (up), the pen's
        26.6 x after the glyph)] of the line's glyphs, and the pen's end
        in 26.6."""
        out = []
        pos = 0
        for g in self.shaper.shape(line) if line else ():
            px, py = pixel(pos + g.xo), pixel(g.yo)
            pos += g.xa
            out.append((g.gid, px, py, pos))
        return out, pos

    def getlength(self, line: str) -> float:
        return self.layout(line)[1] / 64

    def bbox(self, line: str) -> tuple[int, int, int, int]:
        """``getbbox(line)`` with the ``la`` anchor: (left, top, right,
        bottom) from the line's top left."""
        items, _end = self.layout(line)
        if not items:
            return (0, 0, 0, 0)
        x_min = x_max = y_min = y_max = 0
        for gid, px, py, pos in items:
            x_max = max(x_max, pixel(pos))
            b = self.glyph(gid).box
            x_min = min(x_min, px + b[0])
            x_max = max(x_max, px + b[2])
            y_min = min(y_min, py + b[1])
            y_max = max(y_max, py + b[3])
        return (x_min, self.ascender - y_max, x_max, self.ascender - y_min)

    def draw(self, cov: np.ndarray, line: str, x: int, y: int):
        """Combine the line's coverage into ``cov`` (int32, clipped to it)
        with its top left at (x, y): each glyph as ``a + b - a*b/255``."""
        h, w = cov.shape
        items, _end = self.layout(line)
        for gid, px, py, _pos in items:
            g = self.glyph(gid)
            c = g.coverage
            if not c.size:
                continue
            gx = x + px + g.left
            gy = y + self.ascender - py - g.top
            xa, ya = max(gx, 0), max(gy, 0)
            xb = min(gx + c.shape[1], w)
            yb = min(gy + c.shape[0], h)
            if xb > xa and yb > ya:
                a = cov[ya:yb, xa:xb]
                b = c[ya - gy:yb - gy, xa - gx:xb - gx].astype(np.int32)
                t = a * b + 128
                cov[ya:yb, xa:xb] = a + b - (((t >> 8) + t) >> 8)


# The faces truetype() has opened, by (path, modification time, size).
FACES: dict[tuple[str, float, int], TrueTypeFont] = {}


def truetype(path: str, size: int) -> TrueTypeFont:
    """The face ``ImageFont.truetype(path, size)`` opens, one per (file,
    size) and process, opened again where the file has changed."""
    key = (path, os.path.getmtime(path), int(size))
    got = FACES.get(key)
    if got is None:
        face = next((f.face for k, f in FACES.items() if k[:2] == key[:2]),
                    None)
        got = FACES[key] = TrueTypeFont(path, key[2], face)
    return got
