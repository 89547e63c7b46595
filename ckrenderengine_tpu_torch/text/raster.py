"""FreeType's anti-aliased "smooth" rasteriser (``ftgrays``) over a hinted
26.6 outline.

Cells of 1/256 pixel (``PIXEL_BITS`` 8) gather cover and area along each
line; conic arcs are drawn by forward differencing as a power-of-two
count of lines that ``ftgrays`` derives from the arc's deviation; the
sweep turns each row's running cover and cell areas into 8-bit coverage
under the non-zero winding rule, clamped at 255. The bitmap's box is the
outline's control box floored and ceiled to whole pixels. Every division
is the one ``ftgrays`` makes on a 64-bit build (reciprocal multiplication
for the cell walk), and implicit on-curve points are halved as FreeType
halves them on the outline it has moved into the bitmap's frame, so the
coverage is FreeType's byte for byte. TrueType outlines hold conic arcs
only; cubic arcs (CFF) never reach this module.
"""

from __future__ import annotations

import numpy as np

PIXEL_BITS = 8
ONE_PIXEL = 1 << PIXEL_BITS
_RECIP_NUM = 0xFFFFFFFFFFFFFFFF >> PIXEL_BITS
_MASK64 = 0xFFFFFFFFFFFFFFFF
_UDIV_SHIFT = 64 - PIXEL_BITS


def _udiv(a: int, r: int) -> int:
    """FT_UDIV: a / b through the reciprocal r = (2^56 - 1) // b."""
    return ((a * r) & _MASK64) >> _UDIV_SHIFT


def _recip(b: int) -> int:
    """FT_UDIVPREP: the reciprocal of |b| that FT_UDIV multiplies by."""
    return _RECIP_NUM // abs(b)


class _Cells:
    """The cell store of one raster: {(ey, ex): [cover, area]}."""

    __slots__ = ("cells", "x", "y", "ex", "ey", "cover", "area")

    def __init__(self):
        self.cells = {}
        self.x = self.y = 0
        self.ex = self.ey = 0
        self.cover = self.area = 0

    def set_cell(self, ex, ey):
        if self.cover or self.area:
            key = (self.ey, self.ex)
            c = self.cells.get(key)
            if c is None:
                self.cells[key] = [self.cover, self.area]
            else:
                c[0] += self.cover
                c[1] += self.area
        self.ex, self.ey = ex, ey
        self.cover = self.area = 0

    def move_to(self, x, y):
        x <<= PIXEL_BITS - 6
        y <<= PIXEL_BITS - 6
        self.set_cell(x >> PIXEL_BITS, y >> PIXEL_BITS)
        self.x, self.y = x, y

    def line_to(self, x, y):
        self.render_line(x << (PIXEL_BITS - 6), y << (PIXEL_BITS - 6))

    def render_line(self, to_x, to_y):
        """gray_render_line (64-bit build)."""
        x0, y0 = self.x, self.y
        ey1 = y0 >> PIXEL_BITS
        ey2 = to_y >> PIXEL_BITS
        ex1 = x0 >> PIXEL_BITS
        ex2 = to_x >> PIXEL_BITS
        fx1 = x0 & 255
        fy1 = y0 & 255
        dx = to_x - x0
        dy = to_y - y0
        if ex1 == ex2 and ey1 == ey2:
            pass
        elif dy == 0:
            self.set_cell(ex2, ey2)
            self.x, self.y = to_x, to_y
            return
        elif dx == 0:
            if dy > 0:
                while True:
                    self.cover += ONE_PIXEL - fy1
                    self.area += (ONE_PIXEL - fy1) * fx1 * 2
                    fy1 = 0
                    ey1 += 1
                    self.set_cell(ex1, ey1)
                    if ey1 == ey2:
                        break
            else:
                while True:
                    self.cover -= fy1
                    self.area -= fy1 * fx1 * 2
                    fy1 = ONE_PIXEL
                    ey1 -= 1
                    self.set_cell(ex1, ey1)
                    if ey1 == ey2:
                        break
        else:
            prod = dx * fy1 - dy * fx1
            rx = _recip(dx) if ex1 != ex2 else 0
            ry = _recip(dy) if ey1 != ey2 else 0
            dxp = dx * ONE_PIXEL
            dyp = dy * ONE_PIXEL
            while True:
                if prod - dxp > 0 and prod <= 0:                    # left
                    fx2 = 0
                    fy2 = _udiv(-prod, rx)
                    prod -= dyp
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = ONE_PIXEL
                    fy1 = fy2
                    ex1 -= 1
                elif prod - dxp + dyp > 0 and prod - dxp <= 0:      # up
                    prod -= dxp
                    fx2 = _udiv(-prod, ry)
                    fy2 = ONE_PIXEL
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = fx2
                    fy1 = 0
                    ey1 += 1
                elif prod + dyp >= 0 and prod - dxp + dyp <= 0:     # right
                    prod += dyp
                    fx2 = ONE_PIXEL
                    fy2 = _udiv(prod, rx)
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = 0
                    fy1 = fy2
                    ex1 += 1
                else:                                               # down
                    fy2 = 0
                    fx2 = _udiv(prod, ry)
                    prod += dxp
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = fx2
                    fy1 = ONE_PIXEL
                    ey1 -= 1
                self.set_cell(ex1, ey1)
                if ex1 == ex2 and ey1 == ey2:
                    break
        fx2 = to_x & 255
        fy2 = to_y & 255
        self.cover += fy2 - fy1
        self.area += (fy2 - fy1) * (fx1 + fx2)
        self.x, self.y = to_x, to_y

    def conic_to(self, cx, cy, x, y):
        """gray_render_conic: forward differencing over 2^shift segments,
        shift from the arc's deviation (each halving of the step divides
        it by four)."""
        s = PIXEL_BITS - 6
        p0x, p0y = self.x, self.y
        p1x, p1y = cx << s, cy << s
        p2x, p2y = x << s, y << s
        bx, by = p1x - p0x, p1y - p0y
        ax, ay = p2x - p1x - bx, p2y - p1y - by
        d = max(abs(ax), abs(ay))
        if d <= ONE_PIXEL // 4:
            self.render_line(p2x, p2y)
            return
        shift = 0
        while True:
            d >>= 2
            shift += 1
            if d <= ONE_PIXEL // 4:
                break
        rx = ax << (33 - 2 * shift)
        ry = ay << (33 - 2 * shift)
        qx = (bx << (33 - shift)) + (ax << (32 - 2 * shift))
        qy = (by << (33 - shift)) + (ay << (32 - 2 * shift))
        px, py = p0x << 32, p0y << 32
        line = self.render_line
        for _ in range(1 << shift):
            px += qx
            py += qy
            qx += rx
            qy += ry
            line(px >> 32, py >> 32)


def _mid(v: int) -> int:
    """Half of a sum of coordinates, as FreeType takes it on the outline
    it has moved into the bitmap's non-negative frame (a floor)."""
    return v >> 1


def decompose(outline, cells: _Cells):
    """FT_Outline_Decompose of a TrueType outline (on-curve points and
    conic control points) into the cell store."""
    xs, ys, on, ends = outline.xs, outline.ys, outline.on, outline.ends
    first = 0
    for last in ends:
        sx, sy = xs[first], ys[first]
        lx, ly = xs[last], ys[last]
        i = first
        limit = last
        if not on[first]:
            if on[last]:
                sx, sy = lx, ly
                limit = last - 1
            else:
                sx, sy = _mid(sx + lx), _mid(sy + ly)
            i -= 1
        cells.move_to(sx, sy)
        closed = False
        while i < limit:
            i += 1
            if on[i]:
                cells.line_to(xs[i], ys[i])
                continue
            vcx, vcy = xs[i], ys[i]
            while True:
                if i < limit:
                    i += 1
                    vx, vy = xs[i], ys[i]
                    if on[i]:
                        cells.conic_to(vcx, vcy, vx, vy)
                        break
                    mx, my = _mid(vcx + vx), _mid(vcy + vy)
                    cells.conic_to(vcx, vcy, mx, my)
                    vcx, vcy = vx, vy
                    continue
                cells.conic_to(vcx, vcy, sx, sy)
                closed = True
                break
            if closed:
                break
        if not closed:
            cells.line_to(sx, sy)
        first = last + 1


def bitmap_box(outline) -> tuple[int, int, int, int]:
    """(left, top, width, rows) of the glyph's bitmap in whole pixels, y
    up (ft_glyphslot_preset_bitmap for the normal render mode)."""
    if not outline.xs:
        return 0, 0, 0, 0
    x0, y0, x1, y1 = outline.cbox()
    left, bottom = x0 >> 6, y0 >> 6
    right, top = (x1 + 63) >> 6, (y1 + 63) >> 6
    return left, top, right - left, top - bottom


def render(outline) -> tuple[int, int, np.ndarray]:
    """(bitmap_left, bitmap_top, coverage (rows, width) uint8): the glyph
    as ``FT_Render_Glyph`` draws it in the normal (8-bit) mode."""
    left, top, w, h = bitmap_box(outline)
    out = np.zeros((h, w), np.uint8)
    if not w or not h:
        return left, top, out
    cells = _Cells()
    decompose(outline, cells)
    cells.set_cell(0, 0)
    rows: dict = {}
    for (ey, ex), (cover, area) in cells.cells.items():
        rows.setdefault(ey, []).append((ex, cover, area))
    bottom = top - h
    for ey, row in rows.items():
        if not bottom <= ey < top:
            continue
        line = out[top - 1 - ey]
        row.sort()
        cover = 0
        x = left
        for ex, c, a in row:
            if ex >= left + w:
                break
            if cover and ex > x:
                v = _fill(cover)
                line[max(x, left) - left:ex - left] = v
            cover += c * (ONE_PIXEL * 2)
            area = cover - a
            if area and ex >= left:
                line[ex - left] = _fill(area)
            x = ex + 1
        if cover and x < left + w:
            line[max(x, left) - left:] = _fill(cover)
    return left, top, out


def _fill(area: int) -> int:
    """FT_FILL_RULE for the non-zero winding rule."""
    c = area >> (PIXEL_BITS * 2 + 1 - 8)
    if c < 0:
        c = ~c
    return 255 if c > 255 else c
