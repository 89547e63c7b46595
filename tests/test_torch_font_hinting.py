"""FreeType's hinting and rasterising as ``text/hinting.py`` and
``text/raster.py`` redo them, on the CPU against Pillow 12.1.0 (FreeType
2.14.1).

- Seeded glyph sweeps: in each of the six DejaVu faces of the box, at
  every size from 6 to 72, glyphs of the covered blocks (ASCII, Latin-1,
  Latin Extended-A and -B, Greek, Cyrillic, punctuation and symbols) drawn
  alone: each glyph's coverage, its place and its advance equal to
  Pillow's.
- Every glyph of ``glyphs_dejavu.npz`` (DejaVu Sans and Sans Mono at six
  sizes, baked from Pillow) drawn again equal to the baked coverage and
  advance, as ``chip_smoke.py``'s ``fonts`` phase checks on the card.
- FreeType's fixed-point helpers against exact rational arithmetic; the
  rounding states, ``ISECT`` of parallel lines, ``DELTAP`` after ``IUP``
  in backward-compatibility mode, the rounded F_dot_P of a diagonal move
  and the composite offsets' rounding, each on a hand-built program or
  glyph.
- Every opcode of the six faces' programs has a handler; any other opcode
  raises ``NotImplementedError`` naming item 14 and the opcode.
- Every other opcode the interpreter takes, in synthetic faces built with
  fontTools (``SYNTH_CASES``), and the committed faces with backward
  compatibility switched off, against Pillow bit for bit; a face without
  a font program is refused, as FreeType auto-hints it.
"""

import array
import math
import os
import unicodedata
from fractions import Fraction

import numpy as np
import pytest
from fontTools.fontBuilder import FontBuilder
from fontTools.pens.ttGlyphPen import TTGlyphPen
from fontTools.ttLib import TTFont, newTable
from fontTools.ttLib.tables import ttProgram
from PIL import Image, ImageDraw, ImageFont

from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.objects import entity2d as te2
from ckrenderengine_tpu_torch.text import hinting, raster, sfnt
from ckrenderengine_tpu_torch.text.font import TrueTypeFont

BOX_DIR = "/usr/share/fonts/truetype/dejavu"
BOX_FACES = ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSansMono.ttf",
             "DejaVuSansMono-Bold.ttf", "DejaVuSerif.ttf",
             "DejaVuSerif-Bold.ttf")
BLOCKS = ((0x21, 0x7F), (0xA1, 0x250), (0x370, 0x3D0), (0x400, 0x460),
          (0x2010, 0x2050), (0x2190, 0x21A0), (0x2200, 0x2230))
PEN = 40
# DejaVu Sans and Sans Mono at six sizes, baked from Pillow by
# make_glyph_table.py; the package no longer reads it.
NAMED_GLYPHS = os.path.join(os.path.dirname(te2.__file__),
                            "glyphs_dejavu.npz")


def box_face(name: str) -> str:
    path = os.path.join(BOX_DIR, name)
    if not os.path.isfile(path):
        pytest.skip(f"{path} is not installed")
    return path


def _pillow_glyph(font, ch, w, h):
    img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    ImageDraw.Draw(img).text((PEN, PEN), ch, font=font,
                             fill=(255, 255, 255, 255))
    return np.asarray(img)[..., 3].astype(np.int32)


@pytest.mark.parametrize("name", BOX_FACES)
def test_glyph_sweep_against_pillow(name):
    """Sizes 6 to 72, 14 seeded glyphs of the covered blocks each (marks
    left out, since alone a mark gets a dotted circle, and format
    characters, which the layout refuses)."""
    path = box_face(name)
    f = sfnt.load(path)
    codes = [c for lo, hi in BLOCKS for c in range(lo, hi)
             if c in f.cmap and not chr(c).isspace()
             and unicodedata.category(chr(c))[0] not in "MC"]
    rng = np.random.default_rng(sum(map(ord, name)))
    for size in range(6, 73):
        pf, mf = ImageFont.truetype(path, size), TrueTypeFont(path, size)
        w, h = PEN + 4 * size, PEN + 3 * size
        for c in rng.choice(codes, 14, replace=False):
            ch = chr(int(c))
            ref = _pillow_glyph(pf, ch, w, h)
            got = np.zeros((h, w), np.int32)
            mf.draw(got, ch, PEN, PEN)
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"{size} U+{c:04X}")
            assert mf.getlength(ch) == pf.getlength(ch), (size, c)


@pytest.mark.parametrize("table", sorted(
    te2._glyph_file(NAMED_GLYPHS)))
def test_baked_glyph_tables_redrawn(table):
    t = te2._glyph_file(NAMED_GLYPHS)[table]
    font = te2.font_table(os.path.join(scenes.FONT_DIR, t["meta"]["file"]),
                          int(t["meta"]["size"]))
    pen = 32
    for code, (left, top, adv, cov) in t["glyphs"].items():
        a = np.zeros((4 * pen, 6 * pen), np.int32)
        font.draw(a, chr(code), pen, pen)
        ys, xs = np.nonzero(a)
        if ys.size:
            assert (xs.min() - pen, ys.min() - pen) == (left, top), code
            np.testing.assert_array_equal(
                a[ys.min():ys.max() + 1, xs.min():xs.max() + 1], cov)
        else:
            assert cov.size == 0, code
        assert round(font.getlength(chr(code)) * 64) == adv, code


def _rat_round_away(q: Fraction) -> int:
    """Round half away from zero."""
    n = math.floor(abs(q) + Fraction(1, 2))
    return n if q >= 0 else -n


def test_fixed_point_helpers():
    rng = np.random.default_rng(0)
    for _ in range(3000):
        a, b = (int(v) for v in rng.integers(-2**24, 2**24, 2))
        c = int(rng.integers(1, 2**20)) * int(rng.choice([-1, 1]))
        assert hinting.mul_fix(a, b) == _rat_round_away(Fraction(a * b,
                                                                 65536))
        assert hinting.mul_fix14(a, b) == _rat_round_away(
            Fraction(a * b, 16384))
        assert hinting.mul_div(a, b, c) == _rat_round_away(Fraction(a * b,
                                                                    c))
        assert hinting.div_fix(a, c) == _rat_round_away(Fraction(a * 65536,
                                                                 c))
        x, y = (int(v) for v in rng.integers(-4000, 4000, 2))
        if x or y:
            ux, uy = hinting.vector_norm_len(x, y)
            assert abs(math.hypot(ux, uy) - 65536) <= 2
            assert abs(ux - 65536 * x / math.hypot(x, y)) <= 2
            assert abs(uy - 65536 * y / math.hypot(x, y)) <= 2
    assert hinting.dot_fix14(0x2000, 1, 1, 0) == 1    # 0.5 rounds away
    assert hinting.dot_fix14(-0x2000, 1, 1, 0) == -1
    assert hinting.normalize(0, 0) is None


def _interp(ppem=12):
    face = hinting.Face(sfnt.load(os.path.join(scenes.FONT_DIR,
                                               "DejaVuSans.ttf")))
    return hinting.Interpreter(face.font, ppem, ppem * 2048, {}, {})


def _run(it, code, glyph=False):
    it.run(bytes(code), glyph=glyph)
    return it.stack


def _push(*vals):
    out = []
    for v in vals:
        out += [0xB8, (v >> 8) & 0xFF, v & 0xFF]       # PUSHW[0]
    return out


ROUND_CASES = [-97, -96, -64, -33, -32, -31, -1, 0, 1, 15, 16, 31, 32, 33,
               63, 64, 95, 96, 97, 160]


@pytest.mark.parametrize("op,ref", [
    (0x18, lambda d: (d + 32) // 64 * 64 if d >= 0 else
     -((32 - d) // 64 * 64)),                                       # RTG
    (0x19, lambda d: d // 64 * 64 + 32 if d >= 0 else
     -((-d) // 64 * 64 + 32)),                                      # RTHG
    (0x3D, lambda d: (d + 16) // 32 * 32 if d >= 0 else
     -((16 - d) // 32 * 32)),                                       # RTDG
    (0x7D, lambda d: d // 64 * 64 if d >= 0 else -((-d) // 64 * 64)),  # RDTG
    (0x7C, lambda d: (d + 63) // 64 * 64 if d >= 0 else
     -((63 - d) // 64 * 64)),                                       # RUTG
    (0x7A, lambda d: d),                                            # ROFF
], ids=["RTG", "RTHG", "RTDG", "RDTG", "RUTG", "ROFF"])
def test_round_states(op, ref):
    """ROUND[] under each round state on values around the grid: the
    sign is kept (a rounded value never crosses zero, RTHG goes to the
    nearest half pixel)."""
    it = _interp()
    code = [op]
    for d in ROUND_CASES:
        code += _push(d & 0xFFFF) + [0x68]
    got = _run(it, code)
    assert got == [ref(d) for d in ROUND_CASES]


def test_super_round_and_arithmetic():
    """SROUND with selector 0x4B (period 64, phase 0, threshold (11 - 4) *
    64 / 8 = 56: a distance rounds up from 8/64); DIV and MUL in 26.6 as
    FreeType rounds them."""
    it = _interp()
    got = _run(it, _push(0x4B) + [0x76] + _push(40) + [0x68]
               + _push(5) + [0x68] + _push(-40 & 0xFFFF) + [0x68])
    assert got == [64, 0, -64]
    got = _run(it, _push(100, 64 * 3) + [0x62] + _push(-100 & 0xFFFF, 96)
               + [0x63])
    assert got == [hinting.mul_div_no_round(100, 64, 192),
                   hinting.mul_div(-100, 96, 64)]


def test_isect_of_parallel_lines_takes_the_middle():
    """ISECT of parallel lines puts the point at the mean of the four
    ends (the middle of the middles)."""
    it = _interp()
    z = hinting.Zone(5)
    z.cx = [0, 640, 0, 640, 0]
    z.cy = [0, 0, 128, 128, 999]
    it.twilight = z
    # SZPS 0 (every pointer to the twilight zone); ISECT p=4, a0=0, a1=1,
    # b0=2, b1=3.
    _run(it, _push(0) + [0x16] + _push(4, 0, 1, 2, 3) + [0x0F])
    assert (z.cx[4], z.cy[4]) == ((0 + 640 + 0 + 640) // 4, 64)
    assert z.tags[4] & hinting.TOUCH_BOTH == hinting.TOUCH_BOTH


def test_deltap_after_iup_is_ignored_in_backward_compatibility():
    """In v40's backward-compatibility mode a DELTAP moves a point touched
    in y only before IUP ran on both axes, and never in x."""
    it = _interp(ppem=12)
    z = hinting.Zone(6, [1])
    z.cx = z.ox = [0, 64, 0, 0, 0, 0]
    z.cy = z.oy = [0, 64, 0, 0, 0, 0]
    z.ux, z.uy = z.cx[:], z.cy[:]
    it.pts = z
    # SVTCA[y]; MDAP[] 1 (touch y); DELTAP1 point 1 at ppem 12 (delta base
    # 9: selector (12 - 9) << 4 | step 15 = +8 steps of 1/8 px).
    base = [0x00] + _push(1) + [0x2E]
    delta = _push((3 << 4) | 15, 1, 1) + [0x5D]
    it.run(bytes(base + delta), glyph=True)
    assert z.cy[1] == 64 + 64
    z.cy = [0, 64, 0, 0, 0, 0]
    z.tags = [0] * 6
    it.run(bytes(base + [0x30, 0x31] + delta), glyph=True)   # IUP y, x
    assert z.cy[1] == 64
    z.cy = [0, 64, 0, 0, 0, 0]
    z.tags = [0] * 6
    it.run(bytes([0x01] + _push(1) + [0x2E] + delta), glyph=True)  # x
    assert z.cx[1] == 64


def test_diagonal_move_divides_by_the_rounded_f_dot_p():
    """A move along a freedom vector that is neither axis divides by
    F_dot_P, the dot product of the projection and freedom vectors in
    2.14, rounded as TT_DotFix14 rounds (not floored): DejaVu Sans's
    alpha at 27 px moves two points one 1/64 pixel less otherwise."""
    it = _interp()
    g = it.gs
    g.pvx, g.pvy, g.fvx, g.fvy = 16112, 2970, -5338, -15490
    it._compute_funcs()
    assert it.fdotp == -8057
    path = os.path.join(scenes.FONT_DIR, "DejaVuSans.ttf")
    pf, mf = ImageFont.truetype(path, 27), TrueTypeFont(path, 27)
    for ch in "αᾶἃ⍺":
        ref = _pillow_glyph(pf, ch, PEN + 108, PEN + 81)
        got = np.zeros(ref.shape, np.int32)
        mf.draw(got, ch, PEN, PEN)
        np.testing.assert_array_equal(got, ref, err_msg=ch)


def test_composite_offsets_round_y_only():
    """A composite's ROUND_XY_TO_GRID offset snaps y to the pixel and
    keeps x as scaled (the v40 interpreter hints no x): "é" is "e" and the
    acute moved by the component's offset."""
    path = os.path.join(scenes.FONT_DIR, "DejaVuSans.ttf")
    f = sfnt.load(path)
    size = hinting.Face(f).size(13)
    g = f.glyph(f.cmap[ord("é")])
    acute = g.components[1]
    assert acute.flags & sfnt.ROUND_XY_TO_GRID
    x = hinting.mul_fix(acute.arg1, size.scale)
    y = hinting.pix_round(hinting.mul_fix(acute.arg2, size.scale))
    part = size.glyph(acute.gid)
    whole = size.glyph(f.cmap[ord("é")])
    n = len(whole.xs) - len(part.xs)
    assert whole.xs[n:] == [v + x for v in part.xs]
    assert whole.ys[n:] == [v + y for v in part.ys]


def _opcodes(code) -> set:
    out, ip = set(), 0
    while ip < len(code):
        out.add(code[ip])
        ip += hinting._ins_len(code, ip)
    return out


def test_every_opcode_of_the_faces_has_a_handler():
    """The opcodes of ``fpgm``, ``prep`` and every glyph program of the six
    faces are all executed by the interpreter (a handler or flow control);
    any other opcode raises, naming item 14 and the opcode. Every opcode
    the interpreter takes is one that a face or a case of
    :func:`test_opcode_against_freetype` runs against FreeType: GETDATA,
    which FreeType runs for variable fonts only, is refused."""
    flow = {0x1B, 0x1C, 0x2A, 0x2B, 0x2C, 0x2D, 0x40, 0x41, 0x4F, 0x58,
            0x59, 0x78, 0x79, 0x89} | set(range(0xB0, 0xC0))
    seen = set()
    for name in BOX_FACES:
        path = os.path.join(BOX_DIR, name)
        if not os.path.isfile(path):
            continue
        tt = TTFont(path)
        progs = [tt["fpgm"].program, tt["prep"].program]
        glyf = tt["glyf"]
        progs += [glyf[g].program for g in tt.getGlyphOrder()
                  if hasattr(glyf[g], "program")]
        for p in progs:
            seen |= _opcodes(p.getBytecode())
    assert len(seen) >= 80
    missing = [hex(o) for o in seen
               if hinting._OPS[o] is None and o not in flow]
    assert not missing
    for glyph, prep in SYNTH_CASES.values():
        seen |= _opcodes(bytes(glyph + prep))
    seen |= _opcodes(bytes(CASE_FPGM + NATIVE_PREP))
    taken = {o for o in range(256) if hinting._OPS[o] is not None} | flow
    assert not [hinting.opcode_name(o) for o in taken - seen]
    it = _interp()
    with pytest.raises(NotImplementedError, match="0x28.*item 14"):
        _run(it, [0x28])
    with pytest.raises(NotImplementedError, match="GETDATA.*item 14"):
        _run(it, [0x92])


def test_raster_of_a_square_and_a_conic():
    """The smooth rasteriser on hand-built outlines: a 2.5-pixel square at
    a quarter-pixel offset (full, half and quarter coverage cells) and a
    conic arc's area close to the exact parabola's."""
    sq = hinting.Outline([16, 176, 176, 16], [16, 16, 176, 176],
                         [1, 1, 1, 1], [3])
    left, top, cov = raster.render(sq)
    assert (left, top, cov.shape) == (0, 3, (3, 3))
    # Pixel (1, 1) is covered whole, the edges by 3/4, the corners 9/16.
    assert cov[1, 1] == 255 and cov[0, 1] == 191 and cov[0, 0] == 143
    arc = hinting.Outline([0, 640, 1280], [0, 1280, 0], [1, 0, 1], [2])
    _l, _t, cov = raster.render(arc)
    exact = 2 / 3 * 20 * 10                # parabola area, in pixels
    assert abs(cov.sum() / 255 - exact) < 1.0


# -- synthetic faces: the rest of the instruction set against FreeType -----
#
# A face built here with fontTools holds one glyph "A" (a curved box, points
# 0-4 with the off-curve point 3, and a triangle, points 5-7; the phantom
# points are 8-11) whose program is the case's. Each case is drawn by
# Pillow and by the port at CASE_SIZES in two modes: with v40's backward
# compatibility ("compat") and with it switched off by the prep's INSTCTRL
# selector 3 ("native"), where x moves count too.

CASE_SIZES = (8, 9, 11, 12, 15, 17, 20, 23, 27, 32, 39)
CVT = (100, 200, 300, 700, -300, 1400, 180)
Y, X, MDAP0, MDAP1, SHPIX = [0x00], [0x01], [0x2E], [0x2F], [0x38]


def _pw(*vals):
    """NPUSHW of ``vals``."""
    out = [0x41, len(vals)]
    for v in vals:
        out += [(v >> 8) & 0xFF, v & 0xFF]
    return out


def _touch(*pts):
    """Touch each point in y (SVTCA[y], MDAP[]): in backward-compatibility
    mode only a touched point moves by SHPIX or DELTAP."""
    out = list(Y)
    for p in pts:
        out += _pw(p) + MDAP0
    return out


def _use(pt, unit=16):
    """Shift ``pt`` in y by the stack's top times ``unit`` / 64 pixels."""
    return _pw(unit) + [0x63] + _pw(pt) + [0x23] + SHPIX


def _deltas(op, pt, step):
    """``op`` (a DELTAP or DELTAC) on ``pt`` at each of its 16 ppems."""
    args = []
    for k in range(16):
        args += [(k << 4) | step, pt]
    return _pw(*args) + _pw(16) + [op]


# fpgm: function 1 shifts point 7 by a quarter pixel; IDEF 0x28 by half.
CASE_FPGM = (_pw(1) + [0x2C] + _pw(7, 16) + SHPIX + [0x2D]
             + _pw(0x28) + [0x89] + _pw(7, 32) + SHPIX + [0x2D])
NATIVE_PREP = _pw(4, 3) + [0x8E]
# A prep that leaves delta base 14, delta shift 2, RTHG, minimum distance
# 1.5 px and auto-flip off for the glyph programs (RTHG does not reach
# them: every glyph program starts rounding to the grid).
PREP_STATE = (_pw(14) + [0x5E] + _pw(2) + [0x5F] + [0x19] + _pw(96)
              + [0x1A] + _pw(0) + [0x4E])
STATE_GLYPH = (_touch(2, 7) + _deltas(0x5D, 2, 12) + _pw(0) + MDAP1
               + _pw(4) + [0xCD] + _pw(3) + MDAP1 + _pw(5, 4) + [0xE5])

SYNTH_CASES = {
    # name: (glyph program, prep)
    "rthg": ([0x19] + Y + _pw(2) + MDAP1 + _pw(7) + MDAP1 + X + _pw(2)
             + MDAP1, []),
    "roff": ([0x7A] + Y + _pw(2, 3) + [0x3F] + _pw(7, 5) + [0x3F], []),
    "rutg_rdtg": ([0x7C] + Y + _pw(2) + MDAP1 + [0x7D] + _pw(7) + MDAP1,
                  []),
    "sround": (_pw(0x4B) + [0x76] + Y + _pw(2) + MDAP1 + _pw(3) + MDAP1
               + _pw(0x68) + [0x76] + _pw(7) + MDAP1, []),
    "s45round": (_pw(0x4B) + [0x77] + Y + _pw(2) + MDAP1 + _pw(7) + MDAP1,
                 []),
    "miap_unrounded": (Y + _pw(2, 3) + [0x3E] + _pw(7, 5) + [0x3E], []),
    "md_gc_original": (_touch(7, 2, 3) + _pw(2, 5) + [0x4A] + _use(7)
                       + _pw(3, 0) + [0x49] + _use(2) + _pw(3) + [0x47]
                       + _use(3), []),
    "depth_mindex": (_touch(2, 3, 7) + _pw(10, 20, 30) + [0x24] + _use(2)
                     + _pw(2) + [0x26] + _use(3) + _use(7), []),
    "not_odd_even": (_touch(2, 3, 7) + _pw(0) + [0x5C] + _use(2, 4096)
                     + _pw(64) + [0x56] + _use(3, 4096) + _pw(128) + [0x57]
                     + _use(7, 4096) + _pw(1) + [0x5C] + _use(2, 4096)
                     + _pw(96) + [0x56] + _use(3, 4096) + _pw(160) + [0x57]
                     + _use(7, 4096), []),
    "max_min": (_touch(2, 7) + _pw(30, -50) + [0x8B] + _use(2)
                + _pw(30, -50) + [0x8C] + _use(7), []),
    "ceiling": (_touch(2, 7) + _pw(33) + [0x67] + _use(2) + _pw(-33)
                + [0x67] + _use(7), []),
    "nround_round": (_touch(2, 3, 7) + _pw(37) + [0x6C] + _use(2)
                     + _pw(37) + [0x6A] + _use(3) + _pw(37) + [0x6B]
                     + _use(7) + _pw(5) + [0x6D, 0x6E, 0x6F] + _use(2), []),
    "jrot": (_touch(2, 7) + _pw(8, 1) + [0x78] + _pw(7, 128) + SHPIX
             + _pw(8, 0) + [0x78] + _pw(2, 64) + SHPIX, []),
    "wcvtf": (Y + _pw(6, 500) + [0x70] + _pw(7, 6) + [0x3F], []),
    "deltap123": (_touch(2, 7) + _pw(0) + [0x5E] + _pw(1) + [0x5F]
                  + _deltas(0x5D, 2, 12) + _deltas(0x71, 7, 3)
                  + _deltas(0x72, 2, 13), []),
    "deltac123": (_pw(0) + [0x5E] + _pw(2) + [0x5F] + _deltas(0x73, 3, 12)
                  + _deltas(0x74, 5, 2) + _deltas(0x75, 1, 14) + Y
                  + _pw(2, 3) + [0x3F] + _pw(7, 5) + [0x3F] + _pw(0)
                  + MDAP1 + _pw(4, 1) + [0xED], []),
    "sangw_aa": (_pw(7) + [0x7E] + _pw(7) + [0x7F] + Y + _pw(2) + MDAP1,
                 []),
    "flippt": (_pw(3) + [0x80] + _pw(2, 5, 2) + [0x17, 0x80], []),
    "fliprg": (_pw(0, 3) + [0x82] + _pw(5, 7) + [0x81], []),
    "flip_after_iup": (Y + _pw(2) + MDAP1 + [0x30, 0x31] + _pw(3) + [0x80]
                       + _pw(0, 4) + [0x82], []),
    "flipoff_mirp": ([0x4E] + Y + _pw(0) + MDAP1 + _pw(2, 4) + [0xE5]
                     + [0x4D] + _pw(7, 4) + [0xE5], []),
    "sdpvtl": (Y + _pw(0) + MDAP1 + _pw(3, 6) + [0x86] + _pw(4) + [0xCD]
               + _pw(2) + [0xCC] + _pw(1, 5) + [0x87] + _pw(7) + [0xC4],
               []),
    "getinfo": (_touch(2, 3, 7) + _pw(1) + [0x88] + _use(2) + _pw(64)
                + [0x88] + _pw(0) + [0x55] + _use(3)
                + _pw(1024 + 2048 + 4096) + [0x88] + _pw(0) + [0x55]
                + _use(7) + _pw(2 + 4 + 32 + 128 + 256 + 512) + [0x88]
                + _use(2), []),
    "alignpts": (Y + _pw(2, 7) + [0x27] + X + _pw(0, 6) + [0x27], []),
    "twilight_szp": (_pw(0) + [0x13] + Y + _pw(0, 3) + [0x3F] + _pw(1, 6)
                     + [0x3F] + _pw(0) + [0x10] + _pw(1) + [0x14] + _pw(2)
                     + [0xCD] + _pw(0) + [0x15] + _pw(1, 64) + SHPIX
                     + _pw(1) + [0x16] + _pw(7) + MDAP1, []),
    "ssw_sswci": (_pw(150) + [0x1F] + _pw(64) + [0x1E] + Y + _pw(0)
                  + MDAP1 + _pw(4, 6) + [0xE5] + _pw(7, 6) + [0xED], []),
    "smd_mdrp": (_pw(96) + [0x1A] + Y + _pw(0) + MDAP1 + _pw(4) + [0xCD]
                 + _pw(2) + [0xC9], []),
    "loopcall": (_touch(7) + _pw(3, 1) + [0x2A], []),
    "idef": (_touch(7) + [0x28], []),
    "debug_stops": (_touch(2, 7) + _pw(2, 64) + SHPIX + [0x4F] + _pw(7, 64)
                    + SHPIX, []),
    "shpix_after_iup": (_touch(2, 7) + [0x30, 0x31] + _pw(2, 64) + SHPIX
                        + _pw((3 << 4) | 12, 2, 1) + [0x5D], []),
    "prep_state": (STATE_GLYPH, PREP_STATE),
    "instctrl_default_state": (STATE_GLYPH,
                               PREP_STATE + _pw(2, 2) + [0x8E]),
    "instctrl_no_glyph_programs": (STATE_GLYPH, _pw(1, 1) + [0x8E]),
}
for _v in range(0xC0, 0xE0):
    SYNTH_CASES[f"mdrp_{_v:02x}"] = (
        Y + _pw(0) + MDAP1 + _pw(4) + [_v] + _pw(2) + [_v] + _pw(3) + [_v]
        + X + _pw(0) + MDAP1 + _pw(1) + [_v] + _pw(6) + [_v], [])
for _v in range(0xE0, 0x100):
    SYNTH_CASES[f"mirp_{_v:02x}"] = (
        Y + _pw(0) + MDAP1 + _pw(4, 3) + [_v] + _pw(2, 1) + [_v]
        + _pw(7, 5) + [_v] + _pw(3, 4) + [_v] + X + _pw(0) + MDAP1
        + _pw(1, 2) + [_v] + _pw(6, 6) + [_v], [])


def _program(code) -> ttProgram.Program:
    p = ttProgram.Program()
    p.fromBytecode(bytes(code))
    return p


def _synthetic_face(path, glyph, prep, fpgm=CASE_FPGM) -> str:
    fb = FontBuilder(2048, isTTF=True)
    fb.setupGlyphOrder([".notdef", "A"])
    fb.setupCharacterMap({0x41: "A"})
    pen = TTGlyphPen(None)
    pen.moveTo((100, 0))
    pen.lineTo((700, 0))
    pen.lineTo((700, 900))
    pen.qCurveTo((400, 1300), (100, 900))
    pen.closePath()
    pen.moveTo((900, 0))
    pen.lineTo((1300, 0))
    pen.lineTo((1100, 1400))
    pen.closePath()
    a = pen.glyph()
    a.program = _program(glyph)
    fb.setupGlyf({".notdef": TTGlyphPen(None).glyph(), "A": a})
    fb.setupHorizontalMetrics({".notdef": (1000, 0), "A": (1500, 100)})
    fb.setupHorizontalHeader(ascent=1900, descent=-500)
    fb.setupOS2(sTypoAscender=1556, sTypoDescender=-492, usWinAscent=1901,
                usWinDescent=483)
    fb.setupNameTable({"familyName": "Case", "styleName": "Regular"})
    fb.setupPost()
    fb.setupMaxp()
    f = fb.font
    f["head"].flags |= 0x1F
    m = f["maxp"]
    m.maxZones, m.maxTwilightPoints, m.maxStorage = 2, 4, 16
    m.maxFunctionDefs, m.maxInstructionDefs = 16, 4
    m.maxStackElements = 64
    m.maxSizeOfInstructions = max(len(glyph), 1)
    cvt = newTable("cvt ")
    cvt.values = array.array("h", CVT)
    f["cvt "] = cvt
    for tag, code in (("fpgm", fpgm), ("prep", prep)):
        t = newTable(tag)
        t.program = _program(code)
        f[tag] = t
    f.save(str(path))
    return str(path)


def _draws(path, sizes):
    """[(Pillow's coverage, the port's coverage, Pillow's and the port's
    advance)] of "A" at each size."""
    out = []
    for size in sizes:
        pf, mf = ImageFont.truetype(path, size), TrueTypeFont(path, size)
        w = h = PEN + 3 * size
        ref = _pillow_glyph(pf, "A", w, h)
        got = np.zeros((h, w), np.int32)
        mf.draw(got, "A", PEN, PEN)
        out.append((ref, got, pf.getlength("A"), mf.getlength("A")))
    return out


@pytest.mark.parametrize("case", sorted(SYNTH_CASES))
def test_opcode_against_freetype(case, tmp_path):
    """Each case's glyph program (and prep) in a synthetic face, with
    backward compatibility on and off: the port's coverage and advance
    equal to Pillow's at every size, and the program visibly changes
    Pillow's glyph in at least one mode (INSTCTRL selector 1 must leave it
    as if the glyph had no program)."""
    glyph, prep = SYNTH_CASES[case]
    changed = False
    for mode, head in (("compat", _pw(0) + [0x21]), ("native", NATIVE_PREP)):
        path = _synthetic_face(tmp_path / f"{mode}.ttf", glyph, head + prep)
        bare = _synthetic_face(tmp_path / f"{mode}_bare.ttf", [], head)
        draws = _draws(path, CASE_SIZES)
        for size, (ref, got, pl, ml) in zip(CASE_SIZES, draws):
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"{mode} size {size}")
            assert ml == pl, (mode, size)
        bare_refs = [d[0] for d in _draws(bare, CASE_SIZES)]
        changed |= any(not np.array_equal(d[0], b)
                       for d, b in zip(draws, bare_refs))
    assert changed != (case == "instctrl_no_glyph_programs")


@pytest.mark.parametrize("name", ("DejaVuSans.ttf", "DejaVuSansMono.ttf",
                                  "DejaVuSerif-Bold.ttf"))
def test_backward_compatibility_off_against_pillow(name, tmp_path):
    """The committed faces with INSTCTRL selector 3 put before their prep:
    every glyph program runs with x moves, the composites' offsets snap in
    x and the vertical phantom points stand at half the advance. Seeded
    glyphs of the covered blocks at sizes 6 to 48, each equal to
    Pillow's."""
    tt = TTFont(os.path.join(scenes.FONT_DIR, name))
    tt["prep"].program = _program(
        bytes(NATIVE_PREP) + tt["prep"].program.getBytecode())
    path = str(tmp_path / name)
    tt.save(path)
    cmap = tt.getBestCmap()
    codes = [c for lo, hi in BLOCKS[:4] for c in range(lo, hi)
             if c in cmap and not chr(c).isspace()
             and unicodedata.category(chr(c))[0] not in "MC"]
    rng = np.random.default_rng(sum(map(ord, name)) + 3)
    for size in range(6, 49, 3):
        pf, mf = ImageFont.truetype(path, size), TrueTypeFont(path, size)
        w, h = PEN + 4 * size, PEN + 3 * size
        for c in rng.choice(codes, 25, replace=False):
            ch = chr(int(c))
            got = np.zeros((h, w), np.int32)
            mf.draw(got, ch, PEN, PEN)
            np.testing.assert_array_equal(got, _pillow_glyph(pf, ch, w, h),
                                          err_msg=f"{size} U+{c:04X}")
            assert mf.getlength(ch) == pf.getlength(ch), (size, c)


def test_fonts_without_a_font_program_are_refused(tmp_path):
    """FreeType hands a face with an empty ``fpgm`` to its auto-hinter:
    Pillow's glyph is the same whatever its program does. The port refuses
    such a face under item 14."""
    glyph = Y + _pw(3) + MDAP1 + _pw(7) + MDAP1
    path = _synthetic_face(tmp_path / "a.ttf", glyph, _pw(0) + [0x21], [])
    bare = _synthetic_face(tmp_path / "b.ttf", [], _pw(0) + [0x21], [])
    for size in (12, 20, 33):
        pf, pb = ImageFont.truetype(path, size), ImageFont.truetype(bare, size)
        w = PEN + 3 * size
        np.testing.assert_array_equal(_pillow_glyph(pf, "A", w, w),
                                      _pillow_glyph(pb, "A", w, w))
    with pytest.raises(NotImplementedError, match="auto-hinter.*item 14"):
        TrueTypeFont(path, 12)
