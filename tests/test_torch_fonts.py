"""TrueType text (``ckrenderengine_tpu_torch/text/``) on the CPU, against
fontTools, Pillow 12.1.0 (FreeType 2.14.1, Raqm 0.10.3) and the reference
package.

- ``text/sfnt.py`` against fontTools on the six DejaVu faces of the box:
  the cmap FreeType picks, the fixed tables and metrics, every glyph's
  points, on-curve flags, contour ends, program and components, the
  CVT, ``fpgm``, ``prep`` and ``gasp``, and every GSUB and GPOS lookup's
  type, flag and subtable count.
- Layout, hinting and rasterising together against Pillow: seeded strings
  (ligatures, kerning pairs, Latin-1, Greek, Cyrillic, combining marks,
  two lines) in each face at sizes 6 to 72, their length, text box and
  coverage equal bit for bit.
- ``CKSpriteText.Redraw()`` in the committed faces against the
  reference's on the overlay tests' strings and on ligature, kerning,
  Greek and Cyrillic strings, over sizes, alignments and colour pairs.
- ``tests/torch_fonts/expected.npz`` against Pillow and the port.
- The refusals of item 14: CFF outlines (``.otf``), collections, variable
  fonts, right-to-left scripts other than Arabic and Hebrew and a script
  that needs a shaper.
- ``scenes.build_config5_text`` cut to 256x192 through both packages
  (``render_both`` / ``check_render``), each label's texture equal.
"""

import os
import struct

import numpy as np
import pytest
from fontTools.ttLib import TTFont
from PIL import Image, ImageDraw, ImageFont

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.objects import entity2d as te2
from ckrenderengine_tpu_torch.text import sfnt
from ckrenderengine_tpu_torch.text.font import TrueTypeFont
from tests._torch_common import check_render, render_both
from tests.torch_fonts.make_fonts import COLORS, pillow_raster

BOX_DIR = "/usr/share/fonts/truetype/dejavu"
BOX_FACES = ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSansMono.ttf",
             "DejaVuSansMono-Bold.ttf", "DejaVuSerif.ttf",
             "DejaVuSerif-Bold.ttf")
POOLS = (
    "AVATAWAYTaTeToVaVeVoWaYaYoLTLVLYPAFAfi fl ffi ffl office flow .,;:!?-"
    "–—'\"()[]{} 0123456789",
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ ",
    "ΑΒΓΔΕΖΗΘΙΚΛΜΝΞΟΠΡΣΤΥΦΧΨΩαβγδεζηθικλμνξοπρστυφχψωάέήίόύώ ",
    "АБВГДЕЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬЭЮЯабвгдежзийклмнопрстуфхцчшщъыьэюяёЁ ",
    "àáâãäåæçèéêëìíîïñòóôõöøùúûüýÿÀÁÂÃÄÅÆÇÈÉÊËÌÍÎÏÑÒÓÔÕÖØÙÚÛÜÝßœŒšŠžŽ€£¥©®"
    "°±²³µ¶·¹º»«¿¡",
    "ae q x n i j AV ̣́̃̈̇",
    "ab\ncd fi\n\nAV")


def box_face(name: str) -> str:
    path = os.path.join(BOX_DIR, name)
    if not os.path.isfile(path):
        pytest.skip(f"{path} is not installed")
    return path


def _strings(rng, n: int) -> list:
    out = []
    for k in range(n):
        pool = POOLS[k % len(POOLS)]
        out.append("".join(rng.choice(list(pool),
                                      int(rng.integers(1, 14)))))
    return out


@pytest.mark.parametrize("name", BOX_FACES)
def test_sfnt_against_fonttools(name):
    path = box_face(name)
    tt = TTFont(path)
    f = sfnt.Font(open(path, "rb").read(), path)
    order = tt.getGlyphOrder()
    gid = {g: i for i, g in enumerate(order)}
    assert f.cmap == {c: gid[g] for c, g in tt.getBestCmap().items()}
    head, hhea, maxp = tt["head"], tt["hhea"], tt["maxp"]
    assert (f.units_per_em, f.flags, f.loca_long) == (
        head.unitsPerEm, head.flags, head.indexToLocFormat == 1)
    assert (f.hhea_ascender, f.hhea_descender, f.hhea_line_gap) == (
        hhea.ascent, hhea.descent, hhea.lineGap)
    assert (f.num_glyphs, f.max_twilight, f.max_storage, f.max_fdefs,
            f.max_stack) == (maxp.numGlyphs, maxp.maxTwilightPoints,
                             maxp.maxStorage, maxp.maxFunctionDefs,
                             maxp.maxStackElements)
    os2 = tt["OS/2"]
    assert f.os2["typo_ascender"] == os2.sTypoAscender
    assert f.os2["win_descent"] == os2.usWinDescent
    hmtx = tt["hmtx"]
    assert [(int(a), int(b)) for a, b in zip(f.advances, f.lsbs)] == [
        tuple(hmtx[g]) for g in order]
    assert f.cvt.tolist() == list(tt["cvt "].values)
    assert f.fpgm == tt["fpgm"].program.getBytecode()
    assert f.prep == tt["prep"].program.getBytecode()
    assert f.gasp == sorted(tt["gasp"].gaspRange.items())
    glyf = tt["glyf"]
    for i, g in enumerate(order):
        tg = glyf[g]
        mine = f.glyph(i)
        if tg.numberOfContours == 0:
            assert mine is None
        elif tg.numberOfContours > 0:
            coords = np.array(tg.coordinates, np.int64).reshape(-1, 2)
            assert mine.xs.tolist() == coords[:, 0].tolist(), g
            assert mine.ys.tolist() == coords[:, 1].tolist(), g
            assert mine.on.tolist() == [v & 1 for v in tg.flags], g
            assert mine.ends.tolist() == list(tg.endPtsOfContours), g
            prog = tg.program.getBytecode() if hasattr(tg, "program") \
                else b""
            assert mine.program == prog, g
        else:
            assert [c.gid for c in mine.components] == [
                gid[c.glyphName] for c in tg.components], g
            for c, tc in zip(mine.components, tg.components):
                # The bits fontTools keeps of a component's flags.
                kept = 0x0004 | 0x0200 | 0x0400 | 0x0800 | 0x1000
                assert c.flags & kept == tc.flags & kept, g
                if c.flags & sfnt.ARGS_ARE_XY_VALUES:
                    assert (c.arg1, c.arg2) == (tc.x, tc.y), g
                else:
                    assert (c.arg1, c.arg2) == (tc.firstPt, tc.secondPt), g
                if hasattr(tc, "transform"):
                    (xx, xy), (yx, yy) = tc.transform
                    assert (c.xx, c.yx, c.xy, c.yy) == tuple(
                        round(v * 16384) * 4 for v in (xx, xy, yx, yy)), g
            prog = tg.program.getBytecode() if hasattr(tg, "program") \
                else b""
            assert mine.program == prog, g
    for tag in ("GSUB", "GPOS"):
        from ckrenderengine_tpu_torch.text import shaping
        mine = shaping._tables(f, tag)
        lookups = tt[tag].table.LookupList.Lookup
        assert len(mine.lookups) == len(lookups)
        for lk, tl in zip(mine.lookups, lookups):
            t = tl.LookupType
            if t in (7, 9) and tl.SubTable:
                t = tl.SubTable[0].ExtensionLookupType
            assert (lk.type, lk.flag, len(lk.subtables)) == (
                t, tl.LookupFlag, len(tl.SubTable))
        feats = tt[tag].table.FeatureList.FeatureRecord
        assert [t for t, _l in mine.features] == [r.FeatureTag
                                                  for r in feats]
        assert [lks for _t, lks in mine.features] == [
            list(r.Feature.LookupListIndex) for r in feats]


@pytest.mark.parametrize("name", BOX_FACES)
def test_layout_and_raster_against_pillow(name):
    path = box_face(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    sizes = sorted({6, 72} | set(rng.choice(np.arange(7, 72), 10,
                                            replace=False).tolist()))
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    for size in sizes:
        pf, mf = ImageFont.truetype(path, size), TrueTypeFont(path, size)
        for s in _strings(rng, 14):
            lines = s.split("\n")
            assert [mf.getlength(ln) for ln in lines] == [
                pf.getlength(ln) for ln in lines], (size, s)
            assert te2.text_bbox(s, mf) == tuple(
                probe.textbbox((0, 0), s, font=pf)), (size, s)
            w = int(max(pf.getlength(ln) for ln in lines)) + 2 * size + 8
            h = (size * 2 + 8) * len(lines) + 8
            img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
            ImageDraw.Draw(img).text((size, 4), s, font=pf,
                                     fill=(255, 255, 255, 255))
            got = te2.raster_text(s, w, h, (255, 255, 255, 255),
                                  (0, 0, 0, 0), size, mf, y=4)
            np.testing.assert_array_equal(got, np.asarray(img),
                                          err_msg=f"{size} {s!r}")


EXTRA = ["office flow", "AV To Ya WAVE", "Ελληνικά: Γειά σου", "Привет, мир!",
         "fi fl ffi\nAVA ToYa", "naïve café — Ærø ½"]


def _sprite(M, ctx, text, align, fg, bg, size, face, px):
    s = M.CKSpriteText(ctx, "t")
    s.Create(*size)
    s.SetText(text)
    s.SetAlign(align)
    s.SetTextColor(fg)
    s.SetBackgroundTextColor(bg)
    s.SetFont(os.path.join(scenes.FONT_DIR, face), px)
    return s


@pytest.mark.parametrize("align", [0, 1, 2], ids=["left", "center", "right"])
def test_sprite_text_equals_the_reference(align):
    """Bit-equal images (0..255 / 255) in the committed faces on the
    overlay tests' strings and on ligature, kerning, Greek and Cyrillic
    strings, at several sizes and sprite sizes, every colour pair."""
    from tests.test_torch_overlay import TEXTS

    cj, ct = J.CKContext(), O.CKContext(device="cpu")
    rng = np.random.default_rng(align)
    for k, text in enumerate(TEXTS + EXTRA):
        face = scenes.FONT_FILES[(k + align) % 3]
        px = int(rng.choice([9, 11, 13, 17, 22, 31]))
        size = (int(rng.integers(60, 260)), int(rng.integers(14, 70)))
        fg, bg = COLORS[k % 3]
        ij = _sprite(J, cj, text, align, fg, bg, size, face, px).Redraw()
        it = _sprite(O, ct, text, align, fg, bg, size, face, px).Redraw()
        np.testing.assert_array_equal(it.GetImage(), ij.GetImage(),
                                      err_msg=f"{face} {px} {text!r}")


def test_expected_npz_equals_pillow_and_the_port():
    """Every 7th sweep raster of ``expected.npz`` made again by Pillow,
    and every one drawn by the port: equal, text boxes too; the fixture
    faces are the files whose SHA-256 it records."""
    import hashlib

    e = np.load(os.path.join(scenes.FONT_DIR, "expected.npz"))
    for face, sha in zip(e["faces"], e["sha256"]):
        with open(os.path.join(scenes.FONT_DIR, str(face)), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == str(sha)
    for i in range(len(e["sweep_face"])):
        path = os.path.join(scenes.FONT_DIR,
                            str(e["faces"][e["sweep_face"][i]]))
        size, text = int(e["sweep_size"][i]), str(e["sweep_text"][i])
        w, h = (int(v) for v in e["sweep_wh"][i])
        args = (size, text, w, h, int(e["sweep_align"][i]),
                e["sweep_fg"][i], e["sweep_bg"][i])
        if i % 7 == 0:
            np.testing.assert_array_equal(pillow_raster(path, *args),
                                          e[f"sweep:{i}"])
        font = te2.font_table(path, size)
        box = te2.text_bbox(text, font)
        assert box == tuple(e["sweep_bbox"][i].tolist())
        x = {0: 0, 1: (w - box[2] + box[0]) // 2,
             2: w - box[2] + box[0]}[args[4]]
        got = te2.raster_text(text, w, h,
                              tuple(int(c * 255) for c in args[5]),
                              tuple(int(c * 255) for c in args[6]), x, font)
        np.testing.assert_array_equal(got, e[f"sweep:{i}"],
                                      err_msg=f"{path} {size} {text!r}")


def _fake_sfnt(tmp_path, name, tag, tables=()):
    """A file with an sfnt header of ``tag`` and empty ``tables``."""
    data = bytearray(tag + struct.pack(">HHHH", len(tables), 0, 0, 0))
    for t in tables:
        data += t.encode() + struct.pack(">III", 0, 0, 0)
    path = tmp_path / name
    path.write_bytes(bytes(data) + b"\0" * 64)
    return str(path)


def test_refusals_name_item_14(tmp_path):
    """What the TrueType stack does not take raises NotImplementedError
    naming item 14 and the feature: CFF outlines, a collection, a
    variable font, right-to-left text in a script other than Arabic and
    Hebrew (N'Ko, Syriac) and a script that needs a shaper."""
    ct = O.CKContext(device="cpu")
    cases = ((_fake_sfnt(tmp_path, "cff.otf", b"OTTO"), "CFF"),
             (_fake_sfnt(tmp_path, "pair.ttc", b"ttcf"), "collection"),
             (_fake_sfnt(tmp_path, "var.ttf", b"\0\1\0\0", ("fvar",)),
              "variable font"))
    for path, what in cases:
        s = _sprite(O, ct, "abc", 0, *COLORS[0], (64, 20), "x", 12)
        s.SetFont(path, 12)
        with pytest.raises(NotImplementedError, match=f"{what}.*item 14"):
            s.Redraw()
    face = os.path.join(scenes.FONT_DIR, "DejaVuSans.ttf")
    for text, what in (("ߒߞߏ", "right-to-left"), ("abc ܫܠܡܐ", "right"),
                       ("ภาษาไทย", "shaper")):
        s = _sprite(O, ct, text, 0, *COLORS[0], (64, 20), "x", 12)
        s.SetFont(face, 12)
        with pytest.raises(NotImplementedError, match=f"{what}.*item 14"):
            s.Redraw()


CUT = dict(terrain_n=24, n_balls=4)


def _level(P, **kw):
    ctx, rc, spinner, _tick = scenes.build_config5_text(P, **CUT, **kw)
    return ctx, rc, spinner


def test_text_level_matches_the_reference():
    """``build_config5_text`` cut to 256x192 (the labels at their own
    sizes, the frame cut): every label's texture equal to the reference's,
    and the frame through ``check_render``."""
    pair = render_both(_level, accelerator=False, width=256, height=192)
    rj, rt = pair[0], pair[1]
    for row in scenes.TEXT_HUD:
        np.testing.assert_array_equal(
            rt.context.GetObjectByName(row[0]).GetImage(),
            rj.context.GetObjectByName(row[0]).GetImage(), err_msg=row[0])
    check_render(pair)
