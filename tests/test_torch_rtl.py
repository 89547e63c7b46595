"""Right-to-left and bidirectional text (``ckrenderengine_tpu_torch/text/``:
``ucd.py``, ``bidi.py``, ``arabic.py`` and ``shaping.py``) on the CPU,
against fontTools, Python's ``unicodedata``, Pillow 12.1.0 (Raqm 0.10.3,
fribidi 1.0.8, HarfBuzz 12.3.0) and the reference package.

- ``ucd.py``'s tables: scripts against ``fontTools.unicodedata.script``,
  mirrors against ``fontTools.unicodedata.Mirrored``, bidi classes
  against ``unicodedata.bidirectional``, joining types against the Arabic
  presentation forms, paired brackets against the mirrors.
- Raqm's run order (``visual_runs``) on level patterns.
- Rasters and text boxes equal byte for byte to the reference
  ``CKSpriteText``'s (``make_fonts.pillow_raster`` draws as it draws, and
  the alignment cases go through the reference's own object): every
  Arabic letter in each joining context, mark permutations, marks of one
  script after a letter of another or alone, variation selectors, a ZWJ
  that keeps a mark off its base or a pair from a ligature, a ZWJ
  pictograph kept in its grapheme, the normaliser's primary composition
  and CGJ (left-to-right strings the parent laid out wrongly), lam-alef
  with
  and without marks, ZWJ, ZWNJ and tatweel, both kinds of digits, bracket
  pairs and mirrored characters, every bidi control, mixed paragraphs of
  both directions and two-line labels, the three alignments, in DejaVu
  Sans and Sans Mono at several sizes.
- The refusals of item 14 the slice keeps.
- ``expected.npz``'s right-to-left sweep and HUD rasters.
- ``scenes.build_config5_text(rtl=True)`` cut to 256x192 through both
  packages, each label's texture equal.
"""

import itertools
import os
import unicodedata

import numpy as np
import pytest
from fontTools import unicodedata as fu
from fontTools.unicodedata import Mirrored
from PIL import Image, ImageDraw, ImageFont

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.objects import entity2d as te2
from ckrenderengine_tpu_torch.text import shaping, ucd
from tests._torch_common import check_render, render_both
from tests.torch_fonts.make_fonts import COLORS, pillow_raster

SANS, MONO = "DejaVuSans.ttf", "DejaVuSansMono.ttf"
AR_MARKS = "ًٌٍَُِّْٓ"
HE_MARKS = "ְִַָּׁׂ"
PROBE = ImageDraw.Draw(Image.new("RGBA", (1, 1)))


def _path(face):
    return os.path.join(scenes.FONT_DIR, face)


def _covered():
    """Every assigned code point of the blocks ucd.py lays out."""
    for lo, hi in ucd._COMMON_BLOCKS:
        for c in range(lo, hi + 1):
            s = ucd.script_of(chr(c))
            if s is not None and s != ucd.UNKNOWN:
                yield c, s


def test_ucd_scripts_against_fonttools():
    got = dict(_covered())
    assert len(got) > 5000
    assert {c: fu.script(chr(c)) for c in got} == got


def test_ucd_mirrors_against_fonttools():
    assert ucd.MIRROR == dict(Mirrored.MIRRORED)


def test_ucd_bidi_classes_against_unicodedata():
    """Python's classes, except the characters fribidi 1.0.8 does not know
    yet (class L there), all of them Common symbols assigned after
    Unicode 12.1."""
    newer = {c for lo, hi in ucd.FRIBIDI_L for c in range(lo, hi + 1)}
    for c, _s in _covered():
        ch = chr(c)
        want = "L" if c in newer else unicodedata.bidirectional(ch)
        assert ucd.bidi_class(ch) == want, hex(c)
    assert all(unicodedata.bidirectional(chr(c)) != "L" for c in newer)


def test_ucd_joining_types_against_presentation_forms():
    """A letter with initial or medial presentation forms joins on both
    sides (D), one with only a final form on the right (R), one with only
    an isolated form on neither (U); ArabicShaping gives U+0677 and U+06BA
    other types than their forms suggest."""
    forms = {}
    for c in itertools.chain(range(0xFB50, 0xFE00), range(0xFE70, 0xFF00)):
        d = unicodedata.decomposition(chr(c)).split()
        if len(d) == 2 and d[0].startswith("<"):
            forms.setdefault(int(d[1], 16), set()).add(d[0])
    checked = 0
    for c, f in forms.items():
        if not 0x0620 <= c <= 0x06FF or c in (0x0677, 0x06BA):
            continue
        want = "D" if f & {"<initial>", "<medial>"} else (
            "R" if "<final>" in f else "U")
        assert ucd.joining_type(chr(c)) == want, hex(c)
        checked += 1
    assert checked > 70
    assert [ucd.joining_type(ch) for ch in "ـ\u200d\u200cَ\u200e"] == \
        ["C", "C", "U", "T", "T"]


def test_ucd_brackets_pair_like_mirrors():
    """fribidi's bracket ids: an opening bracket's id is itself or the
    bracket it folds to; its mirror closes with the same id."""
    for c, (bid, is_open) in ucd.BRACKETS.items():
        if is_open:
            m = ucd.MIRROR[c]
            assert ucd.BRACKETS[m] == (bid, False), hex(c)
            assert bid == c or ucd.BRACKETS[bid] == (bid, True), hex(c)


@pytest.mark.parametrize("levels, want", [
    ([0, 0, 0], [(0, 3, 0)]),
    ([1, 1, 1], [(0, 3, 1)]),
    ([0, 1, 1, 0], [(0, 1, 0), (1, 3, 1), (3, 4, 0)]),
    ([1, 2, 1, 2, 1], [(4, 5, 1), (3, 4, 2), (2, 3, 1), (1, 2, 2),
                       (0, 1, 1)]),
    ([0, 1, 2, 2, 1, 0], [(0, 1, 0), (4, 5, 1), (2, 4, 2), (1, 2, 1),
                          (5, 6, 0)]),
    ([2, 2, 4, 3], [(0, 2, 2), (3, 4, 3), (2, 3, 4)]),
])
def test_visual_runs_reverse_runs(levels, want):
    assert shaping.visual_runs(levels) == want


def _check(face, size, texts, align=0, colors=0):
    """Each text drawn by the port as CKSpriteText draws it equals
    Pillow's, and so does its text box."""
    path = _path(face)
    font = te2.font_table(path, size)
    pf = ImageFont.truetype(path, size)
    for k, text in enumerate(texts):
        box = tuple(PROBE.textbbox((0, 0), text, font=pf))
        assert te2.text_bbox(text, font) == box, (face, size, text)
        w, h = box[2] - box[0] + 2 * size, box[3] + 6
        fg, bg = COLORS[(k + colors) % 3]
        x = {0: 0, 1: (w - box[2] + box[0]) // 2, 2: w - box[2] + box[0]}[
            align]
        got = te2.raster_text(text, w, h,
                              tuple(int(c * 255) for c in fg),
                              tuple(int(c * 255) for c in bg), x, font)
        np.testing.assert_array_equal(
            got, pillow_raster(path, size, text, w, h, align, fg, bg),
            err_msg=f"{face} {size} {text!r}")


def _letters(face):
    cmap = te2.font_table(_path(face), 13).font.cmap
    return [chr(c) for c in range(0x0620, 0x0700) if c in cmap
            and unicodedata.category(chr(c)).startswith("L")]


@pytest.mark.parametrize("face", [SANS, MONO])
def test_every_arabic_letter_in_every_joining_context(face):
    """Alone, after and before a dual-joiner, between two, beside ZWJ,
    after ZWNJ, beside tatweel, after lam and before alef."""
    texts = []
    for ch in _letters(face):
        texts += [ch, "ب" + ch, ch + "ب", "ب" + ch + "ب", ch + "\u200d",
                  "\u200d" + ch, "ب\u200c" + ch, "ـ" + ch + "ـ", "ل" + ch,
                  ch + "ا"]
    _check(face, 13, texts)


@pytest.mark.parametrize("face, base, marks, n", [
    (SANS, "بلاه", AR_MARKS, 2), (SANS, "ب", AR_MARKS, 3),
    (MONO, "بلا", AR_MARKS, 2), (SANS, "שבאו", HE_MARKS, 2),
    (SANS, "ש", HE_MARKS, 3)])
def test_mark_permutations(face, base, marks, n):
    """Two and three marks on one base in every order: shadda with fatha
    and kasra, hamza above with a vowel, Hebrew shin and sin dots with
    dagesh and vowels (HarfBuzz's modified classes and reorderings)."""
    texts = []
    for b in base:
        for p in itertools.permutations(marks, n):
            texts.append(b + "".join(p) + ("ب" if b in "بلاه" else "ם"))
    _check(face, 17, texts)


@pytest.mark.parametrize("face", [SANS, MONO])
@pytest.mark.parametrize("size", [9, 22])
def test_lam_alef(face, size):
    """The lam-alef ligatures alone and joined, with a mark on the lam or
    the alef, and broken by ZWJ, ZWNJ and tatweel."""
    _check(face, size, ["لا", "بلا", "لَا", "لاَ", "لّا", "لأ", "لإ",
                        "لآ", "بلآ", "لٰا", "ل\u200dا", "ل\u200cا", "لـا",
                        "ل\u200eا", "لا١"])


CASES = {
    "digits": ["العدد ١٢٣٤ والرقم 567", "ب 1.2 ت", "ب 1,000 ت", "-١٢",
               "١٢-", "12.50$ مرحبا 3%", "٣٫١٤ ٬", "abc ١٢٣ def",
               "(۱۲) فارسی ۳", "1ب", "ب1"],
    "brackets": ["abc (مرحبا) def", "مرحبا (abc) سلام", "مرحبا (abc",
                 "abc) مرحبا", "[a(ب]c)", "(((ب)))", "«مرحبا» abc",
                 "ب ≤ ت ∈ ث {د} ‹و› ⊂ [ج]", "a ≤ b (ب) ≥"],
    "controls": ["\u200fhello", "\u200eمرحبا", "ab\u200fcd",
                 "\u061c١٢", "\u202aمرحبا\u202c abc",
                 "\u202babc\u202c مرحبا", "\u202dمرحبا ١٢\u202c",
                 "\u202eabc\u202c x", "x\u2066مرحبا\u2069y",
                 "x\u2067abc\u2069y", "\u2068مرحبا\u2069 abc", "\u2068abc",
                 "abc\u2067", "a\u2067ب"],
    "marks": ["ְ", "َ", "ًا", "ְa", "aְ",
              "aٚb", "ٚ", "ְب", "بְ",
              "a҃", "Ж҃", "ab҉", "1ְ",
              "(ְ)", "مَ ّ", "ڍ\ufe02ֽ", "a\ufe02ֽ", "ب\ufe02ِ",
              "e\ufe01\u0301", "ل\ufe00ا", "ب҈ّ", "ׇ҈ّ٨",
              "س҈ֳ"],
    "normaliser": ["\u1f80\u0300", "X\u034f\u033c", "p\u034f\u031e\u030b",
                   "\u1e12\u031f\u030c\u0357", "a\u034f\u0308",
                   "\u0430\u0488\u0301"],
    "joiners": ["می\u200cخواهم", "ی\u200cها", "ب\u200d", "\u200dب",
                "بـــب", "ب \u200c ب", "a\u200db", "ب\u00adب",
                "ا\u200dْ", "ب\u200dْ", "ا\u200cْ", "ب\u200eِ",
                "ل\u200dإ", "ب \u200dَ", "٣ \u200d☃\u2068",
                "٣ \u200d\u200d☃", "٣ \u200dَ☃"],
    "paragraphs": ["مرحبا بالعالم", "Level 3: «مرحبا» (12 نقطة) ok",
                   "مرحبا، كيف حالك؟", " مرحبا ", "مرحبا   ", "َب",
                   "مرحبا\nhello", "hello\nمرحبا", "١\n٢",
                   "ءآأؤإئابةتثجحخدذرزسشصضطظعغفقكلمنهوىي",
                   "ٹپچڈڑژکگںھہۂۃیےۓ۔", "۰۱۲۳۴۵۶۷۸۹ ٠١٢٣٤٥٦٧٨٩"],
    "hebrew": ["שָׁלוֹם, עוֹלָם! שלב 3", "שלב 3", "בְּרֵאשִׁית בָּרָא",
               "AV שלום Tyre", "abc (שלום) def", "לְהִתְרָאוֹת\nשלום",
               "ת״א ו׳", "שׂ שׁ שּׁ"],
}


@pytest.mark.parametrize("group", sorted(CASES))
def test_strings_against_pillow(group):
    texts = CASES[group]
    faces = [SANS] if group == "hebrew" else [SANS, MONO]
    for face in faces:
        for size, align in ((9, 0), (17, 1), (31, 2)):
            _check(face, size, texts, align, colors=size)


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
    """``CKSpriteText.Redraw()`` in both packages, bit-equal, on labels
    whose first or last visual glyph has a negative left bearing or a mark
    that overhangs, at several sizes and sprite sizes."""
    cj, ct = J.CKContext(), O.CKContext(device="cpu")
    rng = np.random.default_rng(10 + align)
    texts = [row[-1] for row in scenes.TEXT_HUD_RTL] + [
        "ًبب", "ججج", "بِ", "ي", "لإ", "ּשׁ", "ץ (ك)", "(a)ب",
        "مرحبا\n\u2067abc\u2069"]
    for k, text in enumerate(texts):
        face = SANS if any(0x0590 <= ord(c) < 0x0600 for c in text) else (
            SANS, MONO)[k % 2]
        px = int(rng.choice([9, 13, 17, 22, 31]))
        size = (int(rng.integers(40, 300)), int(rng.integers(14, 60)))
        fg, bg = COLORS[k % 3]
        ij = _sprite(J, cj, text, align, fg, bg, size, face, px).Redraw()
        it = _sprite(O, ct, text, align, fg, bg, size, face, px).Redraw()
        np.testing.assert_array_equal(it.GetImage(), ij.GetImage(),
                                      err_msg=f"{face} {px} {text!r}")


@pytest.mark.parametrize("face, text, what", [
    (SANS, "ߒߞߏ", "right-to-left"), (SANS, "ﷲ", "right-to-left"),
    (SANS, "ב\rא", "paragraph separator"),
    (SANS, "\u2067a\u2069 \u2066ب\u2069", "isolate"),
    (MONO, "שלום", "fallback mark positioning"),
    ("DejaVuSerif-Bold.ttf", "مرحبا", "fallback shaping"),
    (SANS, "\u0600١", "format character")])
def test_refusals_name_item_14(face, text, what):
    """What the slice does not take raises NotImplementedError naming
    item 14 and the feature, and nothing is drawn in its place."""
    ct = O.CKContext(device="cpu")
    s = _sprite(O, ct, text, 0, *COLORS[0], (64, 20), face, 12)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 14"):
        s.Redraw()


def test_hebrew_without_gpos_mark_is_refused(tmp_path):
    """A face with Hebrew in GPOS but no ``mark`` feature there gets
    HarfBuzz's presentation-form composition, which is not ported."""
    from fontTools.ttLib import TTFont

    tt = TTFont(_path(SANS))
    table = tt["GPOS"].table
    feats = table.FeatureList.FeatureRecord
    for rec in table.ScriptList.ScriptRecord:
        if rec.ScriptTag == "hebr":
            ls = rec.Script.DefaultLangSys
            ls.FeatureIndex = [i for i in ls.FeatureIndex
                               if feats[i].FeatureTag != "mark"]
    path = tmp_path / "nomark.ttf"
    tt.save(str(path))
    ct = O.CKContext(device="cpu")
    s = _sprite(O, ct, "שָׁלוֹם", 0, *COLORS[0], (64, 20), SANS, 12)
    s.SetFont(str(path), 12)
    with pytest.raises(NotImplementedError,
                       match="presentation-form composition.*item 14"):
        s.Redraw()


def test_expected_npz_rtl_equals_pillow_and_the_port():
    """Every right-to-left sweep raster of ``expected.npz`` drawn by the
    port, text boxes too, every 4th made again by Pillow, and the right-
    to-left HUD labels equal to Pillow's."""
    e = np.load(os.path.join(scenes.FONT_DIR, "expected.npz"))
    assert "fribidi=1.0.8" in [str(m) for m in e["meta"]]
    n = len(e["rtl_face"])
    assert n >= 60
    for i in range(n):
        path = _path(str(e["faces"][e["rtl_face"][i]]))
        size, text = int(e["rtl_size"][i]), str(e["rtl_text"][i])
        w, h = (int(v) for v in e["rtl_wh"][i])
        align = int(e["rtl_align"][i])
        fg, bg = e["rtl_fg"][i], e["rtl_bg"][i]
        if i % 4 == 0:
            np.testing.assert_array_equal(
                pillow_raster(path, size, text, w, h, align, fg, bg),
                e[f"rtl:{i}"])
        font = te2.font_table(path, size)
        box = te2.text_bbox(text, font)
        assert box == tuple(e["rtl_bbox"][i].tolist())
        x = {0: 0, 1: (w - box[2] + box[0]) // 2,
             2: w - box[2] + box[0]}[align]
        got = te2.raster_text(text, w, h, tuple(int(c * 255) for c in fg),
                              tuple(int(c * 255) for c in bg), x, font)
        np.testing.assert_array_equal(got, e[f"rtl:{i}"],
                                      err_msg=f"{path} {size} {text!r}")
    for (name, face, size, _p, (w, h), align, fg, bg,
         text) in scenes.TEXT_HUD_RTL:
        np.testing.assert_array_equal(
            pillow_raster(_path(face), size, text, w, h, align, fg, bg),
            e[f"hud:{name}"])


CUT = dict(terrain_n=24, n_balls=4)


def _level(P, **kw):
    ctx, rc, spinner, _tick = scenes.build_config5_text(P, **CUT, rtl=True,
                                                        **kw)
    return ctx, rc, spinner


def test_rtl_level_matches_the_reference():
    """``build_config5_text(rtl=True)`` cut to 256x192 (the labels at their
    own sizes, the frame cut): every label's texture equal to the
    reference's, and the frame through ``check_render``."""
    pair = render_both(_level, accelerator=False, width=256, height=192)
    rj, rt = pair[0], pair[1]
    for row in scenes.text_hud(rtl=True):
        np.testing.assert_array_equal(
            rt.context.GetObjectByName(row[0]).GetImage(),
            rj.context.GetObjectByName(row[0]).GetImage(), err_msg=row[0])
    check_render(pair)
