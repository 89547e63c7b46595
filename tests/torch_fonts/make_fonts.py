"""Write ``expected.npz``: Pillow's rasters and text boxes of the strings
that ``chip_smoke.py``'s ``fonts`` phase and the tests draw with the
TrueType faces beside this script.

    python3 tests/torch_fonts/make_fonts.py

Needs Pillow with FreeType and Raqm (the port's package does not use
them). The faces are DejaVu Sans, DejaVu Sans Mono and DejaVu Serif Bold
(DejaVu 2.37, ``copyright`` beside them). Each raster is what the
reference's ``CKSpriteText`` draws: an RGBA canvas of the sprite's size in
the background colour, ``ImageDraw.textbbox`` at (0, 0), the text drawn at
the alignment's x and y 0 (:func:`pillow_raster`). The file holds:

- ``faces`` and ``sha256``: the three files and their SHA-256;
- the sweep: every face at sizes 9, 11, 13, 17, 22, 31 and 48 on each of
  ``SWEEP_TEXTS`` (ligatures, kerning, Latin-1, Greek, Cyrillic, two
  lines), the alignment and colour pair cycling: ``sweep_face`` (index
  into ``faces``), ``sweep_size``, ``sweep_text``, ``sweep_align``,
  ``sweep_fg`` and ``sweep_bg`` (RGBA floats), ``sweep_wh`` (the sprite's
  width and height), ``sweep_bbox`` (``textbbox``), and ``sweep:<i>``
  the raster (H, W, 4) uint8;
- the right-to-left sweep: DejaVu Sans and Sans Mono at sizes 11, 17 and
  31 on each of ``RTL_TEXTS`` (Arabic joining, lam-alef, tashkil,
  digits, brackets and mirroring in both paragraph directions, bidi
  controls, ZWNJ, ZWJ and tatweel, Hebrew with niqqud in DejaVu Sans
  only, two lines), with the same keys under ``rtl_`` and ``rtl:<i>``;
- the HUD of ``scenes.build_config5_text(rtl=True)``: ``hud:<name>`` for
  each fixed label and ``hud:score:<k>`` for the score after k = 0..3
  ticks;
- ``meta``: the Pillow, FreeType, Raqm, HarfBuzz and fribidi versions.

Nothing imports this script but the tests.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
from PIL import Image, ImageDraw, ImageFont

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from ckrenderengine_tpu_torch import scenes  # noqa: E402

SWEEP_SIZES = (9, 11, 13, 17, 22, 31, 48)
SWEEP_TEXTS = ("office flow", "AV To Ya WAVE", "Café crème Ærø ½ °C",
               "Ελληνικά: κόσμε", "Привет, мир! Ёж", "two lines\nof fi fl")
RTL_SIZES = (11, 17, 31)
# (text, whether DejaVu Sans Mono draws it too: it has no Hebrew).
RTL_TEXTS = (("مرحبا بالعالم", True), ("لا لَا لّا ـلا لأ", True),
             ("بِسْمِ اللَّهِ الرَّحْمَٰنِ", True),
             ("العدد ١٢٣٤ والرقم 567", True),
             ("abc (مرحبا) [x] ≤ y", True), ("مرحبا (abc) ‹ب› ≤ ٣", True),
             ("\u200fa\u200eb\u202ac\u202c \u202bد\u202c \u2067e\u2069 f",
              True),
             ("می\u200cخواهم ب\u200d ـبـ", True),
             ("Level 3: «مرحبا»\nالمستوى 12", True),
             ("שָׁלוֹם עוֹלָם", False), ("בְּרֵאשִׁית (א) 12", False),
             ("Level 3: «מרחב»\nשלום 12", False))
COLORS = (((1.0, 1.0, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0)),
          ((0.9, 0.2, 0.1, 0.85), (0.1, 0.3, 0.2, 0.5)),
          ((0.3, 0.6, 1.0, 0.5), (1.0, 1.0, 1.0, 1.0)))


def pillow_raster(path: str, size: int, text: str, w: int, h: int,
                  align: int, fg, bg) -> np.ndarray:
    """The reference ``CKSpriteText``'s raster: (h, w, 4) uint8."""
    img = Image.new("RGBA", (w, h), tuple(int(c * 255) for c in bg))
    draw = ImageDraw.Draw(img)
    font = ImageFont.truetype(path, size)
    bbox = draw.textbbox((0, 0), text, font=font)
    tw = bbox[2] - bbox[0]
    x = {0: 0, 1: (w - tw) // 2, 2: w - tw}[align]
    draw.text((x, 0), text, font=font, fill=tuple(int(c * 255) for c in fg))
    return np.asarray(img).copy()


def sweep():
    """The sweep's records: (face index, size, text, align, fg, bg, (w,
    h), textbbox)."""
    out = []
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    i = 0
    for fi, face in enumerate(scenes.FONT_FILES):
        path = os.path.join(HERE, face)
        for size in SWEEP_SIZES:
            font = ImageFont.truetype(path, size)
            for text in SWEEP_TEXTS:
                bbox = tuple(probe.textbbox((0, 0), text, font=font))
                wh = (bbox[2] - bbox[0] + 12, bbox[3] + 4)
                fg, bg = COLORS[i % len(COLORS)]
                out.append((fi, size, text, i % 3, fg, bg, wh, bbox))
                i += 1
    return out


def rtl_sweep():
    """The right-to-left sweep's records, as :func:`sweep`'s."""
    out = []
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    i = 0
    for fi, face in enumerate(scenes.FONT_FILES[:2]):
        path = os.path.join(HERE, face)
        for size in RTL_SIZES:
            font = ImageFont.truetype(path, size)
            for text, mono in RTL_TEXTS:
                if fi == 1 and not mono:
                    continue
                bbox = tuple(probe.textbbox((0, 0), text, font=font))
                wh = (bbox[2] - bbox[0] + 12, bbox[3] + 4)
                fg, bg = COLORS[i % len(COLORS)]
                out.append((fi, size, text, i % 3, fg, bg, wh, bbox))
                i += 1
    return out


def _records(arrays, prefix, recs):
    arrays[f"{prefix}_face"] = np.array([r[0] for r in recs], np.int32)
    arrays[f"{prefix}_size"] = np.array([r[1] for r in recs], np.int32)
    arrays[f"{prefix}_text"] = np.array([r[2] for r in recs])
    arrays[f"{prefix}_align"] = np.array([r[3] for r in recs], np.int32)
    arrays[f"{prefix}_fg"] = np.array([r[4] for r in recs], np.float32)
    arrays[f"{prefix}_bg"] = np.array([r[5] for r in recs], np.float32)
    arrays[f"{prefix}_wh"] = np.array([r[6] for r in recs], np.int32)
    arrays[f"{prefix}_bbox"] = np.array([r[7] for r in recs], np.int32)
    for i, (fi, size, text, align, fg, bg, (w, h), _b) in enumerate(recs):
        arrays[f"{prefix}:{i}"] = pillow_raster(
            os.path.join(HERE, scenes.FONT_FILES[fi]), size, text, w, h,
            align, fg, bg)


def main() -> None:
    import PIL
    from PIL import features

    arrays = {}
    arrays["faces"] = np.array(scenes.FONT_FILES)
    shas = []
    for face in scenes.FONT_FILES:
        with open(os.path.join(HERE, face), "rb") as f:
            shas.append(hashlib.sha256(f.read()).hexdigest())
    arrays["sha256"] = np.array(shas)
    recs = sweep()
    _records(arrays, "sweep", recs)
    rtl = rtl_sweep()
    _records(arrays, "rtl", rtl)
    for (name, face, size, _pos, (w, h), align, fg, bg,
         text) in scenes.text_hud(rtl=True):
        path = os.path.join(HERE, face)
        if text is None:
            for k in range(4):
                arrays[f"hud:{name}:{k}"] = pillow_raster(
                    path, size, scenes.score_text(k), w, h, align, fg, bg)
        else:
            arrays[f"hud:{name}"] = pillow_raster(path, size, text, w, h,
                                                  align, fg, bg)
    arrays["meta"] = np.array([
        "Pillow=" + PIL.__version__,
        "FreeType=" + str(features.version("freetype2")),
        "Raqm=" + str(features.version("raqm")),
        "HarfBuzz=" + str(features.version("harfbuzz")),
        "fribidi=" + str(features.version("fribidi"))])
    out = os.path.join(HERE, "expected.npz")
    np.savez_compressed(out, **arrays)
    print(out, os.path.getsize(out), "bytes,", len(recs), "sweep rasters,",
          len(rtl), "right-to-left rasters")


if __name__ == "__main__":
    main()
