"""Make ``glyphs_default.npz``: the coverage bitmaps of Pillow's default
font, from which :class:`CKSpriteText` draws text without Pillow.

    python3 ckrenderengine_tpu_torch/objects/make_glyph_table.py

Run by hand, where Pillow is installed; nothing imports this script. The
package reads only the ``.npz`` it writes. For each printable ASCII
character the script draws the character alone with ``ImageDraw.text`` at
(16, 16) on a transparent RGBA canvas, white and opaque, which leaves the
font's 8-bit coverage in the alpha channel (Pillow copies the ink's RGB
where the destination alpha is 0 and blends alpha by the coverage). It
keeps the coverage's bounding box relative to the pen, ``getlength``'s
advance and ``getbbox`` of the character, and the bottom of ``"A"``'s text
box, which sets the line pitch of multi-line text. The font's name, the
Pillow and FreeType versions go in ``meta``.
"""

from __future__ import annotations

import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "glyphs_default.npz")
PEN = 16


def main() -> None:
    import PIL
    from PIL import Image, ImageDraw, ImageFont, features

    font = ImageFont.load_default()
    codes, boxes, bboxes, advances, bitmaps, offsets = [], [], [], [], [], [0]
    for code in range(32, 127):
        ch = chr(code)
        img = Image.new("RGBA", (4 * PEN, 4 * PEN), (0, 0, 0, 0))
        ImageDraw.Draw(img).text((PEN, PEN), ch, font=font,
                                 fill=(255, 255, 255, 255))
        cov = np.asarray(img)[..., 3]
        ys, xs = np.nonzero(cov)
        if ys.size:
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        else:
            y0 = y1 = x0 = x1 = PEN
        bm = cov[y0:y1, x0:x1]
        codes.append(code)
        boxes.append((x0 - PEN, y0 - PEN, x1 - x0, y1 - y0))
        bboxes.append(font.getbbox(ch))
        advances.append(font.getlength(ch))
        bitmaps.append(bm.reshape(-1))
        offsets.append(offsets[-1] + bm.size)
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    meta = np.array([
        "font=" + " ".join(str(n) for n in font.getname()),
        "size=" + str(font.size), "Pillow=" + PIL.__version__,
        "FreeType=" + str(features.version("freetype2")),
        "layout_engine=" + str(int(font.layout_engine))])
    np.savez_compressed(
        OUT, codes=np.asarray(codes, np.int32),
        boxes=np.asarray(boxes, np.int32),
        bboxes=np.asarray(bboxes, np.int32),
        advances=np.asarray(advances, np.float32),
        bitmaps=np.concatenate(bitmaps).astype(np.uint8),
        offsets=np.asarray(offsets, np.int64),
        line_bottom=np.int32(probe.textbbox((0, 0), "A", font=font)[3]),
        meta=meta)
    print(OUT, len(codes), "glyphs;", "; ".join(meta))


if __name__ == "__main__":
    main()
