"""Make the glyph tables from which :class:`CKSpriteText` draws text
without Pillow: ``glyphs_default.npz`` (Pillow's default font) and
``glyphs_dejavu.npz`` (``DejaVuSans.ttf`` and ``DejaVuSansMono.ttf`` at
sizes 10, 12, 14, 16, 20 and 24).

    python3 ckrenderengine_tpu_torch/objects/make_glyph_table.py

Run by hand, where Pillow and the DejaVu fonts are installed; nothing
imports this script. The package reads only the ``.npz`` files it writes.

Each table covers printable ASCII, Latin-1, Latin Extended-A, General
Punctuation and Arrows (U+0020-U+007E, U+00A0-U+017F, U+2000-U+21FF) less
the format controls and combining marks of those blocks (U+200B-U+200F,
U+2028-U+202E, U+2060-U+206F, U+20D0-U+20FF), which the shaper does not
lay out glyph by glyph. For each character the script draws the character
alone with ``ImageDraw.text`` at (32, 32) on a transparent RGBA canvas,
white and opaque, which leaves the font's 8-bit coverage in the alpha
channel (Pillow copies the ink's RGB where the destination alpha is 0 and
blends alpha by the coverage; a glyph's coverage does not depend on the
pen's fraction, since Pillow draws each glyph at the rounded pen). It
keeps:

- the coverage's bounding box relative to the pen and the coverage itself
  (identical bitmaps stored once per file);
- the advance in 1/64 pixel (``getlength``), ``getbbox`` of the character,
  and the right edge of its control box, which the string's text box takes
  from the glyph at its rounded pen. The control box can be wider than the
  coverage; where it passes the advance it shows in ``textbbox`` of the
  character behind blank prefixes of many pen fractions, and elsewhere it
  never decides a text box;
- the pair adjustments of the layout (``getlength`` of the pair less the
  two advances, in 1/64 pixel), and the pairs that the layout draws as
  something else than their two glyphs (ligatures), which the package
  refuses to draw;
- the bottom of ``"A"``'s text box, which sets the line pitch of
  multi-line text.

Before it writes a table the script draws random strings both ways and
stops if a raster or a text box differs. The font, the SHA-256 of its file
and the Pillow, FreeType and Raqm versions go in each table's ``meta``.
"""

from __future__ import annotations

import hashlib
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEN = 32
RANGES = ((0x20, 0x7F), (0xA0, 0x180), (0x2000, 0x2200))
SKIP = ((0x200B, 0x2010), (0x2028, 0x202F), (0x2060, 0x2070),
        (0x20D0, 0x2100))
NAMED = ("DejaVuSans.ttf", "DejaVuSansMono.ttf")
SIZES = (10, 12, 14, 16, 20, 24)
# Blank glyphs of many widths: behind them a glyph's pen takes many
# fractions, which shows its control box where it passes the advance.
BLANKS = (0x20, 0x2004, 0x2005, 0x2006, 0x2007, 0x2009, 0x200A)


def table_codes() -> list[int]:
    return [c for lo, hi in RANGES for c in range(lo, hi)
            if not any(a <= c < b for a, b in SKIP)]


def _pixel(v: int) -> int:
    """FreeType's PIXEL: 26.6 fixed point to the nearest pixel."""
    return (v + 32) >> 6


def _div255(v):
    t = v + 128
    return ((t >> 8) + t) >> 8


def _load(spec):
    from PIL import ImageFont

    name, size = spec
    if name is None:
        return ImageFont.load_default()
    return ImageFont.truetype(name, size)


def _coverage(font, text):
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (8 * PEN + 16 * len(text) * 2, 6 * PEN),
                    (0, 0, 0, 0))
    ImageDraw.Draw(img).text((PEN, PEN), text, font=font,
                             fill=(255, 255, 255, 255))
    return np.asarray(img)[..., 3].astype(np.int32)


def _compose(t, text, shape):
    """``text``'s coverage from table ``t`` on a canvas of ``shape`` with
    the pen at (PEN, PEN): the package's raster, restated."""
    cov = np.zeros(shape, np.int32)
    pos = 0
    for i, ch in enumerate(text):
        c = ord(ch)
        if i:
            pos += t["adv"][ord(text[i - 1])] + t["kern"].get(
                (ord(text[i - 1]), c), 0)
        left, top, g = t["glyph"][c]
        if g.size:
            x, y = PEN + _pixel(pos) + left, PEN + top
            a = cov[y:y + g.shape[0], x:x + g.shape[1]]
            cov[y:y + g.shape[0], x:x + g.shape[1]] = a + g - _div255(a * g)
    return cov


def _bbox(t, text):
    """``textbbox((0, 0), text)`` from table ``t`` (one line)."""
    pos = 0
    left, top, right, bottom = 0, None, None, None
    for i, ch in enumerate(text):
        c = ord(ch)
        if i:
            pos += t["adv"][ord(text[i - 1])] + t["kern"].get(
                (ord(text[i - 1]), c), 0)
        px = _pixel(pos)
        l, tp, _r, b = t["bbox"][c]
        r = px + t["cright"][c]
        left = min(left, px + l)
        top = tp if top is None else min(top, tp)
        bottom = b if bottom is None else max(bottom, b)
        right = r if right is None else max(right, r)
    right = max(right, _pixel(pos + t["adv"][ord(text[-1])]))
    return (left, top, right, bottom)


def bake(spec) -> dict:
    """One table: the font ``spec`` = (file name or None, size)."""
    import PIL
    from PIL import Image, ImageDraw, features

    font = _load(spec)
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    codes = table_codes()
    chars = [chr(c) for c in codes]
    t = {"adv": {}, "bbox": {}, "cright": {}, "glyph": {}, "kern": {}}
    for c, ch in zip(codes, chars):
        cov = _coverage(font, ch)[:4 * PEN, :6 * PEN]
        ys, xs = np.nonzero(cov)
        if ys.size:
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            t["glyph"][c] = (int(x0 - PEN), int(y0 - PEN), cov[y0:y1, x0:x1])
        else:
            t["glyph"][c] = (0, 0, np.zeros((0, 0), np.int32))
        t["adv"][c] = round(font.getlength(ch) * 64)
        t["bbox"][c] = tuple(int(v) for v in font.getbbox(ch))
    blank = [chr(b) for b in BLANKS]
    prefixes = blank + [a + b for a in blank for b in blank]
    for c, ch in zip(codes, chars):
        adv = t["adv"][c]
        if not t["glyph"][c][2].size:
            t["cright"][c] = 0          # an empty control box at the pen
            continue
        seen = [t["bbox"][c][2]] if t["bbox"][c][2] > _pixel(adv) else []
        for p in prefixes:
            pos = round((font.getlength(p + ch) - font.getlength(ch)) * 64)
            r = probe.textbbox((0, 0), p + ch, font=font)[2]
            if r > _pixel(pos + adv):
                seen.append(r - _pixel(pos))
        # Unseen, the control box's edge never passes the pen's end, and
        # the coverage's edge (inside it) stands in for it.
        t["cright"][c] = max(seen) if seen else (
            t["glyph"][c][0] + t["glyph"][c][2].shape[1])
    for a, ca in zip(codes, chars):
        for b, cb in zip(codes, chars):
            d = round(font.getlength(ca + cb) * 64) - t["adv"][a] - t["adv"][b]
            if d:
                t["kern"][(a, b)] = d
    # Pairs the layout draws as something else than their two glyphs.
    ascii_ = [c for c in codes if c < 0x7F]
    check = set(t["kern"]) | {(a, b) for a in ascii_ for b in ascii_}
    bad = []
    for a, b in sorted(check):
        text = chr(a) + chr(b)
        ref = _coverage(font, text)
        if not np.array_equal(_compose(t, text, ref.shape), ref):
            bad.append((a, b))
    badset = set(bad)
    # Random strings, both ways.
    rng = np.random.default_rng(sum(map(ord, str(spec))))
    n_bad = 0
    for k in range(400):
        s = "".join(chr(c) for c in rng.choice(
            codes if k % 2 else ascii_, int(rng.integers(1, 14))))
        if any((ord(x), ord(y)) in badset for x, y in zip(s, s[1:])):
            continue
        ref = _coverage(font, s)
        ok = np.array_equal(_compose(t, s, ref.shape), ref)
        ok &= tuple(probe.textbbox((0, 0), s, font=font)) == _bbox(t, s)
        n_bad += not ok
    if n_bad:
        raise SystemExit(f"{spec}: {n_bad} of 400 random strings differ")
    meta = [
        "font=" + " ".join(str(n) for n in font.getname()),
        "size=" + str(font.size), "Pillow=" + PIL.__version__,
        "FreeType=" + str(features.version("freetype2")),
        "Raqm=" + str(features.version("raqm")),
        "layout_engine=" + str(int(font.layout_engine))]
    if spec[0] is not None:
        with open(font.path, "rb") as f:
            meta.append("sha256=" + hashlib.sha256(f.read()).hexdigest())
        meta.append("file=" + os.path.basename(font.path))
    return {
        "codes": np.asarray(codes, np.int32),
        "boxes": np.asarray([(t["glyph"][c][0], t["glyph"][c][1])
                             for c in codes], np.int32),
        "bitmaps": [t["glyph"][c][2].astype(np.uint8) for c in codes],
        "bboxes": np.asarray([t["bbox"][c] for c in codes], np.int32),
        "cright": np.asarray([t["cright"][c] for c in codes], np.int32),
        "advances": np.asarray([t["adv"][c] for c in codes], np.int32),
        "kern_pairs": np.asarray(sorted(t["kern"]), np.int32).reshape(-1, 2),
        "kern": np.asarray([t["kern"][p] for p in sorted(t["kern"])],
                           np.int32),
        "bad_pairs": np.asarray(bad, np.int32).reshape(-1, 2),
        "line_bottom": np.int32(probe.textbbox((0, 0), "A", font=font)[3]),
        "meta": np.array(meta),
        "name": "default" if spec[0] is None else f"{spec[0]}:{spec[1]}",
    }


def write(path: str, tables: list[dict]) -> None:
    """Tables ``i`` as arrays ``{i}_<field>``; their bitmaps in one pool,
    each distinct bitmap once (``{i}_glyph``: its index in the pool)."""
    pool, index, out = [], {}, {}
    for i, tb in enumerate(tables):
        refs = []
        for bm in tb["bitmaps"]:
            key = (bm.shape, bm.tobytes())
            if key not in index:
                index[key] = len(pool)
                pool.append(bm)
            refs.append(index[key])
        out[f"{i}_glyph"] = np.asarray(refs, np.int32)
        for k, v in tb.items():
            if k not in ("bitmaps", "name"):
                out[f"{i}_{k}"] = v
    out["names"] = np.array([tb["name"] for tb in tables])
    out["pool_shapes"] = np.asarray([bm.shape for bm in pool],
                                    np.int32).reshape(-1, 2)
    out["pool_offsets"] = np.cumsum(
        [0] + [bm.size for bm in pool]).astype(np.int64)
    out["pool"] = np.concatenate([bm.reshape(-1) for bm in pool]) \
        .astype(np.uint8)
    np.savez_compressed(path, **out)
    print(path, os.path.getsize(path), "bytes,", len(tables), "tables,",
          len(pool), "distinct bitmaps")


def main() -> None:
    specs = [(None, 10)] + [(n, s) for n in NAMED for s in SIZES]
    workers = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    with ProcessPoolExecutor(workers) as ex:
        tables = list(ex.map(bake, specs))
    for tb in tables:
        print(tb["name"], len(tb["codes"]), "glyphs,", len(tb["kern"]),
              "pair adjustments,", len(tb["bad_pairs"]), "refused pairs")
    write(os.path.join(HERE, "glyphs_default.npz"), tables[:1])
    write(os.path.join(HERE, "glyphs_dejavu.npz"), tables[1:])


if __name__ == "__main__":
    main()
