"""2D overlay entities: CK2dEntity / CKSprite / CKSpriteText.

API mirror of RCK2dEntity (src/CK2dEntity.cpp, include/RCK2dEntity.h —
homogeneous-or-pixel rects, 2D parent tree, background/foreground
membership, clip-to-parent, Z order), RCKSprite (src/CKSprite.cpp —
image-backed 2D entity) and RCKSpriteText (src/CKSpriteText.cpp — text
rendered into the sprite bitmap).

The 2D trees are flattened on the host into ordered quad lists, which the
frame composites under (background) and over (foreground) the 3D pass
(``pipeline/overlay.py``).

Text in a named font is laid out, hinted and rasterised by the port's own
TrueType stack (``text/``: the font file, FreeType's bytecode interpreter
and smooth rasteriser, HarfBuzz's shaping as Raqm asks for it), which is
what ``ImageFont.truetype`` does in the reference; the default font draws
from the baked table ``glyphs_default.npz`` (made by
``make_glyph_table.py``). Each glyph sits at its pen rounded to the pixel,
the pen moving by the layout's advances and pair adjustments in 1/64
pixel; overlapping coverage combines as ``a + b - a*b/255``, and the fill
colour blends over the background colour on 8-bit values, which is what
``ImageDraw.text`` does on an RGBA image. A named font is looked up as
``ImageFont.truetype`` looks it up; one that is not found draws the
default font, as the reference falls back to it.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

from ..roadmap import unported
from ..text.font import TrueTypeFont, truetype
from .base import CKCID_2DENTITY, CKCID_SPRITE, CKCID_SPRITETEXT, CKContext
from .entity import CKRenderObject
from .texture import CKTexture

# CK2dEntity flags (public Virtools SDK values where behavior matters)
CK_2DENTITY_POSITION_HOMOGENEOUS = 0x001
CK_2DENTITY_SIZE_HOMOGENEOUS = 0x002
CK_2DENTITY_CLIPTOPARENT = 0x008
CK_2DENTITY_BACKGROUND = 0x100
CK_2DENTITY_NOTPICKABLE = 0x200
CK_2DENTITY_RATIOOFFSET = 0x400

HERE = os.path.dirname(os.path.abspath(__file__))
GLYPHS = os.path.join(HERE, "glyphs_default.npz")
# Extra pixels between the lines of multi-line text (ImageDraw's default).
LINE_SPACING = 4


class CK2dEntity(CKRenderObject):
    CLASS_ID = CKCID_2DENTITY

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self._parent: CK2dEntity | None = None
        self._children: list[CK2dEntity] = []
        self.flags2d = 0
        # position/size either homogeneous [0..1] of parent or pixels
        self.position = np.zeros(2, np.float32)
        self.size = np.array([64.0, 64.0], np.float32)
        self.zorder = 0
        self.material = None
        self.src_rect = np.array([0.0, 0.0, 1.0, 1.0], np.float32)  # uv rect
        self.color = np.ones(4, np.float32)
        context._bump_topology()

    # -- tree --------------------------------------------------------------
    def SetParent(self, parent: "CK2dEntity | None") -> bool:
        p = parent
        while p is not None:
            if p is self:
                return False
            p = p._parent
        if self._parent is not None:
            self._parent._children.remove(self)
        self._parent = parent
        if parent is not None:
            parent._children.append(self)
        self.context._bump_topology()
        return True

    def GetParent(self):
        return self._parent

    def GetChildrenCount(self) -> int:
        return len(self._children)

    def GetChild(self, i: int):
        return self._children[i]

    # -- placement ---------------------------------------------------------
    def SetPosition(self, pos, hom: bool = False, keep_children: bool = False):
        self.position = np.asarray(pos, np.float32)[:2]
        if hom:
            self.flags2d |= CK_2DENTITY_POSITION_HOMOGENEOUS
        else:
            self.flags2d &= ~CK_2DENTITY_POSITION_HOMOGENEOUS
        self.context._bump_dynamic()

    def GetPosition(self) -> np.ndarray:
        return self.position.copy()

    def SetSize(self, size, hom: bool = False, keep_children: bool = False):
        self.size = np.asarray(size, np.float32)[:2]
        if hom:
            self.flags2d |= CK_2DENTITY_SIZE_HOMOGENEOUS
        else:
            self.flags2d &= ~CK_2DENTITY_SIZE_HOMOGENEOUS
        self.context._bump_dynamic()

    def GetSize(self) -> np.ndarray:
        return self.size.copy()

    def SetRect(self, rect):
        """Pixel rect (x0,y0,x1,y1)."""
        x0, y0, x1, y1 = rect
        self.SetPosition((x0, y0))
        self.SetSize((x1 - x0, y1 - y0))

    def GetRect(self, vw: int = 0, vh: int = 0) -> np.ndarray:
        x0, y0, x1, y1 = self.screen_rect(vw, vh)
        return np.array([x0, y0, x1, y1], np.float32)

    def SetHomogeneousCoordinates(self, on: bool = True):
        if on:
            self.flags2d |= (CK_2DENTITY_POSITION_HOMOGENEOUS
                             | CK_2DENTITY_SIZE_HOMOGENEOUS)
        else:
            self.flags2d &= ~(CK_2DENTITY_POSITION_HOMOGENEOUS
                              | CK_2DENTITY_SIZE_HOMOGENEOUS)

    def IsHomogeneousCoordinates(self) -> bool:
        return bool(self.flags2d & CK_2DENTITY_POSITION_HOMOGENEOUS)

    def EnableClipToParent(self, on: bool = True):
        if on:
            self.flags2d |= CK_2DENTITY_CLIPTOPARENT
        else:
            self.flags2d &= ~CK_2DENTITY_CLIPTOPARENT

    def IsClipToParentEnabled(self) -> bool:
        return bool(self.flags2d & CK_2DENTITY_CLIPTOPARENT)

    def SetBackground(self, back: bool = True):
        if back:
            self.flags2d |= CK_2DENTITY_BACKGROUND
        else:
            self.flags2d &= ~CK_2DENTITY_BACKGROUND
        self.context._bump_topology()

    def IsBackground(self) -> bool:
        return bool(self.flags2d & CK_2DENTITY_BACKGROUND)

    def SetZOrder(self, z: int):
        self.zorder = int(z)
        self.context._bump_dynamic()

    def GetZOrder(self) -> int:
        return self.zorder

    # -- appearance ---------------------------------------------------------
    def SetMaterial(self, material):
        self.material = material
        self.context._bump_topology()

    def GetMaterial(self):
        return self.material

    def SetSourceRect(self, rect):
        """UV sub-rect of the material texture (u0,v0,u1,v1)."""
        self.src_rect = np.asarray(rect, np.float32)[:4]
        self.context._bump_dynamic()

    def GetSourceRect(self) -> np.ndarray:
        return self.src_rect.copy()

    def GetHomogeneousRelativeRect(self, vw: int = 256,
                                   vh: int = 256) -> np.ndarray:
        """This entity's rect in [0..1] coordinates of its parent rect
        (reference GetHomogeneousRelativeRect); parentless entities are
        relative to the viewport."""
        sx0, sy0, sx1, sy1 = self.screen_rect(vw, vh)
        if self._parent is not None:
            px0, py0, px1, py1 = self._parent.screen_rect(vw, vh)
        else:
            px0, py0, px1, py1 = 0.0, 0.0, float(vw), float(vh)
        pw = max(px1 - px0, 1e-9)
        ph = max(py1 - py0, 1e-9)
        return np.array([(sx0 - px0) / pw, (sy0 - py0) / ph,
                         (sx1 - px0) / pw, (sy1 - py0) / ph], np.float32)

    def HierarchySetBackground(self, back: bool = True):
        """Move this entity AND its whole 2D subtree between background and
        foreground (reference HierarchySetBackground)."""
        self.SetBackground(back)
        for c in self._children:
            c.HierarchySetBackground(back)

    def UpdateExtents(self, rc=None) -> tuple:
        """Recompute + record the screen-space extents rect (reference
        UpdateExtents — fills the context's 2D picking extents)."""
        if rc is None:
            rm = self.context.render_manager
            rc = rm.render_contexts[0] if rm and rm.render_contexts else None
        vw = rc.width if rc is not None else 256
        vh = rc.height if rc is not None else 256
        rect = self.screen_rect(vw, vh)
        self._extents = tuple(float(v) for v in rect)
        if rc is not None:
            rc.AddExtents2D(self._extents, self)
        return self._extents

    def GetExtents(self) -> tuple | None:
        return getattr(self, "_extents", None)

    def SetColor(self, rgba):
        self.color = np.asarray(rgba, np.float32)[:4]
        self.context._bump_dynamic()

    # -- geometry -----------------------------------------------------------
    def screen_rect(self, vw: int, vh: int) -> tuple:
        """Resolved pixel rect (reference UpdateExtents semantics: pixel
        rounding of homogeneous coords against the parent/viewport rect)."""
        if self._parent is not None:
            px0, py0, px1, py1 = self._parent.screen_rect(vw, vh)
            pw, ph = px1 - px0, py1 - py0
        else:
            px0, py0, pw, ph = 0.0, 0.0, float(vw), float(vh)
        if self.flags2d & CK_2DENTITY_POSITION_HOMOGENEOUS:
            x0 = px0 + self.position[0] * pw
            y0 = py0 + self.position[1] * ph
        else:
            x0 = px0 + self.position[0]
            y0 = py0 + self.position[1]
        if self.flags2d & CK_2DENTITY_SIZE_HOMOGENEOUS:
            w = self.size[0] * pw
            h = self.size[1] * ph
        else:
            w, h = self.size[0], self.size[1]
        x1, y1 = x0 + w, y0 + h
        if self.flags2d & CK_2DENTITY_CLIPTOPARENT and self._parent is not None:
            x0, y0 = max(x0, px0), max(y0, py0)
            x1, y1 = min(x1, px1), min(y1, py1)
        # pixel rounding (reference Draw :805-908 rounds to pixel centers)
        return (np.floor(x0 + 0.5), np.floor(y0 + 0.5),
                np.floor(x1 + 0.5), np.floor(y1 + 0.5))

    # -- quad emission (scene compiler hook) --------------------------------
    def texture(self):
        """Texture-like object sampled by the quad (material's texture)."""
        if self.material is not None:
            return self.material.GetTexture(0)
        return None

    def quad_descriptors(self, vw: int, vh: int, tex_slot: int) -> list[dict]:
        x0, y0, x1, y1 = self.screen_rect(vw, vh)
        if x1 <= x0 or y1 <= y0:
            return []
        blend = 1
        if self.material is not None and not self.material.AlphaBlendEnabled():
            # Untextured flat quads copy; textured quads still use texel alpha.
            blend = 1 if self.texture() is not None else 0
        u0, v0, u1, v1 = self.src_rect
        return [dict(rect=(x0, y0, x1, y1), uvrect=(u0, v0, u1, v1),
                     color=tuple(self.color), tex=tex_slot, blend=blend)]

    def collect_tree(self, out: list):
        """Depth-first collection in render order (children after parent,
        zorder-sorted — reference RCK2dEntity::Render recursion)."""
        if self.IsVisible():
            out.append(self)
            for c in sorted(self._children, key=lambda e: e.zorder):
                c.collect_tree(out)

    # -- picking ------------------------------------------------------------
    def Pick(self, x: float, y: float, vw: int, vh: int):
        """Front-most hit in this subtree (reference Pick2D walks the tree
        front-to-back, src/CKRenderContext.cpp:1638-1659)."""
        if not self.IsVisible():
            return None
        for c in sorted(self._children, key=lambda e: -e.zorder):
            hit = c.Pick(x, y, vw, vh)
            if hit is not None:
                return hit
        if self.flags2d & CK_2DENTITY_NOTPICKABLE:
            return None
        x0, y0, x1, y1 = self.screen_rect(vw, vh)
        if x0 <= x < x1 and y0 <= y < y1:
            return self
        return None


class CKSprite(CK2dEntity):
    """2D entity backed by its own image slots (reference RCKSprite — the
    pow2 sub-texture decomposition of the DX9 path is not needed: the image
    is one block of the shared texture stack)."""

    CLASS_ID = CKCID_SPRITE

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self._store = CKTexture(context, f"{name}__store")
        self.transparent_color = None

    def Create(self, width: int, height: int, bpp: int = 32, slot: int = 0):
        self._store.Create(width, height, bpp, slot)
        self.SetSize((width, height))
        return True

    def SetImage(self, image: np.ndarray, slot: int = 0):
        self._store.SetImage(image, slot)
        self.SetSize((image.shape[1], image.shape[0]))

    def GetImage(self, slot: int = 0):
        return self._store.GetImage(slot)

    def GetSlotCount(self) -> int:
        return self._store.GetSlotCount()

    def SetCurrentSlot(self, slot: int):
        self._store.SetCurrentSlot(slot)

    def GetCurrentSlot(self) -> int:
        return self._store.GetCurrentSlot()

    def GetWidth(self) -> int:
        return self._store.GetWidth()

    def GetHeight(self) -> int:
        return self._store.GetHeight()

    def SetTransparentColor(self, rgba):
        self._store.SetTransparentColor(rgba)

    def RestoreInitialSize(self):
        """Reset the on-screen size to the image's pixel size (reference
        RestoreInitialSize)."""
        img = self.GetImage()
        if img is not None:
            self.SetSize((img.shape[1], img.shape[0]))

    def CopySpriteData(self, src: "CKSprite") -> bool:
        """Copy every image slot + transparency from another sprite
        (reference RCKSprite::CopySpriteData, src/CKSprite.cpp:279)."""
        if src is self:
            return True
        for i in range(src.GetSlotCount()):
            img = src.GetImage(i)
            if img is not None:
                self.SetImage(img.copy(), slot=i)
        self.SetCurrentSlot(src.GetCurrentSlot())
        self.transparent_color = src.transparent_color
        return True

    def LoadMovie(self, path: str) -> bool:
        """Movie sprites (reference RCKSprite movie load): the frames of a
        movie into image slots, each frame's duration (ms) kept for
        SetMovieTime. False for a missing file, as in the reference.

        - An animated GIF, an APNG, a multi-page TIFF or a still image:
          each frame the RGBA of the reference's
          ``ImageSequence.Iterator``, its duration the frame's own (100
          ms where it has none).
        - An AVI (the reference reads it with OpenCV's FFmpeg): each
          frame as ``VideoCapture.read`` gives it, alpha 1, every frame
          ``1000 / fps`` ms (100 ms where fps <= 1e-3); False where
          OpenCV would not open the file or reads no frame
          (``io/avi.py``).

        Any other file (the reference's other video containers) and the
        AVI codecs ``io/avi.py`` does not decode raise item 14."""
        from ..io.avi import read_avi
        from ..io.imagefile import Refused, frames, is_avi, to_rgba

        try:
            with open(path, "rb") as f:
                head = f.read(189)
        except OSError:
            return False

        def video():
            name = _container(head)
            return unported(f"movie sprites from video containers other "
                            f"than AVI ({name}) (LoadMovie)", 14)
        if is_avi(head):
            with open(path, "rb") as f:
                got = read_avi(f.read())
            if not got or not got[0]:
                return False
            rgb, fps = got
            duration = 1000.0 / fps if fps > 1e-3 else 100.0
            self._movie_durations = []
            for n, px in enumerate(rgb):
                rgba = np.ones(px.shape[:2] + (4,), np.float32)
                rgba[..., :3] = px.astype(np.float32) / 255.0
                self.SetImage(rgba, slot=n)
                self._movie_durations.append(duration)
            self.SetCurrentSlot(0)
            return True
        try:
            it = frames(path)
        except NotImplementedError:         # no reader takes the file
            raise video() from None
        if it is None:
            return False
        try:
            got = [(to_rgba(*fr), float(fr.info.get("duration", 100.0)))
                   for fr in it]
        except Refused:
            raise video() from None
        self._movie_durations = []
        for n, (rgba, duration) in enumerate(got):
            self.SetImage(rgba.astype(np.float32) / 255.0, slot=n)
            self._movie_durations.append(duration)
        self.SetCurrentSlot(0)
        return True

    def GetMovieFrameCount(self) -> int:
        return len(getattr(self, "_movie_durations", ()))

    def GetMovieLength(self) -> float:
        """Total movie length in milliseconds."""
        return float(sum(getattr(self, "_movie_durations", ())))

    def SetMovieTime(self, t_ms: float) -> int:
        """Select the slot covering time ``t_ms`` (wraps); returns the slot."""
        durs = getattr(self, "_movie_durations", None)
        if not durs:
            return 0
        total = sum(durs)
        t = float(t_ms) % total if total > 0 else 0.0
        acc = 0.0
        for i, d in enumerate(durs):
            acc += d
            if t < acc:
                self.SetCurrentSlot(i)
                return i
        self.SetCurrentSlot(len(durs) - 1)
        return len(durs) - 1

    def texture(self):
        return self._store if self._store.current_image() is not None \
            else super().texture()


def _container(head: bytes) -> str:
    """The name of the container a file's first bytes show."""
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"wide", b"free"):
        return "MP4 / MOV"
    if head[:4] == b"\x1aE\xdf\xa3":
        return "Matroska / WebM"
    if head[:4] == b"\0\0\x01\xba":
        return "MPEG-PS"
    if head[:1] == b"G" and head[188:189] == b"G":
        return "MPEG-TS"
    if head[:3] == b"FLV":
        return "FLV"
    return f"a file starting {head[:12]!r}"


@functools.lru_cache(maxsize=None)
def _glyph_file(path: str) -> dict:
    """{table name: table} of one baked file. A table: ``glyphs`` {code:
    (left, top, advance in 1/64 px, coverage (h, w) int32)}, each box
    relative to the rounded pen; ``boxes`` {code: ``getbbox``}; ``right``
    {code: the control box's right edge}; ``kern`` {(a, b): pair
    adjustment in 1/64 px}; ``pitch`` (the line pitch); ``meta`` {key:
    value}."""
    f = np.load(path)
    shapes, offs, pool = f["pool_shapes"], f["pool_offsets"], f["pool"]
    out = {}
    for i, name in enumerate(f["names"].tolist()):
        col = {k[len(f"{i}_"):]: f[k] for k in f.files
               if k.startswith(f"{i}_")}
        glyphs, boxes, right = {}, {}, {}
        for j, code in enumerate(col["codes"].tolist()):
            g = int(col["glyph"][j])
            h, w = shapes[g].tolist()
            cov = pool[offs[g]:offs[g + 1]].reshape(h, w).astype(np.int32)
            left, top = col["boxes"][j].tolist()
            glyphs[code] = (left, top, int(col["advances"][j]), cov)
            boxes[code] = tuple(col["bboxes"][j].tolist())
            right[code] = int(col["cright"][j])
        out[name] = {
            "glyphs": glyphs, "boxes": boxes, "right": right,
            "kern": {tuple(p): int(v) for p, v in zip(
                col["kern_pairs"].tolist(), col["kern"].tolist())},
            "pitch": int(col["line_bottom"]) + LINE_SPACING,
            "meta": dict(m.split("=", 1) for m in col["meta"].tolist())}
    return out


def glyph_table() -> dict:
    """The default font's table (see :func:`_glyph_file`)."""
    return _glyph_file(GLYPHS)["default"]


def font_search_dirs() -> list[str]:
    """The directories ``ImageFont.truetype`` searches for a font name that
    is not a path, in its order."""
    if sys.platform == "win32":
        windir = os.environ.get("WINDIR")
        return [os.path.join(windir, "fonts")] if windir else []
    if sys.platform in ("linux", "linux2"):
        data_home = (os.environ.get("XDG_DATA_HOME")
                     or os.path.expanduser("~/.local/share"))
        data_dirs = (os.environ.get("XDG_DATA_DIRS")
                     or "/usr/local/share:/usr/share")
        return [os.path.join(d, "fonts")
                for d in [data_home] + data_dirs.split(":")]
    if sys.platform == "darwin":
        return ["/Library/Fonts", "/System/Library/Fonts",
                os.path.expanduser("~/Library/Fonts")]
    return []


def find_font(name: str) -> str | None:
    """The file ``ImageFont.truetype(name)`` opens: ``name`` itself, else
    the first file of that name under :func:`font_search_dirs` (without an
    extension: a ``.ttf`` first, else the first file of that stem); None
    where it finds none."""
    if os.path.isfile(name):
        return name
    base = os.path.basename(name)
    ext = os.path.splitext(base)[1]
    other = None
    for directory in font_search_dirs():
        for root, _dirs, files in os.walk(directory):
            for fn in files:
                if ext and fn == base:
                    return os.path.join(root, fn)
                if not ext and os.path.splitext(fn)[0] == base:
                    path = os.path.join(root, fn)
                    if fn.endswith(".ttf"):
                        return path
                    other = other or path
    return other


def font_table(name: str | None, size: int):
    """What draws the reference's ``SetFont(name, size)``: the default
    font's baked table where ``name`` is None or names no file the
    reference would find, else the TrueType face of that file at that
    size (:func:`text.font.truetype`)."""
    path = None if name is None else find_font(name)
    if path is None:
        return glyph_table()
    return truetype(os.path.abspath(path), int(size))


def _div255(v: np.ndarray) -> np.ndarray:
    """v / 255 rounded, for 0 <= v <= 255*255 (Pillow's DIV255)."""
    t = v + 128
    return ((t >> 8) + t) >> 8


def _pixel(v: int) -> int:
    """1/64 pixel to the nearest pixel (FreeType's PIXEL)."""
    return (v + 32) >> 6


def _pens(line: str, table: dict):
    """(code, pen in pixels) of each character of ``line`` in the default
    font's table, and the line's advance in 1/64 pixel (its basic layout
    draws no ligatures). Raises on a character the table does not hold."""
    glyphs, kern = table["glyphs"], table["kern"]
    out, pos = [], 0
    for i, ch in enumerate(line):
        code = ord(ch)
        if code not in glyphs:
            raise unported(f"CKSpriteText character {ch!r} (U+{code:04X}) "
                           f"in the default font: no baked glyph", 14)
        if i:
            prev = ord(line[i - 1])
            pos += glyphs[prev][2] + kern.get((prev, code), 0)
        out.append((code, _pixel(pos)))
    end = pos + glyphs[ord(line[-1])][2] if line else 0
    return out, end


def text_bbox(text: str, table: dict | None = None) -> tuple:
    """(left, top, right, bottom) of ``text`` drawn at (0, 0) (what
    ``ImageDraw.textbbox`` gives for the table's font; the default font's
    where ``table`` is None)."""
    table = glyph_table() if table is None else table
    if isinstance(table, TrueTypeFont):
        box = None
        for li, line in enumerate(text.split("\n")):
            y = li * table.pitch
            l, t, r, b = table.bbox(line)
            line_box = (l, y + t, r, y + b)
            box = line_box if box is None else (
                min(box[0], l), min(box[1], y + t),
                max(box[2], r), max(box[3], y + b))
        return box
    box = None
    for li, line in enumerate(text.split("\n")):
        if not line:
            continue
        y = li * table["pitch"]
        pens, end = _pens(line, table)
        left, right = 0, _pixel(end)
        top = bottom = None
        for code, px in pens:
            l, t, _r, b = table["boxes"][code]
            left = min(left, px + l)
            right = max(right, px + table["right"][code])
            top = t if top is None else min(top, t)
            bottom = b if bottom is None else max(bottom, b)
        line_box = (left, y + top, right, y + bottom)
        box = line_box if box is None else (
            min(box[0], line_box[0]), min(box[1], line_box[1]),
            max(box[2], line_box[2]), max(box[3], line_box[3]))
    return (0, 0, 0, 0) if box is None else box


def raster_text(text: str, width: int, height: int, fill, background,
                x: int = 0, table: dict | None = None,
                y: int = 0) -> np.ndarray:
    """(height, width, 4) uint8 image: ``text`` in the RGBA bytes ``fill``
    over ``background``, its first line's pen at (x, y), drawn from
    ``table`` (the default font's where None)."""
    table = glyph_table() if table is None else table
    cov = np.zeros((height, width), np.int32)
    if isinstance(table, TrueTypeFont):
        for li, line in enumerate(text.split("\n")):
            table.draw(cov, line, x, y + li * table.pitch)
        return _blend(cov, fill, background)
    for li, line in enumerate(text.split("\n")):
        pens, _end = _pens(line, table)
        ly = y + li * table["pitch"]
        for code, px in pens:
            left, top, _adv, g = table["glyphs"][code]
            gx, gy = x + px + left, ly + top
            xa, ya = max(gx, 0), max(gy, 0)
            xb = min(gx + g.shape[1], width)
            yb = min(gy + g.shape[0], height)
            if xb > xa and yb > ya:
                a = cov[ya:yb, xa:xb]
                b = g[ya - gy:yb - gy, xa - gx:xb - gx]
                cov[ya:yb, xa:xb] = a + b - _div255(a * b)
    return _blend(cov, fill, background)


def _blend(cov: np.ndarray, fill, background) -> np.ndarray:
    """The fill colour over the background colour by the 8-bit coverage,
    as ``ImageDraw``'s ``draw_bitmap`` blends it on an RGBA image."""
    bg = np.asarray(background, np.int32)
    ink = np.asarray(fill, np.int32)
    m = cov[..., None]
    out = _div255(bg * (255 - m) + ink * m)
    if bg[3] == 0:
        # Pillow takes the ink's colour where the destination is
        # transparent; only alpha blends.
        out[..., :3] = np.where(m > 0, ink[:3], bg[:3])
    return out.astype(np.uint8)


class CKSpriteText(CKSprite):
    """Sprite whose image is rendered text (reference RCKSpriteText — the
    GDI font handle becomes a TrueType face or the default font's table,
    :func:`font_table`; re-rastered lazily on change)."""

    CLASS_ID = CKCID_SPRITETEXT

    ALIGN_LEFT, ALIGN_CENTER, ALIGN_RIGHT = 0, 1, 2

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.text = ""
        self.font_name = None
        self.font_size = 14
        self.text_color = np.array([1, 1, 1, 1], np.float32)
        self.bg_color = np.array([0, 0, 0, 0], np.float32)
        self.align = self.ALIGN_LEFT
        self._raster_dirty = True

    def SetText(self, text: str):
        if text != self.text:
            self.text = text
            self._raster_dirty = True
            self.context._bump_dynamic()

    def GetText(self) -> str:
        return self.text

    def SetTextColor(self, rgba):
        self.text_color = np.asarray(rgba, np.float32)[:4]
        self._raster_dirty = True

    def GetTextColor(self):
        return self.text_color.copy()

    def SetBackgroundTextColor(self, rgba):
        self.bg_color = np.asarray(rgba, np.float32)[:4]
        self._raster_dirty = True

    def SetFont(self, name: str | None = None, size: int = 14, weight: int = 400,
                italic: bool = False, underline: bool = False):
        """Font selection (reference SetFont): ``name`` and ``size`` pick
        the face at the next raster (:func:`font_table`)."""
        self.font_name = name
        self.font_size = int(size)
        self._raster_dirty = True

    def SetAlign(self, align: int):
        self.align = int(align)
        self._raster_dirty = True

    def GetAlign(self) -> int:
        return self.align

    def ClearFont(self):
        """Drop the font handle -> default font (reference ClearFont)."""
        self.font_name = None
        self._raster_dirty = True

    def IsUpToDate(self) -> bool:
        """False when the bitmap needs re-rasterizing (reference
        IsUpToDate)."""
        return not self._raster_dirty

    def Redraw(self):
        """Force the text raster NOW (reference Redraw — the reference
        redraws into the bitmap on demand)."""
        self._rasterize()
        return self._store

    def _rasterize(self):
        w = max(int(self.size[0]), 1)
        h = max(int(self.size[1]), 1)
        bg = tuple(int(c * 255) for c in self.bg_color)
        fill = tuple(int(c * 255) for c in self.text_color)
        table = font_table(self.font_name, self.font_size)
        bbox = text_bbox(self.text, table)
        tw = bbox[2] - bbox[0]
        x = {self.ALIGN_LEFT: 0, self.ALIGN_CENTER: (w - tw) // 2,
             self.ALIGN_RIGHT: w - tw}[self.align]
        img = raster_text(self.text, w, h, fill, bg, x, table)
        self._store.SetImage(img.astype(np.float32) / 255.0)
        self._raster_dirty = False

    def texture(self):
        if self._raster_dirty:
            self._rasterize()
        return self._store
