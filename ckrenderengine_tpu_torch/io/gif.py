"""GIF files, read as Pillow's ``GifImagePlugin`` reads them.

LZW data, interlaced frames, global and local colour tables and the
transparent index. An animation comes frame by frame as
``ImageSequence.Iterator`` gives it: the first frame as "P" (or "L" where
the file's palette is the grey ramp), later frames composed onto the
previous ones in "RGB", or "RGBA" where the first frame has a transparent
index, each within its own rectangle, after the previous frame's disposal
(0-3). Pillow's bookkeeping is kept as it is, quirks included: a disposal
method given once stays until another is given, and a disposed rectangle
takes the transparent colour (alpha 0) before the background colour.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from .imagefile import Frame, Refused, unsupported


def _lzw(data: bytes, min_bits: int, n_pixels: int) -> bytes:
    """The pixel indices of one frame's LZW stream (at most
    ``n_pixels``; fewer where the end code comes first)."""
    if not 2 <= min_bits <= 8:
        raise unsupported(f"GIF with an LZW code size of {min_bits}")
    clear = 1 << min_bits
    end = clear + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    bits = min_bits + 1
    mask = (1 << bits) - 1
    prev = None
    acc = nacc = 0
    pos = 0
    n = len(data)
    while len(out) < n_pixels:
        while nacc < bits:
            if pos >= n:
                return bytes(out)
            acc |= data[pos] << nacc
            pos += 1
            nacc += 8
        code = acc & mask
        acc >>= bits
        nacc -= bits
        if code == clear:
            del table[clear + 2:]
            bits = min_bits + 1
            mask = (1 << bits) - 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise unsupported("GIF with a broken LZW stream")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            if len(table) < 4096:
                table.append(entry)
        else:
            raise unsupported("GIF with a broken LZW stream")
        out += entry
        prev = entry
        if len(table) > mask and bits < 12:
            bits += 1
            mask = (1 << bits) - 1
    return bytes(out[:n_pixels])


def _rows(h: int, interlace: bool) -> np.ndarray:
    """The image rows in the order the frame's data fills them."""
    if not interlace:
        return np.arange(h)
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        s = self.data[self.pos:self.pos + n]
        self.pos += len(s)
        return s

    def block(self) -> bytes | None:
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def _palette(p: bytes, size: int):
    """Pillow's palette for a colour table: None where the table is the
    grey ramp (i, i, i) (``_is_palette_needed``), else (N, 3) uint8.
    Refused where the file ends inside the table."""
    if len(p) < size:
        raise Refused("GIF colour table cut short")
    a = np.frombuffer(p, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(a))
    if (a == ramp[:, None]).all():
        return None
    return a


def read_gif(data: bytes) -> Iterator[Frame]:
    """The frames of a GIF file as ``ImageSequence.Iterator`` gives them,
    each with the ``duration`` of its Graphic Control Extension where it
    has one."""
    r = _Reader(data)
    s = r.read(13)
    if len(s) < 13:
        raise Refused("GIF header cut short")
    w, h = struct.unpack("<HH", s[6:10])
    flags = s[10]
    info: dict = {}
    global_palette = None
    if flags & 128:
        info["background"] = s[11]
        size = 3 << ((flags & 7) + 1)
        global_palette = _palette(r.read(size), size)
    mode = None
    im = None
    palette0 = None
    disposal_method = 0
    dispose = None
    dispose_extent = None
    k = 0
    while True:
        s = r.read(1)
        if not s or s == b";":
            if k == 0:
                raise Refused("image not found in GIF frame")
            return
        frame_trns = None
        duration = None
        palette = None            # None: no local table; False: grey ramp
        interlace = None
        while True:
            if not s:
                s = r.read(1)
            if not s or s == b";":
                break
            if s == b"!":
                s = r.read(1)
                block = r.block()
                if s and s[0] == 249 and block is not None:
                    if len(block) < 4:
                        raise unsupported("GIF with a short graphic "
                                          "control extension")
                    if block[0] & 1:
                        frame_trns = block[3]
                    duration = struct.unpack("<H", block[1:3])[0] * 10
                    bits = (block[0] & 0b00011100) >> 2
                    if bits:
                        disposal_method = bits
                while r.block():
                    pass
            elif s == b",":
                s = r.read(9)
                if len(s) < 9:
                    raise Refused("GIF image descriptor cut short")
                x0, y0, fw, fh = struct.unpack("<HHHH", s[:8])
                x1, y1 = x0 + fw, y0 + fh
                if x1 > w or y1 > h:
                    raise unsupported("GIF frame outside the logical "
                                      "screen")
                flags = s[8]
                interlace = bool(flags & 64)
                if flags & 128:
                    size = 3 << ((flags & 7) + 1)
                    palette = _palette(r.read(size), size)
                    if palette is None:
                        palette = False
                code_size = r.read(1)
                if not code_size:
                    raise Refused("GIF image data cut short")
                break
            s = b""
        if interlace is None:
            if k == 0:
                raise Refused("image not found in GIF frame")
            return
        # The frame's data sub-blocks.
        chunks = []
        complete = False
        while True:
            n = r.read(1)
            if not n:
                break
            if not n[0]:
                complete = True
                break
            chunk = r.read(n[0])
            if len(chunk) < n[0]:         # Pillow decodes whole sub-blocks
                break
            chunks.append(chunk)
        lzw = b"".join(chunks)

        if dispose is not None:
            ex0, ey0, ex1, ey1 = dispose_extent
            im[ey0:ey1, ex0:ex1] = dispose
        frame_palette = palette if palette is not None else global_palette
        if k == 0:
            mode = "P" if frame_palette is not None and frame_palette \
                is not False else "L"
            palette0 = frame_palette if mode == "P" else None
        elif mode == "P":
            rgba = np.zeros((256, 4), np.uint8)
            rgba[:, 3] = 255
            rgba[:len(palette0), :3] = palette0
            if "transparency" in info:
                rgba[info.pop("transparency"), 3] = 0
                mode = "RGBA"
            else:
                mode = "RGB"
            im = rgba[im]
        elif mode == "L" and frame_palette is not None \
                and frame_palette is not False:
            raise unsupported("GIF whose first frame is grey and a later "
                              "frame has a colour table")
        has_pal = frame_palette is not None and frame_palette is not False

        def rgb(color):
            if has_pal:
                if color * 3 + 3 > frame_palette.size:
                    color = 0
                return tuple(int(v) for v in frame_palette[color])
            return (color, color, color)

        # This frame's disposal, applied before the next frame is drawn.
        dispose = None
        dispose_extent = (x0, y0, x1, y1)
        if disposal_method == 2:
            color = info.get("transparency", frame_trns)
            if color is not None:
                fill = (rgb(color) + (0,)) if mode in ("RGB", "RGBA") \
                    else color
            else:
                color = info.get("background", 0)
                fill = (rgb(color) + (255,)) if mode in ("RGB", "RGBA") \
                    else color
            dispose = np.empty((fh, fw) + ((4,) if mode in ("RGB", "RGBA")
                                           else ()), np.uint8)
            dispose[...] = fill
        elif disposal_method == 3:
            if im is not None:
                dispose = im[y0:y1, x0:x1].copy()
            elif frame_trns is not None:
                dispose = np.full((fh, fw), frame_trns, np.uint8)

        # Decode the frame's indices into its rectangle.
        idx = np.frombuffer(_lzw(lzw, code_size[0], fw * fh), np.uint8)
        if len(idx) < fw * fh:
            if complete:
                raise unsupported("GIF frame whose data ends before its "
                                  "last pixel")
            raise Refused("GIF image data cut short")
        if has_pal and idx.size and int(idx.max()) >= len(frame_palette):
            raise unsupported("GIF index past its colour table")
        order = _rows(fh, interlace)
        if k == 0:
            im = np.full((h, w), frame_trns or 0, np.uint8)
            _put(im, idx, order, x0, y0, fw, None)
            if frame_trns is not None:
                info["transparency"] = frame_trns
        elif mode == "L":
            _put(im, idx, order, x0, y0, fw, frame_trns)
        else:
            if not has_pal:
                raise unsupported("GIF frame without a colour table over "
                                  "a colour frame")
            canvas = np.full((h, w), frame_trns or 0, np.uint8)
            _put(canvas, idx, order, x0, y0, fw, None)
            sub = canvas[y0:y1, x0:x1]
            colours = np.zeros((256, 4), np.uint8)
            colours[:, 3] = 255
            colours[:len(frame_palette), :3] = frame_palette
            if frame_trns is not None:
                colours[frame_trns, 3] = 0
                px = colours[sub]
                keep = px[..., 3:4] == 0
                im[y0:y1, x0:x1] = np.where(keep, im[y0:y1, x0:x1], px)
            else:
                im[y0:y1, x0:x1] = colours[sub]
        out = {}
        if mode == "P":
            out["palette"] = palette0
        if mode in ("P", "L") and "transparency" in info:
            out["transparency"] = info["transparency"]
        if duration is not None:
            out["duration"] = duration
        if mode == "RGB":
            pixels = im[..., :3].copy()
        else:
            pixels = im.copy()
        yield Frame(pixels, mode, out)
        k += 1


def _put(im, idx, order, x0, y0, fw, skip) -> None:
    """Write decoded indices into rows ``order`` of the frame's rectangle;
    where ``skip`` is an index, pixels of that index are not written."""
    n_rows = len(idx) // fw if fw else 0
    rows = idx[:n_rows * fw].reshape(n_rows, fw)
    ys = order[:n_rows] + y0
    if skip is None:
        im[ys, x0:x0 + fw] = rows
    else:
        cur = im[ys, x0:x0 + fw]
        im[ys, x0:x0 + fw] = np.where(rows == skip, cur, rows)
    rest = len(idx) - n_rows * fw
    if rest:
        y = order[n_rows] + y0
        part = idx[n_rows * fw:]
        if skip is None:
            im[y, x0:x0 + rest] = part
        else:
            cur = im[y, x0:x0 + rest]
            im[y, x0:x0 + rest] = np.where(part == skip, cur, part)
