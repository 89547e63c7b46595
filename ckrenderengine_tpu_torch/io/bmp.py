"""Windows bitmaps, read as Pillow's ``BmpImagePlugin`` reads them.

Headers: ``BITMAPCOREHEADER`` (12 bytes) and ``BITMAPINFOHEADER`` through
V5 (40-124 bytes). Bit depths 1, 4, 8, 16, 24 and 32; ``BI_RGB``,
``BI_BITFIELDS`` with the masks Pillow knows, RLE4 and RLE8; bottom-up and
top-down rows; palettes of fewer than 2^bpp entries. Pillow's choices are
kept: a 32-bit ``BI_RGB`` file is "RGB" (its fourth byte is not alpha), a
palette of the grey ramp makes the image "L" (or "1" for black and white),
and the RLE runs are expanded by Pillow's rules, its handling of odd RLE4
absolute runs included.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from .imagefile import Frame, Refused, unsupported

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3

# BI_BITFIELDS masks -> Pillow's raw mode: the band of each byte.
_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
            (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
            (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
            (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
            (0x0, 0x0, 0x0, 0x0): "BGRA"}
_MASKS16 = {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"}


def _i16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _i32(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def read_bmp(data: bytes) -> Iterator[Frame]:
    """The one frame of a BMP file."""
    if len(data) < 18 or data[:2] != b"BM":
        raise Refused("not a BMP file")
    offset = _i32(data, 10)
    pos = 14
    hsize = _i32(data, pos)
    hdr = data[pos + 4:pos + hsize]
    if len(hdr) < hsize - 4:
        raise Refused("BMP header cut short")
    pos += hsize
    direction = -1
    if hsize == 12:
        width, height, _planes, bits = struct.unpack_from("<HHHH", hdr)
        compression = _RAW
        pad = 3
        colors = 0
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = hdr[7] == 0xFF
        direction = 1 if top_down else -1
        width = _i32(hdr, 0)
        height = 2 ** 32 - _i32(hdr, 4) if top_down else _i32(hdr, 4)
        bits = _i16(hdr, 10)
        compression = _i32(hdr, 12)
        colors = _i32(hdr, 28)
        pad = 4
        if compression == _BITFIELDS:
            if len(hdr) >= 48:
                masks = [_i32(hdr, 36 + 4 * i) for i in range(3)]
                masks.append(_i32(hdr, 48) if len(hdr) >= 52 else 0)
            else:
                raw = data[pos:pos + 12]
                if len(raw) < 12:
                    raise Refused("BMP masks cut short")
                masks = [_i32(raw, 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        raise Refused(f"Unsupported BMP header type ({hsize})")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise Refused(f"Unsupported BMP pixel depth ({bits})")
    mode, rawmode = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
                     16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
                     32: ("RGB", "BGRX")}[bits]
    rle = False
    if compression == _BITFIELDS:
        if bits == 32 and tuple(masks) in _MASKS32:
            rawmode = _MASKS32[tuple(masks)]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits == 24 and tuple(masks[:3]) == (0xFF0000, 0xFF00, 0xFF):
            rawmode = "BGR"
        elif bits == 16 and tuple(masks[:3]) in _MASKS16:
            rawmode = _MASKS16[tuple(masks[:3])]
        else:
            raise Refused("Unsupported BMP bitfields layout")
    elif compression in (_RLE8, _RLE4):
        rle = True
    elif compression != _RAW:
        raise Refused(f"Unsupported BMP compression ({compression})")
    if width <= 0 or height <= 0 or width * height > 1 << 28:
        raise unsupported(f"BMP of {width}x{height} pixels")

    info: dict = {}
    if mode == "P":
        if not 0 < colors <= 256:
            raise unsupported(f"BMP palette of {colors} entries")
        raw = data[pos:pos + pad * colors]
        n = len(raw) // pad
        pal = np.frombuffer(raw[:n * pad], np.uint8).reshape(n, pad)
        pal = pal[:, 2::-1]
        ramp = (np.array([0, 255]) if colors == 2 else np.arange(colors))
        if n == colors and (pal == ramp[:, None]).all():
            mode = "1" if colors == 2 else "L"
            if (mode, bits) not in (("1", 1), ("L", 8)) or rle:
                raise unsupported(f"{bits}-bit grey BMP of {colors} "
                                  f"palette entries")
        else:
            info["palette"] = pal.copy()
            if len(raw) < pad * colors:
                raise unsupported("BMP palette cut short")
    start = offset or pos

    if rle:
        idx = _rle(data, start, width, height, bits == 4)
        rows = idx.reshape(height, width)
        px = rows[::-1] if direction == -1 else rows
        _check_palette(px, info)
        yield Frame(np.ascontiguousarray(px), mode, info)
        return

    stride = ((width * bits + 31) >> 3) & ~3
    # Pillow's raw decoder needs the last row's pixels, not its padding.
    need = stride * (height - 1) + (width * bits + 7) // 8
    body = data[start:start + stride * height]
    if len(body) < need:
        raise Refused("image file is truncated")
    body = body.ljust(stride * height, b"\0")
    rows = np.frombuffer(body, np.uint8).reshape(height, stride)
    if direction == -1:
        rows = rows[::-1]
    if bits < 8:
        v = np.unpackbits(rows, axis=1)[:, :width * bits]
        v = v.reshape(height, width, bits)
        px = np.zeros((height, width), np.uint8)
        for i in range(bits):
            px = (px << 1) | v[..., i]
        if mode == "1":
            px = px * np.uint8(255)
    elif bits == 8:
        px = rows[:, :width].copy()
    elif bits == 16:
        v = rows[:, :width * 2].reshape(height, width, 2).astype(np.uint32)
        v = v[..., 0] | (v[..., 1] << 8)
        if rawmode == "BGR;15":
            chans = ((v >> 10) & 31, (v >> 5) & 31, v & 31)
            scale = (31, 31, 31)
        else:
            chans = ((v >> 11) & 31, (v >> 5) & 63, v & 31)
            scale = (31, 63, 31)
        px = np.stack([c * 255 // s for c, s in zip(chans, scale)],
                      axis=2).astype(np.uint8)
    else:
        nb = bits // 8
        v = rows[:, :width * nb].reshape(height, width, nb)
        bands = "RGBA" if mode == "RGBA" else "RGB"
        px = np.stack([v[..., rawmode.index(b)] for b in bands], axis=2)
    _check_palette(px, info)
    yield Frame(np.ascontiguousarray(px), mode, info)


def _check_palette(px, info) -> None:
    pal = info.get("palette")
    if pal is not None and px.size and int(px.max()) >= len(pal):
        raise unsupported("BMP index past its palette")


def _rle(data: bytes, start: int, width: int, height: int,
         rle4: bool) -> np.ndarray:
    """Pillow's ``BmpRleDecoder``: the indices in file row order."""
    dest = width * height
    out = bytearray()
    x = 0
    pos = start
    n = len(data)
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 0x0F])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += b"\0" * (-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            raise unsupported("RLE BMP with a delta code")
        else:
            if rle4:
                k = byte // 2
                got = data[pos:pos + k]
                for b in got:
                    out += bytes([b >> 4, b & 0x0F])
            else:
                k = byte
                got = data[pos:pos + k]
                out += got
            pos += len(got)
            if len(got) < k:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < dest:
        raise unsupported("RLE BMP whose data ends before its last pixel")
    return np.frombuffer(bytes(out[:dest]), np.uint8)
