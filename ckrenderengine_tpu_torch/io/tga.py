"""Truevision TGA files, read as Pillow's ``TgaImagePlugin`` reads them.

Image types 1, 2, 3 and their RLE forms 9, 10, 11; 8-, 16-, 24- and 32-bit
pixels (and 1-bit grey); colour maps of 24-bit entries from any origin;
the ID field; the origin bits (top or bottom first, and the left-right
flip). Pillow's choices are kept: a 16-bit truecolour pixel is
5 bits per colour, scaled by ``c * 255 // 31``, and its top bit an
inverted alpha: 0 where the bit is set, 255 where it is clear (Pillow's
"BGRA;15Z", whatever the descriptor's alpha bits say). Pillow cannot
apply a 16- or 32-bit colour map (it raises ``ValueError``), and 15-bit
pixels and maps it does not read as TGA: this module reads neither.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from .imagefile import Frame, Refused, unsupported

_RAWMODES = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}


def _header(data: bytes):
    if len(data) < 18:
        return None
    (id_len, cmap_type, itype, cmap_start, cmap_len, cmap_depth, _x0, _y0,
     w, h, depth, flags) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    return (id_len, cmap_type, itype, cmap_start, cmap_len, cmap_depth, w,
            h, depth, flags)


def is_tga(data: bytes) -> bool:
    """Whether Pillow's TGA plugin takes the file: its header checks pass,
    and no plugin Pillow tries first claims a file of this kind."""
    hd = _header(data)
    if hd is None:
        return False
    # Headers that a plugin Pillow tries before TGA accepts by its leading
    # bytes (PCX, IPTC, GIMP brush; ICO and CUR with entries to read).
    if ((data[0] == 10 and data[1] in (0, 2, 3, 5)) or data[0] == 0x1C
            or (data[4:7] == b"\0\0\0" and data[7] in (1, 2))
            or (data[:4] in (b"\0\0\1\0", b"\0\0\2\0") and data[4:6]
                != b"\0\0")):
        return False
    _id, cmap_type, itype, _s, _n, cmap_depth, w, h, depth, flags = hd
    return (cmap_type in (0, 1) and w > 0 and h > 0
            and depth in (1, 8, 16, 24, 32) and itype in (1, 2, 3, 9, 10, 11)
            and (not cmap_type or cmap_depth in (16, 24, 32))
            and (itype & 7, depth) in _RAWMODES)


def _bgra15(v: np.ndarray) -> np.ndarray:
    """Pillow's "BGRA;15Z": (..., 4) RGBA of 16-bit little-endian words,
    the top bit an inverted alpha."""
    v = v.astype(np.uint32)
    out = np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                    (v & 31) * 255 // 31, np.where(v & 0x8000, 0, 255)],
                   axis=-1)
    return out.astype(np.uint8)


def _unpack(raw: bytes, n: int, itype: int, depth: int) -> np.ndarray:
    """``n`` pixels of raw bytes in the pixel format of (type, depth)."""
    if depth == 1:
        return np.unpackbits(np.frombuffer(raw, np.uint8))[:n] * np.uint8(255)
    nb = depth // 8
    v = np.frombuffer(raw[:n * nb], np.uint8).reshape(n, nb)
    if (itype, depth) == (2, 16):
        return _bgra15(v[:, 0].astype(np.uint16) | (v[:, 1].astype(np.uint16)
                                                    << 8))
    if (itype, depth) == (2, 24):
        return v[:, 2::-1]
    if (itype, depth) == (2, 32):
        return v[:, [2, 1, 0, 3]]
    if nb == 1:
        return v[:, 0]
    return v                                          # LA


def _rle(data: bytes, pos: int, n: int, nb: int) -> bytes:
    """Expand TGA RLE packets to ``n`` pixels of ``nb`` bytes; Refused
    where the data ends first."""
    out = bytearray()
    end = n * nb
    size = len(data)
    while len(out) < end:
        if pos >= size:
            raise Refused("image file is truncated")
        head = data[pos]
        pos += 1
        count = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos:pos + nb]
            if len(px) < nb:
                raise Refused("image file is truncated")
            out += px * count
            pos += nb
        else:
            chunk = data[pos:pos + count * nb]
            if len(chunk) < count * nb:
                raise Refused("image file is truncated")
            out += chunk
            pos += count * nb
    return bytes(out[:end])


def read_tga(data: bytes) -> Iterator[Frame]:
    """The one frame of a TGA file."""
    hd = _header(data)
    if hd is None or not is_tga(data):
        raise unsupported("TGA header that Pillow's TGA plugin refuses")
    id_len, cmap_type, itype, cmap_start, cmap_len, cmap_depth, w, h, \
        depth, flags = hd
    orient = flags & 0x30
    flip = orient in (0x10, 0x30)
    top_first = orient in (0x20, 0x30)
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    pos = 18 + id_len
    info: dict = {}
    if cmap_type:
        nb = {16: 2, 24: 3, 32: 4}[cmap_depth]
        raw = data[pos:pos + nb * cmap_len]
        pos += nb * cmap_len
        if len(raw) < nb * cmap_len:
            raise unsupported("TGA colour map cut short")
        ent = np.frombuffer(raw, np.uint8).reshape(cmap_len, nb)
        if mode == "P":
            if nb != 3:
                raise unsupported(f"TGA with a {cmap_depth}-bit colour map "
                                  f"(Pillow raises ValueError on it)")
            full = np.zeros((cmap_start + cmap_len, 3), np.uint8)
            full[cmap_start:] = ent[:, 2::-1]
            info["palette"] = full
    n = w * h
    if depth == 1:
        if itype & 8:
            raise unsupported("1-bit RLE TGA")
        nbytes = (w + 7) // 8
        raw = data[pos:pos + nbytes * h]
        if len(raw) < nbytes * h:
            raise Refused("image file is truncated")
        rows = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, nbytes),
                             axis=1)[:, :w] * np.uint8(255)
        px = rows
    else:
        nb = depth // 8
        if itype & 8:
            raw = _rle(data, pos, n, nb)
        else:
            raw = data[pos:pos + n * nb]
            if len(raw) < n * nb:
                if (itype, mode) in ((1, "P"), (3, "L")):
                    # Pillow maps such a file into memory and raises
                    # ValueError where it is too short.
                    raise unsupported("uncompressed 8-bit TGA cut short")
                raise Refused("image file is truncated")
        px = _unpack(raw, n, itype & 7, depth).reshape((h, w) + (
            () if nb == 1 and mode != "LA" else (-1,)))
    if not top_first:
        px = px[::-1]
    if flip:
        px = px[:, ::-1]
    if mode == "P":
        pal = info["palette"]
        if px.size and int(px.max()) >= len(pal):
            raise unsupported("TGA index past its colour map")
    yield Frame(np.ascontiguousarray(px), mode, info)
