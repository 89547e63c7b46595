"""A PNG writer for 8-bit images, written with ``zlib`` and ``struct``.

The JAX package writes its screen dumps with Pillow
(``CKRenderContext.DumpToFile``), which this package does not use. The
files written here hold the same pixels: RGBA as colour type 6, grey as
colour type 0, 8 bits per sample, no interlace, every scanline with filter
type 0. The compressed bytes differ from Pillow's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 4: 6}         # channels -> PNG colour type (L, RGBA)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image, (H, W) grey or (H, W, 4) RGBA, to ``path``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 4), not "
                         f"{img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)          # filter byte 0
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
