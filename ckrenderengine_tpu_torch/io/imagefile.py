"""Image files on the host: the readers behind ``CKTexture.LoadImage`` and
``CKSprite.LoadMovie``.

The JAX package reads these files through Pillow
(``Image.open(path).convert("RGBA")``, and ``ImageSequence.Iterator`` for
movies), which this package does not use. The readers here give the same
RGBA bytes for every file they accept. :func:`open_image` picks the reader
by the file's leading bytes, as Pillow's plugins do (by content, not by
extension):

- ``png.read_png``: PNG and APNG;
- ``gif.read_gif``: GIF, still or animated;
- ``bmp.read_bmp``: Windows bitmaps;
- ``jpeg.read_jpeg``: baseline and progressive Huffman JPEG;
- ``tiff.read_tiff``: TIFF, one page or several;
- an AVI (:func:`is_avi`) is a movie, which ``avi.read_avi`` reads for
  ``LoadMovie`` and Pillow refuses as an image;
- ``tga.read_tga``: Truevision TGA, which has no signature and is tried
  last, as in Pillow.

A reader yields :class:`Frame` s: the pixels in a Pillow mode and the
frame's ``info``. :func:`to_rgba` then gives Pillow's ``convert("RGBA")``
of a frame. A reader raises :class:`Refused` where Pillow raises
``OSError`` for the file (the reference then returns False), and item 14
of the port queue (:func:`unsupported`) for a variant that it does not
read.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from ..roadmap import unported


class Refused(OSError):
    """Pillow refuses this file with ``OSError`` (or its subclass
    ``UnidentifiedImageError``): the reference's ``LoadImage`` returns
    False for it."""


class Frame(NamedTuple):
    """One image or movie frame as Pillow holds it.

    ``pixels``: (H, W) for the modes "1", "L", "P" and "I;16" (uint16),
    else (H, W, bands), uint8. ``mode``: Pillow's mode. ``info``: the keys
    that matter here: ``palette`` ((N, 3) uint8, mode "P"),
    ``transparency`` (Pillow's: an index or a byte string of alphas for
    "P", a value for "1", "L" and "I;16", a triple for "RGB") and
    ``duration`` (ms; absent where Pillow reports none)."""

    pixels: np.ndarray
    mode: str
    info: dict


def unsupported(what: str) -> NotImplementedError:
    """The error for an image file variant that the readers do not read."""
    return unported(f"image files: {what}", 14)


def unsupported_movie(what: str) -> NotImplementedError:
    """The error for an AVI variant (codec, pixel layout) that the movie
    readers (``avi.py`` and its decoders) do not read."""
    return unported(f"movie sprites from AVI files: {what} (LoadMovie)", 14)


def _reader(head: bytes):
    """The reader for a file that starts with ``head``, or None."""
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        from .png import read_png
        return read_png
    if head[:6] in (b"GIF87a", b"GIF89a"):
        from .gif import read_gif
        return read_gif
    if head[:2] == b"BM":
        from .bmp import read_bmp
        return read_bmp
    if head[:3] == b"\xff\xd8\xff":
        from .jpeg import read_jpeg
        return read_jpeg
    if head[:4] in (b"II*\0", b"MM\0*"):
        from .tiff import read_tiff
        return read_tiff
    if is_avi(head):
        return _avi
    return None


def is_avi(head: bytes) -> bool:
    """An AVI file (``RIFF....AVI ``): a movie, which ``avi.read_avi``
    reads for ``LoadMovie``. Other RIFF forms (WebP, an OpenDML ``AVIX``
    part on its own) are not read."""
    return head[:4] == b"RIFF" and head[8:12] == b"AVI "


def _avi(data: bytes) -> Iterator[Frame]:
    """Pillow refuses an AVI as an image (``LoadImage`` returns False)."""
    raise Refused("an AVI movie is not an image file")
    yield


def frames(path: str) -> Iterator[Frame] | None:
    """The frames of the image file at ``path``, decoded one by one as the
    iterator is advanced; None where the file cannot be read (Pillow's
    ``Image.open`` raises ``FileNotFoundError`` there, an ``OSError``).
    Raises item 14 of the port queue (:func:`unsupported`) for a file that
    no reader here takes."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    reader = _reader(data[:16])
    if reader is None:
        from .tga import is_tga, read_tga
        if not is_tga(data):
            raise unsupported(f"{path!r} is in a format that this package "
                              f"does not read (leading bytes "
                              f"{data[:12]!r})")
        reader = read_tga
    return reader(data)


def open_image(path: str) -> Frame | bool:
    """The first frame of the file at ``path`` (what ``Image.open`` loads),
    or False where the reference's ``LoadImage`` returns False: a missing
    file, or a file that Pillow refuses with ``OSError``."""
    it = frames(path)
    if it is None:
        return False
    try:
        return next(it)
    except Refused:
        return False


def to_rgba(pixels: np.ndarray, mode: str, info: dict) -> np.ndarray:
    """Pillow's ``convert("RGBA")`` of a frame: (H, W, 4) uint8.

    - "P": the palette's colour; the alpha from ``transparency`` (an index
      made transparent, or one alpha per entry from a tRNS byte string);
    - "1", "L", "LA": grey to R, G and B; alpha 255 ("1" and "L") unless
      the pixel equals ``transparency``;
    - "I;16": each value clipped to 255 (not scaled), then compared with
      ``transparency``;
    - "RGB": alpha 255 unless the pixel equals the ``transparency`` triple.

    A ``transparency`` value is compared by its low byte, as Pillow's
    conversion does: a 16-bit tRNS value of 261 makes grey 5 transparent.
    """
    trns = info.get("transparency")
    h, w = pixels.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if mode == "P":
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        p = np.asarray(info["palette"], np.uint8).reshape(-1, 3)[:256]
        pal[:len(p), :3] = p
        if isinstance(trns, (bytes, bytearray)):
            a = np.frombuffer(bytes(trns[:256]), np.uint8)
            pal[:len(a), 3] = a
        elif trns is not None:
            pal[int(trns), 3] = 0
        return pal[pixels]
    if mode in ("1", "L", "I;16"):
        grey = pixels
        if mode == "I;16":
            grey = np.minimum(pixels, 255).astype(np.uint8)
        out[..., :3] = grey[..., None]
        out[..., 3] = 255
        if trns is not None:
            out[..., 3][grey == (int(trns) & 0xFF)] = 0
        return out
    if mode == "LA":
        out[..., :3] = pixels[..., :1]
        out[..., 3] = pixels[..., 1]
        return out
    if mode == "RGB":
        out[..., :3] = pixels
        out[..., 3] = 255
        if trns is not None:
            key = np.asarray(trns, np.int64).reshape(1, 1, 3) & 0xFF
            hit = np.all(pixels == key, axis=2)
            out[..., 3][hit] = 0
        return out
    if mode == "RGBA":
        return np.ascontiguousarray(pixels, np.uint8)
    raise unsupported(f"mode {mode!r}")
