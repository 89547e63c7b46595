"""Microsoft Video 1 frames (AVI ``CRAM`` / ``MSVC``), decoded as FFmpeg's
``msvideo1`` decoder decodes them: 8-bit palettised (``pal8``) or 16-bit
RGB555 (``rgb555``).

The picture is cut into 4x4 blocks, coded from the bottom-left block,
each block's rows from the bottom up. Every block opens with two bytes
(a, b):

- ``(b & 0xFC) == 0x84``: skip ``((b - 0x84) << 8) + a`` blocks, which
  keep the previous frame's pixels (the decoder keeps one frame; the
  first starts from zeros);
- ``b < 0x80``: 16 flags, then two colours (a flag set picks the first);
  at 16 bits, a first colour with its top bit set means eight colours,
  a pair per 2x2 quadrant;
- at 8 bits, ``b >= 0x90``: eight colours, a pair per quadrant;
- otherwise one colour: the word ``b << 8 | a`` at 16 bits, ``a`` at 8.

Columns and rows past the last whole block are never written. The data
ending early ends the frame where it stands, as in FFmpeg.
"""

from __future__ import annotations

import numpy as np

# The colour index of pixel (y, x) of a block in eight-colour mode, with
# the flag's "pick the first" bit still to be added: 2 * quadrant.
_QUAD = np.array([[((y & 2) << 1) + (x & 2) for x in range(4)]
                  for y in range(4)])


def decode_msvideo1(buf: bytes, pic: np.ndarray, width: int, height: int,
                    bits: int) -> bool:
    """Paint one packet over ``pic`` ((height, width) uint8 indices at 8
    bits, uint16 RGB555 words at 16; kept between frames). False where
    FFmpeg gives no frame (a packet too small for the picture)."""
    bw, bh = width // 4, height // 4
    if len(buf) < bw * bh // 512:
        return False
    total = bw * bh
    i, n = 0, len(buf)
    skip = 0
    rd = int.from_bytes
    for by in range(bh - 1, -1, -1):
        for bx in range(bw):
            if skip:
                skip -= 1
                total -= 1
                continue
            if n - i < 2:
                return True
            a, b = buf[i], buf[i + 1]
            i += 2
            blk = pic[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            if a == 0 and b == 0 and total == 0:
                return True
            if b & 0xFC == 0x84:
                skip = ((b - 0x84) << 8) + a - 1
            elif b < 0x80 or (bits == 8 and b >= 0x90):
                flags = (b << 8) | a
                if bits == 16:
                    if n - i < 4:
                        return True
                    cols = [rd(buf[i:i + 2], "little"),
                            rd(buf[i + 2:i + 4], "little")]
                    i += 4
                    eight = bool(cols[0] & 0x8000)
                    if eight:
                        if n - i < 12:
                            return True
                        cols += [rd(buf[i + 2 * k:i + 2 * k + 2], "little")
                                 for k in range(6)]
                        i += 12
                else:
                    eight = b >= 0x90
                    k = 8 if eight else 2
                    if n - i < k:
                        return True
                    cols = list(buf[i:i + k])
                    i += k
                # Flag bit j is pixel j of the block, rows bottom up.
                pick = np.array([((flags >> j) & 1) ^ 1 for j in range(16)]
                                ).reshape(4, 4)
                idx = pick + _QUAD if eight else pick
                blk[...] = np.asarray(cols, pic.dtype)[idx][::-1]
            else:
                blk[...] = (b << 8) | a if bits == 16 else a
            total -= 1
    return True
