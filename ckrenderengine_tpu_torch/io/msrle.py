"""Microsoft RLE frames (AVI ``BI_RLE8`` and ``BI_RLE4``), decoded as
FFmpeg's ``msrle`` decoder (``msrle.c``, ``msrledec.c``) decodes them.

The decoder keeps one ``pal8`` frame: a frame's codes paint over the
previous frame, so the pixels that a delta or an early end skips keep
their values, and the first frame starts from zeros. Rows run from the
bottom of the picture up. A packet exactly the size of an uncompressed
bottom-up frame is taken as uncompressed, as FFmpeg guesses. The codes:

- ``n, c`` (n > 0): a run of n pixels of index c (RLE4: the two nibbles
  of c in turn);
- ``0, 0``: end of line; ``0, 1``: end of picture; ``0, 2, dx, dy``: a
  delta;
- ``0, n`` (n > 2): n literal pixels, padded to a 16-bit boundary.

An error in the codes ends the frame where it stands, as in FFmpeg.
"""

from __future__ import annotations

import numpy as np


def _decode8(buf: bytes, pic: np.ndarray) -> None:
    """``msrle_decode_8_16_24_32`` at depth 8, on (H, stride) ``pic``:
    runs may carry on into the next row of memory, as in FFmpeg."""
    h, stride = pic.shape
    flat = pic.reshape(-1)
    end = h * stride                 # output_end: one past the top row
    line, pos = h - 1, 0
    out = line * stride
    i, n = 0, len(buf)
    while i < n:
        p1 = buf[i]
        i += 1
        if p1 == 0:
            p2 = buf[i] if i < n else 0
            i += 1
            if p2 == 0:                                  # end of line
                line -= 1
                if line < 0:
                    return
                out, pos = line * stride, 0
                continue
            if p2 == 1:                                  # end of picture
                return
            if p2 == 2:                                  # delta
                dx = buf[i] if i < n else 0
                dy = buf[i + 1] if i + 1 < n else 0
                i += 2
                line -= dy
                pos += dx
                if line < 0 or pos >= stride:
                    return
                out = line * stride + pos
                continue
            if out + p2 > end:                           # copy past the end
                i += 2
                continue
            if n - i < p2:
                return
            flat[out:out + p2] = np.frombuffer(buf, np.uint8, p2, i)
            out += p2
            i += p2 + (p2 & 1)
            pos += p2
        else:                                            # a run
            if out + p1 > end:
                continue
            v = buf[i] if i < n else 0
            i += 1
            flat[out:out + p1] = v
            out += p1
            pos += p1


def _decode4(buf: bytes, pic: np.ndarray, width: int) -> None:
    """``msrle_decode_pal4``: runs and literals clipped to the row."""
    h = pic.shape[0]
    line, x = h - 1, 0
    i, n = 0, len(buf)
    while line >= 0 and x <= width:
        if i >= n:
            return
        code = buf[i]
        i += 1
        if code == 0:
            b = buf[i] if i < n else 0
            i += 1
            if b == 0:
                line -= 1
                x = 0
            elif b == 1:
                return
            elif b == 2:
                dx = buf[i] if i < n else 0
                dy = buf[i + 1] if i + 1 < n else 0
                i += 2
                x += dx
                line -= dy
            else:
                odd = b & 1
                count = (b + 1) // 2
                if x + 2 * count - odd > width or n - i < count:
                    return
                for k in range(count):
                    if x >= width:
                        break
                    v = buf[i]
                    i += 1
                    pic[line, x] = v >> 4
                    x += 1
                    if k + 1 == count and odd:
                        break
                    if x >= width:
                        break
                    pic[line, x] = v & 15
                    x += 1
                if count & 1:
                    i += 1
        else:
            if x + code > width + 1:
                return
            v = buf[i] if i < n else 0
            i += 1
            for k in range(code):
                if x >= width:
                    break
                pic[line, x] = v >> 4 if not k & 1 else v & 15
                x += 1


def decode_msrle(buf: bytes, pic: np.ndarray, width: int, height: int,
                 bits: int) -> bool:
    """Paint one packet over ``pic`` ((height, stride) uint8 palette
    indices, kept between frames; stride at least ``width``). False where
    FFmpeg gives no frame (a packet under 2 bytes)."""
    if len(buf) < 2:
        return False
    istride = (width * bits + 31) // 32 * 4
    if height * istride == len(buf):                     # uncompressed
        rows = np.frombuffer(buf, np.uint8).reshape(height, istride)[::-1]
        if bits == 4:
            px = np.stack([rows >> 4, rows & 15], axis=2).reshape(
                height, -1)
            pic[:, :width] = px[:, :width]
        else:
            pic[:, :width] = rows[:, :width]
        return True
    if bits == 8:
        _decode8(buf, pic)
    else:
        _decode4(buf, pic, width)
    return True
