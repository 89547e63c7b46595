"""Pixel-format conversion of decoded video frames to RGB, as FFmpeg's
libswscale converts them to BGR24 for OpenCV's ``VideoCapture``.

OpenCV's FFmpeg backend (the reference's ``LoadMovie`` of a video file)
asks swscale for BGR24 at the frame's own size with ``SWS_BICUBIC`` and
no accurate rounding. Which code converts a frame then depends on the
source format and the frame's size; this module follows each route that
the AVI codecs of :mod:`.avi` reach, in the fixed-point arithmetic of that
route, and returns RGB (the reference reverses OpenCV's BGR):

- ``yuv420p`` / ``yuv422p`` (and the full-range ``yuvj`` forms that
  MJPEG gives) of even height: the unscaled converter, which x86 builds
  run as ``yuv420_bgr24_ssse3``. Chroma is taken from its nearest sample
  and each term is a 16-bit ``pmulhw`` product (:func:`_pmulhw_rgb`).
- Every other YUV frame (packed 4:2:2, 4:2:0 and 4:2:2 planar of odd
  height, 4:4:4, 4:4:0, 4:1:1): the scaler (:func:`_scaler`). Its
  bicubic filters (``initFilter``, :func:`_init_filter`) bring chroma to
  the output's chroma grid: half the width, or the whole width where the
  width is odd or the source is 4:4:4 (``SWS_FULL_CHR_H_INT``), and every
  row. Packed output runs MMX code on every row but the last two, which
  swscale writes with its C code and lookup tables (:func:`_ctable`);
  full-chroma output is C (``yuv2rgb_write_full``, :func:`_write_full`).
- ``gray``: the palette route, grey i to (i, i, i); ``pal8``: the
  palette's colour; ``rgb555`` / ``rgb565``: each field widened by
  replicating its top bits; ``bgr24``, ``bgr0``, ``rgb24``, ``rgba``:
  the bytes reordered, alpha dropped.

The colour matrix is swscale's default (ITU-R BT.601), limited range for
``yuv*`` and full range for ``yuvj*``, as OpenCV sets no other. The
fixed-point steps were found against OpenCV 5.0.0's FFmpeg 8 build on an
x86-64 host: every (Y, U, V) pair tabulated, and random planes of every
size from 1x1 to 71x71.
"""

from __future__ import annotations

import numpy as np

from .imagefile import unsupported_movie

# ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]: Cr->R, Cb->B, Cb->G, Cr->G in 16.16.
_BT601 = (104597, 132201, 25675, 53279)


def _round16(f: int) -> int:
    """swscale's ``roundToInt16``: a 16.16 product rounded to an int16."""
    return max(-32768, min(32767, (f + (1 << 15)) >> 16))


def _trunc_div(a: int, b: int) -> int:
    """C integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _coefficients(full: bool):
    """``ff_yuv2rgb_c_init_tables``' cy, oy, crv, cbu, cgu, cgv (16.16) at
    contrast and saturation 1, brightness 0."""
    crv, cbu, cgu, cgv = _BT601[0], _BT601[1], -_BT601[2], -_BT601[3]
    cy, oy = 1 << 16, 0
    if not full:
        cy = cy * 255 // 219
        oy = 16 << 16
    else:
        crv, cbu, cgu, cgv = (_trunc_div(c * 224, 255)
                              for c in (crv, cbu, cgu, cgv))
    return cy, oy, crv, cbu, cgu, cgv


def _ctable(y, u, v, full: bool) -> np.ndarray:
    """The C converter's lookup tables (``yuv2rgb.c``, 24 bits per pixel):
    one clipped luma table indexed by Y plus a chroma offset per channel,
    the chroma coefficients rescaled by the luma gain."""
    cy, oy, crv, cbu, cgu, cgv = _coefficients(full)
    crv, cbu, cgu, cgv = (_trunc_div(c * 65536 + 0x8000, cy)
                          for c in (crv, cbu, cgu, cgv))
    yoffs = 384 if full else 326
    y, u, v = (a.astype(np.int64) for a in (y, u, v))

    def look(i):
        return np.clip(((yoffs + i) * cy - (384 << 16) - oy + 0x8000) >> 16,
                       0, 255)

    r = look(y + ((v * crv) >> 16) - (crv >> 9))
    g = look(y + ((u * cgu) >> 16) - (cgu >> 9) + ((v * cgv) >> 16)
             - (cgv >> 9))
    b = look(y + ((u * cbu) >> 16) - (cbu >> 9))
    return np.stack([r, g, b], -1).astype(np.uint8)


def _write_full(y, u, v, full: bool) -> np.ndarray:
    """``yuv2rgb_write_full``: Y, U and V as the full-chroma output
    functions hand them over (Y at 19 bits, U and V at 19 bits less the
    offset), 30-bit sums clipped, the top 8 bits kept."""
    cy, oy, crv, cbu, cgu, cgv = _coefficients(full)
    y_coeff, y_off = _round16(cy * 8192), _round16(oy * 512)
    vr, ub, ug, vg = (_round16(c * 8192) for c in (crv, cbu, cgu, cgv))
    y = (y - y_off) * y_coeff + (1 << 21)
    # Unsigned 32-bit sums read back as int: past 2^31 they turn negative
    # and clip to 0.
    rgb = [y + v * vr, y + v * vg + u * ug, y + u * ub]
    return np.stack([np.clip(_int32(c), 0, (1 << 30) - 1) >> 22
                     for c in rgb], -1).astype(np.uint8)


def _pmulhw_rgb(y8, u8, v8, full: bool) -> np.ndarray:
    """The MMX / SSSE3 conversion of Y, U, V at 8x scale (the samples
    shifted left by 3, or the vertical scaler's sums): each term the high
    half of a 16x16 product (``pmulhw``), the three added and saturated
    to 8 bits."""
    cy, oy, crv, cbu, cgu, cgv = _coefficients(full)
    y_coeff, y_off = _round16(cy * 8192), _round16(oy * 8)
    vr, ub, ug, vg = (_round16(c * 8192) for c in (crv, cbu, cgu, cgv))
    y = ((y8 - y_off) * y_coeff) >> 16
    u8, v8 = u8 - 1024, v8 - 1024
    r = y + ((v8 * vr) >> 16)
    g = y + ((u8 * ug) >> 16) + ((v8 * vg) >> 16)
    b = y + ((u8 * ub) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# -- the scaler: swscale's general path at a 1:1 luma size --------------------

def _local_pos(sub: int) -> int:
    """``get_local_pos`` at the default chroma siting: a sample's centre
    in 1/256 of a pixel of its own plane."""
    return ((128 << sub) - 128 + 128) >> sub


def _init_filter(inc: int, src: int, dst: int, align: int, one: int,
                 src_pos: int, dst_pos: int):
    """swscale's ``initFilter`` for ``SWS_BICUBIC`` (B = 0, C = 0.6):
    the int64 cubic weights, the near-zero taps trimmed (cut-off 0.002),
    the size rounded up to ``align`` (1 where every row needs one tap,
    as x86 builds allow), the taps past either edge folded onto it, and
    each row normalized to ``one`` with its rounding error carried.
    Returns ((dst, size) int64 coefficients, (dst,) int64 first source
    sample of each)."""
    fone = 1 << (54 - min(max((src // dst).bit_length() - 1, 0), 8))
    if abs(inc - 0x10000) < 10 and src_pos == dst_pos:
        size = 1
        rows = [[fone] for _ in range(dst)]
        pos = list(range(dst))
    else:
        size = 5 if inc <= 1 << 16 else 1 + (4 * src + dst - 1) // dst
        size = max(min(size, src - 2), 1)
        x = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        c6 = int(0.6 * (1 << 24))
        rows, pos = [], []
        for _ in range(dst):
            xx = _trunc_div(x - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _j in range(size):
                d = abs(xx * (1 << 17) - x) << 13
                if inc > 1 << 16:
                    d = _trunc_div(d * dst, src)
                if d >= 1 << 31:
                    coeff = 0
                else:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = ((12 * (1 << 24) - 6 * c6) * ddd
                                 + (-18 * (1 << 24) + 6 * c6) * dd
                                 + 6 * (1 << 24) * (1 << 30))
                    else:
                        coeff = (-6 * c6 * ddd + 30 * c6 * dd
                                 - 48 * c6 * d + 24 * c6 * (1 << 30))
                row.append(_trunc_div(coeff, (1 << 54) // fone))
                xx += 1
            rows.append(row)
            x += 2 * inc
    wide = size
    cut = 0.002 * fone
    need = 0
    for i in range(dst - 1, -1, -1):
        row, acc = rows[i], 0
        for _j in range(wide):
            acc += abs(row[0])
            if acc > cut or (i < dst - 1 and pos[i] >= pos[i + 1]):
                break
            row[:] = row[1:] + [0]
            pos[i] += 1
        acc, n = 0, wide
        for j in range(wide - 1, 0, -1):
            acc += abs(row[j])
            if acc > cut:
                break
            n -= 1
        need = max(need, n)
    if need == 1 and align == 2:
        align = 1
    size = (need + align - 1) & ~(align - 1)
    rows = [[row[j] if j < wide else 0 for j in range(size)] for row in rows]
    for i, row in enumerate(rows):
        if pos[i] < 0:
            for j in range(1, size):
                left = max(j + pos[i], 0)
                row[left] += row[j]
                row[j] = 0
            pos[i] = 0
        if pos[i] + size > src:
            shift = pos[i] + min(size - src, 0)
            acc = 0
            for j in range(size - 1, -1, -1):
                if pos[i] + j >= src:
                    acc += row[j]
                    row[j] = 0
            for j in range(size - 1, -1, -1):
                row[j] = 0 if j < shift else row[j - shift]
            pos[i] -= shift
            row[src - 1 - pos[i]] += acc
    out = np.zeros((dst, size), np.int64)
    for i, row in enumerate(rows):
        total = (sum(row) + one // 2) // one or 1
        err = 0
        for j in range(size):
            v = row[j] + err
            half = total >> 1
            iv = _trunc_div(v + half if v >= 0 else v - half, total)
            out[i, j] = iv
            err = v - iv * total
    return out, np.asarray(pos, np.int64)


def _taps(plane: np.ndarray, coef: np.ndarray, pos: np.ndarray, axis: int):
    """The filter's taps of ``plane`` along ``axis``: (..., dst, size)
    samples (past the edge only where the weight is 0)."""
    idx = np.minimum(pos[:, None] + np.arange(coef.shape[1]),
                     plane.shape[axis] - 1)
    return np.take(plane, idx, axis=axis)


def _hscale(plane: np.ndarray, dst_w: int, src_sub: int,
            dst_sub: int) -> np.ndarray:
    """``hScale8To15``: each row of 8-bit chroma filtered to ``dst_w``
    15-bit samples (sum of products >> 7, capped at 32767)."""
    src_w = plane.shape[1]
    inc = ((src_w << 16) + (dst_w >> 1)) // dst_w
    coef, pos = _init_filter(inc, src_w, dst_w, 4, 1 << 14,
                             _local_pos(src_sub), _local_pos(dst_sub))
    taps = _taps(plane.astype(np.int64), coef, pos, 1)     # (h, dst, size)
    return np.minimum((taps * coef).sum(-1) >> 7, 32767)


def int16(x):
    """Integers wrapped to int16, as a 16-bit register or store keeps
    them."""
    return ((x + 32768) & 0xFFFF) - 32768


def _int32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _scaler(y, u, v, sub_x: int, sub_y: int, full: bool) -> np.ndarray:
    """swscale's general path to BGR24 at the frame's own size (``y``
    (H, W); ``u``, ``v`` subsampled by 2^``sub_x`` across and
    2^``sub_y`` down): chroma scaled by its bicubic filters to the
    output's chroma grid (half width, or full width where the width is
    odd or the source has 4:4:4 chroma; 15-bit samples), then each output
    row written by the vertical output function swscale picks for it.
    Packed output runs the MMX versions (a rounder of 4 in ``_X``) on all
    rows but the last two, which get the C versions; full-chroma output is
    C throughout. Luma is never scaled."""
    h, w = y.shape
    full_chroma = bool(w & 1) or (sub_x == 0 and sub_y == 0)
    dst_w = w if full_chroma else (w + 1) // 2
    cu = _hscale(u, dst_w, sub_x, 0 if full_chroma else 1)
    cv = _hscale(v, dst_w, sub_x, 0 if full_chroma else 1)
    src_h = u.shape[0]
    inc = ((src_h << 16) + (h >> 1)) // h
    coef, pos = _init_filter(inc, src_h, h, 2, 1 << 12, _local_pos(sub_y),
                             _local_pos(0))
    size = coef.shape[1]
    tu = _taps(cu, coef, pos, 0)                # (h, size, dst_w)
    tv = _taps(cv, coef, pos, 0)
    f = coef[:, :, None]
    y15 = y.astype(np.int64) << 7
    # Per output row, vscale calls yuv2*_1 where the chroma filter has one
    # tap, or two summing to 4096 with the second (the alpha) in [0,
    # 4096], else yuv2*_X. The MMX yuv2bgr24_1 takes the first row below
    # an alpha of 2048 and the two rows' mean from there; the C
    # yuv2rgb24_1 weighs the rows by the alpha as _X does, and the C
    # yuv2rgb_full_1 weighs them without _X's rounding term.
    one = np.full((h, 1), size == 1)
    alpha = np.zeros((h, 1), np.int64)
    if size == 2:
        c0, alpha = coef[:, :1], coef[:, 1:]
        one = (c0 + alpha == 4096) & (alpha >= 0) & (alpha <= 4096)
    two = one & (alpha >= 2048)
    t0 = [t[:, 0] for t in (tu, tv)]
    t1 = [t[:, min(1, size - 1)] for t in (tu, tv)]
    if full_chroma:
        uu, vv = (np.where(one, (a * (4096 - alpha) + b * alpha
                                 - (128 << 19)) >> 10,
                           ((1 << 9) - (128 << 19) + (t * f).sum(1)) >> 10)
                  for a, b, t in zip(t0, t1, (tu, tv)))
        return _write_full(y15 * 4, uu, vv, full)

    def wide(a):                        # a chroma sample per pixel pair
        return np.repeat(a, 2, axis=-1)[..., :w]

    mu, mv = (np.where(one, np.where(two, ((a + b) & 0xFFFF) >> 5, a >> 4),
                       int16(4 + ((t * f) >> 16).sum(1)))
              for a, b, t in zip(t0, t1, (tu, tv)))
    my = np.where(one, y15 >> 4, 4 + ((y15 * 4096) >> 16))
    c_u, c_v = (((1 << 18) + (t * f).sum(1)) >> 19 for t in (tu, tv))
    out = _pmulhw_rgb(my, wide(mu), wide(mv), full)
    k = max(h - 2, 0)
    c_u, c_v = (np.clip(c[k:], 0, 255) for c in (c_u, c_v))
    out[k:] = _ctable(y[k:], wide(c_u), wide(c_v), full)
    return out


def yuv_to_rgb(fmt: str, y: np.ndarray, u: np.ndarray,
               v: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) uint8 of planar or packed YUV samples: ``y`` (H, W),
    ``u`` and ``v`` the chroma planes at their own resolution ((H, ceil
    W/2) for 4:2:2, (ceil H/2, ceil W/2) for 4:2:0, (ceil H/2, W) for
    4:4:0, (H, ceil W/4) for 4:1:1, (H, W) for 4:4:4). ``fmt``:
    ``yuv420p``, ``yuv422p``, ``yuyv422``, ``uyvy422`` (limited range) or
    ``yuvj420p``, ``yuvj422p``, ``yuvj444p``, ``yuvj440p``, ``yuvj411p``
    (full range)."""
    h, w = y.shape
    full = fmt.startswith("yuvj")
    if fmt.endswith(("420p", "422p")) and not h & 1:
        # The unscaled converter: nearest chroma.
        cu = np.repeat(u, 2, axis=1)[:, :w]
        cv = np.repeat(v, 2, axis=1)[:, :w]
        if fmt.endswith("420p"):
            cu = np.repeat(cu, 2, axis=0)[:h]
            cv = np.repeat(cv, 2, axis=0)[:h]
        return _pmulhw_rgb(y.astype(np.int32) << 3,
                           cu.astype(np.int32) << 3,
                           cv.astype(np.int32) << 3, full)
    sub_x, sub_y = {"420p": (1, 1), "422p": (1, 0), "uyvy422": (1, 0),
                    "yuyv422": (1, 0), "444p": (0, 0), "440p": (0, 1),
                    "411p": (2, 0)}[next(k for k in (
                        "420p", "422p", "uyvy422", "yuyv422", "444p",
                        "440p", "411p") if fmt.endswith(k))]
    return _scaler(y, u, v, sub_x, sub_y, full)


def image_size_ok(w: int, h: int) -> bool:
    """FFmpeg's ``av_image_check_size``: a frame of this size is refused
    (OpenCV then opens nothing or reads no frame)."""
    return 0 < w and 0 < h and (w + 128) * (h + 128) < (2**31 - 1) // 8


def packed_yuv(fmt: str, buf: np.ndarray, width: int, height: int):
    """The Y, U and V samples of a packed 4:2:2 frame (``yuyv422`` or
    ``uyvy422``), rows of ``ceil(width / 2) * 4`` bytes."""
    cw = (width + 1) // 2
    px = buf[:height * cw * 4].reshape(height, cw, 4)
    if fmt == "yuyv422":
        y0, u, y1, v = (px[..., i] for i in range(4))
    else:
        u, y0, v, y1 = (px[..., i] for i in range(4))
    y = np.stack([y0, y1], axis=2).reshape(height, 2 * cw)[:, :width]
    return y, u, v


def rgb16_to_rgb(px: np.ndarray, green_bits: int) -> np.ndarray:
    """``rgb555`` (``green_bits`` 5) or ``rgb565`` (6) words to RGB, each
    field widened by replicating its top bits."""
    px = px.astype(np.int32)
    gb = green_bits
    r = (px >> (5 + gb)) & 31
    g = (px >> 5) & ((1 << gb) - 1)
    b = px & 31
    out = np.stack([(r << 3) | (r >> 2),
                    (g << (8 - gb)) | (g >> (2 * gb - 8)),
                    (b << 3) | (b >> 2)], -1)
    return out.astype(np.uint8)
