"""PNG files, written with ``zlib`` and ``struct``, and read.

The JAX package writes its screen dumps with Pillow
(``CKRenderContext.DumpToFile``), which this package does not use. The
files written here hold the same pixels: RGBA as colour type 6, grey as
colour type 0, 8 bits per sample, no interlace, every scanline with filter
type 0. The compressed bytes differ from Pillow's.

:func:`read_png` reads PNG and APNG files as Pillow's ``PngImagePlugin``
does: every colour type and bit depth, PLTE and tRNS, the five filter
types, Adam7 interlace, and APNG frames composed with their dispose and
blend ops. gAMA, iCCP and sRGB are not applied, as in Pillow.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator

import numpy as np

from .imagefile import Frame, Refused, unsupported

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


# -- reading ---------------------------------------------------------------

# (bit depth, colour type) -> (Pillow's mode, samples per pixel).
_MODES = {(1, 0): ("1", 1), (2, 0): ("L", 1), (4, 0): ("L", 1),
          (8, 0): ("L", 1), (16, 0): ("I;16", 1),
          (8, 2): ("RGB", 3), (16, 2): ("RGB", 3),
          (1, 3): ("P", 1), (2, 3): ("P", 1), (4, 3): ("P", 1),
          (8, 3): ("P", 1),
          (8, 4): ("LA", 2), (16, 4): ("RGBA", 2),
          (8, 6): ("RGBA", 4), (16, 6): ("RGBA", 4)}

# Adam7: (x0, y0, dx, dy) of each pass.
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_SIMPLE_TRNS = __import__("re").compile(b"^\xff*\x00\xff*$")


def _is_cid(cid: bytes) -> bool:
    return len(cid) == 4 and all(65 <= c <= 90 or 97 <= c <= 122
                                 for c in cid)


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG filters of ``raw`` ((H, 1 + R) uint8 scanlines, each
    led by its filter type; R a multiple of ``bpp``): the (H, R) bytes.

    Rows of filter types 3 (Average) and 4 (Paeth) depend on the byte
    ``bpp`` to the left and on the row above, so the rows are undone along
    anti-diagonals of ``bpp``-byte units: unit (y, x) needs (y, x - 1),
    (y - 1, x) and (y - 1, x - 1), all on earlier diagonals."""
    h, r1 = raw.shape
    ft = raw[:, 0].astype(np.int16)
    if (ft > 4).any():
        raise Refused("unknown PNG filter type")
    data = raw[:, 1:]
    if not ft.any():
        return data.copy()
    n = (r1 - 1) // bpp
    units = data.reshape(h, n, bpp).astype(np.int16)
    # Skewed store: unit (y, x) at s[y + 1, x + y + 1]; row 0 and the
    # column left of each row stay zero (the filters' "outside" bytes).
    s = np.zeros((h + 1, n + h + 1, bpp), np.int16)
    ys_all = np.arange(h)
    f = ft[:, None]
    for d in range(n + h - 1):
        y0, y1 = max(0, d - n + 1), min(h - 1, d)
        ys = ys_all[y0:y1 + 1]
        r = units[ys, d - ys]
        a = s[ys + 1, d]
        b = s[ys, d]
        c = s[ys, d - 1] if d else np.zeros_like(a)
        fy = f[y0:y1 + 1]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(fy == 1, a, np.where(fy == 2, b, np.where(
            fy == 3, (a + b) >> 1, np.where(fy == 4, paeth, 0))))
        s[ys + 1, d + 1] = (r + pred) & 0xFF
    x = np.arange(n)
    out = s[ys_all[:, None] + 1, x[None, :] + ys_all[:, None] + 1]
    return out.astype(np.uint8).reshape(h, n * bpp)


def _samples(rows: np.ndarray, width: int, depth: int, spp: int):
    """Unfiltered scanlines (H, R) -> samples (H, W, spp): uint8 for
    depths up to 8 (unscaled values), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.reshape(h, -1, 2).astype(np.uint16)
        return ((v[..., 0] << 8) | v[..., 1])[:, :width * spp].reshape(
            h, width, spp)
    if depth == 8:
        return rows[:, :width * spp].reshape(h, width, spp)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(h, width, depth).astype(np.uint8)
    v = np.zeros((h, width), np.uint8)
    for i in range(depth):
        v = (v << 1) | bits[..., i]
    return v[..., None]


def _decode(stream: bytes, width: int, height: int, depth: int, spp: int,
            interlace: bool) -> np.ndarray:
    """Decompress and unfilter one image's zlib stream: samples (H, W,
    spp). Refused where the stream ends or breaks before the last row."""
    bpp = max(1, depth * spp // 8)

    def row_bytes(w):
        return (w * depth * spp + 7) // 8

    if interlace:
        passes = []
        for x0, y0, dx, dy in ADAM7:
            pw = (width - x0 + dx - 1) // dx if width > x0 else 0
            ph = (height - y0 + dy - 1) // dy if height > y0 else 0
            passes.append((pw, ph))
        need = sum(ph * (1 + row_bytes(pw)) for pw, ph in passes if pw)
    else:
        need = height * (1 + row_bytes(width))
    try:
        d = zlib.decompressobj()
        buf = d.decompress(stream, need)
    except zlib.error as e:
        raise Refused(f"PNG: {e}") from e
    if len(buf) < need:
        raise Refused("PNG image data is truncated")
    raw = np.frombuffer(buf, np.uint8)
    if not interlace:
        rows = unfilter(raw.reshape(height, -1), bpp)
        return _samples(rows, width, depth, spp)
    dtype = np.uint16 if depth == 16 else np.uint8
    out = np.zeros((height, width, spp), dtype)
    pos = 0
    for (x0, y0, dx, dy), (pw, ph) in zip(ADAM7, passes):
        if not pw or not ph:
            continue
        n = ph * (1 + row_bytes(pw))
        rows = unfilter(raw[pos:pos + n].reshape(ph, -1), bpp)
        pos += n
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, spp)
    return out


def _pixels(samples: np.ndarray, depth: int, ctype: int) -> np.ndarray:
    """Samples -> the pixels of Pillow's mode for (depth, colour type)."""
    if ctype in (0, 3) and depth < 16:
        v = samples[..., 0]
        if ctype == 0 and depth < 8:
            v = (v * {1: 255, 2: 85, 4: 17}[depth]).astype(np.uint8)
        return v
    if depth == 16:
        if ctype == 0:
            return samples[..., 0]
        hi = (samples >> 8).astype(np.uint8)
        if ctype == 4:                  # LA;16B -> RGBA
            return np.concatenate([hi[..., :1]] * 3 + [hi[..., 1:]], axis=2)
        return hi
    return samples


def _chunks(data: bytes) -> list:
    """The file's chunks in order: (type, data, crc ok, whole); the last
    one may be cut short by the end of the file."""
    if not data.startswith(_SIGNATURE):
        raise Refused("not a PNG file")
    out = []
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, cid = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        whole = len(body) == length and len(crc) == 4
        ok = whole and struct.unpack(">I", crc)[0] == (
            zlib.crc32(cid + body) & 0xFFFFFFFF)
        out.append((cid, body, ok, whole))
        pos += 12 + length
        if cid == b"IEND" or not whole:
            break
    return out


def read_png(data: bytes) -> Iterator[Frame]:
    """The frames of a PNG or APNG file (one for a still PNG), as
    ``ImageSequence.Iterator`` gives them; each frame's ``info`` holds
    ``duration`` where Pillow reports one (APNG frames)."""
    chunks = _chunks(data)
    if not chunks or chunks[0][0] != b"IHDR":
        raise Refused("PNG: no IHDR chunk")
    hdr = None
    palette = None
    info: dict = {}
    n_frames = None
    i = 0
    # The chunks before the first image data, as PngImagePlugin._open
    # reads them: every CRC checked, a broken one refused.
    while i < len(chunks):
        cid, body, ok, whole = chunks[i]
        if not _is_cid(cid):
            raise Refused(f"broken PNG file (chunk {cid!r})")
        if cid in (b"IDAT", b"fdAT"):
            break
        if not whole or not ok:
            raise Refused(f"broken PNG file (bad checksum in {cid!r})")
        if cid == b"IEND":
            raise Refused("PNG: no image data")
        if cid == b"IHDR":
            if len(body) < 13:
                raise unsupported("PNG with a short IHDR chunk")
            w, h, depth, ctype, comp, filt, lace = struct.unpack(
                ">IIBBBBB", body[:13])
            if (depth, ctype) not in _MODES or filt or comp or lace > 1:
                raise unsupported(f"PNG of bit depth {depth} and colour "
                                  f"type {ctype} (filter {filt}, "
                                  f"compression {comp}, interlace {lace})")
            hdr = (w, h, depth, ctype, bool(lace))
        elif cid == b"PLTE" and hdr and hdr[3] == 3:
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif cid == b"tRNS" and hdr:
            info["transparency"] = _trns(body, hdr)
        elif cid == b"acTL":
            if n_frames is None:
                n = struct.unpack(">I", body[:4])[0]
                if 0 < n <= 0x80000000:
                    n_frames = n
            else:
                raise unsupported("APNG with two acTL chunks")
        elif cid == b"fcTL":
            info.update(_fctl(body, hdr))
        i += 1
    if hdr is None or i == len(chunks):
        raise Refused("PNG: no image data")
    w, h, depth, ctype, lace = hdr
    mode, spp = _MODES[(depth, ctype)]
    if mode == "P":
        if palette is None:
            raise unsupported("palette PNG without a PLTE chunk")
        info["palette"] = palette
    if n_frames is None and "bbox" in info:
        raise unsupported("PNG with an fcTL chunk and no acTL chunk")
    default_image = n_frames is not None and "bbox" not in info
    total = 1 if n_frames is None else n_frames + default_image

    # Frame by frame: the image data of frame k, then the chunks up to
    # the next frame's data.
    im = None
    prev = None
    dispose = None
    dispose_extent = (0, 0, w, h)
    for k in range(total):
        if k:
            while i < len(chunks) and chunks[i][0] in (b"IDAT", b"fdAT"):
                i += 1
            fctl = None
            while i < len(chunks):
                cid = chunks[i][0]
                if cid == b"IEND":
                    return
                if cid == b"fdAT" and fctl is not None:
                    break
                if cid == b"fcTL":
                    if fctl is not None:
                        raise unsupported("APNG frame without data")
                    fctl = _fctl(chunks[i][1], hdr)
                elif cid == b"tRNS":
                    info["transparency"] = _trns(chunks[i][1], hdr)
                i += 1
            if i >= len(chunks):
                raise unsupported("APNG frame cut short")
            if dispose is not None:
                x0, y0, x1, y1 = dispose_extent
                im[y0:y1, x0:x1] = dispose if dispose is not True else 0
            prev = im.copy()
            info.update(fctl)
        # This frame's dispose op, applied before the next frame is drawn.
        op = info.get("disposal")
        if op == 2 and prev is None:
            op = 1
        if info.get("bbox"):
            dispose_extent = info["bbox"]
        x0, y0, x1, y1 = dispose_extent
        dispose = (prev[y0:y1, x0:x1].copy() if op == 2
                   else True if op == 1 else None)

        bbox = (0, 0, w, h) if k == 0 else info["bbox"]
        stream = bytearray()
        j = i
        while j < len(chunks) and chunks[j][0] in (b"IDAT", b"fdAT"):
            body = chunks[j][1]
            stream += body[4:] if chunks[j][0] == b"fdAT" else body
            j += 1
        x0, y0, x1, y1 = bbox
        px = _pixels(_decode(bytes(stream), x1 - x0, y1 - y0, depth, spp,
                             lace), depth, ctype)
        if im is None:
            im = np.zeros((h, w) + px.shape[2:], px.dtype)
        if prev is not None and info.get("blend") == 1:
            im = prev.copy()
            _paste_over(im, px, bbox, mode, info)
        else:
            im[y0:y1, x0:x1] = px
        out = {key: info[key] for key in ("palette", "transparency",
                                         "duration") if key in info}
        yield Frame(im.copy(), mode, out)


def _trns(body: bytes, hdr) -> object:
    """Pillow's ``transparency`` for a tRNS chunk."""
    depth, ctype = hdr[2], hdr[3]
    if ctype == 3:
        if _SIMPLE_TRNS.match(body):
            i = body.find(b"\0")
            return i if i >= 0 else None
        return bytes(body)
    if ctype == 0:
        v = struct.unpack(">H", body[:2])[0]
        return (255 if v else 0) if depth == 1 else v
    if ctype == 2:
        return struct.unpack(">HHH", body[:6])
    return None


def _fctl(body: bytes, hdr) -> dict:
    """The keys an fcTL chunk sets: bbox, duration (ms), disposal, blend."""
    if len(body) < 26 or hdr is None:
        raise unsupported("APNG with a short fcTL chunk")
    _seq, fw, fh, fx, fy, num, den, dop, bop = struct.unpack(
        ">IIIIIHHBB", body[:26])
    if fx + fw > hdr[0] or fy + fh > hdr[1]:
        raise Refused("APNG contains invalid frames")
    return {"bbox": (fx, fy, fx + fw, fy + fh),
            "duration": float(num) / float(den or 100) * 1000,
            "disposal": dop, "blend": bop}


def _div255(v):
    t = v + 128
    return ((t >> 8) + t) >> 8


def _paste_over(prev, px, bbox, mode, info) -> None:
    """APNG blend op OVER as Pillow does it: ``paste`` of the frame with
    its own RGBA conversion as the mask, every band of ``prev`` blended by
    the mask's alpha with Pillow's rounding."""
    from .imagefile import to_rgba
    x0, y0, x1, y1 = bbox
    if mode in ("RGB", "P"):
        mask = to_rgba(px, mode, info)[..., 3]
    elif mode == "RGBA":
        mask = px[..., 3]
    elif mode == "LA":
        mask = px[..., 1]
    else:
        mask = np.full(px.shape[:2], 255, np.uint8)
    if px.dtype != np.uint8:
        raise unsupported(f"APNG blend over in mode {mode}")
    m = mask.astype(np.int32)
    if px.ndim == 3:
        m = m[..., None]
    dst = prev[y0:y1, x0:x1].astype(np.int32)
    src = px.astype(np.int32)
    prev[y0:y1, x0:x1] = _div255(dst * (255 - m) + src * m).astype(np.uint8)
