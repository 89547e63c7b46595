"""TIFF files, read as Pillow's ``TiffImagePlugin`` (with libtiff) reads
them.

Little- and big-endian files; strips and tiles; compression none,
PackBits, LZW and Deflate, with horizontal predictor 2; 8-bit "L", "LA",
"P", "RGB" and "RGBA" (unassociated alpha, or a fourth sample without
ExtraSamples), chunky and planar ("LA" chunky only). A file of several
pages gives one frame per page, as ``ImageSequence.Iterator`` does; Pillow
reports no duration for them. Other photometric interpretations, bit
depths, associated alpha, JPEG-in-TIFF and other compressions raise item
14 of the port queue (``imagefile.unsupported``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator

import numpy as np

from .imagefile import Frame, Refused, unsupported

_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 16: 8}
_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}


def _ifd(data: bytes, pos: int, e: str) -> tuple[dict, int]:
    """The tags of the IFD at ``pos`` ({tag: tuple of ints}) and the
    offset of the next IFD."""
    if pos + 2 > len(data):
        raise unsupported("TIFF whose IFD lies past the end of the file")
    n = struct.unpack_from(e + "H", data, pos)[0]
    if pos + 2 + 12 * n + 4 > len(data):
        raise unsupported("TIFF whose IFD is cut short")
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(e + "HHI4s", data,
                                                  pos + 2 + 12 * i)
        if typ not in _FMT:
            continue
        size = _SIZES[typ] * count
        if size > 4:
            off = struct.unpack(e + "I", raw)[0]
            raw = data[off:off + size]
            if len(raw) < size:
                raise unsupported("TIFF tag data past the end of the file")
        tags[tag] = struct.unpack(e + _FMT[typ] * count, raw[:size])
    nxt = struct.unpack_from(e + "I", data, pos + 2 + 12 * n)[0]
    return tags, nxt


def _lzw(src: bytes, expect: int) -> bytes:
    """TIFF LZW (MSB-first codes, the code width growing one code early):
    at most ``expect`` bytes."""
    if src[:2] == b"\x00\x01":
        raise unsupported("TIFF with old-style LZW")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bits = 9
    acc = nacc = 0
    pos = 0
    n = len(src)
    prev = None
    while len(out) < expect:
        while nacc < bits:
            if pos >= n:
                return bytes(out)
            acc = ((acc << 8) | src[pos]) & 0xFFFFFFFF
            pos += 1
            nacc += 8
        code = (acc >> (nacc - bits)) & ((1 << bits) - 1)
        nacc -= bits
        if code == 256:
            del table[258:]
            bits = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise unsupported("TIFF with a broken LZW stream")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << bits) and bits < 12:
            bits += 1
    return bytes(out[:expect])


def _packbits(src: bytes, expect: int) -> bytes:
    out = bytearray()
    pos, n = 0, len(src)
    while pos < n and len(out) < expect:
        c = src[pos]
        pos += 1
        if c < 128:
            out += src[pos:pos + c + 1]
            pos += c + 1
        elif c > 128:
            out += src[pos:pos + 1] * (257 - c)
            pos += 1
    return bytes(out[:expect])


def _page(data: bytes, tags: dict) -> Frame:
    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    w, h = one(256), one(257)
    if not w or not h:
        raise unsupported("TIFF page without a size")
    spp = one(277, 1)
    bps = tags.get(258, (1,))
    if len(bps) == 1:
        bps = bps * spp
    comp = one(259, 1)
    photo = one(262, 0)
    planar = one(284, 1)
    predictor = one(317, 1)
    extra = tags.get(338, ())
    if set(bps) != {8} or len(bps) != spp:
        raise unsupported(f"TIFF of {bps} bits per sample")
    if one(266, 1) != 1 or tags.get(339, (1,))[0] != 1:
        raise unsupported("TIFF with a fill order or sample format other "
                          "than 1")
    if comp not in (1, 5, 8, 32946, 32773):
        raise unsupported(f"TIFF compression {comp}")
    if predictor not in (1, 2) or (predictor == 2 and comp == 1):
        raise unsupported(f"TIFF predictor {predictor}")
    key = (photo, spp, tuple(extra))
    modes = {(1, 1, ()): "L", (1, 2, (2,)): "LA", (3, 1, ()): "P",
             (2, 3, ()): "RGB", (2, 4, ()): "RGBA", (2, 4, (2,)): "RGBA",
             (2, 4, (999,)): "RGBA", (2, 4, (0,)): "RGB"}
    if key not in modes:
        raise unsupported(f"TIFF of photometric {photo}, {spp} samples, "
                          f"extra samples {extra}")
    mode = modes[key]
    if mode == "LA" and planar == 2:
        raise unsupported("planar grey-and-alpha TIFF (Pillow raises "
                          "ValueError or reads its alpha plane otherwise)")
    if 322 in tags:
        tw, th = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        tw, th = w, min(one(278, h), h) if one(278, h) else h
        offsets, counts = tags.get(273), tags.get(279)
    if not offsets or not counts or len(offsets) != len(counts):
        raise unsupported("TIFF page without its data offsets")
    across = (w + tw - 1) // tw
    down = (h + th - 1) // th
    planes = spp if planar == 2 else 1
    per = spp // planes
    if len(offsets) < across * down * planes:
        raise unsupported("TIFF with too few strips or tiles")
    img = np.zeros((planes, h, w, per), np.uint8)
    rows_in = th if 322 in tags else None
    i = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                off, cnt = offsets[i], counts[i]
                i += 1
                raw = data[off:off + cnt]
                if len(raw) < cnt:
                    raise unsupported("TIFF data past the end of the file")
                bh = rows_in or min(th, h - ty * th)
                expect = bh * tw * per
                if comp == 1:
                    buf = raw
                elif comp == 5:
                    buf = _lzw(raw, expect)
                elif comp == 32773:
                    buf = _packbits(raw, expect)
                else:
                    try:
                        buf = zlib.decompressobj().decompress(raw, expect)
                    except zlib.error as e:
                        raise unsupported(f"TIFF with broken Deflate data: "
                                          f"{e}") from e
                if len(buf) < expect:
                    raise unsupported("TIFF strip or tile cut short")
                blk = np.frombuffer(buf[:expect], np.uint8).reshape(
                    bh, tw, per)
                if predictor == 2:
                    blk = np.cumsum(blk, axis=1, dtype=np.uint64).astype(
                        np.uint8)
                y0, x0 = ty * th, tx * tw
                hh, ww = min(bh, h - y0), min(tw, w - x0)
                img[p, y0:y0 + hh, x0:x0 + ww] = blk[:hh, :ww]
    px = np.concatenate(list(img), axis=2) if planes > 1 else img[0]
    info: dict = {}
    if mode == "P":
        cmap = tags.get(320)
        if cmap is None or len(cmap) < 3:
            raise unsupported("palette TIFF without a colour map")
        n = len(cmap) // 3
        info["palette"] = (np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T
                           // 256).astype(np.uint8)
    if mode == "RGB" and spp == 4:
        px = px[..., :3]
    if px.shape[2] == 1:
        px = px[..., 0]
    if mode == "P" and px.size and int(px.max()) >= len(info["palette"]):
        raise unsupported("TIFF index past its colour map")
    return Frame(np.ascontiguousarray(px), mode, info)


def read_tiff(data: bytes) -> Iterator[Frame]:
    """The pages of a TIFF file, one frame each."""
    if data[:4] == b"II*\0":
        e = "<"
    elif data[:4] == b"MM\0*":
        e = ">"
    else:
        raise Refused("not a TIFF file")
    if len(data) < 8:
        raise unsupported("TIFF header cut short")
    pos = struct.unpack_from(e + "I", data, 4)[0]
    seen = set()
    while pos and pos not in seen:
        seen.add(pos)
        tags, nxt = _ifd(data, pos, e)
        yield _page(data, tags)
        pos = nxt
