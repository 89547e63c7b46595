"""Image files that Pillow cannot write, written by hand with ``struct`` and
``zlib`` for the tests of the port's image readers
(``ckrenderengine_tpu_torch/io/imagefile.py``) and for
``tests/torch_images/make_images.py``: PNG of any colour type and bit
depth, with chosen filters and Adam7 interlace; APNG; RLE4 and RLE8 BMP;
16-bit TGA; TIFF with tiles, planar samples and predictor 2."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ckrenderengine_tpu_torch.io.jpeg import ZIGZAG
from ckrenderengine_tpu_torch.io.png import ADAM7
from ckrenderengine_tpu_torch.io.png import _chunk as png_chunk


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, spp) integer samples -> (H, R) bytes of PNG scanlines."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        out = np.stack([flat >> 8, flat & 0xFF], axis=2)
        return out.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each scanline with its filter type (0-4)."""
    h, r = rows.shape
    out = bytearray()
    prior = np.zeros(r, np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b = prior
        f = int(filters[y % len(filters)])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(f)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = cur
    return bytes(out)


def png_stream(samples: np.ndarray, depth: int, interlace: bool = False,
               filters=(0, 1, 2, 3, 4)) -> bytes:
    """The zlib-compressed scanlines of (H, W, spp) samples."""
    spp = samples.shape[2]
    bpp = max(1, depth * spp // 8)
    if not interlace:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, filters)
    else:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(sub, depth), bpp, filters)
    return zlib.compress(raw, 9)


def write_png(path, samples, depth: int, ctype: int, interlace=False,
              palette=None, trns: bytes | None = None,
              filters=(0, 1, 2, 3, 4)) -> None:
    """A PNG of (H, W, spp) integer samples at any bit depth and colour
    type, with the chosen filters, Adam7 if ``interlace``."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w = samples.shape[:2]
    body = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, int(interlace)))
    if palette is not None:
        body += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += png_chunk(b"tRNS", trns)
    body += png_chunk(b"IDAT", png_stream(samples, depth, interlace,
                                          filters))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + png_chunk(b"IEND", b""))


def write_bmp_rle(path, indices: np.ndarray, palette: np.ndarray,
                  bits: int, top_down: bool = False) -> None:
    """An RLE8 (``bits`` 8) or RLE4 (4) BMP of (H, W) palette indices:
    encoded runs and absolute runs, with end-of-line codes."""
    h, w = indices.shape
    rows = indices if top_down else indices[::-1]
    out = bytearray()
    for row in rows:
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                if bits == 8:
                    out += bytes([run, row[x]])
                else:
                    out += bytes([run, (row[x] << 4) | row[x]])
                x += run
                continue
            n = 3
            while x + n < w and n < 255 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            vals = row[x:x + n]
            out += bytes([0, n])
            if bits == 8:
                out += bytes(vals.tolist())
                if n % 2:
                    out.append(0)
            else:
                pad = np.append(vals, 0) if n % 2 else vals
                packed = bytes(((pad[0::2] << 4) | pad[1::2]).tolist())
                out += packed
                if len(packed) % 2:
                    out.append(0)
            x += n
        out += b"\0\0"
    out += b"\0\1"
    pal = np.zeros((len(palette), 4), np.uint8)
    pal[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                       bits, 1 if bits == 8 else 2, len(out), 2835, 2835,
                       len(palette), 0)
    off = 14 + len(info) + pal.nbytes
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", off + len(out), 0, 0, off)
                + info + pal.tobytes() + bytes(out))


def write_tga16(path, rgba: np.ndarray, alpha_bits: int = 1,
                top_left: bool = False, rle: bool = False) -> None:
    """A 16-bit truecolour TGA (type 2, or 10 with ``rle``): 5 bits per
    colour, the top bit from the alpha, ``alpha_bits`` in the descriptor."""
    h, w = rgba.shape[:2]
    r, g, b = (rgba[..., i].astype(np.uint16) >> 3 for i in range(3))
    a = (rgba[..., 3] >= 128).astype(np.uint16)
    v = (a << 15) | (r << 10) | (g << 5) | b
    rows = v if top_left else v[::-1]
    if rle:
        body = bytearray()
        for row in rows:
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 128 and row[x + n] == row[x]:
                    n += 1
                if n > 1:
                    body += bytes([0x80 | (n - 1)])
                    body += struct.pack("<H", int(row[x]))
                else:
                    body += bytes([0]) + struct.pack("<H", int(row[x]))
                x += n
        data = bytes(body)
    else:
        data = rows.astype("<u2").tobytes()
    desc = alpha_bits | (0x20 if top_left else 0)
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0,
                      0, w, h, 16, desc)
    with open(path, "wb") as f:
        f.write(hdr + data)


def _tiff_entry(tag, typ, values, endian):
    fmt = {1: "B", 3: "H", 4: "I"}[typ]
    values = list(values)
    data = struct.pack(endian + fmt * len(values), *values)
    return tag, typ, len(values), data


def write_tiff(path, img: np.ndarray, photometric: int, planar: bool,
               tile: int | None = None, rows_per_strip: int = 16,
               compression: int = 1, predictor: int = 1,
               extra_samples=(), palette=None, endian: str = "<") -> None:
    """A one-page TIFF of (H, W[, spp]) uint8 samples: chunky or planar,
    strips or ``tile`` x ``tile`` tiles, compression 1 (none) or 8
    (Deflate), predictor 1 or 2."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    planes = [img[..., s:s + 1] for s in range(spp)] if planar else [img]

    def encode(block):
        block = block.astype(np.uint8)
        if predictor == 2:
            d = block.astype(np.int16)
            d[:, 1:] = d[:, 1:] - d[:, :-1]
            block = (d & 0xFF).astype(np.uint8)
        raw = block.tobytes()
        return zlib.compress(raw) if compression == 8 else raw

    chunks = []
    for plane in planes:
        if tile:
            for ty in range(0, h, tile):
                for tx in range(0, w, tile):
                    blk = np.zeros((tile, tile, plane.shape[2]), np.uint8)
                    part = plane[ty:ty + tile, tx:tx + tile]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
        else:
            for y in range(0, h, rows_per_strip):
                chunks.append(encode(plane[y:y + rows_per_strip]))
    data = b"".join(chunks)
    offs, pos = [], 8
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    ifd_at = pos + (pos & 1)
    e = endian
    entries = [_tiff_entry(256, 4, [w], e), _tiff_entry(257, 4, [h], e),
               _tiff_entry(258, 3, [8] * spp, e),
               _tiff_entry(259, 3, [compression], e),
               _tiff_entry(262, 3, [photometric], e),
               _tiff_entry(277, 3, [spp], e),
               _tiff_entry(284, 3, [2 if planar else 1], e)]
    if predictor != 1:
        entries.append(_tiff_entry(317, 3, [predictor], e))
    if extra_samples:
        entries.append(_tiff_entry(338, 3, list(extra_samples), e))
    if palette is not None:
        pal = np.asarray(palette, np.uint16) * 257
        entries.append(_tiff_entry(320, 3, pal.T.reshape(-1).tolist(), e))
    if tile:
        entries += [_tiff_entry(322, 4, [tile], e),
                    _tiff_entry(323, 4, [tile], e),
                    _tiff_entry(324, 4, offs, e),
                    _tiff_entry(325, 4, [len(c) for c in chunks], e)]
    else:
        entries += [_tiff_entry(273, 4, offs, e),
                    _tiff_entry(278, 4, [rows_per_strip], e),
                    _tiff_entry(279, 4, [len(c) for c in chunks], e)]
    entries.sort()
    n = len(entries)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd, extra = struct.pack(e + "H", n), b""
    for tag, typ, count, payload in entries:
        if len(payload) <= 4:
            ifd += struct.pack(e + "HHI", tag, typ, count) + payload.ljust(
                4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", tag, typ, count,
                               extra_at + len(extra))
            extra += payload + (b"\0" if len(payload) & 1 else b"")
    ifd += struct.pack(e + "I", 0)
    head = (b"II*\0" if e == "<" else b"MM\0*") + struct.pack(e + "I",
                                                               ifd_at)
    with open(path, "wb") as f:
        f.write(head + data + b"\0" * (ifd_at - pos) + ifd + extra)


_DC_SYMS = list(range(12))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                           for s in range(1, 11)]


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        self.acc = 0


def _category(v: int) -> int:
    return abs(v).bit_length()


def write_jpeg(path, planes, sampling, quality: int = 75,
               restart: int = 0, ids=(1, 2, 3), jfif: bool = True,
               adobe: int | None = None) -> None:
    """A baseline JPEG of full-size uint8 ``planes`` (one per component,
    written as given: the caller converts to YCbCr or not), each sampled
    at its (h, v) factor by box averaging, with one fixed-length Huffman
    code per table (every symbol 4 bits for DC, 8 bits for AC) and a
    restart marker every ``restart`` MCUs."""
    h_img, w_img = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    base = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26,
                     58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17,
                     22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103,
                     77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87,
                     103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = np.clip((base * scale + 50) // 100, 1, 255)        # natural order
    n = np.arange(8)
    cos = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16)
    alpha = np.where(n == 0, np.sqrt(0.5), 1.0)
    mcux = -(-w_img // (8 * hmax))
    mcuy = -(-h_img // (8 * vmax))
    coefs = []
    for plane, (hs, vs) in zip(planes, sampling):
        fx, fy = hmax // hs, vmax // vs
        pad = np.pad(plane.astype(np.float64),
                     ((0, mcuy * 8 * vmax - h_img),
                      (0, mcux * 8 * hmax - w_img)), mode="edge")
        small = pad.reshape(pad.shape[0] // fy, fy, pad.shape[1] // fx,
                            fx).mean(axis=(1, 3)) - 128
        by, bx = small.shape[0] // 8, small.shape[1] // 8
        blocks = small.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        f = 0.25 * alpha[:, None] * alpha[None, :] * np.einsum(
            "abxy,xu,yv->abuv", blocks, cos, cos)
        q = np.round(f / qt.reshape(8, 8)).astype(np.int64)
        coefs.append(q.reshape(by, bx, 64)[..., ZIGZAG])
    bits = _Bits()
    preds = [0] * len(planes)
    dc_code = {s: i for i, s in enumerate(_DC_SYMS)}
    ac_code = {s: i for i, s in enumerate(_AC_SYMS)}
    out = bytearray()
    n_mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + (n_mcu // restart
                                                       - 1) % 8])
                bits.out = bytearray()
                preds = [0] * len(planes)
            n_mcu += 1
            for ci, (hs, vs) in enumerate(sampling):
                for y in range(vs):
                    for x in range(hs):
                        blk = coefs[ci][my * vs + y, mx * hs + x]
                        diff = int(blk[0]) - preds[ci]
                        preds[ci] = int(blk[0])
                        c = _category(diff)
                        bits.put(dc_code[c], 4)
                        if c:
                            bits.put(diff if diff > 0 else diff - 1, c)
                        run = 0
                        for k in range(1, 64):
                            v = int(blk[k])
                            if not v:
                                run += 1
                                continue
                            while run > 15:
                                bits.put(ac_code[0xF0], 8)
                                run -= 16
                            c = min(_category(v), 10)
                            v = max(-1023, min(1023, v))
                            bits.put(ac_code[(run << 4) | c], 8)
                            bits.put(v if v > 0 else v - 1, c)
                            run = 0
                        if run:
                            bits.put(ac_code[0x00], 8)
    bits.flush()
    out += bits.out
    seg = lambda m, body: bytes([0xFF, m]) + struct.pack(
        ">H", len(body) + 2) + body
    head = b"\xff\xd8"
    if jfif:
        head += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        head += seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    head += seg(0xDB, b"\0" + qt[ZIGZAG].astype(np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, h_img, w_img, len(planes))
    for cid, (hs, vs) in zip(ids, sampling):
        sof += bytes([cid, (hs << 4) | vs, 0])
    head += seg(0xC0, sof)
    head += seg(0xC4, b"\x00" + bytes([0, 0, 0, 12] + [0] * 12)
                + bytes(_DC_SYMS))
    head += seg(0xC4, b"\x10" + bytes([0] * 7 + [len(_AC_SYMS)] + [0] * 8)
                + bytes(_AC_SYMS))
    if restart:
        head += seg(0xDD, struct.pack(">H", restart))
    sos = bytes([len(planes)])
    for cid in ids[:len(planes)]:
        sos += bytes([cid, 0x00])
    head += seg(0xDA, sos + b"\x00\x3f\x00")
    with open(path, "wb") as f:
        f.write(head + bytes(out) + b"\xff\xd9")
