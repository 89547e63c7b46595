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


def write_jpeg(path, planes, sampling, **kw) -> None:
    """:func:`jpeg_bytes` to a file."""
    with open(path, "wb") as f:
        f.write(jpeg_bytes(planes, sampling, **kw))


def jpeg_bytes(planes, sampling, quality: int = 75, restart: int = 0,
               ids=(1, 2, 3), jfif: bool = True,
               adobe: int | None = None) -> bytes:
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
    return head + bytes(out) + b"\xff\xd9"


def _ck(tag: bytes, body: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body)
                                                                 & 1)


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def avi_bytes(frames, width: int, height: int, compression: bytes | int,
              bits: int, rate: int = 25, scale: int = 1,
              top_down: bool = False, palette=None,
              usec: int | None = None, handler: bytes = b"\0\0\0\0",
              index: str | None = "movi", odml: int = 0,
              audio: bool | str = False, rec: bool = False,
              junk: bool = False,
              name: bytes | None = None, tag: bytes = b"00dc",
              planes: int = 1, size_image: int | None = None) -> bytes:
    """A RIFF AVI of one video stream.

    ``frames``: a list of byte strings, one per video chunk (b"" is a
    dropped frame), or ``("pc", bytes)`` for a ``00pc`` palette change
    (the AVIPALCHANGE body). ``compression``: the BITMAPINFOHEADER
    biCompression (a FourCC or 0 for BI_RGB, 3 for BI_BITFIELDS);
    ``palette``: (N, 3) RGB entries after the header. ``index``: "movi"
    (idx1 offsets from the ``movi`` tag), "file" (absolute offsets) or
    None (no idx1). ``odml``: frames per RIFF list: the chunks after the
    first ``odml`` go to ``RIFF AVIX`` lists, each stream indexed by a
    super index (``indx``) of standard indexes (``ix00``). ``audio``: a
    PCM stream whose ``01wb`` chunks sit between the frames (``"first"``:
    all of them before the first frame, not interleaved). ``rec``:
    each frame's chunks in a ``LIST rec``. ``junk``: JUNK chunks in
    ``hdrl`` and in ``movi``."""
    if isinstance(compression, bytes):
        comp = struct.unpack("<I", compression)[0]
        fcc = compression
    else:
        comp, fcc = compression, b"DIB " if compression == 0 else handler
    handler = fcc if handler == b"\0\0\0\0" and comp else handler
    n_vid = sum(1 for f in frames if not isinstance(f, tuple))
    pal = b""
    if palette is not None:
        p = np.zeros((len(palette), 4), np.uint8)
        p[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal = p.tobytes()
    if size_image is None:
        size_image = max((len(f) for f in frames if not isinstance(f, tuple)),
                         default=0)
    bih = struct.pack("<IiiHHIIiiII", 40, width,
                      -height if top_down else height, planes, bits, comp,
                      size_image, 0, 0,
                      len(palette) if palette is not None else 0, 0) + pal
    if usec is None:
        usec = int(round(1e6 * scale / rate)) if rate else 0
    avih = struct.pack("<IIIIIIIIII4I", usec, 0, 0,
                       0x10 if index else 0, n_vid, 0, 2 if audio else 1,
                       size_image, width, height, 0, 0, 0, 0)
    strh = (b"vids" + handler + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, scale, rate, 0, n_vid, size_image,
        0xFFFFFFFF, 0, 0, 0, width, height))
    # The movi body, chunk by chunk: (tag, body).
    chunks = []
    a_rate = 8000
    for k, f in enumerate(frames):
        if isinstance(f, tuple):
            chunks.append((b"00pc", f[1]))
            continue
        if audio:
            chunks.append((b"01wb", bytes([128 + (k % 7)] * 320)))
        chunks.append((tag, f))
    if audio == "first":                     # not interleaved
        chunks.sort(key=lambda c: c[0] != b"01wb")
    parts = [chunks]
    if odml:
        parts, nv = [[]], 0
        for c in chunks:
            if c[0] == tag:
                if nv and nv % odml == 0:
                    parts.append([])
                nv += 1
            parts[-1].append(c)
    # Lay the file out twice: first to learn the offsets, then for real.
    super_idx = [(0, 0, 0)] * len(parts) if odml else None

    def strl_video():
        body = _ck(b"strh", strh) + _ck(b"strf", bih)
        if name is not None:
            body += _ck(b"strn", name + b"\0")
        if odml:
            entries = b"".join(struct.pack("<QII", off, size, dur)
                               for off, size, dur in super_idx)
            body += _ck(b"indx", struct.pack(
                "<HBBI4sIII", 4, 0, 0, len(super_idx), tag, 0, 0, 0)
                + entries)
        return _list(b"strl", body)

    def strl_audio():
        a_strh = b"auds" + b"\0\0\0\0" + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, a_rate, 0,
            320 * n_vid, 320, 0xFFFFFFFF, 1, 0, 0, 0, 0)
        wfx = struct.pack("<HHIIHHH", 1, 1, a_rate, a_rate, 1, 8, 0)
        return _list(b"strl", _ck(b"strh", a_strh) + _ck(b"strf", wfx))

    def movi_body(part, ix=None):
        """(movi LIST body after its kind, [(tag, offset of the chunk from
        the movi tag, size)])."""
        out = bytearray()
        where = []
        pos = 4                                  # after b"movi"
        if junk:
            out += _ck(b"JUNK", b"\0" * 10)
            pos += 18
        for ctag, body in part:
            ck = _ck(ctag, body)
            if rec:
                ck = _list(b"rec ", ck)
                where.append((ctag, pos + 12, len(body)))
            else:
                where.append((ctag, pos, len(body)))
            out += ck
            pos += len(ck)
        if ix is not None:
            out += ix
        return bytes(out), where

    def layout():
        hdrl = _ck(b"avih", avih) + strl_video()
        if audio:
            hdrl += strl_audio()
        if odml:
            hdrl += _list(b"odml", _ck(b"dmlh", struct.pack("<I", n_vid)
                                       + b"\0" * 244))
        if junk:
            hdrl += _ck(b"JUNK", b"\0" * 30)
        head = b"RIFF\0\0\0\0AVI " + _list(b"hdrl", hdrl)
        movi_at = len(head) + 8                  # the b"movi" tag
        out = [head]
        std = []
        for pi, part in enumerate(parts):
            if pi:
                riff_at = sum(len(x) for x in out)
                movi_at = riff_at + 12 + 8
            body, where = movi_body(part)
            ix = None
            if odml:
                vids = [(o, s) for t, o, s in where if t == tag]
                ix_body = struct.pack("<HBBI4sQI", 2, 0, 1, len(vids), tag,
                                      movi_at, 0) + b"".join(
                    struct.pack("<II", o + 8, s) for o, s in vids)
                ix = _ck(b"ix00", ix_body)
                std.append((movi_at + 4 + len(body), len(ix), len(vids)))
                body, where = movi_body(part, ix)
            movi = _list(b"movi", body)
            if pi == 0:
                if index:
                    rel = movi_at if index == "file" else 0
                    idx = b"".join(struct.pack(
                        "<4sIII", t, 0x10 if t == tag else 0, o + rel, s)
                        for t, o, s in where)
                    movi += _ck(b"idx1", idx)
                out[0] = out[0] + movi
                riff = bytearray(out[0])
                riff[4:8] = struct.pack("<I", len(riff) - 8)
                out[0] = bytes(riff)
            else:
                x = b"RIFF" + struct.pack("<I", len(movi) + 4) + b"AVIX" \
                    + movi
                out.append(x)
        return b"".join(out), std

    data, std = layout()
    if odml:
        super_idx = [(off, size, n) for off, size, n in std]
        data, std2 = layout()
        assert std2 == std
    return data


def msrle_frame(idx: np.ndarray, prev: np.ndarray | None, bits: int,
                runs: bool = True) -> bytes:
    """An MS RLE frame (BI_RLE8 with ``bits`` 8, BI_RLE4 with 4) of
    (H, W) palette indices, bottom row first: encoded runs, absolute runs
    of odd and even length, and, where ``prev`` is given, delta codes over
    the pixels that equal the previous frame's and end-of-line codes
    after a row's last change."""
    h, w = idx.shape
    out = bytearray()
    pend = None                          # (x, line) where a delta starts
    for line in range(h - 1, -1, -1):
        row = idx[line]
        same = (prev[line] == row) if prev is not None else np.zeros(w, bool)
        x = 0
        if pend is not None:
            px, pline = pend
            dy = pline - line
            if dy:
                # End the old line, then skip whole lines by a delta.
                out += b"\0\0"
                dy -= 1
                if dy:
                    out += bytes([0, 2, 0, dy])
            pend = None
        while x < w:
            if same[x]:
                n = 1
                while x + n < w and same[x + n]:
                    n += 1
                if x + n == w:
                    pend = (w, line)
                    break
                if n >= 3:
                    out += bytes([0, 2, n, 0])
                    x += n
                    continue
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if (run >= 3 or w - x < 3) and runs:
                v = int(row[x])
                out += bytes([run, v if bits == 8 else (v << 4) | v])
                x += run
                continue
            n = min(3 + (x % 4), w - x)          # odd and even absolutes
            n = max(3, n) if w - x >= 3 else w - x
            vals = [int(v) for v in row[x:x + n]]
            if n < 3:
                for v in vals:
                    out += bytes([1, v if bits == 8 else v << 4])
                x += n
                continue
            out += bytes([0, n])
            if bits == 8:
                out += bytes(vals)
                if n % 2:
                    out.append(0)
            else:
                pad = vals + [0] * (n % 2)
                packed = bytes((pad[i] << 4) | pad[i + 1]
                               for i in range(0, len(pad), 2))
                out += packed
                if len(packed) % 2:
                    out.append(0)
            x += n
        if pend is None:
            out += b"\0\0"
    if pend is not None or out[-2:] == b"\0\0":
        if out[-2:] == b"\0\0":
            del out[-2:]
    out += b"\0\1"
    return bytes(out)


def cram_frame(img: np.ndarray, prev: np.ndarray | None, bits: int,
               rng=None) -> bytes:
    """An MS Video 1 (CRAM) frame of (H, W) palette indices (``bits`` 8)
    or (H, W) RGB555 words (16): 4x4 blocks from the bottom left, each a
    skip (runs of blocks equal to ``prev``), one colour, two colours or
    eight (one pair per quadrant), picked by the block's colours."""
    h, w = img.shape
    bw, bh = w // 4, h // 4
    out = bytearray()
    skip = 0
    rng = rng if rng is not None else np.random.default_rng(0)

    def flush_skip():
        nonlocal skip
        while skip:
            n = min(skip, 0x3FF)
            out.extend(struct.pack("<H", 0x8400 + n))
            skip -= n

    def word(v):
        out.extend(struct.pack("<H", v))

    for by in range(bh - 1, -1, -1):
        for bx in range(bw):
            blk = img[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            if prev is not None and (prev[by * 4:by * 4 + 4,
                                          bx * 4:bx * 4 + 4] == blk).all():
                skip += 1
                continue
            flush_skip()
            # Bits in stream order: rows bottom to top, left to right.
            order = blk[::-1].reshape(-1)
            cols = sorted(set(order.tolist()))
            one_ok = (bits == 16 and (cols[0] | 0x8000) >> 8 & 0xFC != 0x84) \
                or (bits == 8)
            if len(cols) == 1 and one_ok:
                v = cols[0]
                if bits == 16:
                    word(v | 0x8000)
                else:
                    b = int(rng.choice([0x80, 0x81, 0x83, 0x88, 0x8B, 0x8F]))
                    out.extend(bytes([v, b]))
                continue
            if len(cols) <= 2:
                c0, c1 = cols[0], cols[-1]
                if order[15] == c0:
                    c0, c1 = c1, c0              # flag bit 15 must be 0
                flags = sum(1 << i for i in range(16) if order[i] == c0
                            and c0 != c1)
                word(flags)
                if bits == 16:
                    word(c0 & 0x7FFF)
                    word(c1 & 0x7FFF)
                else:
                    out.extend(bytes([c0, c1]))
                continue
            # Eight colours: a pair per quadrant; a pixel takes the nearer
            # of its quadrant's two by index.
            quad = np.zeros(8, np.int64)
            flags = 0
            for q in range(4):
                qy, qx = q // 2, q % 2
                sub = blk[::-1][qy * 2:qy * 2 + 2, qx * 2:qx * 2 + 2]
                vals = sorted(set(sub.reshape(-1).tolist()))
                a, b = vals[0], vals[-1]
                quad[2 * q], quad[2 * q + 1] = a, b
            if bits == 16:
                quad[0] |= 0x8000
            for i in range(16):
                py, px = i // 4, i % 4
                q = (py // 2) * 2 + px // 2
                a, b = (int(v) & 0x7FFF for v in quad[2 * q:2 * q + 2])
                v = int(order[i])
                if abs(v - a) <= abs(v - b):
                    flags |= 1 << i
            if bits == 16:
                word(flags & 0x7FFF)            # byte b below 0x80
                for v in quad:
                    word(int(v))
            else:
                word(flags | 0x9000)            # byte b 0x90 or more
                out.extend(bytes(int(v) for v in quad))
    flush_skip()
    return bytes(out)


def movie_indices(rng, n: int, h: int, w: int, ncol: int) -> list:
    """``n`` (h, w) uint8 palette-index frames: seeded bands with a disc
    that moves, so consecutive frames share most pixels (runs, skips and
    deltas for the RLE and MS Video 1 writers); frame 2 is noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = ((x // 8 + y // 6 + int(rng.integers(0, ncol))) % ncol)
    out = []
    for k in range(n):
        f = base.copy()
        f[(x - 10 - 9 * k) ** 2 + (y - h // 2) ** 2 < 60] = (k + 3) % ncol
        if k == 2:
            f[h // 4:h // 2, w // 4:w // 2] = rng.integers(
                0, ncol, (h // 2 - h // 4, w // 2 - w // 4))
        out.append(f.astype(np.uint8))
    return out


def movie_rgb(rng, n: int, h: int, w: int, noise: int = 24) -> list:
    """``n`` (h, w, 3) uint8 frames: a smooth ramp with seeded noise and a
    square that moves."""
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for k in range(n):
        img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                        (x + y + 40 * k) % 256], 2).astype(np.float64)
        img += rng.integers(-noise, noise + 1, img.shape)
        img[h // 4:h // 2, (5 * k) % w:(5 * k) % w + w // 4] = (
            240, 30 + 50 * k, 90)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _dib_rows(px: np.ndarray, top_down: bool) -> bytes:
    """Rows of a DIB (bottom-up unless ``top_down``), each padded to a
    multiple of 4 bytes."""
    h = px.shape[0]
    rows = px.reshape(h, -1) if top_down else px.reshape(h, -1)[::-1]
    pad = (-rows.shape[1]) % 4
    return np.pad(rows, ((0, 0), (0, pad))).tobytes()


def jpeg_frame(rgb: np.ndarray, subsampling: int = 2, quality: int = 80,
               grey: bool = False, dht: bool = True) -> bytes:
    """A Pillow JPEG of ``rgb`` (4:4:4, 4:2:2 or 4:2:0 by
    ``subsampling`` 0, 1, 2). Without ``dht`` the frame carries no
    Huffman tables (it uses the standard ones) and an ``AVI1`` APP0 in
    place of JFIF's, as MJPEG AVIs write it."""
    import io

    from PIL import Image
    im = Image.fromarray(rgb)
    if grey:
        im = im.convert("L")
    b = io.BytesIO()
    im.save(b, "JPEG", quality=quality, subsampling=subsampling)
    data = b.getvalue()
    if dht:
        return data
    out, pos = bytearray(b"\xff\xd8"), 2
    while True:
        m = data[pos + 1]
        if m == 0xDA:
            return bytes(out + data[pos:])
        size = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos:pos + 2 + size]
        if m == 0xE0:
            seg = b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1" + bytes(10)
        if m != 0xC4:
            out += seg
        pos += 2 + size


def avi_movie(kind: str, rng, n: int = 4, h: int = 48, w: int = 64,
              top_down: bool = False, **kw) -> bytes:
    """An AVI of ``n`` seeded frames in one of the variants that
    ``ckrenderengine_tpu_torch/io/avi.py`` reads, written by
    :func:`avi_bytes` (``kw`` go there): ``pal8``, ``rgb555``,
    ``rgb565`` (BI_BITFIELDS), ``bgr24``, ``bgr32``, ``i420``, ``yv12``,
    ``yuy2``, ``uyvy``, ``y800``, ``msrle8``, ``msrle4``, ``cram8``,
    ``cram16``, ``mpng``, ``mjpg420``, ``mjpg422``, ``mjpg444``,
    ``mjpg440``, ``mjpg411`` (hand-encoded), ``mjpg_grey``, ``mjpg_avi1``
    (no DHT)."""
    if kind in ("pal8", "msrle8", "msrle4", "cram8"):
        ncol = 16 if kind == "msrle4" else 256
        pal = rng.integers(0, 256, (ncol, 3))
        idx = movie_indices(rng, n, h, w, ncol)
        if kind == "pal8":
            frames = [_dib_rows(f, top_down) for f in idx]
            return avi_bytes(frames, w, h, 0, 8, palette=pal,
                             top_down=top_down, **kw)
        if kind == "cram8":
            frames = [cram_frame(f, idx[i - 1] if i else None, 8, rng)
                      for i, f in enumerate(idx)]
            return avi_bytes(frames, w, h, b"CRAM", 8, palette=pal, **kw)
        bits = 8 if kind == "msrle8" else 4
        frames = [msrle_frame(f, idx[i - 1] if i else None, bits)
                  for i, f in enumerate(idx)]
        return avi_bytes(frames, w, h, 1 if bits == 8 else 2, bits,
                         palette=pal, **kw)
    rgb = movie_rgb(rng, n, h, w)
    if kind in ("rgb555", "rgb565", "cram16"):
        r, g, b = (f.astype(np.uint16) for f in np.moveaxis(
            np.stack(rgb), 3, 0))
        if kind == "rgb565":
            words = (r >> 3 << 11) | (g >> 2 << 5) | (b >> 3)
        else:
            words = (r >> 3 << 10) | (g >> 3 << 5) | (b >> 3)
        words = words.astype("<u2")
        if kind == "cram16":
            quant = [wd & 0x7C1F for wd in words]         # fewer colours
            frames = [cram_frame(f, quant[i - 1] if i else None, 16, rng)
                      for i, f in enumerate(quant)]
            return avi_bytes(frames, w, h, b"CRAM", 16, **kw)
        frames = [_dib_rows(f.view(np.uint8), top_down) for f in words]
        return avi_bytes(frames, w, h, 0 if kind == "rgb555" else 3, 16,
                         top_down=top_down, **kw)
    if kind in ("bgr24", "bgr32"):
        bpp = 3 if kind == "bgr24" else 4
        frames = []
        for f in rgb:
            px = f[..., ::-1]
            if bpp == 4:
                px = np.concatenate([px, rng.integers(
                    0, 256, f.shape[:2] + (1,), dtype=np.uint8)], 2)
            frames.append(_dib_rows(np.ascontiguousarray(px), top_down))
        return avi_bytes(frames, w, h, 0, 8 * bpp, top_down=top_down, **kw)
    if kind in ("i420", "yv12", "yuy2", "uyvy", "y800"):
        frames = []
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for f in rgb:
            yy = f[..., 1]
            if kind == "y800":
                frames.append(yy.tobytes())
                continue
            if kind in ("i420", "yv12"):
                u = f[::2, ::2, 2][:ch, :cw]
                v = f[::2, ::2, 0][:ch, :cw]
                a, b = (v, u) if kind == "yv12" else (u, v)
                frames.append(yy.tobytes() + a.tobytes() + b.tobytes())
                continue
            u, v = f[:, ::2, 2], f[:, ::2, 0]
            pk = np.zeros((h, cw, 4), np.uint8)
            yp = np.pad(yy, ((0, 0), (0, 2 * cw - w)))
            order = (0, 1, 2, 3) if kind == "yuy2" else (1, 0, 3, 2)
            for slot, plane in zip(order, (yp[:, 0::2], u, yp[:, 1::2],
                                           v)):
                pk[..., slot] = plane
            frames.append(pk.tobytes())
        fcc = {"i420": b"I420", "yv12": b"YV12", "yuy2": b"YUY2",
               "uyvy": b"UYVY", "y800": b"Y800"}[kind]
        bits = {"y800": 8, "yuy2": 16, "uyvy": 16}.get(kind, 12)
        return avi_bytes(frames, w, h, fcc, bits, **kw)
    if kind == "mpng":
        frames = []
        for k, f in enumerate(rgb):
            if k % 4 == 1:                                # RGBA
                s, ctype = np.concatenate([f, f[..., :1]], 2), 6
            elif k % 4 == 2:                              # grey
                s, ctype = f[..., 1:2], 0
            else:
                s, ctype = f, 2
            body = png_chunk(b"IHDR", struct.pack(
                ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            body += png_chunk(b"IDAT", png_stream(s, 8))
            frames.append(b"\x89PNG\r\n\x1a\n" + body
                          + png_chunk(b"IEND", b""))
        return avi_bytes(frames, w, h, b"MPNG", 24, **kw)
    if kind in ("mjpg440", "mjpg411"):
        samp = [(1, 2) if kind == "mjpg440" else (4, 1), (1, 1), (1, 1)]
        frames = []
        for f in rgb:
            r, g, b = (f[..., i].astype(np.float64) for i in range(3))
            ycc = [0.299 * r + 0.587 * g + 0.114 * b,
                   128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                   128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
            frames.append(jpeg_bytes([np.clip(np.round(p), 0, 255).astype(
                np.uint8) for p in ycc], samp, quality=80))
        return avi_bytes(frames, w, h, b"MJPG", 24, **kw)
    if kind.startswith("mjpg"):
        sub = {"mjpg444": 0, "mjpg422": 1}.get(kind, 2)
        frames = [jpeg_frame(f, sub, grey=kind == "mjpg_grey",
                             dht=kind != "mjpg_avi1") for f in rgb]
        return avi_bytes(frames, w, h, b"MJPG", 24, **kw)
    raise ValueError(kind)
