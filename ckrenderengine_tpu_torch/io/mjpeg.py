"""Motion JPEG frames (AVI ``MJPG``), decoded as FFmpeg's ``mjpegdec``
decodes them for OpenCV.

The marker parser and the Huffman decoder are those of :mod:`.jpeg`; the
rest follows FFmpeg, not libjpeg (the two differ by up to 75 levels on the
same frame):

- a frame without DHT segments uses the standard tables of JPEG Annex K,
  which ``mjpegdec`` loads before every frame (AVI1 frames omit them);
- the DC predictor starts at 1024 (the level shift, in dequantized
  units) and the dequantized coefficients are 16-bit, as ``block[]`` is;
- the IDCT is FFmpeg's "simple" integer IDCT (``simple_idct.c``), which
  ``idct_algo`` auto selects for 8-bit JPEG: x86-64 builds run it as
  ``ff_simple_idct8_put_sse2`` / ``_avx``, whose output equals the C
  version's;
- baseline and progressive frames, with or without restart intervals;
- the planes stay planar (``yuvj420p``, ``yuvj422p``, ``yuvj444p``,
  ``yuvj440p``, ``yuvj411p`` or ``gray``) and go to RGB through
  :mod:`.swscale`.

A frame cut short (in a damaged file) keeps the blocks decoded before the
cut, as ``mjpegdec`` does; the blocks after it are mid-grey here, where
FFmpeg leaves whatever its frame buffer held. A frame gives a picture
once it has a frame header and then an end-of-image marker or a scan
marker (a scan header cut by the packet's end is read from zero padding,
as FFmpeg reads it, and a bad one skips its scan); otherwise none, and
OpenCV's read loop stops. Nor does a frame whose Huffman tables do not
build or whose sampling ``mjpegdec`` has no pixel format for. Two-field
(interlaced) frames are woven as ``mjpegdec`` weaves them
(:class:`MjpegStream`). Lossless, arithmetic-coded, RGB and CMYK frames
raise item 14 of the port queue.
"""

from __future__ import annotations

import struct

import numpy as np

from .imagefile import unsupported_movie
from .jpeg import ZIGZAG, _Decoder, _Exhausted, _Huffman
from .swscale import image_size_ok, int16, yuv_to_rgb

# JPEG Annex K.3: (class << 4 | id, code counts, symbols).
_STD_TABLES = (
    (0x00, "00010501010101010100000000000000", "000102030405060708090a0b"),
    (0x01, "00030101010101010101010000000000", "000102030405060708090a0b"),
    (0x10, "0002010303020403050504040000017d",
     "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
     "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
     "5455565758595a636465666768696a737475767778797a838485868788898a9293"
     "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
     "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0x11, "00020102040403040705040400010277",
     "000102031104052131061241510761711322328108144291a1b1c109233352f015"
     "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
     "535455565758595a636465666768696a737475767778797a82838485868788898a"
     "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
     "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
)

# simple_idct.c: cos(i * pi / 16) * sqrt(2) * 2^14, rounded (W4 one less).
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20


def _butterfly(x, shift: int, round_in_dc: bool):
    """One 8-point pass of the simple IDCT on eight int64 arrays."""
    if round_in_dc:
        a0 = W4 * (x[0] + ((1 << (shift - 1)) // W4))
    else:
        a0 = W4 * x[0] + (1 << (shift - 1))
    a1, a2, a3 = a0 + W6 * x[2], a0 - W6 * x[2], a0 - W2 * x[2]
    a0 = a0 + W2 * x[2]
    a0 = a0 + W4 * x[4] + W6 * x[6]
    a1 = a1 - W4 * x[4] - W2 * x[6]
    a2 = a2 - W4 * x[4] + W2 * x[6]
    a3 = a3 + W4 * x[4] - W6 * x[6]
    b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
    b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
    b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
    b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
    return [(a0 + b0) >> shift, (a1 + b1) >> shift, (a2 + b2) >> shift,
            (a3 + b3) >> shift, (a3 - b3) >> shift, (a2 - b2) >> shift,
            (a1 - b1) >> shift, (a0 - b0) >> shift]


def simple_idct_put(block: np.ndarray) -> np.ndarray:
    """``ff_simple_idct_put_int16_8bit`` of (N, 8, 8) natural-order int16
    coefficients: rows (a row whose AC terms are all zero becomes its DC
    times 8), stored as int16, then columns, clipped to uint8."""
    b = block.astype(np.int64)
    rows = np.stack(_butterfly([b[:, :, k] for k in range(8)], ROW_SHIFT,
                               False), axis=2)
    dc_only = ~b[:, :, 1:].any(axis=2)
    rows = np.where(dc_only[..., None], (b[:, :, :1] * 8), rows)
    rows = int16(rows)
    cols = np.stack(_butterfly([rows[:, k, :] for k in range(8)], COL_SHIFT,
                               True), axis=1)
    return np.clip(cols, 0, 255).astype(np.uint8)


class _FrameDecoder(_Decoder):
    """``_Decoder`` with FFmpeg's markers: default Huffman tables, no EOI
    needed, and a scan cut short keeps what it decoded."""

    def __init__(self, data: bytes):
        super().__init__(data)
        for tc_th, counts, syms in _STD_TABLES:
            table = _Huffman(bytes.fromhex(counts), bytes.fromhex(syms))
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = table
        self.seen_sof = False
        self.scanned = False             # mjpegdec would give a picture
        self.end = len(data)             # past the EOI, where there is one

    @staticmethod
    def _sof_ok(seg: bytes) -> bool:
        """``ff_mjpeg_decode_sof``'s checks that fail the frame: a size
        ``av_image_check_size`` refuses, sampling factors past 1-4 (8-bit
        samples and 1 or 3 components are refused by name after)."""
        if len(seg) < 6:
            return False
        h, w = struct.unpack_from(">HH", seg, 1)
        factors = seg[7:6 + 3 * seg[5]:3]
        return image_size_ok(w, h) and all(
            1 <= f >> 4 <= 4 and 1 <= f & 15 <= 4 for f in factors)

    def _dht_ok(self, data: bytes, at: int, size: int) -> bool:
        """``ff_mjpeg_decode_dht``: tables read from ``at`` while the
        segment's length lasts (whatever bytes they run over), each of
        class 0-1 and index 0-3, at most 256 codes that build a Huffman
        table; any failure fails the frame. Loads the tables."""
        if size > len(data) - at:
            return False
        while size > 0:
            if size < 17:
                return False
            tc, th = data[at] >> 4, data[at] & 15
            counts = data[at + 1:at + 17]
            total = sum(counts)
            size -= 17
            if tc >= 2 or th >= 4 or size < total or total > 256:
                return False
            try:
                table = _Huffman(counts, data[at + 17:at + 17 + total])
            except NotImplementedError:
                return False
            (self.ac if tc else self.dc)[th] = table
            at += 17 + total
            size -= total
        return True

    def _dqt_ok(self, data: bytes, at: int, size: int) -> bool:
        """``ff_mjpeg_decode_dqt``: whole tables while 65 or more of the
        segment's bytes remain (a shorter rest is ignored), each of
        precision 0-1 and index 0-3, read from ``at`` whatever bytes they
        run over. Loads the tables."""
        if size > len(data) - at:
            return False
        while size >= 65:
            pq, tq = data[at] >> 4, data[at] & 15
            if pq > 1 or tq >= 4:
                return False
            n = 64 * (1 + pq)
            raw = data[at + 1:at + 1 + n].ljust(n, b"\0")
            self.qt[tq] = np.frombuffer(raw, ">u2" if pq else np.uint8
                                        ).astype(np.int64)
            at += 1 + n
            size -= 1 + n
        return True

    def _scan_header(self, s: bytes) -> bool:
        """``ff_mjpeg_decode_sos``' checks: one to four components, the
        length that count gives, each a component of the frame with
        tables that exist."""
        ns = s[0] if s else 0
        if not 1 <= ns <= 4 or len(s) != 4 + 2 * ns:
            return False
        for i in range(ns):
            cid, t = s[1 + 2 * i], s[2 + 2 * i]
            if not any(c.id == cid for c in self.comps):
                return False
            if t >> 4 not in self.dc or t & 15 not in self.ac:
                return False
        return True

    def parse(self) -> None:
        data = self.data
        n = len(data)
        pos = 0
        while True:
            while pos < n and data[pos] != 0xFF:
                pos += 1
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                return
            m = data[pos]
            pos += 1
            if m == 0xD9:                               # EOI
                self.end = pos
                self.scanned |= self.seen_sof
                return
            if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            if m == 0xDA:
                # FFmpeg reads a scan header cut by the packet's end from
                # the zero padding after it.
                head = data[pos:pos + 2].ljust(2, b"\0")
                length = struct.unpack(">H", head)[0]
                seg = data[pos + 2:pos + length].ljust(max(length - 2, 0),
                                                       b"\0")
                pos = min(pos + length, n)
                self.scanned |= self.seen_sof
                if not self.seen_sof or not self._scan_header(seg):
                    continue
                end = self._scan_part(seg, pos)
                if end is None:
                    return
                pos = end
                continue
            if pos + 2 > n:
                return
            length = struct.unpack_from(">H", data, pos)[0]
            seg = data[pos + 2:pos + length]
            if len(seg) < length - 2:
                return
            pos += length
            if m in (0xC0, 0xC1, 0xC2):
                if self.seen_sof:
                    raise unsupported_movie("MJPEG frame with two frame "
                                            "headers")
                if not self._sof_ok(seg):
                    return                          # mjpegdec refuses it
                self._sof(seg, m == 0xC2)
                self.seen_sof = True
            elif 0xC3 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                raise unsupported_movie(
                    f"MJPEG frames of coding process SOF{m - 0xC0} "
                    f"(lossless or hierarchical)")
            elif m == 0xCC:
                raise unsupported_movie("arithmetic-coded MJPEG frames")
            elif m == 0xC4:
                if not self._dht_ok(data, pos - length + 2, length - 2):
                    return                          # mjpegdec: no picture
            elif m == 0xDB:
                if not self._dqt_ok(data, pos - length + 2, length - 2):
                    return                          # mjpegdec: no picture
            elif m == 0xDD:
                self.restart = struct.unpack(">H", seg[:2])[0]
            elif m == 0xEE and seg[:5] == b"Adobe" and length >= 14:
                self.adobe = seg[11]

    def _scan_part(self, s: bytes, pos: int):
        """Decode one scan (a baseline scan whole, whatever its spectral
        selection says; a progressive scan's band and bits); stop quietly
        where its data ends or is corrupt. The position of the marker
        after it, or None."""
        ns = s[0]
        ss, se, ahl = s[1 + 2 * ns:4 + 2 * ns]
        ss, se, ah, al = (ss, se, ahl >> 4, ahl & 15) if self.progressive \
            else (0, 63, 0, 0)
        if ss > se or se > 63 or (ss and ns != 1):
            return None
        comps = []
        for i in range(ns):
            cid, t = s[1 + 2 * i], s[2 + 2 * i]
            comp = next((c for c in self.comps if c.id == cid), None)
            if comp is None:
                raise unsupported_movie("MJPEG scan of an unknown component")
            if comp.tq not in self.qt:
                raise unsupported_movie("MJPEG component without its "
                                        "quantization table")
            comp.qt = self.qt[comp.tq]
            comps.append((comp, t >> 4, t & 15))
        intervals, end = self._intervals(pos)
        if ns == 1:
            comp = comps[0][0]
            units = [(comp, ((by, bx),)) for by in range(comp.bh)
                     for bx in range(comp.bw)]
        else:
            units = [(comp, tuple((my * comp.v + y, mx * comp.h + x)
                                  for y in range(comp.v)
                                  for x in range(comp.h)))
                     for my in range(self.mcuy) for mx in range(self.mcux)
                     for comp, _td, _ta in comps]
        per = ns if ns > 1 else 1
        n_mcu = len(units) // per
        step = self.restart or n_mcu
        done = 0
        for seg in intervals:
            if done >= n_mcu:
                break
            count = min(step, n_mcu - done)
            try:
                self._decode(seg, units[done * per:(done + count) * per],
                             comps, ss, se, ah, al)
            except (_Exhausted, NotImplementedError, ValueError):
                return None          # out of data, or a code no table has
            done += count
        return end


def _plane(comp) -> np.ndarray:
    """A component's samples: dequantized int16 coefficients, the DC
    level shift, the simple IDCT, blocks assembled (MCU-padded)."""
    n = comp.ph * comp.pw
    coef = np.asarray(comp.coef, np.int64).reshape(n, 64)
    deq = np.zeros((n, 64), np.int64)
    if comp.qt is not None:                      # never scanned: all zero
        deq[:, ZIGZAG] = coef * comp.qt[None, :]
    deq[:, 0] += 1024
    blocks = simple_idct_put(int16(deq).reshape(n, 8, 8))
    return blocks.reshape(comp.ph, comp.pw, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(comp.ph * 8, comp.pw * 8)


def _planes(dec):
    """(pixel format, [Y, Cb, Cr] or [Y]) of a decoded picture, each plane
    cropped to its size in FFmpeg's frame; (None, []) for a sampling that
    ``mjpegdec`` has no pixel format for (it gives no picture)."""
    w, h = dec.width, dec.height
    planes = [_plane(c) for c in dec.comps]
    if len(planes) == 1:
        return "gray", [planes[0][:h, :w]]
    ids = tuple(c.id for c in dec.comps)
    if dec.adobe == 0 or ids == (82, 71, 66):
        raise unsupported_movie("RGB MJPEG frames")
    luma, cb, cr = dec.comps
    ratios = {(dec.hmax // c.h, dec.vmax // c.v) for c in (cb, cr)}
    fmt = {(1, 1): "yuvj444p", (2, 1): "yuvj422p", (2, 2): "yuvj420p",
           (1, 2): "yuvj440p", (4, 1): "yuvj411p"}.get(
               ratios.pop() if len(ratios) == 1 else None)
    if (fmt is None or (luma.h, luma.v) != (dec.hmax, dec.vmax)
            or any(dec.hmax % c.h or dec.vmax % c.v for c in (cb, cr))):
        return None, []              # mjpegdec: an unhandled pixel format
    dw = -(-w * cb.h // dec.hmax)
    dh = -(-h * cb.v // dec.vmax)
    return fmt, [planes[0][:h, :w], planes[1][:dh, :dw],
                 planes[2][:dh, :dw]]


class MjpegStream:
    """``mjpegdec``'s state over a stream's frames: whether pictures are
    fields. As FFmpeg decides, a picture is a field where the stream's
    first picture is under 3/4 of the stream's height (``avi_height``),
    and stays so until a frame header changes the picture's size."""

    def __init__(self, avi_height: int):
        self.avi_height = avi_height
        self.size = None
        self.interlaced = False

    def decode(self, data: bytes) -> np.ndarray | None:
        """RGB (H, W, 3) uint8 of one frame, or None where ``mjpegdec``
        gives no picture (no frame and scan header; a field without the
        second field). Two fields weave into the frame, the first on its
        odd rows and the second on its even rows (chroma rows too), and
        the frame converts whole."""
        dec = _FrameDecoder(data)
        dec.parse()
        if not dec.scanned:
            return None
        fmt, planes = _planes(dec)
        if fmt is None:
            return None
        size = (dec.width, dec.height, fmt)
        if size != self.size:
            self.interlaced = (self.size is None and bool(self.avi_height)
                               and dec.height < self.avi_height * 3 // 4)
            self.size = size
        if self.interlaced:
            if dec.progressive:             # mjpegdec refuses the frame
                return None
            second = _FrameDecoder(data[dec.end:])
            second.parse()
            if not second.scanned:
                return None
            fmt2, planes2 = _planes(second)
            if fmt2 is None:
                return None
            if fmt2 != fmt or [p.shape for p in planes2] != [
                    p.shape for p in planes]:
                raise unsupported_movie("two-field MJPEG frames whose "
                                        "fields differ in size or "
                                        "sampling")
            frame = []
            for a, b in zip(planes, planes2):
                both = np.empty((2 * a.shape[0], a.shape[1]), np.uint8)
                both[1::2], both[0::2] = a, b
                frame.append(both)
            planes = frame
        if fmt == "gray":
            return np.repeat(planes[0][..., None], 3, axis=2)
        return yuv_to_rgb(fmt, *planes)
