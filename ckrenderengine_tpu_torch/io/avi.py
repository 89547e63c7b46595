"""AVI movies, read as OpenCV's ``VideoCapture`` reads them through FFmpeg
(the reference's ``LoadMovie`` of a video file).

:func:`demux` follows FFmpeg's ``avidec``:

- the header: ``avih``'s frame period, each ``strl``'s ``strh`` (type,
  rate and scale), ``strf`` (a ``BITMAPINFOHEADER`` and the palette
  after it) and ``strn``, the OpenDML ``indx`` super index and its
  ``ix##`` standard indexes; a file whose header ends before ``movi``
  does not open;
- the packets of the first video stream (OpenCV's pick), in the order
  ``avi_sync`` finds them: a byte-wise scan of ``movi`` that descends
  into ``LIST rec`` and ``RIFF AVIX`` lists, skips ``JUNK``, indexes and
  other streams' chunks (interleaved audio), drops zero-length (dropped)
  frames and applies ``##pc`` palette changes to the next packet; a
  chunk cut by the end of the file gives what is there;
- ``idx1`` (offsets relative to ``movi`` or absolute, aligned on the
  first packet as FFmpeg guesses them) and the OpenDML indexes: where
  they show the streams stored one after another (FFmpeg's
  non-interleaved mode), the video packets are read at the index's
  offsets instead.

:func:`read_avi` decodes the packets as OpenCV's read loop does: each
frame converted to RGB (:mod:`.swscale`), the first packet that fails to
decode ending the movie. The codecs: uncompressed ``BI_RGB`` (8-bit
palettised, 16-bit RGB555, 24 and 32 bits, either row order),
``BI_BITFIELDS`` RGB565, ``I420`` / ``IYUV`` / ``YV12``, ``YUY2`` /
``UYVY`` and ``Y800`` (:func:`_raw`), ``MJPG`` (:mod:`.mjpeg`), MS RLE
(:mod:`.msrle`), MS Video 1 (:mod:`.msvideo1`) and PNG frames (``MPNG``,
:mod:`.png`). Every other codec raises item 14 of the port queue by
name.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

from .imagefile import Refused, unsupported_movie
from .swscale import image_size_ok, packed_yuv, rgb16_to_rgb, yuv_to_rgb


class Packet(NamedTuple):
    """One video chunk: its bytes (fewer than the chunk's size where the
    file ends inside it) and the palette FFmpeg sends with it ((256, 3)
    uint8 RGB), if any."""

    data: bytes
    palette: np.ndarray | None


class AviVideo(NamedTuple):
    """What the demuxer gives for the file's video stream."""

    tag: bytes              # biCompression as four bytes (BI_RGB: 0)
    width: int
    height: int
    top_down: bool          # a negative biHeight
    bits: int               # biBitCount
    palette: np.ndarray | None
    rate: int               # the frame rate, rate / scale frames per s
    scale: int
    packets: list


# FourCCs by the decoder that takes them (compared upper-cased, as
# FFmpeg's tag lookup falls back to).
_RAW_YUV = {b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yuv420p",
            b"YUY2": "yuyv422", b"YUYV": "yuyv422", b"YUNV": "yuyv422",
            b"V422": "yuyv422", b"UYVY": "uyvy422", b"UYNV": "uyvy422",
            b"HDYC": "uyvy422", b"Y800": "gray", b"GREY": "gray",
            b"Y8  ": "gray"}
_MJPEG = {b"MJPG", b"AVRN", b"AVDJ", b"DMB1", b"JPGL", b"QIVG", b"IJPG",
          b"ACDV", b"SLMJ", b"MJLS"}
_MSRLE = {b"\x01\0\0\0", b"\x02\0\0\0", b"MRLE"}
_CRAM = {b"CRAM", b"MSVC", b"WHAM"}
_PNG = {b"MPNG", b"PNG1", b"PNG "}
# Codecs FFmpeg decodes and this package does not, by name.
_REFUSED = {
    b"CVID": "Cinepak", b"IV31": "Indeo 3", b"IV32": "Indeo 3",
    b"IV41": "Indeo 4", b"IV50": "Indeo 5", b"XVID": "MPEG-4 ASP (Xvid)",
    b"DIVX": "MPEG-4 ASP (DivX)", b"DX50": "MPEG-4 ASP (DivX 5)",
    b"FMP4": "MPEG-4 ASP (FFmpeg)", b"MP4V": "MPEG-4 ASP",
    b"DIV3": "MS MPEG-4 v3", b"MP43": "MS MPEG-4 v3",
    b"H264": "H.264", b"X264": "H.264", b"AVC1": "H.264",
    b"HEVC": "HEVC", b"FFV1": "FFV1", b"HFYU": "HuffYUV",
    b"FFVH": "HuffYUV (FFmpeg)", b"MPG2": "MPEG-2", b"VP80": "VP8",
    b"DVSD": "DV", b"TSCC": "TechSmith",
}


# The hdrl chunks avidec reads; any other chunk is skipped (or, past 1 MB,
# ends the header).
_HEADER_TAGS = {b"avih", b"strh", b"strf", b"strd", b"strn", b"vprp",
                b"indx", b"dmlh", b"IDIT", b"amv "}


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _stream_idx(b0: int, b1: int) -> int:
    """FFmpeg's ``get_stream_idx``: two ASCII digits, else 100."""
    if 48 <= b0 <= 57 and 48 <= b1 <= 57:
        return (b0 - 48) * 10 + (b1 - 48)
    return 100


def _palette_quads(raw: bytes) -> np.ndarray:
    """(N, 3) RGB of RGBQUAD (B, G, R, x) entries."""
    q = np.frombuffer(raw[:len(raw) // 4 * 4], np.uint8).reshape(-1, 4)
    return q[:, 2::-1].copy()


class _Stream:
    def __init__(self, kind: bytes):
        self.kind = kind
        self.rate = self.scale = 0
        self.bih = None              # (width, height, bits, tag)
        self.palette = None          # (256, 3) uint8, or None
        self.index = []              # [(chunk position, size)]
        self.super_index = []        # [(ix## position, size)]
        self.pending = False         # a palette for the next packet


class _Reader:
    """The demuxer's state over the file's bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.size = len(data)
        self.streams: list[_Stream] = []
        self.frame_period = 0
        self.movi = None             # position of the b"movi" tag
        self.movi_end = 0
        self.riff_end = 0
        self.non_interleaved = False     # idx1 lists a position twice

    # -- the header (avi_read_header) ------------------------------------
    def header(self) -> bool:
        data, n = self.data, self.size
        if n < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            return False
        self.riff_end = _u32(data, 4) + 8
        pos = 12
        cur = None
        list_end = n
        while True:
            if pos + 8 > n:
                return False                    # no movi: does not open
            tag = data[pos:pos + 4]
            size = _u32(data, pos + 4)
            body = pos + 8
            if tag == b"LIST":
                if body + 4 > n:
                    return False
                kind = data[body:body + 4]
                if kind == b"movi":
                    self.movi = body
                    self.movi_end = body + size + (size & 1)
                    return True
                if kind == b"INFO" or kind == b"ncdt":
                    pos = body + size + (size & 1)
                else:
                    list_end = body + size
                    pos = body + 4               # parse the list's chunks
                continue
            if tag == b"strf" and body < list_end:
                size = min(size, list_end - body)    # as avidec clamps it
            if tag not in _HEADER_TAGS and size > 1000000:
                # avidec takes a huge unknown chunk for a broken header
                # and scans for packets from here on.
                self.movi = body - 4
                self.movi_end = max(self.riff_end, n)
                return True
            pos = body + size + (size & 1)
            if tag == b"avih":
                if body + 4 > n:
                    return False
                self.frame_period = _u32(data, body)
            elif tag == b"strh":
                if body + 28 > n:
                    return False
                kind = data[body:body + 4]
                if kind == b"pads":
                    cur = None
                    continue
                if kind in (b"iavs", b"ivas"):
                    raise unsupported_movie("DV streams in AVI (iavs / ivas)")
                cur = _Stream(kind)
                cur.scale = _u32(data, body + 20)
                cur.rate = _u32(data, body + 24)
                self.streams.append(cur)
            elif tag == b"strf" and cur is not None and cur.kind == b"vids":
                if body + 40 > n:
                    return False
                _bsize, w, h, _planes, bits, comp = struct.unpack_from(
                    "<IiiHHI", data, body)
                cur.bih = (w, h, bits, struct.pack("<I", comp))
                extra = data[body + 40:body + size] \
                    if 40 < size < (1 << 30) and size < n else b""
                if extra and bits <= 8:
                    # avidec: 1 << bits entries from the end of the extra
                    # bytes, each with alpha 255.
                    k = min((1 << bits) * 4, len(extra))
                    pal = np.zeros((256, 3), np.uint8)
                    got = _palette_quads(extra[len(extra) - k:])
                    pal[:len(got)] = got
                    cur.palette = pal
            elif tag == b"indx" and cur is not None:
                self._super_index(cur, data[body:min(body + size, n)])

    def _super_index(self, st: _Stream, b: bytes) -> None:
        if len(b) < 24:
            return
        longs, _sub, itype, count = struct.unpack_from("<HBBI", b)
        if itype != 0 or longs != 4:             # AVI_INDEX_OF_INDEXES
            return
        for k in range(count):
            at = 24 + 16 * k
            if at + 16 > len(b):
                break
            off, size, _dur = struct.unpack_from("<QII", b, at)
            st.super_index.append((off, size))

    # -- indexes (read_odml_index, avi_read_idx1) ------------------------
    def indexes(self) -> bool:
        """Load the OpenDML or idx1 index; True if one was loaded."""
        data, n = self.data, self.size
        odml = False
        for st in self.streams:
            for off, _size in st.super_index:
                if off + 32 > n or data[off:off + 2] != b"ix":
                    continue
                body = off + 8
                longs, _sub, itype, count = struct.unpack_from(
                    "<HBBI", data, body)
                if itype != 1 or longs != 2:      # AVI_INDEX_OF_CHUNKS
                    continue
                base = struct.unpack_from("<Q", data, body + 12)[0]
                for k in range(count):
                    at = body + 24 + 8 * k
                    if at + 8 > n:
                        break
                    rel, size = struct.unpack_from("<II", data, at)
                    size &= 0x7FFFFFFF
                    if size:
                        st.index.append((base + rel - 8, size))
                odml = True
        if odml:
            return True
        pos = self.movi_end
        while pos + 8 <= n:
            tag, size = data[pos:pos + 4], _u32(data, pos + 4)
            if tag == b"idx1":
                self._idx1(data[pos + 8:min(pos + 8 + size, n)])
                return True
            if tag in (b"LIST", b"RIFF"):
                pos += 12
                continue
            pos += 8 + size + (size & 1)
        return False

    def _idx1(self, b: bytes) -> None:
        first = self._first_packet()
        offset = None
        last_pos = last_idx = None
        for k in range(len(b) // 16):
            tag, _flags, pos, size = struct.unpack_from("<4sIII", b, 16 * k)
            i = _stream_idx(tag[0], tag[1])
            if i >= len(self.streams) or tag[2:] == b"pc":
                continue
            if offset is None:
                offset = 0
                if first is not None and (self.movi + 4 != pos
                                          or pos + 500 > first):
                    offset = first - pos
            pos += offset
            if last_pos == pos:
                self.non_interleaved = True
            if last_idx != pos and size:
                self.streams[i].index.append((pos, size))
                last_idx = pos
            last_pos = pos

    def _first_packet(self):
        """The position of the first chunk ``avi_sync`` finds in movi."""
        got = self.sync(self.movi + 4, first=True)
        return None if got is None else got[0]

    def non_interleaved_layout(self) -> bool:
        """FFmpeg's ``guess_ni_flag`` (the part that reads the index's
        positions): streams stored one after another."""
        if self.non_interleaved:
            return True
        last_start, first_end = 0, None
        for st in self.streams:
            if not st.index:
                continue
            last_start = max(last_start, st.index[0][0])
            end = st.index[-1][0]
            first_end = end if first_end is None else min(first_end, end)
        return first_end is not None and last_start > first_end

    # -- packets (avi_sync) -----------------------------------------------
    def fsize(self) -> int:
        if self.size < self.riff_end:
            return self.riff_end if self.riff_end != 8 else 1 << 62
        return self.size

    def sync(self, pos: int, first: bool = False, last_pkt: int = 0):
        """From ``pos``, the next chunk that is a packet of some stream:
        (header position, stream, body position, size), applying palette
        changes on the way; None at the end of the file."""
        data, n = self.data, self.size
        fsize = self.fsize()
        nst = len(self.streams)
        while True:
            i = pos + 7                       # the byte in d[7]
            while i < n:
                h = i - 7
                d = data[h:h + 8]
                size = _u32(d, 4)
                if i + size > fsize or d[0] > 127:
                    i += 1
                    continue
                s2 = _stream_idx(d[2], d[3])
                if (d[:2] == b"ix" and s2 < nst) or d[:4] in (
                        b"JUNK", b"idx1", b"indx"):
                    pos = i + 1 + size
                    break
                if d[:4] == b"LIST":
                    pos = i + 1 + 4
                    break
                s = _stream_idx(d[0], d[1])
                if not (i - last_pkt) & 1 and _stream_idx(d[1], d[2]) < nst:
                    i += 1
                    continue
                if d[2:4] == b"ix" and s < nst:
                    pos = i + 1 + size
                    break
                if d[2:4] == b"wc" and s < nst:
                    pos = i + 1 + 16 * 3 + 8
                    break
                if s < nst:
                    st = self.streams[s]
                    if d[2:4] == b"pc" and size <= 4 * 256 + 4:
                        if not first:
                            self._palette_change(st, i + 1)
                        pos = i + 1 + size
                        break
                    if d[2] < 128 and d[3] < 128:
                        if size == 0 and not first:     # a dropped frame
                            pos = i + 1
                            break
                        return h, s, i + 1, size
                i += 1
            else:
                return None

    def _palette_change(self, st: _Stream, at: int) -> None:
        data = self.data
        if at + 4 > self.size:
            return
        k, count = data[at], data[at + 1]
        last = (k + count - 1) & 0xFF
        if st.palette is None:
            st.palette = np.zeros((256, 3), np.uint8)
        p = at + 4
        while k <= last and p + 4 <= self.size:
            st.palette[k] = (data[p], data[p + 1], data[p + 2])
            k += 1
            p += 4
        st.pending = True


def demux(data: bytes) -> AviVideo | None:
    """The video stream of an AVI file and its packets; None where FFmpeg
    does not open the file (OpenCV's ``isOpened()`` is False)."""
    r = _Reader(data)
    if not r.header():
        return None
    video = next((i for i, st in enumerate(r.streams)
                  if st.kind == b"vids" and st.bih), None)
    if video is None:
        return None
    st = r.streams[video]
    rate, scale = st.rate, st.scale
    if not (rate and scale):
        rate, scale = (1000000, r.frame_period) if r.frame_period else (
            25, 1)
    st.pending = st.palette is not None
    packets = []

    def emit(body, size):
        pal = None
        if st.pending:
            pal = st.palette.copy()
            st.pending = False
        packets.append(Packet(data[body:body + size], pal))

    if r.indexes() and r.non_interleaved_layout():
        for pos, _size in st.index:
            if not 0 <= pos <= len(data) - 8:
                break
            size = _u32(data, pos + 4)
            emit(pos + 8, size)
    else:
        pos, last = r.movi + 4, 0
        while True:
            got = r.sync(pos, last_pkt=last)
            if got is None:
                break
            _h, s, body, size = got
            if s == video:
                emit(body, size)
            last = body
            pos = body + size
    w, h, bits, tag = st.bih
    if not image_size_ok(w, abs(h)):
        return None
    return AviVideo(tag, w, abs(h), h < 0, bits, st.palette, rate, scale,
                    packets)



def fps(video: AviVideo) -> float:
    """OpenCV's ``CAP_PROP_FPS``: the stream's rate / scale."""
    return video.rate / video.scale


# -- decoding ----------------------------------------------------------------

def _raw(video: AviVideo, fmt: str, pkt: bytes, pal: np.ndarray):
    """An uncompressed frame as FFmpeg's ``rawvideo`` lays it out, or None
    where the packet is shorter than a frame."""
    w, h = video.width, video.height
    buf = np.frombuffer(pkt, np.uint8)
    if fmt in ("yuv420p", "yvu420p"):
        cw, ch = (w + 1) // 2, (h + 1) // 2
        if len(buf) < w * h + 2 * cw * ch:
            return None
        y = buf[:w * h].reshape(h, w)
        a = buf[w * h:w * h + cw * ch].reshape(ch, cw)
        b = buf[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)
        u, v = (b, a) if fmt == "yvu420p" else (a, b)
        return yuv_to_rgb("yuv420p", y, u, v)
    if fmt in ("yuyv422", "uyvy422"):
        if len(buf) < (w + 1) // 2 * 4 * h:
            return None
        return yuv_to_rgb(fmt, *packed_yuv(fmt, buf, w, h))
    if fmt == "pal8":
        rows = _pal8_rows(buf, w, h)
        if rows is None:
            return None
    else:
        bpp = {"gray": 1, "rgb555": 2, "rgb565": 2, "bgr24": 3,
               "bgra": 4}[fmt]
        line = w * bpp
        if len(buf) < max(line * h, h):
            return None
        aligned = (line + 3) // 4 * 4
        stride = aligned if aligned * h <= len(buf) else line
        rows = np.lib.stride_tricks.as_strided(buf, (h, line), (stride, 1))
    if video.tag in (b"\0\0\0\0", b"\x03\0\0\0") and not video.top_down:
        rows = rows[::-1]
    rows = np.ascontiguousarray(rows)
    if fmt == "gray":
        return np.repeat(rows[..., None], 3, axis=2)
    if fmt == "pal8":
        return pal[rows]
    if fmt in ("rgb555", "rgb565"):
        return rgb16_to_rgb(rows.view("<u2"), 5 if fmt == "rgb555" else 6)
    px = rows.reshape(h, w, bpp)
    return px[..., 2::-1].copy()


def _pal8_rows(buf: np.ndarray, w: int, h: int):
    """8-bit palettised rows as ``rawvideo`` copies them: the packet's row
    stride is its size over the height, and each row starts at the first
    stride boundary after the previous row's last pixel; pixels past the
    packet's end stay 0 (FFmpeg leaves them as its buffer held them).
    None for a packet under one byte per row."""
    stride = len(buf) // h
    if stride == 0:
        return None
    rows = np.zeros((h, w), np.uint8)
    i = 0
    for r in range(h):
        got = buf[i:i + w]
        rows[r, :len(got)] = got
        i = ((i + w - 1) // stride + 1) * stride
    return rows


def _png_walk(pkt: bytes):
    """(offset past the IEND chunk, the IDAT chunks' data), walking the
    chunks by their lengths; (None, ...) where no whole IEND comes (FFmpeg's
    ``png`` decoder needs one)."""
    p, idat = 8, []
    while p + 12 <= len(pkt):
        length = int.from_bytes(pkt[p:p + 4], "big")
        tag = pkt[p + 4:p + 8]
        if tag == b"IDAT":
            idat.append(pkt[p + 8:p + 8 + length])
        p += 12 + length
        if tag == b"IEND":
            return (p if p <= len(pkt) else None), b"".join(idat)
    return None, b""


def _png_with_idat(pkt: bytes, stream: bytes) -> bytes:
    """The PNG with its IDAT chunks replaced by one holding ``stream``."""
    from .png import _chunk
    out, p, done = [pkt[:8]], 8, False
    while p + 12 <= len(pkt):
        length = int.from_bytes(pkt[p:p + 4], "big")
        tag = pkt[p + 4:p + 8]
        if tag != b"IDAT":
            out.append(pkt[p:p + 12 + length])
        elif not done:
            out.append(_chunk(b"IDAT", stream))
            done = True
        p += 12 + length
        if tag == b"IEND":
            break
    return b"".join(out)


def _png_frame(pkt: bytes):
    """A PNG frame to RGB as swscale converts FFmpeg's ``png`` output, or
    None where the PNG does not decode: no IEND chunk, or image data that
    zlib rejects (a bad code or checksum). Image data that ends early
    still gives a frame, its missing rows 0 here (FFmpeg's hold what its
    buffer held), and a row of an unknown filter type stays unfiltered,
    as in FFmpeg. Alpha is dropped."""
    from .png import read_png
    end, idat = _png_walk(pkt)
    if len(pkt) < 29 or pkt[:8] != b"\x89PNG\r\n\x1a\n" or end is None:
        return None
    w, h = struct.unpack_from(">II", pkt, 16)
    depth, ctype, lace = pkt[24], pkt[25], pkt[28]
    if depth != 8 or ctype not in (0, 2, 3, 6) or lace:
        raise unsupported_movie(f"PNG video frames of bit depth {depth}, "
                                f"colour type {ctype}, interlace {lace}")
    if not image_size_ok(w, h):
        return None
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(idat)
    except zlib.error:
        return None
    line = 1 + w * {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    rows = np.frombuffer(raw[:h * line].ljust(h * line, b"\0"),
                         np.uint8).reshape(h, line).copy()
    rows[rows[:, 0] > 4, 0] = 0      # an unknown filter leaves the row as is
    if not inflate.eof or rows.tobytes() != raw[:h * line]:
        pkt = _png_with_idat(pkt, zlib.compress(rows.tobytes()))
    try:
        fr = next(read_png(pkt))
    except (Refused, StopIteration):
        return None
    if fr.mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        p = np.asarray(fr.info["palette"], np.uint8).reshape(-1, 3)[:256]
        pal[:len(p)] = p
        return pal[fr.pixels]
    if fr.mode == "L":
        return np.repeat(fr.pixels[..., None], 3, axis=2)
    return np.ascontiguousarray(fr.pixels[..., :3])


def codec(video: AviVideo) -> tuple[str, str] | None:
    """(decoder, pixel format) for the stream; None where FFmpeg has no
    decoder for it (a tag that is no FourCC, a bit depth no pixel format
    has), so OpenCV does not open the file; item 14 for a codec FFmpeg
    decodes and this package does not."""
    tag, bits = video.tag, video.bits
    if tag == b"\0\0\0\0":
        fmt = {8: "pal8", 16: "rgb555", 24: "bgr24", 32: "bgra"}.get(bits)
        if fmt is None and bits in (1, 2, 4, 12, 15):
            raise unsupported_movie(f"uncompressed AVI video of {bits} "
                                    f"bits per pixel")
        return ("raw", fmt) if fmt else None
    if tag == b"\x03\0\0\0":
        if bits != 16:
            raise unsupported_movie(f"BI_BITFIELDS AVI video of {bits} "
                                    f"bits per pixel")
        return "raw", "rgb565"
    up = tag.upper()
    if up in _RAW_YUV:
        fmt = _RAW_YUV[up]
        return "raw", "yvu420p" if up == b"YV12" else fmt
    if up in _MJPEG:
        return "mjpeg", ""
    if tag in _MSRLE or up in _MSRLE:
        if bits not in (4, 8):
            raise unsupported_movie(f"MS RLE AVI video of {bits} bits per "
                                    f"pixel")
        return "msrle", "pal8"
    if up in _CRAM:
        if bits not in (8, 16):
            raise unsupported_movie(f"MS Video 1 AVI video of {bits} bits "
                                    f"per pixel")
        return "msvideo1", "pal8" if bits == 8 else "rgb555"
    if up in _PNG:
        return "png", ""
    if not all(32 <= b < 127 for b in tag):
        return None                  # no codec: FFmpeg does not open it
    name = _REFUSED.get(up, "a codec this package does not decode")
    raise unsupported_movie(f"AVI video in {name} (FourCC {tag!r})")


def read_avi(data: bytes):
    """(list of (H, W, 3) uint8 RGB frames, fps) of an AVI file as OpenCV
    reads it, or None where OpenCV does not open it. The frames stop at
    the first packet that does not decode."""
    video = demux(data)
    if video is None:
        return None
    got = codec(video)
    if got is None:
        return None
    kind, fmt = got
    w, h = video.width, video.height
    pal = np.zeros((256, 3), np.uint8)
    stride = (w + 3) // 4 * 4
    pic = np.zeros((h, stride if kind == "msrle" else w),
                   np.uint16 if fmt == "rgb555" else np.uint8)
    if kind == "mjpeg":
        from .mjpeg import MjpegStream
        mjpeg = MjpegStream(h)
    frames = []
    for pkt in video.packets:
        last = False
        if pkt.palette is not None:
            pal = pkt.palette
        if kind == "raw":
            rgb = _raw(video, fmt, pkt.data, pal)
        elif kind == "mjpeg":
            rgb = mjpeg.decode(pkt.data)
        elif kind == "png":
            rgb = _png_frame(pkt.data)
            # Bytes after IEND come back to the decoder as a packet of
            # their own, which fails: this frame is the movie's last.
            last = rgb is not None and _png_walk(pkt.data)[0] < len(
                pkt.data)
        elif kind == "msrle":
            from .msrle import decode_msrle
            ok = decode_msrle(pkt.data, pic, w, h, video.bits)
            rgb = pal[pic[:, :w]] if ok else None
        else:
            from .msvideo1 import decode_msvideo1
            ok = decode_msvideo1(pkt.data, pic, w, h, video.bits)
            rgb = None if not ok else (
                pal[pic] if fmt == "pal8" else rgb16_to_rgb(pic, 5))
        if rgb is None:
            break
        if frames and rgb.shape != frames[0].shape:
            raise unsupported_movie("AVI frames whose size changes within "
                                    "the movie (OpenCV rescales them to "
                                    "the first frame's)")
        frames.append(rgb)
        if last:
            break
    return frames, fps(video)
