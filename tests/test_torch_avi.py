"""AVI movie sprites in the port (``CKSprite.LoadMovie`` through
``io/avi.py`` and its decoders) against the reference's, which reads the
file with OpenCV's ``VideoCapture`` (FFmpeg), on the CPU.

- One case per variant, written to ``tmp_path`` by OpenCV or by the hand
  writers of ``tests/_torch_image_writers.py``: BI_RGB at 8, 16, 32 bits
  and 24 bits top-down, both row orders and odd widths; BI_BITFIELDS
  RGB565; I420 / YV12 / YUY2 / UYVY / Y800 at even and odd sizes (the
  unscaled converter and swscale's bicubic chroma); MS RLE 8 and 4; MS
  Video 1 8 and 16; PNG frames; MJPG 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0 /
  4:1:1 / grey, without DHT, progressive, two-field, odd sizes, and
  OpenCV's own
  MJPG, raw and PNG writers; the container's forms (interleaved and
  non-interleaved audio, ``LIST rec``, JUNK, idx1 relative and absolute,
  no idx1, OpenDML ``indx`` + ``AVIX``, dropped frames, palette changes)
  and frame rates (30000/1001, a scale of 0, ``avih`` disagreeing with
  ``strh``). Every slot, the frame count, ``GetMovieLength`` and the slot
  ``SetMovieTime`` picks are equal exactly.
- Damaged files: cut at a dozen points each (the frame count, or False
  where the reference returns False), a bad packet in the middle, a cut
  inside ``hdrl``.
- 24-bit bottom-up BI_RGB is held to the pixels written: the reference's
  process dies reading it (``malloc_consolidate``), so it is never given
  to the reference here.
- Containers and codecs the port does not read raise item 14 by name.
"""

import struct

import cv2
import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.io import avi
from tests._torch_common import small_ctx
from tests._torch_image_writers import (
    avi_bytes, avi_movie, jpeg_bytes, jpeg_frame, movie_indices, movie_rgb,
)


def _file(kind, **kw):
    def write(path, rng):
        with open(path, "wb") as f:
            f.write(avi_movie(kind, rng, **kw))
    return write


def _opencv(fourcc, n=4, h=48, w=64, fps=12.5):
    """A movie written by OpenCV's own ``VideoWriter``."""
    def write(path, rng):
        code = cv2.VideoWriter_fourcc(*fourcc) if fourcc else 0
        out = cv2.VideoWriter(path, cv2.CAP_FFMPEG, code, fps, (w, h))
        assert out.isOpened(), fourcc
        for f in movie_rgb(rng, n, h, w):
            out.write(np.ascontiguousarray(f[..., ::-1]))
        out.release()
    return write


def _dropped(path, rng):
    """Zero-length chunks between frames, before the first and at the end."""
    data = avi_movie("pal8", rng, n=5)
    got = avi.demux(data)
    frames = [p.data for p in got.packets]
    pal = got.palette
    with open(path, "wb") as f:
        f.write(avi_bytes([b"", frames[0], b"", frames[1], b"", b"",
                           *frames[2:], b""], 64, 48, 0, 8, palette=pal))


def _palette_changes(path, rng):
    """``00pc`` chunks: half the palette, then one entry, then all 256."""
    h, w = 20, 24
    idx = movie_indices(rng, 5, h, w, 256)
    pal = rng.integers(0, 256, (256, 3))

    def pc(first, cols):
        n = len(cols)
        return ("pc", struct.pack("<BBH", first, n & 0xFF, 0) + b"".join(
            struct.pack("<BBBB", *c, 0) for c in cols))
    rows = [f[::-1].tobytes() for f in idx]
    frames = [rows[0], pc(0, rng.integers(0, 256, (128, 3)).tolist()),
              rows[1], rows[2], pc(7, [[1, 2, 3]]), rows[3],
              pc(0, rng.integers(0, 256, (256, 3)).tolist()), rows[4]]
    with open(path, "wb") as f:
        f.write(avi_bytes(frames, w, h, 0, 8, palette=pal))


def _mjpg_fields(subsampling, progressive=False):
    """Two-field MJPEG: each packet the frame's odd rows, then its even
    rows, as two JPEGs of half the stream's height."""
    def write(path, rng):
        import io

        from PIL import Image
        h, w = 32, 40
        packets = []
        for f in movie_rgb(rng, 3, h, w):
            fields = []
            for rows in (f[1::2], f[0::2]):
                b = io.BytesIO()
                Image.fromarray(rows).save(b, "JPEG", quality=85,
                                           subsampling=subsampling,
                                           progressive=progressive)
                fields.append(b.getvalue())
            packets.append(b"".join(fields))
        with open(path, "wb") as f:
            f.write(avi_bytes(packets, w, h, b"MJPG", 24))
    return write


def _mjpg_progressive(path, rng):
    import io

    from PIL import Image
    packets = []
    for f in movie_rgb(rng, 3, 27, 37):
        b = io.BytesIO()
        Image.fromarray(f).save(b, "JPEG", progressive=True, quality=70,
                                subsampling=2)
        packets.append(b.getvalue())
    with open(path, "wb") as f:
        f.write(avi_bytes(packets, 37, 27, b"MJPG", 24))


def _short_palette(path, rng):
    """8-bit frames with a 16-entry palette that use indices past it."""
    h, w = 16, 20
    idx = rng.integers(0, 24, (3, h, w)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(avi_bytes([i[::-1].tobytes() for i in idx], w, h, 0, 8,
                          palette=rng.integers(0, 256, (16, 3))))


CASES = {
    "pal8": _file("pal8"),
    "pal8_top_down_odd_width": _file("pal8", top_down=True, w=37, h=20),
    "pal8_short_palette": _short_palette,
    "rgb555": _file("rgb555", w=37),
    "rgb555_top_down": _file("rgb555", top_down=True),
    "rgb565_bitfields": _file("rgb565"),
    "bgr24_top_down_odd_width": _file("bgr24", top_down=True, w=37),
    "bgr32": _file("bgr32"),
    "bgr32_top_down": _file("bgr32", top_down=True, w=35),
    "i420": _file("i420"),
    "i420_odd_width": _file("i420", w=37, h=24),
    "i420_odd_height": _file("i420", w=36, h=25),
    "i420_odd_both": _file("i420", w=37, h=25),
    "i420_seven_rows": _file("i420", w=20, h=7),
    "yv12": _file("yv12"),
    "yv12_odd_height": _file("yv12", h=3),
    "yuy2": _file("yuy2"),
    "yuy2_odd_height": _file("yuy2", h=47),
    "yuy2_odd_width": _file("yuy2", w=31, h=30),
    "uyvy": _file("uyvy", h=2, w=40),
    "uyvy_odd_both": _file("uyvy", h=9, w=13),
    "y800": _file("y800", w=37, h=21),
    "msrle8": _file("msrle8"),
    "msrle4": _file("msrle4", w=37),
    "cram8": _file("cram8"),
    "cram16": _file("cram16", w=66, h=42),
    "mpng": _file("mpng"),
    "mjpg420": _file("mjpg420"),
    "mjpg420_odd_width": _file("mjpg420", w=37, h=24),
    "mjpg422": _file("mjpg422"),
    "mjpg422_odd_height": _file("mjpg422", h=47),
    "mjpg420_odd_height": _file("mjpg420", w=40, h=23),
    "mjpg444": _file("mjpg444", w=35, h=21),
    "mjpg440": _file("mjpg440", w=24, h=30),
    "mjpg411": _file("mjpg411", w=45, h=17),
    "mjpg_grey": _file("mjpg_grey"),
    "mjpg_progressive": _mjpg_progressive,
    "mjpg_two_fields_420": _mjpg_fields(2),
    "mjpg_two_fields_422": _mjpg_fields(1),
    "mjpg_avi1_no_dht": _file("mjpg_avi1"),
    "opencv_mjpg": _opencv("MJPG"),
    "opencv_raw_i420": _opencv(None, fps=30000 / 1001),
    "opencv_mpng": _opencv("MPNG", n=3),
    "audio_interleaved": _file("mjpg420", audio=True),
    "audio_first_not_interleaved": _file("pal8", n=5, audio="first"),
    "rec_lists": _file("msrle8", rec=True),
    "junk_absolute_idx1": _file("pal8", junk=True, index="file"),
    "no_idx1": _file("i420", index=None),
    "odml_avix": _file("pal8", n=6, odml=2),
    "odml_audio": _file("cram16", n=6, odml=3, audio=True),
    "dropped_frames": _dropped,
    "palette_changes": _palette_changes,
    "rate_ntsc": _file("y800", rate=30000, scale=1001),
    "rate_scale_zero": _file("y800", rate=25, scale=0, usec=33367),
    "rate_all_zero": _file("y800", rate=0, scale=0, usec=0),
    "avih_disagrees": _file("y800", rate=15, scale=1, usec=100000),
    "stream_name": _file("msrle4", name=b"hud spinner"),
}


def _movie(P, path):
    sp = P.CKSprite(small_ctx(P), "movie")
    return sp, sp.LoadMovie(path)


def _same_movie(so, sj) -> None:
    n = sj.GetMovieFrameCount()
    assert so.GetMovieFrameCount() == n >= 1
    assert so.GetMovieLength() == sj.GetMovieLength()
    assert so._movie_durations == sj._movie_durations
    assert so.GetCurrentSlot() == sj.GetCurrentSlot() == 0
    for k in range(n):
        np.testing.assert_array_equal(so.GetImage(k), sj.GetImage(k),
                                      err_msg=f"slot {k}")
    ends = np.cumsum(sj._movie_durations)
    for t in sorted({0.0, *ends, *(ends - 1e-3), float(ends[-1] * 2.5)}):
        assert so.SetMovieTime(t) == sj.SetMovieTime(t), t
        assert so.GetCurrentSlot() == sj.GetCurrentSlot()


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_movie_equals_the_reference(name, tmp_path):
    path = str(tmp_path / f"{name}.avi")
    CASES[name](path, np.random.default_rng(sorted(CASES).index(name)))
    sj, ok_j = _movie(J, path)
    so, ok_o = _movie(O, path)
    assert ok_j is True and ok_o is True
    _same_movie(so, sj)


# Files cut at a dozen points each: the cut falls in hdrl, in chunk
# headers and inside frames.
CUT_CASES = {
    "mjpg420": _file("mjpg420", n=5),
    "opencv_mjpg": _opencv("MJPG", n=4),
    "i420": _file("i420", n=4, h=16, w=24),
    "pal8_audio": _file("pal8", n=4, audio=True, h=16, w=24),
    "msrle8": _file("msrle8", n=5),
    "cram16": _file("cram16", n=4, h=16, w=24),
    "mpng": _file("mpng", n=4, h=16, w=24),
    "odml_no_idx1": _file("y800", n=5, odml=2, index=None, h=8, w=16),
}


def _count(P, path):
    sp, ok = _movie(P, path)
    return sp.GetMovieFrameCount() if ok else False


@pytest.mark.parametrize("name", sorted(CUT_CASES))
def test_truncated_files_give_the_reference_frame_count(name, tmp_path):
    whole = tmp_path / "whole.avi"
    CUT_CASES[name](str(whole), np.random.default_rng(7))
    data = whole.read_bytes()
    n = len(data)
    cuts = sorted({60, 150, 250, *(int(n * f) for f in np.linspace(
        0.08, 0.995, 10))})
    path = str(tmp_path / "cut.avi")
    counts = []
    for c in cuts:
        with open(path, "wb") as f:
            f.write(data[:c])
        want = _count(J, path)
        assert _count(O, path) == want, (c, n)
        counts.append(want)
    assert False in counts and max(counts) >= 3


def _mid_damage(kind):
    def write(path, rng):
        video = avi.demux(avi_movie(kind, rng, n=5))
        pk = [p.data for p in video.packets]
        pk[2] = pk[2][:len(pk[2]) // 3] if kind != "mjpg420" else \
            b"no jpeg here" * 4
        with open(path, "wb") as f:
            f.write(avi_bytes(pk, video.width, video.height, video.tag,
                              video.bits, palette=video.palette))
    return write


@pytest.mark.parametrize("kind", ["mjpg420", "i420", "msrle8", "pal8"])
def test_a_bad_packet_in_the_middle(kind, tmp_path):
    """OpenCV's read loop stops at the first packet that fails to decode
    (a raw frame too short, a JPEG without a frame); an RLE or 8-bit
    palettised frame decodes whatever its packet holds."""
    path = str(tmp_path / "damaged.avi")
    _mid_damage(kind)(path, np.random.default_rng(3))
    sj, ok_j = _movie(J, path)
    so, ok_o = _movie(O, path)
    assert ok_o == ok_j is True
    assert so.GetMovieFrameCount() == sj.GetMovieFrameCount()
    n = sj.GetMovieFrameCount()
    assert n == (2 if kind in ("mjpg420", "i420") else 5)
    for k in range(2):
        np.testing.assert_array_equal(so.GetImage(k), sj.GetImage(k))


def test_bottom_up_24_bit_against_the_written_pixels(tmp_path):
    """The reference crashes reading 24-bit bottom-up BI_RGB (its FFmpeg
    frame copy corrupts the heap), so the port is held to the pixels
    written; the same frames top-down equal the reference."""
    rng = np.random.default_rng(11)
    frames = movie_rgb(rng, 3, 20, 37)
    for top_down in (False, True):
        rows = []
        for f in frames:
            px = f[..., ::-1] if top_down else f[::-1, :, ::-1]
            rows.append(np.pad(np.ascontiguousarray(px).reshape(20, -1),
                               ((0, 0), (0, 1))).tobytes())
        path = str(tmp_path / f"bgr24_{top_down}.avi")
        with open(path, "wb") as f:
            f.write(avi_bytes(rows, 37, 20, 0, 24, top_down=top_down,
                              rate=10))
        so, ok = _movie(O, path)
        assert ok and so.GetMovieFrameCount() == 3
        assert so._movie_durations == [100.0] * 3
        for k, f in enumerate(frames):
            np.testing.assert_array_equal(
                so.GetImage(k)[..., :3], f.astype(np.float32) / 255.0)
            assert (so.GetImage(k)[..., 3] == 1.0).all()
        if top_down:
            _same_movie(so, _movie(J, path)[0])


def _tagged(tag, bits=24, frame=b"\0" * 64):
    def write(path, rng):
        with open(path, "wb") as f:
            f.write(avi_bytes([frame], 8, 8, tag, bits))
    return write


REFUSED = {
    "mp4": (lambda p, r: open(p, "wb").write(
        b"\0\0\0\x18ftypisom\0\0\x02\0isomiso2" + bytes(64)),
        "video containers other than AVI (MP4 / MOV)"),
    "matroska": (lambda p, r: open(p, "wb").write(
        b"\x1aE\xdf\xa3" + bytes(64)), "(Matroska / WebM)"),
    "mpeg_ps": (lambda p, r: open(p, "wb").write(
        b"\0\0\x01\xba" + bytes(300)), "(MPEG-PS)"),
    "mpeg_ts": (lambda p, r: open(p, "wb").write(
        (b"G" + bytes(187)) * 3), "(MPEG-TS)"),
    "flv": (lambda p, r: open(p, "wb").write(b"FLV\x01" + bytes(64)),
            "(FLV)"),
    "webp": (lambda p, r: open(p, "wb").write(
        b"RIFF\x24\0\0\0WEBPVP8 " + bytes(64)), "video containers"),
    "avix_alone": (lambda p, r: open(p, "wb").write(
        b"RIFF\x24\0\0\0AVIXLIST" + bytes(64)), "video containers"),
    "cinepak": (_tagged(b"cvid"), "Cinepak"),
    "xvid": (_tagged(b"XVID"), "MPEG-4 ASP"),
    "h264": (_tagged(b"H264"), "H.264"),
    "huffyuv": (_tagged(b"HFYU"), "HuffYUV"),
    "opencv_ffv1": (_opencv("FFV1", n=2), "FFV1"),
    "opencv_fmp4": (_opencv("FMP4", n=2), "MPEG-4 ASP"),
    "mjpg_size_change": (lambda p, r: open(p, "wb").write(avi_bytes(
        [jpeg_frame(f) for f in movie_rgb(r, 1, 16, 16)
         + movie_rgb(r, 1, 16, 24)], 24, 16, b"MJPG", 24)), "size changes"),
    "mjpg_rgb": (lambda p, r: open(p, "wb").write(avi_bytes(
        [jpeg_bytes([np.full((8, 8), 9, np.uint8)] * 3, [(1, 1)] * 3,
                    ids=(82, 71, 66), jfif=False)], 8, 8, b"MJPG", 24)),
        "RGB MJPEG"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_containers_and_codecs_raise_item_14(name, tmp_path):
    write, word = REFUSED[name]
    path = str(tmp_path / f"{name}.avi")
    write(path, np.random.default_rng(1))
    with pytest.raises(NotImplementedError, match="item 14") as err:
        _movie(O, path)
    assert word in str(err.value)


def test_demux_reads_the_container():
    """``demux``: the stream's fields, the packets in order with dropped
    frames left out, the palette sent with the first packet and after
    each change, and the rate the way FFmpeg settles it."""
    rng = np.random.default_rng(5)
    data = avi_movie("pal8", rng, n=3, h=8, w=12, rate=30000, scale=1001,
                     audio=True, rec=True)
    v = avi.demux(data)
    assert (v.tag, v.width, v.height, v.top_down, v.bits) == (
        b"\0\0\0\0", 12, 8, False, 8)
    assert (v.rate, v.scale) == (30000, 1001)
    assert avi.fps(v) == 30000 / 1001
    assert len(v.packets) == 3
    assert v.packets[0].palette is not None
    assert all(p.palette is None for p in v.packets[1:])
    assert all(len(p.data) == 12 * 8 for p in v.packets)
    assert avi.demux(data[:100]) is None                    # inside hdrl
    assert avi.demux(b"RIFF\0\0\0\0AVI ") is None
    cut = avi.demux(data[:len(data) - 150])
    assert [len(p.data) for p in cut.packets][:2] == [96, 96]
    v = avi.demux(avi_movie("y800", rng, n=2, h=4, w=4, rate=7, scale=0,
                            usec=0))
    assert (v.rate, v.scale) == (25, 1)
    v = avi.demux(avi_movie("y800", rng, n=2, h=4, w=4, rate=0, scale=0,
                            usec=40000))
    assert (v.rate, v.scale) == (1000000, 40000)


def test_hud_movies_equal_the_expected_frames():
    """The level's AVI sprites (``scenes.MOVIE_FILES``) decode in the port
    and in the reference as ``expected.npz`` holds them."""
    import os
    e = np.load(os.path.join(scenes.IMAGE_DIR, "expected.npz"))
    for name in scenes.MOVIE_FILES.values():
        if not name.endswith(".avi"):
            continue
        path = os.path.join(scenes.IMAGE_DIR, name)
        so, ok_o = _movie(O, path)
        sj, ok_j = _movie(J, path)
        assert ok_o and ok_j
        _same_movie(so, sj)
        durations = e[f"{name}:durations"].tolist()
        assert so._movie_durations == durations
        for k in range(len(durations)):
            np.testing.assert_array_equal(
                so.GetImage(k), e[f"{name}:{k}"].astype(np.float32) / 255.0)


def test_an_avi_is_no_image(tmp_path):
    """``LoadImage`` of an AVI returns False (Pillow refuses it)."""
    path = str(tmp_path / "movie.avi")
    with open(path, "wb") as f:
        f.write(avi_movie("y800", np.random.default_rng(2), n=2, h=8, w=8))
    for P in (O, J):
        assert P.CKTexture(small_ctx(P), "t").LoadImage(path) is False


def _audio_only(path, rng):
    data = bytearray(avi_movie("y800", rng, n=2, h=8, w=8))
    at = data.index(b"vids")
    data[at:at + 4] = b"auds"
    with open(path, "wb") as f:
        f.write(bytes(data))


def _one_field(path, rng):
    with open(path, "wb") as f:
        f.write(avi_bytes([jpeg_frame(x) for x in movie_rgb(rng, 2, 8, 16)],
                          16, 16, b"MJPG", 24))


NO_MOVIE = {
    "audio_only": _audio_only,
    "short_first_raw_frame": lambda p, r: open(p, "wb").write(avi_bytes(
        [b"\0" * 40, b"\0" * 64], 8, 8, b"Y800", 8)),
    "mjpg_one_field_per_packet": _one_field,
    "mjpg_progressive_fields": _mjpg_fields(1, progressive=True),
}


@pytest.mark.parametrize("name", sorted(NO_MOVIE))
def test_files_that_give_no_movie(name, tmp_path):
    """No video stream, a first frame that does not decode (a short raw
    frame, a field without its pair, a progressive field, which
    ``mjpegdec`` refuses): False in both packages."""
    path = str(tmp_path / f"{name}.avi")
    NO_MOVIE[name](path, np.random.default_rng(4))
    for P in (O, J):
        assert _movie(P, path)[1] is False, P.__name__
