"""Image files in the port (``io/imagefile.py`` and its readers) against the
reference's ``CKTexture.LoadImage``, which reads them through Pillow, on
the CPU.

- One case per format variant: the file written to ``tmp_path`` from
  seeded numpy, by Pillow where it writes the variant (PNG in every mode
  it saves, BMP, TGA raw and RLE, JPEG grey / 4:4:4 / 4:2:2 / 4:2:0 /
  progressive / restart markers at qualities 10 to 100, GIF, TIFF with
  each compression) and by hand otherwise (``tests/_torch_image_writers``:
  PNG of every bit depth and colour type with every filter and Adam7,
  RLE4 / RLE8 / 16-bit / bit-field / top-down / core-header BMP, 16-bit
  and colour-mapped TGA, JPEG 4:4:0 / 4:1:1 / Adobe RGB, tiled planar
  TIFF with predictor 2). Both packages load it into a texture slot; the
  slots are equal exactly.
- Truncated PNG, GIF, BMP, JPEG and TGA files return False in both.
- WebP and JPEG 2000 files, which Pillow here writes and reads, raise
  item 14 in the port.
- ``tests/torch_images/expected.npz`` still equals Pillow's decode of the
  files beside it, and the port's readers give the same frames.
- ``scenes.build_config5_images`` cut to 128x96 through both packages
  (``render_both`` / ``check_render``), and the port's loaded level
  against the same level built with ``SetImage`` of the expected arrays
  at 256x192, bit-equal over 3 ticks.
"""

import os

import numpy as np
import pytest
from PIL import Image

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.io import imagefile
from ckrenderengine_tpu_torch.io.avi import read_avi
from tests import _torch_image_writers as W
from tests._torch_common import check_render, render_both, small_ctx


def smooth(rng, h, w, c, hi=255):
    """(h, w, c) smooth seeded samples in [0, hi], with a little noise."""
    y, x = np.mgrid[0:h, 0:w]
    ph = rng.uniform(0, 6.3, (c, 2))
    a = np.stack([(np.sin(x / 7 + ph[i, 0]) + np.cos(y / 5 - ph[i, 1]) + 2)
                  / 4 * hi for i in range(c)], -1)
    return (a + rng.normal(0, hi / 60, a.shape)).clip(0, hi).astype(np.int64)


def rgb8(rng, h=29, w=37, c=3):
    return smooth(rng, h, w, c).astype(np.uint8)


def pil(mode, **save):
    """A case written by Pillow: an image of ``mode`` saved with ``save``."""
    def write(path, rng):
        a = rgb8(rng, c=4)
        if mode == "P":
            im = Image.fromarray(a[..., :3]).quantize(40)
        elif mode == "I;16":
            im = Image.fromarray(smooth(rng, 29, 37, 1, 65535)[..., 0]
                                 .astype(np.uint16))
        elif mode == "1":
            im = Image.fromarray(a[..., 0]).convert("1")
        else:
            im = Image.fromarray(a, "RGBA").convert(mode)
        im.save(path, **save)
    return write


def png(depth, ctype, interlace=False, trns=False, size=(23, 19),
        filters=(0, 1, 2, 3, 4)):
    """A PNG written by hand at any depth and colour type."""
    def write(path, rng):
        h, w = size
        spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        s = smooth(rng, h, w, spp, (1 << depth) - 1)
        pal = t = None
        if ctype == 3:
            pal = rng.integers(0, 256, (min(1 << depth, 90), 3))
            s %= len(pal)
            if trns:
                t = bytes(rng.integers(0, 256, len(pal) // 2).astype(
                    np.uint8))
        elif trns:
            t = b"".join(int(v).to_bytes(2, "big") for v in s[0, 0])
        W.write_png(path, s, depth, ctype, interlace, pal, t, filters)
    return write


def jpeg_hand(sampling, **kw):
    def write(path, rng):
        a = rgb8(rng, 41, 35)
        n = len(sampling)
        W.write_jpeg(path, [a[..., i] for i in range(n)], sampling, **kw)
    return write


def bmp_raw(bits, compression=0, masks=None, hsize=40, top=False,
            colors=0):
    """A BMP written by hand: raw rows of random bytes."""
    import struct

    def write(path, rng):
        w, h = 21, 13
        stride = ((w * bits + 31) >> 3) & ~3
        n_pal = colors or (1 << bits if bits <= 8 else 0)
        rows = rng.integers(0, 256, (h, stride)).astype(np.uint8)
        if bits <= 8:
            cap = (colors or 1 << bits) - 1
            if bits == 8:
                rows = np.minimum(rows, cap).astype(np.uint8)
            else:
                rows &= np.uint8(0x11 * min(cap, 1) if bits == 4 else 0xFF)
        if hsize == 12:
            hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
            pal = rng.integers(0, 256, n_pal * 3).astype(np.uint8).tobytes()
        else:
            hdr = struct.pack("<IiiHHIIiiII", hsize, w, -h if top else h, 1,
                              bits, compression, rows.size, 0, 0, colors, 0)
            if masks is not None:
                hdr += struct.pack("<IIII", *masks)
            hdr = hdr.ljust(hsize, b"\0")
            pal = rng.integers(0, 256, n_pal * 4).astype(np.uint8).tobytes()
        off = 14 + len(hdr) + len(pal)
        with open(path, "wb") as f:
            f.write(b"BM" + struct.pack("<IHHI", off + rows.size, 0, 0, off)
                    + hdr + pal + rows.tobytes())
    return write


def bmp_rle(bits, top=False):
    def write(path, rng):
        n = 12 if bits == 4 else 120
        idx = (smooth(rng, 27, 33, 1, n - 1)[..., 0]).astype(np.uint8)
        idx[10:, :9] = 3
        W.write_bmp_rle(path, idx, rng.integers(0, 256, (n, 3)), bits, top)
    return write


def tga16(rle=False, top_left=False):
    def write(path, rng):
        a = rgb8(rng, c=4)
        a[..., 3] = np.where(np.arange(37)[None, :] % 5 == 0, 0, 255)
        W.write_tga16(path, a, 1, top_left, rle)
    return write


def tga_cmap(start, flags):
    """A colour-mapped TGA (type 1) whose map starts at ``start``."""
    import struct

    def write(path, rng):
        w, h = 17, 11
        cmap = rng.integers(0, 256, 9 * 3).astype(np.uint8).tobytes()
        idx = rng.integers(start, start + 9, (h, w)).astype(np.uint8)
        hdr = struct.pack("<BBBHHBHHHHBB", 3, 1, 1, start, 9, 24, 0, 0, w,
                          h, 8, flags)
        with open(path, "wb") as f:
            f.write(hdr + b"id!" + cmap + idx.tobytes())
    return write


def tiff_hand(mode, planar, tile, compression, predictor, endian="<"):
    def write(path, rng):
        a = rgb8(rng, 35, 33, 4)
        img, photo, extra, pal = {
            "L": (a[..., 0], 1, (), None), "RGB": (a[..., :3], 2, (), None),
            "RGBA": (a, 2, (2,), None),
            "P": (a[..., 0] % 50, 3, (), rng.integers(0, 256, (50, 3)))}[mode]
        W.write_tiff(path, img, photo, planar, tile, 8, compression,
                     predictor, extra, pal, endian)
    return write


def gif_still(mode, **save):
    def write(path, rng):
        im = Image.fromarray(rgb8(rng))
        im = im.quantize(30) if mode == "P" else im.convert("L")
        im.save(path, **save)
    return write


CASES = {
    # PNG written by Pillow, in every mode it saves.
    "png_1": ("png", pil("1")),
    "png_L": ("png", pil("L")),
    "png_L_trns": ("png", pil("L", transparency=120)),
    "png_LA": ("png", pil("LA")),
    "png_P": ("png", pil("P")),
    "png_P_trns_index": ("png", pil("P", transparency=5)),
    "png_P_trns_alphas": ("png", pil("P", transparency=bytes(range(0, 250,
                                                                   7)))),
    "png_P_bits4": ("png", pil("P", bits=4)),
    "png_P_bits2": ("png", pil("P", bits=2)),
    "png_P_bits1": ("png", pil("P", bits=1)),
    "png_RGB": ("png", pil("RGB")),
    "png_RGB_trns": ("png", pil("RGB", transparency=(10, 20, 30))),
    "png_RGBA": ("png", pil("RGBA")),
    "png_RGBA_optimize": ("png", pil("RGBA", optimize=True)),
    "png_I16": ("png", pil("I;16")),
    # PNG written by hand: every depth and colour type, filters, Adam7.
    "png_grey1_trns": ("png", png(1, 0, trns=True)),
    "png_grey2": ("png", png(2, 0)),
    "png_grey4_adam7": ("png", png(4, 0, interlace=True)),
    "png_grey16_adam7_trns": ("png", png(16, 0, True, True)),
    "png_rgb16": ("png", png(16, 2)),
    "png_rgb16_trns": ("png", png(16, 2, trns=True)),
    "png_rgb8_adam7": ("png", png(8, 2, True, size=(37, 29))),
    "png_pal1_adam7": ("png", png(1, 3, True)),
    "png_pal2_trns": ("png", png(2, 3, trns=True)),
    "png_pal4_adam7_trns": ("png", png(4, 3, True, True)),
    "png_pal8_paeth": ("png", png(8, 3, filters=(4,))),
    "png_la8_average": ("png", png(8, 4, filters=(3,))),
    "png_la16_adam7": ("png", png(16, 4, True)),
    "png_rgba8_adam7": ("png", png(8, 6, True, size=(9, 5))),
    "png_rgba16": ("png", png(16, 6)),
    "png_rgba16_adam7_1x1": ("png", png(16, 6, True, size=(1, 1))),
    # BMP.
    "bmp_1": ("bmp", pil("1")),
    "bmp_L": ("bmp", pil("L")),
    "bmp_P": ("bmp", pil("P")),
    "bmp_RGB": ("bmp", pil("RGB")),
    "bmp_RGBA_reads_as_RGB": ("bmp", pil("RGBA")),
    "bmp_rle4": ("bmp", bmp_rle(4)),
    "bmp_rle8": ("bmp", bmp_rle(8)),
    "bmp_rle8_top_down": ("bmp", bmp_rle(8, top=True)),
    "bmp_4bit_small_palette": ("bmp", bmp_raw(4, colors=16)),
    "bmp_8bit_small_palette_v5": ("bmp", bmp_raw(8, hsize=124, colors=7)),
    "bmp_16_555": ("bmp", bmp_raw(16)),
    "bmp_16_565_bitfields": ("bmp", bmp_raw(
        16, 3, (0xF800, 0x7E0, 0x1F, 0), hsize=108)),
    "bmp_32_bitfields_alpha": ("bmp", bmp_raw(
        32, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), hsize=124)),
    "bmp_32_top_down": ("bmp", bmp_raw(32, top=True)),
    "bmp_24_core_header": ("bmp", bmp_raw(24, hsize=12)),
    "bmp_8_core_header": ("bmp", bmp_raw(8, hsize=12)),
    # TGA.
    "tga_L": ("tga", pil("L")),
    "tga_L_rle": ("tga", pil("L", compression="tga_rle")),
    "tga_LA_rle": ("tga", pil("LA", compression="tga_rle")),
    "tga_P": ("tga", pil("P")),
    "tga_P_rle_top_left": ("tga", pil("P", compression="tga_rle",
                                      orientation=1)),
    "tga_RGB_id": ("tga", pil("RGB", id_section=b"ballance")),
    "tga_RGB_rle": ("tga", pil("RGB", compression="tga_rle")),
    "tga_RGBA": ("tga", pil("RGBA")),
    "tga_RGBA_rle_top_left": ("tga", pil("RGBA", compression="tga_rle",
                                         orientation=1)),
    "tga_16bit": ("tga", tga16()),
    "tga_16bit_rle_top_left": ("tga", tga16(True, True)),
    "tga_cmap_origin": ("tga", tga_cmap(3, 0)),
    "tga_cmap_flipped": ("tga", tga_cmap(0, 0x30)),
    # JPEG.
    "jpeg_grey": ("jpg", pil("L", quality=75)),
    "jpeg_444_q100": ("jpg", pil("RGB", quality=100, subsampling=0)),
    "jpeg_422_q50": ("jpg", pil("RGB", quality=50, subsampling=1)),
    "jpeg_420_q85": ("jpg", pil("RGB", quality=85, subsampling=2)),
    "jpeg_420_q10": ("jpg", pil("RGB", quality=10, subsampling=2)),
    "jpeg_progressive_420": ("jpg", pil("RGB", progressive=True)),
    "jpeg_progressive_grey": ("jpg", pil("L", progressive=True,
                                         quality=90)),
    "jpeg_restarts_422": ("jpg", pil("RGB", subsampling=1,
                                     restart_marker_blocks=2)),
    "jpeg_restarts_progressive": ("jpg", pil("RGB", progressive=True,
                                             restart_marker_blocks=3)),
    "jpeg_440": ("jpg", jpeg_hand(((1, 2), (1, 1), (1, 1)), quality=70)),
    "jpeg_411_restarts": ("jpg", jpeg_hand(((4, 1), (1, 1), (1, 1)),
                                           restart=2)),
    "jpeg_mixed_sampling": ("jpg", jpeg_hand(((2, 2), (2, 1), (1, 2)))),
    "jpeg_adobe_rgb": ("jpg", jpeg_hand(((1, 1),) * 3, jfif=False,
                                        adobe=0)),
    "jpeg_rgb_ids": ("jpg", jpeg_hand(((1, 1),) * 3, jfif=False,
                                      ids=(82, 71, 66))),
    # GIF stills.
    "gif_P": ("gif", gif_still("P")),
    "gif_P_trns_interlaced": ("gif", gif_still("P", transparency=3,
                                               interlace=True)),
    "gif_L": ("gif", gif_still("L")),
    # TIFF.
    "tiff_RGB_raw": ("tif", pil("RGB")),
    "tiff_RGB_packbits": ("tif", pil("RGB", compression="packbits")),
    "tiff_RGB_lzw": ("tif", pil("RGB", compression="tiff_lzw")),
    "tiff_RGB_adobe_deflate": ("tif", pil(
        "RGB", compression="tiff_adobe_deflate")),
    "tiff_RGBA_deflate": ("tif", pil("RGBA", compression="tiff_deflate")),
    "tiff_L_lzw": ("tif", pil("L", compression="tiff_lzw")),
    "tiff_LA": ("tif", pil("LA")),
    "tiff_P_packbits": ("tif", pil("P", compression="packbits")),
    "tiff_RGB_tiled_planar_predictor": ("tif", tiff_hand(
        "RGB", True, 16, 8, 2)),
    "tiff_RGBA_big_endian_planar": ("tif", tiff_hand(
        "RGBA", True, None, 1, 1, ">")),
    "tiff_P_tiled": ("tif", tiff_hand("P", False, 16, 8, 1)),
}


def _load(P, path):
    tex = P.CKTexture(small_ctx(P), "t")
    return tex.LoadImage(path), tex.slots[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_image_equals_the_reference(name, tmp_path):
    ext, write = CASES[name]
    path = str(tmp_path / f"{name}.{ext}")
    write(path, np.random.default_rng(sorted(CASES).index(name)))
    ok_j, ref = _load(J, path)
    ok_o, got = _load(O, path)
    assert ok_j and ok_o
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


TRUNCATED = ("png_RGBA", "gif_P", "bmp_RGB", "jpeg_420_q85",
             "jpeg_progressive_420", "tga_RGB_rle", "png_rgb8_adam7")


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_files_return_false(name, tmp_path):
    ext, write = CASES[name]
    path = str(tmp_path / f"{name}.{ext}")
    write(path, np.random.default_rng(1))
    with open(path, "rb") as f:
        data = f.read()
    cut = str(tmp_path / f"cut.{ext}")
    for n in (len(data) // 2, len(data) * 3 // 4):
        with open(cut, "wb") as f:
            f.write(data[:n])
        assert _load(J, cut)[0] is False
        assert _load(O, cut)[0] is False


def test_missing_file_returns_false(tmp_path):
    for P in (O, J):
        assert _load(P, str(tmp_path / "missing.png"))[0] is False


@pytest.mark.parametrize("fmt,ext", [("WEBP", "webp"),
                                     ("JPEG2000", "jp2")])
def test_refused_formats_raise_item_14(fmt, ext, tmp_path):
    path = str(tmp_path / f"image.{ext}")
    Image.fromarray(rgb8(np.random.default_rng(3))).save(path, fmt)
    assert _load(J, path)[0]
    with pytest.raises(NotImplementedError,
                       match="format.*not read.*item 14"):
        _load(O, path)


def _expected():
    e = np.load(os.path.join(scenes.IMAGE_DIR, "expected.npz"))
    out = {}
    for key in e.files:
        name, k = key.rsplit(":", 1)
        frames, durations = out.setdefault(name, ([], []))
        if k == "durations":
            durations.extend(e[key].tolist())
        else:
            frames.append((int(k), e[key]))
    return {n: ([f for _k, f in sorted(fr)], d)
            for n, (fr, d) in out.items()}


def test_expected_images_equal_pillow_and_the_port():
    from PIL import ImageSequence
    expected = _expected()
    files = set(os.listdir(scenes.IMAGE_DIR)) - {"expected.npz",
                                                 "make_images.py"}
    assert set(expected) == files
    for name, (frames, durations) in expected.items():
        path = os.path.join(scenes.IMAGE_DIR, name)
        if name.endswith(".avi"):
            # Movies the reference reads with OpenCV: the port's frames
            # (alpha 255) and durations against the expected ones;
            # test_torch_avi.py holds them to OpenCV's.
            rgb, fps = read_avi(open(path, "rb").read())
            assert [1000.0 / fps] * len(rgb) == durations, name
            assert len(rgb) == len(frames), name
            for a, c in zip(frames, rgb):
                np.testing.assert_array_equal(a[..., :3], c)
                assert (a[..., 3] == 255).all()
            continue
        pil_frames = [(np.asarray(f.convert("RGBA")),
                       float(f.info.get("duration", 100.0)))
                      for f in ImageSequence.Iterator(Image.open(path))]
        port = [(imagefile.to_rgba(*f), float(f.info.get("duration",
                                                        100.0)))
                for f in imagefile.frames(path)]
        assert [d for _f, d in pil_frames] == durations == [
            d for _f, d in port], name
        for a, b, c in zip(frames, pil_frames, port):
            np.testing.assert_array_equal(a, b[0])
            np.testing.assert_array_equal(a, c[0])


CUT = dict(terrain_n=24, n_balls=4, n_signs=4)


def _level(P, **kw):
    ctx, rc, spinner, _tick = scenes.build_config5_images(P, **CUT, **kw)
    return ctx, rc, spinner


def test_image_level_matches_the_reference():
    """The level cut to 128x96 (a flat frame: the reference renders it as
    the CPU runs it), its textures and movie frames loaded through each
    package's LoadImage / LoadMovie."""
    pair = render_both(_level, accelerator=False, width=128, height=96)
    rj, rt = pair[0], pair[1]
    for name in ("checker", "ball_skin", "plaza_tex", "sign_tex"):
        np.testing.assert_array_equal(
            rt.context.GetObjectByName(name).slots[0],
            rj.context.GetObjectByName(name).slots[0])
    check_render(pair)


def test_loaded_level_equals_the_set_image_level():
    """The port's level loaded from the files against the same level built
    with SetImage of the expected arrays, at 256x192 over 3 ticks."""
    out = []
    for decoded in (None, _expected()):
        _c, rc, _s, tick = scenes.build_config5_images(
            O, width=256, height=192, decoded=decoded, device="cpu", **CUT)
        frames = []
        for _ in range(3):
            tick()
            rc.Render()
            frames.append((rc.fb.clone(), rc.zb.clone()))
        out.append(frames)
    for (fa, za), (fb, zb) in zip(*out):
        assert bool((fa == fb).all()) and bool((za == zb).all())
