"""DXT decode and DDS files in the port against the reference package, on
the CPU.

- ``decode_dxt`` is array-equal (bit for bit, no tolerance: both decode
  with the same numpy arithmetic) to the reference's on seeded random
  blocks of DXT1, DXT3 and DXT5 at sizes that are and are not multiples of
  4. Random bytes take every mode: DXT1's four-colour and three-colour
  punch-through blocks and DXT5's eight- and six-value alpha blocks (the
  test counts each).
- ``load_dds`` array-equal to the reference's on DXT files with mip chains
  down to 1x1, and on masked uncompressed 16-, 24- and 32-bit files.
- ``CKTexture.LoadImage`` (DDS: level 0 plus user mip levels) and
  ``SetCompressedImage`` hold the same images as the reference's; a WebP
  file (a format the port's readers refuse) raises item 14, a missing one
  returns False.
- A DDS-textured quad at 64x64 (the reference's
  tests/test_dds.py:146 scene, the flat route) within ``ATOL`` of the
  reference's frame.
"""

import struct

import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.io import dds as jdds
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.io import dds as tdds
from tests._torch_common import assert_frames_close, small_ctx

SIZES = ((4, 4), (6, 6), (13, 7), (32, 32), (1, 1), (2, 9))


def _blocks(fmt, w, h, seed):
    rng = np.random.default_rng(seed)
    per = 8 if fmt == "DXT1" else 16
    return rng.bytes(((w + 3) // 4) * ((h + 3) // 4) * per)


@pytest.mark.parametrize("fmt", ["DXT1", "DXT3", "DXT5"])
def test_decode_dxt_equals_the_reference(fmt):
    modes = [0, 0]
    for i, (w, h) in enumerate(SIZES):
        data = _blocks(fmt, w, h, 100 * i + len(fmt))
        got = tdds.decode_dxt(data, w, h, fmt.lower())
        ref = jdds.decode_dxt(data, w, h, fmt)
        assert got.shape == (h, w, 4) and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
        n = len(data) // (8 if fmt == "DXT1" else 16)
        raw = np.frombuffer(data, np.uint8).reshape(n, -1)
        if fmt == "DXT1":
            c = raw[:, :4].copy().view(np.uint16)
            two = c[:, 0] <= c[:, 1]          # three-colour mode
        else:
            two = raw[:, 0] <= raw[:, 1]      # DXT5's six-value alpha
        modes[0] += int((~two).sum())
        modes[1] += int(two.sum())
    if fmt != "DXT3":
        assert min(modes) > 5, modes
    with pytest.raises(ValueError):
        tdds.decode_dxt(b"\0" * 8, 4, 4, "BC7")


def _masked_dds(w, h, bits, masks, alpha, seed):
    """A masked uncompressed DDS file (RGB, with ALPHAPIXELS when
    ``alpha``) of seeded pixels, with a mip chain down to 1x1."""
    rng = np.random.default_rng(seed)
    levels, s = [], (w, h)
    while True:
        levels.append(rng.bytes(s[0] * s[1] * bits // 8))
        if s == (1, 1):
            break
        s = (max(s[0] // 2, 1), max(s[1] // 2, 1))
    pf = struct.pack("<II4sIIIII", 32, 0x40 | (0x1 if alpha else 0),
                     b"\0\0\0\0", bits, *masks)
    header = (b"DDS " + struct.pack("<7I", 124, 0x1 | 0x2 | 0x4 | 0x1000
                                    | 0x20000, h, w, 0, 0, len(levels))
              + b"\0" * 44 + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return header + b"".join(levels)


DDS_FILES = {
    "dxt1_mips": lambda: scenes.dxt1_checker(32, (0.9, 0.85, 0.7),
                                             (0.3, 0.35, 0.3)),
    "dxt3_odd": lambda: scenes.dds_file(
        12, 20, "DXT3", [_blocks("DXT3", 12, 20, 3)]),
    "dxt5_mips": lambda: scenes.dds_file(
        16, 8, "DXT5", [_blocks("DXT5", *s, 5 + i) for i, s in enumerate(
            ((16, 8), (8, 4), (4, 2), (2, 1), (1, 1)))]),
    "a8r8g8b8": lambda: _masked_dds(
        8, 4, 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), True, 7),
    "r8g8b8": lambda: _masked_dds(5, 3, 24, (0xFF0000, 0xFF00, 0xFF, 0),
                                  False, 8),
    "r5g6b5": lambda: _masked_dds(4, 4, 16, (0xF800, 0x7E0, 0x1F, 0),
                                  False, 9),
    "a1r5g5b5": lambda: _masked_dds(4, 2, 16, (0x7C00, 0x3E0, 0x1F, 0x8000),
                                    True, 10),
}


@pytest.mark.parametrize("name", sorted(DDS_FILES))
def test_load_dds_equals_the_reference(name, tmp_path):
    data = DDS_FILES[name]()
    assert tdds.is_dds(data) and not tdds.is_dds(b"PNG")
    path = tmp_path / f"{name}.dds"
    path.write_bytes(data)
    with open(path, "rb") as f:
        from_file = tdds.load_dds(f)
    for src in (bytes(data), str(path)):
        got, ref = tdds.load_dds(src), jdds.load_dds(src)
        assert len(got) == len(ref) > 0
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(from_file, ref):
        np.testing.assert_array_equal(a, b)
    if name == "dxt1_mips":
        assert [lv.shape[0] for lv in got] == [32, 16, 8, 4, 2, 1]
        # The two checker colours come back exactly, as their 565 words.
        c = {tuple(px) for px in got[0].reshape(-1, 4)}
        assert len(c) == 2
    with pytest.raises(ValueError):
        tdds.load_dds(b"JUNK" + data[4:])


def test_texture_image_api_equals_the_reference(tmp_path):
    path = tmp_path / "sign.dds"
    path.write_bytes(scenes.dds_file(
        8, 8, "DXT5", [_blocks("DXT5", 8, 8, 1), _blocks("DXT5", 4, 4, 2),
                       _blocks("DXT5", 2, 2, 3), _blocks("DXT5", 1, 1, 4)]))
    from PIL import Image
    other = tmp_path / "image.webp"
    Image.new("RGB", (8, 8), (40, 90, 160)).save(other, "WEBP")
    dxt3 = _blocks("DXT3", 12, 8, 6)
    out = []
    for P in (O, J):
        ctx = small_ctx(P)
        tex = P.CKTexture(ctx, "t")
        assert tex.LoadImage(str(path))
        assert tex._user_mip_mode and len(tex.user_mip_levels) == 3
        assert not tex.LoadImage(str(tmp_path / "missing.dds"))
        skin = P.CKTexture(ctx, "s")
        assert skin.SetCompressedImage(dxt3, 12, 8, "DXT3", slot=1)
        assert not skin.SetCompressedImage(dxt3, 12, 8, "ATI2")
        out.append((tex.slots[0], tex.user_mip_levels, skin.slots[1]))
        if P is O:
            with pytest.raises(NotImplementedError,
                               match="format.*not read.*item 14"):
                tex.LoadImage(str(other))
    (t0, tm, ts), (j0, jm, js) = out
    np.testing.assert_array_equal(t0, j0)
    np.testing.assert_array_equal(ts, js)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)


def _dds_quad(P, path):
    """The reference's DDS quad (tests/test_dds.py:146-176), an emissive
    quad textured by ``path``, at 64x64; its half width 1.37 (not 1.5)
    keeps the checker's texel edges off the pixel centres, where the two
    packages' f32 UVs could round to either texel."""
    ctx = small_ctx(P)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 0.0, -3.0))
    rc.AttachViewpointToCamera(cam)
    tex = P.CKTexture(ctx, "dxt")
    assert tex.LoadImage(str(path))
    mesh = P.CKMesh(ctx, "quad")
    s = 1.37
    mesh.SetPositions(np.array(
        [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.SetUVs(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "m")
    mat.SetTexture(tex)
    mat.SetEmissive((1, 1, 1, 1))
    mesh.ApplyGlobalMaterial(mat)
    obj = P.CK3dObject(ctx, "q")
    obj.SetCurrentMesh(mesh)
    rc.SetBackgroundColor((0, 0, 0, 1))
    rc.Render()
    return rc


def test_dds_textured_frame_matches_the_reference(tmp_path):
    path = tmp_path / "checker.dds"
    path.write_bytes(scenes.dxt1_checker(16, (0.9, 0.2, 0.1),
                                         (0.1, 0.3, 0.8)))
    rc_t, rc_j = _dds_quad(O, path), _dds_quad(J, path)
    assert_frames_close(rc_t, rc_j)
    fb = rc_t.framebuffer()
    assert len(np.unique(fb[16:48, 16:48, 0])) >= 2   # the checker shows
