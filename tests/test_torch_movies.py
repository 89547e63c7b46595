"""Movie sprites in the port (``CKSprite.LoadMovie`` through
``io/imagefile.py``) against the reference's, which reads the frames with
Pillow's ``ImageSequence.Iterator``, on the CPU.

- One case per variant, written by Pillow from seeded numpy: animated GIFs
  (global and local palettes, a transparent index, disposal 0-3 and their
  mix, interlace, frames cut to their changed rectangle, grey), APNGs
  (RGBA, RGB and grey-with-alpha frames, dispose ops none / background /
  previous, blend ops source / over, a default image), a multi-page TIFF
  and still JPEG, PNG and BMP files (one frame of 100 ms). Every slot is
  equal exactly, and so are the frame count, ``GetMovieLength`` and the
  slot ``SetMovieTime`` picks at times before, on and past each frame's
  end and past the movie's length.
- The reference's scenario of tests/test_2d_overlay.py:267-300 (a GIF
  movie rendered by time, wrapping) run through the port.
- A missing file and an AVI that does not open return False in both
  packages; a file the readers do not take (an MP4) raises item 14 naming
  video containers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.raster.types import VXCMP
from tests._torch_common import (
    assert_frames_close, small_ctx, small_rc, textured_quad,
)


def frames_rgb(rng, n=3, h=24, w=28):
    """``n`` RGB frames: a square moving over a smooth ground, each frame
    changing only part of the picture."""
    y, x = np.mgrid[0:h, 0:w]
    wave = (np.sin(x / 5 + rng.uniform(0, 6)) + np.cos(y / 4) + 2) / 4
    ground = wave[..., None] * np.array([200.0, 150.0, 90.0])
    out = []
    for k in range(n):
        a = ground.copy()
        a[4:12, 3 + 6 * k:11 + 6 * k] = (250, 220 - 40 * k, 30 + 60 * k)
        out.append(a.astype(np.uint8))
    return out


def gif(n=3, quant=True, grey=False, **save):
    def write(path, rng):
        ims = [Image.fromarray(f) for f in frames_rgb(rng, n)]
        if grey:
            ims = [im.convert("L") for im in ims]
        elif quant:
            ims = [im.quantize(12 + 6 * k) for k, im in enumerate(ims)]
        ims[0].save(path, save_all=True, append_images=ims[1:], loop=0,
                    **save)
    return write


def apng(mode="RGBA", **save):
    def write(path, rng):
        ims = []
        for k, f in enumerate(frames_rgb(rng)):
            a = np.full(f.shape[:2] + (1,), 255, np.uint8)
            a[:, :6 + 5 * k] = 60 + 50 * k
            im = Image.fromarray(np.concatenate([f, a], 2), "RGBA")
            ims.append(im.convert(mode))
        ims[0].save(path, save_all=True, append_images=ims[1:], **save)
    return write


def tiff_pages(path, rng):
    ims = [Image.fromarray(f) for f in frames_rgb(rng)]
    ims[1] = ims[1].convert("L")
    ims[0].save(path, save_all=True, append_images=ims[1:],
                compression="tiff_lzw")


def still(fmt, mode="RGB", **save):
    def write(path, rng):
        Image.fromarray(frames_rgb(rng, 1)[0]).convert(mode).save(
            path, fmt, **save)
    return write


DUR = [40, 60, 100]

CASES = {
    "gif_global_palette": ("gif", gif(quant=False, duration=DUR)),
    "gif_local_palettes": ("gif", gif(duration=DUR)),
    "gif_transparency_disposal2": ("gif", gif(duration=DUR, disposal=2,
                                              transparency=0)),
    "gif_disposal3_transparency": ("gif", gif(duration=DUR, disposal=3,
                                              transparency=1)),
    "gif_disposal1": ("gif", gif(duration=[30, 30, 30], disposal=1)),
    "gif_disposal_mix": ("gif", gif(n=4, duration=[20, 40, 60, 80],
                                    disposal=[2, 3, 1, 0],
                                    transparency=2)),
    "gif_interlaced": ("gif", gif(duration=DUR, interlace=True)),
    "gif_cut_rectangles": ("gif", gif(n=4, duration=50, optimize=True)),
    "gif_grey": ("gif", gif(grey=True, duration=[70, 80, 90])),
    "gif_no_duration": ("gif", gif(quant=False)),
    "apng_rgba_over": ("png", apng(duration=[50, 70.5, 90], blend=1)),
    "apng_rgba_source_dispose_background": ("png", apng(
        duration=DUR, blend=0, disposal=1)),
    "apng_rgba_dispose_previous_over": ("png", apng(
        duration=DUR, blend=1, disposal=2)),
    "apng_rgba_mixed_ops": ("png", apng(duration=DUR, blend=[1, 0, 1],
                                        disposal=[2, 1, 0])),
    "apng_rgb": ("png", apng("RGB", duration=DUR)),
    "apng_la_over": ("png", apng("LA", duration=DUR, blend=1)),
    "apng_default_image": ("png", apng(duration=[10, 20, 30],
                                       default_image=True)),
    "tiff_pages": ("tif", tiff_pages),
    "still_jpeg": ("jpg", still("JPEG", quality=80)),
    "still_png": ("png", still("PNG", "RGBA")),
    "still_bmp": ("bmp", still("BMP")),
}


def _movie(P, path):
    sp = P.CKSprite(small_ctx(P), "movie")
    return sp, sp.LoadMovie(path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_movie_equals_the_reference(name, tmp_path):
    ext, write = CASES[name]
    path = str(tmp_path / f"{name}.{ext}")
    write(path, np.random.default_rng(sorted(CASES).index(name)))
    sj, ok_j = _movie(J, path)
    so, ok_o = _movie(O, path)
    assert ok_j is True and ok_o is True
    n = sj.GetMovieFrameCount()
    assert so.GetMovieFrameCount() == n >= 1
    assert so.GetMovieLength() == sj.GetMovieLength()
    assert so.GetCurrentSlot() == sj.GetCurrentSlot() == 0
    for k in range(n):
        np.testing.assert_array_equal(so.GetImage(k), sj.GetImage(k))
    ends = np.cumsum(sj._movie_durations)
    times = sorted({0.0, *ends, *(ends - 1e-3), *(ends + 7.5),
                    float(ends[-1] * 2.5)})
    for t in times:
        assert so.SetMovieTime(t) == sj.SetMovieTime(t), t
        assert so.GetCurrentSlot() == sj.GetCurrentSlot()


def test_gif_movie_frames_render_by_time(tmp_path):
    """tests/test_2d_overlay.py:267-300 through the port."""
    frames = []
    for c in ((255, 0, 0), (0, 255, 0), (0, 0, 255)):
        a = np.zeros((16, 16, 3), np.uint8)
        a[:] = c
        frames.append(Image.fromarray(a))
    p = str(tmp_path / "movie.gif")
    frames[0].save(p, save_all=True, append_images=frames[1:],
                   duration=[40, 60, 100], loop=0)

    ctx = O.CKContext(device="cpu")
    rc = ctx.GetRenderManager().CreateRenderContext(32, 32)
    sp = O.CKSprite(ctx, "movie")
    assert sp.LoadMovie(p)
    assert sp.GetMovieFrameCount() == 3
    assert sp.GetMovieLength() == 200.0
    sp.SetRect((0, 0, 32, 32))
    sp.SetBackground(False)
    expected = {0: (1, 0, 0), 50: (0, 1, 0), 150: (0, 0, 1),
                250: (0, 1, 0)}   # 250 wraps into frame 1
    for t, rgb in expected.items():
        sp.SetMovieTime(t)
        rc.Render()
        c = np.asarray(rc.framebuffer())[16, 16, :3]
        np.testing.assert_allclose(c, rgb, atol=1e-5)


def test_missing_file_and_video_containers(tmp_path):
    for P in (O, J):
        assert _movie(P, str(tmp_path / "missing.gif"))[1] is False
    # An AVI is read by the port since item 14's AVI slice: a header with
    # no movi list does not open, in both packages.
    clip = tmp_path / "clip.avi"
    clip.write_bytes(b"RIFF\x24\0\0\0AVI LIST" + bytes(64))
    for P in (O, J):
        assert _movie(P, str(clip))[1] is False
    mp4 = tmp_path / "clip.mp4"
    mp4.write_bytes(b"\0\0\0\x18ftypisom\0\0\x02\0isomiso2" + bytes(64))
    with pytest.raises(NotImplementedError,
                       match="video containers.*item 14"):
        _movie(O, str(mp4))


def _slot_quad(P, case):
    """A quad textured by a two-slot 8x8 texture, rendered at slot 0.
    ``alpha_test``: the quad is alpha-tested (GREATER 128) and each slot's
    alpha ramps across it the other way, so each slot passes the test on
    another half. ``device_fed``: slot 0 is fed twice by
    ``SetDeviceImage`` (the second feed of the same shape stays on the
    device) and slot 1 is a host image."""
    ctx = small_ctx(P)
    rc = small_rc(P, ctx)
    tex = P.CKTexture(ctx, "slots")
    y, x = np.mgrid[0:8, 0:8]
    a = np.stack([x / 7, y / 7, np.full((8, 8), 0.25), x / 7],
                 -1).astype(np.float32)
    b = a[::-1, ::-1].copy()
    if case == "alpha_test":
        tex.SetImage(a, slot=0)
    else:
        feed = torch.from_numpy if P is O else jnp.asarray
        tex.SetDeviceImage(feed(b[::-1].copy()), slot=0)
        tex.SetDeviceImage(feed(a), slot=0)
    tex.SetImage(b, slot=1)
    tex.SetCurrentSlot(0)
    screen = textured_quad(P, ctx, tex)
    mat = ctx.GetObjectByName("screen_mat")
    if case == "alpha_test":
        mat.EnableAlphaTest(True)
        mat.SetAlphaFunc(int(VXCMP.GREATER))
        mat.SetAlphaRef(128)
    rc.AddObject(screen)
    rc.AddObject(rc.GetAttachedCamera())
    return tex, rc


@pytest.mark.parametrize("case", ["alpha_test", "device_fed"])
def test_set_current_slot_renders_the_new_slot(case):
    """Stepping a texture's slot (what SetMovieTime does) renders the new
    slot's content as the reference does: an alpha-tested quad whose
    slots pass the test on different halves, and a device-fed texture
    stepped to a host slot and back."""
    (tex_o, rc_o), (tex_j, rc_j) = _slot_quad(O, case), _slot_quad(J, case)
    shown = []
    for slot in (0, 1, 0, 1):
        for tex, rc in ((tex_o, rc_o), (tex_j, rc_j)):
            tex.SetCurrentSlot(slot)
            rc.Render()
        assert_frames_close(rc_o, rc_j)
        shown.append(np.asarray(rc_o.framebuffer()).copy())
    assert not np.array_equal(shown[0], shown[1])
    np.testing.assert_array_equal(shown[0], shown[2])
    np.testing.assert_array_equal(shown[1], shown[3])
