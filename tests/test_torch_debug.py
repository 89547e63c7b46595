"""Debug stepping, the debug mode's label, checks and state strings, and the
PV watermark on the port (``CKRenderContext.SetDebugObjectCount`` /
``GetDebugObjectCount`` / ``DebugStep``, ``overlay.raster_label`` /
``composite_label``, ``FillStateString`` and ``AppendState*Line``,
``LoadPVInformationTexture`` / ``DrawPVInformationWatermark``) against the
reference package on the CPU.

Scripts run through both object models; host values are compared exactly
and 64x64 flat-route frames within ``_torch_common.ATOL``. The stepping
label reads ``"<name> (<k>/<n>) <ms> ms"``, where ``<ms>`` is the previous
``Render()``'s wall time: every case sets ``rc.stats.FrameTime`` on both
contexts before a frame, so both draw the same text. The port rasters the
label from its default glyph table, which must equal the reference's Pillow
raster bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu.pipeline import overlay as jov
from ckrenderengine_tpu_torch.pipeline import overlay as tov

from _torch_common import assert_frames_close, small_ctx

PACKAGES = (J, O)
FRAME_MS = 12.25
# Emissive triangles: (name, emissive, position, render priority). The
# priorities put the render order (stable, by descending priority over the
# entity rows) apart from the row order.
TRIS = (("red", (0.9, 0.13, 0.1, 1.0), (-1.6, 0.9, 0.0), 0),
        ("green", (0.2, 0.82, 0.15, 1.0), (1.4, 1.1, 0.5), 3),
        ("blue", (0.1, 0.2, 0.95, 1.0), (-1.3, -1.4, 0.2), 1),
        ("amber", (0.95, 0.62, 0.05, 1.0), (1.5, -1.2, 0.7), 3),
        ("violet", (0.55, 0.15, 0.85, 1.0), (0.1, -0.1, 1.0), 2))
LABELS = ("terrain (3/140) 12.5 ms", "(none) (0/9) 0.0 ms",
          "ball12 (77/140) 1234.5 ms", "row 7 (140/140) 99999.9 ms",
          "a_very_long_name_with_stuff (1/2) 3.3 ms", "Wg,;:!?[]{}|@#$%^&*",
          "x", "", "MMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMMM")


def _scene(P, size=64, debug=True):
    """Five small emissive triangles with render priorities (``TRIS``),
    camera at z = -6, the debug mode on."""
    ctx = small_ctx(P)
    if debug:
        ctx.GetRenderManager().SetRenderOptions("EnableDebugMode", 1)
    rc = ctx.GetRenderManager().CreateRenderContext(size, size)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -6))
    rc.AttachViewpointToCamera(cam)
    for name, emissive, pos, prio in TRIS:
        mesh = P.CKMesh(ctx, name + "_mesh")
        mesh.SetPositions(np.array([[-0.8, -0.7, 0], [0.1, 0.9, 0],
                                    [0.9, -0.6, 0]], np.float32))
        mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
        mesh.BuildNormals()
        mat = P.CKMaterial(ctx, name + "_mat")
        mat.SetDiffuse((0, 0, 0, 1))
        mat.SetEmissive(emissive)
        mat.SetTwoSided(True)
        mesh.ApplyGlobalMaterial(mat)
        obj = P.CK3dObject(ctx, name)
        obj.SetCurrentMesh(mesh)
        obj.SetPosition(pos)
        obj.SetRenderPriority(prio)
    return ctx, rc


def _render(rc):
    rc.stats.FrameTime = FRAME_MS
    rc.Render()


def test_debug_object_count_and_step():
    """Set/GetDebugObjectCount, and DebugStep from -1 through 0 .. n back
    to -1 (and with a delta of 3), equal on both packages."""
    seen = {}
    for P in PACKAGES:
        ctx, rc = _scene(P)
        n = ctx.entity_table.count
        out = [rc.GetDebugObjectCount()]
        rc.SetDebugObjectCount(4)
        out.append(rc.GetDebugObjectCount())
        rc.SetDebugObjectCount()
        out += [rc.DebugStep() for _ in range(n + 3)]
        out += [rc.DebugStep(3) for _ in range(n // 3 + 3)]
        seen[P.__name__] = (n, out)
    (n, ref), (n_t, got) = seen.values()
    assert n_t == n and got == ref
    assert got[:3] == [-1, 4, 0] and got[2:n + 4] == list(range(n + 1)) + [-1]


def test_stepped_frames():
    """Frames at k = 0 (clear colour and the label only), every mid k and
    -1 (every entity, no label), against the reference; the label text;
    the triangles drawn so far follow the priority order."""
    scenes = {P: _scene(P) for P in PACKAGES}
    n = scenes[O][0].entity_table.count
    assert n == scenes[J][0].entity_table.count
    lit = []
    for k in list(range(n + 1)) + [-1]:
        for P, (_ctx, rc) in scenes.items():
            rc.SetDebugObjectCount(k)
            _render(rc)
        rc_j, rc_t = scenes[J][1], scenes[O][1]
        assert_frames_close(rc_t, rc_j)
        fb = rc_t.framebuffer()
        if k >= 0:
            assert rc_t._dbg_label[0] == rc_j._dbg_label_cache[0]
            assert rc_t._dbg_label[0].endswith(f"({k}/{n}) {FRAME_MS:.1f} ms")
            h, w = rc_t._dbg_label[1].shape[:2]
            assert (fb[4:4 + h, 4:4 + w, 3] >= 160 / 255 - 1e-7).all()
        clear = np.asarray(rc_t.background_color, np.float32)
        body = fb[24:, :]
        lit.append(int((np.abs(body - clear).max(-1) > 1e-6).sum()))
    assert lit[0] == 0 and lit[-1] == lit[-2] > 0
    assert lit == sorted(lit[:-1]) + [lit[-1]]
    # The render order, stable by descending priority: green, amber
    # (priority 3, in row order), violet, blue, then the camera (row 0) and
    # red at priority 0.
    rc = scenes[O][1]
    order = np.argsort(-rc._entity_priority_np(n), kind="stable")
    names = {e.row: e.GetName() for e in rc._scene_entities()}
    assert [names[r] for r in order if r in names][:6] == [
        "green", "amber", "violet", "blue", "cam", "red"]


@pytest.mark.parametrize("text", LABELS)
@pytest.mark.parametrize("max_w", [200, 40])
def test_raster_label(text, max_w):
    """raster_label equal to the reference's Pillow raster, bit for bit:
    names, digits, punctuation, an empty string, clipped widths."""
    got, want = tov.raster_label(text, max_w), jov.raster_label(text, max_w)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_composite_label():
    """composite_label on a seeded fb and label at two places, within 1e-6
    of the reference's, alpha the larger of the two."""
    rng = np.random.default_rng(3)
    fb = rng.random((4, 40, 56), dtype=np.float32)
    lab = tov.raster_label("step (3/9) 1.5 ms", 50)
    lab[..., 3] *= rng.random(lab.shape[:2], dtype=np.float32)
    for x, y in ((4, 4), (3, 20)):
        got = tov.composite_label(torch.from_numpy(fb), torch.from_numpy(lab),
                                  x, y).numpy()
        want = np.asarray(jov.composite_label(jnp.asarray(fb),
                                              jnp.asarray(lab), x, y))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        h, w = lab.shape[:2]
        assert np.array_equal(got[3, y:y + h, x:x + w], np.maximum(
            fb[3, y:y + h, x:x + w], lab[..., 3]))
        outside = np.ones(fb.shape[1:], bool)
        outside[y:y + h, x:x + w] = False
        assert np.array_equal(got[:, outside], fb[:, outside])


def test_label_needs_debug_mode_and_room():
    """No label with the debug mode off, or where the frame is too small
    for it; with it on, the frame outside the label's box equals the
    frame without the debug mode bit for bit."""
    rc_off = _scene(O, debug=False)[1]
    rc_on = _scene(O)[1]
    for rc in (rc_off, rc_on):
        rc.SetDebugObjectCount(3)
        _render(rc)
    off, on = rc_off.framebuffer(), rc_on.framebuffer()
    h, w = rc_on._dbg_label[1].shape[:2]
    box = np.zeros(off.shape[:2], bool)
    box[4:4 + h, 4:4 + w] = True
    assert np.array_equal(on[~box], off[~box])
    assert not np.array_equal(on[box], off[box])
    assert rc_off._dbg_label == (None, None)
    rc_tiny = _scene(O, size=16)[1]
    rc_tiny.SetDebugObjectCount(0)
    _render(rc_tiny)
    ref_tiny = _scene(J, size=16)[1]
    ref_tiny.SetDebugObjectCount(0)
    _render(ref_tiny)
    assert_frames_close(rc_tiny, ref_tiny)


@pytest.mark.parametrize("material", [None, "blend", "plain"])
def test_fill_state_string(material):
    """FillStateString of a blended material, an opaque one and of the
    DrawPrimitive state, and the three Append*Line helpers, equal."""
    from ckrenderengine_tpu_torch.raster.types import VXBLEND, VXCMP
    out = []
    for P in PACKAGES:
        ctx, rc = _scene(P)
        mat = None
        if material is not None:
            mat = P.CKMaterial(ctx, "m")
            mat.SetTexture(P.CKTexture(ctx, "t"))
            if material == "blend":
                mat.EnableAlphaBlend(True)
                mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
                mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
                mat.EnableZWrite(False)
                mat.EnableAlphaTest(True)
                mat.SetAlphaFunc(int(VXCMP.GREATER))
        lines = []
        rc.AppendStateOnOffLine(lines, "A", 0)
        rc.AppendStateEnumLine(lines, "B", 7)
        rc.AppendStateUIntLine(lines, "C", -1)
        out.append((rc.FillStateString(mat), lines))
    assert out[0] == out[1]
    assert out[1][1] == ["A: Off", "B: 7", "C: 4294967295"]
    assert len(out[1][0].splitlines()) == 9


def test_watermark():
    """DrawPVInformationWatermark after a frame and from a post-render
    callback: its texture and the frame equal to the reference's, the
    frame outside the watermark's box unchanged."""
    frames = {}
    for P in PACKAGES:
        _ctx, rc = _scene(P, debug=False)
        _render(rc)
        before = rc.framebuffer().copy()
        assert rc.LoadPVInformationTexture()
        assert rc.DrawPVInformationWatermark()
        frames[P] = (rc, before)
    (rc_j, before_j), (rc_t, before_t) = frames[J], frames[O]
    assert np.array_equal(rc_t._pv_texture.GetImage(),
                          rc_j._pv_texture.GetImage())
    assert_frames_close(rc_t, rc_j)
    fb = rc_t.framebuffer()
    box = np.zeros(fb.shape[:2], bool)
    box[64 - 10:64 - 2, 2:34] = True
    assert np.array_equal(fb[~box], before_t[~box])
    assert not np.array_equal(fb[box], before_t[box])
    for P in PACKAGES:
        _ctx, rc = _scene(P, debug=False)
        rc.AddPostRenderCallBack(
            lambda rc_, arg: rc_.DrawPVInformationWatermark())
        _render(rc)
        frames[P] = rc
    assert_frames_close(frames[O], frames[J])
    assert np.array_equal(frames[O].framebuffer(), fb)


def test_debug_mode_stream_checks():
    """Under EnableDebugMode a frame whose compiled stream indexes past its
    pool, or whose triangles index past the stream, raises after the
    frame, as the reference's does; a non-finite frame raises
    FloatingPointError; with the debug mode off nothing is checked."""
    for debug in (True, False):
        for P in PACKAGES:
            _ctx, rc = _scene(P, debug=debug)
            _render(rc)
            c = rc._compiled
            good = (c.src_idx, c.tri_idx)
            for field, msg in (("src_idx", "out of pool"),
                               ("tri_idx", "out of stream")):
                bad = np.array(getattr(c, field))
                bad.flat[0] = (c.positions.shape[0] if field == "src_idx"
                               else c.src_idx.shape[0])
                setattr(c, field, bad)
                if debug:
                    with pytest.raises(AssertionError, match=msg):
                        _render(rc)
                else:
                    _render(rc)
                c.src_idx, c.tri_idx = good
            _render(rc)
    _ctx, rc = _scene(O)
    _render(rc)
    rc.AddPostRenderCallBack(lambda rc_, arg: setattr(
        rc_, "fb", rc_.fb * float("nan")))
    with pytest.raises(FloatingPointError):
        _render(rc)


def test_window_with_stepping():
    """A window of 4 with stepping, the label and the watermark: every tick
    bit-equal to the same ticks at W = 1, each frame's label from its own
    count."""
    ctxs = {}
    for w in (1, 4):
        _ctx, rc = _scene(O)
        rc.AddPostRenderCallBack(
            lambda rc_, arg: rc_.DrawPVInformationWatermark())
        rc.SetFramePipelining(w)
        ctxs[w] = rc
    n = ctxs[1].context.entity_table.count
    for tick in range(n + 4):
        texts = []
        for w, rc in ctxs.items():
            rc.DebugStep()
            _render(rc)
            texts.append(rc._dbg_label[0] if rc.GetDebugObjectCount() >= 0
                         else None)
        assert texts[0] == texts[1]
        assert torch.equal(ctxs[1].fb, ctxs[4].fb), tick
        assert torch.equal(ctxs[1].zb, ctxs[4].zb), tick


def test_stepping_hides_line_segments():
    """A stepped-out grid draws no wireframe border: the port's line pass
    skips the segments of entities hidden in the frame (a deliberate
    difference: the reference draws every compiled segment, so its k = 0
    frame keeps the border); with every entity stepped in, the quad and
    the border are drawn."""
    ctx = small_ctx(O)
    ctx.GetRenderManager().SetRenderOptions("EnableDebugMode", 1)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((4.1, 9.0, -2.2))
    cam.SetOrientation((0.02, -1.0, 0.6))
    rc.AttachViewpointToCamera(cam)
    grid = O.CKGrid(ctx, "zones")
    grid.SetDimensions(8, 6)
    grid.AddLayer("floor").SetSquareArray(np.full((6, 8), 200))
    grid.Show(True)
    frames = []
    for k in (0, -1):
        rc.SetDebugObjectCount(k)
        _render(rc)
        frames.append(rc.framebuffer().copy())
    k0, full = frames
    clear = np.asarray(rc.background_color, np.float32)
    h, w = rc._dbg_label[1].shape[:2]
    body = np.ones(k0.shape[:2], bool)
    body[4:4 + h, 4:4 + w] = False
    assert (k0[body] == clear).all()
    assert (np.abs(full - clear).max(-1) > 0.01).mean() > 0.05
    assert (full[..., :3] > 0.9).all(-1).any()       # the border's lines
