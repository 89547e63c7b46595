"""The render context's API on the port (render states and options, the
post-sprite callbacks, ``DrawScene`` over the kept colour and depth, the
framebuffer reads and writes, the scene queries and stubs, the lifecycle
calls), on the CPU, held against the reference package: each test runs one
script through both object models and compares what they return.

The cases mirror the reference's own (tests/test_context_surface.py,
tests/test_api_surface.py: ``GetBoundingBox``, ``TransformVertices``, the
windowing stubs, the stencil allocator, ``TestGlobalRenderMode``; the
``ClassifyTransparentOrder`` half of
tests/test_lifecycle_surface.py::test_transparent_order_and_render_transparents).
Host values are compared exactly. Frames are 64x64 flat-route scenes of a
few triangles, held to the reference within ``_torch_common.ATOL``, the
f32 rounding of their shades.

A frame that keeps its depth (``DrawScene``) solves with the tiled solve
in the port, B1 on the card, and below the tiled size shades from f32
vertex colours through ``shade_deferred``, as the reference's small frame
does. The second frame draws only geometry nearer than the first:
redrawing a triangle over its own kept depth would make every pixel a
depth tie, which the reference rounds apart per colour channel.
"""

import numpy as np
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O

from _torch_common import ATOL, small_ctx

PACKAGES = (J, O)


def _ctx(P, size=64):
    """The reference's test context (tests/test_context_surface.py:14-20):
    ``size`` x ``size``, camera at z = -5."""
    ctx = small_ctx(P)
    rc = ctx.GetRenderManager().CreateRenderContext(size, size)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -5))
    rc.AttachViewpointToCamera(cam)
    return ctx, rc, cam


def _tri(P, ctx, name="o", z=0.0, emissive=None):
    """The reference's triangle (tests/test_context_surface.py:23-35): a
    white diffuse material, or an emissive one (diffuse black)."""
    mesh = P.CKMesh(ctx, name + "_mesh")
    mesh.SetPositions(np.array([[-1, -1, z], [0, 1.5, z], [1, -1, z]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.SetUVs(np.array([[0, 1], [0.5, 0], [1, 1]], np.float32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, name + "_mat")
    if emissive is None:
        mat.SetDiffuse((1, 1, 1, 1))
    else:
        mat.SetDiffuse((0, 0, 0, 1))
        mat.SetEmissive(emissive)
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = P.CK3dObject(ctx, name)
    obj.SetCurrentMesh(mesh)
    return obj, mesh, mat


def _scene(P):
    """Two emissive triangles under the default ambient light; no vertex
    colour is a whole number of 255ths."""
    ctx, rc, cam = _ctx(P)
    a = _tri(P, ctx, "a", emissive=(0.9, 0.33, 0.1, 1.0))[0]
    b = _tri(P, ctx, "b", z=1.0, emissive=(0.1, 0.62, 0.95, 1.0))[0]
    b.SetPosition((-1.2, 0.3, 0.0))
    return ctx, rc, cam, a, b


def _lit(fb):
    return int((fb[..., :3].sum(-1) > 0.05).sum())


def _both(script):
    """``script(P)`` through the reference (J) and the port (O)."""
    return script(J), script(O)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


# -- callbacks -------------------------------------------------------------

def _callback_script(P, window=1):
    ctx, rc, cam = _ctx(P)
    _tri(P, ctx)
    rc.SetFramePipelining(window)
    seen = []
    rc.AddPreRenderCallBack(lambda dev, a: seen.append(("pre", a)), 1)
    rc.AddPostSpriteRenderCallBack(
        lambda dev, a: seen.append(("sprite", a)), 2)
    rc.AddPostRenderCallBack(lambda dev, a: seen.append(("post", a)), 3)
    for _ in range(3):
        rc.Render()
    frames = list(seen)
    fb = rc.framebuffer().copy()
    rc.RemovePostSpriteRenderCallBack(rc.post_sprite_callbacks[0][1])
    seen.clear()
    rc.ExecutePostSpriteCallbacks()
    rc.ExecutePreRenderCallbacks()
    rc.ExecutePostRenderCallbacks()
    manual = list(seen)
    rc.ClearCallbacks()
    seen.clear()
    rc.Render()
    return frames, manual, seen, fb, rc


def test_post_sprite_callbacks_order_eager_and_windowed():
    """tests/test_context_surface.py:73-95: pre, post-sprite, post per
    Render(), in that order, three times; the manual Execute* calls; a
    removed post-sprite callback and ``ClearCallbacks``. The port's frames
    in a window of 8 fire them exactly as its eager frames and the
    reference's do."""
    ref = _callback_script(J)
    want = [("pre", 1), ("sprite", 2), ("post", 3)] * 3
    assert ref[0] == want
    assert ref[1] == [("pre", 1), ("post", 3)] and ref[2] == []
    for window in (1, 8):
        got = _callback_script(O, window)
        assert got[:3] == ref[:3], window
        _close(got[3], ref[3])


# -- drawing over kept buffers -----------------------------------------------

def _draw_scene_script(P, window=1):
    ctx, rc, cam, a, b = _scene(P)
    rc.SetFramePipelining(window)
    rc.Render()
    first = (rc.framebuffer().copy(), rc.zbuffer().copy())
    # Nearer than anything drawn: no pixel is a redraw at its own depth.
    a.SetPosition((0.6, -0.2, -1.0))
    b.Show(False)
    rc.DrawScene()
    flags = (rc.GetClearBackground(), rc.GetClearZBuffer())
    return first, (rc.framebuffer().copy(), rc.zbuffer().copy()), flags


def test_draw_scene_over_kept_buffers():
    """DrawScene draws over the kept fb and zb (reference :3251-3257):
    the hidden triangle stays in the frame, the moved one is drawn over
    it, and the context's clear flags are untouched. Against the
    reference within ATOL; in the port, every pixel the second frame does
    not draw keeps the first frame's colour and depth bit for bit, and a
    window of 8 renders the same frame (the kept-depth frame renders
    eagerly, after the staged ones)."""
    ref = _draw_scene_script(J)
    got = _draw_scene_script(O)
    for (fb_t, zb_t), (fb_j, zb_j) in zip(got[:2], ref[:2]):
        _close(fb_t, fb_j)
        _close(zb_t, zb_j)
    assert got[2] == ref[2] == (True, True)
    (fb0, zb0), (fb1, zb1) = got[:2]
    drawn = zb1 != zb0
    assert 100 < drawn.sum() < 4000
    assert np.array_equal(fb1[~drawn], fb0[~drawn])
    assert np.all(zb1[drawn] < zb0[drawn])
    # The hidden triangle's pixels that the moved one does not cover.
    kept_b = (fb0[..., 2] > 0.5) & ~drawn
    assert kept_b.sum() > 100
    windowed = _draw_scene_script(O, window=8)
    for (fb_w, zb_w), (fb_e, zb_e) in zip(windowed[:2], got[:2]):
        assert np.array_equal(fb_w, fb_e) and np.array_equal(zb_w, zb_e)


def _lit_script(P):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    rc.Render()
    obj.SetPosition((0.5, 0.0, -0.5))
    rc.DrawScene()
    return rc.framebuffer().copy(), rc.zbuffer().copy()


def test_draw_scene_lit_colour_precision():
    """A lit triangle (ambient 0x0F/255 times the material's 0.3) drawn
    over the kept buffers: its vertex colour, 4.5/255, lies halfway
    between two u8 steps. Both packages shade the small kept-depth frame
    from f32 vertex colours, so colours and depths agree within ATOL."""
    (fb_j, zb_j), (fb_t, zb_t) = _both(_lit_script)
    _close(zb_t, zb_j)
    _close(fb_t, fb_j)
    covered = [int((fb != 0).any(-1).sum()) for fb in (fb_t, fb_j)]
    assert covered[0] == covered[1] > 1000


def _memory_script(P):
    ctx, rc, cam, a, b = _scene(P)
    rc.Render()
    rng = np.random.default_rng(18)
    rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    rgba = rng.uniform(0, 1, (64, 64, 4)).astype(np.float32)
    out = [rc.CopyFromMemoryBuffer(rgba),
           rc.CopyFromMemoryBuffer(rgb, (10, 20, 50, 50)),
           rc.CopyFromMemoryBuffer(rgb, (64, 0, 70, 10))]
    written = rc.framebuffer().copy()
    zb = rc.zbuffer().copy()
    a.SetPosition((0.3, 0.0, -1.0))
    rc.DrawScene()
    return out, written, zb, rc.framebuffer().copy(), rc.zbuffer().copy()


def test_copy_from_memory_buffer_then_draw_scene():
    """CopyFromMemoryBuffer (reference :4011-4029): an f32 RGBA image over
    the whole frame, then a u8 RGB image at (10, 20), clipped at the
    frame's edge, and a rect outside the frame refused; the depth is kept.
    A DrawScene then blends over exactly that image. Against the
    reference; the written frame in the port equals the images bit for
    bit."""
    ref = _memory_script(J)
    got = _memory_script(O)
    assert got[0] == ref[0] == [True, True, False]
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r)
    rng = np.random.default_rng(18)
    rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    rgba = rng.uniform(0, 1, (64, 64, 4)).astype(np.float32)
    want = rgba.copy()
    want[20:50, 10:50, :3] = rgb.astype(np.float32) / 255.0
    want[20:50, 10:50, 3] = 1.0
    assert np.array_equal(got[1], want)


def _dump_script(P):
    ctx, rc, cam, a, b = _scene(P)
    rc.Render()
    return (rc.DumpToMemory(), rc.DumpToMemory("z"),
            rc.DumpToMemory("stencil").astype(np.float32),
            rc.CopyToMemoryBuffer((8, 4, 40, 60)), rc.CopyToVideo(),
            rc.CopyToMemoryBuffer())


def test_dump_and_copy_to_memory():
    """DumpToMemory's colour, depth and stencil planes, a region and the
    whole frame through CopyToMemoryBuffer, and CopyToVideo: shapes equal
    the reference's, values within ATOL."""
    ref, got = _both(_dump_script)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r)
    assert got[3].shape == (56, 32, 4)


def _backup_script(P, window=1):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    rc.SetFramePipelining(window)
    rc.Render()
    rc.BackupScreen()
    fb0 = rc.framebuffer().copy()
    obj.Show(False)
    rc.Render()
    # In a window the hidden frame stays staged until the restore: reading
    # it here would resolve the window first.
    hidden = _lit(rc.framebuffer()) if window == 1 else None
    restored = rc.RestoreScreenBackup()
    fb1 = rc.framebuffer().copy()
    rc._screen_backup = None
    return fb0, hidden, restored, fb1, rc.RestoreScreenBackup()


def test_screen_backup_restore():
    """tests/test_context_surface.py:222-237: the backup comes back after a
    frame that drew nothing; without one, RestoreScreenBackup is False. In
    the port the restored frame equals the backed-up one bit for bit."""
    ref, got = _both(_backup_script)
    assert got[1] == ref[1] == 0
    assert got[2] is ref[2] is True and got[4] is ref[4] is False
    _close(got[0], ref[0])
    _close(got[3], ref[3])
    assert np.array_equal(got[3], got[0])


def test_screen_backup_restore_in_window():
    """The same script in a window of 8: the second frame is still staged
    when RestoreScreenBackup runs, and the restore resolves it first, as
    the reference's does through CopyFromMemoryBuffer; the staged frame
    does not overwrite the restored image."""
    ref, got = _both(lambda P: _backup_script(P, window=8))
    assert got[2] is ref[2] is True and got[4] is ref[4] is False
    _close(got[0], ref[0])
    _close(got[3], ref[3])
    assert np.array_equal(got[3], got[0])


# -- render states -----------------------------------------------------------

def _texture_mode_script(P):
    ctx, rc, cam = _ctx(P)
    obj, mesh, mat = _tri(P, ctx)
    tex = P.CKTexture(ctx, "t")
    img = np.zeros((4, 4, 4), np.float32)
    img[..., 0] = 1.0
    img[..., 3] = 1.0
    tex.SetImage(img)
    mat.SetTexture(tex)
    mat.SetDiffuse((0, 1, 0, 1))
    rc.Render()
    fb_tex = rc.framebuffer().copy()
    zb_tex = rc.zbuffer().copy()
    rc.SetGlobalRenderMode(texture=False)
    rc.Render()
    return (fb_tex, zb_tex, rc.framebuffer().copy(), rc.zbuffer().copy(),
            rc.GetGlobalRenderMode())


def test_global_render_mode_texture_off():
    """tests/test_api_surface.py:131-150: with texturing off the green
    vertex colour comes back where the red texel zeroed it. Both frames
    against the reference; in the port, the depths of the two frames are
    equal bit for bit (the same triangles win)."""
    ref, got = _both(_texture_mode_script)
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r)
    assert got[4] == ref[4] == (2, False, False)
    assert got[2][..., 1].sum() > got[0][..., 1].sum() + 1
    assert np.array_equal(got[1], got[3])


def _state_script(P):
    ctx, rc, cam = _ctx(P)
    out = [rc.GetState(), rc.GetTransparentMode(),
           rc.GetTextureStageState(0, 3), rc.GetTextureMatrix()]
    rc.SetState(5)
    rc.SetTransparentMode(True)
    m = np.eye(4, dtype=np.float32)
    m[3, 0] = 0.5
    out += [rc.SetTextureStageState(0, 3, 7), rc.SetTextureMatrix(m, 1),
            rc.GetState(), rc.GetTransparentMode(),
            rc.GetTextureStageState(0, 3), rc.GetTextureStageState(1, 3),
            rc.GetTextureMatrix(), rc.GetTextureMatrix(1).tolist()]
    rc.SetCurrentRenderOptions(0b1100)
    out += [rc.ChangeCurrentRenderOptions(add=0b0011, remove=0b1000),
            rc.GetCurrentRenderOptions(), rc.GetGlobalRenderMode()]
    return out


def test_render_state_stores():
    """SetState/GetState, the per-stage texture states and matrices
    (tests/test_context_surface.py:176-180), the transparent mode and
    ChangeCurrentRenderOptions (:105-110): equal to the reference's."""
    ref, got = _both(_state_script)
    assert got == ref
    assert got[-3:-1] == [0b0111, 0b0111]


# -- queries and stubs ------------------------------------------------------

def _query_script(P):
    ctx, rc, cam, a, b = _scene(P)
    a.SetPosition((10, 0, 0))
    far = _tri(P, ctx, "far")[0]
    far.SetPosition((0, 0, -60))       # behind the camera
    near = _tri(P, ctx, "near")[0]
    near.Rotate((0, 1, 0), np.pi / 2)
    near.SetPosition((0, 0, -5))       # across the camera's plane
    rc.Render()
    pts = [[0, 0, 0], [0, 0, -100.0], [1, 2, 3], [-4, 0.5, 9]]
    screen, flags, off = rc.TransformVertices(pts)
    local = rc.TransformVertices([[0, 1.5, 0]], b)
    out = dict(
        box=[v.tolist() for v in rc.GetBoundingBox()],
        screen=screen, flags=flags.tolist(), off=off,
        local=(local[0], local[1].tolist(), local[2]),
        one=rc.Transform([0.5, 0.5, 0.0]),
        behind=rc.TransformVertices([[0, 0, -100.0]])[2],
        extents={e.GetName(): rc.GetObjectExtents(e)
                 for e in (a, b, far, near)},
        checks=[rc.CheckObjectExtents(e) for e in (a, b, far, near)])
    first = rc.GetFirstFreeStencilBits()
    rc.UsedStencilBits(0b111)
    rc.UsedStencilBits(0b10000)
    out["stencil"] = (first, rc.GetFirstFreeStencilBits(),
                      rc.GetStencilFreeMask())
    out["memory"] = rc.GetMemoryOccupation()
    out["misc"] = (rc.GetPixelFormat(), rc.GetDirectXInfo(),
                   rc.GetBackgroundMaterial(), rc.WarnEnterThread(),
                   rc.WarnExitThread())
    out["window"] = (rc.GoFullScreen(), rc.StopFullScreen(),
                     rc.IsFullScreen(), rc.GetWindowHandle(),
                     rc.GetWindowRect(), rc.SetWindowRect((0, 0, 8, 8)),
                     rc.ScreenToClient((3, 4)), rc.ClientToScreen([5, 6]))
    rc.SetViewRect(4, 4, 10, 10)
    rc.SetFullViewport()
    out["viewport"] = tuple(rc.GetViewRect())
    return out


def test_queries_and_stubs():
    """GetBoundingBox and TransformVertices (tests/test_api_surface.py:
    80-99; also under an entity's matrix, and Transform), the extents of a
    visible, a far-off, a behind-the-camera and a near-plane-straddling
    triangle after a frame (GetObjectExtents, CheckObjectExtents), the
    stencil allocator (:116-121), GetMemoryOccupation (the port counts its
    device tensors of the same roles: the same bytes), the pixel format,
    the windowing stubs (:101-106) and SetFullViewport: equal to the
    reference's (screen coordinates within 1e-4 pixel)."""
    ref, got = _both(_query_script)
    for k in ("box", "flags", "off", "behind", "checks", "stencil",
              "memory", "misc", "window", "viewport"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["screen"], ref["screen"], atol=1e-4)
    np.testing.assert_allclose(got["one"], ref["one"], atol=1e-4)
    np.testing.assert_allclose(got["local"][0], ref["local"][0], atol=1e-4)
    assert got["local"][1:] == ref["local"][1:]
    assert got["extents"].keys() == ref["extents"].keys()
    for k, e in ref["extents"].items():
        if e is None:
            assert got["extents"][k] is None, k
        else:
            np.testing.assert_allclose(got["extents"][k], e, atol=1e-4)
    assert got["checks"] == [False, True, False, True]
    assert got["stencil"] == (0, 3, 0b10111)
    assert got["window"][4] == (0, 0, 64, 64)


def _roots_script(P):
    ctx, rc, cam = _ctx(P)
    a = _tri(P, ctx, "a")[0]
    b = _tri(P, ctx, "b")[0]
    b.SetParent(a)
    hud = P.CK2dEntity(ctx, "hud")
    bg = P.CK2dEntity(ctx, "bg")
    bg.SetBackground(True)
    sub = P.CK2dEntity(ctx, "sub")
    sub.SetParent(hud)
    names = [[e.GetName() for e in rc.Compute3dRootObjects()],
             [e.GetName() for e in rc.Compute2dRootObjects()]]
    attached = [rc.IsObjectAttached(a), rc.IsObjectAttached(hud)]
    rc.AddObject(a)
    attached += [rc.IsObjectAttached(a), rc.IsObjectAttached(b)]
    return names, attached


def test_root_objects_and_membership():
    """Compute3dRootObjects / Compute2dRootObjects
    (tests/test_context_surface.py:114-125: background roots first) and
    IsObjectAttached before and after an explicit membership: equal to the
    reference's."""
    ref, got = _both(_roots_script)
    assert got == ref
    assert got[0][1] == ["bg", "hud"]


def _transparent_script(P):
    from importlib import import_module
    VXBLEND = import_module(P.__name__.rsplit(".", 1)[0]
                            + ".raster.types").VXBLEND
    ctx, rc, cam = _ctx(P)
    a, _m, amat = _tri(P, ctx, "a")
    b, _m, bmat = _tri(P, ctx, "b")
    for m in (amat, bmat):
        m.EnableAlphaBlend(True)
        m.SetSourceBlend(int(VXBLEND.SRCALPHA))
        m.SetDestBlend(int(VXBLEND.INVSRCALPHA))
    out = []
    for pa, pb in (((0, 0, 2), (0, 0, 8)), ((-3, 0, 0), (3, 0, 0)),
                   ((0, 4, 1), (0, -4, 1))):
        a.SetPosition(pa)
        b.SetPosition(pb)
        out.append((rc.ClassifyTransparentOrder(a, b),
                    rc.ClassifyTransparentOrder(b, a)))
    # Boxes that overlap on every axis: no decision.
    a.SetPosition((0, 0, 0))
    b.Rotate((0, 1, 0), np.pi / 2)
    b.SetPosition((0.5, 0.2, 0))
    out.append((rc.ClassifyTransparentOrder(a, b),
                rc.ClassifyTransparentOrder(b, a)))
    rc.DetachViewpointFromCamera()
    out.append(rc.ClassifyTransparentOrder(a, b))
    return out


def test_classify_transparent_order():
    """tests/test_lifecycle_surface.py:162-175 (b farther along z draws
    first), and boxes apart along x and y, overlapping boxes (no decision)
    and no camera: equal to the reference's."""
    ref, got = _both(_transparent_script)
    assert got == ref
    assert got[0] == (+1, -1) and got[3] == (0, 0) and got[-1] == 0


# -- lifecycle --------------------------------------------------------------

def _lifecycle_script(P):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    out = {}
    v0 = ctx._topology_version
    rc.AddRemoveSequence(True)
    for i in range(4):
        _tri(P, ctx, f"t{i}")[0].SetPosition((i - 1.5, 0.5, 1.0))
    out["sequence"] = (ctx._topology_version - v0,)
    rc.AddRemoveSequence(False)
    out["sequence"] += (ctx._topology_version - v0,)
    rc.Render()
    out["frame"] = rc.framebuffer().copy()
    tcam = P.CKTargetCamera(ctx, "tc")
    tcam.SetPosition((0, 0, -5))
    tgt = P.CK3dEntity(ctx, "tgt")
    tgt.SetPosition((10, 0, -5))
    tcam.SetTarget(tgt)
    rc.PrepareCameras()
    out["aim"] = tcam.GetWorldMatrix()[2, :3].copy()
    out["projection"] = rc.UpdateProjection(True)
    rc.DetachAll()
    rc.Render()
    out["detached"] = (_lit(rc.framebuffer()), rc.IsObjectAttached(obj))
    rc.DetachViewpointFromCamera()
    rc.ForceCameraSettingsUpdate()
    rc.AttachViewpointToCamera(cam)
    rc.AddPreRenderCallBack(lambda dev, a: None)
    rc.OnClearAll()
    rc.Render()
    out["cleared"] = (rc.pre_render_callbacks, rc.IsObjectAttached(obj),
                      rc.framebuffer().copy())
    out["destroyed"] = (rc.DestroyDevice(), rc._compiled.topology_version)
    rc.Render()
    out["rebuilt"] = rc.framebuffer().copy()
    return out


def test_lifecycle():
    """AddRemoveSequence compiles once (tests/test_context_surface.py:
    91-103), PrepareCameras aims a target camera (:127-136), DetachAll
    empties the frame (:145-152), ForceCameraSettingsUpdate detached,
    OnClearAll drops the callbacks and the membership, DestroyDevice and
    the next frame: equal to the reference's. In the port the rebuilt
    frame equals the one before DestroyDevice bit for bit."""
    ref, got = _both(_lifecycle_script)
    assert got["sequence"] == ref["sequence"] == (0, 1)
    np.testing.assert_allclose(got["aim"], ref["aim"], atol=1e-6)
    np.testing.assert_allclose(got["aim"] / np.linalg.norm(got["aim"]),
                               [1, 0, 0], atol=1e-5)
    assert got["projection"] is ref["projection"] is True
    assert got["detached"] == ref["detached"] == (0, False)
    assert got["cleared"][:2] == ref["cleared"][:2] == ([], True)
    assert got["destroyed"] == ref["destroyed"] == (True, -1)
    for k in ("frame", "rebuilt"):
        _close(got[k], ref[k])
    _close(got["cleared"][2], ref["cleared"][2])
    assert _lit(got["frame"]) > 0
    assert np.array_equal(got["rebuilt"], got["cleared"][2])


def test_destroy_device_resolves_pending_window():
    """DestroyDevice with three frames staged in a window of 8: the window
    runs first, so fb holds the third frame (equal to the eager frames'),
    and the next Render() compiles again and renders it bit for bit."""
    frames = {}
    for window in (1, 8):
        ctx, rc, cam, a, b = _scene(O)
        rc.SetFramePipelining(window)
        for k in range(3):
            a.SetPosition((0.1 * k, 0.0, 0.0))
            rc.Render()
        assert rc.DestroyDevice()
        assert rc._window is None and rc._packed_static is None
        frames[window] = [rc.framebuffer().copy()]
        rc.Render()
        frames[window].append(rc.framebuffer().copy())
    for w8, w1 in zip(frames[8], frames[1]):
        assert np.array_equal(w8, w1)
    assert np.array_equal(frames[1][0], frames[1][1])


def test_destroy_device_frees_device_tensors():
    """After DestroyDevice the compiled scene holds no device tensor and
    GetMemoryOccupation counts fb and zb alone (the reference's count after
    its DestroyDevice)."""
    occ = []
    for P in PACKAGES:
        ctx, rc, cam, a, b = _scene(P)
        rc.Render()
        before = rc.GetMemoryOccupation()
        rc.DestroyDevice()
        occ.append((before, rc.GetMemoryOccupation()))
    assert occ[1] == occ[0]
    assert occ[1][1] == 64 * 64 * 4 * 4 + 64 * 64 * 4 < occ[1][0]
    ctx, rc, cam, a, b = _scene(O)
    rc.Render()
    assert rc._compiled._dev_static is not None
    rc.DestroyDevice()
    assert rc._compiled._dev_static is None and rc._compiled._dev_pool is None
    assert isinstance(rc.fb, torch.Tensor)
