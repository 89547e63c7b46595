"""The rasterizer HAL's drawing cases against the reference package's on
the CPU: the reference's ``tests/test_hal.py`` cases that draw, each driven
through both packages' HALs, and the call script of ``raster/hal_fixtures``
(the one ``chip_smoke.py`` runs on the card) at a small size.

The reference HAL draws through its jitted ``jax_backend.render_pass``,
which takes XLA about a minute to compile on the CPU for each batch and
texture shape; these cases run it op by op (``jax.disable_jit``), the same
arithmetic without XLA's fusion. Each case holds the port's fb and zb to
``render_pass``'s bound on record (``test_torch_ordered.py``: 1e-5 on all
but 0.1% of the values, never past 1e-4; the cases here agree bit for
bit), and its render states, counters, texture and buffer contents to
equality.
"""

import contextlib

import jax
import numpy as np
import pytest

from ckrenderengine_tpu.raster import hal as JH
import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.raster import hal as TH
from ckrenderengine_tpu_torch.raster import hal_fixtures as hf
from ckrenderengine_tpu_torch.raster.hal import (
    CKRST_CTXCLEAR_ALL, CKRST_OBJ_INDEXBUFFER, CKRST_OBJ_TEXTURE,
    CKRST_OBJ_VERTEXBUFFER, VXMATRIX_PROJECTION, VXMATRIX_VIEW,
    VXMATRIX_WORLD, VXRENDERSTATE,
)
from ckrenderengine_tpu_torch.raster.types import VXPRIMITIVE

CPU = "cpu"
TRI = int(VXPRIMITIVE.TRIANGLELIST)


def _assert_mostly_close(got, ref, atol=1e-5, cap=1e-4):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    off = diff > atol
    assert off.mean() <= 1e-3, (int(off.sum()), float(diff.max()))
    assert diff.max() <= cap, float(diff.max())


def _both(case, w=32, h=32):
    """Run ``case(hal, rst, drv, ctx)`` on a fresh context of each
    package's HAL (the reference's op by op); hold the port's planes to
    the bound and its states and counters to the reference's. Returns
    (port result, reference result)."""
    out = []
    for hal in (TH, JH):
        rst = hal.CKRasterizer(device=CPU) if hal is TH \
            else hal.CKRasterizer()
        rst.Start(None)
        drv = rst.GetDriver(0)
        c = drv.CreateContext()
        assert c.Create(None, w, h)
        with jax.disable_jit() if hal is JH else contextlib.nullcontext():
            r = case(hal, rst, drv, c)
        out.append((c, r))
    (cp, rp), (cr, rr) = out
    _assert_mostly_close(cp.BackToFront(), cr.BackToFront())
    _assert_mostly_close(cp.zb.numpy(), np.asarray(cr.zb))
    assert cp.stats == cr.stats
    assert np.array_equal(cp._rs_value, cr._rs_value)
    assert np.array_equal(cp._rs_flags, cr._rs_flags)
    return rp, rr


def _proj(n=1.0, f=100.0):
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = 1.0
    m[2, 2] = f / (f - n)
    m[3, 2] = -n * f / (f - n)
    m[2, 3] = 1.0
    return m


TRIANGLE = {"positions": np.array([[-1, -1, 0.5, 1], [0, 1, 0.5, 1],
                                   [1, -1, 0.5, 1]], np.float32),
            "transformed": True}


class TestDrawing:
    def test_clear_and_scene_bracket(self):
        def case(hal, rst, drv, c):
            assert c.BeginScene() and not c.BeginScene()
            assert c.Drawing()
            assert c.Clear(CKRST_CTXCLEAR_ALL, 0xFF4080C0)
            img = c.BackToFront()
            np.testing.assert_allclose(img[0, 0], [0x40 / 255, 0x80 / 255,
                                                   0xC0 / 255, 1.0],
                                       atol=1e-6)
            assert c.EndScene() and not c.EndScene()
            assert c.Clear(2, 0, 0.25)
        _both(case)

    def test_draw_primitive_transformed(self):
        def case(hal, rst, drv, c):
            c.Clear()
            data = dict(TRIANGLE, colors=np.tile(
                [1, 0, 0, 1], (3, 1)).astype(np.float32))
            assert c.DrawPrimitive(TRI, None, data)
            img = c.BackToFront()
            assert img[..., 0].sum() > 10
            assert c.stats["NbTrianglesDrawn"] == 1
        _both(case)

    def test_draw_primitive_local_with_lighting(self):
        def case(hal, rst, drv, c):
            c.SetTransformMatrix(VXMATRIX_WORLD, np.eye(4, dtype=np.float32))
            view = np.eye(4, dtype=np.float32)
            view[3, 2] = 5.0                   # camera at z=-5
            c.SetTransformMatrix(VXMATRIX_VIEW, view)
            c.SetTransformMatrix(VXMATRIX_PROJECTION, _proj())
            c.SetLight(0, {"direction": (0, 0, 1), "diffuse": (0, 1, 0)})
            c.EnableLight(0)
            c.SetMaterial({"diffuse": (1, 1, 1, 1)})
            c.Clear()
            data = {"positions": np.array([[-1, -1, 0], [0, 1.5, 0],
                                           [1, -1, 0]], np.float32),
                    "normals": np.tile([0, 0, -1], (3, 1)).astype(
                        np.float32)}
            assert c.DrawPrimitive(TRI, None, data)
            img = c.BackToFront()
            assert img[..., 1].sum() > 10      # lit green
            assert img[..., 0].sum() < 0.5     # no red/ambient
        _both(case)

    def test_vb_ib_path(self):
        def case(hal, rst, drv, c):
            vbi = rst.CreateObjectIndex(CKRST_OBJ_VERTEXBUFFER)
            assert c.CreateObject(vbi, CKRST_OBJ_VERTEXBUFFER,
                                  {"max_vertices": 8})
            p, col, uv = c.LockVertexBuffer(vbi, 0, 4)
            p[:] = [[-1, -1, 0.5, 1], [-1, 1, 0.5, 1], [1, 1, 0.5, 1],
                    [1, -1, 0.5, 1]]
            col[:] = [0, 0, 1, 1]
            assert c.UnlockVertexBuffer(vbi)
            ibi = rst.CreateObjectIndex(CKRST_OBJ_INDEXBUFFER)
            assert c.CreateObject(ibi, CKRST_OBJ_INDEXBUFFER,
                                  {"max_indices": 6})
            idx = c.LockIndexBuffer(ibi, 0, 6)
            idx[:] = [0, 1, 2, 0, 2, 3]
            assert c.UnlockIndexBuffer(ibi)
            c.Clear()
            assert c.DrawPrimitiveVBIB(TRI, vbi, ibi, index_count=6)
            img = c.BackToFront()
            assert (img[..., 2] > 0.5).mean() > 0.9    # full-screen quad
            assert c.GetVertexBufferData(vbi).shape == (8, 4)
            assert c.GetIndexBufferData(ibi)[:6].tolist() == [0, 1, 2, 0, 2,
                                                              3]
            assert c.OptimizeVertexBuffer(vbi)
            dyn = c.GetDynamicVertexBuffer(2, 16)
            assert dyn == c.GetDynamicVertexBuffer(2, 8)
            data = (c.GetVertexBufferData(vbi), c.GetIndexBufferData(ibi),
                    dyn)
            assert c.DeleteObject(vbi, CKRST_OBJ_VERTEXBUFFER)
            return data
        got, ref = _both(case)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)

    def test_textured_draw(self):
        def case(hal, rst, drv, c):
            ti = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
            assert c.CreateObject(ti, CKRST_OBJ_TEXTURE, {"width": 4,
                                                          "height": 4})
            img = np.zeros((4, 4, 4), np.float32)
            img[..., 1] = 1.0
            img[..., 3] = 1.0
            img[1:3, 1:3, 0] = 0.7
            assert c.LoadTexture(ti, img)
            assert c.GetTextureData(ti).shape == (4, 4, 4)
            c.SetTexture(ti)
            c.Clear()
            data = dict(TRIANGLE, uvs=np.array([[0, 1], [0.5, 0], [1, 1]],
                                               np.float32))
            assert c.DrawPrimitive(TRI, None, data)
            out = c.BackToFront()
            assert out[..., 1].sum() > 10
            return c.GetTextureData(ti)
        got, ref = _both(case)
        np.testing.assert_array_equal(got, ref)

    def test_copy_to_texture(self):
        def case(hal, rst, drv, c):
            c.Clear(CKRST_CTXCLEAR_ALL, 0xFFFF0000)     # red frame
            c.DrawPrimitive(TRI, None, dict(TRIANGLE, colors=np.tile(
                [0, 0.5, 1, 1], (3, 1)).astype(np.float32)))
            ti = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
            c.CreateObject(ti, CKRST_OBJ_TEXTURE, {"width": 32,
                                                   "height": 32})
            assert c.CopyToTexture(ti)
            np.testing.assert_allclose(c.GetTextureData(ti)[0, 0, :3],
                                       [1, 0, 0], atol=1e-6)
            assert c.CopyToTexture(ti, src_rect=(4, 6, 20, 30))
            copy = c.GetTextureData(ti)
            np.testing.assert_array_equal(copy, c.BackToFront()[6:30, 4:20])
            return copy
        got, ref = _both(case)
        np.testing.assert_array_equal(got, ref)


class TestDisplayListsAndMisc:
    def test_display_list_records_and_replays(self):
        def case(hal, rst, drv, c):
            c.Clear()
            dl = c.NewDisplayList()
            c.SetRenderState(VXRENDERSTATE.FOGENABLE, 1)
            data = dict(TRIANGLE, colors=np.tile([1, 1, 1, 1], (3, 1))
                        .astype(np.float32))
            c.DrawPrimitive(TRI, None, data)
            assert c.EndDisplayList()
            tris0 = c.stats["NbTrianglesDrawn"]
            c.Clear()
            c.InternalSetRenderState(VXRENDERSTATE.FOGENABLE, 0)
            assert c.CallDisplayList(dl)
            assert c.stats["NbTrianglesDrawn"] == tris0 + 1
            assert c.GetRenderState(VXRENDERSTATE.FOGENABLE) == 1
            assert c.BackToFront()[..., 0].sum() > 10
            assert c.DeleteDisplayList(dl)
            assert not c.CallDisplayList(dl)
        _both(case)

    def test_shader_constants_and_clip_planes(self):
        def case(hal, rst, drv, c):
            assert c.SetVertexShaderConstant(2, [1, 2, 3, 4])
            np.testing.assert_allclose(c._vs_const[2], [1, 2, 3, 4])
            assert c.SetPixelShaderConstant(0, [5, 6, 7, 8])
            assert c.SetUserClipPlane(0, (0, 1, 0, 2))
            np.testing.assert_allclose(c.GetUserClipPlane(0), [0, 1, 0, 2])
            assert not c.SetUserClipPlane(9, (0, 0, 0, 0))
            assert c.SetVertexShader(0) and not c.SetPixelShader(3)
            return c._vs_const.copy(), c._ps_const.copy()
        got, ref = _both(case)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)

    def test_screen_backup_and_dirty_rects(self):
        def case(hal, rst, drv, c):
            c.Clear(CKRST_CTXCLEAR_ALL, 0xFF00FF00)
            c.SetScreenBackup()
            c.Clear(CKRST_CTXCLEAR_ALL, 0)
            assert c.RestoreScreenBackup()
            assert c.BackToFront()[0, 0, 1] == pytest.approx(1.0)
            c.AddDirtyRect((1, 1, 5, 5))
            c.AddDirtyRect()
            assert len(c._dirty_rects) == 2
            c.ResetDirtyRects()
            assert c._dirty_rects == []
            backend = c.GetImplementationSpecificData()["backend"]
            assert backend == ("torch" if hal is TH else "jax")
            assert c.SetDrawBuffer(3)
            c.WarnThread(True)
            assert c.Resize(width=16, height=16)
            assert c.fb.shape == (4, 16, 16)
        _both(case)


def _lights(M, ctx):
    key = M.CKLight(ctx, "key")
    key.SetColor((1.0, 0.9, 0.8, 1.0))
    key.SetOrientation((0.3, -0.6, 1.0))
    fill = M.CKLight(ctx, "fill")
    fill.SetColor((0.2, 0.3, 0.9, 1.0))
    fill.SetOrientation((-1.0, 0.2, 0.3))
    return [key, fill]


def test_call_script_matches_reference():
    """The card check's call script at 48x40 (48 triangles: a lit sphere,
    VB+IB strips, a replayed display list, blended quads with fog, a
    sprite, a framebuffer copy drawn back, a screen backup): the port's
    planes, counters and probes against the reference's; the probes'
    own identities (copy = fb rect, restore = backup) hold; a replay is
    bit-equal to the same draw issued directly."""
    def case(hal, rst, drv, c):
        M = O if hal is TH else J
        ctx = M.CKContext(device=CPU) if M is O else M.CKContext()
        return hf.hal_script(rst, c, _lights(M, ctx), probes=True,
                             **hf.SMALL)
    got, ref = _both(case, 48, 40)
    assert (got["triangles"], got["vertices"]) == (48, 120)
    for k in ("copy_fb", "copy_tex", "backup_fb", "restored_fb"):
        _assert_mostly_close(got[k], ref[k])
    np.testing.assert_array_equal(got["copy_tex"], got["copy_fb"])
    np.testing.assert_array_equal(got["restored_fb"], got["backup_fb"])
    rst = TH.CKRasterizer(device=CPU)
    rst.Start(None)
    a, b = hf.display_list_pair(rst, 4, 48, 40)
    assert a.stats["NbTrianglesDrawn"] == 2 * b.stats["NbTrianglesDrawn"]
    np.testing.assert_array_equal(a.BackToFront(), b.BackToFront())
    np.testing.assert_array_equal(a.zb.numpy(), b.zb.numpy())
