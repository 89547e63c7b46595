"""Immediate-mode draws on the port (``DrawPrimitive`` and its state, the
staging helpers, ``CKVertexBuffer``, the render manager's vertex buffers,
render-callback meshes, ``RenderTransparents``, Sprite3D batches and
``scenes.build_config5_immediate``) against the reference package on the
CPU: each case runs one script through both object models and compares
host values exactly and fb / zb to ``render_pass``'s bound on record (1e-5
on all but 0.1% of the values, never past 1e-4;
``tests/test_torch_hal_draw.py``).

Both packages draw through their ``render_pass``, one full-frame composite
per triangle. The reference's is one jitted program per batch shape, which
takes XLA about a minute to compile on the CPU; these cases run its
``_one_triangle`` jitted alone, once per frame and texture shape, in the
reference's triangle loop (:class:`_RefPass`, swapped in for the module
its ``CKVertexBuffer.Draw`` calls): the reference's arithmetic, compiled by
XLA, a few seconds per shape. XLA contracts the edge functions'
multiply-adds, so a pixel centre that lies exactly on an edge can fall on
the other side of it than in the port (run op by op, the reference agrees
with the port there bit for bit): the scenes put no edge through pixel
centres, turning their cubes about oblique axes.

The level case renders config 5 cut to 128x96 with its callbacks off
through both packages (``_torch_common.check_render``), then runs the
callbacks' draws on both over the port's level frame, so that the draws
are compared on the same base.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu.objects.vertexbuffer as jvb
from ckrenderengine_tpu.raster import jax_backend as jrb
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.objects import vertexbuffer as tvb
from ckrenderengine_tpu_torch.raster.types import VXBLEND, VXCMP, VXPRIMITIVE

from _torch_common import check_render, render_both, small_ctx

LIST = int(VXPRIMITIVE.TRIANGLELIST)
STRIP = int(VXPRIMITIVE.TRIANGLESTRIP)
FAN = int(VXPRIMITIVE.TRIANGLEFAN)
POINTS = int(VXPRIMITIVE.POINTLIST)
SIZE = 48
LEVEL = dict(width=128, height=96, terrain_n=24, n_balls=4, n_props=2,
             n_cards=1, n_blended=1, n_halos=4)


class _RefPass:
    """The reference's ``render_pass`` for its ``CKVertexBuffer.Draw``:
    the same pixel grid, scissor and triangle loop, each triangle through
    the reference's ``_one_triangle`` jitted alone."""
    DeviceBatch = jrb.DeviceBatch
    one = staticmethod(jax.jit(jrb._one_triangle))

    @staticmethod
    def render_pass(fb, zb, batch, state_i, state_f, tex_planes, tex_hw,
                    fog_color, viewport):
        h, w = fb.shape[1], fb.shape[2]
        py, px = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                              jnp.arange(w, dtype=jnp.float32) + 0.5,
                              indexing="ij")
        vp = viewport
        scissor = ((px >= vp[0]) & (px < vp[0] + vp[2])
                   & (py >= vp[1]) & (py < vp[1] + vp[3]))
        for i in range(batch.xyw.shape[0]):
            tri = tuple(a[i] for a in batch[:11])
            fb, zb = _RefPass.one(px, py, fb, zb, tri, state_i, state_f,
                                  tex_planes, tex_hw, fog_color, scissor)
        return fb, zb


@pytest.fixture(autouse=True)
def _reference_pass(monkeypatch):
    monkeypatch.setattr(jvb, "rb", _RefPass)


def _close(got, ref, atol=1e-5, cap=1e-4):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    off = diff > atol
    assert off.mean() <= 1e-3, (int(off.sum()), float(diff.max()))
    assert diff.max() <= cap, float(diff.max())


def _planes(rc):
    """(fb HWC, zb) of a context of either package, on the host."""
    return rc.framebuffer(), np.asarray(rc.zbuffer())


def _same_frame(rt, rj):
    (fb_t, zb_t), (fb_j, zb_j) = _planes(rt), _planes(rj)
    _close(fb_t, fb_j)
    _close(zb_t, zb_j)
    return fb_t


def _both(script):
    """``script(P)`` through the reference (J) and the port (O)."""
    return script(J), script(O)


def _ctx(P, size=SIZE):
    ctx = small_ctx(P)
    rc = ctx.GetRenderManager().CreateRenderContext(size, size)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0.2, 0.1, -5.0))
    rc.AttachViewpointToCamera(cam)
    return ctx, rc, cam


def _texture(P, ctx, name="tex", seed=3):
    img = np.random.default_rng(seed).uniform(0.1, 1.0, (8, 8, 4))
    img[..., 3] = (np.indices((8, 8)).sum(0) % 3 != 0)
    tex = P.CKTexture(ctx, name)
    tex.SetImage(img.astype(np.float32))
    return tex


def _vertices(n, transformed, seed):
    rng = np.random.default_rng(seed)
    if transformed:
        w = rng.uniform(1.0, 2.0, (n, 1))
        pos = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)) * w,
                              rng.uniform(0.1, 0.9, (n, 1)) * w, w], -1)
    else:
        pos = np.concatenate([rng.uniform(-1.6, 1.6, (n, 2)),
                              rng.uniform(-1.0, 1.0, (n, 1))], -1)
    return (pos.astype(np.float32),
            rng.uniform(0.05, 1.0, (n, 4)).astype(np.float32),
            rng.uniform(-0.5, 1.5, (n, 2)).astype(np.float32))


def _world():
    a = 0.6
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                 [np.sin(a), 0, np.cos(a)]]
    m[3, :3] = (0.3, -0.2, 0.5)
    return m


@pytest.mark.parametrize("transformed", [True, False])
@pytest.mark.parametrize("prim", [LIST, STRIP, FAN, POINTS])
def test_draw_primitive_prim_types(prim, transformed):
    """DrawPrimitive of each primitive type, clip-space and local (through
    the DP world matrix and the camera's view and projection)."""
    n = {LIST: 9, STRIP: 7, FAN: 7, POINTS: 6}[prim]

    def script(P):
        ctx, rc, cam = _ctx(P)
        pos, col, uv = _vertices(n, transformed, seed=prim)
        s = rc.GetDrawPrimitiveStructure(transformed, n)
        s["positions"][:] = pos
        s["colors"][:] = col
        s["uvs"][:] = uv
        if not transformed:
            rc.SetWorldTransformationMatrix(_world())
        ok = rc.DrawPrimitive(prim)
        return rc, ok

    (rj, ok_j), (rt, ok_t) = _both(script)
    assert ok_t is True and ok_j is True
    fb = _same_frame(rt, rj)
    assert (fb[..., :3].sum(-1) > 0).sum() > (4 if prim == POINTS else 40)


def test_draw_primitive_state():
    """DrawPrimitive with indices, a stage-0 texture matrix,
    ``SetTexture`` and ``SetCurrentMaterial`` (whose state and texture
    win over ``SetTexture``'s), one draw after the other; the transform
    getters and setters."""

    def script(P):
        ctx, rc, cam = _ctx(P)
        out = [rc.GetViewTransformationMatrix().tolist(),
               rc.GetProjectionTransformationMatrix().tolist(),
               rc.GetWorldTransformationMatrix().tolist()]
        pos, col, uv = _vertices(8, False, seed=11)
        s = rc.GetDrawPrimitiveStructure(False, 8)
        s["positions"][:] = pos
        s["colors"][:] = col
        s["uvs"][:] = uv
        idx = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4], np.int32)
        rc.SetTexture(_texture(P, ctx, "dp_tex"))
        out.append(rc.DrawPrimitive(LIST, idx))
        m = np.eye(4, dtype=np.float32)
        m[0, 0], m[1, 1], m[3, 0], m[3, 1] = 2.0, -1.5, 0.25, 0.1
        rc.SetTextureMatrix(m)
        rc.SetWorldTransformationMatrix(_world())
        out.append(rc.DrawPrimitive(LIST, idx[::-1].copy()))
        mat = P.CKMaterial(ctx, "dp_mat")
        mat.SetTexture(_texture(P, ctx, "mat_tex", seed=5))
        mat.EnableAlphaBlend(True)
        mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
        mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
        mat.SetTwoSided(True)
        rc.SetCurrentMaterial(mat)
        view = rc.GetViewTransformationMatrix()
        view[3, 2] += 1.0
        rc.SetViewTransformationMatrix(view)
        out.append(rc.DrawPrimitive(FAN, idx[:8].copy()))
        rc.SetCurrentMaterial(None)
        rc.SetTextureMatrix(np.eye(4, dtype=np.float32))
        out += [rc.GetViewTransformationMatrix().tolist(),
                rc.GetWorldTransformationMatrix().tolist()]
        rc.RestoreStereoRenderState()
        out.append(rc.GetViewTransformationMatrix().tolist())
        out.append(rc.DrawPrimitive(LIST, None, {
            "positions": pos[:3], "colors": col[:3], "uvs": uv[:3],
            "transformed": False}))
        return rc, out

    (rj, out_j), (rt, out_t) = _both(script)
    assert out_t == out_j
    _same_frame(rt, rj)


def test_staging_helpers():
    """AllocateStructure / GetStructure / ClearStructure (DrawPrimitive
    without a structure draws nothing), GetDrawPrimitiveIndices,
    LockCurrentVB / ReleaseCurrentVB with and without a draw."""

    def script(P):
        ctx, rc, cam = _ctx(P)
        out = [rc.GetStructure()]
        s = rc.AllocateStructure(4)
        out += [rc.GetStructure() is s, s["positions"].shape,
                s["transformed"]]
        rc.ClearStructure()
        out += [rc.GetStructure(), rc.DrawPrimitive(LIST)]
        out.append(rc.GetDrawPrimitiveIndices(5).tolist())
        out.append(rc.GetDrawPrimitiveIndices(300).shape)
        out.append(rc.ReleaseCurrentVB(LIST))
        p, c, u = rc.LockCurrentVB(4)
        pos, col, uv = _vertices(4, True, seed=21)
        p[:], c[:], u[:] = pos, col, uv
        out.append(rc.ReleaseCurrentVB())
        fb0 = rc.framebuffer().copy()
        p, c, u = rc.LockCurrentVB(4)
        p[:], c[:], u[:] = pos, col, uv
        out.append(rc.ReleaseCurrentVB(FAN))
        p, c, u = rc.LockCurrentVB(300)
        out.append(p.shape)
        return rc, out, fb0

    (rj, out_j, fb0_j), (rt, out_t, fb0_t) = _both(script)
    assert out_t == out_j
    assert not fb0_t.any() and not fb0_j.any()
    fb = _same_frame(rt, rj)
    assert fb[..., :3].any()


def test_vertex_buffer():
    """CKVertexBuffer: Check grows, Lock / Unlock / GetCount, Draw of a
    list and of a strip from an offset, Destroy and a new allocation."""

    def script(P):
        ctx, rc, cam = _ctx(P)
        cls = jvb.CKVertexBuffer if P is J else tvb.CKVertexBuffer
        vb = cls(ctx, "vb", max_vertices=4)
        out = [vb.Check(3), vb.max_vertices, vb.Check(9), vb.max_vertices]
        pos, col, uv = _vertices(12, True, seed=31)
        p, c, u = vb.Lock(0, 6)
        p[:], c[:], u[:] = pos[:6], col[:6], uv[:6]
        vb.Unlock()
        out.append(vb.GetCount())
        out.append(vb.Draw(rc))
        p, c, u = vb.Lock(6, 6)
        p[:], c[:], u[:] = pos[6:], col[6:], uv[6:]
        vb.Unlock()
        out += [vb.GetCount(), vb.Draw(rc, STRIP, 5, 6),
                vb.Draw(rc, LIST, 0, 2)]
        vb.Destroy()
        out += [vb.GetCount(), vb.max_vertices, vb.positions.shape]
        out += [vb.Check(5), vb.max_vertices]
        return rc, out

    (rj, out_j), (rt, out_t) = _both(script)
    assert out_t == out_j
    assert (tvb.CK_VB_OK, tvb.CK_VB_LOST, tvb.CK_VB_FAILED) == (
        jvb.CK_VB_OK, jvb.CK_VB_LOST, jvb.CK_VB_FAILED)
    _same_frame(rt, rj)


def test_manager_vertex_buffers():
    """CreateVertexBuffer / DestroyVertexBuffer / DeleteAllVertexBuffers
    and OnCKEnd, which deletes them."""

    def script(P):
        ctx = small_ctx(P)
        rm = ctx.GetRenderManager()
        a = rm.CreateVertexBuffer("a", 16)
        b = rm.CreateVertexBuffer("b")
        out = [a.max_vertices, b.max_vertices, len(rm._vertex_buffers),
               ctx.GetObject(a.id) is a]
        rm.DestroyVertexBuffer(a)
        out += [len(rm._vertex_buffers), ctx.GetObject(a.id)]
        rm.DestroyVertexBuffer(a)
        rm.CreateVertexBuffer("c", 4)
        rm.DeleteAllVertexBuffers()
        out += [len(rm._vertex_buffers), ctx.GetObject(b.id)]
        d = rm.CreateVertexBuffer("d", 4)
        rm.OnCKEnd()
        out += [len(rm._vertex_buffers), ctx.GetObject(d.id)]
        return out

    out_j, out_t = _both(script)
    assert out_t == out_j == [16, 1024, 2, True, 1, None, 0, None, 0, None]


def _cube_mesh(P, ctx, name, mat, s=0.5):
    verts, faces = scenes._cube(s)
    mesh = P.CKMesh(ctx, name)
    mesh.SetPositions(verts)
    mesh.SetFaces(faces)
    mesh.SetUVs(((verts[:, :2] / s + 1.0) * 0.5).astype(np.float32))
    mesh.BuildNormals()
    mesh.ApplyGlobalMaterial(mat)
    return mesh


def _callback_scene(P, size=SIZE):
    """An emissive triangle in the frame and a cube in front of it whose
    mesh draws itself in a render callback (``DefaultRender``), plus a
    post-render callback that draws a HUD fan through the staging VB.
    Returns (ctx, rc, cube entity)."""
    ctx, rc, cam = _ctx(P, size)
    mesh = P.CKMesh(ctx, "tri_mesh")
    mesh.SetPositions(np.array([[-1.5, -1, 1], [0, 1.5, 1], [1.5, -1, 1]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.BuildNormals()
    tmat = P.CKMaterial(ctx, "tri_mat")
    tmat.SetDiffuse((0, 0, 0, 1))
    tmat.SetEmissive((0.8, 0.3, 0.1, 1))
    tmat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(tmat)
    tri = P.CK3dObject(ctx, "tri")
    tri.SetCurrentMesh(mesh)
    cmat = P.CKMaterial(ctx, "cube_mat")
    cmat.SetDiffuse((0.2, 0.6, 0.9, 1.0))
    cmat.SetTexture(_texture(P, ctx, "cube_tex", seed=7))
    cmat.EnableAlphaTest(True)
    cmat.SetAlphaFunc(int(VXCMP.GREATER))
    cmat.SetAlphaRef(128)
    cube = P.CK3dObject(ctx, "cube")
    cube.SetCurrentMesh(_cube_mesh(P, ctx, "cube_mesh", cmat))
    cube.Rotate((1.0, 1.0, 0.0), 0.5)
    cube.SetPosition((0.3, 0.0, 0.0))
    cube.GetCurrentMesh().SetRenderCallBack(
        lambda rc, m, ent: m.DefaultRender(rc, ent), cube)

    def hud(rc, arg):
        p, c, u = rc.LockCurrentVB(4)
        p[:] = [[-1, 1, 0, 1], [-0.5, 1, 0, 1], [-0.5, 0.6, 0, 1],
                [-1, 0.6, 0, 1]]
        c[:] = (0.1, 0.9, 0.2, 1.0)
        rc.ReleaseCurrentVB(FAN)

    rc.AddPostRenderCallBack(hud)
    return ctx, rc, cube


def test_render_callback_mesh():
    """A mesh with a render callback stays out of the frame and draws
    itself through DrawPrimitive after it; a post-render callback draws
    over both. Through Render(), twice, the cube moving between."""

    def script(P):
        ctx, rc, cube = _callback_scene(P)
        out = []
        for k in range(2):
            rc.Render()
            out.append(int(rc.GetStats().NbTrianglesDrawn))
            cube.Rotate((0.0, 1.0, 0.0), 0.4)
        return rc, out

    (rj, out_j), (rt, out_t) = _both(script)
    assert out_t == out_j == [1, 1]
    fb = _same_frame(rt, rj)
    assert (np.abs(fb[..., 2] - 0.9 * 0.0) > 0.05).sum() > 50


def test_render_transparents_far_to_near():
    """RenderTransparents draws the visible transparent entities far to
    near by their origins' view depth (non-commuting blends make the
    order visible), skipping hidden and opaque ones."""

    def script(P):
        ctx, rc, cam = _ctx(P)
        drawn = []
        for i, (z, a) in enumerate(((0.5, 0.5), (2.5, 0.7), (-1.0, 0.4),
                                    (1.5, 0.6))):
            mat = P.CKMaterial(ctx, f"glass{i}")
            mat.SetDiffuse((0.2 * i, 1.0 - 0.2 * i, 0.5, a))
            mat.EnableAlphaBlend(i != 3)
            mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
            mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
            mat.SetTwoSided(True)
            ent = P.CK3dObject(ctx, f"e{i}")
            ent.SetCurrentMesh(_cube_mesh(P, ctx, f"m{i}", mat, 0.8))
            ent.Rotate((1.0, 0.7, 0.3), 0.35 + 0.2 * i)
            ent.SetPosition((0.2 * i - 0.3, 0.1 * i, z))
            mesh = ent.GetCurrentMesh()
            mesh.AddPostRenderCallBack(
                lambda rc, m, name=ent.GetName(): drawn.append(name))
        hidden = ctx.GetObjectByName("e1")
        clone = P.CK3dObject(ctx, "hidden")
        clone.SetCurrentMesh(hidden.GetCurrentMesh())
        clone.Show(False)
        n = rc.RenderTransparents()
        return rc, (n, drawn)

    (rj, out_j), (rt, out_t) = _both(script)
    assert out_t == out_j == (3, ["e1", "e0", "e2"])
    _same_frame(rt, rj)


def test_sprite3d_batches():
    """AddSprite3DBatch over two materials (one textured), a sprite with
    no material refused, CallSprite3DBatches drawing every batch NOW with
    culling off, FlushSprite3DBatchesIfNeeded with nothing pending."""

    def script(P):
        ctx, rc, cam = _ctx(P)
        plain = P.CKMaterial(ctx, "plain")
        plain.SetDiffuse((0.0, 1.0, 0.3, 1.0))
        tex = P.CKMaterial(ctx, "textured")
        tex.SetDiffuse((1.0, 0.8, 0.6, 1.0))
        tex.SetTexture(_texture(P, ctx, "sprite_tex", seed=9))
        out = []
        for i, mat in enumerate((plain, tex, plain, None)):
            sp = P.CKSprite3D(ctx, f"sp{i}")
            if mat is not None:
                sp.SetMaterial(mat)
            sp.SetPosition((1.2 * i - 1.8, 0.4 * i - 0.6, 0.3 * i))
            sp.SetSize((1.5, 1.0))
            sp.Show(False)
            out.append(rc.AddSprite3DBatch(sp))
        out.append(len(plain.GetSprite3DBatch()))
        out.append(rc.CallSprite3DBatches())
        out += [plain.GetSprite3DBatch(), rc.FlushSprite3DBatchesIfNeeded()]
        sp = ctx.GetObjectByName("sp1")
        rc.AddSprite3DBatch(sp)
        out.append(rc.FlushSprite3DBatchesIfNeeded())
        return rc, out

    (rj, out_j), (rt, out_t) = _both(script)
    assert out_t == out_j == [True, True, True, False, 2, 3, [], 0, 1]
    fb = _same_frame(rt, rj)
    assert (fb[..., 1] > 0.5).sum() > 50


def test_window_of_4_with_dp_callbacks():
    """A render-callback mesh and a DrawPrimitive post-render callback in
    a window of 4: each callback's read of fb runs the staged frame (one
    replay) before it draws, so every tick equals the tick at W = 1, bit
    for bit."""
    frames = {}
    for window in (1, 4):
        _ctx_, rc, cube = _callback_scene(O)
        rc.SetFramePipelining(window)
        got = []
        for k in range(6):
            rc.Render()
            got.append((rc.fb.clone(), rc.zb.clone()))
            cube.Rotate((0.0, 1.0, 0.0), 0.3)
        frames[window] = got
        if window == 4:
            assert rc._window is not None      # the frames replayed
    for (fa, za), (fb, zb) in zip(frames[1], frames[4]):
        assert torch.equal(fa, fb) and torch.equal(za, zb)


# The level's ``imm`` handle of each package, by the package's name.
_IMM = {}


def _level_off(P, **kw):
    ctx, rc, spinner, imm = scenes.build_config5_immediate(P, **kw)
    imm["on"] = False
    _IMM[P.__name__] = imm
    return ctx, rc, imm


def _draw_callbacks(rc):
    """The draws of rc's callbacks, in Render()'s order: each mesh's render
    callback, then the context's post-render callbacks."""
    for obj in list(rc.context._prerender_objects.values()):
        rcb = getattr(obj, "render_callback", None)
        if rcb is not None:
            rcb[0](rc, obj, rcb[1])
    for _kind, fct, arg, _t in rc.post_render_callbacks:
        fct(rc, arg)


def test_config5_immediate_level():
    """``build_config5_immediate`` at 128x96 (a 24x24 terrain, 4 spheres,
    2 props, 1 card, 1 blended prop, 4 halos: 3,272 frame triangles, the
    flat route; the tiled route of the level at this size is held by
    ``test_torch_shaders_level.py``): the level frame with the callbacks
    off against the reference (``check_render``); the callbacks' draws on
    both packages over the port's level frame within the bound; the
    port's Render() with the callbacks on equal to its level frame plus
    those draws, bit for bit."""
    pair = render_both(_level_off, accelerator=False, **LEVEL)
    check_render(pair)
    rj, rt, _packed, _ref = pair
    base = (rt.fb.clone(), rt.zb.clone())
    for P in (J, O):
        _IMM[P.__name__]["on"] = True
    rj.fb = jnp.asarray(base[0].numpy())
    rj.zb = jnp.asarray(base[1].numpy())
    _draw_callbacks(rj)
    _draw_callbacks(rt)
    fb = _same_frame(rt, rj)
    drawn = (rt.fb != base[0]).any(0)
    assert 0.02 < float(drawn.float().mean()) < 0.9
    over = (rt.fb.clone(), rt.zb.clone())
    rt.Render()
    assert torch.equal(rt.fb, over[0]) and torch.equal(rt.zb, over[1])
    assert fb.shape == (96, 128, 4)
