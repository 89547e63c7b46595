"""User vertex and pixel shaders (``SetVertexShader`` / ``SetPixelShader``)
in the port, module by module, against the reference on the CPU. Each stage
is written once against an array namespace (``scenes.config5_shaders``, or
the small stages below) and built on ``jax.numpy`` for the reference and on
``torch`` for the port.

- The vertex stage: ``transform_and_light`` with ``config5_shaded``'s wave
  on the reference's packed inputs (``convert.from_reference`` with the
  torch counterparts): every output within 1e-5 * (1 + |x|), as
  tests/test_torch_texgen.py holds the unshaded stage.
- ``shade_deferred`` with ``config5_shaded``'s pixel shader on seeded
  winners: a mip state (analytic LOD), a cube-env state (the per-pixel UV
  from the interpolated reflection vector), an untextured state (white
  texel), a colour-write-off state, a DP3-keyed state and a tinted
  non-perspective one; fb within ``assert_fb_close``'s bounds (2e-6 on all
  but 1% of the pixels, those within 1/255 on ill-conditioned edges).
- The reference's own cases (tests/test_pixel_shader.py,
  tests/test_vertex_shader.py) through the port's ``Render()``, and the
  port's shaded frames against the reference's within 2e-5.

The ordered passes with a stage, and the shapes each package's stage
receives, are in tests/test_torch_shaders_ordered.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu.pipeline import frame as jfr
from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.types import (
    RasterState, TEXGEN_CUBE, VXTEXTUREBLEND, VXTEXTURE_ADDRESS,
    VXTEXTURE_FILTER, pack_states,
)
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import deferred as tdf
from tests._torch_common import assert_fb_close, to_np
from tests.test_tiled_raster import _random_batch
from tests.test_torch_ordered import _t

SMALL = dict(width=96, height=72, terrain_n=8, n_balls=4)


def _xp(P):
    return jnp if P is J else torch


def _build_shaded(P, **kw):
    return scenes.build_config5_shaded(P, xp=_xp(P), **kw)


# -- the vertex stage --------------------------------------------------------

@pytest.fixture(scope="module")
def shaded_inputs():
    """The reference's packed inputs of the small shaded level, unpacked by
    both packages, with each package's build of the stages."""
    _c, rj, spinner = _build_shaded(J, **SMALL)
    spinner.Rotate((0, 1, 0), 0.7)               # a phase off zero
    rj.Render()
    static, dyn_f, dyn_i, params = rj._fill_packed([], [])
    vs_t, ps_t = scenes.config5_shaders(torch, spinner.row, SMALL["width"],
                                        SMALL["height"])
    st, tf, ti, tp = convert.from_reference(
        {k: np.asarray(v) for k, v in static.items()}, dyn_f, dyn_i, params,
        "cpu", vertex_shader=vs_t, pixel_shader=ps_t)
    scene_j = jfr.unpack_scene(static, jnp.asarray(dyn_f),
                               jnp.asarray(dyn_i), params["layout"])[0]
    scene_t = tfr.unpack_scene(st, tf, ti, tp["layout"])[0]
    return scene_j, scene_t, params, tp


def test_vertex_stage_matches_reference(shaded_inputs):
    scene_j, scene_t, params, tp = shaded_inputs
    assert tp["vertex_shader"] is not None and tp["pixel_shader"] is not None
    out_j = jfr.transform_and_light(scene_j, params["levels"],
                                    vertex_shader=params["vertex_shader"])
    out_t = tfr.transform_and_light(scene_t, params["levels"],
                                    vertex_shader=tp["vertex_shader"])
    plain = tfr.transform_and_light(scene_t, params["levels"])
    names = ("clip", "color", "spec", "fog", "world", "uv")
    for name, a, b in zip(names, out_j, out_t):
        a = np.asarray(a, np.float64)
        b = b.numpy().astype(np.float64)
        assert a.shape == b.shape, name
        assert np.all(np.abs(a - b) <= 1e-5 * (1 + np.abs(a))), (
            name, float(np.abs(a - b).max()))
    # The wave moves the vertices and its tilt reaches the lighting.
    assert (out_t[0] - plain[0]).abs().max() > 1e-3
    assert (out_t[1] - plain[1]).abs().max() > 1e-3


def test_from_reference_pairs_the_stages(shaded_inputs):
    _sj, _st, params, _tp = shaded_inputs
    _c, rj, _s = scenes.build_config5(J, **SMALL)
    rj.Render()
    static, dyn_f, dyn_i, plain = rj._fill_packed([], [])
    static = {k: np.asarray(v) for k, v in static.items()}
    with pytest.raises(ValueError, match="vertex_shader"):
        convert.from_reference(static, dyn_f, dyn_i,
                               dict(plain, vertex_shader=params[
                                   "vertex_shader"]), "cpu")
    with pytest.raises(ValueError, match="pixel_shader"):
        convert.from_reference(static, dyn_f, dyn_i, plain, "cpu",
                               pixel_shader=lambda inp: inp["color"])


# -- the deferred shade ------------------------------------------------------

def _shade_states():
    A, F, B = VXTEXTURE_ADDRESS, VXTEXTURE_FILTER, VXTEXTUREBLEND
    return [
        RasterState(tex=0, tex_address=int(A.WRAP),
                    tex_filter=int(F.LINEARMIPLINEAR),
                    tex_blend=int(B.DOTPRODUCT3), fog=True),     # mip, DP3
        RasterState(tex=1, tex_address=int(A.CLAMP),
                    tex_filter=int(F.LINEAR), texgen=TEXGEN_CUBE),  # cube
        RasterState(fog=True),                                  # untextured
        RasterState(tex=0, color_write=False),                  # z only
        RasterState(tex=1, tex_filter=int(F.NEAREST), perspective=False,
                    const_color=(0.5, 0.8, 1.0)),               # tinted
    ]


def _shade_inputs(mips: bool):
    h, w, t = 72, 96, 160
    rng = np.random.default_rng(23)
    xyw, z, _s, _v = _random_batch(t, h, w, seed=23)
    states = _shade_states()
    si, sf = pack_states(states)
    state = rng.integers(0, len(states), t).astype(np.int32)
    setup = jdf.triangle_setup(xyw, z, jnp.asarray(state), jnp.ones(t, bool),
                               jnp.asarray(si))
    best_id, _bd = jdf.depth_reduce(setup, jnp.ones(t, bool), 1.0,
                                    jnp.asarray([0, 0, w, h], jnp.float32),
                                    h, w)
    refl = rng.normal(size=(t, 3, 3)).astype(np.float32)
    tw = 8
    tex = rng.uniform(0, 1, (2, 4, tw, tw + (tw // 2 if mips else 0)))
    tex_hw = (np.array([[tw, tw, 4], [tw, tw, 4]], np.int32) if mips
              else np.array([[tw, tw], [tw, tw]], np.int32))
    args = (np.asarray(best_id), np.asarray(xyw), np.asarray(z),
            rng.uniform(0, 1, (t, 3, 4)).astype(np.float32),
            rng.uniform(0, 0.3, (t, 3, 3)).astype(np.float32),
            rng.uniform(-1.5, 2.5, (t, 3, 2)).astype(np.float32),
            rng.uniform(0, 1, (t, 3)).astype(np.float32), state, si, sf,
            tex.astype(np.float32), tex_hw,
            np.array([0.2, 0.3, 0.4], np.float32),
            np.broadcast_to(np.array([0.1, 0.0, 0.2, 1.0], np.float32)[
                :, None, None], (4, h, w)).copy())
    return args, refl, {k: np.asarray(v) for k, v in setup.items()}, h, w


@pytest.mark.parametrize("mips", [False, True], ids=["planes", "mips"])
def test_shade_deferred_with_stage_matches_reference(mips):
    args, refl, setup, h, w = _shade_inputs(mips)
    ps = {P: scenes.config5_shaders(_xp(P), 0, w, h)[1] for P in (J, O)}
    ref = np.asarray(jdf.shade_deferred(
        *(jnp.asarray(a) for a in args), h, w, batch_refl=jnp.asarray(refl),
        pixel_shader=ps[J]))
    got = tdf.shade_deferred(*(_t(a) for a in args), h, w,
                             batch_refl=_t(refl), pixel_shader=ps[O])
    ids = args[0]
    assert_fb_close(to_np(got), ref, ids, setup)
    # Every state shades some pixel, and the z-only state keeps the clear
    # colour where it wins.
    hit = ids >= 0
    state = args[7]
    assert len(np.unique(state[ids[hit]])) == len(_shade_states())
    zonly = hit & (state[np.clip(ids, 0, None)] == 3)
    assert np.array_equal(to_np(got)[:, zonly], args[-1][:, zonly])
    # The stage replaced the texture blend.
    plain = tdf.shade_deferred(*(_t(a) for a in args), h, w,
                               batch_refl=_t(refl))
    assert (plain - got).abs().max() > 0.05


# -- the reference's cases, through the port's Render() ------------------------

def _textured_scene(P, blend_mode=None, alpha=False, size=96):
    """tests/test_pixel_shader.py's textured quad through package ``P``."""
    ctx = P.CKContext(**({"device": "cpu"} if P is O else {}))
    rc = ctx.GetRenderManager().CreateRenderContext(size, size)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 0.0, -4.0))
    rc.AttachViewpointToCamera(cam)
    mesh = P.CKMesh(ctx, "quad")
    s = 1.6
    mesh.SetPositions(np.array(
        [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.SetUVs(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    mesh.BuildNormals()
    tex = P.CKTexture(ctx, "grad")
    gy, gx = np.mgrid[0:16, 0:16] / 15.0
    tex.SetImage(np.stack([gx, gy, 0.5 * np.ones_like(gx),
                           np.ones_like(gx)], -1).astype(np.float32))
    mat = P.CKMaterial(ctx, "m")
    mat.SetTexture(tex)
    mat.SetDiffuse((0.8, 0.6, 0.4, 0.5 if alpha else 1.0))
    mat.SetEmissive((0.8, 0.6, 0.4, 1.0))
    if blend_mode is not None:
        mat.SetTextureBlendMode(blend_mode)
    if alpha:
        mat.EnableAlphaBlend(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = P.CK3dObject(ctx, "q")
    obj.SetCurrentMesh(mesh)
    rc.SetBackgroundColor((0, 0, 0, 1))
    return rc, mat


def _dp3_stage(xp):
    def dp3(inp):
        t, d = inp["texel"], inp["color"]
        dot = ((t[..., 0] - 0.5) * (d[..., 0] - 0.5)
               + (t[..., 1] - 0.5) * (d[..., 1] - 0.5)
               + (t[..., 2] - 0.5) * (d[..., 2] - 0.5)) * 4.0
        return xp.stack([dot, dot, dot, d[..., 3]], -1)
    return dp3


def _red_stage(xp):
    def red_only(inp):
        c = inp["color"] * inp["texel"]
        return xp.stack([xp.ones_like(c[..., 0]), xp.zeros_like(c[..., 1]),
                         xp.zeros_like(c[..., 2]), c[..., 3]], -1)
    return red_only


def test_dp3_user_stage_matches_builtin():
    rc, mat = _textured_scene(O, int(VXTEXTUREBLEND.DOTPRODUCT3))
    rc.Render()
    builtin = rc.framebuffer().copy()
    assert builtin[..., :3].std() > 0.01
    mat.SetTextureBlendMode(int(VXTEXTUREBLEND.MODULATE))
    rc.SetPixelShader(_dp3_stage(torch))
    rc.Render()
    np.testing.assert_allclose(rc.framebuffer(), builtin, atol=2e-5)
    # The reference's frame of the same user stage.
    rj, mat_j = _textured_scene(J, int(VXTEXTUREBLEND.MODULATE))
    rj.SetPixelShader(_dp3_stage(jnp))
    rj.Render()
    np.testing.assert_allclose(rc.framebuffer(), rj.framebuffer(), atol=2e-5)


def test_red_stage_on_ordered_pass():
    rc, _mat = _textured_scene(O, alpha=True)
    rc.Render()
    base = rc.framebuffer().copy()
    assert base[..., 1].max() > 0.05
    rc.SetPixelShader(_red_stage(torch))
    rc.Render()
    fb = rc.framebuffer()
    assert fb[..., 0].max() > 0.4
    lit = base[..., :3].sum(-1) > 0.05
    assert fb[..., 1][lit].max() < 1e-5                  # green killed
    rj, _m = _textured_scene(J, alpha=True)
    rj.SetPixelShader(_red_stage(jnp))
    rj.Render()
    np.testing.assert_allclose(fb, rj.framebuffer(), atol=2e-5)
    rc.SetPixelShader(None)
    rc.Render()
    np.testing.assert_allclose(rc.framebuffer(), base, atol=1e-6)


def test_untextured_material_sees_white_texel():
    def scene(P):
        ctx = P.CKContext(**({"device": "cpu"} if P is O else {}))
        rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
        cam = P.CKCamera(ctx, "cam")
        cam.SetPosition((0.0, 0.0, -4.0))
        rc.AttachViewpointToCamera(cam)
        mesh = P.CKMesh(ctx, "t")
        mesh.SetPositions(np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                                   np.float32))
        mesh.SetFaces(np.array([[0, 2, 1]], np.int32))
        mesh.BuildNormals()
        mat = P.CKMaterial(ctx, "m")
        mat.SetEmissive((0.3, 0.5, 0.7, 1.0))
        mesh.ApplyGlobalMaterial(mat)
        P.CK3dObject(ctx, "o").SetCurrentMesh(mesh)
        return rc

    rc = scene(O)
    rc.Render()
    base = rc.framebuffer().copy()
    rc.SetPixelShader(lambda inp: inp["color"] * inp["texel"])
    rc.Render()
    np.testing.assert_allclose(rc.framebuffer(), base, atol=2e-5)
    rj = scene(J)
    rj.SetPixelShader(lambda inp: inp["color"] * inp["texel"])
    rj.Render()
    np.testing.assert_allclose(rc.framebuffer(), rj.framebuffer(), atol=2e-5)


def test_vertex_shader_shifts_the_quad():
    def scene(P):
        ctx = P.CKContext(**({"device": "cpu"} if P is O else {}))
        mesh = P.CKMesh(ctx, "q")
        mesh.SetPositions(np.array(
            [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32))
        mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
        mesh.BuildNormals()
        mat = P.CKMaterial(ctx, "m")
        mat.SetEmissive((1, 0, 0, 1))
        mat.SetTwoSided(True)
        mesh.ApplyGlobalMaterial(mat)
        P.CK3dObject(ctx, "o").SetCurrentMesh(mesh)
        rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
        cam = P.CKCamera(ctx, "cam")
        cam.SetPosition((0, 0, -4))
        rc.AttachViewpointToCamera(cam)
        return rc

    def shift(xp):
        def shift_right(posw, nrmw, scene):
            return posw + xp.asarray([1.5, 0.0, 0.0]), nrmw
        return shift_right

    rc = scene(O)
    rc.Render()
    base = rc.framebuffer().copy()
    assert base[32, 32, 0] > 0.9
    rc.SetVertexShader(shift(torch))
    rc.Render()
    moved = rc.framebuffer()
    assert moved[32, 32].sum() == 0
    assert moved[32, 60, 0] > 0.9
    rj = scene(J)
    rj.SetVertexShader(shift(jnp))
    rj.Render()
    np.testing.assert_allclose(moved, rj.framebuffer(), atol=1e-5)
    rc.SetVertexShader(None)
    rc.Render()
    np.testing.assert_allclose(rc.framebuffer(), base, atol=1e-5)


def test_port_queue_has_no_shader_item():
    """Item 10 (pixel and vertex shaders) is carried: no key in PORT_QUEUE
    and no ``unported(..., 10)`` in the port."""
    import pathlib
    import re

    import ckrenderengine_tpu_torch
    from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE

    assert 10 not in PORT_QUEUE
    root = pathlib.Path(ckrenderengine_tpu_torch.__file__).parent
    cites = re.compile(r"unported\([^()]*(\([^()]*\)[^()]*)*,\s*10\s*\)")
    for path in root.rglob("*.py"):
        assert not cites.search(path.read_text()), path
