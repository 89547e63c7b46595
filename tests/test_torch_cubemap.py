"""Cube-environment mapping in the port's shade stages against the
reference on the CPU: the world reflection vectors through the shade-row
tables, the per-pixel cube UV of every shade path, and the reference's
cube-map scenes.

- The dense, compact and quantized shade-row tables with reflection
  columns (74, 53 and 24 or 28 words), ``expand_rows_compact`` and
  ``expand_rows_quant(has_refl=True)``, on the triangles of
  ``scenes.build_config5_mat`` cut to 96x72 (every TexGen mode, cube-env
  crates and a cube-env plaza channel), from the reference's own stages
  converted bit for bit: the compact and quantized tables (the edge
  coefficients given) and both expansions equal bit for bit, the dense
  table (whose edge and inverse-determinant columns each package
  computes) within 2e-6 * (1 + |x|).
- ``shade_rows`` on the expanded quantized rows with the same winner
  ids and edge values: within 2e-6 on every pixel (the same arithmetic;
  where a fold flips a pixel's cube UV both packages flip it, since they
  read the same rows).
- The textured peel's composite (``_composite_peeled``) fed the same
  layers, whose rows carry the reflection words: within 2e-6.
- The exact ordered pass (``render_pass``) on the reference's ordered
  batch with its reflection columns: within 2e-6 of the reference's;
  ``render_pass_tiled`` bit-equal to it.
- The reference's tests/test_cubemap.py scenes: the octahedral bake equal
  bit for bit, and the mirror quad and the flat mirror across the fold at
  64x64 through both packages' ``Render()`` (flat frames), held to
  ``check_render``, with the reference test's own assertions on the
  port's frame.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckrenderengine_tpu.pipeline import frame as jfr
from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster import jax_backend as jrb
from ckrenderengine_tpu.raster.types import SI_ALPHABLEND
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from ckrenderengine_tpu_torch.raster import deferred as tdf
from ckrenderengine_tpu_torch.raster import torch_backend as trb
from tests._torch_common import (
    check_render, reference_stages, reference_winners, render_both,
    render_reference, to_np,
)

SMALL = dict(width=96, height=72, terrain_n=4, n_balls=2, water_n=4,
             plaza_n=4, pass_n=2)
FACE_COLORS = {0: (1, 0, 0), 1: (0, 1, 0), 2: (0, 0, 1),
               3: (1, 1, 0), 4: (1, 0, 1), 5: (0, 1, 1)}


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, ref, tol=2e-6):
    got = np.asarray(to_np(got), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / (1 + np.abs(ref))
    assert err.max() <= tol, float(err.max())


@pytest.fixture(scope="module")
def stages():
    """The reference's stages of the cut level, its winners, and the
    port's copies of its scene and batch."""
    rj = render_reference(scenes.build_config5_mat, accelerator=False,
                          **SMALL)
    packed = rj._fill_packed([], [])
    st = reference_stages(*packed)
    ids, _depth, setup = reference_winners(*packed)
    sc = st["scene"]
    scene_t = SimpleNamespace(**{k: _t(getattr(sc, k)) for k in (
        "state_i", "state_f", "tex_planes", "tex_hw", "fog_color",
        "viewport", "tex_quad")})
    batch_t = convert.batch_from_reference(
        st["batch"]._replace(planar=None))
    return dict(rj=rj, packed=packed, st=st, ids=ids, setup=setup,
                scene_t=scene_t, batch_t=batch_t)


def _args(b):
    return (b.xyw, b.color, b.specular, b.uv, b.fog, b.state_idx)


def test_dense_and_compact_tables_with_refl(stages):
    b, bt, sc, st = (stages["st"]["batch"], stages["batch_t"],
                     stages["st"]["scene"], stages["scene_t"])
    assert b.refl.shape[1:] == (3, 3) and np.abs(np.asarray(b.refl)).max() > 0
    dense_r = jdf.shade_row_table(*_args(b), sc.state_i, sc.state_f,
                                  sc.tex_hw, batch_refl=b.refl)
    dense_t = tdf.shade_row_table(*_args(bt), st.state_i, st.state_f,
                                  st.tex_hw, batch_refl=bt.refl)
    assert dense_t.shape[1] == tdf.SH_RFL.stop == 74
    _close(dense_t, dense_r)
    setup = stages["setup"]
    comp_r = jdf.shade_row_table_compact(
        *_args(b), batch_refl=b.refl, e_coef=jnp.asarray(setup["e_coef"]),
        inv_det_s=jnp.asarray(setup["inv_det_s"]))
    comp_t = tdf.shade_row_table_compact(
        *_args(bt), _t(setup["e_coef"]), _t(setup["inv_det_s"]),
        batch_refl=bt.refl)
    assert comp_t.shape[1] == tdf.SH_C_RFL.stop == 53
    np.testing.assert_array_equal(to_np(comp_t), np.asarray(comp_r))
    ids = stages["ids"]
    rows = tdf.gather_winner_rows(comp_t, _t(ids))
    full_t = tdf.expand_rows_compact(rows, st.state_i, st.state_f,
                                     st.tex_hw)
    full_r = jdf.expand_rows_compact(jnp.asarray(to_np(rows)), sc.state_i,
                                     sc.state_f, sc.tex_hw)
    assert full_t.shape[0] == 74
    np.testing.assert_array_equal(to_np(full_t), np.asarray(full_r))


@pytest.mark.parametrize("want_ws", [False, True])
def test_quant_rows_with_refl(stages, want_ws):
    b, bt, sc, st = (stages["st"]["batch"], stages["batch_t"],
                     stages["st"]["scene"], stages["scene_t"])
    ivd = stages["setup"]["inv_det_s"]
    q_r = jdf.shade_row_table_quant(*_args(b), batch_refl=b.refl,
                                    inv_det_s=jnp.asarray(ivd),
                                    want_ws=want_ws)
    q_t = tdf.shade_row_table_quant(*_args(bt), batch_refl=bt.refl,
                                    inv_det_s=_t(ivd), want_ws=want_ws)
    assert q_t.dtype == torch.int32 and q_t.shape[1] == (28 if want_ws
                                                         else 24)
    np.testing.assert_array_equal(to_np(q_t), np.asarray(q_r))
    ids = stages["ids"]
    rows_t = tdf.gather_winner_rows(q_t, _t(ids))
    full_t = tdf.expand_rows_quant(rows_t, st.state_i, st.state_f,
                                   st.tex_hw, want_ws=want_ws, has_refl=True)
    full_r = jdf.expand_rows_quant(jnp.asarray(to_np(rows_t)), sc.state_i,
                                   sc.state_f, sc.tex_hw, want_ws=want_ws,
                                   has_refl=True)
    assert full_t.shape[0] == 74
    np.testing.assert_array_equal(to_np(full_t), np.asarray(full_r))
    # The reflection words land in SH_RFL as the corners' vectors.
    hit = ids >= 0
    want = np.asarray(b.refl).reshape(-1, 9)[np.clip(ids, 0, None)]
    got = to_np(full_t[tdf.SH_RFL]).transpose(1, 2, 0)
    np.testing.assert_array_equal(got[hit], want[hit])

    # One shade per pixel from these rows, the winner's edge values given.
    setup = stages["setup"]
    h, w = ids.shape
    py, px = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                         np.arange(w, dtype=np.float32) + 0.5, indexing="ij")
    ec = setup["e_coef"][np.clip(ids, 0, None)]
    epl = [np.where(hit, ec[..., k, 0] * px + ec[..., k, 1] * py
                    + ec[..., k, 2], 0).astype(np.float32) for k in range(3)]
    sp = stages["packed"][3]["sampler_profile"]
    clear = np.full((4, h, w), 0.25, np.float32)
    fb_r = jdf.shade_rows(full_r, jnp.asarray(hit), sc.tex_planes, sc.tex_hw,
                          sc.fog_color, jnp.asarray(clear), h, w,
                          sampler_profile=sp, tex_quad=sc.tex_quad,
                          eplanes=tuple(jnp.asarray(e) for e in epl))
    fb_t = tdf.shade_rows(full_t, _t(hit), st.tex_planes, st.tex_hw,
                          st.fog_color, _t(clear), h, w, sampler_profile=sp,
                          tex_quad=st.tex_quad,
                          eplanes=tuple(_t(e) for e in epl))
    _close(fb_t, fb_r)


def _ordered(stages):
    st = stages["st"]
    b, sc = st["batch"], st["scene"]
    transparent = np.asarray(sc.state_i)[np.asarray(b.state_idx),
                                         SI_ALPHABLEND] != 0
    cap = stages["rj"]._compiled.ordered_cap
    ob = jfr.ordered_subset(b, st["defer"], jnp.asarray(transparent), cap)
    assert ob.refl.shape[1:] == (3, 3)
    return ob, convert.batch_from_reference(ob._replace(planar=None))


def test_peel_composite_with_refl(stages):
    ob, obt = _ordered(stages)
    sc, st = stages["st"]["scene"], stages["scene_t"]
    h, w = stages["ids"].shape
    rng = np.random.default_rng(5)
    fb = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    zb = np.ones((h, w), np.float32)
    lids, les, bad = co.ordered_peel_tiled_cuda(
        obt.xyw, obt.z, obt.valid, obt.color, obt.specular, obt.uv, obt.fog,
        obt.state_idx, obt.clip_rect, obt.clipd, st.state_i, st.state_f,
        _t(zb), st.viewport, h, w)
    assert not bool(bad) and (lids[0] >= 0).sum() > 100
    sp = stages["packed"][3]["sampler_profile"]
    fb_r = jfr._composite_peeled(jnp.asarray(fb), ob, jnp.asarray(to_np(lids)),
                                 jnp.asarray(to_np(les)), sc, sp, h, w)
    fb_t = tfr._composite_peeled(_t(fb), obt, lids, les, st, sp, h, w)
    _close(fb_t, fb_r)


@pytest.mark.parametrize("tiled", [False, True])
def test_exact_ordered_pass_with_refl(stages, tiled):
    ob, obt = _ordered(stages)
    sc, st = stages["st"]["scene"], stages["scene_t"]
    h, w = stages["ids"].shape
    rng = np.random.default_rng(6)
    fb = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    zb = np.ones((h, w), np.float32)
    sp = stages["packed"][3]["sampler_profile"]
    args_r = (sc.state_i, sc.state_f, sc.tex_planes, sc.tex_hw,
              sc.fog_color, sc.viewport)
    args_t = (st.state_i, st.state_f, st.tex_planes, st.tex_hw,
              st.fog_color, st.viewport)
    fr_, _zr = jrb.render_pass(jnp.asarray(fb), jnp.asarray(zb), ob,
                               *args_r, chunk=1, sampler_profile=sp)
    ft, _zt = trb.render_pass(_t(fb), _t(zb), obt, *args_t,
                              sampler_profile=sp)
    assert (to_np(ft) != fb).any(0).sum() > 100
    _close(ft, fr_)
    if tiled:
        # The tiled pass composites each pixel's triangles in the same
        # order with the same arithmetic: the flat pass's frame, bit for
        # bit.
        fg, _zg = trb.render_pass_tiled(_t(fb), _t(zb), obt, *args_t,
                                        tile=32, sampler_profile=sp)
        np.testing.assert_array_equal(to_np(fg), to_np(ft))


def _faces(s=16):
    out = []
    for fi in range(6):
        img = np.zeros((s, s, 4), np.float32)
        img[..., :3] = FACE_COLORS[fi]
        img[..., 3] = 1.0
        out.append(img)
    return out


def test_octahedral_bake_equals_reference():
    import ckrenderengine_tpu.objects as J
    import ckrenderengine_tpu_torch.objects as O

    imgs = []
    for M, kw in ((J, {}), (O, dict(device="cpu"))):
        tex = M.CKTexture(M.CKContext(**kw), "env")
        tex.SetCubeMapFaces(_faces(), size=64)
        imgs.append(np.asarray(tex.current_image()))
    np.testing.assert_array_equal(imgs[1], imgs[0])


def _mirror(O, tilted: bool, **ctx_kw):
    """tests/test_cubemap.py's mirror quads: tilted 45 degrees about y
    (reflecting the view toward +x), or flat facing the camera (every
    reflection near -z: the octahedral atlas's corners, across its
    fold)."""
    from ckrenderengine_tpu.objects.material import VXEFFECT_TEXGEN
    from ckrenderengine_tpu.raster.types import TEXGEN_CUBE

    ctx = O.CKContext(**ctx_kw)
    mesh = O.CKMesh(ctx, "q")
    s = 0.7
    pos = ([[-s, -1, -s], [s, -1, s], [s, 1, s], [-s, 1, -s]] if tilted
           else [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]])
    mesh.SetPositions(np.array(pos, np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.SetUVs(np.zeros((4, 2), np.float32))
    mesh.BuildNormals()
    tex = O.CKTexture(ctx, "env")
    tex.SetCubeMapFaces(_faces(), size=64)
    mat = O.CKMaterial(ctx, "mirror")
    mat.SetEmissive((1, 1, 1, 1))
    mat.SetTexture(tex)
    mat.SetEffect(VXEFFECT_TEXGEN)
    mat.SetEffectParameter(texgen=TEXGEN_CUBE)
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, "o")
    obj.SetCurrentMesh(mesh)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -4))
    rc.AttachViewpointToCamera(cam)
    return ctx, rc, None


@pytest.mark.parametrize("tilted", [True, False], ids=["mirror", "fold"])
def test_cubemap_scenes_match_reference(tilted):
    pair = render_both(lambda O, **kw: _mirror(O, tilted, **kw),
                       accelerator=False)
    check_render(pair)
    _rj, rt, _p, _r = pair
    assert rt._compiled.want_cube
    fb = rt.framebuffer()
    if tilted:
        np.testing.assert_allclose(fb[32, 32, :3], FACE_COLORS[0],
                                   atol=0.15)
        return
    covered = fb[..., :3].sum(-1) > 0.05
    assert covered.mean() > 0.8
    err = np.abs(fb[..., :3] - np.asarray(FACE_COLORS[5])).sum(-1)
    assert (err[covered] < 0.3).mean() > 0.95
