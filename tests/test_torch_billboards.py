"""3D sprites against the reference package on the CPU.

- ``apply_billboards`` (the per-frame corner stage) on seeded banks: all
  four modes, centre offsets, a view whose 3x3 is not orthonormal (the
  camera axes are normalised), invisible sprites (collapsed to their
  centre) and invalid rows (written to no pool row). Op by op the
  reference rounds exactly as the port does: equal bit for bit. Under
  ``jax.jit`` (as its frame runs it) XLA may contract the multiply-adds,
  so there each coordinate is held to 8 u S, u = 2^-24, S = |centre| +
  |right| (|ox| + w/2) + |up| (|oy| + h/2) in that coordinate (the sum of
  the magnitudes the corner adds up, in float64).
- The ``CKSprite3D`` host API against the reference's: setters and
  getters, the versions each setter bumps, ``FillBatch``,
  ``UpdateOrientation``, ``UpdateBox``, ``GetBoundingBox`` and the class
  registry rows of sprites, curves and curve points.
- A small flat frame of sprites of every mode (one invisible) through both
  packages' ``Render()``.
- The effects level (``scenes.build_config5_fx``) cut to 128x96 with
  alpha-tested tree cards that write z (``alpha_cards``: cutouts, the
  common tree card), rendered eagerly through both packages' ``Render()``.
  The cards leave the opaque solve for the ordered pass, so the frame's
  depth buffer holds their depths: opaque winners as in
  ``check_render`` (>= 99.9% equal, the rest ties); colours within 1/255
  on all but 0.1% of the matching pixels, those on an ill-conditioned
  edge or in ``fx_explained``; depths within the opaque winner's f32 bound
  where neither frame's depth left the opaque solve's, and within 1e-4
  where a card wrote z (the bound tests/test_torch_ordered_frame.py holds
  the cutout scene's z-writing fragments to). At the full size that
  ordered pass takes its exact tiled form, which keeps such a frame out
  of a frame window.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.objects import classreg as jreg
from ckrenderengine_tpu.pipeline import overlay as jov
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.objects import base as tbase
from ckrenderengine_tpu_torch.objects import classreg as treg
from ckrenderengine_tpu_torch.pipeline import overlay as tov
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from tests._torch_common import (
    _FRAME_SLACK, assert_frame_fb_close, assert_winners_own_setup,
    check_render, depth_error_bound, fx_explained, port_frame_ids,
    render_both, to_np,
)

U = 2.0 ** -24


def _bank(seed, s=24, n=6, v=120):
    rng = np.random.default_rng(seed)
    world = np.zeros((n, 4, 4), np.float32)
    for e in range(n):
        world[e, :3, :3] = rng.normal(size=(3, 3)) * rng.uniform(0.5, 2.0)
        world[e, 3, :3] = rng.uniform(-50, 50, 3)
        world[e, 3, 3] = 1.0
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rng.normal(size=(3, 3)) * 1.7      # not orthonormal
    view[3, :3] = rng.uniform(-5, 5, 3)
    positions = rng.uniform(-9, 9, (v, 3)).astype(np.float32)
    bank = dict(
        entity_row=rng.integers(0, n, s).astype(np.int32),
        size=rng.uniform(0.1, 6.0, (s, 2)).astype(np.float32),
        offset=rng.uniform(-2.0, 2.0, (s, 2)).astype(np.float32),
        mode=(np.arange(s) % 4).astype(np.int32),
        pool_base=(4 * rng.permutation(v // 4)[:s]).astype(np.int32),
        valid=rng.uniform(size=s) > 0.2)
    visible = rng.uniform(size=n) > 0.3
    return world, view, positions, bank, visible


def _reference(world, view, positions, bank, visible, jit):
    fn = jax.jit(jov.apply_billboards) if jit else jov.apply_billboards
    return np.asarray(fn(jnp.asarray(world), jnp.asarray(view),
                         jnp.asarray(positions),
                         jov.Sprite3DBank(**{k: jnp.asarray(x)
                                             for k, x in bank.items()}),
                         None if visible is None else jnp.asarray(visible)))


def _port(world, view, positions, bank, visible):
    return tov.apply_billboards(
        torch.as_tensor(world), torch.as_tensor(view),
        torch.as_tensor(positions),
        tov.Sprite3DBank(**{k: torch.as_tensor(x) for k, x in bank.items()}),
        None if visible is None else torch.as_tensor(visible)).numpy()


def _magnitude(world, view, bank):
    """(S, 4, 3) float64: S of each corner coordinate (module docstring)."""
    wm = world.astype(np.float64)[bank["entity_row"]]
    v = view.astype(np.float64)
    cam_r = v[:3, 0] / np.linalg.norm(v[:3, 0])
    cam_u = v[:3, 1] / np.linalg.norm(v[:3, 1])
    mode = bank["mode"][:, None]
    right = np.where(mode == 3, wm[:, 0, :3], cam_r[None])
    up = np.where(mode == 3, wm[:, 1, :3], cam_u[None])
    right = np.where(mode == 2, wm[:, 0, :3], right)
    up = np.where(mode == 1, wm[:, 1, :3], up)
    sx = np.abs(bank["offset"][:, :1]) + bank["size"][:, :1] * 0.5
    sy = np.abs(bank["offset"][:, 1:]) + bank["size"][:, 1:] * 0.5
    s = np.abs(wm[:, 3, :3]) + np.abs(right) * sx + np.abs(up) * sy
    return np.repeat(s[:, None], 4, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_visible", [True, False])
def test_apply_billboards_matches_reference(seed, with_visible):
    world, view, positions, bank, visible = _bank(seed)
    if not with_visible:
        visible = None
    got = _port(world, view, positions, bank, visible)
    eager = _reference(world, view, positions, bank, visible, jit=False)
    np.testing.assert_array_equal(got, eager)
    jitted = _reference(world, view, positions, bank, visible, jit=True)
    rows = (bank["pool_base"][:, None] + np.arange(4)).reshape(-1)
    written = np.zeros(positions.shape[0], bool)
    written[rows.reshape(-1, 4)[bank["valid"]].reshape(-1)] = True
    # Invalid sprites and rows no sprite owns keep the pool's values.
    np.testing.assert_array_equal(got[~written], positions[~written])
    bound = 8 * U * _magnitude(world, view, bank)[bank["valid"]]
    idx = rows.reshape(-1, 4)[bank["valid"]]
    assert np.all(np.abs(got[idx] - jitted[idx]) <= bound)
    if visible is not None:
        # An invisible sprite collapses onto its centre.
        hidden = bank["valid"] & ~visible[bank["entity_row"]]
        assert hidden.any()
        centre = world[bank["entity_row"][hidden], 3, :3]
        np.testing.assert_array_equal(
            got[rows.reshape(-1, 4)[hidden]],
            np.repeat(centre[:, None], 4, 1))


def test_apply_billboards_does_not_write_its_input():
    world, view, positions, bank, visible = _bank(3)
    pos = torch.as_tensor(positions.copy())
    out = tov.apply_billboards(
        torch.as_tensor(world), torch.as_tensor(view), pos,
        tov.Sprite3DBank(**{k: torch.as_tensor(x) for k, x in bank.items()}),
        torch.as_tensor(visible))
    np.testing.assert_array_equal(pos.numpy(), positions)
    assert out.shape == pos.shape and not torch.equal(out, pos)


def test_sprite_modes_and_constants_match_reference():
    for name in ("SPRITE3D_BILLBOARD", "SPRITE3D_XROTATE",
                 "SPRITE3D_YROTATE", "SPRITE3D_ORIENTABLE"):
        assert getattr(tov, name) == getattr(jov, name)
    assert tov.Sprite3DBank._fields == jov.Sprite3DBank._fields
    for m in ("MODE_BILLBOARD", "MODE_XROTATE", "MODE_YROTATE",
              "MODE_ORIENTABLE"):
        assert getattr(O.CKSprite3D, m) == getattr(J.CKSprite3D, m)


def _sprite_world(P, **ctx_kw):
    ctx = P.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 48)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((1.0, 2.0, -9.0))
    rc.AttachViewpointToCamera(cam)
    parent = P.CK3dObject(ctx, "parent")
    parent.SetPosition((0.5, -0.25, 2.0))
    parent.Rotate((0.2, 1.0, 0.1), 0.4)
    sp = P.CKSprite3D(ctx, "sp")
    sp.SetParent(parent)
    sp.SetPosition((1.0, 0.5, -0.5), ref=parent)
    return ctx, rc, cam, sp


def _api_trace(P, **ctx_kw):
    """What the host API returns and bumps, step by step."""
    ctx, rc, cam, sp = _sprite_world(P, **ctx_kw)
    out = []
    mat = P.CKMaterial(ctx, "m")

    def bump(fn):
        t0, d0 = ctx._topology_version, ctx._dynamic_version
        fn()
        return (ctx._topology_version - t0, ctx._dynamic_version - d0)

    out.append(bump(lambda: sp.SetMaterial(mat)))
    out.append(sp.GetMaterial() is mat)
    out.append(bump(lambda: sp.SetMode(P.CKSprite3D.MODE_YROTATE)))
    out.append(sp.GetMode())
    out.append(bump(lambda: sp.SetOffset((0.25, -0.5, 9.0))))
    out.append(sp.GetOffset())
    out.append(bump(lambda: sp.SetUVMapping((0.1, 0.2, 0.7, 0.9, 5.0))))
    out.append(sp.GetUVMapping())
    out.append(bump(lambda: sp.SetSize((2.0, 3.0))))
    out.append(sp.GetSize())
    view = np.asarray(rc._camera_np()[0], np.float32)
    for mode in range(4):
        sp.SetMode(mode)
        out.extend(sp.FillBatch(view))
        out.extend(sp.FillBatch())
    out.extend(sp.UpdateBox())
    out.extend(sp.GetBoundingBox())
    out.extend(sp.GetBoundingBox(local=True))
    for mode in (P.CKSprite3D.MODE_XROTATE, P.CKSprite3D.MODE_YROTATE,
                 P.CKSprite3D.MODE_BILLBOARD, P.CKSprite3D.MODE_ORIENTABLE):
        sp.SetMode(mode)
        sp.UpdateOrientation(rc)
        out.append(sp.GetWorldMatrix())
    sp.UpdateOrientation(None)
    out.append(sp.GetWorldMatrix())
    sp.SetBoundingBox((-1, -2, -3), (1, 2, 3))
    out.extend(sp.UpdateBox())
    out.extend(sp.GetBoundingBox(local=True))
    return out


def test_sprite3d_host_api_matches_reference():
    got = _api_trace(O, device="cpu")
    want = _api_trace(J)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple) or isinstance(w, (bool, int)):
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cid", ["CKCID_SPRITE3D", "CKCID_CURVE",
                                 "CKCID_CURVEPOINT"])
def test_class_registry_rows_match_reference(cid):
    got = treg.CKGetClassDesc(getattr(tbase, cid))
    want = jreg.CKGetClassDesc(getattr(J.base, cid))
    assert got is not None and got.cls.__name__ == want.cls.__name__
    assert (got.class_id, got.name, got.parent_id) == (
        want.class_id, want.name, want.parent_id)
    assert treg.CKIsChildClassOf(got.class_id, tbase.CKCID_3DENTITY)
    ctx = O.CKContext(device="cpu")
    obj = ctx.CreateObjectByClassID(got.class_id, "made")
    assert obj.GetClassID() == got.class_id and isinstance(obj, got.cls)


def test_class_registry_dependencies():
    ctx = O.CKContext(device="cpu")
    sp = O.CKSprite3D(ctx, "sp")
    mat = O.CKMaterial(ctx, "m")
    assert treg.CKGetClassDesc(tbase.CKCID_SPRITE3D).deps(sp) == []
    sp.SetMaterial(mat)
    assert treg.CKGetClassDesc(tbase.CKCID_SPRITE3D).deps(sp) == [
        (mat, tbase.CKCID_MATERIAL)]
    cv = O.CKCurve(ctx, "cv")
    pts = [cv.AddControlPoint((float(i), 0.0, 0.0)) for i in range(3)]
    assert treg.CKGetClassDesc(tbase.CKCID_CURVE).deps(cv) == [
        (p, tbase.CKCID_CURVEPOINT) for p in pts]


def build_sprites(P, width=96, height=73, antialias=False, **ctx_kw):
    """A floor quad and one sprite of each mode (one more that is hidden),
    two of them blended, under a camera looking down at them."""
    from ckrenderengine_tpu_torch.raster.types import VXBLEND
    from ckrenderengine_tpu_torch.scene.entity_table import (
        VX_MOVEABLE_VISIBLE,
    )

    ctx = P.CKContext(**ctx_kw)
    if antialias:
        ctx.GetRenderManager().SetRenderOptions("Antialias", 1)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0.3, 3.0, -8.0))
    cam.SetOrientation((0.0, -0.3, 1.0))
    rc.AttachViewpointToCamera(cam)
    floor = P.CKMesh(ctx, "floor")
    floor.SetPositions(np.array([[-6, -1, -4], [6, -1, -4], [6, -1, 8],
                                 [-6, -1, 8]], np.float32))
    floor.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    floor.BuildNormals()
    fmat = P.CKMaterial(ctx, "fm")
    fmat.SetDiffuse((0.4, 0.5, 0.6, 1.0))
    floor.ApplyGlobalMaterial(fmat)
    P.CK3dObject(ctx, "floor").SetCurrentMesh(floor)
    spinner = P.CK3dObject(ctx, "spin")
    spinner.Rotate((0.0, 1.0, 0.0), 0.7)
    for i in range(5):
        mat = P.CKMaterial(ctx, f"sm{i}")
        mat.SetDiffuse((0.2 + 0.15 * i, 0.9 - 0.1 * i, 0.3, 0.55))
        if i % 2:
            mat.EnableAlphaBlend(True)
            mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
            mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
            mat.EnableZWrite(False)
        sp = P.CKSprite3D(ctx, f"sp{i}")
        sp.SetMaterial(mat)
        sp.SetMode(i % 4)
        sp.SetSize((1.6 + 0.3 * i, 1.2))
        sp.SetOffset((0.1 * i, -0.2))
        sp.SetParent(spinner)
        sp.SetPosition((-3.0 + 1.5 * i, 0.2 * i, 0.5 * i), ref=spinner)
        if i == 4:
            sp.SetMoveableFlags(sp.GetMoveableFlags() & ~VX_MOVEABLE_VISIBLE)
    return ctx, rc, spinner


def test_sprite_frame_matches_reference():
    pair = render_both(build_sprites, accelerator=False)
    rj, rt, _packed, _ref = pair
    assert rt.GetStats().NbTrianglesDrawn == rj.GetStats().NbTrianglesDrawn
    assert rt._compiled.extra_pool == 20 and len(rt._compiled.sprite3d_list) == 5
    check_render(pair)


ALPHA_CARDS = dict(width=128, height=96, terrain_n=24, n_balls=8,
                   n_sprites=96, n_curves=2, curve_steps=12,
                   alpha_cards=True)


def test_alpha_tested_cards_frame_matches_reference():
    pair = render_both(scenes.build_config5_fx, frame_ids=True, **ALPHA_CARDS)
    rj, rt, _packed, (ids_ref, depth_ref, setup) = pair
    cards = [m for m, kind, _b in rt._compiled.materials
             if kind == "sprite" and m.GetName() == "cardmat"]
    assert len(cards) == 1 and cards[0].AlphaTestEnabled()
    assert cards[0].ZWriteEnabled() and not cards[0].AlphaBlendEnabled()
    assert rt.GetStats().NbTrianglesDrawn == rj.GetStats().NbTrianglesDrawn

    st, tf, ti, tp = rt._fill_packed([], [])
    tf, ti = torch.as_tensor(tf), torch.as_tensor(ti)
    # Every sprite's 2 triangles in the ordered pass: 48 halos, 24 sparks,
    # 8 halos on the spheres and 16 alpha-tested cards.
    assert tp["ordered_cap"] >= 2 * 96
    sp = tp["sampler_profile"]
    assert not sp[5] and not sp[6]
    assert tfr.ordered_route(tp["ordered_cap"], 768, 1024, sp,
                             tp["pixel_shader"]) == "tiled"

    ids = to_np(port_frame_ids(rt, st, tf, ti, tp))
    setup_port = {k: to_np(v) for k, v in tfr.packed_setup(
        st, tf, ti, tp)[2].items() if isinstance(v, torch.Tensor)}
    same = ids == ids_ref
    assert same.mean() >= 0.999, same.mean()
    assert_winners_own_setup(ids, ids_ref, setup_port, setup)
    match = same & (rj.frame_ids == ids_ref)
    assert match.mean() >= 0.999, match.mean()
    assert_frame_fb_close(to_np(rt.fb), np.asarray(rj.fb), ids_ref, setup,
                          match, explained=fx_explained(pair))

    zb = to_np(rt.zb).astype(np.float64)
    zb_ref = np.asarray(rj.zb, np.float64)
    bound = 4e-6 + 2 * _FRAME_SLACK * np.nan_to_num(
        depth_error_bound(ids_ref, setup), nan=0.0)
    wrote = ~((np.abs(zb - depth_ref) <= bound)
              & (np.abs(zb_ref - depth_ref) <= bound))
    assert wrote.sum() > 50                    # the cards write z
    dz = np.abs(zb - zb_ref)
    assert np.all(dz[wrote] <= 1e-4), dz[wrote].max()
    assert np.all(dz[~wrote] <= 2 * bound[~wrote])
    assert (ids_ref >= 0).mean() > 0.1


def test_port_queue_has_no_line_or_sprite_item():
    """Items 7 (line pass) and 8 (3D sprites) are carried: no key in
    PORT_QUEUE and no ``unported(..., 7)`` or ``(..., 8)`` in the port."""
    import pathlib
    import re

    import ckrenderengine_tpu_torch
    from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE

    assert 7 not in PORT_QUEUE and 8 not in PORT_QUEUE
    assert 17 not in PORT_QUEUE
    assert not any("curve" in v for v in PORT_QUEUE.values())
    root = pathlib.Path(ckrenderengine_tpu_torch.__file__).parent
    cites = re.compile(r"unported\([^()]*(\([^()]*\)[^()]*)*,\s*[78]\s*\)")
    for path in root.rglob("*.py"):
        assert not cites.search(path.read_text()), path
