"""Skinning and device-bound animation in the port, on the CPU.

- ``bone_matrices``, ``build_skin_bank`` (weight normalisation, padding)
  and ``apply_skin`` on a random bank with K = 4 and pad rows, through the
  ``ranges`` path and the row-copy path, against the reference package:
  bone matrices and skinned vertices within 1e-5*(1 + |x|) per element;
  the host-built bank bit for bit.
- Render() with a bound clip against the same clip evaluated on the host
  (the port's analogue of the reference's
  tests/test_animation.py TestDeviceBoundAnimation), key edits while bound,
  ``UnbindAnimation`` and ``SyncToHost``.
- The frame's skin stage against the skin's host ``CalcPointsEx``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ckrenderengine_tpu.pipeline import skinning as jsk
import ckrenderengine_tpu_torch.anim as TA
import ckrenderengine_tpu_torch.objects as T
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.objects import classreg
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.pipeline import skinning as tsk
from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE
from tests._torch_common import to_np
from tests.test_torch_anim import _local, assert_close


def _descriptors(rng):
    """Two skins: 13 vertices on 3 bones with up to 6 influences (cut to
    K = 4), and 7 vertices on 2 bones with unnormalized weights and one
    all-zero row; pool offsets leave rows between and after them."""
    skins = []
    for v, nb, kk, off, obj in ((13, 3, 6, 5, 0), (7, 2, 2, 30, 4)):
        w = rng.uniform(0.0, 2.0, (v, kk)).astype(np.float32)
        w[0] = 0.0
        skins.append(dict(
            pool_offset=off,
            rest_pos=rng.normal(size=(v, 3)).astype(np.float32),
            rest_nrm=rng.normal(size=(v, 3)).astype(np.float32),
            bone_idx=rng.integers(0, nb, (v, kk)).astype(np.int32),
            bone_w=w, bone_rows=rng.integers(1, 8, nb).astype(np.int32),
            obj_row=obj,
            pre=np.stack([_local(rng) for _ in range(nb)])))
    return skins


@pytest.fixture(scope="module")
def skin_case():
    rng = np.random.default_rng(21)
    skins = _descriptors(rng)
    world = np.stack([_local(rng) for _ in range(8)])
    pool = rng.normal(size=(40, 3)).astype(np.float32)
    pool_n = rng.normal(size=(40, 3)).astype(np.float32)
    return skins, world, pool, pool_n


def test_build_skin_bank_matches_reference(skin_case):
    skins = skin_case[0]
    bj = jsk.build_skin_bank(skins)
    bt = tsk.build_skin_bank(skins, device="cpu")
    for f in tsk.SkinBank._fields:
        np.testing.assert_array_equal(to_np(getattr(bt, f)),
                                      np.asarray(getattr(bj, f)), f)
    w = to_np(bt.bone_w)
    valid = to_np(bt.valid)
    assert valid.sum() == 20 and w.shape == (24, 4)     # padded to 8
    # Rows sum to 1 except the all-zero ones and the pads.
    s = w.sum(1)
    live = valid & (s > 0)
    np.testing.assert_allclose(s[live], 1.0, atol=1e-6)
    assert (s[~valid] == 0).all()
    assert tsk.build_skin_bank([], device="cpu") is None


def test_bone_matrices_match_reference(skin_case):
    skins, world = skin_case[:2]
    bj = jsk.build_skin_bank(skins)
    bt = tsk.build_skin_bank(skins, device="cpu")
    assert_close(tsk.bone_matrices(torch.as_tensor(world), bt),
                 np.asarray(jsk.bone_matrices(jnp.asarray(world), bj)))


@pytest.mark.parametrize("use_ranges", [True, False],
                         ids=["ranges", "row_copy"])
def test_apply_skin_matches_reference(skin_case, use_ranges):
    skins, world, pool, pool_n = skin_case
    bj = jsk.build_skin_bank(skins)
    bt = convert.skin_bank_from_reference(bj, "cpu")
    ranges = ((0, 5, 13), (13, 30, 7)) if use_ranges else ()
    pt, nt = torch.as_tensor(pool), torch.as_tensor(pool_n)
    got = tsk.apply_skin(torch.as_tensor(world), pt, nt, bt, ranges=ranges)
    ref = jsk.apply_skin(jnp.asarray(world), jnp.asarray(pool),
                         jnp.asarray(pool_n), bj, ranges=ranges)
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r))
    # The rest pool given is left as it was; unskinned rows are copied.
    np.testing.assert_array_equal(to_np(pt), pool)
    keep = np.ones(40, bool)
    keep[5:18] = keep[30:37] = False
    np.testing.assert_array_equal(to_np(got[0])[keep], pool[keep])


def _clip_scene():
    """One triangle moved by a 2-key position clip (64x64)."""
    ctx = T.CKContext(device="cpu")
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = T.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -6))
    rc.AttachViewpointToCamera(cam)
    mesh = T.CKMesh(ctx, "tri")
    mesh.SetPositions(np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 2, 1]], np.int32))
    mesh.BuildNormals()
    mat = T.CKMaterial(ctx, "m")
    mat.SetEmissive((1, 0.5, 0.2, 1))
    mesh.ApplyGlobalMaterial(mat)
    obj = T.CK3dObject(ctx, "o")
    obj.SetCurrentMesh(mesh)
    clip = TA.CKKeyedAnimation(ctx, "clip")
    oa = TA.CKObjectAnimation(ctx, "oa")
    oa.Set3dEntity(obj)
    pc = oa.CreateController(TA.CKANIMATION_LINEAR_POS)
    pc.AddKey(0.0, (0, 0, 0))
    pc.AddKey(10.0, (1.5, 0, 0))
    clip.AddAnimation(oa)
    return ctx, rc, obj, clip


def test_bound_clip_matches_host_render():
    _ctx, rc, _obj, clip = _clip_scene()
    host = []
    for t in (0.0, 3.0, 7.0):
        clip.SetFrame(t)
        rc.Render()
        host.append(rc.framebuffer().copy())
    assert rc.BindAnimation(clip)
    assert rc.GetBoundAnimation() is clip
    dev = []
    for t in (0.0, 3.0, 7.0):
        clip.SetFrame(t)
        rc.Render()
        dev.append(rc.framebuffer().copy())
    for h, d in zip(host, dev):
        assert np.abs(h - d).mean() < 1e-3
    assert np.abs(dev[0] - dev[2]).mean() > 1e-3      # really animates
    # The bound frame took its world matrices from the animate stage.
    params = rc._fill_packed([], [])[3]
    assert params["world_in"] is not None


def test_key_edit_while_bound_rebuilds_bank():
    _ctx, rc, _obj, clip = _clip_scene()
    assert rc.BindAnimation(clip)
    clip.SetFrame(10.0)
    rc.Render()
    before = rc.framebuffer().copy()
    bank = clip.bank(n_entities=rc.context.entity_table.count, device="cpu")
    clip.animations[0].position_controller.AddKey(10.0, (-1.5, 0, 0))
    rc.Render()
    after = rc.framebuffer().copy()
    assert np.abs(before - after).mean() > 1e-3
    assert clip.bank(n_entities=rc.context.entity_table.count,
                     device="cpu") is not bank


def test_unbind_and_sync_to_host():
    _ctx, rc, obj, clip = _clip_scene()
    assert rc.BindAnimation(clip)
    clip.SetFrame(5.0)
    np.testing.assert_allclose(obj.GetPosition()[0], 0.0, atol=1e-6)
    clip.SyncToHost()
    np.testing.assert_allclose(obj.GetPosition()[0], 0.75, atol=1e-5)
    clip.SetFrame(10.0)            # the host stays stale while bound
    np.testing.assert_allclose(obj.GetPosition()[0], 0.75, atol=1e-5)
    rc.UnbindAnimation()
    np.testing.assert_allclose(obj.GetPosition()[0], 1.5, atol=1e-5)
    assert rc.GetBoundAnimation() is None
    rc.Render()
    assert rc._fill_packed([], [])[3]["world_in"] is None


def test_morph_member_is_not_bound():
    ctx, rc, _obj, clip = _clip_scene()
    ent = T.CK3dObject(ctx, "morphed")
    mesh = T.CKMesh(ctx, "m2")
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    mesh.SetPositions(base)
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    ent.SetCurrentMesh(mesh)
    oa = TA.CKObjectAnimation(ctx, "morph")
    oa.Set3dEntity(ent)
    mc = oa.CreateMorphController(3)
    mc.AddKey(0.0, base)
    mc.AddKey(10.0, base + 1.0)
    clip.AddAnimation(oa)
    assert not rc.BindAnimation(clip)


def test_skin_stage_matches_host_calc_points():
    """The frame's animate, compose and skin stages on a small config-4
    tube against the skin's host CalcPointsEx at the synced pose."""
    _ctx, rc, _tick = scenes.build_config4_skin(
        T, width=96, height=73, n_bones=6, rings_per_bone=2, ring_verts=8,
        device="cpu")
    clip = rc.GetBoundAnimation()
    clip.SetFrame(13.5)
    rc.Render()
    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    c = rc._compiled
    (vo, po, v), = c.skin_ranges
    pos, nrm = tsk.apply_skin(params["world_in"], static["positions"],
                              static["normals"], c.skin_bank,
                              ranges=c.skin_ranges)
    clip.SyncToHost()
    skin = rc.context.GetObjectByName("snake").GetSkin()
    hp, hn = skin.CalcPointsEx()
    assert_close(pos[po:po + v], hp)
    assert_close(nrm[po:po + v], hn)
    # World matrices of the animate + compose stage against the host's.
    n = rc.context.entity_table.count
    world = np.stack([rc.context.GetObjectByName(f"bone{i}").GetWorldMatrix()
                      for i in range(6)])
    rows = [rc.context.GetObjectByName(f"bone{i}").row for i in range(6)]
    assert_close(to_np(params["world_in"])[rows], world)
    assert params["world_in"].shape[0] == n


def test_port_queue_and_unported_classes():
    assert 5 not in PORT_QUEUE
    desc = classreg.CKGetClassDesc(T.base.CKCID_KINEMATICCHAIN)
    assert desc is not None and desc.name == "Kinematic Chain"
    ctx = T.CKContext(device="cpu")
    chain = ctx.CreateObjectByClassID(T.base.CKCID_KINEMATICCHAIN, "chain")
    assert chain.GetClassID() == T.base.CKCID_KINEMATICCHAIN
    parent = T.CK3dObject(ctx, "upper")
    child = T.CK3dObject(ctx, "lower")
    child.SetParent(parent)
    child.SetPosition((0, 0, 1), ref=parent)
    chain.SetStartEffector(parent)
    chain.SetEndEffector(child)
    assert chain.IKSetEffectorPos((0.0, 0.6, 0.8))
    for cid in (T.base.CKCID_KEYEDANIMATION, T.base.CKCID_OBJECTANIMATION,
                T.base.CKCID_CHARACTER, T.base.CKCID_BODYPART):
        obj = ctx.CreateObjectByClassID(cid, f"o{cid}")
        assert obj.GetClassID() == cid
    assert classreg.CKIsChildClassOf(T.base.CKCID_BODYPART,
                                     T.base.CKCID_3DENTITY)


def test_eval_anim_world_is_animate_then_compose():
    """eval_anim_world equals apply_bank followed by compose_world, and the
    frame given the bank itself (``anim=``) renders the frame the bound
    clip's ``world_in`` renders."""
    _ctx, rc, _tick = scenes.build_config4_skin(
        T, width=96, height=73, n_bones=6, rings_per_bone=2, ring_verts=8,
        device="cpu")
    rc.GetBoundAnimation().SetFrame(21.0)
    rc.Render()
    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    fb0, zb0 = tfr.render_frame_packed(static, torch.as_tensor(dyn_f),
                                       torch.as_tensor(dyn_i), **params)
    clip = rc.GetBoundAnimation()
    n = rc.context.entity_table.count
    bank = clip.bank(n_entities=n, device="cpu")
    local = torch.as_tensor(rc.context.entity_table.local[:n])
    from ckrenderengine_tpu_torch.anim.bank import apply_bank
    from ckrenderengine_tpu_torch.scene.entity_table import compose_world
    want = compose_world(apply_bank(local, bank, 21.0), static["parent"],
                         params["levels"])
    assert torch.equal(params["world_in"], want)
    # The same frame through the frame's own animate stage.
    layout = params["layout"]
    d = tfr.unpack(torch.as_tensor(dyn_f), torch.as_tensor(dyn_i), layout)
    assert torch.equal(d["local"], local)
    scene, _d = tfr.unpack_scene(static, torch.as_tensor(dyn_f),
                                 torch.as_tensor(dyn_i), layout)
    p = {k: v for k, v in params.items()
         if k not in ("layout", "world_in", "ss", "texdev", "texdev_rects",
                      "sprites_static", "anim")}
    fb1, zb1 = tfr.render_frame_full_impl(scene, anim=bank, anim_t=21.0,
                                          **p)
    assert torch.equal(fb0, fb1) and torch.equal(zb0, zb1)
