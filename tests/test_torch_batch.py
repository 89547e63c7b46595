"""Context batching on the port (``CKRenderManager.ProcessBatched``), on
the CPU, held against the reference package's ``ProcessBatched`` on the
same scenes (tests/test_context_batching.py, tests/test_antialias.py):

- the one-triangle group (3 contexts at 48x48, a flat frame: B2 on the
  card), the bound-animation group (2 contexts, a live clip) and the
  Antialias group (2 contexts at 32x32, rendered at 64x64): each member
  against the reference's member within the port's bounds
  (``_torch_common.check_render``), and bit-equal to the member's own
  port ``Render()``;
- groups that cannot share one captured frame render through each
  member's ``Render()``: members of another membership (the reference's
  fallback agrees with its own sequential frames there) and a member with
  no-clear flags (the reference's vmapped fallback clears anyway, so that
  case is held to the port's sequential frames only); a vertex-shader
  member renders alone through its Render() while the others batch, and
  members batch by their pixel-shader function, each held to the
  reference's sequential Render() of the same stage;
- the mesh functions of ``parallel.context_batch`` exist and
  ``ProcessBatched(mesh=)`` takes a context mesh (item 12, ported);
- ``SetTileSharding`` refuses more bands than the context's devices and
  bands over a list that names the CPU once per band.

The stacked-scene functions are in tests/test_torch_batch_frames.py, the
batched level and the group's capacity governor in
tests/test_torch_batch_level.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.parallel import context_batch as tcb

from _torch_common import check_render, reference_winners, to_np


def _tri_group(P, n=3, size=48, split=False, **ctx_kw):
    """The reference's one-triangle group (test_context_batching.py:15-34)
    through package ``P``: one two-sided emissive triangle, ``n``
    contexts whose cameras step back by one unit each. ``split``: two
    triangles, the i-th context sees only the i-th (another membership,
    the same stream shapes). Returns (ctx, rm, rcs, objects)."""
    ctx = P.CKContext(**ctx_kw)
    rm = ctx.GetRenderManager()
    mesh = P.CKMesh(ctx, "t")
    mesh.SetPositions(np.array([[-1, -1, 0], [0, 1, 0], [1, -1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "m")
    mat.SetEmissive((1, 0, 0, 1))
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    objs = []
    for k in range(2 if split else 1):
        obj = P.CK3dObject(ctx, f"tri{k}")
        obj.SetCurrentMesh(mesh)
        obj.SetPosition((0.7 * k, 0.2 * k, 0.0))
        objs.append(obj)
    rcs = []
    for i in range(n):
        rc = rm.CreateRenderContext(size, size)
        cam = P.CKCamera(ctx, f"cam{i}")
        cam.SetPosition((0, 0, -3 - i))
        rc.AttachViewpointToCamera(cam)
        if split:
            rc.AddObject(objs[i])
        rcs.append(rc)
    return ctx, rm, rcs, objs


def _aa_group(P, **ctx_kw):
    """The reference's Antialias group (test_antialias.py:76-110): one
    triangle, 2 contexts at 32x32 with Antialias on."""
    ctx = P.CKContext(**ctx_kw)
    rm = ctx.GetRenderManager()
    rm.SetRenderOptions("Antialias", 1)
    mesh = P.CKMesh(ctx, "m")
    mesh.SetPositions(np.array([[-1.0, -0.8, 0.0], [1.1, -0.5, 0.0],
                                [0.2, 1.0, 0.0]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1]], np.int32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "mm")
    mat.SetEmissive((1.0, 1.0, 1.0, 1.0))
    mesh.ApplyGlobalMaterial(mat)
    obj = P.CK3dObject(ctx, "o")
    obj.SetCurrentMesh(mesh)
    rcs = []
    for k in range(2):
        rc = rm.CreateRenderContext(32, 32)
        cam = P.CKCamera(ctx, f"c{k}")
        cam.SetPosition((0.0, 0.0, -2.0 - k))
        rc.AttachViewpointToCamera(cam)
        rcs.append(rc)
    return ctx, rm, rcs, [obj]


def _bind_spin(P, anim, ctx, rcs):
    """The reference's bound clip (test_context_batching.py:92-128): a
    linear rotation of the triangle about y, 1.2 rad over 10 frames, bound
    to every context. Returns the clip."""
    obj = ctx.GetObjectByName("tri0")
    clip = anim.CKKeyedAnimation(ctx, "spin")
    clip.SetLength(10.0)
    oa = anim.CKObjectAnimation(ctx, "oa")
    oa.Set3dEntity(obj)
    ctl = oa.CreateController(anim.CKANIMATION_LINEAR_ROT)
    for t, ang in ((0.0, 0.0), (10.0, 1.2)):
        ctl.AddKey(t, np.array([0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)],
                               np.float32))
    clip.AddAnimation(oa)
    for rc in rcs:
        assert rc.BindAnimation(clip)
    return clip


def _batched(rm, rcs):
    """One ProcessBatched; returns each member's (fb, zb) and asserts the
    group ran as one batch (every member waits on one read)."""
    rm.ProcessBatched()
    reads = {id(rc._batch_read) for rc in rcs}
    assert len(reads) == 1 and rcs[0]._batch_read is not None
    return [(rc.fb.clone(), rc.zb.clone()) for rc in rcs]


def _own_render_equal(rcs, frames):
    """Each member's own Render() (the same scene state) equals its
    batched frame bit for bit."""
    for rc, (fb, zb) in zip(rcs, frames):
        rc.Render()
        assert torch.equal(rc.fb, fb) and torch.equal(rc.zb, zb)


def _reference(rm, rcs):
    """The reference's ProcessBatched of its own group (its governor off,
    as the port's is on the CPU)."""
    for rc in rcs:
        rc._gov_on = False
    rm.ProcessBatched()


def _against_reference(rjs, rts):
    for rj, rt in zip(rjs, rts):
        packed = rj._fill_packed([], [])
        check_render((rj, rt, packed, reference_winners(*packed)))


@pytest.mark.parametrize("group", ["one_triangle", "antialias"])
def test_batch_matches_reference_and_own_render(group):
    build = _tri_group if group == "one_triangle" else _aa_group
    _c, rm_j, rjs, _o = build(J)
    _reference(rm_j, rjs)
    _c, rm_t, rts, _o = build(O, device="cpu")
    frames = _batched(rm_t, rts)
    assert frames[0][0].shape == (4,) + (rts[0].height, rts[0].width)
    _against_reference(rjs, rts)
    # Different cameras, different frames, each with coverage.
    a, b = (to_np(f[0][0]) for f in frames[:2])
    assert (a > 0.5).sum() > 10 and (b > 0.5).sum() > 10
    assert not np.array_equal(a, b)
    _own_render_equal(rts, frames)


def test_batch_with_bound_animation():
    """Each member's clip time rides its own slot; the pose is live: the
    batch at frame 0 differs from the batch at frame 4."""
    from ckrenderengine_tpu import anim as janim
    from ckrenderengine_tpu_torch import anim as tanim

    ctx_j, rm_j, rjs, _o = _tri_group(J, n=2)
    clip_j = _bind_spin(J, janim, ctx_j, rjs)
    ctx_t, rm_t, rts, _o = _tri_group(O, n=2, device="cpu")
    clip_t = _bind_spin(O, tanim, ctx_t, rts)
    clip_j.SetFrame(4.0)
    clip_t.SetFrame(4.0)
    _reference(rm_j, rjs)
    at4 = _batched(rm_t, rts)
    assert rts[0]._anim_req is not None        # the clip ran in the frame
    _against_reference(rjs, rts)
    clip_j.SetFrame(0.0)
    clip_t.SetFrame(0.0)
    _reference(rm_j, rjs)
    at0 = _batched(rm_t, rts)
    _against_reference(rjs, rts)
    assert float((at0[0][0] - at4[0][0]).abs().max()) > 0.05
    _own_render_equal(rts, at0)


def test_other_membership_renders_each_member():
    """Members that see different objects (same stream shapes) cannot
    share one frame: each renders through its Render(), as the
    reference's ProcessBatched renders them (its fallback agrees with its
    own sequential frames here)."""
    _c, rm_j, rjs, _o = _tri_group(J, n=2, split=True)
    _reference(rm_j, rjs)
    _c, rm_t, rts, _o = _tri_group(O, n=2, split=True, device="cpu")
    assert not rm_t._batch_packed(rts)
    rm_t.ProcessBatched()
    assert all(rc._batch_read is None for rc in rts)
    _against_reference(rjs, rts)
    frames = [(rc.fb.clone(), rc.zb.clone()) for rc in rts]
    _own_render_equal(rts, frames)


def test_no_clear_member_renders_each_member():
    """A member that accumulates (no-clear flags) keeps the group out of
    the batch: both members render through Render(), so the accumulating
    one keeps its previous frame under the new one, as sequential Render()
    does (the reference's vmapped fallback clears it: not compared)."""

    def run(batched):
        _c, rm, rcs, objs = _tri_group(O, n=2, device="cpu")
        rcs[1].SetClearBackground(False)
        rcs[1].SetBackgroundColor((0.2, 0.3, 0.4, 1.0))
        out = []
        for pos in ((0.0, 0.0, 0.0), (0.5, 0.3, 0.0)):
            objs[0].SetPosition(pos)
            if batched:
                assert not rm._batch_packed(rcs)
                rm.ProcessBatched()
            else:
                for rc in rcs:
                    rc.Render()
            out.append([rc.fb.clone() for rc in rcs])
        return out

    seq, bat = run(False), run(True)
    for a, b in zip(seq, bat):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # The accumulating member keeps the first frame's triangle.
    assert not torch.equal(seq[1][1], seq[1][0])


def _shift(xp):
    def shift_up(posw, nrmw, scene):
        return posw + xp.asarray([0.0, 0.4, 0.0]), nrmw
    return shift_up


def _tint(xp, k):
    def tint(inp):
        c = inp["color"] * inp["texel"]
        return xp.stack([c[..., 0], c[..., 1] * k, c[..., 2] * k,
                         c[..., 3]], -1)
    return tint


def test_vertex_shader_member_renders_alone():
    """A vertex-shader member is left out of the batch (the reference's
    batch refuses it too) and renders through its own Render(), with its
    shader; the other members still batch. Held to the reference's
    sequential Render() of the same member (its ProcessBatched would drop
    the shader in its vmapped fallback)."""
    _c, rm_j, rjs, _o = _tri_group(J, n=3)
    rjs[1].SetVertexShader(_shift(jnp))
    for rc in rjs:
        rc._gov_on = False
        rc.Render()
    _c, rm, rcs, _o = _tri_group(O, n=3, device="cpu")
    rcs[1].SetVertexShader(_shift(torch))
    assert not rm._batch_packed(rcs)
    rm.ProcessBatched()
    assert rcs[1]._batch_read is None
    assert rcs[0]._batch_read is rcs[2]._batch_read is not None
    frames = [(rc.fb.clone(), rc.zb.clone()) for rc in rcs]
    _against_reference(rjs, rcs)
    _own_render_equal(rcs, frames)
    # The shader moved the member's triangle.
    rcs[1].SetVertexShader(None)
    rcs[1].Render()
    assert not torch.equal(rcs[1].fb, frames[1][0])


def test_pixel_shader_members_batch_by_stage():
    """Members that share one pixel-shader function batch together (the
    graph bakes the stage in, keyed by identity); a member with another
    stage forms its own sub-group. Each member equals its own Render()
    and the reference's sequential Render() of the same stage."""
    stages = {P: (_tint(xp, 0.25), _tint(xp, 0.75))
              for P, xp in ((J, jnp), (O, torch))}
    _c, rm_j, rjs, _o = _tri_group(J, n=3)
    _c, rm, rcs, _o = _tri_group(O, n=3, device="cpu")
    for P, group in ((J, rjs), (O, rcs)):
        a, b = stages[P]
        for rc, fn in zip(group, (a, a, b)):
            rc.SetPixelShader(fn)
    for rc in rjs:
        rc._gov_on = False
        rc.Render()
    subs = []
    run = rm._run_batch
    rm._run_batch = lambda sub, mesh: subs.append(len(sub)) or run(sub, mesh)
    rm.ProcessBatched()
    assert sorted(subs) == [1, 2]
    frames = [(rc.fb.clone(), rc.zb.clone()) for rc in rcs]
    _against_reference(rjs, rcs)
    _own_render_equal(rcs, frames)


def test_mesh_and_tile_sharding_are_item_12():
    """Item 12 of the port queue, ported: the context-mesh functions and
    ``ProcessBatched(mesh=)`` take a ``parallel.mesh.DeviceMesh`` (a
    non-mesh raises ``TypeError``), and ``SetTileSharding`` bands a
    context over its devices (tests/test_torch_bands.py and
    tests/test_torch_context_mesh.py hold the frames)."""
    from ckrenderengine_tpu_torch import roadmap

    _c, rm, rcs, _o = _tri_group(O, n=2, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        rm.ProcessBatched(mesh=object())
    mesh = tcb.make_context_mesh(2, platform="cpu")
    rm.ProcessBatched(mesh=mesh)
    assert all(rc.fb.shape == (4, 48, 48) for rc in rcs)
    for fn in (tcb.make_context_mesh, tcb.shard_scenes,
               tcb.render_frames_sharded, tcb.render_frames_full_sharded,
               tcb.render_frames_packed_sharded):
        assert callable(fn) and fn.__module__ == tcb.__name__
    assert 12 not in roadmap.PORT_QUEUE
    rc = rcs[0]                                # 48 rows, the CPU: 1 device
    assert rc.SetTileSharding(0) and rc.SetTileSharding(1)
    assert rc.SetTileSharding(2) is False
    assert rc.SetTileSharding(5, devices=["cpu"] * 5) is False   # 48 % 5
    with pytest.raises(ValueError):
        rc.SetTileSharding(2, devices=["card0", "card1"])
    assert rc.GetTileSharding() == 0
    assert rc.SetTileSharding(2, devices=["cpu", "cpu"])
    assert rc.GetTileSharding() == 2
