"""The multi-device dry run: the port's counterpart of the reference's
``dryrun_multichip`` (``__graft_entry__.py:142-315``).

On an n-entry mesh it runs each sharded path once on the flagship scene
(a lit cube, a textured floor, two lights, fog and a skinned arm whose bone
a clip turns) at 64x64, holds each against the same frame on one device,
and prints one ``path ok`` line per path:

- the full step (animate -> compose -> skin -> render) of n contexts at n
  clip times, ``context_batch.render_frames_full_sharded``;
- the packed batch of 64 // n * n contexts,
  ``context_batch.render_frames_packed_sharded``;
- one context's frame in n bands, ``CKRenderContext.SetTileSharding``.

The reference allows a few f32 ULPs between its sharded and single-device
programs (XLA fuses them differently); here every path runs the same
operations in the same order, so each must be equal bit for bit.

Run it as ``python3 -m ckrenderengine_tpu_torch.parallel.dryrun [n]`` from
the repository's root.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def build_flagship_scene(device, width: int = 64, height: int = 64):
    """The reference's flagship scene (``__graft_entry__.py:19-126``)
    through this package on ``device``. Returns (render context, anim bank
    of the arm's clip)."""
    from .. import objects as O
    from ..anim import (
        CKANIMATION_LINEAR_ROT, CKObjectAnimation, build_anim_bank,
    )
    from ..raster.types import VXLIGHT

    ctx = O.CKContext(device=device)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 1.0, -4.0))
    cam.SetFrontPlane(0.1)
    cam.SetBackPlane(100.0)
    rc.AttachViewpointToCamera(cam)

    s = 0.5
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32)
    faces = np.array([
        [0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
        [2, 6, 7], [2, 7, 3], [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5],
    ], np.int32)
    cube_mesh = O.CKMesh(ctx, "cube")
    cube_mesh.SetPositions(verts)
    cube_mesh.SetFaces(faces)
    cube_mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "cubemat")
    mat.SetDiffuse((0.9, 0.4, 0.2, 1.0))
    cube_mesh.ApplyGlobalMaterial(mat)
    O.CK3dObject(ctx, "cube").SetCurrentMesh(cube_mesh)

    quad_mesh = O.CKMesh(ctx, "floor")
    quad_mesh.SetPositions(np.array(
        [[-3, -0.5, -3], [3, -0.5, -3], [3, -0.5, 3], [-3, -0.5, 3]],
        np.float32))
    quad_mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    quad_mesh.SetUVs(np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32))
    quad_mesh.BuildNormals()
    tex = O.CKTexture(ctx, "checker")
    img = np.indices((8, 8)).sum(0) % 2
    tex.SetImage(np.stack([img, img, img, np.ones_like(img)],
                          -1).astype(np.float32))
    fmat = O.CKMaterial(ctx, "floormat")
    fmat.SetTexture(tex)
    quad_mesh.ApplyGlobalMaterial(fmat)
    O.CK3dObject(ctx, "floor").SetCurrentMesh(quad_mesh)

    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.3, -1.0, 0.5))
    bulb = O.CKLight(ctx, "bulb")
    bulb.SetType(int(VXLIGHT.POINT))
    bulb.SetPosition((1.0, 2.0, -1.0))

    # The skinned arm, whose second bone the clip turns.
    arm = O.CK3dObject(ctx, "arm")
    arm_mesh = O.CKMesh(ctx, "armmesh")
    apos = np.array([[c * 0.4, r * 0.3 - 1.0, 1.0] for r in (0, 1)
                     for c in range(4)], np.float32)
    afaces = []
    for c in range(3):
        afaces += [[c, c + 5, c + 1], [c, c + 4, c + 5]]
    arm_mesh.SetPositions(apos)
    arm_mesh.SetFaces(np.asarray(afaces, np.int32))
    arm_mesh.BuildNormals()
    amat = O.CKMaterial(ctx, "armmat")
    amat.SetDiffuse((0.2, 0.8, 0.3, 1.0))
    arm_mesh.ApplyGlobalMaterial(amat)
    arm.SetCurrentMesh(arm_mesh)
    b0 = O.CK3dObject(ctx, "bone0")
    b1 = O.CK3dObject(ctx, "bone1")
    b1.SetPosition((0.8, -1.0, 1.0))
    skin = arm.CreateSkin()
    skin.SetBoneCount(2)
    for i, b in enumerate((b0, b1)):
        bd = skin.GetBoneData(i)
        bd.SetBone(b)
        bd.SetBoneInitialInverseMatrix(np.linalg.inv(b.GetWorldMatrix()))
    skin.SetRestPose(apos, arm_mesh.normals)
    for v in range(8):
        skin.SetVertexWeights(v, [0 if (v % 4) < 2 else 1], [1.0])

    oa = CKObjectAnimation(ctx, "wave")
    oa.Set3dEntity(b1)
    rot = oa.CreateController(CKANIMATION_LINEAR_ROT)
    rot.AddKey(0.0, np.array([0, 0, 0, 1], np.float32))
    rot.AddKey(10.0, np.array([0, 0, np.sin(0.4), np.cos(0.4)], np.float32))
    bank = build_anim_bank([oa], [b1.row], device=ctx.device)

    rc.SetFogMode(3)
    rc.SetFogStart(2.0)
    rc.SetFogEnd(50.0)
    return rc, bank


def _same(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.shape == b.shape and torch.equal(a.cpu(), b.cpu())):
        raise AssertionError(f"{name}: the sharded frame differs from the "
                             "single-device frame")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the full, packed and band paths once each on an ``n_devices``
    mesh of ``devices`` (default: the first n cards where there are cards,
    else n entries of the CPU; a list may repeat one device), each against
    the single-device frame bit for bit, printing one ``path ok`` line per
    path. Raises on the first path that fails."""
    from ..pipeline import frame as fr
    from . import context_batch as cb
    from .mesh import DeviceMesh

    if devices is None:
        mesh = cb.make_context_mesh(n_devices)
    else:
        mesh = DeviceMesh(list(devices)[:n_devices], "ctx")
        if mesh.size < n_devices:
            raise ValueError(f"need {n_devices} devices, have {mesh.size}")
    names = ",".join(str(d) for d in mesh.devices)
    rc, bank = build_flagship_scene(mesh.devices[0])
    rc.Render()
    c = rc._compiled
    rc._frame_flags = rc.ResolveRenderFlags(0)
    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    dev = rc.context.device
    scene, _d = fr.unpack_scene(static, torch.as_tensor(dyn_f, device=dev),
                                torch.as_tensor(dyn_i, device=dev),
                                params["layout"])
    h, w, levels = rc.height, rc.width, params["levels"]

    # The full step: n contexts at n clip times; context 0 at time 0.
    scenes = cb.replicate_scene(scene, n_devices)
    anim_t = np.linspace(0.0, 10.0, n_devices).astype(np.float32)
    fb, zb = cb.render_frames_full_sharded(
        scenes, mesh, levels, h, w, skin=c.skin_bank, anim=bank,
        anim_t=[float(t) for t in anim_t], ordered_cap=c.ordered_cap)
    assert fb.shape == (n_devices, 4, h, w) and zb.shape == (n_devices, h, w)
    fb_1, zb_1 = fr.render_frame_full_impl(
        scene, levels, h, w, skin=c.skin_bank, anim=bank, anim_t=0.0,
        ordered_cap=c.ordered_cap, want_texgen=True)[:2]
    _same("full", fb[0], fb_1)
    _same("full zb", zb[0], zb_1)
    print(f"multichip full-sharded path ok ({n_devices}-entry ctx mesh "
          f"[{names}], ctx0 bit-equal to one device)", flush=True)

    # The packed batch: 64 // n * n contexts, context 0 against one frame.
    n_ctx = max(64 // n_devices * n_devices, n_devices)
    dyn_fs = np.broadcast_to(dyn_f, (n_ctx,) + dyn_f.shape).copy()
    dyn_is = np.broadcast_to(dyn_i, (n_ctx,) + dyn_i.shape).copy()
    p1 = {k: v for k, v in params.items() if k != "want_stencil"}
    out = cb.render_frames_packed_sharded(static, dyn_fs, dyn_is, mesh, **p1)
    assert out[0].shape == (n_ctx, 4, h, w)
    ref = fr.render_frame_packed(
        static, torch.as_tensor(dyn_f, device=dev),
        torch.as_tensor(dyn_i, device=dev), **p1)
    _same("packed", out[0][0], ref[0])
    _same("packed", out[0][n_ctx - 1], ref[0])
    print(f"multichip packed-sharded path ok ({n_ctx} ctx on "
          f"{n_devices}-entry mesh [{names}], bit-equal to one device)",
          flush=True)

    # One context's frame in n bands.
    rc.Render()
    fb_whole, zb_whole = rc.fb.clone(), rc.zb.clone()
    if not rc.SetTileSharding(n_devices, devices=mesh.devices):
        raise AssertionError(f"{n_devices} bands refused at height {h}")
    rc.Render()
    _same("band", rc.fb, fb_whole)
    _same("band zb", rc.zb, zb_whole)
    rc.SetTileSharding(0)
    print(f"multichip band-sharded path ok ({n_devices}-band framebuffer "
          f"on [{names}], bit-equal to unbanded)", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
