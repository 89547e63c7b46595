"""Grids (``CKGrid``, ``CKLayer``, the layer-type registry) and inverse
kinematics (``CKKinematicChain``, ``IKJointData``, ``SVDDecompose``,
``SVDSolve``) on the port against the reference package on the CPU.

Host values of the grid are compared exactly: layers and value arrays,
``SetDimensions``, the three orientation modes, coordinates, the debug
mesh that ``Show`` builds and hiding destroys, and the texels of
``UpdateMeshTexture``. The IK solve factors each iteration's Jacobian with
``torch.linalg.svd`` in the port and ``jnp.linalg.svd`` in the reference:
the two round apart, so the effector and the bone matrices are held to
``IK_ATOL`` = 1e-4 absolute and the return values exactly. Frames: a grid
at 128x96 (its blended quad and wireframe border: the flat ordered pass
and the line pass) within ``_torch_common.ATOL`` of the reference's, and
``scenes.build_config5_debug`` cut to 128x96, its skinned arm posed by the
IK of each package, through ``render_both`` and ``check_render``: each
package holds its own pose and skin stage, so their triangles differ by
rounding and each frame is held to its own setup.
"""

import importlib

import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu.anim import ik as jik
from ckrenderengine_tpu.objects import grid as jgrid
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.anim import ik as tik
from ckrenderengine_tpu_torch.objects import base as OB
from ckrenderengine_tpu_torch.objects import grid as tgrid

from _torch_common import (
    assert_frames_close, check_render, port_frame_ids, render_both,
    render_reference, small_ctx,
)

PACKAGES = (J, O)
IK_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_layer_types():
    """Each package numbers layer types in a process-global registry, and
    other test files on the same worker register types in one of them:
    every case starts both from empty and puts back what was there."""
    saved = [(m, dict(m._layer_type_registry)) for m in (jgrid, tgrid)]
    for m, _ in saved:
        m._layer_type_registry.clear()
    yield
    for m, reg in saved:
        m._layer_type_registry.clear()
        m._layer_type_registry.update(reg)


def _anim(P):
    return importlib.import_module(P.__name__.rpartition(".")[0] + ".anim")


def _grid(P, ctx, name="g", w=8, l=6, seed=5):
    """A grid of w x l squares, moved and turned about an oblique axis,
    with two seeded layers: "floor" (by name) and type 7 (by number)."""
    rng = np.random.default_rng(seed)
    grid = P.CKGrid(ctx, name)
    grid.SetDimensions(w, l, 1.5, 0.75)
    grid.SetPosition((1.0, -0.5, 2.0))
    grid.Rotate((0.3, 1.0, 0.2), 0.4)
    floor = grid.AddLayer("floor")
    floor.SetSquareArray(rng.integers(0, 256, (l, w)))
    zone = grid.AddLayer(7, format=2)
    zone.SetSquareArray(rng.integers(0, 256, (l, w)) * (rng.random((l, w))
                                                        < 0.4))
    floor.SetColor((1.0, 0.3, 0.2, 1.0))
    zone.SetColor((0.2, 0.6, 1.0, 1.0))
    return grid, floor, zone


def _grid_script(P):
    """Every grid and layer call whose result is a host value, in order."""
    ctx = small_ctx(P)
    out = []
    grid, floor, zone = _grid(P, ctx)
    out += [grid.GetClassID(), floor.GetClassID(), grid.GetWidth(),
            grid.GetLength(), grid.square_size, grid.GetLayerCount(),
            grid.IsVisible(), grid.IsActive(), floor.GetType(),
            zone.GetFormat(), zone.GetType(), floor.GetColor(),
            floor.GetGrid() is grid, grid.GetLayer("floor") is floor,
            grid.GetLayer(7) is zone, grid.GetLayerByIndex(1) is zone,
            grid.GetLayer("nothing") is None]
    floor.SetValue(2, 3, 99)
    out += [int(floor.GetValue(2, 3)), floor.SetValue2(8, 0, 1),
            floor.SetValue2(7, 5, 42), floor.GetValue2(-1, 0),
            int(floor.GetValue2(7, 5))]
    zone.SetVisible(False)
    out.append(zone.IsVisible())
    zone.SetVisible(True)
    out.append([tuple(b) for b in grid.UpdateBox()])
    # Coordinates in each orientation mode.
    for mode in (tgrid.CKGRID_XZ, tgrid.CKGRID_XY, tgrid.CKGRID_YZ):
        grid.SetOrientationMode(mode)
        out.append(grid.GetOrientationMode())
        for x, y in ((0, 0), (3, 2), (7, 5)):
            p = grid.GetPositionFromCoordinates(x, y)
            out.append((p.tolist(), grid.GetGridCoordinates(p),
                        grid.IsInGrid(p)))
        out.append(grid.GetGridCoordinates((50.0, 50.0, 50.0)))
    grid.SetOrientationMode(tgrid.CKGRID_XZ)
    # Show builds the debug mesh and texture; texels per layer colours.
    grid.Show(True)
    mesh = grid.GetCurrentMesh()
    out += [grid.IsVisible(), mesh.GetVertexCount(), mesh.GetFaceCount(),
            grid._viz_texture.GetImage().copy()]
    floor.SetColor((0.5, 1.0, 0.0, 1.0))
    out.append(grid._viz_texture.GetImage().copy())
    zone.SetVisible(False)
    grid.UpdateMeshTexture()
    out.append(grid._viz_texture.GetImage().copy())
    # A resize keeps the overlapping values, then a hide drops the mesh.
    grid.SetDimensions(5, 9)
    out += [floor.GetSquareArray().copy(), zone.GetSquareArray().shape]
    grid.UpdateMeshTexture()
    out.append(grid._viz_texture.GetImage().copy())
    grid.Show(False)
    out += [grid.IsVisible(), grid.GetCurrentMesh(), grid._viz_texture,
            mesh.GetName() in [o.GetName() for o in ctx._objects.values()]]
    grid.RemoveLayer("floor")
    grid.RemoveLayer(zone)
    out.append(grid.GetLayerCount())
    zone.InitValue(3)
    out.append(int(zone.GetSquareArray().sum()))
    return out


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_grid_api_against_reference():
    """The grid script's values on both packages, one by one."""
    ref, got = _grid_script(J), _grid_script(O)
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert _equal(a, b), (i, a, b)


def test_layer_types_and_class_table():
    """RegisterLayerType and GetLayerTypeByName; the grid, layer and
    chain classes are created through CreateObjectByClassID."""
    n = tgrid.RegisterLayerType("lava")
    assert tgrid.RegisterLayerType("lava") == n
    assert tgrid.GetLayerTypeByName("lava") == n
    assert tgrid.GetLayerTypeByName("no such type") == 0
    ctx = O.CKContext(device="cpu")
    for cid, cls in ((OB.CKCID_GRID, O.CKGrid), (OB.CKCID_LAYER, O.CKLayer),
                     (OB.CKCID_KINEMATICCHAIN, tik.CKKinematicChain)):
        obj = ctx.CreateObjectByClassID(cid, f"o{cid}")
        assert isinstance(obj, cls) and obj.GetClassID() == cid
    from ckrenderengine_tpu_torch.objects import classreg
    assert classreg.CKIsChildClassOf(OB.CKCID_GRID, OB.CKCID_3DENTITY)
    grid, floor, zone = _grid(O, ctx)
    assert classreg.get_dependencies(grid, classreg.FULL_COPY_DEPENDENCIES
                                     ) == [floor, zone]


def _grid_frame(P, **ctx_kw):
    """A shown grid of 8 x 6 squares with two layers over an opaque ground,
    at 128x96: its blended textured quad (NEAREST) and orange wireframe
    border."""
    ctx = P.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(128, 96)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((4.3, 7.1, -4.2))
    cam.SetOrientation((0.05, -0.93, 1.0))
    rc.AttachViewpointToCamera(cam)
    mesh = P.CKMesh(ctx, "ground_m")
    mesh.SetPositions(np.array([[-3, -0.4, -3], [12, -0.4, -3],
                                [12, -0.6, 11], [-3, -0.6, 11]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "ground_mat")
    mat.SetDiffuse((0, 0, 0, 1))
    mat.SetEmissive((0.31, 0.42, 0.27, 1.0))
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    P.CK3dObject(ctx, "ground").SetCurrentMesh(mesh)
    rng = np.random.default_rng(11)
    grid = P.CKGrid(ctx, "zones")
    grid.SetDimensions(8, 6)
    for name, color in (("floor", (1.0, 0.3, 0.2, 1.0)),
                        ("zone", (0.2, 0.6, 1.0, 1.0))):
        layer = grid.AddLayer(name)
        layer.SetSquareArray(rng.integers(0, 256, (6, 8)))
        layer.SetColor(color)
    grid.Show(True)
    return ctx, rc, grid


def test_grid_frame():
    """The grid frame (the flat ordered pass and the line pass) within
    ATOL of the reference's; a layer change between frames shows in the
    next frame without a recompile."""
    rj = render_reference(_grid_frame, accelerator=False)
    _ctx, rt, grid = _grid_frame(O, device="cpu")
    rt.Render()
    assert_frames_close(rt, rj)
    fb0 = rt.framebuffer().copy()
    ver = rt._compiled.topology_version
    grid.GetLayer("floor").SetSquareArray(np.zeros((6, 8), np.int32))
    grid.UpdateMeshTexture()
    rt.Render()
    assert rt._compiled.topology_version == ver
    assert (np.abs(rt.framebuffer() - fb0).max(-1) > 0.01).mean() > 0.02


def _chain(P, ctx, n_bones=8, limits=True):
    """The arm of ``scenes.build_config5_debug`` cut to ``n_bones``, at the
    origin: its skin, bones and chain; the middle third of the bones
    limited to +-0.6 rad."""
    arm, _mesh, _skin, bones, _clip = scenes.make_skinned_tube(
        P, ctx, n_bones, 2, 12, clip=False)
    bones[0].SetOrientation((0.0, 1.0, 0.0), up=(0.0, 0.0, -1.0))
    chain = _anim(P).CKKinematicChain(ctx, "arm_ik")
    chain.SetStartEffector(bones[0])
    chain.SetEndEffector(bones[-1])
    third = n_bones // 3
    if limits:
        for b in bones[third:n_bones - third]:
            b.rotation_joint.SetLimits((-0.6,) * 3, (0.6,) * 3)
    return arm, bones, chain


def _pose(bones):
    return np.stack([b.GetWorldMatrix() for b in bones])


def _ik_script(P):
    """Chain construction, GetChainLength, IKRotateToward (limited and
    free joints), and IKSetEffectorPos towards seeded targets (world and
    ref space, one out of reach)."""
    ctx = small_ctx(P)
    _arm, bones, chain = _chain(P, ctx)
    out = [chain.GetChainBodyCount(),
           [chain.GetChainBody(i).GetName()
            for i in range(chain.GetChainBodyCount())],
           chain.GetStartEffector() is bones[0],
           chain.GetEffector(False) is bones[-1], chain.GetChainLength()]
    poses = []
    for part, target in ((bones[3], (1.0, 1.5, 0.5)),
                         (bones[1], (-1.0, 2.0, 0.3)),
                         (bones[0], (0.0, 2.0, 0.0))):
        out.append(chain.IKRotateToward(part, target))
        poses.append(_pose(bones))
    out.append(chain.IKRotateToward(ctx.GetObjectByName("snake"),
                                    (0, 0, 0)))
    reach = chain.GetChainLength()
    rng = np.random.default_rng(17)
    for target in ([0.5, 0.7 * reach, 0.4], [-0.3 * reach, 0.5 * reach, 0.2],
                   rng.uniform(-0.4, 0.4, 3) * reach + [0, 0.5 * reach, 0],
                   [0.0, 3.0 * reach, 0.0]):
        out.append(chain.IKSetEffectorPos(np.float32(target)))
        poses.append(_pose(bones))
    out.append(chain.IKSetEffectorPos((0.2, 0.8, 0.1), ref=bones[2],
                                      max_iterations=32))
    poses.append(_pose(bones))
    broken = _anim(P).CKKinematicChain(ctx, "broken")
    broken.SetStartEffector(bones[3])
    broken.SetEndEffector(bones[1])
    out += [broken.GetChainBodyCount(), broken.IKSetEffectorPos((0, 1, 0))]
    return out, poses


def test_kinematic_chain_against_reference():
    """The chain script's values equal on both packages; every pose (the
    bones' world matrices after each call) within IK_ATOL; the limited
    joints inside their box."""
    (ref, ref_poses), (got, got_poses) = _ik_script(J), _ik_script(O)
    assert got[:4] == ref[:4]
    assert abs(got[4] - ref[4]) <= 1e-6
    assert got[5:] == ref[5:]
    # Three turns, a part outside the chain; two targets reached, a
    # seeded one the limits keep out of tolerance, one out of reach; a
    # target in a bone's space; a chain whose end is not below its start.
    assert got[5:9] == [True, True, True, False]
    assert got[9:13] == [True, True, False, False]
    assert got[13] is True and got[14:] == [0, False]
    for i, (a, b) in enumerate(zip(got_poses, ref_poses)):
        np.testing.assert_allclose(a, b, rtol=0, atol=IK_ATOL,
                                   err_msg=f"pose {i}")
    ctx = small_ctx(O)
    _arm, bones, chain = _chain(O, ctx)
    chain.IKSetEffectorPos((1.2, 1.4, 0.6))
    for b in bones[2:6]:
        q = tik.CKKinematicChain._clamp_limits(b.GetLocalMatrix(),
                                               b.rotation_joint)
        np.testing.assert_allclose(q, b.GetLocalMatrix(), atol=1e-5)


@pytest.mark.parametrize("damping", [0.0, 0.1])
def test_svd_decompose_and_solve(damping):
    """SVDDecompose and SVDSolve (float64 numpy in both packages) equal
    to the reference's, on a seeded Jacobian and a rank-deficient one."""
    rng = np.random.default_rng(29)
    for m in (rng.normal(size=(3, 7)),
              np.outer([1.0, 2.0, -1.0], rng.normal(size=5))):
        b = rng.normal(size=3)
        for x, y in zip(tik.SVDDecompose(m), jik.SVDDecompose(m)):
            assert np.array_equal(x, y)
        assert np.array_equal(tik.SVDSolve(m, b, damping),
                              jik.SVDSolve(m, b, damping))


def test_ik_svd_on_the_context_device(monkeypatch):
    """Each iteration factors its (3, M) Jacobian once with
    torch.linalg.svd, on the chain's context device."""
    seen = []
    svd = torch.linalg.svd

    def spy(a, *args, **kw):
        seen.append((tuple(a.shape), a.device.type, a.dtype))
        return svd(a, *args, **kw)

    monkeypatch.setattr(torch.linalg, "svd", spy)
    ctx = small_ctx(O)
    _arm, _bones, chain = _chain(O, ctx, limits=False)
    assert chain.IKSetEffectorPos((0.6, 1.6, 0.4), max_iterations=40)
    assert seen and all(s == ((3, 21), "cpu", torch.float32) for s in seen)


LEVEL = dict(width=128, height=96, terrain_n=12, n_balls=4, grid_n=8,
             n_arm_bones=6, arm_ring_verts=12)
FRAME_MS = 12.25


def _level(P, **kw):
    """``scenes.build_config5_debug`` cut to ``LEVEL``, one tick: the arm
    after IKSetEffectorPos towards its second target, DebugStep to 13 of
    its entities (the grid, the arm, then the level's first rows), the
    stepping label's time fixed (it shows the previous frame's)."""
    ctx, rc, _spinner, dbg = scenes.build_config5_debug(P, **kw)
    dbg["chain"].IKSetEffectorPos(dbg["targets"][1])
    rc.SetDebugObjectCount(12)
    rc.DebugStep()
    rc.stats.FrameTime = FRAME_MS
    return ctx, rc, dbg


def test_skinned_arm_frame():
    """The debugged level cut down, its skinned arm posed by each package's
    IK (within IK_ATOL of each other), with the grid, the stepped
    entities, the label and the watermark, through both packages'
    Render(): held to the reference with each package's own triangle
    setup where winners differ; the arm wins pixels."""
    pair = render_both(_level, accelerator=False, **LEVEL)
    check_render(pair, own_setup=True)
    rj, rt = pair[0], pair[1]
    n = rt.context.entity_table.count
    assert rt._dbg_label[0] == rj._dbg_label_cache[0]
    assert rt._dbg_label[0].endswith(f"(13/{n}) {FRAME_MS:.1f} ms")
    st, tf, ti, tp = rt._fill_packed([], [])
    ids = port_frame_ids(rt, st, torch.as_tensor(tf), torch.as_tensor(ti),
                         tp).numpy()
    c = rt._compiled
    rows = c.vert_entity[c.tri_idx[ids[ids >= 0], 0]]
    arm = next(e for e in rt._scene_entities() if e.GetName() == "snake")
    assert (rows == arm.row).sum() > 20
