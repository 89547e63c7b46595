"""Patch meshes against the reference package on the CPU.

- The Bernstein tessellation (``eval_quad_patches``, ``eval_tri_patches``)
  on seeded control nets at levels 1, 3 and 5: within f32 rounding of the
  exact sums (2^-22 of the sum of the terms' magnitudes per element).
- BASELINE config 4's patch sheet (36 patches at iteration 5) and a mixed
  mesh of quad and tri patches with a hard edge and UV patches, built
  through both packages: positions within f32 rounding; faces, UVs and the
  shared-edge weld map EQUAL (the weld rounds positions to 1/4096, so a
  last-bit difference could change a face index); normals within 1e-6;
  the index helpers, corner map and evaluators equal.
- A frame of the sheet alone at 256x193 (a tiled frame) through
  ``Render()`` against the reference's accelerator branch
  (``tests/_torch_common.check_render``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.objects import patchmesh as jpm
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.io import CKStateChunk, save_object
from ckrenderengine_tpu_torch.objects import classreg
from ckrenderengine_tpu_torch.objects import patchmesh as tpm
from ckrenderengine_tpu_torch.raster.types import VXLIGHT
from tests._torch_common import check_render, render_both

ULP_SCALE = 2.0 ** -22


def _assert_rounding(got, ref, terms):
    """|got - ref| within 2^-22 * terms (two f32 evaluations of one sum,
    each within 2^-23 of the sum of its terms' magnitudes)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(diff <= ULP_SCALE * terms + 1e-30), float(
        (diff / np.maximum(terms, 1e-30)).max())


@pytest.mark.parametrize("level", [1, 3, 5])
def test_eval_quad_patches_matches_reference(level):
    rng = np.random.default_rng(10 + level)
    ctrl = (rng.standard_normal((12, 4, 4, 3)) * 8).astype(np.float32)
    ref = np.asarray(jpm.eval_quad_patches(jnp.asarray(ctrl), level))
    got = tpm.eval_quad_patches(torch.as_tensor(ctrl), level).numpy()
    assert got.shape == ref.shape == (12, level + 1, level + 1, 3)
    b = np.abs(jpm._bernstein_matrix(level + 1).astype(np.float64))
    terms = np.einsum("ui,vj,pijc->puvc", b, b, np.abs(ctrl.astype(
        np.float64)))
    _assert_rounding(got, ref, terms)


@pytest.mark.parametrize("level", [1, 3, 5])
def test_eval_tri_patches_matches_reference(level):
    rng = np.random.default_rng(20 + level)
    ctrl = (rng.standard_normal((8, 10, 3)) * 8).astype(np.float32)
    ref = np.asarray(jpm.eval_tri_patches(jnp.asarray(ctrl), level))
    got = tpm.eval_tri_patches(torch.as_tensor(ctrl), level).numpy()
    m = (level + 1) * (level + 2) // 2
    assert got.shape == ref.shape == (8, m, 3)
    _, basis = jpm._tri_bernstein(level)
    terms = np.einsum("mk,pkc->pmc", np.abs(basis.astype(np.float64)),
                      np.abs(ctrl.astype(np.float64)))
    _assert_rounding(got, ref, terms)


def _nearest_f32(exact):
    """The f32 nearest to the Fraction ``exact``, ties to even."""
    from fractions import Fraction

    lo = np.float32(float(exact))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """The fused multiply-add the tri evaluation chains: one rounding of
    the exact a*b + c, also where the f64 sum lands exactly halfway between
    two f32 values and the exact value does not (24929 * 673 * 2^-24 =
    1 + 2^-24, plus or minus 2^-60)."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = rng.standard_normal(2000).astype(np.float32)
    a[:4] = [24929.0, 24929.0, -24929.0, 1.0]
    b[:4] = [673 * 2.0 ** -24] * 3 + [1.0]
    c[:4] = [2.0 ** -60, -(2.0 ** -60), -(2.0 ** -60), 2.0 ** -24]
    got = tpm._fma32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    assert got[0] == np.float32(1 + 2.0 ** -23) and got[1] == 1.0
    assert got[2] == np.float32(-1 - 2.0 ** -23) and got[3] == 1.0
    for i in range(2000):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        assert got[i] == _nearest_f32(exact), (i, a[i], b[i], c[i])


def _mixed(O):
    """Four quad patches (a 2x2 patch sheet), then four tri patches built
    from a 2x2 grid mesh (FromMesh) on the corner verts of a second
    mesh, with one hard edge, UV patches on channel 0 and a per-patch
    material; iteration 4."""
    ctx = O.CKContext(device="cpu") if O is not J else O.CKContext()
    sheet = scenes.make_patch_sheet(O, ctx, n=2, iterations=4)
    grid = O.CKMesh(ctx, "grid")
    verts, uv, faces = scenes.make_terrain(2, 3.0, 0.7)
    grid.SetPositions(verts)
    grid.SetFaces(faces[:4])
    tris = O.CKPatchMesh(ctx, "tris")
    tris.FromMesh(grid)
    tris.SetIterationCount(4)
    tris.SetEdgeHard(1, 4)
    tris.SetPatchUVs(np.array([[0, 0], [1, 0], [0, 1], [0.5, 0.5]],
                              np.float32))
    tris.SetTVPatch(0, 1, O.CKTVPatch([0, 1, 3]))
    sheet.SetEdgeHard(1, 4)
    mat = O.CKMaterial(ctx, "m")
    sheet.SetPatchMaterial(2, mat)
    sheet.SetTVPatch(0, 0, O.CKTVPatch([0, 1, 2, 3]))
    sheet.SetPatchUVs(np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32))
    for pm in (sheet, tris):
        pm.BuildRenderMesh()
    return sheet, tris


def _sheets(O):
    ctx = O.CKContext(device="cpu") if O is not J else O.CKContext()
    return (scenes.make_patch_sheet(O, ctx),) + _mixed(O)


@pytest.fixture(scope="module")
def meshes():
    return list(zip(_sheets(J), _sheets(O)))


def test_config4_sheet_size(meshes):
    _ref, got = meshes[0]
    assert got.positions.shape == (1296, 3)
    assert got.faces.shape == (1800, 3)
    assert got.GetPatchCount() == 36 and got.GetIterationCount() == 5


@pytest.mark.parametrize("which", [0, 1, 2], ids=["sheet", "quads", "tris"])
def test_tessellation_matches_reference(meshes, which):
    ref, got = meshes[which]
    np.testing.assert_allclose(got.positions, ref.positions, rtol=2e-7,
                               atol=1e-6)
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_array_equal(got.uvs, ref.uvs)
    np.testing.assert_array_equal(got._weld_map, ref._weld_map)
    np.testing.assert_array_equal(got.face_materials, ref.face_materials)
    np.testing.assert_allclose(got.normals, ref.normals, atol=1e-6)
    # The weld merged duplicates (and the hard edges kept theirs).
    assert (got._weld_map != np.arange(got._weld_map.shape[0])).any()


def test_helpers_match_reference(meshes):
    for ref, got in meshes[1:]:
        for pi in range(got.GetPatchCount()):
            for args in ((0, 0), (2, 1), (4, 4), (5, 0), (1, 3)):
                assert (got.ComputeQuadVertexIndex(pi, *args)
                        == ref.ComputeQuadVertexIndex(pi, *args))
                assert (got.ComputeTriVertexIndex(pi, *args)
                        == ref.ComputeTriVertexIndex(pi, *args))
            for corner in range(4):
                assert (got.GetCornerTextureCoordinate(pi, corner)
                        == ref.GetCornerTextureCoordinate(pi, corner))
            for uv in ((0.25, 0.5), (0.0, 1.0), (0.3, 0.3)):
                if got.GetPatch(pi).is_quad:
                    np.testing.assert_allclose(
                        got.EvaluateQuadPatch(pi, *uv),
                        ref.EvaluateQuadPatch(pi, *uv), rtol=1e-6)
                else:
                    np.testing.assert_allclose(
                        got.EvaluateTriPatch(pi, *uv),
                        ref.EvaluateTriPatch(pi, *uv), rtol=1e-6)
        assert (got.EnsureCornerVertexMapAllocated()
                == ref.EnsureCornerVertexMapAllocated())
        for v in range(0, got.positions.shape[0], 7):
            assert (got.GetPatchCornerForVertex(1, v)
                    == ref.GetPatchCornerForVertex(1, v))
        for a, b in ((1, 4), (0, 1), (3, 4), (2, 5)):
            assert got.IsEdgeHard(a, b) == ref.IsEdgeHard(a, b)
            assert (got.DoPatchesShareUVOnEdge(a, b)
                    == ref.DoPatchesShareUVOnEdge(a, b))


def test_registration_and_unported_io():
    ctx = O.CKContext(device="cpu")
    pm = ctx.CreateObjectByClassID(O.base.CKCID_PATCHMESH, "p")
    assert isinstance(pm, O.CKPatchMesh)
    assert classreg.CKGetClassName(O.base.CKCID_PATCHMESH) == "Patch Mesh"
    assert pm.IsChildClassOf(O.base.CKCID_MESH)
    # LoadVertices reads the control net back from an ID_PATCHMESH chunk.
    assert not pm.LoadVertices(CKStateChunk())
    src = scenes.make_patch_sheet(O, ctx, n=1, iterations=2)
    src.SetIterationCount(4)
    assert pm.LoadVertices(save_object(src))
    np.testing.assert_array_equal(pm.verts, src.verts)
    np.testing.assert_array_equal(pm.vecs, src.vecs)
    assert pm.iteration_count == 4
    # Lazy tessellation: render groups build the mesh.
    sheet = scenes.make_patch_sheet(O, ctx, n=1, iterations=2)
    sheet.SetIterationCount(3)
    assert sheet.GetRenderGroups() and sheet.faces.shape == (18, 3)


def build_sheet(O, width=256, height=193, **ctx_kw):
    """Config 4's patch sheet alone under config 4's sun, seen from below:
    its faces wind clockwise seen from there (from config 4's camera, above
    it, the sheet is back-facing and culled in both packages)."""
    ctx = O.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, -14.0, -16.0))
    cam.SetOrientation((0.0, 0.6, 1.0))
    cam.SetBackPlane(300.0)
    rc.AttachViewpointToCamera(cam)
    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.3, -1.0, 0.4))
    sun.SetSpecularFlag(True)
    pmesh = scenes.make_patch_sheet(O, ctx)
    pmat = O.CKMaterial(ctx, "patchmat")
    pmat.SetDiffuse((0.45, 0.55, 0.75, 1.0))
    pmat.SetPower(16.0)
    pmesh.ApplyGlobalMaterial(pmat)
    ground = O.CK3dObject(ctx, "patchground")
    ground.SetCurrentMesh(pmesh)
    ground.SetPosition((0.0, -3.5, 0.0))
    return ctx, rc, ground


def test_sheet_frame_matches_reference():
    pair = render_both(build_sheet)
    rt = pair[1]
    assert rt._compiled.n_valid_tris == 1800
    # A tiled frame: the solve and rows of the full-size frame.
    assert rt._compiled.tri_idx.shape[0] * rt.height * rt.width > (1 << 26)
    check_render(pair)
