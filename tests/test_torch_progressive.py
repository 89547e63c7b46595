"""Progressive meshes in the port against the reference package, on the
CPU.

- ``compute_collapse_order``: ``rank`` and ``collapse_to`` array-equal to
  the reference's on seeded meshes (a UV sphere with its welded-apart
  poles, a bumpy grid, a strip with vertex weights). The port keeps each
  vertex's best collapse between steps; the reference recomputes every
  vertex at every step (minutes at the 12x18 sphere), so the meshes here
  are small.
- ``lod_remap`` and ``faces_at_lod`` equal at every budget; and
  ``geomorph_positions`` within f32 rounding (both evaluate
  ``p * (1 - step) + q * step`` in float32 with numpy: 2 ulp of the
  largest coordinate allowed, 0 seen).
- The mesh API (``CreatePM``, ``SetPMVertexCount``,
  ``SetPMGeoMorphStep``, ``DestroyPM``) leaves the same faces and positions
  in both packages.
- A low-LOD frame at 64x64 (the reference's tests/test_progressive_mesh.py
  scene, the flat route) within ``ATOL`` of the reference's frame.
- No ``unported(..., 16)`` call is left, key 16 is gone, and every
  ``unported(..., 14)`` call is one of the refusals item 14 keeps.
"""

import collections
import pathlib
import re

import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.utils import progressive as jpm
import ckrenderengine_tpu_torch
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE
from ckrenderengine_tpu_torch.utils import progressive as tpm
from tests._torch_common import assert_frames_close, small_ctx


def bumpy_grid(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n + 1, 0:n + 1] / float(n)
    pos = np.stack([xx, yy, rng.uniform(0, 0.2, xx.shape)], -1)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + 1, a + n + 2], -1),
                            np.stack([a, a + n + 2, a + n + 1], -1)])
    return pos.reshape(-1, 3).astype(np.float32), faces.astype(np.int32)


def strip(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (24, 3)).astype(np.float32)
    faces = np.array([[i, i + 1, i + 2] for i in range(22)], np.int32)
    return pos, faces, rng.uniform(0, 2, 24).astype(np.float32)


MESHES = {
    "sphere_4x6": lambda: scenes.make_sphere(4, 6, 1.6)[::2] + (None,),
    "bumpy_grid_6": lambda: bumpy_grid(6, 3) + (None,),
    "weighted_strip": lambda: strip(5),
}


@pytest.fixture(scope="module")
def orders():
    """Each mesh's collapse order by both packages."""
    out = {}
    for name, make in MESHES.items():
        pos, faces, w = make()
        out[name] = (pos, faces, tpm.compute_collapse_order(pos, faces, w),
                     jpm.compute_collapse_order(pos, faces, w))
    return out


@pytest.mark.parametrize("name", sorted(MESHES))
def test_collapse_order_equals_the_reference(orders, name):
    pos, faces, (rank, to), (rank_j, to_j) = orders[name]
    assert rank.dtype == to.dtype == np.int32
    np.testing.assert_array_equal(rank, rank_j)
    np.testing.assert_array_equal(to, to_j)
    assert sorted(rank.tolist()) == list(range(pos.shape[0]))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_lod_and_geomorph_equal_the_reference(orders, name):
    pos, faces, (rank, to), _ = orders[name]
    v = pos.shape[0]
    scale = float(np.abs(pos).max())
    for n in sorted({1, 2, 3, v // 4, v // 2, v - 1, v, v + 5}):
        remap = tpm.lod_remap(rank, to, n)
        np.testing.assert_array_equal(remap, jpm.lod_remap(rank, to, n))
        f = tpm.faces_at_lod(faces, remap)
        np.testing.assert_array_equal(f, jpm.faces_at_lod(faces, remap))
        for step in (0.0, 0.3, 0.5, 1.0):
            got = tpm.geomorph_positions(pos, rank, to, n, step)
            ref = jpm.geomorph_positions(pos, rank, to, n, step)
            np.testing.assert_allclose(
                got, ref, rtol=0,
                atol=2 * np.spacing(np.float32(scale)))
    np.testing.assert_array_equal(tpm.faces_at_lod(
        faces, tpm.lod_remap(rank, to, v)), faces)


def _pm_mesh(P, ctx):
    """The reference's low-LOD test mesh (tests/test_progressive_mesh.py:
    81-104): a 6x6 grid from -1 to 1, emissive cyan, two-sided."""
    verts, faces = bumpy_grid(6, 0)
    verts[:, 2] = 0.0
    mesh = P.CKMesh(ctx, "m")
    mesh.SetPositions(verts * 2 - 1)
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "mat")
    mat.SetEmissive((0, 0.8, 0.8, 1))
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    return mesh


def test_pm_api_equals_the_reference():
    out = []
    for P in (O, J):
        ctx = small_ctx(P)
        mesh = _pm_mesh(P, ctx)
        full = mesh.GetFaceCount()
        assert not mesh.IsPM() and mesh.CreatePM() and mesh.IsPM()
        states = []
        for n, step in ((10, 0.0), (20, 0.5), (5, 1.0)):
            mesh.SetPMVertexCount(n)
            mesh.SetPMGeoMorphStep(step)
            assert mesh.GetPMVertexCount() == n
            assert mesh.GetPMGeoMorphStep() == step
            states.append((mesh.faces.copy(), mesh.face_materials.copy(),
                           mesh.positions.copy()))
        assert 0 < states[2][0].shape[0] < states[1][0].shape[0] < full
        mesh.DestroyPM()
        assert not mesh.IsPM() and mesh.GetFaceCount() == full
        states.append((mesh.faces.copy(), mesh.face_materials.copy(),
                       mesh.positions.copy()))
        out.append(states)
    for (ft, mt, pt), (fj, mj, pj) in zip(*out):
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(pt, pj)


def _low_lod(P):
    ctx = small_ctx(P)
    mesh = _pm_mesh(P, ctx)
    obj = P.CK3dObject(ctx, "o")
    obj.SetCurrentMesh(mesh)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = P.CKCamera(ctx, "c")
    cam.SetPosition((0.05, 0.03, -4))
    rc.AttachViewpointToCamera(cam)
    mesh.CreatePM()
    mesh.SetPMVertexCount(12)
    mesh.SetPMGeoMorphStep(0.5)
    rc.Render()
    return rc


def test_low_lod_frame_matches_the_reference():
    rc_t, rc_j = _low_lod(O), _low_lod(J)
    assert_frames_close(rc_t, rc_j)
    assert (rc_t.framebuffer()[..., 2] > 0.5).sum() > 500


def test_port_queue_has_no_progressive_mesh_item():
    """Item 16 (progressive meshes) is carried: no key in PORT_QUEUE and no
    ``unported(..., 16)`` in the port. Item 14 keeps only movie sprites
    from video containers other than AVI, the default font's characters
    outside its baked table, the image and AVI variants the readers refuse
    (one call each, ``imagefile.unsupported`` and
    ``imagefile.unsupported_movie``) and what the TrueType stack of ``text/``
    refuses (font formats, opcodes, layouts): no named font, size or
    ligature waits for a baked table."""
    assert 16 not in PORT_QUEUE and set(PORT_QUEUE) == {1, 14}
    root = pathlib.Path(ckrenderengine_tpu_torch.__file__).parent
    call = re.compile(r"unported\(((?:[^()]|\([^()]*\))*?),\s*(\d+)\s*\)",
                      re.S)
    cites = {}
    for path in root.rglob("*.py"):
        for what, item in call.findall(path.read_text()):
            cites.setdefault(int(item), []).append((path.name, what))
    assert 16 not in cites
    kept = collections.Counter(name for name, _ in cites[14])
    assert kept == {"entity2d.py": 2, "imagefile.py": 2, "sfnt.py": 8,
                    "shaping.py": 14, "hinting.py": 3}, cites[14]
    texts = " ".join(what for _, what in cites[14])
    for word in ("image files", "video containers", "AVI files",
                 "default font",
                 "CFF outlines", "collection", "variable font",
                 "TrueType opcode", "right-to-left", "script needs",
                 "other than Arabic and Hebrew", "bidi isolate",
                 "fallback shaping", "fallback mark positioning",
                 "presentation-form composition", "variation sequence"):
        assert word in texts, word
    assert "ligature" not in texts and "baked glyph table" not in texts
