"""Picking on the port (``Pick``, ``Pick3D`` with and without
``precise_texture``, ``PickRect``, ``RectPick``) against the reference
package on the CPU: one scene built through both object models, the same
pick points and rects asked of both, entities compared by name and
distances within 1e-5 relative.

Picking is host numpy in both packages (``CK3dEntity.RayIntersection`` over
the meshes' host arrays, the texel lookup of PreciseTexturePick on the
texture's host image), so no frame is rendered. The scene holds the
reference's picking triangle (tests/test_aux.py), a scaled and rotated
cube, an alpha-tested card with holes in front of both, a 2D entity and a
hidden entity; the camera is turned so no axis lines up with the view.

The reference's ``RectPick(rect, intersect)`` passes ``intersect`` on to a
``PickRect`` that takes no such argument and raises ``TypeError``; the
port's ``RectPick`` ignores ``intersect`` and returns ``PickRect(rect)``
(README, port section). The case holds it to the reference's
``PickRect``.
"""

import math

import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.raster.types import VXCMP

from _torch_common import small_ctx, tri_scene

W, H = 64, 48
# Pick points: a seeded sample of the frame, pixel centres and corners.
RNG = np.random.default_rng(19)
POINTS = ([(float(x), float(y)) for x, y in zip(RNG.uniform(0, W, 40),
                                                 RNG.uniform(0, H, 40))]
          + [(i + 0.5, j + 0.5) for i in range(0, W, 8)
             for j in range(0, H, 8)])
RECTS = ((0, 0, W, H), (0, 0, 20, 16), (30, 20, 34, 24), (50, 40, 64, 48),
         (-10, -10, -1, -1), (20.5, 10.25, 40.75, 30.5))


def _card_image():
    """8x8 RGBA: alpha 0 on a checker of 2x2-texel holes, 1 elsewhere."""
    i, j = np.indices((8, 8))
    img = np.ones((8, 8, 4), np.float32)
    img[..., 3] = ((i // 2 + j // 2) % 2).astype(np.float32)
    img[..., 0] = 0.2 + 0.1 * i
    return img


def _scene(P, camera=True):
    """The picking scene of package ``P``; returns (ctx, rc, entities by
    name)."""
    ctx = small_ctx(P)
    rc = ctx.GetRenderManager().CreateRenderContext(W, H)
    if camera:
        cam = P.CKCamera(ctx, "cam")
        cam.SetPosition((0.4, 0.3, -5.0))
        cam.SetOrientation((-0.05, -0.04, 1.0))
        rc.AttachViewpointToCamera(cam)
    tri, _mesh, _mat = tri_scene(P, ctx)
    verts = np.array([[x, y, z] for x in (-0.6, 0.6) for y in (-0.6, 0.6)
                      for z in (-0.6, 0.6)], np.float32)
    faces = np.array([
        [0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
        [2, 6, 7], [2, 7, 3], [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5],
    ], np.int32)
    bm = P.CKMesh(ctx, "box_mesh")
    bm.SetPositions(verts)
    bm.SetFaces(faces)
    bm.BuildNormals()
    box = P.CK3dObject(ctx, "box")
    box.SetCurrentMesh(bm)
    box.SetScale((1.8, 0.7, 1.2))
    box.Rotate((0.3, 1.0, 0.2), 0.7)
    box.SetPosition((1.1, -0.4, 1.5))
    card_m = P.CKMesh(ctx, "card_mesh")
    card_m.SetPositions(np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                  [-1, 1, 0]], np.float32))
    card_m.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    card_m.SetUVs(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32))
    card_m.BuildNormals()
    tex = P.CKTexture(ctx, "holes")
    tex.SetImage(_card_image())
    cmat = P.CKMaterial(ctx, "card_mat")
    cmat.SetTexture(tex)
    cmat.EnableAlphaTest(True)
    cmat.SetAlphaFunc(int(VXCMP.GREATER))
    cmat.SetAlphaRef(128)
    cmat.SetTwoSided(True)
    card_m.ApplyGlobalMaterial(cmat)
    card = P.CK3dObject(ctx, "card")
    card.SetCurrentMesh(card_m)
    card.SetPosition((-0.5, 0.2, -1.0))
    hidden = P.CK3dObject(ctx, "hidden")
    hidden.SetCurrentMesh(bm)
    hidden.SetPosition((0.0, 0.0, -2.0))
    hidden.Show(False)
    hud = P.CK2dEntity(ctx, "hud")
    hud.SetRect((4, 30, 16, 44))
    names = {e.GetName(): e for e in (tri, box, card, hidden, hud)}
    return ctx, rc, names


def _name(hit):
    return None if hit is None else hit.GetName()


def _same_hit(got, ref, where):
    assert _name(got[0]) == _name(ref[0]), where
    if math.isinf(ref[1]):
        assert math.isinf(got[1]), where
    else:
        assert got[1] == pytest.approx(ref[1], rel=1e-5, abs=0), where


@pytest.mark.parametrize("precise", [False, True])
def test_pick3d_against_reference(precise):
    """Pick3D at every point: the same entity (or none) and distance."""
    (_cj, rj, _nj), (_ct, rt, _nt) = _scene(J), _scene(O)
    hits = set()
    for x, y in POINTS:
        ref = rj.Pick3D(x, y, precise_texture=precise)
        _same_hit(rt.Pick3D(x, y, precise_texture=precise), ref, (x, y))
        hits.add(_name(ref[0]))
    # The sample reaches the triangle, the cube, the card and the clear.
    assert {"tri", "box", None} <= hits
    assert ("card" in hits) or precise


def test_pick_2d_in_front():
    """Pick: the 2D entity over its rect at distance 0, the 3D hit
    elsewhere (with and without precise_texture)."""
    (_cj, rj, _nj), (_ct, rt, _nt) = _scene(J), _scene(O)
    names = []
    for x, y in POINTS + [(10.0, 37.0), (4.5, 30.5)]:
        for precise in (False, True):
            ref = rj.Pick(x, y, precise)
            got = rt.Pick(x, y, precise)
            _same_hit(got, ref, (x, y, precise))
            names.append(_name(ref[0]))
    assert "hud" in names and "tri" in names
    assert rt.Pick(10.0, 37.0) == (rt.Pick2D(10.0, 37.0), 0.0)


def test_precise_pick_through_a_hole():
    """A ray through a transparent texel of the card picks what lies
    behind it; through an opaque one, the card."""
    (_cj, rj, nj), (_ct, rt, nt) = _scene(J), _scene(O)
    through, solid = [], []
    for x in np.arange(0.5, W, 1.0):
        for y in np.arange(0.5, H, 1.0):
            ref = rj.Pick3D(x, y)
            if _name(ref[0]) != "card":
                continue
            precise = rj.Pick3D(x, y, precise_texture=True)
            (through if _name(precise[0]) != "card" else solid).append(
                (x, y, _name(precise[0])))
            _same_hit(rt.Pick3D(x, y, precise_texture=True), precise, (x, y))
            _same_hit(rt.Pick3D(x, y), ref, (x, y))
    assert through and solid
    assert {n for _x, _y, n in through} & {"tri", "box", None}


def test_pick_rect_and_rect_pick():
    """PickRect over rects inside, across and outside the viewport, and
    RectPick, against the reference's PickRect: the same entities in the
    same order; the hidden entity is never listed."""
    (_cj, rj, _nj), (_ct, rt, _nt) = _scene(J), _scene(O)
    for rect in RECTS:
        ref = [e.GetName() for e in rj.PickRect(rect)]
        assert [e.GetName() for e in rt.PickRect(rect)] == ref, rect
        for intersect in (True, False):
            assert [e.GetName() for e in rt.RectPick(rect, intersect)] \
                == ref, rect
        assert "hidden" not in ref
    assert [e.GetName() for e in rt.PickRect((0, 0, W, H))] == [
        "tri", "box", "card"]
    with pytest.raises(TypeError):
        rj.RectPick((0, 0, W, H))


def test_no_camera():
    """Without a camera no 3D entity picks (None, inf), PickRect lists
    nothing, and Pick still finds the 2D entity."""
    (_cj, rj, _nj), (_ct, rt, _nt) = (_scene(J, camera=False),
                                      _scene(O, camera=False))
    for x, y in POINTS[:10]:
        _same_hit(rt.Pick3D(x, y), rj.Pick3D(x, y), (x, y))
        assert rt.Pick3D(x, y) == (None, float("inf"))
    assert rt.PickRect((0, 0, W, H)) == [] == rj.PickRect((0, 0, W, H))
    assert _name(rt.Pick(10.0, 37.0)[0]) == "hud" == _name(
        rj.Pick(10.0, 37.0)[0])
    assert rt._pick_ray(1.0, 1.0) is None
