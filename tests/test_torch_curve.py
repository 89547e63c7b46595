"""Curves against the reference package on the CPU: ``CKCurve`` and
``CKCurvePoint`` built the same way through both object models.

- The regenerated line mesh (``Update``) of open and closed curves, TCB
  points with tension, continuity and bias, linear points, a fitting
  coefficient, and a step-count change: equal line indices and colours,
  positions within 1e-6 (the host sampling is float64 numpy in both, cast
  to f32), ``GetLength`` and ``GetPos`` likewise.
- The point and curve API: dirty flags, re-binding a point, removing one,
  open/close, getters.
- Through ``Render()``: a dirty curve regenerates its mesh before the
  compile, so a moved control point recompiles the frame
  (``RenderStateCacheMiss``) and moves its line; ``NbLinesDrawn`` follows
  the step count as the reference's does, and the frame of a curve scene
  matches the reference's (``check_render``; pixels in the line pass's
  rounding band, ``fx_explained``, may differ).
"""

import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from tests._torch_common import check_render, fx_explained, render_both

CURVES = {
    "open_tcb": dict(closed=False, linear=(), tcb=True, fit=0.0, steps=40),
    "closed_tcb": dict(closed=True, linear=(), tcb=True, fit=0.0, steps=33),
    "open_linear": dict(closed=False, linear="all", tcb=False, fit=0.0,
                        steps=20),
    "closed_mixed_fit": dict(closed=True, linear=(0, 3), tcb=True, fit=0.3,
                             steps=64),
    "two_points": dict(closed=False, linear=(), tcb=False, fit=0.0,
                       steps=7, n=2),
}


def _curve(P, case, **ctx_kw):
    ctx = P.CKContext(**ctx_kw)
    rng = np.random.default_rng(5)
    cv = P.CKCurve(ctx, "cv")
    cv.SetPosition((1.0, -0.5, 2.0))
    cv.Rotate((0.0, 1.0, 0.0), 0.3)
    n = case.get("n", 7)
    for j in range(n):
        cp = cv.AddControlPoint(rng.uniform(-4, 4, 3).astype(np.float32))
        if case["linear"] == "all" or j in case["linear"]:
            cp.SetLinear(True)
        if case["tcb"]:
            cp.SetTension(float(rng.uniform(-0.6, 0.6)))
            cp.SetContinuity(float(rng.uniform(-0.6, 0.6)))
            cp.SetBias(float(rng.uniform(-0.6, 0.6)))
    if case["closed"]:
        cv.Close()
    cv.SetFittingCoeff(case["fit"])
    cv.SetStepCount(case["steps"])
    cv.SetColor((0.9, 0.2, 0.4, 1.0))
    return ctx, cv


def _mesh(cv):
    cv.Update()
    m = cv.GetCurrentMesh()
    return (np.asarray(m.positions), np.asarray(m.lines),
            np.asarray(m.colors))


@pytest.mark.parametrize("name", list(CURVES))
def test_curve_mesh_matches_reference(name):
    case = CURVES[name]
    _c, got = _curve(O, case, device="cpu")
    _c, want = _curve(J, case)
    for step_count in (case["steps"], 3 * case["steps"] + 1):
        got.SetStepCount(step_count)
        want.SetStepCount(step_count)
        assert got.IsDirty() and want.IsDirty()
        pg, lg, cg = _mesh(got)
        pw, lw, cw = _mesh(want)
        assert not got.IsDirty()
        np.testing.assert_array_equal(lg, lw)
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_allclose(pg, pw, rtol=0, atol=1e-6)
        assert lg.shape[0] == pg.shape[0] - 1 > 0
        assert abs(got.GetLength() - want.GetLength()) <= 1e-6 * max(
            1.0, want.GetLength())
        for s in (0.0, 0.13, 0.5, 0.77, 1.0, 1.5):
            np.testing.assert_allclose(got.GetPos(s), want.GetPos(s),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(got.GetLocalPos(s), got.GetPos(s))


def _api(P, **ctx_kw):
    ctx = P.CKContext(**ctx_kw)
    out = []
    cv = P.CKCurve(ctx, "cv")
    other = P.CKCurve(ctx, "other")
    pts = [cv.AddControlPoint((float(i), float(i % 2), 0.0))
           for i in range(4)]
    cv.Update()
    out.append(cv.IsDirty())
    pts[1].SetTension(0.25)
    out += [cv.IsDirty(), pts[1].GetTension()]
    cv.Update()
    pts[2].SetContinuity(-0.5)
    pts[2].SetBias(0.125)
    out += [pts[2].GetContinuity(), pts[2].GetBias(), cv.IsDirty()]
    cv.Update()
    pts[0].UseTCB(False)
    out += [pts[0].IsTCB(), pts[0].IsLinear(), cv.IsDirty()]
    pts[0].SetLinear(False)
    out += [pts[0].IsLinear(), cv.IsDirty()]
    cv.Update()
    pts[3].SetPosition((5.0, 1.0, 1.0))          # moving a point dirties it
    out.append(cv.IsDirty())
    cv.Update()
    pts[3].NotifyUpdate()
    out.append(cv.IsDirty())
    pts[3].SetCurve(other)
    out += [cv.GetControlPointCount(), other.GetControlPointCount(),
            pts[3].GetCurve() is other, other.IsDirty()]
    cv.RemoveControlPoint(pts[2])
    out += [cv.GetControlPointCount(), pts[2].GetCurve() is None,
            cv.GetControlPoint(1) is pts[1]]
    out += [cv.IsOpen()]
    cv.Close()
    out += [cv.IsOpen(), cv.IsDirty()]
    cv.Open()
    cv.SetStepCount(0)
    out += [cv.GetStepCount(), cv.GetFittingCoeff()]
    cv.SetFittingCoeff(0.5)
    out += [cv.GetFittingCoeff(), tuple(cv.GetColor())]
    pts[1].SetCurveLength(3.5)
    pts[1].SetFittedVector((1, 2, 3, 4))
    pts[1].SetReservedVector((5, 6, 7))
    out += [pts[1].GetCurveLength(), tuple(pts[1].GetFittedVector()),
            tuple(pts[1].GetReservedVector()),
            tuple(pts[0].GetFittedVector())]
    out.append(tuple(_mesh(cv)[0].reshape(-1).round(5)))
    return out


def test_curve_api_matches_reference():
    assert _api(O, device="cpu") == _api(J)


def build_rails(P, width=96, height=73, steps=16, antialias=False,
                **ctx_kw):
    """A floor and two curves (one closed TCB, one open linear) in front
    of a camera."""
    ctx = P.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 2.0, -9.0))
    cam.SetOrientation((0.0, -0.2, 1.0))
    rc.AttachViewpointToCamera(cam)
    floor = P.CKMesh(ctx, "floor")
    floor.SetPositions(np.array([[-6, -1, -4], [6, -1, -4], [6, -1, 8],
                                 [-6, -1, 8]], np.float32))
    floor.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    floor.BuildNormals()
    mat = P.CKMaterial(ctx, "fm")
    mat.SetDiffuse((0.3, 0.35, 0.4, 1.0))
    floor.ApplyGlobalMaterial(mat)
    P.CK3dObject(ctx, "floor").SetCurrentMesh(floor)
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    loop = P.CKCurve(ctx, "loop")
    loop.SetPosition((-1.5, 0.5, 1.0))
    for a in ang:
        loop.AddControlPoint((2.5 * np.cos(a), 0.6 * np.sin(2 * a),
                              1.5 * np.sin(a)))
    loop.Close()
    loop.SetStepCount(steps)
    loop.SetColor((1.0, 0.8, 0.1, 1.0))
    rail = P.CKCurve(ctx, "rail")
    for j in range(6):
        cp = rail.AddControlPoint((-4.0 + 1.6 * j, -0.8 + 0.3 * (j % 2),
                                   3.0 - 0.4 * j))
        cp.SetLinear(True)
    rail.SetStepCount(steps)
    rail.SetColor((0.2, 0.9, 1.0, 1.0))
    return ctx, rc, loop


def test_dirty_curve_recompiles_in_render():
    _ctx, rc, loop = build_rails(O, device="cpu")
    rc.Render()
    s = rc.GetStats()
    misses, lines0 = s.RenderStateCacheMiss, s.NbLinesDrawn
    fb0 = np.asarray(rc.framebuffer()).copy()
    rc.Render()                                       # nothing is dirty
    assert s.RenderStateCacheMiss == misses
    loop.GetControlPoint(2).SetPosition((0.5, 1.5, 2.0), ref=loop)
    assert loop.IsDirty()
    rc.Render()
    assert not loop.IsDirty()
    assert s.RenderStateCacheMiss == misses + 1
    assert (np.asarray(rc.framebuffer()) != fb0).any(-1).sum() > 10
    loop.SetStepCount(40)
    rc.Render()
    assert s.NbLinesDrawn > lines0

    _ctx, rj, loop_j = build_rails(J)
    rj.Render()
    loop_j.GetControlPoint(2).SetPosition((0.5, 1.5, 2.0), ref=loop_j)
    rj.Render()
    loop_j.SetStepCount(40)
    rj.Render()
    assert rj.GetStats().NbLinesDrawn == s.NbLinesDrawn


def test_curve_frame_matches_reference():
    pair = render_both(build_rails, accelerator=False)
    rj, rt, _packed, _ref = pair
    assert rt.GetStats().NbLinesDrawn == rj.GetStats().NbLinesDrawn > 0
    check_render(pair, explained=fx_explained(pair))
