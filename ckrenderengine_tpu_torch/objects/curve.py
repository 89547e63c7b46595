"""3D curves: CKCurve / CKCurvePoint.

API mirror of RCKCurve / RCKCurvePoint (src/CKCurve.cpp,
src/CKCurvePoint.cpp, include/RCKCurve.h:8-60): TCB spline through control-
point entities (per-point tension/continuity/bias + linear flag), open or
closed, fitting coefficient, step count; rendered as a line mesh that is
regenerated when dirty (RCKCurve::Render = update-if-dirty then entity
render). Sampling runs on the host (control counts are tiny); the generated
line mesh rides the device line pass (pipeline/lines.py).
"""

from __future__ import annotations

import numpy as np

from .base import CKCID_CURVE, CKCID_CURVEPOINT, CKContext
from .entity import CK3dEntity
from .mesh import CKMesh


class CKCurvePoint(CK3dEntity):
    CLASS_ID = CKCID_CURVEPOINT

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.curve = None
        self.tension = 0.0
        self.continuity = 0.0
        self.bias = 0.0
        self.linear = False

    def GetCurve(self):
        return self.curve

    # -- API-surface parity batch (reference include/RCKCurvePoint.h) ------
    def SetCurve(self, curve):
        """Re-bind to a curve (reference SetCurve)."""
        if self.curve is curve:
            return
        if self.curve is not None and self in self.curve.points:
            self.curve.points.remove(self)
            self.curve._curve_dirty = True
        self.curve = curve
        if curve is not None and self not in curve.points:
            curve.points.append(self)
            curve._curve_dirty = True

    def SetCurveLength(self, length: float):
        """Arc-length position bookkeeping for the owner curve (reference
        SetCurveLength — the fitting pass stores per-point arc lengths)."""
        self._curve_length = float(length)

    def GetCurveLength(self) -> float:
        return getattr(self, "_curve_length", 0.0)

    def SetFittedVector(self, v):
        """Precomputed spline tangent at this point (reference
        Get/SetFittedVector — the fitting pass caches these)."""
        self._fitted = np.asarray(v, np.float32)[:3].copy()

    def GetFittedVector(self):
        return getattr(self, "_fitted", np.zeros(3, np.float32)).copy()

    def SetReservedVector(self, v):
        self._reserved = np.asarray(v, np.float32)[:3].copy()

    def GetReservedVector(self):
        return getattr(self, "_reserved", np.zeros(3, np.float32)).copy()

    def GetTension(self) -> float:
        return self.tension

    def SetTension(self, t: float):
        self.tension = float(t)
        self._notify()

    def GetContinuity(self) -> float:
        return self.continuity

    def SetContinuity(self, c: float):
        self.continuity = float(c)
        self._notify()

    def GetBias(self) -> float:
        return self.bias

    def SetBias(self, b: float):
        self.bias = float(b)
        self._notify()

    def UseTCB(self, use: bool = True):
        self.linear = not use

    def IsTCB(self) -> bool:
        return not self.linear

    def SetLinear(self, linear: bool = True):
        self.linear = bool(linear)
        self._notify()

    def IsLinear(self) -> bool:
        return self.linear

    def NotifyUpdate(self):
        self._notify()

    def _notify(self):
        if self.curve is not None:
            self.curve._curve_dirty = True

    def _flag_moved(self):
        super()._flag_moved()
        self._notify()


class CKCurve(CK3dEntity):
    CLASS_ID = CKCID_CURVE

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.points: list[CKCurvePoint] = []
        self.closed = False
        self.fitting_coeff = 0.0
        self.step_count = 20
        self.color = np.ones(4, np.float32)
        self._curve_dirty = True
        self._length = 0.0
        mesh = CKMesh(context, f"{name}__curvemesh")
        self.SetCurrentMesh(mesh)
        # curves need a dirty-check each frame (update-if-dirty render)
        context._prerender_objects[self.id] = self

    # -- control points ----------------------------------------------------
    def AddControlPoint(self, pos_or_point) -> CKCurvePoint:
        if isinstance(pos_or_point, CKCurvePoint):
            cp = pos_or_point
        else:
            cp = CKCurvePoint(self.context,
                              f"{self.GetName()}_cp{len(self.points)}")
            cp.SetPosition(np.asarray(pos_or_point, np.float32), ref=self)
        cp.curve = self
        cp.SetParent(self)
        self.points.append(cp)
        self._curve_dirty = True
        return cp

    def RemoveControlPoint(self, cp: CKCurvePoint):
        if cp in self.points:
            self.points.remove(cp)
            cp.curve = None
            self._curve_dirty = True

    def GetControlPointCount(self) -> int:
        return len(self.points)

    def GetControlPoint(self, i: int) -> CKCurvePoint:
        return self.points[i]

    # -- parameters ---------------------------------------------------------
    def Open(self):
        self.closed = False
        self._curve_dirty = True

    def Close(self):
        self.closed = True
        self._curve_dirty = True

    def IsOpen(self) -> bool:
        return not self.closed

    def SetFittingCoeff(self, f: float):
        self.fitting_coeff = float(f)
        self._curve_dirty = True

    def GetFittingCoeff(self) -> float:
        return self.fitting_coeff

    def SetStepCount(self, n: int):
        self.step_count = max(1, int(n))
        self._curve_dirty = True

    def GetStepCount(self) -> int:
        return self.step_count

    def SetColor(self, rgba):
        self.color = np.asarray(rgba, np.float32)[:4]
        self._curve_dirty = True

    def GetColor(self):
        return self.color.copy()

    # -- sampling -----------------------------------------------------------
    def _control_positions(self) -> np.ndarray:
        """Control positions in curve-local space."""
        if not self.points:
            return np.zeros((0, 3), np.float32)
        inv = np.linalg.inv(self.GetWorldMatrix())
        out = np.zeros((len(self.points), 3), np.float32)
        for i, p in enumerate(self.points):
            w = p.GetWorldMatrix()[3, :3]
            out[i] = w @ inv[:3, :3] + inv[3, :3]
        return out

    def _sample(self) -> np.ndarray:
        """TCB-hermite samples through the control points (step_count
        segments per span; fitting_coeff acts as extra global tension)."""
        pts = self._control_positions()
        n = pts.shape[0]
        if n == 0:
            return np.zeros((0, 3), np.float32)
        if n == 1:
            return pts.copy()
        closed = self.closed

        def P(i):
            if closed:
                return pts[i % n]
            return pts[np.clip(i, 0, n - 1)]

        spans = n if closed else n - 1
        steps = max(self.step_count // max(spans, 1), 2)
        samples = []
        for i in range(spans):
            p0, p1 = P(i), P(i + 1)
            pm, pp = P(i - 1), P(i + 2)
            cp_obj = self.points[i % n]
            cn_obj = self.points[(i + 1) % n]
            if cp_obj.linear and cn_obj.linear:
                t = np.linspace(0, 1, steps, endpoint=False)[:, None]
                samples.append(p0 + (p1 - p0) * t)
                continue
            # TCB tangents with the fitting coefficient as global tension
            def tangents(p_prev, p, p_next, tc, cc, bc):
                d0 = p - p_prev
                d1 = p_next - p
                tt = 1.0 - np.clip(tc + self.fitting_coeff, -1.0, 1.0)
                tin = tt * ((1 - cc) * (1 + bc) * 0.5 * d0
                            + (1 + cc) * (1 - bc) * 0.5 * d1)
                tout = tt * ((1 + cc) * (1 + bc) * 0.5 * d0
                             + (1 - cc) * (1 - bc) * 0.5 * d1)
                return tin, tout

            _, out0 = tangents(pm, p0, p1, cp_obj.tension,
                               cp_obj.continuity, cp_obj.bias)
            in1, _ = tangents(p0, p1, pp, cn_obj.tension,
                              cn_obj.continuity, cn_obj.bias)
            t = np.linspace(0, 1, steps, endpoint=False)[:, None]
            t2 = t * t
            t3 = t2 * t
            h1 = 2 * t3 - 3 * t2 + 1
            h2 = -2 * t3 + 3 * t2
            h3 = t3 - 2 * t2 + t
            h4 = t3 - t2
            samples.append(h1 * p0 + h2 * p1 + h3 * out0 + h4 * in1)
        samples.append(P(0)[None] if closed else P(n - 1)[None])
        return np.concatenate(samples).astype(np.float32)

    # -- mesh generation -----------------------------------------------------
    def Update(self):
        """Regenerate the line mesh if dirty (RCKCurve::Render semantics)."""
        if not self._curve_dirty:
            return
        pts = self._sample()
        mesh = self.GetCurrentMesh()
        m = pts.shape[0]
        if m >= 2:
            mesh.SetPositions(pts)
            mesh.SetColors(np.tile(self.color, (m, 1)))
            lines = np.stack([np.arange(m - 1), np.arange(1, m)], -1)
            mesh.SetLineCount(m - 1)
            for i, (a, b) in enumerate(lines):
                mesh.SetLine(i, int(a), int(b))
        self._length = float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum()) \
            if m >= 2 else 0.0
        self._curve_dirty = False

    def GetLength(self) -> float:
        self.Update()
        return self._length

    def GetPos(self, step: float) -> np.ndarray:
        """Position at normalized param step in [0,1] (local space)."""
        self.Update()
        pts = np.asarray(self.GetCurrentMesh().positions)
        if pts.shape[0] == 0:
            return np.zeros(3, np.float32)
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        total = max(cum[-1], 1e-12)
        target = np.clip(step, 0.0, 1.0) * total
        i = int(np.searchsorted(cum, target) - 1)
        i = np.clip(i, 0, len(seg) - 1)
        u = (target - cum[i]) / max(seg[i], 1e-12)
        return (pts[i] * (1 - u) + pts[i + 1] * u).astype(np.float32)

    def GetLocalPos(self, step: float) -> np.ndarray:
        return self.GetPos(step)

    def IsDirty(self) -> bool:
        return self._curve_dirty
