"""Inverse kinematics: a damped-least-squares Jacobian solve over a chain of
body parts.

API mirror of RCKKinematicChain (reference src/CKKinematicChain.cpp,
include/RCKKinematicChain.h: SVDDecompose / SVDSolve, IKRotateToward with
joint-limit clamping). Chains are short (tens of joints), so the iteration
loop walks the chain on the host (numpy, through the ``np_*`` twins of
``math/vxmath.py``); each iteration's (3, M) Jacobian is factored by
``torch.linalg.svd`` on the chain's context device, and its joint angles
come back to the host once per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import vxmath as vx
from ..objects.base import CKCID_KINEMATICCHAIN, CKObject


class IKJointData:
    """Per-joint constraints (reference 116-byte per-body IK data: joint
    limits, saved local transforms, locked flags)."""

    def __init__(self):
        self.active_x = True
        self.active_y = True
        self.active_z = True
        self.limit = False
        self.min_angles = np.full(3, -np.pi, np.float32)
        self.max_angles = np.full(3, np.pi, np.float32)
        self.locked = False
        self.saved_local = None

    def SetLimits(self, mins, maxs):
        self.limit = True
        self.min_angles = np.asarray(mins, np.float32)
        self.max_angles = np.asarray(maxs, np.float32)


class CKKinematicChain(CKObject):
    CLASS_ID = CKCID_KINEMATICCHAIN

    def __init__(self, context, name: str = ""):
        super().__init__(context, name)
        self.start = None                # start effector (fixed end)
        self.end = None                  # end effector (moved toward target)
        self._chain: list = []           # start..end body parts

    # -- chain construction -------------------------------------------------
    def SetStartEffector(self, part):
        self.start = part
        self._rebuild()

    def SetEndEffector(self, part):
        self.end = part
        self._rebuild()

    def GetStartEffector(self):
        return self.start

    def GetEndEffector(self):
        return self.end

    def GetChainBodyCount(self) -> int:
        return len(self._chain)

    def GetChainBody(self, i: int):
        return self._chain[i]

    def _rebuild(self):
        self._chain = []
        if self.start is None or self.end is None:
            return
        # Walk up from end to start.
        chain = []
        e = self.end
        while e is not None:
            chain.append(e)
            if e is self.start:
                break
            e = e.GetParent()
        else:
            self._chain = []
            return
        self._chain = list(reversed(chain))
        for part in self._chain:
            if getattr(part, "rotation_joint", None) is None:
                part.rotation_joint = IKJointData()

    def GetEffector(self, start: bool = True):
        """Chain endpoint accessor (reference GetEffector)."""
        return self.start if start else self.end

    def IKRotateToward(self, part, target_world, max_angle: float = 3.14159):
        """Rotate ONE joint so its end-effector direction moves toward the
        target, clamped to the joint limits (reference IKRotateToward)."""
        if self.end is None or part not in self._chain:
            return False
        jpos = part.GetWorldMatrix()[3, :3]
        epos = self.end.GetWorldMatrix()[3, :3]
        t = np.asarray(target_world, np.float32)
        v1 = epos - jpos
        v2 = t - jpos
        n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if n1 < 1e-9 or n2 < 1e-9:
            return False
        v1, v2 = v1 / n1, v2 / n2
        axis = np.cross(v1, v2)
        na = np.linalg.norm(axis)
        if na < 1e-9:
            return True
        angle = float(np.clip(np.arccos(np.clip(v1 @ v2, -1, 1)),
                              -max_angle, max_angle))
        self._rotate_joint(part, axis / na, angle)
        jd = getattr(part, "rotation_joint", None)
        if jd is not None:
            m = part.GetLocalMatrix()
            part.SetLocalMatrix(self._clamp_limits(m, jd))
        return True

    def GetChainLength(self) -> float:
        """Sum of segment lengths."""
        total = 0.0
        for a, b in zip(self._chain, self._chain[1:]):
            pa = a.GetWorldMatrix()[3, :3]
            pb = b.GetWorldMatrix()[3, :3]
            total += float(np.linalg.norm(pb - pa))
        return total

    # -- solve ---------------------------------------------------------------
    def IKSetEffectorPos(self, target, ref=None, max_iterations: int = 16,
                         tolerance: float = 1e-3, damping: float = 0.1) -> bool:
        """Move the end effector toward ``target`` (world or ref space) by
        damped-least-squares Jacobian iterations over the chain's rotational
        joints (reference IKSetEffectorPos -> SVDSolve)."""
        target = np.asarray(target, np.float32)
        if ref is not None:
            w = ref.GetWorldMatrix()
            target = target @ w[:3, :3] + w[3, :3]
        if len(self._chain) < 2:
            return False
        joints = self._chain[:-1]        # rotating joints (end effector rides)

        for _ in range(max_iterations):
            eff = self._chain[-1].GetWorldMatrix()[3, :3]
            err = target - eff
            if float(np.linalg.norm(err)) < tolerance:
                return True
            # Jacobian: J[:, k] = axis_k x (eff - joint_k) for 3 world axes
            # per joint (axis-active flags mask columns).
            cols = []
            meta = []
            for j, part in enumerate(joints):
                jw = part.GetWorldMatrix()
                jpos = jw[3, :3]
                jd = part.rotation_joint
                for ax in range(3):
                    if not (jd.active_x, jd.active_y, jd.active_z)[ax] or jd.locked:
                        continue
                    axis = jw[ax, :3]
                    n = np.linalg.norm(axis)
                    if n < 1e-9:
                        continue
                    axis = axis / n
                    cols.append(np.cross(axis, eff - jpos))
                    meta.append((j, axis))
            if not cols:
                return False
            dev = self.context.device
            J = torch.as_tensor(np.stack(cols, axis=1), device=dev)  # (3, M)
            # Damped least squares via SVD: dtheta = V (S/(S^2+l^2)) U^T err.
            U, S, Vt = torch.linalg.svd(J, full_matrices=False)
            inv_s = S / (S * S + damping * damping)
            dtheta = (Vt.T @ (inv_s * (U.T @ torch.as_tensor(
                err, device=dev)))).cpu().numpy()
            # Apply per-joint rotations, clamped to a max per-iteration step
            # to keep the linearization valid.
            step = float(np.abs(dtheta).max())
            scale = 1.0 if step <= 0.25 else 0.25 / step
            for (j, axis), ang in zip(meta, dtheta):
                part = joints[j]
                self._rotate_joint(part, axis, float(ang) * scale)
        eff = self._chain[-1].GetWorldMatrix()[3, :3]
        return float(np.linalg.norm(target - eff)) < tolerance

    def _rotate_joint(self, part, world_axis, angle):
        """IKRotateToward: rotate a joint about a world axis with joint-limit
        clamping (Euler-box clamp of the resulting local rotation)."""
        if abs(angle) < 1e-12:
            return
        pw = (part.GetParent().GetWorldMatrix() if part.GetParent() is not None
              else np.eye(4, dtype=np.float32))
        # World-axis rotation -> local space.
        local_axis = world_axis @ np.linalg.inv(pw[:3, :3])
        n = np.linalg.norm(local_axis)
        if n < 1e-9:
            return
        local_axis /= n
        r = vx.np_rotation_axis_angle(local_axis, angle)
        m = part.GetLocalMatrix()
        rot = m.copy()
        rot[:3, :3] = m[:3, :3] @ r[:3, :3]
        jd = part.rotation_joint
        if jd is not None and jd.limit:
            rot = self._clamp_limits(rot, jd)
        part.SetLocalMatrix(rot)

    @staticmethod
    def _clamp_limits(m: np.ndarray, jd: IKJointData) -> np.ndarray:
        """Clamp the local rotation to the joint's Euler-angle box."""
        p, q, s = vx.np_decompose_prs(m)
        q = np.asarray(q)
        # quat -> xyz euler
        x, y, z, w = q
        sinr = 2 * (w * x + y * z)
        cosr = 1 - 2 * (x * x + y * y)
        ex = np.arctan2(sinr, cosr)
        sinp = np.clip(2 * (w * y - z * x), -1, 1)
        ey = np.arcsin(sinp)
        siny = 2 * (w * z + x * y)
        cosy = 1 - 2 * (y * y + z * z)
        ez = np.arctan2(siny, cosy)
        e = np.clip([ex, ey, ez], jd.min_angles, jd.max_angles)
        cx, cy, cz = np.cos(e / 2)
        sx, sy, sz = np.sin(e / 2)
        q2 = np.array([
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ], np.float32)
        return vx.np_compose_prs(p, q2, s)


def SVDDecompose(m):
    """U, s, Vt of an arbitrary matrix (reference RCKKinematicChain::
    SVDDecompose — the Jacobian factorization step)."""
    return np.linalg.svd(np.asarray(m, np.float64), full_matrices=False)


def SVDSolve(m, b, damping: float = 0.0):
    """Least-squares solve m @ x = b via the SVD with optional damped
    singular values (reference SVDSolve; damping is the DLS stabilizer)."""
    u, s, vt = SVDDecompose(m)
    if damping > 0.0:
        inv_s = s / (s * s + damping * damping)
    else:
        inv_s = np.where(s > 1e-12, 1.0 / np.maximum(s, 1e-12), 0.0)
    return (vt.T * inv_s) @ (u.T @ np.asarray(b, np.float64))
