"""Keyframe animation controllers: the 11 controller types of the reference
(RCKKeyframeData, include/RCKKeyframeData.h:10-306, src/CKKeyframeData.cpp)

    Linear / TCB / Bezier x {position, scale}
    Linear / TCB         x {rotation, scaleAxis}
    morph

The host controller objects hold numpy key arrays and precompute the
interpolation coefficients (TCB tangents, Bezier control points) whenever
keys change, as ``ckrenderengine_tpu.anim.keyframe`` does. The device
evaluation is written batched over the A tracks of a bank with torch tensor
ops: every lane evaluates every mode (linear, TCB, Bezier; slerp, squad) and
the track's mode selects one, so a guarded division in an unselected lane
stays finite. All tracks are padded to a common key count K; ``n_keys``
masks the tail, whose times are 3e38.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.vxmath import (
    np_quat_conj, np_quat_exp, np_quat_log, np_quat_mul, np_quat_slerp,
    np_quat_squad, quat_slerp, quat_squad,
)

# Interpolation modes (per track)
INTERP_LINEAR = 0
INTERP_TCB = 1      # hermite with precomputed tangents
INTERP_BEZIER = 2   # cubic bezier with precomputed control points


# ---------------------------------------------------------------------------
# Device evaluation, batched over tracks
# ---------------------------------------------------------------------------

def _at(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(A,K,...) rows picked per track by (A,) key indices -> (A,...)."""
    i = idx.reshape((-1, 1) + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, i.expand((a.shape[0], 1) + a.shape[2:])
                        ).squeeze(1)


def _segment(times: torch.Tensor, t, n_keys: torch.Tensor):
    """Segment [i, i+1] holding t on each track -> (i (A,), u (A,)).

    times (A,K), t a float or (A,) tensor, n_keys (A,). A K-wide compare
    and sum (``searchsorted(times, t, side="right") - 1`` on the padded
    ascending rows): the padded tail of 3e38 never counts. Clamps to the
    track's range."""
    if isinstance(t, torch.Tensor) and t.dim() == 1:
        t = t[:, None]
    last = torch.clamp(n_keys, min=1) - 1
    idx = (times <= t).sum(dim=1) - 1
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(last - 1, min=0))
    t0 = _at(times, idx)
    t1 = _at(times, torch.minimum(idx + 1, last))
    if isinstance(t, torch.Tensor):
        t = t[:, 0]
    dt = t1 - t0
    ok = dt > 1e-12
    u = torch.where(ok, (t - t0) / torch.where(ok, dt, 1.0), 0.0)
    u = torch.clamp(u, 0.0, 1.0)
    # Before the first key, and single-key tracks: clamp to the key.
    u = torch.where(t <= times[:, 0], 0.0, u)
    u = torch.where(n_keys <= 1, 0.0, u)
    return idx, u


def ease_curve(u, ease_to, ease_from):
    """Segment-parameter easing (reference ApplyEaseParameters,
    src/CKKeyframeData.cpp:14-37): hermite remap of u with departure slope
    (1 - ease_from) at the segment's start key and arrival slope
    (1 - ease_to) at its end key, renormalized when their sum exceeds 1.
    The defaults (0, 0) are the exact identity."""
    s = ease_to + ease_from
    scale = torch.where(s > 1.0, 1.0 / torch.clamp(s, min=1e-30), 1.0)
    et = ease_to * scale
    ef = ease_from * scale
    u2 = u * u
    u3 = u2 * u
    h2 = -2 * u3 + 3 * u2
    h3 = u3 - 2 * u2 + u
    h4 = u3 - u2
    return h2 + h3 * (1.0 - ef) + h4 * (1.0 - et)


def np_ease_curve(u: float, ease_to: float, ease_from: float) -> float:
    s = ease_to + ease_from
    if s > 1.0:
        ease_to, ease_from = ease_to / s, ease_from / s
    u2, u3 = u * u, u * u * u
    h2 = -2 * u3 + 3 * u2
    h3 = u3 - 2 * u2 + u
    h4 = u3 - u2
    return h2 + h3 * (1.0 - ease_from) + h4 * (1.0 - ease_to)


def _ends(n_keys, idx):
    return torch.minimum(idx + 1, torch.clamp(n_keys - 1, min=0))


def eval_vector_track(times, values, tan_in, tan_out, mode, ease, n_keys, t):
    """A D-dim tracks at time t -> (A,D).

    times (A,K), values (A,K,D), tan_in/tan_out (A,K,D) (TCB tangents or
    Bezier control points), mode (A,), ease (A,K,2) per key (ease_to,
    ease_from), n_keys (A,)."""
    idx, u = _segment(times, t, n_keys)
    i1 = _ends(n_keys, idx)
    v0 = _at(values, idx)
    v1 = _at(values, i1)
    uu = u[:, None]

    lin = v0 + (v1 - v0) * uu

    # TCB: eased u + hermite basis; outgoing tangent of key idx, incoming of
    # key idx+1 (reference TCB Evaluate, src/CKKeyframeData.cpp:939).
    ue = ease_curve(u, _at(ease[..., 0], i1), _at(ease[..., 1], idx))[:, None]
    u2 = ue * ue
    u3 = u2 * ue
    h1 = 2 * u3 - 3 * u2 + 1
    h2 = -2 * u3 + 3 * u2
    h3 = u3 - 2 * u2 + ue
    h4 = u3 - u2
    tout0 = _at(tan_out, idx)
    tin1 = _at(tan_in, i1)
    tcb = h1 * v0 + h2 * v1 + h3 * tout0 + h4 * tin1

    # Cubic Bezier: control points tan_out[idx] (after v0) and tan_in[i1]
    # (before v1).
    iu = 1.0 - uu
    bez = (iu * iu * iu * v0 + 3 * iu * iu * uu * tout0
           + 3 * iu * uu * uu * tin1 + uu * uu * uu * v1)

    m = mode[:, None]
    return torch.where(m == INTERP_LINEAR, lin,
                       torch.where(m == INTERP_TCB, tcb, bez))


def eval_quat_track(times, quats, tan_a, tan_b, mode, ease, n_keys, t):
    """A quaternion tracks at time t -> (A,4): slerp (linear mode) or TCB
    squad easing. quats (A,K,4) xyzw; tan_a/tan_b (A,K,4) squad control
    quaternions (outgoing / incoming, from tcb_quat_tangents)."""
    idx, u = _segment(times, t, n_keys)
    i1 = _ends(n_keys, idx)
    q0 = _at(quats, idx)
    q1 = _at(quats, i1)
    lin = quat_slerp(q0, q1, u[:, None])
    ue = ease_curve(u, _at(ease[..., 0], i1), _at(ease[..., 1], idx))
    sq = quat_squad(q0, _at(tan_a, idx), _at(tan_b, i1), q1, ue[:, None])
    return torch.where((mode == INTERP_TCB)[:, None], sq, lin)


def eval_morph(times, vertex_keys, normal_keys, n_keys, t):
    """Morph controller: lerp full vertex/normal arrays between keys.

    times (K,), vertex_keys and normal_keys (K,V,3), n_keys an int (one
    track; reference morph controller, include/RCKKeyframeData.h)."""
    nk = torch.as_tensor([n_keys], device=times.device)
    idx, u = _segment(times[None], t, nk)
    i1 = _ends(nk, idx)
    uu = u[0]
    verts = vertex_keys[idx[0]] * (1.0 - uu) + vertex_keys[i1[0]] * uu
    n = normal_keys[idx[0]] * (1.0 - uu) + normal_keys[i1[0]] * uu
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    return verts, n


# ---------------------------------------------------------------------------
# Host controllers
# ---------------------------------------------------------------------------

def tcb_tangents(times: np.ndarray, values: np.ndarray, tcb: np.ndarray):
    """Kochanek-Bartels incoming/outgoing tangents.

    tcb (K,3): per-key (tension, continuity, bias). Standard TCB formulas
    (the reference computes these lazily in the TCB controllers,
    src/CKKeyframeData.cpp)."""
    k = times.shape[0]
    tin = np.zeros_like(values)
    tout = np.zeros_like(values)
    if k < 2:
        return tin, tout
    for i in range(k):
        t_, c, b = tcb[i]
        p = values[i]
        pm = values[i - 1] if i > 0 else values[i]
        pp = values[i + 1] if i < k - 1 else values[i]
        d0 = p - pm
        d1 = pp - p
        tin[i] = ((1 - t_) * (1 - c) * (1 + b) * 0.5) * d0 + \
                 ((1 - t_) * (1 + c) * (1 - b) * 0.5) * d1
        tout[i] = ((1 - t_) * (1 + c) * (1 + b) * 0.5) * d0 + \
                  ((1 - t_) * (1 - c) * (1 - b) * 0.5) * d1
        # Adjust for non-uniform key spacing.
        if 0 < i < k - 1:
            dt0 = times[i] - times[i - 1]
            dt1 = times[i + 1] - times[i]
            denom = dt0 + dt1
            if denom > 1e-12:
                tin[i] *= 2 * dt0 / denom
                tout[i] *= 2 * dt1 / denom
    return tin, tout


class AnimController:
    """Base controller: sorted (time, value) keys, lazy coefficient build.

    API mirror of CKAnimController (AddKey/RemoveKey/Evaluate/GetKey/Compare,
    reference include/RCKKeyframeData.h)."""

    DIM = 3
    MODE = INTERP_LINEAR

    def __init__(self):
        self.times = np.zeros(0, np.float32)
        self.values = np.zeros((0, self.DIM), np.float32)
        self._tcb = np.zeros((0, 3), np.float32)     # tension/continuity/bias
        self._ease = np.zeros((0, 2), np.float32)    # (ease_to, ease_from)
        self._tan_in = None
        self._tan_out = None
        self._version = 0       # bumped on any key edit (bank staleness key)

    # -- key editing ------------------------------------------------------
    def AddKey(self, time: float, value, tcb=(0.0, 0.0, 0.0),
               ease=(0.0, 0.0)):
        value = np.asarray(value, np.float32).reshape(self.DIM)
        i = int(np.searchsorted(self.times, time))
        if i < len(self.times) and abs(self.times[i] - time) < 1e-9:
            self.values[i] = value
            self._tcb[i] = tcb
            self._ease[i] = ease
        else:
            self.times = np.insert(self.times, i, np.float32(time))
            self.values = np.insert(self.values, i, value, axis=0)
            self._tcb = np.insert(self._tcb, i, np.asarray(tcb, np.float32), axis=0)
            self._ease = np.insert(self._ease, i, np.asarray(ease, np.float32),
                                   axis=0)
        self._dirty()
        return i

    def RemoveKey(self, index: int):
        self.times = np.delete(self.times, index)
        self.values = np.delete(self.values, index, axis=0)
        self._tcb = np.delete(self._tcb, index, axis=0)
        self._ease = np.delete(self._ease, index, axis=0)
        self._dirty()

    def GetKeyCount(self) -> int:
        return int(self.times.shape[0])

    def GetKey(self, index: int):
        return float(self.times[index]), self.values[index].copy()

    def GetLength(self) -> float:
        return float(self.times[-1]) if len(self.times) else 0.0

    def Clone(self):
        c = type(self)()
        c.times = self.times.copy()
        c.values = self.values.copy()
        c._tcb = self._tcb.copy()
        c._ease = self._ease.copy()
        return c

    def Compare(self, other, threshold: float = 0.0) -> bool:
        if self.GetKeyCount() != other.GetKeyCount():
            return False
        if not np.allclose(self.times, other.times, atol=1e-6):
            return False
        return bool(np.allclose(self.values, other.values, atol=max(threshold, 1e-6)))

    def _dirty(self):
        self._tan_in = None
        self._tan_out = None
        self._version += 1

    # -- coefficients -----------------------------------------------------
    def _coeffs(self):
        if self._tan_in is None:
            if self.MODE == INTERP_TCB:
                self._tan_in, self._tan_out = tcb_tangents(
                    self.times, self.values, self._tcb)
            elif self.MODE == INTERP_BEZIER:
                # Default Bezier control points: 1/3 along catmull-rom tangents
                # (overridable per key via SetControlPoints).
                tin, tout = tcb_tangents(self.times, self.values,
                                         np.zeros_like(self._tcb))
                self._tan_out = self.values + tout / 3.0
                self._tan_in = self.values - tin / 3.0
            else:
                self._tan_in = np.zeros_like(self.values)
                self._tan_out = np.zeros_like(self.values)
        return self._tan_in, self._tan_out

    def SetControlPoints(self, index: int, cp_in, cp_out):
        """Bezier: explicit control points around key `index`."""
        self._coeffs()
        self._tan_in[index] = np.asarray(cp_in, np.float32)
        self._tan_out[index] = np.asarray(cp_out, np.float32)
        self._version += 1

    # -- evaluation (numpy: host-path ticks must not dispatch to device) ---
    def _segment_np(self, t: float):
        k = self.GetKeyCount()
        last = k - 1
        idx = int(np.searchsorted(self.times, t, side="right")) - 1
        idx = int(np.clip(idx, 0, max(last - 1, 0)))
        t0 = float(self.times[idx])
        t1 = float(self.times[min(idx + 1, last)])
        dt = t1 - t0
        u = (t - t0) / dt if dt > 1e-12 else 0.0
        u = float(np.clip(u, 0.0, 1.0))
        if t <= self.times[0] or k <= 1:
            u = 0.0
        return idx, u

    def Evaluate(self, t: float) -> np.ndarray:
        if self.GetKeyCount() == 0:
            return np.zeros(self.DIM, np.float32)
        tin, tout = self._coeffs()
        idx, u = self._segment_np(float(t))
        i1 = min(idx + 1, self.GetKeyCount() - 1)
        v0, v1 = self.values[idx], self.values[i1]
        if self.MODE == INTERP_LINEAR:
            return (v0 + (v1 - v0) * u).astype(np.float32)
        if self.MODE == INTERP_TCB:
            u = np_ease_curve(u, float(self._ease[i1, 0]),
                              float(self._ease[idx, 1]))
            u2, u3 = u * u, u * u * u
            h1 = 2 * u3 - 3 * u2 + 1
            h2 = -2 * u3 + 3 * u2
            h3 = u3 - 2 * u2 + u
            h4 = u3 - u2
            return (h1 * v0 + h2 * v1 + h3 * tout[idx]
                    + h4 * tin[i1]).astype(np.float32)
        u2, u3 = u * u, u * u * u
        iu = 1.0 - u
        return (iu ** 3 * v0 + 3 * iu * iu * u * tout[idx]
                + 3 * iu * u2 * tin[i1] + u3 * v1).astype(np.float32)

    # -- API-surface parity batch (reference include/RCKKeyframeData.h) ---
    def ComputeTangents(self):
        """Force the TCB tangent (or default Bezier control-point) rebuild
        (reference TCB/Bezier controllers' lazy ComputeTangents /
        ComputeBezierPts)."""
        self._dirty()
        return self._coeffs()

    def ComputeBezierPts(self):
        return self.ComputeTangents()

    def ComputeKeyDistance(self) -> float:
        """Total polyline length through the keys (the reference uses this
        for root-motion velocity normalization)."""
        if self.GetKeyCount() < 2:
            return 0.0
        d = np.diff(self.values, axis=0)
        return float(np.sqrt((d * d).sum(-1)).sum())

    def DumpKeysTo(self) -> bytes:
        """Serialize the key set to a byte buffer (reference DumpKeysTo —
        the CKStateChunk memory-dump path)."""
        import struct
        k = self.GetKeyCount()
        out = [struct.pack("<iii", k, self.DIM, self.MODE)]
        out.append(self.times.astype("<f4").tobytes())
        out.append(self.values.astype("<f4").tobytes())
        out.append(self._tcb.astype("<f4").tobytes())
        out.append(self._ease.astype("<f4").tobytes())
        return b"".join(out)

    def ReadKeysFrom(self, raw: bytes) -> int:
        """Restore keys from a DumpKeysTo buffer; returns bytes consumed."""
        import struct
        k, dim, _mode = struct.unpack_from("<iii", raw, 0)
        if dim != self.DIM:
            raise ValueError(f"key dim {dim} != controller dim {self.DIM}")
        off = 12
        self.times = np.frombuffer(raw, "<f4", k, off).copy()
        off += 4 * k
        self.values = np.frombuffer(raw, "<f4", k * dim, off).reshape(
            k, dim).copy()
        off += 4 * k * dim
        self._tcb = np.frombuffer(raw, "<f4", k * 3, off).reshape(k, 3).copy()
        off += 4 * k * 3
        self._ease = np.frombuffer(raw, "<f4", k * 2, off).reshape(k, 2).copy()
        off += 4 * k * 2
        self._dirty()
        return off

    # -- padded bank row --------------------------------------------------
    def bank_row(self, pad_keys: int):
        """(times, values, tan_in, tan_out, mode, ease, n_keys) padded to
        pad_keys."""
        tin, tout = self._coeffs()
        k = self.GetKeyCount()

        def pad(a, fill=0.0):
            out = np.full((pad_keys,) + a.shape[1:], fill, np.float32)
            out[:k] = a
            return out

        # Pad times with a huge increasing tail so searchsorted stays sane.
        times = np.full(pad_keys, 3.0e38, np.float32)
        times[:k] = self.times
        return (times, pad(self.values), pad(tin), pad(tout),
                np.int32(self.MODE), pad(self._ease), np.int32(k))


class LinearPositionController(AnimController):
    DIM, MODE = 3, INTERP_LINEAR


class LinearScaleController(AnimController):
    DIM, MODE = 3, INTERP_LINEAR


class TCBPositionController(AnimController):
    DIM, MODE = 3, INTERP_TCB


class TCBScaleController(AnimController):
    DIM, MODE = 3, INTERP_TCB


class BezierPositionController(AnimController):
    DIM, MODE = 3, INTERP_BEZIER


class BezierScaleController(AnimController):
    DIM, MODE = 3, INTERP_BEZIER


def tcb_quat_tangents(times: np.ndarray, quats: np.ndarray, tcb: np.ndarray):
    """Squad control quaternions with Kochanek-Bartels T/C/B weighting.

    Returns (q, a, b): keys pre-flipped for shortest-path continuity, plus
    per-key outgoing (a) / incoming (b) squad control quats. Derivation: in
    the tangent space of key i, let gp = log(q_i^-1 q_{i-1}) and
    gn = log(q_i^-1 q_{i+1}); the KB tangents weight -gp and gn with the
    standard (1-t)(1+-c)(1+-b)/2 factors, and matching squad's endpoint
    derivatives gives a_i = q_i exp((d_out - gn)/2),
    b_i = q_i exp((-s_in - gp)/2). With T=C=B=0 both reduce to the classic
    squad tangent q_i exp(-(gp+gn)/4).

    Behavioral note vs src/CKKeyframeData.cpp:1134-1180: the
    decompiled ComputeTangents derives (1-tension)/2 factors but never
    applies them (dead stores) and uses slerp(0.5, prev, next) for both
    tangents; this implementation honors the keys' T/C/B data — the
    documented semantics those fields exist for."""
    k = times.shape[0]
    q = quats.astype(np.float32).copy()
    for i in range(1, k):
        if float(np.dot(q[i - 1], q[i])) < 0.0:
            q[i] = -q[i]
    a = np.tile(np.array([0, 0, 0, 1], np.float32), (k, 1))
    b = a.copy()
    if k < 2:
        return q, a, b
    for i in range(k):
        qc = q[i]
        qp = q[i - 1] if i > 0 else qc
        qn = q[i + 1] if i < k - 1 else qc
        inv = np_quat_conj(qc)
        gp = np_quat_log(np_quat_mul(inv, qp))
        gn = np_quat_log(np_quat_mul(inv, qn))
        t_, c, b_ = (float(x) for x in tcb[i])
        fa = (1 - t_) * (1 + c) * (1 + b_) * 0.5
        fb = (1 - t_) * (1 - c) * (1 - b_) * 0.5
        fc = (1 - t_) * (1 - c) * (1 + b_) * 0.5
        fd = (1 - t_) * (1 + c) * (1 - b_) * 0.5
        d_out = -fa * gp + fb * gn
        s_in = -fc * gp + fd * gn
        if 0 < i < k - 1:
            dt0 = float(times[i] - times[i - 1])
            dt1 = float(times[i + 1] - times[i])
            denom = dt0 + dt1
            if denom > 1e-12:
                s_in = s_in * (2 * dt0 / denom)
                d_out = d_out * (2 * dt1 / denom)
        a[i] = np_quat_mul(qc, np_quat_exp((d_out - gn) * 0.5))
        b[i] = np_quat_mul(qc, np_quat_exp((-s_in - gp) * 0.5))
    return q, a, b


class RotationController(AnimController):
    """Linear rotation: slerp between quaternion keys (x,y,z,w)."""

    DIM = 4
    MODE = INTERP_LINEAR

    def _coeffs(self):
        """Route the base coefficient API to the quaternion tangents (keeps
        ComputeTangents() from building meaningless 4-d vector tangents)."""
        _qf, a, b = self._quat_coeffs()
        return b, a

    def _quat_coeffs(self):
        """(preflipped keys, tan_a (out), tan_b (in)) — cached."""
        if self._tan_in is None:
            if self.MODE == INTERP_TCB and self.GetKeyCount() >= 2:
                qf, a, b = tcb_quat_tangents(self.times, self.values,
                                             self._tcb)
            else:
                qf = self.values.astype(np.float32).copy()
                a = np.tile(np.array([0, 0, 0, 1], np.float32),
                            (self.GetKeyCount(), 1))
                b = a.copy()
            self._qflip = qf
            self._tan_out = a      # outgoing squad control
            self._tan_in = b       # incoming squad control
        return self._qflip, self._tan_out, self._tan_in

    def Evaluate(self, t: float) -> np.ndarray:
        if self.GetKeyCount() == 0:
            return np.array([0, 0, 0, 1], np.float32)
        idx, u = self._segment_np(float(t))
        i1 = min(idx + 1, self.GetKeyCount() - 1)
        if self.MODE != INTERP_TCB or self.GetKeyCount() < 2:
            return np_quat_slerp(self.values[idx], self.values[i1], u)
        qf, a, b = self._quat_coeffs()
        u = np_ease_curve(u, float(self._ease[i1, 0]),
                          float(self._ease[idx, 1]))
        return np_quat_squad(qf[idx], a[idx], b[i1], qf[i1], u)

    def bank_row(self, pad_keys: int):
        """(times, quats, tan_a, tan_b, mode, ease, n_keys)."""
        qf, a, b = self._quat_coeffs()
        k = self.GetKeyCount()
        times = np.full(pad_keys, 3.0e38, np.float32)
        times[:k] = self.times

        def padq(src):
            out = np.zeros((pad_keys, 4), np.float32)
            out[:, 3] = 1.0
            out[:k] = src
            return out

        ease = np.zeros((pad_keys, 2), np.float32)
        ease[:k] = self._ease
        return (times, padq(qf), padq(a), padq(b), np.int32(self.MODE),
                ease, np.int32(k))


class TCBRotationController(RotationController):
    """TCB rotation: squad easing with per-key tension/continuity/bias and
    ease-to/ease-from (see tcb_quat_tangents; reference
    src/CKKeyframeData.cpp:1134-1210)."""
    MODE = INTERP_TCB


class LinearScaleAxisController(RotationController):
    """Scale-axis (quaternion) controller."""


class TCBScaleAxisController(RotationController):
    MODE = INTERP_TCB


class MorphController:
    """Morph controller: keyed full vertex (+normal) arrays
    (reference RCKKeyframeData morph evaluation)."""

    def __init__(self, vertex_count: int):
        self.vertex_count = int(vertex_count)
        self.times = np.zeros(0, np.float32)
        self.vertex_keys = np.zeros((0, vertex_count, 3), np.float32)
        self.normal_keys = np.zeros((0, vertex_count, 3), np.float32)

    def AddKey(self, time: float, vertices, normals=None):
        vertices = np.asarray(vertices, np.float32).reshape(self.vertex_count, 3)
        if normals is None:
            normals = np.zeros_like(vertices)
        i = int(np.searchsorted(self.times, time))
        self.times = np.insert(self.times, i, np.float32(time))
        self.vertex_keys = np.insert(self.vertex_keys, i, vertices, axis=0)
        self.normal_keys = np.insert(
            self.normal_keys, i, np.asarray(normals, np.float32), axis=0)
        return i

    def GetKeyCount(self) -> int:
        return int(self.times.shape[0])

    def GetMorphVertexCount(self) -> int:
        return self.vertex_count

    def SetMorphVertexCount(self, n: int):
        """Resize the per-key vertex arrays (reference SetMorphVertexCount);
        existing keys are truncated or zero-padded."""
        n = int(n)
        if n == self.vertex_count:
            return
        k = self.GetKeyCount()
        for attr in ("vertex_keys", "normal_keys"):
            old = getattr(self, attr)
            new = np.zeros((k, n, 3), np.float32)
            new[:, :min(n, self.vertex_count)] = old[:, :min(n, self.vertex_count)]
            setattr(self, attr, new)
        self.vertex_count = n

    def HasNormalInfo(self) -> bool:
        return bool(self.normal_keys.size and np.any(self.normal_keys))

    def GetLength(self) -> float:
        return float(self.times[-1]) if len(self.times) else 0.0

    def Evaluate(self, t: float):
        if self.GetKeyCount() == 0:
            return None, None
        k = self.GetKeyCount()
        idx = int(np.clip(np.searchsorted(self.times, t, side="right") - 1,
                          0, max(k - 2, 0)))
        i1 = min(idx + 1, k - 1)
        t0, t1 = float(self.times[idx]), float(self.times[i1])
        u = (t - t0) / (t1 - t0) if t1 - t0 > 1e-12 else 0.0
        u = float(np.clip(u, 0.0, 1.0))
        if t <= self.times[0] or k <= 1:
            u = 0.0
        v = self.vertex_keys[idx] * (1 - u) + self.vertex_keys[i1] * u
        n = self.normal_keys[idx] * (1 - u) + self.normal_keys[i1] * u
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(ln, 1e-12)
        return v.astype(np.float32), n.astype(np.float32)
