"""Vectorized host-path clip evaluation: one numpy pass per tick.

The reference applies a keyed animation by looping its object animations and
rebuilding each entity's local matrix one at a time
(RCKKeyedAnimation::SetFrame -> RCKObjectAnimation::SetStep per member,
src/CKObjectAnimation.cpp:1674-1759). Per-call Python + numpy
overhead makes that O(bones) slow on the host (~10 ms for a 128-bone clip).

This module evaluates ALL simple member tracks of a clip in one vectorized
numpy pass and writes the entity table in one batched assignment — the host
twin of the device AnimBank (anim/bank.py), kept on the host so entity
queries (GetPosition etc.) stay exact between ticks.

"Simple" member animations (no merge sources, no morph, no scale-axis track)
take this path; the rest fall back to their per-animation SetStep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

INTERP_LINEAR, INTERP_TCB, INTERP_BEZIER = 0, 1, 2

_PAD_TIME = np.float32(3.0e38)


class HostAnimBank(NamedTuple):
    """Numpy mirror of anim.bank.AnimBank for A member animations."""

    rows: np.ndarray        # (A,) int64 entity-table rows
    ids: tuple              # entity ids (moved-list bookkeeping)
    # position track
    pos_times: np.ndarray   # (A,K)
    pos_values: np.ndarray  # (A,K,3)
    pos_tin: np.ndarray
    pos_tout: np.ndarray
    pos_mode: np.ndarray    # (A,)
    pos_n: np.ndarray       # (A,) int32 (0 = no track)
    # rotation track
    rot_times: np.ndarray   # (A,K)
    rot_quats: np.ndarray   # (A,K,4)
    rot_n: np.ndarray
    # scale track
    scl_times: np.ndarray
    scl_values: np.ndarray
    scl_tin: np.ndarray
    scl_tout: np.ndarray
    scl_mode: np.ndarray
    scl_n: np.ndarray
    signature: tuple        # controller versions; cheap staleness check


def _signature(anims) -> tuple:
    sig = []
    for a in anims:
        sig.append((
            id(a),
            a._entity.row if a._entity is not None else -1,
            a.position_controller._version if a.position_controller else -1,
            a.rotation_controller._version if a.rotation_controller else -1,
            a.scale_controller._version if a.scale_controller else -1,
        ))
    return tuple(sig)


def full_signature(anims) -> tuple:
    """Staleness key over EVERYTHING that can change the simple/rest
    partition or the packed bank rows: membership, entity binding, merge
    sources, and every controller's edit version (ease edits bump the
    version too). Cheap enough to recompute per tick (~attribute reads);
    the expensive is_simple()/build_host_bank() work only reruns when this
    tuple changes."""
    sig = []
    for a in anims:
        pc, rc_, sc = (a.position_controller, a.rotation_controller,
                       a.scale_controller)
        sax, mo = a.scale_axis_controller, a.morph_controller
        sig.append((
            id(a),
            a._entity.row if a._entity is not None else -1,
            id(a._merge_a) if a._merge_a is not None else 0,
            id(a._merge_b) if a._merge_b is not None else 0,
            pc._version if pc is not None else -1,
            rc_._version if rc_ is not None else -1,
            sc._version if sc is not None else -1,
            sax._version if sax is not None else -1,
            len(mo.times) if mo is not None else -1,
        ))
    return tuple(sig)


def is_simple(a) -> bool:
    """Eligible for the batched path (everything SetStep does beyond plain
    PRS -> matrix is absent)."""
    if a._entity is None or a._merge_a is not None or a._merge_b is not None:
        return False
    sax = a.scale_axis_controller
    if sax is not None and sax.GetKeyCount() > 0:
        return False
    mc = a.morph_controller
    if mc is not None and mc.GetKeyCount() > 0:
        return False
    # TCB-squad rotation and ease-warped tracks evaluate through the exact
    # per-animation SetStep path (anim/keyframe.py squad/ease) — this numpy
    # fast path only vectorizes plain lerp/hermite/slerp tracks.
    rc = a.rotation_controller
    if rc is not None and rc.MODE == INTERP_TCB and rc.GetKeyCount() >= 2:
        return False
    for c in (a.position_controller, rc, a.scale_controller):
        if c is not None and c.GetKeyCount() and np.any(c._ease):
            return False
    return True


def build_host_bank(anims) -> HostAnimBank:
    """Stack the padded bank rows of ``anims`` (all must satisfy
    :func:`is_simple`)."""
    a_n = len(anims)
    k = 1
    for a in anims:
        for c in (a.position_controller, a.rotation_controller,
                  a.scale_controller):
            if c is not None:
                k = max(k, c.GetKeyCount())

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    pt = np.full((a_n, k), _PAD_TIME, np.float32)
    pv, pi, po = zeros(a_n, k, 3), zeros(a_n, k, 3), zeros(a_n, k, 3)
    pm = np.zeros(a_n, np.int32)
    pn = np.zeros(a_n, np.int32)
    rt = np.full((a_n, k), _PAD_TIME, np.float32)
    rq = zeros(a_n, k, 4)
    rq[:, :, 3] = 1.0
    rn = np.zeros(a_n, np.int32)
    st = np.full((a_n, k), _PAD_TIME, np.float32)
    sv, si, so = zeros(a_n, k, 3), zeros(a_n, k, 3), zeros(a_n, k, 3)
    sm = np.zeros(a_n, np.int32)
    sn = np.zeros(a_n, np.int32)

    for i, a in enumerate(anims):
        c = a.position_controller
        if c is not None and c.GetKeyCount():
            t, v, ti, to, mode, _e, n = c.bank_row(k)
            pt[i], pv[i], pi[i], po[i], pm[i], pn[i] = t, v, ti, to, mode, n
        c = a.rotation_controller
        if c is not None and c.GetKeyCount():
            t, v, _ta, _tb, _m, _e, n = c.bank_row(k)
            rt[i], rq[i], rn[i] = t, v, n
        c = a.scale_controller
        if c is not None and c.GetKeyCount():
            t, v, ti, to, mode, _e, n = c.bank_row(k)
            st[i], sv[i], si[i], so[i], sm[i], sn[i] = t, v, ti, to, mode, n

    rows = np.asarray([a._entity.row for a in anims], np.int64)
    ids = tuple(a._entity.id for a in anims)
    return HostAnimBank(rows, ids, pt, pv, pi, po, pm, pn,
                        rt, rq, rn, st, sv, si, so, sm, sn,
                        _signature(anims))


def _segments(times: np.ndarray, n: np.ndarray, t: float):
    """Batched twin of AnimController._segment_np over (A,K) time rows."""
    k = times.shape[1]
    idx = (times <= t).sum(axis=1) - 1
    last = np.maximum(n - 1, 0)
    idx = np.clip(idx, 0, np.maximum(last - 1, 0))
    a = np.arange(times.shape[0])
    t0 = times[a, idx]
    t1 = times[a, np.minimum(idx + 1, last)]
    dt = t1 - t0
    with np.errstate(invalid="ignore"):
        u = np.where(dt > 1e-12, (t - t0) / np.where(dt > 1e-12, dt, 1.0), 0.0)
    u = np.clip(u, 0.0, 1.0)
    first = times[:, 0]
    u = np.where((t <= first) | (n <= 1), 0.0, u).astype(np.float32)
    return idx, u, last


def _eval_vector_tracks(times, values, tin, tout, mode, n, t):
    """(A,3) evaluation of linear/TCB/Bezier vector tracks at scalar t."""
    idx, u, last = _segments(times, n, t)
    a = np.arange(times.shape[0])
    i1 = np.minimum(idx + 1, last)
    v0, v1 = values[a, idx], values[a, i1]
    u = u[:, None]
    out = v0 + (v1 - v0) * u                     # linear
    if (mode == INTERP_TCB).any():
        u2, u3 = u * u, u * u * u
        h1 = 2 * u3 - 3 * u2 + 1
        h2 = -2 * u3 + 3 * u2
        h3 = u3 - 2 * u2 + u
        h4 = u3 - u2
        tcb = h1 * v0 + h2 * v1 + h3 * tout[a, idx] + h4 * tin[a, i1]
        out = np.where(mode[:, None] == INTERP_TCB, tcb, out)
    if (mode == INTERP_BEZIER).any():
        u2, u3 = u * u, u * u * u
        iu = 1.0 - u
        bez = (iu ** 3 * v0 + 3 * iu * iu * u * tout[a, idx]
               + 3 * iu * u2 * tin[a, i1] + u3 * v1)
        out = np.where(mode[:, None] == INTERP_BEZIER, bez, out)
    return out.astype(np.float32)


def _eval_quat_tracks(times, quats, n, t):
    """(A,4) batched slerp between adjacent keys (matches np_quat_slerp)."""
    idx, u, last = _segments(times, n, t)
    a = np.arange(times.shape[0])
    q0 = quats[a, idx]
    q1 = quats[a, np.minimum(idx + 1, last)]
    d = (q0 * q1).sum(axis=1)
    q1 = np.where(d[:, None] < 0, -q1, q1)
    d = np.abs(d)
    # near-parallel rows: nlerp
    lerp = q0 + (q1 - q0) * u[:, None]
    lerp /= np.maximum(np.linalg.norm(lerp, axis=1, keepdims=True), 1e-30)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    sth = np.maximum(np.sin(th), 1e-30)
    sl = (np.sin((1 - u) * th)[:, None] * q0
          + np.sin(u * th)[:, None] * q1) / sth[:, None]
    return np.where((d > 0.9995)[:, None], lerp, sl).astype(np.float32)


def np_quat_to_matrix3_batch(q: np.ndarray) -> np.ndarray:
    """(A,4) xyzw -> (A,3,3), batched twin of vxmath.np_quat_to_matrix3."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    m = np.empty((q.shape[0], 3, 3), np.float32)
    m[:, 0, 0] = 1 - 2 * (y * y + z * z)
    m[:, 0, 1] = 2 * (x * y + z * w)
    m[:, 0, 2] = 2 * (x * z - y * w)
    m[:, 1, 0] = 2 * (x * y - z * w)
    m[:, 1, 1] = 1 - 2 * (x * x + z * z)
    m[:, 1, 2] = 2 * (y * z + x * w)
    m[:, 2, 0] = 2 * (x * z + y * w)
    m[:, 2, 1] = 2 * (y * z - x * w)
    m[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def evaluate_host_bank(bank: HostAnimBank, t: float,
                       local: np.ndarray) -> np.ndarray:
    """All member locals at frame ``t`` -> (A,4,4).

    Missing tracks fall back to the entity's CURRENT local matrix parts
    (matching CKObjectAnimation.evaluate_prs, which decomposes the live
    matrix each call — not a build-time snapshot)."""
    cur = local[bank.rows]                          # (A,4,4)
    cur_s = np.linalg.norm(cur[:, :3, :3], axis=2)  # row norms
    cur_s = np.maximum(cur_s, 1e-30)

    has_p = bank.pos_n > 0
    has_r = bank.rot_n > 0
    has_s = bank.scl_n > 0

    if has_p.any():
        p = np.where(has_p[:, None],
                     _eval_vector_tracks(bank.pos_times, bank.pos_values,
                                         bank.pos_tin, bank.pos_tout,
                                         bank.pos_mode, bank.pos_n, t),
                     cur[:, 3, :3])
    else:
        p = cur[:, 3, :3]
    if has_s.any():
        s = np.where(has_s[:, None],
                     _eval_vector_tracks(bank.scl_times, bank.scl_values,
                                         bank.scl_tin, bank.scl_tout,
                                         bank.scl_mode, bank.scl_n, t),
                     cur_s)
    else:
        s = cur_s
    # Rotation: quat track where present, else the current normalized basis.
    r3 = np.empty((cur.shape[0], 3, 3), np.float32)
    if has_r.any():
        q = _eval_quat_tracks(bank.rot_times, bank.rot_quats, bank.rot_n, t)
        r3[has_r] = np_quat_to_matrix3_batch(q[has_r])
    if (~has_r).any():
        nr = ~has_r
        base = cur[nr, :3, :3] / cur_s[nr][:, :, None]
        # mirrored locals: decompose flips scale[0] to keep det(r)>0
        # (np_decompose_prs); recomposing r*s restores the original basis
        # either way, so no det fix is needed when the rot track is absent.
        r3[nr] = base
    m = np.zeros((cur.shape[0], 4, 4), np.float32)
    m[:, :3, :3] = r3 * s[:, :, None]
    m[:, 3, :3] = p
    m[:, 3, 3] = 1.0
    return m
