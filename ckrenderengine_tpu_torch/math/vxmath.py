"""VxMath-equivalent linear algebra: numpy host twins + torch device ops.

Conventions match ``ckrenderengine_tpu.math.vxmath`` (and the Virtools
VxMath library the reference engine is built on):

- Matrices are 4x4, **row-vector** convention: ``v' = v @ M``.
  Row 0..2 are the X/Y/Z basis axes, row 3 is the translation.
- Composition applies left-to-right: ``world = local @ parent_world``.
- Clip space is D3D-style left-handed: visible points satisfy
  ``-w <= x <= w``, ``-w <= y <= w``, ``0 <= z <= w``
  (CKRasterizerContext::TransformVertices,
  src/CKRasterizer/CKRasterizerLib/CKRasterizerContext.cpp:339-362).

The ``np_*`` functions serve per-tick host object-API math; the torch
functions run inside the frame. The torch point/vector transforms are
written as explicit per-component sums in a fixed order, so the CPU and the
CUDA build of a frame round every vertex the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Clip flags (Virtools VXCLIP_* semantics; values are the public SDK ones)
VXCLIP_LEFT = 0x010
VXCLIP_RIGHT = 0x020
VXCLIP_TOP = 0x040
VXCLIP_BOTTOM = 0x080
VXCLIP_FRONT = 0x100
VXCLIP_BACK = 0x200
VXCLIP_ALL = (VXCLIP_LEFT | VXCLIP_RIGHT | VXCLIP_TOP | VXCLIP_BOTTOM
              | VXCLIP_FRONT | VXCLIP_BACK)

# Box-visibility results (CKRasterizerContext::ComputeBoxVisibility,
# CKRasterizerLib/CKRasterizerContext.cpp:394-421)
CBV_OFFSCREEN = 0
CBV_VISIBLE = 1
CBV_ALLINSIDE = 3


# ---------------------------------------------------------------------------
# Numpy host twins
# ---------------------------------------------------------------------------

def np_rotation_axis_angle(axis, angle) -> np.ndarray:
    x, y, z = float(axis[0]), float(axis[1]), float(axis[2])
    n = math.sqrt(x * x + y * y + z * z)
    if n > 1e-30:
        x, y, z = x / n, y / n, z / n
    else:
        x, y, z = 0.0, 0.0, 1.0
    c = math.cos(angle)
    s = math.sin(angle)
    t = 1.0 - c
    return np.array([
        [t * x * x + c, t * x * y + s * z, t * x * z - s * y, 0.0],
        [t * x * y - s * z, t * y * y + c, t * y * z + s * x, 0.0],
        [t * x * z + s * y, t * y * z - s * x, t * z * z + c, 0.0],
        [0.0, 0.0, 0.0, 1.0]], np.float32)


def np_perspective(fov: float, aspect: float, near: float, far: float) -> np.ndarray:
    """fov is the HORIZONTAL field of view, aspect scales y (Virtools
    SetFov semantics)."""
    m = np.zeros((4, 4), np.float32)
    f = 1.0 / np.tan(fov * 0.5)
    m[0, 0] = f
    m[1, 1] = f * aspect
    m[2, 2] = far / (far - near)
    m[2, 3] = 1.0
    m[3, 2] = -near * far / (far - near)
    return m


def np_orthographic(zoom: float, aspect: float, near: float, far: float) -> np.ndarray:
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = zoom
    m[1, 1] = zoom * aspect
    m[2, 2] = 1.0 / (far - near)
    m[3, 2] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def np_quat_slerp(a, b, t: float) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = float(np.dot(a, b))
    if d < 0:
        b = -b
        d = -d
    if d > 0.9995:
        out = a + (b - a) * t
        return out / max(np.linalg.norm(out), 1e-30)
    th = np.arccos(np.clip(d, -1, 1))
    sth = np.sin(th)
    return (np.sin((1 - t) * th) * a + np.sin(t * th) * b) / sth


def np_quat_to_matrix3(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float32)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def np_compose_prs(pos, rot_q, scale) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    r = np_quat_to_matrix3(rot_q)
    s = np.asarray(scale, np.float32)
    m[:3, :3] = r * s[:, None]      # row-vector convention: row i * scale[i]
    m[3, :3] = np.asarray(pos, np.float32)
    return m


def np_quat_from_matrix3(r) -> np.ndarray:
    r = np.asarray(r, np.float32)
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (r[1, 2] - r[2, 1]) / s
        y = (r[2, 0] - r[0, 2]) / s
        z = (r[0, 1] - r[1, 0]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[1, 2] - r[2, 1]) / s
        x = 0.25 * s
        y = (r[1, 0] + r[0, 1]) / s
        z = (r[2, 0] + r[0, 2]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[2, 0] - r[0, 2]) / s
        x = (r[1, 0] + r[0, 1]) / s
        y = 0.25 * s
        z = (r[2, 1] + r[1, 2]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[0, 1] - r[1, 0]) / s
        x = (r[2, 0] + r[0, 2]) / s
        y = (r[2, 1] + r[1, 2]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float32)
    return q / max(np.linalg.norm(q), 1e-30)


def np_decompose_prs(m) -> tuple:
    m = np.asarray(m, np.float32)
    pos = m[3, :3].copy()
    scale = np.linalg.norm(m[:3, :3], axis=1)
    scale = np.where(scale < 1e-30, 1e-30, scale)
    r = m[:3, :3] / scale[:, None]
    if np.linalg.det(r) < 0:
        scale[0] = -scale[0]
        r = m[:3, :3] / scale[:, None]
    return pos, np_quat_from_matrix3(r), scale.astype(np.float32)


def np_quat_mul(a, b) -> np.ndarray:
    """Numpy twin of :func:`quat_multiply` (Hamilton product, xyzw)."""
    ax, ay, az, aw = np.asarray(a, np.float32)
    bx, by, bz, bw = np.asarray(b, np.float32)
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], np.float32)


def np_quat_conj(q) -> np.ndarray:
    q = np.asarray(q, np.float32)
    return q * np.array([-1, -1, -1, 1], np.float32)


def np_quat_log(q) -> np.ndarray:
    q = np.asarray(q, np.float32)
    q = q / max(np.linalg.norm(q), 1e-30)
    vn = float(np.linalg.norm(q[:3]))
    if vn < 1e-9:
        return q[:3].copy()
    phi = float(np.arctan2(vn, q[3]))
    return (q[:3] * (phi / vn)).astype(np.float32)


def np_quat_exp(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    phi = float(np.linalg.norm(v))
    if phi < 1e-9:
        return np.array([v[0], v[1], v[2], np.cos(phi)], np.float32)
    s = np.sin(phi) / phi
    return np.array([v[0] * s, v[1] * s, v[2] * s, np.cos(phi)], np.float32)


def np_quat_slerp_noflip(a, b, t: float) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = float(np.clip(np.dot(a, b), -1.0, 1.0))
    th = float(np.arccos(d))
    sth = np.sin(th)
    if abs(sth) < 1e-5:
        out = a + (b - a) * t
        return (out / max(np.linalg.norm(out), 1e-30)).astype(np.float32)
    out = (np.sin((1 - t) * th) * a + np.sin(t * th) * b) / sth
    return (out / max(np.linalg.norm(out), 1e-30)).astype(np.float32)


def np_quat_squad(q0, a, b, q1, t: float) -> np.ndarray:
    outer = np_quat_slerp_noflip(q0, q1, t)
    inner = np_quat_slerp_noflip(a, b, t)
    return np_quat_slerp_noflip(outer, inner, 2.0 * t * (1.0 - t))


def np_clip_flags(clip: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`clip_flags` (uint32 VXCLIP bits)."""
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    f = np.zeros(clip.shape[:-1], np.uint32)
    f |= np.where(-w > x, VXCLIP_LEFT, 0).astype(np.uint32)
    f |= np.where(x > w, VXCLIP_RIGHT, 0).astype(np.uint32)
    f |= np.where(-w > y, VXCLIP_BOTTOM, 0).astype(np.uint32)
    f |= np.where(y > w, VXCLIP_TOP, 0).astype(np.uint32)
    f |= np.where(z < 0.0, VXCLIP_FRONT, 0).astype(np.uint32)
    f |= np.where(z > w, VXCLIP_BACK, 0).astype(np.uint32)
    return f


# ---------------------------------------------------------------------------
# Torch device ops (frame stages)
# ---------------------------------------------------------------------------

def transform_points(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Affine-transform (N,3) points by (N,4,4) or (4,4) matrices."""
    r = m[..., :3, :3]
    return (points[:, 0:1] * r[..., 0, :] + points[:, 1:2] * r[..., 1, :]
            + points[:, 2:3] * r[..., 2, :]) + m[..., 3, :3]


def transform_vectors(vectors: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Rotate (N,3) direction vectors (ignores translation)."""
    r = m[..., :3, :3]
    return (vectors[:, 0:1] * r[..., 0, :] + vectors[:, 1:2] * r[..., 1, :]
            + vectors[:, 2:3] * r[..., 2, :])


def transform_h4(points4: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N,4) @ (4,4), summed in component order."""
    return (points4[:, 0:1] * m[0] + points4[:, 1:2] * m[1]
            + points4[:, 2:3] * m[2] + points4[:, 3:4] * m[3])


def clip_flags(clip: torch.Tensor) -> torch.Tensor:
    """Per-vertex VXCLIP flags (int32) from (...,4) clip-space coords
    (CKRasterizerContext::TransformVertices,
    CKRasterizerLib/CKRasterizerContext.cpp:341-361)."""
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    zero = torch.zeros((), dtype=torch.int32, device=clip.device)

    def bit(cond, v):
        return torch.where(cond, torch.full((), v, dtype=torch.int32,
                                            device=clip.device), zero)

    return (bit(-w > x, VXCLIP_LEFT) | bit(x > w, VXCLIP_RIGHT)
            | bit(-w > y, VXCLIP_BOTTOM) | bit(y > w, VXCLIP_TOP)
            | bit(z < 0.0, VXCLIP_FRONT) | bit(z > w, VXCLIP_BACK))


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) and PRS, batched over leading axes (animation
# banks). Written with the reference's formulas in its order; ``torch.where``
# keeps every lane's value finite where the reference guards a division.
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-30)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b; with row-vector matrices
    ``quat_to_matrix(quat_multiply(a, b)) == quat_to_matrix(b) @
    quat_to_matrix(a)``."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions -> (..., 4, 4) rotations (row-vector
    convention)."""
    q = quat_normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    o = torch.ones_like(x)
    zr = torch.zeros_like(x)
    return torch.stack([
        o - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy), zr,
        2 * (xy - wz), o - 2 * (xx + zz), 2 * (yz + wx), zr,
        2 * (xz + wy), 2 * (yz - wx), o - 2 * (xx + yy), zr,
        zr, zr, zr, o], dim=-1).reshape(q.shape[:-1] + (4, 4))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation part of a (possibly scaled) row-vector matrix -> quaternion:
    Shepperd's method with all four candidates computed and the largest
    pivot's taken (``argmax`` picks the first of equal pivots, as jnp's
    does)."""
    r = m[..., :3, :3]
    scale = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    r = r / torch.clamp(scale, min=1e-30)
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    qw0 = safe_sqrt(1.0 + tr) * 0.5
    s0 = 0.25 / torch.clamp(qw0, min=1e-30)
    c0 = torch.stack([(m12 - m21) * s0, (m20 - m02) * s0, (m01 - m10) * s0,
                      qw0], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    s1 = 0.25 / torch.clamp(qx1, min=1e-30)
    c1 = torch.stack([qx1, (m01 + m10) * s1, (m02 + m20) * s1,
                      (m12 - m21) * s1], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    s2 = 0.25 / torch.clamp(qy2, min=1e-30)
    c2 = torch.stack([(m01 + m10) * s2, qy2, (m12 + m21) * s2,
                      (m20 - m02) * s2], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    s3 = 0.25 / torch.clamp(qz3, min=1e-30)
    c3 = torch.stack([(m02 + m20) * s3, (m12 + m21) * s3, qz3,
                      (m01 - m10) * s3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4))).squeeze(-2)
    return quat_normalize(q)


def _slerp_weights(theta, sin_theta, t, use_lerp):
    safe = torch.where(use_lerp, 1.0, sin_theta)
    wa = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return wa, wb


def quat_slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Shortest-arc slerp with a lerp fallback for nearly parallel
    quaternions; ``t`` broadcasts against (..., 1)."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0.0, -b, b)
    dot = torch.clamp(torch.abs(dot), max=1.0)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    wa, wb = _slerp_weights(theta, sin_theta, t, sin_theta < 1e-5)
    return quat_normalize(wa * a + wb * b)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3-vector (axis * half-angle)."""
    q = quat_normalize(q)
    v = q[..., :3]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    phi = torch.atan2(vn, q[..., 3:4])
    scale = torch.where(vn > 1e-9, phi / torch.clamp(vn, min=1e-30), 1.0)
    return v * scale


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """3-vector (axis * half-angle) -> unit quaternion."""
    phi = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    s = torch.where(phi > 1e-9, torch.sin(phi) / torch.clamp(phi, min=1e-30),
                    1.0)
    return torch.cat([v * s, torch.cos(phi)], dim=-1)


def quat_slerp_noflip(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Slerp WITHOUT the shortest-arc sign flip: squad's inner terms must
    interpolate the exact control quaternions."""
    dot = torch.clamp(torch.sum(a * b, dim=-1, keepdim=True), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    wa, wb = _slerp_weights(theta, sin_theta, t,
                            torch.abs(sin_theta) < 1e-5)
    return quat_normalize(wa * a + wb * b)


def quat_squad(q0, a, b, q1, t) -> torch.Tensor:
    """Spherical quadrangle interpolation Squad(t; q0, a, b, q1)."""
    outer = quat_slerp_noflip(q0, q1, t)
    inner = quat_slerp_noflip(a, b, t)
    return quat_slerp_noflip(outer, inner, 2.0 * t * (1.0 - t))


def compose_prs(pos: torch.Tensor, rot_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """local = S @ R @ T (row-vector: scale first, then rotate, then
    translate): (...,3), (...,4), (...,3) -> (...,4,4)."""
    r = quat_to_matrix(rot_q)
    top = torch.cat([r[..., :3, :3] * scale[..., :, None], r[..., :3, 3:]],
                    dim=-1)
    bottom = torch.cat([pos, r[..., 3, 3:]], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def decompose_prs(m: torch.Tensor):
    """Matrix -> (position, rotation quaternion, scale). Assumes no shear."""
    pos = m[..., 3, :3]
    scale = torch.linalg.vector_norm(m[..., :3, :3], dim=-1)
    return pos, quat_from_matrix(m), scale


def oct_encode(r: torch.Tensor) -> torch.Tensor:
    """Octahedral encode of (..., 3) unit direction vectors to (..., 2) UVs
    in [0,1]: the cube-environment atlas parameterization
    (``CKTexture.SetCubeMapFaces`` bakes the six faces into this layout).
    The lower hemisphere (z < 0) folds over the diagonals, so a UV jumps
    where an interpolated direction crosses z = 0."""
    a = torch.abs(r)
    denom = torch.clamp(a[..., 0:1] + a[..., 1:2] + a[..., 2:3], min=1e-12)
    p = r / denom

    def snz(x):
        return torch.where(x >= 0, 1.0, -1.0)

    flip = torch.stack([(1.0 - torch.abs(p[..., 1])) * snz(p[..., 0]),
                        (1.0 - torch.abs(p[..., 0])) * snz(p[..., 1])], -1)
    xy = torch.where((p[..., 2] < 0)[..., None], flip, p[..., :2])
    return xy * 0.5 + 0.5
