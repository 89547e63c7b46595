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
        return torch.where(cond, torch.tensor(v, dtype=torch.int32,
                                              device=clip.device), zero)

    return (bit(-w > x, VXCLIP_LEFT) | bit(x > w, VXCLIP_RIGHT)
            | bit(-w > y, VXCLIP_BOTTOM) | bit(y > w, VXCLIP_TOP)
            | bit(z < 0.0, VXCLIP_FRONT) | bit(z > w, VXCLIP_BACK))
