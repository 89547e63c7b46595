"""CKSprite3D: billboard quad entities.

API mirror of RCKSprite3D (src/CKSprite3d.cpp, include/RCKSprite3D.h):
material, billboard mode, center offset, UV rect, size. The reference batches sprites per material on the CPU (4 verts / 6
indices each, CKSprite3DBatch flushed in camera space,
src/CKRenderContext.cpp:2841-2921); here every sprite owns 4 reserved rows
of the device vertex pool and ALL corner positions are computed by one
vectorised device step per frame (pipeline/overlay.apply_billboards) at
the start of the frame.
"""

from __future__ import annotations

import numpy as np

from .base import CKCID_SPRITE3D, CKContext
from .entity import CK3dEntity
from ..pipeline.overlay import (
    SPRITE3D_BILLBOARD, SPRITE3D_ORIENTABLE, SPRITE3D_XROTATE, SPRITE3D_YROTATE,
)


class CKSprite3D(CK3dEntity):
    CLASS_ID = CKCID_SPRITE3D

    MODE_BILLBOARD = SPRITE3D_BILLBOARD
    MODE_XROTATE = SPRITE3D_XROTATE
    MODE_YROTATE = SPRITE3D_YROTATE
    MODE_ORIENTABLE = SPRITE3D_ORIENTABLE

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.material = None
        self.mode = self.MODE_BILLBOARD
        self.offset = np.zeros(2, np.float32)
        self.uv_rect = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
        self.size2d = np.array([1.0, 1.0], np.float32)
        context._bump_topology()

    def SetMaterial(self, material):
        self.material = material
        self.context._bump_topology()

    def GetMaterial(self):
        return self.material

    def SetMode(self, mode: int):
        self.mode = int(mode)
        self.context._bump_dynamic()

    def GetMode(self) -> int:
        return self.mode

    def SetOffset(self, offset):
        self.offset = np.asarray(offset, np.float32)[:2]
        self.context._bump_dynamic()

    def GetOffset(self) -> np.ndarray:
        return self.offset.copy()

    def SetUVMapping(self, rect):
        self.uv_rect = np.asarray(rect, np.float32)[:4]
        self.context._bump_topology()

    def GetUVMapping(self) -> np.ndarray:
        return self.uv_rect.copy()

    def SetSize(self, size):
        self.size2d = np.asarray(size, np.float32)[:2]
        self.context._bump_dynamic()

    def GetSize(self) -> np.ndarray:
        return self.size2d.copy()

    # -- API-surface parity batch (reference include/RCKSprite3D.h) --------
    def FillBatch(self, view_matrix=None) -> tuple:
        """Host-side corner computation: the 4 vertices / 6 indices this
        sprite contributes to its material batch (reference FillBatch,
        src/CKSprite3d.cpp:686+ — the device path computes ALL corners in
        one step; this is the per-sprite staging view)."""
        center = self.GetWorldMatrix()[3, :3]
        if view_matrix is not None and self.mode == self.MODE_BILLBOARD:
            v = np.asarray(view_matrix, np.float32)
            right = v[:3, 0]
            up = v[:3, 1]
        else:
            w = self.GetWorldMatrix()
            right = w[0, :3] / max(np.linalg.norm(w[0, :3]), 1e-9)
            up = w[1, :3] / max(np.linalg.norm(w[1, :3]), 1e-9)
        hx, hy = self.size2d * 0.5
        ox, oy = self.offset
        c = center + right * ox + up * oy
        verts = np.stack([c - right * hx - up * hy,
                          c + right * hx - up * hy,
                          c + right * hx + up * hy,
                          c - right * hx + up * hy]).astype(np.float32)
        u0, v0, u1, v1 = self.uv_rect
        uvs = np.array([[u0, v1], [u1, v1], [u1, v0], [u0, v0]], np.float32)
        indices = np.array([0, 1, 2, 0, 2, 3], np.int32)
        return verts, uvs, indices

    def UpdateOrientation(self, rc=None):
        """Re-aim the local frame per the billboard mode (reference
        UpdateOrientation): billboard modes face the context's camera."""
        cam = rc.GetAttachedCamera() if rc is not None else None
        if cam is None or self.mode == self.MODE_ORIENTABLE:
            return
        to_cam = cam.GetWorldMatrix()[3, :3] - self.GetWorldMatrix()[3, :3]
        n = np.linalg.norm(to_cam)
        if n < 1e-9:
            return
        d = to_cam / n              # local z toward the viewer
        if self.mode == self.MODE_XROTATE:
            d[0] = 0.0
        elif self.mode == self.MODE_YROTATE:
            d[1] = 0.0
        if np.linalg.norm(d) > 1e-9:
            self.SetOrientation(d)

    def SetBoundingBox(self, bmin, bmax):
        """Explicit bbox override (reference SetBoundingBox)."""
        self._box_override = (np.asarray(bmin, np.float32).copy(),
                              np.asarray(bmax, np.float32).copy())

    def UpdateBox(self):
        """Recompute the world box from the current size (reference
        UpdateBox); returns (bmin, bmax)."""
        ov = getattr(self, "_box_override", None)
        if ov is not None:
            return ov
        c = self.GetWorldMatrix()[3, :3]
        h = np.max(self.size2d) * 0.5
        return (c - h).astype(np.float32), (c + h).astype(np.float32)

    def GetBoundingBox(self, local: bool = False):
        ov = getattr(self, "_box_override", None)
        if ov is not None:
            return ov
        if local:
            h = np.max(self.size2d) * 0.5
            return (np.full(3, -h, np.float32), np.full(3, h, np.float32))
        return self.UpdateBox()
