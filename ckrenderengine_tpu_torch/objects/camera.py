"""CKCamera / CKTargetCamera.

API mirror of RCKCamera (include/RCKCamera.h,
src/CKCamera.cpp): fov/near/far, perspective vs orthographic (zoom), aspect
width/height. Projection application follows RCKRenderContext::UpdateProjection
(src/CKRenderContext.cpp:2783-2808) and
CKRenderedScene::PrepareCameras (src/CKRenderedScene.cpp:484-536).
"""

from __future__ import annotations

import numpy as np

from ..math import vxmath as vx
from .base import CKCID_CAMERA, CKCID_TARGETCAMERA, CKContext
from .entity import CK3dEntity

CK_PERSPECTIVEPROJECTION = 1
CK_ORTHOGRAPHICPROJECTION = 2


class CKCamera(CK3dEntity):
    CLASS_ID = CKCID_CAMERA

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.fov = np.float32(0.5)          # horizontal FOV (Virtools default)
        self.front_plane = 1.0
        self.back_plane = 4000.0
        self.projection_type = CK_PERSPECTIVEPROJECTION
        self.orthographic_zoom = 1.0
        self.width = 4
        self.height = 3
        self._aspect_set = False   # explicit SetAspectRatio enables letterbox
        self.ignore_aspect = False  # CK_3DENTITY_CAMERAIGNOREASPECT

    def SetFov(self, fov: float):
        self.fov = float(fov)
        self.context._bump_dynamic()

    def GetFov(self) -> float:
        return float(self.fov)

    def SetFrontPlane(self, near: float):
        self.front_plane = float(near)
        self.context._bump_dynamic()

    def GetFrontPlane(self) -> float:
        return self.front_plane

    def SetBackPlane(self, far: float):
        self.back_plane = float(far)
        self.context._bump_dynamic()

    def GetBackPlane(self) -> float:
        return self.back_plane

    def SetProjectionType(self, t: int):
        self.projection_type = int(t)
        self.context._bump_dynamic()

    def GetProjectionType(self) -> int:
        return self.projection_type

    def SetOrthographicZoom(self, z: float):
        self.orthographic_zoom = float(z)
        self.context._bump_dynamic()

    def GetOrthographicZoom(self) -> float:
        return self.orthographic_zoom

    def SetAspectRatio(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self._aspect_set = True
        self.context._bump_dynamic()

    def GetAspectRatio(self):
        return self.width, self.height

    def IgnoreAspectRatio(self, ignore: bool = True):
        """CK_3DENTITY_CAMERAIGNOREASPECT: opt this camera out of
        CK_RENDER_USECAMERARATIO letterboxing (reference
        src/CKRenderedScene.cpp:594-597)."""
        self.ignore_aspect = bool(ignore)
        self.context._bump_dynamic()

    def projection_matrix(self, aspect: float) -> np.ndarray:
        """aspect = viewport width / height."""
        if self.projection_type == CK_ORTHOGRAPHICPROJECTION:
            return vx.np_orthographic(
                self.orthographic_zoom, aspect, self.front_plane, self.back_plane)
        return vx.np_perspective(
            float(self.fov), aspect, self.front_plane, self.back_plane)

    def view_matrix(self) -> np.ndarray:
        """view = inverse of camera world matrix (CKRenderedScene::Draw sets
        VIEW = inv(rootWorld), src/CKRenderedScene.cpp:235-236)."""
        return np.linalg.inv(self.GetWorldMatrix())


class CKTargetCamera(CKCamera):
    """Camera re-aimed at a target each frame (reference src/CKTargetCamera.cpp)."""

    CLASS_ID = CKCID_TARGETCAMERA

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.target: CK3dEntity | None = None

    def SetTarget(self, target: CK3dEntity | None):
        self.target = target
        self.context._bump_dynamic()

    def GetTarget(self):
        return self.target

    def prepare(self):
        if self.target is not None:
            pos = self.GetPosition()
            tpos = self.target.GetPosition()
            d = tpos - pos
            if np.linalg.norm(d) > 1e-12:
                self.SetOrientation(d)
