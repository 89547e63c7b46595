"""CKLight / CKTargetLight: fixed-function light entities.

API mirror of RCKLight (src/CKLight.cpp, include/RCKLight.h):
CKLightData (type/colors/position/direction/range/falloff/attenuation/cones),
activity flag 0x100, specular flag 0x200 (specular = diffuse * power), light
power scaling. Position comes from world-matrix row 3, direction from row 2
(RCKLight::Setup, src/CKLight.cpp:592-656) — rows the scene compiler reads
when filling the device light bank.
"""

from __future__ import annotations

import numpy as np

from ..pipeline.lighting import light_row_from_params
from ..raster.types import VXLIGHT
from .base import CKCID_LIGHT, CKCID_TARGETLIGHT, CKContext
from .entity import CK3dEntity

_FLAG_ACTIVE = 0x100
_FLAG_SPECULAR = 0x200


class CKLight(CK3dEntity):
    CLASS_ID = CKCID_LIGHT

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        context._lights[self.id] = self
        self.type = int(VXLIGHT.POINT)
        self.color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)   # diffuse
        self.ambient_color = np.zeros(4, np.float32)
        self.range = 100.0
        self.falloff = 1.0
        self.attenuation = np.array([1.0, 0.0, 0.0], np.float32)
        self.hot_spot = np.float32(0.6981317)     # inner cone (40 deg)
        self.falloff_shape = np.float32(0.7853982)  # outer cone (45 deg)
        self.light_power = 1.0
        self.light_flags = _FLAG_ACTIVE

    # -- type / colors ----------------------------------------------------
    def SetType(self, t: int):
        self.type = int(t)
        self.context._bump_appearance()

    def GetType(self) -> int:
        return self.type

    def SetColor(self, rgba):
        self.color = np.asarray(rgba, np.float32)
        self.context._bump_appearance()

    def GetColor(self):
        return self.color.copy()

    def SetSpecularFlag(self, on: bool):
        if on:
            self.light_flags |= _FLAG_SPECULAR
        else:
            self.light_flags &= ~_FLAG_SPECULAR
        self.context._bump_appearance()

    def GetSpecularFlag(self) -> bool:
        return bool(self.light_flags & _FLAG_SPECULAR)

    def Active(self, on: bool):
        if on:
            self.light_flags |= _FLAG_ACTIVE
        else:
            self.light_flags &= ~_FLAG_ACTIVE
        self.context._bump_appearance()

    def GetActivity(self) -> bool:
        return bool(self.light_flags & _FLAG_ACTIVE)

    # -- attenuation / cones ---------------------------------------------
    def SetConstantAttenuation(self, a: float):
        self.attenuation[0] = a
        self.context._bump_appearance()

    def SetLinearAttenuation(self, a: float):
        self.attenuation[1] = a
        self.context._bump_appearance()

    def SetQuadraticAttenuation(self, a: float):
        self.attenuation[2] = a
        self.context._bump_appearance()

    def GetConstantAttenuation(self) -> float:
        return float(self.attenuation[0])

    def GetLinearAttenuation(self) -> float:
        return float(self.attenuation[1])

    def GetQuadraticAttenuation(self) -> float:
        return float(self.attenuation[2])

    def SetRange(self, r: float):
        self.range = float(r)
        self.context._bump_appearance()

    def GetRange(self) -> float:
        return self.range

    def SetHotSpot(self, angle: float):
        self.hot_spot = float(angle)
        self.context._bump_appearance()

    def GetHotSpot(self) -> float:
        return float(self.hot_spot)

    def SetFallOff(self, angle: float):
        self.falloff_shape = float(angle)
        self.context._bump_appearance()

    def GetFallOff(self) -> float:
        return float(self.falloff_shape)

    def Setup(self, rst_ctx, index: int = 0) -> bool:
        """Push this light into a rasterizer HAL context's light table
        (reference RCKLight::Setup, src/CKLight.cpp:592-656 — activity flag
        gating, specular = diffuse scaled by light power)."""
        if not self.GetActivity():
            rst_ctx.EnableLight(index, False)
            return False
        w = self.GetWorldMatrix()
        color = np.asarray(self.GetColor(), np.float32)
        power = max(float(getattr(self, "light_power", 1.0)), 0.0)
        data = {
            "type": self.GetType(),
            "diffuse": (color * power).tolist(),
            "specular": (color * power).tolist()
            if self.GetSpecularFlag() else [0.0, 0.0, 0.0, 0.0],
            "position": w[3, :3].tolist(),
            "direction": w[2, :3].tolist(),
            "range": self.GetRange(),
            "attenuation": [self.GetConstantAttenuation(),
                            self.GetLinearAttenuation(),
                            self.GetQuadraticAttenuation()],
            "inner_angle": self.GetHotSpot(),
            "outer_angle": self.GetFallOff(),
        }
        rst_ctx.SetLight(index, data)
        rst_ctx.EnableLight(index, True)
        return True

    def SetFallOffShape(self, f: float):
        self.falloff = float(f)
        self.context._bump_appearance()

    def GetFallOffShape(self) -> float:
        return self.falloff

    def SetLightPower(self, p: float):
        self.light_power = float(p)
        self.context._bump_appearance()

    def GetLightPower(self) -> float:
        return self.light_power

    # -- lowering (Setup equivalent) --------------------------------------
    def setup_row(self) -> dict | None:
        """Build the device light-bank row; None = light contributes nothing
        (visibility / attenuation-sum / active checks of RCKLight::Setup)."""
        if not self.IsVisible():
            return None
        if not (self.light_flags & _FLAG_ACTIVE):
            return None
        w = self.GetWorldMatrix()
        return light_row_from_params(
            type=self.type,
            diffuse=self.color,
            specular_flag=bool(self.light_flags & _FLAG_SPECULAR),
            ambient=self.ambient_color,
            position=w[3, :3],
            direction=w[2, :3],
            range=self.range,
            falloff=self.falloff,
            att0=float(self.attenuation[0]),
            att1=float(self.attenuation[1]),
            att2=float(self.attenuation[2]),
            inner_angle=float(self.hot_spot),
            outer_angle=float(self.falloff_shape),
            power=self.light_power,
        )


class CKTargetLight(CKLight):
    """Spot light that re-aims at a target entity each frame
    (reference src/CKTargetlight.cpp; LookAt applied by PrepareCameras,
    src/CKRenderedScene.cpp:498-507)."""

    CLASS_ID = CKCID_TARGETLIGHT

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.target: CK3dEntity | None = None
        self.type = int(VXLIGHT.SPOT)

    def SetTarget(self, target: CK3dEntity | None):
        self.target = target
        self.context._bump_appearance()

    def GetTarget(self):
        return self.target

    def prepare(self):
        if self.target is not None:
            pos = self.GetPosition()
            tpos = self.target.GetPosition()
            d = tpos - pos
            if np.linalg.norm(d) > 1e-12:
                self.SetOrientation(d)
