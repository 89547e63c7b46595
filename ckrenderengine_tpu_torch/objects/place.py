"""Spatial sectors: CKPlace with portals and viewport clipping.

API mirror of RCKPlace (src/CKPlace.cpp,
include/RCKPlace.h:7-14): portal list (CKPortalEntry = destination place +
optional portal geometry entity), an attached default camera, and a viewport
clipping rect applied to the place's hierarchy during rendering (the
reference patches the projection matrix and sets a device clip rect during
traversal, src/CKSceneGraph.cpp:113-128,569-584 and
src/CKRenderContext.cpp:2743-2781). TPU mapping: the clip rect becomes a
per-entity scissor column in the device scene state, tested per triangle in
the raster coverage (SURVEY §2.4 "per-place scissor rect + masked draw").
"""

from __future__ import annotations

import numpy as np

from .base import CKCID_PLACE, CKContext
from .entity import CK3dEntity


class CKPortalEntry:
    """(reference CKPortalEntry: place + portal geometry)"""

    def __init__(self, place, portal_entity=None):
        self.place = place
        self.portal = portal_entity


class CKPlace(CK3dEntity):
    CLASS_ID = CKCID_PLACE

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.portals: list[CKPortalEntry] = []
        self.default_camera = None
        self.clip_rect = None       # (x0,y0,x1,y1) pixels or None

    # -- portals -------------------------------------------------------------
    def AddPortal(self, place: "CKPlace", portal_entity: CK3dEntity | None = None):
        """Two-way portal registration (reference keeps symmetric entries)."""
        if self.GetPortalIndex(place) < 0:
            self.portals.append(CKPortalEntry(place, portal_entity))
        if place is not None and place.GetPortalIndex(self) < 0:
            place.portals.append(CKPortalEntry(self, portal_entity))

    def RemovePortal(self, place: "CKPlace"):
        i = self.GetPortalIndex(place)
        if i >= 0:
            del self.portals[i]
        if place is not None:
            j = place.GetPortalIndex(self)
            if j >= 0:
                del place.portals[j]

    def GetPortalCount(self) -> int:
        return len(self.portals)

    def GetPortal(self, i: int):
        e = self.portals[i]
        return e.place, e.portal

    def GetPortalIndex(self, place: "CKPlace") -> int:
        for i, e in enumerate(self.portals):
            if e.place is place:
                return i
        return -1

    # -- camera ---------------------------------------------------------------
    def SetDefaultCamera(self, camera):
        self.default_camera = camera

    def GetDefaultCamera(self):
        return self.default_camera

    # -- viewport clipping -----------------------------------------------------
    def ViewportClip(self, rect=None):
        """Set (or clear with None) the pixel clip rect applied to every
        entity under this place (reference RCKPlace::ViewportClip,
        src/CKPlace.cpp:522)."""
        self.clip_rect = None if rect is None else tuple(float(v) for v in rect)
        self.context._bump_dynamic()

    def GetClipRect(self):
        return self.clip_rect

    def descendants(self):
        """All 3d entities under this place (portal-scoped draw set)."""
        out = []

        def rec(e):
            for i in range(e.GetChildrenCount()):
                ch = e.GetChild(i)
                out.append(ch)
                rec(ch)

        rec(self)
        return out

    def Contains(self, entity) -> bool:
        """Is the entity parented (transitively) under this place?"""
        p = entity
        while p is not None:
            if p is self:
                return True
            p = p.GetParent()
        return False

    def ContainsPoint(self, world_pos) -> bool:
        """Is a world point inside the place's hierarchical bbox?
        (the reference tracks camera place membership; bbox containment is
        the geometric fallback)."""
        import numpy as np

        boxes = []
        for d in [self] + self.descendants():
            if d.GetCurrentMesh() is not None:
                bmin, bmax = d.GetBoundingBox()
                boxes.append((bmin, bmax))
        if not boxes:
            return False
        bmin = np.min([b[0] for b in boxes], axis=0)
        bmax = np.max([b[1] for b in boxes], axis=0)
        p = np.asarray(world_pos)
        return bool(np.all(p >= bmin - 1e-5) and np.all(p <= bmax + 1e-5))

    def portal_screen_rect(self, portal_entity, rc):
        """Projected pixel bbox of a portal's geometry through rc's camera
        (the source of the reference's viewport clip,
        src/CKRenderContext.cpp:2743-2781). None = portal not visible."""
        import numpy as np

        cam = rc.GetAttachedCamera()
        if cam is None or portal_entity is None:
            return None
        if portal_entity.GetCurrentMesh() is not None:
            bmin, bmax = portal_entity.GetCurrentMesh().GetLocalBox()
        else:
            bmin = np.full(3, -0.5, np.float32)
            bmax = np.full(3, 0.5, np.float32)
        vxp, vyp, vw, vh = rc.viewport
        aspect = vw / max(vh, 1)
        mvp = (portal_entity.GetWorldMatrix() @ cam.view_matrix()
               @ cam.projection_matrix(aspect))
        corners = np.array([[x, y, z, 1.0] for x in (bmin[0], bmax[0])
                            for y in (bmin[1], bmax[1])
                            for z in (bmin[2], bmax[2])], np.float32)
        clip = corners @ mvp
        w = clip[:, 3]
        front = w > 1e-6
        if not front.any():
            return None
        sx = vxp + vw * 0.5 + clip[front, 0] / w[front] * vw * 0.5
        sy = vyp + vh * 0.5 - clip[front, 1] / w[front] * vh * 0.5
        if not front.all():
            # portal crosses the near plane: clamp open toward the screen
            sx = np.concatenate([sx, [vxp, vxp + vw]])
            sy = np.concatenate([sy, [vyp, vyp + vh]])
        x0 = max(float(sx.min()), vxp)
        y0 = max(float(sy.min()), vyp)
        x1 = min(float(sx.max()), vxp + vw)
        y1 = min(float(sy.max()), vyp + vh)
        if x1 <= x0 or y1 <= y0:
            return None
        return (x0, y0, x1, y1)
