"""CK3dEntity: transform-node handle over the flat entity table.

API mirror of RCK3dEntity (include/RCK3dEntity.h,
src/CK3dEntity.cpp) — but SetLocalMatrix/SetParent only write the SoA arrays;
world matrices are recomputed in batch on device each frame
(scene/entity_table.py), replacing the WorldMatrixChanged recursion
(src/CK3dEntity.cpp:2091-2207).
"""

from __future__ import annotations

import numpy as np

from ..math import vxmath as vx
from ..scene import entity_table as et
from .base import CKCID_3DENTITY, CKCID_3DOBJECT, CKCID_RENDEROBJECT, CKContext, CKObject


class CKRenderObject(CKObject):
    """Base render object: per-render-context membership mask
    (reference include/RCKRenderObject.h:8-53)."""

    CLASS_ID = CKCID_RENDEROBJECT

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self._in_render_context_mask = 0
        self.callbacks = []          # pre/post render callbacks

    def IsInRenderContext(self, rc) -> bool:
        return bool(self._in_render_context_mask & rc.mask)

    def AddPreRenderCallBack(self, fct, arg=None, temp: bool = False):
        self.callbacks.append(("pre", fct, arg, temp))
        self.context._cb_objects[self.id] = self

    def AddPostRenderCallBack(self, fct, arg=None, temp: bool = False):
        self.callbacks.append(("post", fct, arg, temp))
        self.context._cb_objects[self.id] = self

    def RemoveCallbacks(self):
        self.callbacks.clear()
        self.context._cb_objects.pop(self.id, None)

    # -- API-surface parity batch (reference include/RCKRenderObject.h) ----
    def AddToRenderContext(self, rc):
        """Attach to a context's explicit membership (reference
        AddToRenderContext sets the context-mask bit)."""
        rc.AddObject(self)

    def RemoveFromRenderContext(self, rc):
        rc.RemoveObject(self)

    def GetInRenderContextMask(self) -> int:
        return self._in_render_context_mask

    def IsRootObject(self) -> bool:
        return getattr(self, "_parent", None) is None

    def CanBeHide(self) -> bool:
        """Render objects honor Show/Hide (reference CanBeHide)."""
        return True

    def RemoveRenderCallBack(self, fct):
        self.callbacks = [cb for cb in self.callbacks if cb[1] is not fct]
        if not self.callbacks:
            self.context._cb_objects.pop(self.id, None)

    # CK2 scene-membership notifications (reference CKSceneObject
    # AddToScene/RemoveFromScene — scene recompile triggers here).
    def AddToScene(self, scene=None, dependencies: bool = True):
        self.context._bump_topology()

    def RemoveFromScene(self, scene=None, dependencies: bool = True):
        self.context._bump_topology()


class CK3dEntity(CKRenderObject):
    CLASS_ID = CKCID_3DENTITY

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.row = context.entity_table.allocate()
        self._parent: CK3dEntity | None = None
        self._children: list[CK3dEntity] = []
        self.meshes: list = []
        self.current_mesh = None
        self.render_priority = 0      # scene-graph priority key
        self.moveable_flags = int(et.VX_MOVEABLE_VISIBLE | et.VX_MOVEABLE_PICKABLE)
        self.skin = None
        self.object_animations: list = []
        context._bump_topology()

    def _on_destroy(self):
        # Detach children (parent-delete detaches, reference
        # tests/test_scene_graph.cpp:10-21) and unlink from parent.
        for c in list(self._children):
            c.SetParent(None)
        if self._parent is not None:
            self._parent._children.remove(self)
        self.context.entity_table.free(self.row)
        self.context._bump_topology()

    # -- hierarchy --------------------------------------------------------
    def SetParent(self, parent: "CK3dEntity | None", keep_world: bool = False):
        if keep_world:
            world = self.GetWorldMatrix()
        if self._parent is not None:
            self._parent._children.remove(self)
        self._parent = parent
        if parent is not None:
            parent._children.append(self)
        self.context.entity_table.set_parent(
            self.row, parent.row if parent is not None else None)
        if keep_world:
            self.SetWorldMatrix(world)
        self.context._bump_topology()

    def GetParent(self):
        return self._parent

    def GetChildrenCount(self) -> int:
        return len(self._children)

    def GetChild(self, i: int):
        return self._children[i]

    def AddChild(self, child: "CK3dEntity", keep_world: bool = False):
        child.SetParent(self, keep_world)

    # -- transforms -------------------------------------------------------
    def SetLocalMatrix(self, m, keep_children: bool = False):
        self.context.entity_table.local[self.row] = np.asarray(m, np.float32)
        self._flag_moved()

    def GetLocalMatrix(self) -> np.ndarray:
        return self.context.entity_table.local[self.row].copy()

    def SetWorldMatrix(self, m, keep_children: bool = False):
        m = np.asarray(m, np.float32)
        if self._parent is None:
            self.SetLocalMatrix(m)
        else:
            pw = self._parent.GetWorldMatrix()
            self.SetLocalMatrix(m @ np.linalg.inv(pw))

    def GetWorldMatrix(self) -> np.ndarray:
        # Host-side chain walk (queries only; the frame program composes on
        # device). Depth is small; this is O(depth) per call.
        m = self.context.entity_table.local[self.row].copy()
        p = self._parent
        while p is not None:
            m = m @ self.context.entity_table.local[p.row]
            p = p._parent
        return m

    def GetInverseWorldMatrix(self) -> np.ndarray:
        return np.linalg.inv(self.GetWorldMatrix())

    def GetLastFrameMatrix(self) -> np.ndarray:
        """World matrix saved by RenderManager.PreProcess (reference
        SaveLastFrameMatrix, src/CKRenderManager.cpp:808)."""
        m = getattr(self, "_last_frame_matrix", None)
        return m.copy() if m is not None else self.GetWorldMatrix()

    def GetRenderExtents(self, rc=None):
        """Screen extents (left, top, right, bottom) at the last rendered
        frame (reference RCK3dEntity::GetRenderExtents,
        src/CK3dEntity.cpp:2713). Defaults to the context's first render
        context; None when offscreen or never rendered."""
        if rc is None:
            rm = self.context.GetRenderManager()
            ctxs = rm.render_contexts
            if not ctxs:
                return None
            rc = ctxs[0]
        return rc.GetObjectExtents(self)

    def SetPosition(self, pos, ref: "CK3dEntity | None" = None, keep_children: bool = False):
        pos = np.asarray(pos, np.float32)
        if ref is not None:
            pos = pos @ ref.GetWorldMatrix()[:3, :3] + ref.GetWorldMatrix()[3, :3]
        if self._parent is None:
            local = self.context.entity_table.local[self.row]
            local[3, :3] = pos
        else:
            inv = np.linalg.inv(self._parent.GetWorldMatrix())
            lp = pos @ inv[:3, :3] + inv[3, :3]
            self.context.entity_table.local[self.row][3, :3] = lp
        self._flag_moved()

    def GetPosition(self, ref: "CK3dEntity | None" = None) -> np.ndarray:
        p = self.GetWorldMatrix()[3, :3]
        if ref is not None:
            inv = np.linalg.inv(ref.GetWorldMatrix())
            p = p @ inv[:3, :3] + inv[3, :3]
        return p

    def SetOrientation(self, dir, up=(0.0, 1.0, 0.0), right=None, ref=None):
        d = np.asarray(dir, np.float32)
        d = d / max(np.linalg.norm(d), 1e-30)
        u = np.asarray(up, np.float32)
        r = np.cross(u, d)
        rn = np.linalg.norm(r)
        r = r / rn if rn > 1e-6 else np.array([1.0, 0.0, 0.0], np.float32)
        u2 = np.cross(d, r)
        local = self.context.entity_table.local[self.row]
        local[0, :3] = r
        local[1, :3] = u2
        local[2, :3] = d
        self._flag_moved()

    def Rotate(self, axis, angle, ref=None, keep_children: bool = False):
        r = vx.np_rotation_axis_angle(axis, float(angle))
        local = self.context.entity_table.local[self.row]
        pos = local[3, :3].copy()
        m = local @ r
        m[3, :3] = pos if ref is None else m[3, :3]
        self.context.entity_table.local[self.row] = m
        self._flag_moved()

    def Translate(self, delta, ref=None, keep_children: bool = False):
        self.context.entity_table.local[self.row][3, :3] += np.asarray(delta, np.float32)
        self._flag_moved()

    def SetScale(self, scale, keep_children: bool = False, local: bool = True):
        s = np.broadcast_to(np.asarray(scale, np.float32), (3,))
        m = self.context.entity_table.local[self.row]
        for i in range(3):
            row = m[i, :3]
            n = np.linalg.norm(row)
            if n > 1e-30:
                m[i, :3] = row / n * s[i]
        self._flag_moved()

    def _flag_moved(self):
        self.context.entity_table.flags[self.row] |= et.VX_MOVEABLE_HASMOVED
        rm = self.context.render_manager
        if rm is not None:
            rm._moved_entities.add(self.id)
        self.context._bump_dynamic()

    # -- meshes -----------------------------------------------------------
    def SetCurrentMesh(self, mesh, add_if_not_here: bool = True):
        if mesh is not None and mesh not in self.meshes and add_if_not_here:
            self.meshes.append(mesh)
        self.current_mesh = mesh
        self.context._bump_topology()
        return mesh

    def GetCurrentMesh(self):
        return self.current_mesh

    def AddMesh(self, mesh):
        if mesh not in self.meshes:
            self.meshes.append(mesh)
        if self.current_mesh is None:
            self.current_mesh = mesh
        self.context._bump_topology()

    def RemoveMesh(self, mesh):
        if mesh in self.meshes:
            self.meshes.remove(mesh)
        if self.current_mesh is mesh:
            self.current_mesh = self.meshes[0] if self.meshes else None
        self.context._bump_topology()

    def GetMeshCount(self) -> int:
        return len(self.meshes)

    def GetMesh(self, i: int):
        return self.meshes[i]

    # -- flags / visibility ----------------------------------------------
    def Show(self, show: bool = True):
        super().Show(show)
        tbl = self.context.entity_table
        if show:
            tbl.flags[self.row] |= et.VX_MOVEABLE_VISIBLE
        else:
            tbl.flags[self.row] &= ~np.uint32(et.VX_MOVEABLE_VISIBLE)

    def IsVisible(self) -> bool:
        return bool(self.context.entity_table.flags[self.row] & et.VX_MOVEABLE_VISIBLE)

    def SetMoveableFlags(self, flags: int):
        old = int(self.context.entity_table.flags[self.row])
        self.moveable_flags = int(flags)
        self.context.entity_table.flags[self.row] = np.uint32(flags)
        # Draw-kind bits reshape the compiled buckets (z-only / stencil-only /
        # channels) -> recompile; plain visibility-ish bits stay dynamic.
        kind_bits = (et.VX_MOVEABLE_ZBUFONLY | et.VX_MOVEABLE_STENCILONLY
                     | et.VX_MOVEABLE_RENDERCHANNELS)
        if (old ^ int(flags)) & kind_bits:
            self.context._bump_topology()
        else:
            self.context._bump_dynamic()

    def GetMoveableFlags(self) -> int:
        return int(self.context.entity_table.flags[self.row])

    def SetRenderPriority(self, p: int):
        self.render_priority = int(p)
        self.context._bump_topology()

    # -- API-surface parity batch (reference include/RCK3dEntity.h) --------
    def SetZOrder(self, z: int):
        """Render-order key (reference Set/GetZOrder map onto the scene-
        graph priority here — the same sort key role)."""
        self.SetRenderPriority(z)

    def GetZOrder(self) -> int:
        return self.render_priority

    def IsToBeRendered(self) -> bool:
        return self.IsVisible() and self.current_mesh is not None

    def IsToBeRenderedLast(self) -> bool:
        """True when this entity takes the sorted transparent pass
        (reference IsToBeRenderedLast: transparent objects render after
        opaques)."""
        m = self.current_mesh
        return bool(m is not None and m.IsTransparent())

    def WorldMatrixChanged(self, invalidate_box: bool = True,
                           dont_callbacks: bool = False):
        """Public change notification (reference WorldMatrixChanged,
        src/CK3dEntity.cpp:2091 — here the device recomposes all worlds per
        frame, so this just flags movement)."""
        self._flag_moved()

    def LocalMatrixChanged(self, invalidate_box: bool = True,
                           dont_callbacks: bool = False):
        self._flag_moved()

    def WorldPositionChanged(self):
        self._flag_moved()

    def SaveLastFrameMatrix(self):
        self._last_frame_matrix = self.GetWorldMatrix()

    def GetMemoryOccupation(self) -> int:
        total = 64 * 4   # the SoA table row
        if self.current_mesh is not None:
            m = self.current_mesh
            total += int(m.positions.nbytes + m.normals.nbytes
                         + m.uvs.nbytes + m.faces.nbytes)
        return total

    # Matrix construction from PRS parts (reference ConstructWorldMatrix(Ex)/
    # ConstructLocalMatrix(Ex) — CurvePoints and animations build matrices
    # this way; Ex adds the scale-axis rotated frame).
    def ConstructWorldMatrix(self, pos, quat, scale):
        from ..math import vxmath as vx
        self.SetWorldMatrix(vx.np_compose_prs(
            np.asarray(pos, np.float32), np.asarray(quat, np.float32),
            np.asarray(scale, np.float32)))

    def ConstructWorldMatrixEx(self, pos, quat, scale, scale_axis_quat):
        from ..math import vxmath as vx
        m = vx.np_compose_prs(np.asarray(pos, np.float32),
                              np.asarray(quat, np.float32),
                              np.asarray(scale, np.float32))
        r_sa = vx.np_quat_to_matrix3(np.asarray(scale_axis_quat, np.float32))
        s_axis = r_sa.T @ np.diag(np.asarray(scale, np.float32)) @ r_sa
        rot3 = vx.np_quat_to_matrix3(np.asarray(quat, np.float32))
        m[:3, :3] = s_axis @ rot3
        self.SetWorldMatrix(m)

    def ConstructLocalMatrix(self, pos, quat, scale):
        from ..math import vxmath as vx
        self.SetLocalMatrix(vx.np_compose_prs(
            np.asarray(pos, np.float32), np.asarray(quat, np.float32),
            np.asarray(scale, np.float32)))

    def ConstructLocalMatrixEx(self, pos, quat, scale, scale_axis_quat):
        from ..math import vxmath as vx
        m = vx.np_compose_prs(np.asarray(pos, np.float32),
                              np.asarray(quat, np.float32),
                              np.asarray(scale, np.float32))
        r_sa = vx.np_quat_to_matrix3(np.asarray(scale_axis_quat, np.float32))
        s_axis = r_sa.T @ np.diag(np.asarray(scale, np.float32)) @ r_sa
        rot3 = vx.np_quat_to_matrix3(np.asarray(quat, np.float32))
        m[:3, :3] = s_axis @ rot3
        self.SetLocalMatrix(m)

    def SetQuaternion(self, quat, ref=None, keep_children: bool = False,
                      keep_scale: bool = True):
        """Set the rotation part from a quaternion, preserving position
        (and scale when keep_scale) — reference SetQuaternion."""
        p, r, sc = vx.np_decompose_prs(self.GetLocalMatrix())
        q = np.asarray(quat, np.float32)
        self.SetLocalMatrix(vx.np_compose_prs(
            p, q, sc if keep_scale else np.ones(3, np.float32)))

    def GetQuaternion(self) -> np.ndarray:
        return vx.np_decompose_prs(self.GetLocalMatrix())[1]

    def AddScale(self, scale, keep_children: bool = False,
                 local: bool = True):
        """Multiply the local scale (reference AddScale)."""
        sc = np.broadcast_to(np.asarray(scale, np.float32), (3,))
        m = self.GetLocalMatrix().copy()
        m[:3, :3] = np.diag(sc) @ m[:3, :3]
        self.SetLocalMatrix(m)

    def UpdatePlace(self):
        """Recompute which Place contains this entity (reference
        RCK3dEntity::UpdatePlace — place membership from spatial
        containment). Returns the Place or None."""
        from .place import CKPlace
        pos = self.GetWorldMatrix()[3, :3]
        found = None
        for o in self.context._objects.values():
            if isinstance(o, CKPlace) and o is not self \
                    and o.ContainsPoint(pos):
                found = o
                break
        self._place = found
        return found

    def GetPlace(self):
        return getattr(self, "_place", None)

    # -- bbox -------------------------------------------------------------
    def GetBoundingBox(self, local: bool = False):
        if self.current_mesh is None:
            z = np.zeros(3, np.float32)
            return z, z
        bmin, bmax = self.current_mesh.GetLocalBox()
        if local:
            return bmin, bmax
        w = self.GetWorldMatrix()
        corners = np.array([[x, y, z] for x in (bmin[0], bmax[0])
                            for y in (bmin[1], bmax[1])
                            for z in (bmin[2], bmax[2])], np.float32)
        wc = corners @ w[:3, :3] + w[3, :3]
        return wc.min(0), wc.max(0)

    # -- skin (RCK3dEntity skin pointer + UpdateSkin,
    # src/CK3dEntity.cpp:2918-2973) -----------------------
    def CreateSkin(self):
        from ..anim.skin import CKSkin

        self.skin = CKSkin(self)
        self.context._bump_topology()
        return self.skin

    def GetSkin(self):
        return self.skin

    def DestroySkin(self) -> bool:
        had = self.skin is not None
        self.skin = None
        self.context._bump_topology()
        return had

    def UpdateSkin(self) -> bool:
        """Host-path skin deformation into the current mesh (the device path
        runs inside the frame program's skin stage)."""
        if self.skin is None:
            return False
        self.skin.UpdateMesh()
        return True

    # -- frustum visibility (RCK3dEntity::IsInViewFrustrum,
    # reference src/CK3dEntity.cpp:3196-3295) ------------------------------
    def IsInViewFrustrum(self, rc) -> bool:
        """World-bbox visibility against the context camera's frustum
        (ComputeBoxVisibility semantics: OFFSCREEN -> False)."""
        from ..math.frustum import box_visibility

        cam = rc.GetAttachedCamera()
        if cam is None or self.GetCurrentMesh() is None:
            return self.IsVisible()
        bmin, bmax = self.GetCurrentMesh().GetLocalBox()
        aspect = rc.viewport[2] / max(rc.viewport[3], 1)
        mvp = (self.GetWorldMatrix() @ cam.view_matrix()
               @ cam.projection_matrix(aspect))
        vis = box_visibility(mvp, bmin, bmax)
        return vis != 0     # CBV_OFFSCREEN = 0

    def IsInViewFrustrumHierarchic(self, rc) -> bool:
        """Visibility of this entity or any descendant (hierarchical bbox,
        reference :3297-3318)."""
        if self.IsInViewFrustrum(rc):
            return True
        return any(self.GetChild(i).IsInViewFrustrumHierarchic(rc)
                   for i in range(self.GetChildrenCount()))

    # -- picking ----------------------------------------------------------
    def RayIntersection(self, origin, direction, ref: "CK3dEntity | None" = None):
        """Nearest triangle hit in local space; mirrors g_RayIntersection
        (src/CKMeshUtils.cpp). Returns (dist, face_idx) or None."""
        mesh = self.current_mesh
        if mesh is None or mesh.GetFaceCount() == 0:
            return None
        inv = self.GetInverseWorldMatrix()
        o = np.asarray(origin, np.float32) @ inv[:3, :3] + inv[3, :3]
        d = np.asarray(direction, np.float32) @ inv[:3, :3]
        verts = mesh.positions
        tris = mesh.faces
        v0 = verts[tris[:, 0]]
        e1 = verts[tris[:, 1]] - v0
        e2 = verts[tris[:, 2]] - v0
        p = np.cross(d[None, :], e2)
        det = np.sum(e1 * p, -1)
        mask = np.abs(det) > 1e-12
        inv_det = np.where(mask, 1.0 / np.where(mask, det, 1.0), 0.0)
        t0 = o[None, :] - v0
        u = np.sum(t0 * p, -1) * inv_det
        q = np.cross(t0, e1)
        v = np.sum(d[None, :] * q, -1) * inv_det
        t = np.sum(e2 * q, -1) * inv_det
        hit = mask & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        if not hit.any():
            return None
        ts = np.where(hit, t, np.inf)
        fi = int(np.argmin(ts))
        return float(ts[fi]), fi


class CK3dObject(CK3dEntity):
    """Concrete 3D object (reference include/RCK3dObject.h)."""
    CLASS_ID = CKCID_3DOBJECT
