"""CKObject / CKContext: the object registry.

Equivalent of the CK2 SDK's CKContext + CKObject id system the reference
plugs into (class registration in src/CK2_3D.cpp:146-175).
Objects get integer IDs; the context owns the flat entity table and the
render manager.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from ..scene.entity_table import EntityTable

# CK class ids (public Virtools values for the classes the plugin registers,
# reference src/CK2_3D.cpp:146-175)
CKCID_OBJECT = 1
CKCID_RENDEROBJECT = 47
CKCID_3DENTITY = 33
CKCID_3DOBJECT = 31
CKCID_CAMERA = 34
CKCID_TARGETCAMERA = 35
CKCID_LIGHT = 36
CKCID_TARGETLIGHT = 37
CKCID_MESH = 43
CKCID_PATCHMESH = 44
CKCID_MATERIAL = 30
CKCID_TEXTURE = 41
CKCID_SPRITE = 28
CKCID_SPRITETEXT = 29
CKCID_2DENTITY = 27
CKCID_SPRITE3D = 24
CKCID_PLACE = 22
CKCID_GRID = 50
CKCID_LAYER = 51
CKCID_CURVE = 8
CKCID_CURVEPOINT = 9
CKCID_CHARACTER = 23
CKCID_BODYPART = 32
CKCID_KINEMATICCHAIN = 25
CKCID_ANIMATION = 15
CKCID_KEYEDANIMATION = 18
CKCID_OBJECTANIMATION = 19
CKCID_RENDERCONTEXT = 48


class CKObject:
    """Base object: id, name, visibility flag."""

    CLASS_ID = CKCID_OBJECT

    def __init__(self, context: "CKContext", name: str = ""):
        self.context = context
        self.id = context._register(self)
        self.name = name
        self._visible = True
        self._to_be_deleted = False

    def GetID(self) -> int:
        return self.id

    def GetName(self) -> str:
        return self.name

    def SetName(self, name: str):
        self.name = name

    def GetClassID(self) -> int:
        return self.CLASS_ID

    def GetClassName(self) -> str:
        """Registered class name (reference GetClassName/CKClassDesc)."""
        from .classreg import CKGetClassName
        return CKGetClassName(self.CLASS_ID)

    def IsChildClassOf(self, parent) -> bool:
        from .classreg import CKIsChildClassOf
        return CKIsChildClassOf(self, parent)

    def GetDependencies(self, modes=None) -> list:
        """Direct object dependencies (reference GetDependencies)."""
        from .classreg import get_dependencies
        return get_dependencies(self, modes)

    def Copy(self, modes=None, suffix: str = ""):
        """Dependency-aware duplicate (reference RCK*::Copy)."""
        return self.context.CopyObject(self, modes, suffix)

    # -- CK2 SDK object lifecycle protocol (every RCK* class implements
    # these virtuals — CreateInstance/Register via the class registry,
    # dependency enumeration/remap via objects/classreg.py, and the
    # save/load/delete hooks) ----------------------------------------------
    @classmethod
    def CreateInstance(cls, context: "CKContext", name: str = ""):
        """Factory the class registry dispatches to (reference
        CreateInstance)."""
        return cls(context, name)

    @classmethod
    def Register(cls) -> int:
        """Ensure the class is registered; returns its class id (reference
        Register — registration happens at import here, so this is a
        lookup + assertion)."""
        from .classreg import class_table
        table = class_table()
        if cls.CLASS_ID not in table:
            raise ValueError(f"class id {cls.CLASS_ID} not in the registry")
        return cls.CLASS_ID

    def GetDependenciesCount(self, modes=None) -> int:
        return len(self.GetDependencies(modes))

    def PrepareDependencies(self, dep_set: set, modes=None) -> set:
        """Accumulate this object + its to-be-processed dependency closure
        into ``dep_set`` (reference PrepareDependencies fills a
        CKDependenciesContext)."""
        if self.id in dep_set:
            return dep_set
        dep_set.add(self.id)
        for dep in self.GetDependencies(modes):
            dep.PrepareDependencies(dep_set, modes)
        return dep_set

    def RemapDependencies(self, id_map: dict) -> bool:
        """Rewrite object references according to ``id_map`` {old_id:
        new_id} (reference RemapDependencies) — implemented by a statechunk
        round-trip with the partial remap the Copy path uses."""
        from ..io.serialize import load_object, registry, save_object
        if self.CLASS_ID not in registry():
            return False
        chunk = save_object(self)
        if chunk is None:
            return False
        chunk.RemapObjectIDs({int(k): int(v) for k, v in id_map.items()},
                             keep_unmapped=True)
        # Loaders append to membership lists; clear them so the reload
        # rebuilds rather than duplicates.
        for attr in ("meshes", "points", "body_parts", "animations"):
            val = getattr(self, attr, None)
            if isinstance(val, list):
                val.clear()
        # Loaders assign scalar refs only when resolvable; clear them so a
        # ref remapped to 0 actually drops.
        for attr in ("current_mesh", "root_animation", "active_animation",
                     "root_body_part"):
            if hasattr(self, attr):
                setattr(self, attr, None)
        if hasattr(self, "textures") and isinstance(self.textures, list):
            self.textures = [None] * len(self.textures)
        load_object(self, chunk, self.context)
        return True

    def IsObjectUsed(self, obj, cid: int = 0) -> bool:
        """Does this object reference ``obj`` (reference IsObjectUsed)?"""
        return obj in self.GetDependencies()

    # Save/load/delete hooks (reference PreSave/PostLoad/PreDelete/
    # CheckPreDeletion/CheckPostDeletion). PreSave declares dependencies;
    # PostLoad finalizes; CheckPreDeletion drops references to dying
    # objects before they go away.
    def PreSave(self, file=None, flags: int = 0):
        return None

    def PostLoad(self):
        self.context._bump_topology()

    def PreDelete(self):
        return None

    def CheckPreDeletion(self):
        """Null out references to objects marked to-be-deleted (the
        generic form of the reference's per-class CheckPreDeletion)."""
        dying = {d.id for d in self.GetDependencies()
                 if getattr(d, "_to_be_deleted", False)}
        if dying:
            self.RemapDependencies({oid: 0 for oid in dying})

    def CheckPostDeletion(self):
        return None

    def Show(self, show: bool = True):
        self._visible = bool(show)
        self.context._bump_dynamic()

    def IsVisible(self) -> bool:
        return self._visible

    def IsHiddenByParent(self) -> bool:
        return False


class CKContext:
    """Object registry + shared scene state.

    The CK2 runtime equivalent; tests construct it directly the way the
    reference tests do (``CKContext context(nullptr, 0, 0)``,
    tests/simple_mesh_test.cpp:14).

    ``device``: where every render context of this context keeps its scene
    tensors and framebuffers. The default is the CUDA card; it is never
    replaced silently — without CUDA, ``CKContext()`` raises and the caller
    passes ``device="cpu"`` explicitly.
    """

    def __init__(self, device: "str | torch.device" = "cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CKContext(device='cuda'): CUDA is not available; pass "
                "device='cpu' to run the frame on the CPU")
        self.device = device
        self._objects: dict[int, CKObject] = {}
        self._next_id = itertools.count(1)
        self.entity_table = EntityTable()
        self.render_manager = None  # set by CKRenderManager.__init__
        # Version counters driving scene recompiles vs cheap updates.
        self._topology_version = 0  # geometry / parenting / material-group edits
        self._dynamic_version = 0   # matrices / colors / light params
        # Per-frame scan registries: only objects that registered render
        # callbacks / need a pre-render update (curves, meshes with
        # callbacks) are visited by Render() — a full _objects scan is
        # O(entities) host time per frame at 1000+ entities.
        self._cb_objects: dict[int, CKObject] = {}
        self._prerender_objects: dict[int, CKObject] = {}
        self._lights: dict[int, CKObject] = {}   # live CKLight registry
        # Appearance version: material/light PARAMETER changes (not entity
        # motion) — lets the per-frame material-bank lowering cache.
        self._appearance_version = 0

    # -- registry ---------------------------------------------------------
    def _register(self, obj: CKObject) -> int:
        oid = next(self._next_id)
        self._objects[oid] = obj
        return oid

    def GetObject(self, oid: int) -> Optional[CKObject]:
        return self._objects.get(oid)

    def GetObjectByName(self, name: str) -> Optional[CKObject]:
        for o in self._objects.values():
            if o.name == name:
                return o
        return None

    def GetObjectsByClassID(self, cid: int, derived: bool = False) -> list:
        """Objects of a class (reference GetObjectsListByClassID);
        ``derived`` includes subclasses via the registered hierarchy."""
        if not derived:
            return [o for o in self._objects.values()
                    if o.GetClassID() == cid]
        from .classreg import CKIsChildClassOf
        return [o for o in self._objects.values()
                if CKIsChildClassOf(o.GetClassID(), cid)]

    def GetObjectsCount(self) -> int:
        return len(self._objects)

    def GetObjectsCountByClassID(self, cid: int, derived: bool = False) -> int:
        return len(self.GetObjectsByClassID(cid, derived))

    def DestroyObject(self, obj: "CKObject | int"):
        if isinstance(obj, int):
            obj = self._objects.get(obj)
        if obj is None:
            return
        destroy = getattr(obj, "_on_destroy", None)
        if destroy is not None:
            destroy()
        self._objects.pop(obj.id, None)
        self._cb_objects.pop(obj.id, None)
        self._prerender_objects.pop(obj.id, None)
        self._lights.pop(obj.id, None)
        self._bump_topology()

    def DestroyObjects(self, objs, dependencies: bool = False) -> int:
        """Destroy a batch (reference CKDestroyObjects); ``dependencies``
        also destroys each object's exclusive dependency closure — a
        dependency survives when something OUTSIDE the batch still uses
        it. Runs CheckPreDeletion on survivors first. Returns the number
        destroyed."""
        targets = {}
        for o in objs:
            if isinstance(o, int):
                o = self.GetObject(o)
            if o is not None:
                targets[o.id] = o
        explicit = set(targets)
        if dependencies:
            closure = dict(targets)
            frontier = list(targets.values())
            while frontier:
                for dep in frontier.pop().GetDependencies():
                    if dep.id not in closure:
                        closure[dep.id] = dep
                        frontier.append(dep)
            # A dependency survives when an object OUTSIDE the closure
            # still references it (unless it was an explicit target).
            # Fixpoint: a spared dependency becomes an outside user itself,
            # sparing ITS dependencies in turn.
            changed = True
            while changed:
                changed = False
                for o in list(self._objects.values()):
                    if o.id in closure:
                        continue
                    for dep in o.GetDependencies():
                        if dep.id in closure and dep.id not in explicit:
                            closure.pop(dep.id)
                            changed = True
            targets = closure
        for o in targets.values():
            o._to_be_deleted = True
        self.BeginAddRemoveSequence()
        try:
            for o in list(self._objects.values()):
                if o.id not in targets:
                    o.CheckPreDeletion()
            for o in list(targets.values()):
                o.PreDelete()
                self.DestroyObject(o)
        finally:
            self.EndAddRemoveSequence()
        return len(targets)

    def ClearAll(self):
        """Destroy every object and reset scene state (reference
        CKContext::ClearAll); render contexts and the manager survive and
        are notified via OnClearAll."""
        from .manager import CKRenderContext, CKRenderManager
        keep = {}
        for oid, o in list(self._objects.items()):
            if isinstance(o, (CKRenderContext, CKRenderManager)):
                keep[oid] = o
                continue
            destroy = getattr(o, "_on_destroy", None)
            if destroy is not None:
                destroy()
        self._objects = keep
        self._cb_objects.clear()
        self._prerender_objects.clear()
        self._lights.clear()
        rm = self.render_manager
        if rm is not None:
            from .material import CKMaterial
            rm.default_material = CKMaterial(self, "DefaultMat")
            for rc in rm.render_contexts:
                rc.OnClearAll()
        self._bump_topology()

    # -- factory (CKContext::CreateObject equivalent) ---------------------
    def CreateObject(self, cls, name: str = "", **kw):
        if isinstance(cls, int):
            return self.CreateObjectByClassID(cls, name, **kw)
        return cls(self, name, **kw)

    def CreateObjectByClassID(self, cid: int, name: str = "", **kw):
        """Instantiate by CK class id (reference CreateInstance via the
        registered class table, src/CK2_3D.cpp:146-175)."""
        from .classreg import CKGetClassDesc
        desc = CKGetClassDesc(cid)
        if desc is None:
            raise ValueError(f"unknown CK class id {cid}")
        return desc.cls(self, name, **kw)

    def CopyObject(self, obj: "CKObject", modes=None, suffix: str = ""):
        """Dependency-aware object duplication (reference Copy/
        PrepareDependencies/RemapDependencies — see objects/classreg.py)."""
        from .classreg import copy_object
        return copy_object(self, obj, modes, suffix)

    # -- dirty tracking ---------------------------------------------------
    def Save(self, path: str, objects=None) -> int:
        """Persist the scene (reference CKStateChunk Save path)."""
        from ..io.serialize import SaveScene
        return SaveScene(self, path, objects)

    def Load(self, path: str) -> list:
        """Load a scene file into this context (two-phase id remap)."""
        from ..io.serialize import LoadScene
        return LoadScene(self, path)

    def _bump_topology(self):
        if getattr(self, "_suspend_bumps", 0) > 0:
            self._pending_topology = True
            return
        self._topology_version += 1
        self._dynamic_version += 1

    def _bump_dynamic(self):
        self._dynamic_version += 1

    def _bump_appearance(self):
        self._appearance_version += 1
        self._dynamic_version += 1

    def BeginAddRemoveSequence(self):
        """Batch a burst of object adds/removes into ONE recompile
        (reference RCKRenderContext::AddRemoveSequence(TRUE))."""
        self._suspend_bumps = getattr(self, "_suspend_bumps", 0) + 1

    def EndAddRemoveSequence(self):
        self._suspend_bumps = max(0, getattr(self, "_suspend_bumps", 0) - 1)
        if self._suspend_bumps == 0 and getattr(self, "_pending_topology",
                                                False):
            self._pending_topology = False
            self._bump_topology()

    def GetRenderManager(self):
        if self.render_manager is None:
            from .manager import CKRenderManager
            CKRenderManager(self)
        return self.render_manager
