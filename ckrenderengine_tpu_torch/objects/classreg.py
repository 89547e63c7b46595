"""CK class registry + dependency-aware object copy.

The reference registers 27 CK classes with class ids and a parent-class
hierarchy at plugin load (reference src/CK2_3D.cpp:146-175), and every RCK*
class implements the CK2 SDK object-system machinery: GetClassName /
CreateInstance / Register, plus the dependency protocol used for object
duplication (Copy / GetDependencies / PrepareDependencies /
RemapDependencies — SURVEY §5 "dependency prepare/remap/copy").

Here the same capability is one table + one copy routine:

- ``CK_CLASS_TABLE`` maps class id -> ``CKClassDesc`` (name, parent id,
  python class, direct-dependency extractor). ``CKIsChildClassOf`` walks the
  parent chain the way CKIsChildClassOf does in the CK2 runtime.
- ``CKContext.CopyObject`` builds the dependency closure under per-class
  CK_DEPENDENCIES modes, then reuses the statechunk Save/Load path with a
  *partial* id remap: copied objects' ids remap to their clones, shared
  dependencies keep their original ids and therefore resolve to the original
  objects (same context) — exactly the reference's remap-dependencies
  behavior, with serialization as the single source of per-class copy logic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from . import base as B

# -- CK_DEPENDENCIES modes (per class id) -----------------------------------
CKDEP_USECURRENT = 0        # share: references point at the original object
CKDEP_COPY = 1              # duplicate the dependency into the copy closure


@dataclass
class CKClassDesc:
    class_id: int
    name: str
    parent_id: int
    cls: type
    # direct dependencies as (object, dep_class_id) pairs
    deps: Callable[[object], list] = staticmethod(lambda o: [])


_TABLE: Optional[dict] = None


def _deps_mesh(o):
    out = [(m, B.CKCID_MATERIAL) for m in o.materials if m is not None]
    out += [(ch["material"], B.CKCID_MATERIAL)
            for ch in o.channels if ch.get("material") is not None]
    return out


def _deps_material(o):
    out = [(o.GetTexture(i), B.CKCID_TEXTURE)
           for i in range(4) if o.GetTexture(i) is not None]
    return out


def _deps_3dentity(o):
    out = [(m, B.CKCID_MESH) for m in o.meshes]
    # Children travel with the entity (reference: copying a hierarchy root
    # duplicates the subtree; the clone attaches to the ORIGINAL parent).
    out += [(c, B.CKCID_3DENTITY) for c in o._children]
    anims = getattr(o, "object_animations", None) or []
    out += [(a, B.CKCID_OBJECTANIMATION) for a in anims]
    return out


def _deps_2dentity(o):
    out = []
    mat = getattr(o, "material", None)
    if mat is not None:
        out.append((mat, B.CKCID_MATERIAL))
    out += [(c, B.CKCID_2DENTITY) for c in getattr(o, "_children", ())]
    return out


def _deps_sprite3d(o):
    mat = o.GetMaterial()
    return [(mat, B.CKCID_MATERIAL)] if mat is not None else []


def _deps_curve(o):
    return [(p, B.CKCID_CURVEPOINT) for p in o.points]


def _deps_grid(o):
    return [(l, B.CKCID_LAYER) for l in o.layers]


def _deps_character(o):
    out = _deps_3dentity(o)                 # hierarchy children travel too
    out += [(p, B.CKCID_BODYPART) for p in o.body_parts]
    out += [(a, B.CKCID_KEYEDANIMATION) for a in o.animations]
    return out


def _deps_keyedanim(o):
    return [(a, B.CKCID_OBJECTANIMATION) for a in o.animations]


def _deps_objectanim(o):
    ent = o.Get3dEntity()
    return [(ent, B.CKCID_3DENTITY)] if ent is not None else []


def _build_table() -> dict:
    """Rows for the classes this package carries: the reference's table,
    whole."""
    from ..anim import (CKBodyPart, CKCharacter, CKKeyedAnimation,
                        CKKinematicChain, CKObjectAnimation)
    from ..anim.objectanim import CKAnimation
    from .camera import CKCamera, CKTargetCamera
    from .curve import CKCurve, CKCurvePoint
    from .entity import CK3dEntity, CK3dObject, CKRenderObject
    from .entity2d import CK2dEntity, CKSprite, CKSpriteText
    from .grid import CKGrid, CKLayer
    from .light import CKLight, CKTargetLight
    from .manager import CKRenderContext
    from .material import CKMaterial
    from .mesh import CKMesh
    from .patchmesh import CKPatchMesh
    from .place import CKPlace
    from .sprite3d import CKSprite3D
    from .texture import CKTexture

    rows = [
        # (cid, name, parent, cls, deps) — hierarchy per the CK2 SDK class
        # tree the reference registers into (src/CK2_3D.cpp:146-175).
        (B.CKCID_OBJECT, "Basic Object", 0, B.CKObject, None),
        (B.CKCID_RENDEROBJECT, "Render Object", B.CKCID_OBJECT,
         CKRenderObject, None),
        (B.CKCID_2DENTITY, "2D Entity", B.CKCID_RENDEROBJECT, CK2dEntity,
         _deps_2dentity),
        (B.CKCID_SPRITE, "Sprite", B.CKCID_2DENTITY, CKSprite,
         _deps_2dentity),
        (B.CKCID_SPRITETEXT, "Sprite Text", B.CKCID_SPRITE, CKSpriteText,
         _deps_2dentity),
        (B.CKCID_3DENTITY, "3D Entity", B.CKCID_RENDEROBJECT, CK3dEntity,
         _deps_3dentity),
        (B.CKCID_3DOBJECT, "3D Object", B.CKCID_3DENTITY, CK3dObject,
         _deps_3dentity),
        (B.CKCID_BODYPART, "Body Part", B.CKCID_3DOBJECT, CKBodyPart,
         _deps_3dentity),
        (B.CKCID_SPRITE3D, "3D Sprite", B.CKCID_3DENTITY, CKSprite3D,
         _deps_sprite3d),
        (B.CKCID_CAMERA, "Camera", B.CKCID_3DENTITY, CKCamera,
         _deps_3dentity),
        (B.CKCID_TARGETCAMERA, "Target Camera", B.CKCID_CAMERA,
         CKTargetCamera, _deps_3dentity),
        (B.CKCID_LIGHT, "Light", B.CKCID_3DENTITY, CKLight, _deps_3dentity),
        (B.CKCID_TARGETLIGHT, "Target Light", B.CKCID_LIGHT, CKTargetLight,
         _deps_3dentity),
        (B.CKCID_PLACE, "Place", B.CKCID_3DENTITY, CKPlace, _deps_3dentity),
        (B.CKCID_GRID, "Grid", B.CKCID_3DENTITY, CKGrid, _deps_grid),
        (B.CKCID_LAYER, "Layer", B.CKCID_OBJECT, CKLayer, None),
        (B.CKCID_CURVEPOINT, "Curve Point", B.CKCID_3DENTITY, CKCurvePoint,
         None),
        (B.CKCID_CURVE, "Curve", B.CKCID_3DENTITY, CKCurve, _deps_curve),
        (B.CKCID_CHARACTER, "Character", B.CKCID_3DENTITY, CKCharacter,
         _deps_character),
        (B.CKCID_MESH, "Mesh", B.CKCID_OBJECT, CKMesh, _deps_mesh),
        (B.CKCID_PATCHMESH, "Patch Mesh", B.CKCID_MESH, CKPatchMesh,
         _deps_mesh),
        (B.CKCID_MATERIAL, "Material", B.CKCID_OBJECT, CKMaterial,
         _deps_material),
        (B.CKCID_TEXTURE, "Texture", B.CKCID_OBJECT, CKTexture, None),
        (B.CKCID_ANIMATION, "Animation", B.CKCID_OBJECT, CKAnimation, None),
        (B.CKCID_KEYEDANIMATION, "Keyed Animation", B.CKCID_ANIMATION,
         CKKeyedAnimation, _deps_keyedanim),
        (B.CKCID_OBJECTANIMATION, "Object Animation", B.CKCID_OBJECT,
         CKObjectAnimation, _deps_objectanim),
        (B.CKCID_KINEMATICCHAIN, "Kinematic Chain", B.CKCID_OBJECT,
         CKKinematicChain, None),
        (B.CKCID_RENDERCONTEXT, "Render Context", B.CKCID_OBJECT,
         CKRenderContext, None),
    ]
    table = {}
    for cid, name, parent, cls, deps in rows:
        table[cid] = CKClassDesc(cid, name, parent, cls,
                                 deps if deps is not None else (lambda o: []))
    return table


def class_table() -> dict:
    global _TABLE
    if _TABLE is None:
        _TABLE = _build_table()
    return _TABLE


# -- registry queries (CKGetClassName / CKIsChildClassOf equivalents) -------

def CKGetClassCount() -> int:
    return len(class_table())


def CKGetClassDesc(cid: int) -> Optional[CKClassDesc]:
    return class_table().get(cid)


def CKGetClassName(cid: int) -> str:
    d = class_table().get(cid)
    return d.name if d is not None else ""


def CKGetClassIdByName(name: str) -> int:
    for d in class_table().values():
        if d.name == name:
            return d.class_id
    return 0


def CKGetParentClassID(cid: int) -> int:
    d = class_table().get(cid)
    return d.parent_id if d is not None else 0


def CKIsChildClassOf(child, parent) -> bool:
    """True when ``child`` (class id or object) is ``parent`` or derives
    from it (reference CKIsChildClassOf semantics)."""
    cid = child.GetClassID() if hasattr(child, "GetClassID") else int(child)
    pid = parent.GetClassID() if hasattr(parent, "GetClassID") else int(parent)
    table = class_table()
    seen = 0
    while cid:
        if cid == pid:
            return True
        d = table.get(cid)
        if d is None or seen > 64:
            return False
        cid = d.parent_id
        seen += 1
    return False


# -- dependency protocol ----------------------------------------------------

# Default CK_DEPENDENCIES for Copy: the hierarchy and its animation data are
# duplicated; shared resources (meshes, materials, textures) stay shared —
# the CK2 default copy-dependencies profile.
DEFAULT_COPY_DEPENDENCIES = {
    B.CKCID_3DENTITY: CKDEP_COPY,
    B.CKCID_2DENTITY: CKDEP_COPY,
    B.CKCID_BODYPART: CKDEP_COPY,
    B.CKCID_CURVEPOINT: CKDEP_COPY,
    B.CKCID_LAYER: CKDEP_COPY,
    B.CKCID_KEYEDANIMATION: CKDEP_COPY,
    B.CKCID_OBJECTANIMATION: CKDEP_COPY,
    B.CKCID_MESH: CKDEP_USECURRENT,
    B.CKCID_MATERIAL: CKDEP_USECURRENT,
    B.CKCID_TEXTURE: CKDEP_USECURRENT,
}

# Full-copy profile: everything referenced is duplicated.
FULL_COPY_DEPENDENCIES = {cid: CKDEP_COPY for cid in (
    B.CKCID_3DENTITY, B.CKCID_2DENTITY, B.CKCID_BODYPART,
    B.CKCID_CURVEPOINT, B.CKCID_LAYER, B.CKCID_KEYEDANIMATION,
    B.CKCID_OBJECTANIMATION, B.CKCID_MESH, B.CKCID_MATERIAL,
    B.CKCID_TEXTURE,
)}


def _dep_mode(modes: dict, cid: int) -> int:
    """Resolve a class's mode, falling back up the parent chain (a
    CKCID_3DENTITY entry covers cameras, lights, body parts, ...)."""
    table = class_table()
    while cid:
        if cid in modes:
            return modes[cid]
        d = table.get(cid)
        if d is None:
            break
        cid = d.parent_id
    return CKDEP_USECURRENT


def get_dependencies(obj, modes: Optional[dict] = None) -> list:
    """Direct dependencies of ``obj``; with ``modes``, only those classes
    flagged CKDEP_COPY (reference GetDependencies under a CKDependencies
    context)."""
    d = class_table().get(obj.GetClassID())
    if d is None:
        return []
    out = []
    for dep, _decl_cid in d.deps(obj):
        if dep is None:
            continue
        if modes is not None and \
                _dep_mode(modes, dep.GetClassID()) != CKDEP_COPY:
            continue
        out.append(dep)
    return out


def copy_closure(obj, modes: dict) -> list:
    """BFS the to-be-copied set: ``obj`` plus every dependency whose class
    mode is CKDEP_COPY (reference PrepareDependencies)."""
    seen = {obj.id: obj}
    queue = [obj]
    while queue:
        cur = queue.pop()
        for dep in get_dependencies(cur, modes):
            if dep.id not in seen and "__" not in (dep.GetName() or ""):
                seen[dep.id] = dep
                queue.append(dep)
    return list(seen.values())


def copy_object(ctx, obj, modes: Optional[dict] = None,
                suffix: str = ""):
    """Duplicate ``obj`` (reference RCK*::Copy).

    The closure of CKDEP_COPY dependencies is serialized per class and
    reloaded with a partial id remap: closure ids map to the clones, all
    other referenced ids stay put and resolve to the original shared
    objects. Returns the clone of ``obj``.
    """
    from ..io.serialize import load_object, registry, save_object
    from ..io.statechunk import CKStateChunk

    if modes is None:
        modes = DEFAULT_COPY_DEPENDENCIES
    reg = registry()
    closure = [o for o in copy_closure(obj, modes) if o.CLASS_ID in reg]
    if obj.CLASS_ID not in reg:
        raise ValueError(
            f"class {CKGetClassName(obj.CLASS_ID)!r} is not copyable")

    records = []
    for o in closure:
        chunk = save_object(o)
        records.append((o, chunk))

    id_map: dict[int, int] = {}
    created = []
    for o, chunk in records:
        factory = reg[o.CLASS_ID][3]
        clone = factory(ctx, (o.GetName() or "") + suffix)
        id_map[o.id] = clone.id
        created.append((o, clone, chunk))
    for o, clone, chunk in created:
        raw = CKStateChunk.from_bytes(chunk.to_bytes())
        raw.RemapObjectIDs(id_map, keep_unmapped=True)  # shared ids stay
        load_object(clone, raw, ctx)
    clone_map = {o.id: c for o, c, _ in created}
    return clone_map[obj.id]
