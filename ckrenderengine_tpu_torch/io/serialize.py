"""Scene serialization: per-class Save/Load over CKStateChunk + file container.

Carried from ``ckrenderengine_tpu.io.serialize`` with the same section ids
(0x1000-0x1010), the same per-class chunk layout and the same ``CKSCENE1``
container, so that a scene file written by either package loads in the
other. The reference persists scenes through per-class CKStateChunk
Save/Load with dependency remap (mesh src/CKMesh.cpp Save/Load, place
portals src/CKPlace.cpp:239-331, context include/RCKRenderContext.h:
192-195). A registry maps class ids to (class, save, load, factory);
SaveScene writes every object's chunk with its original id, LoadScene runs
the two-phase create-then-load with id remapping (the reference's dependency
prepare/remap).

The host object model holds numpy arrays, as the JAX package's does; every
array goes into a chunk as numpy with the reference's dtype. Render
contexts are not objects that a scene file carries: their settings (size,
fog, background, portal traversal, camera) are the caller's.

Internal helper objects (names containing "__", e.g. curve line meshes and
sprite-text stores) are regenerated by their owners and skipped.
"""

from __future__ import annotations

import struct

import numpy as np

from .statechunk import CKStateChunk

# section identifiers
ID_COMMON = 0x1000
ID_ENTITY = 0x1001
ID_MESH = 0x1002
ID_MATERIAL = 0x1003
ID_TEXTURE = 0x1004
ID_CAMERA = 0x1005
ID_LIGHT = 0x1006
ID_2D = 0x1007
ID_SPRITE3D = 0x1008
ID_PLACE = 0x1009
ID_GRID = 0x100A
ID_CURVE = 0x100B
ID_ANIM = 0x100C
ID_CHARACTER = 0x100D
ID_SKIN = 0x100E
ID_CURVEPOINT = 0x100F
ID_PATCHMESH = 0x1010

_MAGIC = b"CKSCENE1"


# ---------------------------------------------------------------------------
# per-class helpers
# ---------------------------------------------------------------------------

def _save_entity_common(obj, chunk: CKStateChunk):
    chunk.WriteIdentifier(ID_ENTITY)
    chunk.WriteMatrix(obj.GetLocalMatrix())
    chunk.WriteObjectID(obj.GetParent())
    chunk.WriteInt(obj.GetMoveableFlags())
    chunk.WriteInt(obj.render_priority)
    chunk.WriteInt(len(obj.meshes))
    for m in obj.meshes:
        chunk.WriteObjectID(m)
    chunk.WriteObjectID(obj.GetCurrentMesh())
    chunk.WriteInt(1 if obj.IsVisible() else 0)


def _load_entity_common(obj, chunk: CKStateChunk, ctx):
    if not chunk.SeekIdentifier(ID_ENTITY):
        return
    obj.SetLocalMatrix(chunk.ReadMatrix())
    parent = ctx.GetObject(chunk.ReadObjectID())
    if parent is not None:
        obj.SetParent(parent)
    obj.SetMoveableFlags(chunk.ReadInt())
    obj.render_priority = chunk.ReadInt()
    n = chunk.ReadInt()
    for _ in range(n):
        m = ctx.GetObject(chunk.ReadObjectID())
        if m is not None:
            obj.AddMesh(m)
    cur = ctx.GetObject(chunk.ReadObjectID())
    if cur is not None:
        obj.SetCurrentMesh(cur, add_if_not_here=True)
    obj.Show(bool(chunk.ReadInt()))


def _save_skin(obj, chunk: CKStateChunk):
    skin = obj.GetSkin()
    if skin is None:
        return
    chunk.WriteIdentifier(ID_SKIN)
    chunk.WriteMatrix(skin.object_init)
    chunk.WriteInt(skin.GetBoneCount())
    for bd in skin.bones:
        chunk.WriteObjectID(bd.entity)
        chunk.WriteMatrix(bd.initial_inverse)
    chunk.WriteArray(skin.rest_pos)
    chunk.WriteArray(skin.rest_nrm)
    counts = np.asarray([len(b) for b in skin._vbones], np.int32)
    chunk.WriteArray(counts)
    flat_b = np.asarray([b for bs in skin._vbones for b in bs], np.int32)
    flat_w = np.asarray([w for ws in skin._vweights for w in ws], np.float32)
    chunk.WriteArray(flat_b)
    chunk.WriteArray(flat_w)


def _load_skin(obj, chunk: CKStateChunk, ctx):
    if not chunk.SeekIdentifier(ID_SKIN):
        return
    skin = obj.CreateSkin()
    skin.SetObjectInitMatrix(chunk.ReadMatrix())
    nb = chunk.ReadInt()
    skin.SetBoneCount(nb)
    for i in range(nb):
        bone = ctx.GetObject(chunk.ReadObjectID())
        skin.bones[i].SetBone(bone)
        skin.bones[i].SetBoneInitialInverseMatrix(chunk.ReadMatrix())
    rest_pos = chunk.ReadArray()
    rest_nrm = chunk.ReadArray()
    skin.SetRestPose(rest_pos, rest_nrm)
    counts = chunk.ReadArray()
    flat_b = chunk.ReadArray()
    flat_w = chunk.ReadArray()
    off = 0
    for v, cnt in enumerate(counts):
        skin.SetVertexWeights(v, flat_b[off:off + cnt], flat_w[off:off + cnt])
        off += cnt


def _save_controller(chunk: CKStateChunk, c):
    sub = CKStateChunk()
    sub.WriteIdentifier(ID_ANIM)
    if c is None:
        sub.WriteInt(-1)
    else:
        sub.WriteInt(c.MODE)
        sub.WriteInt(c.DIM)
        sub.WriteArray(c.times)
        sub.WriteArray(c.values)
        sub.WriteArray(c._tcb)
        sub.WriteArray(c._ease)
    chunk.WriteSubChunk(sub)


def _load_controller(chunk: CKStateChunk, oa, ctype_map):
    sub = chunk.ReadSubChunk()
    sub.SeekIdentifier(ID_ANIM)
    mode = sub.ReadInt()
    if mode < 0:
        return None
    dim = sub.ReadInt()
    c = oa.CreateController(ctype_map[(mode, dim)])
    c.times = sub.ReadArray()
    c.values = sub.ReadArray()
    c._tcb = sub.ReadArray()
    c._ease = sub.ReadArray()
    c._dirty()
    return c


# ---------------------------------------------------------------------------
# class savers/loaders
# ---------------------------------------------------------------------------

def _registry():
    from ..anim import (
        CKANIMATION_BEZIER_POS, CKANIMATION_BEZIER_SCL, CKANIMATION_LINEAR_POS,
        CKANIMATION_LINEAR_ROT, CKANIMATION_LINEAR_SCL,
        CKANIMATION_LINEAR_SCLAXIS, CKANIMATION_TCB_POS, CKANIMATION_TCB_ROT,
        CKANIMATION_TCB_SCL, CKANIMATION_TCB_SCLAXIS, CKBodyPart, CKCharacter,
        CKKeyedAnimation, CKObjectAnimation,
    )
    from ..anim.keyframe import INTERP_BEZIER, INTERP_LINEAR, INTERP_TCB
    from ..objects import (
        CK2dEntity, CK3dEntity, CK3dObject, CKCamera, CKCurve, CKCurvePoint,
        CKGrid, CKLight, CKMaterial, CKMesh, CKPatchMesh, CKPlace, CKSprite,
        CKSprite3D, CKSpriteText, CKTargetCamera, CKTargetLight, CKTexture,
    )

    pos_map = {(INTERP_LINEAR, 3): CKANIMATION_LINEAR_POS,
               (INTERP_TCB, 3): CKANIMATION_TCB_POS,
               (INTERP_BEZIER, 3): CKANIMATION_BEZIER_POS}
    rot_map = {(INTERP_LINEAR, 4): CKANIMATION_LINEAR_ROT,
               (INTERP_TCB, 4): CKANIMATION_TCB_ROT}
    scl_map = {(INTERP_LINEAR, 3): CKANIMATION_LINEAR_SCL,
               (INTERP_TCB, 3): CKANIMATION_TCB_SCL,
               (INTERP_BEZIER, 3): CKANIMATION_BEZIER_SCL}
    sclaxis_map = {(INTERP_LINEAR, 4): CKANIMATION_LINEAR_SCLAXIS,
                   (INTERP_TCB, 4): CKANIMATION_TCB_SCLAXIS}

    reg = {}

    def register(cls, save, load, factory=None):
        reg[cls.CLASS_ID] = (cls, save, load,
                             factory or (lambda ctx, name: cls(ctx, name)))

    # ---- texture ----
    def save_texture(o, ch):
        ch.WriteIdentifier(ID_TEXTURE)
        ch.WriteInt(len(o.slots))
        for s in o.slots:
            ch.WriteInt(1 if s is not None else 0)
            if s is not None:
                ch.WriteArray(s)
        ch.WriteInt(o.current_slot)
        ch.WriteInt(1 if o.mipmap else 0)

    def load_texture(o, ch, ctx):
        ch.SeekIdentifier(ID_TEXTURE)
        n = ch.ReadInt()
        for i in range(n):
            if ch.ReadInt():
                o.SetImage(ch.ReadArray(), slot=i)
        o.current_slot = ch.ReadInt()
        o.mipmap = bool(ch.ReadInt())

    register(CKTexture, save_texture, load_texture)

    # ---- material ----
    def save_material(o, ch):
        ch.WriteIdentifier(ID_MATERIAL)
        ch.WriteVector(o.GetDiffuse())
        ch.WriteVector(o.GetAmbient())
        ch.WriteVector(o.GetSpecular())
        ch.WriteVector(o.GetEmissive())
        ch.WriteFloat(o.GetPower())
        ch.WriteInt(o._flags)
        ch.WriteInt(o.GetSourceBlend())
        ch.WriteInt(o.GetDestBlend())
        ch.WriteInt(o.GetZFunc())
        ch.WriteInt(o.GetAlphaFunc())
        ch.WriteInt(o.GetAlphaRef())
        ch.WriteInt(o.GetShadeMode())
        ch.WriteInt(o.GetFillMode())
        ch.WriteInt(o.GetTextureBlendMode())
        ch.WriteInt(o.GetTextureAddressMode())
        ch.WriteInt(o.GetEffect())
        # Effect parameters: numeric keys inline, object refs as IDs
        # (the reference stores these in a CKParameter struct).
        p = o.GetEffectParameter()
        nums = {k: v for k, v in p.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}
        ch.WriteInt(len(nums))
        for k, v in sorted(nums.items()):
            ch.WriteString(k)
            ch.WriteFloat(float(v))
        for refkey in ("ref_entity", "light"):
            ch.WriteObjectID(p.get(refkey))
        for i in range(4):
            ch.WriteObjectID(o.GetTexture(i))

    def load_material(o, ch, ctx):
        ch.SeekIdentifier(ID_MATERIAL)
        o.SetDiffuse(ch.ReadVector())
        o.SetAmbient(ch.ReadVector())
        o.SetSpecular(ch.ReadVector())
        o.SetEmissive(ch.ReadVector())
        o.SetPower(ch.ReadFloat())
        o._flags = ch.ReadInt()
        o.SetSourceBlend(ch.ReadInt())
        o.SetDestBlend(ch.ReadInt())
        o.SetZFunc(ch.ReadInt())
        o.SetAlphaFunc(ch.ReadInt())
        o.SetAlphaRef(ch.ReadInt())
        o.SetShadeMode(ch.ReadInt())
        o.SetFillMode(ch.ReadInt())
        o.SetTextureBlendMode(ch.ReadInt())
        o.SetTextureAddressMode(ch.ReadInt())
        o.SetEffect(ch.ReadInt())
        intkeys = {"texgen", "texgen2", "op", "op2"}
        for _ in range(ch.ReadInt()):
            k = ch.ReadString()
            v = ch.ReadFloat()
            o.effect_parameter[k] = int(v) if k in intkeys else v
        for refkey in ("ref_entity", "light"):
            ref = ctx.GetObject(ch.ReadObjectID())
            if ref is not None:
                o.effect_parameter[refkey] = ref
        for i in range(4):
            t = ctx.GetObject(ch.ReadObjectID())
            if t is not None:
                o.SetTexture(t, i)

    register(CKMaterial, save_material, load_material)

    # ---- mesh ----
    def save_mesh(o, ch):
        ch.WriteIdentifier(ID_MESH)
        ch.WriteArray(o.positions)
        ch.WriteArray(o.normals)
        ch.WriteArray(o.uvs)
        ch.WriteArray(o.colors)
        ch.WriteArray(o.specular_colors)
        ch.WriteArray(o.faces)
        ch.WriteArray(o.face_materials)
        ch.WriteArray(o.lines)
        ch.WriteInt(o.flags)
        ch.WriteInt(len(o.materials))
        for m in o.materials:
            ch.WriteObjectID(m)
        ch.WriteInt(len(o.channels))
        for chan in o.channels:
            ch.WriteObjectID(chan["material"])
            ch.WriteArray(chan["uvs"])
            ch.WriteInt(1 if chan["active"] else 0)
            ch.WriteInt(-1 if chan["src_blend"] is None else chan["src_blend"])
            ch.WriteInt(-1 if chan["dst_blend"] is None else chan["dst_blend"])

    def load_mesh(o, ch, ctx):
        ch.SeekIdentifier(ID_MESH)
        o.SetPositions(ch.ReadArray())
        o.normals = ch.ReadArray()
        o.uvs = ch.ReadArray()
        o.colors = ch.ReadArray()
        o.specular_colors = ch.ReadArray()
        o.SetFaces(ch.ReadArray())
        o.face_materials = ch.ReadArray()
        lines = ch.ReadArray()
        o.lines = lines.astype(np.int32).reshape(-1, 2)
        o.flags = ch.ReadInt()
        n = ch.ReadInt()
        o.materials = [ctx.GetObject(ch.ReadObjectID()) for _ in range(n)]
        nch = ch.ReadInt()
        o.channels = []
        for _ in range(nch):
            mat = ctx.GetObject(ch.ReadObjectID())
            uvs = ch.ReadArray()
            active = bool(ch.ReadInt())
            src_b = ch.ReadInt()
            dst_b = ch.ReadInt()
            o.channels.append({
                "material": mat, "uvs": uvs, "active": active,
                "src_blend": None if src_b < 0 else src_b,
                "dst_blend": None if dst_b < 0 else dst_b})
        o._dirty()

    register(CKMesh, save_mesh, load_mesh)

    # ---- patch mesh ----
    def save_patchmesh(o, ch):
        save_mesh(o, ch)
        ch.WriteIdentifier(ID_PATCHMESH)
        ch.WriteArray(o.verts)
        ch.WriteArray(o.vecs)
        ch.WriteInt(o.iteration_count)
        ch.WriteInt(len(o.patches))
        for p in o.patches:
            ch.WriteArray(np.asarray(p.corners, np.int32))
            ch.WriteArray(np.asarray(p.edge_vecs, np.int32))
            ch.WriteArray(np.asarray(p.interiors, np.int32))
            ch.WriteObjectID(p.material)

    def load_patchmesh(o, ch, ctx):
        from ..objects.patchmesh import CKPatch

        load_mesh(o, ch, ctx)
        ch.SeekIdentifier(ID_PATCHMESH)
        o.verts = ch.ReadArray()
        o.vecs = ch.ReadArray()
        o.iteration_count = ch.ReadInt()
        n = ch.ReadInt()
        o.patches = []
        for _ in range(n):
            corners = ch.ReadArray().tolist()
            edges = ch.ReadArray().tolist()
            interiors = ch.ReadArray().tolist()
            p = CKPatch(corners, edges, interiors)
            p.material = ctx.GetObject(ch.ReadObjectID())
            o.patches.append(p)
        o._tess_dirty = True

    register(CKPatchMesh, save_patchmesh, load_patchmesh)

    # ---- entities ----
    def save_3d(o, ch):
        _save_entity_common(o, ch)
        _save_skin(o, ch)

    def load_3d(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        _load_skin(o, ch, ctx)

    register(CK3dEntity, save_3d, load_3d)
    register(CK3dObject, save_3d, load_3d)

    # ---- camera / light ----
    def save_camera(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_CAMERA)
        ch.WriteFloat(o.GetFov())
        ch.WriteFloat(o.GetFrontPlane())
        ch.WriteFloat(o.GetBackPlane())
        ch.WriteInt(o.GetProjectionType())
        ch.WriteFloat(o.GetOrthographicZoom())
        aw, ah = o.GetAspectRatio()
        ch.WriteInt(aw if o._aspect_set else 0)   # 0 = aspect never set
        ch.WriteInt(ah if o._aspect_set else 0)
        tgt = getattr(o, "target", None)
        ch.WriteObjectID(tgt)

    def load_camera(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_CAMERA)
        o.SetFov(ch.ReadFloat())
        o.SetFrontPlane(ch.ReadFloat())
        o.SetBackPlane(ch.ReadFloat())
        o.SetProjectionType(ch.ReadInt())
        o.SetOrthographicZoom(ch.ReadFloat())
        aw, ah = ch.ReadInt(), ch.ReadInt()
        if aw > 0 and ah > 0:
            o.SetAspectRatio(aw, ah)
        tgt = ctx.GetObject(ch.ReadObjectID())
        if tgt is not None and hasattr(o, "SetTarget"):
            o.SetTarget(tgt)

    register(CKCamera, save_camera, load_camera)
    register(CKTargetCamera, save_camera, load_camera)

    def save_light(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_LIGHT)
        ch.WriteInt(o.GetType())
        ch.WriteVector(o.GetColor())
        ch.WriteFloat(o.GetConstantAttenuation())
        ch.WriteFloat(o.GetLinearAttenuation())
        ch.WriteFloat(o.GetQuadraticAttenuation())
        ch.WriteFloat(o.GetRange())
        ch.WriteFloat(o.GetHotSpot())
        ch.WriteFloat(o.GetFallOff())
        ch.WriteFloat(o.GetFallOffShape())
        ch.WriteFloat(o.GetLightPower())
        ch.WriteInt(1 if o.GetActivity() else 0)
        ch.WriteInt(1 if o.GetSpecularFlag() else 0)
        ch.WriteObjectID(getattr(o, "target", None))

    def load_light(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_LIGHT)
        o.SetType(ch.ReadInt())
        o.SetColor(ch.ReadVector())
        o.SetConstantAttenuation(ch.ReadFloat())
        o.SetLinearAttenuation(ch.ReadFloat())
        o.SetQuadraticAttenuation(ch.ReadFloat())
        o.SetRange(ch.ReadFloat())
        o.SetHotSpot(ch.ReadFloat())
        o.SetFallOff(ch.ReadFloat())
        o.SetFallOffShape(ch.ReadFloat())
        o.SetLightPower(ch.ReadFloat())
        o.Active(bool(ch.ReadInt()))
        o.SetSpecularFlag(bool(ch.ReadInt()))
        tgt = ctx.GetObject(ch.ReadObjectID())
        if tgt is not None and hasattr(o, "SetTarget"):
            o.SetTarget(tgt)

    register(CKLight, save_light, load_light)
    register(CKTargetLight, save_light, load_light)

    # ---- 2D entities ----
    def save_2d(o, ch):
        ch.WriteIdentifier(ID_2D)
        ch.WriteObjectID(o.GetParent())
        ch.WriteInt(o.flags2d)
        ch.WriteVector(o.position)
        ch.WriteVector(o.size)
        ch.WriteInt(o.zorder)
        ch.WriteObjectID(o.material)
        ch.WriteVector(o.src_rect)
        ch.WriteVector(o.color)
        ch.WriteInt(1 if o.IsVisible() else 0)
        if hasattr(o, "_store"):
            img = o._store.current_image()
            ch.WriteInt(1 if img is not None else 0)
            if img is not None:
                ch.WriteArray(img)
        else:
            ch.WriteInt(0)
        if hasattr(o, "text"):
            ch.WriteString(o.text)
            ch.WriteVector(o.text_color)
            ch.WriteVector(o.bg_color)
            ch.WriteInt(o.align)
            ch.WriteInt(o.font_size)

    def load_2d(o, ch, ctx):
        ch.SeekIdentifier(ID_2D)
        parent = ctx.GetObject(ch.ReadObjectID())
        if parent is not None:
            o.SetParent(parent)
        o.flags2d = ch.ReadInt()
        o.position = ch.ReadVector()
        o.size = ch.ReadVector()
        o.zorder = ch.ReadInt()
        o.material = ctx.GetObject(ch.ReadObjectID())
        o.src_rect = ch.ReadVector()
        o.color = ch.ReadVector()
        o.Show(bool(ch.ReadInt()))
        has_img = ch.ReadInt()
        if has_img and hasattr(o, "SetImage"):
            o.SetImage(ch.ReadArray())
        if hasattr(o, "text"):
            o.text = ch.ReadString()
            o.text_color = ch.ReadVector()
            o.bg_color = ch.ReadVector()
            o.align = ch.ReadInt()
            o.font_size = ch.ReadInt()
            o._raster_dirty = True

    register(CK2dEntity, save_2d, load_2d)
    register(CKSprite, save_2d, load_2d)
    register(CKSpriteText, save_2d, load_2d)

    # ---- sprite3d ----
    def save_sprite3d(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_SPRITE3D)
        ch.WriteObjectID(o.material)
        ch.WriteInt(o.mode)
        ch.WriteVector(o.offset)
        ch.WriteVector(o.uv_rect)
        ch.WriteVector(o.size2d)

    def load_sprite3d(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_SPRITE3D)
        o.material = ctx.GetObject(ch.ReadObjectID())
        o.mode = ch.ReadInt()
        o.offset = ch.ReadVector()
        o.uv_rect = ch.ReadVector()
        o.size2d = ch.ReadVector()

    register(CKSprite3D, save_sprite3d, load_sprite3d)

    # ---- place ----
    def save_place(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_PLACE)
        ch.WriteInt(len(o.portals))
        for e in o.portals:
            ch.WriteObjectID(e.place)
            ch.WriteObjectID(e.portal)
        ch.WriteObjectID(o.default_camera)
        has = o.clip_rect is not None
        ch.WriteInt(1 if has else 0)
        if has:
            ch.WriteVector(np.asarray(o.clip_rect, np.float32))

    def load_place(o, ch, ctx):
        from ..objects.place import CKPortalEntry

        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_PLACE)
        n = ch.ReadInt()
        o.portals = []
        for _ in range(n):
            place = ctx.GetObject(ch.ReadObjectID())
            portal = ctx.GetObject(ch.ReadObjectID())
            o.portals.append(CKPortalEntry(place, portal))
        o.default_camera = ctx.GetObject(ch.ReadObjectID())
        if ch.ReadInt():
            o.clip_rect = tuple(ch.ReadVector().tolist())

    register(CKPlace, save_place, load_place)

    # ---- grid ----
    def save_grid(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_GRID)
        ch.WriteInt(o.width)
        ch.WriteInt(o.length)
        sx, sy = o.square_size
        ch.WriteFloat(sx)
        ch.WriteFloat(sy)
        ch.WriteInt(o.orientation_mode)
        ch.WriteInt(o.grid_priority)
        ch.WriteInt(len(o.layers))
        for l in o.layers:
            ch.WriteInt(l.type)
            ch.WriteInt(l.format)
            ch.WriteArray(l.squares)

    def load_grid(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_GRID)
        w = ch.ReadInt()
        l = ch.ReadInt()
        sx = ch.ReadFloat()
        sy = ch.ReadFloat()
        o.SetDimensions(w, l, sx, sy)
        o.orientation_mode = ch.ReadInt()
        o.grid_priority = ch.ReadInt()
        n = ch.ReadInt()
        for _ in range(n):
            layer = o.AddLayer(ch.ReadInt())
            layer.SetFormat(ch.ReadInt())
            layer.squares = ch.ReadArray()

    register(CKGrid, save_grid, load_grid)

    # ---- curve ----
    def save_curvepoint(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_CURVEPOINT)
        ch.WriteFloat(o.tension)
        ch.WriteFloat(o.continuity)
        ch.WriteFloat(o.bias)
        ch.WriteInt(1 if o.linear else 0)

    def load_curvepoint(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_CURVEPOINT)
        o.tension = ch.ReadFloat()
        o.continuity = ch.ReadFloat()
        o.bias = ch.ReadFloat()
        o.linear = bool(ch.ReadInt())

    register(CKCurvePoint, save_curvepoint, load_curvepoint)

    def save_curve(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_CURVE)
        ch.WriteInt(len(o.points))
        for p in o.points:
            ch.WriteObjectID(p)
        ch.WriteInt(1 if o.closed else 0)
        ch.WriteFloat(o.fitting_coeff)
        ch.WriteInt(o.step_count)
        ch.WriteVector(o.color)

    def load_curve(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_CURVE)
        n = ch.ReadInt()
        for _ in range(n):
            p = ctx.GetObject(ch.ReadObjectID())
            if p is not None:
                p.curve = o
                o.points.append(p)
        o.closed = bool(ch.ReadInt())
        o.fitting_coeff = ch.ReadFloat()
        o.step_count = ch.ReadInt()
        o.color = ch.ReadVector()
        o._curve_dirty = True

    def curve_factory(ctx, name):
        c = CKCurve(ctx, name)
        return c

    register(CKCurve, save_curve, load_curve, curve_factory)

    # ---- animations ----
    def save_objectanim(o, ch):
        ch.WriteIdentifier(ID_ANIM)
        ch.WriteObjectID(o.Get3dEntity())
        ch.WriteFloat(o.length)
        _save_controller(ch, o.position_controller)
        _save_controller(ch, o.rotation_controller)
        _save_controller(ch, o.scale_controller)
        _save_controller(ch, o.scale_axis_controller)
        mc = o.morph_controller
        ch.WriteInt(mc.GetMorphVertexCount() if mc is not None else -1)
        if mc is not None:
            ch.WriteArray(mc.times)
            ch.WriteArray(mc.vertex_keys)
            ch.WriteArray(mc.normal_keys)

    def load_objectanim(o, ch, ctx):
        ch.SeekIdentifier(ID_ANIM)
        ent = ctx.GetObject(ch.ReadObjectID())
        if ent is not None:
            o.Set3dEntity(ent)
        o.length = ch.ReadFloat()
        _load_controller(ch, o, pos_map)
        _load_controller(ch, o, rot_map)
        _load_controller(ch, o, scl_map)
        _load_controller(ch, o, sclaxis_map)
        nmv = ch.ReadInt()
        if nmv >= 0:
            mc = o.CreateMorphController(nmv)
            mc.times = ch.ReadArray()
            mc.vertex_keys = ch.ReadArray().reshape(-1, nmv, 3)
            mc.normal_keys = ch.ReadArray().reshape(-1, nmv, 3)

    register(CKObjectAnimation, save_objectanim, load_objectanim)

    def save_keyedanim(o, ch):
        ch.WriteIdentifier(ID_ANIM)
        ch.WriteFloat(o.length)
        ch.WriteInt(o.transition_mode)
        ch.WriteInt(len(o.animations))
        for a in o.animations:
            ch.WriteObjectID(a)
        ch.WriteObjectID(o.root_animation)

    def load_keyedanim(o, ch, ctx):
        ch.SeekIdentifier(ID_ANIM)
        o.length = ch.ReadFloat()
        o.transition_mode = ch.ReadInt()
        n = ch.ReadInt()
        for _ in range(n):
            a = ctx.GetObject(ch.ReadObjectID())
            if a is not None:
                o.animations.append(a)
        o.root_animation = ctx.GetObject(ch.ReadObjectID())

    register(CKKeyedAnimation, save_keyedanim, load_keyedanim)

    # ---- character ----
    def save_character(o, ch):
        _save_entity_common(o, ch)
        ch.WriteIdentifier(ID_CHARACTER)
        ch.WriteInt(len(o.body_parts))
        for p in o.body_parts:
            ch.WriteObjectID(p)
        ch.WriteObjectID(o.root_body_part)
        ch.WriteInt(len(o.animations))
        for a in o.animations:
            ch.WriteObjectID(a)
        ch.WriteObjectID(o.active_animation)

    def load_character(o, ch, ctx):
        _load_entity_common(o, ch, ctx)
        ch.SeekIdentifier(ID_CHARACTER)
        n = ch.ReadInt()
        for _ in range(n):
            p = ctx.GetObject(ch.ReadObjectID())
            if p is not None:
                o.body_parts.append(p)
                p.character = o
        o.root_body_part = ctx.GetObject(ch.ReadObjectID())
        n = ch.ReadInt()
        for _ in range(n):
            a = ctx.GetObject(ch.ReadObjectID())
            if a is not None:
                o.animations.append(a)
                a.SetCharacter(o)
        o.active_animation = ctx.GetObject(ch.ReadObjectID())

    register(CKCharacter, save_character, load_character)
    register(CKBodyPart, save_3d, load_3d)

    return reg


_REG = None


def registry():
    global _REG
    if _REG is None:
        _REG = _registry()
    return _REG


# ---------------------------------------------------------------------------
# scene container
# ---------------------------------------------------------------------------

def save_object(obj) -> CKStateChunk:
    reg = registry()
    entry = reg.get(obj.CLASS_ID)
    if entry is None:
        return None
    chunk = CKStateChunk()
    entry[1](obj, chunk)
    return chunk


def load_object(obj, chunk: CKStateChunk, ctx):
    reg = registry()
    entry = reg.get(obj.CLASS_ID)
    if entry is not None:
        entry[2](obj, chunk, ctx)


def SaveScene(ctx, path: str, objects=None) -> int:
    """Serialize the context's objects (or a subset) to ``path``.
    Returns the number of objects written."""
    reg = registry()
    objs = list(objects) if objects is not None else list(ctx._objects.values())
    records = []
    for o in objs:
        if "__" in (o.GetName() or ""):
            continue                      # internal helper objects
        if o.CLASS_ID not in reg:
            continue
        chunk = save_object(o)
        if chunk is None:
            continue
        records.append((o.CLASS_ID, o.id, o.GetName() or "", chunk.to_bytes()))
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(records)))
        for cid, oid, name, raw in records:
            nb = name.encode("utf-8")
            f.write(struct.pack("<iiI", cid, oid, len(nb)))
            f.write(nb)
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
    return len(records)


def LoadScene(ctx, path: str) -> list:
    """Two-phase load into ``ctx``: create every object, remap saved ids to
    new ids, then run class loaders. Returns the loaded objects."""
    reg = registry()
    with open(path, "rb") as f:
        assert f.read(8) == _MAGIC, "not a CK scene file"
        (n,) = struct.unpack("<I", f.read(4))
        records = []
        for _ in range(n):
            cid, oid, nlen = struct.unpack("<iiI", f.read(12))
            name = f.read(nlen).decode("utf-8")
            (rawn,) = struct.unpack("<Q", f.read(8))
            records.append((cid, oid, name, f.read(rawn)))

    id_map: dict[int, int] = {}
    created = []
    for cid, oid, name, raw in records:
        entry = reg[cid]
        obj = entry[3](ctx, name)
        id_map[oid] = obj.id
        created.append((obj, CKStateChunk.from_bytes(raw)))
    for obj, chunk in created:
        chunk.RemapObjectIDs(id_map)
        load_object(obj, chunk, ctx)
    return [o for o, _ in created]
