"""CKRenderContext: one drawable surface -> the one-frame device program
(reference RCKRenderContext, src/CKRenderContext.cpp).

The host half of the frame, carried from the reference package: the
scene compile, the texture stack, the per-frame packed buffers, host chunk
culling and portal traversal, then ONE call of
``pipeline.frame.render_frame_packed`` on ``CKContext.device`` — or, with
``SetFramePipelining(W)``, W staged frames run as one window of CUDA-graph
replays (``pipeline.window``); ``CKRenderManager.ProcessBatched`` runs a
group of contexts as one replay of a captured frame per member
(:class:`BatchRead` resolves it). The capacity governor sets the tiled
solve's caps from its bin statistics, read where the host already reads.
Stereo renders both eyes side by side, and a target texture receives
each frame on the device (render-to-texture). Immediate-mode draws
(``DrawPrimitive``, the staging VB, Sprite3D batches,
``RenderTransparents``) composite onto fb / zb on the device outside the
frame; picking is host numpy over the meshes. Features outside the ported
slices (tile sharding, debug stepping, ...) raise ``NotImplementedError``
naming their ROADMAP item.
"""

import os
import time

import numpy as np
import torch

from .rendertypes import *          # noqa: F401,F403 (shared prelude)
from .rendertypes import (          # explicit: names the body references
    _pad_to, _mip_chain, CompiledScene, VxStats,
)
from ..pipeline import window as fw


class CKRenderContext(CKObject):
    CLASS_ID = CKCID_RENDERCONTEXT

    def __init__(self, context: CKContext, name: str = "", width: int = 256,
                 height: int = 256):
        # Frame windows (SetFramePipelining): staged frames, their shared
        # inputs, the window of the current key and the dispatched window
        # whose read is pending.
        self._win_size = 1
        self._win_slots: list = []
        self._win_ctx = None
        self._win_fence = None
        self._window = None
        self._win_pending = None
        # Context batches (CKRenderManager.ProcessBatched): the batch graph
        # of the groups this context leads, and the read of the batch
        # this context's buffers came from, while it is pending.
        self._batch = None
        self._batch_read = None
        # The batch graphs of blocks on other devices (ProcessBatched over
        # a context mesh), per device.
        self._mesh_batches: dict = {}
        super().__init__(context, name)
        self.width = int(width)
        self.height = int(height)
        self.viewport = (0, 0, self.width, self.height)
        self.attached_camera: CKCamera | None = None
        self.mask = 1
        # Per-context scene state (CKRenderedScene equivalents,
        # reference src/CKRenderedScene.cpp:20-40 defaults).
        self.background_color = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
        self.background_material: CKMaterial | None = None
        self.ambient_light = np.array([0x0F / 255.0] * 3 + [1.0], np.float32)
        self.fog_mode = int(VXFOG.NONE)
        self.fog_start = 1.0
        self.fog_end = 100.0
        self.fog_density = 1.0
        self.fog_color = np.zeros(3, np.float32)
        self.clear_z = 1.0
        self.clip_rect = None      # context-level scissor (SetClipRect)
        self.render_flags = CK_RENDER_DEFAULTSETTINGS
        self.vertex_shader = None
        self.pixel_shader = None
        self.portal_traversal = False
        self._bound_clip = None
        self.stereo_enabled = False
        self.eye_separation = 0.06         # world units between eyes
        self.focal_length = 2.0
        self.target_texture = None
        # Capacity governor: (pair, slab, g) caps of the tiled solve, None
        # = the frame's t_count heuristic until the first plan.
        self._solve_caps = None
        self._gov_on = context.device.type == "cuda"
        self._gov_frames = 0
        self._gov_stash = None
        self._gov_hist = []
        self._gov_shrunk = False
        # The peel's round count in a window (the eager frame's).
        self._peel_rounds = None
        # Host chunk-cull survivor cap (bumps pre-dispatch; never drops).
        self._chunk_cap = None
        # Framebuffer bands (SetTileSharding): the band mesh, and per mesh
        # device the compile's static tensors copied there.
        self._tile_mesh = None
        self._band_copies: dict = {}
        dev = context.device
        self.fb = torch.zeros((4, self.height, self.width), dtype=torch.float32,
                              device=dev)
        self.zb = torch.ones((self.height, self.width), dtype=torch.float32,
                             device=dev)
        self.sb = torch.zeros((self.height, self.width), dtype=torch.uint8,
                              device=dev)
        # Compile cache
        self._compiled = CompiledScene()
        self._empty_texture_stack()
        # Stats
        self.stats = VxStats()
        self._fps_window_start = time.monotonic()
        self._fps_frames = 0
        # Object membership: entities added via AddObject; empty = everything.
        self._objects: list | None = None
        self.pre_render_callbacks: list = []
        self.post_render_callbacks: list = []
        self.post_sprite_callbacks: list = []
        # Packed-transfer frame state (pipeline/packing.py)
        self._layout_sig = None
        self._layout = None
        self._buf_f = None
        self._buf_i = None
        self._packed_static: dict | None = None
        self._packed_static_vers = None
        from ..profiler import FramePhases
        self.phases = FramePhases()
        # User clip planes (reference CKRasterizerContext::SetUserClipPlane):
        # index -> (plane eq, enabled); kept side is dot((p,1),eq) >= 0.
        self.user_clip_planes: dict[int, tuple] = {}
        self._global_render_mode = (2, True, False)   # (shading, tex, wire)
        self._transparent_mode = False
        self._state = 0
        self._stencil_used_mask = 0
        # Host-side stores of the API (reference rendercontext.py:3422-3561):
        # dirty rects, texture-stage states and matrices, and the screen
        # backup, kept on the device (BackupScreen).
        self._dirty_rects: list = []
        self._texture_stage_states: dict = {}
        self._texture_matrices: dict = {}
        self._screen_backup = None
        # Immediate-mode DrawPrimitive state (reference :96-104): the DP
        # transforms (view / projection None = the camera's), material,
        # texture and render state, the staging structure, the shared index
        # buffer, the pooled staging VB and the pending Sprite3D batches.
        self._dp_world = np.eye(4, dtype=np.float32)
        self._dp_view = None
        self._dp_proj = None
        self._dp_material = None
        self._dp_texture = None
        self._dp_state = None
        self._dp_struct = None
        self._dp_indices = None
        self._current_vb = None
        self._current_vb_count = 0
        self._sprite3d_mats: list = []
        # Debug object stepping (SetDebugObjectCount; -1 renders every
        # entity), the stepping label's (text, device image) and the PV
        # watermark's texture.
        self._debug_object_count = -1
        self._dbg_label = (None, None)
        self._pv_texture = None

    # -- frame windows (SetFramePipelining) ------------------------------
    def _pending(self) -> bool:
        """Staged frames, or a window or batch whose read is pending."""
        return bool(self._win_slots or self._win_pending is not None
                    or self._batch_read is not None)

    @property
    def fb(self):
        if self._pending():
            self._sync_window()
        return self._fb_val

    @fb.setter
    def fb(self, v):
        self._fb_val = v
        self._win_fence = None

    @property
    def zb(self):
        if self._pending():
            self._sync_window()
        return self._zb_val

    @zb.setter
    def zb(self, v):
        self._zb_val = v

    @property
    def sb(self):
        if self._pending():
            self._sync_window()
        return self._sb_val

    @sb.setter
    def sb(self, v):
        self._sb_val = v

    def SetFramePipelining(self, window: int = 1):
        """Render up to ``window`` frames per window (reference
        SetFramePipelining): Render() stages the frame's packed buffers, and
        a full window, or the first read of fb / zb / sb or of the fence,
        runs the staged frames, each as one replay of a CUDA graph captured
        for the window's key (``pipeline.window``). A frame that accumulates,
        reads a device texture, renders to a texture, runs in debug mode or
        takes the exact tiled ordered pass renders eagerly, after the staged
        ones. window = 1 restores the eager frame."""
        self._sync_window()
        self._win_size = max(1, int(window))

    def GetFramePipelining(self) -> int:
        return self._win_size

    def GetFrameFence(self):
        """A completion token: in frame-window mode the last window's (W,)
        f32 per-frame checksums (``window.checksum``; entries past a
        partial window's frames repeat its last one), else the
        framebuffer. The window is resolved first (its flagged frames
        rendered again), so the token's frames are exact."""
        self._sync_window()
        f = self._win_fence
        return f if f is not None else self.fb

    def AddPreRenderCallBack(self, fct, arg=None, temp: bool = False):
        self.pre_render_callbacks.append(("pre", fct, arg, temp))

    def RemovePreRenderCallBack(self, fct):
        self.pre_render_callbacks = [
            cb for cb in self.pre_render_callbacks if cb[1] is not fct]

    def AddPostRenderCallBack(self, fct, arg=None, temp: bool = False):
        self.post_render_callbacks.append(("post", fct, arg, temp))

    def RemovePostRenderCallBack(self, fct):
        self.post_render_callbacks = [
            cb for cb in self.post_render_callbacks if cb[1] is not fct]

    def AttachViewpointToCamera(self, camera: CKCamera):
        self.attached_camera = camera

    def GetAttachedCamera(self) -> CKCamera | None:
        return self.attached_camera

    def AddObject(self, obj):
        if self._objects is None:
            self._objects = []
        if obj not in self._objects:
            self._objects.append(obj)
            obj._in_render_context_mask |= self.mask
            self.context._bump_topology()

    def RemoveObject(self, obj):
        if self._objects and obj in self._objects:
            self._objects.remove(obj)
            obj._in_render_context_mask &= ~self.mask
            self.context._bump_topology()

    def AddObjectWithHierarchy(self, obj):
        self.AddObject(obj)
        for i in range(obj.GetChildrenCount()):
            self.AddObjectWithHierarchy(obj.GetChild(i))

    def SetBackgroundColor(self, rgba):
        self.background_color = np.asarray(rgba, np.float32)

    def GetBackgroundColor(self):
        return self.background_color.copy()

    def SetBackgroundMaterial(self, mat: CKMaterial | None):
        self.background_material = mat

    def SetAmbientLight(self, r, g=None, b=None):
        if g is None:
            rgba = np.asarray(r, np.float32)
        else:
            rgba = np.array([r, g, b, 1.0], np.float32)
        self.ambient_light = rgba

    def GetAmbientLight(self):
        return self.ambient_light.copy()

    def SetFogMode(self, mode: int):
        self.fog_mode = int(mode)

    def GetFogMode(self) -> int:
        return self.fog_mode

    def SetFogStart(self, v: float):
        self.fog_start = float(v)

    def SetFogEnd(self, v: float):
        self.fog_end = float(v)

    def SetFogDensity(self, v: float):
        self.fog_density = float(v)

    def SetFogColor(self, rgb):
        self.fog_color = np.asarray(rgb, np.float32)[:3]

    def SetViewRect(self, x, y, w, h):
        self.viewport = (int(x), int(y), int(w), int(h))

    def GetViewRect(self):
        return self.viewport

    def SetCurrentRenderOptions(self, flags: int):
        self.render_flags = int(flags)

    def GetCurrentRenderOptions(self) -> int:
        return self.render_flags

    def AddCurrentRenderOptions(self, add: int):
        self.render_flags |= int(add)

    def RemoveCurrentRenderOptions(self, remove: int):
        self.render_flags &= ~int(remove)

    def ResolveRenderFlags(self, flags: int) -> int:
        """No option bits in the low 16 -> use the context's stored flags
        (reference ResolveRenderFlags, src/CKRenderContext.cpp:222-229)."""
        return self.render_flags if (flags & CK_RENDER_OPTIONSMASK) == 0 \
            else int(flags)

    def _effective_viewport(self):
        """Viewport after camera aspect-ratio letterboxing (reference
        CKRenderedScene::UpdateViewportSize, src/CKRenderedScene.cpp:538-618:
        CK_RENDER_USECAMERARATIO centers a camera-aspect rect in the window).
        Deviation: applies only when SetAspectRatio was called explicitly —
        the 4:3 ctor default tracks the window instead of letterboxing it."""
        vp = self.viewport
        cam = self.attached_camera
        flags = getattr(self, "_frame_flags", self.render_flags)
        if (cam is None or not (flags & CK_RENDER_USECAMERARATIO)
                or not getattr(cam, "_aspect_set", False)
                or getattr(cam, "ignore_aspect", False)):
            return vp
        x, y, w, h = vp
        cw, ch = cam.GetAspectRatio()
        cw, ch = max(int(cw), 1), max(int(ch), 1)
        if w * ch >= h * cw:              # window wider than camera: pillarbox
            vw, vh = cw * h // ch, h
        else:                             # window taller: letterbox
            vw, vh = w, ch * w // cw
        return (x + (w - vw) // 2, y + (h - vh) // 2, max(vw, 1), max(vh, 1))

    def GetWidth(self) -> int:
        return self.width

    def GetHeight(self) -> int:
        return self.height

    def Resize(self, width: int, height: int):
        self._sync_window()
        self.width = int(width)
        self.height = int(height)
        self.viewport = (0, 0, self.width, self.height)
        dev = self.context.device
        self.fb = torch.zeros((4, self.height, self.width),
                              dtype=torch.float32, device=dev)
        self.zb = torch.ones((self.height, self.width), dtype=torch.float32,
                             device=dev)
        self.sb = torch.zeros((self.height, self.width), dtype=torch.uint8,
                              device=dev)

    def _scene_entities(self) -> list[CK3dEntity]:
        if self._objects is not None:
            ents = [o for o in self._objects if isinstance(o, CK3dEntity)]
        else:
            ents = [o for o in self.context._objects.values()
                    if isinstance(o, CK3dEntity)]
        # Scene-graph priority order (CKSceneGraphNode::SortNodes semantics:
        # higher priority renders first; ties keep creation order).
        ents.sort(key=lambda e: (-e.render_priority, e.id))
        return ents

    def _compile(self):
        c = CompiledScene()
        c.topology_version = self.context._topology_version
        ctx = self.context
        table = ctx.entity_table
        self._chunk_cap = None
        self._solve_caps = None
        self._gov_frames = 0
        self._peel_rounds = None

        entities = self._scene_entities()
        c.n_entities = table.count
        c.levels = table.level_schedule()

        # Material/state buckets: one per distinct material (+ default).
        # Sprite3D draws get their own bucket per material (cull forced off).
        default_mat = getattr(ctx.render_manager, "default_material", None)
        mat_to_bucket: dict[tuple, int] = {}
        tex_to_slot = c.tex_slot

        def tex_slot_for(tex) -> int:
            tkey = id(tex)
            if tkey not in tex_to_slot:
                tex_to_slot[tkey] = len(c.textures)
                c.textures.append(tex)
            return tex_to_slot[tkey]

        def bucket_for(mat: CKMaterial | None, kind: str = "mesh",
                       blends=None) -> int:
            key = (id(mat), kind, blends)
            if key in mat_to_bucket:
                return mat_to_bucket[key]
            if mat is not None and mat.GetTexture(0) is not None:
                tex_slot_for(mat.GetTexture(0))
            mat_to_bucket[key] = len(c.materials)
            c.materials.append((mat, kind, blends))
            return mat_to_bucket[key]

        pool_pos, pool_nrm, pool_uv, pool_col, pool_spec = [], [], [], [], []
        mesh_offset: dict[int, int] = {}
        pool_count = 0

        src, vent, vstate, vlit = [], [], [], []
        tidx, tstate = [], []
        iv = 0

        skin_descs = []
        for ent in entities:
            mesh = ent.GetCurrentMesh()
            if mesh is None or (mesh.GetFaceCount() == 0
                                and mesh.GetLineCount() == 0):
                continue
            # A custom render callback REPLACES the default mesh render
            # (reference RCKMesh::SetRenderCallBack): skip its triangles;
            # the callback fires after the frame program (immediate draws).
            if getattr(mesh, "render_callback", None) is not None:
                continue
            # Skinned entities get a private pool block (their pool vertices
            # are overwritten per-frame by the device skin stage).
            mesh_key = (id(mesh), ent.row if ent.skin is not None else -1)
            if mesh_key not in mesh_offset:
                mesh_offset[mesh_key] = pool_count
                c.pool_sources.append((mesh, -1))
                pool_pos.append(mesh.positions)
                pool_nrm.append(mesh.normals)
                pool_uv.append(mesh.uvs)
                pool_col.append(mesh.colors)
                pool_spec.append(mesh.specular_colors)
                if ent.skin is not None:
                    skin_descs.append(ent.skin.bank_descriptor(pool_count))
                pool_count += mesh.positions.shape[0]
            moff = mesh_offset[mesh_key]
            lit = not mesh.IsPreLitMode()
            # Z-only / stencil-only entities draw through dedicated buckets
            # (VX_MOVEABLE_ZBUFONLY / STENCILONLY, reference draw-flag
            # assembly src/CKMesh.cpp:3938-3974).
            eflags = int(table.flags[ent.row])
            draw_kind = "mesh"
            if eflags & et.VX_MOVEABLE_STENCILONLY:
                draw_kind = "stencil"
            elif eflags & et.VX_MOVEABLE_ZBUFONLY:
                draw_kind = "zbufonly"
            for grp in mesh.GetRenderGroups():
                mat = grp.material if grp.material is not None else default_mat
                # Wireframe fill mode draws the triangle edges through the
                # line pass (reference VXFILL_WIREFRAME / wireframe overlay,
                # src/CKMesh.cpp:4134-4153).
                from ..raster.types import VXFILL
                if mat is not None and mat.GetFillMode() == int(VXFILL.WIREFRAME):
                    nv = grp.vertex_map.shape[0]
                    base_iv = iv
                    src.append(moff + grp.vertex_map)
                    vent.append(np.full(nv, ent.row, np.int32))
                    vstate.append(np.zeros(nv, np.int32))
                    vlit.append(np.zeros(nv, bool))
                    col = tuple(np.asarray(mat.GetDiffuse()).tolist())
                    edges = set()
                    for (a, b_, cc) in grp.local_faces:
                        for e0, e1 in ((a, b_), (b_, cc), (cc, a)):
                            key = (min(e0, e1), max(e0, e1))
                            if key not in edges:
                                edges.add(key)
                                c.line_segments.append(dict(
                                    i0=base_iv + int(key[0]),
                                    i1=base_iv + int(key[1]), color=col))
                    iv += nv
                    continue
                b = bucket_for(mat, kind=draw_kind)
                nv = grp.vertex_map.shape[0]
                src.append(moff + grp.vertex_map)
                vent.append(np.full(nv, ent.row, np.int32))
                vstate.append(np.full(nv, b, np.int32))
                vlit.append(np.full(nv, lit, bool))
                gfaces = grp.local_faces
                if draw_kind == "mesh":
                    # Alpha-test pre-gate: faces whose conservative alpha
                    # upper bound provably fails the test never enter the
                    # stream (they cannot waste peel layer slots or solve
                    # work) — see _atest_prefail_mask.
                    drop = self._atest_prefail_mask(mat, mesh, grp)
                    if drop is not None and drop.any():
                        gfaces = gfaces[~drop]
                        c.atest_pregated += int(drop.sum())
                tidx.append(iv + gfaces)
                tstate.append(np.full(gfaces.shape[0], b, np.int32))
                iv += nv
                # Multi-texture effects synthesize blended passes re-drawing
                # the group over its base draw (BumpEnv/DP3/2-3Textures,
                # reference src/CKMaterial.cpp:1668-2060).
                if mat is None or draw_kind != "mesh":
                    continue
                for pi, pdesc in enumerate(self._effect_passes_for(mat)):
                    for s in (pdesc["slot"], pdesc["bump_slot"]):
                        if s >= 0 and mat.GetTexture(s) is not None:
                            tex_slot_for(mat.GetTexture(s))
                    if pdesc.get("bias_tex") is not None:
                        tex_slot_for(pdesc["bias_tex"])
                    # DP3 constants are per-entity (object-space light dir),
                    # so DP3 buckets split by entity row.
                    row = ent.row if pdesc["dp3"] else -1
                    key = (id(mat), "effectpass", pi, row)
                    if key not in mat_to_bucket:
                        mat_to_bucket[key] = len(c.materials)
                        c.materials.append(
                            (mat, "effectpass",
                             (pdesc, ent if pdesc["dp3"] else None)))
                    b2 = mat_to_bucket[key]
                    src.append(moff + grp.vertex_map)
                    vent.append(np.full(nv, ent.row, np.int32))
                    vstate.append(np.full(nv, b2, np.int32))
                    vlit.append(np.zeros(nv, bool))
                    tidx.append(iv + grp.local_faces)
                    tstate.append(np.full(grp.local_faces.shape[0], b2,
                                          np.int32))
                    iv += nv
            # Material channels: extra UV sets re-drawing the mesh triangles
            # blended over the base pass (RCKMesh::RenderChannels, reference
            # src/CKMesh.cpp:4390+; multi-pass path). Each channel gets a
            # private pool block carrying its own UVs.
            for ci, chan in enumerate(mesh.channels):
                if not chan["active"] or chan["material"] is None:
                    continue
                ckey = (id(mesh), f"chan{ci}",
                        ent.row if ent.skin is not None else -1)
                if ckey not in mesh_offset:
                    mesh_offset[ckey] = pool_count
                    c.pool_sources.append((mesh, ci))
                    pool_pos.append(mesh.positions)
                    pool_nrm.append(mesh.normals)
                    pool_uv.append(chan["uvs"])
                    pool_col.append(mesh.colors)
                    pool_spec.append(mesh.specular_colors)
                    pool_count += mesh.positions.shape[0]
                coff = mesh_offset[ckey]
                b = bucket_for(chan["material"], kind="channel",
                               blends=(chan["src_blend"], chan["dst_blend"]))
                nv = mesh.positions.shape[0]
                src.append(coff + np.arange(nv, dtype=np.int32))
                vent.append(np.full(nv, ent.row, np.int32))
                vstate.append(np.full(nv, b, np.int32))
                vlit.append(np.full(nv, lit, bool))
                tidx.append(iv + mesh.faces.astype(np.int32))
                tstate.append(np.full(mesh.faces.shape[0], b, np.int32))
                iv += nv
            # Mesh line list -> device line pass (RCKMesh line pass,
            # reference src/CKMesh.cpp:4168-4192). Endpoints get their own
            # stream block (full mesh vertex range).
            if mesh.GetLineCount() > 0:
                nv = mesh.positions.shape[0]
                lmat = mesh.GetMaterial(0) if mesh.GetMaterialCount() else None
                lcolor = (np.asarray(lmat.GetDiffuse(), np.float32)
                          if lmat is not None else None)
                src.append(moff + np.arange(nv, dtype=np.int32))
                vent.append(np.full(nv, ent.row, np.int32))
                vstate.append(np.zeros(nv, np.int32))
                vlit.append(np.zeros(nv, bool))
                for (a0, a1) in np.asarray(mesh.lines):
                    col = (lcolor if lcolor is not None
                           else mesh.colors[a0] if mesh.colors.shape[0] > a0
                           else (1, 1, 1, 1))
                    c.line_segments.append(
                        dict(i0=iv + int(a0), i1=iv + int(a1),
                             color=tuple(np.asarray(col).tolist())))
                iv += nv

        # Sprite3D billboards: 4 reserved pool rows + 2 triangles per sprite,
        # corners computed on the device per frame (pipeline/overlay.py).
        # The stream vertices bind to the identity entity row (= table.count).
        from .sprite3d import CKSprite3D

        ident_row = table.count
        for ent in entities:
            if not isinstance(ent, CKSprite3D):
                continue
            mat = ent.material if ent.material is not None else default_mat
            b = bucket_for(mat, kind="sprite")
            pool_base = pool_count
            c.sprite3d_list.append((ent, pool_base, b))
            u0, v0, u1, v1 = ent.uv_rect
            pool_pos.append(np.zeros((4, 3), np.float32))
            pool_nrm.append(np.zeros((4, 3), np.float32))
            pool_uv.append(np.array([[u0, v1], [u1, v1], [u1, v0], [u0, v0]],
                                    np.float32))
            diff = (mat.GetDiffuse() if mat is not None
                    else np.array([1, 1, 1, 1], np.float32))
            pool_col.append(np.tile(np.asarray(diff, np.float32), (4, 1)))
            pool_spec.append(np.zeros((4, 3), np.float32))
            pool_count += 4
            src.append(pool_base + np.arange(4, dtype=np.int32))
            vent.append(np.full(4, ident_row, np.int32))
            vstate.append(np.full(4, b, np.int32))
            vlit.append(np.zeros(4, bool))
            tidx.append(iv + np.array([[0, 1, 2], [0, 2, 3]], np.int32))
            tstate.append(np.full(2, b, np.int32))
            iv += 4
        c.extra_pool = 4 * len(c.sprite3d_list)

        # 2D overlay entities: register their textures in the shared stack.
        from .entity2d import CK2dEntity

        for obj in ctx._objects.values():
            if isinstance(obj, CK2dEntity):
                t = obj.texture()
                if t is not None and t.current_image() is not None:
                    tex_slot_for(t)
        # Background material texture (Clear draws it as a full-screen quad,
        # reference src/CKRenderContext.cpp:465-519).
        if (self.background_material is not None
                and self.background_material.GetTexture(0) is not None):
            tex_slot_for(self.background_material.GetTexture(0))

        if pool_count == 0:
            pool_pos = [np.zeros((1, 3), np.float32)]
            pool_nrm = [np.zeros((1, 3), np.float32)]
            pool_uv = [np.zeros((1, 2), np.float32)]
            pool_col = [np.ones((1, 4), np.float32)]
            pool_spec = [np.zeros((1, 3), np.float32)]
            pool_count = 1
        c.positions = np.concatenate(pool_pos).astype(np.float32)
        c.normals = np.concatenate(pool_nrm).astype(np.float32)
        c.uv = np.concatenate(pool_uv).astype(np.float32)
        c.prelit = np.concatenate(pool_col).astype(np.float32)
        c.prelit_spec = np.concatenate(pool_spec).astype(np.float32)
        c._mesh_pool_count = pool_count - c.extra_pool
        c._pool_version = sum(getattr(m, "data_version", 0)
                              for m, _ci in c.pool_sources)

        if not c.materials:
            bucket_for(default_mat)

        iv_pad = _pad_to(max(iv, 1))
        it = sum(a.shape[0] for a in tidx) if tidx else 0
        it_pad = _pad_to(max(it, 1))

        def cat_pad(parts, n, dtype, fill=0, shape=()):
            if parts:
                a = np.concatenate(parts).astype(dtype)
            else:
                a = np.zeros((0,) + shape, dtype)
            out = np.full((n,) + a.shape[1:], fill, dtype)
            out[: a.shape[0]] = a
            return out

        c.src_idx = cat_pad(src, iv_pad, np.int32)
        c.vert_entity = cat_pad(vent, iv_pad, np.int32)
        c.vert_state = cat_pad(vstate, iv_pad, np.int32)
        c.vert_lit = cat_pad(vlit, iv_pad, bool)
        # Static: does any REAL stream row use prelit colors? (pad rows are
        # "unlit" but belong to no valid triangle.) Gates the prelit pool
        # gathers out of the vertex stage via sampler_profile[7].
        c.any_prelit = bool(np.any(~np.concatenate(vlit))) if vlit else False
        c.tri_idx = cat_pad(tidx, it_pad, np.int32, shape=(3,))
        c.tri_state = cat_pad(tstate, it_pad, np.int32)
        valid = np.zeros(it_pad, bool)
        valid[:it] = True
        c.tri_valid = valid
        c.n_valid_tris = int(valid.sum())   # cached: stats read per frame

        # --- corner-major post-pass (device gather elimination) ------------
        # Triangles whose three stream vertices come from pool rows that no
        # DEVICE stage rewrites (skins, billboards) are re-pointed at a
        # corner-expanded static pool block appended to the pool: their
        # vertex data then streams DENSELY through the vertex stage and
        # triangle assembly becomes a reshape — removing the two ~3*IT-row
        # gathers that dominated the frame at Ballance scale (~32 ms).
        # Host-refreshed meshes (morphs, patch tessellation) stay eligible:
        # _refresh_pool re-expands the corner rows from corner_src_pool.
        # (Round-3 note: making skinned rows corner-eligible by extending
        # the skin bank to the expanded copies was tried and measured 4x
        # SLOWER — the duplicated bone table left take_small's <=128-row
        # one-hot envelope and the 3x skin stream outweighed the gathers it
        # removed. Skinned rows stay on the gathered tail.)
        written = np.zeros(pool_count, bool)
        for d in skin_descs:
            off = d["pool_offset"]
            written[off:off + d["rest_pos"].shape[0]] = True
        if c.extra_pool:
            written[pool_count - c.extra_pool:] = True
        if it:
            src_tri = c.src_idx[c.tri_idx[:it]]              # (it, 3)
            # Out-of-range stream/pool refs (inconsistent user meshes — the
            # device path clamps them) stay on the gathered tail.
            oob = (src_tri < 0) | (src_tri >= pool_count)
            hit = written[np.clip(src_tri, 0, pool_count - 1)] | oob
            eligible = ~hit.any(axis=1)
        else:
            eligible = np.zeros(0, bool)
        itc = int(eligible.sum())
        if itc:
            elig_idx = np.nonzero(eligible)[0]
            if itc >= 8192:
                # Spatial (Morton) sort of the corner block per entity: the
                # cache-optimizer reorder scrambles locality, which would
                # make every cull chunk span the whole mesh. Morton order
                # keeps each CH-triangle chunk spatially tight so host
                # frustum culling (chunk_meta below) can actually reject
                # chunks. Deferred-opaque output is order-independent up to
                # exact-depth ties; same-key transparent draws of one
                # entity may reorder (the reference leaves that order
                # undefined too — its own optimizers reorder faces).
                src_e = c.src_idx[c.tri_idx[elig_idx]]        # (itc, 3)
                cent = c.positions[src_e].mean(axis=1)        # (itc, 3)
                ent_e = c.vert_entity[c.tri_idx[elig_idx, 0]]
                lo = cent.min(0)
                # one COMMON scale for all axes: a near-flat axis (terrain
                # y) then maps to a constant instead of amplified noise
                # that would scramble the interleave
                span = max(float((cent.max(0) - lo).max()), 1e-6)
                q = np.clip((cent - lo) / span * 1023, 0,
                            1023).astype(np.uint32)

                def spread(v):
                    v = (v | (v << 16)) & 0x030000FF
                    v = (v | (v << 8)) & 0x0300F00F
                    v = (v | (v << 4)) & 0x030C30C3
                    v = (v | (v << 2)) & 0x09249249
                    return v
                morton = (spread(q[:, 0]) | (spread(q[:, 1]) << 1)
                          | (spread(q[:, 2]) << 2))
                elig_idx = elig_idx[np.lexsort((morton, ent_e))]
            order = np.concatenate([
                elig_idx, np.nonzero(~eligible)[0],
                np.arange(it, it_pad)])
            c.tri_state = c.tri_state[order]
            c.tri_valid = c.tri_valid[order]
            tri_idx = c.tri_idx[order]
            nc = 3 * itc
            # PLANAR corner order: stream rows [0,itc) are corner 0 of every
            # eligible triangle, [itc,2*itc) corner 1, [2*itc,3*itc) corner 2.
            # Per-corner vertex data is then a contiguous 2D SLICE of the
            # stream — rank-3 (IT,3,C) corner arrays never materialize on
            # device (their trailing (3,C) dims pad to native (8,128) tiles,
            # a 16x traffic blow-up measured at ~12 ms/frame at 527k tris).
            corner_src = c.src_idx[tri_idx[:itc]].T.reshape(-1)
            c.corner_src_pool = corner_src.astype(np.int32)
            p0 = c.positions.shape[0]
            for attr in ("positions", "normals", "uv", "prelit",
                         "prelit_spec"):
                a = getattr(c, attr)
                setattr(c, attr, np.concatenate([a, a[corner_src]]))
            corner_iv = tri_idx[:itc].T.reshape(-1)          # old stream rows
            # Trim the old stream to rows something still references (tail
            # triangle corners, line endpoints) — every per-vertex op runs
            # over the whole stream, so dead rows are pure vertex-stage cost.
            used = np.zeros(iv_pad, bool)
            if itc < it:
                used[tri_idx[itc:it].reshape(-1)] = True
            for seg in c.line_segments:
                used[seg["i0"]] = True
                used[seg["i1"]] = True
            remap = np.full(iv_pad, -1, np.int32)
            n_used = int(used.sum())
            remap[used] = np.arange(n_used, dtype=np.int32)
            new_iv_pad = _pad_to(max(nc + n_used, 1))

            def restream(a, corner_vals):
                out = np.zeros((new_iv_pad,) + a.shape[1:], a.dtype)
                out[:nc] = corner_vals
                out[nc:nc + n_used] = a[used]
                return out

            c.src_idx = restream(
                c.src_idx, (p0 + np.arange(nc)).astype(np.int32))
            c.vert_entity = restream(c.vert_entity, c.vert_entity[corner_iv])
            c.vert_state = restream(c.vert_state, c.vert_state[corner_iv])
            c.vert_lit = restream(c.vert_lit, c.vert_lit[corner_iv])
            tri_new = np.where(tri_idx >= 0, nc + remap[tri_idx], 0)
            ar = np.arange(itc, dtype=np.int32)
            tri_new[:itc] = np.stack([ar, itc + ar, 2 * itc + ar], axis=1)
            tri_new[it:] = 0                       # pad tris: dead anyway
            c.tri_idx = tri_new.astype(np.int32)
            for seg in c.line_segments:
                seg["i0"] = nc + int(remap[seg["i0"]])
                seg["i1"] = nc + int(remap[seg["i1"]])
            c.corner_nc = nc
            c.corner_itc = itc
            c.corner_p0 = p0

        # --- chunk-cull metadata (host frustum culling at stream-chunk
        # granularity) -------------------------------------------------------
        # The TPU mapping of the reference's scene-graph culling
        # (CKSceneGraphNode::ComputeHierarchicalBox + IsInViewFrustrumHierarchic,
        # src/CKSceneGraph.cpp:849-888, CK3dEntity.cpp:3297):
        # the corner-major head splits into CH-triangle chunks; the HOST
        # tests each chunk's conservative world bbox against the frustum
        # every frame (numpy, ~100 parts) and ships the surviving chunk
        # list; the device compacts the stream to the static chunk cap by
        # chunk-axis takes (contiguous blocks - bandwidth, not per-row
        # gather cost). Culling only ever REMOVES fully-offscreen chunks,
        # so output is bit-identical; the cap bumps (recompile) BEFORE
        # dispatch whenever more chunks survive, so no frame ever drops
        # visible geometry.
        CH = 4096
        c.chunk_meta = None
        if itc >= 2 * CH:
            c.chunk_meta = {
                "ch": CH, "n_full": itc // CH, "itc": itc,
                "parts": None, "pool_version": None,
            }

        # Static ordered-path cap: triangles of materials that cannot take the
        # deferred opaque reduce (mirror of raster/deferred.deferred_mask).
        from ..raster.types import VXCMP

        def needs_ordered(mat: CKMaterial | None) -> bool:
            if mat is None:
                return False
            return (mat.AlphaBlendEnabled() or mat.AlphaTestEnabled()
                    or not mat.ZWriteEnabled()
                    or mat.z_func not in (int(VXCMP.LESS), int(VXCMP.LESSEQUAL)))

        ordered_buckets = {i for i, (m, kind, _b) in enumerate(c.materials)
                           if kind in ("channel", "effectpass")
                           or needs_ordered(m)}
        if ordered_buckets and it:
            n_ordered = int(np.isin(c.tri_state[:it], list(ordered_buckets)).sum())
        else:
            n_ordered = 0
        # User clip planes no longer inflate this: straddlers take the
        # per-pixel half-space test inside the deferred reduce
        # (raster/deferred.triangle_setup dplane), not the ordered pass.
        c.ordered_cap = 0 if n_ordered == 0 else _pad_to(n_ordered, 64)

        c.has_stencil = any(kind == "stencil" for _m, kind, _b in c.materials)
        # Static gate for the vertex-stage EMBM fetch (BumpEnv effect).
        c.want_bump = any(
            kind == "effectpass" and b[0]["bump_slot"] >= 0
            for _m, kind, b in c.materials)
        # Static gate for the per-pixel cube-env reflection path.
        from ..raster.types import TEXGEN_CUBE

        def _tg(m, kind, b):
            if kind == "effectpass":
                return b[0]["texgen"]
            return m._effect_texgen() if m is not None else 0
        c.want_cube = any(_tg(m, kind, b) == TEXGEN_CUBE
                          for m, kind, b in c.materials)
        # Static gate for the whole vertex-stage TexGen/reflection block.
        c.want_texgen = any(_tg(m, kind, b) != 0 for m, kind, b in c.materials)

        from ..pipeline.skinning import build_skin_bank
        c.skin_bank = build_skin_bank(skin_descs, device=ctx.device)
        # Every skin's pool rows are pool_offset + arange(v)
        # (anim/skin.py bank_descriptor): the skin stage rebuilds the pool
        # from contiguous slices instead of a row scatter.
        ranges = []
        vo = 0
        for d in skin_descs:
            v = int(d["rest_pos"].shape[0])
            ranges.append((vo, int(d["pool_offset"]), v))
            vo += v
        c.skin_ranges = tuple(ranges)
        # Line segments (wireframe fills, mesh line lists, curves) -> one
        # device line bank per compile (None without segments).
        from ..pipeline.lines import build_line_bank
        c.line_bank = build_line_bank(c.line_segments, device=ctx.device)
        self._compiled = c

        self._refresh_textures(force=True)

    def _refresh_textures(self, force: bool = False):
        """(Re)build the padded texture-plane stack; per-frame same-shape
        image updates (video textures, re-rastered sprite text) re-upload
        without recompiling."""
        c = self._compiled
        v = sum(getattr(t, "data_version", 0) for t in c.textures)
        if not force and v == c._tex_version:
            return
        # Incremental path: when only a few textures changed and their
        # shapes are stable (video textures stepping movie slots, sprite
        # text re-rasters), update just their atlas sub-rects on device
        # (.at[].set — a small transfer) instead of rebuilding + re-
        # uploading the whole stack every frame.
        meta = getattr(c, "_tex_meta", None)
        if not force and meta is not None and c.textures:
            vers = [getattr(t, "data_version", 0) for t in c.textures]
            changed = [i for i, (a, b) in
                       enumerate(zip(vers, meta["versions"])) if a != b]
            if changed and len(changed) <= 8:
                ok = True
                for i in changed:
                    shp = c.textures[i].image_shape()
                    rec = meta["rects"][i]
                    if shp is None or shp[:2] != (rec[3], rec[4]):
                        ok = False
                        break
                if ok:
                    # Device-resident feeds (render-to-texture) register
                    # once; the frame writes their CURRENT image into its
                    # copy of the stack (_fill_packed's texdev,
                    # pipeline/frame._apply_tex_patch): no host transfer.
                    dev_changed = [i for i in changed
                                   if c.textures[i].device_image() is not None]
                    if dev_changed:
                        c.dev_ids = getattr(c, "dev_ids", set()) | set(
                            dev_changed)
                        for i in dev_changed:
                            meta["versions"][i] = vers[i]
                        changed = [i for i in changed
                                   if i not in dev_changed]
                        if not changed:
                            c._tex_version = v
                            return
                    # Register per-frame updaters as VIDEO textures: their
                    # texels ride the packed dyn buffer from now on (one
                    # transfer pair per frame, scattered on device) — the
                    # slice writes below are only the bridge for THIS
                    # frame.
                    vids = getattr(c, "video_ids", set())
                    new_vids = [i for i in changed if i not in vids]
                    if new_vids:
                        c.video_ids = vids | set(new_vids)
                        self._layout_sig = None     # grow the patch segment
                    already = [i for i in changed if i in vids]
                    for i in already:
                        meta["versions"][i] = vers[i]
                    changed = new_vids
                    if not changed:
                        c._tex_version = v
                        return
                    planes = self._tex_planes.clone()
                    for i in changed:
                        t = c.textures[i]
                        pi, oy, ox, h, w, mip_col, levels = meta["rects"][i]
                        img = np.asarray(t.current_image(), np.float32)
                        planes[pi, :, oy:oy + h, ox:ox + w] = \
                            torch.as_tensor(np.moveaxis(img, -1, 0)).to(
                                planes)
                        for lv, nh, nw, y_off, cur in _mip_chain(
                                img, t, levels):
                            planes[pi, :, oy + y_off:oy + y_off + nh,
                                   ox + mip_col:ox + mip_col + nw] = \
                                torch.as_tensor(np.moveaxis(cur, -1, 0)).to(
                                    planes)
                        meta["versions"][i] = vers[i]
                    self._tex_planes = planes
                    c._tex_version = v
                    return
        c._tex_version = v
        rm = self.context.render_manager
        mips_off = bool(int(rm.options.get("DisableMipmap", 0))) \
            if rm is not None else False
        if c.textures:
            imgs = [t.current_image() for t in c.textures]
            imgs = [i if i is not None else np.zeros((1, 1, 4), np.float32) for i in imgs]
            th = max(i.shape[0] for i in imgs)
            tw = max(i.shape[1] for i in imgs)
            want_mips = (not mips_off) and any(
                t.mipmap and t.current_image() is not None
                and min(t.current_image().shape[:2]) >= 2 for t in c.textures)
            # Mixed-size texture sets: the per-texture-plane layout pads
            # every texture to the max size. When that wastes >1.5x the
            # actual texel area, shelf-pack the per-texture blocks (base +
            # its mip column) into ONE atlas plane instead; tex_hw grows
            # (off_y, off_x) columns that the samplers apply per texel.
            blocks_w = [i.shape[1] + (i.shape[1] // 2 if want_mips else 0)
                        for i in imgs]
            pad_area = len(imgs) * th * (tw + (tw // 2 if want_mips else 0))
            used_area = sum(i.shape[0] * bw
                            for i, bw in zip(imgs, blocks_w))
            use_atlas = (getattr(self, "_atlas_enabled", True)
                         and len(imgs) > 1 and pad_area > 1.5 * used_area)
            if use_atlas:
                atlas_w_pack = max(128, max(blocks_w))
                order = sorted(range(len(imgs)),
                               key=lambda i: -imgs[i].shape[0])
                offs = [None] * len(imgs)
                shelf_y = 0
                cur_x, cur_y, shelf_h = 0, 0, 0
                for i in order:
                    bh, bw = imgs[i].shape[0], blocks_w[i]
                    if cur_x + bw > atlas_w_pack:
                        cur_y += shelf_h
                        cur_x, shelf_h = 0, 0
                    offs[i] = (cur_y, cur_x)
                    cur_x += bw
                    shelf_h = max(shelf_h, bh)
                atlas_h = cur_y + shelf_h
                planes = np.zeros((1, 4, atlas_h, atlas_w_pack), np.float32)
                hw = np.zeros((len(imgs), 5 if want_mips else 4), np.int32)
            else:
                atlas_w = tw + (tw // 2 if want_mips else 0)
                planes = np.zeros((len(imgs), 4, th, atlas_w), np.float32)
                # 3 columns (h, w, n_levels) statically signals a mip atlas.
                hw = np.zeros((len(imgs), 3 if want_mips else 2), np.int32)
            rects = []
            for i, (t, img) in enumerate(zip(c.textures, imgs)):
                h, w = img.shape[0], img.shape[1]
                if use_atlas:
                    oy, ox = offs[i]
                    pi = 0
                else:
                    oy, ox = 0, 0
                    pi = i
                planes[pi, :, oy:oy + h, ox:ox + w] = np.moveaxis(img, -1, 0)
                levels = 1
                if want_mips and t.mipmap and min(h, w) >= 2:
                    # Mip atlas: level L at cols [tw, tw + w>>L), rows
                    # [h - (h >> (L-1)), ...). Box-filtered chain (or user
                    # mip levels when provided, reference user mips).
                    cur = img
                    lh, lw = h, w
                    mip_col = w if use_atlas else tw
                    while min(lh, lw) >= 2:
                        user = (t.user_mip_levels[levels - 1]
                                if len(t.user_mip_levels) >= levels else None)
                        nh, nw = max(lh // 2, 1), max(lw // 2, 1)
                        if user is not None and user.shape[:2] == (nh, nw):
                            cur = np.asarray(user, np.float32)
                        else:
                            cur = cur[: nh * 2, : nw * 2].reshape(
                                nh, 2, nw, 2, 4).mean(axis=(1, 3))
                        y_off = 0 if levels == 1 else h - (h >> (levels - 1))
                        planes[pi, :, oy + y_off:oy + y_off + nh,
                               ox + mip_col:ox + mip_col + nw] = \
                            np.moveaxis(cur, -1, 0)
                        lh, lw = nh, nw
                        levels += 1
                if use_atlas:
                    hw[i] = ((h, w, levels, oy, ox) if want_mips
                             else (h, w, oy, ox))
                else:
                    hw[i] = (h, w, levels) if want_mips else (h, w)
                rects.append((pi, oy, ox, h, w,
                              (w if use_atlas else tw) if want_mips else 0,
                              levels))
            # 16-bit texture video formats (reference TextureVideoFormat
            # option / per-texture SetDesiredVideoFormat: _16_RGB565 etc.)
            # store the device stack in bfloat16 — half the texture HBM and
            # gather bandwidth, with quantization comparable to 16-bit
            # hardware formats. 32-bit formats keep float32.
            fmt = str((rm.options.get("TextureVideoFormat", "")
                       if rm is not None else "") or "")
            per_tex_16 = c.textures and all(
                "_16" in str(t.desired_video_format or "")
                or "16_" in str(t.desired_video_format or "")
                for t in c.textures)
            use_16 = "_16" in fmt or fmt.startswith("16") or per_tex_16
            dtype = torch.bfloat16 if use_16 else torch.float32
            dev = self.context.device
            self._tex_planes = torch.as_tensor(planes).to(dev, dtype)
            self._tex_hw = torch.as_tensor(hw, device=dev)
            self._bake_tex_quads(c, planes, rects, dtype)
            c._tex_meta = {
                "versions": [getattr(t, "data_version", 0)
                             for t in c.textures],
                "rects": rects,
            }
        else:
            dev = self.context.device
            self._tex_planes = torch.zeros((1, 4, 1, 1), dtype=torch.float32,
                                           device=dev)
            self._tex_hw = torch.ones((1, 2), dtype=torch.int32, device=dev)
            c._tex_meta = None
            self._tex_quad = None
            c._quad_ok = False

    def _bake_tex_quads(self, c, planes, rects, dtype):
        """Quad-texel table for one-gather bilinear sampling: each (y, x)
        row holds the 2x2 block [c00, c10, c01, c11] with the +1 neighbors
        baked per the texture's addressing mode (wrap rolls inside the
        texture's own level region; clamp/border resolve to the edge texel
        for the +1 neighbor — see raster/deferred's quad path). Disabled
        (quad_ok False) when a texture is used with conflicting wrap-vs-
        clamp modes, with MIRROR/MIRRORONCE, or the stack is too large."""
        from ..raster.types import VXTEXTURE_ADDRESS as _TA

        if planes.size * 16 > 512 * 1024 * 1024:       # quad table > 512 MB
            self._tex_quad = None
            c._quad_ok = False
            return
        slot_modes: dict[int, set] = {}
        for mat, _kind, _b in c.materials:
            if mat is None:
                continue
            am = int(mat.texture_address_mode)
            for s in range(4):
                t = mat.GetTexture(s)
                if t is not None and id(t) in c.tex_slot:
                    slot_modes.setdefault(c.tex_slot[id(t)], set()).add(am)
        wrap_like = {int(_TA.WRAP)}
        # MIRROR is NOT clamp-like for the +1 neighbor: in odd periods the
        # adjacent tap is x-1, so a single baked neighbor cannot serve it.
        clampish = {int(_TA.CLAMP), int(_TA.BORDER)}
        quad = np.zeros(planes.shape[:1] + planes.shape[2:] + (16,),
                        np.float32)                    # (NP, TH, TAW, 16)
        for i, (pi, oy, ox, h, w, mip_col, levels) in enumerate(rects):
            ms = slot_modes.get(i, set())
            if not ms or ms <= clampish:
                wrap = False
            elif ms <= wrap_like:
                wrap = True
            else:
                self._tex_quad = None
                c._quad_ok = False
                return
            regions = [(oy, ox, h, w)]
            lh, lw = h, w
            for lv in range(1, levels):
                nh, nw = max(lh // 2, 1), max(lw // 2, 1)
                y_off = 0 if lv == 1 else h - (h >> (lv - 1))
                regions.append((oy + y_off, ox + mip_col, nh, nw))
                lh, lw = nh, nw
            for (ry, rx, rh, rw) in regions:
                sub = planes[pi, :, ry:ry + rh, rx:rx + rw]   # (4, rh, rw)
                if wrap:
                    xp = np.roll(sub, -1, axis=2)
                    yp = np.roll(sub, -1, axis=1)
                    xyp = np.roll(xp, -1, axis=1)
                else:
                    xp = np.concatenate([sub[:, :, 1:], sub[:, :, -1:]], 2)
                    yp = np.concatenate([sub[:, 1:, :], sub[:, -1:, :]], 1)
                    xyp = np.concatenate([xp[:, 1:, :], xp[:, -1:, :]], 1)
                blk = np.concatenate([sub, xp, yp, xyp], axis=0)  # (16,..)
                quad[pi, ry:ry + rh, rx:rx + rw, :] = np.moveaxis(blk, 0, -1)
        self._tex_quad = torch.as_tensor(quad.reshape(-1, 16)).to(
            self.context.device, dtype)
        c._quad_ok = True

    def _light_rows_np(self) -> dict:
        """Numpy light bank (padded to 8; packed per frame).

        Cached on (topology, appearance, per-light world matrices): light
        parameter setters bump the appearance version and transforms are in
        the key bytes, so static-light scenes skip the per-frame rebuild
        (~0.1 ms host at 2 lights) while moving/retargeted lights refresh."""
        lights = list(self.context._lights.values())
        key_parts = []
        for l in lights:
            prep = getattr(l, "prepare", None)
            if prep is not None:
                prep()
            key_parts.append((l.id, l.GetWorldMatrix().tobytes()))
        ctx = self.context
        key = (ctx._topology_version, ctx._appearance_version,
               tuple(key_parts))
        cached = getattr(self, "_light_rows_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rows = []
        for l in lights:
            row = l.setup_row()
            if row is not None:
                rows.append(row)
        n = _pad_to(max(len(rows), 1), 8)
        arrs = dict(
            type=np.ones(n, np.int32),
            diffuse=np.zeros((n, 4), np.float32),
            specular=np.zeros((n, 4), np.float32),
            ambient=np.zeros((n, 4), np.float32),
            position=np.zeros((n, 3), np.float32),
            direction=np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1)),
            range=np.full(n, 1e8, np.float32),
            falloff=np.ones(n, np.float32),
            attenuation=np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1)),
            cos_theta=np.ones(n, np.float32),
            cos_phi=np.zeros(n, np.float32),
            active=np.zeros(n, bool),
        )
        for i, row in enumerate(rows):
            for k, v in row.items():
                arrs[k][i] = v
            arrs["active"][i] = row["active"]
        self._light_rows_cache = (key, arrs)
        return arrs

    def _material_banks(self, c: CompiledScene):
        from ..raster.types import VXCULL, VXTEXTURE_FILTER

        # Cache: the lowering only depends on scene topology + material/
        # light PARAMETERS (appearance version) + options — not on entity
        # motion. Materials with callbacks disable the cache (the callback
        # fires at lowering time each frame, reference SetAsCurrent hook).
        rm_ = self.context.render_manager
        key = (id(c), c.topology_version,
               self.context._appearance_version,
               self._global_render_mode,
               tuple(sorted(rm_.options.items())) if rm_ is not None else (),
               self.fog_mode)
        cached = getattr(self, "_matbank_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        # Global render options that rewrite packed state
        # (ApplyRenderOptionChange, reference src/CKRenderManager.cpp:639+).
        rm = self.context.render_manager
        opts = rm.options if rm is not None else {}
        disable_filter = bool(int(opts.get("DisableFilter", 0)))
        disable_persp = bool(int(opts.get("DisablePerspectiveCorrection", 0)))
        disable_specular = bool(int(opts.get("DisableSpecular", 0)))

        states = []
        diffuse, ambient, specular, emissive, power = [], [], [], [], []
        fog_on = self.fog_mode != int(VXFOG.NONE)
        for mat, kind, blends in c.materials:
            # Material callbacks fire when the material is lowered for the
            # frame (the SetAsCurrent hook, reference src/CKMaterial.cpp
            # material callback).
            if mat is not None and mat.callback is not None:
                fct, arg = mat.callback
                fct(self, mat, arg)
            is_sprite = kind == "sprite"
            if mat is None:
                st = RasterState(fog=fog_on)
                diffuse.append([0.7, 0.7, 0.7, 1.0])
                ambient.append([0.3, 0.3, 0.3, 1.0])
                specular.append([0.5, 0.5, 0.5, 1.0])
                emissive.append([0.0, 0.0, 0.0, 1.0])
                power.append(0.0)
            else:
                slot = c.tex_slot.get(id(mat.GetTexture(0)), -1)
                st = mat.raster_state(texture_slot=slot, fog=fog_on)
                lp = mat.lighting_params()
                diffuse.append(lp["diffuse"])
                ambient.append(lp["ambient"])
                specular.append(lp["specular"])
                emissive.append(lp["emissive"])
                power.append(lp["power"])
            import dataclasses
            repl = {}
            if is_sprite:
                repl["cull"] = int(VXCULL.NONE)
            if kind == "zbufonly":
                repl["color_write"] = False
            if kind == "stencil":
                repl["color_write"] = False
                repl["z_write"] = False
                repl["stencil"] = True
            if kind == "channel":
                # Channel passes blend over the base geometry and never
                # write Z (reference RenderChannels draw flags).
                from ..raster.types import VXBLEND
                repl["alpha_blend"] = True
                repl["z_write"] = False
                src_b = blends[0] if blends and blends[0] is not None \
                    else int(VXBLEND.SRCALPHA)
                dst_b = blends[1] if blends and blends[1] is not None \
                    else int(VXBLEND.INVSRCALPHA)
                repl["src_blend"] = src_b
                repl["dst_blend"] = dst_b
            if kind == "effectpass":
                # Synthesized multi-texture effect pass (BumpEnv/DP3/2-3TEX,
                # reference src/CKMaterial.cpp:1668-2060): blends over the
                # base draw; COPY/DOT3 stage math ignores vertex lighting
                # (the reference stages chain off ARG2=CURRENT/TFACTOR).
                pdesc, pent = blends
                if pdesc.get("bias_tex") is not None:
                    repl["tex"] = c.tex_slot.get(id(pdesc["bias_tex"]), -1)
                elif pdesc["slot"] >= 0:
                    repl["tex"] = c.tex_slot.get(
                        id(mat.GetTexture(pdesc["slot"])), -1)
                else:
                    repl["tex"] = -1
                repl["texgen"] = pdesc["texgen"]
                repl["alpha_blend"] = True
                repl["z_write"] = False
                repl["src_blend"] = pdesc["src_blend"]
                repl["dst_blend"] = pdesc["dst_blend"]
                repl["blend_op"] = pdesc.get("blend_op", 1)
                repl["tex_blend"] = pdesc["tex_blend"]
                if pdesc["bump_slot"] >= 0:
                    bt = mat.GetTexture(pdesc["bump_slot"])
                    repl["tex2"] = c.tex_slot.get(id(bt), -1)
                    repl["bump_scale"] = pdesc["bump_scale"]
                if pdesc["dp3"]:
                    repl["const_color"] = self._dp3_const(pdesc, pent)
            if disable_filter:
                repl["tex_filter"] = int(VXTEXTURE_FILTER.NEAREST)
            if disable_persp:
                repl["perspective"] = False
            if not self._global_render_mode[1]:
                # SetGlobalRenderMode(texture=False) kills all texturing
                # (reference SetGlobalRenderMode).
                repl["tex"] = -1
                repl["tex2"] = -1
            if repl:
                st = dataclasses.replace(st, **repl)
            states.append(st)
        if disable_specular:
            specular = [[0.0, 0.0, 0.0, 1.0]] * len(specular)
        si, sf = pack_states(states)
        out = (si, sf,
               np.asarray(diffuse, np.float32),
               np.asarray(ambient, np.float32),
               np.asarray(specular, np.float32),
               np.asarray(emissive, np.float32),
               np.asarray(power, np.float32))
        cacheable = not any(
            (m is not None and m.callback is not None)
            # DP3 const_color tracks a moving light/entity pair per frame
            or (k == "effectpass" and b[0].get("dp3"))
            for m, k, b in c.materials)
        if cacheable:
            self._matbank_cache = (key, out)
        return out

    def _effect_passes_for(self, mat) -> list:
        """Built-in effect passes, else the registered custom effect's
        set_callback (reference GetEffectDescription default branch,
        src/CKMaterial.cpp:1352-1360)."""
        passes = mat.effect_passes()
        if passes:
            return passes
        eff = mat.GetEffect()
        rm = self.context.render_manager
        if rm is not None and 0 <= eff < len(rm.effects):
            desc = rm.effects[eff]
            if desc.set_callback is not None:
                return desc.set_callback(self, mat, 0,
                                         desc.callback_arg) or []
        return []

    def _dp3_const(self, pdesc, ent) -> tuple:
        """Object-space light direction encoded as the per-draw constant
        color (reference DP3Effect, src/CKMaterial.cpp:1838-1886: light z
        axis for directional / obj-light vector otherwise, transformed to
        object space, y/z swapped+negated, mapped [-1,1] -> [0,1])."""
        light = pdesc.get("ref_entity")
        if light is None:
            for obj in self.context._objects.values():
                if isinstance(obj, CKLight) and obj.GetActivity():
                    light = obj
                    break
        d = np.array([0.0, 0.0, 1.0], np.float32)
        if light is not None:
            lw = light.GetWorldMatrix()
            if isinstance(light, CKLight) and light.GetType() == 3:  # DIREC
                d = lw[2, :3].astype(np.float32)
            else:
                ow = ent.GetWorldMatrix() if ent is not None \
                    else np.eye(4, dtype=np.float32)
                d = (ow[3, :3] - lw[3, :3]).astype(np.float32)
        if ent is not None:
            inv = ent.GetInverseWorldMatrix()
            d = d @ inv[:3, :3]
        d = np.array([d[0], -d[2], -d[1]], np.float32)   # swap y/z, negate
        n = np.linalg.norm(d)
        d = d / n if n > 1e-9 else np.array([0, 0, 1], np.float32)
        return tuple((d * 0.5 + 0.5).tolist())

    def _refresh_pool(self, c: CompiledScene):
        """Re-gather vertex-pool arrays when any source mesh's data changed
        since compile (morph targets, billboards, geomorph LOD) — dynamic
        updates re-upload arrays without recompiling the frame program."""
        if not c.pool_sources:
            return
        v = sum(getattr(m, "data_version", 0) for m, _ci in c.pool_sources)
        if v == c._pool_version:
            return
        mc = c._mesh_pool_count

        def regather(attr, old, chan_key=None):
            parts = []
            for m, ci in c.pool_sources:
                if chan_key is not None and ci >= 0:
                    parts.append(m.channels[ci][chan_key])
                else:
                    parts.append(getattr(m, attr))
            # static billboard tail, then the corner-expanded block rebuilt
            # from the refreshed base rows (corner-major post-pass)
            parts.append(old[mc:mc + c.extra_pool])
            base = np.concatenate(parts).astype(np.float32)
            if c.corner_nc:
                base = np.concatenate([base, base[c.corner_src_pool]])
            return base

        c.positions = regather("positions", c.positions)
        c.normals = regather("normals", c.normals)
        c.uv = regather("uvs", c.uv, chan_key="uvs")
        c.prelit = regather("colors", c.prelit)
        c.prelit_spec = regather("specular_colors", c.prelit_spec)
        c._pool_version = v

    def _quad_lists(self):
        """(background, foreground) quad-descriptor lists from the 2D entity
        trees (CKRenderedScene::Draw 2D passes, reference :166-179,
        :314-327), each in z-order; the background material's full-screen
        texture quad comes first, under everything (reference Clear's
        TRIANGLEFAN, src/CKRenderContext.cpp:465-519)."""
        c = self._compiled
        vw, vh = self.width, self.height
        back, fore = [], []
        for r in sorted(self._2d_roots(), key=lambda e: e.zorder):
            (back if r.IsBackground() else fore).append(r)
        lists = []
        for group in (back, fore):
            flat: list = []
            for r in group:
                r.collect_tree(flat)
            quads = []
            for e in flat:
                t = e.texture()
                slot = c.tex_slot.get(id(t), -1) if t is not None else -1
                quads += e.quad_descriptors(vw, vh, slot)
            lists.append(quads)
        bm = self.background_material
        if bm is not None and bm.GetTexture(0) is not None:
            slot = c.tex_slot.get(id(bm.GetTexture(0)), -1)
            lists[0].insert(0, dict(rect=(0, 0, vw, vh), uvrect=(0, 0, 1, 1),
                                    color=(1, 1, 1, 1), tex=slot, blend=0))
        return lists[0], lists[1]

    def _2d_roots(self) -> list:
        """Parentless 2D entities of the context, in creation order."""
        from .entity2d import CK2dEntity

        return [o for o in self.context._objects.values()
                if isinstance(o, CK2dEntity) and o.GetParent() is None]

    def Get2dRoot(self, background: bool = True) -> list:
        """Root 2D entities of the background or foreground tree
        (reference Get2dRoot / m_2DRootBack / m_2DRootFore)."""
        return [o for o in self._2d_roots()
                if o.IsBackground() == bool(background)]

    def Pick2D(self, x: float, y: float):
        """Front-most 2D entity under the pixel (reference Pick2D,
        src/CKRenderContext.cpp:1638-1659)."""
        # foreground before background, high zorder first
        roots = sorted(self._2d_roots(),
                       key=lambda e: (e.IsBackground(), -e.zorder))
        for r in roots:
            hit = r.Pick(x, y, self.width, self.height)
            if hit is not None:
                return hit
        return None

    def GetCurrentExtents(self) -> tuple:
        """Screen rect covered by this frame's draws so far (reference
        Get/SetCurrentExtents)."""
        return getattr(self, "_current_extents",
                       (0.0, 0.0, float(self.width), float(self.height)))

    def SetCurrentExtents(self, rect):
        self._current_extents = tuple(float(v) for v in rect)

    def AddExtents2D(self, rect, obj=None):
        """Merge a screen rect into the current extents; with ``obj``, also
        record it for 2D picking (reference AddExtents2D)."""
        x0, y0, x1, y1 = (float(v) for v in rect)
        cx0, cy0, cx1, cy1 = self.GetCurrentExtents()
        self._current_extents = (min(cx0, x0), min(cy0, y0),
                                 max(cx1, x1), max(cy1, y1))
        if obj is not None:
            if not hasattr(self, "_extents_2d"):
                self._extents_2d = []
            self._extents_2d.append(((x0, y0, x1, y1), obj))

    def EnablePortalTraversal(self, on: bool = True):
        """Automatic portal culling: the camera's place renders fully,
        neighbor places clip to their portals' projected screen rects, and
        unconnected places hide (the reference's Place/portal traversal,
        src/CKSceneGraph.cpp:113-128,569-584)."""
        self.portal_traversal = bool(on)
        self.context._bump_dynamic()

    def _portal_place_rects(self):
        """place -> pixel rect (or None=hidden) for the current camera."""
        from .place import CKPlace

        places = [o for o in self.context._objects.values()
                  if isinstance(o, CKPlace)]
        if not places:
            return {}
        cam = self.attached_camera
        cam_place = None
        if cam is not None:
            for p in places:
                if p.Contains(cam):
                    cam_place = p
                    break
            if cam_place is None:
                cam_pos = cam.GetWorldMatrix()[3, :3]
                for p in places:
                    if p.ContainsPoint(cam_pos):
                        cam_place = p
                        break
        if cam_place is None:
            return {}                      # camera outside: no portal culling
        big = 1.0e9
        full = (-big, -big, big, big)
        rects = {p: None for p in places}  # None = hidden
        rects[cam_place] = full
        # breadth-first through portals, intersecting rects along the path
        frontier = [(cam_place, full)]
        for _depth in range(4):
            nxt = []
            for place, rect in frontier:
                for entry in place.portals:
                    dst = entry.place
                    if dst is None:
                        continue
                    prect = place.portal_screen_rect(entry.portal, self)
                    if prect is None:
                        continue
                    r = (max(rect[0], prect[0]), max(rect[1], prect[1]),
                         min(rect[2], prect[2]), min(rect[3], prect[3]))
                    if r[2] <= r[0] or r[3] <= r[1]:
                        continue
                    old = rects.get(dst)
                    if old is None:
                        rects[dst] = r
                        nxt.append((dst, r))
            frontier = nxt
        return rects

    def _entity_clip_np(self, n: int) -> np.ndarray:
        big = 1.0e9
        # No places with clips, no portals, no context scissor (the common
        # case): one cached open-rect array per (n) instead of a per-frame
        # object scan + tile.
        from .place import CKPlace
        simple = (self.clip_rect is None
                  and not getattr(self, "portal_traversal", False)
                  and not any(isinstance(o, CKPlace) and o.clip_rect is not None
                              for o in self.context._objects.values()))
        if simple:
            cached = getattr(self, "_open_clip_cache", None)
            if cached is None or cached.shape[0] != n:
                cached = np.tile(
                    np.array([-big, -big, big, big], np.float32), (n, 1))
                self._open_clip_cache = cached
            return cached
        entity_clip = np.tile(np.array([-big, -big, big, big], np.float32),
                              (n, 1))
        for obj in self.context._objects.values():
            if isinstance(obj, CKPlace) and obj.clip_rect is not None:
                rect = np.asarray(obj.clip_rect, np.float32)
                for d in obj.descendants():
                    if d.row < n:
                        entity_clip[d.row] = rect
        if getattr(self, "portal_traversal", False):
            hidden = np.array([0, 0, 0, 0], np.float32)   # empty rect
            for place, rect in self._portal_place_rects().items():
                r = hidden if rect is None else np.asarray(rect, np.float32)
                for d in place.descendants():
                    if d.row < n:
                        # intersect with any manual place clip
                        e = entity_clip[d.row]
                        entity_clip[d.row] = (
                            max(e[0], r[0]), max(e[1], r[1]),
                            min(e[2], r[2]), min(e[3], r[3]))
        # Context-level clip rect (RCKRenderContext::SetClipRect, reference
        # src/CKRenderContext.cpp:2743-2781) intersects every entity rect.
        if self.clip_rect is not None:
            r = np.asarray(self.clip_rect, np.float32)
            entity_clip[:, 0] = np.maximum(entity_clip[:, 0], r[0])
            entity_clip[:, 1] = np.maximum(entity_clip[:, 1], r[1])
            entity_clip[:, 2] = np.minimum(entity_clip[:, 2], r[2])
            entity_clip[:, 3] = np.minimum(entity_clip[:, 3], r[3])
        return entity_clip

    def SetVertexShader(self, fn):
        """User vertex shader: a torch callable ``fn(posw, nrmw, scene) ->
        (posw', nrmw')`` over the world-space positions and normals (IV,3)
        of every stream row, run in the vertex stage after the world
        transform and before the normals are renormalised and lit (the
        reference's CreateVertexShader path). ``scene`` is the frame's
        ``pipeline.frame.SceneDevice``. In a frame window or a context
        batch the stage runs once, at capture (``raster/stage.py``). Host
        chunk culling tests the undisplaced bounds. None clears."""
        self.vertex_shader = fn
        self.context._bump_dynamic()

    def GetVertexShader(self):
        return self.vertex_shader

    def SetPixelShader(self, fn):
        """User per-pixel stage: a torch callable ``fn(inputs) -> (...,4)``
        rgba replacing the fixed-function texture blend in the deferred
        shade and in the ordered passes (the reference's
        CreatePixelShader/SetPixelShader,
        CKDX9RasterizerContext.cpp:1445-1553). ``inputs``: ``color``
        (...,4) interpolated lit colour, ``texel`` (...,4) (white where
        untextured), ``uv`` (...,2), ``xy`` (...,2) pixel centres at the
        render size, ``si`` / ``sf`` state rows — per pixel (H,W,NUM_SI)
        in the deferred shade, the triangle's (NUM_SI,) row in the ordered
        passes. Specular, fog, the clamp, colour writes and blending stay
        fixed-function after it. A shaded frame solves without the
        quantized rows (B1 without e-planes, or B2) and takes the exact
        ordered passes. In a frame window or a context batch the stage runs
        once, at capture (``raster/stage.py``). None clears."""
        self.pixel_shader = fn
        self.context._bump_dynamic()

    def GetPixelShader(self):
        return self.pixel_shader

    def SetClipRect(self, rect=None):
        """Pixel clip rect applied to the whole 3D scene (None clears)."""
        self.clip_rect = None if rect is None else tuple(float(v) for v in rect)
        self.context._bump_dynamic()

    def GetClipRect(self):
        return self.clip_rect

    def _video_patch_info(self, c):
        """Video-texture patch plan: (total_texels, flat channel-last texel
        indices into the plane stack, per-texture fill plan). The indices
        are STATIC per layout; per-frame texel values ride the packed dyn
        f32 buffer and are scattered on device (no extra transfers)."""
        vids = sorted(getattr(c, "video_ids", set()))
        meta = getattr(c, "_tex_meta", None)
        if not vids or meta is None:
            return 0, None, []
        key = (id(meta), tuple(vids), self._tex_planes.shape)
        cached = getattr(self, "_video_patch_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        _nt, _ch, TH, TW = self._tex_planes.shape
        idx_parts, plan = [], []
        for i in vids:
            pi, oy, ox, h, w, mip_col, levels = meta["rects"][i]
            ys, xs = np.meshgrid(np.arange(oy, oy + h),
                                 np.arange(ox, ox + w), indexing="ij")
            idx_parts.append(((pi * TH + ys) * TW + xs).reshape(-1))
            lh, lw = h, w
            for lv in range(1, levels):
                nh, nw = max(lh // 2, 1), max(lw // 2, 1)
                y0 = (0 if lv == 1 else h - (h >> (lv - 1))) + oy
                x0 = ox + mip_col
                ys, xs = np.meshgrid(np.arange(y0, y0 + nh),
                                     np.arange(x0, x0 + nw), indexing="ij")
                idx_parts.append(((pi * TH + ys) * TW + xs).reshape(-1))
                lh, lw = nh, nw
            plan.append((i, levels))
        idx = np.concatenate(idx_parts).astype(np.int32)
        out = (int(idx.shape[0]), idx, plan)
        self._video_patch_cache = (key, out)
        return out

    def BindAnimation(self, clip) -> bool:
        """Run ``clip`` (a CKKeyedAnimation) on the device: its track bank,
        held on the context's device, evaluates at the start of every
        frame (animate -> compose -> skin -> render), and
        ``clip.SetFrame(t)`` only records the time, which reaches the
        device as one scalar per frame.

        Host-side entity matrices stop tracking the clip while bound; call
        ``clip.SyncToHost()`` before host queries that must see the pose.
        Returns False (no binding) if any member animation needs host-only
        features (morph, merge, scale axis) or lacks an entity."""
        if clip is None or not clip.device_eligible():
            return False
        if self._bound_clip is not None and self._bound_clip is not clip:
            self.UnbindAnimation()
        self._bound_clip = clip
        clip._device_rc = self
        clip._host_stale = True
        self.context._bump_dynamic()
        return True

    def UnbindAnimation(self):
        """Return the bound clip (if any) to host evaluation, syncing the
        entity table to its current frame."""
        clip, self._bound_clip = self._bound_clip, None
        if clip is not None:
            clip._device_rc = None
            clip.SyncToHost()
            self.context._bump_dynamic()

    def GetBoundAnimation(self):
        return self._bound_clip

    def _ensure_packed_layout(self, n, s, l, sp, qb, qf, cp=0, vt=0, ab=0,
                              ck=0):
        from ..pipeline.packing import DynLayout

        sig = (n, s, l, sp, qb, qf, cp, vt, ab, ck)
        if self._layout_sig == sig:
            return
        self._layout_sig = sig
        lay = DynLayout()
        if ab:
            lay.add_f("anim_t", ())
        if vt:
            lay.add_f("tex_patch", (vt, 4))
        if cp:
            lay.add_f("clip_planes", (cp, 4))
        lay.add_f("local", (n, 4, 4))
        lay.add_i("entity_visible", (n,))
        lay.add_f("entity_clip", (n, 4))
        lay.add_f("entity_priority", (n,))
        lay.add_f("state_f", (s, NUM_SF))
        lay.add_i("state_i", (s, NUM_SI))
        for name in ("mat_diffuse", "mat_ambient", "mat_specular",
                     "mat_emissive"):
            lay.add_f(name, (s, 4))
        lay.add_f("mat_power", (s,))
        lay.add_i("lt_type", (l,))
        lay.add_i("lt_active", (l,))
        for name in ("lt_diffuse", "lt_specular", "lt_ambient"):
            lay.add_f(name, (l, 4))
        for name in ("lt_position", "lt_direction", "lt_attenuation"):
            lay.add_f(name, (l, 3))
        for name in ("lt_range", "lt_falloff", "lt_cos_theta", "lt_cos_phi"):
            lay.add_f(name, (l,))
        lay.add_f("global_ambient", (4,))
        lay.add_f("view", (4, 4))
        lay.add_f("proj", (4, 4))
        lay.add_f("cam_pos", (3,))
        lay.add_f("viewport", (4,))
        lay.add_i("fog_mode", ())
        lay.add_i("fog_proj", ())
        for name in ("fog_start", "fog_end", "fog_density"):
            lay.add_f(name, ())
        lay.add_f("fog_color", (3,))
        lay.add_f("clear_color", (4,))
        lay.add_f("clear_z", ())
        if sp:
            lay.add_f("sp_size", (sp, 2))
            lay.add_f("sp_offset", (sp, 2))
            lay.add_i("sp_mode", (sp,))
        for prefix, q in (("qbg", qb), ("qfg", qf)):
            if q:
                lay.add_f(f"{prefix}_rect", (q, 4))
                lay.add_f(f"{prefix}_uvrect", (q, 4))
                lay.add_f(f"{prefix}_color", (q, 4))
                lay.add_i(f"{prefix}_tex", (q,))
                lay.add_i(f"{prefix}_blend", (q,))
                lay.add_i(f"{prefix}_valid", (q,))
        if ck:
            # host-culled stream-chunk survivors (compact_scene_chunks)
            lay.add_i("chunk_idx", (ck,))
            lay.add_i("chunk_n", ())
        self._layout = lay.freeze()
        self._buf_f, self._buf_i = lay.make_buffers()

    def _packed_static_dict(self, c: CompiledScene, n: int) -> dict:
        vp = getattr(self, "_video_patch", (0, None, []))
        # id(self._tex_planes): stable across video-texture frames (their
        # texels ride the dyn patch), changes on any full stack rebuild.
        vers = (id(c), c._pool_version, id(self._tex_planes),
                vp[0], id(vp[1]))
        if self._packed_static is not None and self._packed_static_vers == vers:
            return self._packed_static
        ctx = self.context

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=ctx.device)

        if c._dev_static is None:
            c._dev_static = {k: up(getattr(c, k)) for k in (
                "src_idx", "vert_entity", "vert_state", "vert_lit",
                "tri_idx", "tri_state", "tri_valid")}
        if c._dev_pool_version != c._pool_version:
            c._dev_pool = {k: up(getattr(c, k)) for k in (
                "positions", "normals", "uv", "prelit", "prelit_spec")}
            c._dev_pool_version = c._pool_version
        static = dict(parent=up(ctx.entity_table.parent[:n]),
                      tex_planes=self._tex_planes, tex_hw=self._tex_hw,
                      **c._dev_pool, **c._dev_static)
        if getattr(self, "_tex_quad", None) is not None:
            static["tex_quad"] = self._tex_quad
        if vp[0]:
            static["texpatch_idx"] = up(vp[1])
        # Sprite3D rows (entity rows and pool bases are fixed per compile).
        self._sprites_static = None
        if c.sprite3d_list:
            self._sprites_static = dict(
                entity_row=up(np.asarray([e.row for e, _, _ in
                                          c.sprite3d_list], np.int32)),
                pool_base=up(np.asarray([pb for _, pb, _ in
                                         c.sprite3d_list], np.int32)),
                valid=torch.ones(len(c.sprite3d_list), dtype=torch.bool,
                                 device=ctx.device))
        self._packed_static = static
        self._packed_static_vers = vers
        return static

    def _entity_priority_np(self, n: int) -> np.ndarray:
        # Cached per topology version (SetRenderPriority bumps topology).
        cached = getattr(self, "_prio_cache", None)
        if cached is not None and cached[0] == (self.context._topology_version, n):
            return cached[1]
        out = np.zeros(n, np.float32)
        from .entity import CK3dEntity
        for obj in self.context._objects.values():
            if isinstance(obj, CK3dEntity) and obj.row < n:
                out[obj.row] = float(obj.render_priority)
        self._prio_cache = ((self.context._topology_version, n), out)
        return out

    def _effective_fog_mode(self) -> int:
        """ForceLinearFog option maps exp/exp2 fog to linear
        (reference ApplyRenderOptionChange)."""
        rm = self.context.render_manager
        if rm is not None and int(rm.options.get("ForceLinearFog", 0)):
            if self.fog_mode in (int(VXFOG.EXP), int(VXFOG.EXP2)):
                return int(VXFOG.LINEAR)
        return self.fog_mode

    def _effective_fog_proj(self) -> int:
        """Fog projection mode 0/1/2 (reference g_FogProjectionMode,
        src/CKMaterial.cpp:49 + CKRenderedScene.cpp:416-425): 0 = view-z
        distances, 1 = projected-depth fog with projected start/end, 2 =
        projected-depth fog against (1/startW, projected start)."""
        rm = self.context.render_manager
        return int(rm.options.get("FogProjectionMode", 0)) if rm else 0

    def _camera_np(self):
        cam = self.attached_camera
        vp = self._effective_viewport()
        if cam is not None:
            prep = getattr(cam, "prepare", None)
            if prep is not None:
                prep()
            # Static-camera fast path: view/proj depend only on the camera's
            # world matrix + lens params + viewport — key on those bytes.
            wm = cam.GetWorldMatrix()
            key = (id(cam), wm.tobytes(), float(cam.fov),
                   float(cam.front_plane), float(cam.back_plane),
                   getattr(cam, "projection_type", 0),
                   getattr(cam, "orthographic_zoom", 1.0), tuple(vp))
            cached = getattr(self, "_cam_np_cache", None)
            if cached is not None and cached[0] == key:
                return cached[1]
            view = cam.view_matrix()
            aspect = vp[2] / max(vp[3], 1)
            proj = cam.projection_matrix(aspect)
            cam_pos = wm[3, :3]
            view = np.asarray(view, np.float32)
            proj = np.asarray(proj, np.float32)
            self._last_cam = (view, proj, vp)
            self._cam_np_cache = (key, (view, proj, cam_pos))
            return view, proj, cam_pos
        else:
            view = np.eye(4, dtype=np.float32)
            proj = np.eye(4, dtype=np.float32)
            cam_pos = np.zeros(3, np.float32)
        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        # Cached for lazy render-extents queries (GetObjectExtents).
        self._last_cam = (view, proj, vp)
        return view, proj, cam_pos

    def _fill_packed(self, quads_bg_list, quads_fg_list,
                     defer_anim: bool = False):
        """Build this frame's packed buffers; returns
        (static, dyn_f, dyn_i, params) with params = the static-ish kwargs
        of render_frame_packed. ``defer_anim``: a bound clip is not
        evaluated here; ``self._anim_req`` then holds (locals (N,4,4), clip
        time) for the frame's own animate stage (else None)."""
        from ..pipeline.overlay import quad_windows
        from ..pipeline.packing import fill

        ctx = self.context
        table = ctx.entity_table
        c = self._compiled
        self._refresh_pool(c)
        n = max(table.count, 1)
        si, sf, md, ma, ms, me, mp = self._material_banks(c)
        lt = self._light_rows_np()
        sp = len(c.sprite3d_list)

        def pad4(k):
            return 0 if k == 0 else max(4, ((k + 3) // 4) * 4)

        qb = pad4(len(quads_bg_list))
        qf = pad4(len(quads_fg_list))
        planes = self._active_clip_planes()
        vt, vt_idx, vt_plan = self._video_patch_info(c)
        self._video_patch = (vt, vt_idx, vt_plan)
        view, proj, cam_pos = self._camera_np()
        # Host chunk culling: pick surviving stream chunks for this frame's
        # frustum; the cap (static) bumps BEFORE dispatch when more chunks
        # survive than last compiled for — no frame ever drops geometry.
        cull_idx = self._chunk_select(c, view, proj)
        cull_static = None
        ck = 0
        if cull_idx is not None:
            cm = c.chunk_meta
            needed = int(cull_idx.shape[0])
            cap = self._chunk_cap
            if cap is None or needed > cap:
                cap = min(cm["n_full"],
                          max(8, -(-int(needed * 1.25) // 8) * 8))
                self._chunk_cap = cap
            ck = cap
            cull_static = (cm["ch"], cap, cm["itc"], cm["n_full"])
        self._ensure_packed_layout(n, si.shape[0], lt["type"].shape[0], sp,
                                   qb, qf, planes.shape[0], vt, 0, ck)
        static = self._packed_static_dict(c, n)

        visible = (table.flags[:n] & et.VX_MOVEABLE_VISIBLE) != 0
        # Debug object stepping (reference EnableDebugMode Ctrl+Alt+F11
        # walks the scene object-by-object, src/CKRenderContext.cpp:657-762):
        # SetDebugObjectCount(k) renders only the first k entities in
        # render order; DebugStep() advances. Programmatic here — the
        # interactive hotkey loop is the host app's job.
        dbg = self._debug_object_count
        if dbg >= 0:
            order = np.argsort(-self._entity_priority_np(n), kind="stable")
            cut = order[dbg:]
            visible = visible.copy()
            visible[cut] = False
        vals = dict(
            local=table.local[:n],
            entity_visible=visible,
            entity_clip=self._entity_clip_np(n),
            entity_priority=self._entity_priority_np(n),
            state_f=sf, state_i=si, mat_diffuse=md, mat_ambient=ma,
            mat_specular=ms, mat_emissive=me, mat_power=mp,
            lt_type=lt["type"], lt_active=lt["active"],
            lt_diffuse=lt["diffuse"], lt_specular=lt["specular"],
            lt_ambient=lt["ambient"], lt_position=lt["position"],
            lt_direction=lt["direction"], lt_attenuation=lt["attenuation"],
            lt_range=lt["range"], lt_falloff=lt["falloff"],
            lt_cos_theta=lt["cos_theta"], lt_cos_phi=lt["cos_phi"],
            global_ambient=self.ambient_light, view=view, proj=proj,
            cam_pos=cam_pos, viewport=np.asarray(self._effective_viewport(), np.float32),
            fog_mode=self._effective_fog_mode(),
            fog_proj=self._effective_fog_proj(), fog_start=self.fog_start,
            fog_end=self.fog_end, fog_density=self.fog_density,
            fog_color=self.fog_color, clear_color=self.background_color,
            clear_z=self.clear_z,
        )
        if planes.shape[0]:
            vals["clip_planes"] = planes
        if vt:
            parts = []
            meta = c._tex_meta
            for ti, levels in vt_plan:
                t = c.textures[ti]
                img = np.asarray(t.current_image(), np.float32)
                parts.append(img.reshape(-1, 4))
                for _lv, _nh, _nw, _yo, cur in _mip_chain(img, t, levels):
                    parts.append(np.asarray(cur, np.float32).reshape(-1, 4))
                meta["versions"][ti] = getattr(t, "data_version", 0)
            vals["tex_patch"] = np.concatenate(parts)
        if sp:
            vals["sp_size"] = np.asarray(
                [e.size2d for e, _, _ in c.sprite3d_list], np.float32)
            vals["sp_offset"] = np.asarray(
                [e.offset for e, _, _ in c.sprite3d_list], np.float32)
            vals["sp_mode"] = np.asarray(
                [e.mode for e, _, _ in c.sprite3d_list], np.int32)
        for prefix, cap, quads in (("qbg", qb, quads_bg_list),
                                   ("qfg", qf, quads_fg_list)):
            if not cap:
                continue
            rect = np.zeros((cap, 4), np.float32)
            uvrect = np.tile(np.array([0, 0, 1, 1], np.float32), (cap, 1))
            color = np.ones((cap, 4), np.float32)
            tex = np.full(cap, -1, np.int32)
            blend = np.zeros(cap, np.int32)
            valid = np.zeros(cap, np.int32)
            for i, dq in enumerate(quads):
                rect[i] = dq["rect"]
                uvrect[i] = dq.get("uvrect", (0, 0, 1, 1))
                color[i] = dq.get("color", (1, 1, 1, 1))
                tex[i] = dq.get("tex", -1)
                blend[i] = int(dq.get("blend", 1))
                valid[i] = 1
            vals[f"{prefix}_rect"] = rect
            vals[f"{prefix}_uvrect"] = uvrect
            vals[f"{prefix}_color"] = color
            vals[f"{prefix}_tex"] = tex
            vals[f"{prefix}_blend"] = blend
            vals[f"{prefix}_valid"] = valid
        if ck:
            idx_pad = np.full(ck, c.chunk_meta["n_full"], np.int32)
            idx_pad[:cull_idx.shape[0]] = cull_idx
            vals["chunk_idx"] = idx_pad
            vals["chunk_n"] = np.int32(cull_idx.shape[0])

        fill(self._buf_f, self._buf_i, self._layout, vals)
        rm = ctx.render_manager
        sort_t = bool(int(rm.options.get("SortTransparentObjects", 1))) \
            if rm is not None else True
        # Render-to-texture feeds: each registered texture's current device
        # image and its stack rect, written into the frame's copy of the
        # stack (pipeline/frame._apply_tex_patch).
        texdev, texdev_rects = [], []
        meta_d = getattr(c, "_tex_meta", None)
        for i in sorted(getattr(c, "dev_ids", set())):
            dimg = c.textures[i].device_image()
            if dimg is None or meta_d is None:
                continue
            texdev.append(dimg)
            texdev_rects.append(tuple(meta_d["rects"][i])
                                + (c.textures[i].device_image_chw(),))
        # Bound clip: the animate and compose stages run here, before the
        # frame (pipeline/frame.py eval_anim_world), and the frame takes
        # the (N,4,4) result as ``world_in``. The bank stays on the device
        # between frames; the clip time is a kernel argument.
        world_in = None
        self._anim_req = None
        clip = self._bound_clip
        if clip is not None:
            anim = (table.local[:n].copy(), clip.frame)
            if defer_anim:
                self._anim_req = anim
            else:
                world_in = self._anim_world(static, dict(levels=c.levels),
                                            anim)
        # Static sampler profile (any_nearest, any_mip) from this frame's
        # state bank: lets the shade skip the nearest-filter fetch and the
        # second mip level when no material needs them — the reference's
        # render-state-cache idea applied at the jit-signature level
        # (SURVEY §7); a material switching filter modes recompiles, like
        # swapping a D3D state block.
        from ..raster.types import SI_TEX, SI_TEXFILTER
        from ..raster.types import VXTEXTURE_FILTER as _TF
        _texd = si[:, SI_TEX] >= 0
        _filt = si[:, SI_TEXFILTER]
        _lin = ((_filt == _TF.LINEAR) | (_filt == _TF.LINEARMIPNEAREST)
                | (_filt == _TF.LINEARMIPLINEAR)
                | (_filt == _TF.ANISOTROPIC))
        _mip = ((_filt == _TF.MIPNEAREST) | (_filt == _TF.MIPLINEAR)
                | (_filt == _TF.LINEARMIPNEAREST)
                | (_filt == _TF.LINEARMIPLINEAR)
                | (_filt == _TF.ANISOTROPIC))
        quad_ok = (getattr(c, "_quad_ok", False)
                   and getattr(self, "_tex_quad", None) is not None
                   and not getattr(c, "video_ids", None)
                   and not getattr(c, "dev_ids", None))
        from ..raster.types import (
            SI_ALPHABLEND, SI_ALPHATEST, SI_BLENDOP, SI_DSTBLEND,
            SI_PERSPECTIVE, SI_SRCBLEND, SI_STENCIL, SI_ZFUNC, SI_ZWRITE,
            VXBLEND, VXBLENDOP, VXCMP,
        )
        # 4th element: every state interpolates perspective-correct — the
        # quantized shade row then drops its (ws3, ivd) words entirely.
        # 5th: any state binds a texture at all — false compiles the whole
        # per-pixel sampling stage away (deferred.shade_rows).
        # 6th: every potentially-ORDERED state (not deferred-eligible, not
        # stencil-only) is inside the affine ordered-blend kernel's
        # exactness envelope — untextured, zwrite-off, and alpha-over
        # (SRCALPHA, INVSRCALPHA, ADD) or blend-off replace
        # (raster/pallas_ordered.py); the frame then blends transparency
        # at full rate instead of the sequential XLA composite.
        _deferred_ok = ((si[:, SI_ALPHABLEND] == 0)
                        & (si[:, SI_ALPHATEST] == 0)
                        & (si[:, SI_ZWRITE] != 0)
                        & ((si[:, SI_ZFUNC] == int(VXCMP.LESSEQUAL))
                           | (si[:, SI_ZFUNC] == int(VXCMP.LESS))))
        _ordered = ~_deferred_ok & (si[:, SI_STENCIL] == 0)
        _blend_over = ((si[:, SI_SRCBLEND] == int(VXBLEND.SRCALPHA))
                       & (si[:, SI_DSTBLEND] == int(VXBLEND.INVSRCALPHA))
                       & (si[:, SI_BLENDOP] == int(VXBLENDOP.ADD)))
        _okernel = ((si[:, SI_ZWRITE] == 0) & ~_texd
                    & ((si[:, SI_ALPHABLEND] == 0) | _blend_over))
        ordered_kernel_ok = bool(np.all(~_ordered | _okernel))
        # 7th: the TEXTURED ordered envelope — same as the affine kernel's
        # minus the untextured requirement: the layer-peel path
        # (pallas_ordered.ordered_peel_tiled_pallas) handles textured
        # alpha-over/replace/alpha-test draws at K bounded per-pixel layers
        # with exact fallback on overflow.
        _opeel = ((si[:, SI_ZWRITE] == 0)
                  & ((si[:, SI_ALPHABLEND] == 0) | _blend_over))
        _rm0 = self.context.render_manager
        _peel_opt = int(_rm0.options.get("TexturedPeel", 0) or 0) if _rm0 \
            else 0
        ordered_peel_ok = bool(_peel_opt) and bool(np.all(~_ordered | _opeel))
        # 8th: any stream vertex uses PRELIT colors (unlit materials) —
        # false compiles the two per-row prelit pool gathers away
        # (transform_and_light want_prelit).
        sampler_profile = (bool(np.any(_texd & ~_lin)),
                           bool(np.any(_texd & _mip)), quad_ok,
                           bool(np.all(si[:, SI_PERSPECTIVE] != 0)),
                           bool(np.any(_texd)), ordered_kernel_ok,
                           ordered_peel_ok,
                           bool(getattr(c, "any_prelit", True)))
        # Antialias option -> ordered 2x2 supersample + box resolve (the
        # reference's multisample device setup, src/CKRenderManager.cpp:
        # 117,668 -> CKDX9RasterizerContext.cpp:469-491). Nonzero option = 4
        # ordered samples per pixel: the frame renders at twice the size and
        # resolves fb, zb and sb to this one (frame.box_resolve). Read every
        # frame, so a change takes effect at the next Render().
        _rm = self.context.render_manager
        _aa = int(_rm.options.get("Antialias", 0) or 0) if _rm else 0
        ss = 2 if _aa else 1
        params = dict(
            ss=ss,
            sampler_profile=sampler_profile,
            texdev=tuple(texdev) if texdev else None,
            texdev_rects=tuple(texdev_rects),
            layout=self._layout, levels=self._compiled.levels,
            height=self.height, width=self.width, skin=c.skin_bank,
            skin_ranges=getattr(c, "skin_ranges", ()),
            anim=None, world_in=world_in,
            sprites_static=self._sprites_static, lines=c.line_bank,
            ordered_cap=c.ordered_cap, sort_transparent=sort_t,
            want_stencil=c.has_stencil, vertex_shader=self.vertex_shader,
            pixel_shader=self.pixel_shader,
            want_bump=getattr(c, "want_bump", False),
            want_cube=getattr(c, "want_cube", False),
            corner=(c.corner_nc, c.corner_itc, c.corner_p0),
            want_texgen=getattr(c, "want_texgen", True),
            solve_caps=self._solve_caps,
            cull=cull_static,
            quad_windows=tuple(
                quad_windows(quads, self.height * ss, self.width * ss, ss)
                for quads in (quads_bg_list, quads_fg_list)))
        # Fresh copies: the staging buffers are reused next frame, while a
        # caller may still hold this frame's.
        return static, self._buf_f.copy(), self._buf_i.copy(), params

    def _debug_mode(self) -> bool:
        rm = self.context.render_manager
        return (bool(int(rm.options.get("EnableDebugMode", 0)))
                if rm is not None else False)

    def _anim_world(self, static, params, anim, bank=None):
        """A bound clip's animate and compose stages at (locals, time):
        ``bank`` (default the bound clip's) over the locals."""
        local, t = anim
        dev = self.context.device
        if bank is None:
            bank = self._bound_clip.bank(n_entities=local.shape[0],
                                         device=dev)
        return fr.eval_anim_world(torch.tensor(local, device=dev),
                                  static["parent"], bank, t,
                                  params["levels"])

    def _accumulates(self) -> bool:
        """The frame's clear flags leave a buffer uncleared: it renders
        over the previous frame."""
        return not (self._frame_flags & CK_RENDER_CLEARBACKBUFFER) \
            or not (self._frame_flags & CK_RENDER_CLEARZBUFFER)

    def _render_packed(self, quads_bg_list, quads_fg_list):
        """One frame through the two-buffer packed path: fill the buffers on
        the host, upload both, and run the frame on the context's device;
        a banded context (:meth:`SetTileSharding`) renders its bands on its
        mesh (reference :2155-2171), unless the frame has a stencil plane
        or accumulates, which render unbanded, as in the reference."""
        static, dyn_f, dyn_i, params = self._fill_packed(quads_bg_list,
                                                         quads_fg_list)
        if (self._tile_mesh is not None and not params["want_stencil"]
                and not self._accumulates()):
            return self._render_banded(static, dyn_f, dyn_i, params)
        # CLEARBACK/CLEARZ off -> accumulate over last frame's buffers
        # (reference Clear flag handling, src/CKRenderContext.cpp:438-544).
        prev_fb = (None if (self._frame_flags & CK_RENDER_CLEARBACKBUFFER)
                   else self.fb)
        prev_zb = (None if (self._frame_flags & CK_RENDER_CLEARZBUFFER)
                   else self.zb)
        fb, zb, sb, _host = self._render_eager(static, dyn_f, dyn_i, params,
                                               prev_fb=prev_fb,
                                               prev_zb=prev_zb)
        if sb is not None:
            self.sb = sb
        return fb, zb

    def _render_banded(self, static, dyn_f, dyn_i, params):
        """One frame in horizontal bands over the band mesh
        (``parallel.tile_shard``), assembled on the context's device. Like
        the reference's banded frame it reports no solve statistics, so the
        capacity governor takes no sample."""
        from ..parallel.tile_shard import render_frame_packed_banded

        p = {k: v for k, v in params.items() if k != "want_stencil"}
        return render_frame_packed_banded(
            static, dyn_f, dyn_i, mesh=self._tile_mesh,
            out_device=self.context.device, copies=self._band_copies, **p)

    def _batch_window(self, device, key, static, params, bank, rounds: int,
                      size: int):
        """The stacked window (``window.FrameWindow``) this context leads
        for a batch block on ``device`` (None: its own device) under
        ``key``: kept per device, made anew when the key changes; a window
        on another device holds copies of the static tensors and banks
        there."""
        from ..parallel.mesh import to_device

        home = self.context.device
        dev = home if device is None else torch.device(device)
        batch = self._batch if dev == home else self._mesh_batches.get(dev)
        if batch is not None and batch.key == key:
            return batch
        if batch is not None:
            batch.release()
        if dev != home:
            static, params, bank = (to_device(x, dev)
                                    for x in (static, params, bank))
        batch = fw.FrameWindow(key, static, params, bank, rounds, size, dev,
                               stacked=True)
        if dev == home:
            self._batch = batch
        else:
            self._mesh_batches[dev] = batch
        return batch

    def _render_eager(self, static, dyn_f, dyn_i, params, anim=None,
                      prev_fb=None, prev_zb=None, govern: bool = True,
                      bank=None):
        """Run one frame eagerly (the host reads its decisions, so it is
        exact) from its packed buffers; ``anim``: a deferred bound clip's
        (locals, time), evaluated with ``bank`` (default the bound clip's).
        Updates the stats and, with ``govern``, hands the solve's bin
        statistics to the capacity governor. Returns (fb, zb, sb or None,
        host stats)."""
        dev = self.context.device
        if anim is not None:
            params = dict(params, world_in=self._anim_world(static, params,
                                                            anim, bank))
        dyn_f = torch.as_tensor(dyn_f, device=dev)
        dyn_i = torch.as_tensor(dyn_i, device=dev)
        debug_stats = self._debug_mode()
        # The ordered pass's counters and the solve's bin statistics are
        # host values the frame holds anyway, so every frame reports them.
        host = {}
        out = fr.render_frame_packed(
            static, dyn_f, dyn_i, **params, want_stats=debug_stats,
            prev_fb=prev_fb, prev_zb=prev_zb, host_stats=host)
        s = self.stats
        s.OrderedPeelOverflow = host["OrderedPeelOverflow"]
        s.OrderedPeelRounds = host["OrderedPeelRounds"]
        s.OrderedPeelCorrected += host["OrderedPeelCorrected"]
        s.OrderedReplays += host["OrderedReplays"]
        bins = host.get("SolveBinStats")
        if bins is not None:
            s.SolveLivePairs = bins[1]
            s.SolveFallbackRows = bins[2] + bins[3] + bins[4]
            if govern and self._gov_on:
                self._governor_tick({"SolveBinStats": np.asarray(bins)})
                self._governor_resolve()
        if debug_stats:
            out, dev_stats = out[:-1], out[-1]
            s.TileBinPeak = int(dev_stats["TileBinPeak"])
        sb = out[2] if params["want_stencil"] else None
        return out[0], out[1], sb, host

    # -- capacity governor (reference rendercontext.py:2471-2617) ---------
    def _default_solve_caps(self) -> tuple:
        """Mirror of frame.py's t_count cap heuristic (pair, slab, g)."""
        t = int(self._compiled.tri_idx.shape[0]) if \
            self._compiled.tri_idx is not None else 0
        return (98304 if t <= 600_000 else 262144,
                131072 if t <= (1 << 21) else 262144,
                8192)

    def _governor_tick(self, dev_stats):
        """Take one sample of the tiled solve's bin statistics (the 7-word
        ``SolveBinStats``, or a (W, 7) window of them). The first sample
        after a compile plans the caps at once; later ones are stashed and
        applied by :meth:`_governor_resolve`. The port samples every frame
        and every window at reads the host makes anyway (the eager frame's
        remainder decision, a window's one read), so it has no sampling
        cadence."""
        bs = dev_stats.get("SolveBinStats")
        if bs is None:
            return
        self._gov_frames += 1
        if self._gov_frames == 1 and self._solve_caps is None:
            self._gov_apply(np.asarray(bs))
            return
        self._gov_stash = bs

    def _governor_resolve(self):
        """Apply the newest stashed bin-stats sample."""
        bs = self._gov_stash
        if bs is None:
            return
        self._gov_stash = None
        self._gov_apply(np.asarray(bs))

    def _gov_apply(self, b):
        """The reference's governor arithmetic: the first plan at 2.5x the
        live pairs and small rows and 4x the mid rows (never above the
        static defaults), a bump of a cap whose fallback ran or whose load
        passed 95%, and once per compile a shrink to 1.25x the peak of the
        last 6 samples (disabled for the compile by a later bump)."""
        first = self._solve_caps is None
        if b.ndim == 2:                       # window-stacked: worst frame
            b = b.max(axis=0)
        _peak, live, cut, g_over, s_over, n_small, n_mid = (
            int(x) for x in b)
        s = self.stats
        s.SolveLivePairs = live
        s.SolveFallbackRows = cut + g_over + s_over
        pair0, slab0, g0 = self._default_solve_caps()
        pair, slab, gcap = self._solve_caps or (pair0, slab0, g0)

        def up16k(v):
            return int(-(-int(v) // 16384) * 16384)

        if first:
            pair = min(pair0, up16k(max(49152, live * 2.5)))
            slab = min(slab0, up16k(max(32768, n_small * 2.5)))
            gp = 1024
            while gp < max(n_mid * 4, 512):
                gp *= 2
            gcap = min(g0, max(gp, 1024))
            self._solve_caps = (pair, slab, gcap)
            self._gov_hist = []
            self._gov_shrunk = False
            return
        changed = False
        if cut > 0 or live > 0.95 * pair:
            pair = up16k(max(pair * 1.5, live * 1.75))
            changed = True
        if s_over > 0 or n_small > 0.95 * slab:
            slab = up16k(max(slab * 1.5, n_small * 1.75))
            changed = True
        if g_over > 0 or n_mid > 0.95 * gcap:
            gcap = max(2 * gcap, 1024)
            changed = True
        if changed:
            self._solve_caps = (pair, slab, gcap)
            s.SolveCapBumps += 1
            self._gov_hist = []
            if self._gov_shrunk:
                self._gov_shrunk = None      # disabled for this compile
            return
        if self._gov_shrunk is None or self._gov_shrunk:
            return
        hist = self._gov_hist
        hist.append((live, n_small, n_mid))
        if len(hist) < 6:
            return
        pl = max(h[0] for h in hist)
        ps = max(h[1] for h in hist)
        pm = max(h[2] for h in hist)
        tp = min(pair, up16k(max(49152, pl * 1.25)))
        ts = min(slab, up16k(max(32768, ps * 1.25)))
        gp = 1024
        while gp < max(pm * 1.5, 512):
            gp *= 2
        tg = min(gcap, max(gp, 1024))
        if tp <= pair - 16384 or ts <= slab - 16384 or tg <= gcap // 2:
            self._solve_caps = (tp, ts, tg)
            s.SolveCapShrinks += 1
            self._gov_shrunk = True
        self._gov_hist = []

    # -- window staging (reference rendercontext.py:2618-2768) ------------
    def _eager_only(self) -> bool:
        """Whether this frame renders eagerly, outside any window or batch:
        it accumulates, reads a device texture, renders to a texture, runs
        in debug mode or renders in bands (reference :2624)."""
        return bool(self._accumulates()
                    or getattr(self._compiled, "dev_ids", None)
                    or self.target_texture is not None
                    or self._debug_mode() or self._tile_mesh is not None)

    def _staged_frame(self, quads_bg_list, quads_fg_list):
        """This frame's packed buffers for a captured frame (a window or a
        context batch): (key, static, params, bank, route, slot). ``key``
        holds what the graph bakes in, the per-compile tensors by identity;
        ``bank`` is the bound clip's AnimBank (or None); ``route`` the
        ordered pass's (``frame.ordered_route``); ``slot`` = (dyn_f, dyn_i,
        a bound clip's (locals, time) or None)."""
        c = self._compiled
        static, dyn_f, dyn_i, params = self._fill_packed(
            quads_bg_list, quads_fg_list, defer_anim=True)
        anim = self._anim_req
        ss = params["ss"]
        route = fr.ordered_route(
            c.tri_idx.shape[0] if params["ordered_cap"] is None
            else params["ordered_cap"], self.height * ss, self.width * ss,
            params["sampler_profile"], params["pixel_shader"])
        bank = (None if anim is None else self._bound_clip.bank(
            n_entities=anim[0].shape[0], device=self.context.device))
        key = (fw.freeze({k: v for k, v in params.items()
                          if k not in ("world_in", "solve_caps")}),
               fw.freeze((c, static, bank, self._frame_flags,
                          os.environ.get("CK_FUSED_FETCH", ""), route)))
        return key, static, params, bank, route, (dyn_f, dyn_i, anim)

    @staticmethod
    def _capturable(params: dict, route: str) -> bool:
        """Whether a staged frame can be captured: the exact tiled ordered
        pass and a device-texture feed read the host inside the frame."""
        return not params.get("texdev") and route != "tiled"

    def _render_windowed(self, quads_bg_list, quads_fg_list):
        """Stage this frame into the window; a full window runs."""
        if self._eager_only():
            self._sync_window()
            self.fb, self.zb = self._render_packed(quads_bg_list,
                                                   quads_fg_list)
            return
        key, static, params, bank, route, slot = self._staged_frame(
            quads_bg_list, quads_fg_list)
        if not self._capturable(params, route):
            self._sync_window()
            fb, zb, sb, _host = self._render_eager(static, *slot[:2],
                                                   params, anim=slot[2])
            self.fb, self.zb = fb, zb
            if sb is not None:
                self.sb = sb
            return
        if self._win_slots and self._win_ctx[0] != key:
            # A mid-window change of anything the graph bakes in (layout,
            # chunk cap, texture stack, sampler profile, quad windows, ...):
            # the staged frames run as they are; this frame starts a new
            # window.
            self._flush_window()
        if not self._win_slots:
            self._win_ctx = (key, static, params, bank, route)
        self._win_slots.append(slot)
        if len(self._win_slots) >= self._win_size:
            self._flush_window()

    def _flush_window(self):
        """Run the staged frames as one window. The previous window is
        resolved first, so the governed caps and the peel's round count are
        this window's; fb / zb / sb become the last frame's."""
        slots = self._win_slots
        if not slots:
            return
        self._win_slots = []
        self._resolve_window()
        key, static, params, bank, route = self._win_ctx
        self._win_ctx = None
        params = dict(params, solve_caps=self._solve_caps)
        rounds = (self._peel_rounds_for(static, params, slots[0], bank)
                  if route == "peel" else 0)
        key = key + (fw.freeze(params["solve_caps"]), rounds, self._win_size)
        win = self._window
        if win is None or win.key != key:
            if win is not None:
                win.release()
            win = self._window = fw.FrameWindow(
                key, static, params, bank, rounds, self._win_size,
                self.context.device)
        p = win.run(slots)
        self._fb_val, self._zb_val = p.fb, p.zb
        if p.sb is not None:
            self._sb_val = p.sb
        self._win_fence = p.fence
        self._win_pending = p

    def _resolve_window(self):
        """The window's one host read: render each flagged frame again
        through the eager path (the exact remainder, replay and peel), put
        its checksum into the fence (and its buffers in place, for the last
        frame), and give the window's worst bin statistics to the
        governor."""
        p = self._win_pending
        if p is None:
            return
        self._win_pending = None
        rows = p.read()
        n = len(p.slots)
        win = p.window
        s = self.stats
        if win.rounds:
            s.OrderedPeelRounds = win.rounds
            s.OrderedPeelOverflow = bool(
                rows[:, fw.flag_word("PeelBad")].any())
        for i in np.nonzero(fw.flagged(rows))[0]:
            dyn_f, dyn_i, anim = p.slots[i]
            fb, zb, sb, host = self._render_eager(
                win.static, dyn_f, dyn_i, win.params, anim=anim,
                govern=False, bank=win.bank)
            p.replace(int(i), fb)
            if win.rounds:
                self._peel_rounds = max(self._peel_rounds or 1,
                                        host["OrderedPeelRounds"])
            if i == n - 1:
                self._fb_val, self._zb_val = fb, zb
                if sb is not None:
                    self._sb_val = sb
        if win.tiled:
            bins = rows[:, fw.ROW_BINS]
            worst = bins.max(axis=0)
            s.SolveLivePairs = int(worst[1])
            s.SolveFallbackRows = int(worst[2] + worst[3] + worst[4])
            if self._gov_on:
                self._governor_tick({"SolveBinStats": bins})
                self._governor_resolve()

    def _sync_window(self):
        """Resolve the pending batch, run the staged frames and resolve the
        pending window."""
        if self._batch_read is not None:
            self._batch_read.resolve()
        self._flush_window()
        self._resolve_window()

    def _peel_rounds_for(self, static, params, slot, bank) -> int:
        """The peel's fixed round count of a captured frame: this
        context's eager frame of ``slot`` fixes it the first time."""
        if self._peel_rounds is None:
            host = self._render_eager(static, *slot[:2], params,
                                      anim=slot[2], govern=False,
                                      bank=bank)[3]
            self._peel_rounds = max(1, host["OrderedPeelRounds"])
        return self._peel_rounds

    def _atest_prefail_mask(self, mat, mesh, grp):
        """Compile-time conservative alpha-test pre-gate (round 5).

        Alpha-tested fragments consume peel layer slots BEFORE their test
        runs (the test needs the sampled texel — raster/pallas_ordered.py),
        so alpha-test-heavy content peels extra rounds. A triangle whose
        conservative alpha UPPER BOUND provably fails the test contributes
        nothing to any pass — drop it from the stream at compile. The bound
        is max(texels in the face's UV bbox, via the texture's MAX-mip
        pyramid, +-1 texel for bilinear taps) x max vertex alpha.

        Returns a bool (F,) drop mask over grp.local_faces, or None when
        the gate does not apply (no alpha test, non-GREATER funcs, TexGen,
        pixel shaders, wrap bboxes crossing tile seams fall back to the
        texture-global max). Reference semantics: D3DRS_ALPHATESTENABLE /
        ALPHAREF / ALPHAFUNC, CKDX9RasterizerContext.cpp render-state
        table (:1042).
        """
        from ..raster.types import VXCMP, VXTEXTURE_ADDRESS

        if mat is None or not mat.AlphaTestEnabled():
            return None
        func = int(mat.GetAlphaFunc())
        if func not in (int(VXCMP.GREATER), int(VXCMP.GREATEREQUAL)):
            return None
        if self.pixel_shader is not None or mat._effect_texgen() != 0:
            return None
        ref = mat.GetAlphaRef() / 255.0

        def fails(ub):
            return (ub <= ref) if func == int(VXCMP.GREATER) else (ub < ref)

        if mesh.IsPreLitMode() and mesh.colors.size:
            va = float(mesh.colors[grp.vertex_map, 3].max())
        else:
            va = float(np.asarray(mat.GetDiffuse())[3])
        nfaces = grp.local_faces.shape[0]
        tex = mat.GetTexture(0)
        if tex is None:
            return np.full(nfaces, fails(va), bool)
        pyr = tex.max_alpha_pyramid()
        if pyr is None or mesh.uvs.shape[0] == 0:
            return None
        th, tw = pyr[0].shape
        uv = mesh.uvs[grp.vertex_map]
        fuv = uv[grp.local_faces]                       # (F,3,2)
        u0, u1 = fuv[..., 0].min(1), fuv[..., 0].max(1)
        v0, v1 = fuv[..., 1].min(1), fuv[..., 1].max(1)
        addr = int(mat.GetTextureAddressMode())
        glob = float(pyr[-1][0, 0])
        if addr == int(VXTEXTURE_ADDRESS.CLAMP):
            u0, u1 = np.clip(u0, 0.0, 1.0), np.clip(u1, 0.0, 1.0)
            v0, v1 = np.clip(v0, 0.0, 1.0), np.clip(v1, 0.0, 1.0)
            local = np.ones(nfaces, bool)
        elif addr == int(VXTEXTURE_ADDRESS.WRAP):
            # same-tile bboxes shift into [0,1); cross-seam faces use the
            # global max (conservative)
            local = (np.floor(u0) == np.floor(u1)) & \
                    (np.floor(v0) == np.floor(v1))
            u1 = u1 - np.floor(u0)
            u0 = u0 - np.floor(u0)
            v1 = v1 - np.floor(v0)
            v0 = v0 - np.floor(v0)
        else:                                           # mirror/border: global
            local = np.zeros(nfaces, bool)
        # Texel bbox covering every tap the sampler can take: bilinear taps
        # at coordinate t span [floor(t*W - 0.5), floor(t*W - 0.5) + 1],
        # nearest taps floor(t*W) — both inside [floor(u0*W - 0.5),
        # floor(u1*W + 0.5)]. Then the pyramid level where the bbox spans
        # <= 2 cells per dim: max of the <= 4 covering cells.
        rx0 = np.floor(u0 * tw - 0.5).astype(np.int64)
        rx1 = np.floor(u1 * tw + 0.5).astype(np.int64)
        ry0 = np.floor(v0 * th - 0.5).astype(np.int64)
        ry1 = np.floor(v1 * th + 0.5).astype(np.int64)
        if addr == int(VXTEXTURE_ADDRESS.WRAP):
            # a wrap bilinear tap at the seam reaches the OPPOSITE edge,
            # which a clipped bbox query would miss: those faces take the
            # global max instead.
            local &= (rx0 >= 0) & (rx1 <= tw - 1) & \
                     (ry0 >= 0) & (ry1 <= th - 1)
        tx0 = np.clip(rx0, 0, tw - 1)
        tx1 = np.clip(rx1, 0, tw - 1)
        ty0 = np.clip(ry0, 0, th - 1)
        ty1 = np.clip(ry1, 0, th - 1)
        # Level where the bbox spans <= 4 cells per dim (one level below
        # the 2-cell level: square pyramid cells lose anisotropic bboxes'
        # narrow-axis resolution otherwise), queried as a masked 4x4 grid.
        span = np.maximum(tx1 - tx0 + 1, ty1 - ty0 + 1)
        lvl = np.clip(np.ceil(np.log2(np.maximum(span, 1))).astype(np.int64)
                      - 1, 0, len(pyr) - 1)
        ub = np.full(nfaces, glob, np.float32)
        off = np.arange(4)
        for li in np.unique(lvl[local]):
            sel = local & (lvl == li)
            p = pyr[li]
            ph, pw = p.shape
            cx0 = tx0[sel] >> li
            cx1 = np.clip(tx1[sel] >> li, 0, pw - 1)
            cy0 = ty0[sel] >> li
            cy1 = np.clip(ty1[sel] >> li, 0, ph - 1)
            cx = np.minimum(cx0[:, None] + off[None, :], cx1[:, None])
            cy = np.minimum(cy0[:, None] + off[None, :], cy1[:, None])
            cx = np.clip(cx, 0, pw - 1)
            cy = np.clip(cy, 0, ph - 1)
            m = p[cy[:, :, None], cx[:, None, :]].max(axis=(1, 2))
            ub[sel] = m
        return fails(ub * va)

    def _refresh_chunk_parts(self, c):
        """(Re)build per-chunk conservative local bboxes — per (chunk,
        entity) part over the corner-major head — lazily and again whenever
        the pool refreshes (morphs / patch re-tessellation move vertices)."""
        cm = c.chunk_meta
        if cm["parts"] is not None and cm["pool_version"] == c._pool_version:
            return
        CH, n_full, itc = cm["ch"], cm["n_full"], cm["itc"]
        head_ent = c.vert_entity[:itc]
        pos_head = c.positions[c.corner_p0:c.corner_p0 + 3 * itc]
        parts = []
        for ci in range(n_full):
            sl = slice(ci * CH, (ci + 1) * CH)
            seg = head_ent[sl]
            for er in np.unique(seg):
                rows = np.nonzero(seg == er)[0] + ci * CH
                pts = np.concatenate([pos_head[k * itc + rows]
                                      for k in range(3)])
                parts.append((ci, int(er), pts.min(0), pts.max(0)))
        if len(parts) > 6 * n_full:
            # Chunks average >6 entities (many-small-entity scenes like the
            # 1000-node hierarchy): per-part host culling would cost more
            # than the compaction saves, and per-chunk bboxes degenerate to
            # entity unions anyway. Disable chunk culling for this scene.
            c.chunk_meta = None
            return
        from .entity import CK3dEntity
        rows_needed = {er for _ci, er, _lo, _hi in parts}
        row_obj = {}
        for obj in self.context._objects.values():
            if isinstance(obj, CK3dEntity) \
                    and getattr(obj, "row", None) in rows_needed:
                row_obj[obj.row] = obj
        cm["parts"] = parts
        cm["row_obj"] = row_obj
        cm["pool_version"] = c._pool_version

    def _chunk_select(self, c, view, proj):
        """HOST frustum culling at stream-chunk granularity (the TPU form
        of the reference's hierarchical-bbox scene-graph culling,
        src/CKSceneGraph.cpp:849-888 +
        CK3dEntity::IsInViewFrustrumHierarchic :3297): returns the
        ascending list of chunk indices whose conservative world bbox
        touches the frustum, or None when chunk culling is off. The device
        then compacts the dense stream to these survivors
        (pipeline/frame.compact_scene_chunks) — culling only removes
        fully-offscreen chunks, so pixels are identical."""
        cm = getattr(c, "chunk_meta", None)
        if cm is None or self._bound_clip is not None or self.stereo_enabled:
            return None
        self._refresh_chunk_parts(c)
        cm = c.chunk_meta                    # parts build may disable it
        if cm is None:
            return None
        m = np.asarray(view, np.float32) @ np.asarray(proj, np.float32)
        cols = m.T                          # row-vector: clip = p @ m
        w = cols[3]
        pl = np.stack([w + cols[0], w - cols[0], w + cols[1], w - cols[1],
                       cols[2], w - cols[2]])          # (6,4) inward planes
        pl = pl / np.maximum(
            np.linalg.norm(pl[:, :3], axis=1, keepdims=True), 1e-12)
        eps = 0.5                           # world-unit conservative slack
        vis = np.zeros(cm["n_full"], bool)
        wm_cache: dict = {}
        for ci, er, lo, hi in cm["parts"]:
            if vis[ci]:
                continue
            obj = cm["row_obj"].get(er)
            if obj is None:                 # unknown source: keep the chunk
                vis[ci] = True
                continue
            wm = wm_cache.get(er)
            if wm is None:
                wm = wm_cache[er] = np.asarray(obj.GetWorldMatrix(),
                                               np.float32)
            corners = np.array(
                [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                 for z in (lo[2], hi[2])], np.float32)
            wpts = corners @ wm[:3, :3] + wm[3, :3]
            h4 = np.concatenate([wpts, np.ones((8, 1), np.float32)], 1)
            d = h4 @ pl.T                                  # (8,6)
            if (d.max(axis=0) < -eps).any():
                continue                    # fully outside one plane
            vis[ci] = True
        return np.nonzero(vis)[0].astype(np.int32)

    def Render(self, flags: int = 0):
        """One frame (RCKRenderContext::Render,
        src/CKRenderContext.cpp:767-930)."""
        from ..profiler import PhaseTimer

        if self._batch_read is not None:
            self._batch_read.resolve()
        self._frame_flags = self.ResolveRenderFlags(int(flags))
        t0 = time.monotonic()
        ph = self.phases
        ph.reset()
        with PhaseTimer(ph, "CallbacksTime"):
            for kind, fct, arg, _t in self.pre_render_callbacks:
                fct(self, arg)
            for obj in list(self.context._cb_objects.values()):
                for kind, fct, arg, _t in obj.callbacks:
                    if kind == "pre":
                        fct(self, obj, arg)
        # Dirty curves regenerate their line meshes before compilation
        # (RCKCurve::Render = update-if-dirty then render); mesh pre-render
        # callbacks (patch meshes hook BuildRenderMesh here).
        from .curve import CKCurve
        for obj in list(self.context._prerender_objects.values()):
            if isinstance(obj, CKCurve):
                if obj.IsDirty():
                    obj.Update()
            else:
                for cb in list(getattr(obj, "pre_render_callbacks", ())):
                    cb(self, obj)
        # The reference's render-state cache hit/miss counters map to the scene
        # compile cache: a miss is a frame that had to recompile the streams.
        if self._compiled.topology_version != self.context._topology_version:
            self._compile()
            self.stats.RenderStateCacheMiss += 1
        else:
            self.stats.RenderStateCacheHit += 1
        with PhaseTimer(ph, "BankBuildTime"):
            quads_bg_list, quads_fg_list = self._quad_lists()
            if not (self._frame_flags & CK_RENDER_BACKGROUNDSPRITES):
                quads_bg_list = []
            if not (self._frame_flags & CK_RENDER_FOREGROUNDSPRITES):
                quads_fg_list = []
        self._refresh_textures()
        with PhaseTimer(ph, "DeviceTime"):
            if self.stereo_enabled:
                self._render_stereo_frame(quads_bg_list, quads_fg_list)
            elif self._win_size > 1:
                self._render_windowed(quads_bg_list, quads_fg_list)
            else:
                self.fb, self.zb = self._render_packed(quads_bg_list,
                                                       quads_fg_list)
        # Render-to-texture (reference SetTargetTexture / CopyContext,
        # src/CKRenderContext.cpp:606-638): the frame's (4, H, W) buffer
        # goes to the texture on the device. A copy, so that no later write
        # of this context's buffers reaches the texture.
        if self.target_texture is not None:
            self.target_texture.SetDeviceImage(self.fb.clone(), chw=True)
        # While stepping in debug mode, the stepped object's name and the
        # last frame's time go into the output (reference :2880-2885), before
        # the callbacks draw.
        rm_opts = (self.context.render_manager.options
                   if self.context.render_manager else {})
        debug = bool(int(rm_opts.get("EnableDebugMode", 0)))
        if debug and self._debug_object_count >= 0:
            self._composite_debug_label()
        with PhaseTimer(ph, "CallbacksTime"):
            for obj in list(self.context._prerender_objects.values()):
                rcb = getattr(obj, "render_callback", None)
                if rcb is not None:
                    rcb[0](self, obj, rcb[1])
                for cb in list(getattr(obj, "post_render_callbacks", ())):
                    cb(self, obj)
            # Post-sprite callbacks fire after the foreground 2D pass, so
            # before the context's post-render callbacks (reference
            # :2897-2900, CKRenderedScene::Draw :331-344).
            for kind, fct, arg, _t in self.post_sprite_callbacks:
                fct(self, arg)
            for kind, fct, arg, _t in self.post_render_callbacks:
                fct(self, arg)
            for obj in list(self.context._cb_objects.values()):
                for kind, fct, arg, _t in obj.callbacks:
                    if kind == "post":
                        fct(self, obj, arg)
        if debug:
            # The frame's output and the compiled streams' invariants
            # (reference :2905-2918).
            if not bool(torch.isfinite(self.fb).all()):
                raise FloatingPointError(
                    "render produced non-finite framebuffer values")
            c = self._compiled
            assert c.src_idx.max(initial=0) < c.positions.shape[0], \
                "stream index out of pool"
            assert c.tri_idx.max(initial=0) < c.src_idx.shape[0], \
                "triangle index out of stream"
        self._count_frame()
        self.stats.FrameTime = (time.monotonic() - t0) * 1000.0
        ph.ObjectsRenderTime = self.stats.FrameTime - ph.CallbacksTime
        self.stats.SceneTraversalTime = ph.SceneBuildTime + ph.BankBuildTime
        self.stats.ObjectsRenderTime = ph.DeviceTime
        self.stats.ObjectsCallbacksTime = ph.CallbacksTime
        self._fps_frames += 1
        now = time.monotonic()
        win = now - self._fps_window_start
        if win >= 1.0:
            fps = self._fps_frames / win
            s = self.stats
            s.SmoothedFps = fps if s.SmoothedFps == 0 else 0.9 * fps + 0.1 * s.SmoothedFps
            self._fps_frames = 0
            self._fps_window_start = now
        return True

    def _count_frame(self):
        """The frame's geometry counters (the compiled scene's)."""
        c = self._compiled
        self.stats.NbTrianglesDrawn = c.n_valid_tris
        self.stats.NbVerticesProcessed = int(c.src_idx.shape[0])
        self.stats.NbObjectDrawn = c.n_entities
        self.stats.NbLinesDrawn = len(c.line_segments)

    # -- stereo (reference rendercontext.py:2825-2861, :2952-3038) --------
    def _render_stereo_frame(self, quads_bg_list, quads_fg_list):
        """The stereo frame: both eyes side by side. Staged window frames
        run first, so that no later read of fb / zb resolves an older
        frame over this one. A frame that does not clear its buffers, or
        that samples a render-to-texture feed, takes the eager fallback
        (:meth:`_render_stereo`, ``StereoEagerFallback``); every other the
        packed path (:meth:`_render_stereo_packed`). A banded context takes
        the fallback too, with unbanded eyes (reference :2837-2850)."""
        self._sync_window()
        if (self._accumulates() or getattr(self._compiled, "dev_ids", None)
                or self._tile_mesh is not None):
            self.stats.StereoEagerFallback = True
            self._render_stereo(quads_bg_list, quads_fg_list)
        else:
            self._render_stereo_packed(quads_bg_list, quads_fg_list)

    def _stereo_eye_views(self, view: np.ndarray) -> list:
        """Per-eye view matrices, left then right: the world translated
        opposite each eye's shift of half the eye separation along the
        camera's right axis (reference :2952-2966)."""
        cam = self.attached_camera
        right = (cam.GetWorldMatrix()[0, :3] if cam is not None
                 else np.array([1, 0, 0], np.float32))
        right = right / max(np.linalg.norm(right), 1e-12)
        half = self.eye_separation * 0.5
        out = []
        for sign in (-1.0, 1.0):
            v = view.copy()
            v[3, :3] = view[3, :3] - (right * (half * sign)) @ view[:3, :3]
            out.append(v)
        return out

    def _render_stereo_packed(self, quads_bg_list, quads_fg_list):
        """Stereo on the packed path (reference :2968-2998): one
        ``_fill_packed``, each eye's view patched into a copy of the f32
        buffer, and each eye one eager frame with no stencil (the reference
        runs the two as one 2-frame scan program)."""
        static, dyn_f, dyn_i, params = self._fill_packed(quads_bg_list,
                                                         quads_fg_list)
        self._render_eyes(static, dyn_f, dyn_i, params)

    def _render_stereo(self, quads_bg_list, quads_fg_list):
        """The eager stereo fallback (reference :3000-3038, which renders
        each eye through ``render_frame_full`` with no previous buffers and
        no supersample): each eye starts from the clear colour and depth
        whatever the frame's clear flags, and renders at 1x whatever the
        Antialias option. Otherwise it renders the frame's own scene, as
        the packed path does: the current render-to-texture feeds and
        video texels, portal and clip scissors, the sampler profile (where
        the reference's legacy scene samples the texture stack of its last
        rebuild and drops the other three; README, port section)."""
        from ..pipeline.overlay import quad_windows

        static, dyn_f, dyn_i, params = self._fill_packed(quads_bg_list,
                                                         quads_fg_list)
        params = dict(params, ss=1, quad_windows=tuple(
            quad_windows(quads, self.height, self.width, 1)
            for quads in (quads_bg_list, quads_fg_list)))
        self._render_eyes(static, dyn_f, dyn_i, params)

    def _render_eyes(self, static, dyn_f, dyn_i, params):
        """Render the left and the right eye of one filled frame, each one
        eager frame of a copy of the f32 buffer with the eye's view patched
        in, with no stencil; fb becomes their ``frame.side_by_side``
        composite and zb the right eye's."""
        entries_f, _ = self._layout
        off = next(o for (n, o, _s, _sh) in entries_f if n == "view")
        params = dict(params, want_stencil=False)
        fbs = []
        for v in self._stereo_eye_views(dyn_f[off:off + 16].reshape(4, 4)):
            df = dyn_f.copy()
            df[off:off + 16] = v.reshape(-1)
            fb, zb, _sb, _host = self._render_eager(static, df, dyn_i,
                                                    params, govern=False)
            fbs.append(fb)
        self.fb = fr.side_by_side(*fbs, self.width)
        self.zb = zb

    def SetTargetTexture(self, texture):
        """Render into ``texture`` (reference SetTargetTexture): after each
        frame the texture holds a copy of the framebuffer on the device
        (``CKTexture.SetDeviceImage(..., chw=True)``); None stops."""
        self.target_texture = texture

    def GetTargetTexture(self):
        return self.target_texture

    def SetRenderTarget(self, texture) -> bool:
        """Alias of :meth:`SetTargetTexture` (reference :3521)."""
        self.SetTargetTexture(texture)
        return True

    def GetFogStart(self) -> float:
        return float(self.fog_start)

    def GetFogEnd(self) -> float:
        return float(self.fog_end)

    def GetFogDensity(self) -> float:
        return float(self.fog_density)

    def GetFogColor(self):
        return np.asarray(self.fog_color, np.float32).copy()

    def SetClearBackground(self, on: bool = True):
        if on:
            self.render_flags |= CK_RENDER_CLEARBACKBUFFER
        else:
            self.render_flags &= ~CK_RENDER_CLEARBACKBUFFER

    def GetClearBackground(self) -> bool:
        return bool(self.render_flags & CK_RENDER_CLEARBACKBUFFER)

    def SetClearZBuffer(self, on: bool = True):
        if on:
            self.render_flags |= CK_RENDER_CLEARZBUFFER
        else:
            self.render_flags &= ~CK_RENDER_CLEARZBUFFER

    def GetClearZBuffer(self) -> bool:
        return bool(self.render_flags & CK_RENDER_CLEARZBUFFER)

    def DetachViewpointFromCamera(self):
        self.attached_camera = None

    def GetViewpoint(self):
        """The entity serving as the viewpoint — the attached camera here
        (the reference's root entity is a camera proxy,
        src/CKRenderedScene.cpp:36-40)."""
        return self.attached_camera

    def Activate(self, active: bool = True):
        """Active contexts render during RenderManager::Process (reference
        Activate); Render() can still be called directly either way."""
        self._active = bool(active)

    def IsActive(self) -> bool:
        return getattr(self, "_active", True)

    MAX_CLIP_PLANES = 6

    def _active_clip_planes(self) -> np.ndarray:
        """(P,4) enabled plane equations, index-ordered."""
        rows = [eq for i, (eq, on) in sorted(self.user_clip_planes.items())
                if on]
        if not rows:
            return np.zeros((0, 4), np.float32)
        return np.stack(rows).astype(np.float32)

    def SetUserClipPlane(self, index: int, plane) -> bool:
        """World-space plane equation (a,b,c,d); geometry on the side where
        a·x+b·y+c·z+d >= 0 is kept. Setting a plane enables it."""
        index = int(index)
        if not (0 <= index < self.MAX_CLIP_PLANES):
            return False
        eq = np.asarray(plane, np.float32).reshape(4)
        prev = self._active_clip_planes().shape[0]
        self.user_clip_planes[index] = (eq, True)
        if self._active_clip_planes().shape[0] != prev:
            self.context._bump_topology()   # P changes shapes/layout
        else:
            self.context._bump_dynamic()
        return True

    def GetUserClipPlane(self, index: int):
        entry = self.user_clip_planes.get(int(index))
        return None if entry is None else entry[0].copy()

    def EnableUserClipPlane(self, index: int, enable: bool = True) -> bool:
        entry = self.user_clip_planes.get(int(index))
        if entry is None:
            return False
        self.user_clip_planes[int(index)] = (entry[0], bool(enable))
        self.context._bump_topology()
        return True

    def SetTileSharding(self, n_bands: int = 0, devices=None) -> bool:
        """Shard this context's framebuffer into ``n_bands`` horizontal
        bands, band b on ``devices[b]`` (reference rendercontext.py:
        3925-3940; ``parallel.tile_shard``): ``n_bands`` <= 1 renders on
        the context's device again (True); fewer devices than bands
        (``devices``, default the context's: every CUDA card, or the one
        CPU) or a height the bands do not divide is refused (False). A list
        may name one device several times (``parallel.mesh``), and a device
        that does not exist raises ``ValueError``. A banded frame renders
        eagerly; one with a stencil plane or that accumulates renders
        unbanded, and a stereo frame takes the eager fallback with
        unbanded eyes, as in the reference."""
        from ..parallel.mesh import DeviceMesh, default_devices

        if n_bands <= 1:
            self._tile_mesh = None
            self._band_copies = {}
            return True
        devs = list(devices) if devices is not None else \
            default_devices(self.context.device)
        if len(devs) < n_bands or self.height % n_bands:
            return False
        self._sync_window()
        self._tile_mesh = DeviceMesh(devs[:n_bands], "band")
        self._band_copies = {}
        return True

    def GetTileSharding(self) -> int:
        return 0 if self._tile_mesh is None else self._tile_mesh.size

    def SetStereoParameters(self, eye_separation: float, focal_length: float):
        """A positive eye separation (world units) turns stereo on: each
        Render() draws the left and the right eye side by side (reference
        :3946-3949). The focal length is kept and not used, as in the
        reference."""
        self.eye_separation = float(eye_separation)
        self.focal_length = float(focal_length)
        self.stereo_enabled = eye_separation > 0

    def GetStereoParameters(self):
        return self.eye_separation, self.focal_length

    def RestoreStereoRenderState(self):
        """Drop the per-eye overrides a stereo pass installed (reference
        :3852-3856: the eye and the immediate-mode view and projection).
        A stereo frame here patches each eye's view into a copy of its
        packed buffer and installs no eye; the DrawPrimitive view and
        projection go back to the camera's."""
        self._dp_view = None
        self._dp_proj = None

    def DumpToFile(self, path: str, what: str = "color") -> bool:
        """Write the framebuffer ('color', RGBA), the depth ('z', L8 of
        z * 255), the stencil mask ('stencil', L8) or all three ('both',
        to ``*_color.png``, ``*_z.png`` and ``*_stencil.png``) to PNG
        (reference :3956-3974, the screen dump of src/CKRenderContext.cpp:
        589-603). The reference writes with Pillow; ``io/png.py`` writes the
        same pixels with zlib."""
        from ..io.png import write_png

        if what in ("color", "both"):
            write_png(path if what == "color"
                      else path.replace(".png", "_color.png"),
                      self.BackToFront())
        if what in ("z", "both"):
            z8 = np.clip(self.zbuffer() * 255.0, 0, 255).astype(np.uint8)
            write_png(path if what == "z" else path.replace(".png", "_z.png"),
                      z8)
        if what in ("stencil", "both") and getattr(self, "sb", None) is not None:
            write_png(path if what == "stencil"
                      else path.replace(".png", "_stencil.png"),
                      (self.stencilbuffer() * 255).astype(np.uint8))
        return True

    def GetPhaseTimes(self) -> dict:
        return self.phases.as_dict()

    def Clear(self, flags: int = 0):
        self.fb = torch.as_tensor(self.background_color, device=self.fb.device)[
            :, None, None].expand(self.fb.shape).clone()
        self.zb = torch.full_like(self.zb, self.clear_z)

    def BackToFront(self) -> np.ndarray:
        """uint8 RGBA snapshot of the framebuffer."""
        fb = np.moveaxis(self.fb.detach().cpu().numpy(), 0, -1)
        return np.clip(fb * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def framebuffer(self) -> np.ndarray:
        return np.moveaxis(self.fb.detach().cpu().numpy(), 0, -1)

    def zbuffer(self) -> np.ndarray:
        return self.zb.detach().cpu().numpy()

    def stencilbuffer(self) -> np.ndarray:
        """Stencil mask from STENCILONLY draws (uint8 0/1)."""
        return self.sb.detach().cpu().numpy()

    def GetStats(self) -> VxStats:
        if self._batch_read is not None:
            self._batch_read.resolve()
        return self.stats

    def GetFps(self) -> float:
        """Smoothed FPS (0.9/0.1 EMA over >=1s windows, reference
        src/CKRenderContext.cpp:898-908)."""
        return self.stats.SmoothedFps

    # -- driver (reference rendercontext.py:3228-3240) ---------------------
    def GetDriverIndex(self) -> int:
        return getattr(self, "_driver_index", 0)

    def ChangeDriver(self, index: int) -> bool:
        """Select an entry of the driver table (``raster.caps
        .enumerate_drivers``); False for an index outside it. The frame
        program runs on the context's device whichever entry is chosen."""
        from ..raster.caps import enumerate_drivers

        if not (0 <= index < len(enumerate_drivers())):
            return False
        self._driver_index = int(index)
        return True

    def GetRasterizerContext(self):
        """The device context IS this object (the HAL boundary is the
        frame program)."""
        return self

    # -- render states and options (reference rendercontext.py:3197-3249,
    # :3456-3460, :3541-3561, :3813-3818) -----------------------------------
    def GetState(self) -> int:
        """Context state word (reference GetState/SetState)."""
        return self._state

    def SetState(self, state: int):
        self._state = int(state)

    def SetTextureStageState(self, stage: int, state: int, value) -> bool:
        """Stored per (stage, state), as the reference stores it; no draw
        of either package reads it."""
        self._texture_stage_states[(int(stage), int(state))] = value
        return True

    def GetTextureStageState(self, stage: int, state: int):
        return self._texture_stage_states.get((int(stage), int(state)))

    # The debug mode's render-state listing (reference FillStateString /
    # AppendState*Line, rendercontext.py:3563-3590).
    def FillStateString(self, material=None) -> str:
        """The render state of ``material`` (else the DrawPrimitive state)
        as one "<name>: <value>" line per state."""
        from ..raster.types import RasterState
        st = material.raster_state() if material is not None \
            else self._dp_state or RasterState()
        lines = []
        self.AppendStateOnOffLine(lines, "AlphaBlend", st.alpha_blend)
        self.AppendStateOnOffLine(lines, "AlphaTest", st.alpha_test)
        self.AppendStateOnOffLine(lines, "ZWrite", st.z_write)
        self.AppendStateOnOffLine(lines, "Fog", st.fog)
        self.AppendStateEnumLine(lines, "SrcBlend", st.src_blend)
        self.AppendStateEnumLine(lines, "DestBlend", st.dst_blend)
        self.AppendStateEnumLine(lines, "ZFunc", st.z_func)
        self.AppendStateEnumLine(lines, "Cull", st.cull)
        self.AppendStateUIntLine(lines, "Texture", max(st.tex, 0))
        return "\n".join(lines)

    @staticmethod
    def AppendStateOnOffLine(lines: list, name: str, value) -> None:
        lines.append(f"{name}: {'On' if value else 'Off'}")

    @staticmethod
    def AppendStateEnumLine(lines: list, name: str, value) -> None:
        lines.append(f"{name}: {int(value)}")

    @staticmethod
    def AppendStateUIntLine(lines: list, name: str, value) -> None:
        lines.append(f"{name}: {int(value) & 0xFFFFFFFF}")

    def SetTextureMatrix(self, m, stage: int = 0) -> bool:
        """Stored per stage; stage 0's transforms the UVs of
        :meth:`DrawPrimitive` ((u, v, 0, 1) @ m, keeping x and y)."""
        self._texture_matrices[int(stage)] = np.asarray(m, np.float32)
        return True

    def GetTextureMatrix(self, stage: int = 0):
        return self._texture_matrices.get(int(stage))

    def SetGlobalRenderMode(self, shading: int = 2, texture: bool = True,
                            wireframe: bool = False):
        """Force shading / texturing / wireframe across every material. A
        change of topology: the next frame lowers the material banks again
        (``_material_banks``, textures off where ``texture`` is False)."""
        self._global_render_mode = (int(shading), bool(texture),
                                    bool(wireframe))
        self.context._bump_topology()

    def GetGlobalRenderMode(self):
        return self._global_render_mode

    def SetTransparentMode(self, trans: bool):
        self._transparent_mode = bool(trans)

    def GetTransparentMode(self) -> bool:
        return self._transparent_mode

    def ChangeCurrentRenderOptions(self, add: int = 0, remove: int = 0):
        """Add and remove render-flag bits in one call."""
        self.render_flags = (self.render_flags | int(add)) & ~int(remove)
        return self.render_flags

    # -- callbacks (reference :3435-3455, :3834) ---------------------------
    def AddPostSpriteRenderCallBack(self, fct, arg=None, temp: bool = False):
        """Fires after the foreground 2D pass, before the post-render
        callbacks."""
        self.post_sprite_callbacks.append(("postsprite", fct, arg, temp))

    def RemovePostSpriteRenderCallBack(self, fct):
        self.post_sprite_callbacks = [
            cb for cb in self.post_sprite_callbacks if cb[1] is not fct]

    def ExecutePreRenderCallbacks(self):
        for _kind, fct, arg, _t in list(self.pre_render_callbacks):
            fct(self, arg)

    def ExecutePostRenderCallbacks(self):
        for _kind, fct, arg, _t in list(self.post_render_callbacks):
            fct(self, arg)

    def ExecutePostSpriteCallbacks(self):
        for _kind, fct, arg, _t in list(self.post_sprite_callbacks):
            fct(self, arg)

    def ClearCallbacks(self):
        self.pre_render_callbacks = []
        self.post_render_callbacks = []
        self.post_sprite_callbacks = []

    # -- drawing over kept buffers (reference :3251-3257, :3711-3742) ------
    def DrawScene(self, flags: int = 0):
        """Draw the scene without clearing: ``Render()`` with both clear
        bits removed, over the kept colour and depth. Such a frame renders
        eagerly, after any staged window (``_eager_only``)."""
        flags = self.ResolveRenderFlags(int(flags))
        flags &= ~(CK_RENDER_CLEARBACKBUFFER | CK_RENDER_CLEARZBUFFER)
        return self.Render(flags | CK_RENDER_PLAYERCONTEXT)

    def ClassifyTransparentOrder(self, ent_a, ent_b) -> int:
        """Plane-classification tie-breaker of two transparent objects whose
        Z extents overlap (reference src/CKSceneGraph.cpp:49-80): when one
        box lies wholly on one side of the other's face plane, the box on
        the camera's side draws last. -1: a first, +1: b first, 0: no
        decision."""
        cam = self.GetAttachedCamera()
        if cam is None:
            return 0
        cam_pos = cam.GetWorldMatrix()[3, :3]
        amin, amax = ent_a.GetBoundingBox()
        bmin, bmax = ent_b.GetBoundingBox()

        def classify(outer_min, outer_max, inner_min, inner_max):
            # +1: the inner box draws after the outer one, -1: before.
            for axis in range(3):
                if inner_min[axis] >= outer_max[axis]:
                    return +1 if cam_pos[axis] >= outer_max[axis] else -1
                if inner_max[axis] <= outer_min[axis]:
                    return +1 if cam_pos[axis] <= outer_min[axis] else -1
            return 0

        r = classify(amin, amax, bmin, bmax)
        if r:
            return -1 if r > 0 else +1
        r = classify(bmin, bmax, amin, amax)
        if r:
            return +1 if r > 0 else -1
        return 0

    # -- buffer access (reference :3262-3271, :3422-3433, :3526-3539,
    # :3846, :4002-4029) ----------------------------------------------------
    def DumpToMemory(self, what: str = "color") -> np.ndarray:
        """The framebuffer ('color', (H, W, 4)), depth ('z') or stencil
        ('stencil') on the host."""
        if what == "z":
            return self.zbuffer()
        if what == "stencil":
            return self.stencilbuffer()
        return self.framebuffer()

    def CopyToMemoryBuffer(self, rect=None) -> np.ndarray:
        """(h, w, 4) f32 host copy of the framebuffer region (None: all of
        it)."""
        fb = self.framebuffer()
        if rect is None:
            return fb.copy()
        x0, y0, x1, y1 = (int(v) for v in rect)
        return fb[y0:y1, x0:x1].copy()

    def CopyFromMemoryBuffer(self, image, rect=None) -> bool:
        """Write a host image (uint8 or f32, RGB or RGBA) into the
        framebuffer at ``rect``'s corner (None: the origin), clipped to the
        frame: one host-to-device copy into a copy of the current fb. The
        read of ``fb`` resolves a pending window or batch first, so a later
        ``DrawScene`` blends over exactly this image."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.ones(img.shape[:-1] + (1,), np.float32)], -1)
        fb = self.fb
        x0, y0 = (0, 0) if rect is None else (int(rect[0]), int(rect[1]))
        h = min(img.shape[0], fb.shape[1] - y0)
        w = min(img.shape[1], fb.shape[2] - x0)
        if h <= 0 or w <= 0:
            return False
        patch = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(img[:h, :w], -1, 0), dtype=np.float32))
        fb = fb.clone()
        fb[:, y0:y0 + h, x0:x0 + w] = patch.to(fb.device)
        self.fb = fb
        return True

    def BackupScreen(self):
        """Keep a copy of the framebuffer, on its device."""
        self._screen_backup = self.fb.clone()

    def RestoreScreenBackup(self) -> bool:
        """Put the :meth:`BackupScreen` copy back (False without one). A
        pending window or batch resolves first, so a frame staged before
        the restore cannot overwrite it."""
        if self._screen_backup is None:
            return False
        if self._pending():
            self._sync_window()
        self.fb = self._screen_backup.clone()
        return True

    def CopyToVideo(self) -> np.ndarray:
        """System-to-video copy: the framebuffer already lives on the
        device, so this is the present view."""
        return self.framebuffer()

    def AddDirtyRect(self, rect=None):
        """Partial-present hint; the present is always the whole frame, so
        the list is bookkeeping."""
        self._dirty_rects.append(
            tuple(rect) if rect is not None
            else (0, 0, self.width, self.height))

    def ResetDirtyRects(self):
        self._dirty_rects = []

    def GetDirtyRects(self) -> list:
        return list(self._dirty_rects)

    # -- queries (reference :3097-3194, :3462, :4095-4125) -----------------
    def GetBoundingBox(self):
        """World box (min (3,), max (3,)) of every 3D entity with a mesh,
        or None."""
        lo, hi = None, None
        for obj in self.context._objects.values():
            if isinstance(obj, CK3dEntity) and \
                    obj.GetCurrentMesh() is not None:
                bb = obj.GetBoundingBox()
                if bb is None:
                    continue
                bmin, bmax = np.asarray(bb[0]), np.asarray(bb[1])
                lo = bmin if lo is None else np.minimum(lo, bmin)
                hi = bmax if hi is None else np.maximum(hi, bmax)
        return None if lo is None else (lo, hi)

    def GetObjectExtents(self, ent) -> tuple | None:
        """Screen (left, top, right, bottom) of ``ent``'s world box under
        the camera of the last frame (``_camera_np``'s), clipped to the
        viewport; None when wholly behind the camera or before a frame."""
        cam = getattr(self, "_last_cam", None)
        if cam is None or ent.GetCurrentMesh() is None:
            return None
        view, proj, (vxp, vyp, vw, vh) = cam
        bmin, bmax = ent.GetBoundingBox()
        corners = np.array([[x, y, z, 1.0] for x in (bmin[0], bmax[0])
                            for y in (bmin[1], bmax[1])
                            for z in (bmin[2], bmax[2])], np.float32)
        clip = corners @ view @ proj
        w = clip[:, 3]
        front = w > 1e-6
        if not front.any():
            return None
        ndc = clip[front, :2] / w[front, None]
        sx = vxp + (ndc[:, 0] + 1.0) * 0.5 * vw
        sy = vyp + (1.0 - ndc[:, 1]) * 0.5 * vh
        # A box across the near plane reaches the viewport's edges.
        if not front.all():
            return (float(vxp), float(vyp), float(vxp + vw), float(vyp + vh))
        left = max(float(sx.min()), float(vxp))
        top = max(float(sy.min()), float(vyp))
        right = min(float(sx.max()), float(vxp + vw))
        bottom = min(float(sy.max()), float(vyp + vh))
        if left >= right or top >= bottom:
            return None
        return (left, top, right, bottom)

    def CheckObjectExtents(self, ent) -> bool:
        """True when ``ent`` has extents at the last frame."""
        return self.GetObjectExtents(ent) is not None

    def TransformVertices(self, points, ref=None):
        """Local (under ``ref``'s world matrix) or world points to the
        screen: (screen (N, 2), clip flags (N,) uint32, all off screen)."""
        from ..math import vxmath as vx

        pts = np.asarray(points, np.float32).reshape(-1, 3)
        world = (np.asarray(ref.GetWorldMatrix(), np.float32)
                 if ref is not None else np.eye(4, dtype=np.float32))
        view, proj, _ = self._camera_np()
        clip = np.concatenate(
            [pts, np.ones((pts.shape[0], 1), np.float32)], -1) \
            @ (world @ view @ proj)
        flags = vx.np_clip_flags(clip)
        vx0, vy0, vw, vh = self._effective_viewport()
        w = np.where(np.abs(clip[:, 3]) < 1e-12, 1e-12, clip[:, 3])
        sx = vx0 + vw * 0.5 + clip[:, 0] / w * (vw * 0.5)
        sy = vy0 + vh * 0.5 - clip[:, 1] / w * (vh * 0.5)
        screen = np.stack([sx, sy], -1).astype(np.float32)
        offscreen = (bool(np.bitwise_and.reduce(flags) != 0)
                     if flags.size else False)
        return screen, flags, offscreen

    def Transform(self, point, ref=None):
        """One point to the screen."""
        return self.TransformVertices([point], ref)[0][0]

    def GetStencilFreeMask(self) -> int:
        """The stencil bits taken so far (reference
        src/CKRenderContext.cpp:2331-2347)."""
        return self._stencil_used_mask

    def UsedStencilBits(self, stencil_bits: int):
        self._stencil_used_mask |= int(stencil_bits)

    def GetFirstFreeStencilBits(self) -> int:
        for i in range(32):
            if not (self._stencil_used_mask >> i) & 1:
                return i
        return -1

    def GetMemoryOccupation(self) -> int:
        """Bytes of this context's device tensors in the reference's roles:
        the compiled scene's vertex pool (positions, normals, uv, prelit)
        and index streams (src_idx, tri_idx) as uploaded, and fb and zb."""
        c = self._compiled
        dev = dict(c._dev_pool or {}, **(c._dev_static or {}))
        total = sum(dev[k].numel() * dev[k].element_size() for k in (
            "positions", "normals", "uv", "prelit", "src_idx", "tri_idx")
            if k in dev)
        for b in (self.fb, self.zb):
            total += b.numel() * b.element_size()
        return int(total)

    def GetPixelFormat(self):
        """(colour bits, depth bits, stencil bits): f32 RGBA planes, an f32
        depth plane and an 8-bit stencil plane."""
        return (32, 32, 8)

    def GetDirectXInfo(self):
        return None

    def GetBackgroundMaterial(self):
        return self.background_material

    def Compute3dRootObjects(self) -> list:
        """Parentless 3D entities of this context."""
        return [o for o in self._scene_entities()
                if isinstance(o, CK3dEntity) and o.GetParent() is None]

    def Compute2dRootObjects(self) -> list:
        """Parentless 2D entities, background roots first, then by z order
        and creation."""
        roots = self._2d_roots()
        roots.sort(key=lambda e: (not e.IsBackground(), e.zorder, e.id))
        return roots

    def IsObjectAttached(self, obj) -> bool:
        """Membership test: every render object belongs to a context that
        was never given an explicit list."""
        if self._objects is None:
            from .entity import CKRenderObject
            return isinstance(obj, CKRenderObject)
        return obj in self._objects

    def SetFullViewport(self):
        """The viewport becomes the whole surface."""
        self.SetViewRect(0, 0, self.width, self.height)

    def WarnEnterThread(self):
        return None

    def WarnExitThread(self):
        return None

    # Windowing: the port draws into device buffers, with no window or
    # full-screen device of an operating system.
    def GoFullScreen(self, *a, **kw) -> bool:
        return False

    def StopFullScreen(self) -> bool:
        return False

    def IsFullScreen(self) -> bool:
        return False

    def GetWindowHandle(self):
        return None

    def GetWindowRect(self, screen_relative: bool = False):
        return (0, 0, self.width, self.height)

    def SetWindowRect(self, rect, flags: int = 0):
        return None

    def ScreenToClient(self, pt):
        return tuple(pt)

    def ClientToScreen(self, pt):
        return tuple(pt)

    # -- lifecycle (reference :3090, :3483-3518, :3820-3833) ----------------
    def ForceCameraSettingsUpdate(self):
        cam = self.attached_camera
        if cam is not None and hasattr(cam, "prepare"):
            cam.prepare()
        self.context._bump_dynamic()

    def DetachAll(self):
        """Detach every object from this context: an explicit, empty
        membership."""
        from .entity import CKRenderObject

        for obj in self.context._objects.values():
            if isinstance(obj, CKRenderObject):
                obj._in_render_context_mask &= ~self.mask
        self._objects = []
        self.context._bump_topology()

    def AddRemoveSequence(self, begin: bool):
        """Bracket a burst of AddObject / RemoveObject calls, so that the
        scene compiles once."""
        if begin:
            self.context.BeginAddRemoveSequence()
        else:
            self.context.EndAddRemoveSequence()

    def PrepareCameras(self, flags: int = 0):
        """Aim the target cameras and lights now and refresh the
        projection (reference src/CKRenderedScene.cpp:484-536)."""
        from .camera import CKTargetCamera
        from .light import CKTargetLight

        for o in list(self.context._objects.values()):
            if isinstance(o, (CKTargetCamera, CKTargetLight)):
                o.prepare()
        self.UpdateProjection(True)

    def UpdateProjection(self, force: bool = False) -> bool:
        """Recompute the camera matrices ``_camera_np`` caches
        (reference src/CKRenderContext.cpp:2783-2808)."""
        self._cam_np_cache = None
        _, proj, _ = self._camera_np()
        return proj is not None

    # -- immediate-mode DrawPrimitive (reference GetDrawPrimitiveStructure,
    # src/CKRenderContext.cpp:967, and DrawPrimitive; reference
    # rendercontext.py:3271-3372). A draw composites onto fb / zb NOW,
    # outside the frame, through ``vertexbuffer.draw_clip``: the host
    # batch uploaded once, ``render_pass`` on the context's device. ------
    def SetWorldTransformationMatrix(self, m):
        self._dp_world = np.asarray(m, np.float32).reshape(4, 4)

    def GetWorldTransformationMatrix(self):
        return self._dp_world.copy()

    def SetViewTransformationMatrix(self, m):
        self._dp_view = np.asarray(m, np.float32).reshape(4, 4)

    def GetViewTransformationMatrix(self):
        m = self._dp_view
        if m is not None:
            return m.copy()
        view, _, _ = self._camera_np()
        return np.asarray(view, np.float32)

    def SetProjectionTransformationMatrix(self, m):
        self._dp_proj = np.asarray(m, np.float32).reshape(4, 4)

    def GetProjectionTransformationMatrix(self):
        m = self._dp_proj
        if m is not None:
            return m.copy()
        _, proj, _ = self._camera_np()
        return np.asarray(proj, np.float32)

    def SetCurrentMaterial(self, material):
        self._dp_material = material

    def SetTexture(self, texture, stage: int = 0):
        self._dp_texture = texture

    def GetDrawPrimitiveStructure(self, transformed: bool = True,
                                  vertex_count: int = 0) -> dict:
        """Staging structure for user DrawPrimitive: numpy views the caller
        fills (positions are clip-space xyzw when ``transformed``, local
        xyz otherwise)."""
        n = max(int(vertex_count), 1)
        self._dp_struct = {
            "transformed": bool(transformed),
            "positions": np.zeros((n, 4 if transformed else 3), np.float32),
            "colors": np.ones((n, 4), np.float32),
            "uvs": np.zeros((n, 2), np.float32),
        }
        return self._dp_struct

    def DrawPrimitive(self, prim_type, indices=None, data: dict | None = None):
        """Composite user geometry onto the framebuffer immediately
        (reference RCKRenderContext::DrawPrimitive). ``data`` defaults to the
        last GetDrawPrimitiveStructure; untransformed positions go through
        the current DP world/view/projection matrices, UVs through stage
        0's texture matrix. A bound material's state and texture win over
        the DP state and ``SetTexture``'s texture."""
        from .vertexbuffer import draw_clip

        data = data if data is not None else self._dp_struct
        if data is None:
            return False
        pos = np.asarray(data["positions"], np.float32)
        colors = np.asarray(data["colors"], np.float32)
        uvs = np.asarray(data["uvs"], np.float32)
        if indices is not None:
            idx = np.asarray(indices, np.int64).reshape(-1)
            pos, colors, uvs = pos[idx], colors[idx], uvs[idx]
        tm = self._texture_matrices.get(0)
        if tm is not None:
            # DX9 2D texture transform: (u,v,0,1) @ M, keep xy
            uvh = np.concatenate(
                [uvs, np.zeros((uvs.shape[0], 1), np.float32),
                 np.ones((uvs.shape[0], 1), np.float32)], -1)
            uvs = (uvh @ tm)[:, :2].astype(np.float32)
        if not data.get("transformed", True):
            h = np.concatenate(
                [pos[:, :3], np.ones((pos.shape[0], 1), np.float32)], -1)
            view, proj, _ = self._camera_np()
            if self._dp_view is not None:
                view = self._dp_view
            if self._dp_proj is not None:
                proj = self._dp_proj
            pos = h @ (self._dp_world @ view @ proj)
        state, tex = self._dp_draw_state()
        return draw_clip(self, int(prim_type), pos, colors, uvs,
                         state=state, texture=tex)

    def _dp_draw_state(self) -> tuple:
        """(raster state, texture) of an immediate draw: the bound
        material's state and texture (its texture before ``SetTexture``'s),
        else the DP state the material appliers write and ``SetTexture``'s
        texture."""
        mat = self._dp_material
        if mat is None:
            return self._dp_state, self._dp_texture
        tex = mat.GetTexture()
        return mat.raster_state(), (tex if tex is not None
                                    else self._dp_texture)

    # -- DrawPrimitive staging helpers (reference AllocateStructure /
    # ClearStructure / GetStructure / GetDrawPrimitiveIndices /
    # LockCurrentVB / ReleaseCurrentVB, include/RCKRenderContext.h;
    # reference rendercontext.py:3594-3638) --------------------------------
    def AllocateStructure(self, vertex_count: int = 0,
                          transformed: bool = True) -> dict:
        return self.GetDrawPrimitiveStructure(transformed, vertex_count)

    def GetStructure(self) -> dict | None:
        return self._dp_struct

    def ClearStructure(self):
        self._dp_struct = None

    def GetDrawPrimitiveIndices(self, count: int) -> np.ndarray:
        """Shared sequential index buffer (reference GetDrawPrimitiveIndices
        — the dynamic 16-bit index buffer; 32-bit here, no 65k cap)."""
        cached = self._dp_indices
        if cached is None or cached.shape[0] < count:
            self._dp_indices = np.arange(max(count, 128), dtype=np.int32)
        return self._dp_indices[:count]

    def LockCurrentVB(self, vertex_count: int):
        """Lock a pooled staging VB (reference LockCurrentVB); returns
        (positions, colors, uvs) views. Draw with ReleaseCurrentVB."""
        from .vertexbuffer import CKVertexBuffer

        vb = self._current_vb
        if vb is None:
            vb = CKVertexBuffer(self.context, "__rc_vb",
                                max_vertices=max(vertex_count, 256))
            self._current_vb = vb
        views = vb.Lock(0, vertex_count)
        self._current_vb_count = vertex_count
        return views

    def ReleaseCurrentVB(self, prim_type: int | None = None) -> bool:
        """Unlock the staging VB; with ``prim_type``, draw it immediately."""
        vb = self._current_vb
        if vb is None:
            return False
        vb.Unlock()
        if prim_type is not None:
            state, tex = self._dp_draw_state()
            return vb.Draw(self, int(prim_type), 0,
                           self._current_vb_count, state=state, texture=tex)
        return True

    # -- Sprite3D immediate batches (reference AddSprite3DBatch /
    # CallSprite3DBatches / FlushSprite3DBatchesIfNeeded,
    # src/CKRenderContext.cpp:2821-2921; reference rendercontext.py:
    # 3645-3710). The frame expands its sprites on the device; these drive
    # the immediate path. -------------------------------------------------
    def AddSprite3DBatch(self, sprite3d) -> bool:
        mat = sprite3d.GetMaterial()
        if mat is None:
            return False
        mat.AddSprite3DBatch(sprite3d)
        if mat not in self._sprite3d_mats:
            self._sprite3d_mats.append(mat)
        return True

    def CallSprite3DBatches(self) -> int:
        """Draw every pending material batch NOW (camera-space billboard
        fill + one DrawPrimitive per material, culling off, the material's
        diffuse as the vertex colour). Returns sprites drawn."""
        import dataclasses

        from ..raster.types import VXCULL

        total = 0
        view, proj, _ = self._camera_np()
        for mat in self._sprite3d_mats:
            sprites = mat.GetSprite3DBatch()
            if not sprites:
                continue
            pos_l, uv_l, idx_l = [], [], []
            base = 0
            cam_world = np.linalg.inv(np.asarray(view, np.float32))
            for sp in sprites:
                verts, uvs, indices = sp.FillBatch(cam_world)
                pos_l.append(verts)
                uv_l.append(uvs)
                idx_l.append(indices + base)
                base += 4
            verts = np.concatenate(pos_l)
            h = np.concatenate([verts, np.ones((verts.shape[0], 1),
                                               np.float32)], -1)
            clip = h @ (np.asarray(view, np.float32)
                        @ np.asarray(proj, np.float32))
            s = self.GetDrawPrimitiveStructure(transformed=True,
                                               vertex_count=clip.shape[0])
            s["positions"][:] = clip
            s["uvs"][:] = np.concatenate(uv_l)
            s["colors"][:] = np.asarray(mat.GetDiffuse(), np.float32)
            # Sprites never cull (the reference's sprite batches draw with
            # culling off — billboard winding depends on the view).
            saved_state = self._dp_state
            saved_tex = self._dp_texture
            self._dp_state = dataclasses.replace(
                mat.raster_state(), cull=int(VXCULL.NONE))
            self._dp_texture = mat.GetTexture() or saved_tex
            try:
                self.DrawPrimitive(2, np.concatenate(idx_l), s)
            finally:
                self._dp_state = saved_state
                self._dp_texture = saved_tex
            total += len(sprites)
            mat.FlushSprite3DBatch()
        self._sprite3d_mats = []
        return total

    def FlushSprite3DBatchesIfNeeded(self, mat=None) -> int:
        """Flush when a state change would interleave wrongly (reference
        FlushSprite3DBatchesIfNeeded); flushes everything here."""
        if self._sprite3d_mats:
            return self.CallSprite3DBatches()
        return 0

    def RenderTransparents(self, flags: int = 0) -> int:
        """Immediate back-to-front draw of all transparent entities
        (reference RenderTransparents, rendercontext.py:3744-3766; the
        frame performs this per triangle on the device — this is the host
        path for callbacks): far first by the entity origin's view-space
        z, each through ``CKMesh.Render``. Returns the entities drawn."""
        cam = self.GetAttachedCamera()
        view = (cam.view_matrix() if cam is not None
                else np.eye(4, dtype=np.float32))
        ents = [e for e in self._scene_entities()
                if e.IsVisible() and e.GetCurrentMesh() is not None
                and e.GetCurrentMesh().IsTransparent()]

        def depth(e):
            p = e.GetWorldMatrix()[3, :3]
            return float((np.append(p, 1.0) @ view)[2])

        ents.sort(key=depth, reverse=True)      # far first
        n = 0
        for e in ents:
            if e.GetCurrentMesh().Render(self, e):
                n += 1
        return n

    # -- picking (RCKRenderContext::Pick, src/CKRenderContext.cpp:1661-1900;
    # reference rendercontext.py:4040-4201): host numpy over the meshes'
    # host arrays, as in the reference. ------------------------------------
    def _pick_ray(self, x: float, y: float):
        """World-space eye ray through the point (x, y) of the frame, or
        None without camera. (x, y) maps as given: the centre of pixel
        (i, j) is (i + 0.5, j + 0.5), where the rasterizer samples it."""
        cam = self.attached_camera
        if cam is None:
            return None
        vxp, vyp, vw, vh = self._effective_viewport()
        ndc_x = (x - vxp) / vw * 2.0 - 1.0
        ndc_y = 1.0 - (y - vyp) / vh * 2.0
        aspect = vw / max(vh, 1)
        proj = cam.projection_matrix(aspect)
        dir_cam = np.array([ndc_x / proj[0, 0], ndc_y / proj[1, 1], 1.0],
                           np.float32)
        w = cam.GetWorldMatrix()
        return w[3, :3], dir_cam @ w[:3, :3]

    def Pick3D(self, x: float, y: float, precise_texture: bool = False):
        """Nearest 3D hit: (entity, distance) or (None, inf). With
        ``precise_texture``, alpha-tested texels don't pick
        (PreciseTexturePick, reference src/CKMeshUtils.cpp:35+)."""
        ray = self._pick_ray(x, y)
        if ray is None:
            return None, float("inf")
        origin, direction = ray
        best = (None, float("inf"))
        for ent in self._scene_entities():
            if not ent.IsVisible() or ent.GetCurrentMesh() is None:
                continue
            hit = ent.RayIntersection(origin, direction)
            if hit is None or hit[0] >= best[1]:
                continue
            if precise_texture and self._alpha_rejects(ent, hit, origin,
                                                       direction):
                continue
            best = (ent, hit[0])
        return best

    def _alpha_rejects(self, ent, hit, origin, direction) -> bool:
        """True when the hit texel's alpha fails the material alpha test
        (the texture's current image, read back to the host if it is fed
        on the device)."""
        dist, face = hit
        mesh = ent.GetCurrentMesh()
        if mesh.uvs.shape[0] == 0:
            return False
        mat = mesh.GetFaceMaterial(face)
        tex = mat.GetTexture(0) if mat is not None else None
        if tex is None:
            return False
        img = tex.current_image()
        if img is None:
            return False
        inv = ent.GetInverseWorldMatrix()
        o = np.asarray(origin, np.float32) @ inv[:3, :3] + inv[3, :3]
        d = np.asarray(direction, np.float32) @ inv[:3, :3]
        p = o + d * dist
        a, b, c = mesh.faces[face]
        va, vb, vc = mesh.positions[[a, b, c]]
        # barycentric coords of p
        v0, v1, v2 = vb - va, vc - va, p - va
        d00, d01 = v0 @ v0, v0 @ v1
        d11 = v1 @ v1
        d20, d21 = v2 @ v0, v2 @ v1
        den = d00 * d11 - d01 * d01
        if abs(den) < 1e-12:
            return False
        v = (d11 * d20 - d01 * d21) / den
        w_ = (d00 * d21 - d01 * d20) / den
        u = 1.0 - v - w_
        uv = u * mesh.uvs[a] + v * mesh.uvs[b] + w_ * mesh.uvs[c]
        h, w = img.shape[0], img.shape[1]
        tx = int(np.clip(uv[0] % 1.0 * w, 0, w - 1))
        ty = int(np.clip(uv[1] % 1.0 * h, 0, h - 1))
        return img[ty, tx, 3] < 0.5

    def Pick(self, x: int, y: int, precise_texture: bool = False):
        """2D entities first (front-to-back), then nearest 3D hit. Returns
        (object, distance) — distance 0 for 2D hits."""
        hit2d = self.Pick2D(x, y)
        if hit2d is not None:
            return hit2d, 0.0
        return self.Pick3D(x, y, precise_texture)

    def PickRect(self, rect) -> list:
        """Entities whose projected bbox intersects the pixel rect
        (x0, y0, x1, y1) (RectPick, reference include/RCKRenderContext.h)."""
        cam = self.attached_camera
        if cam is None:
            return []
        x0, y0, x1, y1 = rect
        vxp, vyp, vw, vh = self._effective_viewport()
        aspect = vw / max(vh, 1)
        view = cam.view_matrix()
        proj = cam.projection_matrix(aspect)
        vp = view @ proj
        out = []
        for ent in self._scene_entities():
            if not ent.IsVisible() or ent.GetCurrentMesh() is None:
                continue
            bmin, bmax = ent.GetBoundingBox()
            corners = np.array([[x, y, z, 1.0] for x in (bmin[0], bmax[0])
                                for y in (bmin[1], bmax[1])
                                for z in (bmin[2], bmax[2])], np.float32)
            clip = corners @ vp
            w = clip[:, 3]
            front = w > 1e-6
            if not front.any():
                continue
            sx = vxp + vw * 0.5 + clip[front, 0] / w[front] * vw * 0.5
            sy = vyp + vh * 0.5 - clip[front, 1] / w[front] * vh * 0.5
            if sx.max() < x0 or sx.min() > x1 or sy.max() < y0 or sy.min() > y1:
                continue
            out.append(ent)
        return out

    def RectPick(self, rect, intersect: bool = True) -> list:
        """:meth:`PickRect`; ``intersect`` is ignored (the reference passes
        it on to a PickRect that takes no such argument)."""
        return self.PickRect(rect)

    # -- debug object stepping (reference :3768-3811) -----------------------
    def SetDebugObjectCount(self, k: int = -1):
        """Render only the first ``k`` entities in render order (-1: all),
        the programmatic form of the reference's object-stepping debugger.
        The fill masks the rest (``_fill_packed``): no recompile."""
        self._debug_object_count = int(k)
        self.context._bump_dynamic()

    def GetDebugObjectCount(self) -> int:
        return self._debug_object_count

    def DebugStep(self, delta: int = 1) -> int:
        """Advance the stepping cursor; past the entity count it wraps back
        to -1 (every entity)."""
        n = self.context.entity_table.count
        cur = self._debug_object_count
        cur = 0 if cur < 0 else cur + delta
        if cur > n:
            cur = -1
        self.SetDebugObjectCount(cur)
        return cur

    def _debug_label_text(self) -> str:
        """The label's text, ``<name> (<k>/<n>) <ms> ms``: the last stepped
        entity in render order (stable by descending priority over the
        entity rows, as the fill cuts them) and the previous frame's
        time."""
        k = self._debug_object_count
        n = self.context.entity_table.count
        name = "(none)"
        if k >= 1:
            order = np.argsort(-self._entity_priority_np(n), kind="stable")
            row = int(order[min(k, n) - 1])
            for obj in self.context._objects.values():
                if getattr(obj, "row", None) == row:
                    name = obj.GetName() or f"row {row}"
                    break
        return f"{name} ({k}/{n}) {self.stats.FrameTime:.1f} ms"

    def _composite_debug_label(self):
        """Draw the stepping label (:meth:`_debug_label_text`) into the
        frame at (4, 4), where it fits. The label's image is rastered on
        the host and uploaded once per text."""
        from ..pipeline.overlay import composite_label, raster_label

        text = self._debug_label_text()
        if self._dbg_label[0] != text:
            img = raster_label(text, max_w=max(self.width - 8, 1))
            self._dbg_label = (text, torch.from_numpy(img).to(
                self.context.device))
        img = self._dbg_label[1]
        if img.shape[0] + 4 <= self.height and img.shape[1] + 4 <= self.width:
            self.fb = composite_label(self.fb, img, 4, 4)

    # -- the PV watermark (reference :3860-3883) -----------------------------
    def LoadPVInformationTexture(self) -> bool:
        """The watermark's 32x8 texture: a translucent bar with a dark
        stripe."""
        from .texture import CKTexture
        if self._pv_texture is None:
            tex = CKTexture(self.context, "__pv_watermark")
            img = np.zeros((8, 32, 4), np.float32)
            img[1:7, 1:31] = (1.0, 1.0, 1.0, 0.35)
            img[3:5, 2:30, :3] = 0.1
            tex.SetImage(img)
            self._pv_texture = tex
        return True

    def DrawPVInformationWatermark(self) -> bool:
        """Blend the watermark over the frame's bottom-left corner (2 pixels
        in), through a host copy of the frame and
        :meth:`CopyFromMemoryBuffer`, as the reference does."""
        if not self.LoadPVInformationTexture():
            return False
        img = self._pv_texture.GetImage()
        fb = self.framebuffer().copy()
        h, w = img.shape[0], img.shape[1]
        y0 = self.height - h - 2
        x0 = 2
        a = img[..., 3:4]
        fb[y0:y0 + h, x0:x0 + w, :3] = (
            fb[y0:y0 + h, x0:x0 + w, :3] * (1 - a) + img[..., :3] * a)
        return self.CopyFromMemoryBuffer(fb)

    def DestroyDevice(self) -> bool:
        """Free this context's device state: a pending window or batch is
        resolved first (fb, zb and sb keep its frame), then the compiled
        scene, its uploaded tensors, the texture stack and the captured
        CUDA graphs of its windows and batches are dropped. The next
        ``Render()`` compiles, uploads and captures them again."""
        self._sync_window()
        for graph in (self._window, self._batch,
                      *self._mesh_batches.values()):
            if graph is not None:
                graph.release()
        self._window = self._batch = None
        self._mesh_batches = {}
        self._compiled = CompiledScene()
        self._packed_static = self._packed_static_vers = None
        self._sprites_static = None
        self._video_patch_cache = None
        self._layout_sig = None
        self._empty_texture_stack()
        if self.context.device.type == "cuda":
            torch.cuda.empty_cache()
        return True

    def _empty_texture_stack(self):
        """The one-texel stack of a context with no compiled scene."""
        dev = self.context.device
        self._tex_planes = torch.zeros((1, 4, 1, 1), dtype=torch.float32,
                                       device=dev)
        self._tex_quad = None
        self._tex_hw = torch.ones((1, 2), dtype=torch.int32, device=dev)

    def OnClearAll(self):
        """The context's ClearAll notification: drop the callbacks and the
        membership, and the device state (:meth:`DestroyDevice`)."""
        self.ClearCallbacks()
        self._objects = None
        self.DestroyDevice()
        self.context._bump_topology()


class BatchRead:
    """The one host read of a context batch (``CKRenderManager
    .ProcessBatched``), made lazily: at the first read of any member's
    fb / zb / sb or stats, at a member's next ``Render()``, or at the next
    ``ProcessBatched``. ``members`` are the group's contexts in order
    (the first leads: it holds the group's capacity governor and peel
    round count); ``runs`` are (``window.Pending``, the members it
    rendered, the frame's inputs on the members' device: (static, params,
    bank)) for each chunk of the group; a chunk of a mesh block may have
    run on another device."""

    def __init__(self, members: list, runs: list):
        self.members = members
        self.runs = runs
        self.done = False

    def resolve(self) -> None:
        """Read the rows; render each flagged member again eagerly (the
        exact remainder, replay and peel) into its slot of the stacked
        outputs; set each member's stats; give the group's worst bin
        statistics to the lead's governor and copy its caps and peel
        round count to the others; bring each member's buffers to its own
        device (a copy only for a block that ran on another device)."""
        if self.done:
            return
        self.done = True
        members = self.members
        for rc in members:
            if rc._batch_read is self:
                rc._batch_read = None
        lead = members[0]
        bins = []
        for p, chunk, (static, params, bank) in self.runs:
            rows = p.read()
            win = p.window
            for j, rc in enumerate(chunk):
                s = rc.stats
                s.OrderedPeelRounds = win.rounds
                s.OrderedPeelOverflow = bool(
                    rows[j, fw.flag_word("PeelBad")])
                if win.tiled:
                    b = rows[j, fw.ROW_BINS]
                    s.SolveLivePairs = int(b[1])
                    s.SolveFallbackRows = int(b[2] + b[3] + b[4])
            for j in np.nonzero(fw.flagged(rows))[0]:
                rc = chunk[j]
                dyn_f, dyn_i, anim = p.slots[j]
                out = rc._render_eager(static, dyn_f, dyn_i, params,
                                       anim=anim, govern=False, bank=bank)
                for stacked, plane in zip((p.fb, p.zb, p.sb), out[:3]):
                    if plane is not None:
                        stacked[j].copy_(plane)
                if win.rounds:
                    lead._peel_rounds = max(lead._peel_rounds or 1,
                                            out[3]["OrderedPeelRounds"])
            if win.tiled:
                bins.append(rows[:, fw.ROW_BINS])
        if bins and lead._gov_on:
            # The governor sets the lead's solve counters to the group's
            # worst; the lead's stats stay its own frame's.
            s = lead.stats
            own = (s.SolveLivePairs, s.SolveFallbackRows)
            lead._governor_tick({"SolveBinStats": np.concatenate(bins)})
            lead._governor_resolve()
            s.SolveLivePairs, s.SolveFallbackRows = own
        for rc in members[1:]:
            rc._solve_caps = lead._solve_caps
            rc._peel_rounds = lead._peel_rounds
        for p, chunk, _inputs in self.runs:
            for rc in chunk:
                dev = rc.context.device
                rc._fb_val = rc._fb_val.to(dev)
                rc._zb_val = rc._zb_val.to(dev)
                if p.sb is not None:
                    rc._sb_val = rc._sb_val.to(dev)

