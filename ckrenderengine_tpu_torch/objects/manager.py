"""CKRenderManager (reference RCKRenderManager, src/CKRenderManager.cpp)
and CKRenderedScene.

Shared render types live in .rendertypes and the context in .rendercontext;
this module re-exports both, like the reference package's manager module.
Context batching (``ProcessBatched``) runs on one card; its multi-card
form (``mesh=``) is not carried yet and raises. The driver table is
``raster.caps.enumerate_drivers``; the scene graph is a view over the
entity table (``scene.scenegraph``). The reference's public methods that
this package does not carry raise their port queue item.
"""

from .rendertypes import *          # noqa: F401,F403
from .rendertypes import (          # noqa: F401
    _pad_to, _mip_chain, CompiledScene, VxStats, VxEffectDescription,
)
from .rendercontext import BatchRead, CKRenderContext    # noqa: F401
from ..pipeline import window as fw

# Members per run of a context batch: a larger group runs in chunks of
# this many (each chunk one upload and one graph replay per member).
BATCH_SLOTS = 64


class CKRenderManager(CKObject):
    """Owner of render contexts + global options
    (reference src/CKRenderManager.cpp:77-246)."""

    def __init__(self, context: CKContext, name: str = "RenderManager"):
        super().__init__(context, name)
        context.render_manager = self
        self.render_contexts: list[CKRenderContext] = []
        self._context_mask_free = 0xFFFFFFFF
        self._moved_entities: set[int] = set()
        self._last_frame_entities: set[int] = set()
        self._vertex_buffers: list = []
        self._object_index_next = 1
        self._object_index_free: list[int] = []
        self._root_node = None
        self._trace_session = None
        self.default_material = CKMaterial(context, "DefaultMat")
        # The 17 legacy options (reference src/CKRenderManager.cpp:79-127).
        from ..settings import default_options
        self.options = default_options()
        self.effects: list[VxEffectDescription] = []
        self._register_default_effects()

    # -- effects registry (reference RegisterDefaultEffects/AddEffect/
    # GetEffectDescription, src/CKRenderManager.cpp:721-1050) -------------
    def _register_default_effects(self):
        for summary, max_tex in (("None", 0), ("TexGen", 0),
                                 ("TexGen with referential", 0),
                                 ("Bump Env Mapping", 3), ("DP3 Mapping", 2),
                                 ("2 Textures Blend", 2),
                                 ("3 Textures Blend", 3)):
            self.AddEffect(VxEffectDescription(summary=summary,
                                               max_texture_count=max_tex))

    def AddEffect(self, desc: "VxEffectDescription") -> int:
        """Register an effect; returns its VX_EFFECT code."""
        self.effects.append(desc)
        return len(self.effects) - 1

    def GetEffectCount(self) -> int:
        return len(self.effects)

    def GetEffectDescription(self, i: int) -> "VxEffectDescription":
        return self.effects[i]

    def CreateRenderContext(self, width: int = 256, height: int = 256,
                            name: str = "RenderContext") -> CKRenderContext:
        rc = CKRenderContext(self.context, name, width, height)
        # Allocate a context mask bit (32 max in the reference; we grow).
        for bit in range(64):
            if self._context_mask_free & (1 << bit):
                self._context_mask_free &= ~(1 << bit)
                rc.mask = 1 << bit
                break
        self.render_contexts.append(rc)
        return rc

    def DestroyRenderContext(self, rc: CKRenderContext):
        self.RemoveRenderContext(rc)
        self.context.DestroyObject(rc)

    def GetDefaultMaterial(self):
        return self.default_material

    def CreateVertexBuffer(self, name: str = "", max_vertices: int = 1024):
        """User dynamic vertex buffer (reference
        RCKRenderManager::CreateVertexBuffer)."""
        from .vertexbuffer import CKVertexBuffer

        vb = CKVertexBuffer(self.context, name, max_vertices)
        self._vertex_buffers.append(vb)
        return vb

    def DestroyVertexBuffer(self, vb):
        """(reference DestroyVertexBuffer)"""
        if vb in self._vertex_buffers:
            self._vertex_buffers.remove(vb)
        self.context.DestroyObject(vb)

    def DeleteAllVertexBuffers(self):
        for vb in list(self._vertex_buffers):
            self.DestroyVertexBuffer(vb)

    def GetRenderContextMaskFree(self) -> int:
        return self._context_mask_free

    def GetRenderContextCount(self) -> int:
        return len(self.render_contexts)

    def GetRenderContext(self, i: int) -> CKRenderContext:
        return self.render_contexts[i]

    def GetDesiredTexturesVideoFormat(self):
        return self.options.get("TextureVideoFormat", "32_ARGB8888")

    def SetDesiredTexturesVideoFormat(self, fmt):
        self.options["TextureVideoFormat"] = fmt

    def AddMovedEntity(self, ent):
        self._moved_entities.add(ent.id)

    def FlushTextures(self):
        """Invalidate cached device texture stacks so the next frame
        re-uploads (reference FlushTextures)."""
        for rc in self.render_contexts:
            rc._compiled._tex_version = -1

    def Process(self):
        """Render every active context (reference manager.py:198-203,
        src/CKRenderManager.cpp:521-527): ``Activate(False)`` skips one."""
        for rc in self.render_contexts:
            if rc.IsActive():
                rc.Render()

    def ProcessBatched(self, mesh=None):
        """Render every context, same-shape contexts as context batches
        (reference manager.py:205-249). Contexts group by signature (size,
        hierarchy levels, ordered cap, stream shapes). A member with a
        vertex shader renders through its own ``Render()``, with its shader
        (the reference's batch refuses such a member and renders its group
        with the vmapped fallback, which drops the shader). A group of one
        renders through its ``Render()``; a larger group through
        :meth:`_batch_packed`, or, where it cannot share one captured
        frame, through each member's ``Render()``, as the reference's
        docstring says (its code renders such a group with the vmapped
        ``render_frames_batched``, which leaves out no-clear flags,
        overlays and lines). ``mesh``: a ``ctx``
        :class:`~ckrenderengine_tpu_torch.parallel.mesh.DeviceMesh`
        (``context_batch.make_context_mesh``) over which each batched group
        splits into contiguous blocks, one per entry (reference :205-249);
        anything else raises ``TypeError``."""
        from ..parallel.mesh import DeviceMesh

        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(
                "ProcessBatched(mesh=...) expects a parallel.mesh.DeviceMesh; "
                "it renders this manager's own contexts (like the "
                "reference's Process): there is no context-list parameter")
        groups: dict[tuple, list] = {}
        for rc in self.render_contexts:
            if rc._compiled.topology_version != \
                    rc.context._topology_version:
                rc._compile()
            rc._refresh_textures()
            c = rc._compiled
            sig = (rc.width, rc.height, c.levels, c.ordered_cap,
                   c.src_idx.shape, c.tri_idx.shape)
            groups.setdefault(sig, []).append(rc)
        for rcs in groups.values():
            # A vertex-shader member renders alone, with its shader.
            alone = [rc for rc in rcs if rc.vertex_shader is not None]
            rcs = [rc for rc in rcs if rc.vertex_shader is None]
            if len(rcs) == 1 or (rcs and not self._batch_packed(rcs,
                                                                mesh)):
                alone = rcs + alone
            for rc in alone:
                rc.Render()

    def _batch_packed(self, rcs, mesh=None) -> bool:
        """Render ``rcs`` as context batches: each member's frame is filled
        on the host, the group uploads once (one pinned block, one
        ``non_blocking`` copy per chunk of ``BATCH_SLOTS``) and replays one
        captured frame per member, the first member's
        (``window.FrameWindow(stacked=True)``), into stacked outputs whose
        slices become the members' fb / zb / sb. Members that differ in
        anything the graph bakes in (params but the clip's worlds and the
        caps, the static tensors' shapes, the dyn shapes, a host-culled
        chunk cap, the clip bank, the frame flags, the ordered route) split
        into sub-groups, each batched on its own. The batch's host read
        waits in a :class:`BatchRead`. Returns False, rendering nothing,
        when a member cannot join (reference :251-299: stereo, a vertex
        shader, a target texture, another membership; and a frame that
        renders eagerly in a window: no-clear flags, a device texture,
        debug mode, the exact tiled ordered pass, bands). ``mesh``: as in
        :meth:`ProcessBatched` (reference :254-320)."""

        def membership(rc):
            return None if rc._objects is None else tuple(
                sorted(id(o) for o in rc._objects))

        for rc in rcs:
            if (rc.stereo_enabled or rc.vertex_shader is not None
                    or rc.target_texture is not None
                    or membership(rc) != membership(rcs[0])):
                return False
        staged = []
        for rc in rcs:
            # The member's own staged frames come before the batch's.
            rc._flush_window()
            rc._resolve_window()
            if rc._compiled.topology_version != \
                    rc.context._topology_version:
                rc._compile()
            rc._frame_flags = rc.ResolveRenderFlags(0)
            if rc._eager_only():
                return False
            quads_bg, quads_fg = rc._quad_lists()
            if not (rc._frame_flags & CK_RENDER_BACKGROUNDSPRITES):
                quads_bg = []
            if not (rc._frame_flags & CK_RENDER_FOREGROUNDSPRITES):
                quads_fg = []
            rc._refresh_textures()
            frame = rc._staged_frame(quads_bg, quads_fg)
            _key, static, params, bank, route, slot = frame
            if not rc._capturable(params, route):
                return False
            shape = (fw.freeze({k: v for k, v in params.items()
                                if k not in ("world_in", "solve_caps")},
                               shapes=True),
                     fw.freeze(static, shapes=True), slot[0].shape,
                     slot[1].shape,
                     None if slot[2] is None else slot[2][0].shape,
                     fw.freeze(bank), rc._frame_flags, route)
            staged.append((rc, shape, frame))
        # The previous batch is read now, after the host has filled this
        # one, so that its caps and peel round count are this batch's.
        for rc in rcs:
            if rc._batch_read is not None:
                rc._batch_read.resolve()
        subgroups: dict[tuple, list] = {}
        for rc, shape, frame in staged:
            subgroups.setdefault(shape, []).append((rc, frame))
        for sub in subgroups.values():
            self._run_batch(sub, mesh)
        return True

    def _run_batch(self, sub: list, mesh=None) -> None:
        """One sub-group of :meth:`_batch_packed`: (member, staged frame)
        pairs. The caps and the peel's round count are the first member's
        (its eager frame fixes the count the first time), the graph is
        kept on it per key and device. With a ``mesh`` the sub-group splits
        into contiguous blocks, one per entry, each replayed on its entry's
        device (a CUDA graph belongs to one device) with one upload per
        block; the members' buffers come back to their devices at the
        batch's read (:class:`BatchRead`)."""
        from ..parallel.context_batch import blocks
        from ..parallel.mesh import on

        lead, (key, static, params, bank, route, slot0) = sub[0]
        caps = lead._solve_caps
        params = dict(params, solve_caps=caps)
        rounds = (lead._peel_rounds_for(static, params, slot0, bank)
                  if route == "peel" else 0)
        home = (static, {k: v for k, v in params.items() if k != "world_in"},
                bank)
        runs = []
        for dev, a, b in ([(None, 0, len(sub))] if mesh is None
                          else blocks(len(sub), mesh)):
            block = sub[a:b]
            size = min(len(block), BATCH_SLOTS)
            batch = lead._batch_window(
                dev, key + (fw.freeze(caps), rounds, size), static, params,
                bank, rounds, size)
            members = [rc for rc, _frame in block]
            slots = [frame[-1] for _rc, frame in block]
            with on(batch.device):
                runs += [(batch.run(slots[i:i + size]), members[i:i + size],
                          home) for i in range(0, len(block), size)]
        read = BatchRead([rc for rc, _frame in sub], runs)
        for p, chunk, _home in runs:
            for j, rc in enumerate(chunk):
                rc._solve_caps = caps
                rc._fb_val, rc._zb_val = p.fb[j], p.zb[j]
                if p.sb is not None:
                    rc._sb_val = p.sb[j]
                rc._win_fence = None
                rc._batch_read = read
                rc._count_frame()

    def PreProcess(self):
        """Save every 3D entity's world matrix as its last-frame matrix and
        clear the moved set (reference manager.py:363-379,
        src/CKRenderManager.cpp:311-335)."""
        self.SaveLastFrameMatrix()
        self._moved_entities.clear()

    def SaveLastFrameMatrix(self):
        from .entity import CK3dEntity

        for obj in self.context._objects.values():
            if isinstance(obj, CK3dEntity):
                obj._last_frame_matrix = obj.GetWorldMatrix()

    def GetMovedEntities(self) -> list:
        return [self.context.GetObject(i) for i in self._moved_entities]

    def RegisterLastFrameEntity(self, ent):
        self._last_frame_entities.add(ent.id)

    def UnregisterLastFrameEntity(self, ent):
        self._last_frame_entities.discard(ent.id)

    def PostProcess(self):
        self.CleanMovedEntities()
        self.CleanTemporaryCallbacks()

    def CleanMovedEntities(self):
        """Clear HASMOVED flags (reference CleanMovedEntities :825)."""
        tbl = self.context.entity_table
        tbl.flags[: tbl.count] &= ~np.uint32(et.VX_MOVEABLE_HASMOVED)

    def CleanTemporaryCallbacks(self):
        """Drop the temporary callbacks after the frame: the objects' and
        every context's pre-render, post-render and post-sprite ones."""
        for oid, obj in list(self.context._cb_objects.items()):
            obj.callbacks = [cb for cb in obj.callbacks if not cb[3]]
            if not obj.callbacks:
                self.context._cb_objects.pop(oid, None)
        self.RemoveAllTemporaryCallbacks()

    # -- temporary callbacks (reference manager.py:405-438) ----------------
    def AddTemporaryPreRenderCallback(self, fct, arg=None, rc=None):
        """A pre-render callback on ``rc`` (default: every context) that
        ``PostProcess`` drops after the frame."""
        for target in ([rc] if rc is not None else self.render_contexts):
            target.AddPreRenderCallBack(fct, arg, temp=True)

    def AddTemporaryPostRenderCallback(self, fct, arg=None, rc=None):
        for target in ([rc] if rc is not None else self.render_contexts):
            target.AddPostRenderCallBack(fct, arg, temp=True)

    def AddTemporaryCallback(self, fct, arg=None, pre: bool = True):
        if pre:
            self.AddTemporaryPreRenderCallback(fct, arg)
        else:
            self.AddTemporaryPostRenderCallback(fct, arg)

    def RemoveTemporaryCallback(self, fct):
        for rc in self.render_contexts:
            rc.RemovePreRenderCallBack(fct)
            rc.RemovePostRenderCallBack(fct)

    def RemoveAllTemporaryCallbacks(self):
        """Drop every context's temporary pre-render, post-render and
        post-sprite callbacks now."""
        for rc in self.render_contexts:
            rc.pre_render_callbacks = [
                cb for cb in rc.pre_render_callbacks if not cb[3]]
            rc.post_render_callbacks = [
                cb for cb in rc.post_render_callbacks if not cb[3]]
            rc.post_sprite_callbacks = [
                cb for cb in rc.post_sprite_callbacks if not cb[3]]

    def ClearTemporaryCallbacks(self):
        self.CleanTemporaryCallbacks()

    # -- contexts and objects (reference manager.py:107-128, :180-190,
    # :441-459) -------------------------------------------------------------
    def RemoveRenderContext(self, rc: CKRenderContext):
        """Take a context off the manager without destroying it."""
        if rc in self.render_contexts:
            self.render_contexts.remove(rc)
            self._context_mask_free |= rc.mask

    def ReleaseRenderContextMaskFree(self, mask: int):
        self._context_mask_free |= int(mask)

    def GetFullscreenContext(self):
        return None

    def GetRenderContextFromPoint(self, pt):
        """The first context whose viewport holds the point."""
        x, y = float(pt[0]), float(pt[1])
        for rc in self.render_contexts:
            vx0, vy0, vw, vh = rc.viewport
            if vx0 <= x < vx0 + vw and vy0 <= y < vy0 + vh:
                return rc
        return None

    def DetachAllObjects(self):
        """Remove every render object from every context; each gets an
        explicit, empty membership."""
        from .entity import CKRenderObject

        for rc in self.render_contexts:
            for obj in list(self.context._objects.values()):
                if isinstance(obj, CKRenderObject):
                    rc.RemoveObject(obj)
                    obj._in_render_context_mask &= ~rc.mask
            rc._objects = []
            self.context._bump_topology()

    def CreateObjectIndex(self, kind: int = 0) -> int:
        """An index of the rasterizers' shared object space; released ones
        come back first."""
        if self._object_index_free:
            return self._object_index_free.pop()
        idx = self._object_index_next
        self._object_index_next += 1
        return idx

    def ReleaseObjectIndex(self, index: int):
        self._object_index_free.append(int(index))

    # -- the scene graph (reference manager.py:461-478) ---------------------
    def GetRootNode(self):
        """The root node: a view over the parentless entities
        (``scene.scenegraph``)."""
        from ..scene.scenegraph import CKSceneGraphRootNode

        if self._root_node is None:
            self._root_node = CKSceneGraphRootNode(self)
        return self._root_node

    def CreateNode(self, entity=None):
        """A node view of ``entity``."""
        from ..scene.scenegraph import CKSceneGraphNode

        return CKSceneGraphNode(self, entity)

    def DeleteNode(self, node):
        """Nothing to free: nodes are views."""

    # -- notifications (reference manager.py:158-175, :479-510) ------------
    def RegisterDefaultEffects(self):
        self._register_default_effects()

    def PreClearAll(self):
        """Before a level clear: detach every context's viewpoint, drop the
        temporary callbacks and the moved set."""
        for rc in self.render_contexts:
            rc.DetachViewpointFromCamera()
        self.CleanTemporaryCallbacks()
        self._moved_entities.clear()

    def OnCKEnd(self):
        self.DeleteAllVertexBuffers()

    def OnCKPause(self):
        return None

    def DestroyingDevice(self):
        """The device goes away: every context frees its device state
        (``CKRenderContext.DestroyDevice``); the next ``Render()`` rebuilds
        it from system memory."""
        for rc in self.render_contexts:
            rc.DestroyDevice()

    def GetValidFunctionsMask(self) -> int:
        """The manager notifications carried: PreProcess, PostProcess,
        OnCKEnd, OnCKPause, PreClearAll, SequenceToBeDeleted,
        SequenceDeleted."""
        return 0x7F

    def SequenceAddedToScene(self, obj_ids=None):
        self.context._bump_topology()

    def SequenceRemovedFromScene(self, obj_ids=None):
        self.context._bump_topology()

    def SequenceToBeDeleted(self, obj_ids=None):
        for oid in (obj_ids or []):
            obj = self.context.GetObject(oid)
            if obj is not None:
                obj._to_be_deleted = True

    def SequenceDeleted(self, obj_ids=None):
        self.context._bump_topology()

    # -- device trace (reference manager.py:512-526) ------------------------
    def StartDeviceTrace(self, log_dir: str) -> bool:
        """Trace the following frames with ``torch.profiler`` into a
        Chrome trace under ``log_dir`` (``profiler.DeviceTraceSession``)."""
        from ..profiler import DeviceTraceSession

        self._trace_session = DeviceTraceSession(log_dir)
        return self._trace_session.Start()

    def StopDeviceTrace(self) -> bool:
        sess = self._trace_session
        if sess is None:
            return False
        self._trace_session = None
        return sess.Stop()

    # -- driver enumeration (reference driver table, HW first then SW,
    # src/CKRenderManager.cpp:190-226) -------------------------------------
    def GetRenderDriverCount(self) -> int:
        from ..raster.caps import enumerate_drivers
        return len(enumerate_drivers())

    def GetRenderDriverDescription(self, i: int):
        from ..raster.caps import enumerate_drivers
        return enumerate_drivers()[i]

    def GetDriverCaps(self, i: int = 0):
        return self.GetRenderDriverDescription(i).caps

    def GetPreferredSoftwareDriver(self) -> int:
        """Index of the software (numpy NULL) driver in the driver table.
        (The reference reads a ``hardware`` field the table's entries do
        not have, and so always answers 0.)"""
        from ..raster.caps import enumerate_drivers

        for d in enumerate_drivers():
            if not d.is_hardware:
                return d.index
        return 0

    def GetDriver(self, index: int):
        return self.GetRenderDriverDescription(index)

    def SetRenderOptions(self, name: str, value):
        self.options[name] = value

    def GetRenderOptions(self, name: str):
        return self.options.get(name)


class CKRenderedScene:
    """Per-context scene-state facade (reference CKRenderedScene,
    include/CKRenderedScene.h:13-49, manager.py:547-585): the camera, light
    and fog state of its context, and ``Draw``, one frame."""

    def __init__(self, rc: CKRenderContext):
        self.rc = rc

    def GetBackgroundColor(self):
        return self.rc.GetBackgroundColor()

    def SetBackgroundColor(self, rgba):
        self.rc.SetBackgroundColor(rgba)

    def GetAmbientLight(self):
        return self.rc.GetAmbientLight()

    def SetAmbientLight(self, rgba):
        self.rc.SetAmbientLight(rgba)

    def GetFogMode(self):
        return self.rc.GetFogMode()

    def GetAttachedCamera(self):
        return self.rc.GetAttachedCamera()

    def GetLights(self) -> list:
        from .light import CKLight

        return [o for o in self.rc.context._objects.values()
                if isinstance(o, CKLight)]

    def Get3dEntities(self) -> list:
        return self.rc._scene_entities()

    def Draw(self, flags: int = 0):
        """One frame of the context (``Render``)."""
        return self.rc.Render(flags)

