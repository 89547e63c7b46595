"""CKRenderManager (reference RCKRenderManager, src/CKRenderManager.cpp)
and CKRenderedScene.

Shared render types live in .rendertypes and the context in .rendercontext;
this module re-exports both, like the reference package's manager module.
Context batching (``ProcessBatched``) runs on one card; its multi-card
form (``mesh=``) is not carried yet and raises. The driver table is
``raster.caps.enumerate_drivers``. The reference's public methods that this
package does not carry raise their port queue item.
"""

from .rendertypes import *          # noqa: F401,F403
from .rendertypes import (          # noqa: F401
    _pad_to, _mip_chain, CompiledScene, VxStats, VxEffectDescription,
)
from .rendercontext import BatchRead, CKRenderContext    # noqa: F401
from ..pipeline import window as fw
from ..roadmap import unported, unported_methods

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
        if rc in self.render_contexts:
            self.render_contexts.remove(rc)
            self._context_mask_free |= rc.mask
        self.context.DestroyObject(rc)

    def GetDefaultMaterial(self):
        return self.default_material

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
        """Render every active context (reference
        src/CKRenderManager.cpp:521-527)."""
        for rc in self.render_contexts:
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
        overlays and lines). ``mesh`` (a device mesh over several cards)
        is not ported."""
        if mesh is not None:
            raise unported("multi-card context sharding "
                           "(ProcessBatched(mesh=...))", 12)
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
            if len(rcs) == 1 or (rcs and not self._batch_packed(rcs)):
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
        debug mode, the exact tiled ordered pass)."""
        if mesh is not None:
            raise unported("multi-card context sharding "
                           "(ProcessBatched(mesh=...))", 12)

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
            self._run_batch(sub)
        return True

    def _run_batch(self, sub: list) -> None:
        """One sub-group of :meth:`_batch_packed`: (member, staged frame)
        pairs. The caps and the peel's round count are the first member's
        (its eager frame fixes the count the first time), the graph is
        kept on it per key."""
        lead, (key, static, params, bank, route, slot0) = sub[0]
        caps = lead._solve_caps
        params = dict(params, solve_caps=caps)
        rounds = (lead._peel_rounds_for(static, params, slot0, bank)
                  if route == "peel" else 0)
        size = min(len(sub), BATCH_SLOTS)
        key = key + (fw.freeze(caps), rounds, size)
        batch = lead._batch
        if batch is None or batch.key != key:
            if batch is not None:
                batch.release()
            batch = lead._batch = fw.FrameWindow(
                key, static, params, bank, rounds, size,
                lead.context.device, stacked=True)
        members = [rc for rc, _frame in sub]
        slots = [frame[-1] for _rc, frame in sub]
        runs = [(batch.run(slots[i:i + size]), members[i:i + size])
                for i in range(0, len(sub), size)]
        read = BatchRead(members, runs)
        for p, chunk in runs:
            for j, rc in enumerate(chunk):
                rc._solve_caps = caps
                rc._fb_val, rc._zb_val = p.fb[j], p.zb[j]
                if p.sb is not None:
                    rc._sb_val = p.sb[j]
                rc._win_fence = None
                rc._batch_read = read
                rc._count_frame()

    def PreProcess(self):
        self._moved_entities.clear()

    def PostProcess(self):
        self.CleanMovedEntities()
        self.CleanTemporaryCallbacks()

    def CleanMovedEntities(self):
        """Clear HASMOVED flags (reference CleanMovedEntities :825)."""
        tbl = self.context.entity_table
        tbl.flags[: tbl.count] &= ~np.uint32(et.VX_MOVEABLE_HASMOVED)

    def CleanTemporaryCallbacks(self):
        """Drop temp callbacks after the frame."""
        for oid, obj in list(self.context._cb_objects.items()):
            obj.callbacks = [cb for cb in obj.callbacks if not cb[3]]
            if not obj.callbacks:
                self.context._cb_objects.pop(oid, None)
        for rc in self.render_contexts:
            rc.pre_render_callbacks = [
                cb for cb in rc.pre_render_callbacks if not cb[3]]
            rc.post_render_callbacks = [
                cb for cb in rc.post_render_callbacks if not cb[3]]

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
    include/CKRenderedScene.h:13-49). Not carried yet: each of its methods
    raises (port queue item 17)."""

    def __init__(self, rc: CKRenderContext):
        self.rc = rc


unported_methods(CKRenderedScene, 17, (
    "Draw", "Get3dEntities", "GetAmbientLight", "GetAttachedCamera",
    "GetBackgroundColor", "GetFogMode", "GetLights", "SetAmbientLight",
    "SetBackgroundColor"))
unported_methods(CKRenderManager, 17, (
    "AddTemporaryCallback", "AddTemporaryPostRenderCallback",
    "AddTemporaryPreRenderCallback", "ClearTemporaryCallbacks", "CreateNode",
    "CreateObjectIndex", "CreateVertexBuffer", "DeleteAllVertexBuffers",
    "DeleteNode", "DestroyVertexBuffer", "DestroyingDevice",
    "DetachAllObjects", "GetFullscreenContext", "GetMovedEntities",
    "GetRenderContextFromPoint", "GetRootNode", "GetValidFunctionsMask",
    "OnCKEnd", "OnCKPause", "PreClearAll", "RegisterDefaultEffects",
    "RegisterLastFrameEntity", "ReleaseObjectIndex",
    "ReleaseRenderContextMaskFree", "RemoveAllTemporaryCallbacks",
    "RemoveRenderContext", "RemoveTemporaryCallback", "SaveLastFrameMatrix",
    "SequenceAddedToScene", "SequenceDeleted", "SequenceRemovedFromScene",
    "SequenceToBeDeleted", "StartDeviceTrace", "StopDeviceTrace",
    "UnregisterLastFrameEntity"))
