"""CKRenderManager (reference RCKRenderManager, src/CKRenderManager.cpp).

Shared render types live in .rendertypes and the context in .rendercontext;
this module re-exports both, like the reference package's manager module.
Context batching (``ProcessBatched``) is not carried yet and raises.
"""

from .rendertypes import *          # noqa: F401,F403
from .rendertypes import (          # noqa: F401
    _pad_to, _mip_chain, CompiledScene, VxStats, VxEffectDescription,
)
from .rendercontext import CKRenderContext    # noqa: F401
from ..roadmap import unported


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
        raise unported("ProcessBatched (batched contexts)", 12)

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

    def SetRenderOptions(self, name: str, value):
        self.options[name] = value

    def GetRenderOptions(self, name: str):
        return self.options.get(name)
