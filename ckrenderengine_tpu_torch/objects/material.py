"""CKMaterial: fixed-function material, lowered to a render-state bucket.

API mirror of RCKMaterial (include/RCKMaterial.h,
src/CKMaterial.cpp). The reference's SetAsCurrent "state compiler"
(src/CKMaterial.cpp:1269-1438) becomes :meth:`raster_state` +
:meth:`lighting_params`: the scene compiler packs these into per-draw-segment
state rows consumed branchlessly by the raster kernel.
"""

from __future__ import annotations

import numpy as np

from ..raster.types import (
    RasterState, VXBLEND, VXCMP, VXCULL, VXFILL, VXSHADE, VXTEXTUREBLEND,
    VXTEXTURE_ADDRESS, VXTEXTURE_FILTER,
)
from .base import CKCID_MATERIAL, CKContext, CKObject

# m_Flags bits (reference include/RCKMaterial.h:255-267 packed-flags encoding)
_FLAG_TWOSIDED = 1
_FLAG_PERSPECTIVE = 4
_FLAG_ALPHABLEND = 8
_FLAG_ALPHATEST = 0x10
_FLAG_ZWRITE = 0x20

# VX_EFFECT (public Virtools SDK; dispatched by the reference's SetAsCurrent
# effect switch, src/CKMaterial.cpp:1302-1362).
VXEFFECT_NONE = 0
VXEFFECT_TEXGEN = 1       # UV generation, mode in the effect parameter
VXEFFECT_TEXGENREF = 2    # UV generation relative to a reference entity
VXEFFECT_BUMPENV = 3      # EMBM: textures[1] perturbs an env map (BumpMapEnvEffect :1668)
VXEFFECT_DP3 = 4          # dot3 normal-map lighting (DP3Effect :1804)
VXEFFECT_2TEXTURES = 5    # single-pass 2-texture blend (BlendTexturesEffect :1924)
VXEFFECT_3TEXTURES = 6

# CKRST_TOP texture-stage ops (D3DTEXTUREOP values) accepted as effect
# blend-op parameters; lowered to framebuffer blends by effect_passes().
CKRST_TOP_SELECTARG1 = 2
CKRST_TOP_MODULATE = 4
CKRST_TOP_MODULATE2X = 5
CKRST_TOP_MODULATE4X = 6
CKRST_TOP_ADD = 7
CKRST_TOP_ADDSIGNED = 8
CKRST_TOP_SUBTRACT = 10
CKRST_TOP_BLENDTEXTUREALPHA = 13

# Stage op -> (src_blend, dst_blend, blend_op) multi-pass equivalent.
# SUBTRACT is exact via the REVSUBTRACT framebuffer op (dst - src);
# ADDSIGNED (dst + tex - 0.5) is exact as ADD plus a flat -0.5 bias pass
# (REVSUBTRACT of constant gray) appended by effect_passes().
from ..raster.types import VXBLENDOP as _VXBLENDOP
_OP_ADD = int(_VXBLENDOP.ADD)
_OP_TO_BLENDS = {
    CKRST_TOP_SELECTARG1: (int(VXBLEND.ONE), int(VXBLEND.ZERO), _OP_ADD),
    CKRST_TOP_MODULATE: (int(VXBLEND.DESTCOLOR), int(VXBLEND.ZERO), _OP_ADD),
    CKRST_TOP_MODULATE2X: (int(VXBLEND.DESTCOLOR), int(VXBLEND.SRCCOLOR),
                           _OP_ADD),
    CKRST_TOP_MODULATE4X: (int(VXBLEND.DESTCOLOR), int(VXBLEND.SRCCOLOR),
                           _OP_ADD),
    CKRST_TOP_ADD: (int(VXBLEND.ONE), int(VXBLEND.ONE), _OP_ADD),
    CKRST_TOP_ADDSIGNED: (int(VXBLEND.ONE), int(VXBLEND.ONE), _OP_ADD),
    CKRST_TOP_SUBTRACT: (int(VXBLEND.ONE), int(VXBLEND.ONE),
                         int(_VXBLENDOP.SUBTRACT)),
    CKRST_TOP_BLENDTEXTUREALPHA: (int(VXBLEND.SRCALPHA),
                                  int(VXBLEND.INVSRCALPHA), _OP_ADD),
}


class CKMaterial(CKObject):
    CLASS_ID = CKCID_MATERIAL

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        # Lighting colors (D3DMATERIAL9 defaults the reference uses).
        self.diffuse = np.array([0.7, 0.7, 0.7, 1.0], np.float32)
        self.ambient = np.array([0.3, 0.3, 0.3, 1.0], np.float32)
        self.specular = np.array([0.5, 0.5, 0.5, 1.0], np.float32)
        self.emissive = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
        self.power = 0.0
        # Modes.
        self.shade_mode = int(VXSHADE.GOURAUD)
        self.fill_mode = int(VXFILL.SOLID)
        self.src_blend = int(VXBLEND.ONE)
        self.dst_blend = int(VXBLEND.ZERO)
        self.z_func = int(VXCMP.LESSEQUAL)
        self.alpha_func = int(VXCMP.ALWAYS)
        self.alpha_ref = 0
        self.textures = [None, None, None, None]
        self.texture_blend_mode = int(VXTEXTUREBLEND.MODULATEALPHA)
        self.texture_min_mode = int(VXTEXTURE_FILTER.LINEAR)
        self.texture_mag_mode = int(VXTEXTURE_FILTER.LINEAR)
        self.texture_address_mode = int(VXTEXTURE_ADDRESS.WRAP)
        self.texture_border_color = np.zeros(4, np.float32)
        self._flags = _FLAG_ZWRITE | _FLAG_PERSPECTIVE
        self.effect = 0
        self.effect_parameter: dict = {}
        self.callback = None

    # -- colors -----------------------------------------------------------
    def SetDiffuse(self, rgba):
        self.diffuse = np.asarray(rgba, np.float32)
        self.context._bump_appearance()

    def GetDiffuse(self):
        return self.diffuse.copy()

    def SetAmbient(self, rgba):
        self.ambient = np.asarray(rgba, np.float32)
        self.context._bump_appearance()

    def GetAmbient(self):
        return self.ambient.copy()

    def SetSpecular(self, rgba):
        self.specular = np.asarray(rgba, np.float32)
        self.context._bump_appearance()

    def GetSpecular(self):
        return self.specular.copy()

    def SetEmissive(self, rgba):
        self.emissive = np.asarray(rgba, np.float32)
        self.context._bump_appearance()

    def GetEmissive(self):
        return self.emissive.copy()

    def SetPower(self, p: float):
        self.power = float(p)
        self.context._bump_appearance()

    def GetPower(self) -> float:
        return self.power

    # -- flags ------------------------------------------------------------
    def _set_flag(self, bit: int, on: bool):
        if on:
            self._flags |= bit
        else:
            self._flags &= ~bit
        self.context._bump_topology()  # blend on/off changes pass assignment

    def EnableAlphaBlend(self, on: bool = True):
        self._set_flag(_FLAG_ALPHABLEND, on)

    def AlphaBlendEnabled(self) -> bool:
        return bool(self._flags & _FLAG_ALPHABLEND)

    def EnableAlphaTest(self, on: bool = True):
        self._set_flag(_FLAG_ALPHATEST, on)

    def AlphaTestEnabled(self) -> bool:
        return bool(self._flags & _FLAG_ALPHATEST)

    def EnableZWrite(self, on: bool = True):
        self._set_flag(_FLAG_ZWRITE, on)

    def ZWriteEnabled(self) -> bool:
        return bool(self._flags & _FLAG_ZWRITE)

    def EnablePerspectiveCorrection(self, on: bool = True):
        self._set_flag(_FLAG_PERSPECTIVE, on)

    def PerspectiveCorrectionEnabled(self) -> bool:
        return bool(self._flags & _FLAG_PERSPECTIVE)

    def SetTwoSided(self, on: bool = True):
        self._set_flag(_FLAG_TWOSIDED, on)

    def IsTwoSided(self) -> bool:
        return bool(self._flags & _FLAG_TWOSIDED)

    # -- blend / compare --------------------------------------------------
    def SetSourceBlend(self, mode: int):
        self.src_blend = int(mode)
        self.context._bump_appearance()

    def GetSourceBlend(self) -> int:
        return self.src_blend

    def SetDestBlend(self, mode: int):
        self.dst_blend = int(mode)
        self.context._bump_appearance()

    def GetDestBlend(self) -> int:
        return self.dst_blend

    def SetZFunc(self, func: int):
        self.z_func = int(func)
        # Changes deferred-vs-ordered classification -> recompile scene.
        self.context._bump_topology()

    def GetZFunc(self) -> int:
        return self.z_func

    def SetAlphaFunc(self, func: int):
        self.alpha_func = int(func)
        self.context._bump_appearance()

    def GetAlphaFunc(self) -> int:
        return self.alpha_func

    def SetAlphaRef(self, ref: int):
        self.alpha_ref = int(ref)
        self.context._bump_appearance()

    def GetAlphaRef(self) -> int:
        return self.alpha_ref

    def SetShadeMode(self, mode: int):
        self.shade_mode = int(mode)
        self.context._bump_appearance()

    def GetShadeMode(self) -> int:
        return self.shade_mode

    def SetFillMode(self, mode: int):
        self.fill_mode = int(mode)
        self.context._bump_appearance()

    def GetFillMode(self) -> int:
        return self.fill_mode

    # -- textures ---------------------------------------------------------
    def SetTexture(self, texture, slot: int = 0):
        self.textures[slot] = texture
        self.context._bump_topology()

    def SetTexture0(self, texture):
        self.SetTexture(texture, 0)

    def GetTexture(self, slot: int = 0):
        return self.textures[slot]

    def SetTextureBlendMode(self, mode: int):
        self.texture_blend_mode = int(mode)
        self.context._bump_appearance()

    def GetTextureBlendMode(self) -> int:
        return self.texture_blend_mode

    def SetTextureAddressMode(self, mode: int):
        self.texture_address_mode = int(mode)
        self.context._bump_appearance()

    def GetTextureAddressMode(self) -> int:
        return self.texture_address_mode

    def SetTextureMinMode(self, mode: int):
        self.texture_min_mode = int(mode)
        self.context._bump_appearance()

    def SetTextureMagMode(self, mode: int):
        self.texture_mag_mode = int(mode)
        self.context._bump_appearance()

    def SetTextureBorderColor(self, rgba):
        self.texture_border_color = np.asarray(rgba, np.float32)
        self.context._bump_appearance()

    def SetEffect(self, effect: int):
        self.effect = int(effect)
        self.context._bump_topology()

    def GetEffect(self) -> int:
        return self.effect

    def SetEffectParameter(self, **params):
        """Effect parameters (the reference reads these from a CKParameter
        struct, src/CKMaterial.cpp:1311-1346,1677-1713). Accepted keys:
        texgen (TEXGEN_* mode for TEXGEN/TEXGENREF/BUMPENV), ref_entity,
        op / op2 (CKRST_TOP_* blend op for 2/3TEXTURES), bump_scale (offset
        added to the 2.0 default), light (CKLight or CK3dEntity for DP3)."""
        self.effect_parameter.update(params)
        self.context._bump_topology()

    def GetEffectParameter(self) -> dict:
        return self.effect_parameter

    # -- API-surface parity batch (reference include/RCKMaterial.h) --------
    def GetTextureMinMode(self) -> int:
        return self.texture_min_mode

    def GetTextureMagMode(self) -> int:
        return self.texture_mag_mode

    def GetTextureBorderColor(self):
        return tuple(np.asarray(self.texture_border_color).tolist())

    def GetCallback(self):
        return self.callback

    def SetAsCurrent(self, rc, lit: bool = True, texture_stage: int = 0):
        """Make this material the current immediate-mode state (reference
        RCKMaterial::SetAsCurrent, src/CKMaterial.cpp:1269 — the render-state
        compiler; here it binds the material to the context's user
        DrawPrimitive path)."""
        rc.SetCurrentMaterial(self)
        return True

    # -- per-state-group appliers (reference RCKMaterial private helpers
    # AlphaBlend/AlphaTest/AlphaFunc/ZFunc/ZWrite/TwoSided/
    # PerspectiveCorrection — each pushes ONE state group of SetAsCurrent
    # to the device; here they write the context's immediate-mode
    # RasterState used by user DrawPrimitive when no material is bound) ----
    def _dp_state_of(self, rc):
        from ..raster.types import RasterState
        if getattr(rc, "_dp_state", None) is None:
            rc._dp_state = RasterState()
        return rc._dp_state

    def AlphaBlend(self, rc):
        import dataclasses
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc), alpha_blend=self.AlphaBlendEnabled(),
            src_blend=self.GetSourceBlend(), dst_blend=self.GetDestBlend())

    def AlphaTest(self, rc):
        import dataclasses
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc), alpha_test=self.AlphaTestEnabled(),
            alpha_ref=self.GetAlphaRef() / 255.0)

    def AlphaFunc(self, rc):
        import dataclasses
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc), alpha_func=self.GetAlphaFunc())

    def ZFunc(self, rc):
        import dataclasses
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc), z_func=self.GetZFunc())

    def ZWrite(self, rc):
        import dataclasses
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc), z_write=self.ZWriteEnabled())

    def TwoSided(self, rc):
        import dataclasses
        from ..raster.types import VXCULL
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc),
            cull=int(VXCULL.NONE) if self.IsTwoSided() else int(VXCULL.CCW))

    def PerspectiveCorrection(self, rc):
        import dataclasses
        rc._dp_state = dataclasses.replace(
            self._dp_state_of(rc),
            perspective=self.PerspectiveCorrectionEnabled())

    # -- Sprite3D batch ownership (reference AddSprite3DBatch /
    # GetSprite3DBatch / FlushSprite3DBatch, include/RCKMaterial.h — the
    # material owns the per-frame billboard batch buffer; the TPU build
    # expands ALL sprites in one device step, so the batch list is the
    # host-visible staging view) ------------------------------------------
    def AddSprite3DBatch(self, sprite) -> int:
        if not hasattr(self, "_sprite3d_batch"):
            self._sprite3d_batch = []
        self._sprite3d_batch.append(sprite)
        return len(self._sprite3d_batch)

    def GetSprite3DBatch(self) -> list:
        return list(getattr(self, "_sprite3d_batch", []))

    def FlushSprite3DBatch(self):
        self._sprite3d_batch = []

    def SetCallback(self, fct, arg=None):
        self.callback = (fct, arg) if fct else None

    # -- classification ---------------------------------------------------
    def IsAlphaTransparent(self) -> bool:
        """True transparency rule (reference src/CKMaterial.cpp:2066-2077,
        locked by tests/test_material.cpp): alpha-blend on AND dest blend not
        ZERO AND NOT a depth-writing alpha-test cutout."""
        if not self.AlphaBlendEnabled() or self.dst_blend == VXBLEND.ZERO:
            return False
        if self.AlphaTestEnabled() and self.ZWriteEnabled():
            return False
        return True

    # -- lowering (SetAsCurrent equivalent) -------------------------------
    def raster_state(self, texture_slot: int = -1, lit: bool = True,
                     fog: bool = False) -> RasterState:
        """Lower to the per-draw state bucket (the data that in the reference
        flows through SetAsCurrent's SetRenderState calls)."""
        mag = self.texture_mag_mode
        return RasterState(
            src_blend=self.src_blend if self.AlphaBlendEnabled() else int(VXBLEND.ONE),
            dst_blend=self.dst_blend if self.AlphaBlendEnabled() else int(VXBLEND.ZERO),
            z_func=self.z_func,
            z_write=self.ZWriteEnabled(),
            alpha_blend=self.AlphaBlendEnabled(),
            alpha_test=self.AlphaTestEnabled(),
            alpha_func=self.alpha_func,
            alpha_ref=self.alpha_ref / 255.0,
            tex=texture_slot,
            tex_address=self.texture_address_mode,
            tex_filter=mag,
            tex_blend=self.texture_blend_mode,
            fog=fog,
            perspective=self.PerspectiveCorrectionEnabled(),
            cull=int(VXCULL.NONE) if self.IsTwoSided() else int(VXCULL.CCW),
            border_color=tuple(float(c) for c in self.texture_border_color),
            texgen=self._effect_texgen(),
        )

    def _effect_texgen(self) -> int:
        """Vertex TexGen mode of the BASE pass (reference TexGenEffect,
        src/CKMaterial.cpp:1456+). VXEFFECT_TEXGEN defaults to planar,
        VXEFFECT_TEXGENREF to reflection; the `texgen` effect parameter
        (TEXGEN_PLANAR/REFLECT/CHROME/CUBE) overrides either."""
        from ..raster.types import TEXGEN_NONE, TEXGEN_PLANAR, TEXGEN_REFLECT

        eff = self.GetEffect()
        if eff not in (VXEFFECT_TEXGEN, VXEFFECT_TEXGENREF):
            return TEXGEN_NONE
        default = TEXGEN_PLANAR if eff == VXEFFECT_TEXGEN else TEXGEN_REFLECT
        return int(self.effect_parameter.get("texgen", default))

    def effect_passes(self) -> list:
        """Extra draw passes synthesized from multi-texture effects
        (reference BumpMapEnvEffect/DP3Effect/BlendTexturesEffect,
        src/CKMaterial.cpp:1668-2060 — single-pass stage setups there;
        lowered to blended passes over the base draw here, the same
        degradation the reference applies on single-stage hardware).

        Each entry: dict(slot, texgen, src_blend, dst_blend, tex_blend,
        dp3, bump_slot, bump_scale, ref_entity)."""
        from ..raster.types import (
            TEXBLEND_DOT3FACTOR, TEXGEN_NONE, TEXGEN_REFLECT, VXTEXTUREBLEND,
        )

        eff = self.GetEffect()
        p = self.effect_parameter
        passes = []

        def bias_pass():
            # flat  -0.5  pass completing an exact ADDSIGNED
            # (dst + tex - 0.5): constant gray via a 1x1 texture,
            # REVSUBTRACT framebuffer op.
            return dict(
                slot=-1, texgen=TEXGEN_NONE,
                src_blend=int(VXBLEND.ONE), dst_blend=int(VXBLEND.ONE),
                blend_op=int(_VXBLENDOP.REVSUBTRACT),
                tex_blend=int(VXTEXTUREBLEND.COPY), dp3=False,
                bump_slot=-1, bump_scale=0.0, ref_entity=None,
                bias_tex=self._bias_texture(),
            )

        if eff == VXEFFECT_DP3 and self.textures[1] is not None:
            # Pass: normal map dotted with the object-space light dir
            # (state-bank constant), modulating the base (DESTCOLOR, ZERO).
            passes.append(dict(
                slot=1, texgen=TEXGEN_NONE,
                src_blend=int(VXBLEND.DESTCOLOR), dst_blend=int(VXBLEND.ZERO),
                blend_op=_OP_ADD,
                tex_blend=TEXBLEND_DOT3FACTOR, dp3=True,
                bump_slot=-1, bump_scale=0.0,
                ref_entity=p.get("light"), bias_tex=None,
            ))
        elif eff == VXEFFECT_BUMPENV and self.textures[2] is not None:
            # Pass: env map (textures[2]) with EMBM perturbation from the
            # bump map (textures[1]); ADDSIGNED over the base by default.
            op = int(p.get("op", CKRST_TOP_ADDSIGNED))
            sb, db, bop = _OP_TO_BLENDS.get(
                op, _OP_TO_BLENDS[CKRST_TOP_ADDSIGNED])
            passes.append(dict(
                slot=2, texgen=int(p.get("texgen", TEXGEN_REFLECT)),
                src_blend=sb, dst_blend=db, blend_op=bop,
                tex_blend=int(VXTEXTUREBLEND.COPY), dp3=False,
                bump_slot=1, bump_scale=2.0 + float(p.get("bump_scale", 0.0)),
                ref_entity=p.get("ref_entity"), bias_tex=None,
            ))
            if op == CKRST_TOP_ADDSIGNED:
                passes.append(bias_pass())
        elif eff in (VXEFFECT_2TEXTURES, VXEFFECT_3TEXTURES):
            for slot, op_key, tg_key in ((1, "op", "texgen"),
                                         (2, "op2", "texgen2")):
                if self.textures[slot] is None:
                    continue
                if slot == 2 and eff != VXEFFECT_3TEXTURES:
                    continue
                op = int(p.get(op_key, CKRST_TOP_MODULATE))
                sb, db, bop = _OP_TO_BLENDS.get(
                    op, _OP_TO_BLENDS[CKRST_TOP_MODULATE])
                passes.append(dict(
                    slot=slot, texgen=int(p.get(tg_key, TEXGEN_NONE)),
                    src_blend=sb, dst_blend=db, blend_op=bop,
                    tex_blend=int(VXTEXTUREBLEND.COPY), dp3=False,
                    bump_slot=-1, bump_scale=0.0,
                    ref_entity=p.get("ref_entity"), bias_tex=None,
                ))
                if op == CKRST_TOP_ADDSIGNED:
                    passes.append(bias_pass())
        return passes

    def _bias_texture(self):
        """Lazily created 1x1 mid-gray texture powering the ADDSIGNED bias
        pass."""
        tex = getattr(self, "_addsigned_bias_tex", None)
        if tex is None:
            from .texture import CKTexture
            tex = CKTexture(self.context, f"{self.name}__addsigned_bias")
            img = np.full((1, 1, 4), 0.5, np.float32)
            img[..., 3] = 0.0               # leave fb alpha untouched
            tex.SetImage(img)
            self._addsigned_bias_tex = tex
        return tex

    # -- reference-named effect entry points (reference TexGenEffect /
    # DP3Effect / BumpMapEnvEffect / BlendTexturesEffect,
    # src/CKMaterial.cpp:1456-2060 — stage setups there; pass descriptors
    # here, consumed by the scene compiler's effect-pass lowering) ---------
    def Effect(self) -> int:
        return self.GetEffect()

    def TexGenEffect(self) -> int:
        """The base pass's vertex TexGen mode."""
        return self._effect_texgen()

    def DP3Effect(self):
        """The DOT3 pass descriptor, or None when not a DP3 material."""
        return next((d for d in self.effect_passes() if d["dp3"]), None)

    def BumpMapEnvEffect(self):
        """The EMBM env pass descriptor, or None."""
        return next((d for d in self.effect_passes()
                     if d["bump_slot"] >= 0), None)

    def BlendTexturesEffect(self) -> list:
        """The 2/3-texture blend pass descriptors."""
        if self.GetEffect() not in (VXEFFECT_2TEXTURES, VXEFFECT_3TEXTURES):
            return []
        return self.effect_passes()

    # -- channel-render state patching (reference PatchForChannelRender /
    # RestoreAfterChannelRender: when drawn as a mesh CHANNEL the
    # material's blends are overridden by the channel blends) --------------
    def PatchForChannelRender(self, src_blend: int, dst_blend: int):
        self._channel_saved = (self.GetSourceBlend(), self.GetDestBlend(),
                               self.AlphaBlendEnabled())
        self.SetSourceBlend(int(src_blend))
        self.SetDestBlend(int(dst_blend))
        self.EnableAlphaBlend(True)

    def RestoreAfterChannelRender(self):
        saved = getattr(self, "_channel_saved", None)
        if saved is None:
            return
        self.SetSourceBlend(saved[0])
        self.SetDestBlend(saved[1])
        self.EnableAlphaBlend(saved[2])
        self._channel_saved = None

    def lighting_params(self):
        return dict(
            diffuse=self.diffuse, ambient=self.ambient, specular=self.specular,
            emissive=self.emissive,
            power=self.power if self.power > 0.05 else 0.0,
        )
