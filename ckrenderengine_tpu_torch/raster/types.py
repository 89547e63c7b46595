"""Rasterizer enums and the per-draw render-state encoding.

Enum values follow the public D3D9/Virtools conventions the reference engine
uses (reference: the default-state table in CKRasterizerContext::
InitDefaultRenderStatesValue, src/CKRasterizer/CKRasterizerLib/
CKRasterizerContext.cpp:423-477 — e.g. ZFUNC default 4 = LESSEQUAL, SRCBLEND
default 2 = ONE, DESTBLEND default 1 = ZERO, CULLMODE default 3 = CCW,
SHADEMODE default 2 = GOURAUD).

TPU-first state design: the reference funnels hundreds of SetRenderState calls
through a value/valid cache per context. Here a draw batch carries
(a) a small device array `state_f`/`state_i` of per-state-bucket parameters and
(b) a per-triangle `state_idx`, so ONE kernel pass renders triangles of many
materials branchlessly — the "render-state cache" becomes data, not dispatch.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class VXCMP(enum.IntEnum):
    NEVER = 1
    LESS = 2
    EQUAL = 3
    LESSEQUAL = 4
    GREATER = 5
    NOTEQUAL = 6
    GREATEREQUAL = 7
    ALWAYS = 8


class VXBLEND(enum.IntEnum):
    ZERO = 1
    ONE = 2
    SRCCOLOR = 3
    INVSRCCOLOR = 4
    SRCALPHA = 5
    INVSRCALPHA = 6
    DESTALPHA = 7
    INVDESTALPHA = 8
    DESTCOLOR = 9
    INVDESTCOLOR = 10
    SRCALPHASAT = 11


class VXBLENDOP(enum.IntEnum):
    """Framebuffer blend op (D3DBLENDOP values; VXRENDERSTATE_BLENDOP in
    the reference's render-state table)."""
    ADD = 1
    SUBTRACT = 2          # src*sf - dst*df
    REVSUBTRACT = 3       # dst*df - src*sf
    MIN = 4
    MAX = 5


class VXCULL(enum.IntEnum):
    NONE = 1
    CW = 2
    CCW = 3


class VXSHADE(enum.IntEnum):
    FLAT = 1
    GOURAUD = 2
    PHONG = 3  # treated as GOURAUD (as DX9 fixed function does)


class VXFILL(enum.IntEnum):
    POINT = 1
    WIREFRAME = 2
    SOLID = 3


class VXFOG(enum.IntEnum):
    NONE = 0
    EXP = 1
    EXP2 = 2
    LINEAR = 3


class VXLIGHT(enum.IntEnum):
    POINT = 1
    SPOT = 2
    DIREC = 3


class VXTEXTURE_ADDRESS(enum.IntEnum):
    WRAP = 1
    MIRROR = 2
    CLAMP = 3
    BORDER = 4
    MIRRORONCE = 5


class VXTEXTURE_FILTER(enum.IntEnum):
    NEAREST = 1
    LINEAR = 2
    MIPNEAREST = 3
    MIPLINEAR = 4
    LINEARMIPNEAREST = 5
    LINEARMIPLINEAR = 6
    ANISOTROPIC = 7


class VXTEXTUREBLEND(enum.IntEnum):
    """Texture-stage map blend (CKRST_TSS_TEXTUREMAPBLEND values)."""
    DECAL = 1
    MODULATE = 2
    DECALALPHA = 3
    MODULATEALPHA = 4
    DECALMASK = 5
    MODULATEMASK = 6
    COPY = 7
    ADD = 8
    DOTPRODUCT3 = 9
    MAX = 10


class VXPRIMITIVE(enum.IntEnum):
    POINTLIST = 1
    LINELIST = 2
    LINESTRIP = 3
    TRIANGLELIST = 4
    TRIANGLESTRIP = 5
    TRIANGLEFAN = 6


# ---------------------------------------------------------------------------
# Render-state bucket: the per-draw-segment state vector
# ---------------------------------------------------------------------------

# Integer field indices in state_i (see RasterState.pack)
SI_SRCBLEND = 0
SI_DSTBLEND = 1
SI_ZFUNC = 2
SI_ZWRITE = 3
SI_ALPHABLEND = 4
SI_ALPHATEST = 5
SI_ALPHAFUNC = 6
SI_TEX = 7          # texture index, -1 = untextured
SI_TEXADDR = 8
SI_TEXFILTER = 9
SI_TEXBLEND = 10    # VXTEXTUREBLEND
SI_FOG = 11         # 0/1 vertex fog applied
SI_PERSPECTIVE = 12 # perspective-correct interpolation (default on)
SI_WRAP_U = 13      # D3D wrap-mode interpolation (VXRENDERSTATE_WRAP0 bit 0)
SI_WRAP_V = 14
SI_CULL = 15        # VXCULL; det(M) > 0 = front face (screen CW with y down)
SI_TEXGEN = 16      # TEXGEN_* vertex UV generation (material effects)
SI_COLORWRITE = 17  # 0 = z-only draw (VX_MOVEABLE_ZBUFONLY)
SI_STENCIL = 18     # 1 = stencil-mask draw (VX_MOVEABLE_STENCILONLY)
SI_TEX2 = 19        # secondary (bump) texture for EMBM, -1 = none
SI_BLENDOP = 20     # VXBLENDOP framebuffer blend op (default ADD)
NUM_SI = 21

# TexGen modes (material effects: TexGen/TexGenRef planar/reflection/chrome,
# reference src/CKMaterial.cpp:1302-1362, 1456+)
TEXGEN_NONE = 0
TEXGEN_PLANAR = 1     # uv from view-space position xy
TEXGEN_REFLECT = 2    # sphere-env uv from view-space reflection vector
TEXGEN_CHROME = 3     # sphere-env uv from view-space normal
TEXGEN_CUBE = 4       # octahedral-env uv from WORLD-space reflection vector

# Float field indices in state_f
SF_ALPHAREF = 0     # 0..1
SF_BORDER_R = 1
SF_BORDER_G = 2
SF_BORDER_B = 3
SF_BORDER_A = 4
SF_CONST_R = 5      # per-draw constant color (VXRENDERSTATE_TEXTUREFACTOR;
SF_CONST_G = 6      # DP3 effect encodes the object-space light dir here,
SF_CONST_B = 7      # reference src/CKMaterial.cpp:1880-1886)
SF_BUMP_SCALE = 8   # EMBM bump matrix scale (BumpMapEnvEffect default 2.0)
NUM_SF = 9

# Internal texture-blend mode (not a VXTEXTUREBLEND value): DOT3 of the
# sampled texel against the per-draw constant color instead of the diffuse
# (CKRST_TOP_DOTPRODUCT3 with ARG2 = TFACTOR, the DP3Effect stage setup,
# reference src/CKMaterial.cpp:1889-1892).
TEXBLEND_DOT3FACTOR = 64


@dataclasses.dataclass(frozen=True)
class RasterState:
    """One render-state bucket (roughly: material after SetAsCurrent,
    reference src/CKMaterial.cpp:1269-1438, minus vertex-stage-only states)."""

    src_blend: int = int(VXBLEND.ONE)
    dst_blend: int = int(VXBLEND.ZERO)
    z_func: int = int(VXCMP.LESSEQUAL)
    z_write: bool = True
    alpha_blend: bool = False
    alpha_test: bool = False
    alpha_func: int = int(VXCMP.ALWAYS)
    alpha_ref: float = 0.0
    tex: int = -1
    tex_address: int = int(VXTEXTURE_ADDRESS.WRAP)
    tex_filter: int = int(VXTEXTURE_FILTER.NEAREST)
    tex_blend: int = int(VXTEXTUREBLEND.MODULATEALPHA)
    fog: bool = False
    perspective: bool = True
    cull: int = int(VXCULL.CCW)
    border_color: tuple = (0.0, 0.0, 0.0, 0.0)
    texgen: int = 0
    color_write: bool = True
    stencil: bool = False
    tex2: int = -1
    const_color: tuple = (1.0, 1.0, 1.0)
    bump_scale: float = 0.0
    blend_op: int = 1              # VXBLENDOP.ADD

    def pack(self):
        si = np.zeros(NUM_SI, np.int32)
        sf = np.zeros(NUM_SF, np.float32)
        si[SI_SRCBLEND] = self.src_blend
        si[SI_DSTBLEND] = self.dst_blend
        si[SI_ZFUNC] = self.z_func
        si[SI_ZWRITE] = int(self.z_write)
        si[SI_ALPHABLEND] = int(self.alpha_blend)
        si[SI_ALPHATEST] = int(self.alpha_test)
        si[SI_ALPHAFUNC] = self.alpha_func
        si[SI_TEX] = self.tex
        si[SI_TEXADDR] = self.tex_address
        si[SI_TEXFILTER] = self.tex_filter
        si[SI_TEXBLEND] = self.tex_blend
        si[SI_FOG] = int(self.fog)
        si[SI_PERSPECTIVE] = int(self.perspective)
        si[SI_CULL] = self.cull
        si[SI_TEXGEN] = self.texgen
        si[SI_COLORWRITE] = int(self.color_write)
        si[SI_STENCIL] = int(self.stencil)
        si[SI_TEX2] = self.tex2
        si[SI_BLENDOP] = self.blend_op
        sf[SF_ALPHAREF] = self.alpha_ref
        sf[SF_BORDER_R:SF_BORDER_A + 1] = np.asarray(self.border_color, np.float32)
        sf[SF_CONST_R:SF_CONST_B + 1] = np.asarray(self.const_color, np.float32)
        sf[SF_BUMP_SCALE] = self.bump_scale
        return si, sf


def pack_states(states) -> tuple[np.ndarray, np.ndarray]:
    """List[RasterState] -> (S, NUM_SI) int32, (S, NUM_SF) float32."""
    if not states:
        states = [RasterState()]
    packed = [s.pack() for s in states]
    return np.stack([p[0] for p in packed]), np.stack([p[1] for p in packed])


@dataclasses.dataclass
class TriangleBatch:
    """A device-ready triangle stream for one raster pass.

    All arrays are padded to a static size T; `valid` masks real triangles.
    Coordinates are *screen-homogeneous*: (X, Y, W) where for clip coords
    (x, y, z, w): X = cx*w + x*halfW, Y = cy*w - y*halfH, W = w. A pixel center
    p=(px+.5, py+.5, 1) is inside iff the three adjoint edge functions have the
    sign of det — this is homogeneous rasterization and needs no near-plane
    geometric clipping (the per-pixel 1/w > 0 and 0 <= z <= 1 tests replace
    the reference's VXCLIP vertex flags at pixel granularity).
    """

    xyw: np.ndarray      # (T,3,3) f32 screen-homogeneous vertex coords
    z: np.ndarray        # (T,3)   f32 clip-space z (depth = z/w in [0,1])
    color: np.ndarray    # (T,3,4) f32 vertex diffuse RGBA (lit or prelit)
    specular: np.ndarray # (T,3,3) f32 vertex specular RGB (added post-texture)
    uv: np.ndarray       # (T,3,2) f32 texture coords
    fog: np.ndarray      # (T,3)   f32 per-vertex fog factor (1=no fog)
    state_idx: np.ndarray  # (T,) int32 index into packed state arrays
    valid: np.ndarray    # (T,) bool
    clipd: np.ndarray | None = None  # (T,3,P) user-clip-plane distances
