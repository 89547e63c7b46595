"""Shared render-layer types: CK_RENDER_* flags, the CompiledScene
stream bundle, VxStats counters, and material-effect descriptions —
carried from the reference package's objects/rendertypes.py.
Reference: CK_RENDER_* flags include/CKRenderEngineTypes.h; VxStats
include/CKRasterizerTypes.h:63-69; effects registry RCKRenderManager.
"""

from __future__ import annotations

import time

import numpy as np

from ..pipeline import frame as fr
from ..pipeline.lighting import LightArray
from ..raster.types import RasterState, pack_states, NUM_SF, NUM_SI, VXFOG
from ..scene import entity_table as et
from .base import (
    CKCID_LIGHT, CKCID_RENDERCONTEXT, CKCID_TARGETLIGHT, CKContext, CKObject,
)
from .camera import CKCamera, CKTargetCamera
from .entity import CK3dEntity
from .light import CKLight
from .material import CKMaterial

# CK_RENDER_FLAGS (public Virtools SDK VxDefines.h values; stored on the
# context as m_RenderFlags, reference src/CKRenderContext.cpp:2555,
# resolved per-Render by ResolveRenderFlags :222-229).
CK_RENDER_BACKGROUNDSPRITES = 0x0001
CK_RENDER_FOREGROUNDSPRITES = 0x0002
CK_RENDER_USECAMERARATIO = 0x0004
CK_RENDER_CLEARZBUFFER = 0x0008
CK_RENDER_CLEARBACKBUFFER = 0x0010
CK_RENDER_CLEARSTENCILBUFFER = 0x0020
CK_RENDER_DOBACKTOFRONT = 0x0040
CK_RENDER_DEFAULTSETTINGS = (
    CK_RENDER_BACKGROUNDSPRITES | CK_RENDER_FOREGROUNDSPRITES
    | CK_RENDER_USECAMERARATIO | CK_RENDER_CLEARZBUFFER
    | CK_RENDER_CLEARBACKBUFFER | CK_RENDER_DOBACKTOFRONT)
CK_RENDER_CLEARVIEWPORT = 0x0100
CK_RENDER_WAITVBL = 0x0200
CK_RENDER_PLAYERCONTEXT = 0x0400
CK_RENDER_DONOTUPDATEEXTENTS = 0x0800
CK_RENDER_OPTIONSMASK = 0xFFFF
CK_RENDER_USECURRENTSETTINGS = 0x0000


def _pad_to(n: int, mult: int = 128) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


import dataclasses as _dc


@_dc.dataclass
class VxEffectDescription:
    """Effect registry entry (reference VxEffectDescription; registered via
    RCKRenderManager::AddEffect, src/CKRenderManager.cpp:729).

    ``set_callback(rc, material, stage, arg)`` runs at scene compile for
    materials whose effect code matches this entry; it returns a list of
    effect-pass descriptors (the dict schema of
    CKMaterial.effect_passes) or None."""

    summary: str = ""
    description: str = ""
    max_texture_count: int = 0
    needed_texture_coords: int = 0
    parameter_description: str = ""
    set_callback: object = None
    callback_arg: object = None


def _mip_chain(img: np.ndarray, t, levels: int):
    """Yield (level, nh, nw, y_off, array) for levels 1..levels-1 —
    box-filtered (or user-provided) mip images, matching the stack layout
    rule (level L at rows [y_off, y_off+nh) of the texture's mip column)."""
    cur = np.asarray(img, np.float32)
    h = cur.shape[0]
    lh, lw = cur.shape[0], cur.shape[1]
    for lv in range(1, levels):
        user = (t.user_mip_levels[lv - 1]
                if len(t.user_mip_levels) >= lv else None)
        nh, nw = max(lh // 2, 1), max(lw // 2, 1)
        if user is not None and user.shape[:2] == (nh, nw):
            cur = np.asarray(user, np.float32)
        else:
            cur = cur[: nh * 2, : nw * 2].reshape(
                nh, 2, nw, 2, 4).mean(axis=(1, 3))
        y_off = 0 if lv == 1 else h - (h >> (lv - 1))
        yield lv, nh, nw, y_off, cur
        lh, lw = nh, nw


class CompiledScene:
    """Static layout of one render context's scene (host-side product of
    compilation; the analogue of all CreateRenderGroups/CKVBuffer remaps +
    scene-graph ordering flattened into arrays)."""

    def __init__(self):
        self.topology_version = -1
        # pool
        self.positions = np.zeros((0, 3), np.float32)
        self.normals = np.zeros((0, 3), np.float32)
        self.uv = np.zeros((0, 2), np.float32)
        self.prelit = np.zeros((0, 4), np.float32)
        self.prelit_spec = np.zeros((0, 3), np.float32)
        # instanced stream
        self.src_idx = np.zeros(0, np.int32)
        self.vert_entity = np.zeros(0, np.int32)
        self.vert_state = np.zeros(0, np.int32)
        self.vert_lit = np.zeros(0, bool)
        self.tri_idx = np.zeros((0, 3), np.int32)
        self.tri_state = np.zeros(0, np.int32)
        self.tri_valid = np.zeros(0, bool)
        # Faces dropped at compile by the conservative alpha-test pre-gate
        # (provably-failing alpha tests never enter the stream).
        self.atest_pregated = 0
        # buckets: (material, is_sprite) — sprite buckets force cull off
        self.materials: list[tuple] = []
        self.textures: list = []
        self.tex_slot: dict[int, int] = {}
        self._tex_version = -1
        self.levels: tuple = ()
        self.n_entities = 0
        self.entity_rows = np.zeros(0, np.int32)  # scene entity -> table row
        # Static cap on triangles taking the ordered (sequential) raster path.
        self.ordered_cap = 0
        # Device skin bank (None when no entity has a skin).
        self.skin_bank = None
        # Ordered mesh sources of the vertex pool (per-frame dynamic refresh).
        self.pool_sources: list = []
        self._pool_version = -1
        # Sprite3D billboards: (entity, pool_base, bucket) per sprite.
        self.sprite3d_list: list = []
        # Line segments (stream-index pairs + colors) and their device bank.
        self.line_segments: list = []
        self.line_bank = None
        # Cached device arrays (uploaded once per compile / pool refresh).
        self._dev_static: dict | None = None
        self._dev_pool: dict | None = None
        self._dev_pool_version = -2
        # Extra pool rows appended after mesh sources (billboard corners).
        self.extra_pool = 0
        # Corner-major section (gather-elimination post-pass): first
        # corner_itc triangles read their vertex data from the dense
        # corner-expanded pool block at [corner_p0, corner_p0 + corner_nc).
        self.corner_nc = 0
        self.corner_itc = 0
        self.corner_p0 = 0
        self.corner_src_pool = np.zeros(0, np.int32)
        # Any stencil-only buckets? (drives the optional stencil pass)
        self.has_stencil = False


class VxStats:
    """Frame statistics (reference VxStats / CKRasterizerStats,
    include/CKRasterizerTypes.h:63-69)."""

    def __init__(self):
        self.NbTrianglesDrawn = 0
        self.NbPointsDrawn = 0
        self.NbLinesDrawn = 0
        self.NbVerticesProcessed = 0
        self.NbObjectDrawn = 0
        # Densest raster tile's triangle count last frame (tiled scale path;
        # observability only — the streaming reduce is exact, raster/tiled.py).
        # Populated under EnableDebugMode (avoids a per-frame device readback).
        self.TileBinPeak = 0
        # Peel path reported phase-A capacity overflow this frame (per-pixel
        # depth iterates, so this is the only overflow class). The frame
        # then replays the exact sequential ordered pass itself: the flag
        # means "this frame cost extra time", never pixels.
        self.OrderedPeelOverflow = False
        # Number of peel frames corrected that way.
        self.OrderedPeelCorrected = 0
        # Number of frames whose ordered kernel (blend or peel) overflowed
        # and replayed the exact tiled ordered pass.
        self.OrderedReplays = 0
        # Peel rounds the last sampled frame executed (1 = every pixel's
        # fragment list fit one K-layer window; the alpha-test pre-gate and
        # the K bump exist to keep this at 1).
        self.OrderedPeelRounds = 0
        # Capacity governor (tiled solve): live binned pairs, exact
        # fallback rows beyond the governed caps (nonzero = the caps are
        # bumping), and the bump and shrink counts. Sampled by every eager
        # frame and every window (the worst frame of a window counts).
        self.SolveLivePairs = 0
        self.SolveFallbackRows = 0
        self.SolveCapBumps = 0
        self.SolveCapShrinks = 0
        # Stereo took the eager fallback (a no-clear frame or a
        # render-to-texture feed forces it; it stays set, as in the
        # reference): each eye renders from the clear colour, at 1x.
        self.StereoEagerFallback = False
        self.RenderStateCacheHit = 0
        self.RenderStateCacheMiss = 0
        self.SmoothedFps = 0.0
        self.FrameTime = 0.0
        self.SceneTraversalTime = 0.0
        self.ObjectsRenderTime = 0.0
        self.ObjectsCallbacksTime = 0.0
        self.SkinTime = 0.0
        self.SpriteTime = 0.0
        self.TransparentObjectsSortTime = 0.0


