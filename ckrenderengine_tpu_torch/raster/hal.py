"""Rasterizer HAL: the three abstract-device classes as a working facade.

The counterpart of ``ckrenderengine_tpu.raster.hal``. The reference engine's
hardware-abstraction layer is three classes (include/CKRasterizer.h):
``CKRasterizer`` (shared object-index allocator + driver list, :69-112),
``CKRasterizerDriver`` (caps + context factory, :125-150) and
``CKRasterizerContext`` (clear/scene bracket, lights, material, viewport,
transforms, render-state cache, textures/sprites/VB/IB, DrawPrimitive*,
TransformVertices, ComputeBoxVisibility; :201-519). The engine above
renders through its frame program instead, but the HAL surface itself is a
real, drawable device here: a context's fb/zb live on the rasterizer's
device, and each draw lands on them through ``raster.torch_backend
.render_pass``, as the reference's HAL draws through its
``jax_backend.render_pass``.

The device is explicit: ``CKRasterizer(device="cuda")`` (the default)
raises where CUDA is not available, and every context of its drivers
allocates on it. The vertex work of a draw (the local-to-clip transform,
fixed-function lighting, strip and fan indices, the padded batch) is host
numpy float32, as in the reference, so both packages hand ``render_pass``
the same batch. Textures and sprites go to the device once, when they are
loaded; a framebuffer copy (``CopyToTexture``, ``DrawSprite``, the screen
backup) stays on it. The getters that return numpy (``BackToFront``,
``GetTextureData``, ...) copy to the host.

The NULL-rasterizer role (headless fake with safe defaults, reference
CKRasterizerLib/CKRasterizer.cpp:17-66) is this module with default caps.
"""

from __future__ import annotations

import enum
import os

import numpy as np
import torch

from .caps import (Vx3DCapsDesc, apply_driver_problems, enumerate_drivers,
                   load_video_card_file)
from .types import RasterState, VXBLEND, VXCMP, VXCULL, VXPRIMITIVE

# -- object kinds (reference CKRST_OBJECTTYPE, CKRasterizerEnums.h:114-121) --
CKRST_OBJ_TEXTURE = 0x01
CKRST_OBJ_SPRITE = 0x02
CKRST_OBJ_VERTEXBUFFER = 0x04
CKRST_OBJ_INDEXBUFFER = 0x08
CKRST_OBJ_VERTEXSHADER = 0x10
CKRST_OBJ_PIXELSHADER = 0x20
CKRST_OBJ_ALL = 0x3F
_KIND_BITS = (CKRST_OBJ_TEXTURE, CKRST_OBJ_SPRITE, CKRST_OBJ_VERTEXBUFFER,
              CKRST_OBJ_INDEXBUFFER, CKRST_OBJ_VERTEXSHADER,
              CKRST_OBJ_PIXELSHADER)

# -- clear flags (reference CKRST_CTXCLEAR_FLAGS) ---------------------------
CKRST_CTXCLEAR_COLOR = 1
CKRST_CTXCLEAR_DEPTH = 2
CKRST_CTXCLEAR_STENCIL = 4
CKRST_CTXCLEAR_ALL = 7

# -- transform slots --------------------------------------------------------
VXMATRIX_WORLD = 0
VXMATRIX_VIEW = 1
VXMATRIX_PROJECTION = 2
VXMATRIX_TEXTURE0 = 3


class VXRENDERSTATE(enum.IntEnum):
    """Render-state ids (VxMath VXRENDERSTATETYPE — D3D9-aligned values,
    the numbering the reference's state table indexes by)."""
    FILLMODE = 8
    SHADEMODE = 9
    ZWRITEENABLE = 14
    ALPHATESTENABLE = 15
    SRCBLEND = 19
    DESTBLEND = 20
    CULLMODE = 22
    ZFUNC = 23
    ALPHAREF = 24
    ALPHAFUNC = 25
    DITHERENABLE = 26
    ALPHABLENDENABLE = 27
    FOGENABLE = 28
    SPECULARENABLE = 29
    FOGCOLOR = 34
    FOGSTART = 36
    FOGEND = 37
    FOGDENSITY = 38
    ZENABLE = 7
    LIGHTING = 137
    AMBIENT = 139
    TEXTUREFACTOR = 60
    WRAP0 = 128
    CLIPPING = 136
    NORMALIZENORMALS = 143


RENDERSTATE_MAXSTATE = 256

# state-cache flags (reference include/CKRasterizer.h:524-575)
RSC_VALID = 1
RSC_LOCKED = 2


def _device(device) -> torch.device:
    """``device`` as a torch device; raises for CUDA where it is not
    available (never a silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CKRasterizer(device='cuda'): CUDA is not available; pass "
            "device='cpu' to draw on the CPU")
    return device


def _rgb(packed: int) -> list[float]:
    """0xAARRGGBB -> [r, g, b] in [0, 1]."""
    return [(packed >> 16 & 0xFF) / 255.0, (packed >> 8 & 0xFF) / 255.0,
            (packed & 0xFF) / 255.0]


class CKRasterizer:
    """Driver list + SHARED object-index allocator (reference
    CKRasterizer.cpp:68-103: one byte-mask slot table across all linked
    rasterizers; per-kind first-free cursors). ``device``: where every
    context of its drivers keeps its planes and draws."""

    def __init__(self, device: "str | torch.device" = "cuda"):
        self.device = _device(device)
        self.drivers: list[CKRasterizerDriver] = []
        self._objects_index = np.zeros(0, np.uint8)   # kind-bit mask per slot
        self._first_free = [0] * 6
        self._linked: list[CKRasterizer] = []
        self.driver_problems = []
        self.main_window = None

    # -- lifecycle (reference Start/Close) ---------------------------------
    def Start(self, main_window=None) -> bool:
        self.main_window = main_window
        if not self.drivers:
            self.drivers = [CKRasterizerDriver(self, d.caps)
                            for d in enumerate_drivers()]
        return True

    def Close(self):
        for d in self.drivers:
            for c in list(d.contexts):
                d.DestroyContext(c)
        self.drivers = []

    def GetDriverCount(self) -> int:
        return len(self.drivers)

    def GetDriver(self, i: int) -> "CKRasterizerDriver | None":
        return self.drivers[i] if 0 <= i < len(self.drivers) else None

    # -- shared object indices ---------------------------------------------
    @staticmethod
    def _kind_slot(kind: int) -> int:
        return _KIND_BITS.index(kind)

    def CreateObjectIndex(self, kind: int, warn_others: bool = True) -> int:
        ks = self._kind_slot(kind)
        i = self._first_free[ks]
        n = self._objects_index.shape[0]
        while i < n and (self._objects_index[i] & kind):
            i += 1
        if i >= n:
            new_n = max(n * 2, i + 1)
            grown = np.zeros(new_n, np.uint8)
            grown[:n] = self._objects_index
            self._objects_index = grown
            for d in self.drivers:
                for c in d.contexts:
                    c.UpdateObjectArrays(self)
        self._objects_index[i] |= kind
        self._first_free[ks] = i + 1
        if warn_others:
            for other in self._linked:
                other.CreateObjectIndex(kind, False)
        return i

    def ReleaseObjectIndex(self, index: int, kind: int,
                           warn_others: bool = True) -> bool:
        if not (0 <= index < self._objects_index.shape[0]):
            return False
        self._objects_index[index] &= ~np.uint8(kind)
        ks = self._kind_slot(kind)
        self._first_free[ks] = min(self._first_free[ks], index)
        if warn_others:
            for other in self._linked:
                other.ReleaseObjectIndex(index, kind, False)
        return True

    def FindDriverProblems(self, vendor: str = "", renderer: str = "",
                           version: str = "", device_desc: str = "",
                           bpp: int = 32):
        """First quirks-database entry matching the driver identification
        (reference FindDriverProblems, include/CKRasterizer.h:96)."""
        for p in self.driver_problems:
            if p.renderer and p.renderer not in (renderer + device_desc):
                continue
            if p.vendor and p.vendor not in vendor:
                continue
            if p.version:
                if p.version_must_be_exact and version != p.version:
                    continue
                if not p.version_must_be_exact and p.version not in version:
                    continue
            return p
        return None

    def LinkRasterizer(self, other: "CKRasterizer"):
        if other is not self and other not in self._linked:
            self._linked.append(other)

    def RemoveLinkedRasterizer(self, other: "CKRasterizer"):
        if other in self._linked:
            self._linked.remove(other)

    def LoadVideoCardFile(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        self.driver_problems = load_video_card_file(path)
        for d in self.drivers:
            d.caps = apply_driver_problems(d.caps, self.driver_problems)
        return True


class CKRasterizerDriver:
    """Caps + context factory (reference CKRasterizer.h:125-150). ``caps``:
    one entry of ``caps.enumerate_drivers``; its name is the driver's."""

    def __init__(self, owner: CKRasterizer, caps: Vx3DCapsDesc):
        self.owner = owner
        self.desc = caps.driver_name
        self.hardware = caps.is_hardware
        self.caps = caps
        self.contexts: list[CKRasterizerContext] = []
        # "Display modes" = framebuffer shapes; formats = dtypes.
        self.display_modes = [(640, 480, 32, 60), (1024, 768, 32, 60),
                              (1920, 1080, 32, 60)]
        self.texture_formats = ["32_ARGB8888", "32_RGB888", "16_RGB565",
                                "DXT1", "DXT5"]

    def IsHardware(self) -> bool:
        return self.hardware

    def CreateContext(self) -> "CKRasterizerContext":
        c = CKRasterizerContext(self)
        self.contexts.append(c)
        return c

    def DestroyContext(self, ctx: "CKRasterizerContext") -> bool:
        if ctx in self.contexts:
            self.contexts.remove(ctx)
            return True
        return False

    def FindNearestTextureFormat(self, fmt: str) -> str:
        return fmt if fmt in self.texture_formats else "32_ARGB8888"

    def FindNearestRenderTargetFormat(self, bpp: int = 32) -> str:
        return "32_ARGB8888"

    def FindNearestDepthFormat(self, bpp: int = 32) -> str:
        return "D32F"


def _pow2_tiles(size: int, maxtile: int = 256) -> list[tuple[int, int]]:
    """(offset, pow2-length) covering ``size`` (reference CreateSprite's
    non-pow2 decomposition into pow2 sub-textures, CKSPRTextInfo)."""
    out = []
    off = 0
    remaining = size
    while remaining > 0:
        t = maxtile
        while t > remaining and t > 1:
            t //= 2
        out.append((off, t))
        off += t
        remaining -= t
    return out


class CKRasterizerContext:
    """The drawable device surface (reference CKRasterizer.h:201-519 +
    CKRasterizerLib/CKRasterizerContext.cpp). ``fb`` (4, H, W) and ``zb``
    (H, W) are float32 tensors on the driver's device."""

    def __init__(self, driver: CKRasterizerDriver):
        self.driver = driver
        self.device = driver.owner.device
        self.width = 0
        self.height = 0
        self.fb = None
        self.zb = None
        self.viewport = (0, 0, 0, 0)
        self.in_scene = False
        self.sceneBegined = False
        # transforms
        self._mats = {VXMATRIX_WORLD: np.eye(4, dtype=np.float32),
                      VXMATRIX_VIEW: np.eye(4, dtype=np.float32),
                      VXMATRIX_PROJECTION: np.eye(4, dtype=np.float32)}
        self._viewproj = np.eye(4, dtype=np.float32)
        self._total = np.eye(4, dtype=np.float32)
        # render-state cache (value + flags per state id; hit/miss counters,
        # reference include/CKRasterizer.h:509-510,524-575)
        self._rs_value = np.zeros(RENDERSTATE_MAXSTATE, np.int64)
        self._rs_flags = np.zeros(RENDERSTATE_MAXSTATE, np.uint8)
        self.render_state_cache_hit = 0
        self.render_state_cache_miss = 0
        self.InitDefaultRenderStatesValue()
        # objects (index -> payload dicts)
        self.textures: dict[int, dict] = {}
        self.sprites: dict[int, dict] = {}
        self.vertex_buffers: dict[int, dict] = {}
        self.index_buffers: dict[int, dict] = {}
        self.vertex_shaders: dict[int, dict] = {}
        self.pixel_shaders: dict[int, dict] = {}
        self._current_tex = -1
        self._tss: dict = {}
        self._dyn_vbs: dict = {}
        self._lights: dict[int, dict] = {}
        self._lights_on: set[int] = set()
        self._material = None
        self._vs_const = np.zeros((96, 4), np.float32)
        self._ps_const = np.zeros((32, 4), np.float32)
        self._clip_planes: dict[int, np.ndarray] = {}
        self._dirty_rects: list = []
        self._display_lists: dict[int, list] = {}
        self._recording: list | None = None
        self._recording_id = 0
        self._screen_backup = None
        self._draw_buffer = 0
        self.stats = {"NbTrianglesDrawn": 0, "NbVerticesProcessed": 0}

    # -- creation ----------------------------------------------------------
    def Create(self, window=None, width: int = 256, height: int = 256,
               bpp: int = 32, fullscreen: bool = False, **kw) -> bool:
        self.width, self.height = int(width), int(height)
        self.viewport = (0, 0, self.width, self.height)
        self.fb = torch.zeros((4, self.height, self.width),
                              dtype=torch.float32, device=self.device)
        self.zb = torch.ones((self.height, self.width), dtype=torch.float32,
                             device=self.device)
        return True

    def Resize(self, pos_x: int = 0, pos_y: int = 0, width: int = 0,
               height: int = 0, flags: int = 0) -> bool:
        return self.Create(None, width or self.width, height or self.height)

    # -- frame bracket -----------------------------------------------------
    def BeginScene(self) -> bool:
        if self.sceneBegined:
            return False
        self.sceneBegined = True
        return True

    def EndScene(self) -> bool:
        if not self.sceneBegined:
            return False
        self.sceneBegined = False
        return True

    def Clear(self, flags: int = CKRST_CTXCLEAR_ALL, ccol: int = 0,
              zval: float = 1.0, stencil: int = 0, rect_count: int = 0,
              rects=None) -> bool:
        if self.fb is None:
            return False
        if flags & CKRST_CTXCLEAR_COLOR:
            rgba = torch.tensor(_rgb(ccol) + [(ccol >> 24 & 0xFF) / 255.0],
                                dtype=torch.float32, device=self.device)
            self.fb = rgba[:, None, None].expand(self.fb.shape).contiguous()
        if flags & CKRST_CTXCLEAR_DEPTH:
            self.zb = torch.full_like(self.zb, float(zval))
        return True

    def BackToFront(self, vsync: bool = False) -> np.ndarray:
        """Present = expose the frame (returns HWC float image)."""
        return np.moveaxis(self.fb.cpu().numpy(), 0, -1)

    # -- viewport / transforms --------------------------------------------
    def SetViewport(self, data) -> bool:
        x, y, w, h = (int(v) for v in data[:4])
        self.viewport = (x, y, w, h)
        return True

    def SetTransformMatrix(self, mtype: int, m) -> bool:
        self._mats[int(mtype)] = np.asarray(m, np.float32).reshape(4, 4)
        self.UpdateMatrices()
        return True

    def GetTransformMatrix(self, mtype: int):
        return self._mats.get(int(mtype), np.eye(4, dtype=np.float32)).copy()

    def UpdateMatrices(self):
        """Recompute ViewProj/Total (reference UpdateMatrices — row-vector
        convention: total = world @ view @ proj)."""
        self._viewproj = (self._mats[VXMATRIX_VIEW]
                          @ self._mats[VXMATRIX_PROJECTION])
        self._total = self._mats[VXMATRIX_WORLD] @ self._viewproj

    # -- render-state cache ------------------------------------------------
    def InitDefaultRenderStatesValue(self):
        """Default state table (reference InitDefaultRenderStatesValue,
        CKRasterizerLib/CKRasterizerContext.cpp:423-477)."""
        self._rs_value[:] = 0
        self._rs_flags[:] = 0
        defaults = {
            VXRENDERSTATE.ZENABLE: 1,
            VXRENDERSTATE.ZWRITEENABLE: 1,
            VXRENDERSTATE.ZFUNC: int(VXCMP.LESSEQUAL),
            VXRENDERSTATE.SRCBLEND: int(VXBLEND.ONE),
            VXRENDERSTATE.DESTBLEND: int(VXBLEND.ZERO),
            VXRENDERSTATE.CULLMODE: int(VXCULL.CCW),
            VXRENDERSTATE.ALPHAFUNC: int(VXCMP.ALWAYS),
            VXRENDERSTATE.SHADEMODE: 2,          # gouraud
            VXRENDERSTATE.FILLMODE: 3,           # solid
            VXRENDERSTATE.LIGHTING: 1,
            VXRENDERSTATE.CLIPPING: 1,
            VXRENDERSTATE.FOGCOLOR: 0,
        }
        for k, v in defaults.items():
            self._rs_value[int(k)] = v
            self._rs_flags[int(k)] = RSC_VALID

    def SetRenderState(self, state: int, value: int) -> bool:
        state = int(state)
        if not (0 <= state < RENDERSTATE_MAXSTATE):
            return False
        f = self._rs_flags[state]
        if f & RSC_LOCKED:
            return True
        if (f & RSC_VALID) and self._rs_value[state] == int(value):
            self.render_state_cache_hit += 1
            return True
        self.render_state_cache_miss += 1
        if self._recording is not None:
            self._recording.append(("rs", state, int(value)))
        return self.InternalSetRenderState(state, int(value))

    def InternalSetRenderState(self, state: int, value: int) -> bool:
        self._rs_value[state] = value
        self._rs_flags[state] |= RSC_VALID
        return True

    def GetRenderState(self, state: int):
        return self.InternalGetRenderState(int(state))

    def InternalGetRenderState(self, state: int):
        if not (0 <= state < RENDERSTATE_MAXSTATE):
            return None
        return int(self._rs_value[state])

    def GetRSCacheValue(self, state: int):
        f = self._rs_flags[int(state)]
        return int(self._rs_value[int(state)]) if f & RSC_VALID else None

    def SetRenderStateFlags(self, state: int, flags: int) -> bool:
        """Lock/unlock a state against later SetRenderState writes
        (reference locked flags in the state cache)."""
        if flags & RSC_LOCKED:
            self._rs_flags[int(state)] |= RSC_LOCKED
        else:
            self._rs_flags[int(state)] &= ~np.uint8(RSC_LOCKED)
        return True

    def FlushRenderStateCache(self):
        """Re-apply defaults; counters keep accumulating (reference
        FlushRenderStateCache)."""
        locked = self._rs_flags & RSC_LOCKED
        vals = self._rs_value.copy()
        self.InitDefaultRenderStatesValue()
        keep = locked.astype(bool)
        self._rs_value[keep] = vals[keep]
        self._rs_flags[keep] |= RSC_LOCKED | RSC_VALID

    def InvalidateStateCache(self, state: int | None = None):
        if state is None:
            self._rs_flags &= ~np.uint8(RSC_VALID)
        else:
            self._rs_flags[int(state)] &= ~np.uint8(RSC_VALID)

    def _raster_state(self) -> RasterState:
        """Lower the cached states into the engine's packed RasterState."""
        rs = self.InternalGetRenderState
        return RasterState(
            src_blend=rs(VXRENDERSTATE.SRCBLEND),
            dst_blend=rs(VXRENDERSTATE.DESTBLEND),
            z_func=rs(VXRENDERSTATE.ZFUNC) if rs(VXRENDERSTATE.ZENABLE)
            else int(VXCMP.ALWAYS),
            z_write=bool(rs(VXRENDERSTATE.ZWRITEENABLE)),
            alpha_blend=bool(rs(VXRENDERSTATE.ALPHABLENDENABLE)),
            alpha_test=bool(rs(VXRENDERSTATE.ALPHATESTENABLE)),
            alpha_func=rs(VXRENDERSTATE.ALPHAFUNC),
            alpha_ref=rs(VXRENDERSTATE.ALPHAREF) / 255.0,
            tex=0 if self._current_tex >= 0 else -1,
            fog=bool(rs(VXRENDERSTATE.FOGENABLE)),
            cull=rs(VXRENDERSTATE.CULLMODE),
        )

    # -- lights / material -------------------------------------------------
    def SetLight(self, index: int, data: dict) -> bool:
        self._lights[int(index)] = dict(data)
        return True

    def EnableLight(self, index: int, enable: bool = True) -> bool:
        (self._lights_on.add if enable
         else self._lights_on.discard)(int(index))
        return True

    def SetMaterial(self, mat: dict) -> bool:
        self._material = dict(mat) if mat is not None else None
        return True

    # -- objects -----------------------------------------------------------
    def _planes(self, img: np.ndarray) -> torch.Tensor:
        """(h, w, 4) host image -> (1, 4, h, w) float32 on the device."""
        return torch.as_tensor(np.ascontiguousarray(
            np.moveaxis(np.asarray(img, np.float32), -1, 0))[None],
            device=self.device)

    def CreateObject(self, index: int, kind: int, desc=None) -> bool:
        index = int(index)
        if kind == CKRST_OBJ_TEXTURE:
            d = dict(desc or {})
            w, h = int(d.get("width", 1)), int(d.get("height", 1))
            # Level 0 lives on the device ("planes"); "levels"[0] is None.
            self.textures[index] = {
                "width": w, "height": h, "levels": [None],
                "planes": torch.zeros((1, 4, h, w), dtype=torch.float32,
                                      device=self.device),
                "mip": int(d.get("mip_levels", 1))}
        elif kind == CKRST_OBJ_SPRITE:
            d = dict(desc or {})
            w, h = int(d.get("width", 1)), int(d.get("height", 1))
            self.sprites[index] = {"width": w, "height": h,
                                   "image": torch.zeros(
                                       (h, w, 4), dtype=torch.float32,
                                       device=self.device),
                                   "tiles_x": _pow2_tiles(w),
                                   "tiles_y": _pow2_tiles(h)}
        elif kind == CKRST_OBJ_VERTEXBUFFER:
            d = dict(desc or {})
            n = int(d.get("max_vertices", 1024))
            self.vertex_buffers[index] = {
                "positions": np.zeros((n, 4), np.float32),
                "colors": np.ones((n, 4), np.float32),
                "uvs": np.zeros((n, 2), np.float32), "count": n,
                "locked": None}
        elif kind == CKRST_OBJ_INDEXBUFFER:
            d = dict(desc or {})
            n = int(d.get("max_indices", 1024))
            self.index_buffers[index] = {
                "indices": np.zeros(n, np.int32), "count": n, "locked": None}
        elif kind == CKRST_OBJ_VERTEXSHADER:
            self.vertex_shaders[index] = {"fn": desc}
        elif kind == CKRST_OBJ_PIXELSHADER:
            self.pixel_shaders[index] = {"fn": desc}
        else:
            return False
        return True

    def DeleteObject(self, index: int, kind: int) -> bool:
        table = {CKRST_OBJ_TEXTURE: self.textures,
                 CKRST_OBJ_SPRITE: self.sprites,
                 CKRST_OBJ_VERTEXBUFFER: self.vertex_buffers,
                 CKRST_OBJ_INDEXBUFFER: self.index_buffers,
                 CKRST_OBJ_VERTEXSHADER: self.vertex_shaders,
                 CKRST_OBJ_PIXELSHADER: self.pixel_shaders}[kind]
        return table.pop(int(index), None) is not None

    def FlushObjects(self, kinds: int = CKRST_OBJ_ALL):
        if kinds & CKRST_OBJ_TEXTURE:
            self.textures.clear()
        if kinds & CKRST_OBJ_SPRITE:
            self.sprites.clear()
        if kinds & CKRST_OBJ_VERTEXBUFFER:
            self.vertex_buffers.clear()
        if kinds & CKRST_OBJ_INDEXBUFFER:
            self.index_buffers.clear()
        if kinds & CKRST_OBJ_VERTEXSHADER:
            self.vertex_shaders.clear()
        if kinds & CKRST_OBJ_PIXELSHADER:
            self.pixel_shaders.clear()

    def UpdateObjectArrays(self, rasterizer: CKRasterizer):
        """Index space grew (reference UpdateObjectArrays) — dict-backed
        tables need no resize; hook kept for allocator parity."""
        return self.AllocateObjects(rasterizer._objects_index.shape[0])

    def AllocateObjects(self, capacity: int) -> bool:
        """Reserve object-table capacity (reference AllocateObjects — the
        guard-byte test hook overrides this); dicts grow on demand."""
        self._object_capacity = int(capacity)
        return True

    # -- textures ----------------------------------------------------------
    def LoadTexture(self, index: int, image, level: int = 0) -> bool:
        t = self.textures.get(int(index))
        if t is None:
            return False
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3 + [np.ones_like(img)], -1)
        while len(t["levels"]) <= level:
            t["levels"].append(None)
        if level == 0:
            t["planes"] = self._planes(img)
            t["height"], t["width"] = img.shape[0], img.shape[1]
        else:
            t["levels"][level] = img
        return True

    def LoadCubeMapTexture(self, index: int, image, face: int,
                           level: int = 0) -> bool:
        t = self.textures.get(int(index))
        if t is None:
            return False
        t.setdefault("faces", {})[int(face)] = np.asarray(image, np.float32)
        return True

    def GetTextureData(self, index: int, level: int = 0):
        t = self.textures.get(int(index))
        if t is None or level >= len(t["levels"]):
            return None
        if level == 0:
            return np.moveaxis(t["planes"][0].cpu().numpy(), 0, -1).copy()
        lv = t["levels"][level]
        return None if lv is None else lv.copy()

    def CopyToTexture(self, index: int, src_rect=None, dst_rect=None) -> bool:
        """Framebuffer -> texture (reference CopyToTexture, the
        render-to-texture copy path): a copy on the device."""
        t = self.textures.get(int(index))
        if t is None or self.fb is None:
            return False
        img = self.fb
        if src_rect is not None:
            x0, y0, x1, y1 = (int(v) for v in src_rect)
            img = img[:, y0:y1, x0:x1]
        t["planes"] = img[None].clone()
        t["height"], t["width"] = img.shape[1], img.shape[2]
        return True

    def SetTexture(self, index: int, stage: int = 0) -> bool:
        self._current_tex = int(index)
        return True

    def SetTextureStageState(self, stage: int, state: int, value) -> bool:
        self._tss[(int(stage), int(state))] = value
        return True

    # -- sprites (pow2 decomposition, reference CreateSprite/DrawSprite) ---
    def CreateSprite(self, index: int, width: int, height: int) -> bool:
        return self.CreateObject(index, CKRST_OBJ_SPRITE,
                                 {"width": width, "height": height})

    def LoadSprite(self, index: int, image) -> bool:
        s = self.sprites.get(int(index))
        if s is None:
            return False
        s["image"] = torch.as_tensor(np.asarray(image, np.float32),
                                     device=self.device)
        s["height"], s["width"] = s["image"].shape[:2]
        s["tiles_x"] = _pow2_tiles(s["width"])
        s["tiles_y"] = _pow2_tiles(s["height"])
        return True

    def GetSpriteData(self, index: int):
        s = self.sprites.get(int(index))
        return None if s is None else {
            "width": s["width"], "height": s["height"],
            "tiles_x": list(s["tiles_x"]), "tiles_y": list(s["tiles_y"])}

    def DrawSprite(self, index: int, src_rect=None, dst_rect=None) -> bool:
        """Composite the sprite's pow2 tiles into dst_rect (reference
        DrawSprite draws one textured quad per CKSPRTextInfo tile; a single
        alpha-blit is the array-native equivalent — tiles exist in
        GetSpriteData for API parity). Nearest texels by integer index,
        ``fb·(1−a) + src·a`` on RGB, on the device."""
        s = self.sprites.get(int(index))
        if s is None or self.fb is None:
            return False
        img = s["image"]
        if src_rect is not None:
            x0, y0, x1, y1 = (int(v) for v in src_rect)
            img = img[y0:y1, x0:x1]
        if dst_rect is None:
            dx0, dy0 = 0, 0
            dw, dh = img.shape[1], img.shape[0]
        else:
            dx0, dy0, dx1, dy1 = (int(v) for v in dst_rect)
            dw, dh = dx1 - dx0, dy1 - dy0
        if dw <= 0 or dh <= 0:
            return False
        h, w = self.fb.shape[1:]
        cx0, cy0 = max(dx0, 0), max(dy0, 0)
        cx1, cy1 = min(dx0 + dw, w), min(dy0 + dh, h)
        if cx1 <= cx0 or cy1 <= cy0:
            return False
        yi = torch.clamp(torch.arange(dh, device=self.device)
                         * img.shape[0] // max(dh, 1), 0, img.shape[0] - 1)
        xi = torch.clamp(torch.arange(dw, device=self.device)
                         * img.shape[1] // max(dw, 1), 0, img.shape[1] - 1)
        scaled = img.index_select(0, yi).index_select(1, xi)
        sub = scaled[cy0 - dy0:cy1 - dy0, cx0 - dx0:cx1 - dx0]
        sub = sub.permute(2, 0, 1)                       # (4, h, w)
        a = sub[3:4]
        fb = self.fb.clone()
        dst = fb[:3, cy0:cy1, cx0:cx1]
        fb[:3, cy0:cy1, cx0:cx1] = dst * (1 - a) + sub[:3] * a
        self.fb = fb
        return True

    # -- vertex/index buffers ----------------------------------------------
    def LockVertexBuffer(self, index: int, start: int = 0,
                         count: int | None = None):
        vb = self.vertex_buffers.get(int(index))
        if vb is None:
            return None
        count = count if count is not None else vb["count"] - start
        vb["locked"] = (start, count)
        sl = slice(start, start + count)
        return vb["positions"][sl], vb["colors"][sl], vb["uvs"][sl]

    def UnlockVertexBuffer(self, index: int) -> bool:
        vb = self.vertex_buffers.get(int(index))
        if vb is None or vb["locked"] is None:
            return False
        vb["locked"] = None
        return True

    def GetVertexBufferData(self, index: int):
        vb = self.vertex_buffers.get(int(index))
        return None if vb is None else vb["positions"].copy()

    def OptimizeVertexBuffer(self, index: int) -> bool:
        return int(index) in self.vertex_buffers

    def LockIndexBuffer(self, index: int, start: int = 0,
                        count: int | None = None):
        ib = self.index_buffers.get(int(index))
        if ib is None:
            return None
        count = count if count is not None else ib["count"] - start
        ib["locked"] = (start, count)
        return ib["indices"][start:start + count]

    def UnlockIndexBuffer(self, index: int) -> bool:
        ib = self.index_buffers.get(int(index))
        if ib is None or ib["locked"] is None:
            return False
        ib["locked"] = None
        return True

    def GetIndexBufferData(self, index: int):
        ib = self.index_buffers.get(int(index))
        return None if ib is None else ib["indices"].copy()

    # -- draws -------------------------------------------------------------
    def _light_colors(self, pos_w: np.ndarray, nrm_w: np.ndarray):
        """Fixed-function vertex lighting over the enabled light table
        (ambient + diffuse; the engine's full model lives in the frame
        program — this is the HAL immediate path)."""
        amb_packed = self.InternalGetRenderState(VXRENDERSTATE.AMBIENT) or 0
        amb = np.array(_rgb(amb_packed), np.float32)
        mat_d = np.ones(4, np.float32)
        if self._material is not None:
            mat_d = np.asarray(self._material.get("diffuse", mat_d),
                               np.float32)
        acc = np.broadcast_to(amb, nrm_w.shape).copy()
        for li in self._lights_on:
            l = self._lights.get(li)
            if l is None:
                continue
            ldir = np.asarray(l.get("direction", (0, 0, 1)), np.float32)
            ldir = ldir / max(np.linalg.norm(ldir), 1e-9)
            lcol = np.asarray(l.get("diffuse", (1, 1, 1)), np.float32)[:3]
            ndl = np.maximum(-(nrm_w @ ldir), 0.0)
            acc = acc + ndl[:, None] * lcol
        rgb = np.clip(acc * mat_d[:3], 0.0, 1.0)
        return np.concatenate(
            [rgb, np.full((rgb.shape[0], 1), mat_d[3], np.float32)], -1)

    def DrawPrimitive(self, ptype: int, indices, data: dict) -> bool:
        """CKRST data dict: positions (N,3 local or N,4 clip when
        'transformed'), optional normals/colors/uvs (reference
        DrawPrimitive: CKRST format -> dynamic VB -> draw,
        CKDX9RasterizerContext.cpp:1555-1648)."""
        if self._recording is not None:
            self._recording.append(("draw", ptype, None if indices is None
                                    else np.asarray(indices).copy(),
                                    {k: np.asarray(v).copy()
                                     for k, v in data.items()
                                     if k != "transformed"}
                                    | {"transformed":
                                       data.get("transformed", False)}))
        pos = np.asarray(data["positions"], np.float32)
        n = pos.shape[0]
        if not data.get("transformed", False):
            h = np.concatenate([pos[:, :3], np.ones((n, 1), np.float32)], -1)
            clip = h @ self._total
            if "colors" in data:
                colors = np.asarray(data["colors"], np.float32)
            elif ("normals" in data
                  and self.InternalGetRenderState(VXRENDERSTATE.LIGHTING)):
                world = self._mats[VXMATRIX_WORLD]
                nrm_w = np.asarray(data["normals"],
                                   np.float32) @ world[:3, :3]
                colors = self._light_colors(h @ world, nrm_w)
            else:
                colors = np.ones((n, 4), np.float32)
        else:
            clip = pos if pos.shape[1] == 4 else np.concatenate(
                [pos, np.ones((n, 1), np.float32)], -1)
            colors = np.asarray(data.get("colors",
                                         np.ones((n, 4), np.float32)),
                                np.float32)
        uvs = np.asarray(data.get("uvs", np.zeros((n, 2), np.float32)),
                         np.float32)
        if indices is not None:
            idx = np.asarray(indices, np.int64).reshape(-1)
            clip, colors, uvs = clip[idx], colors[idx], uvs[idx]
        return self._draw_clip(ptype, clip, colors, uvs)

    def _draw_clip(self, ptype: int, clip, colors, uvs) -> bool:
        from ..convert import device_batch_from_host
        from . import batch as rbatch
        from .torch_backend import render_pass
        from .types import pack_states

        count = clip.shape[0]
        if count < 3:
            return False
        if ptype == int(VXPRIMITIVE.TRIANGLESTRIP):
            t = count - 2
            idx = np.stack([np.arange(t), np.arange(1, t + 1),
                            np.arange(2, t + 2)], -1)
            flip = (np.arange(t) % 2) == 1
            idx[flip] = idx[flip][:, [1, 0, 2]]
        elif ptype == int(VXPRIMITIVE.TRIANGLEFAN):
            t = count - 2
            idx = np.stack([np.zeros(t, np.int64), np.arange(1, t + 1),
                            np.arange(2, t + 2)], -1)
        else:
            t = count // 3
            idx = np.arange(t * 3).reshape(-1, 3)
        tb = rbatch.make_batch(clip[idx], view=self.viewport,
                               color=colors[idx], uv=uvs[idx],
                               pad_to=max(8, ((t + 7) // 8) * 8))
        st = self._raster_state()
        si, sf = pack_states([st])
        db = device_batch_from_host(tb, self.device)
        tex = self.textures.get(self._current_tex)
        if tex is not None and st.tex >= 0:
            planes = tex["planes"]
            hw = torch.tensor([planes.shape[2:]], dtype=torch.int32,
                              device=self.device)
        else:
            planes = torch.zeros((1, 4, 1, 1), dtype=torch.float32,
                                 device=self.device)
            hw = torch.ones((1, 2), dtype=torch.int32, device=self.device)
        fogc = self.InternalGetRenderState(VXRENDERSTATE.FOGCOLOR) or 0
        fog_rgb = torch.tensor(_rgb(fogc), dtype=torch.float32,
                               device=self.device)
        self.fb, self.zb = render_pass(
            self.fb, self.zb, db, torch.as_tensor(si, device=self.device),
            torch.as_tensor(sf, device=self.device), planes, hw, fog_rgb,
            torch.tensor(self.viewport, dtype=torch.float32,
                         device=self.device))
        self.stats["NbTrianglesDrawn"] += t
        self.stats["NbVerticesProcessed"] += count
        return True

    def DrawPrimitiveVB(self, ptype: int, vb_index: int, start: int,
                        count: int, indices=None) -> bool:
        vb = self.vertex_buffers.get(int(vb_index))
        if vb is None:
            return False
        sl = slice(start, start + count)
        data = {"positions": vb["positions"][sl],
                "colors": vb["colors"][sl], "uvs": vb["uvs"][sl],
                "transformed": vb["positions"].shape[1] == 4}
        return self.DrawPrimitive(ptype, indices, data)

    def DrawPrimitiveVBIB(self, ptype: int, vb_index: int, ib_index: int,
                          min_index: int = 0, vertex_count: int | None = None,
                          start_index: int = 0,
                          index_count: int | None = None) -> bool:
        ib = self.index_buffers.get(int(ib_index))
        if ib is None:
            return False
        count = index_count if index_count is not None else ib["count"]
        idx = ib["indices"][start_index:start_index + count]
        vb = self.vertex_buffers.get(int(vb_index))
        if vb is None:
            return False
        data = {"positions": vb["positions"], "colors": vb["colors"],
                "uvs": vb["uvs"],
                "transformed": vb["positions"].shape[1] == 4}
        return self.DrawPrimitive(ptype, idx, data)

    def GetDynamicVertexBuffer(self, vertex_format: int, count: int,
                               stride: int = 0, index: int = 0):
        """Pooled dynamic VB keyed by format (reference
        GetDynamicVertexBuffer)."""
        key = (int(vertex_format), int(index))
        vbi = self._dyn_vbs.get(key)
        if vbi is None or self.vertex_buffers[vbi]["count"] < count:
            vbi = len(self.vertex_buffers) + 1000
            self.CreateObject(vbi, CKRST_OBJ_VERTEXBUFFER,
                              {"max_vertices": max(count, 1024)})
            self._dyn_vbs[key] = vbi
        return vbi

    # -- geometry services -------------------------------------------------
    @staticmethod
    def _clip_flags(clip: np.ndarray) -> np.ndarray:
        """Per-vertex 6-plane VXCLIP flags of (N, 4) clip coords."""
        w = clip[:, 3:4]
        flags = ((clip[:, 0:1] < -w) * 1 | (clip[:, 0:1] > w) * 2
                 | (clip[:, 1:2] < -w) * 4 | (clip[:, 1:2] > w) * 8
                 | (clip[:, 2:3] < 0) * 16 | (clip[:, 2:3] > w) * 32)
        return flags[:, 0].astype(np.int32)

    def TransformVertices(self, vertices) -> dict:
        """local -> clip -> screen with per-vertex 6-plane clip flags and
        the all-offscreen AND reduction (reference TransformVertices,
        CKRasterizerLib/CKRasterizerContext.cpp:316-392)."""
        v = np.asarray(vertices, np.float32)
        h = np.concatenate([v[:, :3], np.ones((v.shape[0], 1), np.float32)],
                           -1)
        clip = h @ self._total
        w = clip[:, 3:4]
        flags = self._clip_flags(clip)
        safe_w = np.where(np.abs(w) < 1e-12, 1e-12, w)
        ndc = clip[:, :3] / safe_w
        x0, y0, vw, vh = self.viewport
        screen = np.stack([
            x0 + (ndc[:, 0] * 0.5 + 0.5) * vw,
            y0 + (0.5 - ndc[:, 1] * 0.5) * vh,
            ndc[:, 2]], -1).astype(np.float32)
        offscreen = int(np.bitwise_and.reduce(flags)) if flags.size else 0
        return {"clip": clip, "screen": screen, "flags": flags,
                "offscreen": offscreen != 0}

    def ComputeBoxVisibility(self, bmin, bmax, world=None):
        """OFFSCREEN / VISIBLE / ALLINSIDE classification (reference
        ComputeBoxVisibility, CKRasterizerContext.cpp:394-421)."""
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        corners = np.array([[x, y, z] for x in (bmin[0], bmax[0])
                            for y in (bmin[1], bmax[1])
                            for z in (bmin[2], bmax[2])], np.float32)
        if world is not None:
            wm = np.asarray(world, np.float32)
            corners = corners @ wm[:3, :3] + wm[3, :3]
            h = np.concatenate([corners, np.ones((8, 1), np.float32)], -1)
            clip = h @ self._viewproj
        else:
            h = np.concatenate([corners, np.ones((8, 1), np.float32)], -1)
            clip = h @ self._total
        flags = self._clip_flags(clip)
        if np.bitwise_and.reduce(flags) != 0:
            return "OFFSCREEN"
        if np.bitwise_or.reduce(flags) == 0:
            return "ALLINSIDE"
        return "VISIBLE"

    # -- clip planes / shaders ---------------------------------------------
    def SetUserClipPlane(self, index: int, plane) -> bool:
        if not (0 <= int(index) < 6):
            return False
        self._clip_planes[int(index)] = np.asarray(plane, np.float32)
        return True

    def GetUserClipPlane(self, index: int):
        p = self._clip_planes.get(int(index))
        return None if p is None else p.copy()

    def SetVertexShader(self, index: int) -> bool:
        return int(index) in self.vertex_shaders or int(index) == 0

    def SetPixelShader(self, index: int) -> bool:
        return int(index) in self.pixel_shaders or int(index) == 0

    def SetVertexShaderConstant(self, register: int, data, count: int = 1
                                ) -> bool:
        d = np.asarray(data, np.float32).reshape(-1, 4)
        self._vs_const[register:register + d.shape[0]] = d
        return True

    def SetPixelShaderConstant(self, register: int, data, count: int = 1
                               ) -> bool:
        d = np.asarray(data, np.float32).reshape(-1, 4)
        self._ps_const[register:register + d.shape[0]] = d
        return True

    # -- display lists (reference NewDisplayList/CallDisplayList) ----------
    def NewDisplayList(self) -> int:
        self._recording_id += 1
        self._recording = []
        return self._recording_id

    def EndDisplayList(self) -> bool:
        if self._recording is None:
            return False
        self._display_lists[self._recording_id] = self._recording
        self._recording = None
        return True

    def CallDisplayList(self, dl_id: int) -> bool:
        cmds = self._display_lists.get(int(dl_id))
        if cmds is None:
            return False
        for cmd in cmds:
            if cmd[0] == "rs":
                self.InternalSetRenderState(cmd[1], cmd[2])
            elif cmd[0] == "draw":
                self.DrawPrimitive(cmd[1], cmd[2], cmd[3])
        return True

    def DeleteDisplayList(self, dl_id: int) -> bool:
        return self._display_lists.pop(int(dl_id), None) is not None

    # -- misc --------------------------------------------------------------
    def AddDirtyRect(self, rect=None):
        self._dirty_rects.append(tuple(rect) if rect is not None
                                 else (0, 0, self.width, self.height))

    def ResetDirtyRects(self):
        self._dirty_rects = []

    def SetScreenBackup(self):
        self._screen_backup = self.fb.clone()

    def RestoreScreenBackup(self) -> bool:
        if self._screen_backup is None:
            return False
        self.fb = self._screen_backup.clone()
        return True

    def SetDrawBuffer(self, flags: int) -> bool:
        self._draw_buffer = int(flags)
        return True

    def GetImplementationSpecificData(self) -> dict:
        return {"backend": "torch", "driver": self.driver.desc,
                "device": str(self.device), "fb": self.fb, "zb": self.zb}

    def WarnThread(self, enter: bool = True):
        return None

    def Drawing(self) -> bool:
        return self.sceneBegined


_NULL: dict[torch.device, CKRasterizer] = {}


def CKNULLRasterizerStart(window=None,
                          device: "str | torch.device" = "cuda"
                          ) -> CKRasterizer:
    """The NULL/software rasterizer entry (reference CKNULLRasterizerStart,
    CKRasterizerLib/CKRasterizer.cpp:17-35): a plain CKRasterizer whose
    un-overridden context methods are safe defaults; one per device."""
    device = _device(device)
    if device not in _NULL:
        rst = CKRasterizer(device)
        rst.Start(window)
        _NULL[device] = rst
    return _NULL[device]


def InitNULLRasterizerCaps() -> Vx3DCapsDesc:
    """Default caps of the NULL/software device (reference
    InitNULLRasterizerCaps — safe, generous software caps)."""
    return Vx3DCapsDesc()


def ConvertAttenuationModelFromDX5(a0: float, a1: float, a2: float,
                                   range_: float) -> tuple:
    """DX5 normalized attenuation triplet -> DX9 distance coefficients
    (reference ConvertAttenuationModelFromDX5,
    CKRasterizerLib/CKRasterizer.cpp:339-352): DX5 weights are fractions of
    the light range; DX9 wants absolute 1/(a0 + a1 d + a2 d^2) terms."""
    total = a0 + a1 + a2
    if range_ <= 0.0 or total <= 0.0:
        return 1.0, 0.0, 0.0
    c0 = 1.0 / total
    c1 = (2.0 * a2 + a1) * (c0 / range_) * c0
    c2 = c0 * a2 * c0 / (range_ * range_) + c1 * c1 / c0
    return c0, c1, c2
