"""CKTexture: image container feeding the device texture stack.

API mirror of RCKTexture (include/RCKTexture.h,
src/CKTexture.cpp): system-memory image slots + lazy video upload. Here
"video memory" is the device texture plane stack; the scene compiler assigns
pool slots.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import CKCID_TEXTURE, CKContext, CKObject


class _LazyDeviceImage:
    """Host-side stand-in for a device-resident texture image (reference
    texture.py:16-36): the shape is known at once; the pixels are copied to
    the host only if a host path reads them."""

    def __init__(self, dev, chw: bool = False):
        self._dev = dev
        self._chw = chw
        self.shape = ((dev.shape[1], dev.shape[2], dev.shape[0]) if chw
                      else tuple(dev.shape))
        self._host = None

    def to_host(self) -> np.ndarray:
        if self._host is None:
            a = self._dev.detach().to("cpu", torch.float32, copy=True).numpy()
            self._host = np.moveaxis(a, 0, -1) if self._chw else a
        return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.to_host()
        return a if dtype is None else a.astype(dtype)


class CKTexture(CKObject):
    CLASS_ID = CKCID_TEXTURE

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.slots: list[np.ndarray | None] = [None]   # (H,W,4) f32 images
        self.current_slot = 0
        self.desired_video_format = None
        self.mipmap = True
        self.user_mip_levels: list[np.ndarray] = []
        self.transparent_color = None
        self.data_version = 0

    # -- image API --------------------------------------------------------
    def Create(self, width: int, height: int, bpp: int = 32, slot: int = 0):
        while len(self.slots) <= slot:
            self.slots.append(None)
        self.slots[slot] = np.zeros((height, width, 4), np.float32)
        self.context._bump_topology()
        return True

    def SetImage(self, image: np.ndarray, slot: int = 0):
        """image: (H,W,3|4) float [0,1] or uint8."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones(img.shape[:-1] + (1,), np.float32)], -1)
        while len(self.slots) <= slot:
            self.slots.append(None)
        same_shape = (self.slots[slot] is not None
                      and self.slots[slot].shape == img.shape)
        self.slots[slot] = img
        self.data_version += 1
        # Same-shape updates (video textures, re-rastered text) are dynamic:
        # the texture stack re-uploads without a scene recompile.
        if same_shape:
            self.context._bump_dynamic()
        else:
            self.context._bump_topology()

    def GetImage(self, slot: int = 0) -> np.ndarray | None:
        img = self.slots[slot]
        if isinstance(img, _LazyDeviceImage):
            return img.to_host()
        return img

    def LockSurfacePtr(self, slot: int = 0) -> np.ndarray | None:
        return self.slots[slot]

    def GetWidth(self) -> int:
        img = self.slots[self.current_slot]
        return 0 if img is None else img.shape[1]

    def GetHeight(self) -> int:
        img = self.slots[self.current_slot]
        return 0 if img is None else img.shape[0]

    def GetSlotCount(self) -> int:
        return len(self.slots)

    def SetCurrentSlot(self, slot: int):
        self.current_slot = int(slot)
        self.context._bump_topology()

    def GetCurrentSlot(self) -> int:
        return self.current_slot

    def SetDesiredVideoFormat(self, fmt):
        self.desired_video_format = fmt

    def UseMipmap(self, use: bool = True):
        self.mipmap = bool(use)
        self.context._bump_topology()

    def GetMipmapCount(self) -> int:
        img = self.slots[self.current_slot]
        if img is None or not self.mipmap:
            return 1
        return int(np.log2(max(img.shape[0], img.shape[1]))) + 1

    def SetCubeMapFaces(self, faces, size: int = 128, slot: int = 0):
        """Bake 6 cube faces into an octahedral environment map.

        ``faces``: [+x, -x, +y, -y, +z, -z], each (S,S,3|4) float/uint8 —
        the reference's cube maps (CKDX9RasterizerContext cube-map path,
        CKDX9RasterizerContext.cpp:3418). TEXGEN_CUBE materials (effect 4)
        sample the baked map with octahedral-encoded reflection vectors, so
        per-pixel face selection needs no cube sampler.
        """
        prepped = []
        for f in faces:
            img = np.asarray(f)
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            if img.shape[-1] == 3:
                img = np.concatenate(
                    [img, np.ones(img.shape[:-1] + (1,), np.float32)], -1)
            prepped.append(img.astype(np.float32))

        # Octahedral decode per output texel -> direction -> face sample.
        t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
        oy, ox = np.meshgrid(t, t, indexing="ij")
        oz = 1.0 - np.abs(ox) - np.abs(oy)
        lower = oz < 0
        fx = (1.0 - np.abs(oy)) * np.sign(ox)
        fy = (1.0 - np.abs(ox)) * np.sign(oy)
        dx = np.where(lower, fx, ox)
        dy = np.where(lower, fy, oy)
        dz = oz
        n = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-12
        dx, dy, dz = dx / n, dy / n, dz / n

        ax, ay, az = np.abs(dx), np.abs(dy), np.abs(dz)
        # face ids: 0:+x 1:-x 2:+y 3:-y 4:+z 5:-z (D3D cube order)
        face = np.where(
            (ax >= ay) & (ax >= az), np.where(dx >= 0, 0, 1),
            np.where(ay >= az, np.where(dy >= 0, 2, 3),
                     np.where(dz >= 0, 4, 5)))
        # D3D face (u,v) conventions
        safe = lambda a: np.where(np.abs(a) < 1e-12, 1e-12, a)
        u = np.select(
            [face == 0, face == 1, face == 2, face == 3, face == 4],
            [-dz / safe(ax), dz / safe(ax), dx / safe(ay), dx / safe(ay),
             dx / safe(az)],
            default=-dx / safe(az))
        v = np.select(
            [face == 0, face == 1, face == 2, face == 3, face == 4],
            [-dy / safe(ax), -dy / safe(ax), dz / safe(ay), -dz / safe(ay),
             -dy / safe(az)],
            default=-dy / safe(az))
        out = np.zeros((size, size, 4), np.float32)
        for fi in range(6):
            img = prepped[fi]
            s = img.shape[0]
            m = face == fi
            iu = np.clip(((u * 0.5 + 0.5) * s), 0, s - 1).astype(np.int32)
            iv = np.clip(((v * 0.5 + 0.5) * s), 0, s - 1).astype(np.int32)
            out[m] = img[iv[m], iu[m]]
        self.SetImage(out, slot=slot)
        return True

    def CopyContext(self, rc, slot: int = 0):
        """Copy a render context's framebuffer into this texture
        (reference RCKTexture::CopyContext render-target copy)."""
        self.SetImage(rc.framebuffer(), slot=slot)
        return True

    # -- API-surface parity batch (reference include/RCKTexture.h) ---------
    def GetDesiredVideoFormat(self):
        return self.desired_video_format

    def LoadImage(self, path: str, slot: int = 0) -> bool:
        """Load an image file into a slot (reference LoadImage:
        CKBitmapData file readers). DDS containers (DXT1/3/5 or masked RGB)
        decode through io/dds.py, matching the reference's compressed-
        texture ingestion (CKDX9RasterizerContext::LoadTexture incl.
        mipmaps); shipped mip chains become user mip levels. Every other
        file goes through the readers of io/imagefile.py, which give the
        RGBA bytes of the reference's ``Image.open(path).convert("RGBA")``.
        Returns False where the reference does: a missing file, or a file
        that Pillow refuses with ``OSError``; a file no reader takes raises
        (item 14)."""
        try:
            with open(path, "rb") as f:
                head = f.read(4)
        except OSError:
            return False
        if head != b"DDS ":
            from ..io.imagefile import open_image, to_rgba
            frame = open_image(path)
            if frame is False:
                return False
            rgba = to_rgba(*frame)
            self.SetImage(rgba.astype(np.float32) / 255.0, slot=slot)
            return True
        import struct

        from ..io.dds import load_dds
        try:
            levels = load_dds(path)
        except (ValueError, struct.error):
            return False
        self.SetImage(levels[0], slot=slot)
        if len(levels) > 1:
            self.user_mip_levels = [
                lv.astype(np.float32) for lv in levels[1:]]
            self.SetUserMipMapMode(True)
        return True

    def SetCompressedImage(self, data: bytes, width: int, height: int,
                           fmt: str = "DXT5", slot: int = 0) -> bool:
        """Ingest one raw DXT1/3/5 surface (no container), decoded to RGBA
        on the host at set time (reference LoadTexture hands the blocks to
        D3D, CKDX9RasterizerContext.cpp:1836-2060)."""
        from ..io.dds import decode_dxt
        try:
            img = decode_dxt(data, int(width), int(height), fmt)
        except ValueError:
            return False
        self.SetImage(img, slot=slot)
        return True

    def SetUserMipMapMode(self, on: bool = True):
        """User-provided mip levels instead of auto-generation (reference
        SetUserMipMapMode); levels go in via SetUserMipMapLevel."""
        self._user_mip_mode = bool(on)
        self.context._bump_topology()

    def GetUserMipMapLevel(self, level: int):
        if 0 <= level < len(self.user_mip_levels):
            return self.user_mip_levels[level]
        return None

    # Video-memory lifecycle: device texture stacks are rebuilt from system
    # slots by the context's texture refresh; these model the reference's
    # upload-state API (SystemToVideoMemory/FreeVideoMemory/Restore/
    # IsInVideoMemory, include/RCKTexture.h) on top of that.
    def SystemToVideoMemory(self, rc=None) -> bool:
        self._in_video_memory = True
        self.data_version += 1
        self.context._bump_dynamic()
        return True

    def FreeVideoMemory(self) -> bool:
        self._in_video_memory = False
        return True

    def Restore(self, clamp: bool = False) -> bool:
        return self.SystemToVideoMemory()

    def IsInVideoMemory(self) -> bool:
        return getattr(self, "_in_video_memory", True)

    def SetAsCurrent(self, rc, clamp: bool = False, stage: int = 0) -> bool:
        """Bind as the immediate-mode texture (reference SetAsCurrent ->
        lazy SystemToVideoMemory upload)."""
        self.SystemToVideoMemory(rc)
        rc.SetTexture(self, stage)
        return True

    def GetVideoPixelFormat(self):
        return self.desired_video_format or "32_ARGB8888"

    def GetSystemTextureDesc(self) -> dict:
        img = self.slots[self.current_slot]
        return {"width": self.GetWidth(), "height": self.GetHeight(),
                "bpp": 32, "mip_levels": self.GetMipmapCount(),
                "slot_count": self.GetSlotCount(),
                "has_image": img is not None}

    def GetVideoTextureDesc(self) -> dict:
        d = self.GetSystemTextureDesc()
        d["in_video_memory"] = self.IsInVideoMemory()
        return d

    def GetRstTextureIndex(self) -> int:
        """The rasterizer object index — the texture's id doubles as the
        handle here (no shared index table, PARITY §2.2)."""
        return self.id

    def SetTransparentColor(self, rgba):
        """Color-key transparency: matching texels get alpha 0 (reference
        CKBitmapData transparency semantics)."""
        self.transparent_color = np.asarray(rgba, np.float32)
        img = self.slots[self.current_slot]
        if img is not None:
            key = self.transparent_color[:3]
            match = np.all(np.abs(img[..., :3] - key[None, None]) < (0.5 / 255.0), axis=-1)
            img[..., 3] = np.where(match, 0.0, img[..., 3])
        self.context._bump_topology()

    def SetDeviceImage(self, img, slot: int = 0, chw: bool = False):
        """Device-resident image update (render-to-texture feeds, reference
        texture.py:312-348): ``img`` is a float tensor already on the
        context's device, (H, W, 4), or (4, H, W) planes with ``chw`` (a
        framebuffer, which consumers read as it is). The first image, or
        one of a new shape, is copied to the host so that the texture stack
        rebuild sees its shape (a topology change); after that the slot
        holds a lazy stand-in and only the dynamic version moves. A tensor
        on another device raises: it is never moved."""
        if not isinstance(img, torch.Tensor):
            raise TypeError("SetDeviceImage takes a torch.Tensor, not "
                            f"{type(img).__name__}")
        dev = self.context.device
        if img.device.type != dev.type or (
                dev.index is not None and img.device.index != dev.index):
            raise ValueError(f"SetDeviceImage: the image is on {img.device}, "
                             f"the context renders on {dev}")
        self._device_chw = bool(chw)
        shape_hwc = ((img.shape[1], img.shape[2], img.shape[0]) if chw
                     else tuple(img.shape))
        same_shape = (len(self.slots) > slot
                      and self.slots[slot] is not None
                      and tuple(self.slots[slot].shape) == shape_hwc)
        self._device_image = img
        self._device_slot = slot
        while len(self.slots) <= slot:
            self.slots.append(None)
        if same_shape:
            self.slots[slot] = _LazyDeviceImage(img, chw)
        else:
            self.slots[slot] = _LazyDeviceImage(img, chw).to_host()
        self.data_version += 1
        if same_shape:
            self.context._bump_dynamic()
        else:
            self.context._bump_topology()

    def current_image(self) -> np.ndarray | None:
        img = self.slots[self.current_slot] if self.slots else None
        if isinstance(img, _LazyDeviceImage):
            return img.to_host()
        return img

    def max_alpha_pyramid(self):
        """Conservative per-region alpha bounds: a MAX-mip pyramid of the
        alpha channel, levels halving down to 1x1 (level -1 = the global
        max). Used by the compile-time alpha-test pre-gate (round 5,
        VERDICT #5): a triangle whose UV bbox provably fails the alpha test
        never enters the ordered stream, so it cannot waste peel layer
        slots. Cached per data_version; None for device-fed textures."""
        cache = getattr(self, "_max_alpha_pyr", None)
        if cache is not None and cache[0] == self.data_version:
            return cache[1]
        img = self.current_image()
        if img is None or img.ndim != 3 or img.shape[2] < 4:
            pyr = None
        else:
            a = np.asarray(img[..., 3], np.float32)
            levels = [a]
            while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
                cur = levels[-1]
                h2, w2 = (cur.shape[0] + 1) // 2, (cur.shape[1] + 1) // 2
                pad = np.zeros((h2 * 2, w2 * 2), np.float32)
                pad[:cur.shape[0], :cur.shape[1]] = cur
                # pad rows/cols replicate so the MAX stays conservative
                if cur.shape[0] < h2 * 2:
                    pad[cur.shape[0]:, :cur.shape[1]] = cur[-1:]
                if cur.shape[1] < w2 * 2:
                    pad[:, cur.shape[1]:] = pad[:, cur.shape[1] - 1:cur.shape[1]]
                levels.append(pad.reshape(h2, 2, w2, 2).max(axis=(1, 3)))
            pyr = levels
        self._max_alpha_pyr = (self.data_version, pyr)
        return pyr

    def device_image(self):
        """The device-resident image when this texture is fed by
        SetDeviceImage, else None."""
        return getattr(self, "_device_image", None)

    def device_image_chw(self) -> bool:
        return getattr(self, "_device_chw", False)

    def image_shape(self, slot: int | None = None):
        """(H, W, C) of the current (or given) slot WITHOUT forcing a
        device->host transfer of lazy device images."""
        slot = self.current_slot if slot is None else slot
        if not self.slots or slot >= len(self.slots):
            return None
        img = self.slots[slot]
        return None if img is None else tuple(img.shape)
