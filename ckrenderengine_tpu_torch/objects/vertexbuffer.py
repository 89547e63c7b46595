"""CKVertexBuffer: user-facing dynamic vertex buffer + immediate draw.

API mirror of RCKVertexBuffer (include/RCKVertexBuffer.h:8-31,
src/CKVertexBuffer.cpp — Check/Lock/Draw against the rasterizer's dynamic
VB pool) and the render context's user DrawPrimitive staging buffer
(RCKRenderContext::GetDrawPrimitiveStructure, src/CKRenderContext.cpp:967),
carried from the reference package's objects/vertexbuffer.py.

``Lock`` returns numpy staging views. ``Draw`` (through :func:`draw_clip`,
which ``CKRenderContext.DrawPrimitive`` calls directly) builds the padded
triangle batch on the host, as the reference does, uploads it once to the
render context's device and composites it onto the context's fb / zb there
through ``raster.torch_backend.render_pass`` — the analogue of an
out-of-scene-graph DrawPrimitive call, and the route the rasterizer HAL's
draws take (``raster/hal.py``). Reading ``rc.fb`` resolves a pending frame
window first, so the draw lands on the resolved frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..raster import batch as rbatch
from ..raster.types import RasterState, VXCULL, VXPRIMITIVE, pack_states
from .base import CKContext, CKObject

CK_VB_OK = 0
CK_VB_LOST = 1
CK_VB_FAILED = 2


class CKVertexBuffer(CKObject):
    def __init__(self, context: CKContext, name: str = "",
                 max_vertices: int = 1024):
        super().__init__(context, name)
        self.max_vertices = int(max_vertices)
        self.positions = np.zeros((self.max_vertices, 4), np.float32)  # clip xyzw
        self.colors = np.ones((self.max_vertices, 4), np.float32)
        self.uvs = np.zeros((self.max_vertices, 2), np.float32)
        self._locked = None
        self._count = 0

    def Check(self, count: int) -> int:
        """(reference Check: ensure capacity)"""
        if count > self.max_vertices:
            grow = max(count, 2 * self.max_vertices)
            for attr, fill in (("positions", 0.0), ("colors", 1.0), ("uvs", 0.0)):
                a = getattr(self, attr)
                out = np.full((grow,) + a.shape[1:], fill, np.float32)
                out[: a.shape[0]] = a
                setattr(self, attr, out)
            self.max_vertices = grow
        return CK_VB_OK

    def Lock(self, start: int, count: int):
        """Returns (positions, colors, uvs) staging views for [start, start+count)."""
        self.Check(start + count)
        self._locked = (start, count)
        self._count = max(self._count, start + count)
        sl = slice(start, start + count)
        return self.positions[sl], self.colors[sl], self.uvs[sl]

    def Unlock(self):
        self._locked = None

    def GetCount(self) -> int:
        return self._count

    def Draw(self, rc, prim_type: int = int(VXPRIMITIVE.TRIANGLELIST),
             start: int = 0, count: int | None = None,
             state: RasterState | None = None, texture=None):
        """Immediate draw of clip-space vertices onto rc's framebuffer.

        Positions are CLIP-space xyzw (pre-transformed, the VxDrawPrimitive
        screen/clip path of the reference); the raster pass runs now, on
        the device of rc's buffers (:func:`draw_clip`).
        """
        count = count if count is not None else self._count - start
        v = slice(start, start + count)
        return draw_clip(rc, prim_type, self.positions[v], self.colors[v],
                         self.uvs[v], state, texture)

    def Destroy(self):
        """Release the buffer storage (reference RCKVertexBuffer::Destroy);
        the object stays and can be re-Checked into a new allocation."""
        self.positions = self.positions[:0]
        self.colors = self.colors[:0]
        self.uvs = self.uvs[:0]
        self._count = 0
        self.max_vertices = 0


def draw_clip(rc, prim_type: int, pos, col, uv,
              state: RasterState | None = None, texture=None) -> bool:
    """Composite clip-space vertices ``pos`` (n, 4) with colours ``col``
    (n, 4) and UVs ``uv`` (n, 2) onto rc's fb / zb as ``prim_type``: the
    host batch of the reference's ``CKVertexBuffer.Draw``, uploaded once
    to the device of rc's buffers and drawn through ``render_pass``. The
    arrays are only read."""
    from ..convert import device_batch_from_host
    from ..raster.torch_backend import render_pass

    pos, col, uv = (np.asarray(a, np.float32) for a in (pos, col, uv))
    count = pos.shape[0]
    if prim_type == int(VXPRIMITIVE.POINTLIST):
        if count < 1:
            return False
    elif count < 3:
        return False
    if prim_type == int(VXPRIMITIVE.POINTLIST):
        # Points draw as pixel-sized right triangles around each vertex
        # (the reference's DrawPrimitive(VX_POINTLIST) path).
        vxp, vyp, vw, vh = rc.viewport
        dx = 2.0 / max(vw, 1) * 1.5
        dy = 2.0 / max(vh, 1) * 1.5
        p = np.repeat(pos, 3, axis=0).reshape(count, 3, 4)
        w_ = np.maximum(p[..., 3:4], 1e-6)
        p[:, 1, 0] += dx * w_[:, 1, 0]
        p[:, 2, 1] -= dy * w_[:, 2, 0]
        pos = p.reshape(-1, 4)
        col = np.repeat(col, 3, axis=0)
        uv = np.repeat(uv, 3, axis=0)
        count = count * 3
        prim_type = int(VXPRIMITIVE.TRIANGLELIST)
    if prim_type == int(VXPRIMITIVE.TRIANGLESTRIP):
        t = count - 2
        idx = np.stack([
            np.arange(t), np.arange(1, t + 1), np.arange(2, t + 2)], -1)
        flip = (np.arange(t) % 2) == 1
        idx[flip] = idx[flip][:, [1, 0, 2]]
    elif prim_type == int(VXPRIMITIVE.TRIANGLEFAN):
        t = count - 2
        idx = np.stack([
            np.zeros(t, np.int64), np.arange(1, t + 1),
            np.arange(2, t + 2)], -1)
    else:
        t = count // 3
        idx = np.arange(t * 3).reshape(-1, 3)
    tb = rbatch.make_batch(
        pos[idx], view=rc.viewport, color=col[idx], uv=uv[idx],
        pad_to=max(8, ((t + 7) // 8) * 8))
    # Immediate draws default to no culling (user geometry has no
    # guaranteed winding; matches the reference's 2D/DP paths).
    st = state or RasterState(cull=int(VXCULL.NONE))
    if texture is not None and st.tex < 0:
        st = dataclasses.replace(st, tex=0)
    si, sf = pack_states([st])
    fb, zb = rc.fb, rc.zb
    dev = fb.device
    db = device_batch_from_host(tb, dev)
    if texture is not None:
        # Level 0 of the bound image; a device-fed texture is read back
        # to the host here, as the reference reads it.
        img = texture.current_image()
        tex_planes = torch.as_tensor(
            np.ascontiguousarray(np.moveaxis(img, -1, 0))[None],
            dtype=torch.float32, device=dev)
        tex_hw = torch.tensor([[img.shape[0], img.shape[1]]],
                              dtype=torch.int32, device=dev)
    else:
        tex_planes = torch.zeros((1, 4, 1, 1), dtype=torch.float32,
                                 device=dev)
        tex_hw = torch.ones((1, 2), dtype=torch.int32, device=dev)
    rc.fb, rc.zb = render_pass(
        fb, zb, db, torch.as_tensor(si, device=dev),
        torch.as_tensor(sf, device=dev), tex_planes, tex_hw,
        torch.zeros(3, dtype=torch.float32, device=dev),
        torch.tensor(rc.viewport, dtype=torch.float32, device=dev))
    return True
