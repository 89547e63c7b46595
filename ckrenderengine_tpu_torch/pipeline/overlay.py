"""2D overlay compositing: screen-space textured quads over/under the 3D pass.

The reference draws 2D entities as 4-vertex screen-space fans through the
rasterizer (RCK2dEntity::Draw, src/CK2dEntity.cpp:805-908), background tree
before the 3D scene and foreground tree after (CKRenderedScene::Draw
:166-179, :314-327). Here all visible quads of one layer are packed into a
QuadBank and composited in bank order onto the (4,H,W) framebuffer:
axis-aligned boxes, so per-quad coverage is two range tests, and texturing
samples with one texture slot per quad.

Each quad works on a window of the frame: the pixels whose centres its
rect can cover, taken from the host's quad list (:func:`quad_windows`), so
no device value is read back. Without windows a quad works on the whole
frame; the arithmetic per pixel is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class QuadBank(NamedTuple):
    """Q screen-space quads in composite order (back to front)."""

    rect: torch.Tensor      # (Q,4) f32 pixel rect [x0,y0,x1,y1]
    uvrect: torch.Tensor    # (Q,4) f32 [u0,v0,u1,v1]
    color: torch.Tensor     # (Q,4) f32 modulate RGBA
    tex: torch.Tensor       # (Q,) int32 texture slot, -1 = untextured
    blend: torch.Tensor     # (Q,) int32 1 = alpha blend, 0 = opaque copy
    valid: torch.Tensor     # (Q,) bool


def build_quad_bank(quads: list[dict], pad: int = 4,
                    device=None) -> QuadBank | None:
    """Host: list of dicts (rect, uvrect, color, tex, blend) -> QuadBank."""
    if not quads:
        return None
    q = len(quads)
    qp = max(pad, ((q + pad - 1) // pad) * pad)
    rect = np.zeros((qp, 4), np.float32)
    uvrect = np.tile(np.array([0, 0, 1, 1], np.float32), (qp, 1))
    color = np.ones((qp, 4), np.float32)
    tex = np.full(qp, -1, np.int32)
    blend = np.zeros(qp, np.int32)
    valid = np.zeros(qp, bool)
    for i, d in enumerate(quads):
        rect[i] = d["rect"]
        uvrect[i] = d.get("uvrect", (0, 0, 1, 1))
        color[i] = d.get("color", (1, 1, 1, 1))
        tex[i] = d.get("tex", -1)
        blend[i] = int(d.get("blend", 1))
        valid[i] = True

    def dev(a):
        return torch.as_tensor(a, device=device)

    return QuadBank(rect=dev(rect), uvrect=dev(uvrect), color=dev(color),
                    tex=dev(tex), blend=dev(blend), valid=dev(valid))


def quad_windows(quads: list[dict], height: int, width: int,
                 ss: int = 1) -> tuple:
    """Host: for each quad of the list, the frame window (y0, x0, h, w)
    holding every pixel centre its rect covers, or None where it covers
    none. The covered centres are columns [ceil(x0 - 0.5), ceil(x1 - 0.5))
    and rows alike; one pixel of margin on each side absorbs the f32
    rounding of the device's own test. ``ss``: the Antialias supersample
    factor; ``height`` and ``width`` are then the render size, and each
    rect is scaled by ss in f32 as the frame's ``unpack_scene`` scales it."""
    out = []
    for d in quads:
        x0, y0, x1, y1 = (float(np.float32(v) * np.float32(ss))
                          for v in d["rect"])
        cx0 = max(math.ceil(x0 - 0.5) - 1, 0)
        cx1 = min(math.ceil(x1 - 0.5) + 1, width)
        cy0 = max(math.ceil(y0 - 0.5) - 1, 0)
        cy1 = min(math.ceil(y1 - 0.5) + 1, height)
        out.append((cy0, cx0, cy1 - cy0, cx1 - cx0)
                   if cx1 > cx0 and cy1 > cy0 else None)
    return tuple(out)


def _composite_one(sub, px, py, q, tex_planes, tex_hw):
    """Composite ONE quad onto the (4, h, w) block ``sub`` whose pixel
    centres are (px, py); the reference's arithmetic, operation by
    operation."""
    rect, uvrect, color, tex, blend, valid = q
    x0, y0, x1, y1 = rect[0], rect[1], rect[2], rect[3]
    inside = (px >= x0) & (px < x1) & (py >= y0) & (py < y1) & valid
    # Scalars stay Python numbers: a device tensor made from one would be a
    # blocking host-to-device copy.
    w = torch.clamp(x1 - x0, min=1e-6)
    h = torch.clamp(y1 - y0, min=1e-6)
    u = uvrect[0] + (px - x0) / w * (uvrect[2] - uvrect[0])
    v = uvrect[1] + (py - y0) / h * (uvrect[3] - uvrect[1])

    tid = torch.clamp(tex, 0, tex_hw.shape[0] - 1).long()
    hw = tex_hw.index_select(0, tid.reshape(1))[0]
    tww = hw[1].to(torch.float32)
    thh = hw[0].to(torch.float32)
    iu = torch.minimum(torch.clamp(u * tww, min=0.0), tww - 1).to(torch.int32)
    iv = torch.minimum(torch.clamp(v * thh, min=0.0), thh - 1).to(torch.int32)
    ncols = tex_hw.shape[1]
    _nt, _ch, th, tw = tex_planes.shape
    if ncols >= 4:                 # packed atlas: apply texture offsets
        iu = iu + hw[ncols - 1]
        iv = iv + hw[ncols - 2]
        plane = torch.zeros_like(tid)
    else:
        plane = tid
    # Flat index of each pixel's texel in each of the 4 channel planes.
    chan = torch.arange(4, device=sub.device)[:, None, None]
    idx = ((plane * 4 + chan) * th + iv.long()) * tw + iu.long()
    texel = torch.take(tex_planes, idx).to(torch.float32)      # (4, h, w)
    has_tex = tex >= 0
    src = [torch.where(has_tex, texel[c] * color[c], color[c].expand_as(px))
           for c in range(4)]
    alpha = torch.where(blend != 0, src[3], 1.0)
    out = [torch.where(inside, src[c] * alpha + sub[c] * (1.0 - alpha),
                       sub[c]) for c in range(3)]
    out.append(torch.where(inside, torch.maximum(sub[3], alpha), sub[3]))
    return torch.stack(out)


def composite_quads(fb: torch.Tensor, bank: QuadBank,
                    tex_planes: torch.Tensor, tex_hw: torch.Tensor,
                    height: int, width: int,
                    windows: tuple | None = None,
                    row0: int = 0) -> torch.Tensor:
    """Composite quads onto fb (4,H,W) in bank order. Returns a new fb.

    ``windows``: :func:`quad_windows` of the bank's quads (its first
    ``len(windows)`` rows; the rest are padding and are skipped). Without
    it every row of the bank works on the whole frame. ``row0``: the global
    row of fb's first row (a band of a frame, reference overlay.py:132-160):
    windows and rects stay in global rows, each window is cut to the band's
    rows, and pixel centres are global."""
    q = bank.rect.shape[0]
    if q == 0:
        return fb
    fb = fb.clone(memory_format=torch.contiguous_format)
    dev = fb.device
    rows = range(q) if windows is None else range(len(windows))
    for j in rows:
        quad = tuple(a[j] for a in bank)
        if windows is None:
            oy, ox, wh, ww = row0, 0, height, width
        elif windows[j] is None:
            continue
        else:
            oy, ox, wh, ww = windows[j]
        # The window's global rows inside the band.
        gy0, gy1 = max(oy, row0), min(oy + wh, row0 + height)
        if gy1 <= gy0:
            continue
        pxw = torch.arange(ox, ox + ww, dtype=torch.float32,
                           device=dev)[None, :] + 0.5
        pyw = torch.arange(gy0, gy1, dtype=torch.float32,
                           device=dev)[:, None] + 0.5
        pxw, pyw = torch.broadcast_tensors(pxw, pyw)
        ly0, ly1 = gy0 - row0, gy1 - row0
        sub = fb[:, ly0:ly1, ox:ox + ww]
        fb[:, ly0:ly1, ox:ox + ww] = _composite_one(
            sub, pxw, pyw, quad, tex_planes, tex_hw)
    return fb


def composite_label(fb: torch.Tensor, label: torch.Tensor, x: int,
                    y: int) -> torch.Tensor:
    """A copy of the (4, H, W) framebuffer with the RGBA label (h, w, 4),
    on fb's device, alpha-composited at pixel (x, y): RGB over, alpha the
    larger of the two (reference ``composite_label``, the debug mode's
    stepping label). It runs after the frame, on the whole (a banded
    frame's assembled) framebuffer."""
    h, w = label.shape[0], label.shape[1]
    lab = label.permute(2, 0, 1)
    out = fb.clone()
    dst = fb[:, y:y + h, x:x + w]
    a = lab[3:4]
    out[:3, y:y + h, x:x + w] = lab[:3] * a + dst[:3] * (1.0 - a)
    out[3:4, y:y + h, x:x + w] = torch.maximum(dst[3:4], a)
    return out


def raster_label(text: str, max_w: int, pad: int = 2) -> np.ndarray:
    """Host: ``text`` in white over translucent black ((0, 0, 0, 160)),
    ``pad`` pixels in from each side, the width clipped to ``max_w``:
    (h, w, 4) f32 in [0, 1]. Drawn from the default glyph table, which
    equals Pillow's default font (the reference rasters the label with
    Pillow)."""
    from ..objects.entity2d import raster_text, text_bbox

    bb = text_bbox(text)
    w = min(max(bb[2] + 2 * pad, 1), max_w)
    h = bb[3] + 2 * pad
    img = raster_text(text, w, h, (255, 255, 255, 255), (0, 0, 0, 160),
                      x=pad, y=pad)
    return img.astype(np.float32) / 255.0


class Sprite3DBank(NamedTuple):
    """S billboard sprites expanded on the device (4 vertices, 2 triangles
    each). Sprite s owns pool rows pool_base[s] .. pool_base[s] + 3 in
    corner order (-x-y, +x-y, +x+y, -x+y)."""

    entity_row: torch.Tensor  # (S,) int32
    size: torch.Tensor        # (S,2) world-size (w,h)
    offset: torch.Tensor      # (S,2) centre offset in the billboard plane
    mode: torch.Tensor        # (S,) int32 VXSPRITE3D mode
    pool_base: torch.Tensor   # (S,) int32 first pool row of the sprite
    valid: torch.Tensor       # (S,) bool


# Sprite3D modes (reference VXSPRITE3D_TYPE).
SPRITE3D_BILLBOARD = 0
SPRITE3D_XROTATE = 1
SPRITE3D_YROTATE = 2
SPRITE3D_ORIENTABLE = 3


def apply_billboards(world: torch.Tensor, view: torch.Tensor,
                     positions: torch.Tensor, bank: Sprite3DBank,
                     visible: torch.Tensor | None = None) -> torch.Tensor:
    """The vertex pool with every sprite's 4 corner positions (world space)
    written into its rows; a new tensor (``positions`` is left as it is).

    The reference batches sprites per material and fills 4 vertices and 6
    indices per sprite in camera space on the CPU
    (RCKRenderContext::AddSprite3DBatch, src/CKRenderContext.cpp:2841-2921).
    Here all sprites expand in one vectorised step, and the pool rows ride
    the instanced stream bound to the identity entity row. The rows are a
    per-compile set: an invalid sprite's rows go to a dump row past the
    pool, so nothing here depends on a value read back from the device."""
    if bank.entity_row.shape[0] == 0:
        return positions
    erow = bank.entity_row.long()
    wm = world.index_select(0, erow)                         # (S,4,4)
    center = wm[:, 3, :3]                                    # (S,3)

    # Camera right/up in world space: V maps world->camera (row vectors),
    # so the world direction imaging to camera +x is column 0 of V's 3x3.
    cam_right = view[:3, 0]
    cam_up = view[:3, 1]
    cam_right = cam_right / torch.clamp(torch.linalg.vector_norm(cam_right),
                                        min=1e-12)
    cam_up = cam_up / torch.clamp(torch.linalg.vector_norm(cam_up),
                                  min=1e-12)

    ent_right = wm[:, 0, :3]
    ent_up = wm[:, 1, :3]

    mode = bank.mode[:, None]
    right = torch.where(mode == SPRITE3D_ORIENTABLE, ent_right,
                        cam_right[None])
    up = torch.where(mode == SPRITE3D_ORIENTABLE, ent_up, cam_up[None])
    # Axis-locked rotations: keep the world axis, billboard the other.
    right = torch.where(mode == SPRITE3D_YROTATE, ent_right, right)
    up = torch.where(mode == SPRITE3D_XROTATE, ent_up, up)

    hw = bank.size[:, 0:1] * 0.5
    hh = bank.size[:, 1:2] * 0.5
    ox = bank.offset[:, 0:1]
    oy = bank.offset[:, 1:2]
    c = center + right * ox + up * oy
    corners = torch.stack([
        c - right * hw - up * hh,
        c + right * hw - up * hh,
        c + right * hw + up * hh,
        c - right * hw + up * hh,
    ], dim=1)                                                # (S,4,3)

    if visible is not None:
        vis = visible.index_select(0, erow)
        # Invisible sprites collapse to a point (culled in setup).
        corners = torch.where(vis[:, None, None], corners, center[:, None, :])

    v = positions.shape[0]
    rows = (bank.pool_base[:, None].long()
            + torch.arange(4, device=positions.device)[None])
    rows = torch.where(bank.valid[:, None], rows, v).reshape(-1)
    out = torch.cat([positions, positions.new_zeros((1, 3))])
    out.index_copy_(0, rows, corners.reshape(-1, 3).to(out.dtype))
    return out[:v]
