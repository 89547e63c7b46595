"""The line pass: screen-space segments over the rendered frame, kernel L1.

The counterpart of ``ckrenderengine_tpu.pipeline.lines``. The reference
draws mesh line lists through DrawPrimitive(VX_LINELIST) (RCKMesh::
DefaultRender line pass, src/CKMesh.cpp:4168-4192) and uses them for
curves (RCKCurve renders as a line mesh) and wireframe fills. All line
segments of a scene are one :class:`LineBank`, built once per compile. Each
frame transforms the endpoints along the triangles' vertex path
(:func:`line_rows`, torch), then composites distance-to-segment coverage,
with a z test against the frame's depth buffer and no z write, over the
frame in bank order: the colour of the last covering segment, the alpha
the largest of the pixel's and every covering segment's.

On a CUDA tensor :func:`draw_lines` launches the hand-written kernel L1
(``csrc/lines.cu``): a bin step (:func:`line_bins_kernel`: per 32x8 tile a
bitmask of the segments that can reach it) and the draw, which walks only
its tile's bin. On a CPU tensor it runs :func:`draw_lines_plain`, the
reference's arithmetic in its order. The reference's per-line loop within
a chunk only selects, so the plain version takes each chunk's selection in
one step (the highest covering index's colour, the maximum of the alphas);
the result equals the sequential loop bit for bit. :func:`line_bins_plain`
is the bin step's plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from ..math import vxmath as vx

HALF_WIDTH = 0.7          # the reference's draw_lines defaults
Z_BIAS = 1e-4
CHUNK = 32
# One projected segment per row: ax ay bx by z0 z1 valid (pad) r g b a.
ROW_FLOATS = 12
# L1's tiles: the bin step keeps one bitmask of the bank per tile.
TILE_W, TILE_H = 32, 8


class LineBank(NamedTuple):
    """L line segments over the instanced vertex stream."""

    idx: torch.Tensor       # (L,2) int32 into the stream (src_idx space)
    color: torch.Tensor     # (L,4) f32
    valid: torch.Tensor     # (L,) bool


def build_line_bank(segments: list[dict], pad: int = 8,
                    device=None) -> LineBank | None:
    """Host: list of dicts (i0, i1, color) -> LineBank on ``device``, padded
    to a multiple of ``pad`` rows with invalid segments; None when there is
    no segment."""
    if not segments:
        return None
    n = len(segments)
    lp = max(pad, ((n + pad - 1) // pad) * pad)
    idx = np.zeros((lp, 2), np.int32)
    color = np.ones((lp, 4), np.float32)
    valid = np.zeros(lp, bool)
    for i, s in enumerate(segments):
        idx[i] = (s["i0"], s["i1"])
        color[i] = s.get("color", (1, 1, 1, 1))
        valid[i] = True
    return LineBank(idx=torch.as_tensor(idx, device=device),
                    color=torch.as_tensor(color, device=device),
                    valid=torch.as_tensor(valid, device=device))


def visible_lines(bank: LineBank, scene) -> LineBank:
    """``bank`` with the segments of entities hidden in this frame made
    invalid (``scene.entity_visible``: Show(False) or debug stepping, which
    change no compile). The reference draws every compiled segment."""
    from .frame import _take

    vis = torch.cat([scene.entity_visible, torch.ones(
        1, dtype=torch.bool, device=scene.entity_visible.device)])
    ent = _take(scene.vert_entity, bank.idx[:, 0])
    return bank._replace(valid=bank.valid & _take(vis, ent))


def line_rows(scene, world: torch.Tensor, bank: LineBank) -> torch.Tensor:
    """(L, ROW_FLOATS) f32 projected segments: the endpoints through the
    triangles' vertex path (pool row, entity world matrix, view and
    projection, viewport), as the reference's draw_lines transforms them
    (pipeline/lines.py:57-87). A segment with an endpoint behind the camera
    (w <= 1e-6) is invalid."""
    from .frame import _take

    dev = world.device
    world_ext = torch.cat([world, torch.eye(4, dtype=world.dtype,
                                            device=dev)[None]])
    ep = bank.idx.reshape(-1)                                 # (2L,)
    src = _take(scene.src_idx, ep)
    ent = _take(scene.vert_entity, ep)
    pos = _take(scene.positions, src)
    wm = _take(world_ext, ent)
    posw = vx.transform_points(pos, wm)
    posw4 = torch.cat([posw, torch.ones_like(posw[:, :1])], dim=-1)
    clip = vx.transform_h4(posw4, torch.matmul(scene.view, scene.proj))

    vp = scene.viewport
    w = torch.clamp(clip[:, 3], min=1e-6)
    sx = vp[0] + vp[2] * 0.5 + clip[:, 0] / w * (vp[2] * 0.5)
    sy = vp[1] + vp[3] * 0.5 - clip[:, 1] / w * (vp[3] * 0.5)
    sz = clip[:, 2] / w
    behind = clip[:, 3] <= 1e-6
    valid = bank.valid & ~(behind[0::2] | behind[1::2])
    return torch.stack([sx[0::2], sy[0::2], sx[1::2], sy[1::2], sz[0::2],
                        sz[1::2], valid.to(torch.float32),
                        torch.zeros_like(sz[0::2]), bank.color[:, 0],
                        bank.color[:, 1], bank.color[:, 2],
                        bank.color[:, 3]], dim=1)


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as the reference's weakly typed
    constants are."""
    return float(np.float32(x))


def line_coverage(rows: torch.Tensor, zb: torch.Tensor, height: int,
                  width: int, half_width: float = HALF_WIDTH,
                  z_bias: float = Z_BIAS, row0: float = 0.0) -> torch.Tensor:
    """(L,H,W) bool: which pixels each :func:`line_rows` segment covers
    (distance and z test), the reference's per-pixel arithmetic in its
    order."""
    dev = rows.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5
          + row0)[:, None]

    def col(i):
        return rows[:, i, None, None]

    ax, ay = col(0), col(1)
    dx = col(2) - ax
    dy = col(3) - ay
    len2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
    pax = px - ax
    pay = py - ay
    t = torch.clamp((pax * dx + pay * dy) / len2, 0.0, 1.0)
    ddx = pax - t * dx
    ddy = pay - t * dy
    dist2 = ddx * ddx + ddy * ddy
    zline = col(4) * (1.0 - t) + col(5) * t
    return ((dist2 <= _f32(half_width * half_width)) & (col(6) > 0.5)
            & (zline <= zb + _f32(z_bias)) & (zline >= 0.0)
            & (zline <= 1.0))


def draw_lines_plain(fb: torch.Tensor, zb: torch.Tensor, rows: torch.Tensor,
                     height: int, width: int, half_width: float = HALF_WIDTH,
                     z_bias: float = Z_BIAS, chunk: int = CHUNK,
                     row0: float = 0.0) -> torch.Tensor:
    """Plain torch version of kernel L1: composite :func:`line_rows`
    segments onto fb (4,H,W) against zb (H,W), ``chunk`` segments at a time
    (:func:`line_coverage`). Returns a new fb."""
    dev = fb.device
    rgb, alpha = fb[:3], fb[3]
    for c0 in range(0, rows.shape[0], chunk):
        r = rows[c0:c0 + chunk]
        cov = line_coverage(r, zb, height, width, half_width, z_bias, row0)
        # Later lines win: the colour of the highest covering index.
        k = torch.arange(r.shape[0], device=dev)[:, None, None]
        last = torch.where(cov, k, -1).amax(0)
        sel = r[:, 8:11].index_select(0, last.clamp(min=0).reshape(-1))
        rgb = torch.where((last >= 0)[None], sel.T.reshape(3, height, width),
                          rgb)
        alpha = torch.maximum(alpha, torch.where(
            cov, r[:, 11, None, None], -torch.inf).amax(0))
    return torch.cat([rgb, alpha[None]])


def bin_shape(n_rows: int, height: int, width: int) -> tuple:
    """(tiles, words) of the bins: tiles in row-major order, ceil(L/32)
    32-bit words each."""
    return (-(-height // TILE_H) * -(-width // TILE_W), -(-n_rows // 32))


def line_bins_plain(rows: torch.Tensor, height: int, width: int,
                    row0: float = 0.0,
                    half_width: float = HALF_WIDTH) -> torch.Tensor:
    """Plain torch version of L1's bin step: (tiles, ceil(L/32)) int32
    words (:func:`bin_shape`), bit j of word w set when segment 32 w + j
    may cover a pixel centre of the tile. The test (``csrc/lines.cu``
    ``reaches``) keeps a valid segment with finite endpoints unless its box
    dilated by m = half_width + 1 + 2^-20 (mag + tmag) misses the tile's
    pixel centres, or (where mag <= 2^40) the centres' rect dilated by m
    lies on one side of its line; the kernel's f32 arithmetic in its
    order."""
    dev, f32, row0 = rows.device, torch.float32, _f32(row0)
    n_tiles, n_words = bin_shape(rows.shape[0], height, width)
    tiles_x = -(-width // TILE_W)
    ax, ay, bx, by = (rows[:, k] for k in range(4))
    ok = (rows[:, 6] > 0.5) & torch.isfinite(rows[:, :4]).all(1)
    dx, dy = bx - ax, by - ay
    mag = torch.maximum(torch.maximum(ax.abs(), bx.abs()),
                        torch.maximum(ay.abs(), by.abs()))
    x_hi, x_lo = torch.maximum(ax, bx), torch.minimum(ax, bx)
    y_hi, y_lo = torch.maximum(ay, by), torch.minimum(ay, by)
    capsule = mag <= 2.0 ** 40
    hw1 = torch.tensor(half_width, dtype=f32, device=dev) + 1.0
    tx0 = (torch.arange(tiles_x, dtype=f32, device=dev) * TILE_W
           + 0.5)[:, None]
    tx1 = tx0 + (TILE_W - 1)
    hits = []
    # A few tile rows at a time: (rows, tiles_x, L) temporaries.
    step = max(1, (1 << 22) // max(1, tiles_x * rows.shape[0]))
    for r0 in range(0, -(-height // TILE_H), step):
        ty = torch.arange(r0, min(r0 + step, -(-height // TILE_H)),
                          dtype=f32, device=dev)
        ty0 = ((ty * TILE_H + 0.5) + row0)[:, None, None]
        ty1 = ty0 + (TILE_H - 1)
        tmag = torch.maximum(torch.maximum(tx1.abs(), ty0.abs()), ty1.abs())
        m = hw1 + (mag + tmag) * 2.0 ** -20
        miss = ((x_hi + m < tx0) | (x_lo - m > tx1) | (y_hi + m < ty0)
                | (y_lo - m > ty1))
        ex = (tx0 + 0.5 * (TILE_W - 1)) - ax
        ey = (ty0 + 0.5 * (TILE_H - 1)) - ay
        cr = dx * ey - dy * ex
        rhs = dx.abs() * (m + 0.5 * (TILE_H - 1)) \
            + dy.abs() * (m + 0.5 * (TILE_W - 1))
        miss |= capsule & (cr.abs() > rhs)
        hits.append((ok & ~miss).reshape(len(ty) * tiles_x, rows.shape[0]))
    hit = torch.cat(hits) if hits else torch.zeros(
        (0, rows.shape[0]), dtype=torch.bool, device=dev)
    hit = torch.nn.functional.pad(hit, (0, n_words * 32 - rows.shape[0]))
    bits = torch.arange(32, device=dev, dtype=torch.int64)
    words = (hit.reshape(n_tiles, n_words, 32).to(torch.int64)
             << bits).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def line_bins_kernel(rows: torch.Tensor, height: int, width: int,
                     row0: float = 0.0,
                     half_width: float = HALF_WIDTH) -> torch.Tensor:
    """Launch L1's bin step on CUDA rows (L, ROW_FLOATS) f32: the
    (tiles, words) int32 bins of :func:`line_bins_plain`. An empty bank
    launches nothing."""
    if not rows.is_cuda or rows.dtype != torch.float32 or rows.dim() != 2 \
            or rows.shape[1] != ROW_FLOATS:
        raise ValueError("line_bins_kernel takes CUDA f32 rows "
                         f"(L, {ROW_FLOATS})")
    bins = torch.empty(bin_shape(rows.shape[0], height, width),
                       dtype=torch.int32, device=rows.device)
    if bins.numel() == 0:
        return bins
    rows = rows.contiguous()    # 16-byte aligned rows: the kernel refuses others
    code = cuda_build.library().lib.ck_line_bins(
        rows.data_ptr(), rows.shape[0], bins.data_ptr(), height, width,
        ctypes.c_float(row0), ctypes.c_float(half_width),
        torch.cuda.current_stream(rows.device).cuda_stream)
    cuda_build.check("ck_line_bins", code)
    line_bins_kernel.launches += 1
    return bins


line_bins_kernel.launches = 0


def lines_kernel(fb: torch.Tensor, zb: torch.Tensor, rows: torch.Tensor,
                 height: int, width: int, half_width: float = HALF_WIDTH,
                 z_bias: float = Z_BIAS, row0: float = 0.0) -> torch.Tensor:
    """Launch kernel L1 on CUDA tensors: fb (4,H,W) f32, zb (H,W) f32,
    rows (L, ROW_FLOATS) f32. The bin step (:func:`line_bins_kernel`),
    then the draw over each tile's bin. Returns a new fb."""
    if not (fb.is_cuda and zb.is_cuda and rows.is_cuda) \
            or rows.dtype != torch.float32 or rows.dim() != 2 \
            or rows.shape[1] != ROW_FLOATS \
            or tuple(fb.shape) != (4, height, width) \
            or tuple(zb.shape) != (height, width):
        raise ValueError("lines_kernel takes CUDA f32 fb (4,H,W), zb (H,W) "
                         f"and rows (L, {ROW_FLOATS})")
    lib = cuda_build.library().lib
    fb_in = fb.to(torch.float32).contiguous()
    zb = zb.to(torch.float32).contiguous()
    rows = rows.contiguous()
    bins = line_bins_kernel(rows, height, width, row0, half_width)
    out = torch.empty_like(fb_in)
    stream = torch.cuda.current_stream(fb.device).cuda_stream
    code = lib.ck_draw_lines(
        rows.data_ptr(), rows.shape[0], bins.data_ptr(), fb_in.data_ptr(),
        zb.data_ptr(), out.data_ptr(), height, width, ctypes.c_float(row0),
        ctypes.c_float(half_width * half_width), ctypes.c_float(z_bias),
        stream)
    cuda_build.check("ck_draw_lines", code)
    lines_kernel.launches += 1
    return out


lines_kernel.launches = 0


def draw_lines(fb: torch.Tensor, zb: torch.Tensor, scene, world: torch.Tensor,
               bank: LineBank, height: int, width: int,
               half_width: float = HALF_WIDTH, z_bias: float = Z_BIAS,
               chunk: int = CHUNK, row0: float = 0.0) -> torch.Tensor:
    """Composite the line bank onto fb (4,H,W) with a z test against zb
    (the counterpart of the reference's draw_lines): kernel L1 on a CUDA
    tensor, :func:`draw_lines_plain` on a CPU tensor. Returns a new fb."""
    if bank.idx.shape[0] == 0:
        return fb
    rows = line_rows(scene, world, bank)
    if rows.is_cuda:
        return lines_kernel(fb, zb, rows, height, width, half_width, z_bias,
                            row0)
    return draw_lines_plain(fb, zb, rows, height, width, half_width, z_bias,
                            chunk, row0)
