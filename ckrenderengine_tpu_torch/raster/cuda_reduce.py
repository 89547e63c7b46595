"""Flat depth argmin solve for small frames: CUDA kernel B2 + its plain twin.

The counterpart of ``ckrenderengine_tpu.raster.pallas_reduce``: every
triangle is solved against every pixel with no binning (the plain version
evaluates all T*H*W pairs; the kernel drops rows per 16x8 strip by an exact
scan), so the frame takes this path only for small frames (t <= 4096,
t*H*W <= 2^26) without a kept z-buffer or user clip planes. On a CUDA
tensor :func:`depth_reduce_cuda` launches the hand-written kernel
(``csrc/reduce_flat.cu``); on a CPU tensor it runs
:func:`depth_reduce_plain`, the same arithmetic in torch.

Packed per-triangle row layout (F32_FIELDS floats):
  [0:9]   e0/e1/e2 coefficients (a, b, c), signed (s * adj)
  [9:12]  top-left flags (0/1)
  [12:15] vertex z (z0, z1, z2)
  [15]    inv_det_s
  [16:19] esum plane coefficients
  [19]    s sign
  [20]    valid (0/1)
  [21:25] clip rect (x0, y0, x1, y1)
  [25]    triangle id (as float; exact for id < 2^24)
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .deferred import f32_on, pixel_centres

F32_FIELDS = 32          # padded row width
_BIG = 3.0e38


def pack_rows(setup, defer_tri) -> torch.Tensor:
    """(T, F32_FIELDS) packed triangle rows for the kernel."""
    t = setup["e_coef"].shape[0]
    dev = setup["e_coef"].device
    rows = torch.zeros((t, F32_FIELDS), dtype=torch.float32, device=dev)
    rows[:, 0:9] = setup["e_coef"].reshape(t, 9)
    rows[:, 9:12] = setup["top_left"].to(torch.float32)
    rows[:, 12:15] = setup["z"]
    rows[:, 15] = setup["inv_det_s"]
    rows[:, 16:19] = setup["esum_plane"]
    rows[:, 19] = setup["s"]
    rows[:, 20] = (setup["valid"] & defer_tri).to(torch.float32)
    rows[:, 21:25] = setup["clip_rect"]
    rows[:, 25] = torch.arange(t, dtype=torch.float32, device=dev)
    return rows


def _view5(clear_z, viewport, dev) -> torch.Tensor:
    return torch.cat([torch.as_tensor(viewport, dtype=torch.float32,
                                      device=dev).reshape(4),
                      f32_on(clear_z, dev).reshape(1)])


def depth_reduce_plain(rows: torch.Tensor, clear_z, viewport, height: int,
                       width: int, chunk: int = 64, row0: int = 0):
    """Plain torch version of the B2 kernel over ``pack_rows`` rows:
    deferred.depth_reduce's arithmetic, chunked over rows. ``row0``: the
    global row of the frame's first row (a band of a frame): pixel centres
    (y + 0.5) + row0, the viewport in global rows. Returns (best_id (H,W)
    int32, best_depth (H,W) f32)."""
    dev = rows.device
    py, px = pixel_centres(height, width, dev, row0)
    view = _view5(clear_z, viewport, dev)
    scissor = ((px >= view[0]) & (px < view[0] + view[2])
               & (py >= view[1]) & (py < view[1] + view[3]))
    best_d = view[4].expand(height, width).clone()
    best_i = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, rows.shape[0], chunk):
        r = rows[c0:c0 + chunk]

        def col(i):
            return r[:, i, None, None]

        def plane(o):
            return col(o) * px + col(o + 1) * py + col(o + 2)

        e0 = plane(0)
        e1 = plane(3)
        e2 = plane(6)
        cov = (((e0 > 0) | ((e0 == 0) & (col(9) > 0)))
               & ((e1 > 0) | ((e1 == 0) & (col(10) > 0)))
               & ((e2 > 0) | ((e2 == 0) & (col(11) > 0))))
        depth = (e0 * col(12) + e1 * col(13) + e2 * col(14)) * col(15)
        esum = plane(16) * col(19)
        cov &= ((esum > 0) & (depth >= 0.0) & (depth <= 1.0) & scissor[None]
                & (col(20) > 0))
        cov &= ((px >= col(21)) & (py >= col(22)) & (px < col(23))
                & (py < col(24)))
        ids = r[:, 25].to(torch.int32)
        dm = torch.where(cov, depth, _BIG)
        dmin = torch.amin(dm, dim=0)
        idwin = torch.amax(torch.where(dm == dmin[None], ids[:, None, None],
                                       -1), dim=0)
        better = (idwin >= 0) & ((dmin < best_d)
                                 | ((dmin == best_d) & (idwin > best_i)))
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, idwin, best_i)
    return best_i, best_d


def reduce_flat_kernel(rows: torch.Tensor, clear_z, viewport, height: int,
                       width: int, row0: int = 0):
    """Launch kernel B2 on CUDA ``rows`` (T, 32), the frame's first row at
    global row ``row0``. Returns (best_id (H,W) int32, best_depth (H,W)
    f32)."""
    if not rows.is_cuda or rows.dtype != torch.float32 \
            or rows.dim() != 2 or rows.shape[1] != F32_FIELDS:
        raise ValueError("reduce_flat_kernel takes CUDA f32 rows (T, 32)")
    lib = cuda_build.library().lib
    dev = rows.device
    rows = rows.contiguous()   # 16-byte aligned: the kernel refuses others
    view = _view5(clear_z, viewport, dev).contiguous()
    best_d = torch.empty((height, width), dtype=torch.float32, device=dev)
    best_i = torch.empty((height, width), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ck_reduce_flat(rows.data_ptr(), rows.shape[0], view.data_ptr(),
                              best_d.data_ptr(), best_i.data_ptr(), height,
                              width, float(row0), stream)
    cuda_build.check("ck_reduce_flat", code)
    reduce_flat_kernel.launches += 1
    return best_i, best_d


reduce_flat_kernel.launches = 0


def depth_reduce_cuda(setup, defer_tri, clear_z, viewport, height: int,
                      width: int, row0: int = 0):
    """Flat depth reduce (the counterpart of pallas_reduce.depth_reduce_pallas)
    of ``height`` rows from global row ``row0`` (a band of a frame).
    Returns (best_id (H,W) int32, best_depth (H,W) f32)."""
    rows = pack_rows(setup, defer_tri)
    if rows.is_cuda:
        return reduce_flat_kernel(rows, clear_z, viewport, height, width,
                                  row0)
    return depth_reduce_plain(rows, clear_z, viewport, height, width,
                              row0=row0)
