"""Helpers the tile-binned solve (raster/cuda_tiled.py) shares with the
reference's tiled path: the screen-bbox classifier, the packed-row column
layout, and the all-tiles row reduce of the beyond-cap remainders.

The counterpart of the helper half of ``ckrenderengine_tpu.raster.tiled``;
its XLA solve (``depth_reduce_tiled``) is deliberately not carried — the
CUDA solve and its plain version are the port's only tiled solve.
"""

from __future__ import annotations

import functools

import torch


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _screen_bbox(xyw, z, eps=1e-6):
    """Per-triangle pixel bbox, with near/far-plane clipping for straddlers.

    xyw (T,3,3) screen-homogeneous; z (T,3) clip z. For triangles with all
    w > eps the bbox is the projected-vertex hull. For w-crossing triangles
    the VISIBLE region is the triangle clipped to {z >= 0, z <= w}, whose
    projected hull is the hull of <= 9 candidate points: kept vertices plus
    edge intersections with either clip plane. If any in-region candidate
    has w <= eps — or the z=0 cut crosses w=0 inside the triangle — the
    projection is unbounded and the triangle stays exact via the global bin.

    Returns (x0, y0, x1, y1, unbounded, empty), each (T,).
    """
    hxc = tuple(xyw[:, i, 0] for i in range(3))
    hyc = tuple(xyw[:, i, 1] for i in range(3))
    wc = tuple(xyw[:, i, 2] for i in range(3))
    hzc = tuple(z[:, i] for i in range(3))
    wcross = (wc[0] <= eps) | (wc[1] <= eps) | (wc[2] <= eps)

    def min3(a, b, c):
        return torch.minimum(torch.minimum(a, b), c)

    def max3(a, b, c):
        return torch.maximum(torch.maximum(a, b), c)

    # --- fast path: plain projected hull --------------------------------
    sw = tuple(torch.where(torch.abs(wi) < eps, eps, wi) for wi in wc)
    sx = tuple(hxc[i] / sw[i] for i in range(3))
    sy = tuple(hyc[i] / sw[i] for i in range(3))
    px0 = min3(*sx)
    px1 = max3(*sx)
    py0 = min3(*sy)
    py1 = max3(*sy)

    # --- straddler path: candidates of the {z>=0, z<=w} clipped region --
    d0c = hzc                                          # z >= 0 halfspace
    d1c = tuple(wc[i] - hzc[i] for i in range(3))      # z <= w halfspace
    scale = (max3(*(torch.abs(zi) for zi in hzc))
             + max3(*(torch.abs(wi) for wi in wc)) + 1e-30)
    tol = 1e-5 * scale

    cand_x = [hxc[i] for i in range(3)]
    cand_y = [hyc[i] for i in range(3)]
    cand_w = [wc[i] for i in range(3)]
    cand_ok = [(d0c[i] >= -tol) & (d1c[i] >= -tol) for i in range(3)]
    z0_edge_w = []
    z0_edge_ok = []
    for (a, b) in ((0, 1), (1, 2), (2, 0)):
        for k, dplane in enumerate((d0c, d1c)):
            da, db = dplane[a], dplane[b]
            crosses = (da * db) < 0
            tt = da / torch.where(torch.abs(da - db) < 1e-30, 1e-30, da - db)
            tt = torch.clamp(tt, 0.0, 1.0)
            ix = hxc[a] + tt * (hxc[b] - hxc[a])
            iy = hyc[a] + tt * (hyc[b] - hyc[a])
            iw = wc[a] + tt * (wc[b] - wc[a])
            iz = hzc[a] + tt * (hzc[b] - hzc[a])
            other = (iw - iz >= -tol) if k == 0 else (iz >= -tol)
            cand_x.append(ix)
            cand_y.append(iy)
            cand_w.append(iw)
            cand_ok.append(crosses & other)
            if k == 0:
                z0_edge_w.append(iw)
                z0_edge_ok.append(crosses & other)

    inf = float("inf")
    any_cand = functools.reduce(torch.logical_or, cand_ok)
    wmin_in = functools.reduce(
        torch.minimum, (torch.where(ok, w_, inf)
                        for ok, w_ in zip(cand_ok, cand_w)))
    z0_wmin = functools.reduce(
        torch.minimum, (torch.where(ok, w_, inf)
                        for ok, w_ in zip(z0_edge_ok, z0_edge_w)))
    unbounded = wcross & ((wmin_in <= eps) | (z0_wmin <= eps))
    empty_straddle = wcross & ~any_cand

    big = 1.0e9
    csx = []
    csy = []
    for ok, x_, y_, w_ in zip(cand_ok, cand_x, cand_y, cand_w):
        cwm = torch.where(ok, torch.clamp(w_, min=eps), 1.0)
        csx.append((ok, x_ / cwm))
        csy.append((ok, y_ / cwm))
    # +1px conservative pad: the straddler hull is computed through lerped
    # intersections whose rounding differs from the per-pixel edge test.
    sx0 = functools.reduce(
        torch.minimum, (torch.where(ok, v, big) for ok, v in csx)) - 1.0
    sx1 = functools.reduce(
        torch.maximum, (torch.where(ok, v, -big) for ok, v in csx)) + 1.0
    sy0 = functools.reduce(
        torch.minimum, (torch.where(ok, v, big) for ok, v in csy)) - 1.0
    sy1 = functools.reduce(
        torch.maximum, (torch.where(ok, v, -big) for ok, v in csy)) + 1.0

    x0 = torch.where(wcross, torch.where(unbounded, -big, sx0), px0)
    x1 = torch.where(wcross, torch.where(unbounded, big, sx1), px1)
    y0 = torch.where(wcross, torch.where(unbounded, -big, sy0), py0)
    y1 = torch.where(wcross, torch.where(unbounded, big, sy1), py1)
    return x0, y0, x1, y1, unbounded, empty_straddle


# Packed-row column layout of the solve stream (one f32 row per triangle).
_C_EC = slice(0, 9)       # signed edge coefficients (3 edges x [a,b,c])
_C_Z = slice(9, 12)       # vertex clip z
_C_IVS = 12               # s * inv_det
_C_EP = slice(13, 16)     # esum plane [a,b,c]
_C_SS = 16                # orientation sign s
_C_FL = 17                # flags: top-left bits 1/2/4, valid bit 8
_C_RECT = slice(18, 22)   # per-triangle scissor rect
_C_ID = 22                # original triangle id (exact in f32 below 2^24)
_NCOL = 23                # + 3 * n_planes user-clip-plane columns


def _reduce_rows(carry, rows, n_planes, px, py, scissor):
    """Merge packed triangle rows into a (depth, id) carry.

    ``rows`` (..., C, ncol) broadcast against the carry's pixel grid
    ``px``/``py``/``scissor`` (..., H', W'), with C the row axis. Per-pixel
    arithmetic is exactly the flat reduce's (deferred.depth_reduce); exact
    depth ties go to the LATER draw id.
    """
    best_d, best_i = carry
    ec = rows[..., _C_EC]
    zv = rows[..., _C_Z]
    ivs = rows[..., _C_IVS]
    ep = rows[..., _C_EP]
    ss = rows[..., _C_SS]
    fl = rows[..., _C_FL].to(torch.int32)
    rect = rows[..., _C_RECT]
    ids = rows[..., _C_ID].to(torch.int32)
    tl0 = (fl & 1) != 0
    tl1 = (fl & 2) != 0
    tl2 = (fl & 4) != 0
    tv = (fl & 8) != 0

    pxc = px.unsqueeze(-3)                  # (..., 1, H', W')
    pyc = py.unsqueeze(-3)

    def col(a, i):                          # (..., C) -> (..., C, 1, 1)
        return a[..., i, None, None]

    def plane(coef, o):
        return (col(coef, o) * pxc + col(coef, o + 1) * pyc
                + col(coef, o + 2))

    e0 = plane(ec, 0)
    e1 = plane(ec, 3)
    e2 = plane(ec, 6)
    cov = (((e0 > 0) | ((e0 == 0) & tl0[..., None, None]))
           & ((e1 > 0) | ((e1 == 0) & tl1[..., None, None]))
           & ((e2 > 0) | ((e2 == 0) & tl2[..., None, None])))
    esum = plane(ep, 0) * ss[..., None, None]
    depth = (e0 * col(zv, 0) + e1 * col(zv, 1)
             + e2 * col(zv, 2)) * ivs[..., None, None]
    cov &= ((esum > 0) & (depth >= 0.0) & (depth <= 1.0)
            & tv[..., None, None] & scissor.unsqueeze(-3))
    cov &= ((pxc >= col(rect, 0)) & (pyc >= col(rect, 1))
            & (pxc < col(rect, 2)) & (pyc < col(rect, 3)))
    for p in range(n_planes):
        cov &= plane(rows[..., _NCOL + 3 * p:_NCOL + 3 * p + 3], 0) >= 0
    dm = torch.where(cov, depth, 3.0e38)
    dmin = torch.amin(dm, dim=-3)
    idwin = torch.amax(torch.where(dm == dmin.unsqueeze(-3),
                                   ids[..., None, None], -1), dim=-3)
    better = (idwin >= 0) & ((dmin < best_d)
                             | ((dmin == best_d) & (idwin > best_i)))
    return torch.where(better, dmin, best_d), torch.where(better, idwin, best_i)
