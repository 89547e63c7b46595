"""Inputs that stress the flat solve's kernel design (numpy, from a seed).

The CPU tests (the plain flat solve against the reference's) and
``chip_smoke.py`` / ``frame_bench.py`` (kernel B2 against its plain version,
and its time, on the card) share these cases. Each aims at something the
kernel of ``csrc/reduce_flat.cu`` can get wrong or is built for: config 1's
shape (12 real rows among 128, the rest padding), the limits of the flat
route (``t * H * W`` up to 2^26, ``t`` up to 4,096) with small triangles,
with frame-sized ones that reach every strip, and with fewer 16x16
sub-tiles than the card has SMs (the rows split over a cluster), rows that
tie exactly (the later draw wins, also -0.0 against +0.0), a watertight mesh
whose shared edges pass through pixel centres (the top-left rule), rects and
a viewport on and beside the edges of a thread's 4-pixel block and of a
warp's 16x8 strip, a frame that is no multiple of 16 with an odd height, and
rows whose depth leaves [0, 1] or whose esum is not positive where their
edges pass.

:func:`flat_cases` returns dicts with ``name``, ``scale``, the triangles
``xyw`` (T,3,3) and ``z`` (T,3), ``valid`` (T,) bool for a setup that
culls nothing (``VXCULL.NONE``: ``valid`` carries the culling), ``defer``
(T,) bool,
``clip_rect`` (T,4) or None, the frame ``h``/``w``, the ``viewport``,
``clear_z``, ``reference`` (False where the reference's contracted
arithmetic decides pairs apart from the port's, so only the kernel and its
plain version are compared) and ``expect``, what :func:`check_expect` holds the case's
packed rows (and, where given, the solve's ids) to, so that a case keeps
exercising what it was built for. :func:`flat_stats` computes what it holds
them to, in torch, from the kernel's own tests, and :func:`case_rows` a
case's packed rows through the package's own setup. The package is
imported only there, by its absolute name, so that ``frame_bench.py`` can
load this module by path and build the rows with another tree's package.
:func:`band_cases` are bands of a frame (B2 at a row offset): the same keys
and ``row0`` / ``frame_h``.
"""

from __future__ import annotations

import numpy as np

SUB = 16                 # the kernel's sub-tile (a CTA)
STRIP_W, STRIP_H = 16, 8  # a warp's strip
H100_SMS = 132
FLAT_PAIRS = 1 << 26     # the flat route's limit on t * H * W


def _pack(pts, rng, w_range=(0.5, 2.0), z_range=(0.05, 0.95)):
    """Screen points (T,3,2) -> homogeneous (xyw, z) with random w and clip
    z = w * U(z_range)."""
    t = pts.shape[0]
    w = rng.uniform(*w_range, (t, 3, 1)).astype(np.float32)
    xyw = np.concatenate([pts.astype(np.float32) * w, w], axis=-1)
    z = (rng.uniform(*z_range, (t, 3)) * w[:, :, 0]).astype(np.float32)
    return xyw, z


def _small_tris(rng, n, h, w, rad):
    ctr = rng.uniform([0, 0], [w, h], (n, 1, 2))
    ang = (rng.uniform(0, 2 * np.pi, (n, 1))
           + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.5, 0.5, (n, 3)))
    r = rng.uniform(rad[0], rad[1], (n, 3))
    return ctr + np.stack([np.cos(ang) * r, np.sin(ang) * r], -1)


def _case(name, scale, xyw, z, h, w, valid=None, defer=None, clip_rect=None,
          viewport=None, clear_z=1.0, expect=None, reference=True):
    t = xyw.shape[0]
    return dict(
        name=name, scale=scale, reference=reference,
        xyw=xyw.astype(np.float32),
        z=z.astype(np.float32), h=int(h), w=int(w),
        valid=np.ones(t, bool) if valid is None else valid,
        defer=np.ones(t, bool) if defer is None else defer,
        clip_rect=clip_rect,
        viewport=[0.0, 0.0, float(w), float(h)] if viewport is None
        else [float(v) for v in viewport],
        clear_z=float(clear_z), expect=expect or {})


def _cube(size):
    """Config 1's shape: a cube's 12 triangles in perspective, its back
    faces invalid (culled), padded to 128 rows with zero (degenerate,
    invalid) triangles as the scene compile pads the triangle count."""
    v = np.array([[x, y, zz] for x in (-1, 1) for y in (-1, 1)
                  for zz in (-1, 1)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    a, b = 0.6, 0.45
    rot = (np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])
           @ np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]]))
    p = v @ rot.T + np.array([0.0, 0.0, 4.0])
    f = 1.2 * size / 2
    sx = p[:, 0] / p[:, 2] * f + size / 2
    sy = p[:, 1] / p[:, 2] * f + size / 2
    xyw = np.zeros((128, 3, 3), np.float32)
    z = np.zeros((128, 3), np.float32)
    valid = np.zeros(128, bool)
    i = 0
    for q in quads:
        # Outward normal: the face is seen when it points at the eye.
        normal = np.cross(p[q[1]] - p[q[0]], p[q[2]] - p[q[0]])
        centre = p[list(q)].mean(0)
        if normal @ (centre - p.mean(0)) < 0:
            q = q[::-1]
            normal = -normal
        for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            idx = list(tri)
            wv = p[idx, 2]
            xyw[i, :, 0] = sx[idx] * wv
            xyw[i, :, 1] = sy[idx] * wv
            xyw[i, :, 2] = wv
            z[i] = (wv - 2.0) / 4.0 * wv        # depth (w - 2) / 4 in (0, 1)
            valid[i] = normal @ centre < 0
            i += 1
    return xyw, z, valid


def flat_cases(scale: float = 1.0, seed: int = 31) -> list[dict]:
    """The cases at ``scale``: 1 is the card's full size (the route's
    limits); the CPU tests take 0.25, where the four large cases shrink
    their frame (and the two that fill the limit their row count) so that
    the reference's interpreted kernel can solve them. The other cases are
    small at any scale and do not change."""
    out = []

    def dim(n):
        return max(SUB, int(round(n * scale)))

    # Config 1's shape: 12 rows of a cube among 128.
    size = dim(256)
    xyw, z, valid = _cube(size)
    out.append(_case("config1_pad", scale, xyw, z, size, size, valid=valid,
                     expect=dict(rows=128, valid_rows=6,
                                 min_scan_drop=0.9)))

    # The pair limit with small triangles: 1,024 rows over 256x256.
    rng = np.random.default_rng(seed + 1)
    size = dim(256)
    t = 1024 if scale == 1.0 else max(64, int(1024 * scale * scale))
    xyw, z = _pack(_small_tris(rng, t, size, size, (1.5, 6.0)), rng)
    out.append(_case("flat_limit_256", scale, xyw, z, size, size,
                     expect=dict(rows=t, at_limit=scale == 1.0,
                                 min_scan_drop=0.9)))

    # 128 frame-sized rows: every row reaches every strip and covers every
    # pixel, so the kernel's evaluation throughput is what is measured.
    rng = np.random.default_rng(seed + 2)
    h, w = dim(480), dim(640)
    ctr = np.array([w / 2, h / 2]) + rng.uniform(-0.1, 0.1, (128, 1, 2)) * w
    ang = (rng.uniform(0, 2 * np.pi, (128, 1))
           + np.array([0.0, 2.0944, 4.1888]) + rng.uniform(-0.2, 0.2,
                                                            (128, 3)))
    r = 3.0 * max(h, w) * rng.uniform(1.0, 1.3, (128, 3))
    pts = ctr + np.stack([np.cos(ang) * r, np.sin(ang) * r], -1)
    xyw, z = _pack(pts, rng)
    out.append(_case("flat_deep_640", scale, xyw, z, h, w,
                     expect=dict(rows=128, max_scan_drop=0.01,
                                 all_covered=True)))

    # The row limit at 128x128: 4,096 rows, 64 sub-tiles for 132 SMs.
    rng = np.random.default_rng(seed + 3)
    size = dim(128)
    t = 4096 if scale == 1.0 else max(64, int(4096 * scale * scale))
    xyw, z = _pack(_small_tris(rng, t, size, size, (1.0, 10.0)), rng)
    out.append(_case("flat_cap_128", scale, xyw, z, size, size,
                     expect=dict(rows=t, at_limit=scale == 1.0,
                                 fewer_subtiles_than_sms=True)))

    # Exact ties: 20 triangles each drawn three times, 20 and 128 rows
    # apart (the same 32-row stage or the next, and another rank of a split
    # cluster), nearer than the random rows around them; and 8 pairs of
    # adjacent rows at depth exactly 0, the first at +0.0 or -0.0 and the
    # second at the other sign. The last draw must win every pixel.
    rng = np.random.default_rng(seed + 4)
    h, w = 80, 96
    t = 256
    xyw, z = _pack(_small_tris(rng, t, h, w, (4.0, 30.0)), rng,
                   z_range=(0.3, 0.95))
    base_xyw, base_z = _pack(_small_tris(rng, 20, h, w, (6.0, 16.0)), rng,
                             z_range=(0.01, 0.05))
    for first in (0, 20, 128):
        xyw[first:first + 20], z[first:first + 20] = base_xyw, base_z
    shadowed = list(range(40))
    later = list(range(128, 148))
    zero_xyw, _ = _pack(_small_tris(rng, 8, h, w, (8.0, 20.0)), rng)
    for j in range(8):
        a = t - 16 + 2 * j
        xyw[a] = xyw[a + 1] = zero_xyw[j]
        z[a] = np.float32(-0.0) if j % 2 else np.float32(0.0)
        z[a + 1] = -z[a]
        shadowed.append(a)
        later.append(a + 1)
    out.append(_case("exact_ties", 1.0, xyw, z, h, w, expect=dict(
        shadowed=shadowed, later=later)))

    # A watertight mesh: a grid of 8-pixel quads, each cut along one of its
    # diagonals, reaching past the frame, with w = 1 and corners on pixel
    # centres (x.5) in every other column and every third row, so that
    # edge values are exact and pixel centres on shared edges go to exactly
    # one triangle by the top-left rule.
    rng = np.random.default_rng(seed + 5)
    h, w = 72, 88
    gx = np.arange(-8.0, w + 9.0, 8.0)
    gy = np.arange(-8.0, h + 9.0, 8.0)
    gx += np.where(np.arange(gx.size) % 2 == 0, 0.5, 0.0)
    gy += np.where(np.arange(gy.size) % 3 == 0, 0.5, 0.0)
    tris = []
    for j in range(gy.size - 1):
        for i in range(gx.size - 1):
            p00, p10 = (gx[i], gy[j]), (gx[i + 1], gy[j])
            p01, p11 = (gx[i], gy[j + 1]), (gx[i + 1], gy[j + 1])
            if (i + j) % 2:
                tris += [(p00, p10, p11), (p00, p11, p01)]
            else:
                tris += [(p00, p10, p01), (p10, p11, p01)]
    pts = np.asarray(tris, np.float64)
    t = pts.shape[0]
    xyw = np.concatenate([pts, np.ones((t, 3, 1))], -1)
    z = rng.uniform(0.1, 0.9, (t, 3))
    out.append(_case("shared_edges", 1.0, xyw, z, h, w, expect=dict(
        cover_exactly_once=True, min_edge_pairs=100)))

    # Rects and a viewport on and beside the edges of 4-pixel blocks and of
    # 16x8 strips; the viewport leaves the top row and the right column of
    # sub-tiles wholly outside, and the clear depth is 0.8.
    rng = np.random.default_rng(seed + 6)
    h, w = 64, 96
    t = 300
    xyw, z = _pack(_small_tris(rng, t, h, w, (8.0, 40.0)), rng)
    off = np.array([-0.5, 0.0, 0.5])
    x0 = (rng.choice([4, 16], t) * rng.integers(0, w // 16, t)
          + rng.choice(off, t))
    x1 = x0 + rng.choice([4, 16], t) * rng.integers(1, 4, t) + rng.choice(
        off, t)
    y0 = 8 * rng.integers(0, h // 8, t) + rng.choice(off, t)
    y1 = y0 + 8 * rng.integers(1, 4, t) + rng.choice(off, t)
    rect = np.stack([x0, y0, x1, y1], 1).astype(np.float32)
    out.append(_case("block_edges", 1.0, xyw, z, h, w, clip_rect=rect,
                     viewport=[17.5, 16.0, w - 33.0, h - 23.5], clear_z=0.8,
                     expect=dict(outside_subtiles=True)))

    # A frame that is no multiple of 16, of odd height and width.
    rng = np.random.default_rng(seed + 7)
    h, w = dim(123), dim(203)
    h += 1 - h % 2
    w += 1 - w % 2
    t = 1000 if scale == 1.0 else 250
    xyw, z = _pack(_small_tris(rng, t, h, w, (2.0, 20.0)), rng)
    out.append(_case("odd_frame", scale, xyw, z, h, w,
                     expect=dict(odd=True)))

    # Depth outside [0, 1] (clip z beyond [0, w]) on most rows, and a
    # vertex behind the eye (w < 0) on a third of them.
    rng = np.random.default_rng(seed + 8)
    h, w = 64, 80
    t = 200
    xyw, z = _pack(_small_tris(rng, t, h, w, (6.0, 30.0)), rng,
                   z_range=(-0.4, 1.4))
    xyw[rng.random(t) < 0.3, 0] *= -1.0
    out.append(_case("depth_range", 1.0, xyw, z, h, w, expect=dict(
        depth_rejects=True)))

    # Pairs lost to esum <= 0 where all three edges pass. In exact
    # arithmetic the edges' sum is esum, so only rounding makes them:
    # triangles on pixel-centre corners with w up to 1e5, where an edge is
    # exactly 0 and the esum plane, summed before it is evaluated, rounds
    # to 0 (seven pairs). The reference contracts multiply-adds, which moves
    # such pairs, so this case holds the kernel to the plain version only.
    rng = np.random.default_rng(seed + 12)
    t = 400
    p0 = rng.integers(0, [w, h], (t, 2)) + 0.5
    pts = np.stack([p0, p0 + rng.integers(-20, 21, (t, 2)),
                    p0 + rng.integers(-20, 21, (t, 2))], 1)
    wv = rng.uniform(1e3, 1e5, (t, 3, 1))
    xyw = np.concatenate([pts * wv, wv], -1)     # rounded once, to f32
    z = rng.uniform(-0.4, 1.4, (t, 3)) * wv[..., 0]
    out.append(_case("esum_rounding", 1.0, xyw, z, h, w, reference=False,
                     expect=dict(esum_rejects=True)))
    return out


def band_cases(seed: int = 51) -> list[dict]:
    """Bands of a flat frame (B2 at a row offset): the band of ``h`` rows
    from global row ``row0`` (odd, and no multiple of a 16-row sub-tile)
    of a ``frame_h``-row frame, triangles, rects and viewport in global
    rows: small triangles over the whole frame, triangles that end exactly
    on the band's edges and on the edges of its 16-row sub-tiles and 8-row
    strips (``tiled_fixtures.edge_tris``), and rects on the band's edges.
    ``band_view`` cuts the band with a viewport that starts inside it."""
    from ckrenderengine_tpu_torch.raster.tiled_fixtures import edge_tris

    out = []
    w = 70
    for k, (name, row0, h) in enumerate((("band_flat", 37, 45),
                                         ("band_view", 64, 40))):
        rng = np.random.default_rng(seed + k)
        frame_h = row0 + h + 23
        xyw, z = _pack(_small_tris(rng, 300, frame_h, w, (2.0, 9.0)), rng)
        xe, ze = edge_tris(rng, (row0, row0 + 8, row0 + 16, row0 + h), w)
        xyw, z = np.concatenate([xyw, xe]), np.concatenate([z, ze])
        t = xyw.shape[0]
        rect = np.tile(np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32),
                       (t, 1))
        pick = rng.random(t) < 0.15
        rect[pick] = [3.0, row0 - 0.5, w - 5.0, row0 + h + 0.5]
        pick = rng.random(t) < 0.1
        rect[pick] = [0.0, row0 + 8.0, float(w), row0 + 16.0]
        viewport = (None if name == "band_flat"
                    else [2.5, row0 + 11.0, w - 7.0, 200.0])
        case = _case(name, 1.0, xyw, z, h, w, clip_rect=rect,
                     viewport=viewport or [0.0, 0.0, float(w),
                                           float(frame_h)])
        case.update(row0=row0, frame_h=frame_h)
        out.append(case)
    return out


def case_rows(case: dict, device="cuda"):
    """The packed rows (``cuda_reduce.pack_rows``) of a case on ``device``,
    from the package's ``triangle_setup`` with no culling (``valid``
    carries it)."""
    import torch

    from ckrenderengine_tpu_torch.raster import deferred
    from ckrenderengine_tpu_torch.raster.cuda_reduce import pack_rows
    from ckrenderengine_tpu_torch.raster.types import (
        NUM_SI, SI_CULL, VXCULL,
    )

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=device)

    state_i = np.zeros((1, NUM_SI), np.int32)
    state_i[:, SI_CULL] = int(VXCULL.NONE)
    setup = deferred.triangle_setup(
        dev(case["xyw"]), dev(case["z"]),
        torch.zeros(case["xyw"].shape[0], dtype=torch.int32, device=device),
        dev(case["valid"]), dev(state_i), clip_rect=dev(case["clip_rect"]))
    return pack_rows(setup, dev(case["defer"]))


# Columns of the packed rows (cuda_reduce.pack_rows, pallas_reduce.pack_rows).
_TL, _Z, _INV, _ES, _S, _VALID, _RECT, _ID = 9, 12, 15, 16, 19, 20, 21, 25


def flat_stats(rows, h: int, w: int, viewport, step: int = 32,
               row0: int = 0) -> dict:
    """What the kernel's tests make of ``rows`` (torch, (T, 32) packed rows,
    on any device) on an ``h`` x ``w`` frame whose first row is global row
    ``row0`` (a band of a frame), in its own arithmetic:

    - ``scan_kept`` of ``strip_pairs`` (row, 16x8 strip) pairs: the strip
      scan's test (valid, rect overlap, each edge at the corner its signs
      pick, strips clipped to the frame); ``scan_drop`` its complement's
      share; ``dropped_but_reaching``: dropped pairs where some pixel of the
      strip passes valid, rect and edges (0, or the scan is not exact);
    - ``past_edges``: (pixel, row) pairs past valid, rect and the three
      edges (the roofline's operation count), ``edge_zero`` those decided by
      the top-left rule (an edge exactly 0), ``esum_rejects`` and
      ``depth_rejects`` those then lost to esum <= 0 or a depth outside
      [0, 1];
    - ``min_cover`` / ``max_cover``: rows covering a pixel inside the
      viewport; ``subtiles`` of the frame and ``outside_subtiles`` wholly
      outside the viewport."""
    import torch

    dev = rows.device
    f32 = torch.float32
    ys = torch.arange(h, dtype=f32, device=dev) + 0.5 + float(row0)
    xs = torch.arange(w, dtype=f32, device=dev) + 0.5
    py, px = (a[None] for a in torch.meshgrid(ys, xs, indexing="ij"))
    vp = [torch.tensor(float(v), dtype=f32, device=dev) for v in viewport]
    vx1, vy1 = vp[0] + vp[2], vp[1] + vp[3]
    scissor = (px[0] >= vp[0]) & (px[0] < vx1) & (py[0] >= vp[1]) & (
        py[0] < vy1)
    # Strip boxes, clipped to the frame.
    sx = torch.arange(0, w, STRIP_W, device=dev)
    sy = torch.arange(0, h, STRIP_H, device=dev)
    sxmin = (sx.to(f32) + 0.5)[None, None, :]
    sxmax = ((torch.clamp(sx + STRIP_W, max=w) - 1).to(f32) + 0.5)[None,
                                                                  None, :]
    symin = (sy.to(f32) + 0.5 + float(row0))[None, :, None]
    symax = ((torch.clamp(sy + STRIP_H, max=h) - 1).to(f32) + 0.5
             + float(row0))[None, :, None]
    hp, wp = sy.numel() * STRIP_H, sx.numel() * STRIP_W
    out = dict(strip_pairs=0, scan_kept=0, dropped_but_reaching=0,
               past_edges=0, edge_zero=0, esum_rejects=0, depth_rejects=0)
    cover = torch.zeros((h, w), dtype=torch.int64, device=dev)
    for c0 in range(0, rows.shape[0], step):
        r = rows[c0:c0 + step]

        def col(i):
            return r[:, i, None, None]

        ok = col(_VALID) > 0
        keep = ok & (sxmax >= col(_RECT)) & (symax >= col(_RECT + 1)) & (
            sxmin < col(_RECT + 2)) & (symin < col(_RECT + 3))
        m = ok & (px >= col(_RECT)) & (py >= col(_RECT + 1)) & (
            px < col(_RECT + 2)) & (py < col(_RECT + 3))
        zero = torch.zeros_like(m)
        es = []
        for k in range(3):
            a, b, c = col(3 * k), col(3 * k + 1), col(3 * k + 2)
            tl = col(_TL + k) > 0
            corner = (a * torch.where(a >= 0, sxmax, sxmin)
                      + b * torch.where(b >= 0, symax, symin)) + c
            keep &= (corner > 0) | ((corner == 0) & tl)
            e = (a * px + b * py) + c
            m &= (e > 0) | ((e == 0) & tl)
            zero |= e == 0
            es.append(e)
        depth = (es[0] * col(_Z) + es[1] * col(_Z + 1)
                 + es[2] * col(_Z + 2)) * col(_INV)
        esum = ((col(_ES) * px + col(_ES + 1) * py) + col(_ES + 2)) * col(_S)
        reach = torch.zeros((r.shape[0], hp, wp), dtype=torch.bool,
                            device=dev)
        reach[:, :h, :w] = m
        reach = reach.reshape(r.shape[0], sy.numel(), STRIP_H, sx.numel(),
                              STRIP_W).any(4).any(2)
        out["strip_pairs"] += keep.numel()
        out["scan_kept"] += int(keep.sum())
        out["dropped_but_reaching"] += int((reach & ~keep).sum())
        out["past_edges"] += int(m.sum())
        out["edge_zero"] += int((m & zero).sum())
        out["esum_rejects"] += int((m & ~(esum > 0)).sum())
        out["depth_rejects"] += int((m & (esum > 0) & ~(
            (depth >= 0) & (depth <= 1))).sum())
        cov = m & (esum > 0) & (depth >= 0) & (depth <= 1)
        cover += cov.sum(0)
    out["scan_drop"] = 1.0 - out["scan_kept"] / max(out["strip_pairs"], 1)
    inside = cover[scissor]
    out["min_cover"] = int(inside.min()) if inside.numel() else 0
    out["max_cover"] = int(inside.max()) if inside.numel() else 0
    subs_x, subs_y = -(-w // SUB), -(-h // SUB)
    tx0 = torch.arange(subs_x, dtype=f32, device=dev) * SUB + 0.5
    ty0 = torch.arange(subs_y, dtype=f32, device=dev) * SUB + 0.5 \
        + float(row0)
    out_x = (tx0 + SUB - 1 < vp[0]) | (tx0 >= vx1)
    out_y = (ty0 + SUB - 1 < vp[1]) | (ty0 >= vy1)
    out["subtiles"] = subs_x * subs_y
    out["outside_subtiles"] = int((out_x[None, :] | out_y[:, None]).sum())
    return out


def check_expect(case: dict, stats: dict, ids=None) -> None:
    """Hold a case's :func:`flat_stats` (and, where given, the solve's
    winner ids, any (H, W) integer array) to what the case was built for;
    raises AssertionError otherwise."""
    exp = case["expect"]
    t = case["xyw"].shape[0]

    def hold(cond, *what):
        if not cond:
            raise AssertionError((case["name"],) + what)

    # The scan never drops a row that reaches a pixel of the strip.
    hold(stats["dropped_but_reaching"] == 0, "scan dropped reaching rows",
         stats["dropped_but_reaching"])
    hold(stats["past_edges"] > 0, "nothing passes the edges")
    if "rows" in exp:
        hold(t == exp["rows"], "rows", t)
    if "valid_rows" in exp:
        hold(int(case["valid"].sum()) == exp["valid_rows"], "valid rows")
    if exp.get("at_limit"):
        hold(t * case["h"] * case["w"] == FLAT_PAIRS,
             "not at the flat route's limit", t, case["h"], case["w"])
    if "min_scan_drop" in exp:
        hold(stats["scan_drop"] >= exp["min_scan_drop"], "scan drops",
             stats["scan_drop"])
    if "max_scan_drop" in exp:
        hold(stats["scan_drop"] <= exp["max_scan_drop"], "scan drops",
             stats["scan_drop"])
    if exp.get("all_covered"):
        hold(stats["min_cover"] == t, "rows cover", stats["min_cover"])
    if exp.get("fewer_subtiles_than_sms"):
        hold(stats["subtiles"] < H100_SMS, "sub-tiles", stats["subtiles"])
    if exp.get("cover_exactly_once"):
        hold(stats["min_cover"] == stats["max_cover"] == 1, "cover",
             stats["min_cover"], stats["max_cover"])
    if "min_edge_pairs" in exp:
        hold(stats["edge_zero"] >= exp["min_edge_pairs"], "edge pairs",
             stats["edge_zero"])
    if exp.get("outside_subtiles"):
        hold(0 < stats["outside_subtiles"] < stats["subtiles"],
             "sub-tiles outside", stats["outside_subtiles"])
    if exp.get("odd"):
        hold(case["h"] % 2 == 1 and case["h"] % SUB and case["w"] % SUB,
             "frame", case["h"], case["w"])
    if exp.get("depth_rejects"):
        hold(stats["depth_rejects"] > 0, "no depth rejects")
    if exp.get("esum_rejects"):
        hold(stats["esum_rejects"] > 0, "no esum rejects")
    if ids is not None and "shadowed" in exp:
        won = set(np.unique(np.asarray(ids)).tolist())
        hold(not won & set(exp["shadowed"]), "an earlier tie won",
             sorted(won & set(exp["shadowed"])))
        hold(len(won & set(exp["later"])) >= len(exp["later"]) // 2,
             "later ties won too rarely", len(won & set(exp["later"])))
