"""Tile-binned depth argmin solve: torch phase A + CUDA kernel B1 phase B.

The counterpart of ``ckrenderengine_tpu.raster.pallas_tiled``
(``depth_reduce_tiled_pallas``), with the same exact two-phase structure:

  Phase A (torch) — classify + compact triangles by ONE class-key sort, bin
                    (tile, slab-position) pairs by ONE pair-key sort, find each
                    tile's contiguous range with ``searchsorted``, and gather
                    the packed rows into sorted-stream order once; the
                    unbounded/global class and the slab overflow (each up to
                    ``g_cap`` rows) become two shared leftover segments.
                    Rows have ``ncol`` = 23 + 3 per clip plane logical
                    columns at a pitch of :func:`row_pitch` floats (24, 28,
                    32, 32 for 0-3 planes; zero pad columns nothing reads),
                    so every row starts on 16 bytes.
  Phase B (CUDA)  — kernel B1 (``csrc/solve_tiled.cu``): one CTA per 16x16
                    sub-tile copies the tile's range and then both leftover
                    segments asynchronously (16-byte ``cp.async``) through a
                    shared-memory ring, drops the rows that cannot reach its
                    pixels, and evaluates the others on a block of 4 pixels
                    per thread with the (depth, id[, e0, e1, e2]) carry in
                    registers. On a CPU tensor :func:`solve_phase_b_plain`
                    computes the same per-tile reduce in torch.
                    Given a quantized shade table, kernel B5 (the fetch
                    instantiation of the same source) also writes each
                    pixel's winner row, int32 words bit for bit.

Overflow past the static caps (leftover rows beyond ``g_cap``, tiles cut by
``pair_cap``) streams through exact all-tiles torch loops afterwards, which
run zero iterations on ordinary frames. The caps and the ``want_binstats``
7-vector are identical to the reference's.

Translation notes: float -> int casts clamp in float first (an out-of-range
cast is undefined in torch); dynamic slices become clipped index tensors;
the u32 pair keys are int64 with the same bit layout and ordering.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .deferred import f32_on, gather_winner_rows, pixel_centres
from .tiled import _C_EC, _C_FL, _NCOL, _pow2ceil, _reduce_rows, _screen_bbox

_BIG = 3.0e38


def row_pitch(ncol: int) -> int:
    """Floats per stream row: ``ncol`` rounded up to a multiple of 4, so
    that every row of a 16-byte aligned stream starts on 16 bytes (what the
    kernel's asynchronous 16-byte copies need)."""
    return -(-ncol // 4) * 4


def _tile_index(v: torch.Tensor, tile: int, n: int) -> torch.Tensor:
    """clip(floor(v / tile), 0, n - 1) as int64, clamped in float so huge,
    infinite or NaN bbox edges never reach an undefined cast."""
    f = torch.clamp(torch.floor(v / tile), 0.0, float(n - 1))
    return torch.nan_to_num(f, nan=0.0).to(torch.int64)


def _init_plane(clear_z, height: int, width: int, full_h: int, full_w: int,
                dev) -> torch.Tensor:
    """(full_h, full_w) initial depth: the clear value, or a kept (H, W)
    z-buffer padded with 1.0."""
    cz = f32_on(clear_z, dev)
    if cz.dim() == 2:
        out = torch.ones((full_h, full_w), dtype=torch.float32, device=dev)
        out[:height, :width] = cz
        return out
    return cz.reshape(()).expand(full_h, full_w).contiguous()


def tile_grid(tile: int, tiles_x: int, tiles_y: int, dev):
    """(px, py) pixel centres of every tile, (n_tiles, tile*tile) f32, tiles
    row-major and pixels row-major within a tile. A band of a frame adds
    its first global row to py: (y + 0.5) + row0, the kernels' order
    (``csrc/tile_scan.cuh`` ``centre``)."""
    lp = torch.arange(tile * tile, device=dev)
    tl = torch.arange(tiles_x * tiles_y, device=dev)
    px = ((lp % tile)[None] + (tl % tiles_x)[:, None] * tile).to(
        torch.float32) + 0.5
    py = ((lp // tile)[None] + (tl // tiles_x)[:, None] * tile).to(
        torch.float32) + 0.5
    return px, py


def to_tiles(a: torch.Tensor, tile: int, tiles_x: int,
             tiles_y: int) -> torch.Tensor:
    """(..., H_pad, W_pad) -> (..., n_tiles, tile*tile) in the
    :func:`tile_grid` order."""
    lead = a.shape[:-2]
    nd = len(lead)
    a = a.reshape(lead + (tiles_y, tile, tiles_x, tile))
    a = a.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return a.reshape(lead + (tiles_x * tiles_y, tile * tile))


def untile(a: torch.Tensor, tile: int, tiles_x: int,
           tiles_y: int) -> torch.Tensor:
    """(..., n_tiles, tile*tile) -> (..., H_pad, W_pad), the inverse of
    :func:`to_tiles`."""
    lead = a.shape[:-2]
    nd = len(lead)
    a = a.reshape(lead + (tiles_y, tiles_x, tile, tile))
    a = a.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return a.reshape(lead + (tiles_y * tile, tiles_x * tile))


def solve_phase_b_plain(stream, starts, counts, leftn, gbase: int,
                        sbase: int, viewport, width: int, height: int,
                        init_d, tile: int, tiles_x: int, tiles_y: int,
                        n_planes: int, want_e: bool, shade_tbl=None,
                        rows_per_step: int = 16, row0: int = 0):
    """Plain torch version of kernels B1 and B5: per tile, reduce the
    tile's own stream range, then the two shared leftover segments, then
    mask by the viewport scissor and the framebuffer bounds. Chunked over
    rows so memory stays bounded. With ``shade_tbl`` (T, Wq) int32 (B5) the
    winner's table row is gathered per pixel, 0 where the id is -1.
    ``row0``: the global row of the frame's first row (a band): pixels
    evaluate at global centres, the viewport is in global rows and
    ``height`` bounds the local ones.
    Returns (depth (Hp,Wp), id (Hp,Wp) int32, e-planes (3,Hp,Wp) or None,
    rows (Wq,Hp,Wp) int32 or None) in full-tile padded planes."""
    dev = stream.device
    n_tiles = tiles_x * tiles_y
    npix = tile * tile
    px, py_l = tile_grid(tile, tiles_x, tiles_y, dev)           # (NT, npix)
    py = py_l + float(row0) if row0 else py_l
    init = to_tiles(init_d, tile, tiles_x, tiles_y)
    bd = init.clone()
    bi = torch.full((n_tiles, npix), -1, dtype=torch.int32, device=dev)
    be = torch.zeros((3, n_tiles, npix), dtype=torch.float32, device=dev)
    n_rows = stream.shape[0]
    kk = torch.arange(rows_per_step, device=dev)

    def merge(rows, live):
        """rows (NT|1, K, ncol), live (NT|1, K) -> merge into the carry."""
        nonlocal bd, bi, be

        def col(i):
            return rows[..., i, None]                           # (., K, 1)

        def plane(o):
            return col(o) * px[:, None] + col(o + 1) * py[:, None] + col(o + 2)

        e0 = plane(0)
        e1 = plane(3)
        e2 = plane(6)
        fl = rows[..., _C_FL].to(torch.int32)[..., None]
        cov = (((e0 > 0) | (((fl & 1) != 0) & (e0 == 0)))
               & ((e1 > 0) | (((fl & 2) != 0) & (e1 == 0)))
               & ((e2 > 0) | (((fl & 4) != 0) & (e2 == 0))))
        esum = plane(13) * col(16)
        depth = (e0 * col(9) + e1 * col(10) + e2 * col(11)) * col(12)
        cov &= (esum > 0) & (depth >= 0.0) & (depth <= 1.0)
        cov &= ((px[:, None] >= col(18)) & (py[:, None] >= col(19))
                & (px[:, None] < col(20)) & (py[:, None] < col(21)))
        for p in range(n_planes):
            cov &= plane(_NCOL + 3 * p) >= 0
        cov &= ((fl & 8) != 0) & live[..., None]
        tid = rows[..., 22].to(torch.int32)[..., None]
        dm = torch.where(cov, depth, _BIG)                      # (NT, K, P)
        idv = torch.where(cov, tid, -1)
        dmin = torch.amin(dm, dim=1)
        idw = torch.amax(torch.where(dm == dmin[:, None], idv, -1), dim=1)
        better = (dmin < bd) | ((dmin == bd) & (idw > bi))
        bd = torch.where(better, dmin, bd)
        bi = torch.where(better, idw, bi)
        if want_e:
            # The winner row is unique: take its e-values by index.
            m = (dm == dmin[:, None]) & (idv == idw[:, None])
            k = torch.argmax(m.to(torch.int8), dim=1, keepdim=True)
            for j, e in enumerate((e0, e1, e2)):
                e = e.expand(dm.shape)
                be[j] = torch.where(better, torch.gather(e, 1, k)[:, 0],
                                    be[j])

    peak = int(counts.max()) if n_tiles else 0
    for j in range(0, peak, rows_per_step):
        idx = starts[:, None].long() + j + kk[None]
        live = (j + kk)[None] < counts[:, None]
        rows = stream[torch.clamp(idx, 0, n_rows - 1)]
        merge(rows, live)
    for base, n in ((gbase, int(leftn[0])), (sbase, int(leftn[1]))):
        for j in range(0, n, rows_per_step):
            k = min(rows_per_step, n - j)
            rows = stream[base + j:base + j + k][None]
            merge(rows, torch.ones((1, k), dtype=torch.bool, device=dev))

    vp = torch.as_tensor(viewport, dtype=torch.float32, device=dev)
    scissor = ((px >= vp[0]) & (px < vp[0] + vp[2])
               & (py >= vp[1]) & (py < vp[1] + vp[3])
               & (px < width) & (py_l < height))
    bd = torch.where(scissor, bd, init)
    bi = torch.where(scissor, bi, -1)
    ep = None
    if want_e:
        ep = untile(torch.where(scissor, be, 0.0), tile, tiles_x, tiles_y)
    ids = untile(bi, tile, tiles_x, tiles_y)
    rows = None if shade_tbl is None else gather_winner_rows(shade_tbl, ids)
    return untile(bd, tile, tiles_x, tiles_y), ids, ep, rows


def _launch_solve(name: str, stream, starts, counts, leftn, gbase: int,
                  sbase: int, viewport, width: int, height: int, init_d,
                  tile: int, tiles_x: int, tiles_y: int, n_planes: int,
                  want_e: bool, shade_tbl, kchunk: int, row0: int = 0):
    """Check the arguments, allocate the outputs and launch one
    instantiation of ``csrc/solve_tiled.cu``. The stream and the shade
    table must start on 16 bytes, as torch's allocations and their row
    slices do: the C entry refuses others with ``cudaErrorInvalidValue``."""
    ncol = _NCOL + 3 * n_planes
    if not stream.is_cuda or stream.dtype != torch.float32 \
            or stream.dim() != 2 or stream.shape[1] != row_pitch(ncol):
        raise ValueError(f"{name} takes a CUDA f32 (rows, pitch) stream "
                         f"with pitch = row_pitch({ncol}) = "
                         f"{row_pitch(ncol)} floats per row")
    if tile not in (16, 32):
        raise ValueError("tile must be 16 or 32 (the kernel works on 16x16 "
                         "sub-tiles)")
    dev = stream.device
    lib = cuda_build.library().lib
    full_h, full_w = tiles_y * tile, tiles_x * tile
    stream = stream.contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    leftn = leftn.to(torch.int32).contiguous()
    vp = torch.as_tensor(viewport, dtype=torch.float32,
                         device=dev).reshape(4).contiguous()
    init_d = init_d.contiguous()
    out_d = torch.empty((full_h, full_w), dtype=torch.float32, device=dev)
    out_i = torch.empty((full_h, full_w), dtype=torch.int32, device=dev)
    out_e = (torch.empty((3, full_h, full_w), dtype=torch.float32, device=dev)
             if want_e else None)
    out_r, sh_w, n_tris = None, 0, 0
    if shade_tbl is not None:
        if shade_tbl.device != dev or shade_tbl.dtype != torch.int32 \
                or shade_tbl.dim() != 2 or shade_tbl.shape[1] % 4:
            raise ValueError(f"{name} takes a CUDA int32 (T, Wq) shade "
                             "table on the stream's device, Wq a multiple "
                             "of 4 words")
        shade_tbl = shade_tbl.contiguous()
        n_tris, sh_w = shade_tbl.shape
        out_r = torch.empty((sh_w, full_h, full_w), dtype=torch.int32,
                            device=dev)
    code = lib.ck_solve_tiled(
        stream.data_ptr(), ncol, stream.shape[1], n_planes, starts.data_ptr(),
        counts.data_ptr(), leftn.data_ptr(), gbase, sbase, vp.data_ptr(),
        width, height, float(row0), init_d.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(),
        cuda_build.ptr(out_e), cuda_build.ptr(shade_tbl), sh_w, n_tris,
        cuda_build.ptr(out_r), tile, tiles_x, tiles_y, kchunk,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(f"ck_solve_tiled ({name})", code)
    return out_d, out_i, out_e, out_r


def solve_tiled_kernel(*args, kchunk: int = 128, row0: int = 0):
    """Launch kernel B1 on CUDA tensors: the arguments and the result of
    :func:`solve_phase_b_plain` without a shade table."""
    out = _launch_solve("solve_tiled_kernel", *args, None, kchunk, row0)
    solve_tiled_kernel.launches += 1
    return out


solve_tiled_kernel.launches = 0


def solve_fetch_kernel(*args, kchunk: int = 128, row0: int = 0):
    """Launch kernel B5 on CUDA tensors: B1's solve plus, per pixel, the
    int32 words of its winner's ``shade_tbl`` row. The arguments and the
    result of :func:`solve_phase_b_plain`, ``shade_tbl`` last."""
    out = _launch_solve("solve_fetch_kernel", *args, kchunk, row0)
    solve_fetch_kernel.launches += 1
    return out


solve_fetch_kernel.launches = 0


def solve_phase_b(stream, *args, shade_tbl=None, kchunk: int = 128,
                  row0: int = 0):
    """Phase B dispatch: for a CUDA stream kernel B5 when a shade table is
    given and kernel B1 otherwise; the plain torch version for a CPU one."""
    if not stream.is_cuda:
        return solve_phase_b_plain(stream, *args, shade_tbl=shade_tbl,
                                   row0=row0)
    if shade_tbl is not None:
        return solve_fetch_kernel(stream, *args, shade_tbl, kchunk=kchunk,
                                  row0=row0)
    return solve_tiled_kernel(stream, *args, kchunk=kchunk, row0=row0)


def phase_a(setup, defer_tri, viewport, xyw, height: int, width: int,
            tile: int = 32, max_span: int = 2, span2: int = 16,
            g_cap: int = 8192, slab_cap: int = 131072,
            pair_cap: int = 65536, kchunk: int = 128,
            row0: int = 0) -> dict:
    """Classify, bin and stream-build (pallas_tiled.py phase A, same math).

    ``row0``: the global row of the frame's first row (a band of a frame,
    reference tiled.py:306-311). Bboxes stay in global screen rows; tile
    rows are counted from row0, and a triangle whose bbox ends above row0
    or starts at row0 + height is off screen.

    Returns a dict with the stream (rows, pitch), per-tile ``starts`` and
    ``counts``, the leftover row counts ``leftn``, the segment bases, the
    full row table (T, pitch), the class-sorted ids and the counters the
    remainder loops and the 7-vector bin statistics read. ``ncol`` is the
    number of logical columns and ``pitch`` = :func:`row_pitch` (ncol) the
    row length of the stream and the table; columns ``ncol:`` are zero.
    Every count stays on the device."""
    dev = xyw.device
    t = setup["e_coef"].shape[0]
    ty_n = (height + tile - 1) // tile
    tx_n = (width + tile - 1) // tile
    n_tiles = ty_n * tx_n
    tvalid = setup["valid"] & defer_tri
    n_planes = setup["dplane"].shape[1]

    x0, y0, x1, y1, unbounded, empty = _screen_bbox(xyw, setup["z"])
    tx0 = _tile_index(x0, tile, tx_n)
    tx1 = _tile_index(x1, tile, tx_n)
    ty0 = _tile_index(y0 - row0, tile, ty_n)
    ty1 = _tile_index(y1 - row0, tile, ty_n)
    offscreen = ((x1 < 0) | (x0 >= width) | (y1 < row0)
                 | (y0 >= row0 + height) | empty)
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    span = span_w * span_h
    live = tvalid & ~offscreen
    small = live & ~unbounded & (span <= max_span)
    mid = live & ~unbounded & (span > max_span) & (span <= span2)
    glob = live & ~small & ~mid

    m_cap = _pow2ceil(max(t, 2))
    cls = torch.where(small, 0, torch.where(mid, 1, torch.where(glob, 2, 3)))
    skey, _ = torch.sort(cls.to(torch.int64) * m_cap
                         + torch.arange(t, device=dev))
    sid = skey & (m_cap - 1)
    scls = skey // m_cap
    n_small = small.sum()
    n_mid = mid.sum()
    n_glob = glob.sum()
    g_cap = min(g_cap, m_cap)
    slab_l = min(slab_cap, m_cap, max(t, 1))
    sid = torch.cat([sid, torch.full((g_cap,), t, dtype=torch.int64,
                                     device=dev)])
    scls = torch.cat([scls, torch.full((g_cap,), 3, dtype=torch.int64,
                                       device=dev)])

    slab_id = sid[:slab_l]
    slab_ok = scls[:slab_l] == 0
    mid_pos = n_small + torch.arange(g_cap, device=dev)    # start <= t: in range
    mid_id = sid[mid_pos]
    mid_ok = scls[mid_pos] == 1
    all_id = torch.cat([slab_id, mid_id])                  # (LG,)
    all_ok = torch.cat([slab_ok, mid_ok])
    lg = slab_l + g_cap
    safe = torch.clamp(all_id, 0, t - 1)

    # Packed full-T row table (tiled.py _C_* layout) inside a zeroed
    # (T + 1, pitch) buffer: row t is the dead pad row of the stream gather,
    # columns ncol: the alignment pad.
    tlf = setup["top_left"].to(torch.int32)
    flags_t = (tlf[:, 0] + 2 * tlf[:, 1] + 4 * tlf[:, 2]
               + 8 * tvalid.to(torch.int32)).to(torch.float32)
    ncol = _NCOL + 3 * n_planes
    pitch = row_pitch(ncol)
    full_pad = torch.zeros((t + 1, pitch), dtype=torch.float32, device=dev)
    full_pad[:t, :ncol] = torch.cat([
        setup["e9"], setup["z"], setup["inv_det_s"][:, None],
        setup["esum_plane"], setup["s"][:, None], flags_t[:, None],
        setup["clip_rect"],
        torch.arange(t, dtype=torch.float32, device=dev)[:, None],
        setup["dplane9"]], dim=1)
    full_rows = full_pad[:t]                                # (T, pitch)
    safe_ok = torch.where(all_ok & (all_id < t), safe, t)

    # Pair keys + ONE key sort -> per-tile contiguous stream ranges.
    pbits = int(lg).bit_length()
    if (n_tiles + 1) << pbits > 2 ** 32:
        raise ValueError("tile x slab key space exceeds 32 bits (raise the "
                         "tile size or lower the caps)")
    a_tx0 = tx0[safe]
    a_ty0 = ty0[safe]
    a_sw = span_w[safe]
    a_span = span[safe]

    def pair_keys(lo: int, hi: int, nslots: int):
        di = torch.arange(nslots, device=dev)
        sw = torch.clamp(a_sw[lo:hi], min=1)[:, None]
        lx = di[None, :] % sw
        ly = di[None, :] // sw
        ptile = (a_ty0[lo:hi, None] + ly) * tx_n + (a_tx0[lo:hi, None] + lx)
        ok = all_ok[lo:hi, None] & (di[None, :] < a_span[lo:hi, None])
        ptile = torch.where(ok, ptile, n_tiles)
        p = torch.arange(lo, hi, device=dev)[:, None]
        return (ptile << pbits) | p

    keys = torch.cat([pair_keys(0, slab_l, max_span).reshape(-1),
                      pair_keys(slab_l, lg, span2).reshape(-1)])
    sorted_key, _ = torch.sort(keys)
    stream_len = sorted_key.shape[0]
    sorted_p = sorted_key & ((1 << pbits) - 1)
    bounds = torch.searchsorted(
        sorted_key, torch.arange(n_tiles + 1, device=dev) << pbits)
    starts = bounds[:-1]
    counts = bounds[1:] - bounds[:-1]
    peak = torch.amax(counts)

    # The one stream gather: packed rows in sorted-pair order, sized by
    # pair_cap (LIVE pairs). Tiles whose range does not fit keep count 0 and
    # their sorted tail replays through the all-tiles remainder.
    sl_main = -(-min(stream_len, pair_cap) // kchunk) * kchunk
    n_live = bounds[-1]
    pos = torch.arange(sl_main, device=dev)
    src_p = torch.where(pos < torch.clamp(n_live, max=sl_main),
                        sorted_p[torch.clamp(pos, 0, stream_len - 1)], lg)
    fits = (starts + counts) <= sl_main
    counts_k = torch.where(fits, counts, 0)
    starts_k = torch.where(fits, starts, 0)
    cut_pos = torch.amin(torch.where(~fits & (counts > 0), starts, n_live))
    safe_ok_pad = torch.cat([safe_ok, torch.full((1,), t, dtype=torch.int64,
                                                 device=dev)])
    sid_stream = safe_ok_pad[src_p]
    stream_rows = full_pad[sid_stream]                      # (sl_main, pitch)

    def rows_for(ids):
        r = full_rows[torch.clamp(ids, 0, t - 1)]
        inr = ((ids >= 0) & (ids < t)).to(torch.int32)
        flr = r[:, _C_FL].to(torch.int32)
        r[:, _C_FL] = ((flr & 7) + (flr & 8) * inr).to(torch.float32)
        return r

    # Leftover segments streamed by EVERY tile: the global class (capped at
    # g_cap rows) and the small-class slab overflow (likewise).
    gcap = scap = g_cap
    lrows = -(-gcap // kchunk) * kchunk
    g_start = n_small + torch.clamp(n_mid, max=g_cap)
    g_count = (n_small + n_mid + n_glob) - g_start
    s_over = torch.clamp(n_small - slab_l, min=0)
    sid_pad = torch.cat([sid, torch.full((lrows,), t, dtype=torch.int64,
                                         device=dev)])
    lpos = torch.arange(lrows, device=dev)
    ids_g = torch.where(lpos < torch.clamp(g_count, max=gcap),
                        sid_pad[g_start + lpos], t)
    ids_s = torch.where(lpos < torch.clamp(s_over, max=scap),
                        sid_pad[slab_l:slab_l + lrows], t)
    stream = torch.cat([stream_rows, rows_for(ids_g), rows_for(ids_s)])
    leftn = torch.stack([torch.clamp(g_count, max=gcap),
                         torch.clamp(s_over, max=scap)]).to(torch.int32)
    binstats = torch.stack([
        peak, n_live, torch.clamp(n_live - cut_pos, min=0),
        torch.clamp(g_count - gcap, min=0), torch.clamp(s_over - scap, min=0),
        n_small, n_mid]).to(torch.int32)
    return dict(stream=stream, starts=starts_k.to(torch.int32),
                counts=counts_k.to(torch.int32), leftn=leftn,
                gbase=sl_main, sbase=sl_main + lrows, full_rows=full_rows,
                sid=sid, all_id=all_id, sorted_p=sorted_p, g_start=g_start,
                cut_pos=cut_pos, gcap=gcap, slab_l=slab_l, lg=lg,
                n_planes=n_planes, ncol=ncol, pitch=pitch, tiles_x=tx_n,
                tiles_y=ty_n, binstats=binstats, rows_for=rows_for)


def depth_reduce_tiled_cuda(setup, defer_tri, clear_z, viewport, xyw,
                            height: int, width: int, tile: int = 32,
                            max_span: int = 2, chunk: int = 32,
                            span2: int = 16, g_cap: int = 8192,
                            slab_cap: int = 131072, pair_cap: int = 65536,
                            kchunk: int = 128, want_eplanes: bool = False,
                            want_binstats: bool = False, shade_tbl=None,
                            host_stats: dict | None = None,
                            remainder: bool = True, row0: int = 0):
    """Tile-binned argmin depth reduce (exact); the counterpart of
    ``pallas_tiled.depth_reduce_tiled_pallas``. ``row0``: the global row of
    the frame's first row (a band of a frame, the reference's XLA
    ``tiled.depth_reduce_tiled``): pixels evaluate at their global centres,
    so a band equals the same rows of the whole frame bit for bit.

    Returns (best_id (H,W) int32, best_depth (H,W) f32, peak); with
    ``want_eplanes`` the winner's raw edge values (3,H,W) follow; with
    ``shade_tbl`` (T, Wq) int32, the quantized shade table, each pixel's
    winner row (Wq,H,W) int32 comes last (the fused fetch, kernel B5 on the
    card): equal to ``gather_winner_rows(shade_tbl, best_id)``, so 0 where
    the id is -1, inside and outside the scissor.
    ``want_binstats``: ``peak`` becomes the (7,) int32 vector [peak,
    n_live_pairs, pair_cut_rows, g_over_rows, slab_over_rows, n_small,
    n_mid]; nonzero *_over/cut means the exact all-tiles remainder ran.

    The remainder decision is the one host read: all seven words come back
    at once, and ``host_stats`` (a dict) receives them as the list
    ``"SolveBinStats"``. ``remainder=False`` reads nothing back and runs no
    remainder: the frame is exact only where ``binstats[2:5]`` is all
    zero, which the caller checks on the device."""
    dev = xyw.device
    t = setup["e_coef"].shape[0]
    a = phase_a(setup, defer_tri, viewport, xyw, height, width, tile=tile,
                max_span=max_span, span2=span2, g_cap=g_cap,
                slab_cap=slab_cap, pair_cap=pair_cap, kchunk=kchunk,
                row0=row0)
    tx_n, ty_n = a["tiles_x"], a["tiles_y"]
    full_h, full_w = ty_n * tile, tx_n * tile
    init_d = _init_plane(clear_z, height, width, full_h, full_w, dev)
    vp = torch.as_tensor(viewport, dtype=torch.float32, device=dev).reshape(4)
    best_d, best_i, ep, rows = solve_phase_b(
        a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
        a["sbase"], vp, width, height, init_d, tile, tx_n, ty_n,
        a["n_planes"], want_eplanes, shade_tbl=shade_tbl, kchunk=kchunk,
        row0=row0)

    # --- beyond-cap remainders: exact all-tiles loops (zero iterations on
    # ordinary frames). One small readback decides whether any runs.
    binstats = a["binstats"]
    pair_cut = g_over = s_over2 = 0
    if remainder:
        words = binstats.tolist()
        if host_stats is not None:
            host_stats["SolveBinStats"] = words
        pair_cut, g_over, s_over2 = words[2:5]
    if pair_cut or g_over or s_over2:
        kernel_i = best_i
        py_l, px = pixel_centres(full_h, full_w, dev)
        py = py_l + float(row0)
        scissor = ((px >= vp[0]) & (px < vp[0] + vp[2])
                   & (py >= vp[1]) & (py < vp[1] + vp[3])
                   & (px < width) & (py_l < height))
        ncol = a["ncol"]
        slot_c = torch.arange(chunk, device=dev)
        rows_for = a["rows_for"]
        carry = (best_d, best_i)

        def stream_ids(carry, ids_at, count):
            for c0 in range(0, count, chunk):
                ids = ids_at(c0 + slot_c, c0 + slot_c < count)
                carry = _reduce_rows(carry, rows_for(ids)[:, :ncol],
                                     a["n_planes"], px, py, scissor)
            return carry

        sid = a["sid"]
        g_base = a["g_start"] + a["gcap"]
        carry = stream_ids(carry, lambda k, ok: torch.where(
            ok, sid[torch.clamp(g_base + k, 0, sid.shape[0] - 1)], t), g_over)
        s_base = a["slab_l"] + a["gcap"]
        carry = stream_ids(carry, lambda k, ok: torch.where(
            ok, sid[torch.clamp(s_base + k, 0, sid.shape[0] - 1)], t),
            s_over2)
        all_id_pad = torch.cat([a["all_id"], torch.full(
            (1,), t, dtype=torch.int64, device=dev)])
        sorted_p = a["sorted_p"]

        def tail_ids(k, ok):
            sp = sorted_p[torch.clamp(a["cut_pos"] + k, 0,
                                      sorted_p.shape[0] - 1)]
            return torch.where(ok, all_id_pad[torch.clamp(sp, 0, a["lg"])], t)

        carry = stream_ids(carry, tail_ids, pair_cut)
        best_d, best_i = carry
        if (want_eplanes or shade_tbl is not None) \
                and bool((best_i != kernel_i).any()):
            # A remainder changed a winner: recompute the winners' edge
            # values from the row table and fetch their shade rows again.
            if want_eplanes:
                ec = gather_winner_rows(a["full_rows"][:, _C_EC], best_i)
                ep = torch.stack([ec[3 * k] * px + ec[3 * k + 1] * py
                                  + ec[3 * k + 2] for k in range(3)])
            if shade_tbl is not None:
                rows = gather_winner_rows(shade_tbl, best_i)
    out = (best_i[:height, :width], best_d[:height, :width],
           binstats if want_binstats else binstats[0])
    if want_eplanes:
        out += (ep[:, :height, :width],)
    if shade_tbl is not None:
        out += (rows[:, :height, :width],)
    return out
