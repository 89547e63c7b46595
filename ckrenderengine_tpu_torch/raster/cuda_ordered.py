"""Tile-binned ORDERED kernels: torch phase A + CUDA kernels B3 and B4.

The counterpart of ``ckrenderengine_tpu.raster.pallas_ordered``. Every D3D
blend the transparent path uses is affine in the destination colour
(alpha-over: ``out = (1-sa)·dst + src·sa``; replace: ``out = src``;
uncovered: identity), so a pixel's back-to-front blend chain is an ordered
product of affine maps:

  Phase A (torch)  — :func:`phase_a`: triangle setup, one packed row per
                     draw (the ``_OC_*`` layout, draw order kept), span-window
                     classes, ONE pair-key sort that gives each screen tile a
                     contiguous draw-ordered range of the row stream, the
                     padded opaque z plane and the overflow flag ``bad``.
  Phase B, B3 (CUDA, ``csrc/ordered_blend.cu``) — folds each pixel's
                     draw-ordered blend steps into a carry (A, B); the frame
                     composites ``fb' = A·fb + B`` once
                     (:func:`ordered_blend_tiled_cuda`).
  Phase B, B4 (CUDA, ``csrc/ordered_peel.cu``) — for textured transparency:
                     records per pixel the covering fragments whose index lies
                     in ``[skip, skip+K)`` (draw id and raw e0/e1/e2); the
                     frame shades and blends those K layers and peels again
                     until every pixel drains (:func:`ordered_peel_iterate`).

A row is a coverage head (what coverage reads: the opaque solve's columns
0-21, the state bits, the z function, the draw id and 3 columns per user
clip plane, zero-padded to a multiple of 4 floats; :func:`head_width`) and a
shade tail of 32 floats (colour, specular, fog, alpha function and
reference, w), so every row of a 16-byte aligned stream and its tail start
on 16 bytes (the kernels' asynchronous 16-byte copies) and B4 copies the
head alone.

On a CPU tensor each phase B runs its plain torch version
(:func:`blend_phase_b_plain`, :func:`peel_phase_b_plain`): the same
arithmetic in the same order, vectorised across tiles.

Differences from the reference, all from dropping what existed only for the
TPU's Mosaic compiler: rows are not padded to 128 lanes, tile ranges are not
aligned to 8 rows (so ``_scan_place`` and its aligned-fit overflow clause
go: ``bad`` is ``overspan | bad_cap | n_live_pairs > PAIR_CAP``), and the
opaque z plane is one (H_pad, W_pad) plane, not an (8, npix) broadcast per
tile. ``bad`` is a correctness flag, never a cap: the frame replays its
exact sequential pass when it is set (pipeline/frame.py).
"""

from __future__ import annotations

import torch

from .. import cuda_build
from . import deferred as df
from .cuda_tiled import _init_plane, _tile_index, tile_grid, to_tiles, untile
from .tiled import _pow2ceil, _screen_bbox
from .torch_backend import compare_op
from .types import (
    SF_ALPHAREF, SI_ALPHABLEND, SI_ALPHAFUNC, SI_ALPHATEST, SI_COLORWRITE,
    SI_FOG, SI_PERSPECTIVE, SI_ZFUNC, VXCMP,
)

# Ordered-row layout (the reference's pallas_ordered._OC_* columns, as a
# head and a tail; csrc/ordered_common.cuh mirrors these). Head:
_OC_Z = 9           # corner clip z (3)
_OC_IVS = 12        # signed inverse determinant
_OC_EP = 13         # esum plane (3)
_OC_SS = 16         # sign s
_OC_FL = 17         # top-left bits (1|2|4) + valid bit 8
_OC_RECT = 18       # per-triangle scissor (4)
_OC_BITS = 22       # blend_on | fog_on<<1 | colorwrite<<2 | persp<<3 | at<<4
_OC_ZF = 23         # z compare func
_OC_ID = 24         # draw index (exact in f32 below 2^24)
_OC_CLIP = 25       # user clip planes, 3 each
# Tail, at the head width:
_OC_COL = 0         # corner RGBA x3, corner-major (12)
_OC_SPC = 12        # corner spec RGB x3 (9)
_OC_FOG = 21        # corner fog factors (3)
_OC_AF = 24         # alpha compare func
_OC_AREF = 25       # alpha ref
_OC_WS = 26         # corner w (3), for non-perspective weights
_OC_TAIL = 32       # tail width: 29 columns and 3 zeros

WINDOWS = ((65536, 4), (4096, 16), (1024, 128), (64, -1))
PAIR_CAP = 131072   # stream rows (live (tile, draw) pairs)
K_LAYERS = 4        # peel layers per round (csrc/ordered_peel.cu kLayers)
KCHUNK = 32         # rows a stage of a kernel's shared-memory ring holds
ROWS_PER_STEP = 8   # rows a plain version evaluates per vectorised step


def frame_caps(height: int, width: int) -> dict:
    """Phase A's capacities for a frame of ``height`` x ``width`` pixels:
    the reference's span-class capacities (``WINDOWS``) and ``PAIR_CAP``,
    sized for frames up to 1024x768, each times ceil(pixels / 1024*768);
    the span limits stay. An Antialias frame renders at twice its size, a
    triangle then spans about twice the tiles on each axis, and the 1x
    capacities overflow at the stress scenes' 2048x1536 (a span class past
    its capacity, more live pairs than ``PAIR_CAP``), so every frame would
    replay its exact pass."""
    k = -(-height * width // (1024 * 768))
    return dict(windows=tuple((cap * k, sl) for cap, sl in WINDOWS),
                pair_cap=PAIR_CAP * k)


def head_width(n_planes: int) -> int:
    """Floats of a row's coverage head: its columns rounded up to a
    multiple of 4 (28 / 28 / 32 / 36 for 0-3 clip planes)."""
    return -(-(_OC_CLIP + 3 * n_planes) // 4) * 4


def row_pitch(n_planes: int) -> int:
    """Floats per ordered stream row: the head and the 32-float tail."""
    return head_width(n_planes) + _OC_TAIL


def phase_a(xyw, z, valid, color, spec, uv, fog, state_idx, rect, clipd,
            state_i, state_f, zb, height: int, width: int, tile: int = 32,
            windows: tuple = WINDOWS, pair_cap: int = PAIR_CAP,
            row0: int = 0) -> dict:
    """Shared ordered-stream build of B3 and B4 (the reference's
    ``_ordered_phase_a``). Inputs are the ``ordered_subset`` batch fields
    in draw order; ``uv`` is not read (the peel's composite samples it).
    ``row0``: the global row of the frame's first row (a band of a frame):
    tile rows count from it, bboxes stay in global rows.

    Returns a dict: ``stream`` (rows, :func:`row_pitch`) f32 (pad columns
    zero; the sentinel row t is all zeros), per-tile ``starts`` and
    ``counts`` (int32, exact: tile t streams rows [start, start+count)),
    ``zplane`` (H_pad, W_pad) opaque depth, ``bad`` (device bool),
    ``n_live`` (live (tile, draw) pairs), ``n_planes``, ``tiles_x``,
    ``tiles_y``. Nothing is read back to the host."""
    t = xyw.shape[0]
    if t >= 1 << 24:
        # The draw index rides the stream as f32, exact only below 2^24.
        raise ValueError(
            f"ordered batch of {t} triangles exceeds the 2^24 f32 draw-id "
            "range of the tiled ordered kernels")
    dev = xyw.device
    ty_n = (height + tile - 1) // tile
    tx_n = (width + tile - 1) // tile
    n_tiles = ty_n * tx_n

    setup = df.triangle_setup(xyw, z, state_idx, valid, state_i,
                              clip_rect=rect, clipd=clipd)
    tvalid = setup["valid"]
    n_planes = clipd.shape[-1] if clipd is not None and clipd.dim() == 3 \
        else 0

    # --- packed rows (row k = draw k) inside a zeroed (T + 1, pitch) buffer:
    # row t is the dead pad row of the stream gather.
    tlf = setup["top_left"].to(torch.int32)
    flags_t = (tlf[:, 0] + 2 * tlf[:, 1] + 4 * tlf[:, 2]
               + 8 * tvalid.to(torch.int32)).to(torch.float32)

    def on(c):
        return (state_i[:, c] != 0).to(torch.float32)

    st_cols = torch.stack([
        on(SI_ALPHABLEND) + 2 * on(SI_FOG) + 4 * on(SI_COLORWRITE)
        + 8 * on(SI_PERSPECTIVE) + 16 * on(SI_ALPHATEST),
        state_i[:, SI_ZFUNC].to(torch.float32),
        state_i[:, SI_ALPHAFUNC].to(torch.float32),
        state_f[:, SF_ALPHAREF]], dim=1)                     # (S, 4)
    st_t = df.take_small(st_cols, state_idx)                 # (T, 4)
    head = head_width(n_planes)
    full_pad = torch.zeros((t + 1, head + _OC_TAIL), dtype=torch.float32,
                           device=dev)
    zeros = full_pad[:t]              # the pad columns, read before the copy
    full_pad[:t] = torch.cat([
        setup["e9"], setup["z"], setup["inv_det_s"][:, None],
        setup["esum_plane"], setup["s"][:, None], flags_t[:, None],
        setup["clip_rect"], st_t[:, 0:2],                   # bits, z func
        torch.arange(t, dtype=torch.float32, device=dev)[:, None],
        setup["dplane9"], zeros[:, :head - _OC_CLIP - 3 * n_planes],
        color.reshape(t, 12), spec.reshape(t, 9), fog.reshape(t, 3),
        st_t[:, 2:4],                                       # alpha func, ref
        xyw[..., 2], zeros[:, :_OC_TAIL - _OC_WS - 3]], dim=1)

    # --- classify + bin (the draw index is the key's low bits) ------------
    x0, y0, x1, y1, unbounded, empty = _screen_bbox(xyw, z)
    tx0 = _tile_index(x0, tile, tx_n)
    tx1 = _tile_index(x1, tile, tx_n)
    ty0 = _tile_index(y0 - row0, tile, ty_n)
    ty1 = _tile_index(y1 - row0, tile, ty_n)
    offscreen = ((x1 < 0) | (x0 >= width) | (y1 < row0)
                 | (y0 >= row0 + height) | empty)
    span_w = tx1 - tx0 + 1
    span = span_w * (ty1 - ty0 + 1)
    live = tvalid & ~offscreen
    # Normalise the windows: span limits clamp to n_tiles, and classes made
    # redundant by that drop out (small frames shrink the ladder).
    norm = []
    prev = 0
    for c, sl in windows:
        sl = n_tiles if sl == -1 else min(int(sl), n_tiles)
        if sl > prev:
            norm.append((int(c), sl))
            prev = sl
    nwin = len(norm)
    limits = [sl for _c, sl in norm]
    cls = torch.full((t,), nwin, dtype=torch.int64, device=dev)
    for k in range(nwin - 1, -1, -1):
        cls = torch.where(live & ~unbounded & (span <= limits[k]), k, cls)
    overspan = live & (unbounded | (span > limits[-1]))

    m_cap = _pow2ceil(max(t, 2))
    skey, _ = torch.sort(cls * m_cap + torch.arange(t, device=dev))
    sid = skey & (m_cap - 1)
    max_cap = max(c for c, _sl in norm)
    sid_pad = torch.cat([sid, torch.full((max_cap,), t, dtype=torch.int64,
                                         device=dev)])
    bad_cap = torch.zeros((), dtype=torch.bool, device=dev)
    ids_parts, ok_parts, caps = [], [], []
    off = torch.zeros((), dtype=torch.int64, device=dev)
    for k, (cap, _sl) in enumerate(norm):
        cap = min(cap, m_cap, max(t, 1))
        n_k = (cls == k).sum()
        pos = torch.arange(cap, device=dev)
        ids_k = sid_pad[torch.clamp(off + pos, max=sid_pad.shape[0] - 1)]
        ids_parts.append(ids_k)
        ok_parts.append((pos < torch.clamp(n_k, max=cap)) & (ids_k < t))
        caps.append(cap)
        bad_cap = bad_cap | (n_k > cap)
        off = off + n_k
    all_ok = torch.cat(ok_parts)
    safe = torch.clamp(torch.cat(ids_parts), 0, t - 1)

    pbits = int(t).bit_length()
    if (n_tiles + 1) << pbits > 2 ** 32:
        raise ValueError("tile x draw-id key space exceeds 32 bits")
    a_tx0 = tx0[safe]
    a_ty0 = ty0[safe]
    a_sw = span_w[safe]
    a_span = span[safe]

    def pair_keys(lo: int, hi: int, nslots: int):
        di = torch.arange(nslots, device=dev)
        sw = torch.clamp(a_sw[lo:hi], min=1)[:, None]
        ptile = ((a_ty0[lo:hi, None] + di[None] // sw) * tx_n
                 + a_tx0[lo:hi, None] + di[None] % sw)
        ok = all_ok[lo:hi, None] & (di[None] < a_span[lo:hi, None])
        ptile = torch.where(ok, ptile, n_tiles)
        return ((ptile << pbits) | safe[lo:hi, None]).reshape(-1)

    key_parts = []
    off_s = 0
    for cap, sl in zip(caps, limits):
        key_parts.append(pair_keys(off_s, off_s + cap, sl))
        off_s += cap
    sorted_key, _ = torch.sort(torch.cat(key_parts))
    stream_len = sorted_key.shape[0]
    sorted_p = sorted_key & ((1 << pbits) - 1)
    bounds = torch.searchsorted(
        sorted_key, torch.arange(n_tiles + 1, device=dev) << pbits)
    starts = bounds[:-1]
    counts = bounds[1:] - bounds[:-1]
    n_live = bounds[-1]

    # The stream: rows in sorted (tile, draw) order, sized by ``pair_cap``.
    # A tile whose range does not fit streams nothing; n_live > pair_cap
    # raises ``bad`` then.
    sl_main = min(stream_len, pair_cap)
    pos = torch.arange(sl_main, device=dev)
    sid_stream = torch.where(pos < n_live, sorted_p[:sl_main], t)
    fits = (starts + counts) <= sl_main
    bad = overspan.any() | bad_cap | (n_live > pair_cap)
    return dict(stream=full_pad[sid_stream],
                starts=torch.where(fits, starts, 0).to(torch.int32),
                counts=torch.where(fits, counts, 0).to(torch.int32),
                zplane=_init_plane(zb, height, width, ty_n * tile,
                                   tx_n * tile, dev),
                bad=bad, n_live=n_live, n_planes=n_planes, tiles_x=tx_n,
                tiles_y=ty_n)


# ---------------------------------------------------------------------------
# Plain phase B (torch): the kernels' arithmetic, vectorised across tiles
# ---------------------------------------------------------------------------

def _grid(tile: int, tiles_x: int, tiles_y: int, params):
    """(px, py) pixel centres, (n_tiles, 1, npix): one row axis to
    broadcast against; rows at their global centres (y + 0.5) + row0,
    row0 = ``params[6]`` (the kernels read it there too)."""
    px, py = tile_grid(tile, tiles_x, tiles_y, params.device)
    return px[:, None], (py + params[6])[:, None]


def _fragments(rows, live, px, py, scissor, zb, zbits, n_planes: int):
    """Coverage of K rows per tile, shared by B3 and B4: rows (NT,K,pitch),
    live (NT,K) -> (cov (NT,K,npix), e0, e1, e2, col) where ``col(i)`` is
    column i as (NT,K,1). Coverage is B1's test, the z test against the
    opaque plane with the 2-ULP tie window, the viewport scissor and
    colorwrite (no alpha test)."""
    def col(i):
        return rows[..., i, None]

    def icol(i):
        return rows[..., i].to(torch.int32)[..., None]

    def plane(o):
        return col(o) * px + col(o + 1) * py + col(o + 2)

    e0, e1, e2 = plane(0), plane(3), plane(6)
    fl = icol(_OC_FL)
    cov = (((e0 > 0) | (((fl & 1) != 0) & (e0 == 0)))
           & ((e1 > 0) | (((fl & 2) != 0) & (e1 == 0)))
           & ((e2 > 0) | (((fl & 4) != 0) & (e2 == 0))))
    esum_p = plane(_OC_EP) * col(_OC_SS)
    depth = (e0 * col(_OC_Z) + e1 * col(_OC_Z + 1)
             + e2 * col(_OC_Z + 2)) * col(_OC_IVS)
    cov &= (esum_p > 0) & (depth >= 0.0) & (depth <= 1.0)
    cov &= ((px >= col(_OC_RECT)) & (py >= col(_OC_RECT + 1))
            & (px < col(_OC_RECT + 2)) & (py < col(_OC_RECT + 3)))
    for p in range(n_planes):
        cov &= plane(_OC_CLIP + 3 * p) >= 0
    cov &= ((fl & 8) != 0) & live[..., None] & scissor
    zf = icol(_OC_ZF)
    near = torch.abs(depth.view(torch.int32) - zbits) <= 2
    eq_incl = ((zf == int(VXCMP.LESSEQUAL)) | (zf == int(VXCMP.EQUAL))
               | (zf == int(VXCMP.GREATEREQUAL)))
    cov &= compare_op(zf, depth, zb) | (eq_incl & near)
    cov &= (icol(_OC_BITS) & 4) != 0                # colorwrite
    return cov, e0, e1, e2, col


def _stream_steps(stream, starts, counts):
    """Yield (rows (NT,K,pitch), live (NT,K)) over every tile's range in
    draw order, K = ROWS_PER_STEP rows per step, padded to the longest
    tile's count."""
    dev = stream.device
    n_rows = stream.shape[0]
    kk = torch.arange(ROWS_PER_STEP, device=dev)
    # The plain version's loop length: one host read per call.
    peak = int(counts.max()) if counts.numel() else 0
    for j in range(0, peak, ROWS_PER_STEP):
        idx = starts[:, None].long() + j + kk[None]
        yield (stream[torch.clamp(idx, 0, max(n_rows - 1, 0))],
               (j + kk)[None] < counts[:, None])


def _scissor(px, py, params):
    """The viewport (global rows) and the framebuffer bounds: row0 + height
    is an exact integer, so ``py < row0 + height`` is the local test."""
    vx0, vy0 = params[0], params[1]
    return ((px >= vx0) & (px < vx0 + params[2]) & (py >= vy0)
            & (py < vy0 + params[3]) & (px < params[4])
            & (py < params[6] + params[5]))


def blend_phase_b_plain(stream, starts, counts, params, zplane, tile: int,
                        tiles_x: int, tiles_y: int, n_planes: int):
    """Plain torch version of kernel B3. ``params`` = (vx, vy, vw, vh,
    width, height, row0, fog r, g, b) f32 (:func:`_params`). Returns (5,
    H_pad, W_pad): A (one number for all four channels) then B RGBA of each
    pixel's folded affine blend map (identity where nothing covers)."""
    dev = stream.device
    n_tiles = tiles_x * tiles_y
    npix = tile * tile
    px, py = _grid(tile, tiles_x, tiles_y, params)
    scissor = _scissor(px, py, params)
    zb = to_tiles(zplane, tile, tiles_x, tiles_y)[:, None]
    zbits = zb.contiguous().view(torch.int32)
    fogc = params[7:10]
    head = head_width(n_planes)
    ca = torch.ones((n_tiles, npix), dtype=torch.float32, device=dev)
    cb = [torch.zeros((n_tiles, npix), dtype=torch.float32, device=dev)
          for _ in range(4)]
    for rows, live in _stream_steps(stream, starts, counts):
        cov, e0, e1, e2, col = _fragments(rows, live, px, py, scissor, zb,
                                          zbits, n_planes)
        esum = e0 + e1 + e2
        inv_esum = 1.0 / torch.where(torch.abs(esum) < 1e-30, 1e-30, esum)
        bits = rows[..., _OC_BITS].to(torch.int32)[..., None]
        persp = (bits & 8) != 0
        ivs = col(_OC_IVS)

        def tcol(i):
            return col(head + i)

        w0 = torch.where(persp, e0 * inv_esum, e0 * tcol(_OC_WS) * ivs)
        w1 = torch.where(persp, e1 * inv_esum, e1 * tcol(_OC_WS + 1) * ivs)
        w2 = torch.where(persp, e2 * inv_esum, e2 * tcol(_OC_WS + 2) * ivs)

        def interp(o, k):
            return tcol(o) * w0 + tcol(o + k) * w1 + tcol(o + 2 * k) * w2

        src = [interp(_OC_COL + c, 4) for c in range(4)]
        for c in range(3):
            src[c] = src[c] + interp(_OC_SPC + c, 3)
        fog_on = (bits & 2) != 0
        fogf = torch.clamp(interp(_OC_FOG, 1), 0.0, 1.0)
        for c in range(3):
            src[c] = torch.where(fog_on,
                                 src[c] * fogf + fogc[c] * (1.0 - fogf),
                                 src[c])
        src = [torch.clamp(c, 0.0, 1.0) for c in src]
        sa = src[3]
        at_on = (bits & 16) != 0
        at_ok = compare_op(rows[..., head + _OC_AF].to(torch.int32)[..., None],
                           sa, tcol(_OC_AREF))
        cov &= at_ok | ~at_on
        blend_on = (bits & 1) != 0
        a = torch.where(cov, torch.where(blend_on, 1.0 - sa, 0.0), 1.0)
        b = [torch.where(cov, torch.where(blend_on, src[c] * sa, src[c]),
                         0.0) for c in range(4)]
        for k in range(rows.shape[1]):           # draw order
            ak = a[:, k]
            ca = ak * ca
            cb = [ak * cb[c] + b[c][:, k] for c in range(4)]
    return untile(torch.stack([ca] + cb), tile, tiles_x, tiles_y)


def blend_kernel(stream, starts, counts, params, zplane, tile: int,
                 tiles_x: int, tiles_y: int, n_planes: int):
    """Launch kernel B3 on CUDA tensors (the contract of
    :func:`blend_phase_b_plain`)."""
    _check_stream("blend_kernel", stream, n_planes, tile)
    dev = stream.device
    lib = cuda_build.library().lib
    out = torch.empty((5, tiles_y * tile, tiles_x * tile),
                      dtype=torch.float32, device=dev)
    stream = stream.contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    params = params.to(torch.float32).contiguous()
    zplane = zplane.contiguous()
    code = lib.ck_ordered_blend(
        stream.data_ptr(), stream.shape[1], n_planes, starts.data_ptr(),
        counts.data_ptr(), params.data_ptr(), zplane.data_ptr(),
        out.data_ptr(), tile, tiles_x, tiles_y, KCHUNK,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check("ck_ordered_blend", code)
    blend_kernel.launches += 1
    return out


blend_kernel.launches = 0


def _check_stream(name: str, stream, n_planes: int, tile: int) -> None:
    """The kernels take a CUDA f32 stream at :func:`row_pitch` floats per
    row (16-byte aligned, as torch's allocations are: the C entries refuse
    others) and tiles of 16 or 32 pixels (16x16 sub-tiles)."""
    pitch = row_pitch(n_planes)
    if not stream.is_cuda or stream.dtype != torch.float32 \
            or stream.dim() != 2 or stream.shape[1] != pitch:
        raise ValueError(f"{name} takes a CUDA f32 (rows, {pitch}) stream "
                         f"(row_pitch({n_planes}) floats per row)")
    if tile not in (16, 32):
        raise ValueError("tile must be 16 or 32 (the kernels work on 16x16 "
                         "sub-tiles)")


def blend_phase_b(stream, *args):
    """B3 dispatch: the kernel for a CUDA stream, the plain torch version
    for a CPU one."""
    if stream.is_cuda:
        return blend_kernel(stream, *args)
    return blend_phase_b_plain(stream, *args)


def peel_phase_b_plain(stream, starts, counts, params, skip: int, zplane,
                       tile: int, tiles_x: int, tiles_y: int, n_planes: int):
    """Plain torch version of kernel B4. ``params`` = (vx, vy, vw, vh,
    width, height, row0) f32. Per pixel, in draw order, the covering fragments
    numbered ``skip`` .. ``skip + K_LAYERS - 1`` are recorded. Returns
    (lids (K,H_pad,W_pad) int32, -1 = none; les (K,3,H_pad,W_pad) raw edge
    values; cnt (H_pad,W_pad) int32 covering fragments; ovf (H_pad,W_pad)
    int32, 1 where fragments beyond the window exist)."""
    dev = stream.device
    n_tiles = tiles_x * tiles_y
    npix = tile * tile
    px, py = _grid(tile, tiles_x, tiles_y, params)
    scissor = _scissor(px, py, params)
    zb = to_tiles(zplane, tile, tiles_x, tiles_y)[:, None]
    zbits = zb.contiguous().view(torch.int32)
    lid = torch.full((K_LAYERS, n_tiles, npix), -1, dtype=torch.int32,
                     device=dev)
    le = torch.zeros((K_LAYERS, 3, n_tiles, npix), dtype=torch.float32,
                     device=dev)
    cnt = torch.zeros((n_tiles, npix), dtype=torch.int32, device=dev)
    ovf = torch.zeros((n_tiles, npix), dtype=torch.int32, device=dev)
    for rows, live in _stream_steps(stream, starts, counts):
        cov, e0, e1, e2, _col = _fragments(rows, live, px, py, scissor, zb,
                                           zbits, n_planes)
        tid = rows[..., _OC_ID].to(torch.int32)
        for k in range(rows.shape[1]):           # draw order
            m = cov[:, k]
            ovf = torch.where(m & (cnt >= skip + K_LAYERS), 1, ovf)
            for s in range(K_LAYERS):
                sel = m & (cnt == skip + s)
                lid[s] = torch.where(sel, tid[:, k, None], lid[s])
                for j, e in enumerate((e0, e1, e2)):
                    le[s, j] = torch.where(sel, e[:, k], le[s, j])
            cnt = cnt + m.to(torch.int32)
    return tuple(untile(a, tile, tiles_x, tiles_y)
                 for a in (lid, le, cnt, ovf))


def peel_kernel(stream, starts, counts, params, skip: int, zplane,
                tile: int, tiles_x: int, tiles_y: int, n_planes: int):
    """Launch kernel B4 on CUDA tensors (the contract of
    :func:`peel_phase_b_plain`)."""
    _check_stream("peel_kernel", stream, n_planes, tile)
    dev = stream.device
    lib = cuda_build.library().lib
    full_h, full_w = tiles_y * tile, tiles_x * tile
    lids = torch.empty((K_LAYERS, full_h, full_w), dtype=torch.int32,
                       device=dev)
    les = torch.empty((K_LAYERS, 3, full_h, full_w), dtype=torch.float32,
                      device=dev)
    cnt = torch.empty((full_h, full_w), dtype=torch.int32, device=dev)
    ovf = torch.empty((full_h, full_w), dtype=torch.int32, device=dev)
    stream = stream.contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    params = params.to(torch.float32).contiguous()
    zplane = zplane.contiguous()
    code = lib.ck_ordered_peel(
        stream.data_ptr(), stream.shape[1], n_planes, starts.data_ptr(),
        counts.data_ptr(), params.data_ptr(), int(skip), zplane.data_ptr(),
        lids.data_ptr(), les.data_ptr(), cnt.data_ptr(), ovf.data_ptr(),
        tile, tiles_x, tiles_y, KCHUNK,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check("ck_ordered_peel", code)
    peel_kernel.launches += 1
    return lids, les, cnt, ovf


peel_kernel.launches = 0


def peel_phase_b(stream, *args):
    """B4 dispatch: the kernel for a CUDA stream, the plain torch version
    for a CPU one."""
    if stream.is_cuda:
        return peel_kernel(stream, *args)
    return peel_phase_b_plain(stream, *args)


# ---------------------------------------------------------------------------
# Entries (the reference's ordered_blend_tiled_pallas / ordered_peel_*)
# ---------------------------------------------------------------------------

def _params(viewport, height: int, width: int, extra=None, dev=None,
            row0: int = 0):
    """The kernels' parameter vector: (vx, vy, vw, vh, width, height, row0)
    then ``extra`` (B3: the fog colour). ``row0`` is the global row of the
    frame's first row (a band of a frame)."""
    parts = [torch.as_tensor(viewport, dtype=torch.float32,
                             device=dev).reshape(4),
             df.f32_on(float(width), dev).reshape(1),
             df.f32_on(float(height), dev).reshape(1),
             df.f32_on(float(row0), dev).reshape(1)]
    if extra is not None:
        parts.append(torch.as_tensor(extra, dtype=torch.float32,
                                     device=dev).reshape(-1))
    return torch.cat(parts)


def ordered_blend_tiled_cuda(xyw, z, valid, color, spec, uv, fog, state_idx,
                             rect, clipd, state_i, state_f, fog_color, zb,
                             viewport, height: int, width: int,
                             tile: int = 32, windows: tuple = WINDOWS,
                             pair_cap: int = PAIR_CAP, row0: int = 0):
    """Ordered alpha blend over the opaque frame, as per-pixel affine maps.

    Inputs are the ordered_subset batch fields in draw order; ``row0`` is
    the global row of the frame's first row (a band of a frame). Returns
    (A (4,H,W), B (4,H,W), bad ()): the caller composites ``A·fb + B``, or
    replays the exact pass when ``bad`` is set."""
    pa = phase_a(xyw, z, valid, color, spec, uv, fog, state_idx, rect,
                 clipd, state_i, state_f, zb, height, width, tile, windows,
                 pair_cap, row0)
    ab = blend_phase_b(
        pa["stream"], pa["starts"], pa["counts"],
        _params(viewport, height, width, fog_color, xyw.device, row0),
        pa["zplane"], tile, pa["tiles_x"], pa["tiles_y"],
        pa["n_planes"])[:, :height, :width]
    return ab[0:1].expand(4, height, width), ab[1:5], pa["bad"]


def _peel_phase_b(pa: dict, skip: int, viewport, height: int, width: int,
                  tile: int, row0: int = 0):
    """One peel round over a prepared phase-A stream with the layer window
    starting at ``skip``. Returns (lids (K,H,W) int32, les (K,3,H,W),
    ovf () device bool: fragments beyond skip+K exist)."""
    lids, les, _cnt, ovf = peel_phase_b(
        pa["stream"], pa["starts"], pa["counts"],
        _params(viewport, height, width, dev=pa["stream"].device,
                row0=row0), skip,
        pa["zplane"], tile, pa["tiles_x"], pa["tiles_y"], pa["n_planes"])
    return (lids[:, :height, :width], les[:, :, :height, :width],
            ovf[:height, :width].any())


def ordered_peel_tiled_cuda(xyw, z, valid, color, spec, uv, fog, state_idx,
                            rect, clipd, state_i, state_f, zb, viewport,
                            height: int, width: int, tile: int = 32,
                            windows: tuple = WINDOWS,
                            pair_cap: int = PAIR_CAP, row0: int = 0):
    """ONE round of draw-order fragment peeling. Returns (lids (K,H,W)
    int32, -1 = none; les (K,3,H,W) raw winner edge values; bad ()), where
    ``bad`` joins the phase-A flag and the per-pixel layer overflow."""
    pa = phase_a(xyw, z, valid, color, spec, uv, fog, state_idx, rect,
                 clipd, state_i, state_f, zb, height, width, tile, windows,
                 pair_cap, row0)
    lids, les, ovf = _peel_phase_b(pa, 0, viewport, height, width, tile,
                                   row0)
    return lids, les, pa["bad"] | ovf


def ordered_peel_iterate(composite_fn, fb, xyw, z, valid, color, spec, uv,
                         fog, state_idx, rect, clipd, state_i, state_f, zb,
                         viewport, height: int, width: int, tile: int = 32,
                         windows: tuple = WINDOWS, pair_cap: int = PAIR_CAP,
                         rounds: int | None = None, row0: int = 0):
    """Iterated depth peeling: composite ordered layers K at a time with
    ``composite_fn(fb, lids, les)`` until every pixel's fragment list is
    drained — exact at any depth. Phase A runs once; each further round
    re-streams the kernel with the window advanced by K.

    Returns (fb, bad, rounds). ``bad`` (a Python bool) is the phase-A
    overflow; when it is set no round runs, ``fb`` comes back unchanged and
    ``rounds`` is 0 — the caller replays its exact sequential pass.

    With ``rounds`` given, nothing is read back: exactly that many rounds
    run (a round over drained pixels composites empty layers, which leaves
    ``fb`` as it was), and the result is (fb, bad, more) with ``bad`` the
    phase-A flag and ``more`` the last round's overflow, both device bools:
    ``fb`` is exact only where both are false. ``row0``: the global row of
    the frame's first row (a band of a frame)."""
    pa = phase_a(xyw, z, valid, color, spec, uv, fog, state_idx, rect,
                 clipd, state_i, state_f, zb, height, width, tile, windows,
                 pair_cap, row0)
    if rounds is not None:
        ovf = torch.zeros((), dtype=torch.bool, device=fb.device)
        for r in range(rounds):
            lids, les, ovf = _peel_phase_b(pa, r * K_LAYERS, viewport, height,
                                           width, tile, row0)
            fb = composite_fn(fb, lids, les)
        return fb, pa["bad"], ovf
    # Host read, once per frame: the replay decision.
    if bool(pa["bad"]):
        return fb, True, 0
    skip = 0
    more = True
    while more:
        lids, les, ovf = _peel_phase_b(pa, skip, viewport, height, width,
                                       tile, row0)
        fb = composite_fn(fb, lids, les)
        skip += K_LAYERS
        # Host read, once per round: another round runs only while some
        # pixel still holds fragments beyond the window.
        more = bool(ovf)
    return fb, False, skip // K_LAYERS
