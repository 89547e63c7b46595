"""Deferred opaque rasterization: depth argmin-reduce + one shade per pixel.

The reference's hot loop is sequential per-triangle DrawPrimitive into a
z-buffered framebuffer (CKDX9RasterizerContext::DrawPrimitive,
src/CKRasterizer/CKDX9Rasterizer/CKDX9RasterizerContext.cpp:1555-1648). For
OPAQUE triangles with default depth semantics (LESSEQUAL + z-write, no
blending/alpha-test — CKRasterizerLib/CKRasterizerContext.cpp:423-477) the
final image is order-independent except for exact-depth ties, where the LATER
draw wins. The whole opaque pass is then a pure reduction

    winner(px) = argmin over triangles of (depth(px), -draw_index)

followed by ONE shade per pixel on the winner. This module holds the
triangle setup, the plain flat reduce (:func:`depth_reduce`, the reference
arithmetic both CUDA solves reproduce) and the fixed-function shade — the
counterpart of ``ckrenderengine_tpu.raster.deferred``.

Every per-pixel formula keeps the reference's order of operations; torch runs
each elementwise op as its own rounded step, so nothing is FMA-contracted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..math.vxmath import oct_encode
from .stage import call_stage
from .types import (
    SF_BORDER_R, SF_CONST_R, SI_ALPHABLEND, SI_ALPHATEST, SI_COLORWRITE,
    SI_CULL, SI_FOG, SI_PERSPECTIVE, SI_TEX, SI_TEXADDR, SI_TEXBLEND,
    SI_TEXFILTER, SI_TEXGEN, SI_ZFUNC, SI_ZWRITE, TEXBLEND_DOT3FACTOR,
    TEXGEN_CUBE, VXCMP, VXCULL, VXTEXTUREBLEND, VXTEXTURE_ADDRESS,
    VXTEXTURE_FILTER,
)

_BIG = 3.0e38


def f32_on(value, device) -> torch.Tensor:
    """``value`` (a number or a tensor) as an f32 tensor on ``device``. A
    number becomes a fill on the device: ``torch.tensor(x, device=...)``
    is a blocking host copy, which a frame must not hold (it could not be
    captured into a CUDA graph)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


def open_rect(n: int, device) -> torch.Tensor:
    """(n, 4) scissor rects that keep everything, [-1e9, -1e9, 1e9, 1e9],
    made on the device."""
    half = torch.full((n, 2), 1.0e9, dtype=torch.float32, device=device)
    return torch.cat([-half, half], dim=1)


def take_small(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather from a small table (the reference's one-hot MXU join,
    which is bit-exact with a gather)."""
    return table.index_select(0, idx.reshape(-1).long()).reshape(
        tuple(idx.shape) + tuple(table.shape[1:]))


def gather_winner_rows(tbl: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel winner rows of a per-triangle table: (T,C) rows and (H,W)
    ids -> (C,H,W) channel-major, 0 where the id is negative (background).
    The table's dtype is kept, so int32 words move bit for bit."""
    h, w = ids.shape
    tid = torch.clamp(ids, 0, tbl.shape[0] - 1).reshape(-1).long()
    rows = tbl.index_select(0, tid).T.reshape(tbl.shape[1], h, w)
    return torch.where((ids >= 0)[None], rows, 0)


def deferred_mask(state_i: torch.Tensor) -> torch.Tensor:
    """Per-state-bucket: eligible for the order-independent opaque reduce."""
    return ((state_i[:, SI_ALPHABLEND] == 0)
            & (state_i[:, SI_ALPHATEST] == 0)
            & (state_i[:, SI_ZWRITE] != 0)
            & ((state_i[:, SI_ZFUNC] == int(VXCMP.LESSEQUAL))
               | (state_i[:, SI_ZFUNC] == int(VXCMP.LESS))))


def triangle_setup(xyw, z, state_idx, valid, state_i, clip_rect=None,
                   clipd=None):
    """Per-triangle setup: adjoint edge coeffs, depth plane, cull, flags.

    xyw: (T,3,3) screen-homogeneous verts; z: (T,3) clip z.
    clip_rect: optional (T,4) per-triangle scissor (Place viewport clips).
    clipd: optional (T,3,P) per-corner user-clip-plane signed distances; the
    per-pixel keep test is the sign of the affine plane sum_i e_i(p) d_i.
    Returns a dict of (T,...) tensors (plus 2D twins ``e9``/``dplane9``).
    """
    t = xyw.shape[0]
    dev = xyw.device
    v0c = tuple(xyw[:, 0, k] for k in range(3))
    v1c = tuple(xyw[:, 1, k] for k in range(3))
    v2c = tuple(xyw[:, 2, k] for k in range(3))
    z3 = tuple(z[:, i] for i in range(3))

    def cross_c(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    adj0c = cross_c(v1c, v2c)         # 3 x (T,): coeffs [a_x, a_y, c]
    adj1c = cross_c(v2c, v0c)
    adj2c = cross_c(v0c, v1c)
    det = v0c[0] * adj0c[0] + v0c[1] * adj0c[1] + v0c[2] * adj0c[2]
    s = torch.where(det >= 0, 1.0, -1.0)
    degenerate = torch.abs(det) < 1e-14

    cull = take_small(state_i[:, SI_CULL], state_idx)
    front = det > 0
    keep = ((cull == int(VXCULL.NONE))
            | ((cull == int(VXCULL.CCW)) & front)
            | ((cull == int(VXCULL.CW)) & ~front))

    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    zplane = torch.stack(
        [(adj0c[k] * z3[0] + adj1c[k] * z3[1] + adj2c[k] * z3[2]) * inv_det
         for k in range(3)], dim=1)
    esum_plane = torch.stack(
        [adj0c[k] + adj1c[k] + adj2c[k] for k in range(3)], dim=1)
    # depth = (e0s*z0 + e1s*z1 + e2s*z2) * (s*inv_det): the signed e's and
    # the sign folded into the inverse determinant.
    inv_det_s = torch.where(det >= 0, 1.0, -1.0) * inv_det

    e0s = tuple(adj0c[k] * s for k in range(3))
    e1s = tuple(adj1c[k] * s for k in range(3))
    e2s = tuple(adj2c[k] * s for k in range(3))
    e9 = torch.stack(e0s + e1s + e2s, dim=1)                     # (T,9)
    e_coef = e9.reshape(t, 3, 3)
    top_left = torch.stack(
        [(es[1] > 0) | ((es[1] == 0) & (es[0] > 0))
         for es in (e0s, e1s, e2s)], dim=1)                      # (T,3)

    # Sub-epsilon screen-area slivers cover no pixel centres: cull them
    # (w-crossing triangles keep their validity).
    w3 = (v0c[2], v1c[2], v2c[2])
    wmin = torch.minimum(torch.minimum(w3[0], w3[1]), w3[2])
    sw = tuple(torch.where(torch.abs(wi) < 1e-6, 1e-6, wi) for wi in w3)
    sx = (v0c[0] / sw[0], v1c[0] / sw[1], v2c[0] / sw[2])
    sy = (v0c[1] / sw[0], v1c[1] / sw[1], v2c[1] / sw[2])
    area2 = torch.abs((sx[1] - sx[0]) * (sy[2] - sy[0])
                      - (sx[2] - sx[0]) * (sy[1] - sy[0]))
    sliver = (wmin > 1e-6) & (area2 < 1e-6)

    tvalid = valid & ~degenerate & keep & ~sliver
    if clip_rect is None:
        clip_rect = open_rect(1, dev).expand(t, 4)
    if clipd is not None and clipd.shape[-1] > 0:
        n_planes = clipd.shape[-1]
        d3 = (clipd[:, 0], clipd[:, 1], clipd[:, 2])
        cols = []
        for p in range(n_planes):
            for k in range(3):
                cols.append(e0s[k] * d3[0][:, p] + e1s[k] * d3[1][:, p]
                            + e2s[k] * d3[2][:, p])
        dplane9 = torch.stack(cols, dim=1)                      # (T, 3P)
    else:
        n_planes = 0
        dplane9 = torch.zeros((t, 0), dtype=torch.float32, device=dev)
    dplane = dplane9.reshape(t, n_planes, 3)
    return dict(e_coef=e_coef, e9=e9, top_left=top_left, zplane=zplane,
                esum_plane=esum_plane, s=s, det=det, inv_det=inv_det,
                inv_det_s=inv_det_s, z=z, valid=tvalid,
                clip_rect=clip_rect, dplane=dplane, dplane9=dplane9)


def pixel_centres(height: int, width: int, dev, row0: int = 0):
    """(py, px) (H,W) pixel centres of a frame whose first row is global row
    ``row0`` (a band of a frame): py = (y + 0.5) + row0, the kernels'
    order, so a band's planes equal the whole frame's bit for bit."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    return (py + float(row0) if row0 else py), px


def depth_reduce(setup, defer_tri, clear_z, viewport, height: int,
                 width: int, chunk: int = 64, row0: int = 0):
    """Argmin-reduce over deferred triangles (the flat reference solve) of
    ``height`` rows from global row ``row0`` (reference deferred.py:198).

    Returns (best_id (H,W) int32 [-1 = background], best_depth (H,W) f32).
    Exact-depth ties go to the later draw id (LESSEQUAL)."""
    dev = setup["e_coef"].device
    py, px = pixel_centres(height, width, dev, row0)
    vp = viewport
    scissor = ((px >= vp[0]) & (px < vp[0] + vp[2])
               & (py >= vp[1]) & (py < vp[1] + vp[3]))

    t = setup["e_coef"].shape[0]
    tvalid = setup["valid"] & defer_tri
    ids_all = torch.arange(t, dtype=torch.int32, device=dev)
    dplane = setup["dplane"]
    n_planes = dplane.shape[1]
    best_d = torch.broadcast_to(torch.as_tensor(clear_z, dtype=torch.float32,
                                                device=dev),
                                (height, width)).clone()
    best_i = torch.full((height, width), -1, dtype=torch.int32, device=dev)

    def plane(coef):                       # coef (C,3) -> (C,H,W)
        return (coef[:, 0, None, None] * px + coef[:, 1, None, None] * py
                + coef[:, 2, None, None])

    for c0 in range(0, t, chunk):
        sl = slice(c0, min(t, c0 + chunk))
        ec = setup["e_coef"][sl]
        tl = setup["top_left"][sl]
        zv = setup["z"][sl]
        ivs = setup["inv_det_s"][sl]
        ep = setup["esum_plane"][sl]
        ss = setup["s"][sl]
        tv = tvalid[sl]
        rect = setup["clip_rect"][sl]
        ids = ids_all[sl]
        e0 = plane(ec[:, 0])
        e1 = plane(ec[:, 1])
        e2 = plane(ec[:, 2])
        cov = (((e0 > 0) | ((e0 == 0) & tl[:, 0, None, None]))
               & ((e1 > 0) | ((e1 == 0) & tl[:, 1, None, None]))
               & ((e2 > 0) | ((e2 == 0) & tl[:, 2, None, None])))
        esum = plane(ep) * ss[:, None, None]
        depth = (e0 * zv[:, 0, None, None] + e1 * zv[:, 1, None, None]
                 + e2 * zv[:, 2, None, None]) * ivs[:, None, None]
        cov &= ((esum > 0) & (depth >= 0.0) & (depth <= 1.0)
                & tv[:, None, None] & scissor[None])
        cov &= ((px[None] >= rect[:, 0, None, None])
                & (py[None] >= rect[:, 1, None, None])
                & (px[None] < rect[:, 2, None, None])
                & (py[None] < rect[:, 3, None, None]))
        for p in range(n_planes):
            cov &= plane(dplane[sl][:, p]) >= 0
        dm = torch.where(cov, depth, _BIG)
        dmin = torch.amin(dm, dim=0)
        idwin = torch.amax(torch.where(dm == dmin[None], ids[:, None, None],
                                       -1), dim=0)
        better = (idwin >= 0) & ((dmin < best_d)
                                 | ((dmin == best_d) & (idwin > best_i)))
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, idwin, best_i)
    return best_i, best_d


# ---------------------------------------------------------------------------
# Fixed-function deferred shade
# ---------------------------------------------------------------------------

def _address_pp(coord, fsize, mode):
    """Per-pixel texel addressing (mode is a per-pixel int tensor)."""
    wrap = torch.remainder(coord, fsize)
    period = torch.remainder(coord, 2.0 * fsize)
    mirror = torch.where(period < fsize, period, 2.0 * fsize - 1e-4 - period)
    mirror_once = torch.minimum(torch.clamp(torch.abs(coord), min=0.0),
                                fsize - 1e-4)
    clamp = torch.minimum(torch.clamp(coord, min=0.0), fsize - 1e-4)
    out = torch.where(mode == int(VXTEXTURE_ADDRESS.MIRRORONCE),
                      mirror_once, clamp)
    out = torch.where(mode == int(VXTEXTURE_ADDRESS.MIRROR), mirror, out)
    return torch.where(mode == int(VXTEXTURE_ADDRESS.WRAP), wrap, out)


def _tex_params(tex_hw, tid):
    """Per-element texture parameters from the (NT, 2..5) tex_hw table.

    tex_hw column layouts (static): 2 = per-texture planes; 3 = planes +
    mip column; 4 = packed ATLAS (h, w, off_y, off_x); 5 = atlas + mips
    (h, w, levels, off_y, off_x)."""
    tid_c = torch.clamp(tid, 0, tex_hw.shape[0] - 1).long()
    h0 = tex_hw[tid_c, 0].to(torch.float32)
    w0 = tex_hw[tid_c, 1].to(torch.float32)
    ncols = tex_hw.shape[1]
    has_mips = ncols in (3, 5)
    is_atlas = ncols >= 4
    n_levels = (tex_hw[tid_c, 2].to(torch.float32) if has_mips
                else torch.ones_like(h0))
    if is_atlas:
        atl_y = tex_hw[tid_c, ncols - 2].to(torch.float32)
        atl_x = tex_hw[tid_c, ncols - 1].to(torch.float32)
        plane = torch.zeros_like(h0)
        base_tw = w0           # per-texture mip column = its own base width
    else:
        atl_y = torch.zeros_like(h0)
        atl_x = torch.zeros_like(h0)
        plane = tid_c.to(torch.float32)
        base_tw = torch.zeros_like(h0)   # filled statically by the core
    return dict(h0=h0, w0=w0, n_levels=n_levels, atl_y=atl_y, atl_x=atl_x,
                plane=plane, base_tw=base_tw)


_TEX_PARAM_KEYS = ("h0", "w0", "n_levels", "atl_y", "atl_x", "plane",
                   "base_tw")
_SH_SI_COLS = (SI_TEX, SI_TEXADDR, SI_TEXFILTER, SI_TEXBLEND, SI_FOG,
               SI_PERSPECTIVE, SI_TEXGEN, SI_COLORWRITE)
_SH_SF_COLS = (SF_BORDER_R, SF_BORDER_R + 1, SF_BORDER_R + 2,
               SF_BORDER_R + 3, SF_CONST_R, SF_CONST_R + 1, SF_CONST_R + 2)


def _shade_state_rows(state_i, state_f, tex_hw):
    """(S, 22) packed per-state shade columns: the 8 si + 7 sf columns the
    fixed-function shade reads, plus the 7 per-texture sampling params."""
    prm = _tex_params(tex_hw, state_i[:, SI_TEX])
    # Column slices, not a list index: a list becomes an index tensor that
    # is copied from the host.
    return torch.cat([
        torch.stack([state_i[:, c] for c in _SH_SI_COLS], 1).to(
            torch.float32),
        torch.stack([state_f[:, c] for c in _SH_SF_COLS], 1),
        torch.stack([prm[k] for k in _TEX_PARAM_KEYS], dim=-1),
    ], dim=1)


def sample_texture_pp(tex_planes, tex_hw, tid, u, v, mode, filt, border_rgba,
                      lod=None):
    """Sampling with a texture id per element (and optional mips): the
    texture parameters of each element's ``tid`` from ``tex_hw``, then
    :func:`_sample_texture_core` with no sampler profile. tid/u/v/mode/filt
    share one shape; returns 4 planes of it. The vertex stage's bump fetch
    (EMBM) samples through this."""
    prm = _tex_params(tex_hw, tid)
    has_mips = tex_hw.shape[1] in (3, 5)
    return _sample_texture_core(tex_planes, has_mips, prm, u, v, mode, filt,
                                border_rgba, lod)


def _sample_texture_core(tex_planes, has_mips, prm, u, v, mode, filt,
                         border_rgba, lod=None, profile=None, quad_flat=None):
    """Sampling core over precomputed per-element texture params (see
    :func:`_tex_params`); wrap/clamp/mirror/border addressing, nearest and
    bilinear filters, mips, atlas offsets, and the one-gather quad-texel
    table (``quad_flat``) when the static sampler profile allows it."""
    any_nearest = profile is None or bool(profile[0])
    any_mip = profile is None or bool(profile[1])
    use_quad = (quad_flat is not None and profile is not None
                and len(profile) > 2 and bool(profile[2]))
    nt, _, th, taw = tex_planes.shape
    flat = tex_planes.permute(0, 2, 3, 1).reshape(nt * th * taw, 4)
    h0 = prm["h0"]
    w0 = prm["w0"]
    n_levels = prm["n_levels"].to(torch.int32)
    atl_y = prm["atl_y"]
    atl_x = prm["atl_x"]
    plane = prm["plane"].to(torch.int32)
    # non-atlas entries signal base_tw=0: global mip column = max base width
    glob_col = float((taw * 2) // 3 if has_mips else 0.0)
    base_tw = torch.where(prm["base_tw"] > 0, prm["base_tw"], glob_col)
    border = mode == int(VXTEXTURE_ADDRESS.BORDER)

    linear = ((filt == int(VXTEXTURE_FILTER.LINEAR))
              | (filt == int(VXTEXTURE_FILTER.LINEARMIPNEAREST))
              | (filt == int(VXTEXTURE_FILTER.LINEARMIPLINEAR))
              | (filt == int(VXTEXTURE_FILTER.ANISOTROPIC)))

    def texel_index(cu, cv, w, h, x_off, y_off):
        iu = torch.minimum(torch.clamp(_address_pp(cu, w, mode), min=0),
                           w - 1) + x_off
        iv = torch.minimum(torch.clamp(_address_pp(cv, h, mode), min=0),
                           h - 1) + y_off
        return (plane * (th * taw) + iv.to(torch.int32) * taw
                + iu.to(torch.int32))

    def sample_level(level):
        """level: int32 tensor. Returns a list of 4 planes."""
        lf = level.to(torch.float32)
        scale = torch.exp2(-lf)
        w = torch.clamp(torch.floor(w0 * scale), min=1.0)
        h = torch.clamp(torch.floor(h0 * scale), min=1.0)
        x_off = torch.where(level == 0, 0.0, base_tw) + atl_x
        y_off = torch.where(level <= 1, 0.0,
                            h0 - torch.floor(h0 * torch.exp2(-(lf - 1.0)))
                            ) + atl_y
        tu = u * w
        tv = v * h

        def fetch(cu, cv):
            idx = texel_index(cu, cv, w, h, x_off, y_off)
            texel = flat.index_select(0, idx.reshape(-1).long()).reshape(
                tuple(idx.shape) + (4,)).to(torch.float32)
            return [texel[..., c] for c in range(4)]

        fu = tu - 0.5
        fv = tv - 0.5
        u0_ = torch.floor(fu)
        v0_ = torch.floor(fv)
        du = fu - u0_
        dv = fv - v0_
        if use_quad:
            idx = texel_index(u0_, v0_, w, h, x_off, y_off)
            q = quad_flat.index_select(0, idx.reshape(-1).long()).reshape(
                tuple(idx.shape) + (16,)).to(torch.float32)
            # Clamp-family modes send a below-range base and its +1 neighbor
            # to the SAME edge texel; the baked neighbor is the interior one,
            # so zero the fraction there (wrap keeps it).
            wrapm = mode == int(VXTEXTURE_ADDRESS.WRAP)
            du_e = torch.where(~wrapm & (u0_ < 0), 0.0, du)
            dv_e = torch.where(~wrapm & (v0_ < 0), 0.0, dv)
            lin = [q[..., c] * (1 - du_e) * (1 - dv_e)
                   + q[..., 4 + c] * du_e * (1 - dv_e)
                   + q[..., 8 + c] * (1 - du_e) * dv_e
                   + q[..., 12 + c] * du_e * dv_e for c in range(4)]
        else:
            c00 = fetch(u0_, v0_)
            c10 = fetch(u0_ + 1.0, v0_)
            c01 = fetch(u0_, v0_ + 1.0)
            c11 = fetch(u0_ + 1.0, v0_ + 1.0)
            lin = [c00[c] * (1 - du) * (1 - dv) + c10[c] * du * (1 - dv)
                   + c01[c] * (1 - du) * dv + c11[c] * du * dv
                   for c in range(4)]
        if any_nearest:
            near = fetch(tu, tv)
            out = [torch.where(linear, lin[c], near[c]) for c in range(4)]
        else:
            out = lin
        oob = (tu < 0) | (tu >= w) | (tv < 0) | (tv >= h)
        return [torch.where(border & oob, border_rgba[c], out[c])
                for c in range(4)]

    if lod is None or not has_mips or not any_mip:
        return sample_level(torch.zeros_like(plane))

    mip_near = ((filt == int(VXTEXTURE_FILTER.MIPNEAREST))
                | (filt == int(VXTEXTURE_FILTER.LINEARMIPNEAREST)))
    mip_lin = ((filt == int(VXTEXTURE_FILTER.MIPLINEAR))
               | (filt == int(VXTEXTURE_FILTER.LINEARMIPLINEAR))
               | (filt == int(VXTEXTURE_FILTER.ANISOTROPIC)))
    use_mip = mip_near | mip_lin
    lod_c = torch.minimum(torch.clamp(torch.where(use_mip, lod, 0.0), min=0.0),
                          (n_levels - 1).to(torch.float32))
    l0 = torch.floor(lod_c).to(torch.int32)
    frac = lod_c - l0.to(torch.float32)
    l0 = torch.where(mip_near, torch.round(lod_c).to(torch.int32), l0)
    l1 = torch.minimum(torch.clamp(l0 + 1, min=0), n_levels - 1)
    s0 = sample_level(l0)
    s1 = sample_level(l1)
    return [torch.where(mip_lin, s0[c] * (1 - frac) + s1[c] * frac, s0[c])
            for c in range(4)]


def tex_blend_pp(mode, tex, diff, const=None):
    """Per-pixel texture-stage blend; mode int tensor; tex/diff lists of
    planes; const: optional 3 planes of the per-draw constant color."""
    tr, ta = tex[:3], tex[3]
    dr, da = diff[:3], diff[3]
    cr = const if const is not None else dr
    dot = ((tr[0] - 0.5) * (dr[0] - 0.5) + (tr[1] - 0.5) * (dr[1] - 0.5)
           + (tr[2] - 0.5) * (dr[2] - 0.5)) * 4.0
    dotc = torch.clamp(((tr[0] - 0.5) * (cr[0] - 0.5)
                        + (tr[1] - 0.5) * (cr[1] - 0.5)
                        + (tr[2] - 0.5) * (cr[2] - 0.5)) * 4.0, 0.0, 1.0)
    B = VXTEXTUREBLEND
    is_decal = ((mode == int(B.DECAL)) | (mode == int(B.COPY))
                | (mode == int(B.DECALMASK)))
    is_mod = ((mode == int(B.MODULATE)) | (mode == int(B.MODULATEALPHA))
              | (mode == int(B.MODULATEMASK)))
    out = []
    for c in range(3):
        # jnp.select semantics: the FIRST matching condition wins, so the
        # chain is built from the last case up.
        v = torch.where(mode == int(B.MAX), torch.maximum(tr[c], dr[c]), dr[c])
        v = torch.where(mode == TEXBLEND_DOT3FACTOR, dotc, v)
        v = torch.where(mode == int(B.DOTPRODUCT3), dot, v)
        v = torch.where(mode == int(B.ADD), dr[c] + tr[c], v)
        v = torch.where(mode == int(B.DECALALPHA),
                        dr[c] * (1 - ta) + tr[c] * ta, v)
        v = torch.where(is_mod, tr[c] * dr[c], v)
        v = torch.where(is_decal, tr[c], v)
        out.append(v)
    alpha = torch.where(is_decal, ta, torch.where(is_mod, ta * da, da))
    out.append(alpha)
    return out


def shade_deferred(best_id, batch_xyw, batch_z, batch_color, batch_spec,
                   batch_uv, batch_fog, batch_state, state_i, state_f,
                   tex_planes, tex_hw, fog_color, clear_fb,
                   height: int, width: int, batch_refl=None,
                   pixel_shader=None, sampler_profile=None, tex_quad=None,
                   row0: int = 0):
    """One shading evaluation per pixel on the winning triangle.

    Fixed-function frames take :func:`_shade_deferred_fast`; a frame with
    a ``pixel_shader`` (a user stage, ``raster/stage.py``) the per-pixel
    gather :func:`_shade_deferred_ps`. ``row0``: the global row of the
    frame's first row (a band of a frame). Returns (4,H,W) fb planes
    (background pixels keep clear_fb)."""
    if pixel_shader is not None:
        return _shade_deferred_ps(
            best_id, batch_xyw, batch_color, batch_spec, batch_uv,
            batch_fog, batch_state, state_i, state_f, tex_planes, tex_hw,
            fog_color, clear_fb, height, width, pixel_shader,
            batch_refl=batch_refl, row0=row0)
    return _shade_deferred_fast(
        best_id, batch_xyw, batch_color, batch_spec, batch_uv, batch_fog,
        batch_state, state_i, state_f, tex_planes, tex_hw, fog_color,
        clear_fb, height, width, batch_refl=batch_refl,
        sampler_profile=sampler_profile, tex_quad=tex_quad, row0=row0)


def _shade_deferred_ps(best_id, batch_xyw, batch_color, batch_spec,
                       batch_uv, batch_fog, batch_state, state_i, state_f,
                       tex_planes, tex_hw, fog_color, clear_fb, height: int,
                       width: int, pixel_shader, batch_refl=None,
                       row0: int = 0):
    """The per-pixel-gather shade of a pixel-shader frame (the reference's
    ``_shade_deferred_ps``): every winner attribute gathered per pixel, the
    edge values from per-pixel adjoints, the full ``si`` / ``sf`` state
    rows, the cube-env UV from the interpolated reflection vector, the
    analytic mip LOD from the neighbours' edge values, and the texel (white
    where the state binds no texture). The stage receives ``color``
    (H,W,4), ``texel`` (H,W,4), ``uv`` (H,W,2), ``xy`` (H,W,2) pixel
    centres, ``si`` (H,W,NUM_SI) int32 and ``sf`` (H,W,NUM_SF) and returns
    (H,W,4); specular, fog, the clamp and the colour-write mask follow it.
    ``row0``: the global row of the frame's first row (a band)."""
    dev = best_id.device
    py, px = pixel_centres(height, width, dev, row0)
    hit = best_id >= 0
    tid = torch.clamp(best_id, 0, batch_xyw.shape[0] - 1)

    def take(a):                                   # (T,...) -> (H,W,...)
        return take_small(a, tid)

    xyw = take(batch_xyw)                          # (H,W,3,3)
    v0, v1, v2 = xyw[..., 0, :], xyw[..., 1, :], xyw[..., 2, :]
    adj0 = torch.linalg.cross(v1, v2)
    adj1 = torch.linalg.cross(v2, v0)
    adj2 = torch.linalg.cross(v0, v1)
    det = torch.sum(v0 * adj0, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    p1 = torch.stack([px, py, torch.ones_like(px)], dim=-1)   # (H,W,3)
    e0 = torch.sum(adj0 * p1, -1)
    e1 = torch.sum(adj1 * p1, -1)
    e2 = torch.sum(adj2 * p1, -1)
    esum = e0 + e1 + e2

    sidx = take(batch_state)                       # (H,W) state row
    si_all = take_small(state_i, sidx)             # (H,W,NUM_SI)
    sf_all = take_small(state_f, sidx)             # (H,W,NUM_SF)

    def si(c):
        return si_all[..., c]

    def sf(c):
        return sf_all[..., c]

    persp = si(SI_PERSPECTIVE) != 0
    inv_esum = 1.0 / torch.where(torch.abs(esum) < 1e-30, 1e-30, esum)
    ws = xyw[..., 2]                               # (H,W,3) vertex w
    w0 = torch.where(persp, e0 * inv_esum, e0 * ws[..., 0] * inv_det)
    w1 = torch.where(persp, e1 * inv_esum, e1 * ws[..., 1] * inv_det)
    w2 = torch.where(persp, e2 * inv_esum, e2 * ws[..., 2] * inv_det)

    def interp3(attr, a0=w0, a1=w1, a2=w2):        # attr (T,3,K)
        a = take(attr)                             # (H,W,3,K)
        return (a0[..., None] * a[..., 0, :] + a1[..., None] * a[..., 1, :]
                + a2[..., None] * a[..., 2, :])

    color = interp3(batch_color)                   # (H,W,4)
    has_tex = si(SI_TEX) >= 0
    uvi = interp3(batch_uv)                        # (H,W,2)
    if _has_refl(batch_refl):
        # Per-pixel cube-env UV: oct-encode AFTER interpolating the world
        # reflection vector (seam-free).
        r = interp3(batch_refl)
        r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                            min=1e-12)
        is_cube = (si(SI_TEXGEN) == TEXGEN_CUBE)[..., None]
        uvi = torch.where(is_cube, oct_encode(r), uvi)
    border = [sf(SF_BORDER_R + c) for c in range(4)]

    # Per-pixel mip LOD from screen-space UV gradients: the edge functions
    # are affine (slope a per +x, b per +y), so re-weighting at the
    # neighbouring pixels gives exact footprints.
    lod = None
    if tex_hw.shape[1] > 2:
        def uv_at(de0, de1, de2):
            e0n, e1n, e2n = e0 + de0, e1 + de1, e2 + de2
            esum_n = e0n + e1n + e2n
            inv_n = 1.0 / torch.where(torch.abs(esum_n) < 1e-30, 1e-30,
                                      esum_n)
            return interp3(
                batch_uv,
                torch.where(persp, e0n * inv_n, e0n * ws[..., 0] * inv_det),
                torch.where(persp, e1n * inv_n, e1n * ws[..., 1] * inv_det),
                torch.where(persp, e2n * inv_n, e2n * ws[..., 2] * inv_det))

        uv_dx = uv_at(adj0[..., 0], adj1[..., 0], adj2[..., 0]) - uvi
        uv_dy = uv_at(adj0[..., 1], adj1[..., 1], adj2[..., 1]) - uvi
        tidc = torch.clamp(si(SI_TEX), 0, tex_hw.shape[0] - 1).long()
        tsize = torch.stack([tex_hw[tidc, 1], tex_hw[tidc, 0]], -1).to(
            torch.float32)                         # (H,W,2) (w,h)
        rho = torch.maximum(
            torch.linalg.vector_norm(uv_dx * tsize, dim=-1),
            torch.linalg.vector_norm(uv_dy * tsize, dim=-1))
        lod = torch.log2(torch.clamp(rho, min=1.0))

    texel = sample_texture_pp(
        tex_planes, tex_hw, si(SI_TEX), uvi[..., 0], uvi[..., 1],
        si(SI_TEXADDR), si(SI_TEXFILTER), border, lod=lod)
    texel4 = torch.stack([torch.where(has_tex, texel[c], 1.0)
                          for c in range(4)], -1)
    out = call_stage(pixel_shader, {
        "color": color, "texel": texel4, "uv": uvi,
        "xy": torch.stack([px, py], -1), "si": si_all, "sf": sf_all},
        device=dev)
    colorp = [out[..., c] for c in range(4)]

    spec = interp3(batch_spec)                     # (H,W,3)
    for c in range(3):
        colorp[c] = colorp[c] + spec[..., c]
    fog_on = si(SI_FOG) != 0
    fogf = torch.clamp(interp3(batch_fog[..., None])[..., 0], 0.0, 1.0)
    for c in range(3):
        colorp[c] = torch.where(
            fog_on, colorp[c] * fogf + fog_color[c] * (1.0 - fogf), colorp[c])
    colorp = [torch.clamp(c, 0.0, 1.0) for c in colorp]
    # Z-only draws occlude but leave the background color.
    hit = hit & (si(SI_COLORWRITE) != 0)
    return torch.stack([torch.where(hit, colorp[c], clear_fb[c])
                        for c in range(4)])


# Shade row-table column layout: everything one pixel needs to shade its
# winning triangle, in ONE wide f32 row.
SH_EC = slice(0, 9)      # edge-plane coefficients (adjoint rows)
SH_WS = slice(9, 12)     # vertex w's
SH_IVD = 12              # inverse determinant (same sign convention as EC)
SH_COL = slice(13, 25)   # corner colors (3 x RGBA)
SH_SPC = slice(25, 34)   # corner speculars (3 x RGB)
SH_UV = slice(34, 40)    # corner UVs (3 x 2)
SH_FOG = slice(40, 43)   # corner fog factors
SH_SI = 43               # 8 int state cols, order = _SH_SI_COLS
SH_SF = 51               # 7 f32 state cols, order = _SH_SF_COLS
SH_TP = 58               # 7 texture-params cols, order = _TEX_PARAM_KEYS
SH_RFL = slice(65, 74)   # corner world reflection vectors (cube env only)
SH_NCOL = 65             # without refl; 74 with


def _has_refl(batch_refl) -> bool:
    return batch_refl is not None and batch_refl.shape[-1] > 0


def shade_row_table(batch_xyw, batch_color, batch_spec, batch_uv, batch_fog,
                    batch_state, state_i, state_f, tex_hw, batch_refl=None):
    """(T, SH_NCOL[+9]) packed shade rows (dense build, one wide row); the
    corners' world reflection vectors ride columns SH_RFL when
    ``batch_refl`` has them."""
    t = batch_xyw.shape[0]
    v0, v1, v2 = batch_xyw[:, 0], batch_xyw[:, 1], batch_xyw[:, 2]
    adj0 = torch.linalg.cross(v1, v2)
    adj1 = torch.linalg.cross(v2, v0)
    adj2 = torch.linalg.cross(v0, v1)
    det = torch.sum(v0 * adj0, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    ec9 = torch.cat([adj0, adj1, adj2], dim=1)
    st_t = take_small(_shade_state_rows(state_i, state_f, tex_hw),
                      batch_state)                                 # (T,22)
    cols = [
        ec9,
        batch_xyw[..., 2],
        inv_det[:, None],
        batch_color.reshape(t, 12),
        batch_spec.reshape(t, 9),
        batch_uv.reshape(t, 6),
        batch_fog.reshape(t, 3),
        st_t,
    ]
    if _has_refl(batch_refl):
        cols.append(batch_refl.reshape(t, 9))
    return torch.cat(cols, dim=1)


# Compact shade-row layout: the 22 per-state columns are replaced by ONE
# state-index column and re-joined per pixel from the small state bank
# (expand_rows_compact). It carries the solve's signed edge coefficients, so
# shade_rows computes the analytic mip LOD from it (odd-sized mip frames,
# and frames without a sampler profile).
SH_C_STIDX = 43          # after EC(9) WS(3) IVD(1) COL(12) SPC(9) UV(6) FOG(3)
SH_C_NCOL = 44           # without refl; 53 with
SH_C_RFL = slice(44, 53)


def shade_row_table_compact(batch_xyw, batch_color, batch_spec, batch_uv,
                            batch_fog, batch_state, e_coef, inv_det_s,
                            batch_refl=None):
    """(T, SH_C_NCOL[+9]) compact f32 shade rows: per-triangle data plus
    the state INDEX, then the corners' world reflection vectors (SH_C_RFL)
    when ``batch_refl`` has them. ``e_coef`` (T,9) or (T,3,3) and
    ``inv_det_s`` are the signed pair from triangle_setup (the shade uses
    ratios only)."""
    t = batch_xyw.shape[0]
    cols = [
        e_coef.reshape(t, 9),
        batch_xyw[..., 2],
        inv_det_s[:, None],
        batch_color.reshape(t, 12),
        batch_spec.reshape(t, 9),
        batch_uv.reshape(t, 6),
        batch_fog.reshape(t, 3),
        batch_state.to(torch.float32)[:, None],
    ]
    if _has_refl(batch_refl):
        cols.append(batch_refl.reshape(t, 9))
    return torch.cat(cols, dim=1)


def _state_rows_at(stidx, state_i, state_f, tex_hw, h: int, w: int):
    """(22,H,W) per-state shade columns of each pixel's state index: an
    exact row gather from the small state bank (index clamped)."""
    st = _shade_state_rows(state_i, state_f, tex_hw)          # (S, 22)
    stidx = torch.clamp(stidx.reshape(-1).long(), 0, st.shape[0] - 1)
    return st.index_select(0, stidx).T.reshape(st.shape[1], h, w)


def expand_rows_compact(rows_c, state_i, state_f, tex_hw):
    """Compact per-pixel rows (SH_C_NCOL[+9],H,W) -> the shade_rows layout
    (SH_NCOL[+9],H,W): the 22 per-state columns join per pixel from the
    state bank by index; reflection columns follow them."""
    h, w = rows_c.shape[1], rows_c.shape[2]
    st_px = _state_rows_at(rows_c[SH_C_STIDX], state_i, state_f, tex_hw,
                           h, w)
    return torch.cat([rows_c[:SH_C_STIDX], st_px, rows_c[SH_C_NCOL:]])


# Quantized shade-row layout: colors, speculars and fog quantize to u8
# packed four per int32 word (the reference's D3D9 vertex precision,
# D3DCOLOR DWORDs saturated per vertex), f32 columns travel bitcast, and the
# nine edge coefficients drop out: the caller supplies each pixel's winner
# (e0, e1, e2) instead (shade_rows ``eplanes``).
SH_Q_UV = slice(0, 6)     # corner UVs (3 x 2), f32
SH_Q_STIDX = 6            # state index, int
SH_Q_COL = slice(7, 10)   # 3 words: corner RGBA as u8x4
SH_Q_SPF = slice(10, 13)  # 3 words: corner spec RGB + fog as u8x4
SH_Q_NBASE = 13           # +4 (ws3, ivd) when any non-perspective state;
                          # +9 refl (f32) when cube env; padded to 16
                          # words, or to a multiple of 4 (24 or 28 with
                          # refl)


def _q8(v):
    """[0,1] f32 -> u8 as int32 (round half to even, saturated) — the D3D9
    vertex-color DWORD quantization."""
    return torch.round(torch.clamp(v, 0.0, 1.0) * 255.0).to(torch.int32)


def _pack4(b0, b1, b2, b3):
    """Four bytes -> one int32 word, b3 in the top byte (which sets the
    sign bit): packed in int64 and wrapped into int32's range."""
    w = (b0.long() | (b1.long() << 8) | (b2.long() << 16)
         | (b3.long() << 24))
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _unpack4(word):
    """One int32 word -> four [0,1] f32 planes (arithmetic shift, then
    mask the byte)."""
    inv = f32_on(1.0 / 255.0, word.device)
    return tuple(((word >> (8 * k)) & 0xFF).to(torch.float32) * inv
                 for k in range(4))


def _f2i(x):
    return x.to(torch.float32).contiguous().view(torch.int32)


def _i2f(x):
    return x.contiguous().view(torch.float32)


def shade_row_table_quant(batch_xyw, batch_color, batch_spec, batch_uv,
                          batch_fog, batch_state, batch_refl=None,
                          inv_det_s=None, want_ws: bool = False):
    """(T, 16 or more) int32 quantized shade rows (the SH_Q_* layout).

    ``want_ws``: include the (ws3, ivd) f32 words — needed only when some
    render state disables perspective-correct interpolation. The corners'
    world reflection vectors follow as 9 f32 words when ``batch_refl``
    has them. The table is int32 so packed bytes move bit-transparently."""
    t = batch_xyw.shape[0]
    cols = [_f2i(batch_uv.reshape(t, 6)),
            batch_state.to(torch.int32)[:, None]]
    for k in range(3):
        c = _q8(batch_color[:, k])
        cols.append(_pack4(c[:, 0], c[:, 1], c[:, 2], c[:, 3])[:, None])
    for k in range(3):
        s = _q8(batch_spec[:, k])
        f = _q8(batch_fog[:, k])
        cols.append(_pack4(s[:, 0], s[:, 1], s[:, 2], f)[:, None])
    if want_ws:
        cols += [_f2i(batch_xyw[:, k, 2:3]) for k in range(3)]
        cols.append(_f2i(inv_det_s[:, None]))
    if _has_refl(batch_refl):
        cols += [_f2i(batch_refl[:, k]) for k in range(3)]
    tbl = torch.cat(cols, dim=1)
    n = tbl.shape[1]
    pad = 16 - n if n <= 16 else (-n) % 4
    if pad:
        tbl = F.pad(tbl, (0, pad))
    return tbl


def expand_rows_quant(rows_q, state_i, state_f, tex_hw, want_ws: bool,
                      has_refl: bool):
    """Quantized per-pixel int32 rows (Wq,H,W) -> the shade_rows layout
    (SH_NCOL,H,W) with ZERO edge-coefficient planes (call shade_rows with
    ``eplanes``). The per-state columns join from the small state bank by
    an exact row gather. ``has_refl``: the rows carry the 9 reflection
    words (after the (ws3, ivd) words when ``want_ws``); they land in the
    SH_RFL columns."""
    h, w = rows_q.shape[1], rows_q.shape[2]
    dev = rows_q.device
    zeros9 = torch.zeros((9, h, w), dtype=torch.float32, device=dev)
    off = SH_Q_NBASE
    if want_ws:
        ws_ivd = _i2f(rows_q[off:off + 4])
        off += 4
    else:
        ws_ivd = torch.zeros((4, h, w), dtype=torch.float32, device=dev)
    col12, spc9, fog3 = [], [], []
    for k in range(3):
        col12 += list(_unpack4(rows_q[SH_Q_COL.start + k]))
    for k in range(3):
        r, g, b, f = _unpack4(rows_q[SH_Q_SPF.start + k])
        spc9 += [r, g, b]
        fog3.append(f)
    st_px = _state_rows_at(rows_q[SH_Q_STIDX], state_i, state_f, tex_hw,
                           h, w)
    parts = [zeros9, ws_ivd, torch.stack(col12), torch.stack(spc9),
             _i2f(rows_q[SH_Q_UV]), torch.stack(fog3), st_px]
    if has_refl:
        parts.append(_i2f(rows_q[off:off + 9]))
    return torch.cat(parts)


def _shade_deferred_fast(best_id, batch_xyw, batch_color, batch_spec,
                         batch_uv, batch_fog, batch_state, state_i, state_f,
                         tex_planes, tex_hw, fog_color, clear_fb,
                         height: int, width: int, batch_refl=None,
                         sampler_profile=None, tex_quad=None,
                         row0: int = 0):
    """Packed-row fixed-function deferred shade: ONE per-pixel row gather
    of the winner's shade row, then :func:`shade_rows`."""
    t = batch_xyw.shape[0]
    tbl = shade_row_table(batch_xyw, batch_color, batch_spec, batch_uv,
                          batch_fog, batch_state, state_i, state_f, tex_hw,
                          batch_refl=batch_refl)
    hit = best_id >= 0
    tid = torch.clamp(best_id, 0, t - 1).reshape(-1).long()
    row = tbl.index_select(0, tid).T.reshape(tbl.shape[1], height, width)
    return shade_rows(row, hit, tex_planes, tex_hw, fog_color, clear_fb,
                      height, width, sampler_profile=sampler_profile,
                      tex_quad=tex_quad, row0=row0)


def shade_rows(row, hit, tex_planes, tex_hw, fog_color, clear_fb,
               height: int, width: int, sampler_profile=None, tex_quad=None,
               eplanes=None, row0: int = 0, quad: bool | None = None):
    """Fixed-function shade over per-pixel winner ROWS (C,H,W) in the
    shade_row_table layout: perspective-correct interpolation, mip LOD,
    texture sampling + stage blend, specular add, fog, saturate.

    ``eplanes``: optional (e0, e1, e2) per-pixel winner edge values. The
    row's edge-coefficient block is then never read (the quantized rows
    ship zeros there), and the mip LOD comes from 2x2-quad finite
    differences of the UVs (D3D9's hardware derivative model) on
    even-sized frames, else level 0. ``quad``: whether the frame takes its
    LOD from quads (default: the rows given are of even size); a band of a
    frame (``row0``, its first global row) passes the whole frame's rule,
    and then pairs its own rows, so it starts on an even global row."""
    dev = row.device
    has_mips = tex_hw.shape[1] in (3, 5)
    if quad is None:
        quad = height % 2 == 0 and width % 2 == 0
    elif quad and (row0 % 2 or height % 2):
        raise ValueError("a band of a quad-LOD frame must start and end on "
                         "even rows")
    py, px = pixel_centres(height, width, dev, row0)
    si_pos = {c: i for i, c in enumerate(_SH_SI_COLS)}
    sf_pos = {c: i for i, c in enumerate(_SH_SF_COLS)}

    def si(c):
        return row[SH_SI + si_pos[c]]

    def sf(c):
        return row[SH_SF + sf_pos[c]]

    def plane3(o):
        return row[o] * px + row[o + 1] * py + row[o + 2]

    if eplanes is not None:
        e0, e1, e2 = eplanes
    else:
        e0 = plane3(0)
        e1 = plane3(3)
        e2 = plane3(6)
    esum = e0 + e1 + e2
    persp = si(SI_PERSPECTIVE) != 0
    inv_esum = 1.0 / torch.where(torch.abs(esum) < 1e-30, 1e-30, esum)
    ivd = row[SH_IVD]
    ws0 = row[SH_WS.start]
    ws1 = row[SH_WS.start + 1]
    ws2 = row[SH_WS.start + 2]
    w0 = torch.where(persp, e0 * inv_esum, e0 * ws0 * ivd)
    w1 = torch.where(persp, e1 * inv_esum, e1 * ws1 * ivd)
    w2 = torch.where(persp, e2 * inv_esum, e2 * ws2 * ivd)

    def interp(sl, k):
        """Interpolate k channels stored [v0 x k, v1 x k, v2 x k]."""
        o = sl.start
        return [row[o + c] * w0 + row[o + k + c] * w1 + row[o + 2 * k + c] * w2
                for c in range(k)]

    colorp = interp(SH_COL, 4)
    uvil = interp(SH_UV, 2)
    if row.shape[0] > SH_NCOL:
        # Per-pixel cube-env UV: the interpolated world reflection vector,
        # normalised, then oct-encoded (no seam along the atlas fold).
        rl = interp(SH_RFL, 3)
        r = torch.stack(rl, dim=-1)
        r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                            min=1e-12)
        uvc = oct_encode(r)
        is_cube = si(SI_TEXGEN) == TEXGEN_CUBE
        uvil = [torch.where(is_cube, uvc[..., c], uvil[c]) for c in range(2)]
    has_tex = si(SI_TEX) >= 0
    border = [sf(SF_BORDER_R + c) for c in range(4)]

    # Per-pixel mip LOD from the analytic screen-space UV gradients (edge
    # functions are affine: slope a per +x, b per +y).
    lod = None
    if (tex_hw.shape[1] > 2 and sampler_profile is not None
            and sampler_profile[1] and eplanes is not None and quad):
        # Per-2x2-quad UV derivatives shared by the quad's four pixels;
        # quads straddling a triangle boundary read a neighbour's UV, like
        # real hardware.
        def quad_dd(p):
            ddx = torch.repeat_interleave(p[:, 1::2] - p[:, 0::2], 2, dim=1)
            ddy = torch.repeat_interleave(p[1::2, :] - p[0::2, :], 2, dim=0)
            return ddx, ddy

        tw_, th_ = row[SH_TP + 1], row[SH_TP + 0]
        dux, duy = quad_dd(uvil[0])
        dvx, dvy = quad_dd(uvil[1])
        rho = torch.maximum(
            torch.sqrt((dux * tw_) ** 2 + (dvx * th_) ** 2),
            torch.sqrt((duy * tw_) ** 2 + (dvy * th_) ** 2))
        lod = torch.log2(torch.clamp(rho, min=1.0))
    elif (tex_hw.shape[1] > 2 and eplanes is None
          and (sampler_profile is None or sampler_profile[1])):

        def uv_at(de0, de1, de2):
            e0n, e1n, e2n = e0 + de0, e1 + de1, e2 + de2
            esum_n = e0n + e1n + e2n
            inv_n = 1.0 / torch.where(torch.abs(esum_n) < 1e-30, 1e-30, esum_n)
            w0n = torch.where(persp, e0n * inv_n, e0n * ws0 * ivd)
            w1n = torch.where(persp, e1n * inv_n, e1n * ws1 * ivd)
            w2n = torch.where(persp, e2n * inv_n, e2n * ws2 * ivd)
            o = SH_UV.start
            return [row[o + c] * w0n + row[o + 2 + c] * w1n
                    + row[o + 4 + c] * w2n for c in range(2)]

        ux = uv_at(row[0], row[3], row[6])      # +x: edge-plane a coeffs
        uy = uv_at(row[1], row[4], row[7])      # +y: edge-plane b coeffs
        tw_, th_ = row[SH_TP + 1], row[SH_TP + 0]
        rho = torch.maximum(
            torch.sqrt(((ux[0] - uvil[0]) * tw_) ** 2
                       + ((ux[1] - uvil[1]) * th_) ** 2),
            torch.sqrt(((uy[0] - uvil[0]) * tw_) ** 2
                       + ((uy[1] - uvil[1]) * th_) ** 2))
        lod = torch.log2(torch.clamp(rho, min=1.0))

    # Static any-textured gate (sampler_profile[4]): an untextured frame
    # skips the sampling stage entirely.
    any_tex = (sampler_profile is None or len(sampler_profile) < 5
               or bool(sampler_profile[4]))
    if any_tex:
        prm = {k: row[SH_TP + i] for i, k in enumerate(_TEX_PARAM_KEYS)}
        texel = _sample_texture_core(
            tex_planes, has_mips, prm, uvil[0], uvil[1],
            si(SI_TEXADDR).to(torch.int32), si(SI_TEXFILTER).to(torch.int32),
            border, lod=lod, profile=sampler_profile, quad_flat=tex_quad)
        const = [sf(SF_CONST_R + c) for c in range(3)]
        blended = tex_blend_pp(si(SI_TEXBLEND).to(torch.int32), texel,
                               colorp, const)
        colorp = [torch.where(has_tex, blended[c], colorp[c])
                  for c in range(4)]

    spec = interp(SH_SPC, 3)
    for c in range(3):
        colorp[c] = colorp[c] + spec[c]

    fog_on = si(SI_FOG) != 0
    fogf = torch.clamp(interp(SH_FOG, 1)[0], 0.0, 1.0)
    for c in range(3):
        colorp[c] = torch.where(
            fog_on, colorp[c] * fogf + fog_color[c] * (1.0 - fogf), colorp[c])
    colorp = [torch.clamp(c, 0.0, 1.0) for c in colorp]

    # Z-only draws occlude but leave the background color
    # (VX_MOVEABLE_ZBUFONLY, reference src/CKMesh.cpp:3938-3974).
    hit = hit & (si(SI_COLORWRITE) != 0)
    return torch.stack([torch.where(hit, colorp[c], clear_fb[c])
                        for c in range(4)])
