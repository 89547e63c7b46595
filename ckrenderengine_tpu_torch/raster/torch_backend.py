"""Device containers, branchless state ops and the exact ordered pass.

The counterpart of ``ckrenderengine_tpu.raster.jax_backend``: the
per-triangle ``DeviceBatch``, the D3D compare / blend / texture-address
ops, and the sequential ordered pass that composites the non-deferred
triangles (transparency, alpha-test cutouts, z-override materials) in draw
order — :func:`render_pass` over the whole frame, :func:`render_pass_tiled`
over each screen tile's own triangles. Both run :func:`_one_triangle`, which
is written batched over a leading tile axis: the tiled pass evaluates every
tile's k-th triangle in one call (the reference's ``vmap``), the flat pass is
the same function with one "tile" covering the frame.

This pass is the frame's exact ordered path: below the
``ordered_cap·H·W ≤ 2^26`` gate it IS the ordered pass, and above it it is
what a frame replays when an ordered kernel's phase A reports overflow
(``pipeline/frame.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..math.vxmath import oct_encode
from .deferred import _address_pp, tex_blend_pp
from .stage import call_pixel_stage
from .types import (
    SF_ALPHAREF, SF_BORDER_R, SF_CONST_R, SI_ALPHABLEND, SI_ALPHAFUNC,
    SI_ALPHATEST, SI_BLENDOP, SI_COLORWRITE, SI_CULL, SI_DSTBLEND, SI_FOG,
    SI_PERSPECTIVE, SI_SRCBLEND, SI_TEX, SI_TEXADDR, SI_TEXBLEND,
    SI_TEXFILTER, SI_TEXGEN, SI_ZFUNC, SI_ZWRITE, TEXGEN_CUBE, VXBLEND,
    VXBLENDOP, VXCMP, VXCULL, VXTEXTURE_ADDRESS, VXTEXTURE_FILTER,
)


class DeviceBatch(NamedTuple):
    """Per-triangle device arrays of one frame (see types.TriangleBatch)."""
    xyw: torch.Tensor        # (T,3,3) screen-homogeneous corners
    z: torch.Tensor          # (T,3) clip z
    color: torch.Tensor      # (T,3,4)
    specular: torch.Tensor   # (T,3,3)
    uv: torch.Tensor         # (T,3,2)
    fog: torch.Tensor        # (T,3)
    state_idx: torch.Tensor  # (T,) int32
    valid: torch.Tensor      # (T,) bool
    clip_rect: torch.Tensor  # (T,4) per-triangle scissor [x0,y0,x1,y1] px
    clipd: torch.Tensor      # (T,3,P) per-corner user-clip-plane distances
    refl: torch.Tensor       # (T,3,R) per-corner world reflection vectors
                             # (R = 0 when no cube-env state is present)


def compare_op(func: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """D3D compare; ``func`` int tensor, ``a`` incoming, ``b`` stored."""
    a, b = torch.broadcast_tensors(a, b)
    out = torch.ones_like(a, dtype=torch.bool)
    for code, val in ((VXCMP.GREATEREQUAL, a >= b), (VXCMP.NOTEQUAL, a != b),
                      (VXCMP.GREATER, a > b), (VXCMP.LESSEQUAL, a <= b),
                      (VXCMP.EQUAL, a == b), (VXCMP.LESS, a < b),
                      (VXCMP.NEVER, torch.zeros_like(out))):
        out = torch.where(func == int(code), val, out)
    return out


def z_compare(func: torch.Tensor, depth: torch.Tensor,
              zb: torch.Tensor) -> torch.Tensor:
    """Depth test with a 2-ULP tie window on equality-inclusive compares.

    Depths are in [0,1], so the positive-float bit pattern is
    order-preserving and the window is relative, not an absolute epsilon."""
    zb = torch.broadcast_to(zb, depth.shape)
    dbits = depth.contiguous().view(torch.int32)
    zbits = zb.contiguous().view(torch.int32)
    near = torch.abs(dbits - zbits) <= 2
    strict = compare_op(func, depth, zb)
    eq_incl = ((func == int(VXCMP.LESSEQUAL)) | (func == int(VXCMP.EQUAL))
               | (func == int(VXCMP.GREATEREQUAL)))
    return torch.where(eq_incl, strict | near, strict)


def blend_factor(mode, src, dst, sa, da):
    """Per-channel D3D blend factor; ``mode`` an int tensor broadcast
    against the planes. Unknown modes give ONE."""
    one = torch.ones_like(src)
    B = VXBLEND
    out = one
    for code, val in ((B.SRCALPHASAT, torch.minimum(sa, one - da)),
                      (B.INVDESTCOLOR, one - dst), (B.DESTCOLOR, dst),
                      (B.INVDESTALPHA, one - da), (B.DESTALPHA, da),
                      (B.INVSRCALPHA, one - sa), (B.SRCALPHA, sa),
                      (B.INVSRCCOLOR, one - src), (B.SRCCOLOR, src),
                      (B.ONE, one), (B.ZERO, torch.zeros_like(src))):
        out = torch.where(mode == int(code), val, out)
    return out


def address_coord(coord, size, mode):
    """Texel-space addressing (wrap, mirror, mirror-once, else clamp) of
    float texel coordinates against a float texture size."""
    return _address_pp(coord, size, mode)


def _texel_index(x, size):
    """clip(x, 0, size - 1) truncated to int64; NaN gives 0 (the
    reference's saturating f32 -> int32 cast)."""
    f = torch.minimum(torch.clamp(x, min=0.0), size - 1.0)
    return torch.nan_to_num(f, nan=0.0).to(torch.int64)


def sample_texture(tex_planes, tex_hw, tex_id, u, v, si, sf):
    """Sample the texture stack at level 0 for N triangles at once.

    tex_planes (NT,4,TH,TW); tex_hw (NT,2..5) int32; tex_id (N,) int;
    u, v (N,h,w) coordinates in [0,1] space; si, sf (N, NUM_SI/NUM_SF).
    Returns four (N,h,w) channel planes."""
    nt, _ch, th, tw = tex_planes.shape
    ncols = tex_hw.shape[1]
    is_atlas = ncols >= 4
    tid = torch.clamp(tex_id.long(), 0, tex_hw.shape[0] - 1)

    def per_tri(x):
        return x[:, None, None]

    hf = per_tri(tex_hw[tid, 0].to(torch.float32))
    wf = per_tri(tex_hw[tid, 1].to(torch.float32))
    if is_atlas:
        plane = torch.zeros_like(tid)
        atl_y = tex_hw[tid, ncols - 2].long()
        atl_x = tex_hw[tid, ncols - 1].long()
    else:
        plane = tid
        atl_y = atl_x = torch.zeros_like(tid)
    plane, atl_y, atl_x = per_tri(plane), per_tri(atl_y), per_tri(atl_x)
    mode = per_tri(si[:, SI_TEXADDR])
    filt = per_tri(si[:, SI_TEXFILTER])
    border = mode == int(VXTEXTURE_ADDRESS.BORDER)
    tu = u * wf
    tv = v * hf
    oob = (tu < 0) | (tu >= wf) | (tv < 0) | (tv >= hf)
    Fm = VXTEXTURE_FILTER
    linear = ((filt == int(Fm.LINEAR)) | (filt == int(Fm.LINEARMIPNEAREST))
              | (filt == int(Fm.LINEARMIPLINEAR))
              | (filt == int(Fm.ANISOTROPIC)))
    flat = tex_planes.permute(0, 2, 3, 1).reshape(nt * th * tw, 4)

    def fetch(cu, cv):
        iu = torch.clamp(_texel_index(address_coord(cu, wf, mode), wf)
                         + atl_x, 0, tw - 1)
        iv = torch.clamp(_texel_index(address_coord(cv, hf, mode), hf)
                         + atl_y, 0, th - 1)
        idx = plane * (th * tw) + iv * tw + iu
        texel = flat.index_select(0, idx.reshape(-1)).reshape(
            tuple(idx.shape) + (4,)).to(torch.float32)
        return [texel[..., c] for c in range(4)]

    near = fetch(tu, tv)
    fu = tu - 0.5
    fv = tv - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    du = fu - u0
    dv = fv - v0
    c00 = fetch(u0, v0)
    c10 = fetch(u0 + 1.0, v0)
    c01 = fetch(u0, v0 + 1.0)
    c11 = fetch(u0 + 1.0, v0 + 1.0)
    lin = [c00[c] * (1 - du) * (1 - dv) + c10[c] * du * (1 - dv)
           + c01[c] * (1 - du) * dv + c11[c] * du * dv for c in range(4)]
    out = [torch.where(linear, lin[c], near[c]) for c in range(4)]
    return [torch.where(border & oob, per_tri(sf[:, SF_BORDER_R + c]),
                        out[c]) for c in range(4)]


def _one_triangle(px, py, fb, zb, tri, state_i, state_f, tex_planes, tex_hw,
                  fog_color, scissor, sampler_profile=None,
                  pixel_shader=None):
    """Composite one triangle per leading-axis entry ("tile") onto its
    (N,4,h,w) fb and (N,h,w) zb planes; returns the updated pair.

    ``px``/``py``/``scissor`` broadcast against (N,h,w); ``tri`` holds the
    11 DeviceBatch fields with a leading N axis (N triangles, one per
    tile). ``sampler_profile[4]`` False proves no state binds a texture and
    skips the texel fetch. ``pixel_shader``: a user stage replacing the
    texture blend (``raster/stage.py``), called per tile with the
    reference's shapes: ``color`` / ``texel`` (h,w,4), ``uv`` / ``xy``
    (h,w,2) and the triangle's ``si`` (NUM_SI,) / ``sf`` (NUM_SF,) rows."""
    (xyw, zv, col, spec, uv, fogv, sidx, valid, clip_rect, clipd,
     refl) = tri
    si = state_i[sidx.long()]
    sf = state_f[sidx.long()]

    def t1(x):                       # (N,) per-triangle -> (N,1,1)
        return x[:, None, None]

    def sic(c):
        return t1(si[:, c])

    def sfc(c):
        return t1(sf[:, c])

    v = [[xyw[:, k, c] for c in range(3)] for k in range(3)]

    def cross3(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    adj0 = cross3(v[1], v[2])
    adj1 = cross3(v[2], v[0])
    adj2 = cross3(v[0], v[1])
    det = v[0][0] * adj0[0] + v[0][1] * adj0[1] + v[0][2] * adj0[2]
    s = torch.where(det >= 0, 1.0, -1.0)
    degenerate = torch.abs(det) < 1e-14

    def edge(adj):
        return t1(adj[0]) * px + t1(adj[1]) * py + t1(adj[2])

    e0, e1, e2 = edge(adj0), edge(adj1), edge(adj2)

    def edge_inside(e, adj):
        es = e * t1(s)
        a = adj[0] * s
        b = adj[1] * s
        top_left = (b > 0) | ((b == 0) & (a > 0))
        return (es > 0) | ((es == 0) & t1(top_left))

    inside = (edge_inside(e0, adj0) & edge_inside(e1, adj1)
              & edge_inside(e2, adj2))
    inside = inside & t1(~degenerate & valid)
    # Sub-epsilon screen-area slivers (the same cull as triangle_setup).
    ws = xyw[:, :, 2]
    wmin = torch.amin(ws, dim=1)
    safe_w = torch.where(torch.abs(ws) < 1e-6, 1e-6, ws)
    sxv = xyw[:, :, 0] / safe_w
    syv = xyw[:, :, 1] / safe_w
    area2 = torch.abs((sxv[:, 1] - sxv[:, 0]) * (syv[:, 2] - syv[:, 0])
                      - (sxv[:, 2] - sxv[:, 0]) * (syv[:, 1] - syv[:, 0]))
    inside = inside & t1(~((wmin > 1e-6) & (area2 < 1e-6)))
    inside = inside & scissor
    inside = inside & ((px >= t1(clip_rect[:, 0])) & (py >= t1(clip_rect[:, 1]))
                       & (px < t1(clip_rect[:, 2]))
                       & (py < t1(clip_rect[:, 3])))
    cull = si[:, SI_CULL]
    front = det > 0
    keep = ((cull == int(VXCULL.NONE))
            | ((cull == int(VXCULL.CCW)) & front)
            | ((cull == int(VXCULL.CW)) & ~front))
    inside = inside & t1(keep)

    esum = e0 + e1 + e2
    inv_det = t1(1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det))
    depth = (e0 * t1(zv[:, 0]) + e1 * t1(zv[:, 1])
             + e2 * t1(zv[:, 2])) * inv_det
    inside = inside & (depth >= 0.0) & (depth <= 1.0)

    inv_esum = 1.0 / torch.where(torch.abs(esum) < 1e-30, 1e-30, esum)
    persp = sic(SI_PERSPECTIVE) != 0
    w0 = torch.where(persp, e0 * inv_esum, e0 * t1(xyw[:, 0, 2]) * inv_det)
    w1 = torch.where(persp, e1 * inv_esum, e1 * t1(xyw[:, 1, 2]) * inv_det)
    w2 = torch.where(persp, e2 * inv_esum, e2 * t1(xyw[:, 2, 2]) * inv_det)

    def interp(a0, a1, a2):
        return w0 * t1(a0) + w1 * t1(a1) + w2 * t1(a2)

    for k in range(clipd.shape[-1]):
        inside = inside & (interp(clipd[:, 0, k], clipd[:, 1, k],
                                  clipd[:, 2, k]) >= 0)

    color = [interp(col[:, 0, c], col[:, 1, c], col[:, 2, c])
             for c in range(4)]
    any_tex = (sampler_profile is None or len(sampler_profile) < 5
               or bool(sampler_profile[4]))
    sampled = tex_planes is not None and tex_planes.shape[0] > 0 and any_tex
    has_tex = sic(SI_TEX) >= 0
    texel = None
    if sampled or pixel_shader is not None:
        ui = interp(uv[:, 0, 0], uv[:, 1, 0], uv[:, 2, 0])
        vi = interp(uv[:, 0, 1], uv[:, 1, 1], uv[:, 2, 1])
    if sampled:
        if refl.shape[-1] > 0:
            # Per-pixel cube-env UV: interpolate the world reflection
            # vector, oct-encode after interpolating (no atlas-fold seam).
            r = torch.stack([interp(refl[:, 0, c], refl[:, 1, c],
                                    refl[:, 2, c]) for c in range(3)], -1)
            r = r / torch.clamp(torch.linalg.vector_norm(
                r, dim=-1, keepdim=True), min=1e-12)
            uvc = oct_encode(r)
            is_cube = sic(SI_TEXGEN) == TEXGEN_CUBE
            ui = torch.where(is_cube, uvc[..., 0], ui)
            vi = torch.where(is_cube, uvc[..., 1], vi)
        texel = sample_texture(tex_planes, tex_hw, si[:, SI_TEX], ui, vi,
                               si, sf)
        if pixel_shader is None:
            const = [sfc(SF_CONST_R + c) for c in range(3)]
            blended = tex_blend_pp(sic(SI_TEXBLEND), texel, color, const)
            color = [torch.where(has_tex, blended[c], color[c])
                     for c in range(4)]
    if pixel_shader is not None:
        shape = color[0].shape
        if texel is None:
            texel4 = torch.ones(shape + (4,), dtype=torch.float32,
                                device=fb.device)
        else:
            texel4 = torch.stack([torch.where(has_tex, texel[c], 1.0)
                                  .expand(shape) for c in range(4)], -1)
        out = call_pixel_stage(pixel_shader, {
            "color": torch.stack(color, -1), "texel": texel4,
            "uv": torch.stack([ui.expand(shape), vi.expand(shape)], -1),
            "xy": torch.stack([px.expand(shape), py.expand(shape)], -1),
            "si": si, "sf": sf}, device=fb.device)
        color = [out[..., c] for c in range(4)]

    sp = [interp(spec[:, 0, c], spec[:, 1, c], spec[:, 2, c])
          for c in range(3)]
    color = [color[0] + sp[0], color[1] + sp[1], color[2] + sp[2], color[3]]
    fog_on = sic(SI_FOG) != 0
    fogf = torch.clamp(interp(fogv[:, 0], fogv[:, 1], fogv[:, 2]), 0.0, 1.0)
    color = [torch.where(fog_on, color[c] * fogf + fog_color[c] * (1.0 - fogf),
                         color[c]) for c in range(3)] + [color[3]]
    color = [torch.clamp(c, 0.0, 1.0) for c in color]

    at_on = sic(SI_ALPHATEST) != 0
    at_pass = compare_op(sic(SI_ALPHAFUNC), color[3], sfc(SF_ALPHAREF))
    inside = inside & (at_pass | ~at_on)
    inside = inside & z_compare(sic(SI_ZFUNC), depth, zb)

    blend_on = sic(SI_ALPHABLEND) != 0
    src_mode = sic(SI_SRCBLEND)
    dst_mode = sic(SI_DSTBLEND)
    op = sic(SI_BLENDOP)
    sa = color[3]
    da = fb[:, 3]
    out = []
    for c in range(4):
        src_c = color[c]
        dst_c = fb[:, c]
        sfac = blend_factor(src_mode, src_c, dst_c, sa, da)
        dfac = blend_factor(dst_mode, src_c, dst_c, sa, da)
        if c == 3:                  # SRCALPHASAT uses factor 1 on alpha
            sat = int(VXBLEND.SRCALPHASAT)
            sfac = torch.where(src_mode == sat, torch.ones_like(sfac), sfac)
            dfac = torch.where(dst_mode == sat, torch.ones_like(dfac), dfac)
        s_term = src_c * sfac
        d_term = dst_c * dfac
        blended_c = s_term + d_term
        for code, val in ((VXBLENDOP.MAX, torch.maximum(src_c, dst_c)),
                          (VXBLENDOP.MIN, torch.minimum(src_c, dst_c)),
                          (VXBLENDOP.REVSUBTRACT, d_term - s_term),
                          (VXBLENDOP.SUBTRACT, s_term - d_term)):
            blended_c = torch.where(op == int(code), val, blended_c)
        blended_c = torch.clamp(blended_c, 0.0, 1.0)
        out.append(torch.where(blend_on, blended_c, src_c))

    # Z-only / stencil-only draws never touch color (VX_MOVEABLE_ZBUFONLY,
    # reference src/CKMesh.cpp:3938-3974).
    cwrite = inside & (sic(SI_COLORWRITE) != 0)
    new_fb = torch.stack([torch.where(cwrite, out[c], fb[:, c])
                          for c in range(4)], dim=1)
    zwrite = (sic(SI_ZWRITE) != 0) & inside
    return new_fb, torch.where(zwrite, depth, zb)


def render_pass(fb, zb, batch: DeviceBatch, state_i, state_f, tex_planes,
                tex_hw, fog_color, viewport, pixel_shader=None,
                sampler_profile=None, row0: int = 0):
    """Rasterize a batch in draw order onto (4,H,W) fb and (H,W) zb: one
    full-frame composite per triangle (``pixel_shader``: a user stage,
    called once per triangle on the whole frame). ``row0``: the global row
    of fb's first row (a band of a frame)."""
    from .deferred import pixel_centres

    h, w = fb.shape[1], fb.shape[2]
    py, px = pixel_centres(h, w, fb.device, row0)
    vp = viewport
    scissor = ((px >= vp[0]) & (px < vp[0] + vp[2])
               & (py >= vp[1]) & (py < vp[1] + vp[3]))
    px, py, scissor = px[None], py[None], scissor[None]
    fbn, zbn = fb[None], zb[None]
    for i in range(batch.xyw.shape[0]):
        tri = tuple(a[i:i + 1] for a in batch)
        fbn, zbn = _one_triangle(px, py, fbn, zbn, tri, state_i, state_f,
                                 tex_planes, tex_hw, fog_color, scissor,
                                 sampler_profile=sampler_profile,
                                 pixel_shader=pixel_shader)
    return fbn[0], zbn[0]


def render_pass_tiled(fb, zb, batch: DeviceBatch, state_i, state_f,
                      tex_planes, tex_hw, fog_color, viewport,
                      tile: int = 64, pixel_shader=None,
                      sampler_profile=None, row0: int = 0):
    """Tile-binned ordered pass: each screen tile composites, in the batch's
    (already sorted) stream order, only the triangles whose screen bbox
    overlaps it — a pixel sees exactly the triangle sequence of
    :func:`render_pass`. Slot k of every tile (its k-th overlapping
    triangle, found by a searchsorted over the overlap cumsum) composites
    in one batched :func:`_one_triangle` call (``pixel_shader``: a user
    stage, mapped over the tiles of each slot). ``row0``: the global row of
    fb's first row (a band of a frame; reference jax_backend.py:545-608):
    tile rows count from it, bboxes and pixel centres stay global."""
    from .cuda_tiled import _tile_index, tile_grid, to_tiles, untile
    from .tiled import _screen_bbox

    dev = fb.device
    h, w = fb.shape[1], fb.shape[2]
    t = batch.xyw.shape[0]
    ty = (h + tile - 1) // tile
    tx = (w + tile - 1) // tile
    n_tiles = ty * tx

    x0, y0, x1, y1, _unbounded, empty = _screen_bbox(batch.xyw, batch.z)
    tx0 = _tile_index(x0, tile, tx)
    tx1 = _tile_index(x1, tile, tx)
    ty0 = _tile_index(y0 - row0, tile, ty)
    ty1 = _tile_index(y1 - row0, tile, ty)
    offscreen = ((x1 < 0) | (x0 >= w) | (y1 < row0) | (y0 >= row0 + h)
                 | empty)
    live = batch.valid & ~offscreen
    cx = torch.arange(tx, device=dev)
    cy = torch.arange(ty, device=dev)
    ovx = (cx[None] >= tx0[:, None]) & (cx[None] <= tx1[:, None])   # (T,tx)
    ovy = (cy[None] >= ty0[:, None]) & (cy[None] <= ty1[:, None])   # (T,ty)
    member = (ovy[:, :, None] & ovx[:, None, :]).reshape(t, n_tiles)
    member &= live[:, None]
    inc_t = torch.cumsum(member, dim=0, dtype=torch.int32).T.contiguous()
    counts = inc_t[:, -1] if t else torch.zeros(n_tiles, dtype=torch.int32,
                                                device=dev)

    ph, pw = ty * tile - h, tx * tile - w
    sq = (n_tiles, tile, tile)
    fbt = to_tiles(F.pad(fb, (0, pw, 0, ph)), tile, tx, ty).transpose(
        0, 1).reshape(n_tiles, 4, tile, tile)
    zbt = to_tiles(F.pad(zb, (0, pw, 0, ph), value=1.0), tile, tx,
                   ty).reshape(sq)
    px, py_l = (g.reshape(sq) for g in tile_grid(tile, tx, ty, dev))
    py = py_l + float(row0) if row0 else py_l
    vp = viewport
    scissor = ((px >= vp[0]) & (px < vp[0] + vp[2])
               & (py >= vp[1]) & (py < vp[1] + vp[3]) & (px < w)
               & (py_l < h))

    def padrow(a, fill=0):
        return torch.cat([a, torch.full((1,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=dev)])

    bpad = DeviceBatch(*(padrow(a, False if a.dtype == torch.bool else 0)
                         for a in batch))
    # The slot loop's length is the densest tile's count: one host read per
    # pass (this pass is the exact path, not the kernel path).
    peak = int(counts.max()) if t else 0
    if peak:
        ks = torch.arange(peak, dtype=torch.int32, device=dev)
        ids = torch.searchsorted(inc_t, (ks + 1)[None].expand(n_tiles, peak)
                                 .contiguous())
        ids = torch.where(ks[None] < counts[:, None], ids, t)
        for k in range(peak):
            tri = tuple(a[ids[:, k]] for a in bpad)
            fbt, zbt = _one_triangle(px, py, fbt, zbt, tri, state_i, state_f,
                                     tex_planes, tex_hw, fog_color, scissor,
                                     sampler_profile=sampler_profile,
                                     pixel_shader=pixel_shader)
    fbo = untile(fbt.reshape(n_tiles, 4, -1).transpose(0, 1), tile, tx, ty)
    zbo = untile(zbt.reshape(n_tiles, -1), tile, tx, ty)
    return fbo[:, :h, :w], zbo[:h, :w]
