"""The NULL device: a plain-numpy reference rasterizer.

The counterpart of ``ckrenderengine_tpu.raster.null_backend``, numpy only
as it is. It plays the role of the reference's NULL rasterizer (the
un-overridden CKRasterizer base used headless, reference
CKRasterizerLib/CKRasterizer.cpp:17-66) *and* of a semantics oracle: a
straightforward loop-per-triangle rasterizer, independent of
``raster.torch_backend``, that the device path can be held against.

Algorithm: homogeneous rasterization (edge functions in 2D-homogeneous screen
space from the adjoint of the vertex matrix). Depth is z/w (affine in screen
space, the D3D z-buffer quantity); attributes interpolate perspective-correct
via the 1/w-weighted barycentrics, or screen-linear when perspective
correction is off (DisablePerspectiveCorrection option parity). The pixel
pipeline applies, in order: coverage -> depth range [0,1] -> texture stage ->
specular add -> fog -> alpha test -> z test -> blend -> z write, matching the
DX9 fixed-function order the reference drives via render states.

This file is deliberately scalar-python/numpy and loop-per-triangle — clarity
over speed. It shares no code with the device path.
"""

from __future__ import annotations

import numpy as np

from . import types as T
from .types import (
    SF_ALPHAREF, SF_BORDER_R,
    SI_ALPHABLEND, SI_ALPHAFUNC, SI_ALPHATEST, SI_CULL, SI_DSTBLEND, SI_FOG,
    SI_PERSPECTIVE, SI_SRCBLEND, SI_TEX, SI_TEXADDR, SI_TEXBLEND,
    SI_TEXFILTER, SI_ZFUNC, SI_ZWRITE,
    TriangleBatch, VXBLEND, VXCMP, VXCULL, VXTEXTUREBLEND, VXTEXTURE_ADDRESS,
    VXTEXTURE_FILTER,
)


def _compare(func: int, a, b):
    """D3D compare ops; a is the incoming value, b the stored/ref value."""
    if func == VXCMP.NEVER:
        return np.zeros(np.broadcast(a, b).shape, bool)
    if func == VXCMP.LESS:
        return a < b
    if func == VXCMP.EQUAL:
        return a == b
    if func == VXCMP.LESSEQUAL:
        return a <= b
    if func == VXCMP.GREATER:
        return a > b
    if func == VXCMP.NOTEQUAL:
        return a != b
    if func == VXCMP.GREATEREQUAL:
        return a >= b
    return np.ones(np.broadcast(a, b).shape, bool)  # ALWAYS


def _blend_factor(mode: int, src_rgba, dst_rgba):
    """Returns per-pixel (..., 4) blend factor."""
    sa = src_rgba[..., 3:4]
    da = dst_rgba[..., 3:4]
    one = np.ones_like(src_rgba)
    if mode == VXBLEND.ZERO:
        return np.zeros_like(src_rgba)
    if mode == VXBLEND.ONE:
        return one
    if mode == VXBLEND.SRCCOLOR:
        return src_rgba
    if mode == VXBLEND.INVSRCCOLOR:
        return one - src_rgba
    if mode == VXBLEND.SRCALPHA:
        return np.broadcast_to(sa, src_rgba.shape)
    if mode == VXBLEND.INVSRCALPHA:
        return 1.0 - np.broadcast_to(sa, src_rgba.shape)
    if mode == VXBLEND.DESTALPHA:
        return np.broadcast_to(da, src_rgba.shape)
    if mode == VXBLEND.INVDESTALPHA:
        return 1.0 - np.broadcast_to(da, src_rgba.shape)
    if mode == VXBLEND.DESTCOLOR:
        return dst_rgba
    if mode == VXBLEND.INVDESTCOLOR:
        return one - dst_rgba
    if mode == VXBLEND.SRCALPHASAT:
        f = np.minimum(sa, 1.0 - da)
        out = np.broadcast_to(f, src_rgba.shape).copy()
        out[..., 3] = 1.0
        return out
    return one


def _address(coord, size, mode: int):
    """Texel-space addressing. coord in texel units (float), size = dim."""
    if mode == VXTEXTURE_ADDRESS.WRAP:
        return np.mod(coord, size)
    if mode == VXTEXTURE_ADDRESS.MIRROR:
        period = np.mod(coord, 2 * size)
        return np.where(period < size, period, 2 * size - 1e-4 - period)
    if mode == VXTEXTURE_ADDRESS.MIRRORONCE:
        c = np.abs(coord)
        return np.clip(c, 0, size - 1e-4)
    # CLAMP and BORDER clamp the coordinate; BORDER substitutes color later.
    return np.clip(coord, 0.0, size - 1e-4)


def _sample_texture(tex: np.ndarray, u, v, si, sf):
    """tex (h,w,4) float; u,v in [0,1] texture space (arrays)."""
    h, w = tex.shape[:2]
    mode = int(si[SI_TEXADDR])
    filt = int(si[SI_TEXFILTER])
    border = (mode == VXTEXTURE_ADDRESS.BORDER)
    out_u = u * w
    out_v = v * h
    oob = None
    if border:
        oob = (out_u < 0) | (out_u >= w) | (out_v < 0) | (out_v >= h)
    linear = filt in (VXTEXTURE_FILTER.LINEAR, VXTEXTURE_FILTER.LINEARMIPNEAREST,
                      VXTEXTURE_FILTER.LINEARMIPLINEAR, VXTEXTURE_FILTER.ANISOTROPIC)
    if linear:
        fu = out_u - 0.5
        fv = out_v - 0.5
        u0 = np.floor(fu)
        v0 = np.floor(fv)
        du = (fu - u0)[..., None]
        dv = (fv - v0)[..., None]

        def fetch(cu, cv):
            au = _address(cu, w, mode).astype(np.int64)
            av = _address(cv, h, mode).astype(np.int64)
            return tex[np.clip(av, 0, h - 1), np.clip(au, 0, w - 1)]

        c00 = fetch(u0, v0)
        c10 = fetch(u0 + 1, v0)
        c01 = fetch(u0, v0 + 1)
        c11 = fetch(u0 + 1, v0 + 1)
        result = (c00 * (1 - du) * (1 - dv) + c10 * du * (1 - dv)
                  + c01 * (1 - du) * dv + c11 * du * dv)
    else:
        au = _address(out_u, w, mode).astype(np.int64)
        av = _address(out_v, h, mode).astype(np.int64)
        result = tex[np.clip(av, 0, h - 1), np.clip(au, 0, w - 1)]
    if border:
        bc = sf[SF_BORDER_R:SF_BORDER_R + 4][None]
        result = np.where(oob[..., None], bc, result)
    return result


def _tex_blend(mode: int, tex_rgba, diff_rgba):
    out = diff_rgba.copy()
    tr, ta = tex_rgba[..., :3], tex_rgba[..., 3:4]
    dr, da = diff_rgba[..., :3], diff_rgba[..., 3:4]
    if mode in (VXTEXTUREBLEND.DECAL, VXTEXTUREBLEND.COPY, VXTEXTUREBLEND.DECALMASK):
        return tex_rgba.copy()
    if mode in (VXTEXTUREBLEND.MODULATE, VXTEXTUREBLEND.MODULATEALPHA, VXTEXTUREBLEND.MODULATEMASK):
        out[..., :3] = tr * dr
        out[..., 3:4] = ta * da
        return out
    if mode == VXTEXTUREBLEND.DECALALPHA:
        out[..., :3] = dr * (1 - ta) + tr * ta
        out[..., 3:4] = da
        return out
    if mode == VXTEXTUREBLEND.ADD:
        out[..., :3] = dr + tr
        out[..., 3:4] = da
        return out
    if mode == VXTEXTUREBLEND.DOTPRODUCT3:
        d = np.sum((tr - 0.5) * (dr - 0.5), axis=-1, keepdims=True) * 4.0
        out[..., :3] = d
        out[..., 3:4] = da
        return out
    if mode == VXTEXTUREBLEND.MAX:
        out[..., :3] = np.maximum(tr, dr)
        out[..., 3:4] = da
        return out
    return out


class NullRasterizer:
    """Headless numpy device. Framebuffer is float32 RGBA in [0,1]."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.fb = np.zeros((self.height, self.width, 4), np.float32)
        self.zb = np.ones((self.height, self.width), np.float32)
        self.viewport = (0, 0, self.width, self.height)
        self.textures: list[np.ndarray | None] = []

    # -- device ops ---------------------------------------------------------
    def clear(self, color=(0, 0, 0, 0), z=1.0, clear_color=True, clear_z=True, rect=None):
        ys, xs = slice(None), slice(None)
        if rect is not None:
            x0, y0, x1, y1 = [int(v) for v in rect]
            ys, xs = slice(max(y0, 0), min(y1, self.height)), slice(max(x0, 0), min(x1, self.width))
        if clear_color:
            self.fb[ys, xs] = np.asarray(color, np.float32)
        if clear_z:
            self.zb[ys, xs] = np.float32(z)

    def set_viewport(self, x, y, w, h):
        self.viewport = (int(x), int(y), int(w), int(h))

    def present(self) -> np.ndarray:
        """uint8 RGBA snapshot (BackToFront equivalent)."""
        return np.clip(self.fb * 255.0 + 0.5, 0, 255).astype(np.uint8)

    # -- the rasterizer -----------------------------------------------------
    def draw_batch(self, batch: TriangleBatch, state_i: np.ndarray, state_f: np.ndarray,
                   textures: list[np.ndarray] | None = None):
        textures = textures if textures is not None else self.textures
        vx0, vy0, vw, vh = self.viewport
        scis_x0, scis_y0 = max(vx0, 0), max(vy0, 0)
        scis_x1, scis_y1 = min(vx0 + vw, self.width), min(vy0 + vh, self.height)

        for t in range(batch.xyw.shape[0]):
            if not batch.valid[t]:
                continue
            # float32 throughout: the oracle models a float32 device.
            m = batch.xyw[t].astype(np.float32)  # (3 verts, [X Y W])
            v0, v1, v2 = m[0], m[1], m[2]
            # Analytic adjoint columns: E_j(p) = cross(v_{j+1}, v_{j+2}) . p
            adj = np.stack([np.cross(v1, v2), np.cross(v2, v0), np.cross(v0, v1)],
                           axis=1).astype(np.float32)  # (3 coeffs, 3 edges)
            det = np.float32(v0 @ adj[:, 0])
            if abs(det) < 1e-14:
                continue
            si = state_i[batch.state_idx[t]]
            sf = state_f[batch.state_idx[t]]

            cull = int(si[SI_CULL])
            if cull == VXCULL.CCW and det < 0:
                continue
            if cull == VXCULL.CW and det > 0:
                continue

            s = np.float32(1.0 if det > 0 else -1.0)

            # Conservative screen bbox: project vertices with w>0; if any w<=0,
            # fall back to the full scissor (external triangle).
            ws = m[:, 2]
            if np.all(ws > 1e-12):
                px = m[:, 0] / ws
                py = m[:, 1] / ws
                x0 = max(int(np.floor(px.min())), scis_x0)
                x1 = min(int(np.ceil(px.max())) + 1, scis_x1)
                y0 = max(int(np.floor(py.min())), scis_y0)
                y1 = min(int(np.ceil(py.max())) + 1, scis_y1)
            else:
                x0, x1, y0, y1 = scis_x0, scis_x1, scis_y0, scis_y1
            if x0 >= x1 or y0 >= y1:
                continue

            xs = np.arange(x0, x1, dtype=np.float32) + np.float32(0.5)
            ys = np.arange(y0, y1, dtype=np.float32) + np.float32(0.5)
            pxg, pyg = np.meshgrid(xs, ys)

            e = [adj[0, j] * pxg + adj[1, j] * pyg + adj[2, j] for j in range(3)]
            # Top-left fill rule on w-scaled edge functions, sign-normalized.
            inside = np.ones(pxg.shape, bool)
            for j in range(3):
                ej = e[j] * s
                a = adj[0, j] * s  # x coefficient
                b = adj[1, j] * s  # y coefficient
                top_left = (b > 0) or (b == 0 and a > 0)
                inside &= (ej > 0) | ((ej == 0) & top_left)
            if not inside.any():
                continue

            esum = e[0] + e[1] + e[2]  # = det / w(p)
            # Pixels behind the eye have w<=0 -> esum/det <= 0; inside-sign test
            # already excludes them, but keep a guard for the esum==0 razor.
            inside &= (esum * s) > 0

            zvals = batch.z[t].astype(np.float32)
            inv_det = np.float32(1.0) / det
            depth = (e[0] * zvals[0] + e[1] * zvals[1] + e[2] * zvals[2]) * inv_det
            depth = depth.astype(np.float32)
            inside &= (depth >= 0.0) & (depth <= 1.0)
            if not inside.any():
                continue

            # Interpolation weights.
            if si[SI_PERSPECTIVE]:
                denom = np.where(np.abs(esum) < 1e-30, np.float32(1e-30), esum)
                wj = [(e[j] / denom).astype(np.float32) for j in range(3)]
            else:
                wj = [(e[j] * ws[j] * inv_det).astype(np.float32) for j in range(3)]

            def interp(vals):  # vals (3, K)
                return sum(wj[j][..., None] * vals[j][None, None, :] for j in range(3))

            # User clip planes: interpolated world-space signed distance
            # must be >= 0 (mirror of torch_backend._one_triangle).
            clipd = getattr(batch, "clipd", None)
            if clipd is not None and clipd.shape[-1] > 0:
                dpx = interp(clipd[t].astype(np.float32))      # (h,w,P)
                inside &= np.all(dpx >= 0.0, axis=-1)
                if not inside.any():
                    continue

            color = interp(batch.color[t].astype(np.float32))
            if si[SI_TEX] >= 0 and textures and textures[si[SI_TEX]] is not None:
                uvi = interp(batch.uv[t].astype(np.float32))
                tex = _sample_texture(textures[si[SI_TEX]], uvi[..., 0], uvi[..., 1], si, sf)
                color = _tex_blend(int(si[SI_TEXBLEND]), tex, color)
            spec = interp(batch.specular[t].astype(np.float32))
            color = color.copy()
            color[..., :3] += spec
            if si[SI_FOG]:
                fogf = np.clip(interp(batch.fog[t][:, None].astype(np.float32))[..., 0], 0.0, 1.0)
                fogc = getattr(self, "fog_color", np.zeros(3, np.float32))
                color[..., :3] = color[..., :3] * fogf[..., None] + fogc[None, None, :3] * (1.0 - fogf[..., None])
            color = np.clip(color, 0.0, 1.0)

            if si[SI_ALPHATEST]:
                inside &= _compare(int(si[SI_ALPHAFUNC]), color[..., 3], float(sf[SF_ALPHAREF]))

            zslice = self.zb[y0:y1, x0:x1]
            inside &= _compare(int(si[SI_ZFUNC]), depth, zslice)
            if not inside.any():
                continue

            fbslice = self.fb[y0:y1, x0:x1]
            if si[SI_ALPHABLEND]:
                sfactor = _blend_factor(int(si[SI_SRCBLEND]), color, fbslice)
                dfactor = _blend_factor(int(si[SI_DSTBLEND]), color, fbslice)
                from .types import SI_BLENDOP, VXBLENDOP
                op = int(si[SI_BLENDOP])
                if op == VXBLENDOP.SUBTRACT:
                    out = color * sfactor - fbslice * dfactor
                elif op == VXBLENDOP.REVSUBTRACT:
                    out = fbslice * dfactor - color * sfactor
                elif op == VXBLENDOP.MIN:
                    out = np.minimum(color, fbslice)
                elif op == VXBLENDOP.MAX:
                    out = np.maximum(color, fbslice)
                else:
                    out = color * sfactor + fbslice * dfactor
                out = np.clip(out, 0.0, 1.0)
            else:
                out = color
            fbslice[inside] = out[inside].astype(np.float32)
            if si[SI_ZWRITE]:
                zslice[inside] = depth[inside].astype(np.float32)
