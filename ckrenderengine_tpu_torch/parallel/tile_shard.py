"""One context's framebuffer in horizontal bands over a device mesh.

The counterpart of ``ckrenderengine_tpu/parallel/tile_shard.py``. Contexts
are the other scale axis (``context_batch``); this one splits ONE frame
into ``mesh.shape["band"]`` horizontal bands, one per mesh entry:

- every entry receives the whole packed dynamic state (the two buffers, one
  upload per device) and its own copy of the compile's static tensors,
  made once per (compile, device) and kept by the caller (``copies``);
- each entry renders only its band: the whole frame program (vertex stage,
  phase A, the opaque solve, the shade, the ordered pass, lines and
  overlays) with the band's first global row as ``row0``, while vertices,
  viewport and scissors stay in global screen coordinates. Geometry
  outside the band is rejected by binning and coverage like any
  off-viewport geometry, and the band's pixels equal the same rows of the
  unbanded frame bit for bit (every pixel centre is (y + 0.5) + row0, an
  exact f32 value in either order);
- every route is the whole frame's (``frame.render_frame_impl``'s
  ``frame_h``): the reference decides its routes from the band height and
  gets away with it only because its band path always takes the same XLA
  routes, with its Pallas kernels off (``allow_pallas=False``). On a CUDA
  tensor the port's band launches the hand-written kernels (B1/B5, B2, B3,
  B4, L1) at its row offset.

A mip frame of even size takes its LOD from 2x2 quads of rows (2k, 2k+1).
A band that starts or ends on an odd row renders one more row on that side
(a halo) and drops it, so that its quads are the whole frame's. With
Antialias each band renders ss times its rows at ss times its row offset
and resolves its own windows (the band split composes with Antialias).

The bands come back assembled on ``out_device`` (the context's device):
one copy per band, the gather the reference makes at readback. With every
entry on the context's card it is a device-local copy.
"""

from __future__ import annotations

import torch

from ..pipeline import frame as fr
from .mesh import on, to_device


def band_rows(height: int, n: int, align: bool) -> list:
    """Per band (row0, rows) of a ``height``-row frame in ``n`` bands, and
    the rendered window [r0, r1) that holds it: with ``align`` the window
    starts and ends on even rows. Returns [(row0, rows, r0, r1), ...]."""
    band_h = height // n
    out = []
    for b in range(n):
        row0 = b * band_h
        r0, r1 = row0, row0 + band_h
        if align:
            r0, r1 = r0 - r0 % 2, r1 + r1 % 2
        out.append((row0, band_h, r0, r1))
    return out


# Per-compile inputs (copied once per device and kept) and per-frame ones
# (moved every frame; a no-op on the device they are on).
_PER_COMPILE = ("skin", "lines", "sprites_static")
_PER_FRAME = ("world_in", "texdev")


def _band_inputs(static, params, dyn_f, dyn_i, device, copies, uploads):
    """(static, params, dyn_f, dyn_i) on ``device``: the compile's tensors
    from ``copies`` (made on first use, kept while the compile's objects
    are the same), this frame's buffers uploaded once per device."""
    keep = (static,) + tuple(params[k] for k in _PER_COMPILE)
    entry = copies.get(device)
    if entry is None or any(a is not b for a, b in zip(entry[0], keep)):
        entry = copies[device] = (keep, to_device(static, device), {
            k: to_device(params[k], device) for k in _PER_COMPILE})
    if device not in uploads:
        uploads[device] = (torch.as_tensor(dyn_f, device=device),
                           torch.as_tensor(dyn_i, device=device))
    p = dict(params, **entry[2],
             **{k: to_device(params[k], device) for k in _PER_FRAME})
    return (entry[1], p) + uploads[device]


def render_frame_packed_banded(static: dict, dyn_f, dyn_i, layout: tuple,
                               levels: tuple, height: int, width: int,
                               mesh, axis: str = "band",
                               skin=None, skin_ranges: tuple = (),
                               anim=None, world_in=None,
                               sprites_static=None, lines=None,
                               ordered_cap: int | None = None,
                               chunk: int = 64,
                               sort_transparent: bool = True,
                               vertex_shader=None,
                               pixel_shader=None,
                               want_bump: bool = False,
                               want_cube: bool = False,
                               texdev=None, texdev_rects: tuple = (),
                               sampler_profile=None,
                               corner: tuple = (0, 0, 0),
                               want_texgen: bool = True,
                               ss: int = 1,
                               solve_caps: tuple | None = None,
                               cull: tuple | None = None,
                               quad_windows: tuple | None = None,
                               out_device=None,
                               copies: dict | None = None):
    """One frame of ``height`` rows rendered as ``mesh.shape[axis]``
    horizontal bands, band b on ``mesh.devices[b]`` (a
    :class:`~.mesh.DeviceMesh`). Returns (fb (4,H,W), zb (H,W)) on
    ``out_device`` (default the first entry's device), equal to the
    unbanded frame bit for bit. ``height`` must divide evenly by the band
    count (``ValueError``). ``copies``: the caller's per-device cache of
    the compile's static tensors and banks (None: fresh copies).
    ``chunk`` is the reference's signature (the port's frame takes no chunk
    size).

    Not banded (the caller renders those unbanded, as the reference does):
    the stencil plane and accumulation over the previous frame."""
    n = mesh.shape[axis]
    if height % n:
        raise ValueError(f"height {height} not divisible by {n} bands")
    sp = sampler_profile
    # A mip frame of even size pairs rows for its quad LOD: bands start and
    # end on even rows then (the Antialias render rows always do).
    align = (ss == 1 and sp is not None and len(sp) > 1 and bool(sp[1])
             and height % 2 == 0 and width % 2 == 0)
    params = dict(layout=layout, levels=levels, width=width, skin=skin,
                  skin_ranges=skin_ranges, anim=anim, world_in=world_in,
                  sprites_static=sprites_static, lines=lines,
                  ordered_cap=ordered_cap,
                  sort_transparent=sort_transparent,
                  vertex_shader=vertex_shader, pixel_shader=pixel_shader,
                  want_bump=want_bump, want_cube=want_cube, texdev=texdev,
                  texdev_rects=texdev_rects, sampler_profile=sp,
                  corner=corner, want_texgen=want_texgen, ss=ss,
                  solve_caps=solve_caps, cull=cull,
                  quad_windows=quad_windows)
    copies = {} if copies is None else copies
    uploads = {}
    bands = []
    for dev, (row0, rows, r0, r1) in zip(mesh.devices,
                                         band_rows(height, n, align)):
        st, p, df, di = _band_inputs(static, params, dyn_f, dyn_i, dev,
                                     copies, uploads)
        with on(dev):
            fb, zb = fr.render_frame_packed_impl(
                st, df, di, **p, height=r1 - r0, y_shift=r0, frame_h=height)
        lo = row0 - r0
        bands.append((fb[:, lo:lo + rows], zb[lo:lo + rows]))
    out_device = mesh.devices[0] if out_device is None else out_device
    return (torch.cat([fb.to(out_device) for fb, _zb in bands], dim=1),
            torch.cat([zb.to(out_device) for _fb, zb in bands], dim=0))
