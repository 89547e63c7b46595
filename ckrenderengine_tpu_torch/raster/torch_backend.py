"""Device containers and branchless state ops of the torch rasterizer.

The counterpart of ``ckrenderengine_tpu.raster.jax_backend``'s containers.
The sequential ordered pass (``render_pass*``) is not carried yet: frames
that need it raise (see pipeline/frame.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .types import VXCMP


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
