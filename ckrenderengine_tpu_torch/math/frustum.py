"""Box visibility for host object queries (numpy).

The counterpart of ``ckrenderengine_tpu.math.frustum.box_visibility``: the
8 box corners go to clip space, their VXCLIP flags are OR/AND-reduced, and
the CBV_* class follows the reference rule (AND != 0 -> offscreen; OR != 0
-> partially visible; else all inside), as in
CKRasterizerContext::ComputeBoxVisibility
(src/CKRasterizer/CKRasterizerLib/CKRasterizerContext.cpp:394-421).
It runs on the host (``CK3dEntity.IsInViewFrustrum``), so it is numpy.
"""

from __future__ import annotations

import numpy as np

from . import vxmath as vx

_CORNER_SEL = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.float32)


def box_corners(bmin, bmax) -> np.ndarray:
    """(3,),(3,) -> (8,3) corners."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    return bmin[None] + (bmax - bmin)[None] * _CORNER_SEL


def box_visibility(mat, bmin, bmax) -> int:
    """CBV_* classification of one box under a clip-space matrix."""
    corners = box_corners(bmin, bmax)
    h4 = np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1)
    clip = h4 @ np.asarray(mat, np.float32)
    flags = vx.np_clip_flags(clip)
    or_flags = np.bitwise_or.reduce(flags)
    and_flags = np.bitwise_and.reduce(flags)
    if and_flags != 0:
        return vx.CBV_OFFSCREEN
    return vx.CBV_VISIBLE if or_flags != 0 else vx.CBV_ALLINSIDE
