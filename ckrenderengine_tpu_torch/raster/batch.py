"""Host-side construction of TriangleBatch streams from clip-space geometry.

The counterpart of ``ckrenderengine_tpu.raster.batch``, host numpy as it is:
the seam of the reference engine's DrawPrimitive vertex-buffer loads
(CKRSTLoadVertexBuffer + InternalDrawPrimitiveVB,
CKDX9RasterizerContext.cpp:1555-1786), except that the "draw call" is
data: triangles of many draws concatenate into one padded stream with
per-triangle state indices. ``convert.device_batch_from_host`` uploads a
batch to the card.
"""

from __future__ import annotations

import numpy as np

from .types import TriangleBatch


def clip_to_screen_h(clip: np.ndarray, view_x, view_y, view_w, view_h) -> np.ndarray:
    """(...,4) clip coords -> (...,3) screen-homogeneous (X, Y, W).

    X/W, Y/W land on the reference's viewport mapping
    (CKRasterizerLib/CKRasterizerContext.cpp:366-390): x_s = cx + x/w*W/2,
    y_s = cy - y/w*H/2.
    """
    half_w = view_w * 0.5
    half_h = view_h * 0.5
    cx = view_x + half_w
    cy = view_y + half_h
    x, y, w = clip[..., 0], clip[..., 1], clip[..., 3]
    return np.stack([cx * w + x * half_w, cy * w - y * half_h, w], axis=-1).astype(np.float32)


def make_batch(
    clip: np.ndarray,            # (T,3,4) clip-space triangle vertices
    view=(0, 0, 256, 256),       # viewport (x, y, w, h)
    color: np.ndarray | None = None,     # (T,3,4)
    specular: np.ndarray | None = None,  # (T,3,3)
    uv: np.ndarray | None = None,        # (T,3,2)
    fog: np.ndarray | None = None,       # (T,3)
    state_idx: np.ndarray | None = None, # (T,)
    valid: np.ndarray | None = None,     # (T,)
    pad_to: int | None = None,
) -> TriangleBatch:
    clip = np.asarray(clip, np.float32)
    t = clip.shape[0]
    xyw = clip_to_screen_h(clip, *view)
    z = clip[..., 2]
    if color is None:
        color = np.ones((t, 3, 4), np.float32)
    if specular is None:
        specular = np.zeros((t, 3, 3), np.float32)
    if uv is None:
        uv = np.zeros((t, 3, 2), np.float32)
    if fog is None:
        fog = np.ones((t, 3), np.float32)
    if state_idx is None:
        state_idx = np.zeros(t, np.int32)
    if valid is None:
        valid = np.ones(t, bool)

    arrays = dict(
        xyw=np.asarray(xyw, np.float32),
        z=np.asarray(z, np.float32),
        color=np.asarray(color, np.float32),
        specular=np.asarray(specular, np.float32),
        uv=np.asarray(uv, np.float32),
        fog=np.asarray(fog, np.float32),
        state_idx=np.asarray(state_idx, np.int32),
        valid=np.asarray(valid, bool),
    )
    if pad_to is not None and pad_to > t:
        for k, a in arrays.items():
            pad = np.zeros((pad_to - t,) + a.shape[1:], a.dtype)
            arrays[k] = np.concatenate([a, pad], axis=0)
        arrays["valid"][t:] = False
    return TriangleBatch(**arrays)


def concat_batches(batches: list[TriangleBatch], pad_to: int | None = None) -> TriangleBatch:
    fields = ("xyw", "z", "color", "specular", "uv", "fog", "state_idx", "valid")
    cat = {f: np.concatenate([getattr(b, f) for b in batches], axis=0) for f in fields}
    t = cat["valid"].shape[0]
    if pad_to is not None and pad_to > t:
        for k, a in cat.items():
            pad = np.zeros((pad_to - t,) + a.shape[1:], a.dtype)
            cat[k] = np.concatenate([a, pad], axis=0)
        cat["valid"][t:] = False
    return TriangleBatch(**cat)
