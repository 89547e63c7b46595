"""Carry the reference package's compiled state into this package's tensors.

The reference (``ckrenderengine_tpu``) compiles a scene on the host into a
``static`` dict of arrays, two packed per-frame buffers and a dict of static
frame parameters (``CKRenderContext._fill_packed``). These helpers take those
as numpy arrays — never as JAX objects, so this module imports neither JAX
nor the reference package — and return the same inputs as torch tensors on
a chosen device. The tests use them to feed both device programs identical
inputs, independent of either package's host compile.
"""

from __future__ import annotations

import numpy as np
import torch

# Params of the reference frame that name reference-only objects; the
# opaque slice takes them only when they are empty.
_EMPTY_PARAMS = ("skin", "anim", "world_in", "sprites_static", "lines",
                 "texdev", "vertex_shader", "pixel_shader")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def from_reference(static: dict, dyn_f, dyn_i, params: dict, device):
    """(static, dyn_f, dyn_i, params) of a reference frame -> the same for
    ``pipeline.frame.render_frame_packed`` of this package on ``device``.

    Every array converts bit for bit (``np.asarray`` of each value first);
    hashable params (layout, levels, corner, caps, sampler profile) carry
    over unchanged. Raises when a param names a feature outside the slice."""
    for k in _EMPTY_PARAMS:
        v = params.get(k)
        if v is not None and not (isinstance(v, tuple) and not v):
            raise ValueError(f"reference param {k!r} is set; the opaque "
                             f"slice takes frames without it")
    static_t = {k: _tensor(v, device) for k, v in static.items()}
    out = dict(params)
    for k in _EMPTY_PARAMS:
        out[k] = None
    out["texdev_rects"] = ()
    return (static_t, _tensor(dyn_f, device), _tensor(dyn_i, device), out)


def setup_from_reference(setup_np: dict, device=None) -> dict:
    """A reference ``triangle_setup`` dict (numpy arrays) -> torch tensors
    with the dtypes this package's setup uses (bool masks stay bool)."""
    return {k: _tensor(v, device) for k, v in setup_np.items()}


def batch_from_reference(obatch_np, device=None):
    """A reference ``DeviceBatch`` (its 11 per-triangle fields as numpy
    arrays; an ``ordered_subset`` output included) -> this package's
    ``raster.torch_backend.DeviceBatch`` on ``device``, bit for bit. The
    reference's optional ``planar`` payload is not carried: it holds the
    same values as the fields."""
    from .raster.torch_backend import DeviceBatch

    return DeviceBatch(*(_tensor(getattr(obatch_np, f), device)
                         for f in DeviceBatch._fields))
