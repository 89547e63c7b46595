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

# Params of the reference frame that name features this package does not
# carry yet; it takes a frame only when they are empty.
_EMPTY_PARAMS = ("anim",)
# User stages: a JAX function does not convert, so the caller passes the
# port's counterpart of each one the reference frame sets.
_STAGE_PARAMS = ("vertex_shader", "pixel_shader")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def from_reference(static: dict, dyn_f, dyn_i, params: dict, device,
                   vertex_shader=None, pixel_shader=None):
    """(static, dyn_f, dyn_i, params) of a reference frame -> the same for
    ``pipeline.frame.render_frame_packed`` of this package on ``device``.

    Every array converts bit for bit (``np.asarray`` of each value first);
    hashable params (layout, levels, corner, caps, sampler profile,
    ``skin_ranges``, ``texdev_rects``) carry over unchanged; the skin bank
    and the bound clip's ``world_in`` matrices, the sprites' per-compile
    rows, the line bank and the render-to-texture feeds (``texdev``)
    convert field by field. ``vertex_shader`` / ``pixel_shader``:
    the torch counterparts of the reference frame's user stages, required
    exactly where the frame sets one. Raises when a param names a feature
    this package does not carry, or when a stage and its counterpart do not
    pair up."""
    for k in _EMPTY_PARAMS:
        v = params.get(k)
        if v is not None and not (isinstance(v, tuple) and not v):
            raise ValueError(f"reference param {k!r} is set; this package "
                             f"takes frames without it")
    stages = dict(vertex_shader=vertex_shader, pixel_shader=pixel_shader)
    for k, fn in stages.items():
        if (params.get(k) is None) != (fn is None):
            raise ValueError(f"reference param {k!r} is "
                             f"{'un' if params.get(k) is None else ''}set: "
                             f"pass {k}= exactly when it is set")
    static_t = {k: _tensor(v, device) for k, v in static.items()}
    out = dict(params, **stages)
    for k in _EMPTY_PARAMS:
        out[k] = None
    out["texdev"] = None
    out["texdev_rects"] = tuple(params.get("texdev_rects") or ())
    if params.get("texdev"):
        out["texdev"] = tuple(_tensor(a, device) for a in params["texdev"])
    if params.get("skin") is not None:
        out["skin"] = skin_bank_from_reference(params["skin"], device)
    if params.get("world_in") is not None:
        out["world_in"] = _tensor(params["world_in"], device)
    if params.get("sprites_static") is not None:
        out["sprites_static"] = sprite_bank_from_reference(
            params["sprites_static"], device)
    if params.get("lines") is not None:
        out["lines"] = line_bank_from_reference(params["lines"], device)
    return (static_t, _tensor(dyn_f, device), _tensor(dyn_i, device), out)


def sprite_bank_from_reference(sprites: dict, device=None) -> dict:
    """The reference's frame parameter ``sprites_static`` (a dict of the 3D
    sprites' entity rows, pool bases and valid flags, as arrays) -> the
    same dict of this package's tensors on ``device``, bit for bit."""
    return {k: _tensor(v, device) for k, v in sprites.items()}


def line_bank_from_reference(bank, device=None):
    """A reference ``LineBank`` (its fields as arrays) -> this package's
    ``pipeline.lines.LineBank`` on ``device``, bit for bit."""
    from .pipeline.lines import LineBank

    return LineBank(*(_tensor(getattr(bank, f), device)
                      for f in LineBank._fields))


def skin_bank_from_reference(bank, device=None):
    """A reference ``SkinBank`` (any object with its fields as arrays) ->
    this package's ``pipeline.skinning.SkinBank`` on ``device``, bit for
    bit."""
    from .pipeline.skinning import SkinBank

    return SkinBank(*(_tensor(getattr(bank, f), device)
                      for f in SkinBank._fields))


def anim_bank_from_reference(bank, device=None):
    """A reference ``AnimBank`` (its fields as arrays; ``inv_row`` and
    ``has_anim`` may be None) -> this package's ``anim.bank.AnimBank`` on
    ``device``, bit for bit."""
    from .anim.bank import AnimBank

    return AnimBank(**{f: None if getattr(bank, f) is None
                       else _tensor(getattr(bank, f), device)
                       for f in AnimBank._fields})


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


def device_batch_from_host(tb, device=None):
    """A host ``raster.types.TriangleBatch`` (numpy, already padded) -> this
    package's ``raster.torch_backend.DeviceBatch`` on ``device``, as the
    reference's ``DeviceBatch.from_host`` builds its own: the batch's
    fields bit for bit, an unbounded per-triangle scissor, no clip planes
    unless the batch has ``clipd``, no reflection vectors."""
    from .raster.torch_backend import DeviceBatch

    t = tb.xyw.shape[0]
    big = 1.0e9
    rect = np.tile(np.array([-big, -big, big, big], np.float32), (t, 1))
    clipd = (np.zeros((t, 3, 0), np.float32) if tb.clipd is None
             else np.asarray(tb.clipd, np.float32))
    refl = np.zeros((t, 3, 0), np.float32)
    host = dict(vars(tb), valid=tb.valid.astype(np.bool_), clip_rect=rect,
                clipd=clipd, refl=refl)
    return DeviceBatch(*(_tensor(host[f], device)
                         for f in DeviceBatch._fields))
