"""User pipeline stages: the vertex and pixel shaders of a render context.

A stage is a torch callable with the reference's signature
(``CKRenderContext.SetVertexShader`` / ``SetPixelShader``): the vertex
shader ``fn(posw, nrmw, scene) -> (posw', nrmw')`` over world-space vertex
rows, the pixel shader ``fn(inputs) -> (..., 4)`` over a dict of per-pixel
tensors. The frame calls it where the reference calls it, through
:func:`call_stage` (or :func:`call_pixel_stage` where the frame's tensors
carry a leading per-tile axis the reference's stage never sees).

A frame window or a context batch captures one frame into a CUDA graph: the
stage runs once, at capture, and every replay re-runs the kernels it
launched. A stage that reads the device from the host (``.item()``,
``.cpu()``, ``nonzero``, a Python ``if`` on a tensor) or copies from
pageable host memory cannot be captured: inside :func:`capturing` the stage
runs under ``torch.cuda.set_sync_debug_mode("error")`` and such a call
raises :class:`StageCaptureError`, which names the stage.
"""

from __future__ import annotations

import contextlib

import torch

_capture_depth = 0


class StageCaptureError(RuntimeError):
    """A user stage did something a captured frame cannot hold."""


@contextlib.contextmanager
def capturing():
    """The block warms up and captures a frame (``pipeline/window.py``):
    user stages called inside it must not synchronise with the host."""
    global _capture_depth
    _capture_depth += 1
    try:
        yield
    finally:
        _capture_depth -= 1


def call_stage(fn, *args, device=None, vmapped: bool = False):
    """``fn(*args)`` (``torch.func.vmap(fn)(*args)`` when ``vmapped``).
    Inside :func:`capturing` on a CUDA ``device`` the call runs with host
    synchronisation turned into an error, and any error it raises becomes
    a :class:`StageCaptureError` naming ``fn``."""
    run = torch.func.vmap(fn) if vmapped else fn
    if not _capture_depth or device is None or \
            torch.device(device).type != "cuda":
        return run(*args)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run(*args)
    except RuntimeError as e:
        raise StageCaptureError(
            f"user stage {getattr(fn, '__qualname__', repr(fn))} cannot run "
            f"in a captured frame (a frame window or a context batch): "
            f"{e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def call_pixel_stage(fn, inputs: dict, device=None) -> torch.Tensor:
    """The pixel shader on ``inputs`` whose every tensor has a leading
    per-tile axis N (the ordered pass's batched triangle step): one call
    per tile with the reference's shapes, ``color`` (h, w, 4) and the
    triangle's ``si`` (NUM_SI,) / ``sf`` (NUM_SF,) rows, through
    ``torch.func.vmap`` (the reference's ``jax.vmap`` over tiles). With N
    = 1 (the flat pass, where the reference calls the stage unbatched) it
    is called once on the squeezed inputs. Returns (N, h, w, 4)."""
    n = inputs["color"].shape[0]
    if n == 1:
        out = call_stage(fn, {k: v[0] for k, v in inputs.items()},
                         device=device)
        return out[None]
    return call_stage(fn, inputs, device=device, vmapped=True)
