"""The shaded level (``scenes.build_config5_shaded``: config 5 with a
travelling-wave vertex shader and a pixel shader that reads all six of its
inputs) cut down, through both packages' ``Render()`` on the CPU.

- At 128x96 (a 40x40 terrain and 8 spheres, 6,656 triangles: the tiled
  solve without e-planes and the per-pixel-gather shade, never the
  quantized rows) against the reference on its accelerator branch,
  ``check_render``: winners equal on >= 99.9% of the pixels and ties
  elsewhere, depths within the f32 forward-error bounds, fb within 1/255 on
  all but 0.1% of the matching pixels (those on ill-conditioned edges).
- Frame windows at 96x72 (4,928 triangles, tiled): W = 4 frames
  bit-equal to eager ones, fences included; a shader swapped mid-window
  flushes the staged frames and keys a new window.
- ``SetPixelShader(None)`` / ``SetVertexShader(None)`` give back the
  unshaded frame bit for bit.
- Antialias at 48x36 (rendered at 96x72, 2,240 triangles: the flat solve,
  ``xy`` at the render size) against the reference, ``check_render``'s AA
  bounds. The flat ordered pass under the stage is held by
  tests/test_torch_shaders.py's ordered-pass cases and the golden
  ``shader_320x240``.
"""

import jax.numpy as jnp
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.pipeline import window as tw
from ckrenderengine_tpu_torch.raster import deferred as tdf
from tests._torch_common import check_render, render_both

LEVEL = dict(width=128, height=96, terrain_n=40, n_balls=8)
WINDOW = dict(width=96, height=72, terrain_n=40, n_balls=4)


def _build(P, **kw):
    return scenes.build_config5_shaded(P, xp=jnp if P is J else torch, **kw)


@pytest.fixture(scope="module")
def level():
    return render_both(_build, frame_ids=True, **LEVEL)


def test_level_matches_reference(level, monkeypatch):
    check_render(level)
    # The port's frame took the tiled solve without e-planes and the
    # per-pixel-gather shade, never the quantized rows.
    seen = []
    solve, quant = tfr.depth_reduce_tiled_cuda, tdf.shade_row_table_quant
    monkeypatch.setattr(tfr, "depth_reduce_tiled_cuda",
                        lambda *a, **k: seen.append(sorted(k)) or
                        solve(*a, **k))
    monkeypatch.setattr(tdf, "shade_row_table_quant",
                        lambda *a, **k: seen.append("quant") or
                        quant(*a, **k))
    rt = level[1]
    rt.Render()
    assert len(seen) == 1 and "want_eplanes" not in seen[0] \
        and "shade_tbl" not in seen[0], seen


def _ticks(rc, spinner, n, window, swap_at=None, stage=None):
    """``n`` frames of a 0.05 rad spinner tick each; the fences of W > 1
    and the fb after every frame of W = 1. ``swap_at``: before that frame
    the pixel shader becomes ``stage``."""
    rc.SetFramePipelining(window)
    fbs, fences = [], []
    for f in range(n):
        if f == swap_at:
            rc.SetPixelShader(stage)
        spinner.Rotate((0, 1, 0), 0.05)
        rc.Render()
        if window == 1:
            fbs.append(rc.fb.clone())
            fences.append(tw.checksum(rc.fb))
    return fbs, fences


def _gray(xp):
    def gray(inp):
        c = inp["color"] * inp["texel"]
        g = (c[..., 0] + c[..., 1] + c[..., 2]) / 3.0
        return xp.stack([g, g, g, c[..., 3]], -1)
    return gray


@pytest.mark.parametrize("swap", [False, True], ids=["same", "swapped"])
def test_window_equals_eager(swap):
    runs = []
    run = tw.FrameWindow.run

    def counted(self, slots):
        runs.append(len(slots))
        return run(self, slots)

    gray = _gray(torch)
    swap_at = 2 if swap else None
    _c, r1, s1 = _build(O, device="cpu", **WINDOW)
    fbs, sums = _ticks(r1, s1, 4, 1, swap_at, gray)
    _c, r4, s4 = _build(O, device="cpu", **WINDOW)
    tw.FrameWindow.run = counted
    try:
        _ticks(r4, s4, 4, 4, swap_at, gray)
        # A full window runs; a swap runs the two frames staged before it.
        assert runs == ([2] if swap else [4])
        assert torch.equal(r4.fb, fbs[-1]) and torch.equal(r4.zb, r1.zb)
        assert runs == ([2, 2] if swap else [4])
    finally:
        tw.FrameWindow.run = run
    fence = r4.GetFrameFence()
    want = torch.stack(sums[2:] if swap else sums)
    assert torch.equal(fence[:want.shape[0]], want)
    assert len(set(torch.stack(sums).tolist())) == 4   # the wave moves


def test_clearing_the_shaders_gives_back_the_unshaded_frame():
    _c, rc, _s = _build(O, device="cpu", **WINDOW)
    vs, ps = rc.GetVertexShader(), rc.GetPixelShader()
    rc.SetVertexShader(None)
    rc.SetPixelShader(None)
    rc.Render()
    plain = rc.fb.clone()
    rc.SetVertexShader(vs)
    rc.SetPixelShader(ps)
    rc.Render()
    shaded = rc.fb.clone()
    assert (shaded - plain).abs().max() > 0.05
    rc.SetPixelShader(None)
    rc.Render()
    assert not torch.equal(rc.fb, plain)           # the wave still moves
    rc.SetVertexShader(None)
    rc.Render()
    assert torch.equal(rc.fb, plain)


def test_antialias_matches_reference():
    pair = render_both(_build, accelerator=False, antialias=True, width=48,
                       height=36, terrain_n=16, n_balls=4)
    tp = check_render(pair)
    assert tp["ss"] == 2
