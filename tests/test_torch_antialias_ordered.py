"""Antialias through ``Render()`` of both packages on the CPU: the ordered
pass at twice the size. The reference renders on its accelerator branch
(``tests/_torch_common.render_reference``: its blend kernel and iterated
peel in interpret mode). Both scenes share the stress scenes' camera and
3,200-triangle opaque floor (a tiled frame at 2x), at 128x96:

- ``alpha``: 6 sheets x 450 untextured alpha-over triangles. At 1x the
  ordered pass is under the 2^26 gate (``render_pass``); at 2x
  ``ordered_cap*H*W`` passes it and both packages take the blend branch:
  the port B3's plain version, the reference its Pallas kernel.
- ``alpha_tex``: 4 sheets x 392 textured alpha-over triangles with
  TexturedPeel: ``render_pass`` at 1x, at 2x the peel branch — B4's plain
  version and the peel composite of quantized layer rows in the port, the
  reference's iterated Pallas peel.

Framebuffers within 1e-4 (the bound of tests/test_torch_ordered_frame.py
for B3 and the sequential pass) on all but 0.1% of the display pixels;
zb within f32 rounding of the opaque floor (the ordered draws write no z)
on the same share. Neither frame replays its exact pass.
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from ckrenderengine_tpu_torch.raster import torch_backend as rb
from tests._torch_common import render_reference, to_np

# name: (build, keywords, the ordered branch at 2x)
CASES = {
    "alpha": (scenes.build_alpha50k,
              dict(width=128, height=96, n_sheets=6, sheet_n=15),
              "ordered_blend_tiled_cuda"),
    "alpha_tex": (scenes.build_alpha_tex50k,
                  dict(width=128, height=96, sheet_n=14),
                  "ordered_peel_iterate"),
}


def _branch(monkeypatch, rc):
    """The ordered branches one Render() of ``rc`` takes."""
    calls = []
    for mod, name in ((co, "ordered_blend_tiled_cuda"),
                      (co, "ordered_peel_iterate"), (rb, "render_pass"),
                      (rb, "render_pass_tiled")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rc.Render()
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_ordered_antialias_matches_accelerator_reference(name, monkeypatch):
    build, kw, branch = CASES[name]
    rj = render_reference(build, antialias=True, **kw)
    rt = build(O, device="cpu", antialias=True, **kw)[1]
    assert _branch(monkeypatch, rt) == [branch]
    # Without AA the same stream stays under the gate of the exact flat
    # pass (render_pass).
    cap = rt._compiled.ordered_cap
    assert cap * rt.height * rt.width <= 1 << 26 < cap * rt.height \
        * rt.width * 4
    assert rt.GetStats().OrderedReplays == 0
    fb, zb = to_np(rt.fb), to_np(rt.zb)
    fb_r, zb_r = np.asarray(rj.fb), np.asarray(rj.zb)
    assert fb.shape == fb_r.shape == (4, kw["height"], kw["width"])
    diff = np.abs(fb - fb_r).max(0)
    assert (diff > 1e-4).mean() <= 1e-3, (int((diff > 1e-4).sum()),
                                          float(diff.max()))
    dz = np.abs(zb.astype(np.float64) - zb_r)
    assert (dz > 1e-4).mean() <= 1e-3, float(dz.max())
    # The sheets cover most of the frame, and the ordered draws wrote no z:
    # zb is the opaque frame's.
    assert (fb != fb[:, :1, :1]).any(0).mean() > 0.5
    st, tf, ti, tp = rt._fill_packed([], [])
    _fb0, zb0 = tfr.render_frame_packed(st, torch.as_tensor(tf),
                                        torch.as_tensor(ti),
                                        **dict(tp, ordered_cap=0))
    assert np.array_equal(zb, to_np(zb0))


def test_frame_caps_keep_the_reference_up_to_1024x768():
    """Phase A's capacities are the reference's (pallas_ordered's defaults)
    up to 1024x768 pixels and grow with the pixels beyond: x4 at an
    Antialias frame of 1024x768, the stress scenes' render size."""
    import inspect

    from ckrenderengine_tpu.raster import pallas_ordered as jpo

    ref = inspect.signature(jpo.ordered_blend_tiled_pallas).parameters
    for h, w in ((192, 256), (768, 1024)):
        assert co.frame_caps(h, w) == dict(windows=ref["windows"].default,
                                           pair_cap=ref["pair_cap"].default)
    big = co.frame_caps(1536, 2048)
    assert big["pair_cap"] == 4 * co.PAIR_CAP
    assert big["windows"] == tuple((4 * c, s) for c, s in co.WINDOWS)
    assert co.frame_caps(769, 1024)["pair_cap"] == 2 * co.PAIR_CAP
