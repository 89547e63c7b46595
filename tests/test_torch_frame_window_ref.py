"""The port's windowed frames (``SetFramePipelining``) against the
reference's eager frames, on the CPU: one small tiled frame (config 2 at
256x192, B1's route) and one ordered frame (``alpha50k`` cut to 256x192,
B3's route). The reference renders through its accelerator branch
(tests/_torch_common.render_reference); its own windowed path is held bit
for bit to its eager one by its tests (tests/test_frame_window.py) and is
slow on the CPU, so it is not run here.

The bounds are the eager port frame's: tests/_torch_common.check_render for
the tiled frame, and tests/test_torch_ordered_frame.py's for the ordered
one. The windowed frames also equal the port's eager frames bit for bit.
"""

import numpy as np
import torch

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import (
    check_frame_against_reference, check_render, port_winners,
    reference_winners, render_both, render_reference, to_np,
)


def _windowed(build, kw, window, frames):
    """The scene through the port at W = ``window``: ``frames`` (fewer)
    Render() calls of one state, then one read, which runs them."""
    import ckrenderengine_tpu_torch.objects as O

    _c, rc, _m = build(O, device="cpu", **kw)
    rc.SetFramePipelining(window)
    for _ in range(frames):
        rc.Render()
    assert rc._win_slots                        # staged, not yet run
    fb = rc.fb
    assert rc._window is not None and not rc._win_slots
    return rc, fb


def test_tiled_window_matches_reference():
    kw = dict(width=256, height=192)
    rj, rt, packed, ref = render_both(scenes.build_config2, **kw)
    rw, fb = _windowed(scenes.build_config2, kw, window=4, frames=3)
    assert rw._window.tiled
    assert torch.equal(fb, rt.fb) and torch.equal(rw.zb, rt.zb)
    assert torch.equal(rw.GetFrameFence(), torch.full((4,), float(
        rt.fb.sum(dtype=torch.float32))))
    check_render((rj, rw, packed, ref))


def test_ordered_window_matches_reference():
    kw = dict(width=256, height=192, n_sheets=6, sheet_n=15)
    rj = render_reference(scenes.build_alpha50k, **kw)
    rw, fb = _windowed(scenes.build_alpha50k, kw, window=3, frames=2)
    tp = rw._fill_packed([], [])[3]
    assert tp["ordered_cap"] * rw.height * rw.width > 1 << 26   # B3's route
    assert rw.GetStats().OrderedReplays == 0
    # Opaque winners and the frame within the slice's bounds.
    ref = reference_winners(*rj._fill_packed([], []))
    st, tf, ti, tp = rw._fill_packed([], [])
    _fb, _zb, ids = port_winners(st, torch.as_tensor(np.array(tf)),
                                 torch.as_tensor(np.array(ti)), tp)
    check_frame_against_reference(to_np(ids), to_np(fb), to_np(rw.zb), ref,
                                  rj)
    # The transparent sheets: within 1e-4 on all but 0.1% of the pixels,
    # where opaque depths tie (tests/test_torch_ordered_frame.py).
    fb, zb = to_np(fb), to_np(rw.zb)
    fb_r, zb_r = np.asarray(rj.fb), np.asarray(rj.zb)
    diff = np.abs(fb - fb_r).max(0)
    off = diff > 1e-4
    assert off.mean() <= 1e-3, (int(off.sum()), float(diff.max()))
    dz = np.abs(zb.astype(np.float64) - zb_r)[off]
    assert np.all((dz > 0) & (dz <= 1e-4)), dz
    assert (fb != fb_r[:, :1, :1]).any(0).mean() > 0.5
