"""BASELINE config 3 whole through ``Render()`` of both packages on the
CPU: ``scenes.build_config3`` with all 1,000 entities (12,000 triangles; a
cut hierarchy keeps only the first trees, which lie outside the view), its
sun, point light, HUD sprite and text label, at 256x193. A tiled frame
(t*H*W > 2^26), so the solve and the quantized rows of the full-size
frame; the reference renders through its accelerator branch
(``tests/_torch_common.render_reference``).

The frame is held to ``check_render`` (winners equal on >= 99.9% of the
pixels, depths within f32 rounding, colours within 1/255;
tests/_torch_common.check_frame_against_reference) with ``own_setup``: at
256x193 the cubes are a few pixels wide and interpenetrate, so on a few
pixels the rounding of the vertex stage and setup, not of the depth
formula, decides which face is nearer. There each package's answer is
held to its own triangle setup, and where the reference's frame
disagrees with the reference's own exact solve (one pixel) that frame is
not the yardstick. The HUD pixels that no triangle reaches equal the
reference's within 1e-6.
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from tests._torch_common import (
    check_render, port_frame_ids, render_both, to_np,
)

C3 = dict(width=256, height=193)


@pytest.fixture(scope="module")
def config3():
    return render_both(scenes.build_config3, frame_ids=True, **C3)


def _tiled(rc):
    return rc._compiled.tri_idx.shape[0] * rc.height * rc.width > (1 << 26)


def test_config3_scene(config3):
    rj, rt, _packed, _ref = config3
    assert rt._compiled.n_valid_tris == 12000 and _tiled(rt)
    qb, qf = rt._quad_lists()
    assert qb == [] and len(qf) == 2 and qf == rj._quad_lists()[1]
    assert [q["rect"] for q in qf] == [(8, 8, 32, 32), (40, 8, 168, 28)]


def test_config3_matches_reference(config3):
    check_render(config3, own_setup=True)


def test_config3_hud_matches_reference(config3):
    rj, rt, _packed, ref = config3
    st, tf, ti, tp = rt._fill_packed([], [])
    ids = to_np(port_frame_ids(rt, st, torch.as_tensor(tf),
                               torch.as_tensor(ti), tp))
    fb, fb_ref = to_np(rt.fb), np.asarray(rj.fb)
    for x0, y0, x1, y1 in ((8, 8, 32, 32), (40, 8, 168, 28)):
        win = (slice(y0, y1), slice(x0, x1))
        empty = (ids[win] < 0) & (ref[0][win] < 0)
        assert empty.mean() > 0.25
        diff = np.abs(fb[:, y0:y1, x0:x1] - fb_ref[:, y0:y1, x0:x1]).max(0)
        assert diff[empty].max() <= 1e-6
    # The HUD square (screen pixels 12..27) carries the sprite's colour
    # over the clear colour where no cube lies behind it, the label the
    # text's coverage.
    clear = (ids[12:28, 12:28] < 0) & (ref[0][12:28, 12:28] < 0)
    assert clear.sum() > 20
    np.testing.assert_allclose(
        fb[:, 12:28, 12:28][:, clear].T,
        np.broadcast_to((0.9 * 0.85, 0.2 * 0.85, 0.1 * 0.85, 0.85),
                        (int(clear.sum()), 4)), atol=1e-6)
    label = fb[3, 8:28, 40:168]
    assert (label > 0.5).sum() > 50 and (label == 0).mean() > 0.5


def test_config3_tick_moves_the_frame():
    _c, rc, tick = scenes.build_config3(O, device="cpu", **C3)
    rc.Render()
    fb0 = to_np(rc.fb)
    for _ in range(10):
        tick()
    rc.Render()
    quads = rc._quad_lists()
    moved = np.abs(to_np(rc.fb) - fb0).max(0) > 1e-3
    assert moved.mean() > 0.01, moved.mean()
    # The HUD stays where it is.
    assert rc._quad_lists() == quads
