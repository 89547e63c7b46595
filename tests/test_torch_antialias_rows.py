"""Antialias through ``Render()`` of both packages on the CPU: the row
paths that change with the render size, an accumulate-mode frame and the
HUD overlay. The reference renders on its accelerator branch
(``tests/_torch_common.render_reference``).

- ``config2_mips``: config 2 with a mip chain at 176x125, a tiled frame at
  both sizes: compact rows with the analytic LOD at 1x (odd height), the
  quantized rows with the 2x2-quad LOD at 2x (352x250, even). Held to
  ``check_aa_frame_against_reference`` (tests/test_torch_antialias.py says
  which bounds).
- Config 3 whole (1,000 entities, its HUD sprite and text label) at
  128x97: ``check_aa_frame_against_reference`` with ``own_setup``
  (tests/test_torch_config3_frame.py says why), and the HUD pixels whose
  samples no triangle reaches equal to the reference's within 1e-6: the
  quad rects scale by 2 with the frame, and their host windows are taken
  from the scaled rects at the render size.
- Accumulate mode: config 2 at 128x95 with AA, then the clear flags off,
  the floor hidden and the ball moved nearer, and a second frame over the
  first (the display-size buffers repeat-upsampled under it). Against the
  reference: fb within 1/255 on all but 0.1% of the pixels, zb within
  1e-4 on all but 0.1% of those where the new ball lies (its depths round
  apart by up to 3e-5; a display pixel on its silhouette whose samples the
  two packages cover differently takes another window minimum); on the
  port, zb keeps the first frame's
  values bit for bit where nothing was drawn. (Redrawing the same floor
  over its own kept depth would make every floor sample an exact depth
  tie, which the reference's separately fused programs round apart.)
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.raster import deferred as tdf
from tests._torch_common import (
    accelerator_branch, check_render, port_frame_ids, render_both, to_np,
    win_all,
)

MIPS = dict(width=176, height=125, mips=True)
C3 = dict(width=128, height=97)


def _table(monkeypatch, antialias):
    """The row table the port's mip frame builds."""
    calls = []
    for name in ("shade_row_table_quant", "shade_row_table_compact"):
        fn = getattr(tdf, name)
        monkeypatch.setattr(tdf, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    scenes.build_config2(O, device="cpu", antialias=antialias,
                         **MIPS)[1].Render()
    monkeypatch.undo()
    return calls


def test_mip_frame_takes_quad_lod_at_twice_the_size(monkeypatch):
    assert _table(monkeypatch, False) == ["shade_row_table_compact"]
    assert _table(monkeypatch, True) == ["shade_row_table_quant"]


def test_mip_antialias_matches_accelerator_reference():
    check_render(render_both(scenes.build_config2, antialias=True, **MIPS))


@pytest.fixture(scope="module")
def config3():
    return render_both(scenes.build_config3, frame_ids=True, antialias=True,
                       **C3)


def test_config3_antialias_matches_reference(config3):
    assert check_render(config3, own_setup=True)["ss"] == 2


def test_config3_hud_matches_reference(config3):
    rj, rt, _packed, ref = config3
    st, tf, ti, tp = rt._fill_packed(*rt._quad_lists())
    # The host windows of the two foreground quads cover their scaled rects
    # at the render size, 256x194: (16, 16, 64, 64), and (80, 16, 336, 56)
    # cut at the frame's right edge.
    assert tp["quad_windows"][1] == ((15, 15, 50, 50), (15, 79, 42, 177))
    ids = to_np(port_frame_ids(rt, st, torch.as_tensor(tf),
                               torch.as_tensor(ti), tp))
    empty = win_all((ids < 0) & (ref[0] < 0))
    fb, fb_ref = to_np(rt.fb), np.asarray(rj.fb)
    for x0, y0, x1, y1 in ((8, 8, 32, 32), (40, 8, 168, 28)):
        win = (slice(y0, y1), slice(x0, x1))
        e = empty[win]
        assert e.mean() > 0.25
        diff = np.abs(fb[:, y0:y1, x0:x1] - fb_ref[:, y0:y1, x0:x1]).max(0)
        assert diff[e].max() <= 1e-6
    # The HUD square's four samples of each pixel read one texel: where no
    # cube lies behind it, the sprite's colour over the clear colour.
    clear = empty[12:28, 12:28]
    assert clear.sum() > 20
    np.testing.assert_allclose(
        fb[:, 12:28, 12:28][:, clear].T,
        np.broadcast_to((0.9 * 0.85, 0.2 * 0.85, 0.1 * 0.85, 0.85),
                        (int(clear.sum()), 4)), atol=1e-6)


def _accumulate(M, device=None):
    kw = dict(width=128, height=95, antialias=True)
    if device is not None:
        kw["device"] = device
    ctx, rc, ball = scenes.build_config2(M, **kw)
    rc.Render()
    first = (np.array(to_np(rc.fb)), np.array(to_np(rc.zb)))
    rc.SetClearBackground(False)
    rc.SetClearZBuffer(False)
    ctx.GetObjectByName("floor").Show(False)
    ball.SetPosition((0.8, 0.8, -3.0))
    rc.Render()
    return rc, first


def test_accumulate_second_frame_matches_reference():
    import ckrenderengine_tpu.objects as J

    with accelerator_branch():
        rj, _first_r = _accumulate(J)
        fb_r, zb_r = np.asarray(rj.fb), np.asarray(rj.zb)
    rt, (fb1, zb1) = _accumulate(O, device="cpu")
    fb, zb = to_np(rt.fb), to_np(rt.zb)
    diff = np.abs(fb - fb_r).max(0)
    off = diff > 1.0 / 255.0
    assert off.mean() <= 1e-3, (int(off.sum()), float(diff.max()))
    drawn = zb != zb1
    assert 0.1 < drawn.mean() < 0.9
    dz = np.abs(zb.astype(np.float64) - zb_r)[drawn]
    assert (dz > 1e-4).mean() <= 1e-3, float(dz.max())
    # Where the second frame drew nothing, the first frame's zb stays bit
    # for bit (the window minimum of four equal samples) and its colour
    # within f32 rounding of the four-sample mean.
    assert np.all(zb[~drawn] == zb1[~drawn])
    assert np.abs(fb - fb1).max(0)[~drawn].max() <= 1e-6
    assert (np.abs(fb - fb1).max(0)[drawn] > 0.05).mean() > 0.5
