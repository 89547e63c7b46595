"""The golden frames (tests/torch_golden/, made by
tests/torch_golden/make_golden.py with the reference package on its
accelerator branch, so they carry the quantized rows of a tiled frame):
config 2, the untextured transparency scene whose ordered pass both
packages run through kernel B3, the effects level whose 3D sprites
take the textured peel B4 and whose curves, wireframe grid and line list
take the line pass, the shaded level, whose user stages run in the
per-pixel-gather shade and in the flat ordered pass, and the monitor
level in stereo, whose screen samples a live render-to-texture feed. The reference still reproduces the first two, and the
port on the CPU matches all three. The bounds are the slice's
(tests/test_torch_slice.py): opaque winner ids equal on >= 99.9% of the
pixels, and the 8-bit image within one step wherever the winners agree;
at the effects level on all but 0.1% of those pixels, where a transparent
sprite's ill-conditioned edge or the line pass's rounding band goes the
other way (tests/test_torch_fx_frame.py). ``chip_smoke.py`` holds the
port on the GPU to the same files and bounds."""

import os

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import port_winners, render_ids, to_np
from tests.torch_golden import make_golden

GOLDEN = np.load(make_golden.OUT)
ALPHA = np.load(make_golden.ALPHA_OUT)
FX = np.load(make_golden.FX_OUT)
SHADER = np.load(make_golden.SHADER_OUT)
MONITOR = np.load(make_golden.MONITOR_OUT)


def _check(rgba, ids, golden=GOLDEN, max_off=0.0):
    assert rgba.shape == golden["rgba"].shape and rgba.dtype == np.uint8
    match = ids == golden["ids"]
    assert match.mean() >= 0.999, match.mean()
    diff = np.abs(rgba.astype(np.int32)
                  - golden["rgba"].astype(np.int32)).max(-1)
    off = diff[match] > 1
    assert off.sum() <= max_off * match.sum(), (int(off.sum()),
                                                diff[match].max())
    assert (golden["ids"] >= 0).mean() > 0.5


def test_golden_file_is_small():
    assert os.path.getsize(make_golden.OUT) <= 300_000


def test_reference_reproduces_golden():
    rgba, ids = make_golden.render_reference()
    _check(rgba, ids)


# The card renders both frames in chip_smoke.py's golden phase.
@pytest.mark.parametrize("device", ["cpu"])
def test_port_matches_golden(device):
    import ckrenderengine_tpu_torch.objects as O

    _ctx, rc, _m = scenes.build_config2(O, device=device, width=320,
                                        height=240)
    ids = render_ids(rc)
    _check(rc.BackToFront(), to_np(ids))


def test_alpha_golden_file_is_small():
    assert os.path.getsize(make_golden.ALPHA_OUT) <= 300_000


def test_reference_reproduces_alpha_golden():
    rgba, ids = make_golden.render_reference(make_golden.ALPHA_OUT)
    _check(rgba, ids, ALPHA)


@pytest.mark.parametrize("device", ["cpu"])
def test_port_matches_alpha_golden(device):
    import ckrenderengine_tpu_torch.objects as O

    build, kw = make_golden.frames()[make_golden.ALPHA_OUT]
    _ctx, rc, _m = build(O, device=device, **kw)
    ids = render_ids(rc)
    st, tf, ti, tp = rc._fill_packed([], [])
    assert tp["ordered_cap"] * rc.height * rc.width > 1 << 26   # B3 branch
    assert tp["sampler_profile"][5]
    _check(rc.BackToFront(), to_np(ids), ALPHA)


def test_fx_golden_file_is_small():
    assert os.path.getsize(make_golden.FX_OUT) <= 300_000


@pytest.mark.parametrize("device", ["cpu"])
def test_port_matches_fx_golden(device):
    import ckrenderengine_tpu_torch.objects as O

    build, kw = make_golden.frames()[make_golden.FX_OUT]
    _ctx, rc, _m = build(O, device=device, **kw)
    ids = render_ids(rc)
    st, tf, ti, tp = rc._fill_packed([], [])
    assert tp["ordered_cap"] * rc.height * rc.width > 1 << 26   # B4 branch
    assert tp["sampler_profile"][6] and not tp["sampler_profile"][5]
    assert tp["lines"] is not None and rc.GetStats().NbLinesDrawn == 364
    _check(rc.BackToFront(), to_np(ids), FX, max_off=1e-3)


def test_shader_golden_file_is_small():
    assert os.path.getsize(make_golden.SHADER_OUT) <= 300_000


@pytest.mark.parametrize("device", ["cpu"])
def test_port_matches_shader_golden(device):
    """The shaded level: the tiled solve without e-planes, the pixel shader
    in the per-pixel-gather shade and in the flat ordered pass over the
    alpha sheet (ordered_cap*H*W <= 2^26)."""
    import ckrenderengine_tpu_torch.objects as O

    build, kw = make_golden.frames()[make_golden.SHADER_OUT]
    _ctx, rc, _m = build(O, device=device, **kw)
    ids = render_ids(rc)
    st, tf, ti, tp = rc._fill_packed([], [])
    assert tp["pixel_shader"] is not None and tp["vertex_shader"] is not None
    assert 0 < tp["ordered_cap"] * rc.height * rc.width <= 1 << 26
    _check(rc.BackToFront(), to_np(ids), SHADER)


def test_monitor_golden_file_is_small():
    assert os.path.getsize(make_golden.MONITOR_OUT) <= 300_000


@pytest.mark.parametrize("device", ["cpu"])
def test_port_matches_monitor_golden(device):
    """The monitor level in stereo at its second tick: the main context
    samples the producer's live feed, so Render() takes the stereo
    fallback (each eye a tiled frame with the feed and its mips written
    into the stack); the winner ids are the two eyes' side by side. The
    screen shows the producer's frame, which the two packages render
    within these same bounds: where the producers' winners differ (ties
    on an edge), the texels differ, and trilinear filtering spreads each
    over a few screen pixels. So 0.1% of the matching pixels may differ
    by more than one 8-bit step, and only on the screen."""
    import ckrenderengine_tpu_torch.objects as O

    rc, _producer = make_golden.monitor_ticks(O, device=device)
    rc.Render()
    assert rc.GetStats().StereoEagerFallback and rc._compiled.dev_ids
    static, eyes, dyn_i, params = make_golden.stereo_inputs(rc)
    assert params["texdev"] and params["sampler_profile"][1]
    ids = make_golden.side_by_side(*(
        to_np(port_winners(static, torch.as_tensor(df, device=device),
                           torch.as_tensor(dyn_i, device=device),
                           params)[2]) for df in eyes), rc.width)
    rgba = rc.BackToFront()
    _check(rgba, ids, MONITOR, max_off=1e-3)
    c = rc._compiled
    entity = c.vert_entity[c.tri_idx[:, 0]]
    screen = rc.context.GetObjectByName("screen").row
    diff = np.abs(rgba.astype(np.int32)
                  - MONITOR["rgba"].astype(np.int32)).max(-1)
    off = (diff > 1) & (ids == MONITOR["ids"])
    on_screen = (ids >= 0) & (entity[ids] == screen)
    assert np.all(on_screen[off]) and on_screen.mean() > 0.05
