"""The golden frames (tests/torch_golden/, made by
tests/torch_golden/make_golden.py with the reference package on its
accelerator branch, so they carry the quantized rows of a tiled frame):
config 2, the untextured transparency scene whose ordered pass both
packages run through kernel B3, the effects level whose 3D sprites
take the textured peel B4 and whose curves, wireframe grid and line list
take the line pass, and the shaded level, whose user stages run in the
per-pixel-gather shade and in the flat ordered pass. The reference still reproduces the first two, and the
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
from tests._torch_common import port_winners, to_np
from tests.torch_golden import make_golden

GOLDEN = np.load(make_golden.OUT)
ALPHA = np.load(make_golden.ALPHA_OUT)
FX = np.load(make_golden.FX_OUT)
SHADER = np.load(make_golden.SHADER_OUT)


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
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    _fb, _zb, ids = port_winners(st, torch.as_tensor(tf, device=device),
                                 torch.as_tensor(ti, device=device), tp)
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
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    assert tp["ordered_cap"] * rc.height * rc.width > 1 << 26   # B3 branch
    assert tp["sampler_profile"][5]
    _fb, _zb, ids = port_winners(st, torch.as_tensor(tf, device=device),
                                 torch.as_tensor(ti, device=device), tp)
    _check(rc.BackToFront(), to_np(ids), ALPHA)


def test_fx_golden_file_is_small():
    assert os.path.getsize(make_golden.FX_OUT) <= 300_000


@pytest.mark.parametrize("device", ["cpu"])
def test_port_matches_fx_golden(device):
    import ckrenderengine_tpu_torch.objects as O

    build, kw = make_golden.frames()[make_golden.FX_OUT]
    _ctx, rc, _m = build(O, device=device, **kw)
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    assert tp["ordered_cap"] * rc.height * rc.width > 1 << 26   # B4 branch
    assert tp["sampler_profile"][6] and not tp["sampler_profile"][5]
    assert tp["lines"] is not None and rc.GetStats().NbLinesDrawn == 364
    _fb, _zb, ids = port_winners(st, torch.as_tensor(tf, device=device),
                                 torch.as_tensor(ti, device=device), tp)
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
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    assert tp["pixel_shader"] is not None and tp["vertex_shader"] is not None
    assert 0 < tp["ordered_cap"] * rc.height * rc.width <= 1 << 26
    _fb, _zb, ids = port_winners(st, torch.as_tensor(tf, device=device),
                                 torch.as_tensor(ti, device=device), tp)
    _check(rc.BackToFront(), to_np(ids), SHADER)
