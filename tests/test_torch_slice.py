"""The opaque slice as a whole, port against reference on the CPU: one
helper builds each scene through either package's object model. This file
holds config 1 (cube, flat solve B2) and a config-2-like scene (tiled solve
B1 by t*H*W); tests/test_torch_slice_level.py holds the config-5-like level.

A tiled frame shades from quantized rows in both packages, but the reference
only on its accelerator branch, which its own CPU ``Render()`` never takes.
So the tiled scene's reference frame is rendered on that branch
(tests/_torch_common.accelerator_branch: the backend reads "tpu", the Pallas
solve runs in interpret mode), and both frames carry the same D3DCOLOR
quantization and the same 2x2-quad mip LOD. Config 1 is flat: both packages
shade it through ``shade_deferred``, and its reference stays the CPU's
``Render()``.

What is compared (tests/_torch_common.check_frame_against_reference), and
why the bounds are relative to f32 rounding:

- Winners: equal on >= 99.9% of the pixels; where they differ, the two
  answers tie within f32 rounding (assert_winner_ties).
- Depths: these scenes hold large, off-screen-reaching triangles whose edge
  functions cancel big terms (median edge condition ~50 for the cube and
  240-320 for the other two), so one f32 evaluation of the depth formula is
  only good to ~2e-5 there. The reference disagrees with itself by up to
  1e-3: its fused frame program and its own flat solve on the same inputs
  round apart on ~44% of the config-2 pixels. A fixed 4e-6 cannot hold
  between two implementations that round differently, so depths must agree
  within 4e-6 plus a multiple of the f32 forward-error bound of the
  winner's depth (assert_frame_depth_close).
- Framebuffers: within 1/255 where both frames show the same surface; at
  most 0.1% of those pixels may differ more, on edges so ill-conditioned
  (condition > 1e3) that a nearest-texel lookup flips
  (assert_frame_fb_close).
- The reference's fused frame program also contracts the edge arithmetic
  into FMAs, so on a pixel centre that lies exactly on an edge shared by
  two triangles it can find neither covering (a one-pixel crack, e.g. 8
  pixels along a cube face diagonal at 128x128); its own solve and the
  port, which never contracts, fill them. The frame comparison therefore
  runs on the pixels where the reference's frame agrees with its own solve
  (>= 99.9% of them).
"""

import pytest

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import (
    check_reference_inputs, check_render, render_both,
)

SCENES = {
    "config1": (scenes.build_config1, dict(size=128, accelerator=False)),
    "config2": (scenes.build_config2, dict(width=256, height=192)),
}


@pytest.fixture(scope="module")
def rendered():
    return {name: render_both(build, **kw)
            for name, (build, kw) in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_reference(rendered, name):
    """The port's Render() against the reference's Render()."""
    check_render(rendered[name])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_reference_inputs_through_port_frame(rendered, name):
    """The reference's packed inputs through the port's frame."""
    check_reference_inputs(rendered[name])
