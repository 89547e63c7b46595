"""The opaque slice as a whole on a config-5-like level, port against
reference on the CPU: > 4096 triangles (tiled solve B1), places + portals,
and host chunk culling that compacts the terrain's corner block. The frame
is tiled, so the reference renders it on its accelerator branch (quantized
rows, tests/_torch_common.accelerator_branch). The bounds are those of
tests/test_torch_slice.py, which explains them."""

import pytest

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import (
    check_reference_inputs, check_render, render_both,
)


@pytest.fixture(scope="module")
def level():
    return render_both(scenes.build_config5, width=160, height=120,
                       terrain_n=240, n_balls=8)


def test_render_matches_reference(level):
    """The port's Render() against the reference's Render()."""
    tp = check_render(level)
    assert tp["cull"][1] < tp["cull"][3]        # chunk compaction ran


def test_reference_inputs_through_port_frame(level):
    """The reference's packed inputs through the port's frame."""
    check_reference_inputs(level)
