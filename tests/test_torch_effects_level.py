"""The effect-pass variant of the material-effects level
(``scenes.build_config5_mat(effect_passes=True)``: a DP3 wall, the water
sheet with BumpEnv and its ADDSIGNED bias pass, a 2-texture and a
3-texture slab) cut to 128x96, through both packages' ``Render()`` on the
CPU.

Its passes blend DESTCOLOR / ZERO, ONE / ONE and REVSUBTRACT, outside both
ordered kernels' envelopes: the frame takes the exact ordered pass (its
flat form at this size, its tiled form at 1024x768, where such a frame
renders eagerly). A flat frame, rendered by the reference as its CPU runs
it, with its depth-tie window widened to 1,024 ULP
(``tests/_torch_common.tie_window`` says why: at 2 ULP its redraws fail
their LESSEQUAL tie on some of the ~1,000 pixels they cover), and held to
``check_render`` with the pixels of ``fx_explained`` (ill-conditioned
edges of ordered triangles) left to the 0.1% budget.
"""

import pytest

from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from tests._torch_common import (
    check_reference_inputs, check_render, fx_explained, render_both,
)

TIE_ULPS = 1024
PASSES = dict(width=128, height=96, terrain_n=8, n_balls=2, water_n=4,
              plaza_n=2, pass_n=2, effect_passes=True)


@pytest.fixture(scope="module")
def passes_level():
    return render_both(scenes.build_config5_mat, accelerator=False,
                       tie_ulps=TIE_ULPS, **PASSES)


def test_effect_pass_level_matches_reference(passes_level):
    rj, rt, _packed, _ref = passes_level
    c = rt._compiled
    assert c.want_texgen and c.want_cube and c.want_bump
    kinds = {(m.name, k) for m, k, _b in c.materials if m is not None}
    for name in ("wallmat", "watermat", "slab2mat", "slab3mat"):
        assert (name, "effectpass") in kinds
    tp = rt._fill_packed([], [])[3]
    # Outside both ordered kernels' envelopes: at 1024x768 this level
    # takes the exact tiled pass (and renders eagerly).
    assert not tp["sampler_profile"][5] and not tp["sampler_profile"][6]
    assert tfr.ordered_route(c.ordered_cap, 768, 1024,
                             tp["sampler_profile"]) == "tiled"
    check_render(passes_level, explained=fx_explained(passes_level))


def test_effect_pass_level_reference_inputs(passes_level):
    """The reference's packed inputs (its TexGen, cube and bump gates, its
    effect-pass state rows) through the port's frame."""
    check_reference_inputs(passes_level)
