"""BASELINE config 4 whole through ``Render()`` of both packages on the
CPU: ``scenes.build_config4`` with the skinned tube cut to 20 bones, 4
rings per bone and 16 vertices per ring (2,528 triangles) and the full
patch sheet (36 patches at iteration 5, 1,800 triangles) at 256x193, at
clip times 0 and 20. A tiled frame (t*H*W > 2^26); the reference renders
through its accelerator branch. Seen from config 4's camera the sheet is
back-facing, and both packages cull it.

Each frame is held to ``check_render`` and the reference's own packed
inputs (skin bank and bound-clip world matrices included) through the
port to ``check_reference_inputs``, both with ``own_setup``: the tube and
sheet have edges whose coefficients cancel (edge condition > 1e3), where
each package's depth is held to its own triangle setup
(tests/_torch_common.check_frame_against_reference).
"""

import pytest

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import (
    check_reference_inputs, check_render, render_both,
)

C4 = dict(width=256, height=193, n_bones=20, rings_per_bone=4,
          ring_verts=16)
# Clip ticks of 0.5 frames before the frame: clip times 0 and 20.
TICKS = (0, 40)


def _config4_at(ticks):
    def build(O, **kw):
        ctx, rc, tick = scenes.build_config4(O, **kw)
        for _ in range(ticks):
            tick()
        return ctx, rc, tick
    return build


@pytest.fixture(scope="module", params=TICKS, ids=lambda n: f"t{n / 2:g}")
def config4(request):
    return render_both(_config4_at(request.param), frame_ids=True, **C4)


def _tiled(rc):
    return rc._compiled.tri_idx.shape[0] * rc.height * rc.width > (1 << 26)


def test_config4_scene(config4):
    rj, rt, _packed, _ref = config4
    c = rt._compiled
    assert c.n_valid_tris == 2528 + 1800 and _tiled(rt)
    assert c.skin_bank is not None
    assert rt.GetBoundAnimation().frame == rj.GetBoundAnimation().frame


def test_config4_matches_reference(config4):
    check_render(config4, own_setup=True)


def test_config4_reference_inputs_through_port(config4):
    check_reference_inputs(config4, own_setup=True)
