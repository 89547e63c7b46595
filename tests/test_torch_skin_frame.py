"""The skinned slice as a whole: BASELINE config 4's tube (without its patch
sheet, ``scenes.build_config4_skin``) cut to 28 bones, 4 rings per bone and
16 vertices per ring (1,792 skinned vertices, 3,552 triangles) at 160x121,
through ``Render()`` with the clip bound to the device, at two clip times.

At that size the frame is tiled (t*H*W > 2^26), so it takes the solve and
the quantized rows of the full-size frame; the reference renders through
its accelerator branch (tests/_torch_common.render_reference).

- Each frame against the reference's (check_render): winners equal on
  >= 99.9% of the pixels and tied elsewhere, depths within f32 rounding,
  colours within 1/255 (check_frame_against_reference's bounds).
- The reference's own packed inputs, skin bank and bound-clip world
  matrices, through convert into the port's render_frame_packed.
- The stages on identical inputs: the reference's anim bank (converted)
  through the port's eval_anim_world, and the skin stage on the
  reference's world matrices, within 1e-5*(1 + |x|) per element. The
  chain is 28 levels deep, so compose_world takes the doubling path in
  both packages.
- The two clip times give different frames.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ckrenderengine_tpu.pipeline import skinning as jsk
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.pipeline import skinning as tsk
from tests._torch_common import (
    check_reference_inputs, check_render, render_both, to_np,
)
from tests.test_torch_anim import assert_close

KW = dict(width=160, height=121, n_bones=28, rings_per_bone=4, ring_verts=16)
# Clip ticks of 0.5 frames before the frame: clip times 0 and 20.
TICKS = (0, 40)


def _at(ticks):
    def build(O, **kw):
        ctx, rc, tick = scenes.build_config4_skin(O, **kw)
        for _ in range(ticks):
            tick()
        return ctx, rc, tick
    return build


@pytest.fixture(scope="module", params=TICKS, ids=lambda n: f"t{n / 2:g}")
def pair(request):
    return render_both(_at(request.param), **KW)


def test_frame_is_tiled_and_skinned(pair):
    rj, rt, _packed, _ref = pair
    c = rt._compiled
    t_pad = c.tri_idx.shape[0]
    assert t_pad * rt.height * rt.width > (1 << 26)
    assert c.n_valid_tris == 3552 and c.skin_bank is not None
    # Skinned rows stay on the gathered tail: no corner block.
    assert c.corner_nc == 0 and c.skin_ranges == ((0, 0, 1792),)
    assert rt.GetBoundAnimation().frame == rj.GetBoundAnimation().frame


def test_render_matches_reference(pair):
    check_render(pair)


def test_reference_inputs_through_port(pair):
    check_reference_inputs(pair)


def test_stages_on_identical_inputs(pair):
    rj, rt, (static, dyn_f, dyn_i, params), _ref = pair
    clip = rj.GetBoundAnimation()
    n = rj.context.entity_table.count
    bank = convert.anim_bank_from_reference(clip.bank(n_entities=n), "cpu")
    local = torch.as_tensor(np.array(rj.context.entity_table.local[:n]))
    world = tfr.eval_anim_world(local, torch.as_tensor(
        np.array(static["parent"])), bank, clip.frame, params["levels"])
    world_ref = np.array(params["world_in"])
    assert_close(world, world_ref)
    # The port's own bound-clip stage, from its own host compile.
    assert_close(rt._fill_packed([], [])[3]["world_in"], world_ref)
    # The skin stage on the reference's world matrices.
    skin = convert.skin_bank_from_reference(params["skin"], "cpu")
    got = tsk.apply_skin(torch.as_tensor(world_ref),
                         torch.as_tensor(np.array(static["positions"])),
                         torch.as_tensor(np.array(static["normals"])), skin,
                         ranges=params["skin_ranges"])
    ref = jsk.apply_skin(jnp.asarray(world_ref), static["positions"],
                         static["normals"], params["skin"],
                         ranges=params["skin_ranges"])
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r))


def test_clip_times_give_different_frames():
    frames = []
    for ticks in TICKS:
        import ckrenderengine_tpu_torch.objects as O

        _c, rc, _t = _at(ticks)(O, device="cpu", **KW)
        rc.Render()
        frames.append((to_np(rc.fb), to_np(rc.zb)))
    (fb0, zb0), (fb1, zb1) = frames
    moved = (np.abs(fb0 - fb1).max(0) > 1e-3) | (zb0 != zb1)
    assert moved.mean() > 0.01, moved.mean()
