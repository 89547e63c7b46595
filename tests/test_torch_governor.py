"""The capacity governor of the port's render context against the
reference's (``ckrenderengine_tpu/objects/rendercontext.py``
``_governor_tick`` / ``_governor_resolve`` / ``_gov_apply``).

- Parity: seeded sequences of 7-word ``SolveBinStats`` samples, some of
  them (W, 7) windows, go through both governors step by step (tick,
  resolve, or a recompile). The arithmetic is exact integer logic, so the
  caps and the four ``Solve*`` counters must be identical after every
  step.
- The reference's own cases (tests/test_capacity_governor.py) on the port.
- A frame: a tiled scene whose pair cap is far under its live pairs takes
  the exact remainder (``SolveFallbackRows`` > 0) and is bumped; its next
  frame reports ``SolveFallbackRows`` 0. Both frames equal the reference's
  within the bounds of tests/_torch_common.check_render.
"""

import numpy as np
import pytest

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import check_render, render_both

COUNTERS = ("SolveCapBumps", "SolveCapShrinks", "SolveLivePairs",
            "SolveFallbackRows")


def _cam_rc(O, **ctx_kw):
    ctx = O.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -5))
    rc.AttachViewpointToCamera(cam)
    rc.Render()                      # compile so _default_solve_caps works
    return rc


@pytest.fixture(scope="module")
def reference_rc():
    import ckrenderengine_tpu.objects as J

    return _cam_rc(J)


def _rc():
    import ckrenderengine_tpu_torch.objects as O

    return _cam_rc(O, device="cpu")


def _stats(live=1000, cut=0, g_over=0, s_over=0, n_small=800, n_mid=10,
           peak=50):
    return {"SolveBinStats": np.asarray(
        [peak, live, cut, g_over, s_over, n_small, n_mid], np.int32)}


def _sample(rng, scale):
    """One 7-word sample around ``scale`` live pairs: mostly clean, now and
    then with fallback rows."""
    live = int(rng.integers(0, 2 * scale))
    cut = int(rng.integers(1, 5000)) if rng.random() < 0.15 else 0
    g_over = int(rng.integers(1, 300)) if rng.random() < 0.1 else 0
    s_over = int(rng.integers(1, 3000)) if rng.random() < 0.1 else 0
    n_small = int(rng.integers(0, 2 * scale))
    n_mid = int(rng.integers(0, scale // 8 + 1))
    peak = int(rng.integers(0, 4096))
    return [peak, live, cut, g_over, s_over, n_small, n_mid]


def _reset(rc):
    rc._solve_caps = None
    rc._gov_frames = 0
    rc._gov_stash = None
    rc._gov_hist = []
    rc._gov_shrunk = False
    for k in COUNTERS:
        setattr(rc.stats, k, 0)


@pytest.mark.parametrize("seed", range(6))
def test_governor_matches_reference(reference_rc, seed):
    import jax.numpy as jnp

    rj, rt = reference_rc, _rc()
    _reset(rj)
    _reset(rt)
    rng = np.random.default_rng(seed)
    scale = int(rng.choice([2000, 30000, 60000, 120000]))
    for step in range(120):
        act = rng.random()
        if act < 0.03:
            rj._compile()
            rt._compile()
        elif act < 0.25:
            rj._governor_resolve()
            rt._governor_resolve()
        else:
            if rng.random() < 0.3:
                b = np.asarray([_sample(rng, scale)
                                for _ in range(int(rng.integers(2, 9)))],
                               np.int32)
            else:
                b = np.asarray(_sample(rng, scale), np.int32)
            rj._governor_tick({"SolveBinStats": jnp.asarray(b)})
            rt._governor_tick({"SolveBinStats": b})
            if rng.random() < 0.7:
                rj._governor_resolve()
                rt._governor_resolve()
        assert rt._solve_caps == rj._solve_caps, (seed, step)
        for k in COUNTERS:
            assert getattr(rt.stats, k) == getattr(rj.stats, k), (seed, step,
                                                                  k)
    assert rt._gov_frames == rj._gov_frames    # the same samples taken


def test_sequences_exercise_bumps_and_shrinks(reference_rc):
    """The parity sequences are not all trivial: over the seeds both
    governors bump and shrink."""
    rt = _rc()
    bumps = shrinks = 0
    for seed in range(6):
        _reset(rt)
        rng = np.random.default_rng(seed)
        scale = int(rng.choice([2000, 30000, 60000, 120000]))
        for _ in range(120):
            act = rng.random()
            if act < 0.03:
                rt._compile()
            elif act < 0.25:
                rt._governor_resolve()
            else:
                if rng.random() < 0.3:
                    b = np.asarray([_sample(rng, scale) for _ in range(
                        int(rng.integers(2, 9)))], np.int32)
                else:
                    b = np.asarray(_sample(rng, scale), np.int32)
                rt._governor_tick({"SolveBinStats": b})
                if rng.random() < 0.7:
                    rt._governor_resolve()
        bumps += rt.stats.SolveCapBumps
        shrinks += rt.stats.SolveCapShrinks
    assert bumps > 0 and shrinks > 0


def test_steady_windows_shrink_like_reference(reference_rc):
    """A steady load under a generous first plan: six windows of (W, 7)
    samples fire the one observed-peak shrink in both governors."""
    import jax.numpy as jnp

    rj, rt = reference_rc, _rc()
    _reset(rj)
    _reset(rt)
    rng = np.random.default_rng(7)
    first = np.asarray([10, 39000, 0, 0, 0, 40000, 3000], np.int32)
    rj._governor_tick({"SolveBinStats": jnp.asarray(first)})
    rt._governor_tick({"SolveBinStats": first})
    for _ in range(8):
        b = np.asarray([[10, int(rng.integers(25000, 30000)), 0, 0, 0,
                         int(rng.integers(15000, 20000)), 700]
                        for _ in range(8)], np.int32)
        rj._governor_tick({"SolveBinStats": jnp.asarray(b)})
        rt._governor_tick({"SolveBinStats": b})
        rj._governor_resolve()
        rt._governor_resolve()
        assert rt._solve_caps == rj._solve_caps
    assert rt.stats.SolveCapShrinks == rj.stats.SolveCapShrinks == 1


class TestGovernor:
    """The reference's cases (tests/test_capacity_governor.py) on the
    port."""

    def test_initial_plan_shrinks_to_scene(self):
        rc = _rc()
        rc._gov_on = True
        assert rc._solve_caps is None
        rc._governor_tick(_stats(live=5000, n_small=4000, n_mid=20))
        pair, slab, gcap = rc._solve_caps
        p0, s0, g0 = rc._default_solve_caps()
        assert pair < p0 and slab < s0 and gcap < g0
        assert pair >= 5000 * 2 and slab >= 4000 * 2
        assert gcap >= 1024

    def test_bumps_on_fallback_rows(self):
        rc = _rc()
        rc._gov_on = True
        rc._governor_tick(_stats())
        caps0 = rc._solve_caps
        rc._governor_tick(_stats(live=int(caps0[0] * 0.95), cut=128))
        assert rc._solve_caps == caps0
        rc._governor_resolve()
        assert rc._solve_caps[0] > caps0[0]
        assert rc.stats.SolveCapBumps >= 1
        assert rc.stats.SolveFallbackRows > 0
        assert rc.stats.SolveLivePairs > 0

    def test_small_loads_stay_at_cap_floors(self):
        rc = _rc()
        rc._gov_on = True
        rc._governor_tick(_stats())
        caps0 = rc._solve_caps
        for _ in range(20):
            rc._governor_tick(_stats())
            rc._governor_resolve()
        assert rc._solve_caps == caps0
        assert rc.stats.SolveCapBumps == 0
        assert rc.stats.SolveCapShrinks == 0

    def test_steady_state_shrinks_to_observed_peak(self):
        rc = _rc()
        rc._gov_on = True
        rc._governor_tick(_stats(live=39000, n_small=40000, n_mid=3000))
        caps0 = rc._solve_caps
        assert caps0[0] >= 39000 * 2.4
        for _ in range(5):
            rc._governor_tick(_stats(live=30000, n_small=20000, n_mid=700))
            rc._governor_resolve()
        assert rc._solve_caps == caps0
        assert rc.stats.SolveCapBumps == 0
        rc._governor_tick(_stats(live=30000, n_small=20000, n_mid=700))
        rc._governor_resolve()
        assert rc.stats.SolveCapShrinks == 1
        assert rc._solve_caps[0] < caps0[0]
        assert rc._solve_caps[1] < caps0[1]
        assert rc._solve_caps[0] >= 30000 * 1.25
        assert rc._solve_caps[1] >= 20000 * 1.25
        caps1 = rc._solve_caps
        for _ in range(10):
            rc._governor_tick(_stats(live=30000, n_small=20000, n_mid=700))
            rc._governor_resolve()
        assert rc._solve_caps == caps1
        assert rc.stats.SolveCapShrinks == 1

    def test_recompile_resets_caps(self):
        rc = _rc()
        rc._gov_on = True
        rc._governor_tick(_stats())
        assert rc._solve_caps is not None
        rc._compile()
        assert rc._solve_caps is None

    def test_enabled_where_the_cuda_solve_runs(self):
        assert _rc()._gov_on is False


@pytest.fixture(scope="module")
def tiled_pair():
    """config 2 at 256x192 (a tiled frame) through both packages."""
    return render_both(scenes.build_config2, width=256, height=192)


def test_overflowing_frame_is_bumped(tiled_pair):
    """The port's context with a pair cap far under the scene's live pairs:
    the frame runs the exact remainder, the governor bumps the cap, and the
    next frame needs no fallback. Both frames equal the reference's."""
    _rj, rt, _packed, _ref = tiled_pair
    rt._gov_on = True
    rt._solve_caps = (512, 131072, 8192)
    rt.Render()
    s = rt.GetStats()
    assert s.SolveFallbackRows > 0 and s.SolveLivePairs > 512
    assert s.SolveCapBumps == 1
    assert rt._solve_caps[0] >= 1.75 * s.SolveLivePairs
    check_render(tiled_pair)
    rt.Render()
    assert s.SolveFallbackRows == 0 and s.SolveCapBumps == 1
    check_render(tiled_pair)
