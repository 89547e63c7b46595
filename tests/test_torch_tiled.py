"""The tiled solve (phase A + plain phase B of kernel B1) against the
reference's Pallas solve in interpret mode, on the fixtures of
tests/test_pallas_tiled.py: ids exactly, depth within the reference tests'
4e-6 (beyond it only where the reference's FMA-contracted arithmetic and
the port's uncontracted one round an ill-conditioned edge plane apart, see
tests/_torch_common.assert_depth_close), the 7-vector bin statistics
exactly, and the winner e-planes within 1e-5 (or, for the large raw edge
values of big triangles, within the same rounding bound). The CUDA kernel
itself is held against the plain version on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import (
    assert_depth_close, assert_eplanes_close, to_np,
)
from tests.test_tiled_raster import _random_batch

from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.pallas_tiled import depth_reduce_tiled_pallas
from ckrenderengine_tpu.raster.types import RasterState, pack_states
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.raster import cuda_tiled


def _setup(xyw, z, t, clip_rect=None, clipd=None):
    si, _sf = pack_states([RasterState()])
    return jdf.triangle_setup(xyw, z, jnp.zeros(t, jnp.int32),
                              jnp.ones(t, bool), jnp.asarray(si),
                              clip_rect=clip_rect, clipd=clipd)


def _straddlers():
    rng = np.random.default_rng(9)
    t, h, w = 40, 64, 64
    centers = rng.uniform([0, 0], [w, h], (t, 2)).astype(np.float32)
    offs = rng.normal(0, 1, (t, 3, 2)).astype(np.float32)
    pts = centers[:, None] + offs * 30.0
    ws = rng.uniform(-1.5, 3.0, (t, 3, 1)).astype(np.float32)  # some w <= 0
    xyw = jnp.asarray(np.concatenate([pts * ws, ws], axis=-1))
    z = jnp.asarray(rng.uniform(0.05, 0.95, (t, 3)).astype(np.float32))
    return xyw, z, _setup(xyw, z, t), h, w, 1.0, [0, 0, w, h]


def _fixture(name):
    """(xyw, z, setup, h, w, clear_z, viewport) of one reference fixture."""
    if name.startswith("random"):
        seed, (h, w) = {"random_a": (0, (64, 64)),
                        "random_b": (2, (48, 96))}[name]
        xyw, z, _s, _v = _random_batch(260, h, w, seed)
        return xyw, z, _setup(xyw, z, 260), h, w, 1.0, [0, 0, w, h]
    if name == "overflow":
        xyw, z, _s, _v = _random_batch(300, 64, 64, seed=5, big_frac=0.3)
        return xyw, z, _setup(xyw, z, 300), 64, 64, 1.0, [0, 0, 64, 64]
    if name == "straddlers":
        return _straddlers()
    if name == "clip_rects_planes":
        t = 120
        xyw, z, _s, _v = _random_batch(t, 64, 64, seed=3)
        rng = np.random.default_rng(3)
        rects = np.tile(np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32),
                        (t, 1))
        rects[rng.random(t) < 0.5] = [10.0, 8.0, 50.0, 40.0]
        clipd = rng.uniform(-1.0, 1.0, (t, 3, 1)).astype(np.float32)
        setup = _setup(xyw, z, t, clip_rect=jnp.asarray(rects),
                       clipd=jnp.asarray(clipd))
        return xyw, z, setup, 64, 64, 1.0, [4, 2, 56, 58]
    if name == "kept_zbuffer":
        xyw, z, _s, _v = _random_batch(90, 64, 64, seed=8)
        zb = np.random.default_rng(8).uniform(0.1, 0.9, (64, 64)).astype(
            np.float32)
        return xyw, z, _setup(xyw, z, 90), 64, 64, zb, [0, 0, 64, 64]
    if name == "non_divisible":
        xyw, z, _s, _v = _random_batch(150, 50, 70, seed=4)
        return xyw, z, _setup(xyw, z, 150), 50, 70, 1.0, [0, 0, 70, 50]
    raise KeyError(name)


CASES = [
    ("random_a", dict(max_span=4, span2=16)),
    ("random_b", dict(max_span=4, span2=16)),
    ("overflow", dict(max_span=2, span2=4, g_cap=16, slab_cap=64)),
    ("straddlers", {}),
    ("clip_rects_planes", {}),
    ("kept_zbuffer", {}),
    ("non_divisible", {}),
    ("pair_cap_0", dict(max_span=4, span2=16, pair_cap=0)),
    ("pair_cap_64", dict(max_span=4, span2=16, pair_cap=64)),
]


@pytest.mark.parametrize("name,caps", CASES, ids=[c[0] for c in CASES])
def test_tiled_solve_matches_reference(name, caps):
    base = "random_a" if name.startswith("pair_cap") else name
    xyw, z, setup, h, w, clear, vp = _fixture(base)
    t = xyw.shape[0]
    ref = depth_reduce_tiled_pallas(
        setup, jnp.ones(t, bool), jnp.asarray(clear), jnp.asarray(
            vp, jnp.float32), xyw, h, w, tile=16, interpret=True,
        want_eplanes=True, want_binstats=True, **caps)
    bi_r, bd_r, st_r, ep_r = (np.asarray(a) for a in ref)

    setup_t = convert.setup_from_reference(
        {k: np.asarray(v) for k, v in setup.items()})
    got = cuda_tiled.depth_reduce_tiled_cuda(
        setup_t, torch.ones(t, dtype=torch.bool),
        torch.as_tensor(np.asarray(clear)),
        torch.tensor(vp, dtype=torch.float32),
        torch.as_tensor(np.asarray(xyw)), h, w, tile=16,
        want_eplanes=True, want_binstats=True, **caps)
    bi_g, bd_g, st_g, ep_g = (to_np(a) for a in got)
    np.testing.assert_array_equal(bi_g, bi_r)
    assert_depth_close(bd_g, bd_r, bi_r,
                       {k: np.asarray(v) for k, v in setup.items()})
    np.testing.assert_array_equal(st_g, st_r)
    assert_eplanes_close(ep_g, ep_r, bi_r,
                         {k: np.asarray(v) for k, v in setup.items()})
    assert (bi_g >= 0).any()
    if name in ("overflow", "pair_cap_0", "pair_cap_64"):
        assert st_g[2:5].sum() > 0          # a beyond-cap remainder ran


def test_phase_b_plain_matches_flat_reduce():
    """Phase A + the plain phase B at the frame's tile size (32) equal the
    flat reference arithmetic of the port (deferred.depth_reduce)."""
    from ckrenderengine_tpu_torch.raster import deferred as tdf

    xyw, z, setup, h, w, clear, vp = _fixture("random_b")
    setup_t = convert.setup_from_reference(
        {k: np.asarray(v) for k, v in setup.items()})
    t = xyw.shape[0]
    vp_t = torch.tensor(vp, dtype=torch.float32)
    bi, bd, _peak = cuda_tiled.depth_reduce_tiled_cuda(
        setup_t, torch.ones(t, dtype=torch.bool), 1.0, vp_t,
        torch.as_tensor(np.asarray(xyw)), h, w)
    bi_f, bd_f = tdf.depth_reduce(setup_t, torch.ones(t, dtype=torch.bool),
                                  1.0, vp_t, h, w)
    assert torch.equal(bi, bi_f) and torch.equal(bd, bd_f)
