"""The flat solve (plain version of kernel B2) against the reference's
Pallas flat solve in interpret mode: ids exactly, depth within 4e-6 (beyond
it only where FMA contraction rounds an ill-conditioned edge plane apart).
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import assert_depth_close, to_np
from tests.test_tiled_raster import _random_batch

from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.pallas_reduce import depth_reduce_pallas
from ckrenderengine_tpu.raster.types import RasterState, pack_states
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.raster import cuda_reduce


def _case(seed, t, h, w, rects=False):
    xyw, z, _s, _v = _random_batch(t, h, w, seed)
    si, _sf = pack_states([RasterState()])
    rect = None
    if rects:
        r = np.tile(np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32), (t, 1))
        r[np.random.default_rng(seed).random(t) < 0.5] = [8.0, 4.0, 40.0,
                                                          30.0]
        rect = jnp.asarray(r)
    setup = jdf.triangle_setup(xyw, z, jnp.zeros(t, jnp.int32),
                               jnp.ones(t, bool), jnp.asarray(si),
                               clip_rect=rect)
    return setup, {k: np.asarray(v) for k, v in setup.items()}


@pytest.mark.parametrize("seed,t,h,w,vp,rects", [
    (0, 200, 64, 128, (0, 0, 128, 64), False),
    (1, 150, 48, 80, (6, 3, 60, 40), True),
])
def test_flat_solve_matches_reference(seed, t, h, w, vp, rects):
    setup, setup_np = _case(seed, t, h, w, rects)
    defer = np.random.default_rng(seed).random(t) < 0.9
    bi_r, bd_r = (np.asarray(a) for a in depth_reduce_pallas(
        setup, jnp.asarray(defer), 1.0, jnp.asarray(vp, jnp.float32), h, w,
        interpret=True))
    bi_g, bd_g = cuda_reduce.depth_reduce_cuda(
        convert.setup_from_reference(setup_np), torch.as_tensor(defer), 1.0,
        torch.tensor(vp, dtype=torch.float32), h, w)
    np.testing.assert_array_equal(to_np(bi_g), bi_r)
    assert_depth_close(to_np(bd_g), bd_r, bi_r, setup_np)
    assert (bi_r >= 0).mean() > 0.2


def test_pack_rows_matches_reference():
    from ckrenderengine_tpu.raster.pallas_reduce import pack_rows

    setup, setup_np = _case(2, 64, 32, 32, rects=True)
    defer = np.arange(64) % 3 != 0
    ref = np.asarray(pack_rows(setup, jnp.asarray(defer)))
    got = cuda_reduce.pack_rows(convert.setup_from_reference(setup_np),
                                torch.as_tensor(defer))
    np.testing.assert_array_equal(to_np(got), ref)
