"""The flat solve on the cases of
``ckrenderengine_tpu_torch.raster.flat_fixtures`` (config 1's shape with its
padding rows, the route's pair limit with small triangles, frame-sized rows
that reach every strip, the row limit on fewer sub-tiles than SMs, exact
ties across stages and cluster ranks including -0.0 against +0.0, a
watertight mesh under the top-left rule, rects and a viewport on the edges of
a 4-pixel block and a 16x8 strip, an odd frame, depth outside [0, 1], and
pairs lost to esum alone) at the small scale:

- the plain version (``depth_reduce_cuda`` on CPU tensors) against the
  reference's ``depth_reduce_pallas(..., interpret=True)`` from the
  reference's own setup: ids exactly, depths by ``assert_depth_close`` (the
  tolerances of tests/test_torch_reduce.py), on every case but
  ``esum_rounding``, whose pairs only rounding decides (the reference
  contracts multiply-adds; the card holds the kernel to the plain version
  there);
- ``check_expect`` on every case: what it was built for still holds, from
  the kernel's own tests (``flat_stats``), among them that the kernel's
  strip scan drops no (row, strip) pair where a pixel of the strip passes
  valid, rect and edges;
- bands of a flat frame (``flat_fixtures.band_cases``: B2's plain version
  at a row offset, with triangles and rects ending exactly on the band's,
  its sub-tiles' and its strips' edges): ids equal to the reference's XLA
  ``deferred.depth_reduce`` with ``row0``, depths within the bounds above,
  ids and depths equal to the same rows of the unbanded solve bit for bit,
  and the strip scan at the band's global rows exact (``check_expect``).

Kernel B2 is held against the plain version on these cases at full size on
the card by chip_smoke.py.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import assert_depth_close, to_np

from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.pallas_reduce import depth_reduce_pallas
from ckrenderengine_tpu.raster.types import VXCULL, RasterState, pack_states
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.raster import cuda_reduce
from ckrenderengine_tpu_torch.raster.flat_fixtures import (
    band_cases, check_expect, flat_cases, flat_stats,
)

CASES = {c["name"]: c for c in flat_cases(scale=0.25)}
NAMES = list(CASES)
# The cases whose pairs the reference's contracted arithmetic decides like
# the port's (all but esum_rounding, which only the card compares).
REFERENCE_NAMES = [n for n in NAMES if CASES[n]["reference"]]
CASES.update((c["name"], c) for c in band_cases())
BANDS = [n for n in CASES if "row0" in CASES[n]]


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The reference's setup of a case (no culling: ``valid`` carries it),
    as numpy arrays."""
    c = CASES[name]
    t = c["xyw"].shape[0]
    si, _sf = pack_states([RasterState(cull=int(VXCULL.NONE))])
    setup = jdf.triangle_setup(
        jnp.asarray(c["xyw"]), jnp.asarray(c["z"]), jnp.zeros(t, jnp.int32),
        jnp.asarray(c["valid"]), jnp.asarray(si),
        clip_rect=None if c["clip_rect"] is None
        else jnp.asarray(c["clip_rect"]))
    return {k: np.asarray(v) for k, v in setup.items()}


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_flat_case_matches_reference(name):
    c = CASES[name]
    setup = _setup(name)
    view = jnp.asarray(c["viewport"], jnp.float32)
    bi_r, bd_r = (np.asarray(a) for a in depth_reduce_pallas(
        {k: jnp.asarray(v) for k, v in setup.items()},
        jnp.asarray(c["defer"]), c["clear_z"], view, c["h"], c["w"],
        interpret=True))
    bi_g, bd_g = cuda_reduce.depth_reduce_cuda(
        convert.setup_from_reference(setup), torch.as_tensor(c["defer"]),
        c["clear_z"], torch.tensor(c["viewport"], dtype=torch.float32),
        c["h"], c["w"])
    np.testing.assert_array_equal(to_np(bi_g), bi_r)
    assert_depth_close(to_np(bd_g), bd_r, bi_r, setup)
    assert (bi_r >= 0).any()


@pytest.mark.parametrize("name", NAMES)
def test_flat_case_exercises_its_design(name):
    c = CASES[name]
    setup = convert.setup_from_reference(_setup(name))
    rows = cuda_reduce.pack_rows(setup, torch.as_tensor(c["defer"]))
    ids, _depth = cuda_reduce.depth_reduce_plain(
        rows, c["clear_z"], torch.tensor(c["viewport"]), c["h"], c["w"])
    check_expect(c, flat_stats(rows, c["h"], c["w"], c["viewport"]),
                 to_np(ids))


@pytest.mark.parametrize("name", BANDS)
def test_band_flat_solve(name):
    """B2's plain version at a row offset: against the reference's XLA
    flat solve with ``row0``, and bit-equal to the same rows of the
    unbanded solve."""
    c = CASES[name]
    row0, h, w = c["row0"], c["h"], c["w"]
    setup = _setup(name)
    view = torch.tensor(c["viewport"], dtype=torch.float32)
    setup_t = convert.setup_from_reference(setup)
    defer = torch.as_tensor(c["defer"])
    bi_g, bd_g = cuda_reduce.depth_reduce_cuda(setup_t, defer, c["clear_z"],
                                               view, h, w, row0=row0)
    bi_w, bd_w = cuda_reduce.depth_reduce_cuda(setup_t, defer, c["clear_z"],
                                               view, c["frame_h"], w)
    assert torch.equal(bi_g, bi_w[row0:row0 + h])
    assert torch.equal(bd_g, bd_w[row0:row0 + h])
    # The kernel's strip scan, at the band's global rows, drops no row that
    # reaches its strip.
    rows = cuda_reduce.pack_rows(setup_t, defer)
    check_expect(c, flat_stats(rows, h, w, c["viewport"], row0=row0),
                 to_np(bi_g))
    bi_r, bd_r = (np.asarray(a) for a in jdf.depth_reduce(
        {k: jnp.asarray(v) for k, v in setup.items()},
        jnp.asarray(c["defer"]), c["clear_z"],
        jnp.asarray(c["viewport"], jnp.float32), h, w, row0=float(row0)))
    np.testing.assert_array_equal(to_np(bi_g), bi_r)
    assert_depth_close(to_np(bd_g), bd_r, bi_r, setup)
    assert (bi_r >= 0).mean() > 0.1
