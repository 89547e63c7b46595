"""The tiled solve's 16-byte-aligned row stream, on the cases of
``ckrenderengine_tpu_torch.raster.tiled_fixtures`` (a deep tile beside empty
ones, ranges that are exact chunk multiples, tiles with only leftover
segments, 1 and 3 clip planes, rects and a viewport on the edges of a
thread's pixel block, a frame that is no multiple of the tile), at tile 16,
chunk 32 and a 300-row deep tile so that the reference's interpreted Pallas
kernel can stream them:

- phase A: the padded pitch (24 / 28 / 32 floats), zero pad columns, every
  live stream row equal column for column to the reference's packed row of
  its triangle (rebuilt here from the reference's own setup in the layout of
  pallas_tiled.py:496-515), and ``starts``, ``counts`` and ``leftn`` equal
  to a brute-force binning of the reference's ``_screen_bbox`` under its
  classification rules; ``binstats`` equal to the reference's;
- phase A + the plain phase B on the padded stream against the reference's
  solve in interpret mode: ids exactly, depths and e-planes within the
  bounds of tests/test_torch_tiled.py;
- the beyond-cap remainder and the re-fetch with a padded row table (one
  clip plane, pitch 28) against the reference's fused fetch;
- bands of a frame (``tiled_fixtures.band_cases``: a solve at a row
  offset, with triangles ending exactly on the band's and its tiles'
  edges): phase A's ranges equal to a brute-force binning from row0, the
  solve's ids equal to the reference's XLA ``tiled.depth_reduce_tiled``
  with ``row0`` (depths within the bounds above), and ids, depths and
  e-planes bit-equal to the same rows of the port's unbanded solve, with
  the default caps and with caps so small that the remainder runs.

Kernels B1 and B5 are held against the plain version on these cases on the
card by chip_smoke.py.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import (
    assert_depth_close, assert_eplanes_close, to_np,
)

from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.pallas_tiled import depth_reduce_tiled_pallas
from ckrenderengine_tpu.raster.tiled import _screen_bbox as ref_screen_bbox
from ckrenderengine_tpu.raster.tiled import depth_reduce_tiled
from ckrenderengine_tpu.raster.types import RasterState, pack_states
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.raster import cuda_tiled
from ckrenderengine_tpu_torch.raster.tiled_fixtures import (
    band_cases, check_expect, tiled_cases,
)

TILE, KCHUNK = 16, 32
CASES = {c["name"]: c for c in tiled_cases(tile=TILE, kchunk=KCHUNK,
                                           deep=300)}
NAMES = list(CASES)
CASES.update((c["name"], c) for c in band_cases(tile=TILE, kchunk=KCHUNK))
BANDS = [n for n in CASES if "row0" in CASES[n]]


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _reference_setup(c):
    t = c["xyw"].shape[0]
    si, _sf = pack_states([RasterState()])
    return jdf.triangle_setup(
        jnp.asarray(c["xyw"]), jnp.asarray(c["z"]), jnp.zeros(t, jnp.int32),
        jnp.ones(t, bool), jnp.asarray(si),
        clip_rect=None if c["clip_rect"] is None
        else jnp.asarray(c["clip_rect"]),
        clipd=None if c["clipd"] is None else jnp.asarray(c["clipd"]))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(reference setup, its solve's (ids, depth, binstats, e-planes))."""
    c = CASES[name]
    setup = _reference_setup(c)
    if "row0" in c:
        return _np(setup), None
    t = c["xyw"].shape[0]
    out = depth_reduce_tiled_pallas(
        setup, jnp.ones(t, bool), 1.0, jnp.asarray(c["viewport"],
                                                   jnp.float32),
        jnp.asarray(c["xyw"]), c["h"], c["w"], interpret=True,
        want_eplanes=True, want_binstats=True, **c["caps"])
    return _np(setup), tuple(np.asarray(a) for a in out)


def _port_inputs(name, dev="cpu"):
    c = CASES[name]
    setup, _ref = _reference(name)
    t = c["xyw"].shape[0]
    return (convert.setup_from_reference(setup, dev),
            torch.ones(t, dtype=torch.bool, device=dev),
            torch.tensor(c["viewport"], dtype=torch.float32, device=dev),
            torch.as_tensor(c["xyw"].copy(), device=dev))


@pytest.mark.parametrize("name", NAMES)
def test_stream_case_matches_reference(name):
    c = CASES[name]
    setup, (bi_r, bd_r, st_r, ep_r) = _reference(name)
    setup_t, defer, vp, xyw = _port_inputs(name)
    got = cuda_tiled.depth_reduce_tiled_cuda(
        setup_t, defer, 1.0, vp, xyw, c["h"], c["w"], want_eplanes=True,
        want_binstats=True, **c["caps"])
    bi_g, bd_g, st_g, ep_g = (to_np(a) for a in got)
    np.testing.assert_array_equal(bi_g, bi_r)
    assert_depth_close(bd_g, bd_r, bi_r, setup)
    np.testing.assert_array_equal(st_g, st_r)
    assert_eplanes_close(ep_g, ep_r, bi_r, setup)
    assert (bi_g >= 0).any()


def _reference_rows(setup, t):
    """The reference's packed row table (pallas_tiled.py:496-515), logical
    columns only."""
    tl = setup["top_left"].astype(np.int32)
    flags = (tl[:, 0] + 2 * tl[:, 1] + 4 * tl[:, 2]
             + 8 * setup["valid"].astype(np.int32)).astype(np.float32)
    cols = [setup["e9"] if "e9" in setup else setup["e_coef"].reshape(t, 9),
            setup["z"], setup["inv_det_s"][:, None], setup["esum_plane"],
            setup["s"][:, None], flags[:, None],
            np.broadcast_to(setup["clip_rect"], (t, 4)),
            np.arange(t, dtype=np.float32)[:, None]]
    dp = setup.get("dplane")
    if dp is not None and dp.shape[1]:
        cols.append(dp.reshape(t, -1))
    return np.concatenate(cols, axis=1)


def _reference_bins(c, setup, tile, max_span=2, span2=16, g_cap=8192,
                    slab_cap=131072, **_):
    """(counts (ty, tx), leftn) by brute force from the reference's bbox
    and its classification (pallas_tiled.py:454-494, 644-664; a band's
    rows from its row0, reference tiled.py:306-311)."""
    t = c["xyw"].shape[0]
    h, w = c["h"], c["w"]
    row0 = c.get("row0", 0)
    ty_n, tx_n = -(-h // tile), -(-w // tile)
    x0, y0, x1, y1, unb, empty = (np.asarray(a) for a in ref_screen_bbox(
        jnp.asarray(c["xyw"]), jnp.asarray(setup["z"])))

    def tidx(v, n):
        return np.clip(np.floor(v / tile), 0, n - 1).astype(np.int64)

    tx0, tx1 = tidx(x0, tx_n), tidx(x1, tx_n)
    ty0, ty1 = tidx(y0 - np.float32(row0), ty_n), tidx(y1 - np.float32(row0),
                                                        ty_n)
    off = (x1 < 0) | (x0 >= w) | (y1 < row0) | (y0 >= row0 + h) | empty
    span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    live = setup["valid"] & ~off
    small = live & ~unb & (span <= max_span)
    mid = live & ~unb & (span > max_span) & (span <= span2)
    glob = live & ~small & ~mid
    m_cap = 1 << max(0, int(max(t, 2) - 1).bit_length())
    g_cap = min(g_cap, m_cap)
    slab_l = min(slab_cap, m_cap, max(t, 1))
    binned = np.concatenate([np.nonzero(small)[0][:slab_l],
                             np.nonzero(mid)[0][:g_cap]])
    counts = np.zeros((ty_n, tx_n), np.int64)
    for i in binned:
        counts[ty0[i]:ty1[i] + 1, tx0[i]:tx1[i] + 1] += 1
    g_count = glob.sum() + max(mid.sum() - g_cap, 0)
    s_over = max(small.sum() - slab_l, 0)
    return counts, np.array([min(g_count, g_cap), min(s_over, g_cap)])


@pytest.mark.parametrize("name", NAMES)
def test_phase_a_padded_stream_matches_reference(name):
    c = CASES[name]
    setup, (_bi, _bd, st_r, _ep) = _reference(name)
    setup_t, defer, vp, xyw = _port_inputs(name)
    caps = c["caps"]
    a = cuda_tiled.phase_a(setup_t, defer, vp, xyw, c["h"], c["w"], **caps)
    check_expect(c, a)
    t = c["xyw"].shape[0]
    ncol, pitch = a["ncol"], a["pitch"]
    n_planes = 0 if c["clipd"] is None else c["clipd"].shape[2]
    assert ncol == 23 + 3 * n_planes
    assert pitch == {23: 24, 26: 28, 32: 32}[ncol] == cuda_tiled.row_pitch(
        ncol)
    stream = to_np(a["stream"])
    table = to_np(a["full_rows"])
    assert stream.shape[1] == pitch == table.shape[1]
    assert not stream[:, ncol:].any() and not table[:, ncol:].any()

    # The row table and every live stream row, column for column.
    ref_rows = _reference_rows(setup, t)
    np.testing.assert_array_equal(table[:, :ncol].view(np.int32),
                                  ref_rows.view(np.int32))
    starts, counts, leftn = (to_np(a[k]) for k in ("starts", "counts",
                                                   "leftn"))
    live = np.zeros(stream.shape[0], bool)
    for s, n in zip(starts, counts):
        live[s:s + n] = True
    live[a["gbase"]:a["gbase"] + leftn[0]] = True
    live[a["sbase"]:a["sbase"] + leftn[1]] = True
    ids = stream[live, 22].astype(np.int64)
    np.testing.assert_array_equal(stream[live, :ncol].view(np.int32),
                                  ref_rows[ids].view(np.int32))
    assert not (stream[~live, 17].astype(np.int32) & 8).any()   # dead rows

    # Ranges, leftover counts and statistics.
    counts_r, leftn_r = _reference_bins(c, setup, **caps)
    np.testing.assert_array_equal(
        counts.reshape(a["tiles_y"], a["tiles_x"]), counts_r)
    np.testing.assert_array_equal(leftn, leftn_r)
    np.testing.assert_array_equal(
        starts[counts > 0],
        (np.cumsum(counts) - counts)[counts > 0])
    np.testing.assert_array_equal(to_np(a["binstats"]), st_r)


@pytest.mark.parametrize("wrapper", ["solve_tiled_kernel",
                                     "solve_fetch_kernel"])
def test_kernel_wrappers_refuse_a_cpu_stream(wrapper):
    """The kernels' wrappers launch or raise: a CPU stream (the plain
    version's input, which only ``solve_phase_b`` dispatches) is refused
    before anything is built, and no launch is counted."""
    c = CASES["clip_planes_1"]
    setup_t, defer, vp, xyw = _port_inputs("clip_planes_1")
    a = cuda_tiled.phase_a(setup_t, defer, vp, xyw, c["h"], c["w"],
                           **c["caps"])
    fn = getattr(cuda_tiled, wrapper)
    args = (a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
            a["sbase"], vp, c["w"], c["h"],
            torch.ones((a["tiles_y"] * TILE, a["tiles_x"] * TILE)), TILE,
            a["tiles_x"], a["tiles_y"], a["n_planes"], True)
    if wrapper == "solve_fetch_kernel":
        args += (torch.zeros((c["xyw"].shape[0], 16), dtype=torch.int32),)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA f32"):
        fn(*args, kchunk=KCHUNK)
    assert fn.launches == before


def _words(t, wq, seed):
    words = np.random.default_rng(seed).integers(-2**31, 2**31, (t, wq),
                                                 dtype=np.int64)
    words[:, 3] = np.int64(0x7FC00001 - 2**32)      # a float NaN pattern
    words[:, 5] = 1                                 # a float denormal
    return words.astype(np.int32)


@pytest.mark.parametrize("caps", [
    dict(max_span=2, span2=4, g_cap=16, slab_cap=64),
    dict(max_span=2, span2=4, pair_cap=32)], ids=["leftovers", "pair_cap"])
def test_remainder_and_refetch_read_the_padded_table(caps):
    """One clip plane (26 logical columns at pitch 28), caps so small that
    the all-tiles remainder runs and changes winners: the remainder cuts
    the logical columns out of the padded rows, the e-planes are recomputed
    from the padded table and the shade rows fetched again; ids and rows
    equal the reference's fused fetch."""
    c = CASES["clip_planes_1"]
    setup, _ref = _reference("clip_planes_1")
    setup_t, defer, vp, xyw = _port_inputs("clip_planes_1")
    t = c["xyw"].shape[0]
    tbl = _words(t, 16, 5)
    kw = dict(c["caps"], **caps)
    ref = depth_reduce_tiled_pallas(
        {k: jnp.asarray(v) for k, v in setup.items()}, jnp.ones(t, bool),
        1.0, jnp.asarray(c["viewport"], jnp.float32), jnp.asarray(c["xyw"]),
        c["h"], c["w"], interpret=True, want_eplanes=True,
        want_binstats=True, shade_tbl=jnp.asarray(tbl), sh_pack=2, **kw)
    bi_r, bd_r, st_r, ep_r, rows_r = (np.asarray(a) for a in ref)
    got = cuda_tiled.depth_reduce_tiled_cuda(
        setup_t, defer, 1.0, vp, xyw, c["h"], c["w"], want_eplanes=True,
        want_binstats=True, shade_tbl=torch.as_tensor(tbl), **kw)
    bi_g, bd_g, st_g, ep_g, rows_g = (to_np(a) for a in got)
    assert st_g[2:5].sum() > 0                  # a remainder ran
    np.testing.assert_array_equal(st_g, st_r)
    np.testing.assert_array_equal(bi_g, bi_r)
    np.testing.assert_array_equal(rows_g, rows_r)
    assert_depth_close(bd_g, bd_r, bi_r, setup)
    assert_eplanes_close(ep_g, ep_r, bi_r, setup)
    # The kernel-sized part alone would have given other winners.
    a = cuda_tiled.phase_a(setup_t, defer, vp, xyw, c["h"], c["w"], **kw)
    init = cuda_tiled._init_plane(1.0, c["h"], c["w"], a["tiles_y"] * TILE,
                                  a["tiles_x"] * TILE, "cpu")
    part = cuda_tiled.solve_phase_b_plain(
        a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
        a["sbase"], vp, c["w"], c["h"], init, TILE, a["tiles_x"],
        a["tiles_y"], a["n_planes"], False)[1][:c["h"], :c["w"]]
    assert (to_np(part) != bi_g).any()


@pytest.mark.parametrize("caps", [{}, dict(max_span=2, span2=4, g_cap=16,
                                          slab_cap=64, pair_cap=64)],
                         ids=["caps", "remainder"])
@pytest.mark.parametrize("name", BANDS)
def test_band_solve(name, caps):
    """A band of a frame: phase A's ranges from row0 equal to the brute
    force binning (every triangle whose bbox ends on the band's top edge
    or on a tile edge lands where it must); ids equal to the reference's
    XLA solve with ``row0``, depths within the bounds of
    ``assert_depth_close``; ids, depths and e-planes equal to the same rows
    of the port's unbanded solve bit for bit."""
    c = CASES[name]
    row0, h, w = c["row0"], c["h"], c["w"]
    setup, _ = _reference(name)
    setup_t, defer, vp, xyw = _port_inputs(name)
    kw = dict(c["caps"], **caps)
    if not caps:                    # (pair_cap cuts are not brute-forced)
        a = cuda_tiled.phase_a(setup_t, defer, vp, xyw, h, w, row0=row0,
                               **kw)
        counts_r, leftn_r = _reference_bins(c, setup, **kw)
        np.testing.assert_array_equal(
            to_np(a["counts"]).reshape(a["tiles_y"], a["tiles_x"]),
            counts_r)
        np.testing.assert_array_equal(to_np(a["leftn"]), leftn_r)
    got = cuda_tiled.depth_reduce_tiled_cuda(
        setup_t, defer, 1.0, vp, xyw, h, w, want_eplanes=True,
        want_binstats=True, row0=row0, **kw)
    whole = cuda_tiled.depth_reduce_tiled_cuda(
        setup_t, defer, 1.0, vp, xyw, c["frame_h"], w, want_eplanes=True,
        **kw)
    rows = slice(row0, row0 + h)
    assert torch.equal(got[0], whole[0][rows])
    assert torch.equal(got[1], whole[1][rows])
    assert torch.equal(got[3], whole[3][:, rows])
    if caps:
        assert to_np(got[2])[2:5].sum() > 0       # a remainder ran
    bi_r, bd_r, _peak = depth_reduce_tiled(
        {k: jnp.asarray(v) for k, v in setup.items()},
        jnp.ones(xyw.shape[0], bool), 1.0,
        jnp.asarray(c["viewport"], jnp.float32), jnp.asarray(c["xyw"]), h,
        w, tile=TILE, row0=float(row0))
    bi_g = to_np(got[0])
    np.testing.assert_array_equal(bi_g, np.asarray(bi_r))
    assert_depth_close(to_np(got[1]), np.asarray(bd_r), bi_g, setup)
    assert (bi_g >= 0).mean() > 0.1
