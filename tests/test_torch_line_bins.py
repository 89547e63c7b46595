"""L1's bin step on the CPU: ``line_bins_plain``, the plain version the bin
kernel (``csrc/lines.cu`` ``line_bins_kernel``) equals on the card, on the
seeded banks of ``tests/test_torch_lines.py`` (5, 40 and 300 segments with
degenerate, behind-camera and pad rows, a row offset, a frame at twice the
size) and on made rows: endpoints 3.7e6 px off screen, a diagonal across
the frame, a segment whose endpoints both lie off screen, a NaN alpha,
infinite and NaN coordinates, a fan of segments through one tile.

Each case checks two things:
- the bins are conservative: every (tile, segment) pair in which
  ``line_coverage`` covers a pixel of the tile, with zb = inf and the
  depths moved into [0, 1] (so that only the distance test decides), has
  the segment's bit in the tile's words;
- the binned walk is exact: a composite that takes, for each pixel, only
  the segments of its tile's bin equals ``draw_lines_plain`` bit for bit
  (a NaN equal to a NaN).
"""

import math

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch.pipeline import lines as tl
from tests.test_torch_lines import CASES, _inputs, _Scene


def _seeded_rows(seed, n, h, w, vps):
    scene, world, bank, fb, zb = _inputs(seed, n, h, w, vps)
    tscene = _Scene(**{k: torch.as_tensor(v) for k, v in scene.items()})
    tbank = tl.LineBank(**{k: torch.as_tensor(v) for k, v in bank.items()})
    rows = tl.line_rows(tscene, torch.as_tensor(world), tbank)
    return rows, torch.as_tensor(fb), torch.as_tensor(zb)


def _made_rows(seed, h, w, row0, fan=0):
    """Seeded rows at h x w in the frame's rows [row0, row0 + h): 60 short
    segments (every 13th with an endpoint 3.7e6 px away, every 9th
    degenerate), the special rows, ``fan`` segments through one tile, 8 pad
    rows."""
    rng = np.random.default_rng(seed)
    n = 60
    rows = np.zeros((n, 12), np.float32)
    a = rng.uniform(-0.1, 1.1, (n, 2)) * (w, h) + (0.0, row0)
    rows[:, 0:2] = a
    rows[:, 2:4] = a + rng.normal(0.0, 15.0, (n, 2))
    rows[::9, 2:4] = rows[::9, 0:2]
    rows[1::13, 2:4] = rows[1::13, 0:2] * 3.7e6
    rows[:, 4:6] = rng.uniform(-0.1, 1.1, (n, 2))
    rows[:, 6] = 1.0
    rows[1::26, 6] = 0.0
    rows[:, 8:12] = rng.uniform(0.0, 1.0, (n, 4))
    nan, inf = float("nan"), float("inf")
    special = np.array([
        # NaN alpha, across the frame's middle
        [0.2 * w, 0.3 * h, 0.8 * w, 0.35 * h, 0.1, 0.2, 1, 0, .9, .1, .1,
         nan],
        # the diagonal across the whole frame
        [0.0, 0.0, w, h, 0.15, 0.25, 1, 0, .1, .9, .1, .7],
        # both endpoints off screen, through it
        [-0.5 * w, 0.6 * h, 1.5 * w, 0.45 * h, 0.1, 0.1, 1, 0, .1, .1, .9,
         .6],
        # infinite and NaN coordinates: no pixel
        [inf, 3.0, 5.0, 6.0, 0.1, 0.1, 1, 0, .5, .5, .5, .5],
        [2.0, -inf, 5.0, 6.0, 0.1, 0.1, 1, 0, .5, .5, .5, .5],
        [nan, 3.0, 5.0, 6.0, 0.1, 0.1, 1, 0, .5, .5, .5, .5],
        [4.0, 3.0, 5.0, nan, 0.1, 0.1, 1, 0, .5, .5, .5, .5],
    ], np.float32)
    special[:, 1] += row0
    special[:, 3] += row0
    parts = [rows, special]
    if fan:
        th = np.arange(fan) * (2 * math.pi / fan) + 0.01
        r = rng.uniform(6.0, 16.0, fan)[:, None]
        c = np.array([0.55 * w, 0.55 * h + row0])
        u = np.stack([np.cos(th), np.sin(th)], 1)
        f = np.zeros((fan, 12), np.float32)
        f[:, 0:2] = c - r * u
        f[:, 2:4] = c + r * u
        f[:, 4:6] = rng.uniform(0.0, 0.4, (fan, 2))
        f[:, 6] = 1.0
        f[:, 8:12] = rng.uniform(0.0, 1.0, (fan, 4))
        parts.append(f)
    parts.append(np.zeros((8, 12), np.float32))
    fb = rng.uniform(0.0, 1.0, (4, h, w)).astype(np.float32)
    zb = rng.uniform(0.4, 1.0, (h, w)).astype(np.float32)
    return (torch.as_tensor(np.concatenate(parts)), torch.as_tensor(fb),
            torch.as_tensor(zb))


def _hits(bins, n_rows):
    """(tiles, L) bool from the (tiles, words) int32 bins."""
    bits = (bins[..., None] >> torch.arange(32)) & 1
    return bits.reshape(bins.shape[0], -1)[:, :n_rows].bool()


def _per_tile(cov, h, w):
    """(L, H, W) bool -> (tiles, L): whether a segment covers a pixel of
    each 32x8 tile (row-major tiles)."""
    ty, tx = -(-h // tl.TILE_H), -(-w // tl.TILE_W)
    pad = torch.nn.functional.pad(cov, (0, tx * tl.TILE_W - w,
                                        0, ty * tl.TILE_H - h))
    t = pad.reshape(cov.shape[0], ty, tl.TILE_H, tx, tl.TILE_W).any(4).any(2)
    return t.reshape(cov.shape[0], -1).T


def _binned_walk(fb, zb, rows, h, w, row0, hits):
    """The line pass over each pixel's tile's bin only: the highest
    covering index's rgb, the maximum of the alphas."""
    ty = torch.arange(h) // tl.TILE_H
    tx = torch.arange(w) // tl.TILE_W
    tiles = ty[:, None] * (-(-w // tl.TILE_W)) + tx[None]
    allowed = hits[tiles].permute(2, 0, 1)
    cov = tl.line_coverage(rows, zb, h, w, row0=row0) & allowed
    k = torch.arange(rows.shape[0])[:, None, None]
    last = torch.where(cov, k, -1).amax(0)
    sel = rows[:, 8:11].index_select(0, last.clamp(min=0).reshape(-1))
    rgb = torch.where((last >= 0)[None], sel.T.reshape(3, h, w), fb[:3])
    alpha = torch.maximum(fb[3], torch.where(
        cov, rows[:, 11, None, None], -torch.inf).amax(0))
    return torch.cat([rgb, alpha[None]])


def _bit_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a.view(torch.int32)[~na], b.view(torch.int32)[~nb])


MADE = [
    # (name, seed, h, w, row0, fan)
    ("far_and_special", 11, 72, 96, 0.0, 0),
    ("special_row0_odd_width", 12, 50, 98, 577.0, 0),
    ("special_2x", 13, 144, 192, 8.0, 0),
    ("fan_2100", 14, 40, 64, 0.0, 2100),
]


def _case(kind, params):
    if kind == "seeded":
        _name, seed, n, h, w, row0, vps = params
        return _seeded_rows(seed, n, h, w, vps) + (h, w, row0)
    _name, seed, h, w, row0, fan = params
    return _made_rows(seed, h, w, row0, fan) + (h, w, row0)


ALL = [("seeded", c) for c in CASES] + [("made", c) for c in MADE]


@pytest.mark.parametrize("kind,params", ALL, ids=[c[0] for _k, c in ALL])
def test_bins_conservative_and_binned_walk_exact(kind, params):
    rows, fb, zb, h, w, row0 = _case(kind, params)
    n = rows.shape[0]
    bins = tl.line_bins_plain(rows, h, w, row0)
    assert bins.dtype == torch.int32
    assert tuple(bins.shape) == tl.bin_shape(n, h, w)
    hits = _hits(bins, n)
    # Conservative: depths in [0, 1] and zb = inf leave the distance test.
    flat = rows.clone()
    flat[:, 4:6] = 0.5
    inf = torch.full((h, w), torch.inf)
    covered = _per_tile(tl.line_coverage(flat, inf, h, w, row0=row0), h, w)
    missing = covered & ~hits
    assert not missing.any(), missing.nonzero()[:5]
    assert covered.sum() > 0, "the rows must cover pixels"
    # Rows that are invalid or have a non-finite coordinate have no bit.
    dead = (rows[:, 6] <= 0.5) | ~torch.isfinite(rows[:, :4]).all(1)
    assert not hits[:, dead].any()
    # Exact: the walk over the bins is the line pass.
    want = tl.draw_lines_plain(fb, zb, rows, h, w, row0=row0)
    got = _binned_walk(fb, zb, rows, h, w, row0, hits)
    assert _bit_equal(got, want)
    print(f"{params[0]}: {int(hits.sum())} bin entries of "
          f"{int((~dead).sum()) * hits.shape[0]} pairs, "
          f"{int(covered.sum())} pairs covered, "
          f"{int((want != fb).any(0).sum())} pixels changed")
    if kind == "made":
        # The NaN alpha reaches the frame; the diagonal keeps only the
        # tiles along it, not its whole box (every tile of the frame).
        assert torch.isnan(want[3]).any()
        tiles_x, tiles_y = -(-w // tl.TILE_W), -(-h // tl.TILE_H)
        n_diag = int(hits[:, 61].sum())
        assert n_diag < hits.shape[0] and n_diag <= 2 * (tiles_x + tiles_y)
        if params[-1]:
            assert int(hits.sum(1).max()) >= params[-1]


def test_bins_of_an_empty_bank_and_refusals():
    bins = tl.line_bins_plain(torch.zeros((0, tl.ROW_FLOATS)), 24, 40)
    assert tuple(bins.shape) == (3 * 2, 0)
    with pytest.raises(ValueError):
        tl.line_bins_kernel(torch.zeros((8, tl.ROW_FLOATS)), 24, 40)
