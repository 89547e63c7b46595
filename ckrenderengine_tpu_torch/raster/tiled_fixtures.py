"""Inputs that stress the tiled solve's kernel design (numpy, from a seed).

The CPU tests (against the reference's solve) and ``chip_smoke.py`` (kernels
B1 and B5 against their plain version on the card) share these cases. Each
aims at something the streaming kernel of ``csrc/solve_tiled.cu`` can get
wrong: a tile range that wraps the shared-memory ring many times next to
empty tiles, ranges that are exact multiples of the chunk, tiles with no
range of their own while both leftover segments are nonzero, row pitches of
28 and 32 floats (1 and 3 clip planes), rects and a viewport whose edges fall
on and beside the boundaries of a thread's 4-pixel block, and a frame that is
no multiple of the tile.

:func:`tiled_cases` returns dicts with ``name``, the triangles ``xyw``
(T,3,3) and ``z`` (T,3), optional ``clipd`` (T,3,P) and ``clip_rect`` (T,4),
the frame ``h``/``w``, the ``viewport``, the solve's ``caps`` and ``expect``,
what :func:`check_expect` holds phase A's result to so that a case keeps
exercising what it was built for. :func:`band_cases` are bands of a frame:
the same keys and ``row0`` / ``frame_h``.
"""

from __future__ import annotations

import numpy as np


def _pack(pts, rng):
    """Screen points (T,3,2) -> homogeneous (xyw, z) with random w and
    clip z in [0, w]."""
    t = pts.shape[0]
    w = rng.uniform(0.5, 2.0, (t, 3, 1)).astype(np.float32)
    xyw = np.concatenate([pts.astype(np.float32) * w, w], axis=-1)
    z = rng.uniform(0.05, 0.95, (t, 3)).astype(np.float32) * w[:, :, 0]
    return xyw, z


def _tris_in_box(rng, n, x0, y0, x1, y1, rad=3.0):
    """``n`` triangles whose vertices all lie inside the pixel box (so each
    bins into the tile that holds the box and no other)."""
    ctr = rng.uniform([x0 + rad + 0.5, y0 + rad + 0.5],
                      [x1 - rad - 0.5, y1 - rad - 0.5], (n, 1, 2))
    ang = (rng.uniform(0, 2 * np.pi, (n, 1))
           + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.5, 0.5, (n, 3)))
    r = rng.uniform(0.5 * rad, rad, (n, 3))
    return ctr + np.stack([np.cos(ang) * r, np.sin(ang) * r], -1)


def _tris_anywhere(rng, n, h, w, rad):
    ctr = rng.uniform([0, 0], [w, h], (n, 1, 2))
    ang = rng.uniform(0, 2 * np.pi, (n, 3))
    r = rng.uniform(rad[0], rad[1], (n, 3))
    return ctr + np.stack([np.cos(ang) * r, np.sin(ang) * r], -1)


def _tile_box(ty, tx, tile):
    return tx * tile, ty * tile, (tx + 1) * tile, (ty + 1) * tile


def _case(name, pts, rng, h, w, viewport=None, caps=None, expect=None,
          clip_rect=None, planes=0):
    xyw, z = _pack(pts, rng)
    t = xyw.shape[0]
    return dict(
        name=name, xyw=xyw, z=z, h=h, w=w,
        viewport=[0.0, 0.0, float(w), float(h)] if viewport is None
        else viewport,
        clipd=(rng.uniform(-1, 1, (t, 3, planes)).astype(np.float32)
               if planes else None),
        clip_rect=clip_rect, caps=caps or {}, expect=expect or {})


def tiled_cases(tile: int = 32, kchunk: int = 128, deep: int = 3000,
                seed: int = 21) -> list[dict]:
    """The cases at a tile size, a chunk size and a depth of the deep tile.
    The card run takes the frame's own (32, 128, a few thousand); the CPU
    tests a small (16, 32, a few hundred), which the reference's interpreted
    kernel can stream."""
    out = []
    caps = dict(tile=tile, kchunk=kchunk)

    # A deep tile beside empty ones: `deep` rows wrap the ring many times.
    rng = np.random.default_rng(seed)
    h, w = 3 * tile, 4 * tile
    pts = np.concatenate([
        _tris_in_box(rng, deep, *_tile_box(1, 1, tile)),
        _tris_in_box(rng, 40, *_tile_box(2, 3, tile))])
    out.append(_case("deep_tile", pts, rng, h, w, caps=caps, expect=dict(
        counts_at={(1, 1): deep, (2, 3): 40, (0, 0): 0, (1, 2): 0})))

    # Ranges that are exact multiples of the chunk, one above, one below.
    rng = np.random.default_rng(seed + 1)
    want = {(0, 1): 2 * kchunk, (1, 2): kchunk, (2, 0): kchunk + 1,
            (2, 2): kchunk - 1}
    pts = np.concatenate([_tris_in_box(rng, n, *_tile_box(ty, tx, tile))
                          for (ty, tx), n in want.items()])
    out.append(_case("chunk_multiples", pts, rng, h, w, caps=caps,
                     expect=dict(counts_at={**want, (0, 0): 0})))

    # Tiles with no range of their own; both leftover segments nonzero: the
    # slab takes 64 of the 150 small triangles (the rest overflow into the
    # second segment) and five frame-sized triangles make the global class.
    rng = np.random.default_rng(seed + 2)
    h4 = w4 = 4 * tile
    big = np.array([[[-20.0, -30.0], [w4 * 2.2, -10.0], [-25.0, h4 * 2.1]]])
    big = big + rng.uniform(-8, 8, (5, 3, 2))
    pts = np.concatenate([
        _tris_in_box(rng, 80, *_tile_box(0, 0, tile)),
        _tris_in_box(rng, 70, *_tile_box(0, 1, tile)), big])
    out.append(_case(
        "empty_tiles_leftovers", pts, rng, h4, w4,
        caps=dict(caps, max_span=2, span2=4, g_cap=128, slab_cap=64),
        expect=dict(leftovers=True, empty_tiles=True)))

    # Row pitches 28 and 32: one and three user clip planes.
    for planes in (1, 3):
        rng = np.random.default_rng(seed + 3 + planes)
        hp, wp = 3 * tile + tile // 4, 5 * tile - tile // 4
        pts = _tris_anywhere(rng, 40 * (tile // 8) ** 2, hp, wp,
                             (tile / 16, 2.0 * tile))
        out.append(_case(f"clip_planes_{planes}", pts, rng, hp, wp,
                         caps=caps, planes=planes, expect=dict(
                             pitch=28 if planes == 1 else 32)))

    # Rects whose edges fall on and half a pixel beside the boundaries of
    # the 4-pixel blocks (x) and of 1-, 2- and 4-row blocks (y).
    rng = np.random.default_rng(seed + 7)
    n = 30 * (tile // 8) ** 2
    pts = _tris_anywhere(rng, n, h, w, (tile / 2, 2.5 * tile))
    half = np.array([-0.5, 0.0, 0.5])
    x0 = 4 * rng.integers(0, w // 8, n) + rng.choice(half, n)
    x1 = x0 + 4 * rng.integers(1, w // 8, n) + rng.choice(half, n)
    y0 = 2 * rng.integers(0, h // 4, n) + rng.choice(half, n)
    y1 = y0 + 2 * rng.integers(1, h // 4, n) + rng.choice(half, n)
    rect = np.stack([x0, y0, x1, y1], 1).astype(np.float32)
    out.append(_case("block_edge_rects", pts, rng, h, w, caps=caps,
                     clip_rect=rect))

    # A frame that is no multiple of the tile, under a viewport that cuts
    # 4-pixel blocks in two on the left and on the right.
    rng = np.random.default_rng(seed + 8)
    hc, wc = 6 * tile + tile // 4, 9 * tile + 3 * tile // 8
    pts = _tris_anywhere(rng, 30 * (tile // 8) ** 2, hc, wc,
                         (tile / 16, 2.0 * tile))
    out.append(_case("cut_viewport", pts, rng, hc, wc, caps=caps,
                     viewport=[9.5, 7.0, wc - 48.0, hc - 29.0]))
    return out


def edge_tris(rng, edges, w, n=6):
    """Triangles with integer vertices and w = 1 (so that their bboxes are
    exact) whose bboxes end exactly on the rows ``edges``: per edge ``n``
    above it (y1 == edge) and ``n`` below it (y0 == edge), at random
    columns, each in both windings. Returns (xyw (T,3,3), z (T,3))."""
    pts = []
    for e in edges:
        for sign in (-1, 1):
            x = rng.integers(2, w - 14, n)[:, None] + np.array([0, 9, 4])
            dy = rng.integers(1, 9, (n, 2))
            y = np.stack([np.full(n, e), e + sign * dy[:, 0],
                          e + sign * dy[:, 1]], 1)
            tri = np.stack([x, y], -1).astype(np.float32)
            pts += [tri, tri[:, ::-1]]
    pts = np.concatenate(pts)
    t = pts.shape[0]
    xyw = np.concatenate([pts, np.ones((t, 3, 1), np.float32)], -1)
    return xyw, rng.uniform(0.05, 0.95, (t, 3)).astype(np.float32)


def band_cases(tile: int = 32, kchunk: int = 128,
               seed: int = 41) -> list[dict]:
    """Bands of a frame (a solve at a row offset): each case is the band of
    ``h`` rows from global row ``row0`` of a ``frame_h``-row frame, with the
    triangles, rects and viewport in global rows. Random triangles cover
    the whole frame (most of them miss the band), and :func:`edge_tris`
    end exactly on the band's edges and on its tile edges, so that phase
    A's binning after the row0 subtraction is shown to stay conservative.
    ``band_mid`` starts off the tile grid, is no multiple of the tile and
    has a viewport that ends inside the band; ``band_plane`` is tile-aligned
    with one clip plane (pitch 28)."""
    out = []
    caps = dict(tile=tile, kchunk=kchunk)
    w = 4 * tile + tile // 4
    for k, (name, row0, h, planes) in enumerate((
            ("band_mid", 3 * tile + 8, 2 * tile + tile // 2, 0),
            ("band_plane", 4 * tile, 3 * tile, 1))):
        rng = np.random.default_rng(seed + k)
        frame_h = row0 + h + 2 * tile
        pts = _tris_anywhere(rng, 24 * (tile // 8) ** 2, frame_h, w,
                             (tile / 16, 1.5 * tile))
        xyw, z = _pack(pts, rng)
        xe, ze = edge_tris(rng, (row0, row0 + tile, row0 + 2 * tile,
                                 row0 + h), w)
        xyw, z = np.concatenate([xyw, xe]), np.concatenate([z, ze])
        t = xyw.shape[0]
        viewport = ([3.5, 0.0, w - 9.0, row0 + h - 6.0] if planes == 0
                    else [0.0, 0.0, float(w), float(frame_h)])
        out.append(dict(
            name=name, xyw=xyw, z=z, h=h, w=w, row0=row0, frame_h=frame_h,
            viewport=viewport,
            clipd=(rng.uniform(-1, 1, (t, 3, planes)).astype(np.float32)
                   if planes else None),
            clip_rect=None, caps=caps, expect={}))
    return out


def check_expect(case: dict, a: dict) -> None:
    """Hold phase A's result ``a`` (``cuda_tiled.phase_a``) to what the case
    was built for; raises AssertionError otherwise."""
    exp = case["expect"]
    counts = a["counts"].reshape(a["tiles_y"], a["tiles_x"]).cpu().numpy()
    stats = a["binstats"].cpu().numpy()

    def hold(cond, *what):
        if not cond:
            raise AssertionError((case["name"],) + what)

    for (ty, tx), n in exp.get("counts_at", {}).items():
        hold(counts[ty, tx] == n, "tile", (ty, tx), "rows",
             int(counts[ty, tx]), "expected", n)
    if exp.get("leftovers"):
        leftn = a["leftn"].cpu().numpy()
        hold((leftn > 0).all(), "leftover rows", leftn.tolist())
        hold((stats[2:5] == 0).all(), "a remainder loop ran", stats.tolist())
    if exp.get("empty_tiles"):
        hold((counts == 0).sum() >= counts.size // 2, "empty tiles",
             counts.tolist())
    if "pitch" in exp:
        hold(a["pitch"] == exp["pitch"] == a["stream"].shape[1], "pitch",
             a["pitch"])
