"""Inputs that stress the ordered kernels' design (numpy, from a seed).

The CPU tests (phase A and the plain versions of B3 and B4 against the
reference) and ``chip_smoke.py`` (kernels B3 and B4 against their plain
versions on the card, at tiles of 16 and 32) share these cases. Besides
the reference fixtures' random and bounded batches, each aims at something
the streaming kernels of ``csrc/ordered_blend.cu`` and
``csrc/ordered_peel.cu`` can get wrong: a tile range deeper than the
shared-memory ring beside empty tiles and ranges that are exact multiples
of the chunk, row heads of 28 and 36 floats (1 and 3 clip planes), rects
and a viewport on and beside the edges of a thread's 4-pixel block, a frame
that is no multiple of the tile, colorwrite-off and alpha-tested states
(every case draws from six states), and peel stacks deeper than two rounds
of K = 4 layers (pixels where the scan's exactness decides ``cnt`` and
``ovf``), besides a phase-A overflow.

:func:`ordered_cases` returns dicts with ``name``, the batch ``fields``
(``xyw`` (T,3,3), ``z``, ``valid``, ``color``, ``specular``, ``uv``,
``fog``, ``state_idx``, ``clip_rect``, ``clipd`` (T,3,P), ``refl``), the
states ``si``/``sf``, the frame ``h``/``w``, the opaque depth ``zb``, the
``viewport``, the ``fog_color``, ``windows`` (None: the default span
classes), ``bad`` (the phase-A overflow the case expects), the peel
``skips`` and ``expect``, what :func:`check_expect` holds phase A's result
to so that a case keeps exercising what it was built for.
:func:`band_cases` are bands of a frame (B3 and B4 at a row offset): the
same keys and ``row0`` / ``frame_h`` / ``zb_frame``.
"""

from __future__ import annotations

import numpy as np

from .types import VXBLEND, VXCMP, VXCULL, RasterState, pack_states

FIELDS = ("xyw", "z", "valid", "color", "specular", "uv", "fog", "state_idx",
          "clip_rect", "clipd")


def states():
    """(si, sf) of the cases' six states: alpha-over with fog, replace,
    alpha-over under an alpha test (GREATER 0.35), replace under an alpha
    test (LESSEQUAL 0.6), alpha-over with colorwrite off, and alpha-over
    without perspective weights under a LESS z test."""
    over = dict(alpha_blend=True, src_blend=int(VXBLEND.SRCALPHA),
                dst_blend=int(VXBLEND.INVSRCALPHA), z_write=False,
                cull=int(VXCULL.NONE))
    return pack_states([
        RasterState(**over, fog=True),
        RasterState(z_write=False, cull=int(VXCULL.NONE)),
        RasterState(**over, alpha_test=True, alpha_func=int(VXCMP.GREATER),
                    alpha_ref=0.35),
        RasterState(z_write=False, cull=int(VXCULL.NONE), alpha_test=True,
                    alpha_func=int(VXCMP.LESSEQUAL), alpha_ref=0.6),
        RasterState(**over, color_write=False),
        RasterState(**over, perspective=False, z_func=int(VXCMP.LESS))])


N_STATES = 6


def random_tris(t, h, w, seed, big_frac=0.1):
    """tests/test_tiled_raster._random_batch: screen-space triangles as
    homogeneous (x*w', y*w', w') with clip z."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([0, 0], [w, h], (t, 2)).astype(np.float32)
    sizes = rng.uniform(2, 25, (t, 1)).astype(np.float32)
    big = rng.random(t) < big_frac
    sizes[big] = rng.uniform(100, 400, (big.sum(), 1)).astype(np.float32)
    offs = rng.normal(0, 1, (t, 3, 2)).astype(np.float32)
    pts = centers[:, None] + offs * sizes[:, None]
    ws = rng.uniform(0.5, 4.0, (t, 3, 1)).astype(np.float32)
    return (np.concatenate([pts * ws, ws], axis=-1),
            rng.uniform(0.05, 0.95, (t, 3)).astype(np.float32))


def bounded_tris(seed, h, w, layers=3, spacing=16, rad=6.0):
    """tests/test_pallas_peel._bounded_batch: grid-placed small triangles
    in ``layers`` passes (per-pixel ordered depth <= layers)."""
    rng = np.random.default_rng(seed)
    pts = []
    for _layer in range(layers):
        for cy in range(spacing // 2, h, spacing):
            for cx in range(spacing // 2, w, spacing):
                ang = rng.uniform(0, 2 * np.pi, 3)
                r = rng.uniform(rad * 0.5, rad, 3)
                jx, jy = rng.uniform(-2, 2, 2)
                pts.append(np.stack([cx + jx + np.cos(ang) * r,
                                     cy + jy + np.sin(ang) * r], -1))
    pts = np.asarray(pts, np.float32)
    return _homogeneous(pts, rng, 0.05, 0.5)


def _homogeneous(pts, rng, z0=0.05, z1=0.95):
    """Screen points (T,3,2) -> (xyw, z) with random w and z in [z0, z1]."""
    t = pts.shape[0]
    wgt = rng.uniform(0.5, 2.0, (t, 3, 1)).astype(np.float32)
    return (np.concatenate([pts.astype(np.float32) * wgt, wgt], -1),
            rng.uniform(z0, z1, (t, 3)).astype(np.float32))


def _tris_in_box(rng, n, x0, y0, x1, y1, rad=3.0):
    """``n`` triangles whose vertices all lie inside the pixel box (so each
    bins into the tile that holds the box and no other)."""
    ctr = rng.uniform([x0 + rad + 0.5, y0 + rad + 0.5],
                      [x1 - rad - 0.5, y1 - rad - 0.5], (n, 1, 2))
    ang = (rng.uniform(0, 2 * np.pi, (n, 1))
           + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.5, 0.5, (n, 3)))
    r = rng.uniform(0.5 * rad, rad, (n, 3))
    return ctr + np.stack([np.cos(ang) * r, np.sin(ang) * r], -1)


def _tile_box(ty, tx, tile):
    return tx * tile, ty * tile, (tx + 1) * tile, (ty + 1) * tile


def _fields(xyw, z, rng, h, w, rects=0.2, planes=0, n_states=N_STATES,
            valid=0.9):
    """Per-triangle fields of an ordered batch around (xyw, z), drawn from
    ``rng`` in the reference fixtures' order; ``rects`` of the triangles
    get a scissor inside the frame."""
    t = xyw.shape[0]
    fx = dict(xyw=xyw, z=z,
              color=rng.uniform(0, 1, (t, 3, 4)).astype(np.float32),
              specular=rng.uniform(0, 0.2, (t, 3, 3)).astype(np.float32),
              uv=rng.uniform(0, 1, (t, 3, 2)).astype(np.float32),
              fog=rng.uniform(0.3, 1, (t, 3)).astype(np.float32),
              state_idx=rng.integers(0, n_states, t).astype(np.int32),
              valid=rng.random(t) < valid)
    rect = np.tile(np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32), (t, 1))
    rect[rng.random(t) < rects] = [8.0, 6.0, w - 10.0, h - 8.0]
    fx["clip_rect"] = rect
    fx["clipd"] = (rng.uniform(-1, 1, (t, 3, planes)).astype(np.float32)
                   if planes else np.zeros((t, 3, 0), np.float32))
    fx["refl"] = np.zeros((t, 3, 0), np.float32)
    return fx


def _case(name, fx, h, w, rng, viewport=None, zb=None, windows=None,
          bad=False, skips=(0,), expect=None):
    si, sf = states()
    if zb is None:
        zb = rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
    return dict(name=name, fields=fx, si=si, sf=sf, h=h, w=w, zb=zb,
                viewport=[0.0, 0.0, float(w), float(h)] if viewport is None
                else [float(v) for v in viewport],
                fog_color=[0.2, 0.3, 0.4], windows=windows, bad=bad,
                skips=skips, expect=expect or {})


def _stack(n, size, seed):
    """``n`` large triangles over a ``size`` x ``size`` region, each shifted
    a little, drawn in turn: most pixels of the region are covered ``n``
    deep, those near the edges fewer."""
    rng = np.random.default_rng(seed)
    tri = np.array([[2.0, 2.0], [size - 2.0, 3.0], [3.0, size - 2.0]],
                   np.float32)
    pts = tri[None] + rng.uniform(-1.5, 1.5, (n, 3, 2)).astype(np.float32)
    xyw, z = _homogeneous(pts, rng, 0.1, 0.5)
    fx = _fields(xyw, z, rng, size, size, rects=0.0, valid=1.0)
    # States that write colour without an alpha test: every fragment
    # counts, so deep pixels really are deep.
    fx["state_idx"] = rng.choice(np.array([0, 1, 5], np.int32), n)
    return fx, rng


def _padded(fx, t):
    """The batch with invalid triangles appended up to ``t``: they never
    reach the stream, and cases of one frame size then share the shapes of
    the reference's compiled programs in the CPU tests."""
    n = t - fx["xyw"].shape[0]
    out = {}
    for k, v in fx.items():
        pad = np.zeros((n,) + v.shape[1:], v.dtype)
        if k == "clip_rect":
            pad[:] = [-1e9, -1e9, 1e9, 1e9]
        out[k] = np.concatenate([v, pad])
    return out


def ordered_cases(tile: int = 16, kchunk: int = 32, deep: int = 420,
                  seed: int = 31) -> list[dict]:
    """The cases at a tile size, the kernels' chunk size and the depth of
    the deep tile (more rows than the ring's 4 x ``kchunk``). All but the
    clip-plane, cut-viewport and overflow cases share one frame of 3 x 6
    tiles and one batch size."""
    h, w = 3 * tile, 6 * tile
    t_pad = 640
    out = []
    # The reference fixtures: random triangles (some with rects) over a
    # random opaque depth, and the bounded 3-layer peel batches.
    for s in (1, 4):
        xyw, z = random_tris(150, h, w, s)
        rng = np.random.default_rng(s)
        out.append(_case(f"random_seed{s}",
                         _padded(_fields(xyw, z, rng, h, w), t_pad), h, w,
                         rng))
    for s in (1, 7):
        xyw, z = bounded_tris(s, h, w)
        rng = np.random.default_rng(s + 50)
        out.append(_case(
            f"bounded_seed{s}",
            _padded(_fields(xyw, z, rng, h, w, rects=0.0), t_pad), h, w, rng,
            zb=rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)))

    # A deep tile beside empty ones: `deep` rows wrap the ring many times,
    # and its pixels are covered tens of fragments deep. Ranges that are
    # exact multiples of the chunk, one above and one below, in others.
    rng = np.random.default_rng(seed)
    want = {(1, 1): deep, (0, 1): 2 * kchunk, (1, 3): kchunk,
            (2, 0): kchunk + 1, (2, 2): kchunk - 1}
    pts = np.concatenate([_tris_in_box(rng, n, *_tile_box(ty, tx, tile))
                          for (ty, tx), n in want.items()])
    xyw, z = _homogeneous(pts, rng)
    out.append(_case(
        "deep_tile_chunk_multiples",
        _padded(_fields(xyw, z, rng, h, w, rects=0.0, valid=1.0), t_pad), h,
        w, rng, skips=(0, 4, 8), expect=dict(counts_at={
            **want, (0, 0): 0, (1, 2): 0, (0, 5): 0})))

    # Rects whose edges fall on and half a pixel beside the boundaries of
    # the 4-pixel blocks (x) and of 1- and 2-row steps (y), under a
    # viewport whose edges lie on block boundaries.
    rng = np.random.default_rng(seed + 7)
    xyw, z = random_tris(200, h, w, seed + 7)
    fx = _fields(xyw, z, rng, h, w, rects=0.0)
    n = xyw.shape[0]
    half = np.array([-0.5, 0.0, 0.5])
    x0 = 4 * rng.integers(0, w // 8, n) + rng.choice(half, n)
    x1 = x0 + 4 * rng.integers(1, w // 8, n) + rng.choice(half, n)
    y0 = 2 * rng.integers(0, h // 4, n) + rng.choice(half, n)
    y1 = y0 + 2 * rng.integers(1, h // 4, n) + rng.choice(half, n)
    fx["clip_rect"] = np.stack([x0, y0, x1, y1], 1).astype(np.float32)
    out.append(_case("block_edge_rects", _padded(fx, t_pad), h, w, rng,
                     viewport=[4.0, 2.0, w - 12.0, h - 5.0]))

    # Peel stacks deeper than two rounds of K = 4: 9 (the reference's
    # iterated-peel fixture) and 13 deep, peeled at skip 0, 4, 8 and 12.
    for n, s in ((9, 11), (13, 12)):
        fx, rng = _stack(n, 2 * tile, s)
        out.append(_case(f"stack{n}", _padded(fx, t_pad), h, w, rng,
                         zb=np.ones((h, w), np.float32),
                         skips=(0, 4, 8, 12), expect=dict(depth=n)))

    # Row heads of 28 and 36 floats: 1 and 3 user clip planes (every other
    # case has none: a 28-float head too, three of it padding).
    for planes in (1, 3):
        rng = np.random.default_rng(seed + 3 + planes)
        xyw, z = random_tris(150, h, w, seed + 3 + planes)
        out.append(_case(f"clip_planes_{planes}",
                         _fields(xyw, z, rng, h, w, planes=planes), h, w,
                         rng))

    # A frame that is no multiple of the tile, under a viewport that cuts
    # 4-pixel blocks in two on the left and on the right.
    rng = np.random.default_rng(seed + 8)
    hc, wc = 3 * tile + 5, 5 * tile + 3 * tile // 8 + 2
    xyw, z = random_tris(150, hc, wc, seed + 8)
    out.append(_case("cut_viewport", _fields(xyw, z, rng, hc, wc), hc, wc,
                     rng, viewport=[9.5, 7.0, wc - 30.0, hc - 21.0]))

    # Phase-A overflow: a one-class window of 40 one-tile slots.
    xyw, z = random_tris(40, h, w, 3)
    rng = np.random.default_rng(3)
    out.append(_case("overflow", _fields(xyw, z, rng, h, w), h, w, rng,
                     zb=np.ones((h, w), np.float32), windows=((40, 1),),
                     bad=True))
    return out


def band_cases(tile: int = 16, seed: int = 61) -> list[dict]:
    """Bands of a frame for the ordered kernels (B3 and B4 at a row
    offset): each case is the band of ``h`` rows from global row ``row0``
    of a ``frame_h``-row frame, with fields, rects and viewport in global
    rows; ``zb_frame`` is the whole frame's opaque depth and ``zb`` its
    band rows. Random triangles and peel stacks cover the whole frame and
    ``tiled_fixtures.edge_tris`` end exactly on the band's and its tiles'
    edges. ``band_stack`` puts a 9-deep stack across the band's top edge
    (peeled at skips 0, 4 and 8)."""
    from .tiled_fixtures import edge_tris

    out = []
    w = 5 * tile + 6
    for k, (name, row0, h) in enumerate((("band_random", 2 * tile + 5,
                                          2 * tile + 3),
                                         ("band_stack", 3 * tile,
                                          2 * tile))):
        rng = np.random.default_rng(seed + k)
        frame_h = row0 + h + tile + 7
        xyw, z = random_tris(150, frame_h, w, seed + k)
        xe, ze = edge_tris(rng, (row0, row0 + tile, row0 + h), w, n=4)
        parts = [(xyw, z), (xe, ze)]
        if name == "band_stack":
            sx = _stack(9, 2 * tile, seed + 5)[0]
            sx["xyw"][..., 1] += (row0 - tile) * sx["xyw"][..., 2]
            parts.append((sx["xyw"], sx["z"]))
        xyw = np.concatenate([p[0] for p in parts])
        z = np.concatenate([p[1] for p in parts])
        fx = _fields(xyw, z, rng, frame_h, w)
        zb = rng.uniform(0.3, 1.0, (frame_h, w)).astype(np.float32)
        case = _case(name, _padded(fx, 400), h, w, rng,
                     viewport=[4.0, 3.0, w - 9.0, row0 + h - 5.0],
                     zb=zb[row0:row0 + h],
                     skips=(0, 4, 8) if name == "band_stack" else (0,))
        case.update(row0=row0, frame_h=frame_h, zb_frame=zb)
        out.append(case)
    return out


def check_expect(case: dict, pa: dict, pitch: int) -> None:
    """Hold phase A's result ``pa`` (``cuda_ordered.phase_a``, rows of
    ``pitch`` floats) to what the case was built for; raises
    AssertionError otherwise."""
    exp = case["expect"]
    counts = pa["counts"].reshape(pa["tiles_y"], pa["tiles_x"]).cpu().numpy()

    def hold(cond, *what):
        if not cond:
            raise AssertionError((case["name"],) + what)

    hold(bool(pa["bad"]) == case["bad"], "bad", bool(pa["bad"]))
    hold(pa["stream"].shape[1] == pitch, "pitch", pa["stream"].shape[1])
    hold(pa["n_planes"] == case["fields"]["clipd"].shape[2], "planes")
    for (ty, tx), n in exp.get("counts_at", {}).items():
        hold(counts[ty, tx] == n, "tile", (ty, tx), "rows",
             int(counts[ty, tx]), "expected", n)
    if not case["bad"]:
        hold(counts.sum() > 0, "no rows streamed")
