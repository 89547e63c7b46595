"""The ordered kernels' row stream (a coverage head and a shade tail, each a
multiple of 16 bytes), on the cases of
``ckrenderengine_tpu_torch.raster.ordered_fixtures`` at tile 16 and the
kernels' chunk (a deep tile beside empty ones, ranges that are exact chunk
multiples, 0, 1 and 3 clip planes, rects and a viewport on the edges of a
thread's pixel block, a frame that is no multiple of the tile,
colorwrite-off and alpha-tested states, peel stacks 9 and 13 deep, a
phase-A overflow):

- phase A: the pitch (``row_pitch``: 60 / 60 / 68 floats for 0 / 1 / 3
  planes), zero pad columns and sentinel row, every live stream row equal
  column for column to its triangle's setup, fields and state, draw order
  within each tile's range, and the per-tile row counts equal to the
  reference's ``_ordered_phase_a``;
- phase A + the plain B3 (through ``ordered_blend_tiled_cuda`` on the CPU)
  against ``ordered_blend_tiled_pallas(interpret=True)``: the overflow flag
  equal, A and B within 2e-4 everywhere and within 2e-6 on all but 2% of
  the values (tests/test_torch_ordered.py: 1e-4, and 0.1% past 2e-6, on the
  reference's fixtures). The reference's interpreted fold and
  interpolation contract multiply-adds, the port never does, and these
  cases carry that rounding further: chains 35 fragments deep (1.2% of the
  deep tile's values pass 2e-6), six states (non-perspective weights,
  alpha tests), and fragments whose alpha is near 1, where ``1 - sa`` turns
  an ULP of sa into a large relative error of A (1.46e-4 at one pixel of
  ``clip_planes_1``). The same shares and maxima come out with the
  reference's own triangle setup fed to the port's phase A: they are the
  reference kernel's arithmetic, not the row layout;
- phase A + the plain B4 against the reference's ``_peel_phase_b`` in
  interpret mode at each of the case's layer windows: the overflow flag
  equal, layer ids equal on >= 99.9% of the pixels, and raw edge values
  where the ids agree within 1e-5 plus twice their f32 forward-error bound
  (tests/test_torch_peel.py: each package sets its triangles up itself);
- the column constants of ``csrc/ordered_common.cuh`` equal to ``_OC_*``;
- bands of a frame (``ordered_fixtures.band_cases``: B3 and B4 at a row
  offset, with triangles ending on the band's and its tiles' edges and a
  9-deep stack across its top edge): the plain B3's maps and the plain
  B4's layers, counts and overflow at each skip equal to the same rows of
  the unbanded frame's bit for bit; the exact tiled pass at the offset
  equal to the same rows of the unbanded pass bit for bit and to the
  reference's XLA ``render_pass_tiled`` with ``row0`` within the bounds
  above.

Kernels B3 and B4 are held against these plain versions on the same cases
on the card, at tiles 16 and 32, by chip_smoke.py.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_common import to_np
from tests.test_torch_peel import _fragment_edge_bound

from ckrenderengine_tpu.raster import pallas_ordered as jpo
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from ckrenderengine_tpu_torch.raster import deferred as df
from ckrenderengine_tpu_torch.raster.ordered_fixtures import (
    FIELDS, band_cases, check_expect, ordered_cases,
)
from ckrenderengine_tpu_torch.raster.types import (
    SF_ALPHAREF, SI_ALPHABLEND, SI_ALPHAFUNC, SI_ALPHATEST, SI_COLORWRITE,
    SI_FOG, SI_PERSPECTIVE, SI_ZFUNC, VXCMP,
)

TILE = 16
CASES = {c["name"]: c for c in ordered_cases(tile=TILE, kchunk=co.KCHUNK)}
NAMES = list(CASES)
WINDOWS = co.WINDOWS
BANDS = {c["name"]: c for c in band_cases(tile=TILE)}
BATCH = ("xyw", "z", "color", "specular", "uv", "fog", "state_idx", "valid",
         "clip_rect", "clipd", "refl")


def _assert_close(got, ref):
    """Within 2e-6 on all but 2% of the values and within 2e-4 on those
    (see the module docstring)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    off = diff > 2e-6
    assert off.mean() <= 0.02, (int(off.sum()), float(diff.max()))
    assert diff.max() <= 2e-4, float(diff.max())


def _port(name, fields=FIELDS):
    c = CASES[name]
    fx = c["fields"]
    return [torch.as_tensor(fx[k].copy()) for k in fields]


def _phase_a(name):
    c = CASES[name]
    return co.phase_a(*_port(name), torch.as_tensor(c["si"]),
                      torch.as_tensor(c["sf"]), torch.as_tensor(c["zb"]),
                      c["h"], c["w"], TILE, c["windows"] or WINDOWS)


@pytest.mark.parametrize("name", NAMES)
def test_phase_a_stream_layout(name):
    c = CASES[name]
    fx = c["fields"]
    planes = fx["clipd"].shape[2]
    pa = _phase_a(name)
    head = co.head_width(planes)
    assert head == {0: 28, 1: 28, 3: 36}[planes]
    pitch = co.row_pitch(planes)
    check_expect(c, pa, pitch)
    stream = to_np(pa["stream"])
    assert stream.shape[1] == pitch == head + 32

    starts, counts = to_np(pa["starts"]), to_np(pa["counts"])
    live = np.zeros(stream.shape[0], bool)
    for s, n in zip(starts, counts):
        live[s:s + n] = True
    # Dead rows (past the live pairs) are the all-zero sentinel.
    assert not stream[~live].any()
    # Pad columns are zero.
    ncol_head = co._OC_CLIP + 3 * planes
    assert not stream[:, ncol_head:head].any()
    assert not stream[:, head + co._OC_WS + 3:].any()

    # Every live row, column group by column group, from its triangle.
    t = fx["xyw"].shape[0]
    ids = stream[live, co._OC_ID].astype(np.int64)
    assert (ids >= 0).all() and (ids < t).all()
    rows = stream[live]
    setup = df.triangle_setup(
        *(torch.as_tensor(fx[k].copy()) for k in ("xyw", "z", "state_idx",
                                                  "valid")),
        torch.as_tensor(c["si"]), clip_rect=torch.as_tensor(fx["clip_rect"]),
        clipd=torch.as_tensor(fx["clipd"]))
    si, sf = c["si"], c["sf"]
    groups = {
        0: to_np(setup["e9"]), co._OC_Z: to_np(setup["z"]),
        co._OC_IVS: to_np(setup["inv_det_s"])[:, None],
        co._OC_EP: to_np(setup["esum_plane"]),
        co._OC_SS: to_np(setup["s"])[:, None],
        co._OC_RECT: to_np(setup["clip_rect"]),
        co._OC_CLIP: to_np(setup["dplane9"]),
        head + co._OC_COL: fx["color"].reshape(t, 12),
        head + co._OC_SPC: fx["specular"].reshape(t, 9),
        head + co._OC_FOG: fx["fog"].reshape(t, 3),
        head + co._OC_WS: fx["xyw"][..., 2]}
    for col, src in groups.items():
        k = src.shape[1]
        np.testing.assert_array_equal(rows[:, col:col + k].view(np.int32),
                                      src[ids].astype(np.float32).view(
                                          np.int32), err_msg=str(col))
    assert (rows[:, co._OC_FL].astype(np.int32) & 8).all()   # valid
    state = fx["state_idx"][ids]
    np.testing.assert_array_equal(rows[:, co._OC_ZF], si[state, SI_ZFUNC])
    np.testing.assert_array_equal(rows[:, head + co._OC_AF],
                                  si[state, SI_ALPHAFUNC])
    np.testing.assert_array_equal(rows[:, head + co._OC_AREF],
                                  sf[state, SF_ALPHAREF])
    on = si[state] != 0
    np.testing.assert_array_equal(
        rows[:, co._OC_BITS],
        on[:, SI_ALPHABLEND] + 2 * on[:, SI_FOG] + 4 * on[:, SI_COLORWRITE]
        + 8 * on[:, SI_PERSPECTIVE] + 16 * on[:, SI_ALPHATEST])
    # Draw order within each tile.
    for s, n in zip(starts, counts):
        assert (np.diff(stream[s:s + n, co._OC_ID]) > 0).all()


@functools.partial(jax.jit, static_argnames=("h", "w", "windows"))
def _reference_jit(fields, si, sf, fogc, zb, vp, skip, h, w, windows):
    """The reference's blend (A, B, bad), and its phase A with one peel
    round (interpret mode) at the layer window ``skip``: (lids, les, ovf,
    per-tile row counts). One compiled program per shape."""
    blend = jpo.ordered_blend_tiled_pallas(
        *fields, si, sf, fogc, zb, vp, h, w, tile=TILE, windows=windows,
        interpret=True)
    pa = jpo._ordered_phase_a(*fields, si, sf, zb, h, w, TILE, windows,
                              co.PAIR_CAP, 128)
    lids, les, ovf = jpo._peel_phase_b(pa, skip, vp, h, w, TILE, 128,
                                       co.K_LAYERS, True)
    return blend, (lids, les, ovf, pa["kcounts"])


@functools.lru_cache(maxsize=None)
def _reference(name, skip):
    c = CASES[name]
    fx = c["fields"]
    blend, peel = _reference_jit(
        tuple(jnp.asarray(fx[k]) for k in FIELDS), jnp.asarray(c["si"]),
        jnp.asarray(c["sf"]), jnp.asarray(c["fog_color"], jnp.float32),
        jnp.asarray(c["zb"]), jnp.asarray(c["viewport"], jnp.float32),
        jnp.int32(skip), h=c["h"], w=c["w"], windows=c["windows"] or WINDOWS)
    return [np.asarray(a) for a in blend], [np.asarray(a) for a in peel]


@pytest.mark.parametrize("name", NAMES)
def test_blend_plain_matches_pallas(name):
    c = CASES[name]
    a_r, b_r, bad_r = _reference(name, 0)[0]
    kw = dict(windows=c["windows"]) if c["windows"] else {}
    a_g, b_g, bad_g = (to_np(a) for a in co.ordered_blend_tiled_cuda(
        *_port(name), torch.as_tensor(c["si"]), torch.as_tensor(c["sf"]),
        torch.tensor(c["fog_color"]), torch.as_tensor(c["zb"]),
        torch.tensor(c["viewport"]), c["h"], c["w"], tile=TILE, **kw))
    assert bool(bad_g) == bool(bad_r) == c["bad"]
    assert a_g.shape == a_r.shape == (4, c["h"], c["w"])
    _assert_close(a_g, a_r)
    _assert_close(b_g, b_r)
    if not c["bad"]:
        assert (a_g[0] != 1).any()


@pytest.mark.parametrize("name", [n for n in NAMES if not CASES[n]["bad"]])
def test_peel_plain_matches_pallas(name):
    c = CASES[name]
    h, w = c["h"], c["w"]
    pa = _phase_a(name)
    xyw = c["fields"]["xyw"].astype(np.float64)
    deepest = 0
    for skip in c["skips"]:
        lids_r, les_r, ovf_r, counts_r = _reference(name, skip)[1]
        np.testing.assert_array_equal(to_np(pa["counts"]), counts_r)
        lids_g, les_g, cnt_g, ovf_g = (to_np(a) for a in co.peel_phase_b(
            pa["stream"], pa["starts"], pa["counts"],
            co._params(c["viewport"], h, w), skip, pa["zplane"], TILE,
            pa["tiles_x"], pa["tiles_y"], pa["n_planes"]))
        lids_g, les_g = lids_g[:, :h, :w], les_g[:, :, :h, :w]
        assert bool(ovf_g[:h, :w].any()) == bool(ovf_r), skip
        same = lids_g == lids_r
        assert same.mean() >= 0.999, (skip, same.mean())
        for s in range(co.K_LAYERS):
            bound = _fragment_edge_bound(np.where(same[s], lids_r[s], -1),
                                         xyw, h, w)
            diff = np.abs(les_g[s] - les_r[s])
            assert np.all(diff <= 1e-5 + bound), (skip, s)
        deepest = max(deepest, int(cnt_g.max()))
    if "depth" in c["expect"]:
        assert deepest == c["expect"]["depth"]
    if len(c["skips"]) > 2:
        assert deepest > 2 * co.K_LAYERS


def test_kernel_constants_match_the_layout():
    """``constexpr int k*`` of csrc/ordered_common.cuh: the column constants
    equal ``_OC_*`` and the compare codes ``VXCMP``."""
    src = os.path.join(os.path.dirname(co.__file__), "..", "csrc",
                       "ordered_common.cuh")
    with open(src) as f:
        consts = dict((m.group(1), int(m.group(2))) for m in re.finditer(
            r"constexpr int k(\w+) = (\d+);", f.read()))
    cols = {k[4:]: v for k, v in vars(co).items() if k.startswith("_OC_")}
    assert {k.upper(): consts[k] for k in consts
            if k.upper() in cols} == cols
    codes = {"Never": "NEVER", "Less": "LESS", "Equal": "EQUAL",
             "LessEqual": "LESSEQUAL", "Greater": "GREATER",
             "NotEqual": "NOTEQUAL", "GreaterEqual": "GREATEREQUAL"}
    for k, v in codes.items():
        assert consts[k] == int(getattr(VXCMP, v)), k


@pytest.mark.parametrize("wrapper", ["blend_kernel", "peel_kernel"])
def test_kernel_wrappers_refuse_what_they_do_not_take(wrapper):
    """The kernels' wrappers launch or raise: a CPU stream (the plain
    version's input, which only the dispatch takes), a stream at another
    pitch and a tile that is not 16 or 32 are refused before anything is
    built, and no launch is counted."""
    name = "clip_planes_1"
    c = CASES[name]
    pa = _phase_a(name)
    fn = getattr(co, wrapper)
    params = co._params(c["viewport"], c["h"], c["w"], c["fog_color"])
    extra = () if wrapper == "blend_kernel" else (0,)
    rest = (pa["zplane"], TILE, pa["tiles_x"], pa["tiles_y"], pa["n_planes"])
    before = fn.launches
    for stream, tile, match in (
            (pa["stream"], TILE, "CUDA f32"),
            (pa["stream"][:, :-4], TILE, "CUDA f32"),
            (pa["stream"], 8, "CUDA f32")):
        args = (stream, pa["starts"], pa["counts"], params) + extra \
            + (rest[0], tile) + rest[2:]
        with pytest.raises(ValueError, match=match):
            fn(*args)
    assert fn.launches == before


def _band_b(c, band: bool):
    """Phase A + the plain B3 and B4 (at each skip) of a band case, on the
    band (``band``) or on the whole frame, cut to the band's rows."""
    row0, h, w = c["row0"], c["h"], c["w"]
    rows = slice(0, h) if band else slice(row0, row0 + h)
    fh, r0 = (h, row0) if band else (c["frame_h"], 0)
    zb = c["zb"] if band else c["zb_frame"]
    fx = c["fields"]
    pa = co.phase_a(*(torch.as_tensor(fx[k].copy()) for k in FIELDS),
                    torch.as_tensor(c["si"]), torch.as_tensor(c["sf"]),
                    torch.as_tensor(zb), fh, w, TILE, WINDOWS, row0=r0)
    assert not bool(pa["bad"])
    geo = (TILE, pa["tiles_x"], pa["tiles_y"], pa["n_planes"])
    ab = co.blend_phase_b(
        pa["stream"], pa["starts"], pa["counts"],
        co._params(c["viewport"], fh, w, c["fog_color"], row0=r0),
        pa["zplane"], *geo)[:, rows, :w]
    peel = [tuple(a[..., rows, :w] for a in co.peel_phase_b(
        pa["stream"], pa["starts"], pa["counts"],
        co._params(c["viewport"], fh, w, row0=r0), skip, pa["zplane"],
        *geo)) for skip in c["skips"]]
    return ab, peel


@pytest.mark.parametrize("name", list(BANDS))
def test_band_blend_and_peel_equal_the_whole_frame(name):
    c = BANDS[name]
    ab, peel = _band_b(c, True)
    ab_w, peel_w = _band_b(c, False)
    assert torch.equal(ab, ab_w)
    assert (ab[0] != 1.0).mean(dtype=torch.float32) > 0.05
    for got, want in zip(peel, peel_w):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    if name == "band_stack":
        assert int(peel[0][2].max()) >= 9 and bool(peel[1][3].any())


@pytest.mark.parametrize("name", list(BANDS))
def test_band_tiled_pass(name):
    """The exact tiled ordered pass at a row offset: the same rows as the
    unbanded pass bit for bit, and the reference's with ``row0``."""
    from ckrenderengine_tpu.raster import jax_backend as jrb
    from ckrenderengine_tpu_torch import convert
    from ckrenderengine_tpu_torch.raster import torch_backend as rb

    c = BANDS[name]
    row0, h, w = c["row0"], c["h"], c["w"]
    fx = c["fields"]
    rng = np.random.default_rng(3)
    fb_frame = rng.uniform(0, 1, (4, c["frame_h"], w)).astype(np.float32)
    fb = fb_frame[:, row0:row0 + h]
    jbatch = jrb.DeviceBatch(*(jnp.asarray(fx[k]) for k in BATCH))
    batch = convert.batch_from_reference(jbatch)
    args = (c["si"], c["sf"], np.zeros((1, 4, 2, 2), np.float32),
            np.asarray([[2, 2]], np.int32),
            np.asarray(c["fog_color"], np.float32),
            np.asarray(c["viewport"], np.float32))
    targs = [torch.as_tensor(a) for a in args]
    got = rb.render_pass_tiled(torch.as_tensor(fb), torch.as_tensor(c["zb"]),
                               batch, *targs, tile=16, row0=row0)
    whole = rb.render_pass_tiled(torch.as_tensor(fb_frame),
                                 torch.as_tensor(c["zb_frame"]), batch,
                                 *targs, tile=16)
    assert torch.equal(got[0], whole[0][:, row0:row0 + h])
    assert torch.equal(got[1], whole[1][row0:row0 + h])
    ref = jrb.render_pass_tiled(jnp.asarray(fb), jnp.asarray(c["zb"]),
                                jbatch, *(jnp.asarray(a) for a in args),
                                tile=16, row0=float(row0))
    for a, a_r in zip(got, ref):
        _assert_close(to_np(a), np.asarray(a_r))
    assert (to_np(got[0]) != fb).mean() > 0.05
