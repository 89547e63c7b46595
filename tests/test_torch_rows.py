"""The row path of the opaque shade, module by module, port against
reference on the CPU:

- the compact table and its per-pixel state join: bit-equal;
- the fused fetch (``depth_reduce_tiled_cuda(shade_tbl=...)``, the plain
  version of kernel B5 here) against the reference's Pallas fused fetch in
  interpret mode (``sh_pack=2``) on the fixtures of
  tests/test_pallas_tiled.py — random int32 words with NaN and denormal
  float bit patterns, tiny caps so the beyond-cap re-fetch runs: ids and
  rows exactly. Under a viewport smaller than the frame the port's rows
  equal the gathered table (0 where the id is -1); the reference's kernel
  leaves its fetched rows unmasked outside the scissor, where nothing reads
  them, so there the comparison is against the table;
- the quantized frame and the compact frame as compositions of the stages
  (solve with e-planes, table, winner-row gather, expand, ``shade_rows``)
  against the reference's own composition with its Pallas solve in
  interpret mode: winners exactly, framebuffers within the f32-rounding
  bound of tests/_torch_common.assert_fb_close (2e-6 on all but 1% of the
  pixels; those on ill-conditioned edges and within 1/255). Both packages
  quantize the same way, so no quantization-sized bound is needed.

Kernel B5 itself is held against this plain version on the card by
chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import assert_fb_close, to_np
from tests.test_tiled_raster import _random_batch

from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.pallas_tiled import depth_reduce_tiled_pallas
from ckrenderengine_tpu.raster.types import (
    RasterState, VXTEXTUREBLEND, VXTEXTURE_ADDRESS, VXTEXTURE_FILTER,
    pack_states,
)
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.raster import cuda_tiled
from ckrenderengine_tpu_torch.raster import deferred as tdf

T = torch.as_tensor


def _np(d):
    return {k: np.array(v) for k, v in d.items()}


def _states(perspective: bool, mips: bool):
    A, F, B = VXTEXTURE_ADDRESS, VXTEXTURE_FILTER, VXTEXTUREBLEND
    filt = int(F.LINEARMIPLINEAR if mips else F.LINEAR)
    return [
        RasterState(tex=0, tex_address=int(A.WRAP), tex_filter=filt,
                    tex_blend=int(B.MODULATE), fog=True),
        RasterState(tex=1, tex_address=int(A.CLAMP),
                    tex_filter=int(F.NEAREST), tex_blend=int(B.MODULATEALPHA)),
        RasterState(fog=True),                                # untextured
        RasterState(tex=0, tex_address=int(A.CLAMP), tex_filter=filt,
                    tex_blend=int(B.DECAL), perspective=perspective),
    ]


def _attributes(t, h, w, seed, perspective=True, mips=False):
    """Random triangles with per-corner attributes, four states and two
    textures (with a mip column when ``mips``), as numpy arrays."""
    rng = np.random.default_rng(seed)
    xyw, z, _s, _v = _random_batch(t, h, w, seed=seed)
    si, sf = pack_states(_states(perspective, mips))
    tw = 8
    tex = rng.uniform(0, 1, (2, 4, tw, tw + (tw // 2 if mips else 0)))
    return dict(
        xyw=np.asarray(xyw), z=np.asarray(z), si=si, sf=sf,
        state=rng.integers(0, 4, t).astype(np.int32),
        color=rng.uniform(0, 1, (t, 3, 4)).astype(np.float32),
        spec=rng.uniform(0, 0.3, (t, 3, 3)).astype(np.float32),
        uv=rng.uniform(-1.5, 2.5, (t, 3, 2)).astype(np.float32),
        fog=rng.uniform(0, 1, (t, 3)).astype(np.float32),
        tex=tex.astype(np.float32),
        tex_hw=(np.array([[tw, tw, 4], [tw, tw, 4]], np.int32) if mips
                else np.array([[tw, tw], [tw, tw]], np.int32)),
        fog_color=np.array([0.2, 0.3, 0.4], np.float32),
        clear=np.broadcast_to(np.array([0.1, 0.0, 0.2, 1.0], np.float32)[
            :, None, None], (4, h, w)).copy())


def _reference_setup(a):
    t = a["xyw"].shape[0]
    return jdf.triangle_setup(jnp.asarray(a["xyw"]), jnp.asarray(a["z"]),
                              jnp.asarray(a["state"]), jnp.ones(t, bool),
                              jnp.asarray(a["si"]))


# --- the compact table -----------------------------------------------------

@pytest.mark.parametrize("seed", [3, 12])
def test_compact_table_and_expand_match_reference(seed):
    """shade_row_table_compact and expand_rows_compact, bit for bit, on a
    random batch, random states and random winner ids (background
    included)."""
    h, w, t = 40, 56, 90
    a = _attributes(t, h, w, seed, perspective=False, mips=True)
    setup = _reference_setup(a)
    J = jnp.asarray
    tbl_r = jdf.shade_row_table_compact(
        J(a["xyw"]), J(a["color"]), J(a["spec"]), J(a["uv"]), J(a["fog"]),
        J(a["state"]), e_coef=setup["e9"], inv_det_s=setup["inv_det_s"])
    tbl_g = tdf.shade_row_table_compact(
        T(a["xyw"]), T(a["color"]), T(a["spec"]), T(a["uv"]), T(a["fog"]),
        T(a["state"]), T(np.asarray(setup["e9"])),
        T(np.asarray(setup["inv_det_s"])))
    assert tbl_g.shape == (t, tdf.SH_C_NCOL) == tbl_r.shape
    np.testing.assert_array_equal(to_np(tbl_g).view(np.int32),
                                  np.asarray(tbl_r).view(np.int32))

    ids = np.random.default_rng(seed).integers(-1, t, (h, w)).astype(np.int32)
    rows_r = jnp.take(tbl_r.T, jnp.clip(J(ids), 0, t - 1).reshape(-1),
                      axis=1).reshape(tbl_r.shape[1], h, w)
    rows_r = jnp.where((J(ids) >= 0)[None], rows_r, 0.0)
    rows_g = tdf.gather_winner_rows(tbl_g, T(ids))
    np.testing.assert_array_equal(to_np(rows_g).view(np.int32),
                                  np.asarray(rows_r).view(np.int32))
    full_r = jdf.expand_rows_compact(rows_r, J(a["si"]), J(a["sf"]),
                                     J(a["tex_hw"]))
    full_g = tdf.expand_rows_compact(rows_g, T(a["si"]), T(a["sf"]),
                                     T(a["tex_hw"]))
    assert full_g.shape == (tdf.SH_NCOL, h, w)
    np.testing.assert_array_equal(to_np(full_g).view(np.int32),
                                  np.asarray(full_r).view(np.int32))
    assert (ids < 0).any() and len(np.unique(a["state"][ids[ids >= 0]])) == 4


# --- the fused fetch (plain version of B5) against the Pallas fused fetch ---

def _words(t, wq, seed):
    """Random int32 table words; two columns hold a float NaN and a float
    denormal bit pattern (tests/test_pallas_tiled.py:547-549)."""
    words = np.random.default_rng(seed).integers(
        -2**31, 2**31, (t, wq), dtype=np.int64)
    words[:, 3] = np.int64(0x7FC00001 - 2**32)
    words[:, 5] = 1
    return words.astype(np.int32)


FETCH_CASES = [
    # name, (t, h, w, seed, big_frac), table seed, caps
    ("packed_exact", (260, 48, 96, 2, 0.1), 13, dict(max_span=4, span2=16)),
    ("refetch_leftovers", (300, 64, 64, 5, 0.3), 17,
     dict(max_span=2, span2=4, g_cap=16, slab_cap=64)),
    ("refetch_pair_cap", (300, 64, 64, 5, 0.3), 17,
     dict(max_span=2, span2=4, pair_cap=64)),
]


def _fetch_inputs(fixture, tbl_seed, wq=16):
    t, h, w, seed, big = fixture
    xyw, z, _s, _v = _random_batch(t, h, w, seed, big_frac=big)
    si, _sf = pack_states([RasterState()])
    setup = jdf.triangle_setup(xyw, z, jnp.zeros(t, jnp.int32),
                               jnp.ones(t, bool), jnp.asarray(si))
    return xyw, setup, _words(t, wq, tbl_seed), t, h, w


def _port_fetch(xyw, setup, tbl, t, h, w, vp, **caps):
    return cuda_tiled.depth_reduce_tiled_cuda(
        convert.setup_from_reference(_np(setup)),
        torch.ones(t, dtype=torch.bool), 1.0,
        torch.tensor(vp, dtype=torch.float32), T(np.asarray(xyw)), h, w,
        tile=16, want_eplanes=True, want_binstats=True, shade_tbl=T(tbl),
        **caps)


@pytest.mark.parametrize("name,fixture,tbl_seed,caps", FETCH_CASES,
                         ids=[c[0] for c in FETCH_CASES])
def test_fused_fetch_matches_reference(name, fixture, tbl_seed, caps):
    xyw, setup, tbl, t, h, w = _fetch_inputs(fixture, tbl_seed)
    vp = [0, 0, w, h]
    bi_r, _bd, _pk, _ep, rows_r = depth_reduce_tiled_pallas(
        setup, jnp.ones(t, bool), 1.0, jnp.asarray(vp, jnp.float32), xyw,
        h, w, tile=16, interpret=True, shade_tbl=jnp.asarray(tbl),
        sh_pack=2, want_eplanes=True, **caps)
    bi_g, _bd, stats, _ep, rows_g = _port_fetch(xyw, setup, tbl, t, h, w, vp,
                                                **caps)
    assert rows_g.dtype == torch.int32 and rows_g.shape == (16, h, w)
    np.testing.assert_array_equal(to_np(bi_g), np.asarray(bi_r))
    np.testing.assert_array_equal(to_np(rows_g), np.asarray(rows_r))
    assert torch.equal(rows_g, tdf.gather_winner_rows(T(tbl), bi_g))
    assert (to_np(bi_g) >= 0).any()
    if name.startswith("refetch"):
        assert int(stats[2:5].sum()) > 0     # a beyond-cap remainder ran
    else:
        assert (to_np(bi_g) < 0).any()       # background rows are 0


def test_fused_fetch_small_viewport_rows_are_the_gathered_table():
    """A viewport smaller than the frame, a 20-word table: ids equal the
    reference's, and the rows are the table gathered by id — 0 outside the
    scissor, where the id is -1."""
    xyw, setup, tbl, t, h, w = _fetch_inputs((260, 48, 96, 2, 0.1), 13, 20)
    vp = [6, 4, 70, 36]
    bi_r = depth_reduce_tiled_pallas(
        setup, jnp.ones(t, bool), 1.0, jnp.asarray(vp, jnp.float32), xyw,
        h, w, tile=16, interpret=True, max_span=4, span2=16)[0]
    bi_g, _bd, _st, _ep, rows_g = _port_fetch(xyw, setup, tbl, t, h, w, vp,
                                              max_span=4, span2=16)
    np.testing.assert_array_equal(to_np(bi_g), np.asarray(bi_r))
    ids = to_np(bi_g)
    want = np.where(ids[None] >= 0, tbl[np.clip(ids, 0, t - 1)].transpose(
        2, 0, 1), 0)
    np.testing.assert_array_equal(to_np(rows_g), want)
    outside = np.ones((h, w), bool)
    outside[4:40, 6:76] = False
    assert (ids[outside] == -1).all() and (to_np(rows_g)[:, outside] == 0).all()
    assert (ids[~outside] >= 0).mean() > 0.5


def test_fused_fetch_without_eplanes_returns_the_reference_tuple():
    """(ids, depth, peak, rows), as the reference returns without
    ``want_eplanes``; the rows equal those of the 5-tuple call."""
    xyw, setup, tbl, t, h, w = _fetch_inputs((260, 48, 96, 2, 0.1), 13)
    args = (convert.setup_from_reference(_np(setup)),
            torch.ones(t, dtype=torch.bool), 1.0,
            torch.tensor([0, 0, w, h], dtype=torch.float32),
            T(np.asarray(xyw)), h, w)
    out4 = cuda_tiled.depth_reduce_tiled_cuda(*args, tile=16, shade_tbl=T(tbl))
    out5 = cuda_tiled.depth_reduce_tiled_cuda(*args, tile=16, shade_tbl=T(tbl),
                                              want_eplanes=True)
    assert len(out4) == 4 and len(out5) == 5
    assert torch.equal(out4[0], out5[0]) and torch.equal(out4[3], out5[4])


# --- the quantized and the compact frame, stage by stage --------------------

FRAME_CASES = [
    # name, (h, w), perspective on every state, mips, profile, branch
    ("quant_perspective", (96, 128), True, False,
     (True, False, False, True, True), "quant"),
    ("quant_want_ws", (96, 128), False, False,
     (True, False, False, False, True), "quant"),
    ("quant_mip_even_quad_lod", (96, 128), True, True,
     (True, True, False, True, True), "quant"),
    ("compact_mip_odd", (95, 127), False, True,
     (True, True, False, False, True), "compact"),
]


def _frame_reference(a, setup, h, w, profile, branch):
    J = jnp.asarray
    t = a["xyw"].shape[0]
    vp = jnp.asarray([0, 0, w, h], jnp.float32)
    batch = (J(a["xyw"]), J(a["color"]), J(a["spec"]), J(a["uv"]),
             J(a["fog"]), J(a["state"]))
    shade = (J(a["tex"]), J(a["tex_hw"]), J(a["fog_color"]), J(a["clear"]),
             h, w)

    def gather(tbl, bi, zero):
        rows = jnp.take(tbl.T, jnp.clip(bi, 0, t - 1).reshape(-1),
                        axis=1).reshape(tbl.shape[1], h, w)
        return jnp.where((bi >= 0)[None], rows, zero)

    if branch == "quant":
        want_ws = not profile[3]
        bi, _bd, _pk, epl = depth_reduce_tiled_pallas(
            setup, jnp.ones(t, bool), 1.0, vp, J(a["xyw"]), h, w, tile=16,
            interpret=True, want_eplanes=True)
        tbl = jdf.shade_row_table_quant(
            *batch, inv_det_s=setup["inv_det_s"], want_ws=want_ws)
        rows = jdf.expand_rows_quant(
            gather(tbl, bi, jnp.int32(0)), J(a["si"]), J(a["sf"]),
            J(a["tex_hw"]), want_ws=want_ws, has_refl=False)
        fb = jdf.shade_rows(rows, bi >= 0, *shade, sampler_profile=profile,
                            eplanes=(epl[0], epl[1], epl[2]))
    else:
        bi, _bd, _pk = depth_reduce_tiled_pallas(
            setup, jnp.ones(t, bool), 1.0, vp, J(a["xyw"]), h, w, tile=16,
            interpret=True)
        tbl = jdf.shade_row_table_compact(
            *batch, e_coef=setup["e9"], inv_det_s=setup["inv_det_s"])
        rows = jdf.expand_rows_compact(gather(tbl, bi, 0.0), J(a["si"]),
                                       J(a["sf"]), J(a["tex_hw"]))
        fb = jdf.shade_rows(rows, bi >= 0, *shade, sampler_profile=profile)
    return np.asarray(bi), np.asarray(fb)


def _frame_port(a, setup, h, w, profile, branch):
    t = a["xyw"].shape[0]
    setup_t = convert.setup_from_reference(_np(setup))
    solve = (setup_t, torch.ones(t, dtype=torch.bool), 1.0,
             torch.tensor([0, 0, w, h], dtype=torch.float32), T(a["xyw"]),
             h, w)
    batch = (T(a["xyw"]), T(a["color"]), T(a["spec"]), T(a["uv"]),
             T(a["fog"]), T(a["state"]))
    states = (T(a["si"]), T(a["sf"]), T(a["tex_hw"]))
    shade = (T(a["tex"]), T(a["tex_hw"]), T(a["fog_color"]), T(a["clear"]),
             h, w)
    if branch == "quant":
        want_ws = not profile[3]
        tbl = tdf.shade_row_table_quant(
            *batch, inv_det_s=setup_t["inv_det_s"], want_ws=want_ws)
        assert tbl.shape[1] == (20 if want_ws else 16)
        bi, _bd, _pk, epl, rows_q = cuda_tiled.depth_reduce_tiled_cuda(
            *solve, tile=16, want_eplanes=True, shade_tbl=tbl)
        rows = tdf.expand_rows_quant(rows_q, *states, want_ws=want_ws,
                                     has_refl=False)
        fb = tdf.shade_rows(rows, bi >= 0, *shade, sampler_profile=profile,
                            eplanes=(epl[0], epl[1], epl[2]))
    else:
        bi, _bd, _pk = cuda_tiled.depth_reduce_tiled_cuda(*solve, tile=16)
        tbl = tdf.shade_row_table_compact(*batch, setup_t["e9"],
                                          setup_t["inv_det_s"])
        rows = tdf.expand_rows_compact(tdf.gather_winner_rows(tbl, bi),
                                       *states)
        fb = tdf.shade_rows(rows, bi >= 0, *shade, sampler_profile=profile)
    return to_np(bi), to_np(fb)


@pytest.mark.parametrize("name,hw,persp,mips,profile,branch", FRAME_CASES,
                         ids=[c[0] for c in FRAME_CASES])
def test_rows_frame_matches_reference_stages(name, hw, persp, mips, profile,
                                             branch):
    h, w = hw
    a = _attributes(160, h, w, 11, perspective=persp, mips=mips)
    setup = _reference_setup(a)
    bi_r, fb_r = _frame_reference(a, setup, h, w, profile, branch)
    bi_g, fb_g = _frame_port(a, setup, h, w, profile, branch)
    np.testing.assert_array_equal(bi_g, bi_r)
    assert_fb_close(fb_g, fb_r, bi_r, _np(setup))
    hit = bi_r >= 0
    assert hit.mean() > 0.3
    assert len(np.unique(a["state"][bi_r[hit]])) == 4   # every state shades


def test_quantized_rows_differ_from_the_full_rows_by_the_u8_step():
    """The row path carries the D3DCOLOR quantization: against
    ``shade_deferred`` on the same winners the quantized frame stays within
    3/255 (0.5/255 per corner for colour, specular and fog) on every pixel,
    and does differ."""
    h, w = 96, 128
    a = _attributes(160, h, w, 11)
    setup = _reference_setup(a)
    profile = (True, False, False, True, True)
    bi, fb_q = _frame_port(a, setup, h, w, profile, "quant")
    fb_f = tdf.shade_deferred(
        T(bi), T(a["xyw"]), T(a["z"]), T(a["color"]), T(a["spec"]),
        T(a["uv"]), T(a["fog"]), T(a["state"]), T(a["si"]), T(a["sf"]),
        T(a["tex"]), T(a["tex_hw"]), T(a["fog_color"]), T(a["clear"]), h, w,
        sampler_profile=profile)
    diff = np.abs(fb_q - to_np(fb_f))
    assert 1e-4 < diff.max() <= 3.0 / 255.0, float(diff.max())
