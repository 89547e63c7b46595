"""The ordered pass of the port against the reference on the CPU, module by
module: the exact sequential pass (``render_pass``, ``render_pass_tiled``),
``ordered_subset``, the quantized shade rows, and the B3 path (phase A +
the plain version of the ordered-blend kernel) against
``ordered_blend_tiled_pallas(interpret=True)``, on the fixtures of
tests/test_pallas_ordered.py and tests/test_pallas_peel.py.

Tolerances, and why:

- Sequential pass: fb and zb within 1e-5 on all but 0.1% of the pixels,
  and within 1e-4 on those. The reference's jitted pass contracts
  multiply-adds into FMAs, so its interpolation weights and depths round an
  ULP or two apart from the port's; a long blend chain (up to ~30 steps on
  these fixtures), a bilinear texel weight or a depth tie between two
  z-writing cutouts carries that to ~5e-5 on a few pixels (2 of 4,608 at
  most).
- A and B of the affine blend within 2e-6 on all but 0.1% of the values
  and within 1e-4 on those (up to 1.2e-5 measured: the reference's
  interpret-mode fold contracts its multiply-adds); the composite within
  the reference test's 1e-4 of the sequential pass.
- Quantized rows: bit-equal tables; shade within 2e-6.

The CUDA kernel B3 itself is held against its plain version on the card
by chip_smoke.py, on the cases of raster/ordered_fixtures.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import to_np
from tests.test_pallas_ordered import _alpha_states, _ordered_batch
from tests import test_pallas_peel as peel_fx

from ckrenderengine_tpu.pipeline import frame as jfr
from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster import jax_backend as jrb
from ckrenderengine_tpu.raster.pallas_ordered import (
    ordered_blend_tiled_pallas,
)
from ckrenderengine_tpu.raster.types import (
    RasterState, VXCMP, VXCULL, VXTEXTURE_FILTER, pack_states,
)
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from ckrenderengine_tpu_torch.raster import deferred as tdf
from ckrenderengine_tpu_torch.raster import torch_backend as rb

UNTEX = (False, False, False, True, False)
TEX = (True, False, False, True, True, False, True)


def _t(x):
    return torch.as_tensor(np.array(x))


def _fields(b):
    """The ordered kernels' batch arguments, in their order."""
    return (b.xyw, b.z, b.valid, b.color, b.specular, b.uv, b.fog,
            b.state_idx, b.clip_rect, b.clipd)


def _blend_case(name):
    """(batch, si, sf, fb, zb, fog colour, viewport, h, w) of one
    tests/test_pallas_ordered.py fixture."""
    si, sf = _alpha_states()
    fog_color = np.asarray([0.2, 0.3, 0.4], np.float32)
    if name.startswith("seed"):
        seed = int(name[4:])
        h, w = 48, 96
        batch = _ordered_batch(150, h, w, seed)
        rng = np.random.default_rng(seed + 100)
        fb = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
        zb = rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
        vp = [0, 0, w, h]
    else:                                   # clip planes and a viewport
        h = w = 64
        t = 80
        batch = _ordered_batch(t, h, w, seed=7)
        clipd = np.random.default_rng(7).uniform(-1, 1, (t, 3, 1))
        batch = batch._replace(clipd=jnp.asarray(clipd.astype(np.float32)))
        fb = np.full((4, h, w), 0.25, np.float32)
        zb = np.full((h, w), 0.8, np.float32)
        fog_color = np.zeros(3, np.float32)
        vp = [6, 4, w - 12, h - 10]
    return (batch, si, sf, fb, zb, fog_color,
            np.asarray(vp, np.float32), h, w)


def _peel_case(seed, cutout=False):
    """A tests/test_pallas_peel.py textured fixture; ``cutout`` swaps the
    alpha-tested state for one that writes z (outside both kernels)."""
    h, w = 48, 96
    rng = np.random.default_rng(seed)
    states = [
        RasterState(alpha_blend=True, src_blend=5, dst_blend=6,
                    z_write=False, cull=int(VXCULL.NONE), fog=True, tex=0,
                    tex_filter=int(VXTEXTURE_FILTER.LINEAR)),
        RasterState(alpha_blend=True, src_blend=5, dst_blend=6,
                    z_write=False, cull=int(VXCULL.NONE)),
        RasterState(alpha_blend=True, src_blend=5, dst_blend=6,
                    z_write=cutout, alpha_test=True,
                    alpha_func=int(VXCMP.GREATER), alpha_ref=0.4,
                    cull=int(VXCULL.NONE), tex=0)]
    si, sf = pack_states(states)
    xyw, z, t = peel_fx._bounded_batch(seed, h, w)
    batch = jrb.DeviceBatch(
        xyw=xyw, z=z,
        color=jnp.asarray(rng.uniform(0, 1, (t, 3, 4)).astype(np.float32)),
        specular=jnp.asarray(
            rng.uniform(0, 0.2, (t, 3, 3)).astype(np.float32)),
        uv=jnp.asarray(rng.uniform(0, 1, (t, 3, 2)).astype(np.float32)),
        fog=jnp.asarray(rng.uniform(0.3, 1, (t, 3)).astype(np.float32)),
        state_idx=jnp.asarray(rng.integers(0, 3, t).astype(np.int32)),
        valid=jnp.asarray(rng.random(t) < 0.9),
        clip_rect=jnp.asarray(np.tile(
            np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32), (t, 1))),
        clipd=jnp.zeros((t, 3, 0), jnp.float32),
        refl=jnp.zeros((t, 3, 0), jnp.float32))
    fb = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    zb = rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    return batch, si, sf, fb, zb, h, w


def _assert_mostly_close(got, ref, atol, cap):
    """Within ``atol`` on all but 0.1% of the values, within ``cap`` on
    those (see the module docstring)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    off = diff > atol
    assert off.mean() <= 1e-3, (int(off.sum()), float(diff.max()))
    assert diff.max() <= cap, float(diff.max())


def _assert_pass_close(got, ref):
    for a, a_r in zip(got, ref):
        _assert_mostly_close(to_np(a), np.asarray(a_r), 1e-5, 1e-4)


PASS_CASES = ["untextured_seed1", "untextured_seed4", "clip_planes",
              "textured_seed1", "textured_seed7", "cutout_zwrite"]


@pytest.mark.parametrize("tiled", [False, True], ids=["flat", "tiled"])
@pytest.mark.parametrize("name", PASS_CASES)
def test_render_pass_matches_reference(name, tiled):
    textured = not (name.startswith("untextured") or name == "clip_planes")
    if textured:
        seed = 3 if name == "cutout_zwrite" else int(name[-1])
        batch, si, sf, fb, zb, h, w = _peel_case(seed, name == "cutout_zwrite")
        tex_planes, tex_hw = peel_fx._tex()
        fog_color = np.asarray([0.2, 0.3, 0.4], np.float32)
        vp = np.asarray([0, 0, w, h], np.float32)
        profile = TEX
    else:
        key = "seed" + name[-1] if name != "clip_planes" else name
        batch, si, sf, fb, zb, fog_color, vp, h, w = _blend_case(key)
        tex_planes = np.zeros((1, 4, 2, 2), np.float32)
        tex_hw = np.asarray([[2, 2]], np.int32)
        profile = UNTEX
    args = (si, sf, tex_planes, tex_hw, fog_color, vp)
    if tiled:
        ref = jrb.render_pass_tiled(jnp.asarray(fb), jnp.asarray(zb), batch,
                                    *(jnp.asarray(a) for a in args), tile=16,
                                    sampler_profile=profile)
        got = rb.render_pass_tiled(_t(fb), _t(zb),
                                   convert.batch_from_reference(batch),
                                   *(_t(a) for a in args), tile=16,
                                   sampler_profile=profile)
    else:
        ref = jrb.render_pass(jnp.asarray(fb), jnp.asarray(zb), batch,
                              *(jnp.asarray(a) for a in args), chunk=1,
                              sampler_profile=profile)
        got = rb.render_pass(_t(fb), _t(zb),
                             convert.batch_from_reference(batch),
                             *(_t(a) for a in args), sampler_profile=profile)
    _assert_pass_close(got, ref)
    if name == "cutout_zwrite":
        assert (to_np(got[1]) != zb).mean() > 0.01   # the cutouts wrote z


def _subset_batch(seed, it=96):
    """A random batch with a planar payload, so the reference takes the
    frame's planar sort-key arithmetic; state_idx = arange reads back the
    permutation. Some triangles repeat depths exactly (stable-sort ties)."""
    rng = np.random.default_rng(seed)
    xyw = rng.uniform(-50, 50, (it, 3, 3)).astype(np.float32)
    xyw[..., 2] = rng.uniform(0.2, 3.0, (it, 3))
    xyw[5, :, 2] = 0.0                                  # w guard
    z = (rng.uniform(0, 1, (it, 3)) * xyw[..., 2]).astype(np.float32)
    z[10:20] = z[30:40]
    xyw[10:20] = xyw[30:40]
    color = rng.uniform(0, 1, (it, 3, 4)).astype(np.float32)
    spec = rng.uniform(0, 1, (it, 3, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (it, 3, 2)).astype(np.float32)
    fog = rng.uniform(0, 1, (it, 3)).astype(np.float32)
    cp = tuple(jnp.asarray(np.concatenate(
        [xyw[:, k], z[:, k, None], color[:, k], spec[:, k], uv[:, k],
         fog[:, k, None]], 1)) for k in range(3))
    batch = jrb.DeviceBatch(
        xyw=jnp.asarray(xyw), z=jnp.asarray(z), color=jnp.asarray(color),
        specular=jnp.asarray(spec), uv=jnp.asarray(uv), fog=jnp.asarray(fog),
        state_idx=jnp.arange(it, dtype=jnp.int32),
        valid=jnp.asarray(rng.random(it) < 0.9),
        clip_rect=jnp.asarray(rng.uniform(0, 9, (it, 4)).astype(np.float32)),
        clipd=jnp.zeros((it, 3, 0), jnp.float32),
        refl=jnp.zeros((it, 3, 0), jnp.float32),
        planar={"c": cp, "clipd": None})
    defer = jnp.asarray(rng.random(it) < 0.4)
    transparent = jnp.asarray(rng.random(it) < 0.6)
    prio = jnp.asarray(rng.integers(-1, 2, it).astype(np.float32))
    return batch, defer, transparent, prio


@pytest.mark.parametrize("variant", ["plain", "priority", "unsorted",
                                     "cap_beyond_stream"])
def test_ordered_subset_matches_reference(variant):
    batch, defer, transparent, prio = _subset_batch(3)
    it = batch.valid.shape[0]
    cap = 128 if variant == "cap_beyond_stream" else 64
    if variant == "unsorted":
        transparent = jnp.zeros_like(transparent)
    p = prio if variant == "priority" else None
    ref = jfr.ordered_subset(batch, defer, transparent, cap, tri_priority=p)
    got = tfr.ordered_subset(
        convert.batch_from_reference(batch), _t(defer), _t(transparent),
        cap, tri_priority=None if p is None else _t(p))
    assert got.state_idx.shape[0] == cap
    np.testing.assert_array_equal(to_np(got.state_idx),
                                  np.asarray(ref.state_idx))   # permutation
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(ref.valid))
    for f in ("xyw", "z", "color", "clip_rect"):
        np.testing.assert_array_equal(to_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    assert 0 < int(to_np(got.valid).sum()) < it


def _quant_inputs(seed, h=16, w=24, want_ws=True):
    batch, si, sf, _fb, _zb, _h, _w = _peel_case(seed)
    tex_planes, _hw = peel_fx._tex()
    # Mip-capable table: (h, w, levels) columns.
    tex_hw = np.asarray([[8, 8, 3]], np.int32)
    rng = np.random.default_rng(seed)
    t = batch.xyw.shape[0]
    ids = rng.integers(-1, t, (h, w)).astype(np.int32)
    inv_det_s = rng.uniform(-2, 2, t).astype(np.float32)
    return batch, si, sf, tex_planes, tex_hw, ids, inv_det_s


@pytest.mark.parametrize("want_ws", [False, True])
def test_quant_rows_bit_equal(want_ws):
    batch, si, sf, _tp, tex_hw, ids, ivs = _quant_inputs(1)
    ref = jdf.shade_row_table_quant(
        batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
        batch.state_idx, inv_det_s=jnp.asarray(ivs), want_ws=want_ws)
    tb = convert.batch_from_reference(batch)
    got = tdf.shade_row_table_quant(
        tb.xyw, tb.color, tb.specular, tb.uv, tb.fog, tb.state_idx,
        inv_det_s=_t(ivs), want_ws=want_ws)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert (to_np(got) < 0).any()          # packed top bytes set the sign
    h, w = ids.shape
    tid = np.clip(ids, 0, None).reshape(-1)
    rows = np.where(ids[None] >= 0, np.asarray(ref)[tid].T.reshape(
        -1, h, w), 0).astype(np.int32)
    ref_x = jdf.expand_rows_quant(jnp.asarray(rows), jnp.asarray(si),
                                  jnp.asarray(sf), jnp.asarray(tex_hw),
                                  want_ws=want_ws, has_refl=False)
    got_x = tdf.expand_rows_quant(_t(rows), _t(si), _t(sf), _t(tex_hw),
                                  want_ws=want_ws, has_refl=False)
    np.testing.assert_array_equal(to_np(got_x), np.asarray(ref_x))


@pytest.mark.parametrize("hw,mips", [((16, 24), True), ((15, 24), True),
                                     ((16, 24), False)],
                         ids=["even_quad_lod", "odd_no_lod", "no_mips"])
def test_shade_rows_eplanes_matches_reference(hw, mips):
    h, w = hw
    batch, si, sf, tex_planes, tex_hw, ids, ivs = _quant_inputs(7, h, w)
    if not mips:
        tex_hw = tex_hw[:, :2]
    else:
        si[:, 9] = int(VXTEXTURE_FILTER.MIPLINEAR)        # SI_TEXFILTER
        tex_planes = np.concatenate([tex_planes, tex_planes[..., :4]], -1)
    tbl = np.asarray(jdf.shade_row_table_quant(
        batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
        batch.state_idx, inv_det_s=jnp.asarray(ivs), want_ws=True))
    tid = np.clip(ids, 0, None).reshape(-1)
    rows = np.where(ids[None] >= 0, tbl[tid].T.reshape(-1, h, w), 0).astype(
        np.int32)
    rng = np.random.default_rng(2)
    ep = rng.uniform(0.1, 4.0, (3, h, w)).astype(np.float32)
    profile = (True, mips, False, False, True)
    clear = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    fogc = np.asarray([0.2, 0.3, 0.4], np.float32)
    full = jdf.expand_rows_quant(jnp.asarray(rows), jnp.asarray(si),
                                 jnp.asarray(sf), jnp.asarray(tex_hw),
                                 want_ws=True, has_refl=False)
    ref = jdf.shade_rows(full, jnp.asarray(ids >= 0), jnp.asarray(tex_planes),
                         jnp.asarray(tex_hw), jnp.asarray(fogc),
                         jnp.asarray(clear), h, w, sampler_profile=profile,
                         eplanes=tuple(jnp.asarray(e) for e in ep))
    full_t = tdf.expand_rows_quant(_t(rows), _t(si), _t(sf), _t(tex_hw),
                                   want_ws=True, has_refl=False)
    got = tdf.shade_rows(full_t, _t(ids >= 0), _t(tex_planes), _t(tex_hw),
                         _t(fogc), _t(clear), h, w, sampler_profile=profile,
                         eplanes=tuple(_t(e) for e in ep))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=2e-6)


BLEND_CASES = ["seed1", "seed4", "clip_planes", "overflow"]


@pytest.fixture(scope="module")
def blend_results():
    """Reference (A, B, bad) and port (A, B, bad) of each fixture; the
    overflow case uses a one-class window of 40 slots."""
    out = {}
    for name in BLEND_CASES:
        key = "seed3" if name == "overflow" else name
        batch, si, sf, fb, zb, fogc, vp, h, w = _blend_case(key)
        if name == "overflow":
            batch = _ordered_batch(40, 64, 64, seed=3)
            h = w = 64
            zb = np.ones((h, w), np.float32)
            vp = np.asarray([0, 0, w, h], np.float32)
        kw = dict(windows=((40, 1),)) if name == "overflow" else {}
        fields = _fields(batch)
        ref = ordered_blend_tiled_pallas(
            *fields, jnp.asarray(si), jnp.asarray(sf), jnp.asarray(fogc),
            jnp.asarray(zb), jnp.asarray(vp), h, w, tile=16, interpret=True,
            **kw)
        tb = convert.batch_from_reference(batch)
        got = co.ordered_blend_tiled_cuda(
            *_fields(tb), _t(si), _t(sf), _t(fogc), _t(zb), _t(vp), h, w,
            tile=16, **kw)
        out[name] = (batch, si, sf, fb, zb, fogc, vp, h, w, ref, got)
    return out


@pytest.mark.parametrize("name", BLEND_CASES)
def test_blend_path_matches_pallas(blend_results, name):
    (batch, si, sf, fb, zb, fogc, vp, h, w, ref, got) = blend_results[name]
    a_r, b_r, bad_r = (np.asarray(x) for x in ref)
    a_g, b_g, bad_g = (to_np(x) for x in got)
    # No fixture is cut by the reference's dropped aligned-fit clause, so
    # the overflow flags agree.
    assert bool(bad_g) == bool(bad_r) == (name == "overflow")
    _assert_mostly_close(a_g, a_r, 2e-6, 1e-4)
    _assert_mostly_close(b_g, b_r, 2e-6, 1e-4)
    if name == "overflow":
        return
    fb_ref, _zb = jrb.render_pass(
        jnp.asarray(fb), jnp.asarray(zb), batch, jnp.asarray(si),
        jnp.asarray(sf), jnp.zeros((1, 4, 2, 2), jnp.float32),
        jnp.asarray([[2, 2]], jnp.int32), jnp.asarray(fogc), jnp.asarray(vp),
        chunk=1, sampler_profile=UNTEX)
    np.testing.assert_allclose(a_g * fb + b_g, np.asarray(fb_ref), atol=1e-4)
    assert (a_g < 1).mean() > 0.2


def test_phase_a_rejects_ids_beyond_f32():
    t = 1 << 24
    xyw = torch.zeros((1, 3, 3)).expand(t, 3, 3)       # no t-row storage
    with pytest.raises(ValueError, match="2\\^24"):
        co.phase_a(xyw, xyw[..., 0], None, None, None, None, None, None,
                   None, None, None, None, None, 8, 8)
