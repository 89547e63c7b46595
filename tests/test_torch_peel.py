"""The textured ordered path of the port against the reference on the CPU:
phase A + the plain version of the peel kernel B4 against
``ordered_peel_tiled_pallas(interpret=True)``, ``_composite_peeled`` fed the
same layers in both packages, the iterated peel against the sequential pass,
and the textured transparency scene through ``Render()`` (the B4 branch).

Tolerances, and why:

- Layer ids equal on >= 99.9% of the pixels, the rest on fragment edges
  within f32 rounding; raw edge values, where the ids agree, within 1e-5
  plus twice their f32 forward-error bound, which here includes the
  rounding of the adjoint coefficients: each package sets the triangles up
  itself, and the reference contracts multiply-adds, the port never does.
- The composite of the same layers within 2e-6.
- Against the sequential pass 0.02, the reference test's bound: the
  quantized rows carry vertex colours at u8 (D3DCOLOR) precision.

The CUDA kernel B4 itself is held against its plain version on the card
by chip_smoke.py, on the cases of raster/ordered_fixtures.py."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import to_np
from tests import test_pallas_peel as peel_fx

from ckrenderengine_tpu.pipeline.frame import _composite_peeled as j_comp
from ckrenderengine_tpu.raster import jax_backend as jrb
from ckrenderengine_tpu.raster.pallas_ordered import (
    ordered_peel_tiled_pallas,
)
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from ckrenderengine_tpu_torch.raster import torch_backend as rb

PROFILE = (True, False, False, True, True, False, True)
FOG = np.asarray([0.2, 0.3, 0.4], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _fields(b):
    """The ordered kernels' batch arguments, in their order."""
    return (b.xyw, b.z, b.valid, b.color, b.specular, b.uv, b.fog,
            b.state_idx, b.clip_rect, b.clipd)


def _bounded(seed):
    """The tests/test_pallas_peel.py ``_run`` inputs of one seed."""
    h, w = 48, 96
    rng = np.random.default_rng(seed)
    si, sf = peel_fx._states()
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


def _stack9():
    """Nine stacked covering triangles (depth 9 > 2K): the reference's
    iterated-peel fixture."""
    rng = np.random.default_rng(11)
    si, sf = peel_fx._states()
    h = w = 32
    t = 9
    tri = np.array([[2.0, 2.0, 1.0], [30.0, 2.0, 1.0], [2.0, 30.0, 1.0]],
                   np.float32)
    batch = jrb.DeviceBatch(
        xyw=jnp.asarray(np.tile(tri[None], (t, 1, 1))),
        z=jnp.full((t, 3), 0.4, jnp.float32),
        color=jnp.asarray(rng.uniform(0, 1, (t, 3, 4)).astype(np.float32)),
        specular=jnp.zeros((t, 3, 3), jnp.float32),
        uv=jnp.asarray(rng.uniform(0, 1, (t, 3, 2)).astype(np.float32)),
        fog=jnp.ones((t, 3), jnp.float32),
        state_idx=jnp.asarray(rng.integers(0, 3, t).astype(np.int32)),
        valid=jnp.ones(t, bool),
        clip_rect=jnp.asarray(np.tile(
            np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32), (t, 1))),
        clipd=jnp.zeros((t, 3, 0), jnp.float32),
        refl=jnp.zeros((t, 3, 0), jnp.float32))
    fb = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    return batch, si, sf, fb, np.ones((h, w), np.float32), h, w


def _scenes(si, sf):
    tex_planes, tex_hw = peel_fx._tex()
    ref = peel_fx._scene_ns(si, sf, tex_planes, tex_hw)
    port = SimpleNamespace(state_i=_t(si), state_f=_t(sf),
                           tex_planes=_t(tex_planes), tex_hw=_t(tex_hw),
                           fog_color=_t(FOG), tex_quad=None)
    return ref, port


@pytest.fixture(scope="module")
def peeled():
    """Reference and port peel rounds (skip 0) of seeds 1 and 7."""
    out = {}
    for seed in (1, 7):
        batch, si, sf, fb, zb, h, w = _bounded(seed)
        vp = np.asarray([0, 0, w, h], np.float32)
        ref = ordered_peel_tiled_pallas(
            *_fields(batch), jnp.asarray(si), jnp.asarray(sf), jnp.asarray(zb),
            jnp.asarray(vp), h, w, tile=16, interpret=True)
        tb = convert.batch_from_reference(batch)
        got = co.ordered_peel_tiled_cuda(*_fields(tb), _t(si), _t(sf), _t(zb),
                                         _t(vp), h, w, tile=16)
        out[seed] = (batch, si, sf, fb, zb, h, w, ref, got)
    return out


_EPS32 = float(np.finfo(np.float32).eps)


def _fragment_edge_bound(lids, xyw, h, w):
    """(3,H,W) bound on |e_port - e_ref| for each pixel's recorded fragment
    (lids (H,W), -1 = none). Each package sets its triangles up itself, and
    the reference's setup contracts the adjoint cross products
    (a = y1*w2 - w1*y2, ...) into FMAs, so besides one evaluation of
    e = a*px + b*py + c (3 roundings of the largest term) each coefficient
    carries up to one rounding of its two products; twice the sum covers
    both packages."""
    py, px = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    v = xyw[np.clip(lids, 0, None)]                     # (H,W,3,3)
    out = []
    for j in range(3):
        p, q = v[..., (j + 1) % 3, :], v[..., (j + 2) % 3, :]
        x1, y1, w1 = p[..., 0], p[..., 1], p[..., 2]
        x2, y2, w2 = q[..., 0], q[..., 1], q[..., 2]
        a = y1 * w2 - w1 * y2
        b = w1 * x2 - x1 * w2
        c = x1 * y2 - y1 * x2
        err = 2 * _EPS32 * ((np.abs(y1 * w2) + np.abs(w1 * y2)) * px
                            + (np.abs(w1 * x2) + np.abs(x1 * w2)) * py
                            + np.abs(x1 * y2) + np.abs(y1 * x2))
        err += 3 * _EPS32 * (np.abs(a * px) + np.abs(b * py) + np.abs(c))
        out.append(np.where(lids >= 0, 2 * err, 0.0))
    return np.stack(out)


@pytest.mark.parametrize("seed", [1, 7])
def test_peel_layers_match_pallas(peeled, seed):
    batch, _si, _sf, _fb, _zb, h, w, ref, got = peeled[seed]
    lids_r, les_r, bad_r = (np.asarray(a) for a in ref)
    lids_g, les_g, bad_g = (to_np(a) for a in got)
    assert not bool(bad_r) and not bool(bad_g)
    same = lids_g == lids_r
    assert same.mean() >= 0.999, same.mean()
    xyw = np.asarray(batch.xyw, np.float64)
    near_edge = np.zeros((h, w), bool)
    for s in range(lids_r.shape[0]):
        for lids, les in ((lids_r[s], les_r[s]), (lids_g[s], les_g[s])):
            bound = _fragment_edge_bound(lids, xyw, h, w)
            near_edge |= np.any(np.abs(les) <= bound, axis=0) & (lids >= 0)
        bound = _fragment_edge_bound(np.where(same[s], lids_r[s], -1), xyw,
                                     h, w)
        diff = np.abs(les_g[s] - les_r[s])
        assert np.all(diff <= 1e-5 + bound), float((diff - bound).max())
    # Where the layer ids differ, a recorded fragment sits on one of its
    # edges: its coverage was decided by f32 rounding.
    assert np.all(near_edge[~same.all(0)])
    assert (lids_g[0] >= 0).sum() > 200


@pytest.mark.parametrize("seed", [1, 7])
def test_composite_same_layers_matches_reference(peeled, seed):
    batch, si, sf, fb, _zb, h, w, ref, _got = peeled[seed]
    lids, les, _bad = ref
    scene_r, scene_p = _scenes(si, sf)
    fb_r = j_comp(jnp.asarray(fb), batch, lids, les, scene_r, PROFILE, h, w)
    fb_p = tfr._composite_peeled(
        _t(fb), convert.batch_from_reference(batch), _t(lids), _t(les),
        scene_p, PROFILE, h, w)
    np.testing.assert_allclose(to_np(fb_p), np.asarray(fb_r), atol=2e-6)


@pytest.mark.parametrize("case", ["bounded_seed1", "stack9"])
def test_iterated_peel_matches_sequential(case):
    """The port's iterated peel (K = 4 layers per round) against the
    reference's sequential pass; the 9-deep stack runs three rounds."""
    batch, si, sf, fb, zb, h, w = (_stack9() if case == "stack9"
                                   else _bounded(1))
    scene_r, scene_p = _scenes(si, sf)
    vp = np.asarray([0, 0, w, h], np.float32)
    fb_ref, _ = jrb.render_pass(
        jnp.asarray(fb), jnp.asarray(zb), batch, jnp.asarray(si),
        jnp.asarray(sf), scene_r.tex_planes, scene_r.tex_hw,
        scene_r.fog_color, jnp.asarray(vp), chunk=1, sampler_profile=PROFILE)
    tb = convert.batch_from_reference(batch)

    def comp(f, lids, les):
        return tfr._composite_peeled(f, tb, lids, les, scene_p, PROFILE, h, w)

    fb_it, bad, rounds = co.ordered_peel_iterate(
        comp, _t(fb), *_fields(tb), _t(si), _t(sf), _t(zb), _t(vp), h, w,
        tile=16)
    assert not bad
    assert rounds == (3 if case == "stack9" else 1)
    np.testing.assert_allclose(to_np(fb_it), np.asarray(fb_ref), atol=0.02)


def test_peel_overflow_flags_and_orders_layers():
    """Six stacked triangles, one round: the per-pixel overflow joins the
    flag, and the four layers hold draws 0..3 in draw order."""
    batch, si, sf, _fb, zb, h, w = _stack9()
    tb = convert.batch_from_reference(batch)._replace(
        state_idx=torch.zeros(9, dtype=torch.int32))
    lids, _les, bad = co.ordered_peel_tiled_cuda(
        *(a[:6] for a in _fields(tb)), _t(si), _t(sf), _t(zb),
        _t([0, 0, w, h]), h, w, tile=16)
    assert bool(bad)
    cov = to_np(lids[0]) >= 0
    assert cov.sum() > 100
    for s in range(4):
        assert (to_np(lids[s])[cov] == s).all()


@pytest.fixture(scope="module")
def tex_frame():
    """The textured transparency scene, cut to 4 sheets of 392 triangles
    at 256x192 (ordered_cap*H*W > 2^26), through both packages' Render():
    the port takes B4's branch, the reference on the CPU its exact
    render_pass_tiled. This case keeps the reference's CPU Render(): its
    0.02 bound, on every pixel of the frame, already covers the D3DCOLOR
    quantization that the port's tiled opaque floor carries and the CPU
    reference's does not (at most 3/255 = 0.0118: 0.5/255 per corner for
    colour, specular and fog). (Camera and opaque floor are those of the
    untextured scene, whose frames tests/test_torch_ordered_frame.py holds
    against the reference's accelerator branch.)"""
    import ckrenderengine_tpu.objects as J
    import ckrenderengine_tpu_torch.objects as O

    kw = dict(width=256, height=192, sheet_n=14)
    _c, rj, _m = scenes.build_alpha_tex50k(J, **kw)
    rj.Render()
    _c, rt, _m = scenes.build_alpha_tex50k(O, device="cpu", **kw)
    rt.Render()
    return rj, rt


def test_textured_frame_takes_peel_and_matches(tex_frame):
    rj, rt = tex_frame
    params = rt._fill_packed([], [])[3]
    assert params["ordered_cap"] * rt.height * rt.width > 1 << 26
    assert params["sampler_profile"][6] and not params["sampler_profile"][5]
    stats = rt.GetStats()
    assert stats.OrderedPeelRounds == 1 and stats.OrderedReplays == 0
    fb = to_np(rt.fb)
    diff = np.abs(fb - np.asarray(rj.fb)).max(0)
    assert diff.max() <= 0.02, float(diff.max())
    assert (fb != fb[:, :1, :1]).any(0).mean() > 0.5


def test_port_batch_conversion_is_bit_exact():
    batch, *_ = _bounded(7)
    tb = convert.batch_from_reference(batch)
    assert isinstance(tb, rb.DeviceBatch)
    for name, a in zip(rb.DeviceBatch._fields, tb):
        np.testing.assert_array_equal(to_np(a), np.asarray(getattr(batch,
                                                                   name)))
