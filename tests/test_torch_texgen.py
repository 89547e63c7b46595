"""TexGen, EMBM and the world reflection vector in the port's vertex stage,
and the material-effects level (``scenes.build_config5_mat``) cut down,
port against reference on the CPU.

- ``oct_encode`` on seeded unit vectors, the six axes, the z = 0 circle
  and signed zeros: within 2^-23 of the reference (the three-term |r| sum
  may round apart by an ULP where the reference's XLA reduces it in
  another order; the result is r / sum * 0.5 + 0.5 in [0, 1]).
- ``transform_and_light`` with each static gate (TexGen alone, cube env,
  EMBM, all three) on the reference's own packed inputs through
  ``convert.from_reference``: every output within 1e-5 * (1 + |x|) of the
  reference's (the reference's jit contracts multiply-adds, the port never
  does), each TexGen mode present in the scene's vertex states, and the
  world reflection vectors exported only for TEXGEN_CUBE rows.
- A scene without material effects keeps every gate off, and its
  triangle batch carries no reflection columns.
- ``build_config5_mat`` at 128x96 (a 16x16 terrain, 4 spheres, the 24
  cube-env crates, a 32x32 reflection-TexGen water sheet — 4,768
  triangles, so the tiled solve and the quantized rows with their 9
  reflection words — and a 4x4 planar-TexGen plaza whose two channels
  take the exact ordered pass) through both packages' ``Render()``, held
  to ``check_render`` with the pixels of ``fx_explained`` (ill-conditioned
  edges of ordered triangles) left to the 0.1% budget. The reference
  renders with its depth-tie window widened to 1,024 ULP
  (``tests/_torch_common.tie_window`` says why: at 2 ULP its jitted
  frame blends a channel's alpha but not its RGB on a third of the
  plaza's pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.math import vxmath as jvx
from ckrenderengine_tpu.pipeline import frame as jfr
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.math import vxmath as tvx
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster.types import (
    SI_TEX2, SI_TEXGEN, TEXGEN_CHROME, TEXGEN_CUBE, TEXGEN_PLANAR,
    TEXGEN_REFLECT,
)
from tests._torch_common import check_render, fx_explained, render_both

SMALL = dict(width=96, height=72, terrain_n=4, n_balls=2, water_n=4,
             plaza_n=4, pass_n=2, effect_passes=True)
LEVEL = dict(width=128, height=96, terrain_n=16, n_balls=4, water_n=32,
             plaza_n=4)
TIE_ULPS = 1024


def test_oct_encode_matches_reference():
    rng = np.random.default_rng(11)
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, 64).astype(np.float32)
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1], [0.0, -0.0, -1.0],
                     [-0.0, 0.0, 1.0]], np.float32)
    v = np.concatenate([v / np.linalg.norm(v, axis=-1, keepdims=True), ring,
                        axes]).astype(np.float32)
    ref = np.asarray(jvx.oct_encode(jnp.asarray(v)))
    got = tvx.oct_encode(torch.as_tensor(v)).numpy()
    assert got.shape == ref.shape == (v.shape[0], 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -23)
    assert np.all((got >= 0) & (got <= 1))


@pytest.fixture(scope="module")
def small_inputs():
    """The reference's packed inputs of the small effect-pass scene (every
    TexGen mode, cube env and EMBM), after one CPU Render()."""
    _c, rj, _m = scenes.build_config5_mat(J, **SMALL)
    rj.Render()
    static, dyn_f, dyn_i, params = rj._fill_packed([], [])
    scene_j = jfr.unpack_scene(static, jnp.asarray(dyn_f),
                               jnp.asarray(dyn_i), params["layout"])[0]
    st, tf, ti, tp = convert.from_reference(
        {k: np.asarray(v) for k, v in static.items()}, dyn_f, dyn_i, params,
        "cpu")
    scene_t = tfr.unpack_scene(st, tf, ti, tp["layout"])[0]
    return scene_j, scene_t, params


@pytest.mark.parametrize("gates", [
    dict(want_texgen=True), dict(want_texgen=False, want_cube=True),
    dict(want_texgen=False, want_bump=True),
    dict(want_texgen=True, want_cube=True, want_bump=True)],
    ids=["texgen", "cube", "embm", "all"])
def test_transform_and_light_matches_reference(small_inputs, gates):
    scene_j, scene_t, params = small_inputs
    assert params["want_texgen"] and params["want_cube"] \
        and params["want_bump"]
    # Every TexGen mode and the bump fetch have vertices in the stream.
    vstate = np.asarray(scene_j.vert_state)
    si = np.asarray(scene_j.state_i)
    modes = set(si[vstate, SI_TEXGEN].tolist())
    assert {TEXGEN_PLANAR, TEXGEN_REFLECT, TEXGEN_CHROME,
            TEXGEN_CUBE} <= modes
    assert (si[vstate, SI_TEX2] >= 0).any()
    out_j = jfr.transform_and_light(scene_j, params["levels"], **gates)
    out_t = tfr.transform_and_light(scene_t, params["levels"], **gates)
    names = ("clip", "color", "spec", "fog", "world", "uv", "clipd",
             "refl")
    for name, a, b in zip(names, out_j, out_t):
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a, np.float64)
        b = b.numpy().astype(np.float64)
        assert a.shape == b.shape, name
        assert np.all(np.abs(a - b) <= 1e-5 * (1 + np.abs(a))), (
            name, float(np.abs(a - b).max()))
    refl = out_t[7]
    if not gates.get("want_cube"):
        assert refl is None
        return
    cube = torch.as_tensor(si[vstate, SI_TEXGEN] == TEXGEN_CUBE)
    assert cube.any() and (~cube).any()
    assert torch.all(refl[~cube] == 0)
    n = torch.linalg.vector_norm(refl[cube], dim=-1)
    assert torch.allclose(n, torch.ones_like(n), atol=1e-5)
    # The UV of a cube row is the octahedral code of its reflection vector.
    uv = out_t[5][cube]
    np.testing.assert_array_equal(uv.numpy(),
                                  tvx.oct_encode(refl[cube]).numpy())


def test_scene_without_effects_keeps_the_gates_off():
    import ckrenderengine_tpu_torch.objects as O

    _c, rc, _m = scenes.build_config5(O, device="cpu", width=64, height=48,
                                      terrain_n=4, n_balls=2)
    rc.Render()
    c = rc._compiled
    assert not (c.want_texgen or c.want_cube or c.want_bump)
    st, tf, ti, tp = rc._fill_packed([], [])
    _s, batch, *_ = tfr.packed_setup(st, torch.as_tensor(tf),
                                     torch.as_tensor(ti), tp)
    assert batch.refl.shape[-1] == 0


@pytest.fixture(scope="module")
def level():
    return render_both(scenes.build_config5_mat, tie_ulps=TIE_ULPS, **LEVEL)


def test_level_takes_the_reflection_rows(level):
    rj, rt, _packed, _ref = level
    c = rt._compiled
    assert c.want_texgen and c.want_cube and not c.want_bump
    assert c.tri_idx.shape[0] > 4096                    # the tiled solve
    st, tf, ti, tp = rt._fill_packed([], [])
    _s, batch, setup, *_ = tfr.packed_setup(st, torch.as_tensor(tf),
                                            torch.as_tensor(ti), tp)
    assert batch.refl.shape[1:] == (3, 3)
    from ckrenderengine_tpu_torch.raster import deferred as df

    tbl = df.shade_row_table_quant(
        batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
        batch.state_idx, batch_refl=batch.refl,
        inv_det_s=setup["inv_det_s"], want_ws=not tp["sampler_profile"][3])
    assert tbl.shape[1] == 24
    assert tfr.ordered_route(c.ordered_cap, rt.height, rt.width,
                             tp["sampler_profile"]) == "flat"
    for name in ("NbTrianglesDrawn", "NbObjectDrawn"):
        assert getattr(rt.GetStats(), name) == getattr(rj.GetStats(), name)


def test_level_matches_reference(level):
    check_render(level, explained=fx_explained(level))


def test_port_queue_has_no_material_effects_item():
    """Item 9 (material effects) is carried: no key in PORT_QUEUE and no
    ``unported(..., 9)`` in the port; the other items stay."""
    import pathlib
    import re

    import ckrenderengine_tpu_torch
    from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE

    assert 9 not in PORT_QUEUE
    assert set(PORT_QUEUE) == {1, 14}
    root = pathlib.Path(ckrenderengine_tpu_torch.__file__).parent
    cites = re.compile(r"unported\([^()]*(\([^()]*\)[^()]*)*,\s*9\s*\)")
    for path in root.rglob("*.py"):
        assert not cites.search(path.read_text()), path
