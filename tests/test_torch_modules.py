"""Port modules against the reference package on the CPU: packed-buffer
unpack, world composition, the vertex stage (transform + lighting + fog),
and triangle assembly + setup. Inputs are made with numpy from a seed (or
compiled once by the reference's host layer) and fed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import to_np

import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.pipeline import frame as jfr
from ckrenderengine_tpu.pipeline import packing as jpk
from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.scene import entity_table as jet
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.pipeline import packing as tpk
from ckrenderengine_tpu_torch.raster import deferred as tdf
from ckrenderengine_tpu_torch.scene import entity_table as tet


def test_unpack_matches_reference():
    rng = np.random.default_rng(0)
    lay = tpk.DynLayout()
    lay.add_f("local", (5, 4, 4))
    lay.add_i("vis", (5,))
    lay.add_f("scalar", ())
    lay.add_i("mode", ())
    lay.add_f("planes", (2, 4))
    key = lay.freeze()
    vals = {"local": rng.normal(size=(5, 4, 4)),
            "vis": rng.integers(0, 2, 5), "scalar": 3.5, "mode": 2,
            "planes": rng.normal(size=(2, 4))}
    bf, bi = lay.make_buffers()
    tpk.fill(bf, bi, key, vals)
    ref = jpk.unpack(jnp.asarray(bf), jnp.asarray(bi), key)
    got = tpk.unpack(torch.as_tensor(bf), torch.as_tensor(bi), key)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(ref[k]))
    assert tpk.has_field(key, "planes") and not tpk.has_field(key, "nope")


@pytest.mark.parametrize("deep", [False, True], ids=["levels", "doubling"])
def test_compose_world_matches_reference(deep):
    """Level-batched matmuls (and pointer doubling past 12 levels)."""
    rng = np.random.default_rng(1 + deep)
    n = 40
    parent = np.full(n, -1, np.int32)
    if deep:
        parent[1:16] = np.arange(15)        # a 16-deep chain
        parent[16:] = rng.integers(0, 16, n - 16)
    else:
        parent[4:] = rng.integers(0, 4, n - 4)
        parent[20:] = rng.integers(4, 20, n - 20)
    local = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    local[:, :3, :3] += rng.normal(0, 0.2, (n, 3, 3)).astype(np.float32)
    local[:, 3, :3] = rng.normal(0, 2, (n, 3)).astype(np.float32)
    levels = tuple(tuple(int(i) for i in lv)
                   for lv in jet.compute_levels(parent))
    assert (len(levels) > 12) == deep
    ref = jet.compose_world(jnp.asarray(local), jnp.asarray(parent), levels)
    got = tet.compose_world(torch.as_tensor(local), torch.as_tensor(parent),
                            levels)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def lit_fogged_scene():
    """Config-2-like scene (two lights, specular, texture) with linear fog,
    compiled once by the reference's host layer."""
    _, rc, _ = scenes.build_config2(J, width=160, height=120)
    rc.SetFogMode(3)
    rc.SetFogStart(4.0)
    rc.SetFogEnd(12.0)
    rc.SetFogColor((0.3, 0.4, 0.5))
    rc.Render()
    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    ref_scene, _sp, _d = jfr.unpack_scene(static, jnp.asarray(dyn_f),
                                          jnp.asarray(dyn_i),
                                          params["layout"])
    st, tf, ti, tp = convert.from_reference(
        {k: np.asarray(v) for k, v in static.items()}, dyn_f, dyn_i, params,
        "cpu")
    port_scene, _d2 = tfr.unpack_scene(st, tf, ti, tp["layout"])
    return ref_scene, port_scene, params


def test_transform_and_light_matches_reference(lit_fogged_scene):
    ref_scene, port_scene, params = lit_fogged_scene
    ref = jfr.transform_and_light(ref_scene, params["levels"],
                                  corner=params["corner"],
                                  want_texgen=False)
    got = tfr.transform_and_light(port_scene, params["levels"],
                                  corner=params["corner"])
    # clip, color, spec, fog, world, uv
    names = ("clip", "color", "spec", "fog", "world", "uv")
    for name, r, g in zip(names, ref[:6], got[:6]):
        r = np.asarray(r)
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(to_np(g), r, rtol=0, atol=2e-6 * scale,
                                   err_msg=name)
    fog = np.asarray(ref[3])
    assert fog.min() < 0.99 and fog.max() > 0.0     # fog really varies
    assert np.asarray(ref[2]).max() > 0.01          # specular is lit


def test_assemble_and_setup_match_reference(lit_fogged_scene):
    ref_scene, port_scene, params = lit_fogged_scene
    corner = params["corner"]
    r_clip, r_col, r_spec, r_fog, _, r_uv, r_cd, r_rf = \
        jfr.transform_and_light(ref_scene, params["levels"], corner=corner,
                                want_texgen=False)
    g_clip, g_col, g_spec, g_fog, _, g_uv, g_cd, g_rf = \
        tfr.transform_and_light(port_scene, params["levels"], corner=corner)
    rb = jfr.assemble_triangles(ref_scene, r_clip, r_col, r_spec, r_fog,
                                r_uv, r_cd, r_rf, corner=corner)
    gb = tfr.assemble_triangles(port_scene, g_clip, g_col, g_spec, g_fog,
                                g_uv, g_cd, g_rf, corner=corner)
    np.testing.assert_array_equal(to_np(gb.valid), np.asarray(rb.valid))
    np.testing.assert_array_equal(to_np(gb.state_idx),
                                  np.asarray(rb.state_idx))
    for name in ("xyw", "z", "color", "specular", "uv", "fog", "clip_rect"):
        r = np.asarray(getattr(rb, name))
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(to_np(getattr(gb, name)), r, rtol=0,
                                   atol=4e-6 * scale, err_msg=name)
    rs = jdf.triangle_setup(rb.xyw, rb.z, rb.state_idx, rb.valid,
                            ref_scene.state_i, clip_rect=rb.clip_rect,
                            clipd=rb.clipd, planar=rb.planar)
    # Setup from the SAME corner values (converted reference batch), so the
    # comparison isolates the setup arithmetic.
    gs = tdf.triangle_setup(torch.as_tensor(np.asarray(rb.xyw)),
                            torch.as_tensor(np.asarray(rb.z)),
                            torch.as_tensor(np.asarray(rb.state_idx)),
                            torch.as_tensor(np.asarray(rb.valid)),
                            torch.as_tensor(np.asarray(ref_scene.state_i)),
                            clip_rect=torch.as_tensor(np.asarray(rb.clip_rect)),
                            clipd=torch.as_tensor(np.asarray(rb.clipd)))
    for k in ("valid", "top_left"):
        np.testing.assert_array_equal(to_np(gs[k]), np.asarray(rs[k]),
                                      err_msg=k)
    for k in ("e9", "z", "inv_det_s", "esum_plane", "s", "det", "zplane"):
        r = np.asarray(rs[k])
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(to_np(gs[k]), r, rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=k)
    assert int(np.asarray(rs["valid"]).sum()) > 100
