"""Antialias (the render manager's ``Antialias`` option) through ``Render()``
of both packages on the CPU, opaque scenes: the frame renders at twice its
size and box-resolves to it (fb by the mean of each 2x2 window, zb by its
minimum). The reference renders on its accelerator branch
(``tests/_torch_common.render_reference``), with its Pallas entries in
interpret mode.

- ``triangle``: the reference's ``tests/test_antialias.py`` triangle at
  64x64 (a flat frame at both sizes);
- ``config2``: config 2 at 128x95, flat at 1x and tiled at 2x (the
  quantized rows with B1's e-planes);
- ``level``: config 5 cut to 1,800 terrain triangles and two balls at
  128x96 (3,072 triangle slots after chunk culling): flat at 1x, tiled at
  2x.

Each is held to ``check_aa_frame_against_reference`` (the bounds of
``check_frame_against_reference`` per display pixel over its four
samples: winners equal on >= 99.9% of the samples and tied elsewhere,
depths within f32 rounding, colours within 1/255 on all but 0.1% of the
pixels whose samples all match). On the port alone: a 3D-only frame with
Antialias equals ``frame.box_resolve`` of the port's frame at twice the
size without it, bit for bit, the resolve matches the reference's
arithmetic to the last bit, and the option takes effect at the next
``Render()``.

A mip scene, an accumulate-mode frame and config 3 with its HUD are in
``tests/test_torch_antialias_rows.py``, the transparent scenes in
``tests/test_torch_antialias_ordered.py`` (each file stays under ~90 s).
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import deferred as tdf
from tests._torch_common import check_render, render_both, to_np


def build_triangle(O, size: int = 64, antialias: bool = False, **ctx_kw):
    """The emissive triangle of the reference's tests/test_antialias.py."""
    ctx = O.CKContext(**ctx_kw)
    rm = ctx.GetRenderManager()
    rm.SetRenderOptions("Antialias", int(antialias))
    rc = rm.CreateRenderContext(size, size)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 0.0, -1.6))
    rc.AttachViewpointToCamera(cam)
    rc.SetBackgroundColor((0.0, 0.0, 0.0, 1.0))
    mesh = O.CKMesh(ctx, "trimesh")
    mesh.SetPositions(np.array([[-1.0, -0.8, 0.0], [1.1, -0.5, 0.0],
                                [0.2, 1.0, 0.0]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1]], np.int32))
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "m")
    mat.SetEmissive((1.0, 1.0, 1.0, 1.0))
    mat.SetDiffuse((0.0, 0.0, 0.0, 1.0))
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, "tri")
    obj.SetCurrentMesh(mesh)
    return ctx, rc, obj


# name: (build, keywords, route at 1x, route at 2x)
CASES = {
    "triangle": (build_triangle, dict(size=64), "flat", "flat"),
    "config2": (scenes.build_config2, dict(width=128, height=95), "flat",
                "quant"),
    "level": (scenes.build_config5,
              dict(width=128, height=96, terrain_n=30, n_balls=2), "flat",
              "quant"),
}


def _route(monkeypatch, build, kw, antialias):
    """The opaque branch one port frame takes: "flat" (B2 and
    shade_deferred), "quant" or "compact" (B1 and that row table)."""
    calls = []
    for mod, name in ((tfr, "depth_reduce_cuda"),
                      (tfr, "depth_reduce_tiled_cuda"),
                      (tdf, "shade_row_table_quant"),
                      (tdf, "shade_row_table_compact")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rc = build(O, device="cpu", antialias=antialias, **kw)[1]
    rc.Render()
    monkeypatch.undo()
    if calls == ["depth_reduce_cuda"]:
        return "flat"
    tables = [c for c in calls if c.startswith("shade_row_table")]
    assert sorted(calls) == sorted(["depth_reduce_tiled_cuda"] + tables) \
        and len(tables) == 1, calls
    return tables[0].rsplit("_", 1)[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_follows_the_render_size(name, monkeypatch):
    build, kw, one, two = CASES[name]
    assert _route(monkeypatch, build, kw, False) == one
    assert _route(monkeypatch, build, kw, True) == two


@pytest.mark.parametrize("name", sorted(CASES))
def test_antialias_matches_accelerator_reference(name):
    build, kw, _one, _two = CASES[name]
    pair = render_both(build, antialias=True, **kw)
    rj, rt = pair[0], pair[1]
    assert tuple(rt.fb.shape) == (4, rt.height, rt.width)
    assert rt.zb.shape == (rt.height, rt.width) == np.asarray(rj.zb).shape
    tp = check_render(pair)
    assert tp["ss"] == 2


def test_triangle_edges_get_fractional_coverage():
    """The reference's test_antialias_flips_output_with_edge_coverage on
    the port: fractional values only on the edges of the AA frame, the
    interior and the far background as without AA."""
    hard = build_triangle(O, device="cpu")[1]
    soft = build_triangle(O, device="cpu", antialias=True)[1]
    hard.Render()
    soft.Render()
    r_hard, r_soft = hard.framebuffer()[..., 0], soft.framebuffer()[..., 0]
    assert not np.array_equal(r_hard, r_soft)

    def frac(img):
        return np.sum((img > 0.05) & (img < 0.95))

    assert frac(r_hard) == 0 and frac(r_soft) > 10
    assert ((r_hard > 0.95) & (r_soft > 0.95)).sum() > 1000
    assert ((r_hard < 0.05) & (r_soft < 0.05)).sum() > 100
    zb = soft.zbuffer()
    assert zb.shape == (64, 64) and np.all((zb >= 0.0) & (zb <= 1.0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_antialias_frame_is_the_resolve_of_the_double_frame(name):
    """A 3D-only scene: the AA frame at (H, W) equals box_resolve of the
    port's own frame at (2H, 2W) without AA, bit for bit (the same
    viewport, rects and routes; the resolve is the only step between)."""
    build, kw, _one, _two = CASES[name]
    aa = build(O, device="cpu", antialias=True, **kw)[1]
    aa.Render()
    big = {k: 2 * v if k in ("size", "width", "height") else v
           for k, v in kw.items()}
    double = build(O, device="cpu", **big)[1]
    double.Render()
    fb, zb = tfr.box_resolve(double.fb, double.zb)
    assert torch.equal(aa.fb, fb) and torch.equal(aa.zb, zb)


def test_box_resolve_is_the_window_mean_min_max():
    """fb: the four samples summed in row-major order, then / 4 (the
    reference's reduction order on the CPU: against jnp.mean of the
    windows, equal to the last bit); zb: minimum; sb: maximum."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    fb = (rng.standard_normal((4, 12, 18))
          * rng.choice([1e-3, 1.0, 1e3], (4, 12, 18))).astype(np.float32)
    zb = rng.random((12, 18), dtype=np.float32)
    sb = (rng.random((12, 18)) > 0.7).astype(np.uint8)
    f, z, s = tfr.box_resolve(torch.as_tensor(fb), torch.as_tensor(zb),
                              torch.as_tensor(sb))
    win = jnp.asarray(fb).reshape(4, 6, 2, 9, 2)
    assert np.array_equal(to_np(f), np.asarray(win.mean(axis=(-3, -1))))
    assert np.array_equal(to_np(z), zb.reshape(6, 2, 9, 2).min((1, 3)))
    assert np.array_equal(to_np(s), sb.reshape(6, 2, 9, 2).max((1, 3)))
    assert s.dtype == torch.uint8


def test_option_change_takes_effect_at_next_render():
    _c, rc, _o = build_triangle(O, device="cpu")
    rc.Render()
    hard = rc.framebuffer()
    rc.context.GetRenderManager().SetRenderOptions("Antialias", 1)
    rc.Render()
    soft = rc.framebuffer()
    rc.context.GetRenderManager().SetRenderOptions("Antialias", 0)
    rc.Render()
    assert np.array_equal(rc.framebuffer(), hard)
    assert not np.array_equal(soft, hard) and soft.shape == hard.shape
