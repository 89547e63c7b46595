"""Framebuffer bands on the port (``CKRenderContext.SetTileSharding``,
``parallel.tile_shard``), on the CPU, where every band runs the plain
versions of the kernels at its row offset on a mesh that names the CPU
once per band:

- the reference's own band scene (tests/test_tile_sharding.py:13-66: a
  textured cube, fog, a transparent quad) at 64x64 in 8 bands equal to the
  unbanded frame bit for bit, and with Antialias in 4 bands;
- the same scene's banded frame against the reference's banded frame
  (``SetTileSharding(8)`` on its 8 virtual devices) by
  ``_torch_common.check_render``;
- a tiled-route frame (config 2 cut to 192x128: 3,074 triangles x 24,576
  pixels > 2^26) in 4 bands through phase A, the plain B1 with e-planes and
  the quantized rows, and with caps so small that the exact remainder runs;
- a mip frame of even size (config 2 with mips at 192x120) in 8 bands of 15
  rows: each band renders a halo row on its odd side so that its 2x2 quads
  are the whole frame's;
- the three ordered passes in bands: B3's plain version (alpha sheets), the
  iterated plain B4 (textured sheets under TexturedPeel) and the exact
  tiled pass (the same sheets without it);
- background and foreground 2D quads and a curve's line bank that cross
  the bands' edges;
- frames with a stencil plane or that accumulate render unbanded, a banded
  stereo frame takes the eager fallback; scene changes show, band counts
  the height does not divide are refused, 0 restores one device, and a
  mesh refuses a device that does not exist.
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.parallel import tile_shard
from ckrenderengine_tpu_torch.parallel.mesh import DeviceMesh
from ckrenderengine_tpu_torch.raster import deferred as df
from ckrenderengine_tpu_torch.raster.types import VXLIGHT

from _torch_common import check_render, render_both


def cube_scene(P, width=64, height=64, antialias=False, bands=0,
               quad_zwrite=True, **ctx_kw):
    """tests/test_tile_sharding.py's scene through package ``P``: a
    textured, rotated cube in fog behind a transparent quad. ``bands``:
    the context renders in that many bands (the reference over its
    virtual devices, the port over the CPU named once per band).
    ``quad_zwrite`` off: the quad leaves the opaque depths in zb. Returns
    (ctx, rc, cube)."""
    ctx = P.CKContext(**ctx_kw)
    if antialias:
        ctx.GetRenderManager().SetRenderOptions("Antialias", 1)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 1.0, -5.0))
    rc.AttachViewpointToCamera(cam)
    rc.SetBackgroundColor((0.1, 0.15, 0.2, 1.0))
    rc.SetFogMode(3)
    rc.SetFogStart(2.0)
    rc.SetFogEnd(12.0)
    tex = P.CKTexture(ctx, "checker")
    img = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img, img, img, np.ones_like(img)], -1))
    s = 0.8
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32)
    faces = np.array([
        [0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
        [2, 6, 7], [2, 7, 3], [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5],
    ], np.int32)
    mesh = P.CKMesh(ctx, "cube")
    mesh.SetPositions(verts)
    mesh.SetFaces(faces)
    mesh.SetUVs((verts[:, :2] * 0.5 + 0.5).astype(np.float32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "m")
    mat.SetDiffuse((0.9, 0.5, 0.3, 1.0))
    mat.SetTexture(tex)
    mesh.ApplyGlobalMaterial(mat)
    cube = P.CK3dObject(ctx, "cube")
    cube.SetCurrentMesh(mesh)
    cube.Rotate((1, 1, 0), 0.6)
    tq = P.CKMesh(ctx, "tq")
    tq.SetPositions(np.array([[-1, -1, -1.5], [1, -1, -1.5], [1, 1, -1.5],
                              [-1, 1, -1.5]], np.float32))
    tq.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    tq.BuildNormals()
    tmat = P.CKMaterial(ctx, "tm")
    tmat.SetDiffuse((0.2, 0.9, 0.4, 0.5))
    tmat.EnableAlphaBlend(True)
    tmat.EnableZWrite(quad_zwrite)
    tq.ApplyGlobalMaterial(tmat)
    P.CK3dObject(ctx, "tq").SetCurrentMesh(tq)
    sun = P.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.3, -1.0, 0.5))
    if bands:
        devices = ["cpu"] * bands if P is O else None
        assert rc.SetTileSharding(bands, devices=devices)
    return ctx, rc, cube


def _cpu_bands(n):
    return ["cpu"] * n


class _Spy:
    """Counts the banded frames (``render_frame_packed_banded``) and the
    bands' row offsets while installed."""

    def __init__(self, monkeypatch):
        self.frames, self.row0s = 0, []
        real = tile_shard.render_frame_packed_banded
        frame = tile_shard.fr.render_frame_packed_impl

        def banded(*a, **k):
            self.frames += 1
            return real(*a, **k)

        def band(*a, y_shift=None, **k):
            self.row0s.append(y_shift)
            return frame(*a, y_shift=y_shift, **k)

        monkeypatch.setattr(tile_shard, "render_frame_packed_banded", banded)
        monkeypatch.setattr(tile_shard.fr, "render_frame_packed_impl", band)


def _banded_equals_whole(rc, n, monkeypatch=None, frames=1):
    """Render ``rc`` whole, then in ``n`` bands over the CPU, ``frames``
    times each; every banded fb / zb must equal the whole frame's bit for
    bit. Returns the spy (with ``monkeypatch``) or None."""
    rc.Render()
    fb, zb = rc.fb.clone(), rc.zb.clone()
    spy = None if monkeypatch is None else _Spy(monkeypatch)
    assert rc.SetTileSharding(n, devices=_cpu_bands(n))
    for _ in range(frames):
        rc.Render()
        assert torch.equal(rc.fb, fb) and torch.equal(rc.zb, zb)
    assert rc.fb.device == fb.device
    if spy is not None:
        assert spy.frames == frames
    return spy


def test_banded_equals_unbanded(monkeypatch):
    """The reference's band scene in 8 bands: bit-equal, each band at its
    row offset, and twice in a row (the static copies are kept)."""
    _ctx, rc, _cube = cube_scene(O, device="cpu")
    spy = _banded_equals_whole(rc, 8, monkeypatch, frames=2)
    assert spy.row0s == list(range(0, 64, 8)) * 2
    assert rc.GetTileSharding() == 8
    assert list(rc._band_copies) == [torch.device("cpu")]


def test_banded_composes_with_antialias(monkeypatch):
    """Antialias in 4 bands: each band renders 32 rows at twice its row
    offset and resolves them itself; bit-equal to the unbanded frame,
    which differs from the 1x frame at the edges."""
    _ctx, rc, _cube = cube_scene(O, antialias=True, device="cpu")
    spy = _banded_equals_whole(rc, 4, monkeypatch)
    assert spy.row0s == [0, 16, 32, 48]
    aa = rc.fb.clone()
    rc.context.GetRenderManager().SetRenderOptions("Antialias", 0)
    rc.Render()
    assert (rc.fb - aa).abs().max() > 0.05


def test_banded_against_reference():
    """The port's 8 bands against the reference's 8 (its shard_map over 8
    virtual CPU devices), within the port's bounds (which read the opaque
    depths from zb: the quad writes no z here)."""
    pair = render_both(cube_scene, accelerator=False, bands=8,
                       quad_zwrite=False)
    assert pair[0].GetTileSharding() == 8 == pair[1].GetTileSharding()
    check_render(pair)


def test_tiled_route_bands(monkeypatch):
    """Config 2 at 192x128 takes the tiled route (B1 with e-planes, the
    quantized rows) in every band, whose own size would be flat; with caps
    under the live pairs the exact remainder runs in the bands too."""
    from ckrenderengine_tpu_torch.raster import cuda_tiled

    _ctx, rc, _ball = scenes.build_config2(O, 192, 128, device="cpu")
    calls = []
    real = cuda_tiled.depth_reduce_tiled_cuda

    def solve(*a, row0=0, host_stats=None, **k):
        stats = {} if host_stats is None else host_stats
        out = real(*a, row0=row0, host_stats=stats, **k)
        calls.append((row0, stats["SolveBinStats"][2:5]))
        return out

    monkeypatch.setattr(cuda_tiled, "depth_reduce_tiled_cuda", solve)
    from ckrenderengine_tpu_torch.pipeline import frame as fr
    monkeypatch.setattr(fr, "depth_reduce_tiled_cuda", solve)
    _banded_equals_whole(rc, 4)
    assert [r for r, _ in calls[1:]] == [0, 32, 64, 96]
    rc.SetTileSharding(0)
    rc._solve_caps = (256, 256, 64)
    calls.clear()
    _banded_equals_whole(rc, 4)
    assert sum(map(sum, (b for _r, b in calls[1:]))) > 0   # remainders ran


def test_odd_band_height_on_a_mip_frame(monkeypatch):
    """A mip frame of even size (config 2 with mips, 192x120) takes its LOD
    from 2x2 quads; in 8 bands of 15 rows every band that starts or ends on
    an odd row renders one halo row there, and the frame stays bit-equal."""
    _ctx, rc, _ball = scenes.build_config2(O, 192, 120, mips=True,
                                           device="cpu")
    quads = []
    real = df.shade_rows

    def shade(*a, quad=None, **k):
        quads.append(quad)
        return real(*a, quad=quad, **k)

    monkeypatch.setattr(df, "shade_rows", shade)
    spy = _banded_equals_whole(rc, 8, monkeypatch)
    assert quads and all(q is True for q in quads)
    assert spy.row0s == [0, 14, 30, 44, 60, 74, 90, 104]
    assert tile_shard.band_rows(120, 8, True)[1] == (15, 15, 14, 30)


@pytest.mark.parametrize("kind", ["blend", "peel", "tiled"])
def test_ordered_passes_in_bands(kind, monkeypatch):
    """The alpha sheets (B3's plain version), the textured sheets under
    TexturedPeel (the iterated plain B4) and without it (the exact tiled
    pass), cut to 2 small sheets at 160x120 in 4 bands: bit-equal, and the
    route is the whole frame's. The ordered pass's slot count is raised
    past 2^26 / (H*W), where the frame leaves the exact flat pass for these
    routes (the extra slots hold no triangle)."""
    from ckrenderengine_tpu_torch.pipeline import frame as fr

    kw = dict(width=160, height=120, n_sheets=2, sheet_n=10, device="cpu")
    if kind == "blend":
        _c, rc, _s = scenes.build_alpha50k(O, **kw)
    else:
        ctx, rc, _s = scenes.build_alpha_tex50k(O, **kw)
        if kind == "tiled":
            ctx.GetRenderManager().SetRenderOptions("TexturedPeel", 0)
    rc.Render()
    c = rc._compiled
    c.ordered_cap = max(c.ordered_cap, (1 << 26) // (160 * 120) + 1)
    routes = []
    real = fr.ordered_route

    def route(*a, **k):
        routes.append(real(*a, **k))
        return routes[-1]

    monkeypatch.setattr(fr, "ordered_route", route)
    _banded_equals_whole(rc, 4)
    assert set(routes) == {kind}


def _curve(ctx):
    """A closed curve across the cube scene's frame, drawn as lines."""
    cv = O.CKCurve(ctx, "rail")
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    for a in ang:
        cv.AddControlPoint(np.asarray((1.6 * np.cos(a), 1.2 * np.sin(a),
                                       -0.5), np.float32))
    cv.Close()
    cv.SetStepCount(40)
    cv.SetColor((1.0, 0.9, 0.2, 1.0))


def test_quads_and_lines_across_band_edges():
    """tests/test_torch_overlay.py's HUD (background and foreground
    sprites, a clipped child, a text label, a flat entity) over config 1
    at 96x96 with a curve's lines, in 4 bands whose edges the quads and
    the lines cross: bit-equal."""
    from test_torch_overlay import build_hud

    ctx, rc, _txt = build_hud(O, device="cpu")
    _curve(ctx)
    rc.Render()
    assert rc._compiled.line_bank is not None
    assert len(rc._quad_lists()[0]) == 2 and len(rc._quad_lists()[1]) == 4
    _banded_equals_whole(rc, 4)


def test_stencil_accumulate_and_stereo_render_unbanded(monkeypatch):
    """A frame with a stencil plane and one that accumulates render
    unbanded (the reference's rule); a banded stereo frame takes the eager
    fallback with unbanded eyes."""
    _c, rc, _ball = scenes.build_stencil(O, 64, 48, device="cpu")
    rc.Render()
    fb, sb = rc.fb.clone(), rc.sb.clone()
    spy = _Spy(monkeypatch)
    assert rc.SetTileSharding(4, devices=_cpu_bands(4))
    rc.Render()
    assert spy.frames == 0
    assert torch.equal(rc.fb, fb) and torch.equal(rc.sb, sb)

    _ctx, rc, cube = cube_scene(O, device="cpu")
    rc.Render()
    rc.SetClearBackground(False)
    cube.Rotate((0, 1, 0), 0.3)
    rc.Render()
    acc = rc.fb.clone()
    _ctx, rc2, cube2 = cube_scene(O, bands=4, device="cpu")
    spy = _Spy(monkeypatch)
    rc2.Render()
    rc2.SetClearBackground(False)
    cube2.Rotate((0, 1, 0), 0.3)
    rc2.Render()
    assert spy.frames == 1 and torch.equal(rc2.fb, acc)

    _ctx, rc3, _cube = cube_scene(O, bands=4, device="cpu")
    rc3.SetStereoParameters(0.2, 2.0)
    spy = _Spy(monkeypatch)
    rc3.Render()
    assert rc3.GetStats().StereoEagerFallback and spy.frames == 0
    fb3 = rc3.fb.clone()
    rc3.SetTileSharding(0)
    rc3._render_stereo([], [])
    assert torch.equal(rc3.fb, fb3)


def test_scene_changes_refusals_and_disable():
    """The reference's remaining band tests (tests/test_tile_sharding.py:
    68-94) on the port: a banded context follows its scene; a height the
    bands do not divide and more bands than devices are refused; 0
    renders on one device again; a mesh refuses a device that does not
    exist here."""
    _ctx, rc, cube = cube_scene(O, bands=4, device="cpu")
    rc.Render()
    fb0 = rc.fb.clone()
    cube.Rotate((0, 1, 0), 0.8)
    rc.Render()
    assert (rc.fb - fb0).abs().sum() > 1.0
    whole = rc.fb.clone()
    assert rc.SetTileSharding(0) and rc.GetTileSharding() == 0
    rc.Render()
    assert torch.equal(rc.fb, whole)

    _ctx, rc60, _c = cube_scene(O, width=64, height=60, device="cpu")
    assert not rc60.SetTileSharding(8, devices=_cpu_bands(8))   # 60 % 8
    assert not rc60.SetTileSharding(2)        # a CPU context: one device
    assert rc60.SetTileSharding(0) and rc60.SetTileSharding(1)
    assert rc60.GetTileSharding() == 0
    with pytest.raises(ValueError, match="not divisible"):
        tile_shard.render_frame_packed_banded(
            {}, None, None, (), (), 60, 64, DeviceMesh(_cpu_bands(8)))
    for bad in (["cuda:0"], ["meta"], []):
        with pytest.raises(ValueError):
            DeviceMesh(bad)
    with pytest.raises(ValueError):
        rc.SetTileSharding(2, devices=["cpu", "cuda:3"])
