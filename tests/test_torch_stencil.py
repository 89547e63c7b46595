"""The stencil pass through ``Render()`` of both packages on the CPU: the
z-tested coverage of ``VX_MOVEABLE_STENCILONLY`` draws, ``sb``.

The port solves the stencil triangles with its own solve — B2 on a flat
frame, B1 at the frame's caps otherwise (their plain versions here) —
where the reference takes its plain ``deferred.depth_reduce``. The three
differ only in which id wins an exact depth tie; ``sb`` reads whether a
stencil triangle covers the pixel and at what depth, so it must equal the
reference's exactly:

- the two cases of the reference's ``tests/test_draw_kinds.py``: the mask
  is written and the colour is not; the mask is z-tested;
- a flat frame (config 1 and a stencil quad partly behind the cube, 96x96)
  and a tiled one (``scenes.build_stencil``: config 2 and a stencil quad
  partly behind the sphere, 176x125), each launching its solve twice, and
  two coplanar overlapping stencil quads (every overlapped pixel an exact
  tie): ``sb`` equal to the reference's on every pixel;
- adding the stencil entity leaves fb and zb bit for bit as they were;
- with Antialias (``build_stencil`` at 128x95, rendered at 256x190) ``sb``
  resolves by the window maximum: equal to the reference's, and to the
  maximum of the port's own 2x mask.

The reference renders on its accelerator branch where the frame is tiled
(``tests/_torch_common.render_reference``), on the CPU where it is flat.
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from tests._torch_common import render_reference, to_np, win_max


def _quad(O, ctx, name, z, color):
    """The two-sided 2x2 quad of tests/test_draw_kinds.py."""
    mesh = O.CKMesh(ctx, f"{name}m")
    mesh.SetPositions(np.array(
        [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, f"{name}mat")
    mat.SetEmissive(color)
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, name)
    obj.SetCurrentMesh(mesh)
    return obj


def _draw_kinds(O, front: bool, **ctx_kw):
    """tests/test_draw_kinds.py's stencil scenes at 64x64: a small centre
    stencil quad alone, or a full stencil quad behind an opaque one."""
    from ckrenderengine_tpu_torch.scene.entity_table import (
        VX_MOVEABLE_STENCILONLY,
    )

    ctx = O.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -5))
    rc.AttachViewpointToCamera(cam)
    if front:
        _quad(O, ctx, "front", -1.0, (0, 0, 1, 1))
        sten = _quad(O, ctx, "mask", 0.5, (1, 1, 1, 1))
    else:
        sten = _quad(O, ctx, "mask", 0.0, (1, 1, 1, 1))
        sten.GetCurrentMesh().positions[:, :2] *= 0.4
        sten.GetCurrentMesh()._dirty_dynamic()
    sten.SetMoveableFlags(sten.GetMoveableFlags() | VX_MOVEABLE_STENCILONLY)
    return ctx, rc, sten


def test_stencil_mask_written_not_color():
    rc = _draw_kinds(O, front=False, device="cpu")[1]
    rc.Render()
    fb, sb = rc.framebuffer(), rc.stencilbuffer()
    assert fb.sum() == pytest.approx(0.0, abs=1e-5)
    assert sb.dtype == np.uint8 and sb.shape == (64, 64)
    assert sb[32, 32] == 1 and sb[2, 2] == 0
    rj = render_reference(_draw_kinds, accelerator=False, front=False)
    assert np.array_equal(sb, rj.stencilbuffer())


def test_stencil_z_tested():
    rc = _draw_kinds(O, front=True, device="cpu")[1]
    rc.Render()
    assert rc.stencilbuffer()[32, 32] == 0
    rj = render_reference(_draw_kinds, accelerator=False, front=True)
    assert np.array_equal(rc.stencilbuffer(), rj.stencilbuffer())


def build_stencil_flat(O, size: int = 96, antialias: bool = False,
                       **ctx_kw):
    """Config 1 and a stencil quad behind the cube, partly hidden by it."""
    ctx, rc, cube = scenes.build_config1(O, size, antialias=antialias,
                                         **ctx_kw)
    scenes.add_stencil_quad(O, ctx, -1.0, -0.6, 0.3, 0.8, 1.0)
    return ctx, rc, cube


def build_stencil_ties(O, size: int = 96, antialias: bool = False,
                       **ctx_kw):
    """Config 1 and two coplanar stencil quads that overlap, so every
    overlapped pixel is an exact depth tie of two stencil triangles. They
    stand clear of the cube: where a mask meets an opaque edge, ``sb``
    follows the frame's zb, and the reference's own frame leaves
    one-pixel cracks on the cube's shared edges (its contracted
    multiply-adds), which the port does not."""
    ctx, rc, cube = scenes.build_config1(O, size, antialias=antialias,
                                         **ctx_kw)
    scenes.add_stencil_quad(O, ctx, -2.2, -0.6, -1.2, 0.6, 1.0, "mask_a")
    scenes.add_stencil_quad(O, ctx, -1.8, -0.2, -0.9, 1.0, 1.0, "mask_b")
    return ctx, rc, cube


# name: (build, keywords, the reference on its accelerator branch,
#        the port's solve)
CASES = {
    "flat": (build_stencil_flat, dict(size=96), False, "depth_reduce_cuda"),
    "ties": (build_stencil_ties, dict(size=96), False, "depth_reduce_cuda"),
    "tiled": (scenes.build_stencil, dict(width=176, height=125), True,
              "depth_reduce_tiled_cuda"),
}


@pytest.fixture(scope="module")
def frames():
    out = {}
    for name, (build, kw, accel, _solve) in CASES.items():
        rj = render_reference(build, accelerator=accel, **kw)
        out[name] = rj.stencilbuffer()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_stencil_equals_reference(frames, name, monkeypatch):
    build, kw, _accel, solve = CASES[name]
    calls = []
    fn = getattr(tfr, solve)
    monkeypatch.setattr(tfr, solve, lambda *a, **k: (calls.append(1),
                                                     fn(*a, **k))[1])
    rc = build(O, device="cpu", **kw)[1]
    rc.Render()
    assert len(calls) == 2            # the frame's solve and the stencil's
    sb = rc.stencilbuffer()
    assert np.array_equal(sb, frames[name])
    assert 0.02 < sb.mean() < 0.5
    if name != "ties":
        # Part of the mask shows, part lies behind the opaque mesh.
        hidden = (to_np(rc.zb) < 1.0) & (sb == 0)
        assert hidden.sum() > 20


@pytest.mark.parametrize("name", ["flat", "tiled"])
def test_stencil_entity_leaves_the_frame_unchanged(name):
    build, kw, _accel, _solve = CASES[name]
    rc = build(O, device="cpu", **kw)[1]
    rc.Render()
    plain = (scenes.build_config1(O, kw["size"], device="cpu")
             if name == "flat" else
             scenes.build_config2(O, device="cpu", **kw))[1]
    plain.Render()
    assert torch.equal(rc.fb, plain.fb) and torch.equal(rc.zb, plain.zb)
    assert plain.stencilbuffer().sum() == 0


def test_stencil_with_antialias_resolves_by_maximum():
    kw = dict(width=128, height=95)
    rj = render_reference(scenes.build_stencil, antialias=True, **kw)
    rc = scenes.build_stencil(O, device="cpu", antialias=True, **kw)[1]
    rc.Render()
    sb = rc.stencilbuffer()
    assert sb.shape == (95, 128) and sb.dtype == np.uint8
    assert np.array_equal(sb, rj.stencilbuffer())
    double = scenes.build_stencil(O, device="cpu", width=256, height=190)[1]
    double.Render()
    assert np.array_equal(sb, win_max(double.stencilbuffer()))
    assert 0.02 < sb.mean() < 0.5


def test_port_queue_has_no_stencil_or_antialias_item():
    """Items 2 (stencil pass) and 3 (Antialias) are carried: no key in
    PORT_QUEUE and no ``unported(..., 2)`` or ``(..., 3)`` in the port."""
    import pathlib
    import re

    import ckrenderengine_tpu_torch
    from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE

    assert 2 not in PORT_QUEUE and 3 not in PORT_QUEUE
    root = pathlib.Path(ckrenderengine_tpu_torch.__file__).parent
    cites = re.compile(r"unported\([^()]*(\([^()]*\)[^()]*)*,\s*[23]\s*\)")
    for path in root.rglob("*.py"):
        assert not cites.search(path.read_text()), path
