"""Material channels (extra UV sets redrawn over their base pass,
reference RCKMesh::RenderChannels) through both packages' ``Render()`` on
the CPU.

- The reference's tests/test_channels.py quad at 64x64: an additive
  channel (ONE / ONE), a channel deactivated after a frame with it, and a
  replacing channel with its own UVs; each frame held to
  ``check_render`` (flat frames, rendered by the reference as its CPU runs
  them), with the reference test's own assertion on the port's frame.
- A channel over its own base lands on every pixel its base wins: on the
  plaza of ``scenes.build_config5_mat`` cut to 128x96 (its cube-env
  reflection channel, alpha 0.35, over a planar-TexGen base), the pixels
  whose opaque winner is a plaza triangle and where the port's
  reflection channel did not blend (its ordered pass run from the frame's
  own opaque fb and zb with and without the channel's triangles, compared
  in RGB) are at most 0.1% of them. The reference's own frame misses far
  more there: its jitted frame evaluates the redraw's depth once per
  colour channel and at its 2-ULP tie window blends the alpha but not the
  RGB of many of these pixels (``tests/_torch_common.tie_window``); the
  count is taken from its frames with and without the channel.
"""

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster.types import VXBLEND
from tests._torch_common import (
    check_render, reference_stages, render_both, render_reference,
)

PLAZA = dict(width=128, height=96, terrain_n=8, n_balls=2, water_n=4,
             plaza_n=4)


def _quad(O, case: str, **ctx_kw):
    """The reference test's quad (a self-lit red base, 64x64, camera at
    z = -4) with one channel."""
    ctx = O.CKContext(**ctx_kw)
    mesh = O.CKMesh(ctx, "q")
    mesh.SetPositions(np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.SetUVs(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32))
    mesh.BuildNormals()
    base = O.CKMaterial(ctx, "base")
    base.SetEmissive((0.5, 0, 0, 1))
    base.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(base)
    O.CK3dObject(ctx, "o").SetCurrentMesh(mesh)
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -4))
    rc.AttachViewpointToCamera(cam)
    tex = O.CKTexture(ctx, "chantex")
    img = np.zeros((8, 8, 4), np.float32)
    if case == "own_uvs":
        img[:, :4] = (0, 0, 1, 1)          # left half blue
        img[:, 4:] = (1, 1, 0, 1)          # right half yellow
    else:
        img[..., 1] = 0.5                  # green glow
        img[..., 3] = 1.0
    tex.SetImage(img)
    cmat = O.CKMaterial(ctx, "chan")
    cmat.SetTexture(tex)
    cmat.SetEmissive((1, 1, 1, 1))
    cmat.SetTwoSided(True)
    ci = mesh.AddChannel(cmat, copy_uvs=case != "own_uvs")
    mesh.SetChannelSourceBlend(ci, int(VXBLEND.ONE))
    if case == "own_uvs":
        # The channel samples only the left (blue) half, and replaces.
        mesh.channels[ci]["uvs"] = np.full((4, 2), 0.25, np.float32)
        mesh.SetChannelDestBlend(ci, int(VXBLEND.ZERO))
    else:
        mesh.SetChannelDestBlend(ci, int(VXBLEND.ONE))
    if case == "deactivated":
        rc.Render()
        mesh.ActivateChannel(ci, False)
    return ctx, rc, mesh


@pytest.mark.parametrize("case", ["additive", "deactivated", "own_uvs"])
def test_channel_matches_reference(case):
    pair = render_both(lambda O, **kw: _quad(O, case, **kw),
                       accelerator=False)
    check_render(pair)
    _rj, rt, _p, _r = pair
    kinds = [k for _m, k, _b in rt._compiled.materials]
    px = rt.framebuffer()[32, 32]
    if case == "additive":
        assert "channel" in kinds
        assert px[1] > 0.2 + 1e-3 and px[0] == pytest.approx(0.5, abs=0.1)
    elif case == "deactivated":
        assert "channel" not in kinds and px[1] < 0.1
    else:
        assert px[2] > 0.9 and px[0] < 0.1


def _without_reflection(O, **kw):
    ctx, rc, spinner = scenes.build_config5_mat(O, **kw)
    ctx.GetObjectByName("plaza").ActivateChannel(1, False)
    return ctx, rc, spinner


def _port_not_blended(rt):
    """(plaza pixels, of them where the reflection channel did not blend)
    of the port's frame."""
    st, tf, ti, tp = rt._fill_packed([], [])
    tf, ti = torch.as_tensor(tf), torch.as_tensor(ti)
    scene, batch, _su, defer, bits = tfr.packed_setup(st, tf, ti, tp)
    names = [(m.name if m is not None else None, k)
             for m, k, _b in rt._compiled.materials]
    s_base = names.index(("plazamat", "mesh"))
    s_refl = names.index(("plazarefl", "channel"))
    # The frame without its ordered pass: the opaque fb and zb that pass
    # starts from, and B1's (here the plain solve's) winners.
    fb0, zb0, stats = tfr.render_frame_packed(
        st, tf, ti, **dict(tp, ordered_cap=0), want_stats=True)
    ids = stats["WinnerIds"]
    h, w = ids.shape

    def ordered(b):
        return tfr._ordered_pass(scene, b, defer, bits, fb0, zb0,
                                 rt._compiled.ordered_cap, h, w, True, None,
                                 tp["sampler_profile"], {})[0]

    full = ordered(batch)
    without = ordered(batch._replace(
        valid=batch.valid & (batch.state_idx != s_refl)))
    np.testing.assert_array_equal(full.numpy(), rt.fb.numpy())
    on_base = (ids >= 0) & (batch.state_idx[ids.clamp(min=0)] == s_base)
    same = (full[:3] == without[:3]).all(0)
    return int(on_base.sum()), int((on_base & same).sum())


def test_channel_covers_its_base():
    rj = render_reference(scenes.build_config5_mat, accelerator=False,
                          **PLAZA)
    rj0 = render_reference(_without_reflection, accelerator=False, **PLAZA)
    import ckrenderengine_tpu_torch.objects as O

    _c, rt, _m = scenes.build_config5_mat(O, device="cpu", **PLAZA)
    rt.Render()
    n_base, port_missed = _port_not_blended(rt)
    assert n_base > 300
    assert port_missed <= 1e-3 * n_base, (port_missed, n_base)
    # The reference on the same pixels: its own stages and exact solve
    # (whose winners agree with the port's on >= 99.9% of them).
    from ckrenderengine_tpu.raster import deferred as jdf

    stg = reference_stages(*rj._fill_packed([], []))
    sc = stg["scene"]
    ids, _d = jdf.depth_reduce(stg["setup"], stg["defer"], sc.clear_z,
                               sc.viewport, rj.height, rj.width)
    ids = np.asarray(ids)
    names = [(m.name if m is not None else None, k)
             for m, k, _b in rj._compiled.materials]
    sidx = np.asarray(stg["batch"].state_idx)
    on_base = (ids >= 0) & (sidx[np.clip(ids, 0, None)]
                            == names.index(("plazamat", "mesh")))
    same = (np.asarray(rj.fb)[:3] == np.asarray(rj0.fb)[:3]).all(0)
    ref_missed = int((on_base & same).sum())
    assert abs(int(on_base.sum()) - n_base) <= 1e-3 * n_base
    assert ref_missed > 1e-3 * n_base, ref_missed
