"""Stereo on the port (``SetStereoParameters``, the packed two-eye frame,
its eager fallback, ``RestoreStereoRenderState``), on the CPU, held
against the reference package on the same scenes:

- the reference's cases (tests/test_aux.py:157-186: both eyes side by
  side, shifted apart; the packed frame equal to the eager path's);
- fb and zb against the reference on the packed path and on each trigger
  of the fallback (no-clear colour, no-clear depth, a render-to-texture
  feed), with ``StereoEagerFallback`` set exactly there. A no-clear frame
  renders from the clear colour and depth (the reference's fallback
  passes no previous buffers);
- Antialias: the packed frame renders each eye at 2x and resolves it, the
  fallback at 1x (the reference's fallback passes no supersample);
- a stereo frame after a half-filled window of 4 (the staged frames run
  first and the stereo frame is what fb reads), stereo into a target
  texture, an odd width (2 * (W // 2) columns, the reference's hazard),
  ``GetStereoParameters`` and ``RestoreStereoRenderState``.

A feed's fallback frame samples the feed's current image in the port;
the reference's fallback samples the texture stack of its last rebuild
(README, port section), so that case is held to the reference with its
stack rebuilt before the frame, and a test shows the reference's stale
frame. Frames are the reference's 64x64 flat-route scenes, held to the
reference within ``_torch_common.ATOL``; the port's two paths to each
other bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O

from _torch_common import (
    assert_frames_close, rtt_chain, small_ctx, small_rc, tri_scene,
)

EYES = (0.2, 2.0)


def _stereo(P, w=64, h=64, aa=False, **flags):
    """The reference's stereo scene (tests/test_aux.py:157-170): the
    one-triangle scene at ``w`` x ``h`` with eye separation 0.2.
    ``flags``: SetClearBackground / SetClearZBuffer values."""
    ctx = small_ctx(P)
    if aa:
        ctx.GetRenderManager().SetRenderOptions("Antialias", 1)
    obj = tri_scene(P, ctx)[0]
    rc = small_rc(P, ctx, w, h)
    rc.SetStereoParameters(*EYES)
    if "back" in flags:
        rc.SetClearBackground(flags["back"])
    if "z" in flags:
        rc.SetClearZBuffer(flags["z"])
    return rc, obj


def _both(**kw):
    return _stereo(J, **kw), _stereo(O, **kw)


def test_stereo_side_by_side():
    """tests/test_aux.py:158-170 through both packages."""
    (rc_j, _), (rc_t, _) = _both()
    for rc in (rc_j, rc_t):
        rc.Render()
        fb = rc.framebuffer()
        assert fb.shape == (64, 64, 4)
        left, right = fb[:, :32], fb[:, 32:]
        assert left.sum() > 0 and right.sum() > 0
        assert np.abs(left - right).sum() > 1.0
        assert not rc.GetStats().StereoEagerFallback
    assert_frames_close(rc_t, rc_j)


def test_stereo_packed_matches_fallback():
    """tests/test_aux.py:172-186: the packed frame and the eager fallback
    of the same state agree, in the port bit for bit."""
    (rc_j, _), (rc_t, _) = _both()
    rc_j.Render()
    rc_t.Render()
    assert_frames_close(rc_t, rc_j)
    fb, zb = rc_t.fb.clone(), rc_t.zb.clone()
    rc_t._render_stereo([], [])
    assert torch.equal(rc_t.fb, fb) and torch.equal(rc_t.zb, zb)


def _cleared(**kw):
    """The port's packed stereo frame of the same scene, clearing."""
    rc, _obj = _stereo(O, **kw)
    rc.Render()
    return rc


@pytest.mark.parametrize("flags", [dict(back=False), dict(z=False),
                                   dict(back=False, z=False)])
def test_no_clear_takes_the_fallback(flags):
    """A stereo frame that does not clear takes the eager fallback in both
    packages; it renders from the clear colour and depth, so its second
    frame equals a clearing context's, and the reference's."""
    (rc_j, obj_j), (rc_t, obj_t) = _both(**flags)
    for rc, obj in ((rc_j, obj_j), (rc_t, obj_t)):
        rc.Render()
        obj.Rotate((0, 0, 1), 0.5)
        rc.Render()
        assert rc.GetStats().StereoEagerFallback
    assert_frames_close(rc_t, rc_j)
    ref, obj = _stereo(O)
    obj.Rotate((0, 0, 1), 0.5)
    ref.Render()
    assert not ref.GetStats().StereoEagerFallback
    assert torch.equal(rc_t.fb, ref.fb) and torch.equal(rc_t.zb, ref.zb)


def _feed_pair():
    """The render-to-texture chain with its consumer in stereo, through
    both packages, after two ticks (the feed registered)."""
    pair = [rtt_chain(J), rtt_chain(O)]
    for _c, rc1, rc2, _s, _t in pair:
        rc2.SetStereoParameters(*EYES)
        for _ in range(2):
            rc1.Render()
            rc2.Render()
    return pair


def test_feed_takes_the_fallback():
    """A stereo consumer of a live feed takes the fallback, and its frame
    shows the producer's current frame: it equals the reference's with
    the reference's stack rebuilt from the current feed first."""
    pair = _feed_pair()
    for k in range(2):
        for i, (_c, rc1, rc2, spin, _t) in enumerate(pair):
            spin.Rotate((0, 0, 1), 0.6)
            rc1.Render()
            if i == 0:
                rc2._refresh_textures(force=True)
            rc2.Render()
            assert rc2.GetStats().StereoEagerFallback
            assert rc2._compiled.dev_ids == {0}
        assert_frames_close(pair[1][2], pair[0][2])
    _c, rc1, rc2, _s, rtt = pair[1]
    fb = rc2.fb.clone()
    rc2._render_stereo_packed([], [])
    assert torch.equal(rc2.fb, fb)


def test_reference_fallback_samples_a_stale_feed():
    """Why the case above rebuilds the reference's stack: the reference's
    fallback scene (``_build_scene_device``) samples the stack of its last
    rebuild, so after the producer moves, its stereo consumer shows the
    old frame; the port's shows the new one."""
    pair = _feed_pair()
    before = [rc2.framebuffer().copy() for _c, _r1, rc2, _s, _t in pair]
    for _c, rc1, rc2, spin, _t in pair:
        spin.Rotate((0, 0, 1), 1.2)
        rc1.Render()
        rc2.Render()
    (_c, _r1, rc2_j, _s, _t), (_c2, _r2, rc2_t, _s2, _t2) = pair
    np.testing.assert_array_equal(rc2_j.framebuffer(), before[0])
    assert np.abs(rc2_t.framebuffer() - before[1]).sum() > 1.0


def test_antialias_packed_and_fallback():
    """Antialias: the packed stereo frame renders each eye at 2x and
    resolves it; the fallback (a no-clear frame) renders at 1x, equal to
    the stereo frame without Antialias. Both as in the reference."""
    (rc_j, _), (rc_t, _) = _both(aa=True)
    rc_j.Render()
    rc_t.Render()
    assert_frames_close(rc_t, rc_j)
    one_x = _cleared()
    assert not torch.equal(rc_t.fb, one_x.fb)
    (rc_j, _), (rc_t, _) = _both(aa=True, back=False)
    rc_j.Render()
    rc_t.Render()
    assert_frames_close(rc_t, rc_j)
    assert rc_t.GetStats().StereoEagerFallback
    assert torch.equal(rc_t.fb, one_x.fb) and torch.equal(rc_t.zb, one_x.zb)


def test_stereo_after_a_half_filled_window():
    """Two mono frames staged in a window of 4, then a stereo frame: the
    staged frames run first, and fb / zb are the stereo frame's."""
    rcs = []
    for P in (J, O):
        rc, obj = _stereo(P)
        rc.SetStereoParameters(0.0, 2.0)
        rc.SetFramePipelining(4)
        for _ in range(2):
            obj.Rotate((0, 0, 1), 0.3)
            rc.Render()
        rc.SetStereoParameters(*EYES)
        rc.Render()
        rcs.append(rc)
    rc_j, rc_t = rcs
    assert not rc_t._win_slots and rc_t._win_pending is None
    assert_frames_close(rc_t, rc_j)
    fb = rc_t.fb.clone()
    rc_t._render_stereo_packed([], [])
    assert torch.equal(rc_t.fb, fb)


def test_stereo_into_a_target_texture():
    """A stereo context with a target texture hands over its side-by-side
    frame; a second context samples it."""
    got = []
    for P in (J, O):
        rc, _obj = _stereo(P)
        tgt = P.CKTexture(rc.context, "rt")
        rc.SetTargetTexture(tgt)
        rc.Render()
        rc.Render()
        got.append((rc, tgt))
    (rc_j, tgt_j), (rc_t, tgt_t) = got
    assert_frames_close(rc_t, rc_j)
    assert torch.equal(tgt_t.device_image(), rc_t.fb)
    np.testing.assert_array_equal(tgt_t.GetImage(), rc_t.framebuffer())


def test_odd_width():
    """An odd width loses its last column: fb is 2 * (W // 2) columns
    wide, zb the right eye's at full width (the reference's hazard, which
    the port matches)."""
    (rc_j, _), (rc_t, _) = _both(w=63, h=48)
    rc_j.Render()
    rc_t.Render()
    assert rc_t.framebuffer().shape == (48, 62, 4)
    assert rc_t.zbuffer().shape == (48, 63)
    assert_frames_close(rc_t, rc_j)


def test_stereo_parameters_and_restore():
    rc_j = small_rc(J, small_ctx(J))
    rc_t = small_rc(O, small_ctx(O))
    assert rc_t.GetStereoParameters() == rc_j.GetStereoParameters()
    for rc in (rc_j, rc_t):
        rc.SetStereoParameters(1.2, 60.0)
        assert rc.GetStereoParameters() == (1.2, 60.0) and rc.stereo_enabled
        rc.SetStereoParameters(0.0, 60.0)
        assert not rc.stereo_enabled
    rc, obj = _stereo(O)
    rc.Render()
    fb = rc.fb.clone()
    assert not hasattr(type(rc).RestoreStereoRenderState, "unported_item")
    rc.RestoreStereoRenderState()
    rc.Render()
    assert torch.equal(rc.fb, fb)


def test_port_queue_has_no_stereo_or_render_to_texture():
    """No ``unported(...)`` call names stereo or render-to-texture, and
    item 17 of the port queue (the remaining host API) is gone."""
    from ckrenderengine_tpu_torch import roadmap

    assert 17 not in roadmap.PORT_QUEUE
    assert not any(re.search(r"stereo|texture", v, re.I)
                   for v in roadmap.PORT_QUEUE.values())
    for name in ("SetRenderTarget", "RestoreStereoRenderState",
                 "SetStereoParameters", "SetTargetTexture"):
        assert not hasattr(getattr(O.CKRenderContext, name),
                           "unported_item"), name
    root = Path(roadmap.__file__).parent
    for path in root.rglob("*.py"):
        for call in re.findall(r"unported\((.*?)\)", path.read_text(),
                               re.S):
            assert not re.search(r"stereo|texture|SetRenderTarget", call,
                                 re.I), (path, call)
