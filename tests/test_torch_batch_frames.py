"""The stacked-scene frame functions of context batching on the CPU,
against the reference package's: ``parallel.context_batch``
(``stack_scenes``, ``replicate_scene``, ``render_frames_batched``,
``render_frames_full_batched``) on the same packed inputs, and
``frame.render_frames_packed_batched`` on stacked packed buffers with the
members' bound-clip worlds, which also equals the port's
``ProcessBatched`` (one replayed frame per member) bit for bit. The groups
are tests/test_torch_batch.py's."""

import numpy as np
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.parallel import context_batch as tcb

from _torch_common import to_np
from test_torch_batch import _batched, _bind_spin, _tri_group


def _stacked_inputs():
    """The reference's and the port's stacked scenes of the one-triangle
    group (2 contexts at 48x48), both from the reference's packed inputs."""
    import jax.numpy as jnp
    from ckrenderengine_tpu.parallel import context_batch as jcb
    from ckrenderengine_tpu.pipeline import frame as jfr
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    _c, _rm, rjs, _o = _tri_group(J, n=2)
    js, ts = [], []
    for rj in rjs:
        rj.Render()
        static, dyn_f, dyn_i, params = rj._fill_packed([], [])
        static = {k: np.asarray(v) for k, v in static.items()}
        js.append(jfr.unpack_scene({k: jnp.asarray(v) for k, v in
                                    static.items()}, jnp.asarray(dyn_f),
                                   jnp.asarray(dyn_i), params["layout"])[0])
        st, tf, ti, tp = convert.from_reference(static, dyn_f, dyn_i, params,
                                                "cpu")
        ts.append(tfr.unpack_scene(st, tf, ti, tp["layout"])[0])
    return (jcb.stack_scenes(js), tcb.stack_scenes(ts),
            params["levels"], 48, 48)


def test_render_frames_batched_against_reference():
    """``render_frames_batched`` and ``render_frames_full_batched`` of the
    port against the reference's (vmapped, Pallas off) on stacked scenes;
    each member equals the port's own frame of that member."""
    from ckrenderengine_tpu.parallel import context_batch as jcb
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    jsc, tsc, levels, h, w = _stacked_inputs()
    assert tsc.local.shape[0] == 2
    for fn in ("render_frames_batched", "render_frames_full_batched"):
        fb_j, zb_j = (np.asarray(x) for x in getattr(jcb, fn)(
            jsc, levels, h, w))
        fb_t, zb_t = getattr(tcb, fn)(tsc, levels, h, w)
        assert fb_t.shape == (2, 4, h, w) and zb_t.shape == (2, h, w)
        np.testing.assert_allclose(to_np(fb_t), fb_j, atol=2e-5)
        np.testing.assert_allclose(to_np(zb_t), zb_j, atol=2e-6)
        assert not np.array_equal(fb_j[0], fb_j[1])
    for i in range(2):
        own = tfr.render_frame_impl(tcb.member(tsc, i), levels, h, w,
                                    want_texgen=True)
        assert torch.equal(fb_t[i], own[0]) and torch.equal(zb_t[i], own[1])
    rep = tcb.replicate_scene(tcb.member(tsc, 1), 3)
    fb_r, _zb = tcb.render_frames_batched(rep, levels, h, w)
    assert all(torch.equal(fb_r[i], fb_t[1]) for i in range(3))


def test_render_frames_packed_batched():
    """``frame.render_frames_packed_batched`` on stacked packed buffers:
    against the reference's (vmapped, Pallas off) on the reference's inputs
    of the bound-clip group, and equal to the port's batch (one replayed
    frame per member) on the port's own inputs, the members' clip worlds
    stacked."""
    from ckrenderengine_tpu import anim as janim
    from ckrenderengine_tpu.pipeline import frame as jfr
    from ckrenderengine_tpu_torch import anim as tanim
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    ctx_j, _rm, rjs, _o = _tri_group(J, n=2)
    clip_j = _bind_spin(J, janim, ctx_j, rjs)
    clip_j.SetFrame(6.0)
    filled = []
    for rj in rjs:
        rj.Render()
        filled.append(rj._fill_packed([], []))
    static, _f, _i, params = filled[0]
    p = {k: v for k, v in params.items()
         if k not in ("world_in", "texdev", "texdev_rects")}
    fb_j, zb_j = (np.asarray(x) for x in jfr.render_frames_packed_batched(
        static, np.stack([f[1] for f in filled]),
        np.stack([f[2] for f in filled]),
        world_in=np.stack([f[3]["world_in"] for f in filled]), **p))
    conv = [convert.from_reference({k: np.asarray(v) for k, v in
                                    f[0].items()}, *f[1:], "cpu")
            for f in filled]
    st, _tf, _ti, tp = conv[0]
    tp = {k: v for k, v in tp.items() if k != "world_in"}
    fb_t, zb_t = tfr.render_frames_packed_batched(
        st, torch.stack([c[1] for c in conv]),
        torch.stack([c[2] for c in conv]),
        world_in=torch.stack([c[3]["world_in"] for c in conv]), **tp)
    np.testing.assert_allclose(to_np(fb_t), fb_j, atol=2e-5)
    np.testing.assert_allclose(to_np(zb_t), zb_j, atol=2e-6)

    ctx_t, rm_t, rts, _o = _tri_group(O, n=2, device="cpu")
    clip_t = _bind_spin(O, tanim, ctx_t, rts)
    clip_t.SetFrame(6.0)
    frames = _batched(rm_t, rts)
    own = [rt._fill_packed([], []) for rt in rts]
    st, _f, _i, tp = own[0]
    tp = {k: v for k, v in tp.items() if k != "world_in"}
    fb, zb = tfr.render_frames_packed_batched(
        st, torch.as_tensor(np.stack([o[1] for o in own])),
        torch.as_tensor(np.stack([o[2] for o in own])),
        world_in=torch.stack([o[3]["world_in"] for o in own]), **tp)
    for i, (bfb, bzb) in enumerate(frames):
        assert torch.equal(fb[i], bfb) and torch.equal(zb[i], bzb)
