"""Render-to-texture on the port (``SetTargetTexture``,
``CKTexture.SetDeviceImage`` and the device-resident feed inside the
frame), on the CPU, held against the reference package on the same scenes:

- the reference's cases (tests/test_aux.py:59-83: a target texture
  receives the frame and is usable on a mesh; tests/test_texture_atlas.py:
  162-227: a two-context chain over three ticks with a spinning triangle,
  where the feed is live, ``dev_ids`` is set and ``GetImage`` reads the
  producer's fb back);
- the feed's texels in the stack, its base rect and every mip level,
  against the reference's jitted ``_apply_tex_patch``. The port sums each
  mip texel's 2x2 block as (t00 + t01) + (t10 + t11), then divides by 4.
  The reference's XLA reduction on the CPU associates the sum by the
  width of the level above: at a power of two as the port does (the
  64x64 chain's feed and a 512x384 feed: bit for bit), at any other
  width as ((t00 + t01) + t10) + t11. Two associations of four
  nonnegative texels differ by at most two f32 ULPs of the mean (each
  rounds a partial sum the other does not; measured over 4M seeded blocks
  the gap reaches 2 ULPs and never more), so a level of another width is
  held to two ULPs of the reference's reduction of the same level above;
- a producer ``Resize`` (a new feed shape: the consumers recompile), a
  context that samples its own target (frame k shows frame k - 1),
  ``SetTargetTexture(None)``, the producer's ``Clear()`` between its frame
  and the consumer's (the texture holds a copy), a window of 8 and a
  ``ProcessBatched`` group with a target member (both render eagerly
  through ``Render()``, as the reference does), a feed on another device.

Frames are the reference's small flat-route scenes (64x64): fb and zb are
held to the reference's within 2e-5 (the f32 rounding of their lit and
textured shades; tests/test_torch_shaders.py uses the same bound), the
texture's image to the port's own fb bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu.pipeline import frame as jfr
from ckrenderengine_tpu_torch.pipeline import frame as tfr

from _torch_common import (
    ATOL, assert_frames_close, rtt_chain, small_ctx, small_rc, textured_quad,
    to_np, tri_scene,
)

def _ticks(chains, n, step=None):
    """``n`` ticks of (step, producer Render(), consumer Render()) on each
    chain, the consumers held to the reference's after each tick."""
    for k in range(n):
        for _ctx_, rc1, rc2, spin, _rtt in chains:
            if step is not None:
                step(k, spin)
            rc1.Render()
            rc2.Render()
        assert_frames_close(chains[1][2], chains[0][2])


@pytest.fixture(scope="module")
def chains():
    """The chain through both packages, three ticks with a spin between
    the second and the third: [reference, port]."""
    pair = [rtt_chain(J), rtt_chain(O)]

    def step(k, spin):
        if k == 2:
            spin.Rotate((0, 0, 1), 1.2)

    fbs = []
    for k in range(3):
        _ticks(pair, 1, lambda _k, spin: step(k, spin))
        fbs.append(pair[1][2].fb.clone())
    return pair, fbs


def test_target_texture_receives_frame():
    """tests/test_aux.py:60-69 through both packages."""
    imgs = []
    for P in (J, O):
        ctx = small_ctx(P)
        tri_scene(P, ctx)
        rc = small_rc(P, ctx)
        tgt = P.CKTexture(ctx, "rt")
        rc.SetTargetTexture(tgt)
        assert rc.GetTargetTexture() is tgt
        rc.Render()
        img = tgt.current_image()
        assert img is not None and img.shape == (64, 64, 4)
        assert img[..., 0].max() > 0.9
        imgs.append(np.asarray(img))
    np.testing.assert_array_equal(imgs[1], rc.framebuffer())
    np.testing.assert_allclose(imgs[1], imgs[0], atol=ATOL)
    assert torch.equal(tgt.device_image(), rc.fb)
    assert tgt.device_image() is not rc.fb
    assert tgt.device_image_chw()


def test_rtt_texture_usable_on_mesh():
    """tests/test_aux.py:71-83 through both packages: the captured frame
    on the triangle's own material, then a frame without a target."""
    rcs = []
    for P in (J, O):
        ctx = small_ctx(P)
        tri_scene(P, ctx)
        rc = small_rc(P, ctx)
        tgt = P.CKTexture(ctx, "rt")
        assert rc.SetRenderTarget(tgt) and rc.GetTargetTexture() is tgt
        rc.Render()
        rc.SetTargetTexture(None)
        ctx.GetObjectByName("m").SetTexture(tgt)
        rc.Render()
        assert rc.framebuffer().sum() > 0
        rcs.append(rc)
    assert_frames_close(rcs[1], rcs[0])


def test_chain_shows_live_frames(chains):
    """tests/test_texture_atlas.py:207-227: the consumer's frames equal the
    reference's at each tick (checked in the fixture), the feed is device
    resident and registered, the spin changes the consumer's frame, and
    the host read of the texture is the producer's frame."""
    (ref, port), fbs = chains
    _ctx_, rc1, rc2, _spin, rtt = port
    assert rtt.device_image() is not None
    assert rc2._compiled.dev_ids == {0}
    assert ref[2]._compiled.dev_ids == {0}
    assert torch.equal(fbs[0], fbs[1])
    assert fbs[1][0].sum() > 2
    assert (fbs[2] - fbs[1]).abs().sum() > 1.0
    img = rtt.GetImage()
    assert img.shape == (64, 64, 4)
    np.testing.assert_array_equal(img, rc1.framebuffer())
    np.testing.assert_allclose(img, ref[4].GetImage(), atol=ATOL)
    assert rtt.image_shape() == (64, 64, 4)


def test_feed_texels_match_reference(chains):
    """The consumer's stack with the feed written in (its base rect and its
    mip levels) equals the reference's ``_apply_tex_patch`` under jit on
    the same feed, bit for bit."""
    (ref, port), _fbs = chains
    rc_j, rc_t = ref[2], port[2]
    st, df, di, tp = rc_t._fill_packed([], [])
    sj, dfj, dij, pj = rc_j._fill_packed([], [])
    assert tp["texdev_rects"] == pj["texdev_rects"]
    pi, oy, ox, h, w, mip_col, levels, chw = tp["texdev_rects"][0]
    assert levels == 7 and chw and mip_col == w
    feed = tp["texdev"][0]
    planes_t = tfr._apply_tex_patch(st, {}, tp["layout"], tp["texdev"],
                                    tp["texdev_rects"])
    patch = jax.jit(lambda s, t: jfr._apply_tex_patch(
        s, {}, pj["layout"], t, pj["texdev_rects"]))
    planes_j = np.asarray(patch(sj, (jnp.asarray(to_np(feed)),)))
    np.testing.assert_array_equal(to_np(planes_t), planes_j)
    # The base rect is the feed itself; the static stack stays untouched.
    assert torch.equal(planes_t[pi, :, oy:oy + h, ox:ox + w], feed)
    assert not torch.equal(planes_t, st["tex_planes"])


def test_reference_inputs_with_feed(chains):
    """The reference consumer's own packed inputs, its feed included
    (``convert.from_reference``), through the port's frame: the
    reference's frame."""
    from ckrenderengine_tpu_torch import convert

    (ref, _port), _fbs = chains
    rc_j = ref[2]
    static, dyn_f, dyn_i, params = rc_j._fill_packed([], [])
    assert params["texdev"]
    st, tf, ti, tp = convert.from_reference(
        {k: np.asarray(v) for k, v in static.items()}, dyn_f, dyn_i, params,
        "cpu")
    assert len(tp["texdev"]) == 1 and tp["texdev_rects"] == \
        params["texdev_rects"]
    fb, zb = tfr.render_frame_packed(st, tf, ti, **tp)[:2]
    np.testing.assert_allclose(to_np(fb).transpose(1, 2, 0),
                               rc_j.framebuffer(), atol=ATOL)
    np.testing.assert_allclose(to_np(zb), rc_j.zbuffer(), atol=ATOL)


@pytest.mark.parametrize("shape", [(4, 384, 512), (4, 64, 64), (4, 2, 8),
                                   (4, 120, 160), (4, 37, 50), (4, 2, 9)])
def test_mip_box_matches_reference_reduction(shape):
    """``frame.mip_box`` against the reference's reduction,
    ``reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))`` under jit, on seeded
    texels (odd trailing rows and columns dropped): bit for bit where the
    width is a power of two, else within two f32 ULPs (module docstring);
    and equal to the same sum written out on strided views."""
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 1, shape).astype(np.float32)
    nh, nw = shape[1] // 2, shape[2] // 2

    @jax.jit
    def ref(x):
        x = jnp.moveaxis(x, 0, -1)
        return x[:nh * 2, :nw * 2].reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))

    got = to_np(tfr.mip_box(torch.as_tensor(img)))
    want = np.moveaxis(np.asarray(ref(img)), -1, 0)
    if shape[2] & (shape[2] - 1) == 0:
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= 2 * ulp)
    x = img[:, :nh * 2, :nw * 2]
    plain = ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2])
             + (x[:, 1::2, 0::2] + x[:, 1::2, 1::2])) / np.float32(4)
    np.testing.assert_array_equal(got, plain)


def test_producer_resize_rebuilds_the_stack():
    """A producer Resize gives the feed a new shape: the first frame at it
    goes to the host and recompiles the consumers, the next registers the
    feed again."""
    pair = [rtt_chain(J), rtt_chain(O)]
    _ticks(pair, 2)
    meta0 = pair[1][2]._compiled._tex_meta
    for _c, rc1, _rc2, _s, _t in pair:
        rc1.Resize(48, 40)
    _ticks(pair, 2)
    _c, rc1, rc2, _s, rtt = pair[1]
    assert rtt.GetImage().shape == (40, 48, 4)
    assert rc2._compiled._tex_meta is not meta0
    assert rc2._compiled._tex_meta["rects"][0][3:5] == (40, 48)
    assert rc2._compiled.dev_ids == {0}


def _mirror(P):
    """One context whose screen samples its own target texture, beside a
    spinning triangle."""
    ctx = small_ctx(P)
    rc = small_rc(P, ctx)
    tgt = P.CKTexture(ctx, "self")
    textured_quad(P, ctx, tgt, x0=-1.6, x1=-0.1)
    obj, _mesh, _mat = tri_scene(P, ctx)
    obj.SetPosition((0.8, 0, 0))
    rc.SetTargetTexture(tgt)
    return rc, obj


def test_context_samples_its_own_target(monkeypatch):
    """Frame k samples frame k - 1 (the feed a frame reads is the previous
    frame's fb), and each frame equals the reference's."""
    (rc_j, obj_j), (rc_t, obj_t) = _mirror(J), _mirror(O)
    seen = []
    render = tfr.render_frame_packed

    def spy(*a, **k):
        seen.append(k.get("texdev"))
        return render(*a, **k)

    monkeypatch.setattr(tfr, "render_frame_packed", spy)
    prev = None
    for k in range(4):
        for obj in (obj_j, obj_t):
            obj.Rotate((0, 0, 1), 0.4)
        rc_j.Render()
        rc_t.Render()
        assert_frames_close(rc_t, rc_j)
        if k >= 2:
            assert torch.equal(seen[-1][0], prev)
        prev = rc_t.fb.clone()
    assert seen[0] is None and seen[1] is None
    assert (rc_t.fb - seen[-1][0]).abs().sum() > 1.0


def test_set_target_texture_none_stops_the_feed():
    pair = [rtt_chain(J), rtt_chain(O)]
    _ticks(pair, 2)
    held = []
    for _c, rc1, _rc2, spin, rtt in pair:
        rc1.SetTargetTexture(None)
        assert rc1.GetTargetTexture() is None
        held.append((rtt.data_version, rtt.GetImage().copy()))
    _ticks(pair, 1, lambda _k, spin: spin.Rotate((0, 0, 1), 1.2))
    for (_c, rc1, _rc2, _s, rtt), (ver, img) in zip(pair, held):
        assert rtt.data_version == ver
        np.testing.assert_array_equal(rtt.GetImage(), img)
        assert np.abs(rc1.framebuffer() - img).max() > 0.1


def test_producer_clear_does_not_reach_the_texture():
    """The texture holds a copy of the frame: the producer's Clear()
    between its frame and the consumer's leaves the consumer's frame as it
    is without the Clear()."""
    _c, rc1, rc2, spin, rtt = rtt_chain(O)
    rc1.Render()
    rc2.Render()
    rc1.Render()
    want = rc1.fb.clone()
    rc1.Clear()
    assert not torch.equal(rc1.fb, want)
    rc2.Render()
    assert torch.equal(rtt.device_image(), want)
    shown = rc2.fb.clone()
    rc1.Render()
    rc2.Render()
    assert torch.equal(rc2.fb, shown)
    ref = rtt_chain(J)
    for _ in range(2):
        ref[1].Render()
        ref[2].Render()
    np.testing.assert_allclose(to_np(shown).transpose(1, 2, 0),
                               ref[2].framebuffer(), atol=ATOL)


def test_window_renders_target_and_feed_eagerly():
    """In a window of 8 the producer (a target) and the consumer (a feed)
    render every frame eagerly, so each frame is the reference's."""
    pair = [rtt_chain(J), rtt_chain(O)]
    for _c, rc1, rc2, _s, _t in pair:
        rc1.SetFramePipelining(8)
        rc2.SetFramePipelining(8)
    _ticks(pair, 3, lambda k, spin: spin.Rotate((0, 0, 1), 0.3 * k))
    rc1 = pair[1][1]
    assert not rc1._win_slots and rc1._window is None
    assert pair[1][2]._compiled.dev_ids == {0}


def _group(P):
    """Three contexts of one triangle (tests/test_torch_batch.py's group);
    the first renders into a target texture."""
    ctx = small_ctx(P)
    tri_scene(P, ctx)
    rcs = []
    for i in range(3):
        rc = ctx.GetRenderManager().CreateRenderContext(48, 48)
        cam = P.CKCamera(ctx, f"cam{i}")
        cam.SetPosition((0, 0, -3 - i))
        rc.AttachViewpointToCamera(cam)
        rc._gov_on = False
        rcs.append(rc)
    tgt = P.CKTexture(ctx, "rt")
    rcs[0].SetTargetTexture(tgt)
    return ctx.GetRenderManager(), rcs, tgt


def test_process_batched_with_a_target_member():
    """A group with a target member renders through each member's
    Render() (the reference's group takes its sequential fallback too):
    every member equals the reference's, and the target receives its
    member's frame."""
    (rm_j, rcs_j, _tj), (rm_t, rcs_t, tgt) = _group(J), _group(O)
    rm_j.ProcessBatched()
    rm_t.ProcessBatched()
    for rc_t, rc_j in zip(rcs_t, rcs_j):
        assert rc_t._batch_read is None
        assert_frames_close(rc_t, rc_j)
    assert torch.equal(tgt.device_image(), rcs_t[0].fb)


def test_feed_on_another_device_raises():
    ctx = O.CKContext(device="cpu")
    tex = O.CKTexture(ctx, "t")
    with pytest.raises(ValueError, match="meta"):
        tex.SetDeviceImage(torch.zeros((4, 8, 8), device="meta"), chw=True)
    with pytest.raises(TypeError):
        tex.SetDeviceImage(np.zeros((8, 8, 4), np.float32))
    assert tex.device_image() is None and tex.GetImage() is None


def test_feed_bookkeeping():
    """The first feed (or a new shape) goes to the host and bumps the
    topology; a same-shape feed is lazy and bumps only the dynamic
    version; an (H, W, 4) feed reads back as it is."""
    ctx = O.CKContext(device="cpu")
    tex = O.CKTexture(ctx, "t")
    a = torch.rand((4, 6, 10), generator=torch.Generator().manual_seed(1))
    topo = ctx._topology_version
    tex.SetDeviceImage(a, chw=True)
    assert ctx._topology_version == topo + 1
    assert isinstance(tex.slots[0], np.ndarray)
    assert tex.GetWidth() == 10 and tex.GetHeight() == 6
    b = a.flip(1)
    tex.SetDeviceImage(b, chw=True)
    assert ctx._topology_version == topo + 1
    assert tex.image_shape() == (6, 10, 4) and tex.slots[0]._host is None
    np.testing.assert_array_equal(tex.GetImage(),
                                  to_np(b).transpose(1, 2, 0))
    np.testing.assert_array_equal(tex.current_image(), tex.GetImage())
    hwc = torch.rand((5, 7, 4), generator=torch.Generator().manual_seed(2))
    tex.SetDeviceImage(hwc, slot=1)
    assert not tex.device_image_chw() and tex.device_image() is hwc
    np.testing.assert_array_equal(tex.GetImage(1), to_np(hwc))
    assert tex.data_version == 3
