"""Frame windows on the port (``SetFramePipelining``), on the CPU: W staged
frames run through the device-decided frame function slot by slot
(``pipeline/window.py``; on the card each is one CUDA-graph replay), and
must be BIT-IDENTICAL to the eager frames of W = 1, as the reference's own
tests hold its windowed frames (tests/test_frame_window.py).

- The reference's four cases: a read every frame, the last frame with no
  read in between, a reset to immediate, a bound clip animation.
- The fence: one f32 checksum per frame, equal to W = 1's; a partial
  window repeats its last frame's.
- A change of what the window bakes in (a same-count ``SetImage`` with a
  new shape, the sampler, a moved HUD quad) flushes the staged frames; an
  accumulate frame renders eagerly.
- The device-decided frame reads nothing back and raises a flag where the
  eager frame would have read: B1's remainder (a pair cap under the live
  pairs), B3's replay (phase A overflowing) and the peel with too few
  rounds. The flagged frames are rendered again eagerly, so the window
  still equals W = 1, and the counters count the redo.
- A peel round over drained pixels composites empty layers, which leaves
  fb as it was.

The windowed frames against the reference's frames are in
tests/test_torch_frame_window_ref.py.
"""

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.objects import (
    CK3dObject, CKCamera, CKContext, CKMaterial, CKMesh, CKSprite, CKTexture,
)
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.pipeline import window as tw
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from ckrenderengine_tpu_torch.raster.types import VXTEXTURE_FILTER


def _scene(ctx, w=64, h=64, textured=False):
    rm = ctx.GetRenderManager()
    rc = rm.CreateRenderContext(w, h)
    cam = CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -5))
    rc.AttachViewpointToCamera(cam)
    mesh = CKMesh(ctx, "m")
    mesh.SetPositions(np.array([[-1, -1, 0], [0, 1, 0], [1, -1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.BuildNormals()
    mat = CKMaterial(ctx, "mat")
    mat.SetEmissive((1, 0.2, 0.1, 1))
    if textured:
        mesh.SetUVs(np.array([[0, 0], [0.5, 1], [1, 0]], np.float32))
        tex = CKTexture(ctx, "tex")
        tex.SetImage(_checker(8, 8))
        mat.SetTexture(tex)
        mat.SetTextureMagMode(int(VXTEXTURE_FILTER.LINEAR))
        mat.SetTextureMinMode(int(VXTEXTURE_FILTER.LINEAR))
    mesh.ApplyGlobalMaterial(mat)
    obj = CK3dObject(ctx, "o")
    obj.SetCurrentMesh(mesh)
    return rc, obj, mat


def _checker(h, w):
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w, 4), np.float32)
    img[..., 0] = ((yy + xx) % 2).astype(np.float32)
    img[..., 1] = yy / max(h - 1, 1)
    img[..., 3] = 1.0
    return img


def _move(obj, f):
    obj.SetPosition((0.3 * f - 0.6, 0.1 * f, 0))


def _run_frames(window, n_frames=5, read_each=True):
    ctx = CKContext(device="cpu")
    rc, obj, _mat = _scene(ctx)
    rc.SetFramePipelining(window)
    fbs = []
    for f in range(n_frames):
        _move(obj, f)
        rc.Render()
        if read_each:
            fbs.append(rc.framebuffer())
    if not read_each:
        fbs.append(rc.framebuffer())
    return fbs


@pytest.fixture
def window_runs(monkeypatch):
    """Counts the frames of each window run and records each window's rows
    as read; the third list holds the windows (Pending)."""
    runs = []
    reads = []
    pending = []
    run, read = tw.FrameWindow.run, tw.Pending.read

    def counted_run(self, slots):
        runs.append(len(slots))
        pending.append(run(self, slots))
        return pending[-1]

    def recorded_read(self):
        rows = read(self)
        reads.append(rows)
        return rows

    monkeypatch.setattr(tw.FrameWindow, "run", counted_run)
    monkeypatch.setattr(tw.Pending, "read", recorded_read)
    return runs, reads, pending


def test_windowed_frames_bit_identical(window_runs):
    ref = _run_frames(window=1)
    assert window_runs[0] == []
    win = _run_frames(window=3)
    assert window_runs[0] == [1] * 5            # each read flushes
    assert len(ref) == len(win)
    for a, b in zip(ref, win):
        np.testing.assert_array_equal(a, b)
    assert any(fb[..., :3].sum() > 0 for fb in ref)


def test_windowed_last_frame_without_intermediate_reads(window_runs):
    ref = _run_frames(window=1)
    win = _run_frames(window=3, read_each=False)
    assert window_runs[0] == [3, 2]
    np.testing.assert_array_equal(win[-1], ref[-1])


def test_window_resets_to_immediate(window_runs):
    ctx = CKContext(device="cpu")
    rc, _obj, _mat = _scene(ctx)
    rc.SetFramePipelining(4)
    assert rc.GetFramePipelining() == 4
    rc.Render()
    rc.SetFramePipelining(1)       # flushes pending
    assert window_runs[0] == [1]
    assert rc.GetFramePipelining() == 1
    rc.Render()
    assert window_runs[0] == [1]
    assert np.asarray(rc.framebuffer()).shape == (64, 64, 4)


def test_windowed_bound_clip_animation(window_runs):
    """The window's animate and compose prologue, the clip time a device
    scalar, matches the eager frame's stages."""
    from ckrenderengine_tpu_torch.anim import (
        CKANIMATION_LINEAR_POS, CKKeyedAnimation, CKObjectAnimation,
    )

    def frames(window):
        ctx = CKContext(device="cpu")
        rc, obj, _mat = _scene(ctx)
        oa = CKObjectAnimation(ctx, "oa")
        oa.Set3dEntity(obj)
        pc = oa.CreateController(CKANIMATION_LINEAR_POS)
        pc.AddKey(0.0, (-1, 0, 0))
        pc.AddKey(10.0, (1, 0.5, 0))
        clip = CKKeyedAnimation(ctx, "ka")
        clip.AddAnimation(oa)
        rc.SetFramePipelining(window)
        assert rc.BindAnimation(clip)
        out = []
        for f in range(4):
            clip.SetFrame(2.5 * f + 0.3)
            rc.Render()
            out.append(np.asarray(rc.framebuffer()))
        return out

    ref = frames(1)
    win = frames(4)
    assert window_runs[0] == [1] * 4
    assert any(not np.array_equal(ref[0], r) for r in ref[1:])
    for a, b in zip(ref, win):
        np.testing.assert_array_equal(a, b)


def _checksums_eager(n):
    ctx = CKContext(device="cpu")
    rc, obj, _mat = _scene(ctx)
    out = []
    for f in range(n):
        _move(obj, f)
        rc.Render()
        assert rc.GetFrameFence() is rc.fb       # W = 1: the framebuffer
        out.append(tw.checksum(rc.fb))
    return torch.stack(out), rc.fb


def test_fence_entries_equal_eager_checksums(window_runs):
    ref, _fb = _checksums_eager(6)
    ctx = CKContext(device="cpu")
    rc, obj, _mat = _scene(ctx)
    rc.SetFramePipelining(3)
    fences = []
    for f in range(6):
        _move(obj, f)
        rc.Render()
        if f % 3 == 2:
            fences.append(rc.GetFrameFence().clone())
    assert window_runs[0] == [3, 3]
    assert all(f.shape == (3,) and f.dtype == torch.float32 for f in fences)
    assert torch.equal(torch.cat(fences), ref)
    assert len(set(ref.tolist())) > 1


def test_partial_window(window_runs):
    """Six frames at W = 4: the second window runs its two staged frames
    only, at the fb read; its fence repeats the last frame's checksum."""
    ref, fb_ref = _checksums_eager(6)
    ctx = CKContext(device="cpu")
    rc, obj, _mat = _scene(ctx)
    rc.SetFramePipelining(4)
    for f in range(6):
        _move(obj, f)
        rc.Render()
    assert window_runs[0] == [4]
    assert torch.equal(rc.fb, fb_ref)
    assert window_runs[0] == [4, 2]
    fence = rc.GetFrameFence()
    assert torch.equal(fence, torch.stack([ref[4], ref[5], ref[5], ref[5]]))


def _hud(ctx):
    hud = CKSprite(ctx, "hud")
    icon = np.zeros((12, 12, 4), np.float32)
    icon[2:10, 2:10] = (0.1, 0.9, 0.2, 0.8)
    hud.SetImage(icon)
    hud.SetRect((4, 4, 20, 20))
    return hud


CHANGES = {
    "set_image": lambda tex, mat, hud: tex.SetImage(_checker(16, 4)),
    "sampler": lambda tex, mat, hud: mat.SetTextureMagMode(
        int(VXTEXTURE_FILTER.NEAREST)),
    "hud_moved": lambda tex, mat, hud: hud.SetRect((30, 10, 46, 26)),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_key_change_flushes(change, window_runs):
    """Two frames, a change, two frames, one read: at W = 4 the change
    flushes the two staged frames as they were, and the last frame and the
    fences equal W = 1's."""
    def frames(window):
        ctx = CKContext(device="cpu")
        rc, obj, mat = _scene(ctx, textured=True)
        tex = mat.GetTexture(0)
        hud = _hud(ctx)
        rc.SetFramePipelining(window)
        sums = []
        for f in range(4):
            if f == 2:
                CHANGES[change](tex, mat, hud)
            _move(obj, f)
            rc.Render()
            if window == 1:
                sums.append(tw.checksum(rc.fb))
        return rc, sums

    rc1, sums = frames(1)
    runs, _reads, pending = window_runs
    rcw, _ = frames(4)
    assert runs == [2]                          # the change flushed
    assert torch.equal(rcw.fb, rc1.fb) and torch.equal(rcw.zb, rc1.zb)
    assert runs == [2, 2]
    assert torch.equal(rcw.GetFrameFence()[:2], torch.stack(sums[2:]))
    assert torch.equal(pending[0].fence[:2], torch.stack(sums[:2]))


def test_resize_runs_the_staged_frames(window_runs):
    """Resize runs the frames staged at the old size first; the next
    window is keyed to the new size."""
    ctx = CKContext(device="cpu")
    rc, obj, _mat = _scene(ctx)
    ref, _fb = _checksums_eager(2)
    rc.SetFramePipelining(4)
    for f in range(2):
        _move(obj, f)
        rc.Render()
    rc.Resize(48, 32)
    assert window_runs[0] == [2]
    assert torch.equal(window_runs[2][0].fence[:2], ref)
    rc.Render()
    assert rc.fb.shape == (4, 32, 48) and window_runs[0] == [2, 1]


def test_accumulate_frame_renders_eagerly(window_runs):
    """A frame that keeps the last framebuffer runs after the staged ones,
    eagerly, and the sequence equals W = 1's."""
    def frames(window):
        ctx = CKContext(device="cpu")
        rc, obj, _mat = _scene(ctx)
        rc.SetFramePipelining(window)
        for f in range(3):
            _move(obj, f)
            if f == 2:
                rc.SetClearBackground(False)
            rc.Render()
        return rc.framebuffer()

    ref = frames(1)
    win = frames(3)
    assert window_runs[0] == [2]
    np.testing.assert_array_equal(win, ref)


def _tick_frames(build, kw, window, n, setup=None):
    """A first eager frame (it compiles the scene, which resets the caps
    and the peel's round count), ``setup(rc)``, then n ticks at W =
    ``window``; at W = 1 each tick's (fb, zb, checksum)."""
    import ckrenderengine_tpu_torch.objects as O

    _c, rc, mover = build(O, device="cpu", **kw)
    rc.Render()
    if setup is not None:
        setup(rc)
    rc.SetFramePipelining(window)
    out = []
    for _ in range(n):
        mover.Rotate((0, 1, 0), 0.03)
        rc.Render()
        if window == 1:
            out.append((rc.fb.clone(), rc.zb.clone(), tw.checksum(rc.fb)))
    return rc, out


def _flagged(reads, word):
    return [int(r[:, word].astype(bool).sum()) for r in reads]


def test_solve_remainder_is_flagged_and_redone(window_runs):
    """config 2 at 256x192 (a tiled frame) with a pair cap of 512, far under
    its live pairs: the device-decided frame runs no remainder and flags
    it; the window renders the frame again through the eager remainder, so
    the window equals W = 1 at the same caps, and SolveFallbackRows counts
    the cut rows (the governor is off on the CPU)."""
    kw = dict(width=256, height=192)

    def tiny(rc):
        rc._solve_caps = (512, 131072, 8192)

    rc1, ref = _tick_frames(scenes.build_config2, kw, 1, 3, tiny)
    rcw, _ = _tick_frames(scenes.build_config2, kw, 3, 3, tiny)
    runs, reads, _p = window_runs
    fence = rcw.GetFrameFence()
    assert runs == [3] and len(reads) == 1
    assert tw.flagged(reads[0]).all()
    assert (reads[0][:, 3] > 0).all()           # SolveBinStats pair_cut
    assert torch.equal(rcw.fb, ref[-1][0]) and torch.equal(rcw.zb, ref[-1][1])
    assert torch.equal(fence, torch.stack([r[2] for r in ref]))
    # The window reports its worst frame's fallback rows.
    cut = reads[0][:, 3:6].sum(1)
    assert rcw.stats.SolveFallbackRows == int(cut.max())
    assert 0 < rc1.stats.SolveFallbackRows <= int(cut.max())


def test_stencil_window_flags_both_solves(window_runs):
    """A stencil scene (config 2 and a stencil-only quad, 256x192, tiled)
    at a pair cap of 512 and a g cap of 1 (the quad's rows are leftovers):
    the frame's solve and the stencil's both flag their remainder, the
    window redoes the frames, and fb, zb and the mask sb equal W = 1's."""
    kw = dict(width=256, height=192)

    def tiny(rc):
        rc._solve_caps = (512, 131072, 1)

    rc1, ref = _tick_frames(scenes.build_stencil, kw, 1, 2, tiny)
    rcw, _ = _tick_frames(scenes.build_stencil, kw, 2, 2, tiny)
    assert torch.equal(rcw.sb, rc1.sb) and rcw.sb.float().mean() > 0.01
    assert torch.equal(rcw.fb, ref[-1][0]) and torch.equal(rcw.zb, ref[-1][1])
    runs, reads, _p = window_runs
    assert runs == [2]
    assert _flagged(reads, tw.flag_word("StencilRemainder")) == [2]
    assert (reads[0][:, 3] > 0).all()


def test_device_decided_frame_flags_the_remainder():
    """The frame function itself: with ``flags`` no remainder runs, and
    SolveBinStats says it was needed."""
    import ckrenderengine_tpu_torch.objects as O

    _c, rc, _m = scenes.build_config2(O, device="cpu", width=256, height=192)
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    tp = dict(tp, solve_caps=(512, 131072, 8192))
    flags = {}
    tfr.render_frame_packed(st, torch.as_tensor(tf), torch.as_tensor(ti),
                            **tp, flags=flags)
    bins = flags["SolveBinStats"]
    assert bins.shape == (7,) and bool(bins[2:5].any())
    flags = {}
    tfr.render_frame_packed(st, torch.as_tensor(tf), torch.as_tensor(ti),
                            **dict(tp, solve_caps=None), flags=flags)
    assert not bool(flags["SolveBinStats"][2:5].any())


def _overflowing(monkeypatch):
    phase_a = co.phase_a

    def overflowing(*a, **k):
        return dict(phase_a(*a, **k), bad=torch.tensor(True))

    monkeypatch.setattr(co, "phase_a", overflowing)


ALPHA_B3 = dict(width=256, height=192, n_sheets=6, sheet_n=15)
ALPHA_PEEL = dict(width=256, height=192, n_sheets=6, sheet_n=11)


def test_blend_replay_is_flagged_and_redone(window_runs, monkeypatch):
    """B3's phase A overflowing: the device-decided frame composites
    anyway and flags OrderedReplay; the redo replays the exact pass, as
    W = 1 does, and OrderedReplays counts it."""
    _overflowing(monkeypatch)
    rc1, ref = _tick_frames(scenes.build_alpha50k, ALPHA_B3, 1, 2)
    rcw, _ = _tick_frames(scenes.build_alpha50k, ALPHA_B3, 2, 2)
    runs, reads, _p = window_runs
    assert torch.equal(rcw.fb, ref[-1][0]) and torch.equal(rcw.zb, ref[-1][1])
    assert torch.equal(rcw.GetFrameFence(), torch.stack([r[2] for r in ref]))
    word = tw.flag_word("OrderedReplay")
    assert runs == [2] and _flagged(reads, word) == [2]
    # The first, eager frame replays too.
    assert rcw.stats.OrderedReplays == rc1.stats.OrderedReplays == 3


def test_peel_with_too_few_rounds_is_flagged_and_redone(window_runs):
    """A textured stack needing two peel rounds, run at R = 1: both frames
    of the first window flag PeelMore and are redone (equal to W = 1); the
    redo's round count becomes R, and the next window flags nothing."""
    def one_round(rc):
        rc._peel_rounds = 1

    rc1, ref = _tick_frames(scenes.build_alpha_tex50k, ALPHA_PEEL, 1, 4)
    assert rc1.stats.OrderedPeelRounds == 2
    import ckrenderengine_tpu_torch.objects as O

    _c, rcw, mover = scenes.build_alpha_tex50k(O, device="cpu", **ALPHA_PEEL)
    rcw.Render()
    one_round(rcw)
    rcw.SetFramePipelining(2)
    fences = []
    for f in range(4):
        mover.Rotate((0, 1, 0), 0.03)
        rcw.Render()
        if f % 2 == 1:
            fences.append(rcw.GetFrameFence().clone())
    runs, reads, _p = window_runs
    word = tw.flag_word("PeelMore")
    assert runs == [2, 2] and _flagged(reads, word) == [2, 0]
    assert [w.rounds for w in (rcw._window,)] == [2]
    assert rcw._peel_rounds == 2 and rcw.stats.OrderedPeelRounds == 2
    assert torch.equal(rcw.fb, ref[-1][0])
    assert torch.equal(torch.cat(fences), torch.stack([r[2] for r in ref]))


def test_extra_peel_round_leaves_frame_unchanged():
    """A round over drained pixels: peel_rounds 3 against 2 on a frame that
    drains in 2, bit for bit, and the composite of empty layers alone is
    the identity."""
    import ckrenderengine_tpu_torch.objects as O

    _c, rc, _m = scenes.build_alpha_tex50k(O, device="cpu", **ALPHA_PEEL)
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    tf, ti = torch.as_tensor(tf), torch.as_tensor(ti)
    outs = []
    for rounds in (2, 3):
        flags = {}
        outs.append(tfr.render_frame_packed(st, tf, ti, **tp, flags=flags,
                                            peel_rounds=rounds))
        assert not bool(flags["PeelMore"]) and not bool(flags["PeelBad"])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][0], rc.fb)

    scene, batch, _setup, defer, bits = tfr.packed_setup(st, tf, ti, tp)
    ob = tfr.ordered_batch(scene, batch, defer, bits, tp["ordered_cap"])
    h, w = rc.height, rc.width
    lids = torch.full((co.K_LAYERS, h, w), -1, dtype=torch.int32)
    les = torch.zeros((co.K_LAYERS, 3, h, w))
    fb = rc.fb.clone()
    out = tfr._composite_peeled(fb, ob, lids, les, scene,
                                tp["sampler_profile"], h, w)
    assert torch.equal(out, fb)


def test_port_queue_has_no_window_or_governor_item():
    """Items 4 (frame windows) and 11 (the capacity governor) are carried:
    no key in PORT_QUEUE and no ``unported(..., 4)`` or ``(..., 11)`` in
    the port, and a context takes W = 8."""
    import pathlib
    import re

    import ckrenderengine_tpu_torch
    from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE

    assert 4 not in PORT_QUEUE and 11 not in PORT_QUEUE
    root = pathlib.Path(ckrenderengine_tpu_torch.__file__).parent
    cites = re.compile(r"unported\([^()]*(\([^()]*\)[^()]*)*,\s*(4|11)\s*\)")
    for path in root.rglob("*.py"):
        assert not cites.search(path.read_text()), path
    rc, _obj, _mat = _scene(CKContext(device="cpu"))
    rc.SetFramePipelining(8)
    assert rc.GetFramePipelining() == 8
