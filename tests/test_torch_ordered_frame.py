"""The ordered pass inside the frame, port against reference on the CPU:
small scenes through both packages' Render(). All share the transparency
stress scenes' camera and 3,200-triangle opaque floor, cut to 256x192:

- ``alpha_b3``: 6 sheets x 450 untextured alpha-over triangles,
  ordered_cap*H*W > 2^26 — both packages take the B3 branch (the port its
  plain version, the reference its Pallas kernel in interpret mode);
- ``alpha_gate``: 2 sheets x 128, under the 2^26 gate — ``render_pass``
  in both;
- ``cutout``: alpha-tested fences that write z — outside both kernel
  envelopes, ``render_pass`` in both.

The opaque floor is a tiled frame, which both packages shade from quantized
rows, the reference only on its accelerator branch: its frames are rendered
there (tests/_torch_common.render_reference), so both carry the same
quantization and the bounds below stay those of f32 rounding.

The textured scene (B4 branch) is in tests/test_torch_peel.py.

What is compared, and why:

- Opaque winners (``alpha_b3``, whose floor and camera every scene here
  shares) as in tests/test_torch_slice.py: >= 99.9% equal, the rest ties.
- Framebuffers within 1e-4 (the reference tests' bound for B3 and the
  sequential pass) on all but 0.1% of the pixels. On those, a z-writing
  cutout fragment and the opaque floor tie in depth: the two packages'
  opaque depths round apart (tests/test_torch_slice.py says why), so the
  z test goes opposite ways, and the two frames' depth buffers differ
  there by a near-tie (<= 1e-4).

A phase-A overflow replays the exact tiled pass inside the frame: checked
on both kernel branches by making phase A report overflow.
"""

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import cuda_ordered as co
from tests._torch_common import (
    check_frame_against_reference, port_frame_ids, reference_winners,
    render_ids, render_reference, to_np,
)

SCENES = {
    "alpha_b3": (scenes.build_alpha50k,
                 dict(width=256, height=192, n_sheets=6, sheet_n=15)),
    "alpha_gate": (scenes.build_alpha50k,
                   dict(width=256, height=192, n_sheets=2, sheet_n=8)),
    "cutout": (scenes.build_cutout, dict(width=256, height=192)),
}


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def frames():
    """{name: (reference context, port context)}, each rendered once."""
    import ckrenderengine_tpu_torch.objects as O

    out = {}
    for name, (build, kw) in SCENES.items():
        rj = render_reference(build, **kw)
        _c, rt, _m = build(O, device="cpu", **kw)
        render_ids(rt)
        out[name] = (rj, rt)
    return out


def test_opaque_winners_and_frame_match_reference(frames):
    rj, rt = frames["alpha_b3"]
    ref = reference_winners(*rj._fill_packed([], []))
    st, tf, ti, tp = rt._fill_packed([], [])
    ids = port_frame_ids(rt, st, _t(tf), _t(ti), tp)
    check_frame_against_reference(to_np(ids), to_np(rt.fb), to_np(rt.zb),
                                  ref, rj)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_takes_the_reference_branch(frames, name):
    _rj, rt = frames[name]
    tp = rt._fill_packed([], [])[3]
    sp = tp["sampler_profile"]
    gated = tp["ordered_cap"] * rt.height * rt.width > 1 << 26
    assert tp["ordered_cap"] > 0
    assert gated == (name == "alpha_b3")
    # TexturedPeel is on by default, so the alpha scenes satisfy the peel
    # envelope too; the blend kernel's comes first. Cutouts write z.
    assert sp[5] == sp[6] == (name != "cutout")
    assert rt.GetStats().OrderedReplays == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_matches_reference(frames, name):
    rj, rt = frames[name]
    fb, zb = to_np(rt.fb), to_np(rt.zb)
    fb_r, zb_r = np.asarray(rj.fb), np.asarray(rj.zb)
    diff = np.abs(fb - fb_r).max(0)
    off = diff > 1e-4
    assert off.mean() <= 1e-3, (int(off.sum()), float(diff.max()))
    dz = np.abs(zb.astype(np.float64) - zb_r)[off]
    assert np.all((dz > 0) & (dz <= 1e-4)), dz
    assert (fb != fb_r[:, :1, :1]).any(0).mean() > 0.5
    if name == "cutout":
        assert (zb != to_np(tfr.render_frame_packed(
            *_port_inputs(rt)[:3], **dict(_port_inputs(rt)[3],
                                          ordered_cap=0))[1])).mean() > 0.01


def _port_inputs(rt):
    st, tf, ti, tp = rt._fill_packed([], [])
    return st, _t(tf), _t(ti), tp


def _overflowing(monkeypatch):
    phase_a = co.phase_a

    def overflowing(*a, **k):
        return dict(phase_a(*a, **k), bad=torch.tensor(True))

    monkeypatch.setattr(co, "phase_a", overflowing)


def test_blend_overflow_replays_in_frame(frames, monkeypatch):
    """B3 branch: the replayed frame equals render_pass_tiled's (profile
    bits 5 and 6 off) bit for bit, and OrderedReplays counts it."""
    _rj, rt = frames["alpha_b3"]
    st, tf, ti, tp = _port_inputs(rt)
    exact = dict(tp, sampler_profile=tuple(
        False if i in (5, 6) else v
        for i, v in enumerate(tp["sampler_profile"])))
    fb_x, zb_x, st_x = tfr.render_frame_packed(st, tf, ti, **exact,
                                               want_stats=True)
    assert st_x["OrderedReplays"] == 0
    _overflowing(monkeypatch)
    fb, zb, stats = tfr.render_frame_packed(st, tf, ti, **tp,
                                            want_stats=True)
    assert stats["OrderedReplays"] == 1
    assert stats["OrderedPeelCorrected"] == 0
    assert torch.equal(fb, fb_x) and torch.equal(zb, zb_x)


def test_peel_overflow_replays_in_frame(monkeypatch):
    """B4 branch: no peel round runs, the exact tiled pass replays inside
    the frame (within the peel's 0.02 of its kernel frame), and both
    OrderedPeelCorrected and OrderedReplays count it, also in GetStats()."""
    import ckrenderengine_tpu_torch.objects as O

    _c, rt, _m = scenes.build_alpha_tex50k(O, device="cpu", width=256,
                                           height=192, sheet_n=14)
    rt.Render()
    fb_k = to_np(rt.fb)
    _overflowing(monkeypatch)
    rt.Render()
    stats = rt.GetStats()
    assert stats.OrderedPeelCorrected == 1 and stats.OrderedReplays == 1
    assert stats.OrderedPeelOverflow and stats.OrderedPeelRounds == 0
    assert np.abs(to_np(rt.fb) - fb_k).max() <= 0.02
