"""The row path of the opaque shade as a whole, through ``Render()`` on the
CPU: which branch a frame takes, and the frame against the reference's
accelerator branch (tests/_torch_common.accelerator_branch).

- ``config2_even`` (256x192; the textured plane with a mip chain and a
  trilinear filter, every state perspective): quantized rows with the
  solve's e-planes and the 2x2-quad mip LOD;
- ``config2_odd`` (the same scene at 256x193): a mip frame of odd size
  takes the compact rows with the analytic LOD. Only the height is odd: at
  an odd width the scene's plane of symmetry runs through a column of
  pixel centres, and the reference's own frame then disagrees with its own
  solve on more than 0.1% of the pixels (one-pixel cracks on shared edges,
  tests/test_torch_slice.py);
- ``config1`` (flat): ``shade_deferred``, no row table, no tiled solve.

The bounds against the reference are those of tests/test_torch_slice.py
(check_frame_against_reference): winners equal on >= 99.9% of the pixels
and tied elsewhere, depths within f32 rounding, framebuffers within 1/255
on all but 0.1% of the matching pixels. With ``CK_FUSED_FETCH`` set the
frame is bit-equal to the default path's (the fetch inside the solve
against the gather after it).
"""

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.raster import deferred as tdf
from tests._torch_common import check_render, render_both

SCENES = {
    "config2_even": (scenes.build_config2,
                     dict(width=256, height=192, mips=True), "quant"),
    "config2_odd": (scenes.build_config2,
                    dict(width=256, height=193, mips=True), "compact"),
    "config1": (scenes.build_config1, dict(size=96, accelerator=False),
                "flat"),
}


def _spy(monkeypatch, calls):
    """Count the calls of the stages that tell the branches apart."""
    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            if name == "depth_reduce_tiled_cuda":
                calls["fetch"] = calls.get("fetch", 0) + (
                    k.get("shade_tbl") is not None)
                calls["eplanes"] = calls.get("eplanes", 0) + bool(
                    k.get("want_eplanes"))
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    for name in ("shade_row_table_quant", "shade_row_table_compact",
                 "shade_deferred", "gather_winner_rows"):
        wrap(tdf, name)
    for name in ("depth_reduce_tiled_cuda", "depth_reduce_cuda"):
        wrap(tfr, name)


def _port_context(name):
    import ckrenderengine_tpu_torch.objects as O

    build, kw, _branch = SCENES[name]
    kw = {k: v for k, v in kw.items() if k != "accelerator"}
    return build(O, device="cpu", **kw)[1]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_takes_the_accelerator_branch(name, monkeypatch):
    rc = _port_context(name)
    calls = {}
    _spy(monkeypatch, calls)
    rc.Render()
    branch = SCENES[name][2]
    sp = rc._fill_packed([], [])[3]["sampler_profile"]
    if branch == "flat":
        assert calls == {"depth_reduce_cuda": 1, "shade_deferred": 1}
        return
    assert sp[1] and sp[3]                  # mips on, every state perspective
    want = {"depth_reduce_tiled_cuda": 1, "gather_winner_rows": 1,
            "fetch": 0, "eplanes": int(branch == "quant"),
            "shade_row_table_" + branch: 1}
    assert calls == want


@pytest.mark.parametrize("name", ["config2_even", "config2_odd"])
def test_render_matches_accelerator_reference(name):
    build, kw, _branch = SCENES[name]
    check_render(render_both(build, **kw))


@pytest.mark.parametrize("name", ["config2_even", "level"])
def test_fused_fetch_switch_is_bit_equal(name, monkeypatch):
    """CK_FUSED_FETCH set against unset: the solve fetches the rows itself
    (no gather after it), and fb and zb are bit-equal."""
    import ckrenderengine_tpu_torch.objects as O

    if name == "level":
        build, kw = scenes.build_config5, dict(width=160, height=120,
                                               terrain_n=240, n_balls=8)
    else:
        build, kw = SCENES[name][:2]
    monkeypatch.delenv("CK_FUSED_FETCH", raising=False)
    rc = build(O, device="cpu", **kw)[1]
    rc.Render()
    fb, zb = rc.fb.clone(), rc.zb.clone()
    monkeypatch.setenv("CK_FUSED_FETCH", "1")
    calls = {}
    _spy(monkeypatch, calls)
    rc2 = build(O, device="cpu", **kw)[1]
    rc2.Render()
    assert calls["fetch"] == 1 and calls["eplanes"] == 1
    assert "gather_winner_rows" not in calls
    assert torch.equal(rc2.fb, fb) and torch.equal(rc2.zb, zb)
    assert (fb != fb[:, :1, :1]).any(0).float().mean() > 0.3


def test_odd_frame_ignores_the_switch(monkeypatch):
    """The compact branch has no fused fetch: the switch changes nothing."""
    monkeypatch.setenv("CK_FUSED_FETCH", "1")
    calls = {}
    _spy(monkeypatch, calls)
    rc = _port_context("config2_odd")
    rc.Render()
    assert calls["fetch"] == 0 and calls["shade_row_table_compact"] == 1
    assert np.isfinite(rc.framebuffer()).all()
