"""The effects level (``scenes.build_config5_fx``, cut down) with Antialias
and in frame windows, on the CPU.

- Antialias: the frame renders at twice its size (the sprites' corners,
  the ordered pass and the line pass at 256x192, against the 2x depth
  buffer) and resolves. Held to the reference's accelerator branch by
  ``check_render`` (``check_aa_frame_against_reference``: the 1x bounds
  per display pixel over its 4 samples), with the pixels of
  ``tests/_torch_common.fx_explained`` taken at the render size.
- A frame window of 4 (``SetFramePipelining``) with the spinner turning
  every tick, so the parented halos and the star move: each frame's fence
  entry equals the eager frame's checksum and the last frame's fb and zb
  are bit-equal to the eager run's, with one window run. On the CPU the
  window runs the device-decided frame slot by slot (on the card, graph
  replays): the sprite rows and the line bank are part of its key, held
  by identity.
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.pipeline import window as tw
from tests._torch_common import check_render, fx_explained, render_both

AA = dict(width=128, height=96, terrain_n=24, n_balls=8, n_sprites=192,
          n_curves=3, curve_steps=12)
WIN = dict(width=96, height=72, terrain_n=24, n_balls=8, n_sprites=96,
           n_curves=2, curve_steps=12)


def test_fx_antialias_matches_reference():
    pair = render_both(scenes.build_config5_fx, frame_ids=True,
                       antialias=True, **AA)
    rj, rt, _packed, _ref = pair
    tp = check_render(pair, own_setup=True, explained=fx_explained(pair))
    assert tp["ss"] == 2 and tuple(rt.fb.shape) == (4, 96, 128)
    assert rt.GetStats().NbLinesDrawn == rj.GetStats().NbLinesDrawn


def _frames(window, n=4):
    _ctx, rc, spinner = scenes.build_config5_fx(O, device="cpu", **WIN)
    rc.SetFramePipelining(window)
    sums = []
    for _ in range(n):
        spinner.Rotate((0.0, 1.0, 0.0), 0.05)
        rc.Render()
        if window == 1:
            sums.append(tw.checksum(rc.fb))
    fence = rc.GetFrameFence()
    return (torch.stack(sums) if window == 1 else fence.clone(),
            rc.fb.clone(), rc.zb.clone(), rc)


def test_fx_window_equals_eager_frames(monkeypatch):
    runs = []
    run = tw.FrameWindow.run

    def counted(self, slots):
        runs.append(len(slots))
        return run(self, slots)

    monkeypatch.setattr(tw.FrameWindow, "run", counted)
    ref_sums, ref_fb, ref_zb, _rc = _frames(1)
    assert runs == []
    win_sums, fb, zb, rc = _frames(4)
    assert runs == [4]
    assert len(set(ref_sums.tolist())) == 4     # the frames move
    assert torch.equal(win_sums, ref_sums)
    assert torch.equal(fb, ref_fb) and torch.equal(zb, ref_zb)
    key = rc._window.key
    sprites = rc._fill_packed([], [])[3]["sprites_static"]
    assert any(isinstance(k, tw._Same) and k.obj is sprites["pool_base"]
               for k in _flat(key))
    assert any(isinstance(k, tw._Same) and k.obj is rc._compiled.line_bank.idx
               for k in _flat(key))


def _flat(key):
    for k in key:
        if isinstance(k, tuple):
            yield from _flat(k)
        else:
            yield k
