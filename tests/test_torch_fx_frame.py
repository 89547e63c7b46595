"""A Ballance level's effects through ``Render()`` of both packages on the
CPU: ``scenes.build_config5_fx`` cut down to 160x120, a 120x120 terrain
(28,800 triangles in 7 chunks, of which the host culls one, so the frame
compacts its chunks and the line pass reads the scene from before that),
8 spheres, 192 3D sprites (96 glow halos, 48 sparks, 8 halos
parented to the spheres, 40 tree cards) and 3 curves at step count 12
beside the wireframe grid and the line-list star: 340 line segments. A
tiled frame; the ordered sprites take the exact flat pass at this size
(ordered_cap * H * W <= 2^26) in both packages, the line pass the port's
plain version.

The frame is held to ``check_render(own_setup=True)`` (opaque winners on
>= 99.9% of the pixels, the rest ties; depths within f32 rounding;
colours within 1/255 on all but 0.1% of the matching pixels). Those last
pixels lie on an ill-conditioned edge of an opaque winner or of a sprite
or ordered triangle (whose corners each package's billboard stage rounds:
the reference's jit may contract their multiply-adds), or in the line
pass's rounding band (``tests/_torch_common.fx_explained``; the band
holds endpoints to 1e-3 px and depths to 1e-5). The counters
``NbLinesDrawn`` and ``NbTrianglesDrawn`` equal the reference's, and the
reference's own packed inputs (its sprite rows and line bank through
``convert``) render through the port to the port's own frame.
"""

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.pipeline import frame as tfr
from ckrenderengine_tpu_torch.pipeline import lines as tl
from tests._torch_common import (
    check_render, fx_explained, render_both, to_np,
)

FX = dict(width=160, height=120, terrain_n=120, n_balls=8, n_sprites=192,
          n_curves=3, curve_steps=12)


@pytest.fixture(scope="module")
def fx():
    return render_both(scenes.build_config5_fx, frame_ids=True, **FX)


def test_fx_scene(fx):
    rj, rt, _packed, _ref = fx
    c = rt._compiled
    assert len(c.sprite3d_list) == 192 and c.extra_pool == 4 * 192
    # Curves of 12 control points at step count 12 take 2 steps per span
    # (the reference's max(12 // spans, 2)): a closed curve 24 segments, an
    # open one 22; then the grid's 208 edges and the star's 64 chords.
    assert len(c.line_segments) == 24 + 22 + 22 + 208 + 64
    for name in ("NbLinesDrawn", "NbTrianglesDrawn", "NbVerticesProcessed",
                 "NbObjectDrawn"):
        assert getattr(rt.GetStats(), name) == getattr(rj.GetStats(), name)
    assert rt.GetStats().NbTrianglesDrawn == c.n_valid_tris
    assert c.line_bank.idx.shape[0] % 8 == 0 and c.ordered_cap > 0
    # The frame culls chunks, so the line pass must index the stream from
    # before the compaction.
    _st, _f, ti, tp = rt._fill_packed([], [])
    d = tfr.unpack(torch.as_tensor(_f), torch.as_tensor(ti), tp["layout"])
    assert tp["cull"] is not None and int(d["chunk_n"]) < tp["cull"][3]


def test_fx_frame_matches_reference(fx):
    explained = fx_explained(fx)
    check_render(fx, own_setup=True, explained=explained)


def test_fx_lines_and_sprites_are_drawn(fx):
    """The sprites and lines change the frame: the same frame without the
    line bank, and without the sprite rows, differs on many pixels."""
    _rj, rt, _packed, _ref = fx
    st, tf, ti, tp = rt._fill_packed([], [])
    tf, ti = torch.as_tensor(tf), torch.as_tensor(ti)
    full = to_np(tfr.render_frame_packed(st, tf, ti, **tp)[0])
    np.testing.assert_array_equal(full, to_np(rt.fb))
    no_lines = to_np(tfr.render_frame_packed(st, tf, ti,
                                             **dict(tp, lines=None))[0])
    line_px = (full != no_lines).any(0)
    assert line_px.sum() > 200
    no_sprites = to_np(tfr.render_frame_packed(
        st, tf, ti, **dict(tp, sprites_static=None))[0])
    assert (full != no_sprites).any(0).mean() > 0.05
    # The lines' colours: every changed pixel carries a segment's rgb.
    colors = np.unique(to_np(tp["lines"].color)[:, :3], axis=0)
    got = full[:3, line_px].T
    assert np.all((np.abs(got[:, None] - colors[None]) < 1e-7).all(-1)
                  .any(-1))


def test_fx_reference_inputs_through_the_port(fx):
    """The reference's packed inputs, with its sprite rows and line bank
    converted by convert.from_reference, render through the port to the
    port's own Render() frame: both compiles agree, field for field."""
    _rj, rt, (static, dyn_f, dyn_i, params), _ref = fx
    assert params["sprites_static"] is not None and params["lines"] is not None
    st, tf, ti, tp = convert.from_reference(
        {k: np.asarray(v) for k, v in static.items()}, dyn_f, dyn_i, params,
        "cpu")
    assert isinstance(tp["lines"], tl.LineBank)
    assert set(tp["sprites_static"]) == {"entity_row", "pool_base", "valid"}
    fb = tfr.render_frame_packed(st, tf, ti, **tp)[0]
    np.testing.assert_array_equal(to_np(fb), to_np(rt.fb))
