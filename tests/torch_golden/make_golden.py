"""Render the golden frames with the reference package on the CPU, on its
accelerator branch.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py

Both frames are tiled, and a tiled frame shades from quantized rows: in the
port on the CPU and on the card alike, in the reference only where its
backend is its accelerator. So the reference renders them through
``Render()`` with that branch switched on
(``tests/_torch_common.render_reference``: the backend reads "tpu", the
Pallas kernels run in interpret mode).

Writes, for each frame, the ``BackToFront()`` uint8 RGBA image and its
per-pixel opaque winner-id map (-1 = background) from the reference's own
stages and exact flat solve:

- ``config2_320x240.npz``: BASELINE config 2 (lit sphere over a textured
  plane, two lights) at 320x240;
- ``alpha_320x240.npz``: the untextured transparency scene
  (``scenes.build_alpha50k``) cut to 4 sheets of 242 alpha-over triangles
  at 320x240 — ordered_cap*H*W > 2^26, so both packages take the affine
  blend kernel B3 (the reference's in interpret mode);
- ``fx_320x240.npz``: the effects level (``scenes.build_config5_fx``) cut
  to a 70x70 terrain, 8 spheres, 1,024 3D sprites (776 of them
  transparent: ordered_cap*H*W > 2^26, so both packages take the textured
  peel B4) and 4 curves at step count 24 with the wireframe grid and the
  line-list star, at 320x240;
- ``mat_320x240.npz``: the material-effects level
  (``scenes.build_config5_mat``) cut to a 70x70 terrain and 8 spheres, at
  320x240: chrome TexGen on the spheres, cube-env TexGen on the crates,
  reflection TexGen on the water, planar TexGen on the plaza and its two
  channels (9,216 ordered triangles: ordered_cap*H*W > 2^26, so both
  packages take the textured peel B4 with the quantized rows' reflection
  words).

- ``shader_320x240.npz``: the shaded level
  (``scenes.build_config5_shaded`` with ``alpha_sheet=True``, its stages
  built on ``jax.numpy``) cut to a 70x70 terrain and 8 spheres, at
  320x240: the vertex shader's wave, the pixel shader in the
  per-pixel-gather shade of the tiled solve (no quantized rows) and in the
  flat ordered pass that composites the alpha sheet.

``python tests/torch_golden/make_golden.py fx_320x240`` writes only the
named frames.

The port's tests and ``chip_smoke.py`` hold the port's frames, on the CPU
and on the GPU, against these files.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIR = os.path.join(ROOT, "tests", "torch_golden")
OUT = os.path.join(DIR, "config2_320x240.npz")
ALPHA_OUT = os.path.join(DIR, "alpha_320x240.npz")
FX_OUT = os.path.join(DIR, "fx_320x240.npz")
MAT_OUT = os.path.join(DIR, "mat_320x240.npz")
SHADER_OUT = os.path.join(DIR, "shader_320x240.npz")


def build_shaded(P, **kw):
    """``scenes.build_config5_shaded`` with its stages on the namespace of
    ``P``'s package: ``torch`` for the port's objects, ``jax.numpy`` for
    the reference's."""
    from ckrenderengine_tpu_torch import scenes

    if P.__name__.startswith("ckrenderengine_tpu_torch"):
        import torch as xp
    else:
        import jax.numpy as xp
    return scenes.build_config5_shaded(P, xp=xp, **kw)


def frames():
    """{path: (scene build function, its keyword arguments)} of the golden
    frames."""
    sys.path.insert(0, ROOT)
    from ckrenderengine_tpu_torch import scenes

    return {OUT: (scenes.build_config2, dict(width=320, height=240)),
            ALPHA_OUT: (scenes.build_alpha50k, dict(
                width=320, height=240, n_sheets=4, sheet_n=11)),
            FX_OUT: (scenes.build_config5_fx, dict(
                width=320, height=240, terrain_n=70, n_balls=8,
                n_sprites=1024, n_curves=4, curve_steps=24)),
            MAT_OUT: (scenes.build_config5_mat, dict(
                width=320, height=240, terrain_n=70, n_balls=8)),
            SHADER_OUT: (build_shaded, dict(
                width=320, height=240, terrain_n=70, n_balls=8,
                alpha_sheet=True))}


def render_reference(path: str = OUT):
    """(rgba uint8 (240,320,4), ids int32 (240,320)) of the reference's
    frame for the golden file ``path``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from tests._torch_common import reference_winners, render_reference

    build, kw = frames()[path]
    rc = render_reference(build, **kw)
    ids, _depth, _setup = reference_winners(*rc._fill_packed([], []))
    return rc.BackToFront(), ids.astype("int32")


if __name__ == "__main__":
    import numpy as np

    names = sys.argv[1:]
    for path in frames():
        if names and os.path.basename(path)[:-4] not in names:
            continue
        rgba, ids = render_reference(path)
        np.savez_compressed(path, rgba=rgba, ids=ids)
        print(path, os.path.getsize(path), "bytes")
