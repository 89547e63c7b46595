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

- ``monitor_320x240.npz``: the monitor level
  (``scenes.build_config5_monitor``) cut to a 70x70 terrain and 8
  spheres, the main context at 320x240 in stereo (eye separation 1.2), the
  producer at 160x120, at the second tick (:func:`monitor_ticks`). Its
  main frame samples the producer's live feed, which sends the reference's
  ``Render()`` to its stereo fallback, whose scene samples the stack of
  its last rebuild (README, port section). So the frame is the
  reference's packed stereo frame, feed included: ``_fill_packed``, the
  eyes' views (``_stereo_eye_views``), one ``render_frame_packed`` per eye
  with the feed, and the side-by-side composite; the winner ids are the
  two eyes' composited the same way.

``python tests/torch_golden/make_golden.py fx_320x240`` writes only the
named frames.

The port's tests and ``chip_smoke.py`` hold the port's frames, on the CPU
and on the GPU, against these files.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIR = os.path.join(ROOT, "tests", "torch_golden")
OUT = os.path.join(DIR, "config2_320x240.npz")
ALPHA_OUT = os.path.join(DIR, "alpha_320x240.npz")
FX_OUT = os.path.join(DIR, "fx_320x240.npz")
MAT_OUT = os.path.join(DIR, "mat_320x240.npz")
SHADER_OUT = os.path.join(DIR, "shader_320x240.npz")
MONITOR_OUT = os.path.join(DIR, "monitor_320x240.npz")
MONITOR = dict(width=320, height=240, target=(160, 120), stereo=(1.2, 60.0),
               terrain_n=70, n_balls=8)
# The spinner's turn per tick of the monitor level.
MONITOR_SPIN = 0.05


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
                alpha_sheet=True)),
            MONITOR_OUT: (scenes.build_config5_monitor, MONITOR)}


def monitor_ticks(P, ticks: int = 2, **ctx_kw):
    """``scenes.build_config5_monitor`` at :data:`MONITOR` through package
    ``P``, with every tick but the last's main frame rendered: tick k
    turns the spinner by MONITOR_SPIN (from the second tick on), renders
    the producer, then the main context. Returns (rc, producer); the
    caller renders the main context's last frame."""
    sys.path.insert(0, ROOT)
    from ckrenderengine_tpu_torch import scenes

    _ctx, rc, producer, spinner = scenes.build_config5_monitor(
        P, **MONITOR, **ctx_kw)
    for rc_ in (rc, producer):
        rc_._gov_on = False
    for k in range(ticks):
        if k:
            spinner.Rotate((0, 1, 0), MONITOR_SPIN)
        producer.Render()
        if k < ticks - 1:
            rc.Render()
    return rc, producer


def stereo_inputs(rc):
    """(static, [left dyn_f, right dyn_f], dyn_i, params) of the frame
    ``rc.Render()`` would render next, for either package: the compile,
    the clear flags and the texture refresh of Render(), then
    ``_fill_packed`` and each eye's view (``_stereo_eye_views``)."""
    rc._frame_flags = rc.ResolveRenderFlags(0)
    if rc._compiled.topology_version != rc.context._topology_version:
        rc._compile()
    rc._refresh_textures()
    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    entries_f, _ = rc._layout
    off = next(o for (n, o, _s, _sh) in entries_f if n == "view")
    eyes = []
    for v in rc._stereo_eye_views(dyn_f[off:off + 16].reshape(4, 4).copy()):
        df = dyn_f.copy()
        df[off:off + 16] = v.reshape(-1)
        eyes.append(df)
    return static, eyes, dyn_i, dict(params, want_stencil=False)


def side_by_side(left, right, width: int):
    """Every other column of each eye, left then right (numpy)."""
    half = width // 2
    return np.concatenate([left[..., ::2][..., :half],
                           right[..., ::2][..., :half]], axis=-1)


def render_monitor_reference():
    """(rgba, ids) of the reference's monitor frame (module docstring)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import ckrenderengine_tpu.objects as J
    from ckrenderengine_tpu.pipeline import frame as jfr
    from tests._torch_common import accelerator_branch, reference_winners

    with accelerator_branch():
        rc, _producer = monitor_ticks(J)
        static, eyes, dyn_i, params = stereo_inputs(rc)
        assert params["texdev"] and rc._compiled.dev_ids
        fbs = [np.asarray(jfr.render_frame_packed(
            static, jnp.asarray(df), jnp.asarray(dyn_i), **params)[0])
            for df in eyes]
    ids = [reference_winners(static, df, dyn_i, params)[0] for df in eyes]
    rc.fb = jnp.asarray(side_by_side(*fbs, rc.width))
    return rc.BackToFront(), side_by_side(*ids, rc.width).astype("int32")


def render_reference(path: str = OUT):
    """(rgba uint8 (240,320,4), ids int32 (240,320)) of the reference's
    frame for the golden file ``path``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from tests._torch_common import reference_winners, render_reference

    if path == MONITOR_OUT:
        return render_monitor_reference()
    build, kw = frames()[path]
    rc = render_reference(build, **kw)
    ids, _depth, _setup = reference_winners(*rc._fill_packed([], []))
    return rc.BackToFront(), ids.astype("int32")


if __name__ == "__main__":
    names = sys.argv[1:]
    for path in frames():
        if names and os.path.basename(path)[:-4] not in names:
            continue
        rgba, ids = render_reference(path)
        np.savez_compressed(path, rgba=rgba, ids=ids)
        print(path, os.path.getsize(path), "bytes")
