"""User pixel shaders in the port's ordered passes, and the shapes each
package's stage receives, against the reference on the CPU (the stages as
in tests/test_torch_shaders.py: ``scenes.config5_shaders`` built on
``jax.numpy`` and on ``torch``).

- ``render_pass`` and ``render_pass_tiled`` with the stage on the
  fixtures of tests/test_torch_ordered.py: fb and zb within 1e-5 on all
  but 0.1% of the values and within 1e-4 on those (that module says why).
- The shapes each package's stage receives, path by path: per pixel plane
  in the deferred shade, the whole frame with the triangle's state rows in
  the flat ordered pass, one tile with its triangle's rows in the tiled
  one (the port maps the stage over its batched tile axis).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster import jax_backend as jrb
from ckrenderengine_tpu_torch import convert, scenes
from ckrenderengine_tpu_torch.raster import deferred as tdf
from ckrenderengine_tpu_torch.raster import torch_backend as rb
from tests.test_torch_ordered import (
    PASS_CASES, TEX, UNTEX, _assert_pass_close, _blend_case, _peel_case, _t,
)
from tests.test_torch_shaders import _shade_inputs, _xp
from tests import test_pallas_peel as peel_fx


def _pass_args(name):
    textured = not (name.startswith("untextured") or name == "clip_planes")
    if textured:
        seed = 3 if name == "cutout_zwrite" else int(name[-1])
        batch, si, sf, fb, zb, h, w = _peel_case(seed, name == "cutout_zwrite")
        tex_planes, tex_hw = peel_fx._tex()
        fog_color = np.asarray([0.2, 0.3, 0.4], np.float32)
        vp = np.asarray([0, 0, w, h], np.float32)
        profile = TEX
    else:
        key = "seed" + name[-1] if name != "clip_planes" else name
        batch, si, sf, fb, zb, fog_color, vp, h, w = _blend_case(key)
        tex_planes = np.zeros((1, 4, 2, 2), np.float32)
        tex_hw = np.asarray([[2, 2]], np.int32)
        profile = UNTEX
    return (batch, fb, zb, (si, sf, tex_planes, tex_hw, fog_color, vp),
            profile, h, w)


def _run_pass(P, tiled, batch, fb, zb, args, profile, stage):
    if P is J:
        fn = jrb.render_pass_tiled if tiled else jrb.render_pass
        # One slot per loop step, as the port's tiled pass takes them (the
        # reference's slot chunk changes its compile time, not its result).
        kw = dict(tile=16, chunk=1) if tiled else dict(chunk=1)
        return fn(jnp.asarray(fb), jnp.asarray(zb), batch,
                  *(jnp.asarray(a) for a in args), sampler_profile=profile,
                  pixel_shader=stage, **kw)
    fn = rb.render_pass_tiled if tiled else rb.render_pass
    kw = dict(tile=16) if tiled else {}
    return fn(_t(fb), _t(zb), convert.batch_from_reference(batch),
              *(_t(a) for a in args), sampler_profile=profile,
              pixel_shader=stage, **kw)


@pytest.mark.parametrize("tiled", [False, True], ids=["flat", "tiled"])
@pytest.mark.parametrize("name", [PASS_CASES[0], PASS_CASES[3],
                                  PASS_CASES[5]])
def test_render_pass_with_stage_matches_reference(name, tiled):
    batch, fb, zb, args, profile, h, w = _pass_args(name)
    ps = {P: scenes.config5_shaders(_xp(P), 0, w, h)[1] for P in (J, O)}
    ref = _run_pass(J, tiled, batch, fb, zb, args, profile, ps[J])
    got = _run_pass(O, tiled, batch, fb, zb, args, profile, ps[O])
    _assert_pass_close(got, ref)
    plain = _run_pass(O, tiled, batch, fb, zb, args, profile, None)
    assert (plain[0] - got[0]).abs().max() > 0.05


def _logging_stage(log):
    def stage(inp):
        log.append(tuple(sorted((k, tuple(v.shape)) for k, v in inp.items())))
        return inp["color"] * inp["texel"]
    return stage


def test_stage_sees_the_reference_shapes():
    """Each package's stage, path by path, receives the same shapes: the
    deferred shade's per-pixel planes, the flat ordered pass's whole frame
    with the triangle's (21,) / (9,) state rows, the tiled pass's one tile
    (16 x 16) with its triangle's rows."""
    logs = {}
    batch, fb, zb, args, profile, h, w = _pass_args(PASS_CASES[3])
    sargs, refl, _setup, sh, sw = _shade_inputs(False)
    for P in (J, O):
        for path in ("deferred", "flat", "tiled"):
            log = logs.setdefault((P.__name__, path), [])
            stage = _logging_stage(log)
            if path == "deferred":
                if P is J:
                    np.asarray(jdf.shade_deferred(
                        *(jnp.asarray(a) for a in sargs), sh, sw,
                        pixel_shader=stage))
                else:
                    tdf.shade_deferred(*(_t(a) for a in sargs), sh, sw,
                                       pixel_shader=stage)
            else:
                out = _run_pass(P, path == "tiled", batch, fb, zb, args,
                                profile, stage)
                np.asarray(out[0])
    for path, want in (("deferred", {"color": (sh, sw, 4),
                                     "texel": (sh, sw, 4), "uv": (sh, sw, 2),
                                     "xy": (sh, sw, 2), "si": (sh, sw, 21),
                                     "sf": (sh, sw, 9)}),
                       ("flat", {"color": (h, w, 4), "texel": (h, w, 4),
                                 "uv": (h, w, 2), "xy": (h, w, 2),
                                 "si": (21,), "sf": (9,)}),
                       ("tiled", {"color": (16, 16, 4), "texel": (16, 16, 4),
                                  "uv": (16, 16, 2), "xy": (16, 16, 2),
                                  "si": (21,), "sf": (9,)})):
        ref = set(logs[(J.__name__, path)])
        got = set(logs[(O.__name__, path)])
        assert ref == got == {tuple(sorted(want.items()))}, path
