"""The host compile carried into the port: for the same scene, the port's
``CKRenderContext._fill_packed`` must produce the reference's packed layout
key, static frame parameters, every static array and both per-frame
buffers bit for bit."""

import numpy as np
import pytest

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from tests._torch_common import to_np

SCENES = {
    "config1": (scenes.build_config1, dict(size=128)),
    "config2": (scenes.build_config2, dict(width=256, height=192)),
    # 28 culling chunks with portals: the chunk cap really compacts.
    "config5_small": (scenes.build_config5,
                      dict(width=160, height=120, terrain_n=240, n_balls=8)),
}
PARAM_KEYS = ("layout", "levels", "height", "width", "corner", "cull",
              "sampler_profile", "ordered_cap", "ss", "want_stencil",
              "want_bump", "want_cube", "want_texgen", "sort_transparent",
              "solve_caps", "skin_ranges")


def _packed(objects, build, kw, **ctx_kw):
    _ctx, rc, _mover = build(objects, **kw, **ctx_kw)
    rc._compile()
    rc._refresh_textures()
    return rc._fill_packed([], [])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fill_packed_bit_equal(name):
    build, kw = SCENES[name]
    rs, rf, ri, rp = _packed(J, build, kw)
    ts, tf, ti, tp = _packed(O, build, kw, device="cpu")
    for k in PARAM_KEYS:
        assert rp[k] == tp[k], k
    assert sorted(rs) == sorted(ts)
    for k in rs:
        r, t = np.asarray(rs[k]), to_np(ts[k])
        assert r.dtype == t.dtype and r.shape == t.shape, k
        assert np.array_equal(r, t), k
    assert rf.dtype == tf.dtype and np.array_equal(rf, tf)
    assert ri.dtype == ti.dtype and np.array_equal(ri, ti)
    if name == "config5_small":
        ch, cap, _itc, n_full = tp["cull"]
        assert cap < n_full          # host chunk culling compacts
