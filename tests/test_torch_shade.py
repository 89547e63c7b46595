"""The deferred shade (shade_deferred -> _shade_deferred_fast ->
shade_row_table -> shade_rows, with texture sampling and the stage blend)
against the reference on the same winners and attributes: textured wrap and
clamp states (nearest and bilinear), fog, specular, an untextured state, and
a mip-mapped texture; fb within 2e-6 (all but <= 1% of the pixels, which
must sit on ill-conditioned edges and stay within 1/255; see
tests/_torch_common.assert_fb_close)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests._torch_common import assert_fb_close, to_np
from tests.test_tiled_raster import _random_batch

from ckrenderengine_tpu.raster import deferred as jdf
from ckrenderengine_tpu.raster.types import (
    RasterState, VXTEXTUREBLEND, VXTEXTURE_ADDRESS, VXTEXTURE_FILTER,
    pack_states,
)
from ckrenderengine_tpu_torch.raster import deferred as tdf


def _states():
    A, F, B = VXTEXTURE_ADDRESS, VXTEXTURE_FILTER, VXTEXTUREBLEND
    return [
        RasterState(tex=0, tex_address=int(A.WRAP), tex_filter=int(F.LINEAR),
                    tex_blend=int(B.MODULATE), fog=True),
        RasterState(tex=1, tex_address=int(A.CLAMP),
                    tex_filter=int(F.NEAREST), tex_blend=int(B.MODULATEALPHA)),
        RasterState(fog=True),                                # untextured
        RasterState(tex=0, tex_address=int(A.CLAMP),
                    tex_filter=int(F.LINEARMIPLINEAR),
                    tex_blend=int(B.DECAL), perspective=False),
    ]


@pytest.mark.parametrize("mips", [False, True], ids=["planes", "mips"])
def test_shade_deferred_matches_reference(mips):
    h, w, t = 96, 128, 160
    rng = np.random.default_rng(11)
    xyw, z, _s, _v = _random_batch(t, h, w, seed=11)
    states = _states()
    si, sf = pack_states(states)
    state = rng.integers(0, len(states), t).astype(np.int32)
    setup = jdf.triangle_setup(xyw, z, jnp.asarray(state), jnp.ones(t, bool),
                               jnp.asarray(si))
    best_id, _bd = jdf.depth_reduce(setup, jnp.ones(t, bool), 1.0,
                                    jnp.asarray([0, 0, w, h], jnp.float32),
                                    h, w)
    color = rng.uniform(0, 1, (t, 3, 4)).astype(np.float32)
    spec = rng.uniform(0, 0.3, (t, 3, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (t, 3, 2)).astype(np.float32)   # wrap/clamp
    fog = rng.uniform(0, 1, (t, 3)).astype(np.float32)
    tw = 8
    tex = rng.uniform(0, 1, (2, 4, tw, tw + (tw // 2 if mips else 0)))
    tex = tex.astype(np.float32)
    tex_hw = (np.array([[tw, tw, 4], [tw, tw, 4]], np.int32) if mips
              else np.array([[tw, tw], [tw, tw]], np.int32))
    fog_color = np.array([0.2, 0.3, 0.4], np.float32)
    clear = np.broadcast_to(np.array([0.1, 0.0, 0.2, 1.0], np.float32)[
        :, None, None], (4, h, w)).copy()

    ref = np.asarray(jdf.shade_deferred(
        best_id, xyw, z, jnp.asarray(color), jnp.asarray(spec),
        jnp.asarray(uv), jnp.asarray(fog), jnp.asarray(state),
        jnp.asarray(si), jnp.asarray(sf), jnp.asarray(tex),
        jnp.asarray(tex_hw), jnp.asarray(fog_color), jnp.asarray(clear),
        h, w))
    T = torch.as_tensor
    got = tdf.shade_deferred(
        T(np.asarray(best_id)), T(np.asarray(xyw)), T(np.asarray(z)),
        T(color), T(spec), T(uv), T(fog), T(state), T(si), T(sf), T(tex),
        T(tex_hw), T(fog_color), T(clear), h, w)
    assert_fb_close(to_np(got), ref, np.asarray(best_id),
                    {k: np.asarray(v) for k, v in setup.items()})
    hit = np.asarray(best_id) >= 0
    assert hit.mean() > 0.3
    # every state shades some pixel
    assert len(np.unique(state[np.asarray(best_id)[hit]])) == len(states)
