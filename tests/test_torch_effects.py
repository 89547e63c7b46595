"""Multi-texture effect passes through both packages' ``Render()`` on the
CPU: DP3 normal mapping, bump-environment mapping (EMBM, per vertex, with
the ADDSIGNED bias pass), 2- and 3-texture blends, the SUBTRACT stage op
and a custom effect registered with a callback, on the reference's
tests/test_material_effects.py quad at 48x48 (the effect-pass variant of
``scenes.build_config5_mat`` is tests/test_torch_effects_level.py).

Every pass redraws its base's triangles at LESSEQUAL, blending DESTCOLOR /
ZERO, ONE / ONE or REVSUBTRACT over it, so the frames take the exact
ordered pass (its flat form at this size). They are flat frames, rendered
by the reference as its CPU runs them, and held to ``check_render``:
winners equal on >= 99.9% of the pixels, colours within 1/255 on all but
0.1% of the matching pixels. Each case also holds the property the
reference's own test asserts, on the port's frame.
"""

import numpy as np
import pytest

from ckrenderengine_tpu_torch.objects.material import (
    CKRST_TOP_ADD, CKRST_TOP_MODULATE, CKRST_TOP_SUBTRACT,
    VXEFFECT_2TEXTURES, VXEFFECT_3TEXTURES, VXEFFECT_BUMPENV, VXEFFECT_DP3,
)
from tests._torch_common import check_render, render_both


def _tex(O, ctx, name, arr):
    t = O.CKTexture(ctx, name)
    t.SetImage(np.asarray(arr, np.float32))
    return t


def _flat(O, ctx, rgba, name):
    return _tex(O, ctx, name, np.tile(np.asarray(rgba, np.float32),
                                      (8, 8, 1)))


def _checker(O, ctx, name="checker"):
    img = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    return _tex(O, ctx, name, np.stack([img, img * .5, 1 - img,
                                        np.ones_like(img)], -1))


def _quad(O, effect: str, **ctx_kw):
    """The reference test's emissive quad (camera at z = -3, 48x48) with
    one material effect set up."""
    import importlib

    from ckrenderengine_tpu_torch.raster.types import (
        TEXGEN_CHROME, VXBLEND, VXTEXTUREBLEND,
    )

    VxEffectDescription = importlib.import_module(
        O.__name__ + ".manager").VxEffectDescription

    ctx = O.CKContext(**ctx_kw)
    mesh = O.CKMesh(ctx, "q")
    mesh.SetPositions(np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.SetUVs(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "m")
    mat.SetEmissive((1, 1, 1, 1))
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    O.CK3dObject(ctx, "o").SetCurrentMesh(mesh)
    rc = ctx.GetRenderManager().CreateRenderContext(48, 48)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -3))
    rc.AttachViewpointToCamera(cam)
    rng = np.random.default_rng(7)
    if effect == "dp3":
        mat.SetTexture(_flat(O, ctx, (1, 1, 1, 1), "white"))
        n = rng.normal(0.0, 0.3, (8, 8, 3)).astype(np.float32)
        n[..., 2] = 1.0
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        mat.SetTexture(_tex(O, ctx, "nmap", np.concatenate(
            [n * 0.5 + 0.5, np.ones((8, 8, 1), np.float32)], -1)), 1)
        mat.SetEffect(VXEFFECT_DP3)
        light = O.CKLight(ctx, "sun")
        light.SetType(3)
        light.Rotate((1, 0, 0), 0.6)
        mat.SetEffectParameter(light=light)
    elif effect == "bumpenv":
        mat.SetTexture(_flat(O, ctx, (0.3, 0.3, 0.3, 1), "base"))
        b = rng.uniform(0.3, 0.7, (8, 8)).astype(np.float32)
        mat.SetTexture(_tex(O, ctx, "bump", np.stack(
            [b, 1 - b, b, np.ones_like(b)], -1)), 1)
        mat.SetTexture(_checker(O, ctx, "env"), 2)
        mat.SetEffect(VXEFFECT_BUMPENV)
        mat.SetEffectParameter(bump_scale=1.3)
    elif effect in ("2tex", "3tex"):
        mat.SetTexture(_checker(O, ctx))
        mat.SetTexture(_flat(O, ctx, (0.5, 0.4, 0.3, 1), "light"), 1)
        if effect == "3tex":
            mat.SetTexture(_flat(O, ctx, (0.0, 0.3, 0.1, 1), "glow"), 2)
            mat.SetEffect(VXEFFECT_3TEXTURES)
            mat.SetEffectParameter(op=CKRST_TOP_MODULATE, op2=CKRST_TOP_ADD)
        else:
            mat.SetEffect(VXEFFECT_2TEXTURES)
            mat.SetEffectParameter(op=CKRST_TOP_MODULATE)
    elif effect == "subtract":
        mat.SetDiffuse((0, 0, 0, 1))
        mat.SetTexture(_flat(O, ctx, (0.25, 0.25, 0.25, 1), "flat0"), 0)
        mat.SetTexture(_flat(O, ctx, (0.75, 0.75, 0.75, 1), "flat1"), 1)
        mat.SetEffect(VXEFFECT_2TEXTURES)
        mat.SetEffectParameter(op=CKRST_TOP_SUBTRACT)
    elif effect == "custom":
        def glow(dev, material, stage, arg):
            return [dict(slot=1, texgen=TEXGEN_CHROME,
                         src_blend=int(VXBLEND.ONE),
                         dst_blend=int(VXBLEND.ONE),
                         tex_blend=int(VXTEXTUREBLEND.COPY), dp3=False,
                         bump_slot=-1, bump_scale=0.0, ref_entity=None)]

        rm = ctx.GetRenderManager()
        code = rm.AddEffect(VxEffectDescription(
            summary="MyGlow", set_callback=glow, callback_arg=42))
        mat.SetTexture(_flat(O, ctx, (0.2, 0.2, 0.2, 1), "base"))
        mat.SetTexture(_checker(O, ctx), 1)
        mat.SetEffect(code)
    return ctx, rc, mat


def _quad_port(effect):
    import ckrenderengine_tpu_torch.objects as O

    return _quad(O, effect, device="cpu")


@pytest.mark.parametrize("effect", ["dp3", "bumpenv", "2tex", "3tex",
                                    "subtract", "custom"])
def test_effect_matches_reference(effect):
    pair = render_both(lambda O, **kw: _quad(O, effect, **kw),
                       accelerator=False)
    check_render(pair)
    _rj, rt, _p, _r = pair
    c = rt._compiled
    passes = [b for _m, k, b in c.materials if k == "effectpass"]
    fb = rt.framebuffer()
    centre = fb[24, 24, :3]
    if effect == "dp3":
        assert len(passes) == 1 and passes[0][0]["dp3"]
        # Per-texel dot products: the normal map shows in the frame.
        assert fb[12:36, 12:36, 0].std() > 0.01
    elif effect == "bumpenv":
        assert c.want_bump and len(passes) == 2     # env + ADDSIGNED bias
        assert passes[1][0]["bias_tex"] is not None
    elif effect == "3tex":
        assert len(passes) == 2
    elif effect == "subtract":
        # fb' = tex1 - base = 0.75 - 0.25
        np.testing.assert_allclose(centre, 0.5, atol=0.03)
    elif effect == "custom":
        assert len(passes) == 1 and c.want_texgen
    base_rc = _quad_port("none")[1]
    base_rc.Render()
    assert np.abs(fb - base_rc.framebuffer()).sum() > 1.0


def test_dp3_constant_follows_the_light():
    """DP3's per-frame constant (the light's direction in the entity's
    space) makes the material bank uncacheable: turning the light changes
    the next eager frame, which equals a fresh context's frame with the
    light already turned."""
    _c, rc, mat = _quad_port("dp3")
    rc.Render()
    before = rc.framebuffer().copy()
    light = mat.GetEffectParameter()["light"]
    light.Rotate((1, 0, 0), 0.5)
    rc.Render()
    after = rc.framebuffer()
    assert np.abs(after - before).sum() > 1.0
    _c2, rc2, mat2 = _quad_port("dp3")
    mat2.GetEffectParameter()["light"].Rotate((1, 0, 0), 0.5)
    rc2.Render()
    np.testing.assert_array_equal(rc2.framebuffer(), after)
