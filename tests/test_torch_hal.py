"""The rasterizer HAL (``raster/hal.py``, ``caps.py``, ``batch.py``,
``null_backend.py``) against the reference package's on the CPU: the
reference's ``tests/test_hal.py`` cases that draw nothing, its HAL cases of
``tests/test_lifecycle_surface.py`` and ``tests/test_draw_kinds.py``, and
the object API's driver table. The drawing cases are in
``test_torch_hal_draw.py``.

Where both packages run a case, the port's states, object indices,
counters, buffers, sprite blits and geometry services equal the
reference's. Deliberate differences (README port section): driver 0 is the
CUDA card (``cuda-torch``), each driver carries its own entry of
``enumerate_drivers``, and ``GetPreferredSoftwareDriver`` answers 1 (the
reference's reads a field the table lacks and answers 0).
``supports_render_to_texture`` is True, as in the reference.
"""

import numpy as np
import pytest
import torch

from ckrenderengine_tpu.raster import hal as JH
from ckrenderengine_tpu.raster import batch as JB
from ckrenderengine_tpu.raster import types as JT
from ckrenderengine_tpu.raster.null_backend import NullRasterizer as JNull
import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.raster import batch as TB
from ckrenderengine_tpu_torch.raster import caps as TC
from ckrenderengine_tpu_torch.raster import hal as TH
from ckrenderengine_tpu_torch.raster import types as TT
from ckrenderengine_tpu_torch.raster.hal import (
    CKNULLRasterizerStart, CKRasterizer, CKRST_OBJ_SPRITE,
    CKRST_OBJ_TEXTURE, CKRST_OBJ_VERTEXBUFFER, RSC_LOCKED,
    VXMATRIX_PROJECTION, VXMATRIX_VIEW, VXRENDERSTATE, CKRasterizerContext,
)
from ckrenderengine_tpu_torch.raster.null_backend import NullRasterizer
from ckrenderengine_tpu_torch.raster.types import VXCMP

CPU = "cpu"


def _ctx(w=32, h=32, hal=TH):
    rst = hal.CKRasterizer(device=CPU) if hal is TH else hal.CKRasterizer()
    rst.Start(None)
    drv = rst.GetDriver(0)
    c = drv.CreateContext()
    assert c.Create(None, w, h)
    return rst, drv, c


def _proj(n=1.0, f=100.0):
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = 1.0
    m[2, 2] = f / (f - n)
    m[3, 2] = -n * f / (f - n)
    m[2, 3] = 1.0
    return m


class TestAllocator:
    def test_shared_index_space_per_kind(self):
        seqs = []
        for hal in (TH, JH):
            rst = hal.CKRasterizer(device=CPU) if hal is TH \
                else hal.CKRasterizer()
            rst.Start(None)
            t0 = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
            t1 = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
            s0 = rst.CreateObjectIndex(CKRST_OBJ_SPRITE)
            assert t0 != t1
            assert s0 == t0        # kinds share the slot table byte-masks
            assert rst.ReleaseObjectIndex(t0, CKRST_OBJ_TEXTURE)
            t2 = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
            assert t2 == t0        # first-free cursor rewinds
            seqs.append((t0, t1, s0, t2, rst._objects_index.tolist()))
        assert seqs[0] == seqs[1]

    def test_linked_rasterizers_mirror_indices(self):
        a, b = CKRasterizer(device=CPU), CKRasterizer(device=CPU)
        a.Start(None)
        b.Start(None)
        a.LinkRasterizer(b)
        i = a.CreateObjectIndex(CKRST_OBJ_VERTEXBUFFER)
        assert b._objects_index[i] & CKRST_OBJ_VERTEXBUFFER
        a.RemoveLinkedRasterizer(b)

    def test_null_rasterizer_start(self):
        rst = CKNULLRasterizerStart(device=CPU)
        assert rst is CKNULLRasterizerStart(device=CPU)
        assert rst.GetDriverCount() == 2
        assert rst.GetDriver(0).IsHardware()
        assert not rst.GetDriver(1).IsHardware()
        assert rst.GetDriver(5) is None
        c = rst.GetDriver(1).CreateContext()
        assert c.Create(None, 8, 8) and c.fb.device.type == CPU


class TestDriver:
    def test_caps_and_formats(self):
        rst, drv, c = _ctx()
        assert drv.caps.max_texture_width >= 1024
        assert drv.FindNearestTextureFormat("DXT1") == "DXT1"
        assert drv.FindNearestTextureFormat("weird") == "32_ARGB8888"
        assert drv.FindNearestDepthFormat() == "D32F"
        assert len(drv.display_modes) >= 2
        assert drv.desc == "cuda-torch" and drv.IsHardware()
        assert rst.GetDriver(1).desc == "null-numpy"

    def test_video_card_file_clamps(self, tmp_path):
        ini = tmp_path / "cards.ini"
        ini.write_text("[cuda-torch]\nMaxTextureWidth = 2048\n")
        rst, drv, c = _ctx()
        assert rst.LoadVideoCardFile(str(ini))
        assert drv.caps.max_texture_width <= 2048
        assert rst.GetDriver(1).caps.max_texture_width == 4096
        assert not rst.LoadVideoCardFile(str(tmp_path / "missing.ini"))


class TestStateCache:
    def test_defaults_and_hit_miss(self):
        for hal in (TH, JH):
            rst, drv, c = _ctx(hal=hal)
            assert c.GetRenderState(VXRENDERSTATE.ZFUNC) == int(
                VXCMP.LESSEQUAL)
            h0, m0 = c.render_state_cache_hit, c.render_state_cache_miss
            c.SetRenderState(VXRENDERSTATE.ZFUNC, int(VXCMP.LESSEQUAL))
            assert c.render_state_cache_hit == h0 + 1
            c.SetRenderState(VXRENDERSTATE.ZFUNC, int(VXCMP.ALWAYS))
            assert c.render_state_cache_miss == m0 + 1
            assert c.GetRenderState(VXRENDERSTATE.ZFUNC) == int(VXCMP.ALWAYS)
        _, _, ref = _ctx(hal=JH)
        _, _, port = _ctx()
        assert np.array_equal(port._rs_value, ref._rs_value)
        assert np.array_equal(port._rs_flags, ref._rs_flags)

    def test_locked_state_rejects_writes(self):
        rst, drv, c = _ctx()
        c.SetRenderState(VXRENDERSTATE.FOGENABLE, 1)
        c.SetRenderStateFlags(VXRENDERSTATE.FOGENABLE, RSC_LOCKED)
        c.SetRenderState(VXRENDERSTATE.FOGENABLE, 0)
        assert c.GetRenderState(VXRENDERSTATE.FOGENABLE) == 1
        c.SetRenderStateFlags(VXRENDERSTATE.FOGENABLE, 0)
        c.SetRenderState(VXRENDERSTATE.FOGENABLE, 0)
        assert c.GetRenderState(VXRENDERSTATE.FOGENABLE) == 0

    def test_flush_restores_defaults_keeps_locked(self):
        states = []
        for hal in (TH, JH):
            rst, drv, c = _ctx(hal=hal)
            c.SetRenderState(VXRENDERSTATE.ZFUNC, int(VXCMP.ALWAYS))
            c.SetRenderState(VXRENDERSTATE.SRCBLEND, 5)
            c.SetRenderStateFlags(VXRENDERSTATE.SRCBLEND, RSC_LOCKED)
            c.FlushRenderStateCache()
            assert c.GetRenderState(VXRENDERSTATE.ZFUNC) == int(
                VXCMP.LESSEQUAL)
            assert c.GetRenderState(VXRENDERSTATE.SRCBLEND) == 5
            c.SetRenderState(VXRENDERSTATE.ALPHAREF, 128)
            c.SetRenderState(VXRENDERSTATE.ALPHATESTENABLE, 1)
            states.append(c._raster_state().pack())
            c.InvalidateStateCache()
            assert c.GetRSCacheValue(VXRENDERSTATE.ZFUNC) is None
        for a, b in zip(*states):
            assert np.array_equal(a, b)


class TestSprites:
    def test_pow2_decomposition(self):
        infos = []
        for hal in (TH, JH):
            rst, drv, c = _ctx(64, 64, hal=hal)
            si = rst.CreateObjectIndex(CKRST_OBJ_SPRITE)
            assert c.CreateSprite(si, 100, 40)    # non-pow2
            info = c.GetSpriteData(si)
            assert sum(t for _, t in info["tiles_x"]) >= 100
            assert all((t & (t - 1)) == 0 for _, t in info["tiles_x"])
            assert all((t & (t - 1)) == 0 for _, t in info["tiles_y"])
            infos.append(info)
        assert infos[0] == infos[1]

    def test_draw_sprite_blits(self):
        """The reference's case, then a scaled, clipped, half-transparent
        blit from a source rect: bit-equal to the reference's."""
        rng = np.random.default_rng(3)
        img = rng.uniform(0, 1, (37, 100, 4)).astype(np.float32)
        outs = []
        for hal in (TH, JH):
            rst, drv, c = _ctx(64, 64, hal=hal)
            si = rst.CreateObjectIndex(CKRST_OBJ_SPRITE)
            c.CreateSprite(si, 8, 8)
            red = np.zeros((8, 8, 4), np.float32)
            red[..., 0] = 1.0
            red[..., 3] = 1.0
            assert c.LoadSprite(si, red)
            c.Clear()
            assert c.DrawSprite(si, dst_rect=(10, 10, 26, 26))
            out = c.BackToFront()
            assert out[15, 15, 0] == pytest.approx(1.0)
            assert out[5, 5, 0] == pytest.approx(0.0)
            c.Clear(7, 0xFF336699)
            assert c.LoadSprite(si, img)
            assert c.GetSpriteData(si)["width"] == 100
            assert c.DrawSprite(si, src_rect=(3, 2, 90, 35),
                                dst_rect=(-7, 20, 71, 61))
            assert c.DrawSprite(si, dst_rect=(5, 5, 18, 9))
            assert not c.DrawSprite(si, dst_rect=(70, 70, 80, 80))
            outs.append(c.BackToFront())
        np.testing.assert_array_equal(outs[0], outs[1])


class TestGeometryServices:
    def _setup_cam(self, c):
        view = np.eye(4, dtype=np.float32)
        view[3, 2] = 5.0
        c.SetTransformMatrix(VXMATRIX_VIEW, view)
        c.SetTransformMatrix(VXMATRIX_PROJECTION, _proj())

    def test_transform_vertices(self):
        rst, drv, c = _ctx()
        self._setup_cam(c)
        r = c.TransformVertices([[0, 0, 0], [0, 0, -100]])
        assert r["flags"][0] == 0              # in front, on screen
        assert r["flags"][1] & 16              # behind near plane
        assert not r["offscreen"]
        center = r["screen"][0]
        assert abs(center[0] - 16) < 1 and abs(center[1] - 16) < 1
        r2 = c.TransformVertices([[1000, 0, 0], [2000, 0, 0]])
        assert r2["offscreen"]                 # AND-reduce: all right of view
        _, _, ref = _ctx(hal=JH)
        self._setup_cam(ref)
        pts = np.random.default_rng(1).uniform(-20, 20, (50, 3))
        a, b = c.TransformVertices(pts), ref.TransformVertices(pts)
        for k in ("clip", "screen", "flags"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["offscreen"] == b["offscreen"]

    def test_compute_box_visibility(self):
        rst, drv, c = _ctx()
        self._setup_cam(c)
        assert c.ComputeBoxVisibility((-0.1, -0.1, -0.1),
                                      (0.1, 0.1, 0.1)) == "ALLINSIDE"
        assert c.ComputeBoxVisibility((500, 500, 500),
                                      (501, 501, 501)) == "OFFSCREEN"
        assert c.ComputeBoxVisibility((-50, -50, -50),
                                      (50, 50, 50)) == "VISIBLE"
        world = np.eye(4, dtype=np.float32)
        world[3, 0] = 1000.0
        assert c.ComputeBoxVisibility((-1, -1, -1), (1, 1, 1),
                                      world) == "OFFSCREEN"
        _, _, ref = _ctx(hal=JH)
        self._setup_cam(ref)
        rng = np.random.default_rng(2)
        for _ in range(40):
            lo = rng.uniform(-30, 30, 3)
            hi = lo + rng.uniform(0.1, 30, 3)
            wm = np.eye(4, dtype=np.float32)
            wm[3, :3] = rng.uniform(-5, 5, 3)
            for wv in (None, wm):
                assert (c.ComputeBoxVisibility(lo, hi, wv)
                        == ref.ComputeBoxVisibility(lo, hi, wv))


class TestGuardedAllocator:
    """Guard-byte object-table check (reference GuardedDX9Rasterizer test,
    tests/test_ckdx9_rasterizer_helpers.cpp:44-70: AllocateObjects plants
    0xA5 guard bytes and verifies no overruns)."""

    def test_allocation_growth_never_overruns_guards(self):
        class GuardedContext(CKRasterizerContext):
            GUARD = 0xA5

            def __init__(self, driver):
                super().__init__(driver)
                self.guards = np.full(64, self.GUARD, np.uint8)
                self.alloc_calls = []

            def AllocateObjects(self, capacity):
                self.alloc_calls.append(capacity)
                return super().AllocateObjects(capacity)

            def guards_intact(self):
                return bool((self.guards == self.GUARD).all())

        rst = CKRasterizer(device=CPU)
        rst.Start(None)
        drv = rst.GetDriver(0)
        dev = GuardedContext(drv)
        drv.contexts.append(dev)
        dev.Create(None, 8, 8)
        for i in range(40):
            idx = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
            assert dev.CreateObject(idx, CKRST_OBJ_TEXTURE,
                                    {"width": 2, "height": 2})
            if i % 3 == 0:
                vbi = rst.CreateObjectIndex(CKRST_OBJ_VERTEXBUFFER)
                dev.CreateObject(vbi, CKRST_OBJ_VERTEXBUFFER,
                                 {"max_vertices": 4})
        assert dev.guards_intact()
        assert dev.alloc_calls, "growth never notified AllocateObjects"
        assert max(dev.alloc_calls) >= 40
        rst.ReleaseObjectIndex(0, CKRST_OBJ_TEXTURE)
        again = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
        assert again == 0
        assert dev.guards_intact()


class TestLightSetupAndHal:
    """The HAL cases of the reference's tests/test_lifecycle_surface.py."""

    def test_light_setup_into_hal_context(self):
        tables = []
        for M, hal in ((O, TH), (J, JH)):
            ctx = M.CKContext(device=CPU) if M is O else M.CKContext()
            rst, drv, dev = _ctx(16, 16, hal=hal)
            light = M.CKLight(ctx, "sun")
            light.SetColor((1, 0, 0, 1))
            light.SetPosition((1.0, 2.0, -3.0))
            light.SetOrientation((0.3, -0.6, 1.0))
            assert light.Setup(dev, 0)
            assert 0 in dev._lights_on
            assert dev._lights[0]["diffuse"][0] == pytest.approx(1.0)
            tables.append({k: np.asarray(v, np.float64).tolist()
                           for k, v in dev._lights[0].items()})
            light.Active(False)
            assert not light.Setup(dev, 0)
            assert 0 not in dev._lights_on
        assert tables[0] == tables[1]

    def test_attenuation_conversion(self):
        a0, a1, a2 = TH.ConvertAttenuationModelFromDX5(0, 0, 0, 100.0)
        assert (a0, a1, a2) == (1.0, 0.0, 0.0)
        a0, a1, a2 = TH.ConvertAttenuationModelFromDX5(0.0, 1.0, 0.0, 50.0)
        assert a0 == pytest.approx(1.0) and a1 > 0.0
        for args in ((0.2, 0.5, 0.3, 40.0), (1, 0, 2, 7.5)):
            assert (TH.ConvertAttenuationModelFromDX5(*args)
                    == JH.ConvertAttenuationModelFromDX5(*args))

    def test_find_driver_problems_and_null_caps(self, tmp_path):
        ini = tmp_path / "cards.ini"
        ini.write_text("[buggy-gpu]\nMaxTextureWidth = 256\n"
                       "Version = 6.14\n")
        rst = CKRasterizer(device=CPU)
        rst.Start(None)
        rst.LoadVideoCardFile(str(ini))
        p = rst.FindDriverProblems(renderer="some buggy-gpu card",
                                   version="6.14.10")
        assert p is not None and p.real_max_texture_width == 256
        assert rst.FindDriverProblems(renderer="fine-gpu") is None
        caps = TH.InitNULLRasterizerCaps()
        assert caps.max_texture_width > 0

    def test_allocate_objects_hook(self):
        rst = CKRasterizer(device=CPU)
        rst.Start(None)
        dev = rst.GetDriver(0).CreateContext()
        for _ in range(5):
            rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
        assert getattr(dev, "_object_capacity", 0) >= 5


class TestCapsAndDriverTable:
    """The driver cases of the reference's tests/test_draw_kinds.py and
    the object API's driver methods."""

    def test_driver_enumeration(self):
        ctx = O.CKContext(device=CPU)
        rm = ctx.GetRenderManager()
        assert rm.GetRenderDriverCount() == 2
        hw = rm.GetRenderDriverDescription(0)
        sw = rm.GetRenderDriverDescription(1)
        assert hw.is_hardware and not sw.is_hardware
        caps = rm.GetDriverCaps(0)
        assert caps.max_texture_width >= 4096
        assert caps.supports_render_to_texture       # SetTargetTexture
        assert rm.GetDriver(1) == sw
        assert rm.GetPreferredSoftwareDriver() == 1
        rc = rm.CreateRenderContext(16, 16)
        assert rc.GetDriverIndex() == 0
        assert rc.ChangeDriver(1) and rc.GetDriverIndex() == 1
        assert not rc.ChangeDriver(2) and rc.GetDriverIndex() == 1
        assert rc.GetRasterizerContext() is rc
        jrm = J.CKContext().GetRenderManager()
        assert rm.GetRenderDriverCount() == jrm.GetRenderDriverCount()
        for i in range(2):
            a, b = rm.GetDriverCaps(i), jrm.GetDriverCaps(i)
            for f in ("max_texture_width", "max_texture_height",
                      "max_clip_planes", "supports_cube_maps",
                      "supports_stencil", "supports_mipmaps",
                      "supports_render_to_texture"):
                assert getattr(a, f) == getattr(b, f)

    def test_quirks_file_clamps_caps(self, tmp_path):
        ini = tmp_path / "cards.ini"
        ini.write_text("[cuda-torch]\nMaxTextureWidth = 2048\n"
                       "MaxTextureHeight = 1024\nClampToEdgeBug = 1\n"
                       "\n[other-driver]\nMaxTextureWidth = 64\n")
        problems = TC.load_video_card_file(str(ini))
        assert len(problems) == 2
        caps = TC.apply_driver_problems(TC.Vx3DCapsDesc(), problems)
        assert caps.max_texture_width == 2048
        assert caps.max_texture_height == 1024   # only [cuda-torch] matches

    def test_version_gating(self):
        p = TC.CKDriverProblems(renderer="cuda-torch", version="1.2",
                                version_must_be_exact=True,
                                real_max_texture_width=512)
        caps = TC.apply_driver_problems(TC.Vx3DCapsDesc(), [p],
                                        version="1.2.9")
        assert caps.max_texture_width == 8192     # exact match required
        caps = TC.apply_driver_problems(TC.Vx3DCapsDesc(), [p],
                                        version="1.2")
        assert caps.max_texture_width == 512

    def test_missing_file_is_empty(self):
        assert TC.load_video_card_file("/nonexistent/cards.ini") == []


def test_cuda_rasterizer_raises_without_cuda(monkeypatch):
    """``device="cuda"`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (CKRasterizer, lambda: CKRasterizer(device="cuda"),
                 CKNULLRasterizerStart):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_null_rasterizer_bit_equal_to_reference():
    """The numpy NULL oracle, on the inputs of the reference's
    tests/test_raster_parity.py fuzz (its three seeds): fb, zb and the
    presented bytes bit-equal to the reference's; ``concat_batches`` of
    the seeds' batches equal field by field."""
    w, h = 64, 48
    view = (0, 0, w, h)
    for seed in (11, 22, 33):
        rng = np.random.default_rng(seed)
        t = 24
        pts = rng.uniform(-1.1, 1.1, (t, 3, 2)).astype(np.float32)
        ws = rng.uniform(0.5, 3.0, (t, 3, 1)).astype(np.float32)
        zs = rng.uniform(0.05, 0.95, (t, 3, 1)).astype(np.float32)
        clip = np.concatenate([pts * ws, zs * ws, ws], axis=-1)
        color = rng.uniform(0, 1, (t, 3, 4)).astype(np.float32)
        uv = rng.uniform(-0.5, 1.5, (t, 3, 2)).astype(np.float32)
        fog = rng.uniform(0, 1, (t, 3)).astype(np.float32)
        kw = []
        for _ in range(6):
            kw.append(dict(
                src_blend=int(rng.choice([2, 5, 3])),
                dst_blend=int(rng.choice([1, 2, 6])),
                z_func=int(rng.choice([4, 2, 8])),
                z_write=bool(rng.integers(2)),
                alpha_blend=bool(rng.integers(2)),
                alpha_test=bool(rng.integers(2)), alpha_func=5,
                alpha_ref=float(rng.uniform(0, 1)),
                tex=int(rng.integers(-1, 1)),
                tex_address=int(rng.choice([1, 3, 2])),
                tex_filter=int(rng.choice([1, 2])),
                tex_blend=int(rng.choice([4, 1, 8])),
                fog=bool(rng.integers(2)), perspective=bool(rng.integers(2)),
                cull=int(rng.choice([1, 3, 2])),
                blend_op=int(rng.choice([1, 2, 3, 4, 5]))))
        state_idx = rng.integers(0, 6, t).astype(np.int32)
        texture = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
        outs, cats = [], []
        for Bm, Tm, Null in ((TB, TT, NullRasterizer), (JB, JT, JNull)):
            batch = Bm.make_batch(clip, view=view, color=color, uv=uv,
                                  fog=fog, state_idx=state_idx)
            si, sf = Tm.pack_states([Tm.RasterState(**k) for k in kw])
            r = Null(w, h)
            r.clear((0.1, 0.2, 0.3, 1.0))
            r.fog_color = np.asarray((0.3, 0.4, 0.5), np.float32)
            r.draw_batch(batch, si, sf, [texture])
            outs.append((r.fb.copy(), r.zb.copy(), r.present()))
            cats.append(Bm.concat_batches([batch, batch], pad_to=56))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        for f in ("xyw", "z", "color", "specular", "uv", "fog", "state_idx",
                  "valid"):
            np.testing.assert_array_equal(getattr(cats[0], f),
                                          getattr(cats[1], f))
