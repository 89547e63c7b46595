"""2D overlays against the reference package on the CPU.

- ``composite_quads`` against the reference's on seeded banks, within
  1e-6 on values in [0, 1] (the reference's XLA program may contract the
  blend's multiply-add; the port never does): fractional rects, quads
  wider than the reference's window cap (its dense branch), textured and
  untextured, blend 0 and 1, an atlas stack with texel offsets, and more
  than 64 quads (its scan form). The port's windowed composite equals its
  whole-frame one bit for bit.
- The 2D entity API: pixel, homogeneous and parent-relative rects,
  clip-to-parent, source rects, z-order and background membership in the
  quad lists, ``Pick`` and ``Pick2D``, extents: equal to the reference's.
- ``CKSpriteText``'s raster, drawn from the committed glyph table, against
  the reference's Pillow raster bit for bit: config 3's label and other
  strings, non-ASCII text, three alignments, several colours, multi-line
  text. A named font that is not installed falls back to the default font
  in both; DejaVu Sans draws through the port's TrueType stack, equal to
  the reference's at any size, ligatures included.
- Overlays through ``Render()``: a flat scene with a background sprite, a
  textured background material and foreground sprites, text and a clipped
  child, against the reference's frame; a text change re-rasters through
  the texture patch without a recompile.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.pipeline import overlay as jov
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.objects import entity2d as te2
from ckrenderengine_tpu_torch.pipeline import overlay as tov
from tests._torch_common import (
    check_render, port_frame_ids, render_both, to_np,
)

H, W = 97, 131
TOL = 1e-6


def _quads(rng, n, wide=False, n_tex=3):
    out = []
    for _ in range(n):
        x0, y0 = rng.uniform(-20, W), rng.uniform(-20, H)
        w = rng.uniform(0.3, 300.0 if wide else 40.0)
        h = rng.uniform(0.3, 120.0 if wide else 40.0)
        out.append(dict(rect=(x0, y0, x0 + w, y0 + h),
                        uvrect=tuple(rng.uniform(-0.5, 1.5, 4)),
                        color=tuple(rng.random(4)),
                        tex=int(rng.integers(-1, n_tex)),
                        blend=int(rng.integers(0, 2))))
    return out


def _stack(rng, atlas):
    """A plain stack of 3 textures, or one atlas plane holding 3 blocks
    with (h, w, oy, ox) rows."""
    if not atlas:
        planes = rng.random((3, 4, 16, 24)).astype(np.float32)
        hw = np.array([[16, 24], [8, 8], [13, 5]], np.int32)
        return planes, hw
    planes = rng.random((1, 4, 40, 64)).astype(np.float32)
    hw = np.array([[16, 24, 0, 0], [8, 8, 16, 0], [13, 30, 24, 24]],
                  np.int32)
    return planes, hw


CASES = [("few_fractional", 3, False, False),
         ("wide_dense", 9, True, False),
         ("atlas", 12, False, True),
         ("over_64_scan", 70, False, False)]


@pytest.mark.parametrize("name,n,wide,atlas", CASES,
                         ids=[c[0] for c in CASES])
def test_composite_quads_matches_reference(name, n, wide, atlas):
    rng = np.random.default_rng(sum(map(ord, name)))
    planes, hw = _stack(rng, atlas)
    quads = _quads(rng, n, wide)
    fb = rng.random((4, H, W)).astype(np.float32)
    ref = np.asarray(jov.composite_quads(
        jnp.asarray(fb), jov.build_quad_bank(quads), jnp.asarray(planes),
        jnp.asarray(hw), H, W, win_cap=32))
    bank = tov.build_quad_bank(quads)
    args = (torch.as_tensor(planes), torch.as_tensor(hw), H, W)
    dense = tov.composite_quads(torch.as_tensor(fb), bank, *args).numpy()
    windowed = tov.composite_quads(torch.as_tensor(fb), bank, *args,
                                   tov.quad_windows(quads, H, W)).numpy()
    assert np.abs(dense - ref).max() <= TOL
    np.testing.assert_array_equal(windowed, dense)
    # The quads did something (and, for the wide case, past the cap).
    assert (np.abs(dense - fb) > 1e-3).mean() > 0.01
    if wide:
        assert any(q["rect"][2] - q["rect"][0] > 32 for q in quads)


def test_quad_windows_cover_and_skip():
    quads = [dict(rect=(10.4, 5.6, 10.6, 5.9)),     # covers no centre
             dict(rect=(-50, -50, -10, -10)),        # off screen
             dict(rect=(0.5, 0.5, 1.5, 1.5)),        # one pixel
             dict(rect=(-3, 90, 200, 400))]          # clipped
    win = tov.quad_windows(quads, H, W)
    assert win[1] is None
    assert win[2] == (0, 0, 2, 2)
    assert win[3] == (89, 0, H - 89, W)
    # Untextured opaque quads: the windowed and dense frames agree.
    bank = tov.build_quad_bank([dict(q, color=(0.2, 0.4, 0.6, 1.0), tex=-1,
                                     blend=0) for q in quads])
    planes = torch.zeros((1, 4, 1, 1))
    hw = torch.ones((1, 2), dtype=torch.int32)
    fb = torch.zeros((4, H, W))
    a = tov.composite_quads(fb, bank, planes, hw, H, W)
    b = tov.composite_quads(fb, bank, planes, hw, H, W, win)
    assert torch.equal(a, b) and float(a[0, 0, 0]) == pytest.approx(0.2)
    assert float(a[0, 1, 1]) == 0.0


def _tree(M, ctx):
    """A parent with homogeneous children, clip-to-parent, z-orders, a
    background root and a not-pickable entity."""
    root = M.CK2dEntity(ctx, "root")
    root.SetRect((20.5, 10.25, 110.5, 70.75))
    a = M.CK2dEntity(ctx, "a")
    a.SetParent(root)
    a.SetPosition((0.25, 0.5), hom=True)
    a.SetSize((0.9, 0.75), hom=True)
    a.EnableClipToParent(True)
    a.SetZOrder(3)
    b = M.CK2dEntity(ctx, "b")
    b.SetParent(root)
    b.SetPosition((-5.0, 30.0))
    b.SetSize((40.0, 12.5))
    b.SetZOrder(1)
    b.SetSourceRect((0.1, 0.2, 0.8, 0.9))
    b.SetColor((0.5, 0.25, 1.0, 0.75))
    c = M.CK2dEntity(ctx, "c")
    c.SetParent(a)
    c.SetRect((0, 0, 8, 8))
    c.flags2d |= te2.CK_2DENTITY_NOTPICKABLE
    back = M.CK2dEntity(ctx, "back")
    back.SetHomogeneousCoordinates(True)
    back.SetPosition((0.1, 0.1), hom=True)
    back.SetSize((0.5, 0.5), hom=True)
    back.SetBackground(True)
    back.SetZOrder(-2)
    hidden = M.CK2dEntity(ctx, "hidden")
    hidden.SetRect((0, 0, 50, 50))
    hidden.Show(False)
    return [root, a, b, c, back, hidden]


def test_entity_api_matches_reference():
    cj = J.CKContext()
    ct = O.CKContext(device="cpu")
    rcj = cj.GetRenderManager().CreateRenderContext(W, H)
    rct = ct.GetRenderManager().CreateRenderContext(W, H)
    ej, et = _tree(J, cj), _tree(O, ct)
    for x, y in zip(ej, et):
        for vw, vh in ((W, H), (320, 240)):
            assert x.screen_rect(vw, vh) == y.screen_rect(vw, vh)
            np.testing.assert_array_equal(x.GetRect(vw, vh), y.GetRect(vw, vh))
            np.testing.assert_array_equal(x.GetHomogeneousRelativeRect(vw, vh),
                                          y.GetHomogeneousRelativeRect(vw, vh))
        assert x.IsClipToParentEnabled() == y.IsClipToParentEnabled()
        assert x.IsBackground() == y.IsBackground()
        assert x.quad_descriptors(W, H, -1) == y.quad_descriptors(W, H, -1)
        assert x.UpdateExtents(rcj) == y.UpdateExtents(rct)
    assert rcj.GetCurrentExtents() == rct.GetCurrentExtents()
    names = lambda es: [e.GetName() for e in es]  # noqa: E731
    for x, y in zip(ej, et):
        fj, ft = [], []
        x.collect_tree(fj)
        y.collect_tree(ft)
        assert names(fj) == names(ft)
    for px in range(0, W, 3):
        for py in range(0, H, 3):
            hj = rcj.Pick2D(px + 0.5, py + 0.5)
            ht = rct.Pick2D(px + 0.5, py + 0.5)
            assert (hj is None and ht is None) or (
                hj.GetName() == ht.GetName())
    rcj.Render()
    rct.Render()
    assert rcj._quad_lists() == rct._quad_lists()
    assert names(rct.Get2dRoot(True)) == names(rcj.Get2dRoot(True))
    assert names(rct.Get2dRoot(False)) == names(rcj.Get2dRoot(False))
    assert not ej[0].SetParent(ej[3]) and not et[0].SetParent(et[3])


TEXTS = ["entities: 1000", "Hello, World!", "The quick brown fox jumps",
         "g(j)y,;|_ ~`'\"", "multi\nline  text\n\nend", "", "   ",
         "café → ok"]


def _text_sprite(M, ctx, text, align, fg, bg, size=(128, 20), font=None):
    s = M.CKSpriteText(ctx, "t")
    s.Create(*size)
    s.SetText(text)
    s.SetAlign(align)
    s.SetTextColor(fg)
    s.SetBackgroundTextColor(bg)
    if font is not None:
        s.SetFont(font, 14)
    return s


COLORS = [((1, 1, 1, 1), (0, 0, 0, 0)),
          ((0.9, 0.2, 0.1, 0.85), (0.1, 0.3, 0.2, 0.5)),
          ((0.3, 0.6, 1.0, 0.5), (1.0, 1.0, 1.0, 1.0))]


@pytest.mark.parametrize("align", [0, 1, 2], ids=["left", "center", "right"])
def test_sprite_text_raster_matches_pil(align):
    """Bit-equal images (0..255 / 255) on every string and colour pair,
    ASCII or not."""
    cj, ct = J.CKContext(), O.CKContext(device="cpu")
    for text in TEXTS:
        for fg, bg in COLORS:
            for size in ((128, 20), (40, 30)):
                ij = _text_sprite(J, cj, text, align, fg, bg, size).Redraw()
                it = _text_sprite(O, ct, text, align, fg, bg, size).Redraw()
                np.testing.assert_array_equal(it.GetImage(), ij.GetImage(),
                                              err_msg=repr(text))


def test_named_fonts_fall_back_to_the_default():
    """A font name Pillow cannot find: both draw the default font. A font
    it finds (DejaVu Sans): both draw that font, bit for bit, non-ASCII
    text included, at 14 and at 13 (a size no table was ever baked for:
    the port hints and rasterises the face itself)."""
    cj, ct = J.CKContext(), O.CKContext(device="cpu")
    fg, bg = COLORS[0]
    ij = _text_sprite(J, cj, "entities: 1000", 0, fg, bg,
                      font="no-such-font.ttf").Redraw()
    it = _text_sprite(O, ct, "entities: 1000", 0, fg, bg,
                      font="no-such-font.ttf").Redraw()
    np.testing.assert_array_equal(it.GetImage(), ij.GetImage())
    assert te2.find_font("DejaVuSans.ttf") is not None
    for text in ("entities: 1000", "café → ok"):
        for fg, bg in COLORS:
            ij = _text_sprite(J, cj, text, 1, fg, bg,
                              font="DejaVuSans.ttf").Redraw()
            it = _text_sprite(O, ct, text, 1, fg, bg,
                              font="DejaVuSans.ttf").Redraw()
            np.testing.assert_array_equal(it.GetImage(), ij.GetImage(),
                                          err_msg=repr(text))
    odd = {}
    for M, c in ((J, cj), (O, ct)):
        odd[M] = _text_sprite(M, c, "entities: 1000", 0, fg, bg)
        odd[M].SetFont("DejaVuSans.ttf", 13)
    np.testing.assert_array_equal(odd[O].Redraw().GetImage(),
                                  odd[J].Redraw().GetImage())


def test_ligature_pairs_raise_and_the_default_font_refuses_none():
    """A pair the font's layout draws as a ligature (DejaVu Sans "fi" in
    "file") draws the ligature glyph, as the reference does, bit for bit.
    The default font's table refuses no pair (its basic layout makes no
    ligatures)."""
    baked = np.load(te2.GLYPHS)
    i = baked["names"].tolist().index("default")
    assert baked[f"{i}_bad_pairs"].size == 0
    face = te2.font_table("DejaVuSans.ttf", 14)
    fi = face.layout("fi")[0]
    assert len(fi) == 1 and fi[0][0] != face.font.cmap[ord("f")]
    cj, ct = J.CKContext(), O.CKContext(device="cpu")
    for fg, bg in COLORS:
        ij = _text_sprite(J, cj, "file", 0, fg, bg,
                          font="DejaVuSans.ttf").Redraw()
        it = _text_sprite(O, ct, "file", 0, fg, bg,
                          font="DejaVuSans.ttf").Redraw()
        np.testing.assert_array_equal(it.GetImage(), ij.GetImage())


def test_text_bbox_matches_pil():
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    rng = np.random.default_rng(5)
    strings = [t for t in TEXTS if t and all(
        32 <= ord(c) < 127 or c == "\n" for c in t)]
    strings += ["".join(chr(c) for c in rng.integers(32, 127, k))
                for k in rng.integers(1, 30, 40)]
    for s in strings:
        assert te2.text_bbox(s) == tuple(probe.textbbox((0, 0), s,
                                                        font=font)), s


def build_hud(O, size=96, **ctx_kw):
    """Config 1's cube under a textured background material and a
    background sprite, with a foreground HUD: a textured sprite, its
    clipped child, a text label and a half-transparent flat entity."""
    ctx, rc, _cube = scenes.build_config1(O, size=size, **ctx_kw)
    tex = O.CKTexture(ctx, "bgtex")
    img = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img * 0.3, img * 0.2 + 0.1, 0.4 - img * 0.2,
                           np.ones_like(img)], -1))
    bgm = O.CKMaterial(ctx, "bgmat")
    bgm.SetTexture(tex)
    rc.SetBackgroundMaterial(bgm)
    back = O.CKSprite(ctx, "back")
    back.SetImage(np.full((4, 4, 4), (0.2, 0.8, 0.3, 0.5), np.float32))
    back.SetRect((5, 40, 60, 70))
    back.SetBackground(True)
    hud = O.CKSprite(ctx, "hud")
    icon = np.zeros((24, 24, 4), np.float32)
    icon[4:20, 4:20] = (0.9, 0.2, 0.1, 0.85)
    hud.SetImage(icon)
    hud.SetRect((8, 8, 32, 32))
    child = O.CKSprite(ctx, "child")
    child.SetImage(np.full((3, 5, 4), (0.1, 0.2, 0.9, 1.0), np.float32))
    child.SetParent(hud)
    child.SetRect((10, 10, 40, 22))
    child.EnableClipToParent(True)
    child.SetZOrder(2)
    txt = O.CKSpriteText(ctx, "label")
    txt.Create(64, 14)
    txt.SetText("hud: 42")
    txt.SetTextColor((1.0, 0.9, 0.2, 1.0))
    txt.SetRect((30, 2, 94, 16))
    flat = O.CK2dEntity(ctx, "flat")
    flat.SetRect((60.5, 50.25, 90.75, 66.5))
    flat.SetColor((0.0, 0.5, 1.0, 0.5))
    return ctx, rc, txt


def test_overlay_frame_matches_reference():
    pair = render_both(build_hud, accelerator=False)
    rj, rt, _packed, _ref = pair
    qb, qf = rt._quad_lists()
    assert len(qb) == 2 and len(qf) == 4
    assert qb == rj._quad_lists()[0] and qf == rj._quad_lists()[1]
    check_render(pair)
    # Where no triangle covers the pixel in either frame, the frame is the
    # two overlay layers over the background material alone.
    st, tf, ti, tp = rt._fill_packed([], [])
    ids = to_np(port_frame_ids(rt, st, torch.as_tensor(tf),
                               torch.as_tensor(ti), tp))
    empty = (ids < 0) & (pair[3][0] < 0)
    assert empty.mean() > 0.5
    diff = np.abs(to_np(rt.fb) - np.asarray(rj.fb)).max(0)
    assert diff[empty].max() <= TOL


def test_text_change_repatches_without_recompile():
    ctxs = []
    for M, kw in ((J, {}), (O, dict(device="cpu"))):
        ctx, rc, txt = build_hud(M, **kw)
        rc.Render()
        misses = rc.stats.RenderStateCacheMiss
        txt.SetText("hud: 43")
        rc.Render()
        assert rc.stats.RenderStateCacheMiss == misses
        ctxs.append((rc, txt))
    (rj, _), (rt, tt) = ctxs
    assert tt._store.data_version > 1
    # The label's rect (no triangle reaches it) shows the new text.
    label = (slice(None), slice(2, 16), slice(30, 94))
    np.testing.assert_allclose(to_np(rt.fb)[label], np.asarray(rj.fb)[label],
                               atol=TOL)
    # Its texels now ride the per-frame texture patch.
    assert rt._compiled.video_ids


def test_registration_and_port_queue():
    from ckrenderengine_tpu_torch.objects import base, classreg
    from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE

    assert 6 not in PORT_QUEUE and 15 not in PORT_QUEUE
    # Item 14 keeps only what the TrueType stack refuses, movies and the
    # image variants: no font, size or character waits for a baked table.
    assert "baked" not in PORT_QUEUE[14]
    for what in ("CFF", "collections", "variable", "bitmap-only", "bidi",
                 "opcodes", "video containers", "WebP"):
        assert what in PORT_QUEUE[14], what
    ctx = O.CKContext(device="cpu")
    for cid, cls, name in ((base.CKCID_2DENTITY, O.CK2dEntity, "2D Entity"),
                           (base.CKCID_SPRITE, O.CKSprite, "Sprite"),
                           (base.CKCID_SPRITETEXT, O.CKSpriteText,
                            "Sprite Text")):
        obj = ctx.CreateObjectByClassID(cid, name)
        assert type(obj) is cls and classreg.CKGetClassName(cid) == name
        assert obj.IsChildClassOf(base.CKCID_2DENTITY)
    mat = O.CKMaterial(ctx, "m")
    parent, child = O.CK2dEntity(ctx, "p"), O.CK2dEntity(ctx, "c")
    child.SetParent(parent)
    parent.SetMaterial(mat)
    assert set(parent.GetDependencies()) == {mat, child}
    with pytest.raises(NotImplementedError, match="item 14"):
        O.CKSprite(ctx, "movie").LoadMovie(__file__)


def build_backdrop(O, width=256, height=193, **ctx_kw):
    """Config 2 (a tiled frame at this size: the solve and the quantized
    rows) over a textured background material and a half-transparent
    background sprite."""
    ctx, rc, ball = scenes.build_config2(O, width=width, height=height,
                                         **ctx_kw)
    tex = O.CKTexture(ctx, "bgtex")
    img = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img * 0.3, img * 0.2 + 0.1, 0.4 - img * 0.2,
                           np.ones_like(img)], -1))
    bgm = O.CKMaterial(ctx, "bgmat")
    bgm.SetTexture(tex)
    rc.SetBackgroundMaterial(bgm)
    back = O.CKSprite(ctx, "back")
    back.SetImage(np.full((4, 4, 4), (0.2, 0.8, 0.3, 0.5), np.float32))
    back.SetRect((10.5, 5.25, 200.75, 60.5))
    back.SetBackground(True)
    return ctx, rc, ball


def test_tiled_frame_shades_over_the_background_plane():
    """The row shade of a tiled frame keeps the composited background
    per pixel (not the clear colour) wherever no triangle wins."""
    pair = render_both(build_backdrop)
    rj, rt, _packed, ref = pair
    assert rt._compiled.tri_idx.shape[0] * rt.height * rt.width > (1 << 26)
    check_render(pair)
    st, tf, ti, tp = rt._fill_packed([], [])
    ids = to_np(port_frame_ids(rt, st, torch.as_tensor(tf),
                               torch.as_tensor(ti), tp))
    empty = (ids < 0) & (ref[0] < 0)
    fb = to_np(rt.fb)
    assert empty.mean() > 0.05
    assert np.abs(fb - np.asarray(rj.fb)).max(0)[empty].max() <= TOL
    # The sprite shows over the checker where the sky is empty.
    sprite = np.zeros(ids.shape, bool)
    sprite[6:60, 11:200] = True
    assert (empty & sprite).sum() > 100
    assert np.ptp(fb[1][empty & ~sprite]) > 0.05
