"""Shared helpers of the tests that hold ckrenderengine_tpu_torch against
the reference package (ckrenderengine_tpu) on the CPU."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def accelerator_branch():
    """Run the reference package's ACCELERATOR branch on the CPU.

    The reference shades a tiled frame from per-pixel rows (quantized or
    compact) and takes its ordered kernels only where ``jax.default_backend()``
    is ``"tpu"``, so its own CPU ``Render()`` never runs that arithmetic.
    Inside this block ``jax.default_backend`` reports ``"tpu"`` to the
    reference's frame, and the Pallas entries it looks up at call time
    (the tiled and flat solves, the ordered blend, the iterated peel) run in
    interpret mode. jit caches by static arguments, not by these patches, so
    the caches are cleared on the way in and on the way out. Nothing in the
    reference package changes."""
    import jax
    from ckrenderengine_tpu.raster import (
        pallas_ordered, pallas_reduce, pallas_tiled,
    )

    entries = [(pallas_tiled, "depth_reduce_tiled_pallas"),
               (pallas_reduce, "depth_reduce_pallas"),
               (pallas_ordered, "ordered_blend_tiled_pallas"),
               (pallas_ordered, "ordered_peel_iterate")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in entries]
    backend = jax.default_backend
    jax.clear_caches()
    try:
        jax.default_backend = lambda: "tpu"
        for mod, name, fn in saved:
            setattr(mod, name, functools.partial(fn, interpret=True))
        yield
    finally:
        jax.default_backend = backend
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        jax.clear_caches()


@contextlib.contextmanager
def tie_window(ulps):
    """Widen the reference's LESSEQUAL/EQUAL/GREATEREQUAL tie window
    (``jax_backend.z_compare``, 2 ULP) to ``ulps`` while the block runs
    (None: leave it). A material channel or effect pass redraws its base's
    triangles at LESSEQUAL, so every redrawn sample is a depth tie with
    the solved zb. The reference's jitted frame evaluates the redraw's
    depth in separately fused programs, one per colour channel, which
    contract multiply-adds apart: at 2 ULP the tie passes for some
    channels of a pixel and fails for others (its alpha blends while its
    RGB keeps the base colour). The port evaluates one depth per sample
    and passes every tie; frames with redraws are held to the reference
    rendered with a tie window wide enough that its redraws blend too
    (the reference's frame needs more than 16 ULP and at most 256 on
    ``scenes.build_config5_mat``). jit caches by static arguments, so the
    caches are cleared on the way in and out."""
    if ulps is None:
        yield
        return
    import jax
    import jax.numpy as jnp
    from ckrenderengine_tpu.raster import jax_backend as jrb
    from ckrenderengine_tpu.raster.types import VXCMP

    saved = jrb.z_compare

    def z_compare(func, depth, zb):
        dbits = jax.lax.bitcast_convert_type(depth, jnp.int32)
        zbits = jax.lax.bitcast_convert_type(
            jnp.broadcast_to(zb, depth.shape), jnp.int32)
        near = jnp.abs(dbits - zbits) <= ulps
        strict = jrb.compare_op(func, depth, zb)
        eq_incl = ((func == VXCMP.LESSEQUAL) | (func == VXCMP.EQUAL)
                   | (func == VXCMP.GREATEREQUAL))
        return jnp.where(eq_incl, strict | near, strict)

    jax.clear_caches()
    jrb.z_compare = z_compare
    try:
        yield
    finally:
        jrb.z_compare = saved
        jax.clear_caches()


def render_reference(build, accelerator: bool = True, frame_ids=False,
                     tie_ulps=None, **kw):
    """A scene built by ``build`` (ckrenderengine_tpu_torch.scenes) through
    the reference's object model, rendered once through ``Render()`` on its
    accelerator branch (:func:`accelerator_branch`), or as the CPU runs it
    when ``accelerator`` is off. The reference's capacity governor, which
    follows the backend too, stays off: it only re-plans the caps of later
    frames. Returns the render context. With ``frame_ids`` on the
    accelerator branch, its ``frame_ids`` attribute holds the winner ids
    its own tiled solve found (else None). ``tie_ulps``: render with the
    reference's depth-tie window widened (:func:`tie_window`)."""
    with tie_window(tie_ulps):
        return _render_reference(build, accelerator, frame_ids, **kw)


def _render_reference(build, accelerator, frame_ids, **kw):
    import jax
    import ckrenderengine_tpu.objects as J
    from ckrenderengine_tpu.raster import pallas_tiled

    _c, rj, _m = build(J, **kw)
    rj.frame_ids = None
    if not accelerator:
        rj.Render()
        return rj
    rj._gov_on = False
    if not frame_ids:
        with accelerator_branch():
            rj.Render()
            np.asarray(rj.fb)           # finish the frame inside the block
        return rj
    seen = {}
    with accelerator_branch():
        solve = pallas_tiled.depth_reduce_tiled_pallas

        def spy(*a, **k):
            out = solve(*a, **k)
            jax.debug.callback(lambda i: seen.update(ids=np.asarray(i)),
                               out[0])
            return out

        pallas_tiled.depth_reduce_tiled_pallas = spy
        try:
            rj.Render()
            np.asarray(rj.fb)           # finish the frame inside the block
            jax.effects_barrier()
        finally:
            pallas_tiled.depth_reduce_tiled_pallas = solve
    rj.frame_ids = seen.get("ids")
    return rj


def reference_stages(static, dyn_f, dyn_i, params):
    """The reference package's stages of a frame from its packed inputs,
    run one operation at a time (so no multiply-add is contracted across
    them). A bound clip's ``world_in``, the skin stage and the 3D sprites'
    corners are applied first, as the reference's frame does; an Antialias
    frame (``params["ss"]`` > 1) is set up at its render size. Returns a
    dict: ``scene_lines`` (the scene before chunk compaction, which the
    line pass reads) and ``world_lines`` (the world matrices it reads),
    the compacted ``scene``, the triangle ``batch``, the per-triangle
    ``defer`` mask and the triangle ``setup`` dict."""
    import jax.numpy as jnp
    from ckrenderengine_tpu.pipeline import frame as jfr
    from ckrenderengine_tpu.pipeline.overlay import apply_billboards
    from ckrenderengine_tpu.pipeline.packing import has_field
    from ckrenderengine_tpu.pipeline.skinning import apply_skin
    from ckrenderengine_tpu.raster import deferred as jdf

    layout = params["layout"]
    ss = params.get("ss", 1)
    scene, sprites, d = jfr.unpack_scene(
        static, jnp.asarray(dyn_f), jnp.asarray(dyn_i), layout,
        sprites_static=params.get("sprites_static"), ss=ss)
    world = params.get("world_in")
    if world is None and (params.get("skin") is not None
                          or sprites is not None):
        world = jfr.compose_world(scene.local, scene.parent,
                                  params["levels"])
    if params.get("skin") is not None:
        positions, normals = apply_skin(world, scene.positions,
                                        scene.normals, params["skin"],
                                        ranges=params["skin_ranges"])
        scene = scene._replace(positions=positions, normals=normals)
    if sprites is not None:
        scene = scene._replace(positions=apply_billboards(
            world, scene.view, scene.positions, sprites,
            scene.entity_visible))
    scene_lines = scene
    world_lines = world if world is not None else jfr.compose_world(
        scene.local, scene.parent, params["levels"])
    corner = params["corner"]
    if params["cull"] is not None and has_field(layout, "chunk_idx"):
        scene, corner = jfr.compact_scene_chunks(
            scene, d["chunk_idx"], d["chunk_n"], corner, params["cull"])
    clip, color, spec, fog, _w, uv, clipd_v, refl_v = jfr.transform_and_light(
        scene, params["levels"], world=world, corner=corner,
        vertex_shader=params.get("vertex_shader"),
        want_bump=params.get("want_bump", False),
        want_cube=params.get("want_cube", False),
        want_texgen=params["want_texgen"])
    batch = jfr.assemble_triangles(scene, clip, color, spec, fog, uv, clipd_v,
                                   refl_v, corner=corner)
    defer = jdf.deferred_mask(scene.state_i)[batch.state_idx] & batch.valid
    setup = jdf.triangle_setup(batch.xyw, batch.z, batch.state_idx,
                               batch.valid, scene.state_i,
                               clip_rect=batch.clip_rect, clipd=batch.clipd,
                               planar=batch.planar)
    return dict(scene_lines=scene_lines, world_lines=world_lines,
                scene=scene, batch=batch, defer=defer, setup=setup)


def reference_winners(static, dyn_f, dyn_i, params):
    """(best_id, best_depth, setup) of a reference-package frame from its
    packed inputs: :func:`reference_stages` and the reference's flat exact
    solve; ``setup`` is the triangle-setup dict as numpy arrays. An
    Antialias frame is solved at its render size."""
    from ckrenderengine_tpu.raster import deferred as jdf

    st = reference_stages(static, dyn_f, dyn_i, params)
    scene, setup = st["scene"], st["setup"]
    ss = params.get("ss", 1)
    bi, bd = jdf.depth_reduce(setup, st["defer"], scene.clear_z,
                              scene.viewport, params["height"] * ss,
                              params["width"] * ss)
    return (np.asarray(bi), np.asarray(bd),
            {k: np.asarray(v) for k, v in setup.items()})


def port_winners(static, dyn_f, dyn_i, params):
    """(fb, zb, best_id) of a port frame from its packed inputs."""
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    fb, zb, stats = tfr.render_frame_packed(static, dyn_f, dyn_i, **params,
                                            want_stats=True)
    return fb, zb, stats["WinnerIds"]


def render_ids(rc):
    """``rc.Render()`` and the winner ids (a tensor) of that frame, without
    rendering it twice: the frame's one ``render_frame_packed`` call is
    asked for its stats too (``want_stats=True`` adds the ids to what it
    returns and changes nothing else), and the ids are kept on ``rc``
    beside a copy of its fb and zb, for :func:`check_render`. A Render()
    that makes other than one such call (a window, stereo) gets its ids from
    :func:`port_winners` of its packed inputs instead."""
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    real, seen = tfr.render_frame_packed, []

    def spy(*a, want_stats=False, **k):
        out = real(*a, want_stats=True, **k)
        seen.append(out[-1]["WinnerIds"])
        return out if want_stats else out[:-1]

    tfr.render_frame_packed = spy
    try:
        rc.Render()
    finally:
        tfr.render_frame_packed = real
    if len(seen) == 1:
        ids = seen[0]
    else:
        st, tf, ti, tp = rc._fill_packed([], [])
        ids = port_winners(st, torch.as_tensor(tf), torch.as_tensor(ti),
                           tp)[2]
    rc.test_frame = (rc.fb.clone(), rc.zb.clone(), ids)
    return ids


def port_frame_ids(rc, static, dyn_f, dyn_i, params):
    """The winner ids of ``rc``'s current frame: those :func:`render_ids`
    kept while fb and zb are still that frame's, else :func:`port_winners`
    of the packed inputs given."""
    kept = getattr(rc, "test_frame", None)
    if kept is not None and torch.equal(kept[0], rc.fb) \
            and torch.equal(kept[1], rc.zb):
        return kept[2]
    return port_winners(static, dyn_f, dyn_i, params)[2]


_EPS32 = float(np.finfo(np.float32).eps)


def _winner_edges(ids, setup_np):
    """(e (H,W,3), |a*px| + |b*py| + |c| (H,W,3), z, ivs) of each pixel's
    winner in float64 (pixel centres at +0.5)."""
    h, w = ids.shape
    py, px = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5, indexing="ij")
    i = np.clip(ids, 0, None)
    ec = np.asarray(setup_np["e_coef"], np.float64)[i]      # (H,W,3,3)
    terms = (np.abs(ec[..., 0] * px[..., None])
             + np.abs(ec[..., 1] * py[..., None]) + np.abs(ec[..., 2]))
    e = ec[..., 0] * px[..., None] + ec[..., 1] * py[..., None] + ec[..., 2]
    zz = np.asarray(setup_np["z"], np.float64)[i]
    ivs = np.asarray(setup_np["inv_det_s"], np.float64)[i]
    return e, terms, zz, ivs


def edge_error_bound(ids, setup_np):
    """(3,H,W) forward-error bound of one f32 evaluation of the winner's
    edge values ``e = a*px + b*py + c`` (3 roundings of the largest term).
    Two implementations that round the formula differently — the
    reference's XLA fusions contract multiply-adds into FMAs, the port never
    does — may differ by up to twice this bound; it is large only where the
    plane cancels large terms."""
    _e, terms, _z, _ivs = _winner_edges(ids, setup_np)
    return np.moveaxis(np.where((ids >= 0)[..., None],
                                3 * _EPS32 * terms, 0.0), -1, 0)


def depth_error_bound(ids, setup_np):
    """(H,W) forward-error bound of one f32 evaluation of the winner's depth
    ``(e0*z0 + e1*z1 + e2*z2) * ivs`` (see :func:`edge_error_bound`)."""
    e, terms, zz, ivs = _winner_edges(ids, setup_np)
    ivs = np.abs(ivs)
    err_e = 3 * _EPS32 * terms
    bound = (np.sum(err_e * np.abs(zz), -1)
             + 3 * _EPS32 * np.sum(np.abs(e * zz), -1)) * ivs
    depth = np.abs(np.sum(e * zz, -1) * ivs)
    return np.where(ids >= 0, bound + _EPS32 * depth, 0.0)


def _assert_close_or_bounded(got, ref, bound_fn, atol, max_frac):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    off = diff > atol
    assert off.mean() <= max_frac, (int(off.sum()), float(diff.max()))
    if off.any():
        bound = bound_fn()
        assert np.all(diff[off] <= 2 * bound[off] + atol), (
            float(diff[off].max()), float(bound[off].min()))


def assert_depth_close(got, ref, ids, setup_np, atol=4e-6, max_frac=1e-3):
    """Depths within ``atol`` on all but at most ``max_frac`` of the pixels;
    those must lie within twice the f32 forward-error bound of their
    winner's depth formula (:func:`depth_error_bound`)."""
    _assert_close_or_bounded(got, ref,
                             lambda: depth_error_bound(ids, setup_np),
                             atol, max_frac)


def assert_eplanes_close(got, ref, ids, setup_np, atol=1e-5):
    """Winner edge values within ``atol`` or, since raw edge values grow
    with the triangle (1e5 and more for large ones, where one ULP is 0.01),
    within twice their f32 forward-error bound (:func:`edge_error_bound`)
    — on every pixel."""
    max_frac = 1.0
    _assert_close_or_bounded(got, ref,
                             lambda: edge_error_bound(ids, setup_np),
                             atol, max_frac)


def edge_condition(ids, setup_np):
    """(H,W) condition number of the winner's edge evaluation: the largest
    ratio (|a*px| + |b*py| + |c|) / |e| over its three edges. Near 1 for
    well-conditioned pixels; large where a pixel sits on an edge and the
    plane cancels large terms, so that FMA contraction changes e (and the
    perspective weights e/sum(e) the shade interpolates with)."""
    e, terms, _z, _ivs = _winner_edges(ids, setup_np)
    cond = (terms / np.maximum(np.abs(e), 1e-30)).max(-1)
    return np.where(ids >= 0, cond, 0.0)


def assert_fb_close(got, ref, ids, setup_np, atol=2e-6, max_frac=1e-2):
    """Framebuffers within ``atol`` on all but at most ``max_frac`` of the
    pixels; those stay within one 8-bit step (1/255) and sit on
    ill-conditioned edges (:func:`edge_condition` > 10, against a typical
    value of about 4), where the reference's FMA-contracted edge arithmetic
    rounds the interpolation weights (and the mip LOD) apart from the
    port's."""
    diff = np.abs(np.asarray(got, np.float64)
                  - np.asarray(ref, np.float64)).max(0)
    off = diff > atol
    assert off.mean() <= max_frac, (int(off.sum()), float(diff.max()))
    if off.any():
        assert diff.max() <= 1.0 / 255.0, float(diff.max())
        cond = edge_condition(ids, setup_np)
        assert np.all(cond[off] > 10.0), cond[off].min()


# How far one package's frame depth may lie from the exact depth of its
# winner, in units of depth_error_bound. The bound covers only the final
# depth formula; each package also rounds the vertex transform and the
# triangle setup its own way (the reference's XLA fusions contract
# multiply-adds into FMAs there too), and an ill-conditioned pixel amplifies
# those differences the same way. The slice scenes need up to 1.8.
_FRAME_SLACK = 4.0


def exact_depth(ids, setup_np):
    """(H,W) float64 depth of each pixel's winner (NaN on the background)."""
    e, _terms, zz, ivs = _winner_edges(ids, setup_np)
    return np.where(ids >= 0, np.sum(e * zz, -1) * ivs, np.nan)


def assert_winner_ties(ids, ids_ref, setup_np):
    """Where two frames' winner maps differ, the two answers tie within
    f32 rounding: two winners' exact depths lie within ``_FRAME_SLACK``
    times the sum of their :func:`depth_error_bound`; where only one map
    covers the pixel, it sits on an edge of that winner (|e| within twice
    :func:`edge_error_bound`)."""
    differ = ids != ids_ref
    both = differ & (ids >= 0) & (ids_ref >= 0)
    gap = np.abs(exact_depth(ids, setup_np) - exact_depth(ids_ref, setup_np))
    tol = _FRAME_SLACK * (depth_error_bound(ids, setup_np)
                          + depth_error_bound(ids_ref, setup_np))
    assert np.all(gap[both] <= tol[both]), (gap[both] / tol[both]).max()
    one = differ & ~both
    if one.any():
        cover = np.where(ids >= 0, ids, ids_ref)
        e, _terms, _z, _ivs = _winner_edges(cover, setup_np)
        on_edge = np.any(np.abs(np.moveaxis(e, -1, 0))
                         <= 2 * edge_error_bound(cover, setup_np), axis=0)
        assert np.all(on_edge[one]), int((~on_edge & one).sum())


def assert_winners_own_setup(ids, ids_ref, setup_port, setup_ref):
    """Where two frames' winner maps differ, each package's winner is the
    nearer of the two candidates under its OWN triangle setup, or the other
    candidate sits on one of its edges there (|e| within twice
    :func:`edge_error_bound`). For scenes of sub-pixel, interpenetrating
    faces (config 3's 1,000 cubes), where the vertex stage's rounding moves
    two faces' extrapolated depths apart by more than the depth formula's
    own error: each answer is exact for its package's vertices."""
    differ = ids != ids_ref
    if not differ.any():
        return

    def on_edge(cand, setup_np):
        e, _terms, _z, _ivs = _winner_edges(cand, setup_np)
        return (cand >= 0) & np.any(np.abs(np.moveaxis(e, -1, 0))
                                    <= 2 * edge_error_bound(cand, setup_np),
                                    axis=0)

    for win, other, setup_np in ((ids, ids_ref, setup_port),
                                 (ids_ref, ids, setup_ref)):
        d_win = exact_depth(win, setup_np)
        d_other = exact_depth(other, setup_np)
        tol = _FRAME_SLACK * (depth_error_bound(win, setup_np)
                              + depth_error_bound(other, setup_np))
        nearer = (win >= 0) & ((other < 0) | (d_win <= d_other + tol))
        ok = nearer | on_edge(other, setup_np) | on_edge(win, setup_np)
        assert np.all(ok[differ]), int((differ & ~ok).sum())


def assert_frame_depth_close(got, ref, ids, setup_np, where, atol=4e-6):
    """Depths of two whole frames on the pixels ``where``: within ``atol``
    plus twice ``_FRAME_SLACK`` times the winner's
    :func:`depth_error_bound` on every one."""
    bound = depth_error_bound(ids, setup_np)[where]
    diff = np.abs(np.asarray(got, np.float64)
                  - np.asarray(ref, np.float64))[where]
    assert np.all(diff <= atol + 2 * _FRAME_SLACK * bound), float(
        ((diff - atol) / bound).max())


def assert_frame_fb_close(got, ref, ids, setup_np, where, atol=1.0 / 255.0,
                          max_frac=1e-3, min_cond=1e3, explained=None):
    """Framebuffers of two whole frames on the pixels ``where``: within one
    8-bit step (``atol``) on all but ``max_frac`` of them; those sit on
    edges whose :func:`edge_condition` exceeds ``min_cond``, where the two
    packages' interpolation weights round apart far enough for a
    nearest-texel lookup to land on the neighbouring texel, or on the
    pixels ``explained`` (a mask of other stated causes: :func:`fx_explained`)."""
    diff = np.abs(np.asarray(got, np.float64)
                  - np.asarray(ref, np.float64)).max(0)
    off = (diff > atol) & where
    assert off.sum() <= max_frac * where.sum(), (int(off.sum()),
                                                 float(diff[where].max()))
    if explained is not None:
        off &= ~explained
    if off.any():
        cond = edge_condition(ids, setup_np)
        assert np.all(cond[off] > min_cond), cond[off].min()


def render_both(build, accelerator: bool = True, frame_ids=False,
                tie_ulps=None, **kw):
    """A scene built by ``build`` (ckrenderengine_tpu_torch.scenes) through
    each package's object model and rendered once by each through
    Render(), the reference by :func:`render_reference` (``frame_ids`` and
    ``tie_ulps`` pass on): (reference context, port context, the
    reference's packed inputs, reference_winners of them)."""
    import ckrenderengine_tpu_torch.objects as O

    rj = render_reference(build, accelerator, frame_ids, tie_ulps, **kw)
    _ct, rt, _mt = build(O, device="cpu", **kw)
    render_ids(rt)
    packed = rj._fill_packed([], [])
    return rj, rt, packed, reference_winners(*packed)


def check_frame_against_reference(ids, fb, zb, ref, rj, setup_port=None,
                                  explained=None, min_same=0.999):
    """A port frame (winner ids, fb, zb) against the reference's solve
    ``ref`` = (ids, depth, setup) of the same inputs and the reference's
    rendered frame ``rj`` (tests/test_torch_slice.py says why each bound).

    With ``setup_port`` (the port's own triangle setup, numpy), for scenes
    of sub-pixel, interpenetrating faces: differing winners are held to
    :func:`assert_winners_own_setup`; depths to the reference's where the
    winner's :func:`edge_condition` is at most 1e3, and everywhere to the
    exact depth of the port's winner under the port's setup (on an
    ill-conditioned edge the two setups' coefficients cancel apart); and
    the pixels where the reference's frame disagrees with its own exact
    solve (``rj.frame_ids``) are not compared with that frame.
    ``explained``: as in :func:`assert_frame_fb_close`. ``min_same``: the
    share of pixels whose winners (and frame) must match; every other
    pixel is held to the tie bounds above.
    """
    ids_ref, depth_ref, setup = ref
    same = ids == ids_ref
    assert same.mean() >= min_same, same.mean()
    if setup_port is None:
        assert_winner_ties(ids, ids_ref, setup)
        well = same
    else:
        assert_winners_own_setup(ids, ids_ref, setup_port, setup)
        well = same & (edge_condition(ids_ref, setup) <= 1e3)
        assert_frame_depth_close(zb, exact_depth(ids, setup_port), ids,
                                 setup_port, ids >= 0)
    assert_frame_depth_close(zb, depth_ref, ids_ref, setup, well)

    fb_ref, zb_ref = np.asarray(rj.fb), np.asarray(rj.zb)
    bound = depth_error_bound(ids_ref, setup)
    consistent = (np.abs(zb_ref.astype(np.float64) - depth_ref)
                  <= 4e-6 + 2 * _FRAME_SLACK * bound)
    match = same & consistent
    if setup_port is not None and getattr(rj, "frame_ids", None) is not None:
        match &= rj.frame_ids == ids_ref
    assert match.mean() >= min_same, match.mean()
    assert_frame_depth_close(zb, zb_ref, ids_ref, setup, match & well)
    assert_frame_fb_close(fb, fb_ref, ids_ref, setup, match,
                          explained=explained)
    assert (ids_ref >= 0).mean() > 0.1


def _windows(x, ss):
    """(H*ss, W*ss) -> (H, ss, W, ss): each display pixel's samples."""
    x = np.asarray(x)
    return x.reshape(x.shape[0] // ss, ss, x.shape[1] // ss, ss)


def win_all(m, ss=2):
    return _windows(m, ss).all(axis=(1, 3))


def win_max(x, ss=2):
    return _windows(x, ss).max(axis=(1, 3))


def win_min(x, ss=2):
    return _windows(x, ss).min(axis=(1, 3))


def _assert_lo_depth_close(got, ref, bound, where, atol=4e-6):
    diff = np.abs(np.asarray(got, np.float64)
                  - np.asarray(ref, np.float64))[where]
    tol = atol + 2 * _FRAME_SLACK * bound[where]
    assert np.all(diff <= tol), float((diff - tol).max())


def check_aa_frame_against_reference(ids, fb, zb, ref, rj, setup_port=None,
                                     ss=2, explained=None):
    """An Antialias frame of the port against the reference: the bounds of
    :func:`check_frame_against_reference`, taken per display pixel over
    its ss x ss samples. ``ids`` and ``ref`` = (ids, depth, setup) are at
    the render size, ``fb``, ``zb`` and the reference's frame ``rj`` at the
    display size (resolved: fb by the window mean, zb by its minimum).

    - Winners at the render size: equal on >= 99.9% of the samples, ties
      elsewhere (or held to each package's own setup with ``setup_port``).
    - A display pixel whose samples all have equal winners: its zb within
      ``4e-6 + 2 * _FRAME_SLACK`` times the largest depth bound of its
      samples of the minimum of the reference's exact solve (the minimum of
      values each within a bound is within the largest bound).
    - Framebuffers within 1/255 on all but 0.1% of the pixels whose samples
      all match; those sit on an ill-conditioned edge (the largest
      :func:`edge_condition` of their samples > 1e3), or are
      ``explained`` (display size; as in :func:`assert_frame_fb_close`)."""
    ids_ref, depth_ref, setup = ref
    same = ids == ids_ref
    assert same.mean() >= 0.999, same.mean()
    if setup_port is None:
        assert_winner_ties(ids, ids_ref, setup)
        well = same
    else:
        assert_winners_own_setup(ids, ids_ref, setup_port, setup)
        well = same & (edge_condition(ids_ref, setup) <= 1e3)
        cov = win_all(ids >= 0, ss)
        _assert_lo_depth_close(
            zb, win_min(np.nan_to_num(exact_depth(ids, setup_port),
                                      nan=1.0), ss),
            win_max(depth_error_bound(ids, setup_port), ss), cov)
    bound = win_max(depth_error_bound(ids_ref, setup), ss)
    depth_lo = win_min(depth_ref, ss)
    _assert_lo_depth_close(zb, depth_lo, bound, win_all(well, ss))

    fb_ref, zb_ref = np.asarray(rj.fb), np.asarray(rj.zb)
    consistent = (np.abs(zb_ref.astype(np.float64) - depth_lo)
                  <= 4e-6 + 2 * _FRAME_SLACK * bound)
    match = win_all(same, ss) & consistent
    if setup_port is not None and getattr(rj, "frame_ids", None) is not None:
        match &= win_all(rj.frame_ids == ids_ref, ss)
    assert match.mean() >= 0.999, match.mean()
    _assert_lo_depth_close(zb, zb_ref, bound, match & win_all(well, ss))
    diff = np.abs(np.asarray(fb, np.float64)
                  - np.asarray(fb_ref, np.float64)).max(0)
    off = (diff > 1.0 / 255.0) & match
    assert off.sum() <= 1e-3 * match.sum(), (int(off.sum()),
                                             float(diff[match].max()))
    if explained is not None:
        off &= ~explained
    if off.any():
        cond = win_max(edge_condition(ids_ref, setup), ss)
        assert np.all(cond[off] > 1e3), cond[off].min()
    assert (ids_ref >= 0).mean() > 0.1


def check_render(pair, own_setup: bool = False, explained=None,
                 min_same=0.999):
    """The port's Render() frame of ``pair`` (from :func:`render_both`)
    against the reference; the port's winners from its own packed inputs.
    ``own_setup``: hold differing winners to each package's own triangle
    setup (:func:`assert_winners_own_setup`). An Antialias frame is held
    to :func:`check_aa_frame_against_reference`; a frame at 1x to
    :func:`check_frame_against_reference` (``min_same`` passes on).
    Returns the port's frame parameters."""
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    rj, rt, _packed, ref = pair
    st, tf, ti, tp = rt._fill_packed([], [])
    tf, ti = torch.as_tensor(tf), torch.as_tensor(ti)
    ids = port_frame_ids(rt, st, tf, ti, tp)
    setup_port = None
    if own_setup:
        setup_port = {k: to_np(v) for k, v in tfr.packed_setup(
            st, tf, ti, tp)[2].items() if isinstance(v, torch.Tensor)}
    args = (to_np(ids), to_np(rt.fb), to_np(rt.zb), ref, rj, setup_port)
    if tp.get("ss", 1) == 1:
        check_frame_against_reference(*args, explained=explained,
                                      min_same=min_same)
    else:
        check_aa_frame_against_reference(*args, explained=explained)
    return tp


def check_reference_inputs(pair, own_setup: bool = False):
    """The reference's own packed inputs of ``pair``, converted with
    convert.from_reference, through the port's render_frame_packed
    (``own_setup`` as in :func:`check_render`)."""
    from ckrenderengine_tpu_torch import convert
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    rj, _rt, (static, dyn_f, dyn_i, params), ref = pair
    st, tf, ti, tp = convert.from_reference(
        {k: np.asarray(v) for k, v in static.items()}, dyn_f, dyn_i, params,
        "cpu")
    fb, zb, ids = port_winners(st, tf, ti, tp)
    setup_port = None
    if own_setup:
        setup_port = {k: to_np(v) for k, v in tfr.packed_setup(
            st, tf, ti, tp)[2].items() if isinstance(v, torch.Tensor)}
    check_frame_against_reference(to_np(ids), to_np(fb), to_np(zb), ref, rj,
                                  setup_port)


_U = 2.0 ** -24


def exact_rows(scene, world, bank):
    """(rows float64 (L, 12) exact, delta (L,) bound on either package's
    endpoint error in x and y, delta_z (L,) in depth): the vertex path of
    draw_lines in float64, with first-order f32 error bounds."""
    g = lambda n: n * _U / (1 - n * _U)              # noqa: E731
    world_ext = np.concatenate([world, np.eye(4, dtype=np.float32)[None]])
    ep = bank["idx"].reshape(-1)
    src = scene["src_idx"][ep]
    pos = scene["positions"][src].astype(np.float64)
    wm = world_ext[scene["vert_entity"][ep]].astype(np.float64)
    r, t = wm[:, :3, :3], wm[:, 3, :3]
    terms = np.abs(pos[:, :, None] * r).sum(1) + np.abs(t)
    posw = np.einsum("ni,nij->nj", pos, r) + t
    e_posw = g(4) * terms
    view = scene["view"].astype(np.float64)
    proj = scene["proj"].astype(np.float64)
    vp_m = view @ proj
    e_m = g(4) * (np.abs(view) @ np.abs(proj))
    p4 = np.concatenate([posw, np.ones((posw.shape[0], 1))], 1)
    e4 = np.concatenate([e_posw, np.zeros((posw.shape[0], 1))], 1)
    clip = p4 @ vp_m
    e_clip = (g(8) * (np.abs(p4) @ np.abs(vp_m)) + e4 @ np.abs(vp_m)
              + np.abs(p4) @ e_m)
    vx, vy, vw, vh = scene["viewport"].astype(np.float64)
    w = np.maximum(clip[:, 3], 1e-6)
    qx, qy, qz = clip[:, 0] / w, clip[:, 1] / w, clip[:, 2] / w
    e_w = e_clip[:, 3]

    def e_q(q, ec):
        return (ec + np.abs(q) * e_w) / w + _U * np.abs(q)

    sx = vx + vw * 0.5 + qx * (vw * 0.5)
    sy = vy + vh * 0.5 - qy * (vh * 0.5)
    e_sx = vw * 0.5 * e_q(qx, e_clip[:, 0]) + g(3) * (
        abs(vx) + vw * 0.5 + np.abs(qx) * vw * 0.5)
    e_sy = vh * 0.5 * e_q(qy, e_clip[:, 1]) + g(3) * (
        abs(vy) + vh * 0.5 + np.abs(qy) * vh * 0.5)
    e_sz = e_q(qz, e_clip[:, 2])
    behind = clip[:, 3] <= 1e-6
    valid = bank["valid"] & ~(behind[0::2] | behind[1::2])
    rows = np.stack([sx[0::2], sy[0::2], sx[1::2], sy[1::2], qz[0::2],
                     qz[1::2], valid.astype(np.float64),
                     np.zeros(valid.shape)], 1)
    rows = np.concatenate([rows, bank["color"].astype(np.float64)], 1)
    e_xy = np.maximum(e_sx + e_sy, 0)
    delta = 2 * np.maximum(e_xy[0::2], e_xy[1::2])
    delta_z = 2 * np.maximum(e_sz[0::2], e_sz[1::2])
    # No endpoint sits within its error of the w threshold.
    assert np.all(np.abs(clip[:, 3] - 1e-6) > e_w)
    return rows, delta, delta_z


def line_band(rows, h, w, zb_lo, zb_hi, delta, delta_z, row0=0.0,
              half_width=0.7, z_bias=1e-4):
    """(h, w) bool: the pixels where some valid line segment's coverage
    decision lies within rounding of its threshold (the line pass's band).

    ``rows`` (L, 12) are line_rows-layout segments in float64 (taken as
    exact), ``delta`` (L,) a bound on either package's endpoint error (x
    and y) and ``delta_z`` (L,) on its endpoint depths. Per (pixel,
    segment): the distance to the segment within 2 delta + 16 u (|pax| +
    |pay| + |dx| + |dy|) of sqrt(f32(half_width^2)) while the depth can
    pass, or the depth along the segment within delta_z + |z1 - z0| dt +
    16 u of a limit in [zb_lo, zb_hi] + z_bias (zb_lo / zb_hi: the two
    packages' depth buffers, elementwise), of 0 or of 1, where dt bounds
    the error of the segment parameter t."""
    rows = np.asarray(rows, np.float64)
    keep = rows[:, 6] > 0.5
    rows, delta, delta_z = rows[keep], np.asarray(delta)[keep], \
        np.asarray(delta_z)[keep]
    hw = np.sqrt(float(np.float32(half_width * half_width)))
    zb_lo, zb_hi = (np.minimum(zb_lo, zb_hi).astype(np.float64) + z_bias,
                    np.maximum(zb_lo, zb_hi).astype(np.float64) + z_bias)
    px = np.arange(w, dtype=np.float64)[None, None] + 0.5
    py = np.arange(h, dtype=np.float64)[None, :, None] + 0.5 + row0
    band = np.zeros((h, w), bool)
    for c0 in range(0, rows.shape[0], 32):
        r = rows[c0:c0 + 32]

        def col(a):
            return a[:, None, None]

        ax, ay, z0, z1 = (col(r[:, i]) for i in (0, 1, 4, 5))
        dx, dy = col(r[:, 2] - r[:, 0]), col(r[:, 3] - r[:, 1])
        d = col(delta[c0:c0 + 32])
        dz = col(delta_z[c0:c0 + 32])
        len2 = dx * dx + dy * dy
        pax, pay = px - ax, py - ay
        t = np.clip((pax * dx + pay * dy) / np.maximum(len2, 1e-300), 0, 1)
        dist = np.hypot(pax - t * dx, pay - t * dy)
        mag = np.abs(pax) + np.abs(pay) + np.abs(dx) + np.abs(dy)
        e_d = 2 * d + 16 * _U * mag
        seg = np.sqrt(len2)
        dt = np.minimum(1.0, 4 * e_d * (np.hypot(pax, pay) + seg)
                        / np.maximum(len2, 1e-300))
        zl = z0 * (1 - t) + z1 * t
        e_z = dz + np.abs(z1 - z0) * dt + 16 * _U
        z_may = (zl <= zb_hi[None] + e_z) & (zl >= -e_z) & (zl <= 1 + e_z)
        near = dist <= hw + e_d
        near_z = ((zl >= zb_lo[None] - e_z) & (zl <= zb_hi[None] + e_z)
                  | (np.abs(zl) <= e_z) | (np.abs(zl - 1) <= e_z))
        band |= ((np.abs(dist - hw) <= e_d) & z_may | near & near_z).any(0)
    return band


def ill_conditioned(setup_np, sel, xyw, h, w, min_cond=1e3):
    """(h, w) bool: pixels where the edge evaluation of one of the selected
    triangles is ill-conditioned (:func:`edge_condition` > ``min_cond``),
    within a pixel of its screen box; ``xyw`` (T, 3, 3) the triangles'
    screen-homogeneous corners, ``sel`` (T,) bool."""
    out = np.zeros((h, w), bool)
    ec = np.asarray(setup_np["e_coef"], np.float64)
    xyw = np.asarray(xyw, np.float64)
    for k in np.nonzero(sel)[0]:
        with np.errstate(divide="ignore", invalid="ignore"):
            v = xyw[k, :, :2] / xyw[k, :, 2:3]
        if not np.isfinite(v).all() or (xyw[k, :, 2] <= 0).any():
            x0, x1, y0, y1 = 0, w, 0, h
        else:
            x0 = max(int(np.floor(v[:, 0].min())) - 1, 0)
            x1 = min(int(np.ceil(v[:, 0].max())) + 1, w)
            y0 = max(int(np.floor(v[:, 1].min())) - 1, 0)
            y1 = min(int(np.ceil(v[:, 1].max())) + 1, h)
        if x1 <= x0 or y1 <= y0:
            continue
        px = np.arange(x0, x1, dtype=np.float64)[None, :, None] + 0.5
        py = np.arange(y0, y1, dtype=np.float64)[:, None, None] + 0.5
        a, b, c = ec[k, :, 0], ec[k, :, 1], ec[k, :, 2]
        e = a * px + b * py + c
        terms = np.abs(a * px) + np.abs(b * py) + np.abs(c)
        cond = (terms / np.maximum(np.abs(e), 1e-30)).max(-1)
        out[y0:y1, x0:x1] |= cond > min_cond
    return out


def fx_explained(pair, eps=1e-3, eps_z=1e-5):
    """(H, W) bool at the display size: the pixels of a ``render_both``
    pair whose colours may differ for a stated cause other than an opaque
    edge, so that :func:`check_render` may leave them to the 0.1% budget.
    Both masks come from the reference's own stages of the frame
    (:func:`reference_stages`), never from the port's:

    - an ill-conditioned edge (:func:`edge_condition` > 1e3, the bound
      :func:`assert_frame_fb_close` holds opaque winners to) of a triangle
      of the ordered pass or of a 3D sprite: its coverage there goes
      either way with the rounding of its corners, which each package's
      billboard stage computes (the reference's jit may round them apart
      by 8 u S, tests/test_torch_billboards.py);
    - the line band (:func:`line_band`) of the frame's line bank: the
      endpoints' exact projections in float64 (:func:`exact_rows`), with
      their first-order f32 error bounds but at least ``eps`` px in x and
      y and ``eps_z`` in depth (the bounds take each package's world
      matrices as exact, and the two compose them apart by a few ulps),
      against a depth buffer anywhere between the two packages' (both
      frames' zb and the reference's exact solve within its bound).

    An Antialias frame's masks are made at its render size (against the
    reference's exact solve there) and a display pixel is explained when
    any of its samples is."""
    from ckrenderengine_tpu.raster.types import SI_STENCIL

    rj, rt, packed, ref = pair
    params = packed[3]
    ss = params.get("ss", 1)
    h, w = rj.height * ss, rj.width * ss
    st = reference_stages(*packed)
    batch = st["batch"]
    sidx = np.asarray(batch.state_idx)
    state_i = np.asarray(st["scene"].state_i)
    sprite_state = np.array([kind == "sprite" for _m, kind, _b
                             in rj._compiled.materials])
    sel = np.asarray(batch.valid) & (
        ~np.asarray(st["defer"]) & (state_i[sidx, SI_STENCIL] == 0)
        | sprite_state[sidx])
    out = ill_conditioned(st["setup"], sel, np.asarray(batch.xyw), h, w)
    if params["lines"] is not None:
        sc = st["scene_lines"]
        scene = {k: np.asarray(getattr(sc, k)) for k in (
            "src_idx", "vert_entity", "positions", "view", "proj",
            "viewport")}
        bank = {k: np.asarray(getattr(params["lines"], k))
                for k in ("idx", "color", "valid")}
        rows, delta, delta_z = exact_rows(
            scene, np.asarray(st["world_lines"]), bank)
        ids_ref, depth_ref, setup = ref
        b = 4e-6 + 2 * _FRAME_SLACK * np.nan_to_num(
            depth_error_bound(ids_ref, setup), nan=0.0)
        lo, hi = depth_ref - b, depth_ref + b
        if ss == 1:
            zs = (to_np(rt.zb), np.asarray(rj.zb))
            lo = np.minimum(lo, np.minimum(*zs))
            hi = np.maximum(hi, np.maximum(*zs))
        out |= line_band(rows, h, w, lo, hi, np.maximum(delta, eps),
                         np.maximum(delta_z, eps_z))
    return out if ss == 1 else win_max(out, ss)


# Small scenes of the reference's render-to-texture and stereo tests
# (tests/test_aux.py, tests/test_texture_atlas.py), built through either
# object model. Their 64x64 flat-route frames are held to the reference's
# within ATOL, the f32 rounding of their lit and textured shades.
ATOL = 2e-5


def small_ctx(P):
    """A ``CKContext`` of package ``P``: the port's on the CPU."""
    if P.__name__.startswith("ckrenderengine_tpu_torch"):
        return P.CKContext(device="cpu")
    return P.CKContext()


def tri_scene(P, ctx, emissive=(1, 0, 0, 1)):
    """The reference's one-triangle scene (tests/test_aux.py:14-27)."""
    mesh = P.CKMesh(ctx, "t")
    mesh.SetPositions(np.array([[-1, -1, 0], [0, 1, 0], [1, -1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.SetUVs(np.array([[0, 1], [0.5, 0], [1, 1]], np.float32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "m")
    mat.SetEmissive(emissive)
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = P.CK3dObject(ctx, "tri")
    obj.SetCurrentMesh(mesh)
    return obj, mesh, mat


def small_rc(P, ctx, w=64, h=64, name="cam"):
    """A ``w`` x ``h`` render context whose camera ``name`` stands at
    z = -4 (tests/test_aux.py:30-36)."""
    rc = ctx.GetRenderManager().CreateRenderContext(w, h)
    cam = P.CKCamera(ctx, name)
    cam.SetPosition((0, 0, -4))
    rc.AttachViewpointToCamera(cam)
    return rc


def textured_quad(P, ctx, tex, name="screen", x0=-1.0, x1=1.0):
    """A two-sided emissive quad textured by ``tex``."""
    quad = P.CKMesh(ctx, name + "_m")
    quad.SetPositions(np.array([[x0, -1, 0], [x1, -1, 0], [x1, 1, 0],
                                [x0, 1, 0]], np.float32))
    quad.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    quad.SetUVs(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    quad.BuildNormals()
    qmat = P.CKMaterial(ctx, name + "_mat")
    qmat.SetEmissive((1, 1, 1, 1))
    qmat.SetTwoSided(True)
    qmat.SetTexture(tex)
    quad.ApplyGlobalMaterial(qmat)
    screen = P.CK3dObject(ctx, name)
    screen.SetCurrentMesh(quad)
    return screen


def rtt_chain(P):
    """The reference's render-to-texture chain
    (tests/test_texture_atlas.py:168-205): ``rc1`` renders a spinning lit
    triangle into ``rtt``, ``rc2`` a quad textured by ``rtt``. Returns
    (ctx, rc1, rc2, spin, rtt)."""
    ctx = small_ctx(P)
    rc1 = small_rc(P, ctx, name="c1")
    mesh = P.CKMesh(ctx, "tri")
    mesh.SetPositions(np.array([[-1, -1, 0], [0, 1.5, 0], [1, -1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, "m")
    mat.SetDiffuse((1, 0.1, 0.1, 1))
    mesh.ApplyGlobalMaterial(mat)
    spin = P.CK3dObject(ctx, "spin")
    spin.SetCurrentMesh(mesh)
    rc1.AddObject(spin)
    rc1.AddObject(rc1.GetAttachedCamera())
    rtt = P.CKTexture(ctx, "rtt")
    rc1.SetTargetTexture(rtt)
    rc2 = small_rc(P, ctx, name="c2")
    screen = textured_quad(P, ctx, rtt)
    rc2.AddObject(screen)
    rc2.AddObject(rc2.GetAttachedCamera())
    return ctx, rc1, rc2, spin, rtt


def assert_frames_close(rc_t, rc_j):
    """The port context's fb and zb within ATOL of the reference's."""
    fb_t, fb_j = rc_t.framebuffer(), rc_j.framebuffer()
    assert fb_t.shape == fb_j.shape
    np.testing.assert_allclose(fb_t, fb_j, atol=ATOL)
    np.testing.assert_allclose(rc_t.zbuffer(), rc_j.zbuffer(), atol=ATOL)
