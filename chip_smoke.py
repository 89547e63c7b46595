"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``ckrenderengine_tpu_torch`` from
``ckrenderengine_tpu_torch/csrc`` (B1 tiled solve, B2 flat solve, B3 ordered
blend, B4 textured peel), holds each kernel against its plain torch version
on the card, drives BASELINE configs 1, 2 and 5 and the two transparency
stress scenes (``alpha50k``, ``alpha_tex50k``) through the CK entry points
(``CKContext(device="cuda")`` -> ``CreateRenderContext`` -> ``Render()``),
checks an overflowing ordered frame's in-frame replay, holds the kernel
frames against the exact ordered pass and against the CPU, checks the two
golden frames the reference package rendered (``tests/torch_golden/``), and
times the frames and kernels. Every phase prints a line; any failure
raises, so the exit code is nonzero. The last line is the device record
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without CUDA the
script exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "torch_golden")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# Kernel fixtures (numpy, from a seed)
# ---------------------------------------------------------------------------

def solve_fixture(T=9000, H=320, W=512, seed=3, planes=0):
    """Random screen-space triangles (the reference's on-chip parity
    fixture, benchmarks/parity_tpu_check.py ``_solve_fixture``), optional
    per-corner user-clip-plane distances. Returns numpy (xyw, z, clipd)."""
    rng = np.random.default_rng(seed)
    xyw = np.zeros((T, 3, 3), np.float32)
    ctr = rng.uniform([0, 0], [W, H], (T, 2)).astype(np.float32)
    for k in range(3):
        ang = rng.uniform(0, 2 * np.pi, T)
        rad = rng.uniform(2, 60, T)
        w = rng.uniform(0.5, 2.0, T).astype(np.float32)
        xyw[:, k, 0] = (ctr[:, 0] + np.cos(ang) * rad) * w
        xyw[:, k, 1] = (ctr[:, 1] + np.sin(ang) * rad) * w
        xyw[:, k, 2] = w
    z = rng.uniform(0, 1, (T, 3)).astype(np.float32) * xyw[:, :, 2]
    clipd = (rng.uniform(-1, 1, (T, 3, planes)).astype(np.float32)
             if planes else None)
    return xyw, z, clipd


def make_setup(xyw, z, clipd, device):
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.raster.types import (
        NUM_SI, SI_CULL, VXCULL,
    )

    t = xyw.shape[0]
    state_i = np.zeros((1, NUM_SI), np.int32)
    state_i[:, SI_CULL] = int(VXCULL.NONE)
    xyw_t = torch.as_tensor(xyw, device=device)
    setup = df.triangle_setup(
        xyw_t, torch.as_tensor(z, device=device),
        torch.zeros(t, dtype=torch.int32, device=device),
        torch.ones(t, dtype=torch.bool, device=device),
        torch.as_tensor(state_i, device=device),
        clipd=None if clipd is None else torch.as_tensor(clipd,
                                                         device=device))
    return setup, xyw_t


def compare_b1(name, H, W, seed=3, T=9000, planes=0, kept_zb=False,
               **caps) -> float:
    """B1 through the whole tiled solve on the card (kernel) and on the CPU
    (plain phase B) from identical inputs: exact ids, depths, e-planes and
    bin statistics. Returns the max abs depth difference (0 when exact)."""
    from ckrenderengine_tpu_torch.raster.cuda_tiled import (
        depth_reduce_tiled_cuda,
    )

    xyw, z, clipd = solve_fixture(T, H, W, seed, planes)
    clear = 1.0
    if kept_zb:
        clear = np.random.default_rng(seed + 1).uniform(
            0.1, 0.9, (H, W)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        setup, xyw_t = make_setup(xyw, z, clipd, dev)
        vp = torch.tensor([0.0, 0.0, W, H], device=dev)
        cz = clear if np.isscalar(clear) else torch.as_tensor(clear,
                                                              device=dev)
        bi, bd, stats, ep = depth_reduce_tiled_cuda(
            setup, torch.ones(T, dtype=torch.bool, device=dev), cz, vp,
            xyw_t, H, W, want_eplanes=True, want_binstats=True, **caps)
        outs[dev] = [x.cpu().numpy() for x in (bi, bd, stats, ep)]
    (bi_k, bd_k, st_k, ep_k), (bi_p, bd_p, st_p, ep_p) = \
        outs["cuda"], outs["cpu"]
    err = float(np.abs(bd_k - bd_p).max())
    ok = (np.array_equal(bi_k, bi_p) and np.array_equal(bd_k, bd_p)
          and np.array_equal(ep_k, ep_p) and np.array_equal(st_k, st_p))
    emit("kernel_parity", kernel="B1", case=name, shape=[H, W], tris=T,
         ids_equal=bool(np.array_equal(bi_k, bi_p)),
         depth_max_abs_err=err,
         eplanes_max_abs_err=float(np.abs(ep_k - ep_p).max()),
         binstats=st_k.tolist(), binstats_equal=bool(
             np.array_equal(st_k, st_p)),
         covered=float((bi_k >= 0).mean()), ok=bool(ok))
    check(ok, f"B1 {name}: kernel and plain version disagree")
    check((bi_k >= 0).any(), f"B1 {name}: nothing covered")
    return err


def compare_b2(H=256, W=256, T=2000, seed=5) -> float:
    """B2 kernel vs its plain version on the same CUDA rows."""
    from ckrenderengine_tpu_torch.raster.cuda_reduce import (
        depth_reduce_plain, pack_rows, reduce_flat_kernel,
    )

    xyw, z, _ = solve_fixture(T, H, W, seed)
    setup, _ = make_setup(xyw, z, None, "cuda")
    rows = pack_rows(setup, torch.ones(T, dtype=torch.bool, device="cuda"))
    vp = torch.tensor([0.0, 0.0, W, H], device="cuda")
    bi_k, bd_k = reduce_flat_kernel(rows, 1.0, vp, H, W)
    bi_p, bd_p = depth_reduce_plain(rows, 1.0, vp, H, W)
    err = float((bd_k - bd_p).abs().max())
    ids_ok = bool(torch.equal(bi_k, bi_p))
    ok = ids_ok and bool(torch.equal(bd_k, bd_p))
    emit("kernel_parity", kernel="B2", case="random", shape=[H, W], tris=T,
         ids_equal=ids_ok, depth_max_abs_err=err,
         covered=float((bi_k >= 0).float().mean()), ok=ok)
    check(ok, "B2: kernel and plain version disagree")
    return err


# ---------------------------------------------------------------------------
# Ordered-kernel fixtures (the reference's tests/test_pallas_ordered.py and
# tests/test_pallas_peel.py fixtures, recreated with numpy)
# ---------------------------------------------------------------------------

def random_tris(t, h, w, seed, big_frac=0.1):
    """tests/test_tiled_raster._random_batch: screen-space triangles as
    homogeneous (x*w', y*w', w') with clip z."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([0, 0], [w, h], (t, 2)).astype(np.float32)
    sizes = rng.uniform(2, 25, (t, 1)).astype(np.float32)
    big = rng.random(t) < big_frac
    sizes[big] = rng.uniform(100, 400, (big.sum(), 1)).astype(np.float32)
    offs = rng.normal(0, 1, (t, 3, 2)).astype(np.float32)
    pts = centers[:, None] + offs * sizes[:, None]
    ws = rng.uniform(0.5, 4.0, (t, 3, 1)).astype(np.float32)
    return (np.concatenate([pts * ws, ws], axis=-1),
            rng.uniform(0.05, 0.95, (t, 3)).astype(np.float32))


def ordered_states(textured: bool):
    """The reference fixtures' three states: alpha-over (fogged), replace or
    plain alpha-over, alpha-tested alpha-over; textured for the peel."""
    from ckrenderengine_tpu_torch.raster.types import (
        VXBLEND, VXCMP, VXCULL, VXTEXTURE_FILTER, RasterState, pack_states,
    )

    over = dict(alpha_blend=True, src_blend=int(VXBLEND.SRCALPHA),
                dst_blend=int(VXBLEND.INVSRCALPHA), z_write=False,
                cull=int(VXCULL.NONE))
    atest = dict(over, alpha_test=True, alpha_func=int(VXCMP.GREATER))
    if textured:
        return pack_states([
            RasterState(**over, fog=True, tex=0,
                        tex_filter=int(VXTEXTURE_FILTER.LINEAR)),
            RasterState(**over), RasterState(**atest, alpha_ref=0.4, tex=0)])
    return pack_states([RasterState(**over, fog=True),
                        RasterState(z_write=False, cull=int(VXCULL.NONE)),
                        RasterState(**atest, alpha_ref=0.35)])


def ordered_fixture(xyw, z, rng, h, w, rects=True, planes=0, seed=0):
    """Per-triangle fields of an ordered batch around (xyw, z), drawn from
    ``rng`` in the reference fixtures' order."""
    t = xyw.shape[0]
    fx = dict(xyw=xyw, z=z,
              color=rng.uniform(0, 1, (t, 3, 4)).astype(np.float32),
              specular=rng.uniform(0, 0.2, (t, 3, 3)).astype(np.float32),
              uv=rng.uniform(0, 1, (t, 3, 2)).astype(np.float32),
              fog=rng.uniform(0.3, 1, (t, 3)).astype(np.float32),
              state_idx=rng.integers(0, 3, t).astype(np.int32),
              valid=rng.random(t) < 0.9)
    rect = np.tile(np.array([[-1e9, -1e9, 1e9, 1e9]], np.float32), (t, 1))
    if rects:
        rect[rng.random(t) < 0.2] = [8.0, 6.0, w - 10.0, h - 8.0]
    fx["clip_rect"] = rect
    fx["clipd"] = (np.random.default_rng(seed).uniform(
        -1, 1, (t, 3, planes)).astype(np.float32) if planes
        else np.zeros((t, 3, 0), np.float32))
    fx["refl"] = np.zeros((t, 3, 0), np.float32)
    return fx


def blend_fixtures():
    """(name, fields, h, w, tile, zb, viewport, fog colour, windows,
    bad expected) of each B3 parity case."""
    out = []
    for seed in (1, 4):
        h, w = 48, 96
        xyw, z = random_tris(150, h, w, seed)
        fx = ordered_fixture(xyw, z, np.random.default_rng(seed), h, w)
        rng = np.random.default_rng(seed + 100)
        rng.uniform(0, 1, (4, h, w))
        zb = rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
        out.append((f"random_seed{seed}", fx, h, w, 16, zb, [0, 0, w, h],
                    [0.2, 0.3, 0.4], None, False))
    xyw, z = random_tris(80, 64, 64, 7)
    fx = ordered_fixture(xyw, z, np.random.default_rng(7), 64, 64, planes=1,
                         seed=7)
    out.append(("clip_planes_viewport", fx, 64, 64, 16,
                np.full((64, 64), 0.8, np.float32), [6, 4, 52, 54],
                [0.0, 0.0, 0.0], None, False))
    xyw, z = random_tris(600, 200, 300, 8)
    fx = ordered_fixture(xyw, z, np.random.default_rng(8), 200, 300)
    zb = np.random.default_rng(9).uniform(0.3, 1.0, (200, 300)).astype(
        np.float32)
    out.append(("tile32_non_divisible", fx, 200, 300, 32, zb,
                [0, 0, 300, 200], [0.2, 0.3, 0.4], None, False))
    xyw, z = random_tris(40, 64, 64, 3)
    fx = ordered_fixture(xyw, z, np.random.default_rng(3), 64, 64)
    out.append(("overflow", fx, 64, 64, 16, np.ones((64, 64), np.float32),
                [0, 0, 64, 64], [0.0, 0.0, 0.0], ((40, 1),), True))
    return out


def bounded_tris(seed, h, w, layers=3, spacing=16, rad=6.0):
    """tests/test_pallas_peel._bounded_batch: grid-placed small triangles
    in ``layers`` passes (per-pixel ordered depth <= layers)."""
    rng = np.random.default_rng(seed)
    pts = []
    for _layer in range(layers):
        for cy in range(spacing // 2, h, spacing):
            for cx in range(spacing // 2, w, spacing):
                ang = rng.uniform(0, 2 * np.pi, 3)
                r = rng.uniform(rad * 0.5, rad, 3)
                jx, jy = rng.uniform(-2, 2, 2)
                pts.append(np.stack([cx + jx + np.cos(ang) * r,
                                     cy + jy + np.sin(ang) * r], -1))
    pts = np.asarray(pts, np.float32)
    t = pts.shape[0]
    wgt = rng.uniform(0.5, 2.0, (t, 3, 1)).astype(np.float32)
    return (np.concatenate([pts * wgt, wgt], -1),
            rng.uniform(0.05, 0.5, (t, 3)).astype(np.float32))


def peel_fixtures():
    """(name, fields, h, w, zb, skips) of each B4 parity case: the bounded
    3-layer batches (seeds 1 and 7) and a stack of 9 covering triangles,
    deeper than K = 4, peeled at skip 0, 4 and 8."""
    out = []
    for seed in (1, 7):
        h, w = 48, 96
        xyw, z = bounded_tris(seed, h, w)
        rng = np.random.default_rng(seed)
        fx = ordered_fixture(xyw, z, rng, h, w, rects=False)
        rng.uniform(0, 1, (4, h, w))
        zb = rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
        out.append((f"bounded_seed{seed}", fx, h, w, zb, (0,)))
    t = 9
    tri = np.array([[2.0, 2.0, 1.0], [30.0, 2.0, 1.0], [2.0, 30.0, 1.0]],
                   np.float32)
    fx = ordered_fixture(np.tile(tri[None], (t, 1, 1)),
                         np.full((t, 3), 0.4, np.float32),
                         np.random.default_rng(11), 32, 32, rects=False)
    fx["valid"] = np.ones(t, bool)
    out.append(("stack9_beyond_k", fx, 32, 32, np.ones((32, 32), np.float32),
                (0, 4, 8)))
    return out


def _phase_a(fx, h, w, tile, zb, windows=None, textured=False):
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co

    si, sf = ordered_states(textured)
    f = {k: torch.as_tensor(v, device="cuda") for k, v in fx.items()}
    kw = {} if windows is None else dict(windows=windows)
    return co.phase_a(f["xyw"], f["z"], f["valid"], f["color"],
                      f["specular"], f["uv"], f["fog"], f["state_idx"],
                      f["clip_rect"], f["clipd"],
                      torch.as_tensor(si, device="cuda"),
                      torch.as_tensor(sf, device="cuda"),
                      torch.as_tensor(zb, device="cuda"), h, w, tile, **kw)


def compare_b3(name, fx, h, w, tile, zb, vp, fogc, windows, expect_bad):
    """B3 kernel vs its plain version on the same card-side phase A: the
    (8, H_pad, W_pad) A/B planes exactly."""
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co

    pa = _phase_a(fx, h, w, tile, zb, windows)
    args = (pa["stream"], pa["starts"], pa["counts"],
            co._params(vp, h, w, fogc, "cuda"), pa["zplane"], tile,
            pa["tiles_x"], pa["tiles_y"], pa["n_planes"])
    k = co.blend_kernel(*args)
    p = co.blend_phase_b_plain(*args)
    err = float((k - p).abs().max())
    exact = bool(torch.equal(k, p))
    bad = bool(pa["bad"])
    emit("kernel_parity", kernel="B3", case=name, shape=[h, w], tile=tile,
         tris=int(fx["xyw"].shape[0]), live_pairs=int(pa["n_live"]),
         bad=bad, max_abs_err=err, exact=exact,
         blended=float((k[0] != 1).float().mean()))
    check(exact, f"B3 {name}: kernel and plain version disagree")
    check(bad == expect_bad, f"B3 {name}: bad flag {bad}")
    return err


def compare_b4(name, fx, h, w, zb, skips):
    """B4 kernel vs its plain version per round: ids, edge values, counts
    and the overflow flag exactly."""
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co

    pa = _phase_a(fx, h, w, 16, zb, textured=True)
    err = 0.0
    for skip in skips:
        args = (pa["stream"], pa["starts"], pa["counts"],
                co._params([0, 0, w, h], h, w, dev="cuda"), skip,
                pa["zplane"], 16, pa["tiles_x"], pa["tiles_y"],
                pa["n_planes"])
        k = co.peel_kernel(*args)
        p = co.peel_phase_b_plain(*args)
        exact = all(torch.equal(a, b) for a, b in zip(k, p))
        e = float((k[1] - p[1]).abs().max())
        err = max(err, e)
        emit("kernel_parity", kernel="B4", case=name, shape=[h, w],
             skip=skip, tris=int(fx["xyw"].shape[0]),
             layer0_covered=float((k[0][0] >= 0).float().mean()),
             max_count=int(k[2].max()), overflow=bool(k[3].any()),
             max_abs_err=e, exact=bool(exact))
        check(exact, f"B4 {name} skip {skip}: kernel and plain disagree")
    return err


def build_panes(O, n_panes=70, width=1024, height=768, **ctx_kw):
    """``n_panes`` camera-facing full-screen glass panes (alpha-over,
    z-write off) in front of a far opaque wall: every pane spans all
    tiles, so more than the widest span class's 64 slots overflow the
    ordered kernel's phase A and the frame replays its exact pass."""
    from ckrenderengine_tpu_torch.raster.types import VXBLEND

    ctx = O.CKContext(**ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 0.0, -10.0))
    rc.AttachViewpointToCamera(cam)
    quad = np.array([[-40, -30, 0], [40, -30, 0], [40, 30, 0], [-40, 30, 0]],
                    np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    wall = O.CKMesh(ctx, "wallm")
    wall.SetPositions(quad + np.array([0, 0, 60], np.float32))
    wall.SetFaces(faces)
    wall.BuildNormals()
    wmat = O.CKMaterial(ctx, "wallmat")
    wmat.SetDiffuse((0.3, 0.4, 0.5, 1.0))
    wall.ApplyGlobalMaterial(wmat)
    O.CK3dObject(ctx, "wall").SetCurrentMesh(wall)
    pmat = O.CKMaterial(ctx, "panemat")
    pmat.SetDiffuse((0.8, 0.5, 0.3, 0.05))
    pmat.EnableAlphaBlend(True)
    pmat.SetSourceBlend(int(VXBLEND.SRCALPHA))
    pmat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
    pmat.EnableZWrite(False)
    for i in range(n_panes):
        m = O.CKMesh(ctx, f"pane{i}m")
        m.SetPositions(quad + np.array([0, 0, 10 + 0.5 * i], np.float32))
        m.SetFaces(faces)
        m.BuildNormals()
        m.ApplyGlobalMaterial(pmat)
        O.CK3dObject(ctx, f"pane{i}").SetCurrentMesh(m)
    return ctx, rc, None


def frame_with(rc, profile_off=()):
    """(fb, zb, stats) of rc's current frame through render_frame_packed
    on its device, with the given sampler-profile bits forced off (bits 5
    and 6 off = the exact tiled ordered pass)."""
    from ckrenderengine_tpu_torch.pipeline import frame as fr

    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    sp = list(params["sampler_profile"])
    for b in profile_off:
        sp[b] = False
    params = dict(params, sampler_profile=tuple(sp))
    dev = rc.context.device
    return fr.render_frame_packed(
        static, torch.as_tensor(dyn_f, device=dev),
        torch.as_tensor(dyn_i, device=dev), **params, want_stats=True)


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def render_config(build, O, device, **kw):
    ctx, rc, mover = build(O, device=device, **kw)
    rc.Render()
    return ctx, rc, mover


def frame_checks(name, rc):
    fb = rc.fb
    check(tuple(fb.shape) == (4, rc.height, rc.width),
          f"{name}: framebuffer shape {tuple(fb.shape)}")
    finite = bool(torch.isfinite(fb).all())
    clear = torch.as_tensor(rc.background_color, device=fb.device)
    covered = float((fb != clear[:, None, None]).any(0).float().mean())
    check(finite, f"{name}: non-finite framebuffer")
    check(covered > 0.01, f"{name}: framebuffer is all clear colour")
    return finite, covered


def winners(rc):
    return frame_with(rc)[2]["WinnerIds"].cpu().numpy()


def reset_launches(mods):
    for fn in mods:
        fn.launches = 0


def main() -> int:
    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # The port itself; without it (the script alone) the import fails here,
    # before any result is printed.
    sys.path.insert(0, ROOT)
    from ckrenderengine_tpu_torch import cuda_build, scenes
    import ckrenderengine_tpu_torch.objects as O
    from ckrenderengine_tpu_torch.pipeline import frame as fr
    from ckrenderengine_tpu_torch.raster import (
        cuda_ordered as co, cuda_reduce, cuda_tiled,
    )
    from ckrenderengine_tpu_torch.raster import deferred as df

    card = card_line()
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    kernel_fns = {"B1": cuda_tiled.solve_tiled_kernel,
                  "B2": cuda_reduce.reduce_flat_kernel,
                  "B3": co.blend_kernel, "B4": co.peel_kernel}

    # --- 2. build ----------------------------------------------------------
    lib = cuda_build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    emit("build", seconds=round(lib.build_seconds, 3), library=os.path.relpath(
        lib.path, ROOT), ptxas=ptxas)

    # --- 3. kernel parity on the card --------------------------------------
    errs = {"B1": [
        compare_b1("solve_fixture", 320, 512),
        compare_b1("tiny_caps", 128, 128, seed=4, T=1200, g_cap=16,
                   slab_cap=64, pair_cap=64),
        compare_b1("clip_planes", 320, 512, seed=6, planes=2),
        compare_b1("kept_zbuffer", 320, 512, seed=7, kept_zb=True),
        compare_b1("non_divisible", 200, 300, seed=8, T=3000),
    ], "B2": [compare_b2()]}
    errs["B3"] = [compare_b3(*case) for case in blend_fixtures()]
    errs["B4"] = [compare_b4(*case) for case in peel_fixtures()]

    # --- 4. main path through Render() -------------------------------------
    # Each path runs with every launch count at 0 and is read right after.
    launches = dict.fromkeys(kernel_fns, 0)
    configs = {}
    for name, build, kernels in (
            ("config1", scenes.build_config1, ("B2",)),
            ("config2", scenes.build_config2, ("B1",)),
            ("config5", scenes.build_config5, ("B1",)),
            ("alpha50k", scenes.build_alpha50k, ("B1", "B3")),
            ("alpha_tex50k", scenes.build_alpha_tex50k, ("B1", "B4"))):
        reset_launches(kernel_fns.values())
        t0 = time.monotonic()
        ctx, rc, mover = render_config(build, O, "cuda")
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        got = {k: fn.launches for k, fn in kernel_fns.items()}
        for k in launches:
            launches[k] += got[k]
        finite, covered = frame_checks(name, rc)
        for k in kernels:
            check(got[k] > 0, f"{name}: the frame did not launch {k}")
        configs[name] = (ctx, rc, mover)
        extra = {}
        if rc._compiled.ordered_cap:
            stats = rc.GetStats()
            check(stats.OrderedReplays == 0, f"{name}: ordered replay")
            scene, batch, _su, defer, bits = fr.packed_setup(
                *packed_cuda(rc))
            ob = fr.ordered_batch(scene, batch, defer, bits,
                                  rc._compiled.ordered_cap)
            pa = co.phase_a(*ordered_fields(ob, scene), rc.zb, rc.height,
                            rc.width)
            extra = dict(ordered_tris=int(ob.valid.sum()),
                         ordered_cap=int(rc._compiled.ordered_cap),
                         live_pairs=int(pa["n_live"]),
                         replays=stats.OrderedReplays,
                         peel_rounds=stats.OrderedPeelRounds)
            if "B4" in kernels:
                # Covering fragments per pixel: the rounds the peel needs
                # (a sheet folding over itself can stack more than the
                # scene's 4 sheets on a pixel; the reference's geometry
                # does the same, and its iterated peel runs those rounds).
                cnt = co.peel_phase_b(
                    pa["stream"], pa["starts"], pa["counts"],
                    co._params(scene.viewport, rc.height, rc.width,
                               dev="cuda"), 0, pa["zplane"], 32,
                    pa["tiles_x"], pa["tiles_y"],
                    pa["n_planes"])[2][:rc.height, :rc.width]
                deep = torch.nonzero(cnt > 4)[:8].cpu().tolist()
                need = max(1, -(-int(cnt.max()) // 4))
                extra.update(fragments_per_pixel=torch.bincount(
                    cnt.reshape(-1).long()).cpu().tolist(),
                    pixels_deeper_than_k=deep, rounds_needed=need)
                check(stats.OrderedPeelRounds == need,
                      f"{name}: {stats.OrderedPeelRounds} peel rounds")
        emit("main_path", config=name, size=[rc.width, rc.height],
             triangles=int(rc._compiled.n_valid_tris), finite=finite,
             covered=covered, launches=got,
             first_frame_s=round(first_s, 3), **extra)

    # --- 5. replay of an overflowing ordered frame on the card -------------
    _c, rc_p, _m = build_panes(O, device="cuda")
    rc_p.Render()
    fb_k, zb_k, st_k = frame_with(rc_p)
    fb_x, zb_x, st_x = frame_with(rc_p, profile_off=(5, 6))
    same = bool(torch.equal(fb_k, fb_x) and torch.equal(zb_k, zb_x))
    emit("replay", scene="panes70", size=[rc_p.width, rc_p.height],
         ordered_cap=int(rc_p._compiled.ordered_cap),
         render_replays=rc_p.GetStats().OrderedReplays,
         frame_replays=st_k["OrderedReplays"], equals_exact_pass=same)
    check(rc_p.GetStats().OrderedReplays == 1 and st_k["OrderedReplays"] == 1
          and st_x["OrderedReplays"] == 0, "replay: not counted")
    check(same, "replay: the frame differs from render_pass_tiled's")

    # --- 6. kernel frames against the exact pass, and against the CPU ------
    small = (("alpha50k_small", scenes.build_alpha50k,
              dict(width=256, height=192, n_sheets=6, sheet_n=15), 1e-4),
             ("alpha_tex50k_small", scenes.build_alpha_tex50k,
              dict(width=256, height=192, n_sheets=4, sheet_n=14), 0.02))
    for name, build, kw, tol in small:
        _c, rc_g, _m = render_config(build, O, "cuda", **kw)
        fb_k, _zk, st_k = frame_with(rc_g)
        fb_x, _zx, st_x = frame_with(rc_g, profile_off=(5, 6))
        err = float((fb_k - fb_x).abs().max())
        emit("exact_pass", config=name, size=[rc_g.width, rc_g.height],
             ordered_cap=int(rc_g._compiled.ordered_cap),
             fb_max_abs_diff=err, tolerance=tol,
             peel_rounds=st_k["OrderedPeelRounds"])
        check(st_k["OrderedReplays"] == 0, f"{name}: replayed")
        check(err <= tol, f"{name}: kernel frame vs exact pass {err}")
        _c, rc_c, _m = render_config(build, O, "cpu", **kw)
        diff = float(np.abs(rc_g.framebuffer() - rc_c.framebuffer()).max())
        emit("cpu_reference", config=name, fb_max_abs_diff=diff,
             tolerance=2e-6)
        check(diff <= 2e-6, f"{name}: card and CPU frames disagree {diff}")

    # The same frames on the CPU (plain versions) at small sizes: >= 99.9%
    # equal winners (cuBLAS and the CPU may round a 4x4 matrix product
    # apart by an ULP), framebuffers within 1/255 where the winners agree.
    for name, build, kw in (
            ("config1", scenes.build_config1, dict(size=256)),
            ("config5_small", scenes.build_config5,
             dict(width=256, height=192, terrain_n=70, n_balls=8))):
        _, rc_g, _ = render_config(build, O, "cuda", **kw)
        _, rc_c, _ = render_config(build, O, "cpu", **kw)
        ids_g, ids_c = winners(rc_g), winners(rc_c)
        eq = ids_g == ids_c
        fb_diff = float(np.abs(rc_g.framebuffer() - rc_c.framebuffer())[
            eq].max())
        emit("cpu_reference", config=name, ids_equal_frac=float(eq.mean()),
             fb_max_abs_diff_matching=fb_diff)
        check(eq.mean() >= 0.999 and fb_diff <= 1.0 / 255.0,
              f"{name}: card and CPU frames disagree")

    # --- 7. golden frames (reference package, CPU) --------------------------
    for frame, build, kw in (
            ("config2_320x240", scenes.build_config2,
             dict(width=320, height=240)),
            ("alpha_320x240", scenes.build_alpha50k, dict(
                width=320, height=240, n_sheets=4, sheet_n=11))):
        g = np.load(os.path.join(GOLDEN_DIR, frame + ".npz"))
        _, rc_g, _ = render_config(build, O, "cuda", **kw)
        ids = winners(rc_g)
        rgba = rc_g.BackToFront()
        match = ids == g["ids"]
        diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32))
        emit("golden", frame=frame, ids_equal_frac=float(match.mean()),
             rgba_max_diff_matching=int(diff[match].max()),
             rgba_max_diff=int(diff.max()))
        check(match.mean() >= 0.999, f"golden {frame}: winner ids differ")
        check(int(diff[match].max()) <= 1, f"golden {frame}: image differs")

    # --- 8. timing (informational) -----------------------------------------
    # Frames per second through Render(): 2 warm-up ticks, then 30 ticks of
    # (rotate the config's mover, Render()), fenced by synchronize().
    n = 30
    fps = {}
    for name, angle in (("config1", 0.02), ("config2", 0.03),
                        ("config5", 0.01), ("alpha50k", 0.02),
                        ("alpha_tex50k", 0.02)):
        _ctx, rc_t, mover = configs[name]
        for _ in range(2):
            mover.Rotate((0, 1, 0), angle)
            rc_t.Render()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            mover.Rotate((0, 1, 0), angle)
            rc_t.Render()
        torch.cuda.synchronize()
        fps[name] = n / (time.monotonic() - t0)
        emit("fps", config=name, card=card, fps=fps[name], frames=n,
             size=[rc_t.width, rc_t.height])
    rc5 = configs["config5"][1]

    static, dyn_f, dyn_i, params = packed_cuda(rc5)
    H, W = rc5.height, rc5.width
    st = {}
    st["setup_ms"] = cuda_ms(lambda: fr.packed_setup(static, dyn_f, dyn_i,
                                                     params), 5)
    scene, batch, setup, defer, _bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                        params)
    caps = fr._solve_caps(batch.valid.shape[0], None)
    st["phase_a_ms"] = cuda_ms(lambda: cuda_tiled.phase_a(
        setup, defer, scene.viewport, batch.xyw, H, W, **caps), 5)
    a = cuda_tiled.phase_a(setup, defer, scene.viewport, batch.xyw, H, W,
                           **caps)
    init = cuda_tiled._init_plane(scene.clear_z, H, W, a["tiles_y"] * 32,
                                  a["tiles_x"] * 32, "cuda")
    b1_args = (a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
               a["sbase"], scene.viewport, W, H, init, 32, a["tiles_x"],
               a["tiles_y"], a["n_planes"], False)
    st["b1_ms"] = cuda_ms(lambda: cuda_tiled.solve_tiled_kernel(*b1_args), 20)
    st["b1_plain_ms"] = cuda_ms(
        lambda: cuda_tiled.solve_phase_b_plain(*b1_args), 3)
    out_k = cuda_tiled.solve_tiled_kernel(*b1_args)
    out_p = cuda_tiled.solve_phase_b_plain(*b1_args)
    b1_frame_ok = (torch.equal(out_k[0], out_p[0])
                   and torch.equal(out_k[1], out_p[1]))
    check(b1_frame_ok, "B1 kernel and plain version disagree at config-5 "
          "frame shapes")
    best_id, _bd, _pk = cuda_tiled.depth_reduce_tiled_cuda(
        setup, defer, scene.clear_z, scene.viewport, batch.xyw, H, W, **caps)
    clear_fb = scene.clear_color[:, None, None].expand(4, H, W)
    st["shade_ms"] = cuda_ms(lambda: df.shade_deferred(
        best_id, batch.xyw, batch.z, batch.color, batch.specular, batch.uv,
        batch.fog, batch.state_idx, scene.state_i, scene.state_f,
        scene.tex_planes, scene.tex_hw, scene.fog_color, clear_fb, H, W,
        sampler_profile=params["sampler_profile"],
        tex_quad=scene.tex_quad), 5)
    emit("timing", config="config5", card=card, fps=fps["config5"], frames=n,
         **{k: round(v, 4) for k, v in st.items()},
         binstats=a["binstats"].cpu().tolist(),
         note="stage times are CUDA-event means of the stage alone")

    # B2 at config-1 frame shapes.
    rc1 = configs["config1"][1]
    sc1, bt1, su1, de1, _b1 = fr.packed_setup(*packed_cuda(rc1))
    rows1 = cuda_reduce.pack_rows(su1, de1)
    b2_args = (rows1, sc1.clear_z, sc1.viewport, rc1.height, rc1.width)
    b2_ms = cuda_ms(lambda: cuda_reduce.reduce_flat_kernel(*b2_args), 20)
    b2_plain_ms = cuda_ms(lambda: cuda_reduce.depth_reduce_plain(*b2_args), 5)
    k1 = cuda_reduce.reduce_flat_kernel(*b2_args)
    p1_ = cuda_reduce.depth_reduce_plain(*b2_args)
    check(torch.equal(k1[0], p1_[0]) and torch.equal(k1[1], p1_[1]),
          "B2 kernel and plain version disagree at config-1 frame shapes")

    # B3 and B4 at the stress frames' shapes, with phase A and composite.
    ordered_ms = {}
    for name, kernel in (("alpha50k", "B3"), ("alpha_tex50k", "B4")):
        ordered_ms[kernel] = time_ordered(name, kernel, configs[name][1],
                                          fps[name], card, fr, co)

    ms = {"B1": (st["b1_ms"], st["b1_plain_ms"]), "B2": (b2_ms, b2_plain_ms),
          **ordered_ms}
    sources = {"B1": ("solve_tiled", "csrc/solve_tiled.cu",
                      "ckrenderengine_tpu/raster/pallas_tiled.py:61"),
               "B2": ("reduce_flat", "csrc/reduce_flat.cu",
                      "ckrenderengine_tpu/raster/pallas_reduce.py:61"),
               "B3": ("ordered_blend", "csrc/ordered_blend.cu",
                      "ckrenderengine_tpu/raster/pallas_ordered.py:89"),
               "B4": ("ordered_peel", "csrc/ordered_peel.cu",
                      "ckrenderengine_tpu/raster/pallas_ordered.py:518")}
    kernels = [
        {"name": f"{k} {sources[k][0]}", "route": "cuda",
         "source": "ckrenderengine_tpu_torch/" + sources[k][1],
         "replaces": sources[k][2], "launches": launches[k],
         "max_abs_err": max(errs[k]), "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in ("B1", "B2", "B3", "B4")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def packed_cuda(rc):
    """rc's packed frame inputs with the two buffers on the card."""
    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    return (static, torch.as_tensor(dyn_f, device="cuda"),
            torch.as_tensor(dyn_i, device="cuda"), params)


def ordered_fields(ob, scene):
    """The phase-A inputs of an ordered batch, in the entries' order."""
    return (ob.xyw, ob.z, ob.valid, ob.color, ob.specular, ob.uv, ob.fog,
            ob.state_idx, ob.clip_rect, ob.clipd, scene.state_i,
            scene.state_f)


def time_ordered(name, kernel, rc, fps, card, fr, co):
    """CUDA-event times of the ordered stages at a stress frame's shapes:
    phase A, the kernel and its plain version (checked equal there), and
    the composite. Returns (kernel ms, plain ms)."""
    static, dyn_f, dyn_i, params = packed_cuda(rc)
    H, W = rc.height, rc.width
    scene, batch, _su, defer, bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                     params)
    ob = fr.ordered_batch(scene, batch, defer, bits, rc._compiled.ordered_cap)
    fields = ordered_fields(ob, scene)
    zb, fb = rc.zb, rc.fb
    st = {"phase_a_ms": cuda_ms(lambda: co.phase_a(*fields, zb, H, W), 5)}
    pa = co.phase_a(*fields, zb, H, W)
    tx, ty = pa["tiles_x"], pa["tiles_y"]
    if kernel == "B3":
        args = (pa["stream"], pa["starts"], pa["counts"],
                co._params(scene.viewport, H, W, scene.fog_color, "cuda"),
                pa["zplane"], 32, tx, ty, pa["n_planes"])
        kfn, pfn = co.blend_kernel, co.blend_phase_b_plain
        ab = kfn(*args)[:, :H, :W]
        st["composite_ms"] = cuda_ms(lambda: ab[0:4] * fb + ab[4:8], 20)
    else:
        args = (pa["stream"], pa["starts"], pa["counts"],
                co._params(scene.viewport, H, W, dev="cuda"), 0,
                pa["zplane"], 32, tx, ty, pa["n_planes"])
        kfn, pfn = co.peel_kernel, co.peel_phase_b_plain
        lids, les, _c, _o = kfn(*args)
        lids, les = lids[:, :H, :W], les[:, :, :H, :W]
        sp = params["sampler_profile"]
        st["composite_ms"] = cuda_ms(lambda: fr._composite_peeled(
            fb, ob, lids, les, scene, sp, H, W), 5)
    st["kernel_ms"] = cuda_ms(lambda: kfn(*args), 20)
    st["plain_ms"] = cuda_ms(lambda: pfn(*args), 2)
    out_k, out_p = kfn(*args), pfn(*args)
    if kernel == "B3":
        out_k, out_p = (out_k,), (out_p,)
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          f"{kernel} kernel and plain version disagree at {name} shapes")
    emit("timing", config=name, card=card, fps=fps, kernel=kernel,
         live_pairs=int(pa["n_live"]), stream_rows=int(pa["stream"].shape[0]),
         max_tile_rows=int(pa["counts"].max()),
         **{k: round(v, 4) for k, v in st.items()},
         note="stage times are CUDA-event means of the stage alone")
    return st["kernel_ms"], st["plain_ms"]


if __name__ == "__main__":
    sys.exit(main())
