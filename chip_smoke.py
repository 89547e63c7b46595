"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``ckrenderengine_tpu_torch`` from
``ckrenderengine_tpu_torch/csrc``, holds each kernel against its plain torch
version on the card, drives BASELINE configs 1, 2 and 5 through the CK entry
points (``CKContext(device="cuda")`` -> ``CreateRenderContext`` ->
``Render()``), checks the config-2 frame against the golden frame the
reference package rendered (``tests/torch_golden/config2_320x240.npz``),
and times config 5. Every phase prints a line; any failure raises, so the
exit code is nonzero. The last line is the device record
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
GOLDEN = os.path.join(ROOT, "tests", "torch_golden", "config2_320x240.npz")


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
    from ckrenderengine_tpu_torch.pipeline import frame as fr

    static, dyn_f, dyn_i, params = rc._fill_packed([], [])
    dev = rc.context.device
    fb, zb, stats = fr.render_frame_packed(
        static, torch.as_tensor(dyn_f, device=dev),
        torch.as_tensor(dyn_i, device=dev), **params, want_stats=True)
    return stats["WinnerIds"].cpu().numpy()


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
    from ckrenderengine_tpu_torch.raster import cuda_reduce, cuda_tiled
    from ckrenderengine_tpu_torch.raster import deferred as df

    card = card_line()
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # --- 2. build ----------------------------------------------------------
    lib = cuda_build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    emit("build", seconds=round(lib.build_seconds, 3), library=os.path.relpath(
        lib.path, ROOT), ptxas=ptxas)

    # --- 3. kernel parity on the card --------------------------------------
    errs_b1 = [
        compare_b1("solve_fixture", 320, 512),
        compare_b1("tiny_caps", 128, 128, seed=4, T=1200, g_cap=16,
                   slab_cap=64, pair_cap=64),
        compare_b1("clip_planes", 320, 512, seed=6, planes=2),
        compare_b1("kept_zbuffer", 320, 512, seed=7, kept_zb=True),
        compare_b1("non_divisible", 200, 300, seed=8, T=3000),
    ]
    err_b2 = compare_b2()

    # --- 4. main path through Render() -------------------------------------
    cuda_tiled.solve_tiled_kernel.launches = 0
    cuda_reduce.reduce_flat_kernel.launches = 0
    configs = {}
    for name, build, kw, kernel in (
            ("config1", scenes.build_config1, {}, "B2"),
            ("config2", scenes.build_config2, {}, "B1"),
            ("config5", scenes.build_config5, {}, "B1")):
        b1_0 = cuda_tiled.solve_tiled_kernel.launches
        b2_0 = cuda_reduce.reduce_flat_kernel.launches
        t0 = time.monotonic()
        ctx, rc, mover = render_config(build, O, "cuda", **kw)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        finite, covered = frame_checks(name, rc)
        d_b1 = cuda_tiled.solve_tiled_kernel.launches - b1_0
        d_b2 = cuda_reduce.reduce_flat_kernel.launches - b2_0
        check((d_b2 if kernel == "B2" else d_b1) > 0,
              f"{name}: the frame did not launch {kernel}")
        configs[name] = (ctx, rc, mover)
        emit("main_path", config=name, size=[rc.width, rc.height],
             triangles=int(rc._compiled.n_valid_tris), finite=finite,
             covered=covered, launches_b1=d_b1, launches_b2=d_b2,
             first_frame_s=round(first_s, 3))
    launches = {"B1": cuda_tiled.solve_tiled_kernel.launches,
                "B2": cuda_reduce.reduce_flat_kernel.launches}

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

    # --- 5. golden frame (reference package, config 2 at 320x240) ----------
    g = np.load(GOLDEN)
    _, rc_g, _ = render_config(scenes.build_config2, O, "cuda", width=320,
                               height=240)
    ids = winners(rc_g)
    rgba = rc_g.BackToFront()
    match = ids == g["ids"]
    diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32))
    emit("golden", frame="config2_320x240", ids_equal_frac=float(
        match.mean()), rgba_max_diff_matching=int(diff[match].max()),
        rgba_max_diff=int(diff.max()))
    check(match.mean() >= 0.999, "golden: winner ids differ")
    check(int(diff[match].max()) <= 1, "golden: framebuffer differs")

    # --- 6. timing (informational) -----------------------------------------
    # Frames per second through Render(): 2 warm-up ticks, then 30 ticks of
    # (rotate the config's mover, Render()), fenced by synchronize().
    n = 30
    fps = {}
    for name, angle in (("config1", 0.02), ("config2", 0.03),
                        ("config5", 0.01)):
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

    static, dyn_f, dyn_i, params = rc5._fill_packed([], [])
    dyn_f = torch.as_tensor(dyn_f, device="cuda")
    dyn_i = torch.as_tensor(dyn_i, device="cuda")
    H, W = rc5.height, rc5.width
    st = {}
    st["setup_ms"] = cuda_ms(lambda: fr.packed_setup(static, dyn_f, dyn_i,
                                                     params), 5)
    scene, batch, setup, defer = fr.packed_setup(static, dyn_f, dyn_i, params)
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
    s1, f1, i1, p1 = rc1._fill_packed([], [])
    sc1, bt1, su1, de1 = fr.packed_setup(
        s1, torch.as_tensor(f1, device="cuda"),
        torch.as_tensor(i1, device="cuda"), p1)
    rows1 = cuda_reduce.pack_rows(su1, de1)
    b2_args = (rows1, sc1.clear_z, sc1.viewport, rc1.height, rc1.width)
    b2_ms = cuda_ms(lambda: cuda_reduce.reduce_flat_kernel(*b2_args), 20)
    b2_plain_ms = cuda_ms(lambda: cuda_reduce.depth_reduce_plain(*b2_args), 5)
    k1 = cuda_reduce.reduce_flat_kernel(*b2_args)
    p1_ = cuda_reduce.depth_reduce_plain(*b2_args)
    check(torch.equal(k1[0], p1_[0]) and torch.equal(k1[1], p1_[1]),
          "B2 kernel and plain version disagree at config-1 frame shapes")

    kernels = [
        {"name": "B1 solve_tiled", "route": "cuda",
         "source": "ckrenderengine_tpu_torch/csrc/solve_tiled.cu",
         "replaces": "ckrenderengine_tpu/raster/pallas_tiled.py:61",
         "launches": launches["B1"], "max_abs_err": max(errs_b1),
         "ms": st["b1_ms"], "plain_ms": st["b1_plain_ms"]},
        {"name": "B2 reduce_flat", "route": "cuda",
         "source": "ckrenderengine_tpu_torch/csrc/reduce_flat.cu",
         "replaces": "ckrenderengine_tpu/raster/pallas_reduce.py:61",
         "launches": launches["B2"], "max_abs_err": err_b2,
         "ms": b2_ms, "plain_ms": b2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
