"""Frame rates and per-frame device launches of the smoke scenes (the five
BASELINE configs, config 4 without its patch sheet, the two stress scenes,
each of the seven again with Antialias on, config 2 with a stencil-only
mesh, config 5 with 3D sprites, curves and lines, ``config5_fx``, with
material effects, ``config5_mat``, and with user vertex and pixel shaders,
``config5_shaded``), for comparing two trees of this package on one card.

    python3 ckrenderengine_tpu_torch/frame_bench.py --root . --out a.json
    python3 ckrenderengine_tpu_torch/frame_bench.py --root _parent --out b.json

``--root`` is the directory that holds the ``ckrenderengine_tpu_torch``
package to measure (this tree, or an unpacked ``git archive`` of another
commit: archive ``ckrenderengine_tpu_torch`` AND ``native``, whose C++
mesh optimizer the scene compile falls back from to minutes of Python);
the script itself uses only what every tree of the port has (a scene
whose build function or ``antialias`` keyword a tree lacks is left out of
that tree's run). Run
the trees in turns inside one call (parent, change, change, parent): two
calls may land on two cards and hosts. For each scene it renders 2 warm-up
ticks and 30 timed ticks of (rotate the mover, or run config 3's or 4's
own tick, then ``Render()``), fenced by ``torch.cuda.synchronize()``, then
40 ticks synchronised before and after each (``frame_ms_median`` and
``_p75``) and the host's ``_fill_packed`` alone with the frame's 2D quad
lists (``fill_packed_ms``, median of 20), then profiles 3 more ticks with
``torch.profiler`` and counts what reached the card, with the mean time on
the card of each hand-written kernel the frames launched (``kernel_ms``; the
tiled solve is B5 when ``CK_FUSED_FETCH`` is set, B1 otherwise) and the
device's idle share (1 - device ms per frame / the frame median).
``--window W`` renders each scene's ticks through frame windows
(``SetFramePipelining(W)``; the first frame stays eager): each timed run
is a whole number of windows fenced by ``GetFrameFence()`` read back to the
host, the latency is a fenced window's wall-clock over W (median and p75 of
at least 5 windows), and the profile covers one window, its counts divided
by W. One call can so compare W = 1 and W = 8 on one tree.
``--batched N`` instead measures context batching
(``CKRenderManager.ProcessBatched``) on ``scenes.build_batched`` with N
contexts at 256x256, by the reference's protocol for
``contexts_per_sec_batched_Nx256`` (``bench.py:312-352``): two warm-up
batches, one timed batch that sets the count n (3 to 48 batches, about
4 s), then twice n batches, each after rotating the root 0.01 rad, fenced
by reading the last member's fb sum; the better rate. One more batch is
profiled: device ms and launches, host launch calls per context, the idle
share (1 - device ms per batch / the measured ms per batch), and each
group key's capture ms and graph pool MiB.
``--frames DIR`` also saves every scene's first frame (fb and zb) as ``.npy``
files, so two trees' frames can be compared bit for bit. ``--flat DIR``
first times the flat solve B2 alone (``reduce_flat_kernel``, its own time
on the card under ``torch.profiler``, checked equal to its plain version) on
four cases of ``raster/flat_fixtures.py`` (config 1's shape, and the
route's limits: ``flat_limit_256``, ``flat_deep_640``, ``flat_cap_128``) and
on config 1's shape with every row invalid (the kernel's floor) and with no
rows (its grid and the two planes alone). The cases' packed rows are saved
in DIR as ``.npz`` by the first run that finds them missing (the fixture
module of this script's own tree, loaded by path; the setup and the
packing of the ``--root`` tree) and loaded by every later run, so every
tree is timed on the same bits, also a tree that has no fixture module.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import faulthandler
import inspect
import json
import os
import subprocess
import sys
import time

TICKS = 30
# (name, build function, rotation of the mover per tick, keywords); the
# build functions of configs 3 and 4 return their tick in the mover's place.
_BASE = (("config1", "build_config1", 0.02),
         ("config2", "build_config2", 0.03),
         ("config5", "build_config5", 0.01),
         ("config3", "build_config3", None),
         ("config4", "build_config4", None),
         ("config4_skin", "build_config4_skin", None),
         ("alpha50k", "build_alpha50k", 0.02),
         ("alpha_tex50k", "build_alpha_tex50k", 0.02))
SCENES = tuple((name, build, angle, {}) for name, build, angle in _BASE) + \
    tuple((name + "_aa", build, angle, {"antialias": True})
          for name, build, angle in _BASE if name != "config4_skin") + \
    (("stencil", "build_stencil", 0.03, {}),
     ("config5_fx", "build_config5_fx", 0.01, {}),
     ("config5_mat", "build_config5_mat", 0.01, {}),
     ("config5_shaded", "build_config5_shaded", 0.01, {}))
KERNELS = ("solve_tiled_kernel", "reduce_flat_kernel", "ordered_blend_kernel",
           "ordered_peel_kernel", "lines_kernel", "line_bins_kernel")
FLAT_CASES = ("config1_pad", "flat_limit_256", "flat_deep_640", "flat_cap_128")


# A torch.profiler window on the H100 now and then loses the device records
# near its ends, at times every record of a short window. Windows that open
# PROFILE_PAD_S before the first call and close PROFILE_PAD_S after the last
# synchronise keep them; a window that still comes back short is profiled
# again, up to PROFILE_TRIES times. PROFILE_WINDOWS counts the windows and
# the repeats, for the "profiler_windows" line.
PROFILE_PAD_S = 0.05
PROFILE_TRIES = 3
PROFILE_WINDOWS = {"windows": 0, "repeated": 0, "short_kept": 0,
                   "short": []}


def profile_window(fn, reps: int, activities, complete,
                   label: str = "") -> tuple:
    """``(prof, wall_ms)``: a padded ``torch.profiler`` window of ``reps``
    calls of ``fn()`` after one warm-up call, profiled again while
    ``complete(prof)`` is false; the wall time per call is the calls' own,
    the profiler's overhead included and the padding not. Each short try
    is listed in ``PROFILE_WINDOWS["short"]`` by ``label`` and its event
    count."""
    import torch
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    PROFILE_WINDOWS["windows"] += 1
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.monotonic()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / reps
            time.sleep(PROFILE_PAD_S)
        if complete(prof):
            return prof, wall_ms
        PROFILE_WINDOWS["repeated"] += 1
        PROFILE_WINDOWS["short"].append([label, len(prof.events())])
    PROFILE_WINDOWS["short_kept"] += 1
    return prof, wall_ms


def device_us(events):
    return sum(e.device_time_total if hasattr(e, "device_time_total")
               else e.cuda_time_total for e in events)


def profiled_kernels(prof) -> dict:
    """Device launches of each hand-written kernel in a profile: B5 is the
    tiled solve's fetch instantiation (its second template argument), L1
    the line pass's draw and L1_bins its bin step."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(("B1", "B2", "B3", "B4", "B5", "L1", "L1_bins"), 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if "solve_tiled_kernel<" in e.name:
            args = e.name.split("solve_tiled_kernel<", 1)[1].split(">", 1)[0]
            fetch = args.split(",")[1].strip() in ("true", "1", "(bool)1")
            out["B5" if fetch else "B1"] += 1
        elif "reduce_flat_kernel" in e.name:
            out["B2"] += 1
        elif "ordered_blend_kernel" in e.name:
            out["B3"] += 1
        elif "ordered_peel_kernel" in e.name:
            out["B4"] += 1
        elif "lines_kernel" in e.name:
            out["L1"] += 1
        elif "line_bins_kernel" in e.name:
            out["L1_bins"] += 1
    return out


def host_launch_calls(prof) -> int:
    """The runtime calls that put work on the card (graph launches, kernel
    launches, copies) in a profile: what the host sends to the card."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type != DeviceType.CUDA
               and e.name.startswith(("cudaGraphLaunch", "cudaLaunchKernel",
                                      "cudaMemcpy", "cuLaunchKernel")))


def batched_pass(rm, rcs, root, reps: int = 2, min_batches: int = 3,
                 target_s: float = 4.0) -> dict:
    """``rm.ProcessBatched()`` of the group ``rcs`` (``scenes.build_batched``
    on the card) by the reference's protocol (module docstring): ``reps``
    timed runs of n batches, n = ``target_s`` over one batch's time,
    clamped to [``min_batches``, 48]. Returns the rates and the profile's
    figures; ``keys`` lists every batch graph captured in the pass and the
    group's current one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.pipeline import window as fw

    captured = []
    capture = fw.FrameWindow._capture

    def spy_capture(self, slot):
        capture(self, slot)
        captured.append(self)

    fw.FrameWindow._capture = spy_capture
    n_ctx = len(rcs)
    try:
        def fence():
            return float(rcs[-1].fb.sum())

        # The second warm-up batch runs at the caps the governor planned
        # from the first (a new capture), out of the timed runs.
        for _ in range(2):
            rm.ProcessBatched()
            fence()
        t0 = time.perf_counter()
        rm.ProcessBatched()
        fence()
        batch_s = max(time.perf_counter() - t0, 1e-4)
        n = max(min_batches, min(48, int(target_s / batch_s)))
        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _i in range(n):
                root.Rotate((0, 1, 0), 0.01)
                rm.ProcessBatched()
            fence()
            rates.append(n * n_ctx / (time.perf_counter() - t0))

        def one():
            root.Rotate((0, 1, 0), 0.01)
            rm.ProcessBatched()
            fence()

        prof, wall_ms = profile_window(
            one, 1, [ProfilerActivity.CUDA],
            lambda p: profiled_kernels(p)["B1"] + profiled_kernels(p)["B2"]
            + profiled_kernels(p)["B5"] >= n_ctx, label=f"batched_{n_ctx}")
    finally:
        fw.FrameWindow._capture = capture
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = device_us(dev) / 1e3
    best = max(rates)
    batch_ms = n_ctx / best * 1e3
    graphs = {id(w): w for w in captured + [rcs[0]._batch]}
    return {
        "contexts": n_ctx, "size": [rcs[0].width, rcs[0].height],
        "antialias": bool(rm.options.get("Antialias", 0)),
        "batches_timed": n, "contexts_per_sec": best,
        "contexts_per_sec_runs": rates, "batch_ms": batch_ms,
        "profiled_batch_wall_ms": wall_ms,
        "device_ms_per_context": dev_ms / n_ctx,
        "device_launches_per_context": len(dev) / n_ctx,
        "host_launch_calls_per_context": host_launch_calls(prof) / n_ctx,
        "device_idle_share": 1.0 - dev_ms / batch_ms,
        "profiled_kernels": profiled_kernels(prof),
        "keys": [{"capture_ms": w.capture_ms,
                  "pool_mib": w.pool_bytes / 2 ** 20}
                 for w in graphs.values()],
        "solve_caps": list(rcs[0]._solve_caps or ())}


def flat_inputs(dirname: str) -> dict:
    """{case: (rows, clear_z, viewport, h, w)} on the card, from DIR's
    ``.npz`` files, made first where missing."""
    import importlib.util

    import numpy as np
    import torch

    os.makedirs(dirname, exist_ok=True)
    path = {n: os.path.join(dirname, n + ".npz") for n in FLAT_CASES}
    missing = [n for n in FLAT_CASES if not os.path.exists(path[n])]
    if missing:
        spec = importlib.util.spec_from_file_location(
            "flat_fixtures_of_this_tree", os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "raster",
                "flat_fixtures.py"))
        fixtures = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fixtures)
        for case in fixtures.flat_cases():
            if case["name"] in missing:
                np.savez(path[case["name"]],
                         rows=fixtures.case_rows(case).cpu().numpy(),
                         view=np.asarray(case["viewport"]
                                         + [case["clear_z"]], np.float32),
                         hw=np.asarray([case["h"], case["w"]]))
    out = {}
    for name in FLAT_CASES:
        f = np.load(path[name])
        view = torch.as_tensor(f["view"], device="cuda")
        h, w = (int(v) for v in f["hw"])
        out[name] = (torch.as_tensor(f["rows"], device="cuda"),
                     float(f["view"][4]), view[:4], h, w)
    return out


def flat_pass(dirname: str, reps: int = 20) -> dict:
    """B2's own mean time on the card per case, and on config 1's shape
    with every row invalid (the floor) and with no rows (the grid alone),
    after one warm-up launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.raster.cuda_reduce import (
        depth_reduce_plain, reduce_flat_kernel,
    )

    inputs = flat_inputs(dirname)
    rows, *rest = inputs["config1_pad"]
    floor = rows.clone()
    floor[:, 20] = 0.0
    inputs["config1_pad_floor"] = (floor, *rest)
    inputs["config1_pad_no_rows"] = (rows[:0], *rest)
    out = {}
    for name, args in inputs.items():
        k = reduce_flat_kernel(*args)
        p = depth_reduce_plain(*args)
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError(f"B2 and its plain version disagree at "
                                 f"{name}")

        def launches(prof):
            return [e for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "reduce_flat_kernel" in e.name]

        prof, _wall = profile_window(
            lambda: reduce_flat_kernel(*args), reps, [ProfilerActivity.CUDA],
            lambda p: len(launches(p)) == reps)
        ev = launches(prof)
        out[name] = {"kernel_ms": device_us(ev) / 1e3 / max(len(ev), 1),
                     "launches_timed": len(ev),
                     "tris": int(args[0].shape[0]),
                     "size": [args[4], args[3]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", default=None)
    ap.add_argument("--flat", default=None)
    ap.add_argument("--window", type=int, default=1)
    ap.add_argument("--batched", type=int, default=0)
    args = ap.parse_args()
    window = max(1, args.window)
    # A run that stalls says where: every 120 s all stacks go to stderr.
    faulthandler.dump_traceback_later(120, repeat=True)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("frame_bench: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from ckrenderengine_tpu_torch import scenes
    import ckrenderengine_tpu_torch.objects as O

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "card": card, "ticks": TICKS, "window": window,
           "fused_fetch": bool(os.environ.get("CK_FUSED_FETCH")),
           "scenes": {}}

    if args.flat:
        out["flat"] = flat_pass(args.flat)
        print(json.dumps({"root": args.root, "flat": out["flat"]}),
              flush=True)
    if args.batched:
        res = batched_pass(*scenes.build_batched(O, args.batched, 256,
                                                 device="cuda"))
        out["batched"] = res
        print(json.dumps({"root": args.root, "card": card, "batched": res}),
              flush=True)
    for name, build, angle, kw in SCENES if not args.batched else ():
        if not hasattr(scenes, build) or not set(kw) <= set(
                inspect.signature(getattr(scenes, build)).parameters):
            continue
        _ctx, rc, mover = getattr(scenes, build)(O, device="cuda", **kw)
        rc.Render()
        torch.cuda.synchronize()
        if args.frames:
            os.makedirs(args.frames, exist_ok=True)
            np.save(os.path.join(args.frames, name + "_fb.npy"),
                    rc.fb.cpu().numpy())
            np.save(os.path.join(args.frames, name + "_zb.npy"),
                    rc.zb.cpu().numpy())

        def step():
            if angle is None:
                mover()
            else:
                mover.Rotate((0, 1, 0), angle)
            rc.Render()

        def fence():
            if window > 1:
                rc.GetFrameFence().cpu()
            torch.cuda.synchronize()

        def tick():
            """One frame, or with --window one fenced window of frames."""
            for _ in range(window):
                step()
            fence()

        rc.SetFramePipelining(window)
        for _ in range(2):
            tick()
        torch.cuda.synchronize()
        rounds = -(-TICKS // window)
        t0 = time.monotonic()
        for _ in range(rounds):
            for _ in range(window):
                step()
        fence()
        fps = rounds * window / (time.monotonic() - t0)
        lat = []
        for _ in range(max(5, 40 // window)):
            t1 = time.monotonic()
            tick()
            lat.append((time.monotonic() - t1) * 1e3 / window)
        fill = []
        quads = rc._quad_lists()
        for _ in range(20):
            t1 = time.monotonic()
            rc._fill_packed(*quads)
            fill.append((time.monotonic() - t1) * 1e3)
        reps = 1 if window > 1 else 3
        prof, _wall = profile_window(
            tick, reps, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
            lambda p: any(e.device_type == DeviceType.CUDA
                          for e in p.events()))
        frames = reps * window
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev_us = device_us(dev)
        by_kernel = {k: [e for e in dev if k in e.name] for k in KERNELS}
        median = float(np.median(lat))
        out["scenes"][name] = {
            "fps": fps, "size": [rc.width, rc.height],
            "frame_ms_median": median,
            "frame_ms_p75": float(np.percentile(lat, 75)),
            "fill_packed_ms": float(np.median(fill)),
            "device_launches_per_frame": len(dev) / frames,
            "device_ms_per_frame": dev_us / 1e3 / frames,
            "device_idle_share": 1.0 - dev_us / 1e3 / frames / median,
            "kernel_ms": {k: device_us(ev) / 1e3 / len(ev)
                          for k, ev in by_kernel.items() if ev}}
        print(json.dumps({"root": args.root, "scene": name,
                          **out["scenes"][name]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
