"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``ckrenderengine_tpu_torch`` from
``ckrenderengine_tpu_torch/csrc`` (B1 tiled solve, B2 flat solve, B3 ordered
blend, B4 textured peel, B5 tiled solve with the fused winner-row fetch, L1
line pass: its bin step and its draw),
prints their registers, spills and resident CTAs per SM, holds each kernel
against its plain torch version on the card bit for bit (B1 and B5 also on
the stream cases of ``raster/tiled_fixtures.py``, B3 and B4 on every case
of ``raster/ordered_fixtures.py``, each at tiles of 32 and of 16 pixels, B2
on every case of ``raster/flat_fixtures.py`` at full size),
drives all five BASELINE configs whole — 1, 2, 3 (1,000 entities, a
moving point light, a HUD sprite and a text label), 4 (61,440 vertices
skinned to 128 bones, a keyed clip bound to the device, a Bezier patch
sheet of 36 patches at iteration 5) and 5 — and the two transparency
stress scenes (``alpha50k``, ``alpha_tex50k``) through the CK entry points
(``CKContext(device="cuda")`` -> ``CreateRenderContext`` -> ``Render()``),
checks config 3's HUD square and label against the sprite's colour and
the text's coverage, renders configs 2, 4 and 5 again with
``CK_FUSED_FETCH`` set (B5; the frame must equal the default path's bit
for bit), checks that a tick of the clip changes the skinned frame, runs
one skinned frame's animate, compose and skin stages under
``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
inside them), renders an odd-sized mip frame (the compact rows), checks an
overflowing ordered frame's in-frame replay, holds the kernel frames and
small frames of every config against the exact ordered pass and against
the CPU, checks the two golden frames the reference package rendered
(``tests/torch_golden/``), renders the seven scenes again with the
render manager's Antialias option on (each frame at twice its size,
resolved: B2 at config 1, B1 at the others, B3 and B4's rounds at the
stress scenes; B5 once at config 5 with its frame bit-equal; the AA
frames of configs 1, 2, 5 and ``alpha50k`` equal to the resolve of the
frame rendered at twice the size) and the stencil scenes (config 2 with a
stencil-only quad, with and without Antialias, and a flat one: the frame's
solve and the stencil's launch B1 or B2 twice, and the mask equals the
plain solve's on the card), renders the five configs, both stress scenes
and config 5 with Antialias in frame windows of 8 (``SetFramePipelining``;
the ``window`` phase: each frame one CUDA-graph replay, every window's
frames and fences bit-equal to the eager run's, no host synchronisation in
the replay loops, the kernels seen in every replay, a forced pair-cap
overflow and a too-small peel round count redone and then governed away),
renders the effects level (``scenes.build_config5_fx``: config 5 with
2,048 3D sprites and 1,192 line segments of curves, a wireframe grid and a
line list; the ``fx`` phase: B1, B4's rounds and L1 in every frame, B3 in
its place with untextured halos, each kernel equal to its plain version on
those frames' inputs (L1's bins equal to ``line_bins_plain``'s too), L1
also on seeded fixtures (a NaN alpha, a diagonal across the frame, a
segment through it from off screen, a fan of 2,100 segments through one
tile), L1 timed as the sum of its two launches beside the copy floor (the
draw with no row), a frame with Antialias,
the level cut to 320x240 against the CPU and the golden frame
``fx_320x240``, and 8 frames as graph replays in the ``window`` phase),
renders the material-effects level (``scenes.build_config5_mat``: config 5
with chrome TexGen on its spheres, cube-env TexGen on the annex crates, a
reflection-TexGen water sheet and a planar-TexGen plaza with a detail
channel and a cube-env reflection channel; the ``mat`` phase: B1 and B4's
rounds in each eager frame, B5 with its frame bit-equal and its 24-word
rows equal to B1 plus the gather, B4 equal to its plain version on the
plaza's stream, the reflection channel blended over at least 99.9% of its
base's pixels, a frame with Antialias, the ``effect_passes`` variant (DP3,
BumpEnv, 2- and 3-texture passes) through the exact tiled ordered pass,
the level cut to 320x240 against the CPU and the golden frame
``mat_320x240``, and 8 frames as graph replays in the ``window`` phase),
renders groups of render contexts through ``ProcessBatched`` (the
``batch`` phase: ``scenes.build_batched`` at 8 and 64 contexts of 256x256
and at 8 with Antialias, and the reference's one-triangle group at 3 x
48x48: each group one batch of one CUDA-graph replay per member, B1 or B2
once per member, every member bit-equal to its own eager ``Render()``,
contexts/sec by the reference's protocol with device ms, launches and
host launch calls per context),
renders the shaded level (``scenes.build_config5_shaded``: config 5 with a
travelling-wave vertex shader and a pixel shader; the ``shader`` phase: B1
without e-planes once per eager frame and nothing else, not even B5 under
``CK_FUSED_FETCH``, the per-pixel-gather shade with the stage, B1 equal to
its plain version on the frame's inputs and timed beside its bound, 8
frames as graph replays equal to the eager frames, a host-reading stage
refused in a window with an error naming it, the level cut to 320x240
with an alpha sheet in the flat ordered pass against the CPU and the
golden frame ``shader_320x240``, a batch of 8 contexts sharing one pixel
shader, a frame with Antialias),
drives the rasterizer HAL (the ``hal`` phase: ``raster/hal_fixtures``'s
call script of 1,026 immediate-mode triangles, a sprite, a framebuffer
copy and a screen backup on a 1024x768 ``CKRasterizerContext`` through
``render_pass`` and no hand-written kernel; a display-list replay, the
copy and the restore bit-equal to what they copy; the counters; the
driver table; the script cut to 290 triangles at 128x96 on the card
against the CPU; host ms
per sphere ``DrawPrimitive``, device ms and launches per triangle),
renders the monitor level in stereo (``scenes.build_config5_monitor``:
config 5 at 1024x768 with both eyes side by side, and a 512x384 producer
context rendering the level into the texture a screen in it samples; the
``monitor`` phase: B1 once per producer frame and once per eye, the
texture equal to the producer's frame, the feed and its mip levels in the
main frame's stack equal to their plain versions, the packed stereo path
equal to the eager fallback the live feed takes, B1 equal to its plain
version at an eye's inputs, device ms and launches per stereo and per
producer frame, and the level at 320x240 against the golden frame
``monitor_320x240``),
drives the render context and manager API over config 5 (the ``api``
phase: the screen backup, ``DrawScene`` over the kept depth with B1 equal
to its plain version, callbacks eagerly and in a window, ``DestroyDevice``,
``Process``),
draws over the level through the immediate path
(``scenes.build_config5_immediate``; the ``immediate`` phase: B1 once per
tick, then render-callback meshes, ``RenderTransparents``, Sprite3D
batches and a staging-VB HUD through ``DrawPrimitive``'s ``render_pass``,
pixels outside their boxes equal to the callback-free tick, ``Pick3D``
against the frame's winners, ``PickRect``, a precise pick through a
card's hole, and the draws at 128x96 equal on the card and the CPU),
steps through the debugged level (``scenes.build_config5_debug``: config
5 under ``EnableDebugMode`` with a shown 64x64 grid, a 16-bone skinned
arm driven by a ``CKKinematicChain`` and the PV watermark; the ``debug``
phase: B1, L1 and its bin step once on the stepped tick and each equal
to its plain version there, pixels outside the label's and the watermark's boxes
equal to the tick without the debug mode, a k = 0 frame of the clear
colour only, ``DebugStep``'s walk, the IK targets reached, the grid's
coordinate round trip, ``RadixSorter`` over the level's view depths,
``NvStripifier`` and ``PlaceFitter`` on the terrain, and the tick at
128x96 equal on the card and the CPU),
saves and reloads a DXT-textured level (``scenes.build_config5_io``:
config 5 with a DXT1 DDS checker carrying a mip chain, DXT3 sphere skins
from ``SetCompressedImage``, 12 alpha-over signs from a DXT5 DDS file and
the shared sphere a progressive mesh at half of its vertices; the ``io``
phase: B1 once and B4 once per peel round on the saved level's frame and
on the frame of the level ``ctx.Save`` wrote and ``scenes.load_level``
read into a fresh context, which is bit-equal to it; B1, B5 and B4 equal to
their plain versions at the loaded frame's inputs; the ``DumpToFile``
PNGs decoded with zlib equal to ``BackToFront()`` and the buffers; a
``CopyObject`` clone of a ball equal to one built by hand; save and load
seconds, the file's size, DXT decode host ms per MiB, ``CreatePM`` and
``SetPMVertexCount`` host ms),
reads image files with the port's own readers and renders a level
textured from them (``scenes.build_config5_images``: config 5 with a
512x512 JPEG checker, 256x256 BMP sphere skins, a palette-PNG plaza, 12
alpha-over signs from an RLE TGA and four HUD movie sprites, an animated
GIF, an APNG, an MJPG AVI and an MS RLE AVI; the ``images`` phase: every
file of ``tests/torch_images/`` decoded equal to the reference's decode
(Pillow's, or OpenCV's for the AVIs of ``io/avi.py``) in
``expected.npz``, host ms per decoded MiB of each reader and AVI codec,
3 ticks with
``SetMovieTime`` with B1 once and B4 once per peel round, B1 and B4 equal
to their plain versions at the first frame's inputs, and the same level
built with ``SetImage`` of the expected arrays bit-equal over the 3
ticks),
letters a HUD in TrueType faces with the port's own font stack
(``text/``) and renders the level under it
(``scenes.build_config5_text``: config 5 under eight ``CKSpriteText``
labels in the DejaVu faces of ``tests/torch_fonts/`` at sizes 9 to 48,
ligatures, kerning, Latin-1, Greek, Cyrillic and a score that changes
every tick; the ``fonts`` phase: the faces' SHA-256 against the fixtures',
the 126 rasters and text boxes of ``expected.npz`` drawn by
``CKSpriteText`` bit-equal to Pillow's, every glyph of
``glyphs_dejavu.npz`` redrawn equal, 3 ticks with B1 once per tick and
every label's texture equal to Pillow's raster, B1 equal to its plain
version at the first frame's inputs, and the same HUD set by ``SetImage``
bit-equal over the 3 ticks; host ms per raster by size, µs per glyph of
hinting and of rasterising, the glyph caches' bytes),
renders one frame in horizontal bands (the ``bands`` phase:
``SetTileSharding`` over a mesh naming card 0 once per band, every banded
frame bit-equal to the unbanded one: config 5 in 4 bands of 192 rows,
config 5 with Antialias, config 1 (B2), ``alpha50k`` (B3),
``alpha_tex50k`` (B4), ``config5_fx`` (L1) and config 2 with mips at
1000x750 in 6 bands of 125 rows; each kernel once per band, B4 once per
band and round, B5 per band under ``CK_FUSED_FETCH``, the profiler's
count equal to the wrappers'; each kernel equal to its plain version and
timed at one band's own inputs, and on the fixtures' band cases; device ms
of a banded config 5 frame beside the unbanded one), runs the multi-card
paths on a mesh naming card 0 four times (the ``multicard`` phase:
``dryrun_multichip(4)``'s three paths, and ``ProcessBatched`` of 8
contexts of 256x256 over a 4-entry context mesh bit-equal to
``ProcessBatched()``, B1 once per member; again over the real cards where
the machine has several, else a line says it did not run),
and times the frames, the stages (the skinned
frame's animate + compose + skin stage on its own, config 3's overlay
composite) and the kernels, at 1x and at their Antialias shapes, each
launch after 128 MiB written to flush the L2, beside each kernel's
roofline bound, under which no kernel's time may fall (B2
also at its floor, every row invalid, and at the flat route's limits).
Every phase prints a line; any failure raises, so the exit code is nonzero.
The last line is the device record ``{"ok": true, "device": {"platform":
"gpu", ...}}``. Without CUDA the script exits nonzero before printing any
result.
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


T0 = time.monotonic()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.monotonic() - T0, 1)}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host's CPU (its model name, or on ARM its implementer and part
    numbers), architecture and core count, beside a host-side time."""
    import platform
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("CPU implementer", "CPU part")
        if k in fields) or "model not reported"
    return f"{model}, {platform.machine()}, {os.cpu_count()} cores"


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


# Bytes written before each timed call: more than twice the H100's 50 MB
# L2, so the call finds its inputs in HBM and the L2 full of other dirty
# lines, as the bytes bound (each input read from HBM, each output written
# there) assumes. Without it a call whose inputs and outputs fit in the L2
# (L1 at 1024x768 moves 28 MB) can run in under the time HBM allows.
L2_FLUSH_BYTES = 128 * 2**20
_L2_FLUSH = []


def flush_l2() -> None:
    """Write L2_FLUSH_BYTES on the card (one fill launch, whose name holds
    none of the hand-written kernels')."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(L2_FLUSH_BYTES // 4, device="cuda"))
    _L2_FLUSH[0].zero_()


def kernel_ms(fn, name: str, reps: int = 20) -> float:
    """Mean milliseconds the kernel whose name contains ``name`` runs on the
    card per launch, over ``reps`` calls of ``fn()`` under ``torch.profiler``
    (one warm-up call first), each call after :func:`flush_l2`. Unlike
    :func:`cuda_ms` it holds no host time: a wrapper's launch takes the
    host some 0.05 ms, which a CUDA-event mean counts whenever the kernel
    is shorter than that."""
    return kernel_parts_ms(fn, (name,), reps)[name]


def kernel_parts_ms(fn, names, reps: int = 20) -> dict:
    """{name: mean ms per launch} of each kernel whose name contains one of
    ``names``, every one launched once per call of ``fn()``, from one
    profiler window of ``reps`` calls, each after :func:`flush_l2` (as
    :func:`kernel_ms`)."""
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import profile_window

    def hits(prof, name):
        return [e for e in prof.key_averages() if name in e.key]

    def count(prof, name):
        return sum(e.count for e in hits(prof, name))

    # Each call launches each kernel once (a wrapper counts one launch per
    # call), so a window with any other count than ``reps`` lost records
    # or holds foreign ones, and is profiled again.
    def cold():
        flush_l2()
        fn()

    prof, _wall = profile_window(
        cold, reps, [ProfilerActivity.CUDA],
        lambda p: all(count(p, k) == reps for k in names),
        label="+".join(names))
    out = {}
    for name in names:
        n = count(prof, name)
        check(n > 0, f"the profiler recorded no launch of {name}")
        total_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                       else e.cuda_time_total for e in hits(prof, name))
        out[name] = total_us / 1e3 / n
    return out


# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM
# bandwidth, and 67 TFLOP/s of float32 outside the tensor cores counting a
# fused multiply-add as two operations. The kernels here never fuse
# (--fmad=false), so their operations run at half that rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
# Arithmetic that no exact implementation of a rasterizing kernel avoids.
# A pair whose pixel lies outside the row's rect, whose row is invalid, or
# which fails one of the three edge tests costs nothing here: hierarchical
# rejects (by rect, by a block's corner value of an edge function) drop
# such pairs many at a time. A pair that passes all three edge tests needs
# its esum sign and its depth. Every plane value is fl(fl(a*px + b*py) + c)
# in the reference's order: its two adds are the pair's own, while a*px is
# shared by a column of pixels and b*py by a row, so the products amortise
# away. Three edges and esum: 8 adds; the esum sign product: 1; the depth
# (three products, two adds, the scale): 6. Each user clip plane adds its 2
# adds. Comparisons, and what only covered fragments pay (B3's
# interpolation and blend), are not counted, so the operations bound stays
# a lower bound.
OPS_PER_PAIR = 15
OPS_PER_CLIP_PLANE = 2
# The count used before the kernels shared products between pixels or
# rejected rows early: all 23 operations (three planes at 4, esum 5, depth
# 6; 4 per clip plane) for every pair a tile streams, whatever its fate.
# Kept beside the new bound as one yardstick for old and new kernels.
OLD_OPS_PER_PAIR = 23
OLD_OPS_PER_CLIP_PLANE = 4


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def roofline(pairs_past_edges: int, pairs: int, n_planes: int,
             n_bytes: int) -> dict:
    """The least time the card could take: ``pairs_past_edges`` (pixel, row)
    evaluations at the peak f32 rate without FMA, against ``n_bytes`` (each
    input read once, each output written once) at the peak memory rate.
    ``old_count_bound_ms`` is the same with the earlier count: every one of
    the ``pairs`` a tile streams at 23 operations."""
    ops = pairs_past_edges * (OPS_PER_PAIR + OPS_PER_CLIP_PLANE * n_planes)
    old_ops = pairs * (OLD_OPS_PER_PAIR + OLD_OPS_PER_CLIP_PLANE * n_planes)
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations_ms": ops_ms, "bytes_ms": bytes_ms,
            "old_count_bound_ms": max(old_ops / F32_OPS_PER_S * 1e3,
                                      bytes_ms),
            "pixel_row_pairs": int(pairs),
            "pairs_past_edges": int(pairs_past_edges),
            "operations": int(ops), "bytes": int(n_bytes)}


def tiled_pairs(counts, extra_rows: int, tile: int) -> int:
    """(pixel, row) pairs of a tiled kernel: every tile evaluates its own
    live rows plus ``extra_rows`` shared ones on tile*tile pixels."""
    return (int(counts.sum()) + counts.numel() * extra_rows) * tile * tile


def past_edges(ec, top_left, ok, rect, px, py):
    """Number (a 0-d int64 tensor) of (pixel, row) pairs whose row is
    ``ok``, whose pixel centre lies inside the row's rect [x0, y0, x1, y1)
    and passes all three edge functions under the top-left rule, evaluated
    as the plain versions do. Per row ``ec`` (..., K, 9) edge coefficients,
    ``top_left`` (..., K, 3) bool, ``ok`` (..., K) bool, ``rect``
    (..., K, 4), broadcast against the pixel centres ``px``, ``py``
    (..., 1, P)."""
    def col(a, i):
        return a[..., i, None]

    m = (ok[..., None] & (px >= col(rect, 0)) & (py >= col(rect, 1))
         & (px < col(rect, 2)) & (py < col(rect, 3)))
    for k in range(3):
        e = (col(ec, 3 * k) * px + col(ec, 3 * k + 1) * py
             + col(ec, 3 * k + 2))
        m &= (e > 0) | (col(top_left, k) & (e == 0))
    return m.sum()


def tiled_pairs_past_edges(stream, starts, counts, segments, tile: int,
                           tiles_x: int, tiles_y: int, step: int = 16,
                           row0: int = 0) -> int:
    """:func:`past_edges` over what a tiled kernel streams, from the edge,
    flag and rect columns the solve and the ordered streams share (0:9, 17,
    18:22): each tile's own range plus the ``segments`` [(base, rows)]
    every tile streams, ``step`` rows of every tile at a time; a band's
    pixels at their global rows (``row0``)."""
    from ckrenderengine_tpu_torch.raster.cuda_tiled import tile_grid

    dev = stream.device
    px, py = tile_grid(tile, tiles_x, tiles_y, dev)
    px, py = px[:, None], (py + float(row0))[:, None]
    kk = torch.arange(step, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)

    def count(rows, live):
        fl = rows[..., 17].to(torch.int32)
        top_left = torch.stack([(fl & b) != 0 for b in (1, 2, 4)], -1)
        return past_edges(rows[..., 0:9], top_left, live & ((fl & 8) != 0),
                          rows[..., 18:22], px, py)

    for j in range(0, int(counts.max()), step):
        idx = starts[:, None].long() + j + kk[None]
        total += count(stream[idx.clamp(0, stream.shape[0] - 1)],
                       (j + kk)[None] < counts[:, None])
    for base, n in segments:
        for j in range(0, n, step):
            rows = stream[base + j:base + min(j + step, n)][None]
            total += count(rows, torch.ones(rows.shape[:2], dtype=torch.bool,
                                            device=dev))
    return int(total)


def quant_words(t: int, wq: int, seed: int) -> np.ndarray:
    """A random (t, wq) int32 shade table whose columns 3 and 5 hold a float
    NaN and a float denormal bit pattern (the reference's fused-fetch
    fixture, tests/test_pallas_tiled.py)."""
    words = np.random.default_rng(seed).integers(-2**31, 2**31, (t, wq),
                                                 dtype=np.int64)
    words[:, 3] = np.int64(0x7FC00001 - 2**32)
    words[:, 5] = 1
    return words.astype(np.int32)


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


def make_setup(xyw, z, clipd, device, clip_rect=None):
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.raster.types import (
        NUM_SI, SI_CULL, VXCULL,
    )

    def on_device(a):
        return None if a is None else torch.as_tensor(a, device=device)

    t = xyw.shape[0]
    state_i = np.zeros((1, NUM_SI), np.int32)
    state_i[:, SI_CULL] = int(VXCULL.NONE)
    xyw_t = on_device(xyw)
    setup = df.triangle_setup(
        xyw_t, on_device(z), torch.zeros(t, dtype=torch.int32, device=device),
        torch.ones(t, dtype=torch.bool, device=device), on_device(state_i),
        clip_rect=on_device(clip_rect), clipd=on_device(clipd))
    return setup, xyw_t


def compare_b1(name, H, W, seed=3, T=9000, planes=0, kept_zb=False,
               viewport=None, **caps):
    """B1 and B5 on the random triangles of :func:`solve_fixture`."""
    xyw, z, clipd = solve_fixture(T, H, W, seed, planes)
    clear = 1.0
    if kept_zb:
        clear = np.random.default_rng(seed + 1).uniform(
            0.1, 0.9, (H, W)).astype(np.float32)
    return compare_solve(name, xyw, z, clipd, None, H, W,
                         viewport or [0.0, 0.0, W, H], clear, caps, seed)


def compare_case(case):
    """B1 and B5, with and without e-planes, on one case of
    ``raster/tiled_fixtures.py``; phase A must still give what the case
    was built for (a deep tile, exact chunk multiples, ...)."""
    return compare_solve(
        case["name"], case["xyw"], case["z"], case["clipd"],
        case["clip_rect"], case["h"], case["w"], case["viewport"], 1.0,
        case["caps"], 4, without_e=True, case=case,
        row0=case.get("row0", 0))


def compare_solve(name, xyw, z, clipd, clip_rect, H, W, viewport, clear,
                  caps, seed, without_e=False, case=None, row0: int = 0):
    """B1 and B5 through the whole tiled solve on the card (kernels) and on
    the CPU (plain phase B) from identical inputs: exact ids, depths,
    e-planes and bin statistics, and for B5 (a random int32 shade table
    with NaN and denormal float patterns, 16 or 20 words) exact rows, which
    must also be the table gathered by id. ``without_e`` runs both kernels
    again without e-planes: the same ids, depths and rows. ``row0``: the
    frame is a band whose first row is that global row. Returns the max
    abs depth difference of each kernel (0 when exact)."""
    from ckrenderengine_tpu_torch.raster.cuda_tiled import (
        depth_reduce_tiled_cuda, phase_a,
    )
    from ckrenderengine_tpu_torch.raster.deferred import gather_winner_rows
    from ckrenderengine_tpu_torch.raster.tiled_fixtures import check_expect

    T = xyw.shape[0]
    words = quant_words(T, 16 if seed % 2 else 20, seed + 10)
    outs = {}
    for dev in ("cuda", "cpu"):
        setup, xyw_t = make_setup(xyw, z, clipd, dev, clip_rect)
        vp = torch.tensor(viewport, dtype=torch.float32, device=dev)
        cz = clear if np.isscalar(clear) else torch.as_tensor(clear,
                                                              device=dev)
        args = (setup, torch.ones(T, dtype=torch.bool, device=dev), cz, vp,
                xyw_t, H, W)
        tbl = torch.as_tensor(words, device=dev)
        caps = dict(caps, row0=row0)
        if case is not None and dev == "cuda":
            check_expect(case, phase_a(setup, args[1], vp, xyw_t, H, W,
                                       **caps))
        b1 = depth_reduce_tiled_cuda(*args, want_eplanes=True,
                                     want_binstats=True, **caps)
        b5 = depth_reduce_tiled_cuda(*args, want_eplanes=True,
                                     want_binstats=True, shade_tbl=tbl,
                                     **caps)
        gathered = bool(torch.equal(b5[4], gather_winner_rows(tbl, b5[0])))
        check(gathered, f"B5 {name} on {dev}: rows are not the gathered "
              "table")
        outs[dev] = [[x.cpu().numpy() for x in out] for out in (b1, b5)]
        if without_e and dev == "cuda":
            n1 = depth_reduce_tiled_cuda(*args, want_binstats=True, **caps)
            n5 = depth_reduce_tiled_cuda(*args, want_binstats=True,
                                         shade_tbl=tbl, **caps)
            same = (all(torch.equal(x, y) for x, y in zip(n1, b1[:3]))
                    and all(torch.equal(x, y) for x, y in zip(
                        n5, b5[:3] + b5[4:])))
            check(same, f"{name}: B1 or B5 without e-planes differs from "
                  "the run with them")
    errs = []
    for k, kernel in enumerate(("B1", "B5")):
        got, plain = outs["cuda"][k], outs["cpu"][k]
        bi_k, bd_k, st_k, ep_k = got[:4]
        err = float(np.abs(bd_k - plain[1]).max())
        ok = all(np.array_equal(a, b) for a, b in zip(got, plain))
        extra = {}
        if kernel == "B5":
            extra = dict(rows_equal=bool(np.array_equal(got[4], plain[4])),
                         table_words=int(words.shape[1]),
                         rows_nonzero=float((got[4] != 0).any(0).mean()))
        emit("kernel_parity", kernel=kernel, case=name, shape=[H, W], tris=T,
             row0=row0, ids_equal=bool(np.array_equal(bi_k, plain[0])),
             depth_max_abs_err=err,
             eplanes_max_abs_err=float(np.abs(ep_k - plain[3]).max()),
             binstats=st_k.tolist(), binstats_equal=bool(
                 np.array_equal(st_k, plain[2])),
             covered=float((bi_k >= 0).mean()), without_eplanes_too=without_e,
             ok=bool(ok), **extra)
        check(ok, f"{kernel} {name}: kernel and plain version disagree")
        check((bi_k >= 0).any(), f"{kernel} {name}: nothing covered")
        errs.append(err)
    check(all(np.array_equal(a, b) for a, b in zip(outs["cuda"][0],
                                                   outs["cuda"][1][:4])),
          f"B5 {name}: its solve differs from B1's")
    return errs


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


def flat_args(case):
    """``reduce_flat_kernel``'s arguments for one flat case on the card."""
    from ckrenderengine_tpu_torch.raster.flat_fixtures import case_rows

    return (case_rows(case), case["clear_z"],
            torch.tensor(case["viewport"], dtype=torch.float32,
                         device="cuda"), case["h"], case["w"])


def compare_flat(case, lib) -> float:
    """B2 against its plain version on one full-size case of
    ``raster/flat_fixtures.py`` (a band case at its ``row0``): ids and
    depths exactly; the case must still give what it was built for
    (``check_expect``)."""
    from ckrenderengine_tpu_torch.raster.cuda_reduce import (
        depth_reduce_plain, reduce_flat_kernel,
    )
    from ckrenderengine_tpu_torch.raster.flat_fixtures import (
        check_expect, flat_stats,
    )

    args = flat_args(case)
    rows, _cz, _vp, h, w = args
    row0 = case.get("row0", 0)
    bi_k, bd_k = reduce_flat_kernel(*args, row0)
    bi_p, bd_p = depth_reduce_plain(*args, row0=row0)
    stats = flat_stats(rows, h, w, case["viewport"], row0=row0)
    check_expect(case, stats, bi_k.cpu().numpy())
    err = float((bd_k - bd_p).abs().max())
    ok = bool(torch.equal(bi_k, bi_p) and torch.equal(bd_k, bd_p))
    emit("kernel_parity", kernel="B2", case=case["name"], shape=[h, w],
         tris=int(rows.shape[0]), row0=row0,
         ctas_per_subtile=lib.ck_reduce_flat_split(rows.shape[0], h, w),
         scan_drop=stats["scan_drop"], pairs_past_edges=stats["past_edges"],
         esum_rejects=stats["esum_rejects"],
         depth_rejects=stats["depth_rejects"], depth_max_abs_err=err,
         covered=float((bi_k >= 0).float().mean()), ok=ok)
    check(ok, f"B2 {case['name']}: kernel and plain version disagree")
    return err


# ---------------------------------------------------------------------------
# Ordered kernels on the cases of raster/ordered_fixtures.py
# ---------------------------------------------------------------------------

def compare_ordered(case, tile: int):
    """B3 and B4 kernels against their plain versions on one case's
    card-side phase A at ``tile``: B3's (5, H_pad, W_pad) A/B planes and,
    at each of the case's layer windows, B4's ids, edge values, counts and
    overflow flags, all exactly. Returns the max abs difference of each."""
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co
    from ckrenderengine_tpu_torch.raster.ordered_fixtures import (
        FIELDS, check_expect,
    )

    fx = {k: torch.as_tensor(case["fields"][k], device="cuda")
          for k in FIELDS}
    h, w = case["h"], case["w"]
    row0 = case.get("row0", 0)
    kw = {} if case["windows"] is None else dict(windows=case["windows"])
    pa = co.phase_a(*(fx[k] for k in FIELDS),
                    torch.as_tensor(case["si"], device="cuda"),
                    torch.as_tensor(case["sf"], device="cuda"),
                    torch.as_tensor(case["zb"], device="cuda"), h, w, tile,
                    row0=row0, **kw)
    check_expect(case, pa, co.row_pitch(pa["n_planes"]))
    name = f"{case['name']}_tile{tile}"
    tx, ty = pa["tiles_x"], pa["tiles_y"]
    ranges = (pa["stream"], pa["starts"], pa["counts"])
    b3 = ranges + (co._params(case["viewport"], h, w, case["fog_color"],
                            "cuda", row0), pa["zplane"], tile, tx, ty,
                 pa["n_planes"])
    k, p = co.blend_kernel(*b3), co.blend_phase_b_plain(*b3)
    err3 = float((k - p).abs().max())
    exact = bool(torch.equal(k, p))
    emit("kernel_parity", kernel="B3", case=name, shape=[h, w], row0=row0,
         tris=int(case["fields"]["valid"].sum()),
         live_pairs=int(pa["n_live"]), max_tile_rows=int(pa["counts"].max()),
         planes=pa["n_planes"], bad=bool(pa["bad"]), max_abs_err=err3,
         exact=exact, blended=float((k[0] != 1).float().mean()))
    check(exact, f"B3 {name}: kernel and plain version disagree")
    err4 = 0.0
    for skip in case["skips"]:
        b4 = ranges + (co._params(case["viewport"], h, w, dev="cuda",
                                  row0=row0), skip,
                     pa["zplane"], tile, tx, ty, pa["n_planes"])
        k, p = co.peel_kernel(*b4), co.peel_phase_b_plain(*b4)
        exact = all(torch.equal(a, b) for a, b in zip(k, p))
        e = float((k[1] - p[1]).abs().max())
        err4 = max(err4, e)
        emit("kernel_parity", kernel="B4", case=name, shape=[h, w],
             row0=row0, skip=skip, layer0_covered=float((k[0][0] >= 0).float().mean()),
             max_count=int(k[2].max()), overflow=bool(k[3].any()),
             max_abs_err=e, exact=bool(exact))
        check(exact, f"B4 {name} skip {skip}: kernel and plain disagree")
    return err3, err4


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
    if device == "cpu":
        render_keeping_ids(rc)
    else:
        rc.Render()
    return ctx, rc, mover


def render_keeping_ids(rc) -> None:
    """``rc.Render()`` on the CPU, keeping its frame's winner ids beside a
    copy of its fb and zb, so that :func:`winners` need not render a CPU
    frame (seconds at 320x240) a second time: the frame's one
    ``render_frame_packed`` call is asked for its stats too, which adds the
    ids to what it returns and changes nothing else."""
    from ckrenderengine_tpu_torch.pipeline import frame as fr

    real, seen = fr.render_frame_packed, []

    def spy(*a, want_stats=False, **k):
        out = real(*a, want_stats=True, **k)
        seen.append(out[-1]["WinnerIds"])
        return out if want_stats else out[:-1]

    fr.render_frame_packed = spy
    try:
        rc.Render()
    finally:
        fr.render_frame_packed = real
    if len(seen) == 1:
        rc.kept_ids = (rc.fb.clone(), rc.zb.clone(), seen[0])


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
    """The winner ids of rc's current frame: those :func:`render_keeping_ids`
    kept while fb and zb are still that frame's, else a frame through
    :func:`frame_with`."""
    kept = getattr(rc, "kept_ids", None)
    if kept is not None and torch.equal(kept[0], rc.fb) \
            and torch.equal(kept[1], rc.zb):
        return kept[2].cpu().numpy()
    return frame_with(rc)[2]["WinnerIds"].cpu().numpy()


def compare_with_cpu(name, rc_g, rc_c, **fields):
    """A frame rendered on the card against the same frame on the CPU (the
    plain versions): winners equal on >= 99.9% of the frame, and the
    framebuffer within 1/255 wherever they are (cuBLAS and the CPU may round
    a 4x4 matrix product apart by an ULP, which moves vertices, ties and
    texel lookups). The other pixels are ties between two triangles: they
    are counted, and nothing bounds their colours but the frame's range."""
    ids_g, ids_c = winners(rc_g), winners(rc_c)
    eq = ids_g == ids_c
    diff = np.abs(rc_g.framebuffer() - rc_c.framebuffer()).max(-1)
    off = int((diff[eq] > 1.0 / 255.0).sum())
    emit("cpu_reference", config=name, size=[rc_g.width, rc_g.height],
         ids_equal_frac=float(eq.mean()),
         fb_max_abs_diff_matching=float(diff[eq].max()),
         matching_pixels_over_2e_6=int((diff[eq] > 2e-6).sum()),
         matching_pixels_over_1_255=off,
         pixels_outside=int((~eq).sum()),
         fb_max_abs_diff_outside=float(diff[~eq].max()) if (~eq).any()
         else 0.0, **fields)
    check(eq.mean() >= 0.999, f"{name}: card and CPU winners disagree")
    check(off == 0,
          f"{name}: card and CPU frames disagree {diff[eq].max()} on "
          f"{off} pixels")
    check(float(diff.max()) <= 1.0, f"{name}: frame out of range")


def count_calls(mod, name):
    """Wrap ``mod.name`` with a call counter; the returned function restores
    the original and returns the count."""
    fn = getattr(mod, name)
    n = [0]

    def counted(*a, **k):
        n[0] += 1
        return fn(*a, **k)

    setattr(mod, name, counted)

    def done() -> int:
        setattr(mod, name, fn)
        return n[0]

    return done


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
    from ckrenderengine_tpu_torch.pipeline import lines as ll
    from ckrenderengine_tpu_torch.raster import (
        cuda_ordered as co, cuda_reduce, cuda_tiled,
    )
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.raster.ordered_fixtures import (
        ordered_cases,
    )
    from ckrenderengine_tpu_torch.raster.flat_fixtures import flat_cases
    from ckrenderengine_tpu_torch.raster.tiled_fixtures import tiled_cases

    card = card_line()
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    kernel_fns = {"B1": cuda_tiled.solve_tiled_kernel,
                  "B2": cuda_reduce.reduce_flat_kernel,
                  "B3": co.blend_kernel, "B4": co.peel_kernel,
                  "B5": cuda_tiled.solve_fetch_kernel}

    # --- 2. build ----------------------------------------------------------
    lib = cuda_build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    # Resident CTAs per SM of each instantiation of the tiled solve at the
    # frames' launch shapes (tile 32, 128-row chunks, no clip plane).
    occupancy = {
        f"{'B5' if fetch else 'B1'}{'_eplanes' if want_e else ''}":
        lib.lib.ck_solve_tiled_occupancy(want_e, fetch, 0, 24, 32, 128)
        for fetch in (0, 1) for want_e in (1, 0)}
    # The ordered kernels at the stress frames' shapes (tile 32, no plane).
    occupancy.update(
        B3=lib.lib.ck_ordered_blend_occupancy(0, 32, co.KCHUNK),
        B4=lib.lib.ck_ordered_peel_occupancy(0, 32, co.KCHUNK),
        B2=lib.lib.ck_reduce_flat_occupancy())
    emit("build", seconds=round(lib.build_seconds, 3), library=os.path.relpath(
        lib.path, ROOT), ptxas=ptxas, ctas_per_sm=occupancy)
    check(all(v > 0 for v in occupancy.values()),
          f"occupancy query failed: {occupancy}")
    entry = ""
    for ln in ptxas:
        if "Compiling entry" in ln:
            entry = ln
        if "spill" in ln and any(k in entry for k in (
                "solve_tiled", "ordered", "reduce_flat")):
            check("0 bytes spill stores, 0 bytes spill loads" in ln,
                  f"a kernel spills registers: {entry} {ln}")

    # --- 3. kernel parity on the card --------------------------------------
    solve_errs = [
        compare_b1("solve_fixture", 320, 512),
        compare_b1("tiny_caps", 128, 128, seed=4, T=1200, g_cap=16,
                   slab_cap=64, pair_cap=64),
        compare_b1("clip_planes", 320, 512, seed=6, planes=2),
        compare_b1("kept_zbuffer", 320, 512, seed=7, kept_zb=True),
        compare_b1("kept_zbuffer_tile16", 200, 300, seed=7, T=3000,
                   kept_zb=True, tile=16),
        compare_b1("non_divisible", 200, 300, seed=8, T=3000),
        compare_b1("small_viewport", 200, 300, seed=9, T=3000,
                   viewport=[10.0, 6.0, 250.0, 170.0]),
    ]
    solve_errs += [compare_case(case) for case in tiled_cases()]
    # The same cases at one sub-tile per tile and a ring of 32-row chunks.
    solve_errs += [compare_case(dict(case, name=case["name"] + "_tile16"))
                   for case in tiled_cases(tile=16, kchunk=32, deep=300)]
    errs = {"B1": [e[0] for e in solve_errs],
            "B5": [e[1] for e in solve_errs], "B2": [compare_b2()]}
    # B2 on every flat case at full size.
    errs["B2"] += [compare_flat(case, lib.lib) for case in flat_cases()]
    # B3 and B4 on every ordered case at one sub-tile per tile and at four.
    ordered_errs = [compare_ordered(case, tile) for tile in (16, 32)
                    for case in ordered_cases(tile=tile, kchunk=co.KCHUNK)]
    errs["B3"] = [e[0] for e in ordered_errs]
    errs["B4"] = [e[1] for e in ordered_errs]

    # --- 4. main path through Render() -------------------------------------
    # Each path runs with every launch count at 0 and is read right after.
    launches = dict.fromkeys(kernel_fns, 0)
    configs = {}
    os.environ.pop("CK_FUSED_FETCH", None)
    for name, build, kernels in (
            ("config1", scenes.build_config1, ("B2",)),
            ("config2", scenes.build_config2, ("B1",)),
            ("config5", scenes.build_config5, ("B1",)),
            ("config3", scenes.build_config3, ("B1",)),
            ("config4", scenes.build_config4, ("B1",)),
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
        for k in kernel_fns:
            check((got[k] > 0) == (k in kernels),
                  f"{name}: the frame launched {k} {got[k]} times")
        check(got["B1"] <= 1 and got["B2"] <= 1, f"{name}: {got}")
        if name in ("config2", "config5", "config4"):
            # The same tick again with the fused fetch: B5 once, no B1, and
            # the frame equal to the default path's on every pixel.
            fb0, zb0 = rc.fb.clone(), rc.zb.clone()
            os.environ["CK_FUSED_FETCH"] = "1"
            reset_launches(kernel_fns.values())
            rc.Render()
            torch.cuda.synchronize()
            del os.environ["CK_FUSED_FETCH"]
            fused = {k: fn.launches for k, fn in kernel_fns.items()}
            for k in launches:
                launches[k] += fused[k]
            differ = int(((rc.fb != fb0).any(0) | (rc.zb != zb0)).sum())
            emit("fused_fetch", config=name, launches=fused,
                 pixels_that_differ=differ)
            check(fused["B5"] == 1 and fused["B1"] == 0,
                  f"{name}: fused-fetch frame launches {fused}")
            check(differ == 0, f"{name}: the fused-fetch frame differs from "
                  f"the default path's on {differ} pixels")
        configs[name] = (ctx, rc, mover)
        extra = {}
        if name == "config4":
            extra = skinned_checks(name, rc, mover, kernel_fns, launches, fr)
        if name == "config3":
            extra = hud_checks(rc)
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

    # --- 4b. Antialias and the stencil pass through Render() ---------------
    aa = antialias_phase(O, scenes, fr, kernel_fns, launches)
    stencil_phase(O, scenes, fr, kernel_fns, launches, cuda_tiled,
                  cuda_reduce)

    # --- 4c. frame windows: W frames as CUDA-graph replays -----------------
    window_phase(O, scenes, kernel_fns, launches, card)

    # --- 4d. the effects level: 3D sprites, curves and the line pass -------
    fx = fx_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4e. the material-effects level: TexGen, cube env, channels --------
    mat = mat_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4f. context batching: one captured frame replayed per member ------
    batch_phase(O, scenes, kernel_fns, launches, card)

    # --- 4g. user vertex and pixel shaders ---------------------------------
    shaded = shader_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4h. the rasterizer HAL: immediate-mode draws ----------------------
    hal_phase(O, dict(kernel_fns, **line_fns(ll)), card)

    # --- 4i. render-to-texture and stereo: the monitor level ---------------
    monitor_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4j. the render context and manager API ----------------------------
    api_phase(O, scenes, kernel_fns, launches, card)

    # --- 4k. picking and immediate-mode draws over the level ---------------
    immediate_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4l. debug stepping, the grid and the IK arm over the level --------
    debug_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4m. scene IO: the DXT-textured, progressive-mesh level reloaded ---
    io = io_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4m2. image files: the level textured from PNG, BMP, TGA, JPEG, --
    # GIF and APNG files read by the port's own readers
    images = images_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4m3. TrueType text: the port's font stack against Pillow's ------
    # bytes, and the level under a HUD lettered with it
    fonts = fonts_phase(O, scenes, fr, kernel_fns, launches, card)

    # --- 4n. framebuffer bands: one frame over a mesh of card 0 ----------
    bands = bands_phase(O, scenes, fr, kernel_fns, launches, card, configs,
                        aa)
    for k, v in bands["errs"].items():
        if k in errs:
            errs[k] += v

    # --- 4o. the multi-card paths: the dry run and a context mesh --------
    multicard_phase(O, scenes, kernel_fns, card)

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

    # The opaque frames on the card against the CPU (the plain versions) at
    # small sizes; the tiled ones take the row path on both.
    for name, build, kw in (
            ("config1", scenes.build_config1, dict(size=256)),
            ("config2_small", scenes.build_config2,
             dict(width=256, height=192)),
            ("config5_small", scenes.build_config5,
             dict(width=256, height=192, terrain_n=70, n_balls=8)),
            ("config3_small", scenes.build_config3,
             dict(width=256, height=193)),
            ("config4_small", scenes.build_config4,
             dict(width=256, height=193, n_bones=28, rings_per_bone=4,
                  ring_verts=32))):
        _, rc_g, tick_g = render_config(build, O, "cuda", **kw)
        _, rc_c, tick_c = render_config(build, O, "cpu", **kw)
        compare_with_cpu(name, rc_g, rc_c)
        if name == "config4_small":
            # A later clip time, so the pose is not the first frame's.
            for _ in range(24):
                tick_g()
                tick_c()
            rc_g.Render()
            rc_c.Render()
            compare_with_cpu(name + "_t12", rc_g, rc_c)

    # An odd-sized mip frame takes the compact rows (the analytic LOD needs
    # the edge coefficients); a mip frame of even size the quantized rows
    # with the 2x2-quad LOD. Both on the card against the CPU.
    for name, kw, table in (
            ("config2_mips_odd", dict(width=320, height=241, mips=True),
             "shade_row_table_compact"),
            ("config2_mips_even", dict(width=320, height=240, mips=True),
             "shade_row_table_quant")):
        built = count_calls(df, table)
        _, rc_g, _ = render_config(scenes.build_config2, O, "cuda", **kw)
        on_card = built()
        _, rc_c, _ = render_config(scenes.build_config2, O, "cpu", **kw)
        check(on_card == 1, f"{name}: {table} ran {on_card} times")
        check(rc_g._fill_packed([], [])[3]["sampler_profile"][1],
              f"{name}: no mip state")
        compare_with_cpu(name, rc_g, rc_c, branch=table)

    # --- 7. golden frames (reference package, CPU) --------------------------
    for frame, build, kw in (
            ("config2_320x240", scenes.build_config2,
             dict(width=320, height=240)),
            ("alpha_320x240", scenes.build_alpha50k, dict(
                width=320, height=240, n_sheets=4, sheet_n=11))):
        g = np.load(os.path.join(GOLDEN_DIR, frame + ".npz"))
        reset_launches(kernel_fns.values())
        _, rc_g, _ = render_config(build, O, "cuda", **kw)
        got = {k: fn.launches for k, fn in kernel_fns.items()}
        ids = winners(rc_g)
        rgba = rc_g.BackToFront()
        check(rgba.shape == g["rgba"].shape and rgba.dtype == np.uint8,
              f"golden {frame}: image {rgba.shape} {rgba.dtype}")
        match = ids == g["ids"]
        diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32))
        emit("golden", frame=frame, ids_equal_frac=float(match.mean()),
             rgba_max_diff_matching=int(diff[match].max()),
             rgba_max_diff=int(diff.max()), launches=got)
        check(match.mean() >= 0.999, f"golden {frame}: winner ids differ")
        check(int(diff[match].max()) <= 1, f"golden {frame}: image differs")
        check((g["ids"] >= 0).mean() > 0.5, f"golden {frame}: mostly empty")
        if frame.startswith("alpha"):
            # The transparent sheets took the B3 branch.
            check(got["B3"] == 1, f"golden {frame}: launches {got}")

    # --- 8. timing (informational) -----------------------------------------
    # Frames per second through Render(): 2 warm-up ticks, then 30 ticks of
    # (the config's tick: rotate its mover or advance config 4's clip,
    # Render()), fenced by synchronize().
    # The Antialias scenes take 5 ticks (frame_bench.py profiles them).
    fps = {}
    names = ("config1", "config2", "config5", "config3", "config4",
             "alpha50k", "alpha_tex50k")
    for name, (_ctx, rc_t, mover), n in (
            [(k, configs[k], 30) for k in names]
            + [(k + "_aa", aa[k], 5) for k in names]):
        step = ticker(name.removesuffix("_aa"), mover)
        for _ in range(2):
            step()
            rc_t.Render()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            step()
            rc_t.Render()
        torch.cuda.synchronize()
        fps[name] = n / (time.monotonic() - t0)
        emit("fps", config=name, card=card, fps=fps[name], frames=n,
             size=[rc_t.width, rc_t.height])
    # Stages and solve kernels of the row path at the frames' own shapes,
    # and what one frame launches on the card.
    rows_ms = {name: time_rows(name, configs[name][1], fps[name], card, fr,
                               cuda_tiled, df, plain=name == "config5")
               for name in ("config2", "config5", "config3", "config4")}
    for name in ("config2", "config5", "config3", "config4"):
        _ctx, rc_t, mover = configs[name]
        for fused in ((False, True) if name != "config3" else (False,)):
            if fused:
                os.environ["CK_FUSED_FETCH"] = "1"
            per_frame = profile_frames(rc_t, ticker(name, mover))
            os.environ.pop("CK_FUSED_FETCH", None)
            emit("frame_profile", config=name, card=card, fused_fetch=fused,
                 **per_frame)
    time_skin_stage(configs["config4"][1], fps["config4"], card, fr)
    time_overlay(configs["config3"][1], fps["config3"], card, fr)
    b1_ms, b5_ms = rows_ms["config5"]["B1"], rows_ms["config5"]["B5"]

    # B2 at config 1's frame, at its floor there, at config 1's Antialias
    # frame and at the flat limits.
    b2_times = time_flat(configs["config1"][1], aa["config1"][1], card, fr,
                         cuda_reduce, lib, ptxas, flat_cases())

    # B3 and B4 at the stress frames' shapes, with phase A and composite.
    ordered_ms = {}
    for name, kernel in (("alpha50k", "B3"), ("alpha_tex50k", "B4")):
        ordered_ms[kernel] = time_ordered(name, kernel, configs[name][1],
                                          fps[name], card, fr, co)

    ms = {"B1": b1_ms, "B2": b2_times["config1"],
          **ordered_ms, "B5": b5_ms}
    # Each kernel at its Antialias shape (2x the display size), checked
    # equal to its plain version there: B1 and B5 at config 5, B2 at config
    # 1 (above), B3 at alpha50k, B4 at alpha_tex50k.
    rows_aa = time_rows("config5_aa", aa["config5"][1], fps["config5_aa"],
                        card, fr, cuda_tiled, df, plain=False)
    aa_ms = {"B1": rows_aa["B1"], "B5": rows_aa["B5"],
             "B2": b2_times["config1_aa"]}
    for name, kernel in (("alpha50k", "B3"), ("alpha_tex50k", "B4")):
        aa_ms[kernel] = time_ordered(name + "_aa", kernel, aa[name][1],
                                     fps[name + "_aa"], card, fr, co)
    aa_shape = {"B1": "config5_aa", "B5": "config5_aa", "B2": "config1_aa",
                "B3": "alpha50k_aa", "B4": "alpha_tex50k_aa"}
    sources = {"B1": ("solve_tiled", "csrc/solve_tiled.cu",
                      "ckrenderengine_tpu/raster/pallas_tiled.py:61"),
               "B2": ("reduce_flat", "csrc/reduce_flat.cu",
                      "ckrenderengine_tpu/raster/pallas_reduce.py:61"),
               "B3": ("ordered_blend", "csrc/ordered_blend.cu",
                      "ckrenderengine_tpu/raster/pallas_ordered.py:89"),
               "B4": ("ordered_peel", "csrc/ordered_peel.cu",
                      "ckrenderengine_tpu/raster/pallas_ordered.py:518"),
               "B5": ("solve_tiled_fetch", "csrc/solve_tiled.cu",
                      "ckrenderengine_tpu/raster/pallas_tiled.py:204")}
    # No single PyTorch call computes any of these functions: library_ms is
    # null for all five.
    kernels = [
        {"name": f"{k} {sources[k][0]}", "route": "cuda",
         "source": "ckrenderengine_tpu_torch/" + sources[k][1],
         "replaces": sources[k][2], "launches": launches[k],
         "max_abs_err": max(errs[k]), "ms": ms[k][0], "plain_ms": ms[k][1],
         "bound_ms": ms[k][2]["bound_ms"], "bound_by": ms[k][2]["bound_by"],
         "library_ms": None, "events_ms": ms[k][3],
         "old_count_bound_ms": ms[k][2]["old_count_bound_ms"],
         "bound_counts": {
             c: ms[k][2][c] for c in (
                 "pixel_row_pairs", "pairs_past_edges", "operations",
                 "bytes", "operations_ms", "bytes_ms")},
         "antialias": {"shape": aa_shape[k], "ms": aa_ms[k][0],
                       "bound_ms": aa_ms[k][2]["bound_ms"],
                       "bound_by": aa_ms[k][2]["bound_by"]}}
        for k in ("B1", "B2", "B3", "B4", "B5")]
    # Each kernel the effects level launches, at its frame's shapes (B3 at
    # the level with untextured halos).
    for k in kernels:
        key = k["name"].split()[0]
        if key in fx:
            k["config5_fx"] = {"ms": fx[key][0], "plain_ms": fx[key][1],
                               "bound_ms": fx[key][2]["bound_ms"],
                               "bound_by": fx[key][2]["bound_by"]}
        if key in mat:
            k["config5_mat"] = {"ms": mat[key][0], "plain_ms": mat[key][1],
                                "bound_ms": mat[key][2]["bound_ms"],
                                "bound_by": mat[key][2]["bound_by"]}
        if key in io:
            # B1 and B5 at the reloaded level's frame, B4 at its signs.
            k["config5_io"] = {"ms": io[key][0], "plain_ms": io[key][1],
                               "bound_ms": io[key][2]["bound_ms"],
                               "bound_by": io[key][2]["bound_by"]}
        if key in images:
            # B1 at the image level's first frame, B4 at its signs.
            k["config5_images"] = {
                "ms": images[key][0], "plain_ms": images[key][1],
                "bound_ms": images[key][2]["bound_ms"],
                "bound_by": images[key][2]["bound_by"]}
        if key in fonts:
            # B1 at the lettered level's first frame.
            k["config5_text"] = {
                "ms": fonts[key][0], "plain_ms": fonts[key][1],
                "bound_ms": fonts[key][2]["bound_ms"],
                "bound_by": fonts[key][2]["bound_by"]}
        for suffix, label in (("", "bands"), ("_aa", "bands_aa")):
            b = bands["ms"].get(key + suffix)
            if b is not None:
                # The kernel at one band's own inputs (its row offset).
                k[label] = {"config": b[5], "row0": b[4], "ms": b[0],
                            "plain_ms": b[1], "bound_ms": b[2]["bound_ms"],
                            "bound_by": b[2]["bound_by"], "events_ms": b[3]}
        if key in shaded:
            # B1 without e-planes, at the shaded level's frame.
            k["config5_shaded"] = {
                "ms": shaded[key][0], "plain_ms": shaded[key][1],
                "bound_ms": shaded[key][2]["bound_ms"],
                "bound_by": shaded[key][2]["bound_by"],
                "events_ms": shaded[key][3]}
    # L1 is not a TPU kernel: the reference's line pass is plain JAX.
    # Its ms is the sum of its launches per call (the bin step and the
    # draw); "parts_ms" gives each, "copy_floor_ms" the draw with no row.
    check(launches["L1"] > 0 and launches["L1_bins"] > 0,
          f"L1 never ran on the main path: {launches}")
    l1, l1_aa = fx["L1"], fx["L1_aa"]
    b = bands["ms"]["L1"]

    def l1_shape(t, **more):
        return {**more, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2]["bound_ms"], "bound_by": t[2]["bound_by"],
                "events_ms": t[3], "parts_ms": t[2]["parts_ms"],
                "copy_floor_ms": t[2]["copy_floor_ms"],
                "bin_entries": t[2]["bin_entries"]}
    kernels.append({
        "name": "L1 lines", "route": "cuda",
        "source": "ckrenderengine_tpu_torch/csrc/lines.cu",
        "replaces": "ckrenderengine_tpu/pipeline/lines.py:52",
        "replaces_note": "draw_lines, plain JAX (no pl.pallas_call)",
        "launches": launches["L1"], "bin_launches": launches["L1_bins"],
        "max_abs_err": max(fx["L1_errs"] + bands["errs"]["L1"]),
        **l1_shape(l1), "library_ms": None,
        "bound_counts": {c: l1[2][c] for c in (
            "pairs_within_half_width", "bin_entries", "largest_bin",
            "tested_pairs", "operations", "bytes", "operations_ms",
            "bytes_ms")},
        "antialias": l1_shape(l1_aa, shape="config5_fx_aa"),
        "bands": l1_shape(b, config=b[5], row0=b[4])})
    from ckrenderengine_tpu_torch import frame_bench
    emit("profiler_windows", **frame_bench.PROFILE_WINDOWS,
         pad_s=frame_bench.PROFILE_PAD_S, tries=frame_bench.PROFILE_TRIES)
    for k in kernels:
        # A time under the bound means the bound counts work no kernel
        # needs, or the timing is wrong.
        for t in (k, k["antialias"], k.get("config5_fx", k),
                  k.get("config5_mat", k), k.get("config5_shaded", k),
                  k.get("config5_io", k), k.get("config5_images", k),
                  k.get("bands", k),
                  k.get("bands_aa", k)):
            check(t["ms"] >= t["bound_ms"],
                  f"{k['name']}: {t['ms']} ms is below its bound "
                  f"{t['bound_ms']} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# The HAL's call script: on the card at config 5's display size, and at
# 128x96 on the card and on the CPU, there cut to HAL_SMALL_SCRIPT: 192 +
# 32 + 2 * 16 + 32 + 2 = 290 triangles, every call of the full script's
# 1,026 (each triangle costs the card ~18 host ms).
HAL_SIZE = (1024, 768)
HAL_SMALL = (128, 96)
HAL_SMALL_SCRIPT = dict(rings=8, segments=12, grid=4, fan=16, quads=16)
HAL_CLEAR = np.array([0x20, 0x30, 0x40, 0xFF], np.float32) / 255.0
# Triangles of the sphere drawn again under torch.profiler (its ~1,140
# launches per triangle make the whole 768-triangle draw a long profile).
HAL_PROFILED = 16


def hal_lights(O, device):
    """The script's two lights, object-API CKLights of a context on
    ``device`` (pushed into the HAL context by ``CKLight.Setup``)."""
    ctx = O.CKContext(device=device)
    key = O.CKLight(ctx, "key")
    key.SetColor((1.0, 0.9, 0.8, 1.0))
    key.SetOrientation((0.3, -0.6, 1.0))
    fill = O.CKLight(ctx, "fill")
    fill.SetColor((0.2, 0.3, 0.9, 1.0))
    fill.SetOrientation((-1.0, 0.2, 0.3))
    return [key, fill]


def hal_run(O, device, size, script=None, **kw):
    """A fresh rasterizer on ``device``, a context of ``size`` on its
    driver 0, the call script through it (the full one, or ``script``'s
    sizes). Returns (rasterizer, context, the script's record)."""
    from ckrenderengine_tpu_torch.raster import hal as H
    from ckrenderengine_tpu_torch.raster import hal_fixtures as hf

    rst = H.CKRasterizer(device=device)
    rst.Start(None)
    ctx = rst.GetDriver(0).CreateContext()
    ctx.Create(None, *size)
    out = hf.hal_script(rst, ctx, hal_lights(O, device),
                        **(script or hf.FULL), **kw)
    return rst, ctx, out


def hal_cpu_planes(threads: int) -> tuple:
    """The call script cut to HAL_SMALL_SCRIPT at HAL_SMALL on the CPU, in
    a worker process of its own (spawned: it never touches the card).
    Returns (fb HWC, zb, seconds)."""
    sys.path.insert(0, ROOT)
    import ckrenderengine_tpu_torch.objects as O

    torch.set_num_threads(threads)
    t0 = time.monotonic()
    _r, ctx, _o = hal_run(O, "cpu", HAL_SMALL, HAL_SMALL_SCRIPT)
    return ctx.BackToFront(), ctx.zb.numpy(), time.monotonic() - t0


def hal_phase(O, kernel_fns, card) -> dict:
    """The rasterizer HAL on the card (``raster/hal.py``).

    - The driver table: two drivers, the first the card and hardware, in
      the object API (``CKRenderManager``) and in the HAL.
    - The call script (``raster/hal_fixtures.FULL``: 1,026 triangles) at
      1024x768, every launch count at 0 first and read after: the HAL
      draws through ``render_pass``, so no hand-written kernel launches.
      The fb is finite and more than 1% of it differs from the clear
      colour, zb lies in [0, 1], the counters are the script's, the copied
      texture equals its fb rect and the restored fb the backup, bit for
      bit; a display-list replay equals the same draw issued directly on a
      fresh context, bit for bit. The script's sphere ``DrawPrimitive``
      (768 triangles): its host ms (no synchronise) and wall ms (with
      one); HAL_PROFILED of its triangles drawn again under torch.profiler:
      device launches and device ms per triangle.
    - The script cut to HAL_SMALL_SCRIPT at 128x96 on the card and on the
      CPU, in a worker process that starts after the timed sphere draw and runs while the
      card works on: fb and zb within
      ``render_pass``'s bound (1e-5 on all but 0.1% of the values, never
      past 1e-4)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ckrenderengine_tpu_torch.frame_bench import device_us
    from ckrenderengine_tpu_torch.raster import hal as H
    from ckrenderengine_tpu_torch.raster import hal_fixtures as hf

    t_phase = time.monotonic()
    steps = {}

    def step(name, t0):
        steps[name] = time.monotonic() - t0
        emit("hal_step", step=name, s=steps[name])

    rm = O.CKContext(device="cuda").GetRenderManager()
    rst = H.CKRasterizer(device="cuda")
    rst.Start(None)
    check(rm.GetRenderDriverCount() == 2 and rst.GetDriverCount() == 2
          and rm.GetRenderDriverDescription(0).is_hardware
          and rst.GetDriver(0).IsHardware()
          and not rm.GetRenderDriverDescription(1).is_hardware
          and rm.GetPreferredSoftwareDriver() == 1,
          "hal: the driver table is not (card, software)")
    threads = max(1, (os.cpu_count() or 2) - 2)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        sphere, cpu = {}, []

        class timed:
            def __init__(self, n):
                sphere["triangles"] = n

            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                sphere["host_ms"] = (time.perf_counter() - self.t) * 1e3
                torch.cuda.synchronize()
                sphere["wall_ms"] = (time.perf_counter() - self.t) * 1e3
                # The CPU worker starts once the timed draw is done, so
                # the host ms are taken on an unloaded host.
                cpu.append(ex.submit(hal_cpu_planes, threads))
                steps["cpu_start_s"] = time.monotonic() - t_phase

        t0 = time.monotonic()
        reset_launches(kernel_fns.values())
        _r, ctx, out = hal_run(O, "cuda", HAL_SIZE, probes=True,
                               timer=timed)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in kernel_fns.items()}
        step("script_1024x768_s", t0)
        check(all(v == 0 for v in got.values()),
              f"hal: the HAL path launched hand-written kernels {got}")
        fb = ctx.BackToFront()
        zb = ctx.zb.cpu().numpy()
        finite = bool(np.isfinite(fb).all() and np.isfinite(zb).all())
        covered = float((np.abs(fb - HAL_CLEAR).max(-1) > 0).mean())
        check(finite, "hal: non-finite fb or zb")
        check(covered > 0.01, f"hal: only {covered} of the fb was drawn")
        check(float(zb.min()) >= 0.0 and float(zb.max()) <= 1.0,
              "hal: zb outside [0, 1]")
        check(ctx.stats == {"NbTrianglesDrawn": out["triangles"],
                            "NbVerticesProcessed": out["vertices"]}
              and out["triangles"] == 1026,
              f"hal: counters {ctx.stats} against the script's {out}")
        check(np.array_equal(out["copy_tex"], out["copy_fb"]),
              "hal: CopyToTexture's level 0 differs from its fb rect")
        check(np.array_equal(out["restored_fb"], out["backup_fb"]),
              "hal: RestoreScreenBackup differs from the backup")
        t0 = time.monotonic()
        a, b = hf.display_list_pair(rst, hf.FULL["fan"], *HAL_SIZE)
        dl_equal = (np.array_equal(a.BackToFront(), b.BackToFront())
                    and bool(torch.equal(a.zb, b.zb)))
        step("display_list_s", t0)
        check(dl_equal, "hal: a display-list replay differs from the "
              "direct draw")

        # HAL_PROFILED of the sphere's triangles (its equator band), drawn
        # again on the script's state under torch.profiler: each triangle
        # runs the same full-frame composite.
        t0 = time.monotonic()
        pos, nrm, idx = hf.sphere(hf.FULL["rings"], hf.FULL["segments"])
        band = hf.FULL["rings"] // 2 * hf.FULL["segments"] * 6
        part = idx[band:band + 3 * HAL_PROFILED]
        ctx.DrawPrimitive(hf.TRI, part, {"positions": pos, "normals": nrm})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ctx.DrawPrimitive(hf.TRI, part, {"positions": pos,
                                             "normals": nrm})
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        check(len(dev) > 0, "hal: the profiler recorded no device activity")
        sphere["profiled_triangles"] = HAL_PROFILED
        sphere["device_launches"] = len(dev)
        sphere["device_ms"] = device_us(dev) / 1e3
        step("profile_s", t0)

        # The cut script at HAL_SMALL, card against CPU.
        t0 = time.monotonic()
        _r, ctx_g, _o = hal_run(O, "cuda", HAL_SMALL, HAL_SMALL_SCRIPT)
        fb_g, zb_g = ctx_g.BackToFront(), ctx_g.zb.cpu().numpy()
        step("script_small_card_s", t0)
        t0 = time.monotonic()
        check(len(cpu) == 1, "hal: the sphere draw was not timed")
        fb_c, zb_c, cpu_s = cpu[0].result()
        step("cpu_wait_s", t0)
    errs = {}
    for name, g, c in (("fb", fb_g, fb_c), ("zb", zb_g, zb_c)):
        diff = np.abs(g.astype(np.float64) - c)
        errs[name] = {"max_abs_err": float(diff.max()),
                      "share_past_1e-5": float((diff > 1e-5).mean())}
        check(errs[name]["share_past_1e-5"] <= 1e-3
              and errs[name]["max_abs_err"] <= 1e-4,
              f"hal: {name} card against CPU {errs[name]}")
    res = {"size": list(HAL_SIZE), "triangles": out["triangles"],
           "vertices": out["vertices"], "covered": covered,
           "finite": finite, "zb_range": [float(zb.min()), float(zb.max())],
           "launches": got, "display_list_equal": dl_equal,
           "sphere": sphere,
           "device_launches_per_triangle": (sphere["device_launches"]
                                            / HAL_PROFILED),
           "device_ms_per_triangle": sphere["device_ms"] / HAL_PROFILED,
           "host_ms_per_sphere_draw": sphere["host_ms"],
           "card_vs_cpu": {"size": list(HAL_SMALL), **errs,
                           "cpu_s": cpu_s, "cpu_threads": threads},
           "steps": steps, "phase_s": time.monotonic() - t_phase,
           "card": card}
    emit("hal", **res)
    return res


MONITOR_TICKS = 3


def render_counted(rc, kernel_fns, launches) -> dict:
    """One Render() of ``rc`` with every launch count at 0 first: its
    CUDA-event ms and its launches (added to ``launches``)."""
    reset_launches(kernel_fns.values())
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    rc.Render()
    e1.record()
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    return {"frame_ms": e0.elapsed_time(e1), "launches": got}


def plain_mips(feed, levels: int) -> list:
    """The feed (4, H, W) and its mip levels by the plain rule: each texel
    of a level the mean of a 2x2 block of the level above, summed as
    (t00 + t01) + (t10 + t11) over strided views, then divided by 4."""
    out = [feed]
    for _ in range(1, levels):
        x = out[-1]
        nh, nw = max(x.shape[1] // 2, 1), max(x.shape[2] // 2, 1)
        x = x[:, :nh * 2, :nw * 2]
        out.append(((x[:, 0::2, 0::2] + x[:, 0::2, 1::2])
                    + (x[:, 1::2, 0::2] + x[:, 1::2, 1::2])) / 4.0)
    return out


def monitor_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """Render-to-texture and stereo through Render() on the card:
    ``scenes.build_config5_monitor`` (config 5, 528,032 triangles, at
    1024x768 in stereo, eye separation 1.2; a 512x384 producer context
    renders the level from a security camera into the texture a screen in
    the level samples with a trilinear filter).

    - MONITOR_TICKS ticks (turn the spinner, Render() the producer, then
      the main context), each frame with every launch count at 0 first:
      B1 once per producer frame and twice per stereo frame (once per eye)
      and nothing else; the first stereo frame takes the packed path, the
      later ones the eager fallback (they sample the live feed). After
      each producer frame the texture's device image equals its fb.
    - The last tick's feed in the main frame's stack: its rect equals the
      feed and each mip level the plain 2x2 means, bit for bit.
    - The packed stereo path on the last tick's state equals the fallback's
      frame bit for bit.
    - B1 with e-planes at the left eye's inputs equals its plain version.
    - Device ms and launches of one producer frame, one stereo frame and
      one frame of the main context with stereo off (torch.profiler).
    - Golden: the level at 320x240 with a 160x120 producer, second tick,
      against ``tests/torch_golden/monitor_320x240.npz``."""
    from ckrenderengine_tpu_torch.raster import cuda_tiled

    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_golden"))
    import make_golden as mg

    t_phase = time.monotonic()
    ctx, rc, producer, spinner = scenes.build_config5_monitor(
        O, device="cuda", stereo=(1.2, 60.0))
    feed = ctx.GetObjectByName("monitor_feed")
    ticks = []
    for k in range(MONITOR_TICKS):
        if k:
            spinner.Rotate((0, 1, 0), mg.MONITOR_SPIN)
        p = render_counted(producer, kernel_fns, launches)
        check(torch.equal(feed.device_image(), producer.fb),
              f"monitor tick {k}: the texture differs from the producer's "
              "frame")
        s = render_counted(rc, kernel_fns, launches)
        # StereoEagerFallback stays set once a frame took the fallback.
        ticks.append({"producer": p, "stereo": s,
                      "fallback": rc.stats.StereoEagerFallback})
    finite, covered = frame_checks("config5_monitor", rc)
    want_p = {k: 0 for k in kernel_fns}
    want_p["B1"] = 1
    want_s = dict(want_p, B1=2)
    for k, t in enumerate(ticks):
        check(t["producer"]["launches"] == want_p
              and t["stereo"]["launches"] == want_s,
              f"monitor tick {k}: launches {t}")
    check(not ticks[0]["fallback"] and ticks[1]["fallback"]
          and rc._compiled.dev_ids,
          "monitor: the stereo frames did not take packed, then fallback")

    # The feed and its mips in the last frame's stack.
    static, eyes, dyn_i, params = mg.stereo_inputs(rc)
    (texdev,), (rect,) = params["texdev"], params["texdev_rects"]
    pi, oy, ox, h, w, mip_col, levels, chw = rect
    check(texdev is feed.device_image() and chw and levels > 1,
          f"monitor: the frame's feed {rect}")
    dyn_i = torch.as_tensor(dyn_i, device="cuda")
    eyes = [torch.as_tensor(df, device="cuda") for df in eyes]
    scene, _d = fr.unpack_scene(static, eyes[0], dyn_i, params["layout"],
                                texdev=params["texdev"],
                                texdev_rects=params["texdev_rects"])
    planes = scene.tex_planes[pi]
    mips_equal = []
    for lv, want in enumerate(plain_mips(texdev, levels)):
        y0 = oy + (0 if lv <= 1 else h - (h >> (lv - 1)))
        x0 = ox + (0 if lv == 0 else mip_col)
        mips_equal.append(bool(torch.equal(
            planes[:, y0:y0 + want.shape[1], x0:x0 + want.shape[2]], want)))
    check(all(mips_equal), f"monitor: feed levels equal {mips_equal}")

    # The packed path on the same state: the fallback's frame.
    fb0, zb0 = rc.fb.clone(), rc.zb.clone()
    rc._render_stereo_packed([], [])
    packed_equal = bool(torch.equal(rc.fb, fb0) and torch.equal(rc.zb, zb0))
    check(packed_equal, "monitor: packed stereo differs from the fallback")

    # B1 with e-planes at the left eye's inputs against its plain version.
    H, W = rc.height, rc.width
    _sc, batch, setup, defer, _bits = fr.packed_setup(static, eyes[0], dyn_i,
                                                      params)
    a = cuda_tiled.phase_a(setup, defer, scene.viewport, batch.xyw, H, W,
                           **fr._solve_caps(batch.valid.shape[0], None))
    init = cuda_tiled._init_plane(scene.clear_z, H, W, a["tiles_y"] * 32,
                                  a["tiles_x"] * 32, "cuda")
    args = (a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
            a["sbase"], scene.viewport, W, H, init, 32, a["tiles_x"],
            a["tiles_y"], a["n_planes"], True)
    b1_equal = all(x is None and y is None or torch.equal(x, y) for x, y in
                   zip(cuda_tiled.solve_tiled_kernel(*args),
                       cuda_tiled.solve_phase_b_plain(*args)))
    check(b1_equal, "monitor: B1 and its plain version disagree at the "
          "eye's inputs")

    # What one producer frame and one stereo frame put on the card, and
    # one frame of the main context without stereo (which culls chunks).
    dev = {}
    for name, ctx_ in (("producer", producer), ("stereo", rc),
                       ("mono", rc)):
        if name == "mono":
            rc.SetStereoParameters(0.0, 60.0)
        n, ms, wall = device_window(ctx_.Render, 1)
        dev[name] = {"device_launches": n, "device_ms": ms,
                     "profiled_frame_ms": wall}
    emit("monitor", config="config5_monitor", card=card,
         size=[rc.width, rc.height],
         producer_size=[producer.width, producer.height],
         triangles=int(rc._compiled.n_valid_tris), ticks=ticks,
         finite=finite, covered=covered, feed_levels=levels,
         feed_levels_equal=mips_equal, packed_equals_fallback=packed_equal,
         b1_equals_plain_at_eye=b1_equal,
         stereo_frame_ms_median=float(np.median(
             [t["stereo"]["frame_ms"] for t in ticks[1:]])),
         producer_frame_ms_median=float(np.median(
             [t["producer"]["frame_ms"] for t in ticks[1:]])),
         per_frame=dev)

    # The golden frame's size on the card.
    reset_launches(kernel_fns.values())
    rc_g, _p = mg.monitor_ticks(O, device="cuda")
    rc_g.Render()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    static, eyes, dyn_i, params = mg.stereo_inputs(rc_g)
    dyn_i = torch.as_tensor(dyn_i, device="cuda")
    ids = mg.side_by_side(*(fr.render_frame_packed(
        static, torch.as_tensor(df, device="cuda"), dyn_i, **params,
        want_stats=True)[2]["WinnerIds"].cpu().numpy() for df in eyes),
        rc_g.width)
    g = np.load(mg.MONITOR_OUT)
    rgba = rc_g.BackToFront()
    c = rc_g._compiled
    entity = c.vert_entity[c.tri_idx[:, 0]]
    screen = rc_g.context.GetObjectByName("screen").row
    match = ids == g["ids"]
    diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32)).max(-1)
    off = (diff > 1) & match
    on_screen = (ids >= 0) & (entity[ids] == screen)
    emit("golden", frame="monitor_320x240", ids_equal_frac=float(match.mean()),
         rgba_pixels_over_1_matching=int(off.sum()),
         rgba_max_diff_matching=int(diff[match].max()),
         off_pixels_on_screen=bool(on_screen[off].all()), launches=got)
    check(rgba.shape == g["rgba"].shape, "golden monitor_320x240: shape")
    check(match.mean() >= 0.999, "golden monitor_320x240: winner ids differ")
    check(off.sum() <= 1e-3 * match.sum() and on_screen[off].all(),
          f"golden monitor_320x240: {int(off.sum())} pixels")
    # Two ticks of the producer, one packed stereo frame and the fallback.
    check(got == dict(want_p, B1=6),
          f"golden monitor_320x240: launches {got}")
    emit("monitor_phase", seconds=round(time.monotonic() - t_phase, 1))
    return dev


API_WINDOW = 8
API_STEP = 5.0       # world units the camera moves before the DrawScene


def plain_b1():
    """Swap B1's wrapper for its plain version (no launch counted) while
    the returned function has not been called; it restores the wrapper."""
    from ckrenderengine_tpu_torch.raster import cuda_tiled

    kernel = cuda_tiled.solve_tiled_kernel

    def plain(*args, kchunk: int = 128, row0: int = 0):
        return cuda_tiled.solve_phase_b_plain(*args, row0=row0)

    cuda_tiled.solve_tiled_kernel = plain

    def restore():
        cuda_tiled.solve_tiled_kernel = kernel

    return restore


def api_phase(O, scenes, kernel_fns, launches, card) -> dict:
    """The render context and manager API through Render() on the card:
    ``scenes.build_config5`` (528,032 triangles) at 1024x768.

    - Render(), then BackupScreen().
    - SetGlobalRenderMode(texture=False), Render(): the winner ids and the
      depth equal the textured frame's, the colours differ where it
      sampled a texture; texturing back on.
    - RestoreScreenBackup(): DumpToMemory() equals the first frame bit
      for bit.
    - Render(), CopyFromMemoryBuffer of a seeded 1024x768 image, the
      camera API_STEP forward, DrawScene(): B1 once, with the kept depth,
      and nothing else; pixels it does not draw keep the image. The same
      sequence with B1's plain version on the card gives the same fb and
      zb bit for bit.
    - A post-sprite callback, a post-render callback and a temporary
      pre-render callback fire once per Render() in the reference's order
      (temporary, post-sprite, post), eagerly and in a window of
      API_WINDOW; after PostProcess() the temporary one is gone.
    - DestroyDevice() lowers torch.cuda.memory_allocated() by at least
      the bytes of the compiled scene's uploads (GetMemoryOccupation()
      less fb and zb) and drops the window's graphs; the next Render()
      equals the first frame bit for bit.
    - Process() renders the context and skips an inactive second one."""
    t_phase = time.monotonic()
    b1_start = launches["B1"]
    ctx, rc, _spinner = scenes.build_config5(O, device="cuda")
    rm = ctx.GetRenderManager()
    cam = rc.GetAttachedCamera()
    home = cam.GetLocalMatrix()
    step = home.copy()
    fwd = home[2, :3] / np.linalg.norm(home[2, :3])
    step[3, :3] += API_STEP * fwd
    frames = {"first": render_counted(rc, kernel_fns, launches)}
    fb0, zb0 = rc.fb.clone(), rc.zb.clone()
    ids0 = winners(rc)
    rc.BackupScreen()

    rc.SetGlobalRenderMode(texture=False)
    frames["texture_off"] = render_counted(rc, kernel_fns, launches)
    ids1 = winners(rc)
    ids_equal = bool(np.array_equal(ids0, ids1))
    zb_equal = bool(torch.equal(rc.zb, zb0))
    untextured = int((rc.fb != fb0).any(0).sum())
    check(ids_equal and zb_equal, "api: the untextured frame's winners or "
          "depths differ from the textured frame's")
    check(untextured > 0, "api: texturing off changed no pixel")
    rc.SetGlobalRenderMode(texture=True)
    check(rc.RestoreScreenBackup(), "api: no screen backup")
    restored = bool(np.array_equal(
        rc.DumpToMemory(), np.moveaxis(fb0.cpu().numpy(), 0, -1)))
    check(restored, "api: the restored screen differs from the first frame")

    image = np.random.default_rng(18).integers(
        0, 256, (rc.height, rc.width, 3), dtype=np.uint8)

    def draw_over(name):
        cam.SetLocalMatrix(home)
        frames[name + "_render"] = render_counted(rc, kernel_fns, launches)
        check(rc.CopyFromMemoryBuffer(image), "api: CopyFromMemoryBuffer")
        under = (rc.fb.clone(), rc.zb.clone())
        cam.SetLocalMatrix(step)
        reset_launches(kernel_fns.values())
        rc.DrawScene()
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in kernel_fns.items()}
        for k in got:
            launches[k] += got[k]
        frames[name] = {"launches": got}
        return under, (rc.fb.clone(), rc.zb.clone())

    (fb_img, zb_kept), (fb_ds, zb_ds) = draw_over("draw_scene")
    want = {k: 0 for k in kernel_fns}
    want["B1"] = 1
    check(frames["draw_scene"]["launches"] == want,
          f"api: the DrawScene frame launched {frames['draw_scene']}")
    img = torch.as_tensor(np.moveaxis(image, -1, 0).astype(np.float32)
                          / 255.0, device="cuda")
    check(torch.equal(fb_img[:3], img) and bool((fb_img[3] == 1).all())
          and torch.equal(zb_kept, zb0),
          "api: CopyFromMemoryBuffer did not write the image over the "
          "kept depth")
    drawn = zb_ds != zb_kept
    drawn_frac = float(drawn.float().mean())
    behind = int((zb_ds[drawn] > zb_kept[drawn]).sum())
    recoloured = int((fb_ds != fb_img).any(0)[~drawn].sum())
    check(0.05 < drawn_frac < 1.0, f"api: DrawScene drew {drawn_frac}")
    check(behind == 0 and recoloured == 0,
          f"api: DrawScene drew {behind} pixels behind the kept depth and "
          f"changed {recoloured} it did not draw")
    restore = plain_b1()
    try:
        _under, (fb_p, zb_p) = draw_over("draw_scene_plain")
    finally:
        restore()
    plain_equal = bool(torch.equal(fb_p, fb_ds) and torch.equal(zb_p, zb_ds))
    check(frames["draw_scene_plain"]["launches"]["B1"] == 0,
          "api: the plain sequence launched B1")
    check(plain_equal, "api: the DrawScene frame differs from the same "
          "sequence with B1's plain version")

    cam.SetLocalMatrix(home)
    seen = []
    rc.AddPostSpriteRenderCallBack(lambda dev, a: seen.append("sprite"))
    rc.AddPostRenderCallBack(lambda dev, a: seen.append("post"))
    order = ["temp", "sprite", "post"]
    calls = {}
    for window in (1, API_WINDOW):
        rc.SetFramePipelining(window)
        rm.AddTemporaryPreRenderCallback(lambda dev, a: seen.append("temp"),
                                         rc=rc)
        seen.clear()
        reset_launches(kernel_fns.values())
        for _ in range(window):
            rc.Render()
        rm.PostProcess()
        rc.Render()
        rc.SetFramePipelining(1)
        torch.cuda.synchronize()
        for k, fn in kernel_fns.items():
            launches[k] += fn.launches
        calls[window] = list(seen)
        check(seen == order * window + order[1:],
              f"api: callbacks at W = {window}: {seen}")
    rc.ClearCallbacks()

    torch.cuda.synchronize()
    held = rc.GetMemoryOccupation() - sum(
        b.numel() * b.element_size() for b in (rc.fb, rc.zb))
    mem_before = torch.cuda.memory_allocated()
    check(rc.DestroyDevice(), "api: DestroyDevice")
    mem_after = torch.cuda.memory_allocated()
    freed = mem_before - mem_after
    check(held > 0 and freed >= held and rc._window is None
          and rc._batch is None,
          f"api: DestroyDevice freed {freed} bytes of the {held} the "
          f"compiled scene's uploads held, window {rc._window}, batch "
          f"{rc._batch}")
    frames["rebuilt"] = render_counted(rc, kernel_fns, launches)
    rebuilt_equal = bool(torch.equal(rc.fb, fb0) and torch.equal(rc.zb, zb0))
    check(rebuilt_equal, "api: the frame after DestroyDevice differs from "
          "the first")

    rc2 = rm.CreateRenderContext(64, 48)
    rc2.AttachViewpointToCamera(cam)
    hits = []
    rc.AddPreRenderCallBack(lambda dev, a: hits.append("rc"))
    rc2.AddPreRenderCallBack(lambda dev, a: hits.append("rc2"))
    rc2.Activate(False)
    reset_launches(kernel_fns.values())
    rm.Process()
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    check(hits == ["rc"] and got == want,
          f"api: Process() rendered {hits}, launches {got}")
    seconds = time.monotonic() - t_phase
    emit("api", config="config5", card=card, size=[rc.width, rc.height],
         triangles=int(rc._compiled.n_valid_tris),
         frame_ms={k: round(v["frame_ms"], 3) for k, v in frames.items()
                   if "frame_ms" in v},
         draw_scene_launches=frames["draw_scene"]["launches"],
         draw_scene_drawn_frac=drawn_frac,
         draw_scene_equals_plain_b1=plain_equal,
         untextured_ids_equal=ids_equal, untextured_pixels=untextured,
         restored_equals_first=restored, callbacks=calls,
         memory_allocated_mib=[round(mem_before / 2**20, 1),
                               round(mem_after / 2**20, 1)],
         destroy_freed_bytes=freed, scene_upload_bytes=held,
         rebuilt_equals_first=rebuilt_equal, process_rendered=hits,
         b1_launches=launches["B1"] - b1_start)
    emit("api_phase", seconds=round(seconds, 1))
    return frames


IMM_SIZE = (1024, 768)
# The card-against-CPU tick: the level cut as the golden frames cut it.
IMM_SMALL = dict(width=128, height=96, terrain_n=70, n_balls=8)
IMM_PICKS = 16
IMM_SEED = 19


def imm_callbacks(rc):
    """The draws of rc's callbacks in Render()'s order: each mesh's render
    callback, then the context's post-render callbacks."""
    for obj in list(rc.context._prerender_objects.values()):
        rcb = getattr(obj, "render_callback", None)
        if rcb is not None:
            rcb[0](rc, obj, rcb[1])
    for _kind, fct, arg, _t in rc.post_render_callbacks:
        fct(rc, arg)


# The CPU worker's context between its two jobs (one worker process).
_IMM_CPU = {}


def imm_cpu_level(threads: int) -> dict:
    """``build_config5_immediate`` at IMM_SMALL on the CPU, in a worker
    process of its own (spawned: it never touches the card): the level
    frame with the callbacks off, its winners, fb, zb and 8-bit image.
    The context stays in the worker for :func:`imm_cpu_draws`."""
    sys.path.insert(0, ROOT)
    import ckrenderengine_tpu_torch.objects as O
    from ckrenderengine_tpu_torch import scenes

    torch.set_num_threads(threads)
    t0 = time.monotonic()
    _c, rc, _s, imm = scenes.build_config5_immediate(O, device="cpu",
                                                     **IMM_SMALL)
    imm["on"] = False
    render_keeping_ids(rc)
    _IMM_CPU.update(rc=rc, imm=imm)
    return {"ids": winners(rc), "rgba": rc.BackToFront(),
            "fb": rc.fb.numpy().copy(), "zb": rc.zb.numpy().copy(),
            "seconds": time.monotonic() - t0}


def imm_cpu_draws() -> dict:
    """The callbacks' draws over the worker's level frame (fb, zb)."""
    t0 = time.monotonic()
    rc, imm = _IMM_CPU["rc"], _IMM_CPU["imm"]
    imm["on"] = True
    imm_callbacks(rc)
    return {"fb": rc.fb.numpy(), "zb": rc.zb.numpy(),
            "seconds": time.monotonic() - t0}


def imm_screen_box(rc, clip) -> tuple:
    """Pixel box (x0, y0, x1, y1), end-exclusive, that holds every pixel
    a draw of the clip-space vertices ``clip`` can touch; the whole frame
    when a vertex lies on or behind the eye plane."""
    x, y, w, h = rc.viewport
    clip = np.asarray(clip, np.float64)
    if clip.shape[0] == 0:
        return (0, 0, 0, 0)
    if not (clip[:, 3] > 1e-6).all():
        return (0, 0, rc.width, rc.height)
    sx = x + (clip[:, 0] / clip[:, 3] + 1.0) * 0.5 * w
    sy = y + (1.0 - clip[:, 1] / clip[:, 3]) * 0.5 * h
    # Points draw as right triangles 1.5 pixels wide around each vertex.
    return (max(int(np.floor(sx.min())) - 3, 0),
            max(int(np.floor(sy.min())) - 3, 0),
            min(int(np.ceil(sx.max())) + 3, rc.width),
            min(int(np.ceil(sy.max())) + 3, rc.height))


def imm_spy():
    """Wrap ``vertexbuffer.draw_clip`` (every immediate draw of the object
    API): each call's screen box, triangles (padded as drawn) and host ms
    (no synchronise). Returns (record, restore)."""
    from ckrenderengine_tpu_torch.objects import vertexbuffer as vbm

    draw = vbm.draw_clip
    rec = {"boxes": [], "host_ms": [], "triangles": 0, "padded": 0}

    def spy(rc, prim_type, pos, col, uv, state=None, texture=None):
        n = len(pos)
        t = (n if prim_type == 1 else
             n - 2 if prim_type in (5, 6) else n // 3)
        rec["boxes"].append(imm_screen_box(rc, pos))
        rec["triangles"] += t
        rec["padded"] += max(8, -(-t // 8) * 8)
        t0 = time.perf_counter()
        ok = draw(rc, prim_type, pos, col, uv, state, texture)
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
        return ok

    vbm.draw_clip = spy

    def restore():
        vbm.draw_clip = draw

    return rec, restore


def imm_entity_ids(rc, fr):
    """The off tick's winner ids with chunk culling off (so each id is a
    triangle of the compiled stream) and each triangle's entity."""
    rc._chunk_select = lambda c, view, proj: None
    try:
        ids = frame_with(rc)[2]["WinnerIds"].cpu().numpy()
    finally:
        del rc._chunk_select
    c = rc._compiled
    rows = c.vert_entity[c.tri_idx[:, 0]]
    by_row = {e.row: e for e in rc._scene_entities()}
    return ids, rows, by_row


def imm_pick_pixels(ids, rows, excluded, n: int) -> list:
    """Up to ``n`` pixels whose 3x3 neighbourhood has one winner triangle,
    outside ``excluded``: in a seeded order, taken in turn from each
    winner entity (``rows`` of the winner triangles), so that the picks
    reach the spheres as well as the terrain."""
    h, w = ids.shape
    same = np.zeros_like(ids, dtype=bool)
    same[1:-1, 1:-1] = ids[1:-1, 1:-1] >= 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            same[1:-1, 1:-1] &= (ids[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
                                 == ids[1:-1, 1:-1])
    ys, xs = np.nonzero(same & ~excluded)
    groups = {}
    for i in np.random.default_rng(IMM_SEED).permutation(len(ys)):
        groups.setdefault(int(rows[ids[ys[i], xs[i]]]), []).append(
            (int(xs[i]), int(ys[i])))
    out = []
    while len(out) < n and any(groups.values()):
        for g in groups.values():
            if g and len(out) < n:
                out.append(g.pop(0))
    return out


def imm_one_triangle(rc):
    """A function that composites one triangle of the HUD quad onto rc's
    fb / zb through ``render_pass``, as each triangle of an immediate
    draw is composited (the draw pads its batch to a multiple of 8 with
    invalid triangles, each composited the same way)."""
    from ckrenderengine_tpu_torch.convert import device_batch_from_host
    from ckrenderengine_tpu_torch.raster import batch as rbatch
    from ckrenderengine_tpu_torch.raster.torch_backend import render_pass
    from ckrenderengine_tpu_torch.raster.types import (
        RasterState, VXCULL, pack_states,
    )

    clip = np.array([[[-0.95, 0.95, 0.0, 1.0], [-0.55, 0.95, 0.0, 1.0],
                      [-0.55, 0.7, 0.0, 1.0]]], np.float32)
    tb = rbatch.make_batch(clip, view=rc.viewport,
                           color=np.full((1, 3, 4), 0.5, np.float32))
    db = device_batch_from_host(tb, "cuda")
    si, sf = (torch.as_tensor(a, device="cuda") for a in pack_states(
        [RasterState(cull=int(VXCULL.NONE))]))
    planes = torch.zeros((1, 4, 1, 1), device="cuda")
    hw = torch.ones((1, 2), dtype=torch.int32, device="cuda")
    fog = torch.zeros(3, device="cuda")
    vp = torch.tensor(rc.viewport, dtype=torch.float32, device="cuda")

    def one():
        rc.fb, rc.zb = render_pass(rc.fb, rc.zb, db, si, sf, planes, hw,
                                   fog, vp)

    return one


def imm_project(rc, ent, local) -> tuple:
    """Screen point of ``ent``'s local point under rc's camera."""
    view, proj, (vx, vy, vw, vh) = rc._last_cam
    p = np.append(np.asarray(local, np.float32), 1.0) @ ent.GetWorldMatrix()
    c = p @ view @ proj
    return (float(vx + (c[0] / c[3] + 1.0) * 0.5 * vw),
            float(vy + (1.0 - c[1] / c[3]) * 0.5 * vh))


def immediate_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """Picking and immediate-mode draws over the Ballance level on the
    card: ``scenes.build_config5_immediate`` at 1024x768 (528,032 level
    triangles; 8 render-callback props, 2 of them alpha-tested cards with
    holes, 4 blended props drawn by RenderTransparents, 64 Sprite3D halos
    through CallSprite3DBatches and a HUD fan through LockCurrentVB: 274
    immediate triangles in 14 draws, 328 as padded).

    - The tick with its callbacks: B1 once and nothing else; each draw's
      screen box, triangles and host ms (``imm_spy``). The same tick with
      the callbacks off: B1 once; with B1's plain version: the same fb and
      zb bit for bit. Pixels outside every draw's box equal the
      callback-free tick's, bit for bit.
    - One triangle's composite under torch.profiler (each padded
      triangle of a draw runs one): device launches and ms per triangle.
    - Pick3D at IMM_PICKS pixel centres whose 3x3 neighbourhood has one
      winner triangle, outside the draws' boxes and the annex and hidden
      rooms' boxes (portals cull or clip those in the frame, not in
      picking): each returns the winner triangle's entity; host ms per
      Pick3D. PickRect over the viewport lists every visible meshed
      entity whose render extents are on screen. Through a hole of a
      card, Pick(precise_texture=True) returns what Pick3D finds with the
      card hidden; through a solid texel, the card.
    - The tick at IMM_SMALL on the card and on the CPU (a worker process
      started after the timed draws, beside the rest of the phase): the
      level frame's winners on >= 99.9% of the pixels and its 8-bit image
      within 1 where they agree (the golden frames' tolerance); the
      callbacks' draws over the CPU's level frame on both, bit for bit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ckrenderengine_tpu_torch.frame_bench import device_us

    t_phase = time.monotonic()
    steps = {}

    def step(name, t0):
        steps[name] = round(time.monotonic() - t0, 3)

    t0 = time.monotonic()
    ctx, rc, _spinner, imm = scenes.build_config5_immediate(
        O, *IMM_SIZE, device="cuda")
    step("build_s", t0)
    rec, restore = imm_spy()
    t0 = time.monotonic()
    try:
        on = render_counted(rc, kernel_fns, launches)
    finally:
        restore()
    fb_on, zb_on = rc.fb.clone(), rc.zb.clone()
    step("tick_s", t0)
    # The CPU worker starts once the timed draws are done (clean host ms);
    # it runs beside the rest of the phase on threads the picks leave free.
    threads = max(1, (os.cpu_count() or 2) - 4)
    ex = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    job_level = ex.submit(imm_cpu_level, threads)
    job_draws = ex.submit(imm_cpu_draws)
    try:
        want = {k: 0 for k in kernel_fns}
        want["B1"] = 1
        check(on["launches"] == want, f"immediate: the tick launched {on}")
        check(len(rec["boxes"]) == 14 and rec["triangles"] == 274
              and rec["padded"] == 328,
              f"immediate: {len(rec['boxes'])} draws of {rec['triangles']} "
              f"triangles")
        t0 = time.monotonic()
        imm["on"] = False
        off = render_counted(rc, kernel_fns, launches)
        fb_off, zb_off = rc.fb.clone(), rc.zb.clone()
        check(off["launches"] == want, f"immediate: the off tick {off}")
        restore_b1 = plain_b1()
        try:
            reset_launches(kernel_fns.values())
            rc.Render()
            torch.cuda.synchronize()
            plain_got = {k: fn.launches for k, fn in kernel_fns.items()}
        finally:
            restore_b1()
        b1_plain_equal = bool(torch.equal(rc.fb, fb_off)
                              and torch.equal(rc.zb, zb_off))
        check(plain_got["B1"] == 0 and b1_plain_equal,
              f"immediate: the level frame differs from B1's plain version's "
              f"({plain_got})")
        step("off_ticks_s", t0)
        finite = bool(torch.isfinite(fb_on).all() and torch.isfinite(zb_on).all())
        check(finite, "immediate: non-finite fb or zb")
        boxed = torch.zeros((rc.height, rc.width), dtype=torch.bool,
                            device="cuda")
        for x0, y0, x1, y1 in rec["boxes"]:
            boxed[y0:y1, x0:x1] = True
        outside = ~boxed
        untouched_equal = bool(
            torch.equal(fb_on[:, outside], fb_off[:, outside])
            and torch.equal(zb_on[outside], zb_off[outside]))
        drawn = float((fb_on != fb_off).any(0).float().mean())
        boxed_frac = float(boxed.float().mean())
        check(untouched_equal, "immediate: pixels outside every draw's box "
              "differ from the callback-free tick")
        check(0.005 < drawn <= boxed_frac < 0.9,
              f"immediate: the draws changed {drawn} of the frame, their boxes "
              f"cover {boxed_frac}")

        # One immediate triangle's composite (what each padded triangle of a
        # draw runs), profiled: device launches and ms per triangle.
        t0 = time.monotonic()
        one = imm_one_triangle(rc)
        one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        check(len(dev) > 0, "immediate: the profiler saw no device work")
        profiled = {"triangles": 1, "device_launches": len(dev),
                    "device_ms": device_us(dev) / 1e3}
        step("profile_s", t0)

        # Picking against the off tick's winners.
        t0 = time.monotonic()
        imm["on"] = False
        rc.Render()
        ids, rows, by_row = imm_entity_ids(rc, fr)
        excluded = boxed.cpu().numpy()
        rooms = [e for e in rc._scene_entities()
                 if e.GetParent() is not None
                 and e.GetParent().GetName() in ("place_annex", "place_hidden")]
        for e in rooms:
            ext = rc.GetObjectExtents(e)
            if ext is not None:
                l, t, r, b = ext
                excluded[int(t):int(np.ceil(b)) + 1, int(l):int(np.ceil(r)) + 1] \
                    = True
        pixels = imm_pick_pixels(ids, rows, excluded, IMM_PICKS)
        check(len(pixels) >= 16, f"immediate: only {len(pixels)} pick pixels")
        pick_ms, picked = [], []
        for x, y in pixels:
            want_ent = by_row.get(int(rows[ids[y, x]]))
            t1 = time.perf_counter()
            got, dist = rc.Pick3D(x + 0.5, y + 0.5)
            pick_ms.append((time.perf_counter() - t1) * 1e3)
            picked.append((x, y, want_ent.GetName() if want_ent else None,
                           got.GetName() if got else None))
        mismatched = [p for p in picked if p[2] != p[3]]
        check(not mismatched, f"immediate: Pick3D against the winners "
              f"{mismatched}")
        listed = rc.PickRect((0, 0, rc.width, rc.height))
        expect = [e for e in rc._scene_entities() if e.IsVisible()
                  and e.GetCurrentMesh() is not None
                  and rc.GetObjectExtents(e) is not None]
        check([e.GetName() for e in listed] == [e.GetName() for e in expect],
              "immediate: PickRect over the viewport lists "
              f"{[e.GetName() for e in listed]} for "
              f"{[e.GetName() for e in expect]}")
        card_ent = imm["cards"][0]
        # The card's UVs follow its local x and y; its -z face (towards the
        # camera) shows the whole image: a hole at texels (2, 2), a solid
        # texel at (2, 6).
        hole = imm_project(rc, card_ent, (-1.125, 1.125, -1.5))
        solid = imm_project(rc, card_ent, (-0.375, 1.125, -1.5))
        through = rc.Pick(*hole, precise_texture=True)[0]
        card_ent.Show(False)
        behind = rc.Pick3D(*hole)[0]
        card_ent.Show(True)
        hole_ok = (rc.Pick(*hole)[0] is card_ent and through is not card_ent
                   and through is behind
                   and rc.Pick(*solid, precise_texture=True)[0] is card_ent)
        check(hole_ok, f"immediate: the precise pick through the card's hole "
              f"gave {through and through.GetName()}, behind it "
              f"{behind and behind.GetName()}")
        step("picks_s", t0)

        # The small tick, card against CPU: the worker's level frame, then the
        # draws over it on both.
        t0 = time.monotonic()
        _c, rc_g, _s, imm_g = scenes.build_config5_immediate(
            O, device="cuda", **IMM_SMALL)
        imm_g["on"] = False
        rc_g.Render()
        ids_g, rgba_g = winners(rc_g), rc_g.BackToFront()
        step("small_card_s", t0)
        t0 = time.monotonic()
        cpu = job_level.result()
        step("cpu_level_wait_s", t0)
        match = ids_g == cpu["ids"]
        diff = np.abs(rgba_g.astype(np.int32) - cpu["rgba"].astype(np.int32))
        level = {"ids_equal_frac": float(match.mean()),
                 "rgba_max_diff_matching": int(diff[match].max())}
        check(level["ids_equal_frac"] >= 0.999
              and level["rgba_max_diff_matching"] <= 1,
              f"immediate: the small level frame, card against CPU {level}")
        t0 = time.monotonic()
        rc_g.fb = torch.as_tensor(cpu["fb"], device="cuda")
        rc_g.zb = torch.as_tensor(cpu["zb"], device="cuda")
        imm_g["on"] = True
        imm_callbacks(rc_g)
        fb_g, zb_g = rc_g.fb.cpu().numpy(), rc_g.zb.cpu().numpy()
        step("small_draws_s", t0)
        t0 = time.monotonic()
        cpu_draws = job_draws.result()
        step("cpu_draws_wait_s", t0)
    finally:
        ex.shutdown(cancel_futures=True)
    draws_equal = bool(np.array_equal(fb_g, cpu_draws["fb"])
                       and np.array_equal(zb_g, cpu_draws["zb"]))
    check(draws_equal, "immediate: the draws over the CPU's level frame "
          "differ between the card and the CPU")
    seconds = time.monotonic() - t_phase
    tri = rec["triangles"]
    res = {"config": "config5_immediate", "card": card,
           "size": list(IMM_SIZE),
           "triangles": int(rc._compiled.n_valid_tris),
           "draws": len(rec["boxes"]), "immediate_triangles": tri,
           "padded_triangles": rec["padded"],
           "tick_launches": on["launches"],
           "tick_ms": round(on["frame_ms"], 3),
           "off_tick_ms": round(off["frame_ms"], 3),
           "host_ms_per_draw": [round(v, 3) for v in rec["host_ms"]],
           "host_ms_per_draw_mean": float(np.mean(rec["host_ms"])),
           "host_ms_per_padded_triangle": sum(rec["host_ms"])
           / rec["padded"],
           "device_launches_per_triangle": profiled["device_launches"],
           "device_ms_per_triangle": profiled["device_ms"],
           "drawn_frac": drawn, "boxed_frac": boxed_frac,
           "untouched_equal": untouched_equal,
           "b1_plain_equal": b1_plain_equal,
           "picks": len(pixels), "pick_entities": sorted(
               {p[2] for p in picked}),
           "host_ms_per_pick3d": float(np.mean(pick_ms)),
           "host_ms_per_pick3d_max": float(np.max(pick_ms)),
           "pick_rect": len(listed), "precise_hole": hole_ok,
           "small": {"size": [IMM_SMALL["width"], IMM_SMALL["height"]],
                     **level, "draws_bit_equal": draws_equal,
                     "cpu_level_s": round(cpu["seconds"], 3),
                     "cpu_draws_s": round(cpu_draws["seconds"], 3),
                     "cpu_threads": threads},
           "steps": steps, "phase_s": round(seconds, 3)}
    emit("immediate", **res)
    emit("immediate_phase", seconds=round(seconds, 1), card=card)
    return res


DBG_SIZE = (1024, 768)
# The card-against-CPU tick: the level cut as the golden frames cut it.
DBG_SMALL = dict(width=128, height=96, terrain_n=70, n_balls=8)
DBG_FRAME_MS = 16.5          # FrameTime set before each tick: one label text
DBG_IK_ATOL = 1e-4           # bone matrices, card against CPU
DBG_STRIP_FACES = 48_000     # the terrain's first 48 rows of quads
DBG_PROFILED = 4             # label composites per profiler window


def dbg_tick(rc, dbg, k: int, target: int) -> float:
    """One debug tick before Render(): IKSetEffectorPos towards target
    ``target`` of the path, then DebugStep from ``k`` - 1 to ``k``, and
    FrameTime fixed so the label's text is known. Returns the host ms of
    the IK call."""
    t0 = time.perf_counter()
    dbg["chain"].IKSetEffectorPos(dbg["targets"][target])
    ms = (time.perf_counter() - t0) * 1e3
    rc.SetDebugObjectCount(k - 1)
    check(rc.DebugStep() == k, f"debug: DebugStep did not reach {k}")
    rc.stats.FrameTime = DBG_FRAME_MS
    return ms


def dbg_boxes(rc) -> np.ndarray:
    """(H, W) bool on the host: the stepping label's box at (4, 4) and the
    PV watermark's (32x8, 2 pixels in from the bottom-left corner)."""
    box = np.zeros((rc.height, rc.width), bool)
    if rc._dbg_label[1] is not None and rc.GetDebugObjectCount() >= 0:
        h, w = rc._dbg_label[1].shape[:2]
        box[4:4 + h, 4:4 + w] = True
    box[rc.height - 10:rc.height - 2, 2:34] = True
    return box


def dbg_cpu_tick(threads: int) -> dict:
    """``build_config5_debug`` at DBG_SMALL on the CPU, in a worker process
    of its own (spawned: it never touches the card): the stepped tick of
    :func:`debug_phase`'s small run, its winners, 8-bit image, label text
    and the arm's bone matrices."""
    sys.path.insert(0, ROOT)
    import ckrenderengine_tpu_torch.objects as O
    from ckrenderengine_tpu_torch import scenes

    torch.set_num_threads(threads)
    t0 = time.monotonic()
    _c, rc, _s, dbg = scenes.build_config5_debug(O, device="cpu",
                                                 **DBG_SMALL)
    n = rc.context.entity_table.count
    dbg_tick(rc, dbg, n // 2, 1)
    render_keeping_ids(rc)
    return {"ids": winners(rc), "rgba": rc.BackToFront(),
            "label": rc._dbg_label[0],
            "bones": np.stack([b.GetWorldMatrix() for b in dbg["bones"]]),
            "seconds": time.monotonic() - t0}


def debug_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """Debug stepping, the grid, the IK arm and the geometry tools over the
    Ballance level on the card: ``scenes.build_config5_debug`` at
    1024x768 (config 5's 528,032 triangles, a shown 64x64 grid with two
    layers, a 16-bone skinned arm driven by a CKKinematicChain,
    EnableDebugMode, the PV watermark from a post-render callback).

    - The stepped tick (IKSetEffectorPos, then DebugStep to half the
      entity count; the grid and the arm come first in render order): B1
      and L1 once each and nothing else. The same tick with B1's plain
      version: fb and zb bit-equal. L1 at the tick's line-pass inputs
      equal to its plain version. With EnableDebugMode off, the same
      count: every pixel outside the label's and the watermark's boxes
      bit-equal.
    - k = 0: only the clear colour outside the two boxes. DebugStep walks
      0, 1, ..., n and wraps to -1.
    - The label's composite under torch.profiler: device launches and ms
      per composite.
    - IK: each target of the path reached within the chain's tolerance;
      host ms per IKSetEffectorPos (each iteration reads its joint angles
      back from the card).
    - Grid: GetGridCoordinates(GetPositionFromCoordinates(x, y)) == (x, y)
      on every square.
    - Geometry (host): RadixSorter over the tick's view depths (the mean
      corner w of every triangle of the stream, chunk culling off) equal to a
      stable np.argsort; NvStripifier on DBG_STRIP_FACES terrain faces,
      each face in one strip; PlaceFitter between two adjacent terrain
      pieces; host ms of each, and which path (native or numpy) ran.
    - The tick at DBG_SMALL on the card and on the CPU (a worker process
      started after the timed IK): winners on >= 99.9% of the pixels, the
      8-bit image within 1 where they agree (the golden frames'
      tolerance), the same label text, the bones within DBG_IK_ATOL."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import device_us, profile_window
    from ckrenderengine_tpu_torch.pipeline import lines as ll
    from ckrenderengine_tpu_torch.pipeline.overlay import composite_label
    from ckrenderengine_tpu_torch.utils import (
        NvStripifier, PlaceFitter, RadixSorter, native, strip_to_triangles,
    )

    t_phase = time.monotonic()
    steps = {}

    def step(name, t0):
        steps[name] = round(time.monotonic() - t0, 3)

    fns = dict(kernel_fns, **line_fns(ll))
    for k in line_fns(ll):
        launches.setdefault(k, 0)
    t0 = time.monotonic()
    ctx, rc, _spinner, dbg = scenes.build_config5_debug(
        O, *DBG_SIZE, device="cuda")
    n = ctx.entity_table.count
    mid = n // 2
    step("build_s", t0)
    t0 = time.monotonic()
    ik_first_ms = dbg_tick(rc, dbg, mid, 0)
    tick = render_counted(rc, fns, launches)
    fb_on, zb_on = rc.fb.clone(), rc.zb.clone()
    label = rc._dbg_label[0]
    step("tick_s", t0)
    want = {k: 0 for k in fns}
    want.update(B1=1, L1=1, L1_bins=1)
    check(tick["launches"] == want, f"debug: the stepped tick launched {tick}")
    check(label.endswith(f"({mid}/{n}) {DBG_FRAME_MS:.1f} ms"),
          f"debug: label {label!r}")
    check(bool(torch.isfinite(fb_on).all()), "debug: non-finite fb")

    # IK over the target path; then the tick's pose back, for the checks
    # below that render the tick again.
    t0 = time.monotonic()
    chain = dbg["chain"]
    pose = [b.GetLocalMatrix().copy() for b in dbg["bones"]]
    ik_ms, ik_err, ik_ok = [], [], []
    for t in dbg["targets"]:
        t1 = time.perf_counter()
        ik_ok.append(bool(chain.IKSetEffectorPos(t)))
        ik_ms.append((time.perf_counter() - t1) * 1e3)
        eff = dbg["bones"][-1].GetWorldMatrix()[3, :3]
        ik_err.append(float(np.linalg.norm(eff - t)))
    check(all(ik_ok) and max(ik_err) < 1e-3,
          f"debug: IK targets missed {ik_ok} {ik_err}")
    for b, m in zip(dbg["bones"], pose):
        b.SetLocalMatrix(m)
    step("ik_s", t0)

    # The CPU worker starts once the timed IK is done (clean host ms); it
    # runs beside the rest of the phase on threads the phase leaves free.
    threads = max(1, (os.cpu_count() or 2) - 4)
    ex = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    job = ex.submit(dbg_cpu_tick, threads)
    try:
        # The same tick with B1's plain version, then L1 against its plain
        # version at the tick's line-pass inputs.
        t0 = time.monotonic()
        restore_b1 = plain_b1()
        try:
            reset_launches(fns.values())
            rc.stats.FrameTime = DBG_FRAME_MS
            rc.Render()
            torch.cuda.synchronize()
            plain_got = {k: fn.launches for k, fn in fns.items()}
        finally:
            restore_b1()
        b1_plain_equal = bool(torch.equal(rc.fb, fb_on)
                              and torch.equal(rc.zb, zb_on))
        check(plain_got["B1"] == 0 and b1_plain_equal,
              f"debug: the tick differs from B1's plain version's ({plain_got})")
        rc.stats.FrameTime = DBG_FRAME_MS
        s = line_inputs(rc, ll)
        l1_err = check_l1(ll, s["fb"], s["zb"], s["rows"], s["h"], s["w"],
                          0.0, "debug")[0]
        step("plain_s", t0)

        # The debug mode off at the same count: only the label's box differs
        # (the watermark is the scene's callback, drawn in both).
        t0 = time.monotonic()
        boxes = dbg_boxes(rc)
        rm = ctx.GetRenderManager()
        rm.SetRenderOptions("EnableDebugMode", 0)
        rc.stats.FrameTime = DBG_FRAME_MS
        rc.Render()
        rm.SetRenderOptions("EnableDebugMode", 1)
        outside = torch.as_tensor(~boxes, device=rc.fb.device)
        untouched_equal = bool(torch.equal(rc.fb[:, outside], fb_on[:, outside])
                               and torch.equal(rc.zb, zb_on))
        label_changed = float((rc.fb != fb_on).any(0).float().mean())
        check(untouched_equal, "debug: pixels outside the label's and the "
              "watermark's boxes differ from the tick without the debug mode")
        check(label_changed > 0, "debug: the label drew nothing")

        # k = 0: only the clear colour outside the boxes; the step's wrap.
        rc.SetDebugObjectCount(0)
        rc.stats.FrameTime = DBG_FRAME_MS
        rc.Render()
        clear = torch.as_tensor(rc.background_color, device=rc.fb.device)
        empty = bool((rc.fb[:, outside] == clear[:, None]).all())
        check(empty, "debug: the k = 0 frame shows more than the clear colour")
        rc.SetDebugObjectCount(-1)
        walk = [rc.DebugStep() for _ in range(n + 2)]
        check(walk == list(range(n + 1)) + [-1],
              f"debug: DebugStep walked {walk[:4]} ... {walk[-3:]}")
        step("checks_s", t0)

        # The label's composite alone, DBG_PROFILED calls in a padded
        # profiler window, taken again until its device records are a
        # whole multiple of the calls (a window may lose records).
        t0 = time.monotonic()
        img = rc._dbg_label[1]

        def device(prof):
            return [e for e in prof.events()
                    if e.device_type == DeviceType.CUDA]

        prof, _wall = profile_window(
            lambda: composite_label(rc.fb, img, 4, 4), DBG_PROFILED,
            [ProfilerActivity.CUDA],
            lambda p: len(device(p)) > 0
            and len(device(p)) % DBG_PROFILED == 0, label="label")
        dev = device(prof)
        check(len(dev) > 0 and len(dev) % DBG_PROFILED == 0,
              f"debug: the profiler saw {len(dev)} device records")
        label_launches = len(dev) // DBG_PROFILED
        label_ms = device_us(dev) / 1e3 / DBG_PROFILED
        step("profile_s", t0)
        # Grid round trip on every square.
        t0 = time.monotonic()
        grid = dbg["grid"]
        bad = [(x, y) for y in range(grid.GetLength())
               for x in range(grid.GetWidth())
               if grid.GetGridCoordinates(
                   grid.GetPositionFromCoordinates(x, y)) != (x, y)]
        check(not bad, f"debug: grid round trip fails at {bad[:8]}")
        step("grid_s", t0)

        # Geometry tools on the level's data.
        t0 = time.monotonic()
        rc.SetDebugObjectCount(-1)
        rc._chunk_select = lambda c, view, proj: None
        try:
            _scene, batch, _su, _df, _bits = fr.packed_setup(
                *packed_cuda(rc))
        finally:
            del rc._chunk_select
        w = batch.xyw[..., 2].mean(-1).cpu().numpy()
        t1 = time.perf_counter()
        order = RadixSorter().Sort(w).GetIndices()
        radix_ms = (time.perf_counter() - t1) * 1e3
        neg_zero = int(np.signbit(w[w == 0]).sum())
        radix_equal = bool(np.array_equal(order, np.argsort(w, kind="stable")))
        check(radix_equal and neg_zero == 0,
              f"debug: the radix order differs from np.argsort "
              f"({neg_zero} negative zeros)")
        terrain = next(o for o in ctx._objects.values()
                       if isinstance(o, O.CKMesh) and o.GetName() == "terrain")
        faces = terrain.faces[:DBG_STRIP_FACES]
        t1 = time.perf_counter()
        strips = NvStripifier().Stripify(faces)
        strip_ms = (time.perf_counter() - t1) * 1e3
        covered = sum(len(strip_to_triangles(st)) for st in strips)
        check(covered == len(faces), f"debug: the strips cover {covered} "
              f"of {len(faces)} faces")
        v = terrain.positions
        near = (np.abs(v[:, 0]) <= 30.0) & (np.abs(v[:, 2]) < 30.0)
        t1 = time.perf_counter()
        fit = PlaceFitter.ComputeBestFitBBox(v[near & (v[:, 0] <= 0.0)],
                                             v[near & (v[:, 0] >= 0.0)])
        fit_ms = (time.perf_counter() - t1) * 1e3
        check(fit is not None and abs(float(fit[0][0])) < 1e-3,
              f"debug: PlaceFitter between the terrain pieces gave {fit}")
        step("geometry_s", t0)

        # The small tick, card against CPU.
        t0 = time.monotonic()
        _c, rc_g, _s, dbg_g = scenes.build_config5_debug(
            O, device="cuda", **DBG_SMALL)
        dbg_tick(rc_g, dbg_g, rc_g.context.entity_table.count // 2, 1)
        rc_g.Render()
        ids_g, rgba_g = winners(rc_g), rc_g.BackToFront()
        bones_g = np.stack([b.GetWorldMatrix() for b in dbg_g["bones"]])
        step("small_card_s", t0)
        t0 = time.monotonic()
        cpu = job.result()
        step("cpu_wait_s", t0)
    finally:
        ex.shutdown(cancel_futures=True)
    match = ids_g == cpu["ids"]
    diff = np.abs(rgba_g.astype(np.int32) - cpu["rgba"].astype(np.int32))
    bone_err = float(np.abs(bones_g - cpu["bones"]).max())
    small = {"size": [DBG_SMALL["width"], DBG_SMALL["height"]],
             "ids_equal_frac": float(match.mean()),
             "rgba_max_diff_matching": int(diff[match].max()),
             "label_equal": rc_g._dbg_label[0] == cpu["label"],
             "bone_max_abs_err": bone_err,
             "cpu_s": round(cpu["seconds"], 3), "cpu_threads": threads}
    check(small["ids_equal_frac"] >= 0.999
          and small["rgba_max_diff_matching"] <= 1 and small["label_equal"]
          and bone_err <= DBG_IK_ATOL,
          f"debug: the small tick, card against CPU {small}")
    seconds = time.monotonic() - t_phase
    res = {"config": "config5_debug", "card": card, "size": list(DBG_SIZE),
           "triangles": int(rc._compiled.n_valid_tris), "entities": n,
           "step": mid, "label": label, "tick_launches": tick["launches"],
           "tick_ms": round(tick["frame_ms"], 3),
           "b1_plain_equal": b1_plain_equal, "l1_max_abs_err": l1_err,
           "untouched_equal": untouched_equal,
           "label_pixels_frac": label_changed, "k0_clear_only": empty,
           "label_composite_device_launches": label_launches,
           "label_composite_device_ms": label_ms,
           "ik_targets": len(ik_ms), "ik_reached": all(ik_ok),
           "ik_max_err": max(ik_err),
           "host_ms_per_ik_set_effector_pos": float(np.mean(ik_ms)),
           "host_ms_per_ik_set_effector_pos_max": float(np.max(ik_ms)),
           "ik_first_ms": round(ik_first_ms, 3),
           "grid_squares": grid.GetWidth() * grid.GetLength(),
           "native_path": native.available(),
           "radix_values": int(w.size), "radix_host_ms": radix_ms,
           "radix_equal": radix_equal,
           "stripify_faces": len(faces), "strips": len(strips),
           "stripify_host_ms": strip_ms, "place_fit_host_ms": fit_ms,
           "small": small, "steps": steps, "phase_s": round(seconds, 3)}
    emit("debug", **res)
    emit("debug_phase", seconds=round(seconds, 1), card=card)
    return res


# Scene IO: the DXT-textured, progressive-mesh level saved, loaded into a
# fresh context and rendered again.
IO_SIZE = (1024, 768)
IO_DECODE_SIZE = 1024          # texels per side of the timed DXT surfaces
IO_PROFILED = 3                # frames per profiler window


def png_pixels(path: str) -> np.ndarray:
    """The pixels of an 8-bit grey or RGBA PNG without interlace whose
    scanlines all take filter type 0 (as ``io/png.py`` writes them), read
    with zlib: (H, W) or (H, W, 4) uint8."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0], f"{path}: bad CRC")
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _c, _f, interlace = head
    chans = {0: 1, 6: 4}[ctype]
    check(depth == 8 and interlace == 0, f"{path}: header {head}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * chans)
    check(not rows[:, 0].any(), f"{path}: a scanline filter other than 0")
    img = rows[:, 1:].reshape(h, w, chans)
    return img[..., 0] if chans == 1 else img


def dxt_decode_ms_per_mib(fmt: str, seed: int) -> float:
    """Host ms per MiB of blocks of ``io.dds.decode_dxt`` on a seeded
    IO_DECODE_SIZE-square surface (best of 3)."""
    from ckrenderengine_tpu_torch.io.dds import decode_dxt

    s = IO_DECODE_SIZE
    blocks = np.random.default_rng(seed).bytes(
        (s // 4) ** 2 * (8 if fmt == "DXT1" else 16))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        img = decode_dxt(blocks, s, s, fmt)
        best = min(best, time.perf_counter() - t0)
    check(img.shape == (s, s, 4) and np.isfinite(img).all(),
          f"decode_dxt {fmt}: {img.shape}")
    return best * 1e3 / (len(blocks) / 2**20)


def io_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """Scene IO and the progressive mesh through Render() on the card:
    ``scenes.build_config5_io`` at 1024x768 (config 5's 528,032 terrain
    triangles; its checker a DXT1 DDS file with a mip chain, the spheres'
    skin DXT3 blocks through SetCompressedImage, 12 alpha-over signs
    textured from a DXT5 DDS file, the shared sphere a progressive mesh at
    half of its vertices, geomorphed halfway).

    - The level's first frame: B1 once, B4 once per peel round, nothing
      else.
    - ``ctx.Save`` to a temporary directory (not the repository), the file
      loaded into a fresh ``CKContext(device="cuda")`` by
      ``scenes.load_level`` (a render context of the same settings), and
      its first frame: B1 once, B4 as often, fb and zb bit-equal to the
      saved level's frame.
    - B1 and B5 (``time_rows``) and B4 (``time_ordered``) at the loaded
      frame's inputs, each equal to its plain version there.
    - ``DumpToFile(what="both")`` of the loaded frame: the colour PNG,
      decoded with zlib, equal to ``BackToFront()``; the z and stencil
      PNGs equal to the buffers they dump.
    - A ``CopyObject`` clone of a ball in the loaded level, moved in front
      of the camera, against a ball built by hand at the same place in the
      saved level: fb and zb bit-equal.
    - Save and load seconds, the file's size, DXT decode host ms per MiB,
      CreatePM and SetPMVertexCount host ms, the LOD's triangles, device
      ms and launches of the saved and the loaded frame (torch.profiler).
    """
    import tempfile

    from ckrenderengine_tpu_torch.raster import (
        cuda_ordered as co, cuda_tiled,
    )
    from ckrenderengine_tpu_torch.raster import deferred as df

    t_phase = time.monotonic()
    pm_ms = {}
    originals = {}

    def timed(name):
        fn = originals[name] = getattr(O.CKMesh, name)

        def run(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            pm_ms[name] = (time.perf_counter() - t0) * 1e3
            return out
        return run

    for name in ("CreatePM", "SetPMVertexCount"):
        setattr(O.CKMesh, name, timed(name))
    try:
        t0 = time.monotonic()
        ctx, rc, _spinner = scenes.build_config5_io(O, *IO_SIZE,
                                                    device="cuda")
        build_s = time.monotonic() - t0
    finally:
        for name, fn in originals.items():
            setattr(O.CKMesh, name, fn)
    sphere = ctx.GetObjectByName("sphere")
    pm = {"create_pm_host_ms": pm_ms["CreatePM"],
          "set_pm_vertex_count_host_ms": pm_ms["SetPMVertexCount"],
          "vertices": int(sphere.GetVertexCount()),
          "lod_vertices": int(sphere.GetPMVertexCount()),
          "lod_triangles": int(sphere.GetFaceCount()),
          "full_triangles": int(sphere._pm_full_faces.shape[0])}
    check(sphere.IsPM() and 0 < pm["lod_triangles"] < pm["full_triangles"],
          f"config5_io: the sphere's LOD {pm}")
    decode = {fmt: dxt_decode_ms_per_mib(fmt, 21 + i)
              for i, fmt in enumerate(("DXT1", "DXT3", "DXT5"))}

    want = lambda got: (got["B1"] == 1 and got["B4"] >= 1 and got["B2"] == 0
                        and got["B3"] == 0 and got["B5"] == 0)
    saved = render_counted(rc, kernel_fns, launches)
    frame_checks("config5_io", rc)
    s = rc.GetStats()
    check(want(saved["launches"]) and saved["launches"]["B4"]
          == s.OrderedPeelRounds and s.OrderedReplays == 0,
          f"config5_io: launches {saved['launches']}")
    fb0, zb0 = rc.fb.clone(), rc.zb.clone()

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config5_io.ck")
        t0 = time.monotonic()
        n_objects = ctx.Save(path)
        save_s = time.monotonic() - t0
        size = os.path.getsize(path)
        t0 = time.monotonic()
        ctx2, rc2 = scenes.load_level(O, path, rc, device="cuda")
        load_s = time.monotonic() - t0
        loaded = render_counted(rc2, kernel_fns, launches)
        frame_checks("config5_io_loaded", rc2)
        differ = int(((rc2.fb != fb0).any(0) | (rc2.zb != zb0)).sum())
        check(loaded["launches"] == saved["launches"],
              f"config5_io loaded: launches {loaded['launches']}, saved "
              f"{saved['launches']}")
        check(differ == 0, f"config5_io: the loaded frame differs from the "
              f"saved level's on {differ} pixels")

        # The screen dump of the loaded frame.
        dump = os.path.join(d, "frame.png")
        check(rc2.DumpToFile(dump, "both"), "DumpToFile refused")
        color = png_pixels(dump.replace(".png", "_color.png"))
        z8 = png_pixels(dump.replace(".png", "_z.png"))
        s8 = png_pixels(dump.replace(".png", "_stencil.png"))
        dump_equal = {
            "color": bool(np.array_equal(color, rc2.BackToFront())),
            "z": bool(np.array_equal(z8, np.clip(
                rc2.zbuffer() * 255.0, 0, 255).astype(np.uint8))),
            "stencil": bool(np.array_equal(
                s8, (rc2.stencilbuffer() * 255).astype(np.uint8)))}
        check(all(dump_equal.values()), f"DumpToFile: {dump_equal}")

    # The kernels at the loaded frame's inputs against their plain versions.
    rows = time_rows("config5_io_loaded", rc2, None, card, fr, cuda_tiled,
                     df, plain=False)
    b4 = time_ordered("config5_io_loaded", "B4", rc2, None, card, fr, co)
    prof = {name: profile_frames(r, lambda: None, IO_PROFILED)
            for name, r in (("saved", rc), ("loaded", rc2))}

    # A CopyObject clone of a ball against a ball built by hand.
    where = (6.0, 14.0, -36.0)
    ball = ctx2.GetObjectByName("ball0")
    clone = ctx2.CopyObject(ball, suffix="_copy")
    check(clone is not ball and clone.GetCurrentMesh() is
          ball.GetCurrentMesh() and clone.GetParent() is ball.GetParent(),
          "CopyObject: the clone does not share the ball's mesh and parent")
    clone.SetPosition(where)
    by_hand = O.CK3dObject(ctx, "ball0_copy")
    by_hand.SetCurrentMesh(ctx.GetObjectByName("sphere"))
    by_hand.SetParent(ctx.GetObjectByName("spinner"))
    by_hand.SetPosition(where)
    copy_frames = {}
    for name, r in (("clone", rc2), ("by_hand", rc)):
        copy_frames[name] = render_counted(r, kernel_fns, launches)
        check(want(copy_frames[name]["launches"]),
              f"copy {name}: launches {copy_frames[name]['launches']}")
    copy_differ = int(((rc2.fb != rc.fb).any(0) | (rc2.zb != rc.zb)).sum())
    moved = int((rc2.fb != fb0).any(0).sum())
    check(copy_differ == 0, f"CopyObject: the clone's frame differs from the "
          f"hand-built ball's on {copy_differ} pixels")
    check(moved > 100, f"CopyObject: the clone changes {moved} pixels")

    seconds = time.monotonic() - t_phase
    res = {"card": card, "size": list(IO_SIZE),
           "triangles": int(rc._compiled.n_valid_tris),
           "ordered_triangles": int(rc._compiled.ordered_cap),
           "build_s": round(build_s, 3), "objects_saved": n_objects,
           "save_s": round(save_s, 4), "load_s": round(load_s, 4),
           "file_bytes": size, "dxt_decode_host_ms_per_mib": decode,
           "pm": pm, "saved_frame": {**saved, **prof["saved"]},
           "loaded_frame": {**loaded, **prof["loaded"]},
           "loaded_pixels_that_differ": differ, "dump_equal": dump_equal,
           "copy_pixels_that_differ": copy_differ,
           "copy_pixels_changed": moved,
           "copy_launches": {k: v["launches"] for k, v in copy_frames.items()},
           "phase_s": round(seconds, 3)}
    emit("io", **res)
    emit("io_phase", seconds=round(seconds, 1), card=card)
    return {"B1": rows["B1"], "B5": rows["B5"], "B4": b4}


# Image files: config 5 textured from the files of tests/torch_images/.
IMAGES_SIZE = (1024, 768)
IMAGES_TICKS = 3


def expected_images(scenes) -> dict:
    """``tests/torch_images/expected.npz`` as {file name: (list of RGBA
    uint8 frames, list of durations in ms)}: Pillow's decode of each file,
    made by ``make_images.py`` where Pillow is installed."""
    e = np.load(os.path.join(scenes.IMAGE_DIR, "expected.npz"))
    out = {}
    for name in sorted({k.rsplit(":", 1)[0] for k in e.files}):
        n = sum(1 for k in e.files if k.startswith(name + ":")) - 1
        out[name] = ([e[f"{name}:{k}"] for k in range(n)],
                     e[f"{name}:durations"].tolist())
    return out


def movie_sprite_checks(tag, ctx, rc, scenes, expected) -> list:
    """Each HUD movie sprite of ``scenes.build_config5_images`` (a 64x64
    rect at 1:1, so each pixel centre samples one texel) must show the
    frame of the slot SetMovieTime chose: at every pixel that frame holds
    opaque, ``rc.fb`` equals the frame's RGB / 255 exactly (the composite
    gives ``texel * 1 + dst * 0`` there). Those pixels must tell the frame
    from each other frame of the movie, so that a stale frame fails.
    Returns the slots."""
    slots = []
    for name, fname in scenes.MOVIE_FILES.items():
        sp = ctx.GetObjectByName(name)
        slot = sp.GetCurrentSlot()
        x0, y0, x1, y1 = (int(v) for v in sp.GetRect())
        frames = expected[fname][0]
        want = torch.from_numpy(frames[slot]).to(rc.fb.device)
        opaque = want[..., 3] == 255
        # RGB / 255 on the host, as the sprite's slots were set.
        rgb = torch.from_numpy(frames[slot][..., :3].astype(np.float32)
                               / 255.0).to(rc.fb.device)
        got = rc.fb[:3, y0:y1, x0:x1].permute(1, 2, 0)
        err = (got[opaque] - rgb[opaque]).abs()
        check(bool(opaque.any()) and not bool(err.any()),
              f"{tag}: sprite {name} does not show frame {slot} of "
              f"{fname} at its opaque pixels: {int((err > 0).sum())} "
              f"values differ, by up to {float(err.max()):.3g}")
        for k, other in enumerate(frames):
            o = torch.from_numpy(other[..., :3]).to(rc.fb.device)
            check(k == slot or bool((o[opaque] != want[..., :3][opaque])
                                    .any()),
                  f"{tag}: frames {slot} and {k} of {fname} agree at "
                  f"frame {slot}'s opaque pixels")
        slots.append(slot)
    return slots


def images_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """Image files through the port's readers and a level textured from
    them, on the card: ``scenes.build_config5_images`` at 1024x768
    (config 5's 528,032 terrain triangles; its checker a 512x512 4:2:0
    JPEG, the spheres' skin a 256x256 24-bit BMP, a plaza from an 8-bit
    palette PNG with tRNS, 12 alpha-over signs from a 256x256 32-bit RLE
    TGA, and four HUD sprites playing an animated GIF, an APNG, an MJPG
    AVI written by OpenCV and an MS RLE AVI).

    - Every file of ``tests/torch_images/`` decoded by the port's readers
      (``io/imagefile.py``; ``io/avi.py`` for the AVIs, one per codec it
      reads) equal to ``expected.npz`` (the reference's decode: Pillow's,
      or OpenCV's for an AVI), every frame and every duration; host ms
      per decoded MiB of each reader and of each AVI codec (best of 3, on
      the card machine's host).
    - 3 ticks of the level (each stepping every movie with
      ``SetMovieTime``): B1 once per frame, B4 once per peel round,
      nothing else; B1 and B4 equal to their plain versions at the first
      frame's inputs (``time_rows``, ``time_ordered``); each HUD sprite
      showing the frame of its slot (``movie_sprite_checks``), and each
      sprite's slot moving over the ticks.
    - The same level built with ``SetImage`` of the expected arrays in
      place of ``LoadImage`` / ``LoadMovie``: its 3 frames bit-equal, fb
      and zb, to the loaded level's, and its sprites showing the same
      slots' frames.
    - The phase's seconds, device ms and launches per frame
      (torch.profiler).
    """
    from ckrenderengine_tpu_torch.io import avi, imagefile
    from ckrenderengine_tpu_torch.raster import (
        cuda_ordered as co, cuda_tiled,
    )
    from ckrenderengine_tpu_torch.raster import deferred as df

    t_phase = time.monotonic()
    expected = expected_images(scenes)
    check(set(expected) == set(os.listdir(scenes.IMAGE_DIR))
          - {"expected.npz", "make_images.py"},
          f"images: expected.npz holds {sorted(expected)}")
    decode, totals = {}, {}
    for name, (want, durations) in expected.items():
        path = os.path.join(scenes.IMAGE_DIR, name)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            if name.endswith(".avi"):
                with open(path, "rb") as f:
                    rgb, fps = avi.read_avi(f.read())
                got = []
                for px in rgb:
                    rgba = np.full(px.shape[:2] + (4,), 255, np.uint8)
                    rgba[..., :3] = px
                    got.append((rgba, 1000.0 / fps))
            else:
                it = imagefile.frames(path)
                got = [(imagefile.to_rgba(*f),
                        float(f.info.get("duration", 100.0))) for f in it]
            best = min(best, time.perf_counter() - t0)
        check(len(got) == len(want) and all(
            np.array_equal(g, w) for (g, _d), w in zip(got, want)),
            f"images: {name} differs from expected.npz")
        check([d for _g, d in got] == durations,
              f"images: {name} durations {[d for _g, d in got]}, "
              f"expected {durations}")
        mib = sum(g.nbytes for g, _d in got) / 2**20
        if name.endswith(".avi"):
            # An AVI by its codec and the decoder's pixel format.
            with open(path, "rb") as f:
                kind, fmt = avi.codec(avi.demux(f.read()))
            reader = "_".join(["avi", kind] + ([fmt] if fmt else []))
        else:
            # The reader imagefile picked by the file's content: each is
            # a generator function named read_<format>.
            reader = it.__name__.removeprefix("read_")
        decode[name] = {"reader": reader, "frames": len(got),
                        "decoded_mib": mib, "host_ms": best * 1e3}
        ms, total = totals.get(reader, (0.0, 0.0))
        totals[reader] = (ms + best * 1e3, total + mib)
    per_mib = {r: ms / mib for r, (ms, mib) in totals.items()}
    emit("images_decode", card=card, host_cpu=host_cpu(),
         host_ms_per_decoded_mib=per_mib, files=decode)

    t0 = time.monotonic()
    ctx, rc, _spinner, tick = scenes.build_config5_images(
        O, *IMAGES_SIZE, device="cuda")
    build_s = time.monotonic() - t0
    want = lambda got: (got["B1"] == 1 and got["B4"] >= 1 and got["B2"] == 0
                        and got["B3"] == 0 and got["B5"] == 0)
    frames, ticks = [], []
    for k in range(IMAGES_TICKS):
        tick()
        got = render_counted(rc, kernel_fns, launches)
        s = rc.GetStats()
        check(want(got["launches"]) and got["launches"]["B4"]
              == s.OrderedPeelRounds and s.OrderedReplays == 0,
              f"config5_images tick {k}: launches {got['launches']}")
        frame_checks(f"config5_images_tick{k}", rc)
        frames.append((rc.fb.clone(), rc.zb.clone()))
        ticks.append({**got, "movie_slots": movie_sprite_checks(
            f"config5_images tick {k}", ctx, rc, scenes, expected)})
        if k == 0:
            # The kernels at the first frame's inputs against their plain
            # versions.
            rows = time_rows("config5_images", rc, None, card, fr,
                             cuda_tiled, df, plain=False)
            b4 = time_ordered("config5_images", "B4", rc, None, card, fr,
                              co)
    for i, name in enumerate(scenes.MOVIE_FILES):
        check(len({t["movie_slots"][i] for t in ticks}) > 1,
              f"config5_images: sprite {name} showed one slot in "
              f"{IMAGES_TICKS} ticks")
    prof = profile_frames(rc, tick, IO_PROFILED)

    t0 = time.monotonic()
    c2, rc2, _s2, tick2 = scenes.build_config5_images(
        O, *IMAGES_SIZE, decoded=expected, device="cuda")
    twin_build_s = time.monotonic() - t0
    differ = []
    for k in range(IMAGES_TICKS):
        tick2()
        got = render_counted(rc2, kernel_fns, launches)
        check(got["launches"] == ticks[k]["launches"],
              f"config5_images SetImage twin tick {k}: launches "
              f"{got['launches']}, loaded {ticks[k]['launches']}")
        check(movie_sprite_checks(f"config5_images SetImage twin tick {k}",
                                  c2, rc2, scenes, expected)
              == ticks[k]["movie_slots"],
              f"config5_images SetImage twin tick {k}: movie slots")
        fb, zb = frames[k]
        differ.append(int(((rc2.fb != fb).any(0) | (rc2.zb != zb)).sum()))
    check(not any(differ), f"config5_images: the SetImage level's frames "
          f"differ from the loaded level's on {differ} pixels")

    seconds = time.monotonic() - t_phase
    emit("images", card=card, size=list(IMAGES_SIZE),
         triangles=int(rc._compiled.n_valid_tris),
         ordered_triangles=int(rc._compiled.ordered_cap),
         build_s=round(build_s, 3), twin_build_s=round(twin_build_s, 3),
         ticks=ticks, **prof, pixels_that_differ=differ,
         phase_s=round(seconds, 3))
    emit("images_phase", seconds=round(seconds, 1), card=card)
    return {"B1": rows["B1"], "B4": b4}


FONTS_SIZE = (1024, 768)
FONTS_TICKS = 3
GLYPH_PEN = 32                 # make_glyph_table.py's pen position


def named_glyphs(te2) -> str:
    """``glyphs_dejavu.npz``: DejaVu Sans and Sans Mono at six sizes,
    baked from Pillow by ``make_glyph_table.py`` (a fixture, not read by
    the package)."""
    return os.path.join(os.path.dirname(te2.__file__), "glyphs_dejavu.npz")


def expected_fonts(scenes):
    """``tests/torch_fonts/expected.npz``: Pillow's rasters and text boxes
    (made by ``make_fonts.py`` where Pillow is installed)."""
    return np.load(os.path.join(scenes.FONT_DIR, "expected.npz"))


def hud_rasters(e) -> dict:
    """The HUD rasters of ``expected.npz`` as ``build_config5_text`` takes
    them: {label name or "score:<k>": (H, W, 4) uint8}."""
    return {k[len("hud:"):]: e[k] for k in e.files if k.startswith("hud:")}


def font_sweep(O, scenes, e, card, prefix="sweep") -> dict:
    """Every (face, size, string) of ``expected.npz``'s sweep ``prefix``
    ("sweep", or "rtl" for the right-to-left one) through
    ``CKSpriteText.Redraw()`` on a card context: the image equal to
    Pillow's bytes, the text box to ``textbbox``. Returns host ms per
    raster by size (the first raster of a face and size hints and
    rasterises its glyphs)."""
    from ckrenderengine_tpu_torch.objects import entity2d as te2

    ctx = O.CKContext(device="cuda")
    ms = {}
    for i in range(len(e[f"{prefix}_face"])):
        face = str(e["faces"][e[f"{prefix}_face"][i]])
        path = os.path.join(scenes.FONT_DIR, face)
        size = int(e[f"{prefix}_size"][i])
        text = str(e[f"{prefix}_text"][i])
        w, h = (int(v) for v in e[f"{prefix}_wh"][i])
        sp = O.CKSpriteText(ctx, f"{prefix}{i}")
        sp.Create(w, h)
        sp.SetFont(path, size)
        sp.SetAlign(int(e[f"{prefix}_align"][i]))
        sp.SetTextColor(e[f"{prefix}_fg"][i])
        sp.SetBackgroundTextColor(e[f"{prefix}_bg"][i])
        sp.SetText(text)
        t0 = time.perf_counter()
        got = sp.Redraw().GetImage()
        ms.setdefault(size, []).append((time.perf_counter() - t0) * 1e3)
        want = e[f"{prefix}:{i}"].astype(np.float32) / 255.0
        check(got.shape == want.shape and np.array_equal(got, want),
              f"fonts: {face} at {size} draws {text!r} unlike Pillow")
        box = te2.text_bbox(text, te2.font_table(path, size))
        check(box == tuple(int(v) for v in e[f"{prefix}_bbox"][i]),
              f"fonts: {face} at {size}: text box of {text!r} {box}, "
              f"Pillow {tuple(e[f'{prefix}_bbox'][i])}")
    return {size: sum(v) / len(v) for size, v in sorted(ms.items())}


def glyph_table_redraw(scenes) -> dict:
    """Every glyph of ``glyphs_dejavu.npz`` (DejaVu Sans and Sans Mono at
    six sizes, baked from Pillow by ``make_glyph_table.py``) drawn again by
    the TrueType path: its coverage, box and advance equal to the baked
    ones. Returns the glyph count per table."""
    from ckrenderengine_tpu_torch.objects import entity2d as te2

    counts = {}
    pen = GLYPH_PEN
    for name, table in te2._glyph_file(named_glyphs(te2)).items():
        face = os.path.join(scenes.FONT_DIR, table["meta"]["file"])
        font = te2.font_table(face, int(table["meta"]["size"]))
        for code, (left, top, adv, cov) in table["glyphs"].items():
            ch = chr(code)
            # The coverage white ink leaves in the alpha of a transparent
            # canvas, as the table was baked.
            a = np.zeros((4 * pen, 6 * pen), np.int32)
            font.draw(a, ch, pen, pen)
            ys, xs = np.nonzero(a)
            if ys.size:
                got = (int(xs.min()) - pen, int(ys.min()) - pen,
                       a[ys.min():ys.max() + 1, xs.min():xs.max() + 1])
            else:
                got = (0, 0, np.zeros((0, 0), np.int32))
            check(got[:2] == (left, top) and np.array_equal(got[2], cov),
                  f"fonts: {name} U+{code:04X} differs from the baked "
                  f"coverage")
            check(round(font.getlength(ch) * 64) == adv,
                  f"fonts: {name} U+{code:04X} advance "
                  f"{font.getlength(ch) * 64}, baked {adv}")
        counts[name] = len(table["glyphs"])
    return counts


def fonts_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """TrueType text through the port's own font stack (``text/``: the
    font file, FreeType's bytecode interpreter and smooth rasteriser,
    HarfBuzz's layout as Raqm asks for it), on the host, and a HUD lettered
    with it over the level on the card.

    - The committed faces (``tests/torch_fonts/``) equal, by SHA-256, to
      those ``expected.npz`` and ``glyphs_dejavu.npz`` were made from.
    - Every (face, size, string) of ``expected.npz``'s sweep and of its
      right-to-left sweep (Arabic, Hebrew, bidi) drawn by
      ``CKSpriteText`` equal to Pillow's bytes and text box
      (``font_sweep``); host ms per raster by size, right-to-left beside
      left-to-right.
    - Every glyph of ``glyphs_dejavu.npz`` drawn again equal to the baked
      coverage and advance (``glyph_table_redraw``); µs per glyph of
      hinting and of rasterising, and the glyph caches' bytes.
    - ``scenes.build_config5_text(rtl=True)`` at 1024x768 (config 5's
      528,032 terrain triangles under eleven ``CKSpriteText`` labels: an
      Arabic, a Hebrew and a mixed-direction one among them, and a score
      whose text changes every tick) for 3 ticks: B1 once per frame
      and no other kernel, every label's texture equal to its expected
      raster, B1 equal to its plain version at the first frame's inputs.
    - The same level with the labels' rasters set by ``SetImage``: its 3
      frames bit-equal, fb and zb, to the lettered level's.
    - Each tick's CUDA-event ms and launches, device ms and launches per
      frame (torch.profiler) ticking, turning without a text change and
      turning with every label hidden, and the phase's seconds.
    """
    import hashlib

    from ckrenderengine_tpu_torch.objects import entity2d as te2
    from ckrenderengine_tpu_torch.raster import cuda_tiled
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.text import font as tfont

    t_phase = time.monotonic()
    e = expected_fonts(scenes)
    shas = {}
    for face in scenes.FONT_FILES:
        with open(os.path.join(scenes.FONT_DIR, face), "rb") as f:
            shas[face] = hashlib.sha256(f.read()).hexdigest()
    check([shas[str(f)] for f in e["faces"]] == [str(v) for v in
                                                  e["sha256"]],
          "fonts: the committed faces differ from expected.npz's")
    for name, table in te2._glyph_file(named_glyphs(te2)).items():
        check(shas.get(table["meta"]["file"]) == table["meta"]["sha256"],
              f"fonts: {table['meta']['file']} differs from the file "
              f"glyphs_dejavu.npz table {name} was baked from")
    tfont.FACES.clear()
    t0 = time.monotonic()
    raster_ms = font_sweep(O, scenes, e, card)
    sweep_s = time.monotonic() - t0
    t0 = time.monotonic()
    rtl_ms = font_sweep(O, scenes, e, card, prefix="rtl")
    rtl_s = time.monotonic() - t0
    t0 = time.monotonic()
    glyphs = glyph_table_redraw(scenes)
    redraw_s = time.monotonic() - t0
    faces = list(tfont.FACES.values())
    n_glyphs = sum(len(f.glyphs) for f in faces)
    emit("fonts_host", card=card, host=host_cpu(),
         host_ms_per_raster_by_size=raster_ms,
         sweep_rasters=int(len(e["sweep_face"])), sweep_s=round(sweep_s, 3),
         rtl_host_ms_per_raster_by_size=rtl_ms,
         rtl_sweep_rasters=int(len(e["rtl_face"])), rtl_sweep_s=round(rtl_s,
                                                                   3),
         baked_glyphs_redrawn=glyphs, redraw_s=round(redraw_s, 3),
         glyphs_rasterised=n_glyphs,
         hint_us_per_glyph=sum(f.hint_s for f in faces) / n_glyphs * 1e6,
         raster_us_per_glyph=sum(f.raster_s for f in faces) / n_glyphs
         * 1e6,
         cache_bytes=sum(f.cache_bytes() for f in faces),
         faces_sizes_cached=len(faces))

    rasters = hud_rasters(e)
    t0 = time.monotonic()
    ctx, rc, spinner, tick = scenes.build_config5_text(
        O, *FONTS_SIZE, rtl=True, device="cuda")
    build_s = time.monotonic() - t0
    labels = [row[0] for row in scenes.text_hud(rtl=True)]
    frames, ticks = [], []
    for k in range(FONTS_TICKS):
        tick()
        got = render_counted(rc, kernel_fns, launches)
        check(got["launches"]["B1"] == 1 and sum(
            got["launches"].values()) == 1,
            f"config5_text tick {k}: launches {got['launches']}")
        frame_checks(f"config5_text_tick{k}", rc)
        for name in labels:
            key = f"score:{k + 1}" if name == "score" else name
            want = rasters[key].astype(np.float32) / 255.0
            img = ctx.GetObjectByName(name).GetImage()
            check(img is not None and img.shape == want.shape
                  and np.array_equal(img, want),
                  f"config5_text tick {k}: label {name} differs from "
                  f"Pillow's raster")
        frames.append((rc.fb.clone(), rc.zb.clone()))
        ticks.append(got)
        if k == 0:
            rows = time_rows("config5_text", rc, None, card, fr,
                             cuda_tiled, df, plain=False)
    prof = profile_frames(rc, tick, IO_PROFILED)
    # Where a tick's work goes: the level turning without a text change
    # (no texture patch), then turning with every label hidden.

    def turn():
        spinner.Rotate((0, 1, 0), 0.02)

    turning = profile_frames(rc, turn, IO_PROFILED)
    for name in labels:
        ctx.GetObjectByName(name).Show(False)
    hidden = profile_frames(rc, turn, IO_PROFILED)

    t0 = time.monotonic()
    _c2, rc2, _s2, tick2 = scenes.build_config5_text(
        O, *FONTS_SIZE, rasters=rasters, rtl=True, device="cuda")
    twin_build_s = time.monotonic() - t0
    differ = []
    for k in range(FONTS_TICKS):
        tick2()
        got = render_counted(rc2, kernel_fns, launches)
        check(got["launches"] == ticks[k]["launches"],
              f"config5_text SetImage twin tick {k}: launches "
              f"{got['launches']}, lettered {ticks[k]['launches']}")
        fb, zb = frames[k]
        differ.append(int(((rc2.fb != fb).any(0) | (rc2.zb != zb)).sum()))
    check(not any(differ), f"config5_text: the SetImage level's frames "
          f"differ from the lettered level's on {differ} pixels")

    seconds = time.monotonic() - t_phase
    emit("fonts", card=card, size=list(FONTS_SIZE),
         triangles=int(rc._compiled.n_valid_tris), labels=len(labels),
         build_s=round(build_s, 3), twin_build_s=round(twin_build_s, 3),
         ticks=ticks, **prof, turning_only=turning, labels_hidden=hidden,
         pixels_that_differ=differ,
         phase_s=round(seconds, 3))
    emit("fonts_phase", seconds=round(seconds, 1), card=card)
    return {"B1": rows["B1"]}


AA_SCENES = (("config1", "build_config1", ("B2",)),
             ("config2", "build_config2", ("B1",)),
             ("config5", "build_config5", ("B1",)),
             ("config3", "build_config3", ("B1",)),
             ("config4", "build_config4", ("B1",)),
             ("alpha50k", "build_alpha50k", ("B1", "B3")),
             ("alpha_tex50k", "build_alpha_tex50k", ("B1", "B4")))


def antialias_phase(O, scenes, fr, kernel_fns, launches) -> dict:
    """The seven scenes with the Antialias option on, at their sizes: each
    frame renders at twice the size and resolves to it. Each scene's first
    Render() runs with every launch count at 0 and must launch the kernels
    of its route (B2 at config 1, B1 at the others, B3 at ``alpha50k``,
    B4's rounds at ``alpha_tex50k``), without an ordered replay. Config 5
    again under ``CK_FUSED_FETCH``: B5 once and the frame bit-equal; its
    solve's bin statistics are printed. At configs 1, 2, 5 and ``alpha50k``
    the AA frame must equal ``frame.box_resolve`` of the frame rendered
    without AA at twice the size, bit for bit. Returns {name: (ctx, rc,
    mover)}."""
    out = {}
    for name, build, kernels in AA_SCENES:
        reset_launches(kernel_fns.values())
        t0 = time.monotonic()
        ctx, rc, mover = render_config(getattr(scenes, build), O, "cuda",
                                       antialias=True)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        got = {k: fn.launches for k, fn in kernel_fns.items()}
        for k in launches:
            launches[k] += got[k]
        finite, covered = frame_checks(name + "_aa", rc)
        stats = rc.GetStats()
        for k in kernel_fns:
            check((got[k] > 0) == (k in kernels),
                  f"{name} AA: the frame launched {k} {got[k]} times")
        check(got["B1"] <= 1 and got["B2"] <= 1, f"{name} AA: {got}")
        check(stats.OrderedReplays == 0, f"{name} AA: ordered replay")
        check(got["B4"] == stats.OrderedPeelRounds,
              f"{name} AA: {got['B4']} B4 launches in "
              f"{stats.OrderedPeelRounds} rounds")
        check(tuple(rc.zb.shape) == (rc.height, rc.width),
              f"{name} AA: zb {tuple(rc.zb.shape)}")
        extra = {}
        if rc._compiled.ordered_cap:
            extra["ordered_phase_a"] = ordered_caps_check(rc, fr)
        emit("antialias", config=name, size=[rc.width, rc.height],
             render_size=[2 * rc.width, 2 * rc.height],
             triangles=int(rc._compiled.n_valid_tris), finite=finite,
             covered=covered, launches=got, peel_rounds=stats.OrderedPeelRounds,
             first_frame_s=round(first_s, 3), **extra)
        out[name] = (ctx, rc, mover)

    rc5 = out["config5"][1]
    binstats = frame_with(rc5)[2]["SolveBinStats"].cpu().tolist()
    emit("antialias_binstats", config="config5", binstats=binstats,
         fields=["peak", "live_pairs", "pair_cut_rows", "g_over_rows",
                 "slab_over_rows", "n_small", "n_mid"],
         pair_cap=(rc5._solve_caps or (fr._solve_caps(
             rc5._compiled.tri_idx.shape[0], None)["pair_cap"],))[0])
    fb0, zb0 = rc5.fb.clone(), rc5.zb.clone()
    os.environ["CK_FUSED_FETCH"] = "1"
    reset_launches(kernel_fns.values())
    rc5.Render()
    torch.cuda.synchronize()
    del os.environ["CK_FUSED_FETCH"]
    fused = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in launches:
        launches[k] += fused[k]
    differ = int(((rc5.fb != fb0).any(0) | (rc5.zb != zb0)).sum())
    emit("antialias_fused_fetch", config="config5", launches=fused,
         pixels_that_differ=differ)
    check(fused["B5"] == 1 and fused["B1"] == 0,
          f"config5 AA: fused-fetch frame launches {fused}")
    check(differ == 0, f"config5 AA: the fused-fetch frame differs from the "
          f"default path's on {differ} pixels")

    for name in ("config1", "config2", "config5", "alpha50k"):
        build = getattr(scenes, dict((n, b) for n, b, _k in AA_SCENES)[name])
        rc = out[name][1]
        size = (dict(size=2 * rc.width) if name == "config1"
                else dict(width=2 * rc.width, height=2 * rc.height))
        _c, rc2, _m = render_config(build, O, "cuda", **size)
        fb, zb = fr.box_resolve(rc2.fb, rc2.zb)
        equal = bool(torch.equal(fb, rc.fb) and torch.equal(zb, rc.zb))
        emit("antialias_resolve", config=name, size=[rc.width, rc.height],
             double_size=[rc2.width, rc2.height], bit_equal=equal,
             fb_max_abs_diff=float((fb - rc.fb).abs().max()))
        check(equal, f"{name}: the AA frame differs from the resolve of the "
              "frame at twice the size")
        del rc2, _c
    return out


WINDOW = 8
# (name, build function, keywords, kernels, full windows of ticks): 2W + 3
# ticks at config 5 (its forced pair-cap overflow is redone in the first
# window and governed away in the second), W + 3 (one full window and a
# partial one) at the other scenes.
WINDOW_SCENES = (("config1", "build_config1", {}, ("B2",), 1),
                 ("config2", "build_config2", {}, ("B1",), 1),
                 ("config3", "build_config3", {}, ("B1",), 1),
                 ("config4", "build_config4", {}, ("B1",), 1),
                 ("config5", "build_config5", {}, ("B1",), 2),
                 ("alpha50k", "build_alpha50k", {}, ("B1", "B3"), 1),
                 ("alpha_tex50k", "build_alpha_tex50k", {}, ("B1", "B4"), 1),
                 ("config5_aa", "build_config5", {"antialias": True},
                  ("B1",), 1),
                 ("config5_fx", "build_config5_fx", {},
                  ("B1", "B4", "L1", "L1_bins"), 1),
                 ("config5_mat", "build_config5_mat", {}, ("B1", "B4"), 1))


def window_phase(O, scenes, kernel_fns, launches, card,
                 window_scenes=None) -> dict:
    """Frame windows (``SetFramePipelining``), W = 8, at the scenes' full
    sizes: BASELINE configs 1-5, ``alpha50k``, ``alpha_tex50k``, config 5
    with Antialias, ``config5_fx`` and ``config5_mat``. Each scene renders
    a first frame and then W + 3 ticks (its mover rotating, config 3's and
    4's own tick; 2W + 3 at config 5) once at
    W = 1 and once at W = 8, each in a context of its own. Config 5 (at 1x) starts its ticks with a pair
    cap of 32,768 (under its ~46k live pairs) and
    ``alpha_tex50k`` with one peel round where its frames need two.

    Checks: each window's last fb / zb and the final partial window's, and
    every fence entry, bit-equal to the W = 1 run's frames and
    ``window.checksum`` of them; every copy-and-replay loop runs under
    ``set_sync_debug_mode("error")``; a torch.profiler window over one
    window shows the scene's kernels W times (B4 R times per frame, B5 at
    config 5 with ``CK_FUSED_FETCH``, L1 at ``config5_fx``, whose windows
    each make one read and redo no frame); the forced overflows are flagged
    and redone, the governor bumps config 5's caps and from the next
    window no frame is redone and ``SolveFallbackRows`` is 0. Prints per
    scene the frame ms (median, p75) at W = 1 (each tick synchronised) and
    W = 8 (host wall-clock of two fenced windows, over W), host launch calls
    and device launches and ms per frame with the idle share (profiler),
    and each key's capture ms and graph pool bytes, beside the card.

    ``window_scenes``: other entries in ``WINDOW_SCENES``' form (the
    ``shader`` phase's). Returns {scene: its ``window`` line}."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import (
        device_us, host_launch_calls, profile_window, profiled_kernels,
    )
    from ckrenderengine_tpu_torch.pipeline import window as fw

    @contextlib.contextmanager
    def no_sync():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    captured, reads = [], []
    capture, read = fw.FrameWindow._capture, fw.Pending.read

    def spy_capture(self, slot):
        capture(self, slot)
        captured.append(self)

    def spy_read(self):
        rows = read(self)
        reads.append(rows)
        return rows

    fw.FrameWindow._capture = spy_capture
    fw.Pending.read = spy_read
    fw.REPLAY_GUARD = no_sync
    reset_launches(kernel_fns.values())
    window_scenes = window_scenes or WINDOW_SCENES
    lines = {}
    try:
        for name, build, kw, kernels, n_windows in window_scenes:
            base = name.removesuffix("_aa")
            n_ticks = n_windows * WINDOW + 3

            def fresh():
                ctx, rc, mover = render_config(getattr(scenes, build), O,
                                               "cuda", **kw)
                if name == "config5":
                    rc._solve_caps = (32768,) + tuple(rc._solve_caps[1:])
                if name == "alpha_tex50k":
                    rc._peel_rounds = 1
                return rc, ticker(base, mover)

            # W = 1: every tick's frame, checksum and synchronised time.
            rc1, step1 = fresh()
            eager, lat1 = [], []
            for _ in range(n_ticks):
                t0 = time.monotonic()
                step1()
                rc1.Render()
                torch.cuda.synchronize()
                lat1.append((time.monotonic() - t0) * 1e3)
                eager.append((rc1.fb.clone(), rc1.zb.clone(),
                              fw.checksum(rc1.fb)))
            # CUDA activity alone: it holds the kernels and the runtime's
            # launch and copy calls, without the cost of every CPU op.
            prof1, _w = profile_window(
                lambda: (step1(), rc1.Render()), 1, [ProfilerActivity.CUDA],
                lambda p: sum(profiled_kernels(p).values()) > 0,
                label=name + "_w1")
            # W = 8.
            rc, step = fresh()
            bumps0 = rc.stats.SolveCapBumps
            del captured[:], reads[:]
            rc.SetFramePipelining(WINDOW)
            fences, last = [], []
            for i in range(n_ticks):
                step()
                rc.Render()
                if i % WINDOW == WINDOW - 1 or i == n_ticks - 1:
                    fences.append(rc.GetFrameFence().clone())
                    last.append((i, rc.fb.clone(), rc.zb.clone(),
                                 rc.stats.SolveFallbackRows))
            flagged = [int(fw.flagged(r).sum()) for r in reads]
            n_reads = len(reads)
            frames_ok = all(torch.equal(fb, eager[i][0])
                            and torch.equal(zb, eager[i][1])
                            for i, fb, zb, _f in last)
            want = torch.stack([e[2] for e in eager])
            got = torch.cat([f[:min(WINDOW, n_ticks - WINDOW * k)]
                             for k, f in enumerate(fences)])
            pad_ok = torch.equal(fences[-1][3:], want[-1].expand(WINDOW - 3))
            fences_ok = bool(torch.equal(got, want)) and bool(pad_ok)
            rounds = rc._window.rounds
            lat8 = []
            for _ in range(2):
                t0 = time.monotonic()
                for _ in range(WINDOW):
                    step()
                    rc.Render()
                rc.GetFrameFence().cpu()
                lat8.append((time.monotonic() - t0) * 1e3 / WINDOW)

            def one_window():
                for _ in range(WINDOW):
                    step()
                    rc.Render()
                rc.GetFrameFence()
                torch.cuda.synchronize()

            def whole(p):
                k = profiled_kernels(p)
                return all(k[x] > 0 and k[x] % WINDOW == 0 for x in kernels)

            prof8, _w = profile_window(
                one_window, 1, [ProfilerActivity.CUDA], whole,
                label=name + "_w8")
            seen = profiled_kernels(prof8)
            want_k = {k: (WINDOW * (rounds if k == "B4" else 1)
                          if k in kernels else 0) for k in seen}
            dev8 = [e for e in prof8.events()
                    if e.device_type == DeviceType.CUDA]
            dev1 = [e for e in prof1.events()
                    if e.device_type == DeviceType.CUDA]
            med1, med8 = float(np.median(lat1)), float(np.median(lat8))
            dev_ms1 = device_us(dev1) / 1e3
            dev_ms8 = device_us(dev8) / 1e3 / WINDOW
            keys = [{"capture_ms": w.capture_ms, "pool_bytes": w.pool_bytes}
                    for w in captured]
            s = rc.stats
            lines[name] = dict(
                config=name, card=card, size=[rc.width, rc.height],
                 window=WINDOW, frames=n_ticks, frames_bit_equal=frames_ok,
                 fences_bit_equal=fences_ok, flagged_per_window=flagged,
                 solve_caps=list(rc._solve_caps or ()),
                 cap_bumps=s.SolveCapBumps - bumps0,
                 fallback_rows_after=[x[3] for x in last],
                 peel_rounds=rounds, profiled_kernels=seen,
                 expected_kernels=want_k,
                 frame_ms_w1={"median": med1,
                              "p75": float(np.percentile(lat1, 75))},
                 frame_ms_w8={"median": med8,
                              "p75": float(np.percentile(lat8, 75))},
                 host_launch_calls_per_frame={
                     "w1": host_launch_calls(prof1),
                     "w8": host_launch_calls(prof8) / WINDOW},
                 device_launches_per_frame={"w1": len(dev1),
                                            "w8": len(dev8) / WINDOW},
                 device_ms_per_frame={"w1": dev_ms1, "w8": dev_ms8},
                 device_idle_share={"w1": 1.0 - dev_ms1 / med1,
                                    "w8": 1.0 - dev_ms8 / med8},
                 keys=keys)
            emit("window", **lines[name])
            check(frames_ok, f"{name}: a windowed frame differs from W = 1")
            check(fences_ok, f"{name}: the fences differ from W = 1's "
                  "checksums")
            check(seen == want_k, f"{name}: a window launched {seen}, "
                  f"expected {want_k}")
            if name in ("config5", "alpha_tex50k"):
                check(flagged[0] > 0 and not any(flagged[1:]),
                      f"{name}: flagged frames per window {flagged}")
                check(last[-1][3] == 0 and last[1][3] == 0,
                      f"{name}: fallback rows {[x[3] for x in last]}")
            if name == "config5":
                check(s.SolveCapBumps - bumps0 >= 1, f"{name}: no bump")
            if name == "alpha_tex50k":
                check(rounds == 2, f"{name}: {rounds} peel rounds")
            if name == "config5_fx":
                # One read per window (its rows), and no frame redone.
                check(n_reads == len(fences) and not any(flagged),
                      f"{name}: {n_reads} reads for {len(fences)} "
                      f"windows, flagged {flagged}")
            if name == "config5":
                # The fused fetch inside the graph: B5 once per frame.
                os.environ["CK_FUSED_FETCH"] = "1"
                try:
                    prof5, _w = profile_window(
                        one_window, 1, [ProfilerActivity.CUDA],
                        lambda p: profiled_kernels(p)["B5"] > 0,
                        label="config5_fused_w8")
                finally:
                    del os.environ["CK_FUSED_FETCH"]
                seen5 = profiled_kernels(prof5)
                emit("window_fused_fetch", config=name, card=card,
                     profiled_kernels=seen5)
                check(seen5["B5"] == WINDOW and seen5["B1"] == 0,
                      f"{name}: fused-fetch window launched {seen5}")
            del rc, rc1
    finally:
        fw.FrameWindow._capture = capture
        fw.Pending.read = read
        fw.REPLAY_GUARD = None
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    used = (kernel_fns if window_scenes is WINDOW_SCENES
            else {k for scene in window_scenes for k in scene[3]})
    check(all(got[k] > 0 for k in used),
          f"window phase: wrapper launches {got}")
    return lines


# The effects level's eager ticks after its first frame, and the level cut
# to the golden frame's size.
FX_TICKS = 5
FX_GOLDEN = dict(width=320, height=240, terrain_n=70, n_balls=8,
                 n_sprites=1024, n_curves=4, curve_steps=24)
# The line pass's arithmetic per pair whose pixel lies within half_width of
# the segment: pax, pay, two products and a sum, the division, two products
# and two differences, two squares and a sum (13), then 1 - t, two products
# and a sum for the depth along the segment (4). Comparisons and selects
# are not counted.
OPS_PER_LINE_PAIR = 17


# L1's launches per call, by kernel name: the bin step, then the draw.
L1_PARTS = ("line_bins_kernel", "lines_kernel")


def line_fns(ll) -> dict:
    """L1's wrappers by launch-count key: the draw and its bin step."""
    return {"L1": ll.lines_kernel, "L1_bins": ll.line_bins_kernel}


def bit_equal(a, b) -> bool:
    """Equal bit for bit, a NaN equal to any NaN (the plain version's NaN
    payload is the framework's, the kernel's the segment's own)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(torch.int32)[~na], b.view(torch.int32)[~nb]))


def check_l1(ll, fb, zb, rows, h, w, row0, label) -> tuple:
    """L1 against its plain version at these inputs: the bin kernel's
    words equal to ``line_bins_plain``'s and the frame equal to
    ``draw_lines_plain``'s bit for bit. Returns (max abs error, NaN where
    both are NaN counted 0; the kernel's frame; the bins)."""
    bins_k = ll.line_bins_kernel(rows, h, w, row0)
    bins_p = ll.line_bins_plain(rows, h, w, row0)
    check(torch.equal(bins_k, bins_p),
          f"L1 at {label}: the bins differ from line_bins_plain's on "
          f"{int((bins_k != bins_p).sum())} words")
    out_k = ll.lines_kernel(fb, zb, rows, h, w, row0=row0)
    out_p = ll.draw_lines_plain(fb, zb, rows, h, w, row0=row0)
    both = torch.isnan(out_k) & torch.isnan(out_p)
    err = float(torch.where(both, 0.0, out_k - out_p).abs().max())
    check(bit_equal(out_k, out_p),
          f"L1 and its plain version disagree at {label} ({err})")
    return err, out_k, bins_p


def line_inputs(rc, ll) -> dict:
    """The line pass's inputs at the render size (fb, zb, the projected
    rows, height, width), caught on the way into ``lines.draw_lines``
    during one more Render()."""
    seen = {}
    draw = ll.draw_lines

    def spy(fb, zb, scene, world, bank, h, w, *a, **k):
        seen.update(fb=fb, zb=zb, rows=ll.line_rows(scene, world, bank),
                    h=h, w=w)
        return draw(fb, zb, scene, world, bank, h, w, *a, **k)

    ll.draw_lines = spy
    try:
        rc.Render()
    finally:
        ll.draw_lines = draw
    check("rows" in seen, "the frame drew no line")
    return seen


def bin_counts(bins):
    """Segments in each tile's bin: set bits per row of L1's (tiles,
    words) int32 bins."""
    return sum(((bins >> j) & 1).sum(1) for j in range(32))


def lines_bound(rows, zb, h: int, w: int, ll, row0: float = 0.0) -> dict:
    """L1's roofline from this frame's rows: the pairs whose pixel passes
    the distance test of a valid segment (what any exact line pass
    evaluates in full), at OPS_PER_LINE_PAIR each, against the bytes (fb
    read and written, zb and the rows read once). Also the pairs the
    kernel tests: each bin entry (``line_bins_plain``) times a tile's 256
    pixels. ``row0``: the global row of a band's first row."""
    covered = 0
    inf = torch.full_like(zb, float("inf"))
    for c0 in range(0, rows.shape[0], 32):
        covered += int(ll.line_coverage(rows[c0:c0 + 32], inf, h, w,
                                        row0=row0).sum())
    counts = bin_counts(ll.line_bins_plain(rows, h, w, row0))
    entries = int(counts.sum())
    n_bytes = 2 * 4 * h * w * 4 + h * w * 4 + nbytes(rows)
    ops = covered * OPS_PER_LINE_PAIR
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations_ms": ops_ms, "bytes_ms": bytes_ms,
            "pairs_within_half_width": covered,
            "bin_entries": entries, "largest_bin": int(counts.max()),
            "tested_pairs": entries * ll.TILE_W * ll.TILE_H,
            "operations": ops, "bytes": n_bytes}


def time_lines(name, rc, card, ll) -> tuple:
    """L1 at a frame's own line-pass inputs: its bins checked equal to
    ``line_bins_plain`` and its frame to ``draw_lines_plain`` bit for bit,
    then its own time on the card (torch.profiler), the sum of its
    launches (the bin step and the draw, each by its name), the copy floor
    (the draw with no row at the same fb and zb), its CUDA-event time and
    the plain version's, beside its bound. Returns (kernel ms, plain ms,
    bound, events ms, max abs error); the bound holds the parts and the
    floor."""
    s = line_inputs(rc, ll)
    args = (s["fb"], s["zb"], s["rows"], s["h"], s["w"])
    err, out_k, _bins = check_l1(ll, *args, 0.0, name)
    parts = kernel_parts_ms(lambda: ll.lines_kernel(*args), L1_PARTS)
    st = {"kernel_ms": sum(parts.values()),
          **{f"{k}_ms": v for k, v in parts.items()},
          "copy_floor_ms": kernel_ms(
              lambda: ll.lines_kernel(s["fb"], s["zb"], s["rows"][:0],
                                      s["h"], s["w"]), "lines_kernel"),
          "kernel_events_ms": cuda_ms(lambda: ll.lines_kernel(*args), 20),
          "plain_ms": cuda_ms(lambda: ll.draw_lines_plain(*args), 2)}
    bound = lines_bound(s["rows"], s["zb"], s["h"], s["w"], ll)
    bound.update(parts_ms=parts, copy_floor_ms=st["copy_floor_ms"])
    emit("timing", config=name, card=card, kernel="L1",
         size=[s["w"], s["h"]], segments=int(s["rows"].shape[0]),
         valid_segments=int((s["rows"][:, 6] > 0.5).sum()),
         pixels_changed=int((out_k != s["fb"]).any(0).sum()),
         **{k: round(v, 5) for k, v in st.items()},
         **{k: v for k, v in bound.items()
            if k not in ("parts_ms", "copy_floor_ms")},
         note="kernel_ms is L1's own time on the card (torch.profiler), the "
         "sum of line_bins_kernel_ms and lines_kernel_ms; copy_floor_ms the "
         "draw with no row; plain_ms a CUDA-event mean of draw_lines_plain")
    return st["kernel_ms"], st["plain_ms"], bound, st["kernel_events_ms"], err


def line_fixture(h: int, w: int, seed: int, row0: float = 0.0):
    """Seeded line-pass inputs at h x w: 600 segments, every 9th degenerate
    (both endpoints equal: the squared-length clamp), every 13th with an
    endpoint far off screen (an endpoint behind the camera projects past
    1e6 px: half of them still valid, the others invalid, as the frame
    marks them), 8 invalid pad rows, depths in [-0.1, 1.1]. Then, placed in
    the frame's rows [row0, row0 + h): a segment with a NaN alpha, the
    diagonal across the whole frame, a segment whose endpoints both lie
    off screen, and LINE_FAN segments through one tile (its bin holds more
    than the draw's 2,048-segment chunk of words)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = 600
    rows = torch.zeros((n, 12))
    a = torch.rand((n, 2), generator=g) * torch.tensor([1.2 * w, 1.2 * h]) \
        - torch.tensor([0.1 * w, 0.1 * h])
    rows[:, 0:2] = a
    rows[:, 2:4] = a + torch.randn((n, 2), generator=g) * 60.0
    rows[::9, 2:4] = rows[::9, 0:2]
    rows[1::13, 2:4] = rows[1::13, 0:2] * 3.7e6
    rows[:, 4:6] = torch.rand((n, 2), generator=g) * 1.2 - 0.1
    rows[:, 6] = 1.0
    rows[1::26, 6] = 0.0
    rows[-8:, 6] = 0.0
    rows[:, 8:12] = torch.rand((n, 4), generator=g)
    fb = torch.rand((4, h, w), generator=g)
    zb = torch.rand((h, w), generator=g) * 0.6 + 0.4
    special = torch.tensor([
        [0.2 * w, 0.3 * h, 0.8 * w, 0.35 * h, 0.1, 0.2, 1, 0, .9, .1, .1,
         float("nan")],
        [0.0, 0.0, w, h, 0.15, 0.25, 1, 0, .1, .9, .1, .7],
        [-0.5 * w, 0.6 * h, 1.5 * w, 0.45 * h, 0.1, 0.1, 1, 0, .1, .1, .9,
         .6]])
    th = torch.arange(LINE_FAN) * (2 * np.pi / LINE_FAN) + 0.01
    r = 8.0 + 24.0 * torch.rand(LINE_FAN, generator=g)
    u = torch.stack([th.cos(), th.sin()], 1) * r[:, None]
    c = torch.tensor([0.55 * w, 0.55 * h])
    fan = torch.zeros((LINE_FAN, 12))
    fan[:, 0:2], fan[:, 2:4] = c - u, c + u
    fan[:, 4:6] = torch.rand((LINE_FAN, 2), generator=g) * 0.4
    fan[:, 6] = 1.0
    fan[:, 8:12] = torch.rand((LINE_FAN, 4), generator=g)
    made = torch.cat([special, fan])
    made[:, 1] += row0
    made[:, 3] += row0
    rows = torch.cat([rows[:-8], made, rows[-8:]])
    return fb.cuda(), zb.cuda(), rows.cuda(), row0


def fixture_l1(ll, h: int, w: int, seed: int, row0: float) -> float:
    """L1 on ``line_fixture(h, w, seed, row0)`` at row offset ``row0``:
    bins and frame equal to the plain versions', the NaN alpha in the
    frame, the fan's tile holding the whole fan. Returns the max abs
    error."""
    fb, zb, rows, r0 = line_fixture(h, w, seed, row0)
    label = f"fixture {w}x{h} at row {r0}"
    err, k, bins = check_l1(ll, fb, zb, rows, h, w, r0, label)
    counts = bin_counts(bins)
    largest = int(counts.max())
    changed = int((k != fb).any(0).sum())
    nan_alpha = int(torch.isnan(k[3]).sum())
    emit("line_fixture", size=[w, h], row0=r0, seed=seed,
         segments=int(rows.shape[0]), pixels_changed=changed,
         nan_alpha_pixels=nan_alpha, bin_entries=int(counts.sum()),
         largest_bin=largest, bit_equal=True, max_abs_err=err)
    check(changed > 1000, f"L1 {label}: the lines change too few pixels")
    check(nan_alpha > 0, f"L1 {label}: no NaN alpha in the frame")
    check(largest >= LINE_FAN, f"L1 {label}: the fan's tile holds {largest}")
    return err


# Segments of line_fixture's fan through one tile: more than the 2,048
# segments of the draw's first chunk of 64 words.
LINE_FAN = 2100


def billboard_stage(rc, fr, card) -> dict:
    """The frame's 3D sprite corner stage (``overlay.apply_billboards``)
    on its own at the frame's inputs: device launches and ms per call
    (torch.profiler), CUDA-event ms; it runs once under
    ``set_sync_debug_mode("error")`` first (no host read)."""
    from ckrenderengine_tpu_torch.pipeline.overlay import apply_billboards
    from ckrenderengine_tpu_torch.scene.entity_table import compose_world

    static, dyn_f, dyn_i, params = packed_cuda(rc)
    scene, d = fr.unpack_scene(static, dyn_f, dyn_i, params["layout"])
    world = compose_world(scene.local, scene.parent, params["levels"])
    bank = fr.sprite_bank(params["sprites_static"], d)

    def go():
        return apply_billboards(world, scene.view, scene.positions, bank,
                                scene.entity_visible)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        go()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_dev, dev_ms, _wall = device_window(go, 10)
    out = {"sprites": int(bank.entity_row.shape[0]),
           "device_launches": n_dev, "device_ms": dev_ms,
           "events_ms": cuda_ms(go, 20)}
    emit("billboard_stage", config="config5_fx", card=card, **out,
         note="the sprite corner stage alone at the frame's inputs; "
         "device_ms from torch.profiler, events_ms a CUDA-event mean")
    return out


def fx_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """The effects level, ``scenes.build_config5_fx`` at 1024x768 (config
    5's 528,032 terrain triangles and 64 spheres, 2,048 3D sprites, 16
    curves, a wireframe grid and a line list: 1,192 line segments), through
    Render() on the card.

    - Eager: the first frame and FX_TICKS ticks (the spinner turning)
      with every launch count at 0 before them: B1 once, B4 once per peel
      round and L1 once per frame, and no other kernel (one frame takes one
      ordered route: the textured halos take the peel). The same level with
      untextured halos (``textured_halos=False``) takes B3 in B4's place.
    - The kernels on those frames' own inputs, each equal to its plain
      version bit for bit: B1 and B5 (``time_rows``), B4 and B3
      (``time_ordered``), L1 (``time_lines``); L1 also on seeded fixtures
      (degenerate, off-screen and invalid segments) at 1024x768 and
      2048x1536, with and without a row offset.
    - The sprite corner stage alone (``billboard_stage``).
    - One frame with Antialias (2048x1536): B1, B4's rounds, L1 once, no
      replay; L1 timed at that shape.
    - The level cut to the golden frame's size on the card against the CPU
      (``compare_with_cpu``: every matching pixel within 1/255) and against
      ``tests/torch_golden/fx_320x240.npz`` (as tests/test_torch_golden.py
      holds it: within one 8-bit step on all but 0.1% of the matching
      pixels, where the reference's rounding of a sprite edge or of the
      line pass's band goes the other way).

    The window (8 frames as graph replays) runs in ``window_phase``, whose
    ``window`` line also gives the level's device launches and ms per frame
    eager and at W = 8.
    Returns {kernel: (ms, plain ms, bound, events ms)} at the fx frame and
    the L1 entry's numbers."""
    from ckrenderengine_tpu_torch.pipeline import lines as ll
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co
    from ckrenderengine_tpu_torch.raster import cuda_tiled
    from ckrenderengine_tpu_torch.raster import deferred as df

    t_phase = time.monotonic()
    fns = dict(kernel_fns, **line_fns(ll))
    for k in line_fns(ll):
        launches.setdefault(k, 0)
    out = {}
    rcs = {}
    for name, kw, route in (("config5_fx", {}, "B4"),
                            ("config5_fx_b3", {"textured_halos": False},
                             "B3")):
        reset_launches(fns.values())
        t0 = time.monotonic()
        ctx, rc, spinner = render_config(scenes.build_config5_fx, O, "cuda",
                                         **kw)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        rounds = [rc.GetStats().OrderedPeelRounds]
        for _ in range(FX_TICKS if name == "config5_fx" else 0):
            spinner.Rotate((0, 1, 0), ANGLES["config5_fx"])
            rc.Render()
            rounds.append(rc.GetStats().OrderedPeelRounds)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in fns.items()}
        for k in got:
            launches[k] += got[k]
        frames = 1 + (FX_TICKS if name == "config5_fx" else 0)
        finite, covered = frame_checks(name, rc)
        stats = rc.GetStats()
        want = {"B1": frames, "L1": frames, "L1_bins": frames,
                "B4": sum(rounds) if route == "B4" else 0,
                "B3": frames if route == "B3" else 0, "B2": 0, "B5": 0}
        emit("fx", config=name, size=[rc.width, rc.height],
             triangles=int(rc._compiled.n_valid_tris),
             sprites=len(rc._compiled.sprite3d_list),
             lines=stats.NbLinesDrawn, frames=frames, launches=got,
             expected_launches=want, peel_rounds=rounds,
             replays=stats.OrderedReplays, finite=finite, covered=covered,
             first_frame_s=round(first_s, 3))
        check(got == want, f"{name}: launches {got}, expected {want}")
        check(stats.OrderedReplays == 0, f"{name}: ordered replay")
        rcs[name] = (ctx, rc, spinner)

    rc = rcs["config5_fx"][1]
    out.update(time_rows("config5_fx", rc, None, card, fr, cuda_tiled, df,
                         plain=False))
    out["B4"] = time_ordered("config5_fx", "B4", rc, None, card, fr, co)
    out["B3"] = time_ordered("config5_fx_b3", "B3", rcs["config5_fx_b3"][1],
                             None, card, fr, co)
    l1 = time_lines("config5_fx", rc, card, ll)
    out["L1"] = l1[:4]
    errs = [l1[4]]
    for h, w in ((768, 1024), (1536, 2048)):
        for seed, row0 in ((h, 0.0), (h + 1, 8.0)):
            errs.append(fixture_l1(ll, h, w, seed, row0))
    out["L1_errs"] = errs
    out["billboards"] = billboard_stage(rc, fr, card)
    del rcs

    # Antialias: one frame at twice the size.
    reset_launches(fns.values())
    _c, rc_aa, _m = render_config(scenes.build_config5_fx, O, "cuda",
                                  antialias=True)
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in fns.items()}
    for k in got:
        launches[k] += got[k]
    s = rc_aa.GetStats()
    frame_checks("config5_fx_aa", rc_aa)
    emit("fx_antialias", config="config5_fx", size=[rc_aa.width,
                                                    rc_aa.height],
         render_size=[2 * rc_aa.width, 2 * rc_aa.height], launches=got,
         peel_rounds=s.OrderedPeelRounds, replays=s.OrderedReplays)
    check(got["B1"] == 1 and got["L1"] == 1 and got["L1_bins"] == 1
          and got["B3"] == 0
          and got["B4"] == s.OrderedPeelRounds >= 1 and s.OrderedReplays == 0,
          f"config5_fx AA: launches {got}")
    out["L1_aa"] = time_lines("config5_fx_aa", rc_aa, card, ll)[:4]
    del rc_aa, _c

    # The golden frame's size: card against CPU, and against the golden.
    _c, rc_g, _m = render_config(scenes.build_config5_fx, O, "cuda",
                                 **FX_GOLDEN)
    _c2, rc_c, _m2 = render_config(scenes.build_config5_fx, O, "cpu",
                                   **FX_GOLDEN)
    compare_with_cpu("config5_fx_320x240", rc_g, rc_c)
    g = np.load(os.path.join(GOLDEN_DIR, "fx_320x240.npz"))
    ids = winners(rc_g)
    rgba = rc_g.BackToFront()
    match = ids == g["ids"]
    diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32)).max(-1)
    off = int((diff[match] > 1).sum())
    emit("golden", frame="fx_320x240", ids_equal_frac=float(match.mean()),
         rgba_pixels_over_1_matching=off,
         rgba_max_diff_matching=int(diff[match].max()),
         peel_rounds=rc_g.GetStats().OrderedPeelRounds)
    check(rgba.shape == g["rgba"].shape, "golden fx_320x240: image shape")
    check(match.mean() >= 0.999, "golden fx_320x240: winner ids differ")
    check(off <= 1e-3 * match.sum(), f"golden fx_320x240: {off} pixels")
    emit("fx_phase", seconds=round(time.monotonic() - t_phase, 1))
    return out


# The material-effects level: eager ticks after its first frame, and the
# level cut to the golden frame's size.
MAT_TICKS = 2
MAT_GOLDEN = dict(width=320, height=240, terrain_n=70, n_balls=8)
# The effect-pass variant with its ordered meshes cut (an 8x8 water sheet
# and plaza, 4x4 wall and slabs): its exact tiled ordered pass runs one
# batched composite per slot of its densest 64x64 tile, some 1,200 device
# launches each; at full size that tile holds 172 triangles and a frame
# takes 4-5 s on the card.
MAT_PASSES = dict(effect_passes=True, water_n=8, plaza_n=8, pass_n=4)


def mat_frame(rc, kernel_fns, launches, fr, step=None) -> dict:
    """One Render() of rc (after ``step()``) with every launch count at 0:
    its CUDA-event ms (the frame's span on the card, host gaps included),
    launches, ordered route, peel rounds and ``OrderedReplays``."""
    reset_launches(kernel_fns.values())
    if step is not None:
        step()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    rc.Render()
    e1.record()
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    params = rc._fill_packed([], [])[3]
    ss = params["ss"]
    s = rc.GetStats()
    return {"frame_ms": e0.elapsed_time(e1), "launches": got,
            "route": fr.ordered_route(rc._compiled.ordered_cap,
                                      rc.height * ss, rc.width * ss,
                                      params["sampler_profile"]),
            "peel_rounds": s.OrderedPeelRounds,
            "replays": s.OrderedReplays}


def device_frame(rc, step) -> dict:
    """Device launches and device ms of one tick (``step()``, Render()),
    from a torch.profiler window of CUDA activity alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import device_us, profile_window

    def device(prof):
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    prof, wall_ms = profile_window(lambda: (step(), rc.Render()), 1,
                                   [ProfilerActivity.CUDA],
                                   lambda p: len(device(p)) > 0,
                                   label="frame")
    dev = device(prof)
    return {"device_launches": len(dev), "device_ms": device_us(dev) / 1e3,
            "profiled_frame_ms": wall_ms}


def channel_coverage(rc, fr, base: str, channel: str) -> dict:
    """Pixels whose opaque winner (B1's) is a triangle of material
    ``base``, and those of them where the channel of material ``channel``
    did not blend: the frame's ordered pass run from its own opaque
    (fb, zb) with and without the channel's triangles, compared in RGB.
    A channel redraws its base's triangles at LESSEQUAL, so each such
    pixel is a depth tie between B1's depth and the ordered kernel's."""
    static, dyn_f, dyn_i, params = packed_cuda(rc)
    h, w = rc.height * params["ss"], rc.width * params["ss"]
    scene, batch, _su, defer, bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                     params)
    names = [(m.name if m is not None else None, k)
             for m, k, _b in rc._compiled.materials]
    s_base = names.index((base, "mesh"))
    s_chan = names.index((channel, "channel"))
    fb0, zb0 = ordered_inputs(rc, fr)
    ids = torch.as_tensor(winners(rc), device=fb0.device)

    def ordered(b):
        return fr._ordered_pass(scene, b, defer, bits, fb0, zb0,
                                rc._compiled.ordered_cap, h, w, True, None,
                                params["sampler_profile"], {})[0]

    full = ordered(batch)
    without = ordered(batch._replace(
        valid=batch.valid & (batch.state_idx != s_chan)))
    on_base = (ids >= 0) & (batch.state_idx[ids.clamp(min=0)] == s_base)
    same = (full[:3] == without[:3]).all(0)
    return {"base_pixels": int(on_base.sum()),
            "not_blended": int((on_base & same).sum())}


def mat_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """The material-effects level, ``scenes.build_config5_mat`` at 1024x768
    (config 5 with chrome TexGen on its 64 spheres, cube-env TexGen on the
    24 annex crates, a 2,048-triangle reflection-TexGen water sheet and a
    4,608-triangle planar-TexGen plaza with a detail channel and a cube-env
    reflection channel), through Render() on the card.

    - Eager: the first frame and MAT_TICKS ticks, each with every launch
      count at 0 before it: B1 once and B4 once per peel round (the
      plaza's 9,216 channel triangles take the textured peel), nothing
      else, no replay; then the device launches and ms of one more tick.
    - The same tick with ``CK_FUSED_FETCH``: B5 once, no B1, the frame
      bit-equal.
    - B1 and B5 on that frame's inputs against their plain versions (each
      timed), B5's rows (24 words: the quantized row with the reflection
      vectors) against B1 plus the gather (``time_rows``); B4 on the
      plaza's ordered stream against its plain version
      (``time_ordered``).
    - The reflection channel over its plaza: the B1-winner pixels of the
      plaza where it did not blend (:func:`channel_coverage`), at most
      0.1% of them.
    - One frame with Antialias (2048x1536): B1 once, B4 per round.
    - The ``effect_passes`` variant (DP3 wall, BumpEnv water with its
      ADDSIGNED bias pass, 2- and 3-texture slabs) with its ordered meshes
      cut (``MAT_PASSES``), two eager frames: its passes lie outside both
      ordered kernels' envelopes, so the route is "tiled" (the exact tiled
      ordered pass) and B1 is the only kernel; the slot count of that
      pass, and the device launches and device ms of one more frame.
    - The level cut to 320x240 on the card against the CPU
      (``compare_with_cpu``) and against the golden frame
      ``tests/torch_golden/mat_320x240.npz``.

    W = 8 runs in ``window_phase``. Returns {kernel: (ms, plain ms, bound,
    events ms)} at the level's frame for B1, B4 and B5."""
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co
    from ckrenderengine_tpu_torch.raster import cuda_tiled
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.raster import torch_backend as rb

    t_phase = time.monotonic()
    reset_launches(kernel_fns.values())
    ctx, rc, spinner = scenes.build_config5_mat(O, device="cuda")
    frames = [mat_frame(rc, kernel_fns, launches, fr)]
    step = ticker("config5_mat", spinner)
    for _ in range(MAT_TICKS):
        frames.append(mat_frame(rc, kernel_fns, launches, fr, step))
    finite, covered = frame_checks("config5_mat", rc)
    c = rc._compiled
    emit("mat", config="config5_mat", size=[rc.width, rc.height],
         triangles=int(c.n_valid_tris), ordered_cap=int(c.ordered_cap),
         want=dict(texgen=c.want_texgen, cube=c.want_cube, bump=c.want_bump),
         frames=frames, finite=finite, covered=covered, card=card,
         **device_frame(rc, step))
    for f in frames:
        want = {k: 0 for k in kernel_fns}
        want.update(B1=1, B4=f["peel_rounds"])
        check(f["launches"] == want and f["peel_rounds"] >= 1,
              f"config5_mat: launches {f['launches']}, expected {want}")
        check(f["route"] == "peel" and f["replays"] == 0,
              f"config5_mat: route {f['route']}, replays {f['replays']}")

    fb0, zb0 = rc.fb.clone(), rc.zb.clone()
    os.environ["CK_FUSED_FETCH"] = "1"
    try:
        fused = mat_frame(rc, kernel_fns, launches, fr)
    finally:
        del os.environ["CK_FUSED_FETCH"]
    differ = int(((rc.fb != fb0).any(0) | (rc.zb != zb0)).sum())
    scene, batch, setup, _d, _b = fr.packed_setup(*packed_cuda(rc))
    words = int(df.shade_row_table_quant(
        batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
        batch.state_idx, batch_refl=batch.refl,
        inv_det_s=setup["inv_det_s"],
        want_ws=not rc._fill_packed([], [])[3]["sampler_profile"][3]
    ).shape[1])
    emit("fused_fetch", config="config5_mat", launches=fused["launches"],
         pixels_that_differ=differ, table_words=words)
    check(fused["launches"]["B5"] == 1 and fused["launches"]["B1"] == 0,
          f"config5_mat: fused-fetch frame launches {fused['launches']}")
    check(differ == 0, f"config5_mat: the fused-fetch frame differs on "
          f"{differ} pixels")
    check(words == 24, f"config5_mat: {words} quantized words, expected 24")

    out = time_rows("config5_mat", rc, None, card, fr, cuda_tiled, df,
                    plain=True)
    out["B4"] = time_ordered("config5_mat", "B4", rc, None, card, fr, co)
    cov = channel_coverage(rc, fr, "plazamat", "plazarefl")
    emit("channel_coverage", config="config5_mat", **cov,
         bound=1e-3 * cov["base_pixels"])
    check(cov["base_pixels"] > 1000, f"config5_mat: plaza {cov}")
    check(cov["not_blended"] <= 1e-3 * cov["base_pixels"],
          f"config5_mat: the reflection channel misses its base: {cov}")
    del ctx, rc

    # Antialias: one frame at twice the size.
    reset_launches(kernel_fns.values())
    _c, rc_aa, _m = scenes.build_config5_mat(O, device="cuda",
                                             antialias=True)
    f = mat_frame(rc_aa, kernel_fns, launches, fr)
    frame_checks("config5_mat_aa", rc_aa)
    emit("mat_antialias", config="config5_mat",
         size=[rc_aa.width, rc_aa.height],
         render_size=[2 * rc_aa.width, 2 * rc_aa.height], **f)
    check(f["launches"]["B1"] == 1 and f["launches"]["B2"] == 0
          and f["launches"]["B3"] == 0 and f["launches"]["B5"] == 0
          and f["launches"]["B4"] == f["peel_rounds"] >= 1
          and f["replays"] == 0 and f["route"] == "peel",
          f"config5_mat AA: {f}")
    del _c, rc_aa

    # The effect passes: the exact tiled ordered pass, eagerly.
    _c, rc_e, spin_e = scenes.build_config5_mat(O, device="cuda",
                                                **MAT_PASSES)
    done = count_calls(rb, "_one_triangle")
    frames = [mat_frame(rc_e, kernel_fns, launches, fr)]
    slots = [done()]
    done = count_calls(rb, "_one_triangle")
    frames.append(mat_frame(rc_e, kernel_fns, launches, fr,
                            ticker("config5_mat", spin_e)))
    slots.append(done())
    per_frame = device_frame(rc_e, ticker("config5_mat", spin_e))
    frame_checks("config5_mat_passes", rc_e)
    emit("mat_effect_passes", config="config5_mat", cut=MAT_PASSES,
         ordered_cap=int(rc_e._compiled.ordered_cap), frames=frames,
         ordered_slots=slots, card=card, **per_frame)
    for f in frames:
        want = {k: 0 for k in kernel_fns}
        want["B1"] = 1
        check(f["route"] == "tiled" and f["launches"] == want,
              f"config5_mat effect passes: {f}")
    del _c, rc_e

    # The golden frame's size: card against CPU, and against the golden.
    _c, rc_g, _m = render_config(scenes.build_config5_mat, O, "cuda",
                                 **MAT_GOLDEN)
    _c2, rc_c, _m2 = render_config(scenes.build_config5_mat, O, "cpu",
                                   **MAT_GOLDEN)
    compare_with_cpu("config5_mat_320x240", rc_g, rc_c)
    g = np.load(os.path.join(GOLDEN_DIR, "mat_320x240.npz"))
    ids = winners(rc_g)
    rgba = rc_g.BackToFront()
    match = ids == g["ids"]
    diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32)).max(-1)
    off = int((diff[match] > 1).sum())
    emit("golden", frame="mat_320x240", ids_equal_frac=float(match.mean()),
         rgba_pixels_over_1_matching=off,
         rgba_max_diff_matching=int(diff[match].max()),
         peel_rounds=rc_g.GetStats().OrderedPeelRounds)
    check(rgba.shape == g["rgba"].shape, "golden mat_320x240: image shape")
    check(match.mean() >= 0.999, "golden mat_320x240: winner ids differ")
    check(off <= 1e-3 * match.sum(), f"golden mat_320x240: {off} pixels")
    emit("mat_phase", seconds=round(time.monotonic() - t_phase, 1))
    return out


# The batched groups: (name, contexts, size, Antialias, the solve kernel
# each member launches). The 8x256 and 64x256 groups are the reference's
# contexts_per_sec_batched_8x256 / _64x256 scenes (scenes.build_batched);
# "one_triangle" is the reference's test group (3 contexts at 48x48, a
# flat frame).
BATCH_GROUPS = (("batched_8x256", 8, 256, False, "B1"),
                ("batched_64x256", 64, 256, False, "B1"),
                ("one_triangle", 3, 48, False, "B2"),
                ("batched_8x256_aa", 8, 256, True, "B1"))
# The stats a batch sets per member, compared with the member's eager
# Render() (the cumulative and timing counters are left out).
FRAME_STATS = ("NbTrianglesDrawn", "NbVerticesProcessed", "NbObjectDrawn",
               "NbLinesDrawn", "SolveLivePairs", "SolveFallbackRows",
               "OrderedPeelRounds", "OrderedPeelOverflow")


def one_triangle_group(O, n: int, size: int):
    """The reference's one-triangle batching group
    (tests/test_context_batching.py:15-34) on the card: (rm, rcs, obj)."""
    ctx = O.CKContext(device="cuda")
    rm = ctx.GetRenderManager()
    mesh = O.CKMesh(ctx, "t")
    mesh.SetPositions(np.array([[-1, -1, 0], [0, 1, 0], [1, -1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "m")
    mat.SetEmissive((1, 0, 0, 1))
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, "tri")
    obj.SetCurrentMesh(mesh)
    rcs = []
    for i in range(n):
        rc = rm.CreateRenderContext(size, size)
        cam = O.CKCamera(ctx, f"cam{i}")
        cam.SetPosition((0, 0, -3 - i))
        rc.AttachViewpointToCamera(cam)
        rcs.append(rc)
    return rm, rcs, obj


def batch_phase(O, scenes, kernel_fns, launches, card, groups=BATCH_GROUPS,
                stage=None) -> dict:
    """Context batching (``CKRenderManager.ProcessBatched``) on the card:
    the groups of ``BATCH_GROUPS``, each in a manager of its own. Each
    group runs two warm-up batches, a third and the checked one (a
    ``torch.profiler`` window), every copy-and-replay loop under
    ``set_sync_debug_mode("error")``. Checks: the group ran as one batch
    (one read, one run of all members); the profile shows the group's
    solve kernel once per member and no other; each member's fb, zb and
    frame stats (``FRAME_STATS``) are bit-equal to its own eager
    ``Render()`` at the batch's caps. Then ``frame_bench.batched_pass``
    (the reference's protocol, runs of about 1 s) gives contexts/sec, and
    device ms, device launches and host launch calls per context, the idle
    share and each key's capture ms and pool MiB, beside the card.

    ``groups``: other entries in ``BATCH_GROUPS``' form; ``stage``: a pixel
    shader every member of a group shares (the ``shader`` phase)."""
    import contextlib

    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import (
        batched_pass, profile_window, profiled_kernels,
    )
    from ckrenderengine_tpu_torch.pipeline import window as fw

    @contextlib.contextmanager
    def no_sync():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    out = {}
    reset_launches(kernel_fns.values())
    fw.REPLAY_GUARD = no_sync
    try:
        for name, n, size, aa, kernel in groups:
            if name == "one_triangle":
                rm, rcs, root = one_triangle_group(O, n, size)
            else:
                rm, rcs, root = scenes.build_batched(
                    O, n, size, antialias=aa, device="cuda")
            for rc in rcs if stage is not None else ():
                rc.SetPixelShader(stage)
            reads = []

            def batch():
                root.Rotate((0, 1, 0), 0.01)
                rm.ProcessBatched()
                reads.append(rcs[0]._batch_read)
                return float(rcs[-1].fb.sum())

            for _ in range(2):
                batch()
            prof, _wall = profile_window(
                batch, 1, [ProfilerActivity.CUDA],
                lambda p: profiled_kernels(p)[kernel] >= n,
                label=name)
            read = reads[-1]
            one_batch = (read is not None and read.members == rcs
                         and len(read.runs) == 1
                         and len(read.runs[0][1]) == n)
            seen = profiled_kernels(prof)
            want = {k: (n if k == kernel else 0) for k in seen}
            frames = [(rc.fb.clone(), rc.zb.clone(),
                       {f: getattr(rc.GetStats(), f) for f in FRAME_STATS})
                      for rc in rcs]
            caps = rcs[0]._batch.params["solve_caps"]
            covered = [float((fb[3] > 0).float().mean()) for fb, _z, _s
                       in frames]
            finite = all(bool(torch.isfinite(fb).all()) for fb, _z, _s
                         in frames)
            bit_equal, stats_equal = [], []
            for rc, (fb, zb, st) in zip(rcs, frames):
                rc._solve_caps = caps
                rc.Render()
                bit_equal.append(bool(torch.equal(rc.fb, fb)
                                      and torch.equal(rc.zb, zb)))
                stats_equal.append(
                    st == {f: getattr(rc.GetStats(), f)
                           for f in FRAME_STATS})
            rates = batched_pass(rm, rcs, root, target_s=1.0)
            line = dict(group=name, card=card,
                        one_batch=one_batch, checked_kernels=seen,
                        expected_kernels=want,
                        members_bit_equal=sum(bit_equal),
                        stats_equal=sum(stats_equal), finite=finite,
                        covered_min_max=[min(covered), max(covered)],
                        checked_caps=list(caps or ()), **rates)
            emit("batch", **line)
            check(one_batch, f"{name}: not one batch of {n}")
            check(seen == want, f"{name}: the batch launched {seen}, "
                  f"expected {want}")
            check(all(bit_equal), f"{name}: {n - sum(bit_equal)} members "
                  "differ from their eager Render()")
            check(all(stats_equal), f"{name}: {n - sum(stats_equal)} "
                  "members' stats differ from their eager Render()'s")
            check(finite and max(covered) > 0.05, f"{name}: frames {covered}")
            check(rates["profiled_kernels"][kernel] == n,
                  f"{name}: the timed batch launched "
                  f"{rates['profiled_kernels']}")
            out[name] = line
            del rm, rcs, root, reads, prof
    finally:
        fw.REPLAY_GUARD = None
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    check(all(got[g[4]] > 0 for g in groups), f"batch phase: wrapper "
          f"launches {got}")
    return out


# The shaded level: eager ticks after its first frame, its window entry
# (two full windows of W and a partial one), the golden frame's cut, and
# the batched group whose members share one pixel shader.
SHADER_TICKS = 2
SHADER_WINDOW = (("config5_shaded", "build_config5_shaded", {}, ("B1",), 1),)
SHADER_GOLDEN = dict(width=320, height=240, terrain_n=70, n_balls=8,
                     alpha_sheet=True)
SHADER_BATCH = (("batched_8x256_shaded", 8, 256, False, "B1"),)


def shaded_frame(rc, kernel_fns, launches, df, step=None) -> dict:
    """One Render() of a shaded context (after ``step()``) with every
    launch count at 0: its CUDA-event ms, launches, and how many times it
    ran the per-pixel-gather shade and built the quantized rows."""
    ps = count_calls(df, "_shade_deferred_ps")
    quant = count_calls(df, "shade_row_table_quant")
    reset_launches(kernel_fns.values())
    if step is not None:
        step()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    rc.Render()
    e1.record()
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    return {"frame_ms": e0.elapsed_time(e1), "launches": got,
            "pixel_stage_shades": ps(), "quantized_tables": quant()}


def time_shaded(name, rc, card, fr, cuda_tiled, df) -> dict:
    """B1 in its instantiation without e-planes on a shaded frame's own
    inputs (the vertex shader's positions), bit-equal to its plain version
    and timed beside its roofline bound; and the shade stage: the
    per-pixel-gather shade with the user stage (``shade_deferred`` with
    ``pixel_shader``) beside config 5's unshaded shade of the same winners
    (the quantized rows: table, gather, expand, ``shade_rows`` from B1's
    e-planes). Returns (kernel ms, plain ms, bound, CUDA-event ms)."""
    static, dyn_f, dyn_i, params = packed_cuda(rc)
    H, W = rc.height * params["ss"], rc.width * params["ss"]
    sp = params["sampler_profile"]
    scene, batch, setup, defer, _bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                        params)
    caps = fr._solve_caps(batch.valid.shape[0], None)
    a = cuda_tiled.phase_a(setup, defer, scene.viewport, batch.xyw, H, W,
                           **caps)
    init = cuda_tiled._init_plane(scene.clear_z, H, W, a["tiles_y"] * 32,
                                  a["tiles_x"] * 32, "cuda")
    args = (a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
            a["sbase"], scene.viewport, W, H, init, 32, a["tiles_x"],
            a["tiles_y"], a["n_planes"])
    out = cuda_tiled.solve_tiled_kernel(*args, False)
    ref = cuda_tiled.solve_phase_b_plain(*args, False)
    check(out[2] is None and all(
        x is None and y is None or torch.equal(x, y)
        for x, y in zip(out, ref)),
          f"B1 without e-planes and its plain version disagree at {name}")
    st = {"b1_ms": kernel_ms(lambda: cuda_tiled.solve_tiled_kernel(
        *args, False), "solve_tiled_kernel"),
        "b1_events_ms": cuda_ms(lambda: cuda_tiled.solve_tiled_kernel(
            *args, False), 20),
        "b1_plain_ms": cuda_ms(lambda: cuda_tiled.solve_phase_b_plain(
            *args, False), 3)}
    ids = out[1][:H, :W]
    shade = (scene.tex_planes, scene.tex_hw, scene.fog_color,
             scene.clear_color[:, None, None].expand(4, H, W), H, W)
    st["shade_stage_ms"] = cuda_ms(lambda: df.shade_deferred(
        ids, batch.xyw, batch.z, batch.color, batch.specular, batch.uv,
        batch.fog, batch.state_idx, scene.state_i, scene.state_f, *shade,
        batch_refl=batch.refl, pixel_shader=params["pixel_shader"]), 5)
    # Config 5's shade of the same winners: the quantized rows.
    want_ws = not sp[3]
    epl = cuda_tiled.solve_tiled_kernel(*args, True)[2][:, :H, :W]

    def unshaded():
        tbl = df.shade_row_table_quant(
            batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
            batch.state_idx, batch_refl=batch.refl,
            inv_det_s=setup["inv_det_s"], want_ws=want_ws)
        rows = df.expand_rows_quant(
            df.gather_winner_rows(tbl, ids), scene.state_i, scene.state_f,
            scene.tex_hw, want_ws=want_ws,
            has_refl=batch.refl.shape[-1] > 0)
        return df.shade_rows(rows, ids >= 0, *shade, sampler_profile=sp,
                             tex_quad=scene.tex_quad,
                             eplanes=(epl[0], epl[1], epl[2]))

    st["unshaded_config5_shade_ms"] = cuda_ms(unshaded, 5)
    leftn = a["leftn"].tolist()
    pairs = tiled_pairs(a["counts"], sum(leftn), 32)
    past = tiled_pairs_past_edges(
        a["stream"], a["starts"], a["counts"],
        ((a["gbase"], leftn[0]), (a["sbase"], leftn[1])), 32, a["tiles_x"],
        a["tiles_y"])
    solve_in = ((int(a["counts"].sum()) + sum(leftn)) * a["stream"].shape[1]
                * 4 + nbytes(a["starts"], a["counts"], a["leftn"], init))
    bound = roofline(past, pairs, a["n_planes"],
                     solve_in + nbytes(*(x for x in out if x is not None)))
    emit("shader_timing", config=name, card=card, size=[W, H],
         **{k: round(v, 4) for k, v in st.items()},
         b1_bound_ms=bound["bound_ms"], b1_bound_by=bound["bound_by"],
         pixel_row_pairs=pairs, pairs_past_edges=past,
         note="b1_ms is B1's own time without e-planes (torch.profiler); "
         "the other times are CUDA-event means of the stage alone")
    return (st["b1_ms"], st["b1_plain_ms"], bound, st["b1_events_ms"])


def shader_phase(O, scenes, fr, kernel_fns, launches, card) -> dict:
    """User vertex and pixel shaders through Render() on the card:
    ``scenes.build_config5_shaded`` (config 5, 528,032 triangles, with a
    travelling-wave vertex shader and a pixel shader reading all six of
    its inputs) at 1024x768.

    - Eager: the first frame and SHADER_TICKS ticks, each with every launch
      count at 0 first: B1 once per frame (its instantiation without
      e-planes), no B2-B5, the per-pixel-gather shade once and no
      quantized rows; one more frame with ``CK_FUSED_FETCH``: still no B5.
      The device ms, launches and idle share of one more tick.
    - B1 on the frame's own inputs against its plain version, timed beside
      its bound, and the shade stage beside config 5's unshaded shade
      (:func:`time_shaded`).
    - Windowed: W = 8 through ``window_phase`` (one fenced window and a
      partial one, every window's last frame and every fence entry
      bit-equal to the eager frames').
    - A stage that reads the host (``.item()``) in a window raises
      ``StageCaptureError`` naming it.
    - Golden: the level cut to 320x240 with its alpha sheet (the flat
      ordered pass under the stage) against the CPU and against
      ``tests/torch_golden/shader_320x240.npz``.
    - Batched: ``scenes.build_batched`` at 8 x 256x256, every member
      sharing one pixel shader: one batch, B1 once per member, each member
      bit-equal to its own eager Render() (``batch_phase``).
    - Antialias: one eager frame at 2048x1536, B1 once.

    Returns {"B1": (ms, plain ms, bound, events ms)} of the no-e-plane
    instantiation at the level's frame."""
    from ckrenderengine_tpu_torch.raster import cuda_tiled
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.raster import torch_backend as rb
    from ckrenderengine_tpu_torch.raster.stage import StageCaptureError

    t_phase = time.monotonic()
    ctx, rc, spinner = scenes.build_config5_shaded(O, device="cuda")
    step = ticker("config5_shaded", spinner)
    frames = [shaded_frame(rc, kernel_fns, launches, df)]
    for _ in range(SHADER_TICKS):
        frames.append(shaded_frame(rc, kernel_fns, launches, df, step))
    finite, covered = frame_checks("config5_shaded", rc)
    os.environ["CK_FUSED_FETCH"] = "1"
    try:
        fused = shaded_frame(rc, kernel_fns, launches, df, step)
    finally:
        del os.environ["CK_FUSED_FETCH"]
    dev = device_frame(rc, step)
    frame_ms = float(np.median([f["frame_ms"] for f in frames[1:]]))
    c = rc._compiled
    emit("shader", config="config5_shaded", size=[rc.width, rc.height],
         triangles=int(c.n_valid_tris), ordered_cap=int(c.ordered_cap),
         frames=frames, fused_fetch_frame=fused, finite=finite,
         covered=covered, card=card, frame_ms_median=frame_ms,
         device_idle_share=1.0 - dev["device_ms"] / frame_ms, **dev)
    want = {k: 0 for k in kernel_fns}
    want["B1"] = 1
    for f in frames + [fused]:
        check(f["launches"] == want and f["pixel_stage_shades"] == 1
              and f["quantized_tables"] == 0,
              f"config5_shaded: frame {f}, expected launches {want}")
    out = {"B1": time_shaded("config5_shaded", rc, card, fr, cuda_tiled,
                             df)}
    del ctx, rc

    window = window_phase(O, scenes, kernel_fns, launches, card,
                          window_scenes=SHADER_WINDOW)["config5_shaded"]
    check(window["frames_bit_equal"] and window["fences_bit_equal"],
          "config5_shaded: windowed frames differ from eager ones")

    # A stage that synchronises with the host cannot be captured.
    def host_reading_stage(inp):
        return inp["color"] * float(inp["texel"].amax().item())

    _c, rc_s, _m = scenes.build_config2(O, device="cuda", width=64,
                                        height=48)
    rc_s.SetPixelShader(host_reading_stage)
    rc_s.Render()                                   # eager: allowed
    rc_s.SetFramePipelining(2)
    msg = ""
    try:
        for _ in range(2):
            rc_s.Render()
        rc_s.GetFrameFence().cpu()
    except StageCaptureError as e:
        msg = str(e)
    emit("shader_capture_error", raised=bool(msg), message=msg[:200])
    check("host_reading_stage" in msg,
          f"a host-reading stage in a window did not raise: {msg!r}")
    del _c, rc_s

    # The golden frame's size: the card against the CPU and the golden.
    reset_launches(kernel_fns.values())
    flat_pass = count_calls(rb, "_one_triangle")
    _c, rc_g, _m = render_config(scenes.build_config5_shaded, O, "cuda",
                                 **SHADER_GOLDEN)
    composites = flat_pass()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in got:
        launches[k] += got[k]
    _c2, rc_c, _m2 = render_config(scenes.build_config5_shaded, O, "cpu",
                                   **SHADER_GOLDEN)
    compare_with_cpu("config5_shaded_320x240", rc_g, rc_c)
    g = np.load(os.path.join(GOLDEN_DIR, "shader_320x240.npz"))
    ids = winners(rc_g)
    rgba = rc_g.BackToFront()
    match = ids == g["ids"]
    diff = np.abs(rgba.astype(np.int32) - g["rgba"].astype(np.int32)).max(-1)
    off = int((diff[match] > 1).sum())
    emit("golden", frame="shader_320x240", ids_equal_frac=float(match.mean()),
         rgba_pixels_over_1_matching=off,
         rgba_max_diff_matching=int(diff[match].max()), launches=got,
         ordered_composites=composites,
         ordered_cap=int(rc_g._compiled.ordered_cap))
    check(got == want, f"golden shader_320x240: launches {got}")
    check(composites == rc_g._compiled.ordered_cap,
          f"golden shader_320x240: {composites} flat ordered composites")
    check(rgba.shape == g["rgba"].shape, "golden shader_320x240: shape")
    check(match.mean() >= 0.999, "golden shader_320x240: winner ids differ")
    check(off <= 1e-3 * match.sum(), f"golden shader_320x240: {off} pixels")
    del _c, rc_g, _c2, rc_c

    # Context batching: members that share one pixel shader.
    stage = scenes.config5_shaders(torch, 0, 256, 256)[1]
    batch_phase(O, scenes, kernel_fns, launches, card, groups=SHADER_BATCH,
                stage=stage)

    # Antialias: one frame at twice the size.
    _c, rc_aa, _m = scenes.build_config5_shaded(O, device="cuda",
                                                antialias=True)
    f = shaded_frame(rc_aa, kernel_fns, launches, df)
    frame_checks("config5_shaded_aa", rc_aa)
    emit("shader_antialias", config="config5_shaded",
         size=[rc_aa.width, rc_aa.height],
         render_size=[2 * rc_aa.width, 2 * rc_aa.height], **f)
    check(f["launches"] == want and f["pixel_stage_shades"] == 1,
          f"config5_shaded AA: {f}")
    del _c, rc_aa
    emit("shader_phase", seconds=round(time.monotonic() - t_phase, 1))
    return out


def ordered_caps_check(rc, fr) -> dict:
    """An Antialias frame's ordered phase A at its render size with the
    reference's 1x capacities and with ``cuda_ordered.frame_caps``: the
    overflow flag and the live (tile, draw) pairs of each. The scaled
    capacities must not overflow."""
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co

    static, dyn_f, dyn_i, params = packed_cuda(rc)
    h, w = rc.height * params["ss"], rc.width * params["ss"]
    scene, batch, _su, defer, bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                     params)
    ob = fr.ordered_batch(scene, batch, defer, bits, rc._compiled.ordered_cap)
    _fb, zb = ordered_inputs(rc, fr)
    out = {}
    for caps, kw in (("reference_1x", {}), ("frame_caps",
                                            co.frame_caps(h, w))):
        pa = co.phase_a(*ordered_fields(ob, scene), zb, h, w, **kw)
        out[caps] = {"overflow": bool(pa["bad"]),
                     "live_pairs": int(pa["n_live"]),
                     "pair_cap": kw.get("pair_cap", co.PAIR_CAP)}
    check(not out["frame_caps"]["overflow"],
          f"ordered phase A overflows its capacities at {w}x{h}")
    return out


def stencil_inputs(rc, fr):
    """The stencil pass's inputs and its mask ``sb`` at the render size,
    caught on the way through ``frame.stencil_pass`` during one more
    Render()."""
    seen = {}
    stencil_pass = fr.stencil_pass

    def spy(*a, **k):
        sb = stencil_pass(*a, **k)
        seen.update(args=a, sb=sb)
        return sb

    fr.stencil_pass = spy
    try:
        rc.Render()
    finally:
        fr.stencil_pass = stencil_pass
    return seen["args"], seen["sb"]


def plain_stencil(args, cuda_tiled, cuda_reduce, fr):
    """``frame.stencil_pass`` with the plain versions of B1 and B2 on the
    card's tensors; also the tiled solve's bin statistics (None if flat)."""
    setup, batch, tri_bits, zb, viewport, h, w, flat, t_count, caps = args
    stencil_tri = (tri_bits[:, 2] > 0.5) & batch.valid
    binstats = None
    if flat:
        s_id, s_depth = cuda_reduce.depth_reduce_plain(
            cuda_reduce.pack_rows(setup, stencil_tri), 1.0, viewport, h, w)
    else:
        a = cuda_tiled.phase_a(setup, stencil_tri, viewport, batch.xyw, h, w,
                               **fr._solve_caps(t_count, caps))
        init = cuda_tiled._init_plane(1.0, h, w, a["tiles_y"] * 32,
                                      a["tiles_x"] * 32, zb.device)
        d, i, _e, _r = cuda_tiled.solve_phase_b_plain(
            a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
            a["sbase"], viewport, w, h, init, 32, a["tiles_x"],
            a["tiles_y"], a["n_planes"], False)
        s_id, s_depth = i[:h, :w], d[:h, :w]
        binstats = a["binstats"].cpu().tolist()
    return ((s_id >= 0) & (s_depth <= zb + 1e-6)).to(torch.uint8), binstats


def stencil_phase(O, scenes, fr, kernel_fns, launches, cuda_tiled,
                  cuda_reduce) -> None:
    """``scenes.build_stencil`` (config 2 and a stencil-only quad behind
    the sphere, 640x480) without and with Antialias, and config 1 with a
    stencil quad behind the cube (a flat frame). Each first Render() runs
    with every count at 0: the frame's solve and the stencil's launch B1
    twice (B2 twice on the flat frame), and nothing else. The mask at the
    render size must equal the one the plain solve makes on the card from
    the same inputs, and with Antialias the resolved mask must be its 2x2
    window maximum."""
    def flat_scene(O, device, antialias=False):
        ctx, rc, cube = scenes.build_config1(O, device=device,
                                             antialias=antialias)
        scenes.add_stencil_quad(O, ctx, -1.0, -0.6, 0.3, 0.8, 1.0)
        return ctx, rc, cube

    for name, build, kw, kernel in (
            ("stencil", scenes.build_stencil, {}, "B1"),
            ("stencil_aa", scenes.build_stencil, {"antialias": True}, "B1"),
            ("stencil_flat", flat_scene, {}, "B2")):
        reset_launches(kernel_fns.values())
        _c, rc, _m = render_config(build, O, "cuda", **kw)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in kernel_fns.items()}
        for k in launches:
            launches[k] += got[k]
        check(got == {k: 2 if k == kernel else 0 for k in kernel_fns},
              f"{name}: launches {got}")
        args, sb_hi = stencil_inputs(rc, fr)
        sb_plain, binstats = plain_stencil(args, cuda_tiled, cuda_reduce, fr)
        equal = bool(torch.equal(sb_hi, sb_plain))
        ss = sb_hi.shape[0] // rc.height
        resolved = bool(torch.equal(rc.sb, sb_hi.reshape(
            rc.height, ss, rc.width, ss).amax(dim=(1, 3))))
        emit("stencil", scene=name, size=[rc.width, rc.height],
             render_size=list(sb_hi.shape[::-1]), launches=got,
             mask_share=float(rc.sb.float().mean()),
             sb_equals_plain=equal, resolved_by_max=resolved,
             stencil_binstats=binstats)
        check(equal, f"{name}: the kernel's mask differs from the plain "
              "solve's")
        check(resolved, f"{name}: sb is not the window maximum")
        check(0.01 < float(rc.sb.float().mean()) < 0.5,
              f"{name}: mask share {float(rc.sb.float().mean())}")
        check(binstats is None or not any(binstats[2:5]),
              f"{name}: the stencil solve overflowed its caps {binstats}")


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


def ordered_inputs(rc, fr):
    """The opaque (fb, zb) that rc's ordered pass starts from, at the
    render size (twice the display size with Antialias): caught on the
    way into ``frame._ordered_pass`` during one more Render()."""
    seen = {}
    ordered_pass = fr._ordered_pass

    def spy(scene, batch, defer_tri, tri_bits, fb, zb, *a, **k):
        seen.update(fb=fb, zb=zb)
        return ordered_pass(scene, batch, defer_tri, tri_bits, fb, zb, *a,
                            **k)

    fr._ordered_pass = spy
    try:
        rc.Render()
    finally:
        fr._ordered_pass = ordered_pass
    return seen["fb"], seen["zb"]


def time_ordered(name, kernel, rc, fps, card, fr, co):
    """CUDA-event times of the ordered stages at a stress frame's shapes:
    phase A, the kernel and its plain version (checked equal there), and
    the composite. Returns (kernel ms, plain ms, roofline bound, CUDA-event
    ms of the kernel's wrapper)."""
    static, dyn_f, dyn_i, params = packed_cuda(rc)
    H, W = rc.height * params["ss"], rc.width * params["ss"]
    scene, batch, _su, defer, bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                     params)
    ob = fr.ordered_batch(scene, batch, defer, bits, rc._compiled.ordered_cap)
    fields = ordered_fields(ob, scene)
    fb, zb = ordered_inputs(rc, fr)
    caps = co.frame_caps(H, W)
    st = {"phase_a_ms": cuda_ms(lambda: co.phase_a(*fields, zb, H, W,
                                                   **caps), 5)}
    pa = co.phase_a(*fields, zb, H, W, **caps)
    check(not bool(pa["bad"]), f"{name}: ordered phase A overflows")
    tx, ty = pa["tiles_x"], pa["tiles_y"]
    if kernel == "B3":
        args = (pa["stream"], pa["starts"], pa["counts"],
                co._params(scene.viewport, H, W, scene.fog_color, "cuda"),
                pa["zplane"], 32, tx, ty, pa["n_planes"])
        kfn, pfn = co.blend_kernel, co.blend_phase_b_plain
        ab = kfn(*args)[:, :H, :W]
        st["composite_ms"] = cuda_ms(lambda: ab[0:1] * fb + ab[1:5], 20)
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
    st["kernel_ms"] = kernel_ms(lambda: kfn(*args), {
        "B3": "ordered_blend_kernel", "B4": "ordered_peel_kernel"}[kernel])
    st["kernel_events_ms"] = cuda_ms(lambda: kfn(*args), 20)
    st["plain_ms"] = cuda_ms(lambda: pfn(*args), 2)
    out_k, out_p = kfn(*args), pfn(*args)
    if kernel == "B3":
        out_k, out_p = (out_k,), (out_p,)
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          f"{kernel} kernel and plain version disagree at {name} shapes")
    # Bytes: the rows the tiles stream (each tile's live rows once; B4 reads
    # only their heads), the ranges, the opaque depth and the outputs.
    row_floats = (pa["stream"].shape[1] if kernel == "B3"
                  else co.head_width(pa["n_planes"]))
    bound = roofline(
        tiled_pairs_past_edges(pa["stream"], pa["starts"], pa["counts"], (),
                               32, tx, ty),
        tiled_pairs(pa["counts"], 0, 32), pa["n_planes"],
        int(pa["counts"].sum()) * row_floats * 4
        + nbytes(pa["starts"], pa["counts"], pa["zplane"], *out_k))
    emit("timing", config=name, card=card, fps=fps, kernel=kernel,
         size=[W, H], bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
         old_count_bound_ms=bound["old_count_bound_ms"],
         pixel_row_pairs=bound["pixel_row_pairs"],
         pairs_past_edges=bound["pairs_past_edges"],
         live_pairs=int(pa["n_live"]), stream_rows=int(pa["stream"].shape[0]),
         row_floats_read=row_floats, bound_bytes=bound["bytes"],
         max_tile_rows=int(pa["counts"].max()),
         **{k: round(v, 4) for k, v in st.items()},
         note="kernel_ms is the kernel's own time on the card "
         "(torch.profiler); the other stage times are CUDA-event means of "
         "the stage alone")
    return st["kernel_ms"], st["plain_ms"], bound, st["kernel_events_ms"]


def ptxas_registers(ptxas, kernel: str) -> int:
    """Registers ptxas gave the entry whose name contains ``kernel``."""
    entry = ""
    for ln in ptxas:
        if "Compiling entry" in ln:
            entry = ln
        elif kernel in entry and "registers" in ln:
            return int(ln.split("Used ")[1].split(" registers")[0])
    fail(f"ptxas reported no registers for {kernel}")


def flat_bound(rows, outs, h: int, w: int, viewport, row0: int = 0) -> dict:
    """B2's roofline bound on these inputs: the pairs past valid, rect and
    edges (``flat_stats``, the kernel's arithmetic) at 15 operations, against
    the rows at the seven 16-byte words the kernel reads, the 5-float view
    and the two planes it writes, each once; a band's pixels at their
    global rows (``row0``)."""
    from ckrenderengine_tpu_torch.raster.flat_fixtures import flat_stats

    past = flat_stats(rows, h, w, viewport, row0=row0)["past_edges"]
    return roofline(past, rows.shape[0] * h * w, 0,
                    rows.shape[0] * 28 * 4 + 5 * 4 + nbytes(*outs))


def time_flat(rc1, rc1_aa, card, fr, cuda_reduce, lib, ptxas, cases):
    """B2's own time (``torch.profiler``), its CUDA-event and plain times
    and its bound at config 1's frame, at the same launch with every row's
    valid bit cleared (the kernel's floor at that grid: rows streamed and
    scanned, two planes written), at config 1's Antialias frame (512x512)
    and at the three cases of ``raster/flat_fixtures.py`` at the flat
    route's limits; each checked equal to its plain version there. Returns
    {shape: (kernel ms, plain ms, bound, CUDA-event ms)}."""
    def frame_args(rc):
        static, dyn_f, dyn_i, params = packed_cuda(rc)
        sc, _bt, su, de, _bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                 params)
        return (cuda_reduce.pack_rows(su, de), sc.clear_z, sc.viewport,
                rc.height * params["ss"], rc.width * params["ss"])

    args1 = frame_args(rc1)
    floor = args1[0].clone()
    floor[:, 20] = 0.0
    shapes = [("config1", args1, None),
              ("config1_floor", (floor,) + args1[1:], None),
              ("config1_aa", frame_args(rc1_aa), None)]
    by_name = {c["name"]: c for c in cases}
    shapes += [(n, flat_args(by_name[n]), by_name[n]["viewport"])
               for n in ("flat_limit_256", "flat_deep_640", "flat_cap_128")]
    regs = ptxas_registers(ptxas, "reduce_flat")
    ctas = lib.lib.ck_reduce_flat_occupancy()
    out = {}
    for name, args, viewport in shapes:
        rows, _cz, vp, h, w = args
        k = cuda_reduce.reduce_flat_kernel(*args)
        p = cuda_reduce.depth_reduce_plain(*args)
        check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
              f"B2 kernel and plain version disagree at {name}")
        t = {"ms": kernel_ms(lambda: cuda_reduce.reduce_flat_kernel(*args),
                             "reduce_flat_kernel"),
             "events_ms": cuda_ms(
                 lambda: cuda_reduce.reduce_flat_kernel(*args), 20),
             "plain_ms": cuda_ms(
                 lambda: cuda_reduce.depth_reduce_plain(*args), 3)}
        bound = flat_bound(rows, k, h, w,
                           vp.tolist() if viewport is None else viewport)
        emit("flat_timing", shape_name=name, card=card, size=[w, h],
             tris=int(rows.shape[0]),
             valid_rows=int((rows[:, 20] > 0).sum()),
             ctas_per_subtile=lib.lib.ck_reduce_flat_split(rows.shape[0], h,
                                                            w),
             ctas_per_sm=ctas, registers=regs,
             **{key: round(v, 5) for key, v in t.items()},
             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
             bound_share=bound["bound_ms"] / t["ms"],
             pixel_row_pairs=bound["pixel_row_pairs"],
             pairs_past_edges=bound["pairs_past_edges"],
             bound_bytes=bound["bytes"],
             note="ms is the kernel's own time on the card "
             "(torch.profiler); events_ms and plain_ms are CUDA-event means")
        check(t["ms"] >= bound["bound_ms"],
              f"B2 at {name}: {t['ms']} ms is below its bound")
        out[name] = (t["ms"], t["plain_ms"], bound, t["events_ms"])
    return out


def time_rows(name, rc, fps, card, fr, cuda_tiled, df, plain: bool):
    """CUDA-event times of an opaque tiled frame's stages at its own shapes:
    setup, phase A, B1 with e-planes, the winner-row gather after it, B5 in
    their place, and the shade stage from the quantized rows (table, expand,
    ``shade_rows``) beside ``shade_deferred``, which the frame took before
    it shaded from rows. B1 and B5 are checked against their plain versions
    there (timed too when ``plain``). Returns {"B1" | "B5": (kernel ms,
    plain ms or None, roofline bound, CUDA-event ms of the wrapper)}."""
    static, dyn_f, dyn_i, params = packed_cuda(rc)
    H, W = rc.height * params["ss"], rc.width * params["ss"]
    sp = params["sampler_profile"]
    st = {"setup_ms": cuda_ms(lambda: fr.packed_setup(static, dyn_f, dyn_i,
                                                      params), 5)}
    scene, batch, setup, defer, _bits = fr.packed_setup(static, dyn_f, dyn_i,
                                                        params)
    caps = fr._solve_caps(batch.valid.shape[0], None)
    st["phase_a_ms"] = cuda_ms(lambda: cuda_tiled.phase_a(
        setup, defer, scene.viewport, batch.xyw, H, W, **caps), 5)
    a = cuda_tiled.phase_a(setup, defer, scene.viewport, batch.xyw, H, W,
                           **caps)
    init = cuda_tiled._init_plane(scene.clear_z, H, W, a["tiles_y"] * 32,
                                  a["tiles_x"] * 32, "cuda")
    want_ws = not sp[3]

    has_refl = batch.refl.shape[-1] > 0

    def table():
        return df.shade_row_table_quant(
            batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
            batch.state_idx, batch_refl=batch.refl,
            inv_det_s=setup["inv_det_s"], want_ws=want_ws)

    tbl = table()
    b1_args = (a["stream"], a["starts"], a["counts"], a["leftn"], a["gbase"],
               a["sbase"], scene.viewport, W, H, init, 32, a["tiles_x"],
               a["tiles_y"], a["n_planes"], True)
    b5_args = b1_args + (tbl,)
    out1 = cuda_tiled.solve_tiled_kernel(*b1_args)
    out5 = cuda_tiled.solve_fetch_kernel(*b5_args)
    for kernel, out, args in (("B1", out1, b1_args), ("B5", out5, b5_args)):
        ref = cuda_tiled.solve_phase_b_plain(*args)
        check(all(x is None and y is None or torch.equal(x, y)
                  for x, y in zip(out, ref)),
              f"{kernel} kernel and plain version disagree at {name} frame "
              "shapes")
    ids = out1[1][:H, :W]

    def gather():
        return df.gather_winner_rows(tbl, ids)

    check(torch.equal(out5[3][:, :H, :W], gather()),
          f"B5 rows differ from B1 plus the gather at {name} frame shapes")
    st["b1_ms"] = kernel_ms(lambda: cuda_tiled.solve_tiled_kernel(*b1_args),
                            "solve_tiled_kernel")
    st["b1_events_ms"] = cuda_ms(
        lambda: cuda_tiled.solve_tiled_kernel(*b1_args), 20)
    st["gather_ms"] = cuda_ms(gather, 20)
    st["b1_plus_gather_ms"] = cuda_ms(
        lambda: df.gather_winner_rows(
            tbl, cuda_tiled.solve_tiled_kernel(*b1_args)[1][:H, :W]), 20)
    st["b5_ms"] = kernel_ms(lambda: cuda_tiled.solve_fetch_kernel(*b5_args),
                            "solve_tiled_kernel")
    st["b5_events_ms"] = cuda_ms(
        lambda: cuda_tiled.solve_fetch_kernel(*b5_args), 20)
    st["b1_plain_ms"] = st["b5_plain_ms"] = None
    if plain:
        st["b1_plain_ms"] = cuda_ms(
            lambda: cuda_tiled.solve_phase_b_plain(*b1_args), 3)
        st["b5_plain_ms"] = cuda_ms(
            lambda: cuda_tiled.solve_phase_b_plain(*b5_args), 3)

    shade = (scene.tex_planes, scene.tex_hw, scene.fog_color,
             scene.clear_color[:, None, None].expand(4, H, W), H, W)
    epl = out1[2][:, :H, :W]

    def shade_rows():
        rows = df.expand_rows_quant(gather(), scene.state_i, scene.state_f,
                                    scene.tex_hw, want_ws=want_ws,
                                    has_refl=has_refl)
        return df.shade_rows(rows, ids >= 0, *shade, sampler_profile=sp,
                             tex_quad=scene.tex_quad,
                             eplanes=(epl[0], epl[1], epl[2]))

    st["table_ms"] = cuda_ms(table, 5)
    st["shade_rows_ms"] = cuda_ms(shade_rows, 5)
    st["shade_stage_ms"] = cuda_ms(lambda: (table(), shade_rows()), 5)
    st["shade_deferred_ms"] = cuda_ms(lambda: df.shade_deferred(
        ids, batch.xyw, batch.z, batch.color, batch.specular, batch.uv,
        batch.fog, batch.state_idx, scene.state_i, scene.state_f, *shade,
        batch_refl=batch.refl, sampler_profile=sp,
        tex_quad=scene.tex_quad), 5)

    # Bounds from this frame's inputs: every tile streams its own live
    # rows and both leftover segments past its 1024 pixels, and the pairs
    # that pass the rect and the three edge tests need esum and depth; the
    # bytes are those rows, the per-tile ranges, the initial depth plane
    # and the outputs, and for B5 also one table row per distinct winner.
    leftn = a["leftn"].tolist()
    pairs = tiled_pairs(a["counts"], sum(leftn), 32)
    past = tiled_pairs_past_edges(
        a["stream"], a["starts"], a["counts"],
        ((a["gbase"], leftn[0]), (a["sbase"], leftn[1])), 32, a["tiles_x"],
        a["tiles_y"])
    # The rows the tiles stream: each tile's live rows and the two leftover
    # segments, each once.
    solve_in = ((int(a["counts"].sum()) + sum(leftn)) * a["stream"].shape[1]
                * 4 + nbytes(a["starts"], a["counts"], a["leftn"], init))
    winners_n = int(torch.unique(ids[ids >= 0]).numel())
    bounds = {"B1": roofline(past, pairs, a["n_planes"],
                             solve_in + nbytes(*out1)),
              "B5": roofline(past, pairs, a["n_planes"],
                             solve_in + nbytes(*out5)
                             + winners_n * tbl.shape[1] * 4)}
    live_tiles = a["counts"][a["counts"] > 0].float()
    emit("timing", config=name, card=card, fps=fps, size=[W, H],
         **{k: v if v is None else round(v, 4) for k, v in st.items()},
         table_words=int(tbl.shape[1]), distinct_winners=winners_n,
         b1_bound_ms=bounds["B1"]["bound_ms"],
         b5_bound_ms=bounds["B5"]["bound_ms"],
         b1_old_count_bound_ms=bounds["B1"]["old_count_bound_ms"],
         b5_old_count_bound_ms=bounds["B5"]["old_count_bound_ms"],
         pixel_row_pairs=pairs, pairs_past_edges=past,
         binstats=a["binstats"].cpu().tolist(),
         leftover_rows=leftn, tiles=int(a["counts"].numel()),
         tile_rows_mean=float(live_tiles.mean()),
         tile_rows_peak=int(a["counts"].max()),
         note="b1_ms and b5_ms are the kernels' own times on the card "
         "(torch.profiler); the other stage times are CUDA-event means of "
         "the stage alone; shade_stage = table + gather + expand + "
         "shade_rows")
    return {k: (st[k.lower() + "_ms"], st[k.lower() + "_plain_ms"],
                bounds[k], st[k.lower() + "_events_ms"])
            for k in ("B1", "B5")}


# What one tick of each scene changes before its Render(): the mover's
# rotation about y, or the scene's own tick (config 3 rotates its roots and
# moves its bulb, config 4 advances its clip by 0.5 frames).
ANGLES = {"config1": 0.02, "config2": 0.03, "config5": 0.01,
          "alpha50k": 0.02, "alpha_tex50k": 0.02, "config5_fx": 0.01,
          "config5_mat": 0.01, "config5_shaded": 0.01}


def ticker(name, mover):
    if callable(mover):
        return mover
    return lambda: mover.Rotate((0, 1, 0), ANGLES[name])


def device_window(fn, reps: int) -> tuple:
    """(device launches, device ms, wall ms) per call of ``fn()`` over a
    ``torch.profiler`` window of ``reps`` calls after one warm-up call; the
    wall time is the calls', the profiler's overhead included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import profile_window

    def device(prof):
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    prof, wall_ms = profile_window(
        fn, reps, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
        lambda p: len(device(p)) > 0, label="frames")
    dev = device(prof)
    check(len(dev) > 0, "the profiler recorded no device activity")
    dev_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                 else e.cuda_time_total for e in dev)
    return len(dev) / reps, dev_us / 1e3 / reps, wall_ms


def profile_frames(rc, step, frames: int = 3) -> dict:
    """What one tick (``step()``, then Render()) puts on the card: device
    kernel and copy launches per frame and their summed device time."""
    def tick():
        step()
        rc.Render()

    launches, dev_ms, wall_ms = device_window(tick, frames)
    return {"device_launches_per_frame": launches,
            "device_ms_per_frame": dev_ms, "profiled_frame_ms": wall_ms}


def stage_spy(fr, fn):
    """Route the skinned frame's animate + compose stage
    (``frame.eval_anim_world``) and skin stage (``skinning.apply_skin``)
    through ``fn(name, stage, *args, **kw)``; returns the restore call."""
    from ckrenderengine_tpu_torch.pipeline import skinning

    saved = [(fr, "eval_anim_world"), (skinning, "apply_skin")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    for mod, name, stage in saved:
        setattr(mod, name, lambda *a, _n=name, _s=stage, **k: fn(
            _n, _s, *a, **k))

    def restore():
        for mod, name, stage in saved:
            setattr(mod, name, stage)
    return restore


def skinned_checks(name, rc, tick, kernel_fns, launches, fr) -> dict:
    """Config 4 after its first frame: a tick of the clip must change the
    frame (and launch B1 once), and one more frame's animate, compose and
    skin stages run under ``set_sync_debug_mode("error")``, which raises
    on any host synchronisation inside them."""
    fb0 = rc.fb.clone()
    reset_launches(kernel_fns.values())
    tick()
    rc.Render()
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in kernel_fns.items()}
    for k in launches:
        launches[k] += got[k]
    changed = float((rc.fb != fb0).any(0).float().mean())
    check(got["B1"] == 1 and sum(got.values()) == 1,
          f"{name}: the ticked frame launched {got}")
    check(changed > 0.001, f"{name}: a clip tick changed {changed} "
          "of the frame")
    ran = []

    def checked(name, stage, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = stage(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran.append(name)
        return out

    restore = stage_spy(fr, checked)
    try:
        tick()
        rc.Render()
        torch.cuda.synchronize()
    finally:
        restore()
    check(sorted(ran) == ["apply_skin", "eval_anim_world"],
          f"{name}: sync-checked stages {ran}")
    return dict(tick_launches=got, tick_changed_frac=changed,
                sync_checked_stages=sorted(ran),
                skinned_vertices=int(rc._compiled.skin_bank.valid.sum()),
                bones=int(rc._compiled.skin_bank.bone_row.shape[0]),
                anim_tracks=int(rc.GetBoundAnimation().bank(
                    n_entities=rc.context.entity_table.count,
                    device="cuda").rot_n.shape[0]))


def hud_checks(rc) -> dict:
    """Config 3's foreground HUD on the card, where no triangle lies behind
    it: the HUD square's and the label's pixels are the sprite's image
    (the label's: its text raster) times the entity colour, blended over
    the clear colour as the overlay composite does, within 1e-6."""
    ids = winners(rc)
    fb = rc.framebuffer()
    clear = np.asarray(rc.background_color, np.float32)
    out = {}
    for ent in ("hud", "fpslabel"):
        e = rc.context.GetObjectByName(ent)
        img = np.asarray(e.texture().current_image(), np.float32)
        x0, y0, x1, y1 = (int(v) for v in e.screen_rect(rc.width,
                                                        rc.height))
        check(img.shape[:2] == (y1 - y0, x1 - x0),
              f"config3: {ent} image {img.shape} in rect {(x0, y0, x1, y1)}")
        src = img * np.asarray(e.color, np.float32)
        a = src[..., 3:4]
        want = np.concatenate([src[..., :3] * a
                               + clear[:3] * (np.float32(1.0) - a),
                               np.maximum(clear[3], a)], -1)
        empty = ids[y0:y1, x0:x1] < 0
        err = float(np.abs(fb[y0:y1, x0:x1] - want).max(-1)[empty].max())
        covered = int((a[..., 0][empty] > 0.5).sum())
        out[ent] = {"rect": [x0, y0, x1, y1], "max_abs_err": err,
                    "empty_frac": float(empty.mean()),
                    "pixels_alpha_over_half": covered}
        check(empty.mean() > 0.5, f"config3: {ent} hidden by the scene")
        check(err <= 1e-6, f"config3: {ent} differs from its image by {err}")
        check(covered > 50, f"config3: {ent} shows {covered} pixels")
    return {"hud": out}


def time_overlay(rc, fps, card, fr) -> None:
    """Config 3's foreground composite (its HUD sprite and label over the
    frame) on its own at the frame's inputs: device launches and device ms
    per frame (``torch.profiler``) and CUDA-event ms; it runs once under
    ``set_sync_debug_mode("error")`` first (no host read of a quad)."""
    from ckrenderengine_tpu_torch.pipeline.overlay import (
        QuadBank, composite_quads,
    )

    static, dyn_f, dyn_i, params = rc._fill_packed(*rc._quad_lists())
    dev = rc.context.device
    scene, d = fr.unpack_scene(static, torch.as_tensor(dyn_f, device=dev),
                               torch.as_tensor(dyn_i, device=dev),
                               params["layout"])
    bank = QuadBank(rect=d["qfg_rect"], uvrect=d["qfg_uvrect"],
                    color=d["qfg_color"], tex=d["qfg_tex"],
                    blend=d["qfg_blend"], valid=d["qfg_valid"] != 0)
    win = params["quad_windows"][1]
    fb = rc.fb.clone()

    def go():
        return composite_quads(fb, bank, scene.tex_planes, scene.tex_hw,
                               rc.height, rc.width, win)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        go()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_dev, dev_ms, _wall = device_window(go, 10)
    emit("overlay_composite", config="config3", card=card, fps=fps,
         size=[rc.width, rc.height], quads=len(win), windows=list(win),
         device_launches=n_dev, device_ms=dev_ms,
         events_ms=cuda_ms(go, 10),
         note="the foreground composite alone at the frame's inputs; "
         "device_ms from torch.profiler, events_ms a CUDA-event mean")


def time_skin_stage(rc, fps, card, fr) -> None:
    """The animate + compose + skin stage of one config 4 frame on its
    own, at the frame's inputs: its device launches and device ms per
    frame (``torch.profiler``) and its CUDA-event ms (which hold the host's
    launch gaps), beside the frame's."""
    calls = {}

    def keep(name, stage, *a, **k):
        calls[name] = (stage, a, k)
        return stage(*a, **k)

    restore = stage_spy(fr, keep)
    try:
        rc.Render()
        torch.cuda.synchronize()
    finally:
        restore()

    def run(names):
        def go():
            for nm in names:
                stage, a, k = calls[nm]
                stage(*a, **k)
        return go

    out = {}
    for label, names in (("animate_compose", ["eval_anim_world"]),
                         ("skin", ["apply_skin"]),
                         ("stage", ["eval_anim_world", "apply_skin"])):
        n_dev, dev_ms, _wall = device_window(run(names), 10)
        out[label] = {"device_launches": n_dev, "device_ms": dev_ms,
                      "events_ms": cuda_ms(run(names), 10)}
    emit("skin_stage", config="config4", card=card, fps=fps,
         size=[rc.width, rc.height], **out,
         note="device_ms is the stage's summed kernel time on the card per "
         "frame (torch.profiler); events_ms a CUDA-event mean of the stage "
         "alone, host launch gaps included")


# ---------------------------------------------------------------------------
# Framebuffer bands and the multi-card paths
# ---------------------------------------------------------------------------

# The banded frames: (name, where the context comes from, bands, kernels
# each band launches). A mesh names card 0 once per band.
BAND_FRAMES = (("config5", "configs", 4, ("B1",)),
               ("config5_aa", "aa", 4, ("B1",)),
               ("config1", "configs", 4, ("B2",)),
               ("alpha50k", "configs", 4, ("B1", "B3")),
               ("alpha_tex50k", "configs", 4, ("B1", "B4")),
               ("config5_fx", "build", 4, ("B1", "B4", "L1", "L1_bins")),
               ("config2_mips_odd_bands", "build", 6, ("B1",)))
# The band whose kernels are timed and held against their plain versions.
BAND_TIMED = 1


def band_spy(fr, ll, cuda_tiled, co):
    """Catch, per band, the inputs each kernel's dispatch receives during
    the next banded Render(): {kernel: [inputs, ...]} in band order. The
    callers are wrapped, never the wrappers (which count their launches
    through their module's global names). Returns (seen, restore)."""
    seen = {}
    saved = [(cuda_tiled, "solve_phase_b"), (fr, "depth_reduce_cuda"),
             (co, "blend_phase_b"), (co, "peel_phase_b"), (ll, "draw_lines")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    real = {name: fn for _mod, name, fn in saved}

    def solve(stream, *a, shade_tbl=None, kchunk=128, row0=0):
        seen.setdefault("B5" if shade_tbl is not None else "B1", []).append(
            ((stream,) + a, shade_tbl, row0))
        return real["solve_phase_b"](stream, *a, shade_tbl=shade_tbl,
                                     kchunk=kchunk, row0=row0)

    def flat(setup, defer, clear_z, viewport, h, w, row0=0):
        from ckrenderengine_tpu_torch.raster.cuda_reduce import pack_rows
        seen.setdefault("B2", []).append(
            (pack_rows(setup, defer), clear_z, viewport, h, w, row0))
        return real["depth_reduce_cuda"](setup, defer, clear_z, viewport, h,
                                         w, row0=row0)

    def blend(stream, *a):
        seen.setdefault("B3", []).append((stream,) + a)
        return real["blend_phase_b"](stream, *a)

    def peel(stream, *a):
        seen.setdefault("B4", []).append((stream,) + a)
        return real["peel_phase_b"](stream, *a)

    def lines(fb, zb, scene, world, bank, h, w, *a, row0=0.0, **k):
        seen.setdefault("L1", []).append(
            (fb, zb, ll.line_rows(scene, world, bank), h, w, row0))
        return real["draw_lines"](fb, zb, scene, world, bank, h, w, *a,
                                  row0=row0, **k)

    for mod, name, fn in saved:
        setattr(mod, name, {"solve_phase_b": solve, "depth_reduce_cuda": flat,
                            "blend_phase_b": blend, "peel_phase_b": peel,
                            "draw_lines": lines}[name])

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return seen, restore


def band_kernel(kernel, inputs, name, card, ll, cuda_tiled, cuda_reduce,
                co) -> tuple:
    """One kernel at one band's own inputs (caught by :func:`band_spy`):
    equal to its plain version bit for bit, its own time on the card, its
    CUDA-event time and the plain version's, beside its bound from these
    inputs. Returns (kernel ms, plain ms, bound, events ms, row0)."""
    if kernel in ("B1", "B5"):
        args, tbl, row0 = inputs
        kw = dict(row0=row0)
        if kernel == "B1":
            def kfn():
                return cuda_tiled.solve_tiled_kernel(*args, **kw)
            label = "solve_tiled_kernel"
        else:
            def kfn():
                return cuda_tiled.solve_fetch_kernel(*args, tbl, **kw)
            label = "solve_tiled_kernel"

        def pfn():
            return cuda_tiled.solve_phase_b_plain(*args, shade_tbl=tbl, **kw)

        (stream, starts, counts, leftn, gbase, sbase, _vp, w, h, init, tile,
         tx, ty, n_planes, _want_e) = args
        left = leftn.tolist()
        outs = kfn()
        n_bytes = ((int(counts.sum()) + sum(left)) * stream.shape[1] * 4
                   + nbytes(starts, counts, leftn, init, *outs))
        if tbl is not None:
            ids = outs[1]
            n_bytes += int(torch.unique(ids[ids >= 0]).numel()) \
                * tbl.shape[1] * 4
        bound = roofline(
            tiled_pairs_past_edges(stream, starts, counts,
                                   ((gbase, left[0]), (sbase, left[1])),
                                   tile, tx, ty, row0=row0),
            tiled_pairs(counts, sum(left), tile), n_planes, n_bytes)
    elif kernel == "B2":
        rows, cz, vp, h, w, row0 = inputs

        def kfn():
            return cuda_reduce.reduce_flat_kernel(rows, cz, vp, h, w, row0)

        def pfn():
            return cuda_reduce.depth_reduce_plain(rows, cz, vp, h, w,
                                                  row0=row0)
        label = "reduce_flat_kernel"
        outs = kfn()
        bound = flat_bound(rows, outs, h, w, vp.tolist(), row0)
    elif kernel in ("B3", "B4"):
        args = inputs
        stream, starts, counts, params = args[:4]
        tile, tx, ty, n_planes = args[-4:]
        row0 = int(params[6])
        h, w = int(params[5]), int(params[4])
        kfn_, pfn_ = ((co.blend_kernel, co.blend_phase_b_plain)
                      if kernel == "B3"
                      else (co.peel_kernel, co.peel_phase_b_plain))

        def kfn():
            return kfn_(*args)

        def pfn():
            return pfn_(*args)
        label = ("ordered_blend_kernel" if kernel == "B3"
                 else "ordered_peel_kernel")
        outs = kfn()
        outs = (outs,) if kernel == "B3" else outs
        row_floats = (stream.shape[1] if kernel == "B3"
                      else co.head_width(n_planes))
        bound = roofline(
            tiled_pairs_past_edges(stream, starts, counts, (), tile, tx, ty,
                                   row0=row0),
            tiled_pairs(counts, 0, tile), n_planes,
            int(counts.sum()) * row_floats * 4
            + nbytes(starts, counts, args[-5], *outs))
    else:
        fb, zb, rows, h, w, row0 = inputs

        def kfn():
            return ll.lines_kernel(fb, zb, rows, h, w, row0=row0)

        def pfn():
            return ll.draw_lines_plain(fb, zb, rows, h, w, row0=row0)
        bound = lines_bound(rows, zb, h, w, ll, row0)
        check_l1(ll, fb, zb, rows, h, w, row0, f"{name}'s band")
    if kernel != "L1":
        out_k, out_p = kfn(), pfn()
        if isinstance(out_k, torch.Tensor):
            out_k, out_p = (out_k,), (out_p,)
        same = all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(out_k, out_p))
        check(same, f"{kernel} and its plain version disagree at {name}'s "
              f"band at row {row0}")
        st = {"ms": kernel_ms(kfn, label)}
    else:
        # L1's time is the sum of its launches: the bin step and the draw.
        parts = kernel_parts_ms(kfn, L1_PARTS)
        st = {"ms": sum(parts.values()),
              **{f"{k}_ms": v for k, v in parts.items()},
              "copy_floor_ms": kernel_ms(
                  lambda: ll.lines_kernel(fb, zb, rows[:0], h, w,
                                          row0=row0), "lines_kernel")}
        bound.update(parts_ms=parts, copy_floor_ms=st["copy_floor_ms"])
    st.update(events_ms=cuda_ms(kfn, 20), plain_ms=cuda_ms(pfn, 2))
    emit("band_kernel", config=name, kernel=kernel, card=card, row0=row0,
         size=[w, h], equal_to_plain=True,
         **{k: round(v, 5) for k, v in st.items()},
         bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
         note="ms is the kernel's own time on the card (torch.profiler) at "
         "this band's inputs; events_ms and plain_ms CUDA-event means")
    check(st["ms"] >= bound["bound_ms"],
          f"{kernel} at {name}'s band: {st['ms']} ms is below its bound")
    return st["ms"], st["plain_ms"], bound, st["events_ms"], row0


def bands_phase(O, scenes, fr, kernel_fns, launches, card, configs,
                aa) -> dict:
    """One context's frame in horizontal bands (``SetTileSharding`` over a
    mesh that names card 0 once per band) against the unbanded frame of
    the same tick, fb and zb bit for bit: config 5 (B1 with e-planes at
    rows 0, 192, 384, 576), config 5 with Antialias (bands of 384 render
    rows), config 1 (B2), ``alpha50k`` (B3), ``alpha_tex50k`` (B4, each
    band its own round count), ``config5_fx`` (L1, 3D sprites) and config
    2 with mips at 1000x750 in 6 bands of 125 rows (odd: each band renders
    a halo row so that its 2x2 quads are the frame's); config 5 again
    under ``CK_FUSED_FETCH`` (B5). Each kernel is launched once per band
    (B4 once per round) and nothing else; each is held against its plain
    version at band ``BAND_TIMED``'s own inputs and timed there, and B1,
    B5, B2, B3, B4 and L1 against their plain versions on the band cases
    of the fixtures. Prints the device ms of a banded config 5 frame
    beside the unbanded one. Returns {"errs": {kernel: [max abs error]},
    "ms": {kernel: (ms, plain ms, bound, events ms, row0, config)}}."""
    from ckrenderengine_tpu_torch import cuda_build
    from ckrenderengine_tpu_torch.pipeline import lines as ll
    from ckrenderengine_tpu_torch.raster import cuda_ordered as co
    from ckrenderengine_tpu_torch.raster import cuda_reduce, cuda_tiled
    from ckrenderengine_tpu_torch.raster import deferred as df
    from ckrenderengine_tpu_torch.raster import (
        flat_fixtures, ordered_fixtures, tiled_fixtures,
    )

    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import (
        profile_window, profiled_kernels,
    )

    t_phase = time.monotonic()
    fns = dict(kernel_fns, **line_fns(ll))
    for k in line_fns(ll):
        launches.setdefault(k, 0)
    errs = {k: [] for k in fns}
    timed = {}
    # The kernels at row0 != 0 on the fixtures' band cases.
    for tile, kchunk in ((32, 128), (16, 32)):
        for case in tiled_fixtures.band_cases(tile=tile, kchunk=kchunk):
            e1, e5 = compare_case(dict(case, name=f"{case['name']}_t{tile}"))
            errs["B1"].append(e1)
            errs["B5"].append(e5)
        for case in ordered_fixtures.band_cases(tile=tile):
            e3, e4 = compare_ordered(case, tile)
            errs["B3"].append(e3)
            errs["B4"].append(e4)
    errs["B2"] += [compare_flat(case, cuda_build.library().lib)
                   for case in flat_fixtures.band_cases()]
    for row0 in (192.0, 577.0):
        errs["L1"].append(fixture_l1(ll, 192, 1024, 23, row0))
    emit("band_fixtures", card=card,
         max_abs_err={k: max(v) for k, v in errs.items() if v})

    built = {}
    for name, source, n, kernels in BAND_FRAMES:
        if source == "configs":
            rc = configs[name][1]
        elif source == "aa":
            rc = aa[name.removesuffix("_aa")][1]
        elif name == "config5_fx":
            _c, rc, _m = render_config(scenes.build_config5_fx, O, "cuda")
        else:
            _c, rc, _m = render_config(scenes.build_config2, O, "cuda",
                                       width=1000, height=750, mips=True)
        built[name] = rc
        rc.SetTileSharding(0)
        rc.Render()
        fb0, zb0 = rc.fb.clone(), rc.zb.clone()
        check(rc.SetTileSharding(n, devices=["cuda:0"] * n),
              f"{name}: {n} bands refused")
        quant = count_calls(df, "shade_row_table_quant")
        seen, restore = band_spy(fr, ll, cuda_tiled, co)
        reset_launches(fns.values())
        t0 = time.monotonic()
        try:
            rc.Render()
            torch.cuda.synchronize()
        finally:
            restore()
            n_quant = quant()
        band_s = time.monotonic() - t0
        got = {k: fn.launches for k, fn in fns.items()}
        for k in got:
            launches[k] += got[k]
        differ = int(((rc.fb != fb0).any(0) | (rc.zb != zb0)).sum())
        row0s = {k: [v[-1] if k != "B3" and k != "B4" else int(v[3][6])
                     for v in seen[k]] for k in seen}
        # The same frame under the profiler: what the card ran.
        prof, _wall = profile_window(
            rc.Render, 1, [ProfilerActivity.CUDA],
            lambda p: profiled_kernels(p)[kernels[0]] >= n, label=name)
        on_card = profiled_kernels(prof)
        emit("bands", config=name, card=card, size=[rc.width, rc.height],
             bands=n, launches=got, profiled_kernels=on_card,
             band_row0s=row0s, pixels_that_differ=differ,
             banded_frame_s=round(band_s, 3), quantized_row_tables=n_quant)
        check(all(on_card[k] == got[k] for k in got),
              f"{name}: the profiler saw {on_card}, the wrappers {got}")
        check(differ == 0, f"{name}: the banded frame differs from the "
              f"unbanded one on {differ} pixels")
        for k in fns:
            if k in kernels:
                check(got[k] >= n if k == "B4" else got[k] == n,
                      f"{name}: {k} launched {got[k]} times in {n} bands")
            else:
                check(got[k] == 0, f"{name}: {k} launched {got[k]} times")
        check(all(len(set(r)) == n and sorted(r) == r
                  for r in row0s.values()), f"{name}: band rows {row0s}")
        if name == "config2_mips_odd_bands":
            check(n_quant == n and row0s["B1"][1] % 2 == 0,
                  f"{name}: quantized rows {n_quant}, rows {row0s}")
        for k in kernels:
            if (k, name) in (("B1", "config5"), ("B2", "config1"),
                             ("B3", "alpha50k"), ("B4", "alpha_tex50k"),
                             ("L1", "config5_fx"), ("B1", "config5_aa")):
                key = k if name != "config5_aa" else "B1_aa"
                # The first call at band BAND_TIMED's row offset (B4 runs
                # once per round).
                at = sorted(set(row0s[k]))[BAND_TIMED]
                first = seen[k][row0s[k].index(at)]
                timed[key] = band_kernel(k, first, name, card, ll, cuda_tiled,
                                         cuda_reduce, co) + (name,)
                if k == "B1":
                    # B5 at the same band: the frame's quantized table.
                    args, _tbl, row0 = first
                    tbl = _band_table(rc, fr, df)
                    timed["B5" if name == "config5" else "B5_aa"] = (
                        band_kernel("B5", (args, tbl, row0), name, card, ll,
                                    cuda_tiled, cuda_reduce, co) + (name,))

    # Config 5 again under CK_FUSED_FETCH: B5 once per band, no B1.
    rc = built["config5"]
    fb_b, zb_b = rc.fb.clone(), rc.zb.clone()
    os.environ["CK_FUSED_FETCH"] = "1"
    reset_launches(fns.values())
    try:
        rc.Render()
        torch.cuda.synchronize()
    finally:
        del os.environ["CK_FUSED_FETCH"]
    got = {k: fn.launches for k, fn in fns.items()}
    for k in got:
        launches[k] += got[k]
    differ = int(((rc.fb != fb_b).any(0) | (rc.zb != zb_b)).sum())
    emit("bands_fused_fetch", config="config5", bands=4, launches=got,
         pixels_that_differ=differ)
    check(got["B5"] == 4 and got["B1"] == 0 and differ == 0,
          f"config5 banded fused fetch: {got}, {differ} pixels differ")

    # Device ms per frame, banded beside unbanded (the vertex stage runs
    # once per band: about four times its cost on one card).
    per = {}
    for bands in (4, 0):
        rc.SetTileSharding(bands, devices=["cuda:0"] * bands)
        per["banded" if bands else "unbanded"] = profile_frames(
            rc, lambda: None, frames=1)
    emit("bands_device_ms", config="config5", card=card, bands=4, **per,
         note="device_ms_per_frame is the frame's summed kernel and copy "
         "time on the card (torch.profiler)")
    for r in built.values():
        r.SetTileSharding(0)
    emit("bands_phase", card=card, seconds=round(time.monotonic() - t_phase,
                                                  1))
    return {"errs": errs, "ms": timed}


def _band_table(rc, fr, df):
    """The quantized shade table of ``rc``'s frame (what B5 fetches from in
    a band of it)."""
    static, dyn_f, dyn_i, params = packed_cuda(rc)
    scene, batch, setup, _d, _b = fr.packed_setup(static, dyn_f, dyn_i,
                                                  params)
    sp = params["sampler_profile"]
    return df.shade_row_table_quant(
        batch.xyw, batch.color, batch.specular, batch.uv, batch.fog,
        batch.state_idx, batch_refl=batch.refl,
        inv_det_s=setup["inv_det_s"], want_ws=not sp[3])


def multicard_phase(O, scenes, kernel_fns, card) -> None:
    """The multi-card paths on a mesh that names card 0 four times (the
    driver's machine has one card): ``dryrun_multichip(4)`` (the full,
    packed and band paths, each bit-equal to one device) and
    ``ProcessBatched(mesh=)`` of 8 contexts of 256x256 over a 4-entry
    context mesh, bit-equal to ``ProcessBatched()``, with B1 launched once
    per member. On a machine with several cards the same runs again over
    them (a 4-entry mesh, each card in turn); with one card a line says so
    (no pass)."""
    import contextlib
    import io

    from torch.profiler import ProfilerActivity

    from ckrenderengine_tpu_torch.frame_bench import (
        profile_window, profiled_kernels,
    )
    from ckrenderengine_tpu_torch.parallel.dryrun import dryrun_multichip
    from ckrenderengine_tpu_torch.parallel.mesh import (
        DeviceMesh, check_device,
    )

    t_phase = time.monotonic()
    n_cards = torch.cuda.device_count()
    meshes = [("cuda:0 x4", ["cuda:0"] * 4)]
    if n_cards > 1:
        meshes.append((f"{n_cards} cards",
                       [f"cuda:{i % n_cards}" for i in range(4)]))
    for label, devices in meshes:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(4, devices=devices)
        lines = [ln for ln in buf.getvalue().splitlines() if "path ok" in ln]
        emit("multicard_dryrun", mesh=label, card=card, lines=lines)
        check(len(lines) == 3, f"dryrun_multichip on {label}: {lines}")

        rm, rcs, root = scenes.build_batched(O, 8, 256, device="cuda")
        rm.ProcessBatched()
        whole = [(rc.fb.clone(), rc.zb.clone()) for rc in rcs]
        mesh = DeviceMesh(devices, "ctx")
        differ = []
        for _ in range(2):
            # The first captures each block's window, the second replays it
            # under the profiler: B1 once per member, nothing else.
            prof, _wall = profile_window(
                lambda: rm.ProcessBatched(mesh=mesh) or float(
                    rcs[-1].fb.sum()), 1, [ProfilerActivity.CUDA],
                lambda p: profiled_kernels(p)["B1"] >= 8, label=label)
            differ.append(sum(int(((rc.fb != a).any(0) | (rc.zb != b)).sum())
                              for rc, (a, b) in zip(rcs, whole)))
        seen = profiled_kernels(prof)
        runs = [len(chunk) for _p, chunk, _i in rcs[0]._batch_read.runs] \
            if rcs[0]._batch_read is not None else None
        on_home = all(rc.fb.device == check_device(rc.context.device)
                      for rc in rcs)
        emit("multicard_batch", mesh=label, card=card, contexts=8,
             size=[256, 256], profiled_kernels=seen,
             pixels_that_differ=differ, block_runs=runs,
             buffers_on_their_contexts_device=on_home)
        check(differ == [0, 0] and on_home,
              f"ProcessBatched(mesh) on {label}: {differ} pixels differ")
        check(seen["B1"] == 8 and sum(seen.values()) == 8,
              f"ProcessBatched(mesh) on {label}: {seen}")
    if n_cards == 1:
        emit("multicard_real_cards", run=False, cards=n_cards,
             note="not run: this machine has 1 card; the multi-card paths "
             "ran on a mesh naming card 0 four times")
    emit("multicard_phase", card=card,
         seconds=round(time.monotonic() - t_phase, 1))


if __name__ == "__main__":
    sys.exit(main())
