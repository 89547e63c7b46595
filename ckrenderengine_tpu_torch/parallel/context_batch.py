"""Many render contexts: scenes stacked on a leading context axis and
rendered member by member, on one device or in blocks over a context mesh.

The counterpart of ``ckrenderengine_tpu/parallel/context_batch.py``, which
stacks ``SceneDevice`` pytrees on a ``ctx`` axis, vmaps the frame program
over it with its Pallas kernels switched off, and shards the axis over a
device mesh. Here the same functions are a loop over the context axis of
:func:`pipeline.frame.render_frame_impl` /
:func:`~pipeline.frame.render_frame_full_impl`: a CUDA tensor launches the
kernels in every member's frame, a CPU tensor runs their plain versions,
which equal the kernels bit for bit. (``CKRenderManager.ProcessBatched``
does not take this path: it replays one captured frame per member,
``pipeline.window``.) The mesh functions split the context axis into
contiguous blocks, one per entry of a ``ctx`` mesh
(:class:`~.mesh.DeviceMesh`), and render each block on its entry's device
with no communication between them; the outputs come back stacked on the
first entry's device, one copy per block.
"""

from __future__ import annotations

import torch

from ..pipeline.frame import (
    SceneDevice, render_frame_full_impl, render_frame_impl,
    render_frames_packed_batched,
)
from .mesh import DeviceMesh, on, to_device


def _map(fn, *trees):
    """``fn`` over the tensor leaves of equal-structured scenes (nested
    NamedTuples; None leaves stay None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)


def stack_scenes(scenes: list[SceneDevice]) -> SceneDevice:
    """Stack same-topology scenes on a leading context axis."""
    return _map(lambda *xs: torch.stack(xs), *scenes)


def replicate_scene(scene: SceneDevice, n: int) -> SceneDevice:
    """``scene`` repeated ``n`` times on a leading context axis (a
    broadcast view, no copy)."""
    return _map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)),
                scene)


def member(scenes: SceneDevice, i: int) -> SceneDevice:
    """Member ``i`` of stacked scenes."""
    return _map(lambda x: x[i], scenes)


def _count(scenes: SceneDevice) -> int:
    return scenes.local.shape[0]


def _stack_frames(frames) -> tuple:
    """Per-member (fb, zb) -> (B,4,H,W) fb, (B,H,W) zb."""
    return tuple(torch.stack(planes) for planes in zip(*frames))


def render_frames_batched(scenes: SceneDevice, levels: tuple, height: int,
                          width: int, ordered_cap: int | None = None,
                          chunk: int = 64):
    """(B, ...) scenes -> (B,4,H,W) fb, (B,H,W) zb: each member's frame
    with the reference's defaults (its vmapped ``render_frame_impl``).
    ``chunk`` is the reference's signature; the port's frame takes no
    chunk size."""
    return _stack_frames(
        render_frame_impl(member(scenes, i), levels, height, width,
                          ordered_cap=ordered_cap, want_texgen=True)[:2]
        for i in range(_count(scenes)))


def render_frames_full_batched(scenes: SceneDevice, levels: tuple,
                               height: int, width: int, skin=None, anim=None,
                               anim_t=None, ordered_cap: int | None = None,
                               chunk: int = 64, want_cube: bool = False):
    """The full step (animate -> compose -> skin -> render) per member:
    ``skin`` and ``anim`` are shared banks, ``anim_t`` a (B,) clip time per
    member (None: 0), so the members render different frames of one
    clip."""
    n = _count(scenes)
    times = [0.0] * n if anim_t is None else [
        anim_t[i] for i in range(n)]
    return _stack_frames(
        render_frame_full_impl(member(scenes, i), levels, height, width,
                               skin=skin, anim=anim, anim_t=times[i],
                               ordered_cap=ordered_cap, want_cube=want_cube,
                               want_texgen=True)[:2]
        for i in range(n))


def make_context_mesh(n_devices: int | None = None,
                      platform: str | None = None) -> DeviceMesh:
    """1-D ``ctx`` mesh over the first ``n_devices`` devices of
    ``platform``: "cuda" (or "gpu") the cards, "cpu" n entries of the CPU
    (the counterpart of the reference's virtual host devices); None the
    cards where there are any, else the CPU. ``ValueError`` when the
    platform has fewer devices than asked for, as in the reference."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cpu":
        return DeviceMesh(["cpu"] * (n_devices or 1), "ctx")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if have < n or n < 1:
        raise ValueError(f"need {n} devices on platform {platform}, have "
                         f"{have}")
    return DeviceMesh([f"cuda:{i}" for i in range(n)], "ctx")


def blocks(n: int, mesh: DeviceMesh) -> list:
    """Contiguous (device, start, stop) blocks of an ``n``-member context
    axis, one per mesh entry (the earlier blocks one longer where the count
    does not divide), empty blocks left out."""
    k, extra = divmod(n, mesh.size)
    out, start = [], 0
    for i, dev in enumerate(mesh.devices):
        stop = start + k + (1 if i < extra else 0)
        if stop > start:
            out.append((dev, start, stop))
        start = stop
    return out


def shard_scenes(scenes: SceneDevice, mesh: DeviceMesh) -> list:
    """Contiguous blocks of the context axis placed on the mesh entries:
    [(device, block scenes on it), ...]."""
    return [(dev, _map(lambda x: x[a:b].to(dev), scenes))
            for dev, a, b in blocks(_count(scenes), mesh)]


def _gather(outs, mesh: DeviceMesh) -> tuple:
    """Per-block output tuples -> the tuple of their concatenations on the
    first entry's device (one copy per block)."""
    return tuple(torch.cat([o.to(mesh.devices[0]) for o in planes])
                 for planes in zip(*outs))


def render_frames_sharded(scenes: SceneDevice, mesh: DeviceMesh,
                          levels: tuple, height: int, width: int,
                          ordered_cap: int | None = None, chunk: int = 64):
    """:func:`render_frames_batched` of each block of the context axis on
    its mesh entry. Returns (B,4,H,W) fb and (B,H,W) zb on the first
    entry's device."""
    outs = []
    for dev, block in shard_scenes(scenes, mesh):
        with on(dev):
            outs.append(render_frames_batched(block, levels, height, width,
                                              ordered_cap=ordered_cap))
    return _gather(outs, mesh)


def render_frames_full_sharded(scenes: SceneDevice, mesh: DeviceMesh,
                               levels: tuple, height: int, width: int,
                               skin=None, anim=None, anim_t=None,
                               ordered_cap: int | None = None,
                               chunk: int = 64):
    """The full step per block of the context axis on its mesh entry:
    ``skin`` and ``anim`` are shared banks (a copy on each entry's device),
    ``anim_t`` a (B,) clip time per member (None: 0)."""
    outs = []
    for dev, a, b in blocks(_count(scenes), mesh):
        block = _map(lambda x: x[a:b].to(dev), scenes)
        with on(dev):
            outs.append(render_frames_full_batched(
                block, levels, height, width, skin=to_device(skin, dev),
                anim=to_device(anim, dev),
                anim_t=None if anim_t is None else anim_t[a:b],
                ordered_cap=ordered_cap))
    return _gather(outs, mesh)


def render_frames_packed_sharded(static: dict, dyn_f, dyn_i,
                                 mesh: DeviceMesh, **params):
    """The packed batch in blocks: the (B, F) f32 / (B, I) i32 buffers (and
    a (B, N, 4, 4) ``world_in``) cut along the context axis, each block
    uploaded once to its entry's device, ``static`` and the params' banks
    copied there, and :func:`frame.render_frames_packed_batched` run on
    it. Returns the batch's outputs stacked on the first entry's
    device."""
    world_in = params.pop("world_in", None)
    outs = []
    for dev, a, b in blocks(len(dyn_f), mesh):
        with on(dev):
            outs.append(render_frames_packed_batched(
                to_device(static, dev),
                torch.as_tensor(dyn_f[a:b], device=dev),
                torch.as_tensor(dyn_i[a:b], device=dev),
                world_in=None if world_in is None else torch.as_tensor(
                    world_in[a:b], device=dev),
                **to_device(params, dev)))
    return _gather(outs, mesh)
