"""Many render contexts on one card: scenes stacked on a leading context
axis and rendered member by member.

The counterpart of ``ckrenderengine_tpu/parallel/context_batch.py``, which
stacks ``SceneDevice`` pytrees on a ``ctx`` axis, vmaps the frame program
over it with its Pallas kernels switched off, and shards the axis over a
device mesh. On one card the same functions are a loop over the context
axis of :func:`pipeline.frame.render_frame_impl` /
:func:`~pipeline.frame.render_frame_full_impl`: a CUDA tensor launches the
kernels in every member's frame, a CPU tensor runs their plain versions,
which equal the kernels bit for bit. (``CKRenderManager.ProcessBatched``
does not take this path: it replays one captured frame per member,
``pipeline.window``.) The mesh functions need several cards and are not
ported.
"""

from __future__ import annotations

import torch

from ..pipeline.frame import (
    SceneDevice, render_frame_full_impl, render_frame_impl,
)
from ..roadmap import unported


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


def _sharded(*_a, **_k):
    raise unported("multi-card context sharding", 12)


make_context_mesh = shard_scenes = render_frames_sharded = _sharded
render_frames_full_sharded = render_frames_packed_sharded = _sharded
