"""Flat SoA scene state: the flat replacement for the RCK3dEntity tree.

The reference keeps a pointer-linked transform hierarchy and eagerly recurses on
every move (RCK3dEntity::WorldMatrixChanged / LocalMatrixChanged,
src/CK3dEntity.cpp:2091-2207). On an accelerator that design is hostile:
per-entity virtual dispatch, pointer chasing, and O(depth) recursion per move.

Here the hierarchy is three flat arrays:

- ``local``   (N,4,4) float32 — local transform per entity (row-vector convention)
- ``parent``  (N,)    int32   — parent index, -1 for roots
- ``flags``   (N,)    uint32  — moveable flags (visibility etc.)

World matrices for the WHOLE scene are recomputed per frame by level-ordered
batched composition: entities are grouped by hierarchy depth (a static schedule
that only changes when the tree topology changes, i.e. at recompile time), and
each level is one batched (L,4,4)@(L,4,4) matmul of locals against gathered
parent worlds. Total work is O(N) matmuls in O(depth) sequential steps — depth
is small (tens) even for Ballance-scale scenes. Very deep chains switch to
pointer doubling.

Flags mirror the reference's CK_3DENTITY/moveable flags where behavior depends
on them (VX_MOVEABLE_* in the Virtools SDK).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Moveable flags (subset used by render behavior; values = public Virtools SDK)
VX_MOVEABLE_PICKABLE = 0x00000001
VX_MOVEABLE_VISIBLE = 0x00000002
VX_MOVEABLE_RENDERCHANNELS = 0x00000080
VX_MOVEABLE_HASMOVED = 0x00000400
VX_MOVEABLE_WORLDALIGNED = 0x00000800
VX_MOVEABLE_NOZBUFFERWRITE = 0x00001000
VX_MOVEABLE_RENDERFIRST = 0x00002000
VX_MOVEABLE_NOZBUFFERTEST = 0x00004000
VX_MOVEABLE_INVERSEWORLDMATVALID = 0x00008000
VX_MOVEABLE_DONTUPDATEFROMPARENT = 0x00010000
VX_MOVEABLE_INDIRECTMATRIX = 0x00020000
VX_MOVEABLE_ZBUFONLY = 0x00040000
VX_MOVEABLE_STENCILONLY = 0x00080000
VX_MOVEABLE_HIERARCHICALHIDE = 0x00100000
VX_MOVEABLE_CHARACTERRENDERED = 0x00200000
VX_MOVEABLE_RESERVED2 = 0x00400000


def compute_levels(parent: np.ndarray) -> list[np.ndarray]:
    """Host-side: group entity indices by hierarchy depth.

    Returns a list of index arrays; level k holds all entities whose chain to a
    root has length k. Static per scene topology — recomputed only when
    parenting changes (the analogue of the reference's scene-graph dirty flags).
    """
    parent = np.asarray(parent, np.int64)
    n = parent.shape[0]
    depth = np.zeros(n, np.int64)
    # Iterative depth computation (parents may appear after children).
    changed = True
    guard = 0
    while changed:
        changed = False
        guard += 1
        if guard > n + 2:
            raise ValueError("parent cycle detected in entity table")
        has_parent = parent >= 0
        pd = np.where(has_parent, depth[np.clip(parent, 0, max(n - 1, 0))] + 1, 0)
        if not np.array_equal(pd, depth):
            depth = pd
            changed = True
    levels = []
    for d in range(int(depth.max()) + 1 if n else 0):
        idx = np.nonzero(depth == d)[0].astype(np.int32)
        if idx.size:
            levels.append(idx)
    return levels


def compose_world(local: torch.Tensor, parent: torch.Tensor,
                  levels: tuple) -> torch.Tensor:
    """Batched world-matrix composition: world[i] = local[i] @ world[parent[i]].

    ``levels`` is the static schedule from :func:`compute_levels`; its
    indices reach the device once per schedule (:func:`_device_levels`).
    Each level
    is one batched (L,4,4)@(L,4,4) ``torch.matmul`` of locals against the
    gathered parent worlds (full f32: the package turns TF32 off). Replaces
    the reference's WorldMatrixChanged recursion
    (src/CK3dEntity.cpp:2091-2207).

    Deep hierarchies (more than 12 levels) switch to pointer doubling:
    ceil(log2(depth)) batched gather+matmul rounds instead of one step per
    level.
    """
    if len(levels) > 12:
        return _compose_world_doubling(local, parent, len(levels))
    world = local
    for li, idx in enumerate(_level_tensors(levels, local.device)):
        if li == 0:
            continue  # roots: world == local
        p = parent[idx].long()
        lw = torch.matmul(local[idx], world[p])
        world = world.index_copy(0, idx, lw)
    return world


@functools.lru_cache(maxsize=16)
def _device_levels(levels: tuple, device: torch.device) -> tuple:
    """Each level's indices as an int64 tensor on ``device``, kept per
    schedule: an upload in every frame would be a blocking host copy, which
    no frame may hold (it could not be captured into a CUDA graph)."""
    return tuple(torch.as_tensor(np.asarray(idx, np.int64), device=device)
                 for idx in levels)


def _level_tensors(levels, device: torch.device) -> tuple:
    try:
        return _device_levels(levels, device)
    except TypeError:                 # an unhashable schedule: no cache
        return _device_levels.__wrapped__(levels, device)


def _compose_world_doubling(local: torch.Tensor, parent: torch.Tensor,
                            max_depth: int) -> torch.Tensor:
    """Pointer doubling with a host-known round count."""
    n = local.shape[0]
    rng = torch.arange(n, dtype=torch.int64, device=local.device)
    is_root = parent < 0
    link = torch.where(is_root, rng, parent.long())
    ident = torch.eye(4, dtype=local.dtype, device=local.device).expand_as(local)
    # chain[i] = product of local matrices of i's ancestors (nearest first).
    chain = torch.where(is_root[:, None, None], ident, local[link])
    steps = max(1, int(np.ceil(np.log2(max(max_depth, 2)))))
    for _ in range(steps):
        parent_chain = chain[link]
        at_root = link == rng
        chain = torch.where(at_root[:, None, None], chain,
                            torch.matmul(chain, parent_chain))
        link = link[link]
    return torch.where(is_root[:, None, None], local, torch.matmul(local, chain))


class EntityTable:
    """Host-side growable SoA entity table.

    Capacity grows geometrically; device shapes only change on capacity growth,
    so the jitted frame program recompiles rarely (the SURVEY build-plan's
    "recompile only on capacity growth" rule).
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self.count = 0
        self.local = np.tile(np.eye(4, dtype=np.float32), (self.capacity, 1, 1))
        self.parent = np.full(self.capacity, -1, np.int32)
        self.flags = np.full(self.capacity, VX_MOVEABLE_VISIBLE | VX_MOVEABLE_PICKABLE, np.uint32)
        self.bbox_min = np.zeros((self.capacity, 3), np.float32)
        self.bbox_max = np.zeros((self.capacity, 3), np.float32)
        self._levels: list[np.ndarray] | None = None
        self._topology_version = 0
        self._free: list[int] = []

    # -- allocation -------------------------------------------------------
    def allocate(self) -> int:
        if self._free:
            i = self._free.pop()
        else:
            if self.count >= self.capacity:
                self._grow(max(2 * self.capacity, 64))
            i = self.count
            self.count += 1
        self.local[i] = np.eye(4, dtype=np.float32)
        self.parent[i] = -1
        self.flags[i] = VX_MOVEABLE_VISIBLE | VX_MOVEABLE_PICKABLE
        self._invalidate_topology()
        return i

    def free(self, row: int):
        """Recycle a destroyed entity's row (destroy bumps topology, so no
        compiled scene can still reference it)."""
        self.local[row] = np.eye(4, dtype=np.float32)
        self.parent[row] = -1
        self.flags[row] = 0        # invisible until reallocated
        self._free.append(row)
        self._invalidate_topology()

    def _grow(self, new_cap: int):
        def grow(a, fill=0):
            out = np.empty((new_cap,) + a.shape[1:], a.dtype)
            out[: a.shape[0]] = a
            out[a.shape[0]:] = fill
            return out

        eye = np.eye(4, dtype=np.float32)
        new_local = np.tile(eye, (new_cap, 1, 1))
        new_local[: self.capacity] = self.local
        self.local = new_local
        self.parent = grow(self.parent, -1)
        self.flags = grow(self.flags, VX_MOVEABLE_VISIBLE)
        self.bbox_min = grow(self.bbox_min)
        self.bbox_max = grow(self.bbox_max)
        self.capacity = new_cap
        self._invalidate_topology()

    # -- topology ----------------------------------------------------------
    def _invalidate_topology(self):
        self._levels = None
        self._topology_version += 1

    def set_parent(self, child: int, parent: int | None):
        # Reject cycles (mirrors CKSceneGraph AddChild guards).
        p = parent if parent is not None else -1
        anc = p
        while anc is not None and anc >= 0:
            if anc == child:
                raise ValueError("re-parenting would create a cycle")
            anc = int(self.parent[anc])
        self.parent[child] = p
        self._invalidate_topology()

    def levels(self) -> list[np.ndarray]:
        if self._levels is None:
            self._levels = compute_levels(self.parent[: self.count])
        return self._levels

    def level_schedule(self) -> tuple:
        """Hashable static schedule for :func:`compose_world`."""
        return tuple(tuple(int(i) for i in lvl) for lvl in self.levels())
