"""Progressive mesh: edge-collapse LOD with geomorph support.

Carried from ``ckrenderengine_tpu.utils.progressive`` for equal integer
results. Re-implementation of the reference's PM construction
(RCKMesh::CreatePM, src/CKMesh.cpp:3579+: edge collapse with cost =
distance x curvature, and BuildRenderMesh's PM LOD + geomorph lerp
:2580-2720). The collapse order is computed once on the host (Stan
Melax's polygon-reduction formulation);
rendering at any vertex budget is a pure remap, and geomorphing is a
positions lerp that rides the dynamic pool refresh without recompiling.

``compute_collapse_order`` keeps each vertex's best collapse and each face's
normal between steps and recomputes only what a collapse touches, where the
JAX package's version recomputes every vertex at every step (O(V^3)). The
arithmetic, the sets and the order in which they are walked are the same,
so ``rank`` and ``collapse_to`` are equal.
"""

from __future__ import annotations

import numpy as np


def compute_collapse_order(positions: np.ndarray, faces: np.ndarray,
                           weights: np.ndarray | None = None):
    """Edge-collapse sequence.

    Returns (rank, collapse_to):
    - rank (V,) int32: removal order; the vertex removed LAST has rank V-1,
      so rendering at budget n keeps the vertices with rank >= V - n.
    - collapse_to (V,) int32: vertex that v collapses onto (-1 for the last).
    """
    v_count = positions.shape[0]
    pos = positions.astype(np.float64)
    faces = np.asarray(faces, np.int64)

    # adjacency
    vert_faces: list[set] = [set() for _ in range(v_count)]
    vert_neighbors: list[set] = [set() for _ in range(v_count)]
    face_alive = np.ones(faces.shape[0], bool)
    face_verts = [list(f) for f in faces]
    for fi, (a, b, c) in enumerate(faces):
        for v in (a, b, c):
            vert_faces[v].add(fi)
        vert_neighbors[a].update((b, c))
        vert_neighbors[b].update((a, c))
        vert_neighbors[c].update((a, b))

    normals: dict[int, np.ndarray] = {}

    def face_normal(fi):
        n = normals.get(fi)
        if n is None:
            a, b, c = face_verts[fi]
            n = np.cross(pos[b] - pos[a], pos[c] - pos[a])
            l = np.linalg.norm(n)
            n = n / l if l > 1e-12 else np.zeros(3)
            normals[fi] = n
        return n

    def edge_cost(u, v):
        """cost(u->v) = |u-v| * curvature (Melax; the reference's
        distance x curvature). Vertex weights (RCKMesh::SetVertexWeight)
        scale the cost, protecting weighted vertices from collapse."""
        length = np.linalg.norm(pos[v] - pos[u])
        sides = [fi for fi in vert_faces[u] if v in face_verts[fi]]
        curvature = 0.0
        for fi in vert_faces[u]:
            if not face_alive[fi]:
                continue
            mincurv = 1.0
            nf = face_normal(fi)
            for si in sides:
                if not face_alive[si]:
                    continue
                ns = face_normal(si)
                mincurv = min(mincurv, (1.0 - float(nf @ ns)) / 2.0)
            curvature = max(curvature, mincurv)
        cost = length * curvature
        if weights is not None and u < weights.shape[0]:
            # additive + multiplicative protection: weighted vertices stay
            # even when locally flat (curvature 0)
            cost = cost * (1.0 + float(weights[u])) + float(weights[u])
        return cost

    def best_collapse(u):
        best_v, best_c = None, np.inf
        for v in vert_neighbors[u]:
            c = edge_cost(u, v)
            if c < best_c:
                best_c, best_v = c, v
        if best_v is None:
            return -1, -1.0          # isolated: removed first
        return best_v, best_c

    alive = np.ones(v_count, bool)
    rank = np.zeros(v_count, np.int32)
    collapse_to = np.full(v_count, -1, np.int32)
    best = [best_collapse(u) for u in range(v_count)]

    for order in range(v_count):
        # pick the alive vertex with minimal collapse cost (the first one
        # on a tie)
        best_u, best_v, best_c = -1, -1, np.inf
        for u in range(v_count):
            if not alive[u]:
                continue
            v, c = best[u]
            if c < best_c:
                best_u, best_v, best_c = u, v, c
        u, v = best_u, best_v
        rank[u] = order
        collapse_to[u] = v
        alive[u] = False
        if v < 0:
            continue
        # Every cost that the collapse can change is a cost of a vertex of
        # one of u's faces: u's neighbours, v among them.
        touched = set(vert_neighbors[u])
        # collapse u -> v: rewrite faces, drop degenerates
        for fi in list(vert_faces[u]):
            if not face_alive[fi]:
                continue
            fv = face_verts[fi]
            if v in fv:
                face_alive[fi] = False
                for w in fv:
                    vert_faces[w].discard(fi)
            else:
                fv[fv.index(u)] = v
                vert_faces[v].add(fi)
                normals.pop(fi, None)
        # rewire neighbors
        for w in vert_neighbors[u]:
            if w == v:
                continue
            vert_neighbors[w].discard(u)
            vert_neighbors[w].add(v)
            vert_neighbors[v].add(w)
        vert_neighbors[v].discard(u)
        for w in touched:
            if alive[w]:
                best[w] = best_collapse(w)

    return rank, collapse_to


def lod_remap(rank: np.ndarray, collapse_to: np.ndarray, n_keep: int):
    """(V,) map from every vertex to its representative at budget n_keep."""
    v = rank.shape[0]
    n_keep = int(np.clip(n_keep, 1, v))
    remap = np.arange(v, dtype=np.int32)
    # rank[u] is the step at which u was removed, so keeping n vertices
    # keeps the last n removed: u survives iff rank[u] >= v - n_keep.
    cutoff = v - n_keep
    # Resolve collapse chains to the final survivors: latest-removed first,
    # so when u is handled its target (always removed later) already maps
    # to a surviving representative.
    for u in np.argsort(rank)[::-1]:
        if rank[u] < cutoff:
            t = collapse_to[u]
            remap[u] = remap[t] if t >= 0 else u
    return remap


def faces_at_lod(faces: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Remapped faces with degenerates removed."""
    f = remap[np.asarray(faces, np.int32)]
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    return f[keep]


def geomorph_positions(positions: np.ndarray, rank: np.ndarray,
                       collapse_to: np.ndarray, n_keep: int,
                       step: float) -> np.ndarray:
    """Positions lerped toward each collapsed vertex's representative
    (reference geomorph lerp, src/CKMesh.cpp:2580-2720). step=0 -> original,
    step=1 -> fully collapsed snap."""
    remap = lod_remap(rank, collapse_to, n_keep)
    out = positions.copy()
    moved = remap != np.arange(positions.shape[0])
    out[moved] = (positions[moved] * (1.0 - step)
                  + positions[remap[moved]] * step)
    return out
