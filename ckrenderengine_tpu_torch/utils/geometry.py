"""Host mesh tooling the scene compile uses to order each material group's
faces (objects/mesh.py ``_optimize_group_order``): the stripifier
(reference src/MeshStriper.cpp) and the vertex-cache optimizer (reference
src/VertexCacheOptimizer.cpp, re-designed as Forsyth linear-speed scoring),
with the edge adjacency the stripifier's fallback needs.

Hot paths dispatch to the native C++ library (native/ckcore.cpp via ctypes);
every method has a numpy fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

BOUNDARY = 0xFFFFFFFF


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


class MeshAdjacency:
    """Edge/face adjacency from a triangle list; BOUNDARY marks open edges.
    Edge k of face f connects face vertices k and (k+1)%3."""

    def __init__(self, faces=None):
        self.adj = np.zeros((0, 3), np.uint32)
        self.faces = np.zeros((0, 3), np.uint32)
        if faces is not None:
            self.Compute(faces)

    def Compute(self, faces) -> np.ndarray:
        f = np.ascontiguousarray(np.asarray(faces, np.uint32))
        n = f.shape[0]
        self.faces = f
        adj = np.full((n, 3), BOUNDARY, np.uint32)
        if n == 0:
            self.adj = adj
            return adj
        lib = native.load()
        if lib is not None:
            lib.ck_mesh_adjacency(_u32p(f), n, _u32p(adj))
        else:
            edge_map: dict = {}
            for fi in range(n):
                for k in range(3):
                    a, b = int(f[fi, k]), int(f[fi, (k + 1) % 3])
                    key = (min(a, b), max(a, b))
                    if key in edge_map:
                        of, ok = edge_map.pop(key)
                        adj[fi, k] = of
                        adj[of, ok] = fi
                    else:
                        edge_map[key] = (fi, k)
        self.adj = adj
        return adj


def _stripify(faces: np.ndarray):
    """(strips list of index arrays) via native lib or python fallback."""
    f = np.ascontiguousarray(np.asarray(faces, np.uint32))
    n = f.shape[0]
    if n == 0:
        return []
    lib = native.load()
    if lib is not None:
        out = np.zeros(4 * n + 16, np.uint32)
        lens = np.zeros(n, np.uint32)
        nstrips = ctypes.c_uint32(0)
        lib.ck_stripify(_u32p(f), n, _u32p(out), _u32p(lens),
                        ctypes.byref(nstrips))
        strips = []
        off = 0
        for i in range(nstrips.value):
            l = int(lens[i])
            strips.append(out[off:off + l].copy())
            off += l
        return strips
    # Python fallback: same greedy algorithm.
    adj = MeshAdjacency(f).adj
    degree = (adj != BOUNDARY).sum(axis=1)
    seeds = np.argsort(degree, kind="stable")
    used = np.zeros(n, bool)
    strips = []

    def third(tri, a, b):
        for v in tri:
            if v != a and v != b:
                return int(v)
        return int(tri[0])

    for s in seeds:
        if used[s]:
            continue
        tri = f[s]
        v0, v1, v2 = int(tri[0]), int(tri[1]), int(tri[2])
        for rot in range(3):
            nb = adj[s, (rot + 1) % 3]
            a = int(tri[rot])
            b = int(tri[(rot + 1) % 3])
            cc = int(tri[(rot + 2) % 3])
            v0, v1, v2 = a, b, cc
            if nb != BOUNDARY and not used[nb]:
                break
        used[s] = True
        strip = [v0, v1, v2]
        cur, ea, eb = s, v1, v2
        while True:
            nxt = None
            for k in range(3):
                nb = adj[cur, k]
                if nb != BOUNDARY and not used[nb]:
                    tri2 = f[nb]
                    if ea in tri2 and eb in tri2:
                        nxt = int(nb)
                        break
            if nxt is None:
                break
            nv = third(f[nxt], ea, eb)
            strip.append(nv)
            used[nxt] = True
            cur, ea, eb = nxt, eb, nv
        strips.append(np.asarray(strip, np.uint32))
    return strips


def strip_to_triangles(strip: np.ndarray) -> np.ndarray:
    """Strip indices -> (T,3) triangles, skipping degenerates. Winding
    alternates per strip position (standard strip parity)."""
    tris = []
    for i in range(len(strip) - 2):
        a, b, c = int(strip[i]), int(strip[i + 1]), int(strip[i + 2])
        if a == b or b == c or a == c:
            continue
        if i % 2 == 0:
            tris.append((a, b, c))
        else:
            tris.append((b, a, c))
    return np.asarray(tris, np.uint32).reshape(-1, 3)


class MeshStriper:
    """Stripifier (reference include/MeshStriper.h: strip tracking from
    seed edges, radix-sorted seeds by face degree)."""

    def __init__(self):
        self.strips: list[np.ndarray] = []

    def Compute(self, faces) -> bool:
        self.strips = _stripify(faces)
        return True


class VertexCache:
    """FIFO post-T&L cache simulator (reference include/VertexCache.h)."""

    def __init__(self, size: int = 16):
        self.size = int(size)
        self.entries: list[int] = []

    def InCache(self, v: int) -> bool:
        return v in self.entries

    def AddEntry(self, v: int) -> bool:
        """Returns True on miss (entry added)."""
        if v in self.entries:
            return False
        self.entries.insert(0, v)
        if len(self.entries) > self.size:
            self.entries.pop()
        return True


class VertexCacheOptimizer:
    """Triangle reorder for post-T&L cache locality (reference
    src/VertexCacheOptimizer.cpp; algorithm re-designed as Forsyth
    linear-speed scoring)."""

    def __init__(self, cache_size: int = 16):
        self.cache_size = int(cache_size)

    def Optimize(self, faces, n_vertices: int | None = None) -> np.ndarray:
        """Returns the optimized face ORDER (indices into faces)."""
        f = np.ascontiguousarray(np.asarray(faces, np.uint32))
        n = f.shape[0]
        if n == 0:
            return np.zeros(0, np.uint32)
        # The native optimizer indexes per-vertex tables by face indices;
        # nv must cover the max referenced index even when the caller's
        # vertex count is stale (e.g. a mesh resized under existing faces).
        nv = int(n_vertices if n_vertices is not None else 0)
        nv = max(nv, int(f.max()) + 1)
        order = np.zeros(n, np.uint32)
        lib = native.load()
        if lib is not None:
            lib.ck_vertex_cache_optimize(_u32p(f), n, nv, self.cache_size,
                                         _u32p(order))
            return order
        # Fallback: greedy tip-in-cache ordering.
        cache = VertexCache(self.cache_size)
        remaining = set(range(n))
        out = []
        while remaining:
            best, best_score = None, -1
            for fi in remaining:
                score = sum(cache.InCache(int(v)) for v in f[fi])
                if score > best_score:
                    best, best_score = fi, score
                    if score == 3:
                        break
            out.append(best)
            remaining.remove(best)
            for v in f[best]:
                cache.AddEntry(int(v))
        return np.asarray(out, np.uint32)
