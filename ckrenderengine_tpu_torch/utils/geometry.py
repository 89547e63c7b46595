"""Host mesh tooling: the radix sorter (reference include/RadixSort.h),
edge adjacency (src/MeshAdjacency.cpp), the greedy stripifier the scene
compile uses to order each material group's faces (objects/mesh.py
``_optimize_group_order``; reference src/MeshStriper.cpp), the
multi-sample stripifier (src/NvStripifier.cpp), the vertex-cache simulator
and optimizer (include/VertexCache.h, src/VertexCacheOptimizer.cpp,
re-designed as Forsyth linear-speed scoring), the nearest-point hash grid
(src/NearestPointGrid.cpp) and the best-fit box between two point sets
(src/PlaceFitter.cpp).

Hot paths dispatch to the native C++ library (native/ckcore.cpp via ctypes);
every method has a numpy fallback. These stay host tools: nothing here runs
on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

BOUNDARY = 0xFFFFFFFF


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RadixSorter:
    """4-pass byte-histogram radix sort returning sorted indices
    (reference include/RadixSort.h)."""

    def __init__(self):
        self._indices = np.zeros(0, np.uint32)

    def Sort(self, values) -> "RadixSorter":
        v = np.ascontiguousarray(values)
        n = v.shape[0]
        out = np.zeros(n, np.uint32)
        if n == 0:
            self._indices = out
            return self
        lib = native.load()
        if lib is not None and v.dtype in (np.uint32, np.float32):
            if v.dtype == np.uint32:
                lib.ck_radix_sort_u32(_u32p(v), n, _u32p(out))
            else:
                lib.ck_radix_sort_f32(_f32p(v), n, _u32p(out))
        else:
            out = np.argsort(v, kind="stable").astype(np.uint32)
        self._indices = out
        return self

    def GetIndices(self) -> np.ndarray:
        return self._indices


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

    def GetAdjacency(self) -> np.ndarray:
        return self.adj

    def IsBoundary(self, face: int, edge: int) -> bool:
        return self.adj[face, edge] == BOUNDARY

    def BoundaryEdgeCount(self) -> int:
        return int((self.adj == BOUNDARY).sum())


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
    """Strip builder (reference include/MeshStriper.h: strip tracking from
    seed edges, radix-sorted seeds by face degree)."""

    def __init__(self):
        self.strips: list[np.ndarray] = []

    def Compute(self, faces) -> bool:
        self.strips = _stripify(faces)
        return True

    def GetStripCount(self) -> int:
        return len(self.strips)

    def GetStrip(self, i: int) -> np.ndarray:
        return self.strips[i]

    def ConnectAll(self) -> np.ndarray:
        """Single strip with degenerate bridges (reference connect-all)."""
        if not self.strips:
            return np.zeros(0, np.uint32)
        out = list(self.strips[0])
        for s in self.strips[1:]:
            s = list(s)
            if len(out) % 2 == 1:
                out.append(out[-1])      # parity fix degenerate
            out += [out[-1], s[0]] + s
        return np.asarray(out, np.uint32)


def _nvstripify(faces: np.ndarray, samples: int):
    """Multi-sample bidirectional stripifier (native ck_nvstripify or the
    byte-identical python fallback).

    Per round: sample up to ``samples`` unused seed faces (boundary-first
    order), grow a candidate strip in BOTH directions from each of the
    seed's 3 edge orientations, and commit only the longest candidate.
    Distinct from the greedy one-pass walker in _stripify, mirroring the
    reference's two algorithms (src/MeshStriper.cpp vs src/NvStripifier.cpp
    — structure studied, independently implemented)."""
    f = np.ascontiguousarray(np.asarray(faces, np.uint32))
    n = f.shape[0]
    if n == 0:
        return []
    samples = max(1, int(samples))
    lib = native.load()
    if lib is not None and hasattr(lib, "ck_nvstripify"):
        out = np.zeros(4 * n + 16, np.uint32)
        lens = np.zeros(n, np.uint32)
        nstrips = ctypes.c_uint32(0)
        lib.ck_nvstripify(_u32p(f), n, samples, _u32p(out), _u32p(lens),
                          ctypes.byref(nstrips))
        strips, off = [], 0
        for i in range(nstrips.value):
            ln = int(lens[i])
            strips.append(out[off:off + ln].copy())
            off += ln
        return strips

    adj = MeshAdjacency(f).adj
    degree = (adj != BOUNDARY).sum(axis=1)
    seeds = np.argsort(degree, kind="stable")
    used = np.zeros(n, bool)
    mark = np.zeros(n, np.int64)
    epoch = 0

    def third(tri, a, b):
        for v in tri:
            if v != a and v != b:
                return int(v)
        return int(tri[0])

    def grow(cur, ea, eb, ep):
        verts = []
        while True:
            nxt = None
            for k in range(3):
                nb = int(adj[cur, k])
                if nb != BOUNDARY and not used[nb] and mark[nb] != ep:
                    tri2 = f[nb]
                    if ea in tri2 and eb in tri2:
                        nxt = nb
                        break
            if nxt is None:
                return verts
            nv = third(f[nxt], ea, eb)
            verts.append(nv)
            mark[nxt] = ep
            cur, ea, eb = nxt, eb, nv

    strips = []
    scan = 0
    remaining = n
    while remaining > 0:
        while scan < n and used[seeds[scan]]:
            scan += 1
        best = None          # (faces, seed, rot) — first best wins
        found = 0
        for s in range(scan, n):
            fi = int(seeds[s])
            if used[fi]:
                continue
            found += 1
            for rot in range(3):
                v0 = int(f[fi, rot])
                v1 = int(f[fi, (rot + 1) % 3])
                v2 = int(f[fi, (rot + 2) % 3])
                epoch += 1
                mark[fi] = epoch
                fw = grow(fi, v1, v2, epoch)
                bk = grow(fi, v1, v0, epoch)
                total = 1 + len(fw) + len(bk)
                if best is None or total > best[0]:
                    best = (total, fi, rot)
            if found >= samples:
                break
        fi, rot = best[1], best[2]
        v0 = int(f[fi, rot])
        v1 = int(f[fi, (rot + 1) % 3])
        v2 = int(f[fi, (rot + 2) % 3])
        epoch += 1
        mark[fi] = epoch
        fw = grow(fi, v1, v2, epoch)
        bk = grow(fi, v1, v0, epoch)
        used[mark == epoch] = True
        remaining -= 1 + len(fw) + len(bk)
        strip = ([bk[-1]] if len(bk) % 2 == 1 else []) \
            + bk[::-1] + [v0, v1, v2] + fw
        strips.append(np.asarray(strip, np.uint32))
    return strips


class NvStripifier:
    """NVIDIA-style stripifier (reference src/NvStripifier.cpp): per round,
    sample several seed faces, grow candidate strips bidirectionally from
    every seed edge orientation, commit the longest — a genuinely different
    algorithm from MeshStriper's greedy walker (typically fewer, longer
    strips); cache-aware splitting via ``MaxStripLength``."""

    def __init__(self, cache_size: int = 16, max_strip_length: int = 0,
                 experiments: int = 10):
        self.cache_size = cache_size
        self.max_strip_length = max_strip_length
        self.experiments = max(1, int(experiments))

    def Stripify(self, faces) -> list[np.ndarray]:
        strips = _nvstripify(faces, self.experiments)
        if self.max_strip_length and self.max_strip_length >= 3:
            split = []
            for s in strips:
                while len(s) > self.max_strip_length:
                    split.append(s[: self.max_strip_length])
                    s = s[self.max_strip_length - 2:]
                split.append(s)
            strips = split
        return strips

    def CreateStrips(self, faces) -> np.ndarray:
        ms = MeshStriper()
        ms.strips = self.Stripify(faces)
        return ms.ConnectAll()


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

    def Clear(self):
        self.entries = []

    @staticmethod
    def MissCount(indices, size: int = 16) -> int:
        idx = np.ascontiguousarray(np.asarray(indices, np.uint32)).reshape(-1)
        lib = native.load()
        if lib is not None:
            return int(lib.ck_cache_misses(_u32p(idx), idx.shape[0], size))
        c = VertexCache(size)
        return sum(c.AddEntry(int(v)) for v in idx)


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

    def OptimizeFaces(self, faces, n_vertices: int | None = None) -> np.ndarray:
        """Returns the reordered faces themselves."""
        f = np.asarray(faces, np.uint32)
        return f[self.Optimize(f, n_vertices)]


class NearestPointGrid:
    """Uniform hash grid for nearest-point-within-threshold queries
    (reference include/NearestPointGrid.h:12-53)."""

    def __init__(self, points, cell_size: float = 1.0):
        self.points = np.ascontiguousarray(np.asarray(points, np.float32))
        self.cell = float(cell_size)
        self._handle = None
        lib = native.load()
        if lib is not None and self.points.shape[0]:
            self._handle = lib.ck_npgrid_build(
                _f32p(self.points), self.points.shape[0], self.cell)

    def GetNearestPoint(self, query, threshold: float) -> int | None:
        q = np.asarray(query, np.float32)
        if self.points.shape[0] == 0:
            return None
        lib = native.load()
        if self._handle is not None and lib is not None:
            r = lib.ck_npgrid_nearest(self._handle, float(q[0]), float(q[1]),
                                      float(q[2]), float(threshold))
            return None if r == BOUNDARY else int(r)
        d = np.linalg.norm(self.points - q, axis=1)
        i = int(np.argmin(d))
        return i if d[i] <= threshold else None

    def __del__(self):
        lib = native.load()
        if getattr(self, "_handle", None) is not None and lib is not None:
            lib.ck_npgrid_free(self._handle)
            self._handle = None


class PlaceFitter:
    """Best-fit oriented box between two point sets from their common
    vertices (reference src/PlaceFitter.cpp ComputeBestFitBBox)."""

    @staticmethod
    def ComputeBestFitBBox(points_a, points_b, threshold: float = 1e-3):
        """Common points (within threshold) -> (center, axes (3,3),
        half_extents) of the PCA-fit box, or None when no overlap."""
        a = np.asarray(points_a, np.float32)
        b = np.asarray(points_b, np.float32)
        if a.shape[0] == 0 or b.shape[0] == 0:
            return None
        grid = NearestPointGrid(b, cell_size=max(threshold * 4, 1e-3))
        common = [p for p in a
                  if grid.GetNearestPoint(p, threshold) is not None]
        if len(common) < 3:
            return None
        pts = np.asarray(common, np.float32)
        center = pts.mean(axis=0)
        d = pts - center
        cov = d.T @ d / len(pts)
        _, vecs = np.linalg.eigh(cov)
        axes = vecs.T[::-1]                  # principal first
        proj = d @ axes.T
        half = np.abs(proj).max(axis=0)
        return center, axes.astype(np.float32), half.astype(np.float32)
