"""Bezier patch meshes, tessellated on the host at build time.

API mirror of RCKPatchMesh (include/RCKPatchMesh.h, src/CKPatchMesh.cpp):
corner verts + control vecs, quad/tri bicubic Bezier patches, iteration
count, per-channel UV patches, smooth normals, and BuildRenderMesh. The
reference tessellates on the CPU inside a mesh pre-render callback
(src/CKPatchMesh.cpp:48,73,692); here tessellation is one Bernstein
evaluation over ALL patches at the iteration level, run once per build
(torch on the tensors' device; BuildRenderMesh uses the CPU). The result
is an ordinary mesh: the frame has no patch stage.

Patch control layout (Virtools convention):
- quad patch: 4 corner vert indices + 8 edge vec indices (2 per edge) +
  4 interior vec indices -> a 4x4 Bezier control grid.
- tri patch: 3 corner verts + 6 edge vecs + 1 interior -> 10 control points
  of a cubic Bezier triangle.

The two evaluations sum their products in a fixed order (pairwise for the
quad grid's 4 terms; one fused multiply-add chain for the triangle's 10),
so the tessellated positions are the same floats on every device.
Shared-edge welding rounds positions to 1/4096, and a last-bit difference
there could change which vertex a face points at.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import CKCID_PATCHMESH, CKContext
from .mesh import CKMesh


def _bernstein_matrix(n_samples: int) -> np.ndarray:
    """(n_samples, 4) cubic Bernstein basis evaluated on [0,1]."""
    t = np.linspace(0.0, 1.0, n_samples, dtype=np.float32)[:, None]
    return np.concatenate([
        (1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t ** 3,
    ], axis=1)


def _sum4(p: list) -> torch.Tensor:
    """Four f32 terms summed pairwise: (p0 + p1) + (p2 + p3)."""
    return (p[0] + p[1]) + (p[2] + p[3])


def eval_quad_patches(ctrl: torch.Tensor, level: int) -> torch.Tensor:
    """Tessellate quad patches: ctrl (P,4,4,3) -> (P, L+1, L+1, 3).

    S(u,v) = B(u)^T C B(v) per component: the u contraction, then the v
    contraction."""
    basis = torch.as_tensor(_bernstein_matrix(level + 1), device=ctrl.device)
    a = _sum4([basis[None, :, i, None, None] * ctrl[:, None, i]
               for i in range(4)])                               # (P,n,4,3)
    return _sum4([basis[None, None, :, j, None] * a[:, :, None, j]
                  for j in range(4)])                            # (P,n,n,3)


def _tri_bernstein(level: int) -> tuple[np.ndarray, np.ndarray]:
    """Barycentric sample grid + degree-3 Bezier-triangle basis.

    Returns (bary (M,3), basis (M,10)) where the 10 control points are
    ordered [300,030,003, 210,120, 021,012, 102,201, 111].
    """
    pts = []
    for i in range(level + 1):
        for j in range(level + 1 - i):
            u = i / level
            v = j / level
            pts.append((u, v, 1.0 - u - v))
    bary = np.asarray(pts, np.float32)
    u, v, w = bary[:, 0], bary[:, 1], bary[:, 2]
    basis = np.stack([
        u ** 3, v ** 3, w ** 3,
        3 * u * u * v, 3 * u * v * v,
        3 * v * v * w, 3 * v * w * w,
        3 * w * w * u, 3 * w * u * u,
        6 * u * v * w,
    ], axis=1).astype(np.float32)
    return bary, basis


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add does.

    The product of two f32 values is exact in f64; the f64 sum is rounded
    once more, which only matters where it lands exactly halfway between
    two f32 values: there the sum's rounding error (TwoSum) picks the
    side."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    below = r.double() <= s
    lo = torch.where(below, r, torch.nextafter(r, torch.full_like(r, -np.inf)))
    hi = torch.nextafter(lo, torch.full_like(lo, np.inf))
    tie = (lo.double() + hi.double()) * 0.5 == s
    return torch.where(tie & (err > 0), hi,
                       torch.where(tie & (err < 0), lo, r))


def eval_tri_patches(ctrl: torch.Tensor, level: int) -> torch.Tensor:
    """Tessellate tri patches: ctrl (P,10,3) -> (P, M, 3)."""
    _, basis = _tri_bernstein(level)
    basis = torch.as_tensor(basis, device=ctrl.device)
    out = torch.zeros((ctrl.shape[0], basis.shape[0], 3), dtype=ctrl.dtype,
                      device=ctrl.device)
    for k in range(10):
        b = basis[None, :, k, None].expand_as(out)
        out = _fma32(b, ctrl[:, None, k].expand_as(out), out)
    return out


def quad_grid_faces(level: int, flip: bool = False) -> np.ndarray:
    """Triangulation of an (L+1)x(L+1) grid (row-major indices)."""
    n = level + 1
    faces = []
    for r in range(level):
        for c in range(level):
            a = r * n + c
            b = a + 1
            d = a + n
            e = d + 1
            if flip:
                faces += [[a, b, e], [a, e, d]]
            else:
                faces += [[a, e, b], [a, d, e]]
    return np.asarray(faces, np.int32)


def tri_grid_faces(level: int) -> np.ndarray:
    """Triangulation of the barycentric sample grid of _tri_bernstein."""
    # row i has (level+1-i) points; row starts:
    starts = np.cumsum([0] + [level + 1 - i for i in range(level)])
    faces = []
    for i in range(level):
        for j in range(level - i):
            a = starts[i] + j
            b = a + 1
            c = starts[i + 1] + j
            faces.append([a, b, c])
            if j < level - i - 1:
                d = starts[i + 1] + j + 1
                faces.append([b, d, c])
    return np.asarray(faces, np.int32)


class CKPatch:
    """One quad or tri patch (reference CKPatch): corner vert indices, edge
    vec indices (2 per edge, outgoing order), interior vec indices."""

    def __init__(self, corners, edge_vecs, interiors):
        self.corners = list(corners)          # 4 (quad) or 3 (tri)
        self.edge_vecs = list(edge_vecs)      # 8 (quad) or 6 (tri)
        self.interiors = list(interiors)      # 4 (quad) or 1 (tri)
        self.smoothing = 0xFFFFFFFF
        self.material = None

    @property
    def is_quad(self) -> bool:
        return len(self.corners) == 4


class CKTVPatch:
    """Per-channel UV patch: uv indices for the patch corners
    (reference CKTVPatch)."""

    def __init__(self, uv_indices):
        self.uv_indices = list(uv_indices)


class CKPatchMesh(CKMesh):
    """Mesh whose geometry is generated from Bezier patches
    (reference RCKPatchMesh). ``BuildRenderMesh`` tessellates at the current
    iteration count into the base-class vertex/face arrays."""

    CLASS_ID = CKCID_PATCHMESH

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.verts = np.zeros((0, 3), np.float32)     # patch corner points
        self.vecs = np.zeros((0, 3), np.float32)      # control vectors
        self.patches: list[CKPatch] = []
        self.tv_patches: dict[int, list[CKTVPatch]] = {}
        self.patch_uvs = np.zeros((0, 2), np.float32)
        self.iteration_count = 4
        self._hard_edges: set = set()
        self._tess_dirty = True

    # -- control data (RCKPatchMesh API) -----------------------------------
    def SetVertCount(self, n: int):
        self.verts = np.resize(self.verts, (n, 3)).astype(np.float32)
        self._tess_dirty = True

    def GetVertCount(self) -> int:
        return int(self.verts.shape[0])

    def SetVert(self, i: int, pos):
        self.verts[i] = pos
        self._tess_dirty = True

    def GetVert(self, i: int):
        return self.verts[i].copy()

    def SetVecCount(self, n: int):
        self.vecs = np.resize(self.vecs, (n, 3)).astype(np.float32)
        self._tess_dirty = True

    def GetVecCount(self) -> int:
        return int(self.vecs.shape[0])

    def SetVec(self, i: int, pos):
        self.vecs[i] = pos
        self._tess_dirty = True

    def GetVec(self, i: int):
        return self.vecs[i].copy()

    def SetVerts(self, verts):
        self.verts = np.asarray(verts, np.float32).reshape(-1, 3)
        self._tess_dirty = True

    def SetVecs(self, vecs):
        self.vecs = np.asarray(vecs, np.float32).reshape(-1, 3)
        self._tess_dirty = True

    def AddPatch(self, patch: CKPatch) -> int:
        self.patches.append(patch)
        self._tess_dirty = True
        return len(self.patches) - 1

    def GetPatchCount(self) -> int:
        return len(self.patches)

    def GetPatch(self, i: int) -> CKPatch:
        return self.patches[i]

    def SetPatchMaterial(self, i: int, material):
        self.patches[i].material = material
        self._tess_dirty = True

    def GetPatchMaterial(self, i: int):
        return self.patches[i].material

    def SetIterationCount(self, n: int):
        self.iteration_count = max(1, int(n))
        self._tess_dirty = True

    def GetIterationCount(self) -> int:
        return self.iteration_count

    def SetTVPatch(self, channel: int, i: int, tv: CKTVPatch):
        lst = self.tv_patches.setdefault(channel, [])
        while len(lst) <= i:
            lst.append(None)
        lst[i] = tv
        self._tess_dirty = True

    def SetPatchUVs(self, uvs):
        self.patch_uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        self._tess_dirty = True

    # -- control-grid assembly ---------------------------------------------
    def _quad_control_grid(self, p: CKPatch) -> np.ndarray:
        """4x4 Bezier control grid from corners/edge vecs/interiors.

        Grid[u][v]: u along edge c0->c1, v along edge c0->c3.
        Edge vec order per edge k (c_k -> c_{k+1}): two points outward.
        """
        c = self.verts[p.corners]                     # (4,3)
        e = self.vecs[p.edge_vecs]                    # (8,3)
        it = self.vecs[p.interiors]                   # (4,3)
        g = np.zeros((4, 4, 3), np.float32)
        g[0, 0], g[3, 0], g[3, 3], g[0, 3] = c[0], c[1], c[2], c[3]
        # edge 0: c0->c1 (u axis, v=0)
        g[1, 0], g[2, 0] = e[0], e[1]
        # edge 1: c1->c2 (v axis at u=3)
        g[3, 1], g[3, 2] = e[2], e[3]
        # edge 2: c2->c3 (reverse u at v=3)
        g[2, 3], g[1, 3] = e[4], e[5]
        # edge 3: c3->c0 (reverse v at u=0)
        g[0, 2], g[0, 1] = e[6], e[7]
        g[1, 1], g[2, 1], g[2, 2], g[1, 2] = it[0], it[1], it[2], it[3]
        return g

    def _tri_control(self, p: CKPatch) -> np.ndarray:
        """10 control points [300,030,003, 210,120, 021,012, 102,201, 111]."""
        c = self.verts[p.corners]
        e = self.vecs[p.edge_vecs]
        i = self.vecs[p.interiors]
        return np.concatenate([c, e, i[:1]], axis=0).astype(np.float32)

    # -- evaluation ---------------------------------------------------------
    def EvaluateQuadPatch(self, i: int, u: float, v: float) -> np.ndarray:
        """Point on quad patch i at (u,v) (reference EvaluateQuadPatch)."""
        g = self._quad_control_grid(self.patches[i])

        def bern(t):
            return np.array([(1 - t) ** 3, 3 * t * (1 - t) ** 2,
                             3 * t * t * (1 - t), t ** 3], np.float32)

        return bern(u) @ np.einsum("j,ijc->ic", bern(v), g)

    def EvaluateTriPatch(self, i: int, u: float, v: float) -> np.ndarray:
        ctrl = self._tri_control(self.patches[i])[None]
        w = 1.0 - u - v
        uu, vv, ww = u, v, w
        basis = np.array([
            uu ** 3, vv ** 3, ww ** 3, 3 * uu * uu * vv, 3 * uu * vv * vv,
            3 * vv * vv * ww, 3 * vv * ww * ww, 3 * ww * ww * uu,
            3 * ww * uu * uu, 6 * uu * vv * ww], np.float32)
        return basis @ ctrl[0]

    # -- tessellation -------------------------------------------------------
    def BuildRenderMesh(self):
        """Tessellate all patches into the mesh vertex/face arrays
        (the reference hooks this as a pre-render callback)."""
        if not self._tess_dirty:
            return
        level = self.iteration_count
        quad_patches = [p for p in self.patches if p.is_quad]
        tri_patches = [p for p in self.patches if not p.is_quad]

        all_pos, all_faces, all_uv = [], [], []
        face_mats = []
        offset = 0
        if quad_patches:
            ctrl = np.stack([self._quad_control_grid(p) for p in quad_patches])
            pts = eval_quad_patches(torch.as_tensor(ctrl), level).numpy()
            n = level + 1
            base_faces = quad_grid_faces(level)
            for pi, p in enumerate(quad_patches):
                grid = pts[pi].reshape(n * n, 3)
                all_pos.append(grid)
                all_faces.append(base_faces + offset)
                face_mats += [p.material] * base_faces.shape[0]
                # corner-bilinear UVs (TV patch or default 0..1)
                uvs = self._patch_corner_uvs(p, 4)
                uu, vv = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                                     indexing="ij")
                uv = (uvs[0][None, None] * (1 - uu)[..., None] * (1 - vv)[..., None]
                      + uvs[1][None, None] * uu[..., None] * (1 - vv)[..., None]
                      + uvs[2][None, None] * uu[..., None] * vv[..., None]
                      + uvs[3][None, None] * (1 - uu)[..., None] * vv[..., None])
                all_uv.append(uv.reshape(n * n, 2))
                offset += n * n
        if tri_patches:
            ctrl = np.stack([self._tri_control(p) for p in tri_patches])
            pts = eval_tri_patches(torch.as_tensor(ctrl), level).numpy()
            bary, _ = _tri_bernstein(level)
            base_faces = tri_grid_faces(level)
            m = bary.shape[0]
            for pi, p in enumerate(tri_patches):
                all_pos.append(pts[pi])
                all_faces.append(base_faces + offset)
                face_mats += [p.material] * base_faces.shape[0]
                uvs = self._patch_corner_uvs(p, 3)
                uv = (bary[:, 0:1] * uvs[0] + bary[:, 1:2] * uvs[1]
                      + bary[:, 2:3] * uvs[2])
                all_uv.append(uv)
                offset += m

        if not all_pos:
            self._tess_dirty = False
            return
        self.SetPositions(np.concatenate(all_pos))
        self.SetUVs(np.concatenate(all_uv))
        faces = np.concatenate(all_faces)
        self.SetFaces(faces)
        for fi, mat in enumerate(face_mats):
            if mat is not None:
                self.SetFaceMaterial(fi, mat)
        self._weld_shared_edges()
        self.BuildNormals()
        self._tess_dirty = False
        self._dirty()

    def _patch_corner_uvs(self, p: CKPatch, n: int) -> np.ndarray:
        tvs = self.tv_patches.get(0)
        if tvs is not None:
            idx = self.patches.index(p)
            if idx < len(tvs) and tvs[idx] is not None and len(self.patch_uvs):
                return self.patch_uvs[tvs[idx].uv_indices[:n]]
        if n == 4:
            return np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        return np.array([[0, 0], [1, 0], [0, 1]], np.float32)

    def _weld_shared_edges(self):
        """Weld coincident tessellated vertices so shared patch edges get
        averaged (smooth) normals (reference shared-edge vertex welding)."""
        pos = self.positions
        # quantize to merge exact duplicates (patches sharing corner verts
        # evaluate to bit-identical edge rows)
        key = np.round(pos * 4096.0).astype(np.int64)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        # Remap every vertex to the first occurrence of its quantized position
        # (positions stay un-compacted; duplicates become unreferenced).
        remap = first[inverse.reshape(-1)].astype(np.int32)
        # Hard edges stay un-welded: their tessellated edge vertices keep
        # their own identity, so the two sides get separate (hard) normals
        # (reference CKPatchEdge hard flag / smooth-vs-hard edge normals).
        for key in self._hard_edges:
            a, b = tuple(key)
            for pi, e in self._patches_sharing_edge(a, b):
                for vi in self._edge_vertex_indices(pi, e):
                    if vi >= 0:
                        remap[vi] = vi
        self._weld_map = remap
        self.faces = remap[np.asarray(self.faces)]

    def _edge_vertex_indices(self, patch_index: int, local_edge: int) -> list:
        """Tessellated render-mesh vertex indices along one patch edge."""
        level = self.iteration_count
        n = level + 1
        p = self.patches[patch_index]
        if p.is_quad:
            coords = {0: [(i, 0) for i in range(n)],
                      1: [(n - 1, j) for j in range(n)],
                      2: [(i, n - 1) for i in range(n)],
                      3: [(0, j) for j in range(n)]}[local_edge]
            return [self.ComputeQuadVertexIndex(patch_index, i, j)
                    for i, j in coords]
        coords = {0: [(0, c) for c in range(level + 1)],
                  1: [(r, level - r) for r in range(level + 1)],
                  2: [(r, 0) for r in range(level + 1)]}[local_edge]
        return [self.ComputeTriVertexIndex(patch_index, r, c)
                for r, c in coords]

    # -- index helpers (reference include/RCKPatchMesh.h:79-88; the
    # reference's helpers address its edge-shared tessellation tables —
    # here they address this class's per-patch grid layout: quad patches
    # first, each (n+1)^2 row-major, then tri patches, each (n+1)(n+2)/2
    # in barycentric-row order) -------------------------------------------
    def _patch_vertex_base(self, patch_index: int) -> int:
        level = self.iteration_count
        n = level + 1
        quad_count = n * n
        tri_count = (level + 1) * (level + 2) // 2
        quads = [i for i, p in enumerate(self.patches) if p.is_quad]
        tris = [i for i, p in enumerate(self.patches) if not p.is_quad]
        if patch_index in quads:
            return quads.index(patch_index) * quad_count
        return (len(quads) * quad_count
                + tris.index(patch_index) * tri_count)

    def ComputeQuadVertexIndex(self, patch_index: int, i: int,
                               j: int) -> int:
        """Render-mesh vertex index of quad-grid coordinate (i, j)
        (reference ComputeQuadVertexIndex)."""
        if (not (0 <= patch_index < len(self.patches))
                or not self.patches[patch_index].is_quad):
            return -1
        n = self.iteration_count + 1
        if not (0 <= i < n and 0 <= j < n):
            return -1
        return self._patch_vertex_base(patch_index) + i * n + j

    def TriInteriorOffset(self, row: int, col: int) -> int:
        """Offset of barycentric grid cell (row, col) within a tri patch
        (reference TriInteriorOffset — row-major over shrinking rows)."""
        level = self.iteration_count
        off = 0
        for r in range(row):
            off += level + 1 - r
        return off + col

    def ComputeTriVertexIndex(self, patch_index: int, row: int,
                              col: int) -> int:
        if (not (0 <= patch_index < len(self.patches))
                or self.patches[patch_index].is_quad):
            return -1
        level = self.iteration_count
        if not (0 <= row <= level and 0 <= col <= level - row):
            return -1
        return (self._patch_vertex_base(patch_index)
                + self.TriInteriorOffset(row, col))

    def EnsureCornerVertexMapAllocated(self, patch_count: int | None = None):
        """Corner -> tessellated-vertex-index map (reference
        EnsureCornerVertexMapAllocated fills m_CornerVertexMap)."""
        self.BuildRenderMesh()
        level = self.iteration_count
        n = level + 1
        cmap = []
        for pi, p in enumerate(self.patches):
            if p.is_quad:
                corners = [self.ComputeQuadVertexIndex(pi, 0, 0),
                           self.ComputeQuadVertexIndex(pi, n - 1, 0),
                           self.ComputeQuadVertexIndex(pi, n - 1, n - 1),
                           self.ComputeQuadVertexIndex(pi, 0, n - 1)]
            else:
                corners = [self.ComputeTriVertexIndex(pi, 0, 0),
                           self.ComputeTriVertexIndex(pi, 0, level),
                           self.ComputeTriVertexIndex(pi, level, 0), -1]
            cmap.append(corners)
        self._corner_vertex_map = cmap
        return cmap

    def GetPatchCornerForVertex(self, patch_index: int,
                                vertex_index: int) -> int:
        """Which patch corner a tessellated vertex is, or -1 (reference
        GetPatchCornerForVertex)."""
        cmap = getattr(self, "_corner_vertex_map", None)
        if cmap is None:
            cmap = self.EnsureCornerVertexMapAllocated()
        if not (0 <= patch_index < len(cmap)):
            return -1
        corners = cmap[patch_index]
        return corners.index(vertex_index) if vertex_index in corners else -1

    # Hard edges: an edge is the unordered pair of patch-corner indices it
    # spans (reference CKPatchEdge hard flag drives split tessellation —
    # here it marks the edge excluded from normal welding).
    def SetEdgeHard(self, corner_a: int, corner_b: int, hard: bool = True):
        key = frozenset((int(corner_a), int(corner_b)))
        (self._hard_edges.add if hard
         else self._hard_edges.discard)(key)
        self._tess_dirty = True

    def IsEdgeHard(self, corner_a: int, corner_b: int) -> bool:
        return frozenset((int(corner_a), int(corner_b))) in self._hard_edges

    def _patches_sharing_edge(self, corner_a: int, corner_b: int) -> list:
        key = {int(corner_a), int(corner_b)}
        out = []
        for pi, p in enumerate(self.patches):
            cs = p.corners
            k = len(cs)
            for e in range(k):
                if {cs[e], cs[(e + 1) % k]} == key:
                    out.append((pi, e))
                    break
        return out

    def DoPatchesShareUVOnEdge(self, corner_a: int, corner_b: int) -> bool:
        """True when the (<=2) patches on this edge carry the same UVs at
        both endpoints (reference DoPatchesShareUVOnEdge — decides whether
        tessellated edge vertices can be shared)."""
        shared = self._patches_sharing_edge(corner_a, corner_b)
        if len(shared) < 2:
            return True
        uvs = []
        for pi, e in shared[:2]:
            p = self.patches[pi]
            k = len(p.corners)
            cu = self._patch_corner_uvs(p, k)
            a_local = p.corners.index(corner_a)
            b_local = p.corners.index(corner_b)
            uvs.append((tuple(cu[a_local]), tuple(cu[b_local])))
        return uvs[0] == uvs[1]

    def GetCornerTextureCoordinate(self, patch_index: int, corner: int,
                                   channel: int = -1):
        """(u, v) at a patch corner (reference GetCornerTextureCoordinate)."""
        if not (0 <= patch_index < len(self.patches)):
            return None
        p = self.patches[patch_index]
        cu = self._patch_corner_uvs(p, len(p.corners))
        if not (0 <= corner < len(p.corners)):
            return None
        return float(cu[corner][0]), float(cu[corner][1])

    def GetTextureChannelPtr(self, channel: int = -1):
        """The live UV array for a channel (reference GetTextureChannelPtr
        returned base+stride; numpy views carry their own stride)."""
        self.BuildRenderMesh()
        return self.GetTextureCoordinatesPtr(channel)

    def WriteTextureCoordinate(self, vertex_index: int, u: float, v: float,
                               channel: int = -1):
        arr = self.GetTextureChannelPtr(channel)
        arr[vertex_index] = (u, v)
        self._dirty_dynamic()

    def LoadVertices(self, chunk) -> bool:
        """Restore control verts/vecs from a statechunk (reference
        RCKPatchMesh::LoadVertices)."""
        from ..io.serialize import ID_PATCHMESH
        if not chunk.SeekIdentifier(ID_PATCHMESH):
            return False
        self.SetVerts(chunk.ReadArray())
        self.SetVecs(chunk.ReadArray())
        self.iteration_count = chunk.ReadInt()
        self._tess_dirty = True
        return True

    def FromMesh(self, mesh: CKMesh):
        """Approximate: adopt the mesh's triangles as flat tri patches
        (reference FromMesh builds patches from a plain mesh)."""
        self.SetVerts(mesh.positions.copy())
        self.patches = []
        vecs = []
        for (a, b, c) in np.asarray(mesh.faces):
            pa, pb, pc = mesh.positions[[a, b, c]]
            base = len(vecs)
            # edge vecs at 1/3, 2/3 along each edge; interior = centroid
            vecs += [pa + (pb - pa) / 3, pa + 2 * (pb - pa) / 3,
                     pb + (pc - pb) / 3, pb + 2 * (pc - pb) / 3,
                     pc + (pa - pc) / 3, pc + 2 * (pa - pc) / 3,
                     (pa + pb + pc) / 3]
            self.patches.append(CKPatch(
                [a, b, c], list(range(base, base + 6)), [base + 6]))
        self.SetVecs(np.asarray(vecs, np.float32))
        self._tess_dirty = True

    # Tessellate lazily whenever render groups are requested (the analogue of
    # the reference's pre-render callback path).
    def GetRenderGroups(self):
        self.BuildRenderMesh()
        return super().GetRenderGroups()
