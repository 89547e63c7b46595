"""CKSkin host object: bones, per-vertex weights, device-bank descriptor.

API mirror of RCKSkin / RCKSkinBoneData (reference src/CKSkin.cpp,
include/RCKSkin.h). The reference's per-bone gather lists
(BuildBonePointLists, src/CKSkin.cpp:419+) and bone-major CalcPointsEx
scatter (:183-331) are replaced by the vertex-major device stage in
pipeline/skinning.py; this class keeps the same construction API and
provides a numpy `CalcPoints` for host-side queries/tests.

Bone transform semantics (src/CKSkin.cpp:153-181,266-271): in row-vector
convention a rest vertex maps through

    object_init @ bone_initial_inverse @ bone_world @ object_inv_world
"""

from __future__ import annotations

import numpy as np


class CKSkinBoneData:
    """(reference RCKSkinBoneData)"""

    def __init__(self):
        self.entity = None               # the bone's CK3dEntity
        self.initial_inverse = np.eye(4, dtype=np.float32)

    def SetBone(self, ent):
        self.entity = ent

    def GetBone(self):
        return self.entity

    def SetBoneInitialInverseMatrix(self, m):
        self.initial_inverse = np.asarray(m, np.float32)

    def GetBoneInitialInverseMatrix(self):
        return self.initial_inverse.copy()

    # reference RCKSkinBoneData accessor aliases
    def GetInitialInverseMatrix(self):
        return self.GetBoneInitialInverseMatrix()

    def GetTransformMatrix(self, skin) -> np.ndarray:
        """The bone's full skinning transform for ``skin``:
        object_init @ initial_inverse @ bone_world @ inv(owner_world)
        (reference ConstructBoneTransfoMatrices per-bone product,
        src/CKSkin.cpp:153-181,266-271)."""
        obj_inv = np.linalg.inv(skin.owner.GetWorldMatrix())
        bw = (self.entity.GetWorldMatrix() if self.entity is not None
              else np.eye(4, dtype=np.float32))
        return (skin.object_init @ self.initial_inverse @ bw
                @ obj_inv).astype(np.float32)


class CKSkin:
    """Skin attached to a CK3dEntity (ent.CreateSkin())."""

    MAX_BONES_PER_VERTEX = 4

    def __init__(self, owner):
        self.owner = owner               # the skinned CK3dEntity
        self.bones: list[CKSkinBoneData] = []
        self.object_init = np.eye(4, dtype=np.float32)
        self.vertex_count = 0
        self.rest_pos = np.zeros((0, 3), np.float32)
        self.rest_nrm = np.zeros((0, 3), np.float32)
        # Ragged host-side weights, normalized lazily.
        self._vbones: list[list[int]] = []
        self._vweights: list[list[float]] = []

    # -- construction (RCKSkin API) ----------------------------------------
    def SetBoneCount(self, n: int):
        while len(self.bones) < n:
            self.bones.append(CKSkinBoneData())
        del self.bones[n:]

    def GetBoneCount(self) -> int:
        return len(self.bones)

    def GetBoneData(self, i: int) -> CKSkinBoneData:
        return self.bones[i]

    def SetObjectInitMatrix(self, m):
        self.object_init = np.asarray(m, np.float32)

    def SetVertexCount(self, n: int):
        self.vertex_count = int(n)
        self.rest_pos = np.zeros((n, 3), np.float32)
        self.rest_nrm = np.zeros((n, 3), np.float32)
        self._vbones = [[] for _ in range(n)]
        self._vweights = [[] for _ in range(n)]

    def GetVertexCount(self) -> int:
        return self.vertex_count

    def SetVertexInitialPos(self, i: int, pos):
        self.rest_pos[i] = pos

    def SetVertexInitialNormal(self, i: int, n):
        self.rest_nrm[i] = n

    def SetRestPose(self, positions, normals=None):
        positions = np.asarray(positions, np.float32)
        self.SetVertexCount(positions.shape[0])
        self.rest_pos = positions.copy()
        if normals is not None:
            self.rest_nrm = np.asarray(normals, np.float32).copy()

    def SetVertexBone(self, vertex: int, bone: int, weight: float):
        self._vbones[vertex].append(int(bone))
        self._vweights[vertex].append(float(weight))

    def SetVertexWeights(self, vertex: int, bones, weights):
        self._vbones[vertex] = [int(b) for b in bones]
        self._vweights[vertex] = [float(w) for w in weights]

    def GetVertexWeights(self, vertex: int):
        return list(self._vbones[vertex]), list(self._vweights[vertex])

    # -- API-surface parity batch (reference include/RCKSkin.h) ------------
    def GetObjectInitMatrix(self):
        return self.object_init.copy()

    def GetInitialPos(self, i: int):
        return self.rest_pos[i].copy()

    def SetInitialPos(self, i: int, pos):
        self.SetVertexInitialPos(i, pos)

    def GetNormalCount(self) -> int:
        return int(self.rest_nrm.shape[0])

    def SetNormalCount(self, n: int):
        """Resize the rest-normal array independently of positions
        (reference SetNormalCount)."""
        n = int(n)
        old = self.rest_nrm
        self.rest_nrm = np.zeros((n, 3), np.float32)
        self.rest_nrm[:min(n, old.shape[0])] = old[:min(n, old.shape[0])]

    def GetNormal(self, i: int):
        return self.rest_nrm[i].copy()

    def SetNormal(self, i: int, n):
        self.rest_nrm[i] = n

    def GetWeight(self, vertex: int, idx: int) -> float:
        return float(self._vweights[vertex][idx])

    def SetWeight(self, vertex: int, idx: int, w: float):
        self._vweights[vertex][idx] = float(w)

    def GetWeightsArray(self) -> np.ndarray:
        """Packed (V,K) normalized weight matrix (reference per-vertex
        weight storage, flattened)."""
        return self.packed_weights()[1]

    def GetBonesArray(self) -> np.ndarray:
        """Packed (V,K) bone-index matrix."""
        return self.packed_weights()[0]

    def GetVertexData(self, vertex: int):
        """(initial_pos, bones, weights) for one vertex (reference
        GetVertexData view into RCKSkinVertexData)."""
        return (self.rest_pos[vertex].copy(), list(self._vbones[vertex]),
                list(self._vweights[vertex]))

    def ConstructBoneTransfoMatrices(self) -> np.ndarray:
        """(B,4,4) full per-bone skinning transforms at the bones' current
        world matrices (reference ConstructBoneTransfoMatrices)."""
        return np.stack([bd.GetTransformMatrix(self) for bd in self.bones]) \
            if self.bones else np.zeros((0, 4, 4), np.float32)

    def BuildBonePointLists(self):
        """Per-bone gather lists (reference RCKSkinBonePoints,
        src/CKSkin.cpp:419+): for each bone, the (vertex_index, weight)
        pairs it influences. The device path uses the vertex-major packed
        arrays instead; this is the bone-major view for API parity."""
        lists = [[] for _ in self.bones]
        for v in range(self.vertex_count):
            for b, w in zip(self._vbones[v], self._vweights[v]):
                if 0 <= b < len(lists):
                    lists[b].append((v, float(w)))
        self._bone_point_lists = lists
        return lists

    def ClearBonePointLists(self):
        self._bone_point_lists = None

    def GetBonePointLists(self):
        lists = getattr(self, "_bone_point_lists", None)
        return lists if lists is not None else self.BuildBonePointLists()

    def CalcPointsEx(self):
        """Skinned positions AND rotated normals (reference CalcPointsEx,
        src/CKSkin.cpp:183-331 — here vectorized vertex-major)."""
        pos = self.CalcPoints()
        bmats = self.ConstructBoneTransfoMatrices()
        bi, w = self.packed_weights()
        acc_n = np.zeros((self.vertex_count, 3), np.float32)
        for j in range(bi.shape[1]):
            r = bmats[bi[:, j]][:, :3, :3]            # rotation part
            nj = np.einsum("vi,vij->vj", self.rest_nrm, r)
            acc_n += nj * w[:, j:j + 1]
        ln = np.linalg.norm(acc_n, axis=-1, keepdims=True)
        acc_n = acc_n / np.maximum(ln, 1e-12)
        return pos, acc_n.astype(np.float32)

    def CalcLocalBBox(self):
        """Mesh-local bbox of the current skinned points (reference
        CalcLocalBBox)."""
        if self.vertex_count == 0:
            return None
        p = self.CalcPoints()
        return p.min(axis=0), p.max(axis=0)

    def RemapVertices(self, remap):
        """Reorder per-vertex skin data by ``remap`` (new_index = position,
        value = old index) — the reference uses this when the progressive
        mesh reorders vertices (src/CKSkin.cpp:345-397)."""
        remap = np.asarray(remap, np.int64)
        self.rest_pos = self.rest_pos[remap].copy()
        self.rest_nrm = self.rest_nrm[remap].copy() \
            if self.rest_nrm.shape[0] == len(remap) else self.rest_nrm
        self._vbones = [self._vbones[i] for i in remap]
        self._vweights = [self._vweights[i] for i in remap]
        self.vertex_count = len(remap)
        self.ClearBonePointLists()

    # -- packed arrays -----------------------------------------------------
    def packed_weights(self, k: int | None = None):
        """(V,K) bone indices + normalized weights (top-K by weight,
        remainder renormalized — the analogue of the reference's weighted-
        mode remainder handling, src/CKSkin.cpp:201-233)."""
        k = k or self.MAX_BONES_PER_VERTEX
        v = self.vertex_count
        import itertools
        counts = np.fromiter((len(b) for b in self._vbones), np.int64,
                             count=v)
        maxc = int(counts.max()) if v else 0
        total = int(counts.sum())
        # Flatten the ragged per-vertex lists at C speed, scatter into a
        # (V, maxc) pad, then top-K select + normalize fully vectorized
        # (runs per skin-bank build; the old per-vertex python loop cost
        # ~100 ms at 60k verts — this is ~8 ms).
        wb = np.zeros((v, max(maxc, 1)), np.float32)
        bb = np.zeros((v, max(maxc, 1)), np.int32)
        if total:
            flat_w = np.fromiter(
                itertools.chain.from_iterable(self._vweights), np.float32,
                count=total)
            flat_b = np.fromiter(
                itertools.chain.from_iterable(self._vbones), np.int32,
                count=total)
            rows_f = np.repeat(np.arange(v), counts)
            offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
            cols_f = np.arange(total) - np.repeat(offs, counts)
            wb[rows_f, cols_f] = flat_w
            bb[rows_f, cols_f] = flat_b
        if maxc > k:
            # top-K by weight per row (argpartition then sort descending)
            part = np.argpartition(-wb, k - 1, axis=1)[:, :k]
        else:
            part = np.broadcast_to(np.arange(max(maxc, 1)), wb.shape)[:, :k]
        wsel = np.take_along_axis(wb, part, 1)[:, :k] if v else wb[:, :k]
        bsel = np.take_along_axis(bb, part, 1)[:, :k] if v else bb[:, :k]
        order = np.argsort(-wsel, axis=1, kind="stable")
        wsel = np.take_along_axis(wsel, order, 1)
        bsel = np.take_along_axis(bsel, order, 1)
        kk = wsel.shape[1]
        bi = np.zeros((v, k), np.int32)
        bw = np.zeros((v, k), np.float32)
        bi[:, :kk] = bsel
        bw[:, :kk] = wsel
        s = bw.sum(1, keepdims=True)
        degenerate = (s[:, 0] <= 1e-12) & (counts > 0)
        bw = np.where(s > 1e-12, bw / np.maximum(s, 1e-12), bw)
        bw[degenerate, 0] = 1.0
        return bi, bw

    def bone_pre_matrices(self) -> np.ndarray:
        """(B,4,4) object_init @ initial_inverse per bone (constant part)."""
        b = len(self.bones)
        pre = np.zeros((b, 4, 4), np.float32)
        for i, bd in enumerate(self.bones):
            pre[i] = self.object_init @ bd.initial_inverse
        return pre

    def bone_rows(self) -> np.ndarray:
        return np.asarray(
            [bd.entity.row if bd.entity is not None else 0 for bd in self.bones],
            np.int32)

    def bank_descriptor(self, pool_offset: int) -> dict:
        """Descriptor consumed by pipeline.skinning.build_skin_bank."""
        bi, bw = self.packed_weights()
        return dict(
            pool_offset=int(pool_offset), rest_pos=self.rest_pos,
            rest_nrm=self.rest_nrm, bone_idx=bi, bone_w=bw,
            bone_rows=self.bone_rows(), obj_row=self.owner.row,
            pre=self.bone_pre_matrices())

    # -- host evaluation (oracle for tests; RCKSkin::CalcPointsEx) ---------
    def CalcPoints(self) -> np.ndarray:
        """Skinned positions in mesh-local space (numpy)."""
        obj_inv = np.linalg.inv(self.owner.GetWorldMatrix())
        bmats = np.zeros((len(self.bones), 4, 4), np.float32)
        for i, bd in enumerate(self.bones):
            bw = (bd.entity.GetWorldMatrix() if bd.entity is not None
                  else np.eye(4, dtype=np.float32))
            bmats[i] = self.object_init @ bd.initial_inverse @ bw @ obj_inv
        bi, w = self.packed_weights()
        p4 = np.concatenate([self.rest_pos,
                             np.ones((self.vertex_count, 1), np.float32)], -1)
        acc = np.zeros((self.vertex_count, 3), np.float32)
        for j in range(bi.shape[1]):
            m = bmats[bi[:, j]]                       # (V,4,4)
            pj = np.einsum("vi,vij->vj", p4, m)[:, :3]
            acc += pj * w[:, j:j + 1]
        return acc

    def UpdateMesh(self):
        """Write skinned points into the owner's mesh (host path — the device
        path goes through the frame program's skin stage)."""
        mesh = self.owner.GetCurrentMesh()
        if mesh is None:
            return
        mesh.SetPositions(self.CalcPoints())

    def CalcBonesBBox(self):
        """World bbox of all bone origins (reference CalcBonesBBox)."""
        pts = np.asarray([bd.entity.GetWorldMatrix()[3, :3]
                          for bd in self.bones if bd.entity is not None],
                         np.float32)
        if pts.size == 0:
            return None
        return pts.min(axis=0), pts.max(axis=0)
