"""Device skinning: batched vertex-major bone blending.

The reference engine deforms skins bone-major: RCKSkin::CalcPointsEx walks
each bone's gather list and scatter-accumulates weighted vec4s into the
mesh's vertex array (src/CKSkin.cpp:183-331). As
``ckrenderengine_tpu.pipeline.skinning`` does, this is the vertex-major
gather instead,

    pos'(v) = sum_k  w_k(v) * (rest(v) @ B[bone_k(v)])

with a fixed per-vertex bone budget K (weights padded with 0): a gather of
the bone matrices and a few elementwise passes, every vertex independent.

Bone matrices follow RCKSkinBoneData (src/CKSkin.cpp:153-181,266-271): in
row-vector convention the chain applied to a rest-pose vertex is

    B = object_init @ bone_initial_inverse @ bone_world @ object_inv_world

where ``object_init @ bone_initial_inverse`` is constant (``pre``, built on
the host) and the two world matrices come from the frame's composed world
matrices. Everything here stays on the device: the object's inverse is
``torch.linalg.inv_ex`` (no ``info`` check, so no host synchronisation),
and the transforms are explicit per-component sums in full f32, which round
the same way on the CPU and the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..raster.deferred import take_small


class SkinBank(NamedTuple):
    """All skins of a scene flattened into one device bank.

    SV = total skinned vertices (padded), B = total bones (padded),
    K = per-vertex bone budget.
    """

    pool_idx: torch.Tensor   # (SV,) int32 vertex-pool rows to overwrite
    rest_pos: torch.Tensor   # (SV,3) rest-pose positions (mesh local)
    rest_nrm: torch.Tensor   # (SV,3) rest-pose normals
    bone_idx: torch.Tensor   # (SV,K) int32 into the bone axis
    bone_w: torch.Tensor     # (SV,K) f32, rows sum to 1 (0-padded)
    valid: torch.Tensor      # (SV,) bool, false for pad rows
    bone_row: torch.Tensor   # (B,) int32 entity-table row of each bone
    obj_row: torch.Tensor    # (B,) int32 entity-table row of the skinned object
    pre: torch.Tensor        # (B,4,4) object_init @ bone_initial_inverse


def bone_matrices(world: torch.Tensor, bank: SkinBank) -> torch.Tensor:
    """(B,4,4) full bone transforms from the composed world matrices."""
    bw = take_small(world, bank.bone_row)                   # (B,4,4)
    ow = take_small(world, bank.obj_row)                    # (B,4,4)
    inv_ow = torch.linalg.inv_ex(ow).inverse
    return torch.matmul(bank.pre, torch.matmul(bw, inv_ow))


def _rows3(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(SV,3) vectors times the 3x3 blocks of (SV,K,4,4) -> (SV,K,3),
    summed in component order."""
    return (v[:, None, 0:1] * m[:, :, 0, :3] + v[:, None, 1:2] * m[:, :, 1, :3]
            + v[:, None, 2:3] * m[:, :, 2, :3])


def apply_skin(world: torch.Tensor, positions: torch.Tensor,
               normals: torch.Tensor, bank: SkinBank,
               ranges: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Skinned positions and normals written into copies of the (V,3) pool
    arrays; the arrays given are not modified (they are the compile's rest
    pool, which every frame starts from).

    ``ranges``: static ((bank_row0, pool_row0, count), ...) when every
    skin's pool rows are contiguous (they are: bank_descriptor maps
    ``pool_offset + arange(v)``). The pool is then rebuilt by one
    concatenation of slices per array. Without ranges the rows go through
    a row copy, with the pad rows sent to a dropped row."""
    if bank.pool_idx.shape[0] == 0:
        return positions, normals
    bmats = bone_matrices(world, bank)                       # (B,4,4)
    sv, k = bank.bone_idx.shape
    vb = take_small(bmats.reshape(-1, 16),
                    bank.bone_idx).reshape(sv, k, 4, 4)
    w = bank.bone_w[..., None]

    # (SV,K,3): the rest point (w = 1) through each bone, then blended.
    pk = _rows3(bank.rest_pos, vb) + vb[:, :, 3, :3]
    pos = torch.sum(pk * w, dim=1)
    # Normals: rotate by the 3x3 part (no translation), renormalize.
    nrm = torch.sum(_rows3(bank.rest_nrm, vb) * w, dim=1)
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                     keepdim=True), min=1e-12)

    if ranges:
        def rebuild(pool, skinned):
            parts, at = [], 0
            for vo, po, v in sorted(ranges, key=lambda r: r[1]):
                parts += [pool[at:po], skinned[vo:vo + v]]
                at = po + v
            parts.append(pool[at:])
            return torch.cat(parts)
        return rebuild(positions, pos), rebuild(normals, nrm)
    n = positions.shape[0]
    idx = torch.where(bank.valid, bank.pool_idx.long(), n)

    def scatter(pool, skinned):
        out = torch.cat([pool, pool[:1]])
        return out.index_copy(0, idx, skinned)[:n]
    return scatter(positions, pos), scatter(normals, nrm)


def build_skin_bank(skins: list, k: int = 4, pad: int = 8,
                    device=None) -> SkinBank | None:
    """Host: flatten per-entity skin descriptors into one bank on
    ``device``.

    ``skins``: list of dicts with keys pool_offset (int), rest_pos (V,3),
    rest_nrm (V,3), bone_idx (V,K') int, bone_w (V,K'), bone_rows (B',),
    obj_row (int), pre (B',4,4). Returns None when empty.
    """
    if not skins:
        return None
    sv = sum(s["rest_pos"].shape[0] for s in skins)
    b = sum(s["bone_rows"].shape[0] for s in skins)
    sv_pad = max(pad, ((sv + pad - 1) // pad) * pad)
    b_pad = max(1, b)

    pool_idx = np.zeros(sv_pad, np.int32)
    rest_pos = np.zeros((sv_pad, 3), np.float32)
    rest_nrm = np.zeros((sv_pad, 3), np.float32)
    bone_idx = np.zeros((sv_pad, k), np.int32)
    bone_w = np.zeros((sv_pad, k), np.float32)
    valid = np.zeros(sv_pad, bool)
    bone_row = np.zeros(b_pad, np.int32)
    obj_row = np.zeros(b_pad, np.int32)
    pre = np.tile(np.eye(4, dtype=np.float32), (b_pad, 1, 1))

    vo = 0
    bo = 0
    for s in skins:
        v = s["rest_pos"].shape[0]
        nb = s["bone_rows"].shape[0]
        kk = min(k, s["bone_idx"].shape[1])
        pool_idx[vo:vo + v] = s["pool_offset"] + np.arange(v)
        rest_pos[vo:vo + v] = s["rest_pos"]
        rest_nrm[vo:vo + v] = s["rest_nrm"]
        bone_idx[vo:vo + v, :kk] = s["bone_idx"][:, :kk] + bo
        w = s["bone_w"][:, :kk].astype(np.float32)
        wsum = w.sum(axis=1, keepdims=True)
        bone_w[vo:vo + v, :kk] = np.where(wsum > 1e-12,
                                          w / np.maximum(wsum, 1e-12), w)
        valid[vo:vo + v] = True
        bone_row[bo:bo + nb] = s["bone_rows"]
        obj_row[bo:bo + nb] = s["obj_row"]
        pre[bo:bo + nb] = s["pre"]
        vo += v
        bo += nb

    def dev(a):
        return torch.as_tensor(a, device=device)

    return SkinBank(
        pool_idx=dev(pool_idx), rest_pos=dev(rest_pos),
        rest_nrm=dev(rest_nrm), bone_idx=dev(bone_idx), bone_w=dev(bone_w),
        valid=dev(valid), bone_row=dev(bone_row), obj_row=dev(obj_row),
        pre=dev(pre))
