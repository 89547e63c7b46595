"""Device animation bank: every PRS track of a clip evaluated in one batched
pass.

The reference evaluates controllers per entity per tick on the CPU
(RCKObjectAnimation::SetStep, src/CKObjectAnimation.cpp:1674-1759: evaluate
position, rotation, scale, rebuild the local matrix, then the
LocalMatrixChanged recursion). As in ``ckrenderengine_tpu.anim.bank``, all
tracks of the animated entities are padded into one bank of tensors held on
the render device; one batched evaluation gives every local matrix, and a
gather + select merges them into the entity table's locals, which then feed
``compose_world`` (animate -> compose -> skin -> render, no host round
trip). Only the clip time crosses to the device per frame, as a scalar.

Missing tracks fall back to the entity's base PRS decomposition taken when
the bank is built, mirroring the reference's "decompose to fill missing
parts" (:1716-1752).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math import vxmath as vx
from .keyframe import eval_quat_track, eval_vector_track


class AnimBank(NamedTuple):
    """A = animated entities, K = padded key count; tensors on one device."""

    entity_row: torch.Tensor   # (A,) int32 target entity-table rows
    # position track
    pos_times: torch.Tensor    # (A,K)
    pos_values: torch.Tensor   # (A,K,3)
    pos_tin: torch.Tensor      # (A,K,3)
    pos_tout: torch.Tensor     # (A,K,3)
    pos_mode: torch.Tensor     # (A,) int32
    pos_ease: torch.Tensor     # (A,K,2) per key (ease_to, ease_from)
    pos_n: torch.Tensor        # (A,) int32 (0 = no track)
    # rotation track (slerp or TCB squad)
    rot_times: torch.Tensor    # (A,K)
    rot_quats: torch.Tensor    # (A,K,4) (preflipped for TCB)
    rot_ta: torch.Tensor       # (A,K,4) outgoing squad control quats
    rot_tb: torch.Tensor       # (A,K,4) incoming squad control quats
    rot_mode: torch.Tensor     # (A,) int32
    rot_ease: torch.Tensor     # (A,K,2)
    rot_n: torch.Tensor        # (A,) int32
    # scale track
    scl_times: torch.Tensor
    scl_values: torch.Tensor
    scl_tin: torch.Tensor
    scl_tout: torch.Tensor
    scl_mode: torch.Tensor
    scl_ease: torch.Tensor
    scl_n: torch.Tensor
    # base PRS fallback (decomposed entity local at bank build)
    base_pos: torch.Tensor     # (A,3)
    base_rot: torch.Tensor     # (A,4)
    base_scl: torch.Tensor     # (A,3)
    # Scatter-free application (built when the entity count is known): row
    # i of the entity table takes bank lane inv_row[i] (A = "keep
    # local[i]").
    inv_row: torch.Tensor | None = None   # (N,) int32 in [0, A]
    has_anim: torch.Tensor | None = None  # (N,) bool


def evaluate_bank_prs(bank: AnimBank, t):
    """Every track at time t (a float or a 0-d tensor) -> (pos (A,3),
    rot (A,4), scl (A,3))."""
    a = bank.entity_row.shape[0]
    if isinstance(t, torch.Tensor):
        tt = t.to(torch.float32).expand(a)
    else:
        tt = float(np.float32(t))
    pos = eval_vector_track(
        bank.pos_times, bank.pos_values, bank.pos_tin, bank.pos_tout,
        bank.pos_mode, bank.pos_ease, bank.pos_n, tt)
    rot = eval_quat_track(
        bank.rot_times, bank.rot_quats, bank.rot_ta, bank.rot_tb,
        bank.rot_mode, bank.rot_ease, bank.rot_n, tt)
    scl = eval_vector_track(
        bank.scl_times, bank.scl_values, bank.scl_tin, bank.scl_tout,
        bank.scl_mode, bank.scl_ease, bank.scl_n, tt)
    pos = torch.where((bank.pos_n > 0)[:, None], pos, bank.base_pos)
    rot = torch.where((bank.rot_n > 0)[:, None], rot, bank.base_rot)
    scl = torch.where((bank.scl_n > 0)[:, None], scl, bank.base_scl)
    return pos, rot, scl


def blend_prs(p0, r0, s0, p1, r1, s1, factor):
    """Blend two PRS sets (warper / merged-animation blending, reference
    RCKObjectAnimation merged evaluation and CKCharacter warps)."""
    f = float(np.float32(factor))
    pos = p0 * (1.0 - f) + p1 * f
    scl = s0 * (1.0 - f) + s1 * f
    rot = vx.quat_slerp(r0, r1, f)
    return pos, rot, scl


def prs_to_locals(pos, rot, scl):
    """(A,3), (A,4), (A,3) -> (A,4,4) local matrices."""
    return vx.compose_prs(pos, rot, scl)


def _merge_locals(local: torch.Tensor, bank: AnimBank,
                  mats: torch.Tensor) -> torch.Tensor:
    """Write the bank lanes' matrices into the entity-table rows: a gather
    and a select when the bank knows the entity count (``inv_row``), else a
    row copy that drops out-of-range rows."""
    if bank.inv_row is not None and bank.inv_row.shape[0] == local.shape[0]:
        eye = torch.eye(4, dtype=mats.dtype, device=mats.device)
        picked = torch.cat([mats, eye[None]]).index_select(
            0, bank.inv_row.long())
        return torch.where(bank.has_anim[:, None, None], picked, local)
    n = local.shape[0]
    rows = bank.entity_row.long()
    rows = torch.where((rows >= 0) & (rows < n), rows, n)
    out = torch.cat([local, local[:1]])
    return out.index_copy(0, rows, mats)[:n]


def apply_bank(local: torch.Tensor, bank: AnimBank, t) -> torch.Tensor:
    """Evaluate at time t and merge the (A,4,4) locals into (N,4,4)."""
    pos, rot, scl = evaluate_bank_prs(bank, t)
    return _merge_locals(local, bank, prs_to_locals(pos, rot, scl))


def apply_bank_blended(local: torch.Tensor, bank_a: AnimBank, t_a,
                       bank_b: AnimBank, t_b, factor) -> torch.Tensor:
    """Two-animation blend (transition warp): both banks target the same
    entity_row layout (built from the same character)."""
    p0, r0, s0 = evaluate_bank_prs(bank_a, t_a)
    p1, r1, s1 = evaluate_bank_prs(bank_b, t_b)
    pos, rot, scl = blend_prs(p0, r0, s0, p1, r1, s1, factor)
    return _merge_locals(local, bank_a, prs_to_locals(pos, rot, scl))


def build_anim_bank(object_anims: list, entity_rows: list[int],
                    pad_keys: int | None = None,
                    n_entities: int | None = None,
                    device=None) -> AnimBank | None:
    """Host: pack CKObjectAnimation controllers into an AnimBank on
    ``device``.

    object_anims[i] animates entity_rows[i]. Returns None when empty.
    ``n_entities`` (the entity-table row count) enables the scatter-free
    application (inv_row / has_anim)."""
    if not object_anims:
        return None
    a = len(object_anims)
    kmax = 1
    for oa in object_anims:
        for c in (oa.position_controller, oa.rotation_controller,
                  oa.scale_controller):
            if c is not None:
                kmax = max(kmax, c.GetKeyCount())
    k = pad_keys or max(2, kmax)

    def z(shape, fill=0.0):
        return np.full(shape, fill, np.float32)

    f = {}
    for name, dim, fill in (("pos", 3, 0.0), ("scl", 3, 1.0)):
        f[name + "_times"] = z((a, k), 3.0e38)
        f[name + "_values"] = z((a, k, dim), fill)
        f[name + "_tin"] = z((a, k, dim))
        f[name + "_tout"] = z((a, k, dim))
        f[name + "_mode"] = np.zeros(a, np.int32)
        f[name + "_ease"] = z((a, k, 2))
        f[name + "_n"] = np.zeros(a, np.int32)
    f["rot_times"] = z((a, k), 3.0e38)
    f["rot_quats"] = z((a, k, 4))
    f["rot_quats"][..., 3] = 1.0
    f["rot_ta"] = f["rot_quats"].copy()
    f["rot_tb"] = f["rot_quats"].copy()
    f["rot_mode"] = np.zeros(a, np.int32)
    f["rot_ease"] = z((a, k, 2))
    f["rot_n"] = np.zeros(a, np.int32)

    # Base PRS of every lane in one batched decomposition (the reference's
    # jnp decompose_prs, here on CPU tensors); a lane without an entity
    # keeps the identity, which decomposes to (0, (0, 0, 0, 1), 1) exactly.
    base_m = np.tile(np.eye(4, dtype=np.float32), (a, 1, 1))
    for i, oa in enumerate(object_anims):
        ent = oa.Get3dEntity()
        if ent is not None:
            base_m[i] = ent.GetLocalMatrix()
        for name, c, fields in (
                ("pos", oa.position_controller,
                 ("times", "values", "tin", "tout", "mode", "ease", "n")),
                ("rot", oa.rotation_controller,
                 ("times", "quats", "ta", "tb", "mode", "ease", "n")),
                ("scl", oa.scale_controller,
                 ("times", "values", "tin", "tout", "mode", "ease", "n"))):
            if c is not None and c.GetKeyCount() > 0:
                for field, v in zip(fields, c.bank_row(k)):
                    f[f"{name}_{field}"][i] = v
    f["base_pos"], f["base_rot"], f["base_scl"] = (
        x.numpy() for x in vx.decompose_prs(torch.from_numpy(base_m)))

    if n_entities is not None:
        inv_np = np.full(n_entities, a, np.int32)
        rows_np = np.asarray(entity_rows, np.int64)
        ok = (rows_np >= 0) & (rows_np < n_entities)
        inv_np[rows_np[ok]] = np.nonzero(ok)[0].astype(np.int32)
        f["inv_row"] = inv_np
        f["has_anim"] = inv_np < a
    f["entity_row"] = np.asarray(entity_rows, np.int32)
    return AnimBank(**{name: torch.as_tensor(np.ascontiguousarray(v),
                                             device=device)
                       for name, v in f.items()})
