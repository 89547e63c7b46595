"""Character: body-part hierarchy + animation state machine with warp blending.

API mirror of RCKCharacter (reference src/CKCharacter.cpp) and RCKBodyPart
(include/RCKBodyPart.h:7-40), carried from
``ckrenderengine_tpu.anim.character``. The per-tick ``ProcessAnimation``
follows src/CKCharacter.cpp:985-1258: frame stepping scaled by delta time,
loop wraparound, root-motion translation of the character, transition warps
to the next active animation, and secondary animations with loop counts and
starting/stopping warps.

The state machine is host logic emitting (clip, frame[, blend]); the track
evaluation runs on the device through each clip's AnimBank (anim/bank.py)
in ``apply_pose_device``, on the device of the local matrices it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import vxmath as vx
from ..objects.base import CKCID_BODYPART, CKCID_CHARACTER, CKObject
from ..objects.entity import CK3dObject
from .bank import apply_bank, apply_bank_blended
from .objectanim import CKAnimation, CKKeyedAnimation


class CKBodyPart(CK3dObject):
    """3d object owned by a character, optional exclusive animation + IK joint
    (reference include/RCKBodyPart.h)."""

    CLASS_ID = CKCID_BODYPART

    def __init__(self, context, name: str = ""):
        super().__init__(context, name)
        self.character = None
        self.exclusive_animation = None
        self.rotation_joint = None       # IKJointData when part of a chain

    def GetCharacter(self):
        return self.character

    def SetExclusiveAnimation(self, anim):
        self.exclusive_animation = anim

    def GetExclusiveAnimation(self):
        return self.exclusive_animation


class _SecondaryState:
    def __init__(self, anim: CKKeyedAnimation, loops: int):
        self.anim = anim
        self.frame = 0.0
        self.loops_left = loops          # -1 = infinite
        self.stopping = False


class CKCharacter(CK3dObject):
    CLASS_ID = CKCID_CHARACTER

    # Warp length default (frames) when transition mode asks for a warp.
    DEFAULT_WARP_LENGTH = 10.0

    def __init__(self, context, name: str = ""):
        super().__init__(context, name)
        self.body_parts: list[CKBodyPart] = []
        self.animations: list[CKKeyedAnimation] = []
        self.root_body_part: CKBodyPart | None = None
        self.floor_ref = None
        self.anim_lod = 1.0
        # Active-animation state machine
        self.active_animation: CKKeyedAnimation | None = None
        self.next_active_animation: CKKeyedAnimation | None = None
        self._warp_frame = 0.0
        self._warp_length = 0.0
        self._warping = False
        self._frozen_pose: dict | None = None
        self._last_root_pos: np.ndarray | None = None
        self.automatic_process = True
        self.secondary: list[_SecondaryState] = []

    # -- body parts ---------------------------------------------------------
    def AddBodyPart(self, part: CKBodyPart):
        if part not in self.body_parts:
            self.body_parts.append(part)
            part.character = self
            if self.root_body_part is None:
                self.SetRootBodyPart(part)
            if part.GetParent() is None and part is not self.root_body_part:
                part.SetParent(self.root_body_part)

    def RemoveBodyPart(self, part: CKBodyPart):
        if part in self.body_parts:
            self.body_parts.remove(part)
            part.character = None

    def GetBodyPartCount(self) -> int:
        return len(self.body_parts)

    def GetBodyPart(self, i: int) -> CKBodyPart:
        return self.body_parts[i]

    def SetRootBodyPart(self, part: CKBodyPart):
        self.root_body_part = part
        if part.GetParent() is None:
            part.SetParent(self)

    def GetRootBodyPart(self):
        return self.root_body_part

    # -- animations ----------------------------------------------------------
    def AddAnimation(self, anim: CKKeyedAnimation):
        if anim not in self.animations:
            self.animations.append(anim)
            anim.SetCharacter(self)

    def RemoveAnimation(self, anim: CKKeyedAnimation):
        if anim in self.animations:
            self.animations.remove(anim)
            anim.SetCharacter(None)

    def GetAnimationCount(self) -> int:
        return len(self.animations)

    def GetAnimation(self, i: int) -> CKKeyedAnimation:
        return self.animations[i]

    def GetActiveAnimation(self):
        return self.active_animation

    def GetNextActiveAnimation(self):
        return self.next_active_animation

    def SetActiveAnimation(self, anim: CKKeyedAnimation | None):
        self.active_animation = anim
        if anim is not None:
            anim.SetFrame(0.0)
            anim.frame = 0.0
            self._last_root_pos = None
        self._warping = False
        return True

    def SetNextActiveAnimation(self, anim: CKKeyedAnimation | None,
                               transition_mode: int | None = None,
                               warp_length: float = 0.0):
        """Queue the next animation (reference SetNextActiveAnimation :814).

        TRANSITION_BREAK starts the warp immediately; TRANSITION_THROUGH
        waits for the current clip to finish its loop first.
        """
        self.next_active_animation = anim
        if anim is not None and transition_mode is not None:
            anim.SetTransitionMode(transition_mode)
        self._pending_warp_length = (warp_length or self.DEFAULT_WARP_LENGTH)
        if (anim is not None and transition_mode is not None
                and transition_mode & CKAnimation.TRANSITION_BREAK):
            self._begin_transition()
        return True

    # -- secondary animations ------------------------------------------------
    def PlaySecondaryAnimation(self, anim: CKKeyedAnimation, loops: int = 1):
        """(reference PlaySecondaryAnimation :1305)"""
        self.secondary.append(_SecondaryState(anim, loops))

    def StopSecondaryAnimation(self, anim: CKKeyedAnimation):
        for s in self.secondary:
            if s.anim is anim:
                s.stopping = True

    def GetSecondaryAnimationsCount(self) -> int:
        return len(self.secondary)

    # -- state machine -------------------------------------------------------
    def _begin_transition(self):
        if self.next_active_animation is None:
            return
        # Freeze the current pose (local matrices of all animated parts) —
        # the warper blends from this snapshot to the next clip's frame 0.
        pose = {}
        src = self.active_animation
        if src is not None:
            for oa in src.animations:
                ent = oa.Get3dEntity()
                if ent is not None:
                    pose[ent.row] = ent.GetLocalMatrix()
        self._frozen_pose = pose
        self._warping = True
        self._warp_frame = 0.0
        self._warp_length = getattr(self, "_pending_warp_length",
                                    self.DEFAULT_WARP_LENGTH)

    def ProcessAnimation(self, delta_frames: float = 1.0):
        """One tick (reference RCKCharacter::ProcessAnimation :985-1258).

        ``delta_frames``: frames to advance (behavior-engine step x framerate
        link factor).
        """
        if self._warping:
            self._process_warp(delta_frames)
        elif self.active_animation is not None:
            self._process_active(delta_frames)
        self._process_secondary(delta_frames)

    def _process_active(self, delta: float):
        anim = self.active_animation
        length = anim.GetLength()
        new_frame = anim.frame + delta
        looped = length > 0 and new_frame >= length
        if looped:
            # Root-motion across the wrap: advance by (end - cur) first.
            self._apply_root_motion(anim, anim.frame, length)
            new_frame = new_frame - length
            self._last_root_pos = None
            if self.next_active_animation is not None:
                mode = self.next_active_animation.GetTransitionMode()
                if mode & CKAnimation.TRANSITION_WARP:
                    self._begin_transition()
                    return
                # Through-transition without warp: hard switch.
                self.active_animation = self.next_active_animation
                self.next_active_animation = None
                self.active_animation.frame = 0.0
                self.active_animation.SetFrame(0.0)
                return
        else:
            self._apply_root_motion(anim, anim.frame, new_frame)
        anim.frame = new_frame
        anim.SetFrame(new_frame)
        self._realign_root()

    def _apply_root_motion(self, anim: CKKeyedAnimation, f0: float, f1: float):
        """Translate the character by the root track's delta
        (reference :1038-1053)."""
        if anim.root_animation is None:
            return
        p0 = anim.EvaluateRootPosition(f0)
        p1 = anim.EvaluateRootPosition(f1)
        delta = np.asarray(p1) - np.asarray(p0)
        if np.any(delta):
            self.Translate(delta)

    def _realign_root(self):
        """AlignCharacterWithRootPosition: keep the root part at the character
        origin by moving its in-animation translation into the character."""
        # The root animation's positional content was consumed as root motion;
        # zero the root part's local translation so it stays glued.
        anim = self.active_animation
        if anim is None or anim.root_animation is None:
            return
        root_ent = anim.root_animation.Get3dEntity()
        if root_ent is None:
            return
        m = root_ent.GetLocalMatrix()
        m[3, :3] = 0.0
        root_ent.SetLocalMatrix(m)

    def _process_warp(self, delta: float):
        self._warp_frame += delta
        t = min(self._warp_frame / max(self._warp_length, 1e-6), 1.0)
        dst = self.next_active_animation
        if dst is None:
            self._warping = False
            return
        # Evaluate destination pose at frame 0 and blend from frozen pose.
        for oa in dst.animations:
            ent = oa.Get3dEntity()
            if ent is None:
                continue
            p1, r1, s1 = oa.evaluate_prs(0.0)
            m1 = vx.np_compose_prs(p1, r1, s1)
            m0 = self._frozen_pose.get(ent.row) if self._frozen_pose else None
            if m0 is None:
                ent.SetLocalMatrix(m1)
                continue
            p0_, r0_, s0_ = vx.np_decompose_prs(m0)
            p1_, r1_, s1_ = vx.np_decompose_prs(m1)
            p = p0_ * (1 - t) + p1_ * t
            s = s0_ * (1 - t) + s1_ * t
            r = vx.np_quat_slerp(r0_, r1_, t)
            ent.SetLocalMatrix(vx.np_compose_prs(p, r, s))
        if t >= 1.0:
            self.active_animation = dst
            self.next_active_animation = None
            self._warping = False
            dst.frame = 0.0
            self._last_root_pos = None

    def _process_secondary(self, delta: float):
        done = []
        for s in self.secondary:
            length = s.anim.GetLength()
            s.frame += delta
            if length > 0 and s.frame >= length:
                if s.stopping or (s.loops_left > 0 and s.loops_left <= 1):
                    done.append(s)
                    continue
                if s.loops_left > 0:
                    s.loops_left -= 1
                s.frame -= length
            s.anim.SetFrame(s.frame)
        for s in done:
            self.secondary.remove(s)

    # -- device path ---------------------------------------------------------
    def apply_pose_device(self, local: torch.Tensor) -> torch.Tensor:
        """Current pose applied to an (N,4,4) local-matrix tensor: a warp
        becomes a two-bank blended evaluation, otherwise one bank
        evaluation. The banks are built on ``local``'s device."""
        n, dev = local.shape[0], local.device
        if self._warping and self.next_active_animation is not None:
            t = min(self._warp_frame / max(self._warp_length, 1e-6), 1.0)
            src = self.active_animation
            dst = self.next_active_animation
            if src is None:
                return apply_bank(local, dst.bank(n, dev), 0.0)
            return apply_bank_blended(local, src.bank(n, dev), src.frame,
                                      dst.bank(n, dev), 0.0, t)
        if self.active_animation is not None:
            return apply_bank(local, self.active_animation.bank(n, dev),
                              self.active_animation.frame)
        return local

    # -- misc ----------------------------------------------------------------
    # -- API-surface parity batch (reference include/RCKCharacter.h) -------
    def GetStartingFrame(self) -> float:
        """Frame the active animation starts from after a transition
        (reference Get/SetStartingFrame)."""
        return getattr(self, "_starting_frame", 0.0)

    def SetStartingFrame(self, frame: float):
        self._starting_frame = float(frame)
        if self.active_animation is not None:
            self.active_animation.SetFrame(float(frame))

    def RemoveSecondaryAnimationAt(self, i: int) -> bool:
        if 0 <= i < len(self.secondary):
            self.secondary.pop(i)
            return True
        return False

    def PreDeleteBodyPartsForAnimation(self, anim):
        """Drop body-part exclusive-animation links that point at ``anim``
        before it is destroyed (reference PreDeleteBodyPartsForAnimation)."""
        for part in self.body_parts:
            if part.GetExclusiveAnimation() is anim:
                part.SetExclusiveAnimation(None)

    def FindFloorReference(self):
        """Nearest non-body-part entity under the character via a downward
        ray (reference FindFloorReference — floor detection for root
        realignment). Sets and returns the floor reference object."""
        import numpy as np
        origin = self.GetWorldMatrix()[3, :3] + np.array([0, 1e-3, 0],
                                                         np.float32)
        direction = np.array([0.0, -1.0, 0.0], np.float32)
        own = set(self.body_parts) | {self}
        best, best_t = None, np.inf
        from ..objects.entity import CK3dEntity
        for o in self.context._objects.values():
            if not isinstance(o, CK3dEntity) or o in own:
                continue
            if o.GetCurrentMesh() is None or self.Contains_(o):
                continue
            hit = o.RayIntersection(origin, direction)
            if hit is not None and hit[0] < best_t:
                best, best_t = o, hit[0]
        if best is not None:
            self.SetFloorReferenceObject(best)
        return best

    def Contains_(self, ent) -> bool:
        p = ent
        while p is not None:
            if p is self:
                return True
            p = p.GetParent()
        return False

    def SetAutomaticProcess(self, on: bool = True):
        self.automatic_process = bool(on)

    def IsAutomaticProcess(self) -> bool:
        return self.automatic_process

    def SetAnimationLevelOfDetail(self, lod: float):
        self.anim_lod = float(lod)

    def GetAnimationLevelOfDetail(self) -> float:
        return self.anim_lod

    def GetFloorReferenceObject(self):
        return self.floor_ref

    def SetFloorReferenceObject(self, obj):
        self.floor_ref = obj
