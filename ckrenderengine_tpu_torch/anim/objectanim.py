"""Object / keyed animation host objects.

API mirror of RCKObjectAnimation (reference include/RCKObjectAnimation.h
:10-110, src/CKObjectAnimation.cpp) and RCKAnimation / RCKKeyedAnimation
(include/RCKAnimation.h:7-73, src/CKKeyedAnimation.cpp), carried from
``ckrenderengine_tpu.anim.objectanim``. Host objects hold controllers and
clip metadata. A clip bound to a render context (``BindAnimation``)
evaluates on the device through its AnimBank (anim/bank.py): the bank is
built once per controller signature on the context's device, and per frame
only the clip time crosses. The per-object ``SetStep`` path (evaluate and
write the entity's local matrix) keeps the host semantics of
src/CKObjectAnimation.cpp:1674-1759, including the PRS fallback from the
entity's current matrix.
"""

from __future__ import annotations

import numpy as np

from ..math import vxmath as vx
from ..objects.base import CKCID_ANIMATION, CKCID_KEYEDANIMATION, CKCID_OBJECTANIMATION, CKObject
from .keyframe import (
    BezierPositionController, BezierScaleController, LinearPositionController,
    LinearScaleAxisController, LinearScaleController, MorphController,
    RotationController, TCBPositionController, TCBRotationController,
    TCBScaleAxisController, TCBScaleController,
)

# Controller type codes (CKANIMATION_CONTROLLER in the reference SDK).
CKANIMATION_LINEAR_POS = 0
CKANIMATION_TCB_POS = 1
CKANIMATION_BEZIER_POS = 2
CKANIMATION_LINEAR_SCL = 3
CKANIMATION_TCB_SCL = 4
CKANIMATION_BEZIER_SCL = 5
CKANIMATION_LINEAR_ROT = 6
CKANIMATION_TCB_ROT = 7
CKANIMATION_LINEAR_SCLAXIS = 8
CKANIMATION_TCB_SCLAXIS = 9
CKANIMATION_MORPH = 10

_POS_TYPES = {
    CKANIMATION_LINEAR_POS: LinearPositionController,
    CKANIMATION_TCB_POS: TCBPositionController,
    CKANIMATION_BEZIER_POS: BezierPositionController,
}
_SCL_TYPES = {
    CKANIMATION_LINEAR_SCL: LinearScaleController,
    CKANIMATION_TCB_SCL: TCBScaleController,
    CKANIMATION_BEZIER_SCL: BezierScaleController,
}
_ROT_TYPES = {
    CKANIMATION_LINEAR_ROT: RotationController,
    CKANIMATION_TCB_ROT: TCBRotationController,
}
_SCLAXIS_TYPES = {
    CKANIMATION_LINEAR_SCLAXIS: LinearScaleAxisController,
    CKANIMATION_TCB_SCLAXIS: TCBScaleAxisController,
}


class CKObjectAnimation(CKObject):
    """One entity's animation: PRS (+scaleAxis, +morph) controllers.

    Evaluation semantics mirror RCKObjectAnimation::SetStep
    (src/CKObjectAnimation.cpp:1674-1759): missing tracks are filled from the
    entity's current local-matrix decomposition; morph targets write the
    mesh's vertex arrays (:1761-1800+).
    """

    CLASS_ID = CKCID_OBJECTANIMATION

    def __init__(self, context, name: str = ""):
        super().__init__(context, name)
        self._entity = None
        self.position_controller = None
        self.rotation_controller = None
        self.scale_controller = None
        self.scale_axis_controller = None
        self.morph_controller = None
        self.length = 0.0
        # Merged-animation sources (reference merged anims w/ merge factor).
        self._merge_a = None
        self._merge_b = None
        self.merge_factor = 0.5

    # -- entity binding ----------------------------------------------------
    def Set3dEntity(self, ent):
        self._entity = ent
        if ent is not None and self not in ent.object_animations:
            ent.object_animations.append(self)

    def Get3dEntity(self):
        return self._entity

    # -- controller creation ----------------------------------------------
    def CreateController(self, ctype: int):
        if ctype in _POS_TYPES:
            self.position_controller = _POS_TYPES[ctype]()
            return self.position_controller
        if ctype in _SCL_TYPES:
            self.scale_controller = _SCL_TYPES[ctype]()
            return self.scale_controller
        if ctype in _ROT_TYPES:
            self.rotation_controller = _ROT_TYPES[ctype]()
            return self.rotation_controller
        if ctype in _SCLAXIS_TYPES:
            self.scale_axis_controller = _SCLAXIS_TYPES[ctype]()
            return self.scale_axis_controller
        raise ValueError(f"unknown controller type {ctype}")

    def CreateMorphController(self, vertex_count: int):
        self.morph_controller = MorphController(vertex_count)
        return self.morph_controller

    def DeleteController(self, ctype: int) -> bool:
        if ctype in _POS_TYPES and self.position_controller is not None:
            self.position_controller = None
            return True
        if ctype in _SCL_TYPES and self.scale_controller is not None:
            self.scale_controller = None
            return True
        if ctype in _ROT_TYPES and self.rotation_controller is not None:
            self.rotation_controller = None
            return True
        if ctype in _SCLAXIS_TYPES and self.scale_axis_controller is not None:
            self.scale_axis_controller = None
            return True
        if ctype == CKANIMATION_MORPH and self.morph_controller is not None:
            self.morph_controller = None
            return True
        return False

    # -- API-surface parity batch (reference include/RCKObjectAnimation.h) --
    def GetPositionController(self):
        return self.position_controller

    def GetRotationController(self):
        return self.rotation_controller

    def GetScaleController(self):
        return self.scale_controller

    def GetScaleAxisController(self):
        return self.scale_axis_controller

    def GetMorphController(self):
        return self.morph_controller

    def HasPositionInfo(self) -> bool:
        c = self.position_controller
        return c is not None and c.GetKeyCount() > 0

    def HasRotationInfo(self) -> bool:
        c = self.rotation_controller
        return c is not None and c.GetKeyCount() > 0

    def HasScaleInfo(self) -> bool:
        c = self.scale_controller
        return c is not None and c.GetKeyCount() > 0

    def HasScaleAxisInfo(self) -> bool:
        c = self.scale_axis_controller
        return c is not None and c.GetKeyCount() > 0

    def HasMorphInfo(self) -> bool:
        c = self.morph_controller
        return c is not None and c.GetKeyCount() > 0

    def HasMorphNormalInfo(self) -> bool:
        c = self.morph_controller
        return c is not None and c.HasNormalInfo()

    def GetMorphVertexCount(self) -> int:
        c = self.morph_controller
        return c.GetMorphVertexCount() if c is not None else 0

    # Key-add conveniences: create the default (linear) controller on first
    # use, exactly the type the reference's Add*Key paths target.
    def AddPositionKey(self, time: float, pos):
        if self.position_controller is None:
            self.CreateController(CKANIMATION_LINEAR_POS)
        return self.position_controller.AddKey(time, pos)

    def AddRotationKey(self, time: float, quat):
        if self.rotation_controller is None:
            self.CreateController(CKANIMATION_LINEAR_ROT)
        return self.rotation_controller.AddKey(time, quat)

    def AddScaleKey(self, time: float, scale):
        if self.scale_controller is None:
            self.CreateController(CKANIMATION_LINEAR_SCL)
        return self.scale_controller.AddKey(time, scale)

    def AddScaleAxisKey(self, time: float, quat):
        if self.scale_axis_controller is None:
            self.CreateController(CKANIMATION_LINEAR_SCLAXIS)
        return self.scale_axis_controller.AddKey(time, quat)

    def CheckScaleKeys(self) -> int:
        """Repair degenerate scale keys: components with |s| < 1e-6 are
        clamped away from zero (reference CheckScaleKeys — zero scales make
        the PRS decomposition singular). Returns the number of repaired
        keys."""
        c = self.scale_controller
        if c is None or c.GetKeyCount() == 0:
            return 0
        v = c.values
        bad = np.abs(v) < 1e-6
        n_bad = int(np.any(bad, axis=1).sum())
        if n_bad:
            sign = np.where(v < 0, -1.0, 1.0)
            c.values = np.where(bad, sign * 1e-6, v).astype(np.float32)
            c._dirty()
        return n_bad

    def ClearAll(self):
        """Drop every controller (reference ClearAll)."""
        self.position_controller = None
        self.rotation_controller = None
        self.scale_controller = None
        self.scale_axis_controller = None
        self.morph_controller = None
        self._shared_from = None

    def ResetKeyframeData(self):
        """Fresh, un-shared keyframe container (reference ResetKeyframeData
        allocates a new CKKeyframeData)."""
        self.ClearAll()
        self.length = 0.0

    def ShareDataFrom(self, other: "CKObjectAnimation"):
        """Share the other animation's keyframe container (reference
        ref-counted CKKeyframeData sharing): the controllers become the SAME
        objects, so key edits are visible through both animations."""
        self.position_controller = other.position_controller
        self.rotation_controller = other.rotation_controller
        self.scale_controller = other.scale_controller
        self.scale_axis_controller = other.scale_axis_controller
        self.morph_controller = other.morph_controller
        self._shared_from = other

    def Shared(self) -> bool:
        return getattr(self, "_shared_from", None) is not None

    def IsMerged(self) -> bool:
        return self._merge_a is not None and self._merge_b is not None

    def GetCurrentStep(self) -> float:
        return getattr(self, "_current_step", 0.0)

    def SetCurrentStep(self, step: float):
        self.SetStep(step)

    def SetKeyframeLength(self, l: float):
        """Length of the shared keyframe data (reference SetKeyframeLength);
        the animation reports it when no explicit anim length is set."""
        self.length = float(l)

    def GetKeyframeLength(self) -> float:
        return self.GetLength()

    def EvaluateScaleAxis(self, t: float):
        if self.scale_axis_controller is None:
            return None
        return self.scale_axis_controller.Evaluate(t)

    def EvaluateMorphTarget(self, t: float):
        """Morph vertex/normal arrays at ``t`` (reference
        EvaluateMorphTarget writes them into the mesh modifier arrays;
        SetStep does that application here)."""
        if self.morph_controller is None:
            return None, None
        return self.morph_controller.Evaluate(t)

    # -- length ------------------------------------------------------------
    def GetLength(self) -> float:
        if self.length > 0:
            return self.length
        l = 0.0
        for c in (self.position_controller, self.rotation_controller,
                  self.scale_controller, self.scale_axis_controller):
            if c is not None:
                l = max(l, c.GetLength())
        if self.morph_controller is not None and self.morph_controller.GetKeyCount():
            l = max(l, float(self.morph_controller.times[-1]))
        return l

    def SetLength(self, l: float):
        self.length = float(l)

    # -- evaluation --------------------------------------------------------
    def EvaluatePosition(self, t: float):
        if self.position_controller is None:
            return None
        return self.position_controller.Evaluate(t)

    def EvaluateRotation(self, t: float):
        if self.rotation_controller is None:
            return None
        return self.rotation_controller.Evaluate(t)

    def EvaluateScale(self, t: float):
        if self.scale_controller is None:
            return None
        return self.scale_controller.Evaluate(t)

    def EvaluateKeys(self, t: float):
        return (self.EvaluatePosition(t), self.EvaluateRotation(t),
                self.EvaluateScale(t))

    def GetVelocity(self, step: float):
        """Positional velocity at ``step`` via a one-frame finite
        difference of the position track (reference
        RCKObjectAnimation::GetVelocity, src/CKObjectAnimation.cpp:1621+)."""
        import numpy as np

        if self.position_controller is None:
            return np.zeros(3, np.float32)
        length = max(float(self.GetLength()), 1.0)
        frame = step * length            # EvaluatePosition takes frame time
        frame2 = frame + 1.0 if frame + 1.0 < length else frame - 1.0
        p1 = np.asarray(self.EvaluatePosition(frame), np.float32)
        p2 = np.asarray(self.EvaluatePosition(frame2), np.float32)
        return (p2 - p1) if frame < frame2 else (p1 - p2)

    def evaluate_prs(self, t: float):
        """PRS with base-matrix fallback for missing tracks."""
        base_p = base_r = base_s = None
        if self._entity is not None:
            base_p, base_r, base_s = vx.np_decompose_prs(
                self._entity.GetLocalMatrix())
        else:
            base_p = np.zeros(3, np.float32)
            base_r = np.array([0, 0, 0, 1], np.float32)
            base_s = np.ones(3, np.float32)
        p = self.EvaluatePosition(t)
        r = self.EvaluateRotation(t)
        s = self.EvaluateScale(t)
        return (p if p is not None else base_p,
                r if r is not None else base_r,
                s if s is not None else base_s)

    def SetStep(self, step: float, entity=None):
        """Evaluate at ``step`` and write the target's local matrix
        (+morph into the mesh)."""
        ent = entity or self._entity
        self._current_step = float(step)
        if self._merge_a is not None and self._merge_b is not None:
            pa = self._merge_a.evaluate_prs(step)
            pb = self._merge_b.evaluate_prs(step)
            f = self.merge_factor
            p = pa[0] * (1 - f) + pb[0] * f
            r = vx.np_quat_slerp(pa[1], pb[1], f)
            s = pa[2] * (1 - f) + pb[2] * f
        else:
            p, r, s = self.evaluate_prs(step)
        if ent is not None:
            m = vx.np_compose_prs(p, r, s)
            # Scale-axis track: scale applies in a rotated frame
            # (S' = R_sa^-1 diag(s) R_sa, reference scaleAxis controllers).
            if self.scale_axis_controller is not None \
                    and self.scale_axis_controller.GetKeyCount() > 0:
                q_sa = self.scale_axis_controller.Evaluate(step)
                r_sa = vx.np_quat_to_matrix3(q_sa)
                s_axis = r_sa.T @ np.diag(np.asarray(s, np.float32)) @ r_sa
                rot3 = vx.np_quat_to_matrix3(r)
                m[:3, :3] = s_axis @ rot3      # row-vector: scale then rotate
            ent.SetLocalMatrix(m)
            if self.morph_controller is not None and ent.GetCurrentMesh() is not None:
                v, n = self.morph_controller.Evaluate(step)
                if v is not None:
                    mesh = ent.GetCurrentMesh()
                    mesh.SetPositions(v)
                    if n is not None and np.any(n):
                        mesh.SetNormals(n)

    def SetFrame(self, frame: float):
        self.SetStep(frame)

    # -- merge / transition -------------------------------------------------
    @staticmethod
    def CreateMergedAnimation(context, a: "CKObjectAnimation",
                              b: "CKObjectAnimation", factor: float = 0.5):
        m = CKObjectAnimation(context, f"{a.GetName()}+{b.GetName()}")
        m._merge_a, m._merge_b = a, b
        m.merge_factor = float(factor)
        m._entity = a._entity
        return m

    def SetMergeFactor(self, f: float):
        self.merge_factor = float(f)

    def GetMergeFactor(self) -> float:
        return self.merge_factor

    def CreateTransition(self, to_anim: "CKObjectAnimation", length: float,
                         from_t: float, to_t: float = 0.0):
        """Snapshot transition: linear/ slerp blend from this animation's pose
        at from_t to to_anim's pose at to_t over ``length`` frames
        (reference CreateTransition)."""
        p0, r0, s0 = self.evaluate_prs(from_t)
        p1, r1, s1 = to_anim.evaluate_prs(to_t)
        tr = CKObjectAnimation(self.context,
                               f"{self.GetName()}->{to_anim.GetName()}")
        tr._entity = self._entity
        pc = tr.CreateController(CKANIMATION_LINEAR_POS)
        pc.AddKey(0.0, p0)
        pc.AddKey(length, p1)
        rc = tr.CreateController(CKANIMATION_LINEAR_ROT)
        rc.AddKey(0.0, r0)
        rc.AddKey(length, r1)
        sc = tr.CreateController(CKANIMATION_LINEAR_SCL)
        sc.AddKey(0.0, s0)
        sc.AddKey(length, s1)
        tr.SetLength(length)
        return tr

    def Clone(self):
        c = CKObjectAnimation(self.context, self.GetName())
        c._entity = self._entity
        for attr in ("position_controller", "rotation_controller",
                     "scale_controller", "scale_axis_controller"):
            src = getattr(self, attr)
            if src is not None:
                setattr(c, attr, src.Clone())
        c.length = self.length
        return c


class CKAnimation(CKObject):
    """Base animation: length / framerate link / transition flags
    (reference include/RCKAnimation.h:7-73)."""

    CLASS_ID = CKCID_ANIMATION

    # Transition modes (CK_ANIMATION_TRANSITION_MODE subset)
    TRANSITION_THROUGH = 1
    TRANSITION_BREAK = 2
    TRANSITION_WARP = 4
    SECONDARY_LOOP = 8

    def __init__(self, context, name: str = ""):
        super().__init__(context, name)
        self.length = 0.0
        self.frame = 0.0
        self.framerate_linked = True
        self.transition_mode = self.TRANSITION_THROUGH
        self.charac = None

    def GetLength(self) -> float:
        return self.length

    def SetLength(self, l: float):
        self.length = float(l)

    def GetFrame(self) -> float:
        return self.frame

    def SetFrame(self, f: float):
        self.frame = float(f)

    def GetStep(self) -> float:
        return self.frame / self.length if self.length > 0 else 0.0

    def SetStep(self, s: float):
        self.SetFrame(s * self.length)

    def SetCharacter(self, ch):
        self.charac = ch

    def GetCharacter(self):
        return self.charac

    def LinkToFrameRate(self, on: bool = True):
        self.framerate_linked = bool(on)

    def IsLinkedToFrameRate(self) -> bool:
        return self.framerate_linked

    # -- API-surface parity batch (reference include/RCKAnimation.h) -------
    def SetCanBeInterrupt(self, can: bool = True):
        """Whether a SetNextActiveAnimation may cut this clip mid-play
        (reference CanBeInterrupt flag)."""
        self._can_interrupt = bool(can)

    def CanBeInterrupt(self) -> bool:
        return getattr(self, "_can_interrupt", True)

    def SetCharacterOrientation(self, takes: bool = True):
        """Whether the character adopts this animation's root orientation
        (reference DoesCharacterTakeOrientation)."""
        self._takes_orientation = bool(takes)

    def DoesCharacterTakeOrientation(self) -> bool:
        return getattr(self, "_takes_orientation", True)

    def SetLinkedFrameRate(self, link: bool = True, fps: float = 30.0):
        self._framerate_link = bool(link)
        self._linked_fps = float(fps)

    def GetLinkedFrameRate(self) -> float:
        return getattr(self, "_linked_fps", 30.0)

    def GetNextFrame(self, delta_frames: float) -> float:
        """Frame after stepping by ``delta_frames`` with loop wraparound
        (reference GetNextFrame — the ProcessAnimation stepping rule)."""
        length = max(self.GetLength(), 1e-6)
        f = self.frame + float(delta_frames)
        while f >= length:
            f -= length
        while f < 0:
            f += length
        return f

    def GetRootEntity(self):
        """The entity the root animation drives (reference GetRootEntity)."""
        root = getattr(self, "root_animation", None)
        return root.Get3dEntity() if root is not None else None

    def SetSecondaryAnimationMode(self, mode: int):
        self._secondary_mode = int(mode)

    def GetSecondaryAnimationMode(self) -> int:
        return getattr(self, "_secondary_mode", 0)

    def SetCurrentStep(self, step: float):
        """Position by normalized step in [0,1] (reference SetCurrentStep)."""
        self.SetFrame(float(step) * max(self.GetLength(), 1e-6))

    def GetCurrentStep(self) -> float:
        return self.frame / max(self.GetLength(), 1e-6)

    def SetTransitionMode(self, mode: int):
        self.transition_mode = int(mode)

    def GetTransitionMode(self) -> int:
        return self.transition_mode


class CKKeyedAnimation(CKAnimation):
    """A set of object animations forming one clip (reference
    src/CKKeyedAnimation.cpp): per-entity animations + root animation with
    root-motion extraction + CenterAnimation recentering."""

    CLASS_ID = CKCID_KEYEDANIMATION

    def __init__(self, context, name: str = ""):
        super().__init__(context, name)
        self.animations: list[CKObjectAnimation] = []
        self.root_animation: CKObjectAnimation | None = None
        self._bank = None
        self._bank_version = -1
        self._host_bank = None

    def AddAnimation(self, anim: CKObjectAnimation):
        if anim not in self.animations:
            self.animations.append(anim)
            self.length = max(self.length, anim.GetLength())
            self._bank = None

    def RemoveAnimation(self, anim: CKObjectAnimation):
        if anim in self.animations:
            self.animations.remove(anim)
            self._bank = None

    def GetAnimationCount(self) -> int:
        return len(self.animations)

    def GetAnimation(self, ent_or_idx):
        if isinstance(ent_or_idx, int):
            return self.animations[ent_or_idx]
        for a in self.animations:
            if a.Get3dEntity() is ent_or_idx:
                return a
        return None

    def SetRootAnimation(self, anim: CKObjectAnimation):
        self.root_animation = anim

    def GetRootAnimation(self):
        return self.root_animation

    def GetLength(self) -> float:
        if self.length <= 0:
            for a in self.animations:
                self.length = max(self.length, a.GetLength())
        return self.length

    # -- host-path evaluation ----------------------------------------------
    def SetFrame(self, frame: float):
        """Apply every object animation at ``frame`` (host path).

        Members without merge/morph/scale-axis state evaluate in ONE
        vectorized numpy pass (anim/host_bank.py) and write the entity table
        in one batched assignment — the reference's per-member SetStep loop
        (src/CKObjectAnimation.cpp:1674) is O(bones) Python overhead on a
        128-bone character. The rest keep the exact per-animation path."""
        if getattr(self, "_device_rc", None) is not None:
            # Device-bound (CKRenderContext.BindAnimation): the clip's bank
            # evaluates INSIDE the frame program at the packed scalar time —
            # this call records the time only. Host-side entity matrices
            # stay at their last-synced pose; call SyncToHost() before host
            # queries (GetPosition/picking) that must see the current frame.
            self.frame = float(frame)
            self._host_stale = True
            self._device_rc.context._bump_dynamic()
            return
        self._set_frame_host(frame)

    def SyncToHost(self):
        """Evaluate the current frame on the host (entity-table update) for
        a device-bound clip, e.g. before picking or GetPosition queries."""
        if getattr(self, "_host_stale", False):
            self._host_stale = False
            self._set_frame_host(self.frame)

    def _set_frame_host(self, frame: float):
        from . import host_bank as hb
        from ..scene import entity_table as et

        self.frame = float(frame)
        # The simple/rest partition and the packed bank are static between
        # key/membership edits; recomputing them per tick (is_simple calls
        # np.any per controller) used to cost ~1.8 ms/frame on a 128-bone
        # clip. Cache both keyed on the full controller signature.
        sig = hb.full_signature(self.animations)
        cache = self._host_bank
        if cache is None or cache[0] != sig:
            simple = [a for a in self.animations if hb.is_simple(a)]
            rest = [a for a in self.animations if not hb.is_simple(a)]
            bank = hb.build_host_bank(simple) if len(simple) >= 2 else None
            if bank is None:
                rest = self.animations
                ctx = None
            else:
                ctx = simple[0]._entity.context
            cache = self._host_bank = (sig, bank, rest, ctx)
        _, bank, rest, ctx = cache
        if bank is not None:
            table = ctx.entity_table
            table.local[bank.rows] = hb.evaluate_host_bank(
                bank, self.frame, table.local)
            table.flags[bank.rows] |= et.VX_MOVEABLE_HASMOVED
            rm = ctx.render_manager
            if rm is not None:
                rm._moved_entities.update(bank.ids)
            ctx._bump_dynamic()
        for a in rest:
            a.SetStep(frame)

    # -- device bank --------------------------------------------------------
    def bank(self, n_entities: int | None = None, device=None):
        """AnimBank over all member animations with a bound entity, held on
        ``device``; cached on the full controller signature (and the entity
        count and device), so key edits rebuild it and a frame reuses it.
        ``n_entities`` (entity-table row count) enables the scatter-free
        device application (anim/bank.py inv_row path)."""
        from . import host_bank as hb
        from .bank import build_anim_bank

        sig = (hb.full_signature(self.animations), n_entities, str(device))
        if self._bank is None or self._bank_version != sig:
            anims = [a for a in self.animations if a.Get3dEntity() is not None]
            rows = [a.Get3dEntity().row for a in anims]
            self._bank = build_anim_bank(anims, rows, n_entities=n_entities,
                                         device=device)
            self._bank_version = sig
        return self._bank

    def device_eligible(self) -> bool:
        """Every member evaluable by the device bank: bound entity, no merge
        sources, no morph, no scale-axis track (those stay host-evaluated)."""
        for a in self.animations:
            if a.Get3dEntity() is None or a._merge_a is not None \
                    or a._merge_b is not None:
                return False
            sax = a.scale_axis_controller
            if sax is not None and sax.GetKeyCount() > 0:
                return False
            mc = a.morph_controller
            if mc is not None and mc.GetKeyCount() > 0:
                return False
        return bool(self.animations)

    def invalidate_bank(self):
        self._bank = None

    # -- API-surface parity batch (reference include/RCKKeyedAnimation.h) --
    def GetRootAnimationInternal(self):
        """The stored root animation without entity-derived fallbacks
        (reference GetRootAnimationInternal)."""
        return self.root_animation

    def GetRootVectorInternal(self):
        """Accumulated root-motion vector (reference GetRootVectorInternal)."""
        import numpy as np
        return getattr(self, "_root_vector", np.zeros(3, np.float32)).copy()

    def SetParentKeyedAnimation(self, parent: "CKKeyedAnimation | None"):
        """Merged-animation back-pointer (reference SetParentKeyedAnimation)."""
        self._parent_keyed = parent

    def GetParentKeyedAnimation(self):
        return getattr(self, "_parent_keyed", None)

    def UpdateRootEntity(self) -> bool:
        """Re-derive which object animation drives the hierarchy root
        (reference UpdateRootEntity): the animation whose entity has no
        animated parent becomes the root animation."""
        animated = {a.Get3dEntity() for a in self.animations
                    if a.Get3dEntity() is not None}
        for a in self.animations:
            ent = a.Get3dEntity()
            if ent is None:
                continue
            p = ent.GetParent()
            has_animated_parent = False
            while p is not None:
                if p in animated:
                    has_animated_parent = True
                    break
                p = p.GetParent()
            if not has_animated_parent:
                self.root_animation = a
                return True
        return False

    def EvaluateRootPosition(self, frame: float):
        """Root body-part position at ``frame`` (root-motion source,
        reference src/CKCharacter.cpp:1038-1053)."""
        ra = self.root_animation
        if ra is None and self.animations:
            ra = self.animations[0]
        if ra is None:
            return np.zeros(3, np.float32)
        p = ra.EvaluatePosition(frame)
        return p if p is not None else np.zeros(3, np.float32)

    def CenterAnimation(self):
        """Recenter the root animation's position keys around frame 0
        (reference CKKeyedAnimation::CenterAnimation)."""
        ra = self.root_animation
        if ra is None or ra.position_controller is None:
            return
        pc = ra.position_controller
        if pc.GetKeyCount() == 0:
            return
        origin = pc.values[0].copy()
        pc.values = pc.values - origin
        pc._dirty()
        if self._bank is not None:
            self._bank = None
