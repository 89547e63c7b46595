"""Animation: keyframe controllers, object and keyed animations, device
animation banks, skins, characters and inverse kinematics (the reference's
``anim`` package)."""

from .keyframe import (
    AnimController, BezierPositionController, BezierScaleController,
    LinearPositionController, LinearScaleAxisController, LinearScaleController,
    MorphController, RotationController, TCBPositionController,
    TCBRotationController, TCBScaleAxisController, TCBScaleController,
)
from .objectanim import (
    CKANIMATION_BEZIER_POS, CKANIMATION_BEZIER_SCL, CKANIMATION_LINEAR_POS,
    CKANIMATION_LINEAR_ROT, CKANIMATION_LINEAR_SCL, CKANIMATION_LINEAR_SCLAXIS,
    CKANIMATION_MORPH, CKANIMATION_TCB_POS, CKANIMATION_TCB_ROT,
    CKANIMATION_TCB_SCL, CKANIMATION_TCB_SCLAXIS, CKAnimation,
    CKKeyedAnimation, CKObjectAnimation,
)
from .character import CKBodyPart, CKCharacter
from .ik import CKKinematicChain, IKJointData
from .skin import CKSkin, CKSkinBoneData
from .bank import (
    AnimBank, apply_bank, apply_bank_blended, build_anim_bank,
    evaluate_bank_prs,
)
