"""CK-compatible host object model (the classes the opaque frame needs).

Thin handles over flat SoA scene state, carried from
``ckrenderengine_tpu.objects``: the classes mirror the reference's public CK2
render API (RCKRenderManager / RCKRenderContext / RCKMesh / RCKMaterial /
RCK3dEntity / RCKCamera / RCKLight / RCKPlace) but hold no per-object device
resources — the scene compiler lowers them into device tensors per render
context, and ``CKRenderContext.Render()`` runs the frame.
"""

from .base import CKContext, CKObject
from .entity import CK3dEntity, CK3dObject
from .mesh import CKMesh
from .patchmesh import CKPatch, CKPatchMesh, CKTVPatch
from .entity2d import CK2dEntity, CKSprite, CKSpriteText
from .place import CKPlace, CKPortalEntry
from .sprite3d import CKSprite3D
from .curve import CKCurve, CKCurvePoint
from .grid import CKGrid, CKLayer
from .material import (
    CKMaterial, VXEFFECT_2TEXTURES, VXEFFECT_3TEXTURES, VXEFFECT_BUMPENV,
    VXEFFECT_DP3, VXEFFECT_NONE, VXEFFECT_TEXGEN, VXEFFECT_TEXGENREF,
)
from .texture import CKTexture
from .light import CKLight, CKTargetLight
from .camera import CKCamera, CKTargetCamera
from .manager import (
    CK_RENDER_BACKGROUNDSPRITES, CK_RENDER_CLEARBACKBUFFER,
    CK_RENDER_CLEARZBUFFER, CK_RENDER_DEFAULTSETTINGS,
    CK_RENDER_FOREGROUNDSPRITES, CK_RENDER_USECAMERARATIO,
    CKRenderContext, CKRenderManager, VxEffectDescription,
)
from .classreg import (
    CKDEP_COPY, CKDEP_USECURRENT, CKGetClassDesc, CKGetClassIdByName,
    CKGetClassName, CKGetParentClassID, CKIsChildClassOf,
    DEFAULT_COPY_DEPENDENCIES, FULL_COPY_DEPENDENCIES,
)

__all__ = [
    "CKContext", "CKObject", "CK3dEntity", "CK3dObject", "CKMesh",
    "CKPatch", "CKPatchMesh", "CKTVPatch", "CK2dEntity", "CKSprite",
    "CKSpriteText", "CKSprite3D", "CKCurve", "CKCurvePoint", "CKGrid",
    "CKLayer",
    "CKPlace", "CKPortalEntry", "CKMaterial", "CKTexture", "CKLight",
    "CKTargetLight", "CKCamera", "CKTargetCamera", "CKRenderManager",
    "CKRenderContext", "VxEffectDescription",
    "VXEFFECT_NONE", "VXEFFECT_TEXGEN", "VXEFFECT_TEXGENREF",
    "VXEFFECT_BUMPENV", "VXEFFECT_DP3", "VXEFFECT_2TEXTURES",
    "VXEFFECT_3TEXTURES",
    "CK_RENDER_DEFAULTSETTINGS", "CK_RENDER_USECAMERARATIO",
    "CK_RENDER_CLEARBACKBUFFER", "CK_RENDER_CLEARZBUFFER",
    "CK_RENDER_BACKGROUNDSPRITES", "CK_RENDER_FOREGROUNDSPRITES",
    "CKDEP_COPY", "CKDEP_USECURRENT", "CKGetClassDesc",
    "CKGetClassIdByName", "CKGetClassName", "CKGetParentClassID",
    "CKIsChildClassOf", "DEFAULT_COPY_DEPENDENCIES",
    "FULL_COPY_DEPENDENCIES",
]
