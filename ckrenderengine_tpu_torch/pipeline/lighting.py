"""DX9 fixed-function Gouraud vertex lighting, batched over all scene vertices.

Replaces the per-draw SetLight/SetMaterial + fixed-function T&L path of the
reference (RCKLight::Setup, src/CKLight.cpp:592-656; RCKMaterial::SetAsCurrent,
src/CKMaterial.cpp:1269-1438). Lights are a padded SoA bank, the material
lighting parameters are per-vertex gathered rows, and one broadcast
evaluation lights every vertex of every entity in the frame at once.

Semantics (D3D9 fixed-function, world-space formulation), the same as
``ckrenderengine_tpu.pipeline.lighting``:

- ``out.rgb = emissive + Ma*(global_ambient + sum La*att*spot)
             + Md * sum Ld * max(N.L, 0) * att * spot``  (saturated)
- ``out.a   = Md.a``
- separate specular ``spec.rgb = Ms * sum Ls * max(N.H, 0)^power * att * spot``
  added after texture blending, zeroed when the material's specular power
  <= 0.05 (src/CKMaterial.cpp "SpecularPower > 0.05f").
- attenuation ``1 / (a0 + a1*d + a2*d^2)`` with a hard range cutoff;
  directional lights have att = 1.
- spot factor: 1 inside the inner cone, 0 outside the outer cone,
  ``((rho - cos_phi) / (cos_theta - cos_phi)) ^ falloff`` between.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..raster.types import VXLIGHT


class LightArray(NamedTuple):
    """Padded SoA light bank (L rows). All colors are pre-power-scaled."""

    type: torch.Tensor       # (L,) int32 VXLIGHT
    diffuse: torch.Tensor    # (L,4) f32
    specular: torch.Tensor   # (L,4) f32
    ambient: torch.Tensor    # (L,4) f32
    position: torch.Tensor   # (L,3) f32 world
    direction: torch.Tensor  # (L,3) f32 world (normalized)
    range: torch.Tensor      # (L,) f32
    falloff: torch.Tensor    # (L,) f32
    attenuation: torch.Tensor  # (L,3) f32 [a0, a1, a2]
    cos_theta: torch.Tensor  # (L,) f32 cos(inner/2)
    cos_phi: torch.Tensor    # (L,) f32 cos(outer/2)
    active: torch.Tensor     # (L,) bool


class MaterialLighting(NamedTuple):
    """Per-vertex (already gathered) material lighting rows."""

    diffuse: torch.Tensor    # (...,4)
    ambient: torch.Tensor    # (...,4)
    specular: torch.Tensor   # (...,4)
    emissive: torch.Tensor   # (...,4)
    power: torch.Tensor      # (...,)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def compute_vertex_lighting(pos: torch.Tensor, normal: torch.Tensor,
                            mat: MaterialLighting, lights: LightArray,
                            global_ambient: torch.Tensor,
                            cam_pos: torch.Tensor):
    """Returns (diffuse_rgba (V,4), specular_rgb (V,3)), both saturated.

    pos/normal: (V,3) world-space positions and unit normals; mat fields are
    gathered per vertex; cam_pos (3,) is the eye for the specular half
    vector."""
    eps = 1e-12
    # (V, L, 3) vertex -> light geometry, broadcast over the light bank.
    to_light = lights.position[None, :, :] - pos[:, None, :]
    dist = torch.sqrt(torch.clamp(torch.sum(to_light * to_light, -1),
                                  min=eps))                       # (V,L)
    l_point = to_light / dist[..., None]
    is_dir = (lights.type == int(VXLIGHT.DIREC))[None, :]
    ldir_n = lights.direction / torch.clamp(_norm(lights.direction), min=eps)
    l_vec = torch.where(is_dir[..., None], -ldir_n[None, :, :], l_point)

    # Attenuation with range cutoff (1 for directional).
    a0 = lights.attenuation[:, 0][None]
    a1 = lights.attenuation[:, 1][None]
    a2 = lights.attenuation[:, 2][None]
    att = 1.0 / torch.clamp(a0 + a1 * dist + a2 * dist * dist, min=eps)
    att = torch.where(dist <= lights.range[None, :], att, 0.0)
    att = torch.where(is_dir, 1.0, att)

    # Spot factor.
    rho = torch.sum(ldir_n[None, :, :] * (-l_vec), -1)           # (V,L)
    denom = torch.clamp(lights.cos_theta - lights.cos_phi, min=eps)[None]
    t = torch.clamp((rho - lights.cos_phi[None]) / denom, 0.0, 1.0)
    smooth = torch.pow(torch.clamp(t, min=eps), lights.falloff[None])
    spot = torch.where(rho >= lights.cos_theta[None], 1.0,
                       torch.where(rho <= lights.cos_phi[None], 0.0, smooth))
    spot = torch.where((lights.type == int(VXLIGHT.SPOT))[None], spot, 1.0)

    gate = att * spot * lights.active[None].to(torch.float32)    # (V,L)

    ndotl = torch.clamp(torch.sum(normal[:, None, :] * l_vec, -1), min=0.0)
    diff_sum = torch.sum((gate * ndotl)[..., None]
                         * lights.diffuse[None, :, :3], dim=1)
    amb_sum = torch.sum(gate[..., None] * lights.ambient[None, :, :3], dim=1)

    # Specular: local-viewer halfway vector.
    view = cam_pos[None, :] - pos
    view = view / torch.clamp(_norm(view), min=eps)
    h = l_vec + view[:, None, :]
    h = h / torch.clamp(_norm(h), min=eps)
    ndoth = torch.clamp(torch.sum(normal[:, None, :] * h, -1), min=0.0)
    power = torch.clamp(mat.power, min=eps)
    spec_gate = torch.where(ndotl > 0.0,
                            torch.pow(torch.clamp(ndoth, min=eps),
                                      power[:, None]), 0.0)
    spec_sum = torch.sum((gate * spec_gate)[..., None]
                         * lights.specular[None, :, :3], dim=1)

    rgb = (mat.emissive[..., :3]
           + mat.ambient[..., :3] * (global_ambient[None, :3] + amb_sum)
           + mat.diffuse[..., :3] * diff_sum)
    diffuse_rgba = torch.cat([torch.clamp(rgb, 0.0, 1.0),
                              torch.clamp(mat.diffuse[..., 3:4], 0.0, 1.0)],
                             dim=-1)
    # SPECULARENABLE only when power > 0.05 (reference threshold).
    spec_on = (mat.power > 0.05).to(torch.float32)[..., None]
    specular_rgb = torch.clamp(mat.specular[..., :3] * spec_sum,
                               0.0, 1.0) * spec_on
    return diffuse_rgba, specular_rgb


def fog_factor(cam_z: torch.Tensor, mode: torch.Tensor, start: torch.Tensor,
               end: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """Per-vertex D3D fog factor (1 = unfogged) from camera-space depth.

    The vertex-fog modes of CKRenderedScene::SetDefaultRenderStates
    (src/CKRenderedScene.cpp:383-482): NONE/EXP/EXP2/LINEAR."""
    d = torch.clamp(cam_z, min=0.0)
    lin = torch.clamp((end - d) / torch.clamp(end - start, min=1e-12),
                      0.0, 1.0)
    e1 = torch.exp(-d * density)
    e2 = torch.exp(-((d * density) ** 2))
    one = torch.ones_like(d)
    return torch.where(mode == 1, e1,
                       torch.where(mode == 2, e2,
                                   torch.where(mode == 3, lin, one)))


def light_row_from_params(
    type: int, diffuse, specular_flag: bool, ambient, position, direction,
    range: float, falloff: float, att0: float, att1: float, att2: float,
    inner_angle: float, outer_angle: float, power: float = 1.0,
    active: bool = True,
):
    """Host helper: build one light row with the reference's Setup semantics
    (power scaling + specular-flag handling, src/CKLight.cpp:620-655)."""
    diffuse = np.asarray(diffuse, np.float32)
    scaled = diffuse.copy()
    if power != 1.0:
        scaled = scaled * np.float32(power)
    if specular_flag:
        spec = np.array([diffuse[0] * power, diffuse[1] * power,
                         diffuse[2] * power, 1.0], np.float32)
    else:
        spec = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    # Non-directional lights with ~zero attenuation sum are dropped.
    if type != int(VXLIGHT.DIREC) and (att0 + att1 + att2) < 1e-5:
        active = False
    return dict(
        type=np.int32(type),
        diffuse=scaled,
        specular=spec,
        ambient=np.asarray(ambient, np.float32),
        position=np.asarray(position, np.float32),
        direction=np.asarray(direction, np.float32),
        range=np.float32(range),
        falloff=np.float32(falloff),
        attenuation=np.asarray([att0, att1, att2], np.float32),
        cos_theta=np.float32(np.cos(inner_angle * 0.5)),
        cos_phi=np.float32(np.cos(outer_angle * 0.5)),
        active=bool(active),
    )
