"""The one-frame device program: scene state -> framebuffer, in torch.

The counterpart of ``ckrenderengine_tpu.pipeline.frame``: instead of walking
a pointer tree and issuing thousands of stateful draw calls
(CKRenderedScene::Draw -> RCKMesh::Render -> DrawPrimitive,
src/CKRenderedScene.cpp:152-355), the whole scene is flat device tensors and
one eager pass does

    unpack -> animate -> compose transforms -> skin -> 3D sprite corners
    -> compact culled chunks -> background 2D quads -> transform + light
    -> assemble + set up triangles -> visibility solve (CUDA B1 or B2)
    -> deferred shade -> ordered pass (render_pass*, CUDA B3 or B4)
    -> stencil pass (B2 or B1 on the stencil-only triangles)
    -> line pass (CUDA L1) -> foreground 2D quads (overlay.composite_quads)
    -> Antialias resolve (2x2 box: fb mean, zb min, sb max)

The solve dispatch is the reference's, minus the TPU lane rule: the tiled
solve (B1) when ``t > 4096`` or ``t*H*W > 2^26``, else the flat solve (B2)
when there is no kept z-buffer and no user clip plane, else B1. The shade
dispatch is the reference's accelerator branch, on the card and on the CPU
alike: a frame of the tiled size shades from per-pixel winner ROWS —
quantized rows with B1's exported edge values, or compact rows when a mip
frame has an odd size — and a smaller frame through ``shade_deferred``,
whichever solve it took. With the environment
variable ``CK_FUSED_FETCH`` set, kernel B5 fetches the quantized rows inside
the solve (same frame, bit for bit). The ordered
pass composites the non-deferred triangles in sorted draw order
(:func:`ordered_subset`): the exact flat pass below ``ordered_cap*H*W <=
2^26``; above it the affine blend kernel B3 for untextured alpha-over, the
textured peel B4 (TexturedPeel) with the quantized layer shade, else the
exact tiled pass. A kernel's phase-A overflow replays the exact tiled pass
inside the frame (``OrderedReplays``). CPU tensors take the same branches
through the kernels' plain versions. Given ``flags``, the frame decides on
the device and reads nothing back (what ``pipeline/window.py`` captures
into a CUDA graph); see :func:`render_frame_impl`. Features outside the ported slices
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..math import vxmath as vx
from ..raster import deferred as df
from ..raster import torch_backend as rb
from ..raster.cuda_reduce import depth_reduce_cuda
from ..raster.cuda_tiled import depth_reduce_tiled_cuda
from ..raster.deferred import take_small
from ..raster.stage import call_stage
from ..raster.types import (
    SF_BUMP_SCALE, SI_ALPHABLEND, SI_STENCIL, SI_TEX2, SI_TEXGEN,
    TEXGEN_CHROME, TEXGEN_CUBE, TEXGEN_PLANAR, TEXGEN_REFLECT,
    VXTEXTURE_ADDRESS, VXTEXTURE_FILTER,
)
from ..scene.entity_table import compose_world
from .lighting import LightArray, MaterialLighting, compute_vertex_lighting, fog_factor
from .overlay import QuadBank, Sprite3DBank, apply_billboards, composite_quads
from .packing import has_field, unpack


class SceneDevice(NamedTuple):
    """Dynamic per-frame scene state (device tensors)."""

    # Entity state
    local: torch.Tensor          # (N,4,4) local transforms
    parent: torch.Tensor         # (N,) int32
    entity_visible: torch.Tensor  # (N,) bool
    entity_clip: torch.Tensor    # (N,4) per-entity scissor rect (Place clips)
    entity_priority: torch.Tensor  # (N,) f32 render priority

    # Mesh vertex pool (shared, unique geometry)
    positions: torch.Tensor      # (V,3)
    normals: torch.Tensor        # (V,3)
    uv: torch.Tensor             # (V,2)
    prelit: torch.Tensor         # (V,4) prelit diffuse
    prelit_spec: torch.Tensor    # (V,3) prelit specular

    # Instanced vertex stream (entity x material-group duplication)
    src_idx: torch.Tensor        # (IV,) int32 into pool
    vert_entity: torch.Tensor    # (IV,) int32
    vert_state: torch.Tensor     # (IV,) int32 state/material bucket
    vert_lit: torch.Tensor       # (IV,) bool lit (vs prelit)

    # Triangle stream
    tri_idx: torch.Tensor        # (IT,3) int32 into instanced stream
    tri_state: torch.Tensor      # (IT,) int32
    tri_valid: torch.Tensor      # (IT,) bool

    # Material / render-state bank (S rows)
    state_i: torch.Tensor        # (S, NUM_SI) int32
    state_f: torch.Tensor        # (S, NUM_SF) f32
    mat_diffuse: torch.Tensor    # (S,4)
    mat_ambient: torch.Tensor    # (S,4)
    mat_specular: torch.Tensor   # (S,4)
    mat_emissive: torch.Tensor   # (S,4)
    mat_power: torch.Tensor      # (S,)

    # Lights + global lighting state
    lights: LightArray
    global_ambient: torch.Tensor  # (4,)

    # Camera
    view: torch.Tensor           # (4,4)
    proj: torch.Tensor           # (4,4)
    cam_pos: torch.Tensor        # (3,) world-space eye
    viewport: torch.Tensor       # (4,) f32 [x,y,w,h]

    # Fog
    fog_mode: torch.Tensor       # () int32 VXFOG
    fog_start: torch.Tensor      # ()
    fog_end: torch.Tensor        # ()
    fog_density: torch.Tensor    # ()
    fog_color: torch.Tensor      # (3,)

    # Textures
    tex_planes: torch.Tensor     # (NT,4,TH,TW)
    tex_hw: torch.Tensor         # (NT,2..5) int32

    # Clear
    clear_color: torch.Tensor    # (4,)
    clear_z: torch.Tensor        # ()

    # User clip planes (world-space plane equations; a point p is kept when
    # dot((p,1), plane) >= 0). None = none active.
    clip_planes: torch.Tensor | None = None   # (P,4)

    # Fog projection mode 0/1/2 (reference g_FogProjectionMode). None = 0.
    fog_proj: torch.Tensor | None = None      # () int32

    # Quad-texel table for one-gather bilinear sampling.
    tex_quad: torch.Tensor | None = None      # (NT*TH*TAW, 16)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with the reference's ``jnp.take`` index handling: a
    negative index counts from the end, and every index is clamped into
    range (an out-of-range CUDA gather is a fatal device assert). Padding
    triangles after chunk compaction carry such indices; they are invalid,
    so only finiteness matters for them."""
    n = a.shape[0]
    idx = idx.long()
    idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, max(n - 1, 0))
    return a.index_select(0, idx)


def transform_and_light(scene: SceneDevice, levels: tuple, world=None,
                        vertex_shader=None, want_bump: bool = False,
                        want_cube: bool = False,
                        corner: tuple = (0, 0, 0),
                        want_texgen: bool = False,
                        want_prelit: bool = True):
    """Vertex stage: world compose -> gather -> transform -> light -> project.

    The material effects are gated statically, as in the reference: with
    ``want_texgen`` or ``want_cube`` each row's UV is replaced by its
    state's TexGen mode (planar, sphere reflection, chrome, cube); with
    ``want_bump`` the EMBM offset from the bump texture (slot ``SI_TEX2``)
    is added per vertex; with ``want_cube`` the world reflection vector of
    every TEXGEN_CUBE row is exported (``refl_v``, zero elsewhere) for the
    shade's per-pixel cube UV. A scene without them runs none of it.

    ``vertex_shader``: an optional user stage ``fn(posw, nrmw, scene) ->
    (posw', nrmw')`` over every stream row's world-space position and
    normal (``raster/stage.py``), called after the world transform and
    before the normals are renormalised, lit, TexGen'd and projected.

    Returns (clip (IV,4), color (IV,4), spec (IV,3), fog (IV,), world
    (N,4,4), uv (IV,2), clipd_v (IV,P) | None, refl_v (IV,3) | None)."""
    if world is None:
        world = compose_world(scene.local, scene.parent, levels)
    # Row N = identity: world-space vertex sources bind here.
    world_ext = torch.cat([world, torch.eye(4, dtype=world.dtype,
                                            device=world.device)[None]])
    wm = take_small(world_ext, scene.vert_entity)                # (IV,4,4)

    # Corner-major fast path: the first ``nc`` stream rows alias the dense
    # corner-expanded pool block at [p0, p0+nc) — a slice, not a gather;
    # only the tail still gathers through src_idx.
    nc, _itc, p0 = corner

    def take_pool(a):
        if not nc:
            return _take(a, scene.src_idx)
        return torch.cat([a[p0:p0 + nc], _take(a, scene.src_idx[nc:])])

    pool_cat = torch.cat([scene.positions, scene.normals, scene.uv], dim=1)
    cat = take_pool(pool_cat)                                    # (IV,8)
    pos = cat[:, 0:3]
    nrm = cat[:, 3:6]
    uv_pool = cat[:, 6:8]

    posw = vx.transform_points(pos, wm)
    nrmw = vx.transform_vectors(nrm, wm)
    if vertex_shader is not None:
        posw, nrmw = call_stage(vertex_shader, posw, nrmw, scene,
                                device=posw.device)
    nrmw = nrmw / torch.clamp(torch.linalg.vector_norm(nrmw, dim=-1,
                                                       keepdim=True),
                              min=1e-12)

    viewproj = torch.matmul(scene.view, scene.proj)
    posw4 = torch.cat([posw, torch.ones_like(posw[:, :1])], dim=-1)
    clip = vx.transform_h4(posw4, viewproj)
    cam_z = vx.transform_h4(posw4, scene.view)[..., 2]

    mat_cat = torch.cat(
        [scene.mat_diffuse, scene.mat_ambient, scene.mat_specular,
         scene.mat_emissive, scene.mat_power[:, None]], dim=1)   # (S, 17)
    mrow = take_small(mat_cat, scene.vert_state)
    mat = MaterialLighting(
        diffuse=mrow[:, 0:4], ambient=mrow[:, 4:8], specular=mrow[:, 8:12],
        emissive=mrow[:, 12:16], power=mrow[:, 16])
    lit_diffuse, lit_spec = compute_vertex_lighting(
        posw, nrmw, mat, scene.lights, scene.global_ambient, scene.cam_pos)

    if want_prelit:
        lit = scene.vert_lit[:, None]
        color = torch.where(lit, lit_diffuse, take_pool(scene.prelit))
        spec = torch.where(lit, lit_spec, take_pool(scene.prelit_spec))
    else:
        color, spec = lit_diffuse, lit_spec
    if scene.fog_proj is None:
        fog = fog_factor(cam_z, scene.fog_mode, scene.fog_start,
                         scene.fog_end, scene.fog_density)
    else:
        # Fog projection modes (reference CKRenderedScene.cpp:405-425):
        # mode 0 fogs view-space z against (fog_start, fog_end); modes 1/2
        # fog projected depth z/w against start/end pushed through the
        # projection matrix.
        p = scene.proj
        sz = p[2, 2] * scene.fog_start + p[3, 2]
        sw = p[2, 3] * scene.fog_start + p[3, 3]
        ez = p[2, 2] * scene.fog_end + p[3, 2]
        ew = p[2, 3] * scene.fog_end + p[3, 3]

        def sdiv(a, b):
            return a / torch.where(torch.abs(b) < 1e-30, 1e-30, b)

        proj_start = sdiv(sz, sw)
        proj_end = sdiv(ez, ew)
        recip_sw = sdiv(torch.ones_like(sw), sw)
        mode = scene.fog_proj
        fstart = torch.where(mode == 1, proj_start,
                             torch.where(mode == 2, recip_sw,
                                         scene.fog_start))
        fend = torch.where(mode == 1, proj_end,
                           torch.where(mode == 2, proj_start, scene.fog_end))
        zndc = sdiv(clip[..., 2], clip[..., 3])
        coord = torch.where(mode > 0, zndc, cam_z)
        fog = fog_factor(coord, scene.fog_mode, fstart, fend,
                         scene.fog_density)

    uv = uv_pool
    rw = texgen = None
    if want_texgen or want_cube:
        # TexGen (reference TexGenEffect, src/CKMaterial.cpp:1456+): planar
        # from the view-space position, sphere-env from the view-space
        # reflection vector or normal, cube-env from the octahedral code
        # of the WORLD-space reflection vector.
        texgen = take_small(scene.state_i[:, SI_TEXGEN], scene.vert_state)
        pos_v = vx.transform_points(posw, scene.view)
        nrm_v = vx.transform_vectors(nrmw, scene.view)
        nrm_v = nrm_v / torch.clamp(torch.linalg.vector_norm(
            nrm_v, dim=-1, keepdim=True), min=1e-12)
        d = pos_v / torch.clamp(torch.linalg.vector_norm(
            pos_v, dim=-1, keepdim=True), min=1e-12)
        r = d - 2.0 * _sum3(d * nrm_v) * nrm_v
        m = 2.0 * torch.sqrt(torch.clamp(
            r[..., 0] ** 2 + r[..., 1] ** 2 + (r[..., 2] + 1.0) ** 2,
            min=1e-12))
        uv_reflect = torch.stack([r[..., 0] / m + 0.5,
                                  -r[..., 1] / m + 0.5], -1)
        uv_chrome = torch.stack([nrm_v[..., 0] * 0.5 + 0.5,
                                 -nrm_v[..., 1] * 0.5 + 0.5], -1)
        uv_planar = pos_v[..., :2]
        dw = posw - scene.cam_pos[None, :]
        dw = dw / torch.clamp(torch.linalg.vector_norm(
            dw, dim=-1, keepdim=True), min=1e-12)
        rw = dw - 2.0 * _sum3(dw * nrmw) * nrmw
        uv_cube = vx.oct_encode(rw)
        tg = texgen[:, None]
        uv = torch.where(tg == TEXGEN_PLANAR, uv_planar, uv)
        uv = torch.where(tg == TEXGEN_REFLECT, uv_reflect, uv)
        uv = torch.where(tg == TEXGEN_CHROME, uv_chrome, uv)
        uv = torch.where(tg == TEXGEN_CUBE, uv_cube, uv)
    if want_bump and scene.tex_planes.shape[0] > 0:
        # Per-vertex EMBM (VXEFFECT_BUMPENV, reference BumpMapEnvEffect,
        # src/CKMaterial.cpp:1668+): the bump texture's (r, g) at the mesh
        # UV, scaled by the bump scale, offsets the generated env UV. The
        # reference evaluates it per vertex, and so does this stage.
        tex2 = take_small(scene.state_i[:, SI_TEX2], scene.vert_state)
        bscale = take_small(scene.state_f[:, SF_BUMP_SCALE],
                            scene.vert_state)
        zero = torch.zeros((), dtype=torch.float32, device=uv.device)
        texel = df.sample_texture_pp(
            scene.tex_planes, scene.tex_hw, torch.clamp(tex2, min=0),
            uv_pool[..., 0], uv_pool[..., 1],
            torch.full_like(tex2, int(VXTEXTURE_ADDRESS.WRAP)),
            torch.full_like(tex2, int(VXTEXTURE_FILTER.LINEAR)),
            [zero] * 4)
        duv = torch.stack([(texel[0] - 0.5) * bscale,
                           (texel[1] - 0.5) * bscale], -1)
        uv = torch.where((tex2 >= 0)[:, None], uv + duv, uv)
    # User clip planes: per-vertex signed world-space distances.
    clipd_v = None
    if scene.clip_planes is not None and scene.clip_planes.shape[0] > 0:
        clipd_v = posw4 @ scene.clip_planes.T                    # (IV,P)
    # Cube env per pixel: the shade interpolates the corners' world
    # reflection vectors and oct-encodes each pixel's.
    refl_v = None
    if want_cube and rw is not None:
        refl_v = torch.where((texgen == TEXGEN_CUBE)[:, None], rw,
                             torch.zeros_like(rw))
    return clip, color, spec, fog, world, uv, clipd_v, refl_v


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1): the three components added left to right."""
    return a[..., 0:1] + a[..., 1:2] + a[..., 2:3]


def compact_scene_chunks(scene: SceneDevice, chunk_idx, chunk_n,
                         corner: tuple, chunk: tuple):
    """Compact the corner-major head to the host-selected chunk list.

    The host culls CH-triangle chunks of the static corner block against the
    frustum each frame (the reference's hierarchical-bbox scene-graph
    culling, src/CKSceneGraph.cpp:849-888) and ships the surviving chunk
    indices; whole (CH, C) blocks move along the chunk axis. Culled chunks
    are fully outside the frustum, so output is identical; pad slots beyond
    ``chunk_n`` mask their triangles invalid.

    ``chunk`` = (CH, cap, itc, n_full); ``chunk_idx`` (cap,) ascending
    survivor list; ``chunk_n`` () live count. Returns (scene', corner')."""
    CH, cap, itc, n_full = chunk
    nc = 3 * itc
    p0 = corner[2]
    dev = scene.src_idx.device
    safe = torch.clamp(chunk_idx, 0, n_full - 1).long()
    live = torch.arange(cap, device=dev) < chunk_n
    rem = itc - n_full * CH
    itc2 = cap * CH + rem
    nc2 = 3 * itc2

    def chunk_take(a, base, stride):
        parts = []
        for k in range(3):
            b0 = base + k * stride
            blk = a[b0:b0 + n_full * CH].reshape((n_full, CH) + a.shape[1:])
            sel = blk.index_select(0, safe).reshape((cap * CH,) + a.shape[1:])
            if rem:
                sel = torch.cat([sel, a[b0 + n_full * CH:b0 + stride]])
            parts.append(sel)
        return torch.cat(parts)

    def pool2(a):
        # new pool = [compacted corner head, whole old pool]
        return torch.cat([chunk_take(a, p0, itc), a])

    def stream2(a):
        return torch.cat([chunk_take(a, 0, itc), a[nc:]])

    def tri2(a):
        blk = a[:n_full * CH].reshape((n_full, CH) + a.shape[1:])
        sel = blk.index_select(0, safe).reshape((cap * CH,) + a.shape[1:])
        if rem:
            sel = torch.cat([sel, a[n_full * CH:itc]])
        return torch.cat([sel, a[itc:]])

    src_idx = torch.cat([torch.arange(nc2, dtype=torch.int32, device=dev),
                         scene.src_idx[nc:] + nc2])
    tri_valid = tri2(scene.tri_valid)
    slot_live = torch.repeat_interleave(live, CH)
    tri_valid = torch.cat([tri_valid[:cap * CH] & slot_live,
                           tri_valid[cap * CH:]])
    ar = torch.arange(itc2, dtype=torch.int32, device=dev)
    tidx_head = torch.stack([ar, itc2 + ar, 2 * itc2 + ar], dim=1)
    tidx_tail = scene.tri_idx[itc:] + (nc2 - nc)
    scene2 = scene._replace(
        positions=pool2(scene.positions), normals=pool2(scene.normals),
        uv=pool2(scene.uv), prelit=pool2(scene.prelit),
        prelit_spec=pool2(scene.prelit_spec),
        src_idx=src_idx, vert_entity=stream2(scene.vert_entity),
        vert_state=stream2(scene.vert_state),
        vert_lit=stream2(scene.vert_lit),
        tri_idx=torch.cat([tidx_head, tidx_tail]),
        tri_state=tri2(scene.tri_state), tri_valid=tri_valid)
    return scene2, (nc2, itc2, 0)


def assemble_triangles(scene: SceneDevice, clip, color, spec, fog, uv=None,
                       clipd_v=None, refl_v=None, corner: tuple = (0, 0, 0)):
    """Triangle stage: gather per-corner attributes + whole-triangle cull.

    Returns the DeviceBatch in stream (priority) order. ``corner`` =
    (nc, itc, p0): the first ``itc`` triangles read the first ``nc = 3*itc``
    stream rows in corner-major order (rows [k*itc, (k+1)*itc) hold corner k
    of every head triangle), so their per-corner data is a slice; only the
    tail pays the per-corner gathers. ``refl_v`` (IV,3), the world
    reflection vectors of a cube-env frame, rides the same wide row into
    the batch's ``refl`` (IT,3,3); without it ``refl`` is (IT,3,0)."""
    _nc, itc, _p0 = corner
    i0, i1, i2 = scene.tri_idx[:, 0], scene.tri_idx[:, 1], scene.tri_idx[:, 2]

    def corner_planar(a):
        """(IV, ...) per-stream-row tensor -> 3 x (IT, ...) per-corner."""
        if not itc:
            return (_take(a, i0), _take(a, i1), _take(a, i2))
        return tuple(torch.cat([a[k * itc:(k + 1) * itc], _take(a, idx[itc:])])
                     for k, idx in enumerate((i0, i1, i2)))

    def first_corner_take(a):
        if not itc:
            return _take(a, i0)
        return torch.cat([a[:itc], _take(a, i0[itc:])])

    flags = vx.clip_flags(clip)
    # Whole-triangle rejection: all three corners outside one plane (the
    # AND-reduction of CKRasterizerContext::TransformVertices,
    # CKRasterizerLib/CKRasterizerContext.cpp:339-392, per triangle).
    fl0, fl1, fl2 = corner_planar(flags)
    reject = (fl0 & fl1 & fl2) != 0
    vis_ext = torch.cat([scene.entity_visible,
                         torch.ones(1, dtype=torch.bool,
                                    device=scene.entity_visible.device)])
    tri_ent = first_corner_take(scene.vert_entity)
    ent_vis = take_small(vis_ext, tri_ent)
    valid = scene.tri_valid & ~reject & ent_vis
    it = scene.tri_idx.shape[0]
    if clipd_v is not None:
        d0, d1, d2 = corner_planar(clipd_v)
        valid = valid & ~torch.any((d0 < 0) & (d1 < 0) & (d2 < 0), dim=1)
        clipd = torch.stack([d0, d1, d2], dim=1)
    else:
        clipd = torch.zeros((it, 3, 0), dtype=torch.float32,
                            device=clip.device)

    # Screen-homogeneous coords (raster/types.py convention).
    vxp, vyp, vw_, vh_ = (scene.viewport[0], scene.viewport[1],
                          scene.viewport[2], scene.viewport[3])
    half_w = vw_ * 0.5
    half_h = vh_ * 0.5
    cx = vxp + half_w
    cy = vyp + half_h
    x, y, z, w = clip[:, 0], clip[:, 1], clip[:, 2], clip[:, 3]
    sx = cx * w + x * half_w
    sy = cy * w - y * half_h

    # Per-triangle scissor from the owning entity; identity row N gets the
    # open rect.
    open_rect = df.open_rect(1, clip.device)
    tri_rect = take_small(torch.cat([scene.entity_clip, open_rect]), tri_ent)

    if uv is None:
        uv = _take(scene.uv, scene.src_idx)
    # One wide row per vertex, gathered once per corner.
    vparts = [torch.stack([sx, sy, w], dim=-1), z[:, None], color, spec, uv,
              fog[:, None]]
    n_refl = 3 if refl_v is not None else 0
    if n_refl:
        vparts.append(refl_v)
    vrow = torch.cat(vparts, dim=-1)                             # (IV, 14+R)
    cp = corner_planar(vrow)

    def stack3(sl):
        return torch.stack([c[:, sl] for c in cp], dim=1)

    return rb.DeviceBatch(
        xyw=stack3(slice(0, 3)), z=stack3(3),
        color=stack3(slice(4, 8)), specular=stack3(slice(8, 11)),
        uv=stack3(slice(11, 13)), fog=stack3(13),
        state_idx=scene.tri_state, valid=valid, clip_rect=tri_rect,
        clipd=clipd, refl=stack3(slice(14, 14 + n_refl)))


def opaque_setup(scene: SceneDevice, levels: tuple, world=None,
                 vertex_shader=None, want_bump: bool = False,
                 want_cube: bool = False, corner: tuple = (0, 0, 0),
                 want_texgen: bool = False, sampler_profile=None):
    """Vertex stage + triangle assembly + triangle setup: the inputs of the
    visibility solve. Returns (batch, setup, defer_tri)."""
    want_prelit = (sampler_profile is None or len(sampler_profile) < 8
                   or bool(sampler_profile[7]))
    clip, color, spec, fog, _world, uv, clipd_v, refl_v = transform_and_light(
        scene, levels, world, vertex_shader=vertex_shader,
        want_bump=want_bump, want_cube=want_cube, corner=corner,
        want_texgen=want_texgen, want_prelit=want_prelit)
    batch = assemble_triangles(scene, clip, color, spec, fog, uv, clipd_v,
                               refl_v, corner=corner)
    # One small-table row per triangle for the deferred-eligibility bit.
    bucket_tbl = torch.stack(
        [df.deferred_mask(scene.state_i).to(torch.float32),
         (scene.state_i[:, SI_ALPHABLEND] != 0).to(torch.float32),
         (scene.state_i[:, SI_STENCIL] != 0).to(torch.float32)], dim=1)
    tri_bits = take_small(bucket_tbl, batch.state_idx)           # (IT,3)
    defer_tri = (tri_bits[:, 0] > 0.5) & batch.valid
    setup = df.triangle_setup(batch.xyw, batch.z, batch.state_idx,
                              batch.valid, scene.state_i,
                              clip_rect=batch.clip_rect, clipd=batch.clipd)
    return batch, setup, defer_tri, tri_bits


def ordered_subset(batch: rb.DeviceBatch, defer_tri: torch.Tensor,
                   transparent: torch.Tensor, ordered_cap: int,
                   tri_priority=None) -> rb.DeviceBatch:
    """Compact the non-deferred triangles into an ``ordered_cap``-slot
    stream: cutouts and z-overrides first in stream (priority) order, then
    transparent triangles back to front — higher priority renders first,
    and within a priority band farther triangles render first (the device
    analogue of CKSceneGraphRootNode::SortTransparentObjects,
    src/CKSceneGraph.cpp:618-752).

    ``transparent``: (IT,) bool, alpha-blend triangles (depth-sorted).
    ``tri_priority``: optional (IT,) f32 entity render priority.
    The sort key is the mean of the corners' z/w, summed corner by corner
    and divided by 3 (the reference frame's arithmetic); both sorts are
    stable."""
    it = batch.valid.shape[0]
    dev = batch.valid.device
    ordered = batch.valid & ~defer_tri
    w_ = batch.xyw[..., 2]
    zw = batch.z / torch.where(torch.abs(w_) < 1e-12, 1e-12, w_)
    depth_mean = (zw[:, 0] + zw[:, 1] + zw[:, 2]) / 3.0

    arange = torch.arange(it, device=dev)
    big = 3.0e38
    o_key = torch.where(ordered & ~transparent, arange.to(torch.float32),
                        big)
    o_perm = torch.argsort(o_key, stable=True)
    depth01 = torch.clamp(depth_mean, 0.0, 1.0)
    # Priority bands (integers, scaled past the [0,1] depth term) primary,
    # back-to-front depth secondary.
    sort_val = -depth01
    if tri_priority is not None:
        sort_val = -tri_priority * 4.0 - depth01
    t_key = torch.where(ordered & transparent, sort_val, big)
    t_perm = torch.argsort(t_key, stable=True)
    n_first = (ordered & ~transparent).sum()
    slot = torch.arange(ordered_cap, device=dev)
    t_slot = torch.clamp(slot - n_first, 0, it - 1)
    perm = torch.where(slot < n_first, o_perm[torch.clamp(slot, 0, it - 1)],
                       t_perm[t_slot])
    sel_valid = (slot < ordered.sum()) & ordered[perm]
    return rb.DeviceBatch(*(sel_valid if name == "valid" else a[perm]
                            for name, a in zip(rb.DeviceBatch._fields,
                                               batch)))


def _composite_peeled(fb, obatch: rb.DeviceBatch, lids, les, scene,
                      sampler_profile, height: int, width: int,
                      row0: int = 0, quad: bool | None = None):
    """Shade and blend peeled ordered layers (draw order per pixel).

    ``lids``/``les``: one peel round's outputs — per layer the covering
    draw's index and raw edge values. Each layer shades ONCE per pixel
    through the quantized rows (texture sampling included), then composites
    with the draw's blend mode (alpha-over / replace) after its alpha test:
    the semantics of the sequential pass, as K dense passes. ``row0`` and
    ``quad``: a band's first global row and the whole frame's LOD rule
    (:func:`df.shade_rows`)."""
    from ..raster.types import (
        SF_ALPHAREF, SI_ALPHABLEND, SI_ALPHAFUNC, SI_ALPHATEST,
    )

    refl = obatch.refl if obatch.refl.shape[-1] else None
    all_persp = (sampler_profile is not None and len(sampler_profile) > 3
                 and bool(sampler_profile[3]))
    inv_det_s = None
    if not all_persp:
        v0, v1, v2 = obatch.xyw[:, 0], obatch.xyw[:, 1], obatch.xyw[:, 2]
        det = torch.sum(v0 * torch.linalg.cross(v1, v2), dim=-1)
        inv_det_s = 1.0 / torch.clamp(torch.abs(det), min=1e-30)
    tbl = df.shade_row_table_quant(
        obatch.xyw, obatch.color, obatch.specular, obatch.uv, obatch.fog,
        obatch.state_idx, batch_refl=refl, inv_det_s=inv_det_s,
        want_ws=not all_persp)
    st4 = torch.stack([
        (scene.state_i[:, SI_ALPHABLEND] != 0).to(torch.float32),
        scene.state_i[:, SI_ALPHAFUNC].to(torch.float32),
        scene.state_f[:, SF_ALPHAREF],
        (scene.state_i[:, SI_ALPHATEST] != 0).to(torch.float32)], dim=1)
    zeros = torch.zeros((4, height, width), dtype=torch.float32,
                        device=fb.device)
    for s in range(lids.shape[0]):
        hit = lids[s] >= 0
        rows_q = df.gather_winner_rows(tbl, lids[s])
        full = df.expand_rows_quant(rows_q, scene.state_i, scene.state_f,
                                    scene.tex_hw, want_ws=not all_persp,
                                    has_refl=refl is not None)
        src = df.shade_rows(full, hit, scene.tex_planes, scene.tex_hw,
                            scene.fog_color, zeros, height, width,
                            sampler_profile=sampler_profile,
                            tex_quad=scene.tex_quad,
                            eplanes=(les[s, 0], les[s, 1], les[s, 2]),
                            row0=row0, quad=quad)
        stidx = torch.clamp(rows_q[df.SH_Q_STIDX].reshape(-1).long(), 0,
                            st4.shape[0] - 1)
        stp = st4.index_select(0, stidx).T.reshape(4, height, width)
        blend_on = stp[0] != 0
        sa = src[3]
        at_ok = rb.compare_op(stp[1].to(torch.int32), sa, stp[2])
        keep = hit & (at_ok | ~(stp[3] != 0))
        # shade_rows zeroed colorwrite-off pixels through its hit mask; the
        # peel kernel already drops colorwrite-off rows.
        a = torch.where(keep, torch.where(blend_on, 1.0 - sa, 0.0), 1.0)
        b = torch.where(keep[None],
                        torch.where(blend_on[None], src * sa[None], src), 0.0)
        fb = a[None] * fb + b
    return fb


def _solve_caps(t_count: int, solve_caps) -> dict:
    """Static caps of the tiled solve: the reference's t_count heuristic
    (frame.py:824-826), or an explicit (pair_cap, slab_cap, g_cap)."""
    if solve_caps is not None:
        return dict(pair_cap=solve_caps[0], slab_cap=solve_caps[1],
                    g_cap=solve_caps[2])
    return dict(pair_cap=98304 if t_count <= 600_000 else 262144,
                slab_cap=131072 if t_count <= (1 << 21) else 262144)


def render_frame_impl(scene: SceneDevice, levels: tuple, height: int,
                      width: int, ordered_cap: int | None = None,
                      world=None, background=None,
                      sort_transparent: bool = True,
                      want_stencil: bool = False,
                      vertex_shader=None, pixel_shader=None,
                      want_bump: bool = False, want_cube: bool = False,
                      want_stats: bool = False, sampler_profile=None,
                      prev_fb=None, prev_zb=None,
                      corner: tuple = (0, 0, 0),
                      want_texgen: bool = False,
                      solve_caps: tuple | None = None,
                      host_stats: dict | None = None,
                      flags: dict | None = None, peel_rounds: int = 1,
                      row0: int = 0, frame_h: int | None = None):
    """Full frame: clear -> vertex stage -> deferred opaque solve + shade
    -> the ordered rest (cutouts, z-overrides, sorted transparency).

    ``row0`` / ``frame_h``: a band of a frame of ``frame_h`` rows (default
    ``height``), its ``height`` rows starting at global row ``row0``
    (reference frame.py:693-699, parallel/tile_shard.py). Vertices,
    viewport and scissors stay in global screen coordinates and every
    raster stage evaluates global pixel centres, so the band equals the
    same rows of the whole frame bit for bit. Every route (tiled or flat
    solve, quantized or compact rows, the quad LOD, the ordered pass and
    its tile, the ordered kernels' capacities) is decided from the whole
    frame, never from the band: a band then runs the whole frame's
    arithmetic. A band of a quad-LOD frame starts and ends on even rows.

    ``prev_fb``/``prev_zb``: last frame's buffers when the clear flags are
    off (reference RCKRenderContext::Clear, src/CKRenderContext.cpp:438-544):
    rendering then accumulates over the previous frame. ``ordered_cap``:
    static upper bound on the triangles the ordered pass takes (None = all
    triangles, 0 = no ordered pass). ``host_stats``: a dict that receives
    the frame's host counters whatever ``want_stats`` says: the ordered
    pass's (OrderedPeelOverflow, OrderedPeelRounds, OrderedPeelCorrected,
    OrderedReplays) and, when the tiled solve ran, its 7-word bin
    statistics ``SolveBinStats`` as the list its remainder decision read.

    ``flags``: a dict that makes the frame device-decided. It then reads
    nothing back to the host, so that it can be captured into a CUDA
    graph: the tiled solves run no remainder, B3's composite is always
    taken and the peel runs exactly ``peel_rounds`` rounds. Each decision
    that a host read would have made goes into ``flags`` as a device
    tensor: ``SolveBinStats`` (7,) int32 of the main solve (when it is
    tiled), and 0-d bools ``StencilRemainder``, ``OrderedReplay``,
    ``PeelBad`` and ``PeelMore`` (where those passes run). The frame is
    exact when every flag is false and ``SolveBinStats[2:5]`` is zero;
    otherwise the caller renders it again without ``flags``.

    ``want_stencil``: also solve the stencil-only triangles
    (VX_MOVEABLE_STENCILONLY) against the finished zb and return their
    z-tested coverage ``sb`` (:func:`stencil_pass`).

    Returns (fb (4,H,W) f32, zb (H,W) f32[, sb (H,W) uint8][, stats
    dict])."""
    if background is not None:
        clear_fb = background
    elif prev_fb is not None:
        clear_fb = prev_fb
    else:
        clear_fb = scene.clear_color[:, None, None].to(
            torch.float32).expand(4, height, width)
    z_init = scene.clear_z if prev_zb is None else prev_zb
    fh = height if frame_h is None else frame_h

    batch, setup, defer_tri, tri_bits = opaque_setup(
        scene, levels, world, vertex_shader=vertex_shader,
        want_bump=want_bump, want_cube=want_cube, corner=corner,
        want_texgen=want_texgen, sampler_profile=sampler_profile)
    t_count = batch.valid.shape[0]
    # A mip frame of even size takes its LOD from 2x2 quads (the whole
    # frame's size decides, so that a band shades as the frame does).
    quad = fh % 2 == 0 and width % 2 == 0
    tiled = t_count > 4096 or t_count * fh * width > (1 << 26)
    flat = not tiled and prev_zb is None and batch.clipd.shape[-1] == 0
    sp = sampler_profile
    batch_args = (batch.xyw, batch.color, batch.specular, batch.uv,
                  batch.fog, batch.state_idx)
    shade_args = (scene.tex_planes, scene.tex_hw, scene.fog_color, clear_fb,
                  height, width)

    decided = flags is not None

    def solve_tiled(**kw):
        out = depth_reduce_tiled_cuda(
            setup, defer_tri, z_init, scene.viewport, batch.xyw, height,
            width, want_binstats=want_stats or decided,
            host_stats=host_stats, remainder=not decided, row0=row0,
            **_solve_caps(t_count, solve_caps), **kw)
        if decided:
            flags["SolveBinStats"] = out[2]
        return out

    tile_peak = None
    if not tiled or pixel_shader is not None:
        # Every frame below the tiled size, as in the reference, and every
        # pixel-shader frame: one full-width row gather per pixel inside
        # shade_deferred, from f32 vertex colours. The flat solve (B2) has
        # no initial depth plane and no clip planes, so a small frame that
        # keeps its depth or clips solves with B1.
        if flat:
            best_id, best_depth = depth_reduce_cuda(
                setup, defer_tri, scene.clear_z, scene.viewport, height,
                width, row0=row0)
        else:
            best_id, best_depth, tile_peak = solve_tiled()
        fb = df.shade_deferred(
            best_id, batch.xyw, batch.z, *batch_args[1:], scene.state_i,
            scene.state_f, *shade_args, batch_refl=batch.refl,
            pixel_shader=pixel_shader, sampler_profile=sp,
            tex_quad=scene.tex_quad, row0=row0)
    elif sp is not None and (not sp[1] or quad):
        # Quantized rows: colours, speculars and fog as u8 words (the
        # reference's D3DCOLOR vertex precision) and no edge coefficients;
        # B1 exports the winner's (e0, e1, e2) per pixel instead. A mip
        # frame of even size takes its LOD from 2x2-quad differences.
        want_ws = not (len(sp) > 3 and bool(sp[3]))
        tbl = df.shade_row_table_quant(
            *batch_args, batch_refl=batch.refl,
            inv_det_s=setup["inv_det_s"], want_ws=want_ws)
        # CK_FUSED_FETCH (off by default, as in the reference): kernel B5
        # fetches the winner rows inside the solve; else a gather after it.
        if os.environ.get("CK_FUSED_FETCH"):
            best_id, best_depth, tile_peak, epl, rows_q = solve_tiled(
                want_eplanes=True, shade_tbl=tbl)
        else:
            best_id, best_depth, tile_peak, epl = solve_tiled(
                want_eplanes=True)
            rows_q = df.gather_winner_rows(tbl, best_id)
        rows = df.expand_rows_quant(rows_q, scene.state_i, scene.state_f,
                                    scene.tex_hw, want_ws=want_ws,
                                    has_refl=batch.refl.shape[-1] > 0)
        fb = df.shade_rows(rows, best_id >= 0, *shade_args,
                           sampler_profile=sp, tex_quad=scene.tex_quad,
                           eplanes=(epl[0], epl[1], epl[2]), row0=row0,
                           quad=quad)
    else:
        # Compact rows (a mip frame of odd size, or no sampler profile):
        # the solve's signed edge coefficients ride the row, so the shade
        # keeps its analytic mip LOD.
        best_id, best_depth, tile_peak = solve_tiled()
        tbl = df.shade_row_table_compact(
            *batch_args, setup["e9"], setup["inv_det_s"],
            batch_refl=batch.refl)
        rows = df.expand_rows_compact(
            df.gather_winner_rows(tbl, best_id), scene.state_i,
            scene.state_f, scene.tex_hw)
        fb = df.shade_rows(rows, best_id >= 0, *shade_args,
                           sampler_profile=sp, tex_quad=scene.tex_quad,
                           row0=row0)
    zb = best_depth
    if ordered_cap is None:
        ordered_cap = t_count
    ordered = dict(OrderedPeelOverflow=False, OrderedPeelRounds=0,
                   OrderedPeelCorrected=0, OrderedReplays=0)
    if ordered_cap > 0:
        fb, zb = _ordered_pass(
            scene, batch, defer_tri, tri_bits, fb, zb, ordered_cap, height,
            width, sort_transparent, pixel_shader, sampler_profile, ordered,
            flags, peel_rounds, row0, fh)
    if host_stats is not None:
        host_stats.update(ordered)
    out = (fb, zb)
    if want_stencil:
        out += (stencil_pass(setup, batch, tri_bits, zb, scene.viewport,
                             height, width, flat, t_count, solve_caps,
                             flags=flags, row0=row0),)
    if not want_stats:
        return out
    # Stats: the reference's counters, the ordered path's (which path the
    # frame took), and the per-pixel winner id map (-1 = background) for
    # parity checks.
    zero = torch.zeros((), dtype=torch.int32, device=fb.device)
    stats = {"TileBinPeak": zero, "WinnerIds": best_id, **ordered}
    if tile_peak is not None:
        stats.update({"TileBinPeak": tile_peak[0],
                      "SolveLivePairs": tile_peak[1],
                      "SolveFallbackRows": tile_peak[2] + tile_peak[3]
                      + tile_peak[4],
                      "SolveBinStats": tile_peak})
    return out + (stats,)


def stencil_pass(setup, batch, tri_bits, zb, viewport, height: int,
                 width: int, flat: bool, t_count: int, solve_caps=None,
                 flags: dict | None = None, row0: int = 0):
    """The stencil mask (reference frame.py:1051-1060): the z-tested
    coverage of the stencil-only draws (VX_MOVEABLE_STENCILONLY, reference
    src/CKMesh.cpp:3938-3974), solved at a clear depth of 1.0 against the
    frame's finished ``zb``. A flat frame solves it with B2, any other with
    B1 at the frame's caps, where the reference takes its plain
    ``deferred.depth_reduce``: the three differ only in which id wins an
    exact depth tie, and the mask reads the winner's depth and whether
    there is one, not its id. Returns sb (H,W) uint8, 1 where a stencil
    triangle covers the pixel at a depth <= zb + 1e-6. With ``flags``
    (a device-decided frame, :func:`render_frame_impl`) B1 runs no
    remainder and ``flags["StencilRemainder"]`` says whether one was
    needed."""
    stencil_tri = (tri_bits[:, 2] > 0.5) & batch.valid
    if flat:
        s_id, s_depth = depth_reduce_cuda(setup, stencil_tri, 1.0, viewport,
                                          height, width, row0=row0)
    else:
        s_id, s_depth, peak = depth_reduce_tiled_cuda(
            setup, stencil_tri, 1.0, viewport, batch.xyw, height, width,
            want_binstats=flags is not None, remainder=flags is None,
            row0=row0, **_solve_caps(t_count, solve_caps))
        if flags is not None:
            flags["StencilRemainder"] = peak[2:5].any()
    return ((s_id >= 0) & (s_depth <= zb + 1e-6)).to(torch.uint8)


def ordered_batch(scene: SceneDevice, batch, defer_tri, tri_bits,
                  ordered_cap: int, sort_transparent: bool = True):
    """The frame's ordered stream: :func:`ordered_subset` of the
    non-deferred, non-stencil triangles with the entities' render
    priorities, transparent triangles sorted unless ``sort_transparent``
    is off (SortTransparentObjects=0 keeps stream order)."""
    transparent = tri_bits[:, 1] > 0.5
    if not sort_transparent:
        transparent = torch.zeros_like(transparent)
    # Stencil-only triangles are consumed by the stencil pass alone.
    stencil_tri = (tri_bits[:, 2] > 0.5) & batch.valid
    prio_ext = torch.cat([scene.entity_priority,
                          torch.zeros(1, dtype=torch.float32,
                                      device=batch.valid.device)])
    tri_prio = _take(prio_ext, _take(scene.vert_entity, scene.tri_idx[:, 0]))
    return ordered_subset(batch, defer_tri | stencil_tri, transparent,
                          ordered_cap, tri_priority=tri_prio)


def ordered_route(ordered_cap: int, height: int, width: int,
                  sampler_profile, pixel_shader=None) -> str:
    """Which ordered pass a frame of (render) size ``height`` x ``width``
    takes, from host values alone (:func:`_ordered_pass`): "none", "flat"
    (the exact flat pass), "blend" (B3), "peel" (B4) or "tiled" (the exact
    tiled pass, whose loop length is a host read)."""
    if ordered_cap <= 0:
        return "none"
    if ordered_cap * height * width <= (1 << 26):
        return "flat"
    sp = sampler_profile
    if pixel_shader is None and sp is not None and len(sp) > 5 \
            and bool(sp[5]):
        return "blend"
    if pixel_shader is None and sp is not None and len(sp) > 6 \
            and bool(sp[6]) and (not sp[1]
                                 or (height % 2 == 0 and width % 2 == 0)):
        return "peel"
    return "tiled"


def _ordered_pass(scene: SceneDevice, batch, defer_tri, tri_bits, fb, zb,
                  ordered_cap: int, height: int, width: int,
                  sort_transparent: bool, pixel_shader, sampler_profile,
                  stats: dict, flags: dict | None = None,
                  peel_rounds: int = 1, row0: int = 0,
                  frame_h: int | None = None):
    """The ordered remainder over the opaque frame (fb, zb), with the
    reference's dispatch (frame.py:924-1032), its "on TPU" read as "always":
    a CUDA tensor launches the kernel, a CPU tensor runs its plain version.

    - ``ordered_cap·H·W ≤ 2^26``: the exact flat pass, :func:`render_pass`.
    - Else, every ordered state inside the affine envelope
      (``sampler_profile[5]``) and no pixel shader: B3; a phase-A overflow
      replays :func:`render_pass_tiled` from the same (fb, zb).
    - Else, the textured envelope (``sampler_profile[6]``, TexturedPeel):
      B4 iterated; a phase-A overflow replays the same way in this frame
      (``OrderedPeelCorrected``), in place of the reference's deferred host
      re-render.
    - Else :func:`render_pass_tiled` with the reference's tile ladder.

    The kernels' phase A scales the reference's capacities with the frame
    size (``cuda_ordered.frame_caps``). Fills ``stats``
    (OrderedPeelOverflow, OrderedPeelRounds, OrderedPeelCorrected,
    OrderedReplays) and returns (fb, zb).

    With ``flags`` (a device-decided frame, :func:`render_frame_impl`)
    nothing is read back: B3's composite is always taken and its phase-A
    overflow goes into ``flags["OrderedReplay"]``; the peel runs
    ``peel_rounds`` rounds and flags ``PeelBad`` (phase A) and ``PeelMore``
    (fragments left after the last round). The exact tiled pass reads its
    loop length back, so such a frame cannot be device-decided.

    ``row0`` / ``frame_h``: a band of a frame (:func:`render_frame_impl`):
    the route, the tile of the exact pass and the kernels' capacities are
    the whole frame's."""
    from ..raster import cuda_ordered as co

    fh = height if frame_h is None else frame_h
    ob = ordered_batch(scene, batch, defer_tri, tri_bits, ordered_cap,
                       sort_transparent)
    passes = (scene.state_i, scene.state_f, scene.tex_planes, scene.tex_hw,
              scene.fog_color, scene.viewport)
    route = ordered_route(ordered_cap, fh, width, sampler_profile,
                          pixel_shader)
    if route == "flat":
        return rb.render_pass(fb, zb, ob, *passes,
                              pixel_shader=pixel_shader,
                              sampler_profile=sampler_profile, row0=row0)
    if route == "tiled" and flags is not None:
        raise ValueError("the exact tiled ordered pass reads the host: this "
                         "frame cannot be device-decided")
    tile_o = 64
    while (ordered_cap * (((fh + tile_o - 1) // tile_o)
                          * ((width + tile_o - 1) // tile_o)) > (1 << 26)
           and tile_o < max(fh, width)):
        tile_o *= 2
    caps = co.frame_caps(fh, width)
    fields = (ob.xyw, ob.z, ob.valid, ob.color, ob.specular, ob.uv, ob.fog,
              ob.state_idx, ob.clip_rect, ob.clipd, scene.state_i,
              scene.state_f)

    def replay():
        stats["OrderedReplays"] = 1
        return rb.render_pass_tiled(fb, zb, ob, *passes, tile=tile_o,
                                    pixel_shader=pixel_shader,
                                    sampler_profile=sampler_profile,
                                    row0=row0)

    if route == "blend":
        a_o, b_o, bad = co.ordered_blend_tiled_cuda(
            *fields, scene.fog_color, zb, scene.viewport, height, width,
            row0=row0, **caps)
        if flags is not None:
            flags["OrderedReplay"] = bad
        # Host read, once per frame: the replay decision.
        elif bool(bad):
            return replay()
        return a_o * fb + b_o, zb
    if route == "peel":
        quad = fh % 2 == 0 and width % 2 == 0

        def comp(f, lids, les):
            return _composite_peeled(f, ob, lids, les, scene,
                                     sampler_profile, height, width, row0,
                                     quad)

        if flags is not None:
            fb_p, flags["PeelBad"], flags["PeelMore"] = \
                co.ordered_peel_iterate(
                    comp, fb, *fields, zb, scene.viewport, height, width,
                    rounds=peel_rounds, row0=row0, **caps)
            stats["OrderedPeelRounds"] = peel_rounds
            return fb_p, zb
        fb_p, bad, rounds = co.ordered_peel_iterate(
            comp, fb, *fields, zb, scene.viewport, height, width,
            row0=row0, **caps)
        stats.update(OrderedPeelOverflow=bad, OrderedPeelRounds=rounds)
        if bad:
            stats["OrderedPeelCorrected"] = 1
            return replay()
        return fb_p, zb
    return rb.render_pass_tiled(fb, zb, ob, *passes, tile=tile_o,
                                pixel_shader=pixel_shader,
                                sampler_profile=sampler_profile, row0=row0)


def render_frame_full_impl(scene: SceneDevice, levels: tuple, height: int,
                           width: int, skin=None, skin_ranges: tuple = (),
                           anim=None, anim_t=0.0, world_in=None, sprites=None,
                           quads_bg=None, quads_fg=None, lines=None,
                           ordered_cap: int | None = None,
                           sort_transparent: bool = True,
                           want_stencil: bool = False,
                           vertex_shader=None, pixel_shader=None,
                           want_bump: bool = False, want_cube: bool = False,
                           want_stats: bool = False, sampler_profile=None,
                           prev_fb=None, prev_zb=None,
                           corner: tuple = (0, 0, 0),
                           want_texgen: bool = False,
                           solve_caps: tuple | None = None,
                           cull: tuple | None = None, cull_sel=None,
                           host_stats: dict | None = None,
                           quad_windows: tuple | None = None,
                           flags: dict | None = None, peel_rounds: int = 1,
                           row0: int = 0, frame_h: int | None = None):
    """The per-frame device program: animate -> compose -> skin ->
    (culled-chunk compaction) -> the opaque frame.

    ``anim``: AnimBank evaluated at ``anim_t``. ``world_in``: world
    matrices a separate stage already produced (:func:`eval_anim_world`,
    a render context's bound clip); the animate and compose stages are then
    skipped. ``skin``: SkinBank, whose rows are written into copies of the
    pool. ``quads_bg``/``quads_fg``: QuadBanks composited under the 3D
    pass (over the clear colour, or over ``prev_fb``) and over it;
    ``quad_windows``: their host-side windows (``overlay.quad_windows``;
    None = whole-frame quads). ``sprites``: Sprite3DBank, whose corners
    are written into the pool after the skin stage. ``lines``: LineBank,
    drawn over the finished 3D frame (against its zb) before the
    foreground quads, from the scene before chunk compaction, whose stream
    rows the bank indexes (reference frame.py:1142-1145, :1179-1183).
    ``want_stencil``: the stencil mask follows zb (:func:`stencil_pass`).
    ``host_stats``, ``flags``, ``peel_rounds``, ``row0`` and ``frame_h``
    (a band of a frame): as in :func:`render_frame_impl`; the 2D quads and
    the line pass evaluate the band's global pixel centres too."""
    scene, world, corner, scene_lines = scene_stages(
        scene, levels, skin, skin_ranges, anim, anim_t, world_in, corner,
        cull, cull_sel, sprites)
    win_bg, win_fg = quad_windows or (None, None)
    background = None
    if quads_bg is not None:
        background = prev_fb if prev_fb is not None else \
            scene.clear_color[:, None, None].to(torch.float32).expand(
                4, height, width)
        background = composite_quads(background, quads_bg, scene.tex_planes,
                                     scene.tex_hw, height, width, win_bg,
                                     row0)
    out = render_frame_impl(
        scene, levels, height, width, ordered_cap, world=world,
        background=background,
        sort_transparent=sort_transparent, want_stencil=want_stencil,
        vertex_shader=vertex_shader, pixel_shader=pixel_shader,
        want_bump=want_bump, want_cube=want_cube, want_stats=want_stats,
        sampler_profile=sampler_profile, prev_fb=prev_fb, prev_zb=prev_zb,
        corner=corner, want_texgen=want_texgen, solve_caps=solve_caps,
        host_stats=host_stats, flags=flags, peel_rounds=peel_rounds,
        row0=row0, frame_h=frame_h)
    if lines is not None:
        from .lines import draw_lines, visible_lines

        out = (draw_lines(out[0], out[1], scene_lines, world,
                          visible_lines(lines, scene_lines), height,
                          width, row0=float(row0)),) + tuple(out[1:])
    if quads_fg is None:
        return out
    fb = composite_quads(out[0], quads_fg, scene.tex_planes, scene.tex_hw,
                         height, width, win_fg, row0)
    return (fb,) + tuple(out[1:])


def scene_stages(scene: SceneDevice, levels: tuple, skin=None,
                 skin_ranges: tuple = (), anim=None, anim_t=0.0,
                 world_in=None, corner: tuple = (0, 0, 0), cull=None,
                 cull_sel=None, sprites=None):
    """animate -> compose -> skin -> 3D sprite corners (``sprites``, a
    Sprite3DBank) -> culled-chunk compaction: the scene, world matrices and
    corner tuple the frame's vertex stage takes, and the scene before the
    compaction (what the line pass reads)."""
    from .skinning import apply_skin

    if world_in is not None:
        world = world_in
    elif anim is not None:
        world = eval_anim_world(scene.local, scene.parent, anim, anim_t,
                                levels)
    else:
        world = compose_world(scene.local, scene.parent, levels)
    if skin is not None:
        positions, normals = apply_skin(world, scene.positions,
                                        scene.normals, skin,
                                        ranges=skin_ranges)
        scene = scene._replace(positions=positions, normals=normals)
    if sprites is not None:
        scene = scene._replace(positions=apply_billboards(
            world, scene.view, scene.positions, sprites,
            scene.entity_visible))
    full = scene
    # Compaction runs after the skin and sprite writes, so the gathered
    # tail sees them (neither kind of row is ever in the corner block).
    if cull is not None and cull_sel is not None:
        scene, corner = compact_scene_chunks(scene, cull_sel[0], cull_sel[1],
                                             corner, cull)
    return scene, world, corner, full


def eval_anim_world(local, parent, anim, anim_t, levels):
    """The animate and compose stages: the bank's tracks at ``anim_t`` (a
    float or a 0-d tensor) merged into the (N,4,4) locals, then the world
    matrices. A render context with a bound clip runs this before its frame
    and hands the result over as ``world_in``, as the reference does (its
    frame and this stage are two device programs)."""
    from ..anim.bank import apply_bank

    return compose_world(apply_bank(local, anim, anim_t), parent, levels)


def mip_box(cur: torch.Tensor) -> torch.Tensor:
    """The next mip level of a (4, h, w) image: each texel the mean of a
    2x2 block (odd trailing rows and columns dropped), summed as
    (t00 + t01) + (t10 + t11), then divided by 4. That is how the
    reference's XLA reduction (``mean(axis=(1, 3))``) associates the sum
    on the CPU when the level above is a power of two wide, as every level
    of a 512x384 feed is; at other widths it sums ((t00 + t01) + t10) +
    t11, within two f32 ULPs of this (tests/test_torch_rtt.py). bf16
    levels sum in f32, as ``jnp.mean`` does."""
    nh, nw = max(cur.shape[1] // 2, 1), max(cur.shape[2] // 2, 1)
    x = cur[:, :nh * 2, :nw * 2].to(torch.float32).reshape(4, nh, 2, nw, 2)
    total = (x[:, :, 0, :, 0] + x[:, :, 0, :, 1]) \
        + (x[:, :, 1, :, 0] + x[:, :, 1, :, 1])
    return (total / 4.0).to(cur.dtype)


def _apply_tex_patch(static: dict, d: dict, layout: tuple, texdev=None,
                     texdev_rects: tuple = ()) -> torch.Tensor:
    """Per-frame texture updates applied inside the frame (reference
    frame.py:1201-1239): device-resident images (render-to-texture feeds,
    ``texdev``, one rect ``(plane, oy, ox, h, w, mip_col, levels, chw)``
    each) are written into a copy of the stack with their mip chain; then
    video-texture texels (packed in the dyn f32 buffer) scatter via
    precomputed channel-last indices."""
    planes = static["tex_planes"]
    if texdev:
        planes = planes.clone()
        for img, rect in zip(texdev, texdev_rects):
            pi, oy, ox, h, w, mip_col, levels, chw = rect
            # A (4, H, W) feed (a framebuffer) is the stack's own layout.
            cur = (img if chw else img.permute(2, 0, 1)).to(planes.dtype)
            planes[pi, :, oy:oy + h, ox:ox + w] = cur
            for lv in range(1, levels):
                cur = mip_box(cur)
                y_off = 0 if lv == 1 else h - (h >> (lv - 1))
                planes[pi, :, oy + y_off:oy + y_off + cur.shape[1],
                       ox + mip_col:ox + mip_col + cur.shape[2]] = cur
    if not has_field(layout, "tex_patch") or "texpatch_idx" not in static:
        return planes
    idx = static["texpatch_idx"].long()
    vals = d["tex_patch"]
    nt, _ch, th, tw = planes.shape
    cl = planes.permute(0, 2, 3, 1).reshape(-1, 4).clone()
    cl[idx] = vals.to(cl.dtype)
    return cl.reshape(nt, th, tw, 4).permute(0, 3, 1, 2).contiguous()


def render_frame_packed_impl(static: dict, dyn_f, dyn_i, layout: tuple,
                             levels: tuple, height: int, width: int,
                             skin=None, skin_ranges: tuple = (),
                             anim=None, world_in=None,
                             sprites_static=None, lines=None,
                             ordered_cap: int | None = None,
                             sort_transparent: bool = True,
                             want_stencil: bool = False,
                             vertex_shader=None, pixel_shader=None,
                             want_bump: bool = False,
                             want_cube: bool = False,
                             want_stats: bool = False,
                             sampler_profile=None,
                             prev_fb=None, prev_zb=None,
                             texdev=None, texdev_rects: tuple = (),
                             corner: tuple = (0, 0, 0),
                             want_texgen: bool = False, ss: int = 1,
                             solve_caps: tuple | None = None,
                             cull: tuple | None = None,
                             host_stats: dict | None = None,
                             quad_windows: tuple | None = None,
                             flags: dict | None = None,
                             peel_rounds: int = 1,
                             y_shift: int | None = None,
                             frame_h: int | None = None):
    """Packed-transfer frame entry: ``static`` is the per-compile dict of
    device tensors, ``dyn_f``/``dyn_i`` the two per-frame buffers (see
    pipeline/packing.py). Takes exactly what the render context's
    ``_fill_packed`` returns.

    ``ss``: the Antialias supersample factor (reference frame.py:1242-1345).
    The frame renders at (ss*height, ss*width) — every route, tile and
    parity rule sees that size — and :func:`box_resolve` brings fb, zb and
    sb back to (height, width). Accumulate-mode buffers arrive at display
    size and are repeat-upsampled first, so that a pixel no draw touches
    resolves to its previous value. ``quad_windows`` are the host windows
    of the scaled quad rects at the render size. ``host_stats``, ``flags``
    and ``peel_rounds``: as in :func:`render_frame_impl` (a device-decided
    frame reads nothing back).

    ``y_shift`` / ``frame_h``: render rows [y_shift, y_shift + height) of a
    frame of ``frame_h`` display rows (a band, reference frame.py:1258-1309,
    ``parallel/tile_shard.py``), at ss times both; the band resolves its own
    Antialias windows, which never cross it."""
    scene, d = unpack_scene(static, dyn_f, dyn_i, layout, ss=ss,
                            texdev=texdev, texdev_rects=texdev_rects)
    rh, rw = height * ss, width * ss
    row0 = 0 if y_shift is None else int(y_shift) * ss
    fh = None if frame_h is None else frame_h * ss
    if ss > 1:
        if prev_fb is not None:
            prev_fb = prev_fb.repeat_interleave(ss, dim=-2).repeat_interleave(
                ss, dim=-1)
        if prev_zb is not None:
            prev_zb = prev_zb.repeat_interleave(ss, dim=-2).repeat_interleave(
                ss, dim=-1)

    def quad_bank(prefix):
        if not has_field(layout, f"{prefix}_rect"):
            return None
        return QuadBank(
            rect=d[f"{prefix}_rect"], uvrect=d[f"{prefix}_uvrect"],
            color=d[f"{prefix}_color"], tex=d[f"{prefix}_tex"],
            blend=d[f"{prefix}_blend"], valid=d[f"{prefix}_valid"] != 0)

    # An anim bank given to the frame itself evaluates at the packed
    # scalar time.
    anim_t = d["anim_t"] if (anim is not None
                             and has_field(layout, "anim_t")) else 0.0
    cull_sel = None
    if cull is not None and has_field(layout, "chunk_idx"):
        cull_sel = (d["chunk_idx"], d["chunk_n"])
    out = render_frame_full_impl(
        scene, levels, rh, rw, skin=skin, skin_ranges=skin_ranges,
        anim=anim, anim_t=anim_t, world_in=world_in,
        sprites=sprite_bank(sprites_static, d), lines=lines,
        ordered_cap=ordered_cap,
        sort_transparent=sort_transparent,
        want_stencil=want_stencil, vertex_shader=vertex_shader,
        pixel_shader=pixel_shader, want_bump=want_bump, want_cube=want_cube,
        want_stats=want_stats, sampler_profile=sampler_profile,
        prev_fb=prev_fb, prev_zb=prev_zb, corner=corner,
        want_texgen=want_texgen, solve_caps=solve_caps, cull=cull,
        cull_sel=cull_sel, host_stats=host_stats,
        quads_bg=quad_bank("qbg"), quads_fg=quad_bank("qfg"),
        quad_windows=quad_windows, flags=flags, peel_rounds=peel_rounds,
        row0=row0, frame_h=fh)
    if ss == 1:
        return out
    stats = out[-1:] if want_stats else ()
    planes = out[:-1] if want_stats else out
    return box_resolve(*planes, ss=ss) + stats


def side_by_side(left: torch.Tensor, right: torch.Tensor,
                 width: int) -> torch.Tensor:
    """The stereo composite of two eyes' frames (or per-pixel maps) of
    ``width`` columns (reference rendercontext.py:2993-2997): each half
    holds every other column of its eye, so the result is 2 * (width // 2)
    columns wide; an odd width loses its last column, as in the
    reference."""
    half = width // 2
    return torch.cat([left[..., ::2][..., :half],
                      right[..., ::2][..., :half]], dim=-1)


def box_resolve(fb, zb, sb=None, ss: int = 2) -> tuple:
    """The Antialias resolve of a frame rendered at ss times the display
    size: each ss x ss window of fb averages (its samples summed in
    row-major order, then divided by ss*ss: the reference's XLA reduction
    on the CPU, bit for bit), zb takes the window's minimum (the nearest
    covered sample keeps later z tests conservative) and sb its maximum
    (any covered sample). Returns (fb, zb[, sb]) at display size."""
    def windows(x):
        h, w = x.shape[-2] // ss, x.shape[-1] // ss
        x = x.reshape(x.shape[:-2] + (h, ss, w, ss))
        return [x[..., :, i, :, j] for i in range(ss) for j in range(ss)]

    samples = windows(fb)
    total = samples[0]
    for x in samples[1:]:
        total = total + x
    out = (total / float(ss * ss), torch.amin(torch.stack(windows(zb)), 0))
    if sb is not None:
        out += (torch.amax(torch.stack(windows(sb)), 0),)
    return out


render_frame_packed = render_frame_packed_impl


def render_frames_packed_batched(static: dict, dyn_f, dyn_i,
                                 world_in=None, **params) -> tuple:
    """Packed frames of a context batch: ``dyn_f`` / ``dyn_i`` carry a
    leading context axis (B, F) / (B, I), ``world_in`` (optional) the
    members' (B, N, 4, 4) bound-clip worlds; ``static`` and ``params``
    (:func:`render_frame_packed`'s) are shared. Each member's frame runs in
    turn on the tensors' device (the reference vmaps the same frame with
    its Pallas kernels off). Returns the frame's outputs stacked: (B,4,H,W)
    fb, (B,H,W) zb[, (B,H,W) sb]."""
    frames = [render_frame_packed(
        static, dyn_f[i], dyn_i[i], **params,
        world_in=None if world_in is None else world_in[i])
        for i in range(dyn_f.shape[0])]
    return tuple(torch.stack(planes) for planes in zip(*frames))


def packed_setup(static: dict, dyn_f, dyn_i, params: dict):
    """(scene, batch, setup, defer_tri, tri_bits) of a packed frame: what
    its visibility solve, shade and ordered pass receive (``tri_bits``:
    per triangle deferred / alpha-blend / stencil). Lets a caller run and
    time the stages at the shapes a real frame gives them (a bound clip's
    ``world_in`` and the skin stage included; an Antialias frame's at its
    render size)."""
    scene, d = unpack_scene(static, dyn_f, dyn_i, params["layout"],
                            ss=params.get("ss", 1))
    cull_sel = None
    if params["cull"] is not None and has_field(params["layout"],
                                                "chunk_idx"):
        cull_sel = (d["chunk_idx"], d["chunk_n"])
    scene, world, corner, _full = scene_stages(
        scene, params["levels"], params["skin"], params["skin_ranges"],
        world_in=params["world_in"], corner=params["corner"],
        cull=params["cull"], cull_sel=cull_sel,
        sprites=sprite_bank(params.get("sprites_static"), d))
    batch, setup, defer_tri, tri_bits = opaque_setup(
        scene, params["levels"], world, corner=corner,
        vertex_shader=params.get("vertex_shader"),
        want_bump=params.get("want_bump", False),
        want_cube=params.get("want_cube", False),
        want_texgen=params["want_texgen"],
        sampler_profile=params["sampler_profile"])
    return scene, batch, setup, defer_tri, tri_bits


def unpack_scene(static: dict, dyn_f, dyn_i, layout: tuple, ss: int = 1,
                 texdev=None, texdev_rects: tuple = ()):
    """Packed buffers -> (SceneDevice, raw field dict): the device-side
    inverse of CKRenderContext._fill_packed. ``texdev`` /
    ``texdev_rects``: this frame's render-to-texture feeds
    (:func:`_apply_tex_patch`).

    ``ss``: the Antialias supersample factor. Every pixel-space quantity —
    viewport, entity scissors, 2D quad rects — is multiplied by ss in f32
    (exact for ss = 2), so the frame renders at ss times the size; the
    raster math itself is unchanged."""
    d = unpack(dyn_f, dyn_i, layout)
    if ss > 1:
        for key in ("viewport", "entity_clip", "qbg_rect", "qfg_rect"):
            if key in d:
                d[key] = d[key] * float(ss)
    lights = LightArray(
        type=d["lt_type"], diffuse=d["lt_diffuse"], specular=d["lt_specular"],
        ambient=d["lt_ambient"], position=d["lt_position"],
        direction=d["lt_direction"], range=d["lt_range"],
        falloff=d["lt_falloff"], attenuation=d["lt_attenuation"],
        cos_theta=d["lt_cos_theta"], cos_phi=d["lt_cos_phi"],
        active=d["lt_active"] != 0)
    scene = SceneDevice(
        local=d["local"], parent=static["parent"],
        entity_visible=d["entity_visible"] != 0,
        entity_clip=d["entity_clip"],
        entity_priority=d["entity_priority"],
        positions=static["positions"], normals=static["normals"],
        uv=static["uv"], prelit=static["prelit"],
        prelit_spec=static["prelit_spec"], src_idx=static["src_idx"],
        vert_entity=static["vert_entity"], vert_state=static["vert_state"],
        vert_lit=static["vert_lit"], tri_idx=static["tri_idx"],
        tri_state=static["tri_state"], tri_valid=static["tri_valid"],
        state_i=d["state_i"], state_f=d["state_f"],
        mat_diffuse=d["mat_diffuse"], mat_ambient=d["mat_ambient"],
        mat_specular=d["mat_specular"], mat_emissive=d["mat_emissive"],
        mat_power=d["mat_power"], lights=lights,
        global_ambient=d["global_ambient"], view=d["view"], proj=d["proj"],
        cam_pos=d["cam_pos"], viewport=d["viewport"],
        fog_mode=d["fog_mode"], fog_start=d["fog_start"],
        fog_end=d["fog_end"], fog_density=d["fog_density"],
        fog_color=d["fog_color"],
        tex_planes=_apply_tex_patch(static, d, layout, texdev,
                                    texdev_rects),
        tex_hw=static["tex_hw"], clear_color=d["clear_color"],
        clear_z=d["clear_z"],
        clip_planes=(d["clip_planes"]
                     if has_field(layout, "clip_planes") else None),
        fog_proj=(d["fog_proj"] if has_field(layout, "fog_proj") else None),
        tex_quad=static.get("tex_quad"))
    return scene, d


def sprite_bank(sprites_static: dict | None, d: dict):
    """The frame's Sprite3DBank: the per-compile rows ``sprites_static``
    (entity rows, pool bases, valid) with the sizes, offsets and modes of
    the packed field dict ``d`` (reference unpack_scene, frame.py:1408-1415);
    None without sprites."""
    if sprites_static is None:
        return None
    return Sprite3DBank(
        entity_row=sprites_static["entity_row"], size=d["sp_size"],
        offset=d["sp_offset"], mode=d["sp_mode"],
        pool_base=sprites_static["pool_base"],
        valid=sprites_static["valid"])
