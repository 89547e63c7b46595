"""Scenes of the BASELINE configurations and stress cases, for either
object model.

Each build function takes an ``objects`` module — this package's
(``ckrenderengine_tpu_torch.objects``) or the reference package's — plus the
keyword arguments of its ``CKContext`` (``device=`` for this package), so the
tests can build one scene through both packages and compare the frames.
The scenes are those of ``benchmarks/baseline.py`` (configs 1 to 4: config
3 with its HUD sprite and text label, config 4 with its skinned tube,
device-bound clip and Bezier patch sheet, and ``config4_skin``, config 4
without the sheet), ``bench.build_scene`` (config 5) and
``benchmarks/stress.py`` (the two transparency stress cases), plus a small
alpha-test cutout scene, config 2 with a stencil-only mesh and config 5
with a level's effects (``build_config5_fx``: sprites, curves, lines),
material effects (``build_config5_mat``: TexGen, cube env, EMBM, effect
passes, channels), user shaders (``build_config5_shaded``) and a live
monitor fed by render-to-texture, in stereo (``build_config5_monitor``),
immediate-mode draws (``build_config5_immediate``), a debugged level
with a layered grid and an IK-driven arm (``build_config5_debug``) and a
level with DXT textures and a progressive-mesh LOD that goes through a
scene file (``build_config5_io``, ``reload_level``, ``load_level``),
made from seeds; sizes are
parameters so the tests can cut the frame, the hierarchy, the terrain, the
sheets and the skinned tube down. Every build function takes
``antialias=True`` to switch the render manager's Antialias option on (the
frame then renders at twice its size and resolves to it).
"""

from __future__ import annotations

import importlib
import os
import struct

import numpy as np

from .raster.types import VXLIGHT, VXTEXTURE_FILTER


def make_sphere(rows: int, cols: int, radius: float = 1.0):
    th = np.linspace(0, np.pi, rows + 1)
    ph = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    T, Ph = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([
        radius * np.sin(T) * np.cos(Ph),
        radius * np.cos(T),
        radius * np.sin(T) * np.sin(Ph),
    ], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([Ph / (2 * np.pi), T / np.pi], -1).reshape(-1, 2).astype(
        np.float32)
    faces = []
    for r in range(rows):
        for c in range(cols):
            a = r * cols + c
            b = r * cols + (c + 1) % cols
            cc = (r + 1) * cols + c
            d = (r + 1) * cols + (c + 1) % cols
            faces.append([a, cc, b])
            faces.append([b, cc, d])
    return pts, uv, np.asarray(faces, np.int32)


def make_terrain(n: int, extent: float, amp: float):
    xs = np.linspace(-extent, extent, n + 1, dtype=np.float32)
    zs = np.linspace(-extent, extent, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = amp * (np.sin(gx * 0.15) * np.cos(gz * 0.2)
                + 0.3 * np.sin(gx * 0.7 + gz * 0.5))
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([(gx + extent) / (2 * extent) * 24,
                   (gz + extent) / (2 * extent) * 24],
                  -1).reshape(-1, 2).astype(np.float32)
    rr, cc = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (rr * (n + 1) + cc).reshape(-1)
    f1 = np.stack([a, a + 1, a + n + 2], -1)
    f2 = np.stack([a, a + n + 2, a + n + 1], -1)
    faces = np.concatenate([f1[:, None], f2[:, None]], 1).reshape(-1, 3)
    return verts, uv, faces.astype(np.int32)


def _cube(s: float):
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32)
    faces = np.array([
        [0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
        [2, 6, 7], [2, 7, 3], [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5],
    ], np.int32)
    return verts, faces


def _context(O, antialias: bool, ctx_kw):
    """A ``CKContext`` of ``O``; with ``antialias`` its render manager's
    Antialias option is on, so every frame renders at twice the size and
    resolves to it."""
    ctx = O.CKContext(**ctx_kw)
    if antialias:
        ctx.GetRenderManager().SetRenderOptions("Antialias", 1)
    return ctx


def build_config1(O, size: int = 256, antialias: bool = False, **ctx_kw):
    """Flat-shaded cube (BASELINE config 1, 256x256). Returns
    (ctx, rc, cube); rotate ``cube`` about y by 0.02 per tick."""
    ctx = _context(O, antialias, ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(size, size)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 1.0, -4.0))
    rc.AttachViewpointToCamera(cam)
    verts, faces = _cube(0.5)
    mesh = O.CKMesh(ctx, "cube")
    mesh.SetPositions(verts)
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "mat")
    mat.SetDiffuse((0.9, 0.4, 0.2, 1.0))
    mesh.ApplyGlobalMaterial(mat)
    cube = O.CK3dObject(ctx, "cube")
    cube.SetCurrentMesh(mesh)
    return ctx, rc, cube


def build_config2(O, width: int = 640, height: int = 480,
                  mips: bool = False, antialias: bool = False, **ctx_kw):
    """Lit sphere over a textured plane, 2 lights (BASELINE config 2,
    640x480). ``mips``: the plane's texture gets a mip chain and a
    trilinear filter (the BASELINE scene has none), so the frame needs a
    mip LOD. Returns (ctx, rc, ball); rotate ``ball`` by 0.03 per tick."""
    ctx = _context(O, antialias, ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 2.0, -7.0))
    cam.SetOrientation((0.0, -0.15, 1.0))
    rc.AttachViewpointToCamera(cam)

    spts, suv, sfaces = make_sphere(32, 48, 1.5)
    sphere_mesh = O.CKMesh(ctx, "sphere")
    sphere_mesh.SetPositions(spts)
    sphere_mesh.SetUVs(suv)
    sphere_mesh.SetFaces(sfaces)
    sphere_mesh.BuildNormals()
    smat = O.CKMaterial(ctx, "smat")
    smat.SetDiffuse((0.8, 0.3, 0.2, 1.0))
    smat.SetPower(32.0)
    sphere_mesh.ApplyGlobalMaterial(smat)
    ball = O.CK3dObject(ctx, "ball")
    ball.SetCurrentMesh(sphere_mesh)
    ball.SetPosition((0.0, 0.8, 0.0))

    tex = O.CKTexture(ctx, "checker")
    img = (np.indices((16, 16)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img, img * 0.8 + 0.1, img * 0.6 + 0.2,
                           np.ones_like(img)], -1))
    plane = O.CKMesh(ctx, "plane")
    plane.SetPositions(np.array([[-6, -1, -6], [6, -1, -6], [6, -1, 6],
                                 [-6, -1, 6]], np.float32))
    plane.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    plane.SetUVs(np.array([[0, 0], [6, 0], [6, 6], [0, 6]], np.float32))
    plane.BuildNormals()
    pmat = O.CKMaterial(ctx, "pmat")
    pmat.SetDiffuse((0.9, 0.9, 0.9, 1.0))
    pmat.SetTexture(tex)
    if mips:
        tex.UseMipmap(True)
        pmat.SetTextureMinMode(int(VXTEXTURE_FILTER.LINEARMIPLINEAR))
        pmat.SetTextureMagMode(int(VXTEXTURE_FILTER.LINEARMIPLINEAR))
    plane.ApplyGlobalMaterial(pmat)
    floor = O.CK3dObject(ctx, "floor")
    floor.SetCurrentMesh(plane)

    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.3, -1.0, 0.4))
    sun.SetSpecularFlag(True)
    bulb = O.CKLight(ctx, "bulb")
    bulb.SetType(int(VXLIGHT.POINT))
    bulb.SetPosition((2.0, 3.0, -2.0))
    bulb.SetColor((0.4, 0.5, 1.0, 1.0))
    bulb.SetRange(30.0)
    return ctx, rc, ball


def build_config3(O, width: int = 1024, height: int = 768,
                  n_entities: int = 1000, antialias: bool = False,
                  **ctx_kw):
    """1,000-entity hierarchy of depth 6 with a sun, a moving point light
    and a foreground HUD (BASELINE config 3,
    ``benchmarks/baseline.py:138-228``): cube entities in trees grown from
    seeded random roots, a 24x24 HUD sprite at (8, 8) and the
    ``CKSpriteText`` "entities: 1000" at (40, 8, 168, 28), at 1024x768.
    ``n_entities`` cuts the hierarchy (the label says the count). Returns
    (ctx, rc, tick); each ``tick()`` rotates the roots by 0.01 about y and
    moves the bulb along its circle, as the source's tick does."""
    ctx = _context(O, antialias, ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 10.0, -42.0))
    cam.SetOrientation((0.0, -0.2, 1.0))
    cam.SetBackPlane(400.0)
    rc.AttachViewpointToCamera(cam)

    verts, faces = _cube(0.4)
    mesh = O.CKMesh(ctx, "cube")
    mesh.SetPositions(verts)
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "mat")
    mat.SetDiffuse((0.7, 0.7, 0.8, 1.0))
    mat.SetPower(16.0)
    mesh.ApplyGlobalMaterial(mat)

    rng = np.random.default_rng(3)
    roots = []
    n_made = 0

    # Trees of depth 6: 4 children per node down to depth 2, then 3.
    def grow(parent, depth):
        nonlocal n_made
        if depth == 0 or n_made >= n_entities:
            return
        k = 4 if depth > 2 else 3
        for _ in range(k):
            if n_made >= n_entities:
                return
            e = O.CK3dObject(ctx, f"e{n_made}")
            n_made += 1
            e.SetCurrentMesh(mesh)
            if parent is not None:
                e.SetParent(parent)
            e.SetPosition(tuple(rng.uniform(-3.5, 3.5, 3)), ref=parent)
            grow(e, depth - 1)

    while n_made < n_entities:
        root = O.CK3dObject(ctx, f"root{len(roots)}")
        n_made += 1
        root.SetCurrentMesh(mesh)
        root.SetPosition((float(rng.uniform(-25, 25)), 5.0,
                          float(rng.uniform(-20, 30))))
        roots.append(root)
        grow(root, 5)

    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.3, -1.0, 0.2))
    bulb = O.CKLight(ctx, "bulb")
    bulb.SetType(int(VXLIGHT.POINT))
    bulb.SetPosition((0.0, 12.0, 0.0))
    bulb.SetColor((1.0, 0.7, 0.4, 1.0))
    bulb.SetRange(120.0)

    hud = O.CKSprite(ctx, "hud")
    icon = np.zeros((24, 24, 4), np.float32)
    icon[4:20, 4:20] = (0.9, 0.2, 0.1, 0.85)
    hud.SetImage(icon)
    hud.SetRect((8, 8, 32, 32))
    txt = O.CKSpriteText(ctx, "fpslabel")
    txt.Create(128, 20)
    txt.SetText(f"entities: {n_entities}")
    txt.SetRect((40, 8, 168, 28))
    state = {"i": 0}

    def tick():
        i = state["i"]
        for r in roots:
            r.Rotate((0, 1, 0), 0.01)
        bulb.SetPosition((18.0 * np.sin(i * 0.05), 12.0,
                          18.0 * np.cos(i * 0.05)))
        state["i"] = i + 1

    return ctx, rc, tick


def make_skinned_tube(O, ctx, n_bones: int = 128, rings_per_bone: int = 4,
                      ring_verts: int = 120, clip: bool = True):
    """A tube of n_bones*rings_per_bone rings of ring_verts vertices
    skinned to a chain of bones along +z, with a keyed clip that sways every
    bone about y with a phase offset (``benchmarks/baseline.py:231-320``;
    None where ``clip`` is False). The anim classes come from the package
    ``O`` belongs to. Returns (obj, mesh, skin, bones, clip)."""
    A = importlib.import_module(O.__name__.rpartition(".")[0] + ".anim")
    seg_len = 0.35
    length = n_bones * seg_len
    rings = n_bones * rings_per_bone
    zs = np.linspace(0.0, length, rings, dtype=np.float32)
    th = np.linspace(0, 2 * np.pi, ring_verts, endpoint=False,
                     dtype=np.float32)
    Z, Th = np.meshgrid(zs, th, indexing="ij")
    R = 1.0 + 0.15 * np.sin(Z * 0.8)
    pos = np.stack([R * np.cos(Th), R * np.sin(Th), Z],
                   -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(rings - 1):
        for c in range(ring_verts):
            a = r * ring_verts + c
            b = r * ring_verts + (c + 1) % ring_verts
            cc = (r + 1) * ring_verts + c
            d = (r + 1) * ring_verts + (c + 1) % ring_verts
            faces += [[a, cc, b], [b, cc, d]]
    faces = np.asarray(faces, np.int32)

    mesh = O.CKMesh(ctx, "tube")
    mesh.SetPositions(pos)
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "tubemat")
    mat.SetDiffuse((0.3, 0.7, 0.9, 1.0))
    mat.SetPower(24.0)
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, "snake")
    obj.SetCurrentMesh(mesh)

    bones = []
    parent = None
    for i in range(n_bones):
        b = O.CK3dObject(ctx, f"bone{i}")
        if parent is not None:
            b.SetParent(parent)
            b.SetPosition((0, 0, seg_len), ref=parent)
        bones.append(b)
        parent = b

    skin = obj.CreateSkin()
    skin.SetObjectInitMatrix(np.eye(4, dtype=np.float32))
    skin.SetBoneCount(n_bones)
    for i, b in enumerate(bones):
        bd = skin.GetBoneData(i)
        bd.SetBone(b)
        inv = np.eye(4, dtype=np.float32)
        inv[3, 2] = -zs[min(i * rings_per_bone, rings - 1)]
        bd.SetBoneInitialInverseMatrix(inv)
    skin.SetRestPose(pos, mesh.normals)
    # Each vertex binds to its ring's bone and the next (50/50 at seams).
    ring_of = np.repeat(np.arange(rings), ring_verts)
    bone_of = np.minimum(ring_of // rings_per_bone, n_bones - 1)
    frac = (ring_of % rings_per_bone) / rings_per_bone
    nxt = np.minimum(bone_of + 1, n_bones - 1)
    for v in range(pos.shape[0]):
        w1 = float(frac[v]) * 0.5
        skin.SetVertexWeights(v, [int(bone_of[v]), int(nxt[v])],
                              [1.0 - w1, w1])
    if not clip:
        return obj, mesh, skin, bones, None

    clip = A.CKKeyedAnimation(ctx, "wave")
    clip.SetLength(60.0)
    for i, b in enumerate(bones):
        oa = A.CKObjectAnimation(ctx, f"oa{i}")
        oa.Set3dEntity(b)
        rcn = oa.CreateController(A.CKANIMATION_LINEAR_ROT)
        phase = i * 0.21
        for t in np.linspace(0.0, 60.0, 13):
            ang = 0.10 * np.sin(t * 0.35 + phase)
            # quaternion about +y, (x, y, z, w)
            q = np.array([0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)],
                         np.float32)
            rcn.AddKey(float(t), q)
        clip.AddAnimation(oa)
    return obj, mesh, skin, bones, clip


def make_patch_sheet(O, ctx, n: int = 6, iterations: int = 5,
                     extent: float = 12.0, amp: float = 1.2):
    """An n x n grid of Bezier quad patches forming a wavy ground sheet
    (``benchmarks/baseline.py:323-366``): 36 patches tessellated at
    iteration 5 into 1,296 vertices and 1,800 faces at the defaults.
    Returns the built patch mesh."""
    pm = O.CKPatchMesh(ctx, "patchsheet")

    def height(x, y):
        return amp * (np.sin(x * 0.6) * np.cos(y * 0.5))

    xs = np.linspace(-extent, extent, n + 1)
    corners = np.array([[x, height(x, y), y] for y in xs for x in xs],
                       np.float32)
    pm.SetVerts(corners)
    vecs = []
    patches = []

    def pt(x, y):
        return np.array([x, height(x, y), y], np.float32)

    for r in range(n):
        for c in range(n):
            i00 = r * (n + 1) + c
            quad = [i00, i00 + 1, i00 + n + 2, i00 + n + 1]
            x0, x1 = xs[c], xs[c + 1]
            y0, y1 = xs[r], xs[r + 1]
            base = len(vecs)
            # 8 edge control points (1/3, 2/3 along each edge), sampled off
            # the analytic surface so tessellation reconstructs the waves.
            for (ax, ay), (bx, by) in (((x0, y0), (x1, y0)),
                                       ((x1, y0), (x1, y1)),
                                       ((x1, y1), (x0, y1)),
                                       ((x0, y1), (x0, y0))):
                for tpar in (1 / 3, 2 / 3):
                    vecs.append(pt(ax + (bx - ax) * tpar,
                                   ay + (by - ay) * tpar))
            for (u, v) in ((1 / 3, 1 / 3), (2 / 3, 1 / 3), (2 / 3, 2 / 3),
                           (1 / 3, 2 / 3)):
                vecs.append(pt(x0 + (x1 - x0) * u, y0 + (y1 - y0) * v))
            patches.append(O.CKPatch(quad, list(range(base, base + 8)),
                                     list(range(base + 8, base + 12))))
    pm.SetVecs(np.asarray(vecs, np.float32))
    for p in patches:
        pm.AddPatch(p)
    pm.SetIterationCount(iterations)
    pm.BuildRenderMesh()
    return pm


def _config4(O, width, height, n_bones, rings_per_bone, ring_verts,
             sheet: bool, antialias: bool, ctx_kw):
    ctx = _context(O, antialias, ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((8.0, 6.0, -14.0))
    cam.SetOrientation((-0.25, -0.18, 1.0))
    cam.SetBackPlane(300.0)
    rc.AttachViewpointToCamera(cam)
    _obj, _mesh, _skin, _bones, clip = make_skinned_tube(
        O, ctx, n_bones, rings_per_bone, ring_verts)
    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.3, -1.0, 0.4))
    sun.SetSpecularFlag(True)
    if sheet:
        pmesh = make_patch_sheet(O, ctx)
        pmat = O.CKMaterial(ctx, "patchmat")
        pmat.SetDiffuse((0.45, 0.55, 0.75, 1.0))
        pmat.SetPower(16.0)
        pmesh.ApplyGlobalMaterial(pmat)
        ground = O.CK3dObject(ctx, "patchground")
        ground.SetCurrentMesh(pmesh)
        ground.SetPosition((0.0, -3.5, 0.0))
    if not rc.BindAnimation(clip):
        raise RuntimeError("the config-4 clip did not bind to the device")
    state = {"t": 0.0}

    def tick():
        state["t"] = (state["t"] + 0.5) % clip.GetLength()
        clip.SetFrame(state["t"])

    return ctx, rc, tick


def build_config4(O, width: int = 1024, height: int = 768,
                  n_bones: int = 128, rings_per_bone: int = 4,
                  ring_verts: int = 120, antialias: bool = False,
                  **ctx_kw):
    """BASELINE config 4 (``benchmarks/baseline.py:369-417``): a tube of
    61,440 vertices and 122,640 triangles at the defaults, skinned to 128
    bones, with a keyed clip of 13 keys on each of 128 rotation tracks
    bound to the render context (device animation), over a Bezier patch
    sheet of 36 patches tessellated at iteration 5 (1,800 faces, its own
    lit material), at 1024x768: 124,440 triangles. Returns (ctx, rc,
    tick); ``tick()`` advances the clip by 0.5 frames modulo its length,
    as the source's tick does."""
    return _config4(O, width, height, n_bones, rings_per_bone, ring_verts,
                    True, antialias, ctx_kw)


def build_config4_skin(O, width: int = 1024, height: int = 768,
                       n_bones: int = 128, rings_per_bone: int = 4,
                       ring_verts: int = 120, antialias: bool = False,
                       **ctx_kw):
    """:func:`build_config4` without its Bezier patch sheet: the tube,
    bones, clip, camera, light and frame of config 4 alone, for comparing
    with measurements taken before the sheet was carried. Returns (ctx, rc,
    tick)."""
    return _config4(O, width, height, n_bones, rings_per_bone, ring_verts,
                    False, antialias, ctx_kw)


def build_config5(O, width: int = 1024, height: int = 768,
                  terrain_n: int = 500, n_balls: int = 64,
                  antialias: bool = False, **ctx_kw):
    """Ballance-scale level (BASELINE config 5, ``bench.build_scene``): a
    terrain of 2*terrain_n^2 triangles (528,032 triangles in all at the
    default 500), 64 spheres under a rotating parent, linear fog, textures,
    specular, a point and a directional light, places with a portal, and
    host chunk culling. Returns (ctx, rc, spinner); rotate ``spinner``
    about y per tick."""
    ctx = _context(O, antialias, ctx_kw)
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 18.0, -60.0))
    cam.SetOrientation((0.0, -0.25, 1.0))
    cam.SetFrontPlane(1.0)
    cam.SetBackPlane(4000.0)
    rc.AttachViewpointToCamera(cam)

    # The world lives in place_main; an annex room is reachable through a
    # portal window (its content draws scissored to the portal's screen
    # rect), and an unconnected room's content is culled by the portal
    # traversal (reference RCKPlace portals, src/CKSceneGraph.cpp:113-128).
    place_main = O.CKPlace(ctx, "place_main")
    place_annex = O.CKPlace(ctx, "place_annex")
    place_hidden = O.CKPlace(ctx, "place_hidden")
    cam.SetParent(place_main)
    rc.SetFogMode(3)
    rc.SetFogStart(60.0)
    rc.SetFogEnd(400.0)
    rc.SetFogColor((0.35, 0.4, 0.5))
    rc.SetBackgroundColor((0.35, 0.4, 0.5, 1.0))

    tex = O.CKTexture(ctx, "checker")
    img = (np.indices((32, 32)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img * 0.6 + 0.3, img * 0.5 + 0.35,
                           img * 0.4 + 0.3, np.ones_like(img)], -1))

    tverts, tuv, tfaces = make_terrain(terrain_n, 300.0, 4.0)
    terrain_mesh = O.CKMesh(ctx, "terrain")
    terrain_mesh.SetPositions(tverts)
    terrain_mesh.SetUVs(tuv)
    terrain_mesh.SetFaces(tfaces)
    terrain_mesh.BuildNormals()
    tmat = O.CKMaterial(ctx, "terrainmat")
    tmat.SetDiffuse((0.75, 0.8, 0.7, 1.0))
    tmat.SetTexture(tex)
    terrain_mesh.ApplyGlobalMaterial(tmat)
    terrain = O.CK3dObject(ctx, "terrain")
    terrain.SetCurrentMesh(terrain_mesh)
    terrain.SetParent(place_main)

    spts, suv, sfaces = make_sphere(12, 18, 1.6)
    sphere_mesh = O.CKMesh(ctx, "sphere")
    sphere_mesh.SetPositions(spts)
    sphere_mesh.SetUVs(suv)
    sphere_mesh.SetFaces(sfaces)
    sphere_mesh.BuildNormals()
    smat = O.CKMaterial(ctx, "spheremat")
    smat.SetDiffuse((0.85, 0.3, 0.2, 1.0))
    smat.SetPower(24.0)
    sphere_mesh.ApplyGlobalMaterial(smat)
    rng = np.random.default_rng(7)
    spinner = O.CK3dObject(ctx, "spinner")   # rotating parent
    spinner.SetParent(place_main)
    for i in range(n_balls):
        ball = O.CK3dObject(ctx, f"ball{i}")
        ball.SetCurrentMesh(sphere_mesh)
        ball.SetParent(spinner)
        x, z = rng.uniform(-120, 120, 2)
        ball.SetPosition((x, 6.0 + rng.uniform(0, 6), z + 40), ref=spinner)

    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.4, -1.0, 0.3))
    sun.SetSpecularFlag(True)
    bulb = O.CKLight(ctx, "bulb")
    bulb.SetType(int(VXLIGHT.POINT))
    bulb.SetPosition((0.0, 25.0, 0.0))
    bulb.SetColor((0.5, 0.6, 1.0, 1.0))
    bulb.SetRange(250.0)

    crate_mesh = O.CKMesh(ctx, "crate")
    cverts, cfaces = _cube(1.8)
    crate_mesh.SetPositions(cverts)
    crate_mesh.SetFaces(cfaces)
    crate_mesh.BuildNormals()
    cmat = O.CKMaterial(ctx, "cratemat")
    cmat.SetDiffuse((0.8, 0.65, 0.3, 1.0))
    crate_mesh.ApplyGlobalMaterial(cmat)
    for i in range(24):
        crate = O.CK3dObject(ctx, f"crate{i}")
        crate.SetCurrentMesh(crate_mesh)
        crate.SetParent(place_annex)
        crate.SetPosition((-30.0 + (i % 6) * 5.0, 12.0 + (i // 6) * 5.0,
                           60.0))
    for i in range(8):
        ghost = O.CK3dObject(ctx, f"ghost{i}")
        ghost.SetCurrentMesh(crate_mesh)
        ghost.SetParent(place_hidden)
        ghost.SetPosition((i * 4.0 - 16.0, 10.0, 20.0))

    door = O.CK3dObject(ctx, "door")
    dm = O.CKMesh(ctx, "doorm")
    dm.SetPositions(np.array(
        [[-45.0, 2.0, 30.0], [-10.0, 2.0, 30.0],
         [-10.0, 30.0, 30.0], [-45.0, 30.0, 30.0]], np.float32))
    dm.SetFaces(np.zeros((0, 3), np.int32))    # portal geometry only
    door.SetCurrentMesh(dm)
    place_main.AddPortal(place_annex, door)
    rc.EnablePortalTraversal(True)
    return ctx, rc, spinner


# config5_shaded's stages. The wave's amplitude stays well inside the host
# chunk cull's 0.5 world-unit slack, since both packages cull the
# undisplaced bounds before the vertex stage.
WAVE_AMP = 0.2
WAVE_K = 0.5                 # rad per world unit along x (z at half rate)
BAND_FREQ = 6.2831855        # one band per texture repeat in u
TINT = (1.0, 0.94, 0.86)


def config5_shaders(xp, spinner_row: int, width: int, height: int):
    """(vertex_shader, pixel_shader) of :func:`build_config5_shaded`,
    written once against the array namespace ``xp`` (``torch`` for this
    package, ``jax.numpy`` for the reference), so both packages render the
    same stages.

    - The vertex shader lifts every row by a travelling wave in world y,
      ``WAVE_AMP * sin(k (x + z/2) - a)``, and tilts its normal by the
      wave's gradient. Its phase ``a`` is the spinner's rotation, read from
      ``scene.local[spinner_row]`` (cos a, sin a): a per-frame input that
      reaches a captured frame through the scene.
    - The pixel shader reads all six inputs: ``texel`` x ``color`` (as
      MODULATE), a DP3 gain where ``si[..., SI_TEXBLEND]`` is DOTPRODUCT3
      (the checker terrain), a tint from ``sf[..., SF_CONST_R:+3]``, a
      band in ``uv`` and a vignette in ``xy`` about the centre of the
      ``width`` x ``height`` render target."""
    from .raster.types import SF_CONST_R, SI_TEXBLEND, VXTEXTUREBLEND

    dp3_mode = int(VXTEXTUREBLEND.DOTPRODUCT3)
    cx, cy = 0.5 * width, 0.5 * height

    def vertex_shader(posw, nrmw, scene):
        rot = scene.local[spinner_row]
        ca, sa = rot[0, 0], rot[0, 2]
        th = WAVE_K * (posw[:, 0] + 0.5 * posw[:, 2])
        st, ct = xp.sin(th), xp.cos(th)
        wave = WAVE_AMP * (st * ca - ct * sa)             # sin(th - a)
        slope = WAVE_AMP * WAVE_K * (ct * ca + st * sa)   # its d/dth
        pos = xp.stack([posw[:, 0], posw[:, 1] + wave, posw[:, 2]], -1)
        nrm = xp.stack([nrmw[:, 0] - slope * nrmw[:, 1], nrmw[:, 1],
                        nrmw[:, 2] - 0.5 * slope * nrmw[:, 1]], -1)
        return pos, nrm

    def pixel_shader(inp):
        color, texel, uv, xy = inp["color"], inp["texel"], inp["uv"], inp["xy"]
        si, sf = inp["si"], inp["sf"]
        dot = ((texel[..., 0] - 0.5) * (color[..., 0] - 0.5)
               + (texel[..., 1] - 0.5) * (color[..., 1] - 0.5)
               + (texel[..., 2] - 0.5) * (color[..., 2] - 0.5)) * 4.0
        gain = xp.where(si[..., SI_TEXBLEND] == dp3_mode,
                        0.75 + 0.5 * xp.clip(dot, 0.0, 1.0), 1.0)
        band = 0.88 + 0.12 * xp.cos(uv[..., 0] * BAND_FREQ)
        dx = (xy[..., 0] - cx) / cx
        dy = (xy[..., 1] - cy) / cy
        shade = gain * band * (1.0 - 0.3 * (dx * dx + dy * dy))
        rgb = [texel[..., c] * color[..., c] * shade
               * (sf[..., SF_CONST_R + c] * TINT[c]) for c in range(3)]
        return xp.stack(rgb + [texel[..., 3] * color[..., 3]], -1)

    return vertex_shader, pixel_shader


def build_config5_shaded(O, width: int = 1024, height: int = 768,
                         terrain_n: int = 500, n_balls: int = 64,
                         alpha_sheet: bool = False, antialias: bool = False,
                         xp=None, **ctx_kw):
    """Config 5 (:func:`build_config5`: 528,032 triangles, fog, textures,
    specular, portals, host chunk culling) with a vertex and a pixel shader
    (:func:`config5_shaders`, built on ``xp``, default ``torch``; pass
    ``jax.numpy`` with the reference's objects). The terrain material's
    texture blend is DOTPRODUCT3, the state the pixel shader keys its DP3
    gain on. ``alpha_sheet``: one alpha-blended textured 8-triangle sheet
    in front of the camera, which the ordered pass composites under the
    pixel shader (the flat ordered pass up to 1024x768). Returns (ctx, rc,
    spinner); rotate ``spinner`` about y per tick (the wave's phase)."""
    from .raster.types import VXTEXTUREBLEND

    if xp is None:
        import torch as xp
    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, antialias=antialias,
                                     **ctx_kw)
    ctx.GetObjectByName("terrainmat").SetTextureBlendMode(
        int(VXTEXTUREBLEND.DOTPRODUCT3))
    if alpha_sheet:
        rng = np.random.default_rng(15)
        mat = _fx_material(O, ctx, "sheetmat", (1.0, 1.0, 1.0, 1.0),
                           _seeded_texture(O, ctx, "sheettex", rng, 32,
                                           alpha=0.55))
        mat.SetTwoSided(True)
        _grid_object(O, ctx, "sheet", 2, (-12.0, 2.0, 0.0), (24.0, 0.0, 0.0),
                     (0.0, 10.0, 0.0), mat, ctx.GetObjectByName("place_main"))
    ss = 2 if antialias else 1
    vs, ps = config5_shaders(xp, spinner.row, width * ss, height * ss)
    rc.SetVertexShader(vs)
    rc.SetPixelShader(ps)
    return ctx, rc, spinner


def build_config5_monitor(O, width: int = 1024, height: int = 768,
                          target=(512, 384), stereo=None,
                          terrain_n: int = 500, n_balls: int = 64,
                          antialias: bool = False, **ctx_kw):
    """Config 5 (:func:`build_config5`) with a live monitor: a second
    render context of size ``target`` (the producer) renders the level
    from a security camera high over the field into a target texture
    (``SetTargetTexture``), and a 9.6 x 7.2 screen in the level, 40 units in
    front of the main camera, samples that texture with a trilinear
    (``LINEARMIPLINEAR``) filter through an emissive white material. The
    producer's camera does not see the screen. ``stereo``:
    (eye_separation, focal_length) switches the main context to stereo —
    (1.2, 60.0) at full size, the main camera standing 60 units from the
    origin. Each tick: rotate ``spinner`` about y, Render() the producer,
    then the main context. Returns (ctx, rc, producer, spinner)."""
    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, antialias=antialias,
                                     **ctx_kw)
    place_main = ctx.GetObjectByName("place_main")
    producer = ctx.GetRenderManager().CreateRenderContext(*target)
    cam = O.CKCamera(ctx, "monitor_cam")
    cam.SetPosition((0.0, 40.0, -30.0))
    cam.SetOrientation((0.0, -0.5, 1.0))
    cam.SetFov(0.9)
    cam.SetFrontPlane(1.0)
    cam.SetBackPlane(4000.0)
    cam.SetParent(place_main)
    producer.AttachViewpointToCamera(cam)
    producer.SetFogMode(3)
    producer.SetFogStart(60.0)
    producer.SetFogEnd(400.0)
    producer.SetFogColor((0.35, 0.4, 0.5))
    producer.SetBackgroundColor((0.35, 0.4, 0.5, 1.0))
    producer.EnablePortalTraversal(True)
    feed = O.CKTexture(ctx, "monitor_feed")
    producer.SetTargetTexture(feed)

    quad = O.CKMesh(ctx, "screen_mesh")
    quad.SetPositions(np.array(
        [[-4.8, 6.5, -20.0], [4.8, 6.5, -20.0], [4.8, 13.7, -20.0],
         [-4.8, 13.7, -20.0]], np.float32))
    quad.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    # Row 0 of the feed is the top of the producer's frame.
    quad.SetUVs(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32))
    quad.BuildNormals()
    mat = O.CKMaterial(ctx, "screenmat")
    mat.SetDiffuse((0.0, 0.0, 0.0, 1.0))
    mat.SetAmbient((0.0, 0.0, 0.0, 1.0))
    mat.SetSpecular((0.0, 0.0, 0.0, 1.0))
    mat.SetEmissive((1.0, 1.0, 1.0, 1.0))
    mat.SetTwoSided(True)
    mat.SetTexture(feed)
    mat.SetTextureMinMode(int(VXTEXTURE_FILTER.LINEARMIPLINEAR))
    mat.SetTextureMagMode(int(VXTEXTURE_FILTER.LINEARMIPLINEAR))
    quad.ApplyGlobalMaterial(mat)
    screen = O.CK3dObject(ctx, "screen")
    screen.SetCurrentMesh(quad)
    screen.SetParent(place_main)
    if stereo is not None:
        rc.SetStereoParameters(*stereo)
    return ctx, rc, producer, spinner


def _deferred(rc, mesh, ent):
    """A render callback that draws nothing: the mesh stays out of the
    frame and draws later, from the context's post-render callback
    (``RenderTransparents``)."""


def _card_texture(O, ctx, name):
    """A 16x16 card texture: a warm tint, alpha 0 on a checker of 4x4
    texel holes and 1 elsewhere."""
    i, j = np.indices((16, 16))
    a = ((i // 4 + j // 4) % 2).astype(np.float32)
    img = np.stack([np.full_like(a, 0.85), 0.55 + 0.02 * i, 0.3 + 0.02 * j,
                    a], -1).astype(np.float32)
    tex = O.CKTexture(ctx, name)
    tex.SetImage(img)
    return tex


def _halo_texture(O, ctx, name):
    """A 16x16 opaque radial glow: bright at the centre, dark at the
    rim."""
    i, j = np.indices((16, 16)).astype(np.float32)
    r = np.hypot(i - 7.5, j - 7.5) / 7.5
    g = np.clip(1.0 - r, 0.05, 1.0)
    img = np.stack([g, g, 0.8 * g + 0.1, np.ones_like(g)],
                   -1).astype(np.float32)
    tex = O.CKTexture(ctx, name)
    tex.SetImage(img)
    return tex


def build_config5_immediate(O, width: int = 1024, height: int = 768,
                            terrain_n: int = 500, n_balls: int = 64,
                            n_props: int = 8, n_cards: int = 2,
                            n_blended: int = 4, n_halos: int = 64,
                            antialias: bool = False, **ctx_kw):
    """Config 5 (:func:`build_config5`) with immediate-mode draws, as a
    level with custom-render objects and a HUD draws them:

    - ``n_props`` 12-triangle cubes in front of the camera whose meshes
      draw themselves through ``SetRenderCallBack`` -> ``DefaultRender``
      -> ``RenderGroup`` -> ``DrawPrimitive`` (their triangles stay out of
      the frame); the first ``n_cards`` carry an alpha-tested card texture
      with holes (:func:`_card_texture`);
    - ``n_blended`` alpha-blended cubes whose render callback draws
      nothing: the context's post-render callback draws them far to near
      through ``RenderTransparents``;
    - ``n_halos`` ``CKSprite3D`` halos with an opaque glow texture,
      hidden from the frame, which the post-render callback queues with
      ``AddSprite3DBatch`` and draws with ``CallSprite3DBatches``;
    - a 2-triangle HUD quad the post-render callback draws last through
      ``LockCurrentVB`` / ``ReleaseCurrentVB``.

    At the defaults a tick draws 274 immediate triangles in 14
    ``DrawPrimitive`` calls (328 with each call's padding to a multiple of
    8). Returns (ctx, rc, spinner, imm): ``imm`` holds the objects
    ("props", "cards", "blended", "halos") and ``imm["on"]``, which the
    callbacks read: False makes them draw nothing, with the frame's compile
    unchanged."""
    from .raster.types import VXBLEND, VXCMP, VXPRIMITIVE

    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, antialias=antialias,
                                     **ctx_kw)
    place_main = ctx.GetObjectByName("place_main")
    rng = np.random.default_rng(19)
    imm = {"on": True, "props": [], "cards": [], "blended": [], "halos": []}
    cverts, cfaces = _cube(1.5)
    # The cube's UVs from its x and y: the faces facing -z and +z show the
    # whole image.
    cuv = np.stack([(cverts[:, 0] / 1.5 + 1.0) * 0.5,
                    (1.0 - cverts[:, 1] / 1.5) * 0.5], -1).astype(np.float32)

    def cube(name, mat, pos, callback):
        mesh = O.CKMesh(ctx, name + "_mesh")
        mesh.SetPositions(cverts)
        mesh.SetFaces(cfaces)
        mesh.SetUVs(cuv)
        mesh.BuildNormals()
        mesh.ApplyGlobalMaterial(mat)
        ent = O.CK3dObject(ctx, name)
        ent.SetCurrentMesh(mesh)
        ent.SetParent(place_main)
        ent.SetPosition(pos)
        mesh.SetRenderCallBack(callback, ent)
        return ent

    def draw_mesh(rc, mesh, ent):
        # The render callback, with the entity as its argument: the mesh
        # draws itself (DefaultRender -> RenderGroup -> DrawPrimitive).
        if imm["on"]:
            mesh.DefaultRender(rc, ent)

    card_tex = _card_texture(O, ctx, "card_tex") if n_cards else None
    for i in range(n_props):
        mat = O.CKMaterial(ctx, f"prop_mat{i}")
        mat.SetDiffuse(tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,))
        if i < n_cards:
            mat.SetTexture(card_tex)
            mat.EnableAlphaTest(True)
            mat.SetAlphaFunc(int(VXCMP.GREATER))
            mat.SetAlphaRef(128)
        x = -24.0 + 48.0 * i / max(n_props - 1, 1)
        ent = cube(f"prop{i}", mat, (x, 7.0 + (i % 3), 10.0 + 3.0 * (i % 2)),
                   draw_mesh)
        imm["props"].append(ent)
        if i < n_cards:
            imm["cards"].append(ent)
    for i in range(n_blended):
        mat = O.CKMaterial(ctx, f"glass_mat{i}")
        mat.SetDiffuse(tuple(rng.uniform(0.3, 1.0, 3)) + (0.45,))
        mat.EnableAlphaBlend(True)
        mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
        mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
        mat.EnableZWrite(False)
        mat.SetTwoSided(True)
        x = -12.0 + 24.0 * i / max(n_blended - 1, 1)
        imm["blended"].append(cube(f"glass{i}", mat,
                                   (x, 10.0, 6.0 * i), _deferred))
    # An opaque halo material: the hidden sprites' triangles stay in the
    # frame's opaque stream (invalid), so the frame has no ordered pass.
    halo_mat = O.CKMaterial(ctx, "halo_mat")
    halo_mat.SetDiffuse((1.0, 0.85, 0.4, 1.0))
    halo_mat.SetTexture(_halo_texture(O, ctx, "halo_tex"))
    for i in range(n_halos):
        sp = O.CKSprite3D(ctx, f"halo{i}")
        sp.SetMaterial(halo_mat)
        x, z = rng.uniform(-40.0, 40.0), rng.uniform(0.0, 60.0)
        sp.SetPosition((x, 5.0 + rng.uniform(0.0, 4.0), z))
        sp.SetSize((1.5, 1.5))
        sp.Show(False)                  # drawn by the callback, not the frame
        imm["halos"].append(sp)
    hud_mat = O.CKMaterial(ctx, "hud_mat")
    hud_mat.SetDiffuse((0.1, 0.25, 0.4, 0.6))
    hud_mat.EnableAlphaBlend(True)
    hud_mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
    hud_mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
    hud_mat.SetTwoSided(True)
    # The HUD quad in clip space, a fan over the top-left corner.
    hud = np.array([[-0.95, 0.95, 0.0, 1.0], [-0.55, 0.95, 0.0, 1.0],
                    [-0.55, 0.7, 0.0, 1.0], [-0.95, 0.7, 0.0, 1.0]],
                   np.float32)

    def post(rc, arg):
        if not imm["on"]:
            return
        rc.RenderTransparents()
        for sp in imm["halos"]:
            rc.AddSprite3DBatch(sp)
        rc.CallSprite3DBatches()
        pos, col, uv = rc.LockCurrentVB(4)
        pos[:] = hud
        col[:] = hud_mat.GetDiffuse()
        uv[:] = 0.0
        rc.SetCurrentMaterial(hud_mat)
        rc.ReleaseCurrentVB(int(VXPRIMITIVE.TRIANGLEFAN))
        rc.SetCurrentMaterial(None)

    rc.AddPostRenderCallBack(post)
    return ctx, rc, spinner, imm


def build_config5_debug(O, width: int = 1024, height: int = 768,
                        terrain_n: int = 500, n_balls: int = 64,
                        grid_n: int = 64, n_arm_bones: int = 16,
                        arm_ring_verts: int = 24, n_targets: int = 8,
                        seed: int = 20, antialias: bool = False, **ctx_kw):
    """Config 5 (:func:`build_config5`) as a level is debugged, with
    ``EnableDebugMode`` on:

    - a shown ``CKGrid`` of ``grid_n`` x ``grid_n`` unit squares over the
      terrain (its debug mesh: a half-transparent quad textured with the
      layers' colours and an orange wireframe border) with two layers,
      "floor" (red) and "zone" (blue), filled from ``seed``;
    - an arm: :func:`make_skinned_tube` with ``n_arm_bones`` bones and no
      clip, standing up from the ground in front of the camera, whose bone
      chain a ``CKKinematicChain`` drives; the middle third of its bones
      have joint limits of +-0.6 rad about each axis;
    - a context post-render callback that draws the PV watermark (its
      texture loaded at build, so the first frame's callback adds no
      object).

    The grid and the arm have render priorities 2 and 1, so debug
    stepping reaches them first, then the level's entities in row order.

    A tick calls ``chain.IKSetEffectorPos`` (one of ``n_targets`` targets
    on a circle above the arm's base, within its reach) and
    ``rc.DebugStep()`` before ``Render()``. Returns (ctx, rc, spinner,
    dbg): ``dbg`` holds "grid", "layers", "chain", "bones", "arm" and
    "targets" ((n_targets, 3) world points)."""
    A = importlib.import_module(O.__name__.rpartition(".")[0] + ".anim")
    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, antialias=antialias,
                                     **ctx_kw)
    ctx.GetRenderManager().SetRenderOptions("EnableDebugMode", 1)
    place_main = ctx.GetObjectByName("place_main")
    rng = np.random.default_rng(seed)

    grid = O.CKGrid(ctx, "zones")
    grid.SetParent(place_main)
    grid.SetDimensions(grid_n, grid_n)
    grid.SetPosition((-0.5 * grid_n, 5.0, 5.0))
    layers = []
    for name, color, density in (("floor", (1.0, 0.3, 0.2, 1.0), 0.5),
                                 ("zone", (0.2, 0.6, 1.0, 1.0), 0.3)):
        layer = grid.AddLayer(name)
        vals = rng.integers(64, 256, (grid_n, grid_n))
        layer.SetSquareArray(vals * (rng.random((grid_n, grid_n))
                                     < density))
        layer.SetColor(color)
        layers.append(layer)
    grid.Show(True)
    grid.SetRenderPriority(2)

    base = np.array([8.0, 4.0, -12.0], np.float32)
    arm, _mesh, _skin, bones, _clip = make_skinned_tube(
        O, ctx, n_arm_bones, 4, arm_ring_verts, clip=False)
    arm.SetParent(place_main)
    arm.SetPosition(base)
    arm.SetRenderPriority(1)
    bones[0].SetParent(place_main)
    bones[0].SetPosition(base)
    bones[0].SetOrientation((0.0, 1.0, 0.0), up=(0.0, 0.0, -1.0))
    chain = A.CKKinematicChain(ctx, "arm_ik")
    chain.SetStartEffector(bones[0])
    chain.SetEndEffector(bones[-1])
    third = n_arm_bones // 3
    for b in bones[third:n_arm_bones - third]:
        b.rotation_joint.SetLimits((-0.6,) * 3, (0.6,) * 3)
    reach = chain.GetChainLength()
    ang = np.linspace(0.0, 2.0 * np.pi, n_targets, endpoint=False)
    targets = (base + np.stack([0.45 * reach * np.cos(ang),
                                0.7 * reach + 0.1 * reach * np.sin(2 * ang),
                                0.45 * reach * np.sin(ang)], -1)
               ).astype(np.float32)

    rc.LoadPVInformationTexture()
    rc.AddPostRenderCallBack(lambda rc_, arg: rc_.DrawPVInformationWatermark())
    dbg = {"grid": grid, "layers": layers, "chain": chain, "bones": bones,
           "arm": arm, "targets": targets}
    return ctx, rc, spinner, dbg


def _terrain_height(x, z, amp: float = 4.0):
    """Height of :func:`make_terrain`'s surface at (x, z)."""
    return amp * (np.sin(x * 0.15) * np.cos(z * 0.2)
                  + 0.3 * np.sin(x * 0.7 + z * 0.5))


def _fx_material(O, ctx, name, diffuse, texture=None, blend=True):
    """An unlit sprite material: ``diffuse`` (the sprites' vertex colour)
    modulating ``texture``; with ``blend`` alpha-over (SRCALPHA,
    INVSRCALPHA) with z-write off, else opaque."""
    from .raster.types import VXBLEND

    mat = O.CKMaterial(ctx, name)
    mat.SetDiffuse(diffuse)
    if texture is not None:
        mat.SetTexture(texture)
    if blend:
        mat.EnableAlphaBlend(True)
        mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
        mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
        mat.EnableZWrite(False)
    return mat


def build_config5_fx(O, width: int = 1024, height: int = 768,
                     terrain_n: int = 500, n_balls: int = 64,
                     n_sprites: int = 2048, n_curves: int = 16,
                     curve_steps: int = 64, textured_halos: bool = True,
                     alpha_cards: bool = False, antialias: bool = False,
                     **ctx_kw):
    """Config 5 (:func:`build_config5`) with a Ballance level's effects:
    3D sprites, curves and lines, placed from a seed. Returns (ctx, rc,
    spinner); rotate ``spinner`` about y per tick.

    - ``n_sprites`` CKSprite3D (2 triangles each): half glow halos (a 32x32
      radial alpha texture, alpha-over, z-write off, MODE_BILLBOARD), a
      quarter untextured sparks (alpha-over, z-write off, half
      MODE_XROTATE and half MODE_YROTATE), one halo per sphere parented to
      it (MODE_ORIENTABLE, so they move with the spinner), and the rest
      textured opaque tree cards standing on the terrain (z-write on,
      MODE_YROTATE). At the default 2,048: 1,024 + 512 + 64 + 448.
    - ``n_curves`` CKCurve rails of 12 control points at step count
      ``curve_steps`` (closed TCB, open linear, open TCB with tension,
      continuity and bias, closed with a fitting coefficient and linear
      points, in turn), a wireframe-fill 8x8 quad grid (208 edges) and a
      64-segment line-list mesh under the spinner: at the defaults 1,192
      line segments.

    The TexturedPeel option is on, so the transparent sprites take the
    textured peel (B4); with ``textured_halos`` off every transparent
    sprite is untextured and they take the ordered blend (B3). One frame
    takes one ordered route. The tree cards are opaque, not alpha-tested:
    an alpha-tested state that writes z lies outside both ordered kernels'
    envelopes and sends the whole ordered pass to its exact tiled form,
    which reads the host inside the frame, so such a frame never runs in a
    frame window. With ``alpha_cards`` on they are that case: cutouts (the
    texture's alpha under alpha test GREATER 128) with z-write on."""
    from .raster.types import VXCMP, VXFILL

    ctx, rc, spinner = build_config5(O, width, height, terrain_n, n_balls,
                                     antialias, **ctx_kw)
    ctx.GetRenderManager().SetRenderOptions("TexturedPeel", 1)
    rng = np.random.default_rng(12)

    glow = O.CKTexture(ctx, "glow")
    yy, xx = np.mgrid[-1:1:32j, -1:1:32j]
    halo = np.clip(1.2 - np.sqrt(xx ** 2 + yy ** 2), 0, 1).astype(np.float32)
    glow.SetImage(np.stack([halo, halo * 0.9, halo * 0.3, halo], -1))
    bark = O.CKTexture(ctx, "treecard")
    ty, tx = np.mgrid[0:32, 0:16]
    crown = (np.abs(tx - 7.5) < (ty * 0.25 + 1.0)).astype(np.float32)
    bark.SetImage(np.stack([0.2 + 0.3 * crown, 0.3 + 0.4 * crown,
                            0.15 + 0.1 * crown,
                            crown if alpha_cards else np.ones_like(crown)],
                           -1))
    halo_mat = _fx_material(O, ctx, "halomat", (1.0, 0.9, 0.6, 1.0),
                            glow if textured_halos else None)
    spark_mat = _fx_material(O, ctx, "sparkmat", (1.0, 0.6, 0.2, 0.6))
    card_mat = _fx_material(O, ctx, "cardmat", (1.0, 1.0, 1.0, 1.0), bark,
                            blend=False)
    if alpha_cards:
        card_mat.EnableAlphaTest(True)
        card_mat.SetAlphaFunc(int(VXCMP.GREATER))
        card_mat.SetAlphaRef(128)

    n_halo = n_sprites // 2
    n_spark = n_sprites // 4
    n_card = max(n_sprites - n_halo - n_spark - n_balls, 0)

    def sprite(name, mat, mode, size, pos, parent=None):
        sp = O.CKSprite3D(ctx, name)
        sp.SetMaterial(mat)
        sp.SetMode(mode)
        sp.SetSize(size)
        if parent is not None:
            sp.SetParent(parent)
            sp.SetPosition(pos, ref=parent)
        else:
            sp.SetPosition(pos)
        return sp

    def ground(z0, z1, spread=0.3):
        # (x, z) in the camera's view (its half-width at depth d is ~0.3 d)
        # or, with a wider ``spread``, around it.
        z = rng.uniform(z0, z1)
        return rng.uniform(-spread, spread) * (z + 62.0), z

    S3 = O.CKSprite3D
    for i in range(n_halo):
        x, z = ground(-10, 300, spread=0.6)
        s = float(rng.uniform(2.0, 5.0))
        sprite(f"halo{i}", halo_mat, S3.MODE_BILLBOARD, (s, s),
               (x, float(_terrain_height(x, z)) + rng.uniform(4, 18), z))
    for i in range(n_spark):
        x, z = ground(-15, 160)
        s = float(rng.uniform(0.6, 1.5))
        sprite(f"spark{i}", spark_mat,
               S3.MODE_XROTATE if i % 2 == 0 else S3.MODE_YROTATE, (s, s),
               (x, float(_terrain_height(x, z)) + rng.uniform(1, 12), z))
    for i in range(n_card):
        x, z = ground(0, 280)
        h = float(rng.uniform(5.0, 9.0))
        sprite(f"card{i}", card_mat, S3.MODE_YROTATE, (h * 0.5, h),
               (x, float(_terrain_height(x, z)) + h * 0.5, z))
    for i in range(n_balls):
        ball = ctx.GetObjectByName(f"ball{i}")
        sprite(f"ballhalo{i}", halo_mat, S3.MODE_ORIENTABLE, (4.0, 4.0),
               (0.0, 0.0, -2.0), parent=ball)

    # Rails: 12 control points each, on a loop or a wave over the terrain.
    for k in range(n_curves):
        cx, cz = ground(-15, 40)
        cv = O.CKCurve(ctx, f"rail{k}")
        cv.SetPosition((cx, float(_terrain_height(cx, cz)) + 5.0, cz))
        kind = k % 4
        ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        for j in range(12):
            if kind in (0, 3):
                p = (8 * np.cos(ang[j]), 1.5 * np.sin(3 * ang[j]),
                     6 * np.sin(ang[j]))
            else:
                p = (-15 + 2.75 * j, 2 * np.sin(j * 0.9),
                     4 * np.cos(j * 0.7))
            cp = cv.AddControlPoint(np.asarray(p, np.float32))
            if kind == 1 or (kind == 3 and j % 3 == 0):
                cp.SetLinear(True)
            if kind == 2:
                cp.SetTension(float(rng.uniform(-0.5, 0.5)))
                cp.SetContinuity(float(rng.uniform(-0.5, 0.5)))
                cp.SetBias(float(rng.uniform(-0.5, 0.5)))
        if kind in (0, 3):
            cv.Close()
        if kind == 3:
            cv.SetFittingCoeff(0.3)
        cv.SetStepCount(curve_steps)
        cv.SetColor((float(rng.uniform(0.5, 1)), float(rng.uniform(0.5, 1)),
                     float(rng.uniform(0.2, 1)), 1.0))

    # A wireframe 8x8 quad grid standing upright.
    g = np.linspace(-8.0, 8.0, 9, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    grid = O.CKMesh(ctx, "wiregrid")
    grid.SetPositions(np.stack([gx + 10.0, gy + 12.0,
                                np.full_like(gx, 70.0)], -1).reshape(-1, 3))
    a = (np.arange(8)[:, None] * 9 + np.arange(8)[None]).reshape(-1)
    grid.SetFaces(np.concatenate([np.stack([a, a + 1, a + 10], -1),
                                  np.stack([a, a + 10, a + 9], -1)]).astype(
        np.int32))
    grid.BuildNormals()
    wmat = O.CKMaterial(ctx, "wiremat")
    wmat.SetDiffuse((0.2, 0.9, 0.4, 1.0))
    wmat.SetFillMode(int(VXFILL.WIREFRAME))
    wmat.SetTwoSided(True)
    grid.ApplyGlobalMaterial(wmat)
    O.CK3dObject(ctx, "wiregrid").SetCurrentMesh(grid)

    # A 64-segment line list (a star of chords) turning with the spinner.
    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    star = O.CKMesh(ctx, "star")
    star.SetPositions(np.stack([12 * np.cos(ang), np.full_like(ang, 7.0),
                                12 * np.sin(ang) + 40], -1).astype(
        np.float32))
    star.SetColors(np.tile(np.array([1.0, 0.3, 0.8, 1.0], np.float32),
                           (64, 1)))
    star.SetLineCount(64)
    for i in range(64):
        star.SetLine(i, i, (i + 27) % 64)
    st = O.CK3dObject(ctx, "star")
    st.SetCurrentMesh(star)
    st.SetParent(spinner)
    return ctx, rc, spinner


def make_grid(n: int, origin, du, dv):
    """An n x n quad grid (2 n^2 triangles) spanning ``origin`` + [0,1]
    ``du`` + [0,1] ``dv``, with UVs in [0,1]^2: (positions, uvs, faces)."""
    t = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    gu, gv = np.meshgrid(t, t, indexing="ij")
    pts = (np.asarray(origin, np.float32)
           + gu[..., None] * np.asarray(du, np.float32)
           + gv[..., None] * np.asarray(dv, np.float32))
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + 1, a + n + 2], -1),
                            np.stack([a, a + n + 2, a + n + 1], -1)])
    return (pts.reshape(-1, 3).astype(np.float32),
            np.stack([gu, gv], -1).reshape(-1, 2).astype(np.float32),
            faces.astype(np.int32))


def _grid_object(O, ctx, name, n, origin, du, dv, mat, parent):
    pts, uv, faces = make_grid(n, origin, du, dv)
    mesh = O.CKMesh(ctx, name)
    mesh.SetPositions(pts)
    mesh.SetUVs(uv)
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, name)
    obj.SetCurrentMesh(mesh)
    obj.SetParent(parent)
    return obj, mesh


def _seeded_texture(O, ctx, name, rng, size: int, alpha=None):
    """A smooth seeded RGBA texture: a 4x4 random colour lattice, wrapped
    and interpolated bilinearly to ``size`` x ``size``; ``alpha`` a fixed
    alpha (else 1)."""
    lat = rng.uniform(0.15, 0.95, (4, 4, 3)).astype(np.float32)
    t = np.arange(size, dtype=np.float32) * (4.0 / size)
    i0 = np.floor(t).astype(int)
    f = (t - i0)[:, None]
    rows = lat[i0] * (1 - f[..., None]) + lat[(i0 + 1) % 4] * f[..., None]
    img = (rows[:, i0] * (1 - f[None]) + rows[:, (i0 + 1) % 4] * f[None])
    a = np.full((size, size, 1), 1.0 if alpha is None else alpha, np.float32)
    tex = O.CKTexture(ctx, name)
    tex.SetImage(np.concatenate([img, a], -1).astype(np.float32))
    return tex


def build_config5_mat(O, width: int = 1024, height: int = 768,
                      terrain_n: int = 500, n_balls: int = 64,
                      effect_passes: bool = False, water_n: int = 32,
                      plaza_n: int = 48, pass_n: int = 16,
                      antialias: bool = False, **ctx_kw):
    """Config 5 (:func:`build_config5`) with the material effects a Ballance
    level uses, made from a seed. Returns (ctx, rc, spinner).

    Default variant, every draw inside the kernels' envelopes (the frame
    runs in frame windows):

    - chrome TexGen on the spheres (a 64x64 env texture);
    - cube-environment TexGen on the 24 annex crates (six seeded 32x32
      faces baked by ``SetCubeMapFaces`` into a 128x128 octahedral atlas);
    - a water sheet of ``water_n`` x ``water_n`` quads with reflection
      TexGen (VXEFFECT_TEXGENREF);
    - a plaza of ``plaza_n`` x ``plaza_n`` quads with planar TexGen on its
      base pass and two alpha-over (SRCALPHA, INVSRCALPHA), z-write-off
      material channels: a detail channel with its own UVs (the base UVs
      x4) and a cube-env reflection channel with diffuse alpha 0.35. The
      TexturedPeel option is on, so their 2 x 2 plaza_n^2 ordered
      triangles take the textured peel (B4).

    With ``effect_passes`` the multi-texture effects join: a
    ``pass_n`` x ``pass_n`` wall with VXEFFECT_DP3 (a seeded normal map, the
    sun as its light), the water sheet switched to VXEFFECT_BUMPENV (bump
    map in slot 1, env map in slot 2, the default ADDSIGNED, which adds the
    REVSUBTRACT bias pass), and two ``pass_n`` x ``pass_n`` slabs with
    VXEFFECT_2TEXTURES (a lightmap, MODULATE) and VXEFFECT_3TEXTURES
    (``op2`` ADD). Their passes blend DESTCOLOR/ZERO and ONE/ONE, with
    REVSUBTRACT, outside both ordered kernels' envelopes, so such a frame
    takes the exact tiled ordered pass, as the reference does, and renders
    eagerly (never in a frame window)."""
    from .objects.material import (
        CKRST_TOP_ADD, CKRST_TOP_MODULATE, VXEFFECT_2TEXTURES,
        VXEFFECT_3TEXTURES, VXEFFECT_BUMPENV, VXEFFECT_DP3, VXEFFECT_TEXGEN,
        VXEFFECT_TEXGENREF,
    )
    from .raster.types import TEXGEN_CHROME, TEXGEN_CUBE, VXBLEND

    ctx, rc, spinner = build_config5(O, width, height, terrain_n, n_balls,
                                     antialias, **ctx_kw)
    ctx.GetRenderManager().SetRenderOptions("TexturedPeel", 1)
    rng = np.random.default_rng(13)
    place = ctx.GetObjectByName("place_main")

    env = _seeded_texture(O, ctx, "envmap", rng, 64)
    smat = ctx.GetObjectByName("spheremat")
    smat.SetTexture(env)
    smat.SetEffect(VXEFFECT_TEXGEN)
    smat.SetEffectParameter(texgen=TEXGEN_CHROME)

    cube = O.CKTexture(ctx, "cubeenv")
    faces = []
    for _f in range(6):
        base = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        img = base * rng.uniform(0.7, 1.0, (32, 32, 1)).astype(np.float32)
        faces.append(np.concatenate([img, np.ones((32, 32, 1), np.float32)],
                                    -1))
    cube.SetCubeMapFaces(faces, size=128)
    cmat = ctx.GetObjectByName("cratemat")
    cmat.SetTexture(cube)
    cmat.SetEffect(VXEFFECT_TEXGEN)
    cmat.SetEffectParameter(texgen=TEXGEN_CUBE)

    wmat = O.CKMaterial(ctx, "watermat")
    wmat.SetDiffuse((0.5, 0.65, 0.8, 1.0))
    wmat.SetTexture(_seeded_texture(O, ctx, "water", rng, 64))
    wmat.SetEffect(VXEFFECT_TEXGENREF)
    _grid_object(O, ctx, "water", water_n, (-30.0, 5.6, -34.0), (26.0, 0, 0),
                 (0, 0, 26.0), wmat, place)

    pmat = O.CKMaterial(ctx, "plazamat")
    pmat.SetDiffuse((0.8, 0.78, 0.7, 1.0))
    pmat.SetTexture(_seeded_texture(O, ctx, "paving", rng, 32))
    pmat.SetEffect(VXEFFECT_TEXGEN)                  # planar by default
    _plaza, pmesh = _grid_object(O, ctx, "plaza", plaza_n, (2.0, 6.0, -34.0),
                                 (28.0, 0, 0), (0, 0, 28.0), pmat, place)
    detail = O.CKMaterial(ctx, "detailmat")
    detail.SetDiffuse((1.0, 1.0, 1.0, 1.0))
    detail.SetTexture(_seeded_texture(O, ctx, "detail", rng, 32, alpha=0.5))
    ci = pmesh.AddChannel(detail, copy_uvs=False)
    pmesh.channels[ci]["uvs"] = (pmesh.uvs * 4.0).astype(np.float32)
    rmat = O.CKMaterial(ctx, "plazarefl")
    rmat.SetDiffuse((1.0, 1.0, 1.0, 0.35))
    rmat.SetTexture(cube)
    rmat.SetEffect(VXEFFECT_TEXGEN)
    rmat.SetEffectParameter(texgen=TEXGEN_CUBE)
    cr = pmesh.AddChannel(rmat)
    for k in (ci, cr):
        pmesh.SetChannelSourceBlend(k, int(VXBLEND.SRCALPHA))
        pmesh.SetChannelDestBlend(k, int(VXBLEND.INVSRCALPHA))
    if not effect_passes:
        return ctx, rc, spinner

    sun = ctx.GetObjectByName("sun")
    nmap = O.CKTexture(ctx, "normalmap")
    nrm = rng.normal(0.0, 0.25, (32, 32, 3)).astype(np.float32)
    nrm[..., 2] = 1.0
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nmap.SetImage(np.concatenate([nrm * 0.5 + 0.5,
                                  np.ones((32, 32, 1), np.float32)], -1))
    dmat = O.CKMaterial(ctx, "wallmat")
    dmat.SetDiffuse((0.8, 0.75, 0.7, 1.0))
    dmat.SetTwoSided(True)
    dmat.SetTexture(_seeded_texture(O, ctx, "bricks", rng, 32))
    dmat.SetTexture(nmap, 1)
    dmat.SetEffect(VXEFFECT_DP3)
    dmat.SetEffectParameter(light=sun)
    _grid_object(O, ctx, "wall", pass_n, (-10.0, 6.0, 16.0), (20.0, 0, 0),
                 (0, 8.0, 0), dmat, place)

    bump = O.CKTexture(ctx, "bump")
    b = rng.uniform(0.3, 0.7, (16, 16)).astype(np.float32)
    bump.SetImage(np.stack([b, 1.0 - b, b, np.ones_like(b)], -1))
    wmat.SetTexture(bump, 1)
    wmat.SetTexture(env, 2)
    wmat.SetEffect(VXEFFECT_BUMPENV)

    for name, eff, x0, kw in (
            ("slab2", VXEFFECT_2TEXTURES, -15.0,
             dict(op=CKRST_TOP_MODULATE)),
            ("slab3", VXEFFECT_3TEXTURES, 3.0,
             dict(op=CKRST_TOP_MODULATE, op2=CKRST_TOP_ADD))):
        m = O.CKMaterial(ctx, name + "mat")
        m.SetDiffuse((0.7, 0.7, 0.7, 1.0))
        m.SetTexture(_seeded_texture(O, ctx, name + "base", rng, 32))
        m.SetTexture(_seeded_texture(O, ctx, name + "light", rng, 16), 1)
        if eff == VXEFFECT_3TEXTURES:
            m.SetTexture(_seeded_texture(O, ctx, name + "glow", rng, 16), 2)
        m.SetEffect(eff)
        m.SetEffectParameter(**kw)
        _grid_object(O, ctx, name, pass_n, (x0, 6.5, -2.0), (12.0, 0, 0),
                     (0, 0, 12.0), m, place)
    return ctx, rc, spinner


def _alpha_stage(O, ctx, width: int, height: int):
    """Camera, sun and the 3,200-triangle opaque floor shared by the two
    transparency stress scenes (``benchmarks/stress.py``)."""
    rc = ctx.GetRenderManager().CreateRenderContext(width, height)
    cam = O.CKCamera(ctx, "cam")
    cam.SetPosition((0.0, 14.0, -40.0))
    cam.SetOrientation((0.0, -0.3, 1.0))
    cam.SetBackPlane(500.0)
    rc.AttachViewpointToCamera(cam)
    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.2, -1.0, 0.3))
    fverts, fuv, ffaces = make_terrain(40, 60.0, 1.0)
    floor_mesh = O.CKMesh(ctx, "floor")
    floor_mesh.SetPositions(fverts)
    floor_mesh.SetUVs(fuv)
    floor_mesh.SetFaces(ffaces)
    floor_mesh.BuildNormals()
    fmat = O.CKMaterial(ctx, "floormat")
    fmat.SetDiffuse((0.4, 0.45, 0.5, 1.0))
    floor_mesh.ApplyGlobalMaterial(fmat)
    floor = O.CK3dObject(ctx, "floor")
    floor.SetCurrentMesh(floor_mesh)
    return rc


def _sheets(O, ctx, name, mat, n_sheets, sheet_n, amp, seed, place):
    """``n_sheets`` copies of a (2*sheet_n^2)-triangle sheet under one
    spinner; ``place(rng, i)`` gives sheet i's position."""
    verts, uv, faces = make_terrain(sheet_n, 30.0, amp)
    mesh = O.CKMesh(ctx, name)
    mesh.SetPositions(verts)
    mesh.SetUVs(uv)
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mesh.ApplyGlobalMaterial(mat)
    rng = np.random.default_rng(seed)
    spinner = O.CK3dObject(ctx, "spin")
    for i in range(n_sheets):
        s = O.CK3dObject(ctx, f"{name}{i}")
        s.SetCurrentMesh(mesh)
        s.SetParent(spinner)
        s.SetPosition(place(rng, i), ref=spinner)
    return spinner


def build_alpha50k(O, width: int = 1024, height: int = 768,
                   n_sheets: int = 25, sheet_n: int = 31,
                   antialias: bool = False, **ctx_kw):
    """Untextured transparency at scale (``benchmarks/stress.py``
    ``case_alpha50k``): 25 sheets x 1,922 = 48,050 alpha-over triangles,
    z-write off, over a 3,200-triangle opaque floor at 1024x768. Every
    ordered state is in the affine kernel's envelope, so the ordered pass is
    kernel B3. Returns (ctx, rc, spinner); rotate ``spinner`` about y by
    0.02 per tick."""
    from .raster.types import VXBLEND

    ctx = _context(O, antialias, ctx_kw)
    rc = _alpha_stage(O, ctx, width, height)
    amat = O.CKMaterial(ctx, "glass")
    amat.SetDiffuse((0.9, 0.3, 0.25, 0.35))
    amat.EnableAlphaBlend(True)
    amat.SetSourceBlend(int(VXBLEND.SRCALPHA))
    amat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
    amat.EnableZWrite(False)
    spinner = _sheets(O, ctx, "sheet", amat, n_sheets, sheet_n, 0.5, 11,
                      lambda rng, i: (rng.uniform(-6, 6), 2.0 + i * 0.8,
                                      rng.uniform(-6, 6)))
    return ctx, rc, spinner


def build_alpha_tex50k(O, width: int = 1024, height: int = 768,
                       n_sheets: int = 4, sheet_n: int = 79,
                       antialias: bool = False, **ctx_kw):
    """Textured transparency at scale (``benchmarks/stress.py``
    ``case_alpha_tex50k``): 4 sheets x 12,482 = 49,928 textured alpha-over
    triangles over the opaque floor at 1024x768, with the TexturedPeel
    option on; the ordered pass is the peel kernel B4. Most pixels see at
    most 4 covering fragments, but a sheet can fold over itself on screen:
    at the first frame one pixel sees 5, so the peel runs a second round.
    Returns (ctx, rc, spinner); rotate ``spinner`` about y by 0.02 per
    tick."""
    from .raster.types import VXBLEND

    ctx = _context(O, antialias, ctx_kw)
    ctx.GetRenderManager().SetRenderOptions("TexturedPeel", 1)
    rc = _alpha_stage(O, ctx, width, height)
    tex = O.CKTexture(ctx, "glasstex")
    img = (np.indices((16, 16)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img * 0.3 + 0.6, img * 0.2 + 0.7,
                           img * 0.2 + 0.75, img * 0.3 + 0.55], -1))
    amat = O.CKMaterial(ctx, "texglass")
    amat.SetDiffuse((0.9, 0.95, 1.0, 0.45))
    amat.SetTexture(tex)
    amat.EnableAlphaBlend(True)
    amat.SetSourceBlend(int(VXBLEND.SRCALPHA))
    amat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
    amat.EnableZWrite(False)
    spinner = _sheets(O, ctx, "texsheet", amat, n_sheets, sheet_n, 0.4, 13,
                      lambda rng, i: (rng.uniform(-3, 3), 3.0 + i * 1.5,
                                      rng.uniform(-3, 3)))
    return ctx, rc, spinner


def build_cutout(O, width: int = 256, height: int = 192, n_fences: int = 6,
                 fence_n: int = 2, antialias: bool = False, **ctx_kw):
    """Alpha-test cutouts that write z: ``n_fences`` upright textured fences
    (2*fence_n^2 triangles each, checker alpha, alpha test GREATER 128,
    MODULATE texture blend, z-write on) standing in a row over the opaque
    floor. Alpha test takes them out of the deferred solve and z-write out
    of both kernel envelopes, so the ordered pass is the exact sequential
    one. Returns (ctx, rc, spinner)."""
    from .raster.types import VXCMP

    ctx = _context(O, antialias, ctx_kw)
    rc = _alpha_stage(O, ctx, width, height)
    tex = O.CKTexture(ctx, "fencetex")
    img = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img * 0.5 + 0.3, np.full_like(img, 0.6),
                           img * 0.3 + 0.2, img], -1))
    mat = O.CKMaterial(ctx, "fence")
    mat.SetDiffuse((0.9, 0.85, 0.7, 1.0))
    mat.SetTexture(tex)
    mat.EnableAlphaTest(True)
    mat.SetAlphaFunc(int(VXCMP.GREATER))
    mat.SetAlphaRef(128)
    verts, uv, faces = make_terrain(fence_n, 4.0, 0.0)
    # Stand the flat grid upright: (x, y, z) -> (x, z + 4, 0).
    upright = np.stack([verts[:, 0], verts[:, 2] + 4.0,
                        np.zeros_like(verts[:, 0])], -1).astype(np.float32)
    mesh = O.CKMesh(ctx, "fencem")
    mesh.SetPositions(upright)
    mesh.SetUVs((uv / 24.0 * 3.0).astype(np.float32))
    mesh.SetFaces(faces)
    mesh.BuildNormals()
    mesh.ApplyGlobalMaterial(mat)
    spinner = O.CK3dObject(ctx, "spin")
    for i in range(n_fences):
        f = O.CK3dObject(ctx, f"fence{i}")
        f.SetCurrentMesh(mesh)
        f.SetParent(spinner)
        f.SetPosition((-12.0 + i * 5.0, 0.0, -4.0 + i * 3.0), ref=spinner)
    return ctx, rc, spinner


def add_stencil_quad(O, ctx, x0: float, y0: float, x1: float, y1: float,
                     z: float, name: str = "mask"):
    """A two-sided upright quad [x0, x1] x [y0, y1] at depth ``z`` drawn as
    a stencil-only entity (``VX_MOVEABLE_STENCILONLY``): it writes the
    render context's stencil mask where it passes the z test, and neither
    colour nor depth. Returns the entity."""
    from .scene.entity_table import VX_MOVEABLE_STENCILONLY

    mesh = O.CKMesh(ctx, f"{name}m")
    mesh.SetPositions(np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z],
                                [x0, y1, z]], np.float32))
    mesh.SetFaces(np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, f"{name}mat")
    mat.SetEmissive((1.0, 1.0, 1.0, 1.0))
    mat.SetTwoSided(True)
    mesh.ApplyGlobalMaterial(mat)
    obj = O.CK3dObject(ctx, name)
    obj.SetCurrentMesh(mesh)
    obj.SetMoveableFlags(obj.GetMoveableFlags() | VX_MOVEABLE_STENCILONLY)
    return obj


def build_stencil(O, width: int = 640, height: int = 480,
                  antialias: bool = False, **ctx_kw):
    """BASELINE config 2 (:func:`build_config2`) plus one stencil-only quad
    standing behind the sphere (z = 2, clear of the sphere's radius), so
    the sphere hides part of it and the floor lies behind the rest: the
    frame's mask ``sb`` is 1 where the quad is seen and 0 behind the
    sphere. Returns (ctx, rc, ball); rotate ``ball`` by 0.03 per tick."""
    ctx, rc, ball = build_config2(O, width, height, antialias=antialias,
                                  **ctx_kw)
    add_stencil_quad(O, ctx, -3.0, -0.5, 0.5, 3.0, 2.0)
    return ctx, rc, ball


def build_batched(O, n_ctx: int = 8, size=256, antialias: bool = False,
                  **ctx_kw):
    """The context-batching scene (``bench.build_batched_scene``, which
    measures ``contexts_per_sec_batched_8x256`` and ``_64x256``): ``n_ctx``
    same-topology contexts of ``size`` (an int for a square frame, or
    (width, height)) viewing a field of 48 lit spheres (12 x 18 segments,
    20,736 triangles, seeded positions under one root) from cameras spread
    around it. Returns (rm, rcs, root); rotate ``root`` about y by 0.01 per
    batch."""
    width, height = (size, size) if np.isscalar(size) else size
    ctx = _context(O, antialias, ctx_kw)
    rm = ctx.GetRenderManager()
    spts, suv, sfaces = make_sphere(12, 18, 1.6)
    mesh = O.CKMesh(ctx, "sphere")
    mesh.SetPositions(spts)
    mesh.SetUVs(suv)
    mesh.SetFaces(sfaces)
    mesh.BuildNormals()
    mat = O.CKMaterial(ctx, "m")
    mat.SetDiffuse((0.8, 0.4, 0.2, 1.0))
    mat.SetPower(24.0)
    mesh.ApplyGlobalMaterial(mat)
    rng = np.random.default_rng(3)
    root = O.CK3dObject(ctx, "root")
    for i in range(48):
        b = O.CK3dObject(ctx, f"b{i}")
        b.SetCurrentMesh(mesh)
        b.SetParent(root)
        x, z = rng.uniform(-24, 24, 2)
        b.SetPosition((x, rng.uniform(-4, 8), z + 30), ref=root)
    sun = O.CKLight(ctx, "sun")
    sun.SetType(int(VXLIGHT.DIREC))
    sun.SetOrientation((0.4, -1.0, 0.3))
    rcs = []
    for k in range(n_ctx):
        rc = rm.CreateRenderContext(width, height)
        cam = O.CKCamera(ctx, f"cam{k}")
        ang = k * (2 * np.pi / n_ctx)
        cam.SetPosition((np.sin(ang) * 10.0, 6.0, -np.cos(ang) * 10.0))
        cam.SetOrientation((-np.sin(ang) * 0.3, -0.15, np.cos(ang)))
        rc.AttachViewpointToCamera(cam)
        rcs.append(rc)
    return rm, rcs, root


# -- config5_io: DDS and DXT textures, a progressive mesh, scene files -----

_DDSD_DXT = 0x1 | 0x2 | 0x4 | 0x1000           # caps, height, width, pixfmt
_DDSD_MIPMAPCOUNT = 0x20000


def dds_file(width: int, height: int, fourcc: str, surfaces) -> bytes:
    """A DDS file of one DXT surface per mip level (level 0 first): the
    ``DDS `` magic, the 124-byte header with its FOURCC pixel format, then
    the surfaces."""
    n = len(surfaces)
    flags = _DDSD_DXT | (_DDSD_MIPMAPCOUNT if n > 1 else 0)
    pf = struct.pack("<II4sIIIII", 32, 0x4, fourcc.encode("ascii"),
                     0, 0, 0, 0, 0)
    header = (b"DDS " + struct.pack("<7I", 124, flags, height, width, 0, 0, n)
              + b"\0" * 44 + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return header + b"".join(surfaces)


def rgb565(rgb) -> int:
    """A colour in [0, 1] as the nearest RGB565 word."""
    r, g, b = (int(round(float(c) * m)) for c, m in zip(rgb, (31, 63, 31)))
    return (r << 11) | (g << 5) | b


def dxt1_checker(size: int, light, dark) -> bytes:
    """A DDS file of a ``size`` x ``size`` one-texel checker in DXT1 with a
    full mip chain. Level 0 holds two colours per block in four-colour
    mode (c0 = ``light`` > c1 = ``dark``, indices 0 and 1), which the
    decode gives back exactly; every smaller level is the blocks' midpoint,
    index 2 of three-colour mode (c0 = ``dark`` <= c1 = ``light``)."""
    c_light, c_dark = rgb565(light), rgb565(dark)
    if c_light <= c_dark:
        raise ValueError("the checker's light colour must encode above its "
                         "dark one")
    bits = 0
    for k in range(16):                     # texel k = (k // 4, k % 4)
        bits |= (0 if (k // 4 + k % 4) % 2 else 1) << (2 * k)
    mid = struct.pack("<HHI", c_dark, c_light, 0xAAAAAAAA)
    surfaces, s = [], size
    while True:
        nb = ((s + 3) // 4) ** 2
        surfaces.append(struct.pack("<HHI", c_light, c_dark, bits) * nb
                        if s == size else mid * nb)
        if s == 1:
            break
        s //= 2
    return dds_file(size, size, "DXT1", surfaces)


def dxt_blocks(rng, size: int, fmt: str) -> bytes:
    """``size`` x ``size`` texels of seeded DXT blocks: any bytes are a
    valid block, so DXT5 alpha takes both of its modes."""
    per = 8 if fmt == "DXT1" else 16
    return rng.bytes(((size + 3) // 4) ** 2 * per)


def build_config5_io(O, width: int = 1024, height: int = 768,
                     terrain_n: int = 500, n_balls: int = 64,
                     n_signs: int = 12, seed: int = 21,
                     antialias: bool = False, **ctx_kw):
    """Config 5 (:func:`build_config5`) with textures from DXT surfaces and
    a progressive-mesh LOD, the level that the scene-IO path saves and
    loads:

    - the terrain's ``checker`` is a 32x32 DXT1 DDS file with a full mip
      chain (:func:`dxt1_checker`, read by ``LoadImage``: user mip levels);
    - the spheres' material samples ``ball_skin``, 32x32 seeded DXT3 blocks
      given to ``SetCompressedImage``;
    - ``n_signs`` signs of 2x2 quads stand on the terrain in front of the
      camera, alpha-over (z-write off) with ``sign_tex``, a 32x32 DXT5 DDS
      file of seeded blocks; with the TexturedPeel option on, their 8
      ordered triangles each take the peel (B4) above the flat size;
    - the shared 12x18 ``sphere`` mesh is a progressive mesh (``CreatePM``)
      at half of its vertices (``SetPMVertexCount``), geomorphed halfway
      (``SetPMGeoMorphStep(0.5)``).

    The DDS files are written to a temporary directory and removed after
    loading. Returns (ctx, rc, spinner)."""
    import tempfile

    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, antialias=antialias,
                                     **ctx_kw)
    ctx.GetRenderManager().SetRenderOptions("TexturedPeel", 1)
    rng = np.random.default_rng(seed)
    checker = ctx.GetObjectByName("checker")
    sign_tex = O.CKTexture(ctx, "sign_tex")
    with tempfile.TemporaryDirectory() as d:
        files = {checker: dxt1_checker(32, (0.9, 0.85, 0.7),
                                       (0.3, 0.35, 0.3)),
                 sign_tex: dds_file(32, 32, "DXT5",
                                    [dxt_blocks(rng, 32, "DXT5")])}
        for tex, data in files.items():
            path = os.path.join(d, f"{tex.GetName()}.dds")
            with open(path, "wb") as f:
                f.write(data)
            if not tex.LoadImage(path):
                raise RuntimeError(f"LoadImage refused {path}")

    skin = O.CKTexture(ctx, "ball_skin")
    if not skin.SetCompressedImage(dxt_blocks(rng, 32, "DXT3"), 32, 32,
                                   "DXT3"):
        raise RuntimeError("SetCompressedImage refused the DXT3 blocks")
    ctx.GetObjectByName("spheremat").SetTexture(skin)

    sign_mat = _fx_material(O, ctx, "signmat", (1.0, 1.0, 1.0, 1.0),
                            texture=sign_tex)
    sign_mat.SetTwoSided(True)
    pts, uv, faces = make_grid(2, (-4.0, -2.5, 0.0), (8.0, 0.0, 0.0),
                               (0.0, 5.0, 0.0))
    sign_mesh = O.CKMesh(ctx, "sign")
    sign_mesh.SetPositions(pts)
    sign_mesh.SetUVs(uv)
    sign_mesh.SetFaces(faces)
    sign_mesh.BuildNormals()
    sign_mesh.ApplyGlobalMaterial(sign_mat)
    place_main = ctx.GetObjectByName("place_main")
    for i in range(n_signs):
        x = -30.0 + (i % 4) * 20.0 + rng.uniform(-3.0, 3.0)
        z = -25.0 + (i // 4) * 18.0 + rng.uniform(-3.0, 3.0)
        sign = O.CK3dObject(ctx, f"sign{i}")
        sign.SetCurrentMesh(sign_mesh)
        sign.SetParent(place_main)
        sign.SetPosition((x, float(_terrain_height(x, z)) + 4.0, z))

    sphere = ctx.GetObjectByName("sphere")
    sphere.CreatePM()
    sphere.SetPMVertexCount(sphere.GetVertexCount() // 2)
    sphere.SetPMGeoMorphStep(0.5)
    return ctx, rc, spinner


# The image files of build_config5_images, written by
# tests/torch_images/make_images.py.
IMAGE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "torch_images")
IMAGE_FILES = {"checker": "terrain_checker.jpg",
               "ball_skin": "sphere_skin.bmp",
               "plaza_tex": "plaza_palette.png",
               "sign_tex": "sign_alpha.tga"}
MOVIE_FILES = {"hud_gif": "hud_movie.gif", "hud_apng": "hud_movie_apng.png",
               "hud_mjpg": "hud_mjpg.avi", "hud_rle": "hud_rle.avi"}
MOVIE_STEP_MS = 55.0          # SetMovieTime advance per tick


def build_config5_images(O, width: int = 1024, height: int = 768,
                         image_dir: str = IMAGE_DIR, terrain_n: int = 500,
                         n_balls: int = 64, n_signs: int = 12,
                         seed: int = 23, decoded: dict | None = None,
                         antialias: bool = False, **ctx_kw):
    """Config 5 (:func:`build_config5`) with its textures loaded from image
    files at Ballance's sizes (``IMAGE_FILES`` and ``MOVIE_FILES`` in
    ``image_dir``):

    - the terrain's ``checker``: a 512x512 4:2:0 JPEG of quality 85;
    - the spheres' ``ball_skin``: a 256x256 24-bit BMP;
    - ``plaza_tex``: an 8-bit palette PNG with tRNS, 128x128, on an opaque
      4x4 quad plaza in front of the camera;
    - ``n_signs`` alpha-over (z-write off) signs of 2x2 quads with
      ``sign_tex``, a 256x256 32-bit RLE TGA whose alpha is a gradient;
      with the TexturedPeel option on, their ordered triangles take the
      peel (B4) above the flat size, as ``build_config5_io``'s signs do;
    - four HUD ``CKSprite`` movies: ``hud_gif`` (a 64x64 animated GIF: 3
      frames, local palettes, a transparent index, disposal 2, 40/60/100
      ms), ``hud_apng`` (a 64x64 APNG of 3 frames blended over),
      ``hud_mjpg`` (a 64x64 MJPG 4:2:0 AVI of 4 frames at 12.5 fps,
      written by OpenCV) and ``hud_rle`` (a 64x64 8-bit MS RLE AVI of 4
      frames at 30000/1001 fps).

    Textures load through ``LoadImage`` and the sprites through
    ``LoadMovie``; with ``decoded`` ({file name: (list of (H, W, 4) uint8
    frames, list of durations in ms)}) the same level is built with
    ``SetImage`` of those frames instead. Returns (ctx, rc, spinner,
    tick); ``tick()`` turns the spinner and steps both movies by
    ``MOVIE_STEP_MS`` through ``SetMovieTime``."""
    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, antialias=antialias,
                                     **ctx_kw)
    ctx.GetRenderManager().SetRenderOptions("TexturedPeel", 1)
    rng = np.random.default_rng(seed)

    def image(tex, name):
        if decoded is None:
            path = os.path.join(image_dir, name)
            if not tex.LoadImage(path):
                raise RuntimeError(f"LoadImage refused {path}")
        else:
            tex.SetImage(decoded[name][0][0].astype(np.float32) / 255.0)

    textures = {"checker": ctx.GetObjectByName("checker")}
    for name in ("ball_skin", "plaza_tex", "sign_tex"):
        textures[name] = O.CKTexture(ctx, name)
    for key, tex in textures.items():
        image(tex, IMAGE_FILES[key])
    ctx.GetObjectByName("spheremat").SetTexture(textures["ball_skin"])

    plaza_mat = O.CKMaterial(ctx, "plazamat")
    plaza_mat.SetDiffuse((0.9, 0.9, 0.9, 1.0))
    plaza_mat.SetTexture(textures["plaza_tex"])
    pts, uv, faces = make_grid(4, (-20.0, 0.0, -30.0), (40.0, 0.0, 0.0),
                               (0.0, 0.0, 24.0))
    pts[:, 1] = _terrain_height(pts[:, 0], pts[:, 2]) + 0.6
    plaza_mesh = O.CKMesh(ctx, "plaza")
    plaza_mesh.SetPositions(pts.astype(np.float32))
    plaza_mesh.SetUVs(uv)
    plaza_mesh.SetFaces(faces)
    plaza_mesh.BuildNormals()
    plaza_mesh.ApplyGlobalMaterial(plaza_mat)
    plaza = O.CK3dObject(ctx, "plaza")
    plaza.SetCurrentMesh(plaza_mesh)
    place_main = ctx.GetObjectByName("place_main")
    plaza.SetParent(place_main)

    sign_mat = _fx_material(O, ctx, "signmat", (1.0, 1.0, 1.0, 1.0),
                            texture=textures["sign_tex"])
    sign_mat.SetTwoSided(True)
    pts, uv, faces = make_grid(2, (-4.0, -2.5, 0.0), (8.0, 0.0, 0.0),
                               (0.0, 5.0, 0.0))
    sign_mesh = O.CKMesh(ctx, "sign")
    sign_mesh.SetPositions(pts)
    sign_mesh.SetUVs(uv)
    sign_mesh.SetFaces(faces)
    sign_mesh.BuildNormals()
    sign_mesh.ApplyGlobalMaterial(sign_mat)
    for i in range(n_signs):
        x = -30.0 + (i % 4) * 20.0 + rng.uniform(-3.0, 3.0)
        z = -25.0 + (i // 4) * 18.0 + rng.uniform(-3.0, 3.0)
        sign = O.CK3dObject(ctx, f"sign{i}")
        sign.SetCurrentMesh(sign_mesh)
        sign.SetParent(place_main)
        sign.SetPosition((x, float(_terrain_height(x, z)) + 4.0, z))

    movies = []
    for i, (name, fname) in enumerate(MOVIE_FILES.items()):
        sp = O.CKSprite(ctx, name)
        if decoded is None:
            path = os.path.join(image_dir, fname)
            if not sp.LoadMovie(path):
                raise RuntimeError(f"LoadMovie refused {path}")
        else:
            frames, durations = decoded[fname]
            for k, f in enumerate(frames):
                sp.SetImage(f.astype(np.float32) / 255.0, slot=k)
            sp._movie_durations = [float(d) for d in durations]
            sp.SetCurrentSlot(0)
        x0 = 8 + 72 * i
        sp.SetRect((x0, 8, x0 + 64, 72))
        movies.append(sp)
    state = {"t": 0.0}

    def tick():
        spinner.Rotate((0, 1, 0), 0.02)
        state["t"] += MOVIE_STEP_MS
        for sp in movies:
            sp.SetMovieTime(state["t"])

    return ctx, rc, spinner, tick


FONT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "torch_fonts")
FONT_FILES = ("DejaVuSans.ttf", "DejaVuSansMono.ttf", "DejaVuSerif-Bold.ttf")
# The HUD of build_config5_text: (name, font file, size in pixels, the
# sprite's top left as fractions of the frame, its size in pixels, align
# (0 left, 1 centre, 2 right), text colour, background colour, text; the
# score's text is score_text(k)).
TEXT_HUD = (
    ("title", "DejaVuSerif-Bold.ttf", 48, (0.02, 0.02), (440, 64), 0,
     (1.0, 0.85, 0.3, 1.0), (0.0, 0.0, 0.0, 0.0), "office flow"),
    ("kerning", "DejaVuSans.ttf", 31, (0.5, 0.02), (480, 44), 1,
     (1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.25, 0.6), "AV To Ya WAVE Tyre"),
    ("latin1", "DejaVuSans.ttf", 22, (0.55, 0.12), (440, 32), 2,
     (0.95, 0.95, 0.8, 1.0), (0.0, 0.0, 0.0, 0.35),
     "Café crème — Ærø, façade, naïve ½ °C"),
    ("greek", "DejaVuSerif-Bold.ttf", 17, (0.02, 0.14), (360, 26), 0,
     (0.6, 0.9, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0), "Ελληνικά: Γειά σου κόσμε"),
    ("cyrillic", "DejaVuSansMono.ttf", 13, (0.02, 0.2), (300, 20), 1,
     (1.0, 0.7, 0.7, 1.0), (0.2, 0.0, 0.0, 0.5), "Привет, мир! Ёж и щётка"),
    ("two_line", "DejaVuSans.ttf", 11, (0.02, 0.26), (220, 36), 0,
     (1.0, 1.0, 1.0, 0.9), (0.0, 0.0, 0.0, 0.5),
     "Level 3 — Ballance\nflow: office, AVA"),
    ("status", "DejaVuSansMono.ttf", 9, (0.75, 0.94), (240, 14), 2,
     (0.8, 1.0, 0.8, 1.0), (0.0, 0.0, 0.0, 0.0), "fps 60 | tris 528032 | ✓"),
    ("score", "DejaVuSansMono.ttf", 22, (0.72, 0.86), (260, 30), 2,
     (1.0, 1.0, 0.4, 1.0), (0.0, 0.0, 0.0, 0.5), None),
)


# The right-to-left labels build_config5_text adds with rtl=True, in the
# free space of the 1024x768 HUD: Arabic with lam-alef under tanwin, a
# shadda and an Arabic-Indic digit (right-aligned); Hebrew with niqqud, a
# shin dot and qamats on one base (centred); a left-to-right paragraph
# with an Arabic run in guillemets and brackets, European digits after
# Arabic and a Persian word with ZWNJ (DejaVu Sans Mono has no ZWNJ glyph;
# HarfBuzz hides it as a default ignorable).
TEXT_HUD_RTL = (
    ("arabic", "DejaVuSans.ttf", 22, (0.6, 0.19), (380, 34), 2,
     (1.0, 0.9, 0.5, 1.0), (0.0, 0.0, 0.0, 0.4),
     "أهلاً بكم! المستوى ٣ • حظّ سعيد"),
    ("hebrew", "DejaVuSans.ttf", 17, (0.6, 0.25), (380, 26), 1,
     (0.7, 0.85, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0), "שָׁלוֹם, עוֹלָם! שלב 3"),
    ("mixed", "DejaVuSansMono.ttf", 13, (0.02, 0.9), (420, 22), 0,
     (0.9, 1.0, 0.9, 1.0), (0.1, 0.1, 0.1, 0.5),
     "Level 3: «مرحبا» (12 نقطة) می\u200cخواهم ok"),
)


def text_hud(rtl: bool = False) -> tuple:
    """The labels of build_config5_text: TEXT_HUD, and TEXT_HUD_RTL after
    it where ``rtl``."""
    return TEXT_HUD + TEXT_HUD_RTL if rtl else TEXT_HUD


def score_text(k: int) -> str:
    """The score label of ``build_config5_text`` after ``k`` ticks."""
    return f"SCORE {980 + 1250 * k:07d} ×{k + 1}"


def build_config5_text(O, width: int = 1024, height: int = 768,
                       terrain_n: int = 500, n_balls: int = 64,
                       rasters: dict | None = None, rtl: bool = False,
                       **ctx_kw):
    """Config 5 (:func:`build_config5`) under a HUD of ``CKSpriteText``
    labels (``TEXT_HUD``) in the TrueType faces of ``FONT_DIR``: sizes 9,
    11, 13, 17, 22, 31 and 48, the three alignments, ligatures ("office",
    "flow"), kerning pairs ("AV", "To", "Ya"), Latin-1, Greek and Cyrillic
    text, a two-line label, and a score whose text changes every tick
    (:func:`score_text`). With ``rtl`` the HUD also holds the Arabic,
    Hebrew and mixed-direction labels of ``TEXT_HUD_RTL``.

    With ``rasters`` ({label name: (H, W, 4) uint8, and ``"score:<k>"``
    for the score after k ticks}) the same HUD is built from plain
    ``CKSprite`` objects with ``SetImage`` of those rasters. Returns (ctx,
    rc, spinner, tick); ``tick()`` turns the spinner and moves the score
    on."""
    ctx, rc, spinner = build_config5(O, width, height, terrain_n=terrain_n,
                                     n_balls=n_balls, **ctx_kw)
    sprites = {}
    for (name, face, size, (fx, fy), (w, h), align, fg, bg,
         text) in text_hud(rtl):
        x0, y0 = int(fx * width), int(fy * height)
        if rasters is None:
            sp = O.CKSpriteText(ctx, name)
            sp.Create(w, h)
            sp.SetFont(os.path.join(FONT_DIR, face), size)
            sp.SetAlign(align)
            sp.SetTextColor(fg)
            sp.SetBackgroundTextColor(bg)
            sp.SetText(score_text(0) if text is None else text)
        else:
            sp = O.CKSprite(ctx, name)
            key = "score:0" if text is None else name
            sp.SetImage(rasters[key].astype(np.float32) / 255.0)
        sp.SetRect((x0, y0, x0 + w, y0 + h))
        sprites[name] = sp
    state = {"k": 0}

    def tick():
        spinner.Rotate((0, 1, 0), 0.02)
        state["k"] += 1
        k = state["k"]
        if rasters is None:
            sprites["score"].SetText(score_text(k))
        else:
            sprites["score"].SetImage(
                rasters[f"score:{k}"].astype(np.float32) / 255.0)

    return ctx, rc, spinner, tick


def load_level(O, path: str, rc, **ctx_kw):
    """Load the scene file ``path`` into a fresh ``O.CKContext(**ctx_kw)``
    (``Load``). A scene file holds objects, not the render manager or its
    contexts, so the fresh context gets ``rc``'s settings again: its
    manager's options, a render context of ``rc``'s size, its background,
    ambient light, fog and portal traversal, and the camera of the same
    name. Returns (ctx, rc)."""
    ctx = O.CKContext(**ctx_kw)
    rm = ctx.GetRenderManager()
    rm.options.update(rc.context.GetRenderManager().options)
    ctx.Load(path)
    rc2 = rm.CreateRenderContext(rc.width, rc.height)
    rc2.SetBackgroundColor(rc.GetBackgroundColor())
    rc2.SetAmbientLight(rc.GetAmbientLight())
    rc2.SetFogMode(rc.GetFogMode())
    rc2.SetFogStart(rc.GetFogStart())
    rc2.SetFogEnd(rc.GetFogEnd())
    rc2.SetFogDensity(rc.GetFogDensity())
    rc2.SetFogColor(rc.GetFogColor())
    rc2.EnablePortalTraversal(rc.portal_traversal)
    rc2.AttachViewpointToCamera(
        ctx.GetObjectByName(rc.GetAttachedCamera().GetName()))
    return ctx, rc2


def reload_level(O, ctx, rc, path: str, **ctx_kw):
    """Save ``ctx``'s objects to ``path`` (``ctx.Save``) and load them with
    :func:`load_level` into a fresh context with ``rc``'s settings.
    Returns (ctx, rc)."""
    ctx.Save(path)
    return load_level(O, path, rc, **ctx_kw)
