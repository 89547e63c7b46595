"""One call script through the rasterizer HAL, for tests and the card check.

:func:`hal_script` drives a ``CKRasterizerContext`` as an immediate-mode
application would: transforms, two lights set up by ``CKLight.Setup``, a lit
indexed sphere (``DrawPrimitive``), a textured ground as vertex- and
index-buffer strips (``DrawPrimitiveVBIB``), a triangle fan recorded in a
display list and replayed, pre-transformed alpha-blended quads with fog on,
a scaled non-pow2 sprite (``DrawSprite``), a framebuffer rect copied into a
texture (``CopyToTexture``) and drawn, and a screen backup restored. It
uses the HAL's API and numpy only, so the same script runs through this
package's HAL and the reference package's, at any context size; the
geometry scales with the arguments (the full size draws 1,026 triangles).
"""

from __future__ import annotations

import numpy as np

from .hal import (CKRST_CTXCLEAR_ALL, CKRST_CTXCLEAR_COLOR,
                  CKRST_OBJ_INDEXBUFFER, CKRST_OBJ_SPRITE, CKRST_OBJ_TEXTURE,
                  CKRST_OBJ_VERTEXBUFFER, VXMATRIX_PROJECTION, VXMATRIX_VIEW,
                  VXMATRIX_WORLD, VXRENDERSTATE)
from .types import VXBLEND, VXCULL, VXPRIMITIVE

# The full-size script: 768 + 128 + 2·32 + 64 + 2 = 1,026 triangles.
FULL = dict(rings=16, segments=24, grid=8, fan=32, quads=32)
# A small one for the CPU tests: 24 + 8 + 2·4 + 6 + 2 = 48 triangles.
SMALL = dict(rings=3, segments=4, grid=2, fan=4, quads=3)

TRI = int(VXPRIMITIVE.TRIANGLELIST)
STRIP = int(VXPRIMITIVE.TRIANGLESTRIP)
FAN = int(VXPRIMITIVE.TRIANGLEFAN)


def perspective(fov: float, aspect: float, near: float, far: float):
    """D3D left-handed row-vector projection."""
    m = np.zeros((4, 4), np.float32)
    m[1, 1] = 1.0 / np.tan(fov / 2)
    m[0, 0] = m[1, 1] / aspect
    m[2, 2] = far / (far - near)
    m[3, 2] = -near * far / (far - near)
    m[2, 3] = 1.0
    return m


def sphere(rings: int, segments: int, radius: float = 1.2):
    """(positions (V,3), normals (V,3), indices (rings·segments·6,)) of a
    UV sphere, two triangles per cell, wound to face outwards under the
    default CCW cull."""
    th = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
    ph = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
    t, p = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                   -1).reshape(-1, 3).astype(np.float32)
    r, s = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    a = (r * (segments + 1) + s).reshape(-1)
    b, c, d = a + segments + 1, a + 1, a + segments + 2
    idx = np.stack([a, c, b, c, d, b], -1).reshape(-1).astype(np.int32)
    return nrm * np.float32(radius), nrm, idx


def _clip(ctx, local: np.ndarray) -> np.ndarray:
    """(N, 3) local points -> (N, 4) clip coords under ctx's transforms
    (the HAL's own arithmetic, float32)."""
    total = (ctx.GetTransformMatrix(VXMATRIX_WORLD)
             @ ctx.GetTransformMatrix(VXMATRIX_VIEW)
             @ ctx.GetTransformMatrix(VXMATRIX_PROJECTION))
    h = np.concatenate([local, np.ones((local.shape[0], 1), np.float32)], -1)
    return (h @ total).astype(np.float32)


def fan_draw(fan: int):
    """The display list's draw: a pre-transformed coloured disc of ``fan``
    triangles, centre first."""
    ang = np.linspace(0.0, 2 * np.pi, fan + 1, dtype=np.float32)
    ring = np.stack([0.55 + 0.3 * np.cos(ang), 0.45 + 0.4 * np.sin(ang),
                     np.full_like(ang, 0.3), np.ones_like(ang)], -1)
    pos = np.concatenate([np.array([[0.55, 0.45, 0.3, 1.0]], np.float32),
                          ring]).astype(np.float32)
    col = np.stack([0.5 + 0.5 * np.cos(np.arange(fan + 2) * 0.7),
                    0.6 * np.ones(fan + 2), 0.5 + 0.5 * np.sin(
                        np.arange(fan + 2) * 0.3), np.ones(fan + 2)],
                   -1).astype(np.float32)
    return {"positions": pos, "colors": col, "transformed": True}


def record_fan(ctx, fan: int) -> int:
    """Record the fan (and its cull state) in a new display list, drawing
    it once as it records; returns the list's id."""
    dl = ctx.NewDisplayList()
    ctx.SetRenderState(VXRENDERSTATE.CULLMODE, int(VXCULL.NONE))
    ctx.DrawPrimitive(FAN, None, fan_draw(fan))
    ctx.EndDisplayList()
    return dl


def setup_lights(ctx, lights) -> None:
    """Push ``lights`` (objects with ``Setup(ctx, index)``, e.g. CKLight)
    into the context, lighting on, a white material, a dim ambient."""
    for i, light in enumerate(lights):
        light.Setup(ctx, i)
    ctx.SetRenderState(VXRENDERSTATE.LIGHTING, 1)
    ctx.SetRenderState(VXRENDERSTATE.AMBIENT, 0xFF182028)
    ctx.SetMaterial({"diffuse": (1.0, 1.0, 1.0, 1.0)})


def hal_script(rst, ctx, lights, rings=16, segments=24, grid=8, fan=32,
               quads=32, probes: bool = False, timer=None) -> dict:
    """Drive ``ctx`` (created on a driver of ``rst``, any size) through the
    script. Returns the triangles and vertices it drew and, with
    ``probes``, host copies taken along the way: the fb rect at
    ``CopyToTexture`` and the texture's level 0 after it, the fb at
    ``SetScreenBackup`` and after ``RestoreScreenBackup``. ``timer``: a
    context manager factory wrapped around the sphere's ``DrawPrimitive``
    (given its triangle count)."""
    w, h = ctx.width, ctx.height
    out = {"triangles": 0, "vertices": 0}

    def count(t, v):
        out["triangles"] += t
        out["vertices"] += v

    ctx.Clear(CKRST_CTXCLEAR_ALL, 0xFF203040)
    view = np.eye(4, dtype=np.float32)
    view[3, :3] = (0.0, -0.6, 5.0)           # camera at (0, 0.6, -5)
    ctx.SetTransformMatrix(VXMATRIX_VIEW, view)
    ctx.SetTransformMatrix(VXMATRIX_PROJECTION,
                           perspective(1.0, w / h, 1.0, 50.0))
    world = np.eye(4, dtype=np.float32)
    world[3, :3] = (-0.4, 0.2, 0.0)
    ctx.SetTransformMatrix(VXMATRIX_WORLD, world)
    setup_lights(ctx, lights)

    # A lit indexed sphere in local space.
    pos, nrm, idx = sphere(rings, segments)
    n_sph = idx.size // 3
    data = {"positions": pos, "normals": nrm}
    if timer is None:
        ctx.DrawPrimitive(TRI, idx, data)
    else:
        with timer(n_sph):
            ctx.DrawPrimitive(TRI, idx, data)
    count(n_sph, idx.size)
    ctx.SetTransformMatrix(VXMATRIX_WORLD, np.eye(4, dtype=np.float32))

    # A textured ground: grid x grid quads as VB + IB strips.
    ti = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
    ctx.CreateObject(ti, CKRST_OBJ_TEXTURE, {"width": 16, "height": 16})
    ck = (np.indices((16, 16)).sum(0) % 2).astype(np.float32)
    tex = np.stack([0.3 + 0.6 * ck, 0.5 + 0.3 * ck, 0.2 + 0.2 * ck,
                    np.ones_like(ck)], -1)
    ctx.LoadTexture(ti, tex)
    g = np.linspace(-4.0, 4.0, grid + 1, dtype=np.float32)
    gx, gz = np.meshgrid(g, g + 3.0, indexing="ij")
    local = np.stack([gx, np.full_like(gx, -1.3), gz], -1).reshape(-1, 3)
    nv = local.shape[0]
    vbi = rst.CreateObjectIndex(CKRST_OBJ_VERTEXBUFFER)
    ctx.CreateObject(vbi, CKRST_OBJ_VERTEXBUFFER, {"max_vertices": nv})
    p, col, uv = ctx.LockVertexBuffer(vbi, 0, nv)
    p[:] = _clip(ctx, local)
    col[:] = (0.9, 0.9, 0.85, 1.0)
    uv[:] = np.stack([gx, gz], -1).reshape(-1, 2) * 0.25
    ctx.UnlockVertexBuffer(vbi)
    row = 2 * (grid + 1)
    ibi = rst.CreateObjectIndex(CKRST_OBJ_INDEXBUFFER)
    ctx.CreateObject(ibi, CKRST_OBJ_INDEXBUFFER, {"max_indices": grid * row})
    ib = ctx.LockIndexBuffer(ibi, 0, grid * row)
    r, c = np.meshgrid(np.arange(grid), np.arange(grid + 1), indexing="ij")
    ib[:] = np.stack([r * (grid + 1) + c, (r + 1) * (grid + 1) + c],
                     -1).reshape(-1)
    ctx.UnlockIndexBuffer(ibi)
    ctx.SetRenderState(VXRENDERSTATE.CULLMODE, int(VXCULL.NONE))
    ctx.SetTexture(ti)
    for k in range(grid):
        ctx.DrawPrimitiveVBIB(STRIP, vbi, ibi, start_index=k * row,
                              index_count=row)
        count(row - 2, row)
    ctx.SetTexture(-1)

    # A fan recorded in a display list, then replayed with the cull back on.
    dl = record_fan(ctx, fan)
    ctx.SetRenderState(VXRENDERSTATE.CULLMODE, int(VXCULL.CCW))
    ctx.CallDisplayList(dl)
    count(2 * fan, 2 * (fan + 2))

    # Pre-transformed alpha-blended quads with fog on, no z write.
    rng = np.random.default_rng(7)
    ctr = rng.uniform(-0.9, 0.9, (quads, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (quads, 2)).astype(np.float32)
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    xy = (ctr[:, None] + corners[None] * half[:, None]).reshape(-1, 2)
    z = np.repeat(rng.uniform(0.1, 0.9, quads).astype(np.float32), 4)
    qpos = np.concatenate([xy, z[:, None], np.ones((4 * quads, 1),
                                                   np.float32)], -1)
    qcol = np.repeat(rng.uniform(0, 1, (quads, 4)).astype(np.float32), 4, 0)
    qcol[:, 3] = np.repeat(rng.uniform(0.3, 0.7, quads), 4)
    qidx = (np.arange(quads)[:, None] * 4
            + np.array([0, 2, 1, 0, 3, 2])[None]).reshape(-1)
    for st, v in ((VXRENDERSTATE.ALPHABLENDENABLE, 1),
                  (VXRENDERSTATE.SRCBLEND, int(VXBLEND.SRCALPHA)),
                  (VXRENDERSTATE.DESTBLEND, int(VXBLEND.INVSRCALPHA)),
                  (VXRENDERSTATE.ZWRITEENABLE, 0),
                  (VXRENDERSTATE.CULLMODE, int(VXCULL.NONE)),
                  (VXRENDERSTATE.FOGENABLE, 1),
                  (VXRENDERSTATE.FOGCOLOR, 0xFF8090A0)):
        ctx.SetRenderState(st, v)
    ctx.DrawPrimitive(TRI, qidx, {"positions": qpos, "colors": qcol,
                                  "transformed": True})
    count(2 * quads, qidx.size)
    for st, v in ((VXRENDERSTATE.ALPHABLENDENABLE, 0),
                  (VXRENDERSTATE.SRCBLEND, int(VXBLEND.ONE)),
                  (VXRENDERSTATE.DESTBLEND, int(VXBLEND.ZERO)),
                  (VXRENDERSTATE.ZWRITEENABLE, 1),
                  (VXRENDERSTATE.FOGENABLE, 0)):
        ctx.SetRenderState(st, v)

    # A 100 x 37 sprite (non-pow2 tiles), scaled into a rect.
    si = rst.CreateObjectIndex(CKRST_OBJ_SPRITE)
    ctx.CreateSprite(si, 100, 37)
    yy, xx = np.mgrid[0:37, 0:100].astype(np.float32)
    img = np.stack([xx / 99, yy / 36, 1 - xx / 99,
                    0.25 + 0.75 * (xx / 99) * (yy / 36)], -1)
    ctx.LoadSprite(si, img.astype(np.float32))
    sx, sy = w // 16, h - h // 4
    ctx.DrawSprite(si, dst_rect=(sx, sy, sx + w // 5, sy + h // 7))

    # A framebuffer rect into a texture, drawn back on a quad.
    tj = rst.CreateObjectIndex(CKRST_OBJ_TEXTURE)
    ctx.CreateObject(tj, CKRST_OBJ_TEXTURE, {"width": 1, "height": 1})
    rect = (w // 4, h // 4, w // 2, h // 2)
    if probes:
        out["copy_fb"] = ctx.BackToFront()[rect[1]:rect[3],
                                           rect[0]:rect[2]].copy()
    ctx.CopyToTexture(tj, src_rect=rect)
    if probes:
        out["copy_tex"] = ctx.GetTextureData(tj)
    ctx.SetTexture(tj)
    quad = np.array([[0.3, 0.9, 0.05, 1], [0.95, 0.9, 0.05, 1],
                     [0.95, 0.3, 0.05, 1], [0.3, 0.3, 0.05, 1]], np.float32)
    ctx.DrawPrimitive(TRI, np.array([0, 1, 2, 0, 2, 3]),
                      {"positions": quad, "transformed": True,
                       "uvs": np.array([[0, 0], [1, 0], [1, 1], [0, 1]],
                                       np.float32)})
    count(2, 6)
    ctx.SetTexture(-1)

    # A screen backup, a clear, the restore.
    ctx.SetScreenBackup()
    if probes:
        out["backup_fb"] = ctx.BackToFront().copy()
    ctx.Clear(CKRST_CTXCLEAR_COLOR, 0)
    ctx.RestoreScreenBackup()
    if probes:
        out["restored_fb"] = ctx.BackToFront().copy()
    return out


def display_list_pair(rst, fan: int, width: int, height: int):
    """Two fresh contexts of ``rst``'s driver 0: the fan recorded (drawn
    once), the frame cleared and the list replayed; and the same draw
    issued directly. Returns both contexts."""
    drv = rst.GetDriver(0)
    a, b = drv.CreateContext(), drv.CreateContext()
    for c in (a, b):
        c.Create(None, width, height)
        c.Clear(CKRST_CTXCLEAR_ALL, 0xFF000000)
    dl = record_fan(a, fan)
    a.Clear(CKRST_CTXCLEAR_ALL, 0xFF000000)
    a.SetRenderState(VXRENDERSTATE.CULLMODE, int(VXCULL.CCW))
    a.CallDisplayList(dl)
    b.SetRenderState(VXRENDERSTATE.CULLMODE, int(VXCULL.NONE))
    b.DrawPrimitive(FAN, None, fan_draw(fan))
    return a, b
