"""Spatial grids: CKGrid / CKLayer.

API mirror of RCKGrid / RCKLayer (reference src/CKGrid.cpp, src/CKLayer.cpp,
include/RCKGrid.h, include/RCKLayer.h): a width x length grid entity,
invisible by default, with an orientation, a priority and named, typed data
layers (CKSquare value arrays, plain 2D numpy arrays keyed by grid
coordinates). A shown grid builds its debug mesh: a half-transparent quad
textured with the layers' colours and an orange wireframe border, which
renders through ``Render()`` like any mesh (the quad in the ordered pass,
the border in the line pass). Layer types live in this module's own
registry (``RegisterLayerType``).
"""

from __future__ import annotations

import numpy as np

from .base import CKCID_GRID, CKCID_LAYER, CKContext, CKObject
from .entity import CK3dEntity

# Grid orientation modes (CK_GRIDORIENTATION)
CKGRID_XZ = 0     # squares in the entity's local XZ plane (default)
CKGRID_XY = 1
CKGRID_YZ = 2

_layer_type_registry: dict[str, int] = {}


def RegisterLayerType(name: str) -> int:
    """Global layer-type registry (reference CKGridManager type registration)."""
    if name not in _layer_type_registry:
        _layer_type_registry[name] = len(_layer_type_registry) + 1
    return _layer_type_registry[name]


def GetLayerTypeByName(name: str) -> int:
    return _layer_type_registry.get(name, 0)


class CKLayer(CKObject):
    CLASS_ID = CKCID_LAYER

    def __init__(self, context: CKContext, name: str = "", grid=None,
                 ltype: int = 0, width: int = 0, length: int = 0):
        super().__init__(context, name)
        self.grid = grid
        self.type = int(ltype)
        self.format = 0
        self.squares = np.zeros((length, width), np.int32)
        self.visible = True
        # Visualization color: square color = value x color in the grid's
        # debug texture (reference: per-type color from CKGridManager,
        # reference src/CKGrid.cpp:552-584).
        self.color = (1.0, 1.0, 1.0, 1.0)

    def SetColor(self, rgba):
        self.color = tuple(float(c) for c in rgba)
        if self.grid is not None and self.grid._viz_texture is not None:
            self.grid.UpdateMeshTexture()

    def GetColor(self):
        return self.color

    def GetType(self) -> int:
        return self.type

    def SetType(self, t: int):
        self.type = int(t)

    def GetFormat(self) -> int:
        return self.format

    def SetFormat(self, f: int):
        self.format = int(f)

    def SetValue(self, x: int, y: int, value):
        self.squares[y, x] = value

    def GetValue(self, x: int, y: int):
        return self.squares[y, x]

    def GetSquareArray(self) -> np.ndarray:
        return self.squares

    def SetSquareArray(self, arr):
        a = np.asarray(arr)
        assert a.shape == self.squares.shape
        self.squares = a.astype(self.squares.dtype)

    def GetGrid(self):
        return self.grid

    # -- API-surface parity batch (reference include/RCKLayer.h) -----------
    def SetValue2(self, x: int, y: int, value) -> bool:
        """Bounds-checked SetValue returning success (reference
        RCKLayer::SetValue2, src/CKLayer.cpp)."""
        if not (0 <= x < self.squares.shape[1]
                and 0 <= y < self.squares.shape[0]):
            return False
        self.squares[y, x] = value
        return True

    def GetValue2(self, x: int, y: int):
        """Bounds-checked GetValue; None when outside (reference
        GetValue2)."""
        if not (0 <= x < self.squares.shape[1]
                and 0 <= y < self.squares.shape[0]):
            return None
        return self.squares[y, x]

    def SetVisible(self, visible: bool = True):
        self.visible = bool(visible)

    def IsVisible(self) -> bool:
        return self.visible

    def InitOwner(self, owner):
        """First owner binding (reference InitOwner — the grid that created
        the layer)."""
        self.grid = owner

    def SetOwner(self, owner):
        self.grid = owner

    def GetOwner(self):
        return self.grid

    def InitValue(self, value):
        self.squares[:] = value


class CKGrid(CK3dEntity):
    CLASS_ID = CKCID_GRID

    def __init__(self, context: CKContext, name: str = ""):
        super().__init__(context, name)
        self.width = 10          # squares along local x
        self.length = 10         # squares along local z (XZ orientation)
        self.orientation_mode = CKGRID_XZ
        self.grid_priority = 0
        self.layers: list[CKLayer] = []
        self._size = (1.0, 1.0)  # local units per square (SetDimensions)
        # Debug-visualization mesh (reference ConstructMeshTexture,
        # reference src/CKGrid.cpp:399): built lazily when shown.
        self._viz_mesh = None
        self._viz_texture = None
        self._viz_materials = ()
        self.Show(False)         # grids are invisible entities by default

    # -- debug visualization mesh -------------------------------------------
    def Show(self, show: bool = True):
        """Visible grids build their debug mesh; hiding destroys it
        (reference RCKGrid::Show, reference src/CKGrid.cpp:383-392)."""
        if show and not self.IsVisible():
            super().Show(True)               # mesh path needs visibility on
            self.ConstructMeshTexture(0.5)
        elif not show:
            if self.IsVisible():
                self.DestroyMeshTexture()
            super().Show(False)
        else:
            super().Show(show)

    def ConstructMeshTexture(self, scale: float = 0.5):
        """Build the grid's renderable debug mesh: a half-transparent main
        quad textured with per-square layer colors plus an orange wireframe
        border (reference RCKGrid::ConstructMeshTexture,
        reference src/CKGrid.cpp:399-631 — 12 verts, 10 faces,
        alpha-blend main material, wireframe border material, pow2 layer
        texture with 2x2 texels per square, nearest filtering).
        ``scale`` is the main-quad vertex alpha (0.5 = the reference's
        half-transparent overlay)."""
        if self._viz_mesh is not None:
            self.SetCurrentMesh(self._viz_mesh, True)
            return self._viz_mesh
        from ..raster.types import VXBLEND, VXFILL, VXTEXTURE_FILTER, \
            VXTEXTUREBLEND
        from .material import CKMaterial
        from .mesh import CKMesh
        from .texture import CKTexture

        name = self.GetName() or "grid"
        mesh = self.context.CreateObject(CKMesh, f"{name} mesh")
        w, l = float(self.width), float(self.length)
        eps = 1e-4
        mesh.SetVertexCount(12)
        # Main quad (0-3) floats slightly above the border wireframe
        # (reference uses y=1 for the quad, y=0 for the border).
        verts = [(0.0, 1.0, 0.0), (0.0, 1.0, l), (w, 1.0, l), (w, 1.0, 0.0),
                 (0.0, 0.0, eps), (eps, 0.0, l), (w, 0.0, l - eps),
                 (w - eps, 0.0, 0.0), (eps, 0.0, 0.0), (0.0, 0.0, l - eps),
                 (w - eps, 0.0, l), (w, 0.0, eps)]
        for i, v in enumerate(verts):
            mesh.SetVertexPosition(i, v)
        mesh.SetLitMode(True)                        # VX_PRELITMESH
        mesh.SetFaceCount(10)
        faces = [(0, 1, 2), (0, 2, 3),               # main quad
                 (5, 9, 1), (6, 10, 2), (7, 11, 3), (4, 8, 0),
                 (4, 5, 9), (5, 6, 10), (6, 7, 11), (7, 4, 8)]
        for f, (a, b, c) in enumerate(faces):
            mesh.SetFaceVertexIndex(f, a, b, c)
        for i in range(4):
            mesh.SetVertexColor(i, (1.0, 1.0, 1.0, float(scale)))
        for i in range(4, 12):
            mesh.SetVertexColor(i, (1.0, 0.5, 0.1, 1.0))

        mat = self.context.CreateObject(CKMaterial, f"{name} material")
        mat.EnableAlphaBlend(True)
        mat.EnableZWrite(False)
        mat.SetSourceBlend(int(VXBLEND.SRCALPHA))
        mat.SetDestBlend(int(VXBLEND.INVSRCALPHA))
        mat.SetTwoSided(True)
        mat.SetDiffuse((1.0, 1.0, 1.0, 1.0))
        mat.SetTextureMagMode(int(VXTEXTURE_FILTER.NEAREST))
        mat.SetTextureMinMode(int(VXTEXTURE_FILTER.NEAREST))
        mat.SetTextureBlendMode(int(VXTEXTUREBLEND.MODULATEALPHA))
        mesh.SetFaceMaterial(0, mat)
        mesh.SetFaceMaterial(1, mat)

        mat2 = self.context.CreateObject(CKMaterial, f"{name} material2")
        mat2.SetFillMode(int(VXFILL.WIREFRAME))
        mat2.SetTwoSided(True)
        mat2.SetDiffuse((1.0, 1.0, 1.0, 1.0))
        for f in range(2, 10):
            mesh.SetFaceMaterial(f, mat2)

        # pow2 layer texture, 2x2 texels per square (reference :519-541).
        def _texdim(n):
            for lim, d in ((64, 256), (32, 128), (16, 64), (8, 32)):
                if n > lim:
                    return d
            return 16
        tex_w, tex_h = _texdim(self.width), _texdim(self.length)
        tex = self.context.CreateObject(CKTexture, f"{name} texture")
        tex.Create(tex_w, tex_h, 32)
        u_scale = (self.width * 2) / float(tex_w)
        v_scale = (self.length * 2) / float(tex_h)
        for i, (u, v) in enumerate(((0.0, 0.0), (0.0, v_scale),
                                    (u_scale, v_scale), (u_scale, 0.0))):
            mesh.SetVertexTextureCoordinates(i, u, v)
        mat.SetTexture0(tex)

        self._viz_mesh = mesh
        self._viz_texture = tex
        self._viz_materials = (mat, mat2)
        self.UpdateMeshTexture()
        mesh.SetTransparent(True)
        self.SetCurrentMesh(mesh, True)
        return mesh

    def UpdateMeshTexture(self):
        """Refill the visualization texture from the current layer values:
        each square's color accumulates value x layer-color over visible
        layers, clamped (reference texture fill loop,
        reference src/CKGrid.cpp:566-600), written as 2x2 texels."""
        tex = self._viz_texture
        if tex is None:
            return
        img = tex.LockSurfacePtr()
        tex_h, tex_w = img.shape[0], img.shape[1]
        acc = np.zeros((self.length, self.width, 3), np.float32)
        for layer in self.layers:
            if not layer.IsVisible():
                continue
            color = np.asarray(layer.color, np.float32)[:3]
            acc += layer.squares.astype(np.float32)[:, :, None] * color
        cells = np.clip(acc / 255.0, 0.0, 1.0)
        up = np.repeat(np.repeat(cells, 2, axis=0), 2, axis=1)
        h = min(2 * self.length, tex_h)
        w = min(2 * self.width, tex_w)
        img[:] = 0.0
        img[..., 3] = 1.0
        img[:h, :w, :3] = up[:h, :w]
        tex.SetImage(img)

    def DestroyMeshTexture(self):
        """Drop the visualization mesh/materials/texture (reference
        RCKGrid::DestroyMeshTexture, called from Show(hide))."""
        if self._viz_mesh is None:
            return
        self.RemoveMesh(self._viz_mesh)
        for obj in (self._viz_mesh, self._viz_texture, *self._viz_materials):
            if obj is not None:
                self.context.DestroyObject(obj)
        self._viz_mesh = None
        self._viz_texture = None
        self._viz_materials = ()

    # -- shape ---------------------------------------------------------------
    def SetDimensions(self, width: int, length: int, size_x: float = 1.0,
                      size_y: float = 1.0):
        """width x length squares of size (size_x, size_y) in local units;
        resizes existing layers (values preserved where overlapping)."""
        self.width = int(width)
        self.length = int(length)
        for layer in self.layers:
            old = layer.squares
            new = np.zeros((self.length, self.width), old.dtype)
            h = min(old.shape[0], self.length)
            w = min(old.shape[1], self.width)
            new[:h, :w] = old[:h, :w]
            layer.squares = new
        self._size = (float(size_x), float(size_y))

    def GetWidth(self) -> int:
        return self.width

    def GetLength(self) -> int:
        return self.length

    def SetOrientationMode(self, mode: int):
        self.orientation_mode = int(mode)

    def GetOrientationMode(self) -> int:
        return self.orientation_mode

    def UpdateBox(self):
        """Recompute the grid's local bbox from its dimensions (reference
        RCKGrid::UpdateBox); returns (bmin, bmax)."""
        w = self.GetWidth() * self._size[0]
        l = self.GetLength() * self._size[1]
        bmin = np.array([-w * 0.5, 0.0, -l * 0.5], np.float32)
        bmax = np.array([w * 0.5, 0.0, l * 0.5], np.float32)
        self._local_box = (bmin, bmax)
        return bmin, bmax

    def SetGridPriority(self, p: int):
        self.grid_priority = int(p)

    def GetGridPriority(self) -> int:
        return self.grid_priority

    @property
    def square_size(self) -> tuple:
        return self._size

    # -- layers --------------------------------------------------------------
    def AddLayer(self, type_or_name, format: int = 0) -> CKLayer:
        ltype = (RegisterLayerType(type_or_name)
                 if isinstance(type_or_name, str) else int(type_or_name))
        layer = CKLayer(self.context, f"{self.GetName()}_layer{ltype}",
                        grid=self, ltype=ltype, width=self.width,
                        length=self.length)
        layer.SetFormat(format)
        self.layers.append(layer)
        return layer

    def GetLayer(self, type_or_name) -> CKLayer | None:
        ltype = (GetLayerTypeByName(type_or_name)
                 if isinstance(type_or_name, str) else int(type_or_name))
        for l in self.layers:
            if l.type == ltype:
                return l
        return None

    def GetLayerCount(self) -> int:
        return len(self.layers)

    def GetLayerByIndex(self, i: int) -> CKLayer:
        return self.layers[i]

    def RemoveLayer(self, layer_or_type):
        layer = (layer_or_type if isinstance(layer_or_type, CKLayer)
                 else self.GetLayer(layer_or_type))
        if layer in self.layers:
            self.layers.remove(layer)

    # -- coordinates ---------------------------------------------------------
    def _axes(self):
        if self.orientation_mode == CKGRID_XY:
            return 0, 1
        if self.orientation_mode == CKGRID_YZ:
            return 1, 2
        return 0, 2   # XZ

    def GetGridCoordinates(self, world_pos) -> tuple[int, int] | None:
        """World position -> (x, y) square coords, or None if outside."""
        inv = np.linalg.inv(self.GetWorldMatrix())
        p = np.asarray(world_pos, np.float32) @ inv[:3, :3] + inv[3, :3]
        ax, ay = self._axes()
        sx, sy = self.square_size
        gx = int(np.floor(p[ax] / sx + self.width * 0.5))
        gy = int(np.floor(p[ay] / sy + self.length * 0.5))
        if 0 <= gx < self.width and 0 <= gy < self.length:
            return gx, gy
        return None

    def GetPositionFromCoordinates(self, x: int, y: int) -> np.ndarray:
        """Square-center world position."""
        ax, ay = self._axes()
        sx, sy = self.square_size
        local = np.zeros(3, np.float32)
        local[ax] = (x + 0.5 - self.width * 0.5) * sx
        local[ay] = (y + 0.5 - self.length * 0.5) * sy
        w = self.GetWorldMatrix()
        return local @ w[:3, :3] + w[3, :3]

    def IsInGrid(self, world_pos) -> bool:
        return self.GetGridCoordinates(world_pos) is not None

    def IsActive(self) -> bool:
        """Grids are always active, shown or not."""
        return True
