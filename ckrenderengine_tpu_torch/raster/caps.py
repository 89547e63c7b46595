"""Device capability descriptions: the port's Vx3DCapsDesc analogue.

The counterpart of ``ckrenderengine_tpu.raster.caps``. The reference engine
enumerates adapters and fills Vx3DCapsDesc from D3DCAPS9
(CKDX9RasterizerDriver::InitializeCaps) plus a driver-problem database for
buggy drivers (CKDriverProblems, include/CKRasterizerTypes.h:29-58). Here
the capability set is static per driver: driver 0 is the CUDA card, which
draws through ``raster.torch_backend``; driver 1 the software entry (the
numpy NULL oracle, ``raster.null_backend``), as in the reference's table.

The caps describe this package as it is: ``Render()`` hands each frame of a
context with a target texture to that texture on the device, so
``supports_render_to_texture`` is True, as in the reference.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Vx3DCapsDesc:
    """Driver capability set (reference Vx3DCapsDesc fields that consumers
    actually read)."""

    driver_name: str = "cuda-torch"
    description: str = "PyTorch/CUDA rasterizer on the card"
    is_hardware: bool = True            # device-accelerated (CUDA)
    max_texture_width: int = 8192
    max_texture_height: int = 8192
    max_clip_planes: int = 6
    max_active_lights: int = 128        # light bank is padded, not fixed-8
    max_primitive_count: int = 1 << 30  # 32-bit indices internally
    max_vertex_index: int = 1 << 30
    texture_formats: tuple = ("float32_rgba",)
    zbuffer_formats: tuple = ("float32",)
    supports_mipmaps: bool = True
    supports_cube_maps: bool = True   # octahedral env maps
    supports_stencil: bool = True
    supports_render_to_texture: bool = True   # SetTargetTexture
    supports_user_clip_planes: bool = True   # per-entity scissor rects
    vertex_shader_version: int = 0      # fixed-function model only
    pixel_shader_version: int = 0


@dataclasses.dataclass(frozen=True)
class DriverDesc:
    """One enumerated render driver (reference CKRenderManager driver table:
    HW drivers first, then SW — src/CKRenderManager.cpp:190-226)."""

    index: int
    caps: Vx3DCapsDesc
    is_hardware: bool


def enumerate_drivers() -> list[DriverDesc]:
    """The CUDA card first (hardware), the numpy NULL oracle second
    (software)."""
    hw = Vx3DCapsDesc()
    sw = Vx3DCapsDesc(
        driver_name="null-numpy",
        description="numpy reference rasterizer (NULL device, test oracle)",
        is_hardware=False, max_texture_width=4096, max_texture_height=4096,
        supports_mipmaps=False, supports_stencil=False)
    return [DriverDesc(0, hw, True), DriverDesc(1, sw, False)]


@dataclasses.dataclass
class CKDriverProblems:
    """Buggy-driver database entry (reference CKDriverProblems,
    include/CKRasterizerTypes.h:29-58: vendor/renderer match + caps
    overrides like real max texture size and the clamp-to-edge bug).
    Matching is by driver/version substring; overrides clamp the
    advertised caps."""

    vendor: str = ""
    renderer: str = ""
    version: str = ""
    version_must_be_exact: bool = False
    real_max_texture_width: int = 0      # 0 = no override
    real_max_texture_height: int = 0
    clamp_to_edge_bug: bool = False
    rgba_swap_formats: tuple = ()

    def matches(self, caps: Vx3DCapsDesc, version: str = "") -> bool:
        if self.renderer and self.renderer not in caps.driver_name:
            return False
        if self.version:
            if self.version_must_be_exact:
                return version == self.version
            return self.version in version
        return True


def load_video_card_file(path: str) -> list[CKDriverProblems]:
    """Parse a driver-quirks INI (reference CKRasterizer::LoadVideoCardFile,
    include/CKRasterizer.h:95-97). Sections name the renderer; keys map to
    CKDriverProblems fields:

        [some-driver]
        MaxTextureWidth = 2048
        MaxTextureHeight = 2048
        ClampToEdgeBug = 1
        Version = 1.2.3
        VersionMustBeExact = 1
    """
    import configparser
    import os

    problems: list[CKDriverProblems] = []
    if not os.path.exists(path):
        return problems
    cp = configparser.ConfigParser()
    cp.read(path)
    for section in cp.sections():
        s = cp[section]
        problems.append(CKDriverProblems(
            renderer=section,
            version=s.get("Version", ""),
            version_must_be_exact=bool(int(s.get("VersionMustBeExact", "0"))),
            real_max_texture_width=int(s.get("MaxTextureWidth", "0")),
            real_max_texture_height=int(s.get("MaxTextureHeight", "0")),
            clamp_to_edge_bug=bool(int(s.get("ClampToEdgeBug", "0"))),
        ))
    return problems


def apply_driver_problems(caps: Vx3DCapsDesc,
                          problems: list[CKDriverProblems],
                          version: str = "") -> Vx3DCapsDesc:
    """Clamp advertised caps by every matching quirk entry (the reference
    consults the database when initializing driver caps)."""
    for p in problems:
        if not p.matches(caps, version):
            continue
        repl = {}
        if p.real_max_texture_width:
            repl["max_texture_width"] = min(caps.max_texture_width,
                                            p.real_max_texture_width)
        if p.real_max_texture_height:
            repl["max_texture_height"] = min(caps.max_texture_height,
                                             p.real_max_texture_height)
        if repl:
            caps = dataclasses.replace(caps, **repl)
    return caps
