"""Render settings: the 17 legacy options + INI-style config.

Mirrors the reference's layered config (SURVEY §5): CK2_3D.ini parsed next to
the module (src/CKRenderSettings.cpp:104-172) and the VxOption table
registered by the manager ctor (src/CKRenderManager.cpp:79-127).
"""

from __future__ import annotations

import os

# The 17 options with their reference defaults
# (src/CKRenderManager.cpp:79-127, src/CK2_3D.ini:7-25).
_DEFAULTS = {
    "TextureVideoFormat": "_32_ARGB8888",
    "SpriteVideoFormat": "_16_ARGB1555",
    "EnableScreenDump": 0,
    "EnableDebugMode": 0,
    "VertexCache": 16,
    "SortTransparentObjects": 1,
    "TextureCacheManagement": 1,
    "UseIndexBuffers": 1,
    "ForceLinearFog": 0,
    "EnsureVertexShader": 0,
    "ForceSoftware": 0,
    "DisableFilter": 0,
    "DisableDithering": 0,
    "Antialias": 0,
    "DisableMipmap": 0,
    "DisableSpecular": 0,
    "DisablePerspectiveCorrection": 0,
    # g_FogProjectionMode global in the reference (src/CKMaterial.cpp:49,
    # applied CKRenderedScene.cpp:416-425) — surfaced as an option here.
    "FogProjectionMode": 0,
    # Extension with no reference equivalent: textured ordered transparency
    # through the iterated layer-peel kernel (B4, not ported yet; the
    # ordered pass raises).
    "TexturedPeel": 1,
}

def default_options() -> dict:
    return dict(_DEFAULTS)


def _parse_ini(path: str) -> dict:
    """Parse the reference's `<CK2_3D>` section format
    (src/CKRenderSettings.cpp:42-76): `<Section>` headers, `key=value` lines."""
    values: dict[str, str] = {}
    section = None
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(";") or line.startswith("#"):
                    continue
                if line.startswith("<") and line.endswith(">"):
                    section = line[1:-1]
                    continue
                if section == "CK2_3D" and "=" in line:
                    k, v = line.split("=", 1)
                    values[k.strip()] = v.strip()
    except OSError:
        pass
    return values


_ini_cache: dict[str, dict] | None = None


def _ini_values() -> dict:
    global _ini_cache
    if _ini_cache is None:
        path = os.environ.get(
            "CK2_3D_INI",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "CK2_3D.ini"),
        )
        _ini_cache = _parse_ini(path)
    return _ini_cache


def get_string(name: str, default: str | None = None) -> str | None:
    ini = _ini_values()
    if name in ini:
        return ini[name]
    if default is not None:
        return default
    d = _DEFAULTS.get(name)
    return None if d is None else str(d)


def get_dword(name: str, default: int = 0) -> int:
    v = get_string(name, None)
    if v is None:
        return default
    try:
        return int(str(v), 0)
    except ValueError:
        return default
