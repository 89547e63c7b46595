"""Features of the reference package that this package does not carry yet.

Each raises ``NotImplementedError`` where it is first used, naming the item
of the port queue in ROADMAP.md that will bring it. A frame never renders
something different in their place.
"""

from __future__ import annotations

# ROADMAP.md "Port queue", in order.
PORT_QUEUE = {
    1: "quantized shade with e-plane consumption",
    2: "GPU benchmark",
    3: "ordered-blend kernel B3",
    4: "textured-peel kernel B4",
    5: "fused-fetch solve variant B5",
    6: "ordered and transparent pass",
    7: "stencil pass",
    8: "antialias supersampling",
    9: "frame windows",
    10: "skinning and animation",
    11: "2D overlays",
    12: "line pass",
    13: "3D sprites",
    14: "material effects (TexGen, bump, cube env, channels, effect passes)",
    15: "pixel and vertex shaders",
    16: "capacity governor",
    17: "context batching and tile sharding",
    18: "rasterizer HAL",
    19: "scene IO",
    20: "patch meshes",
    21: "progressive meshes",
    22: "remaining host API (stereo, render-to-texture, picking, "
        "immediate-mode draws, debug stepping)",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error a not-yet-ported feature raises at its point of use."""
    return NotImplementedError(
        f"{what} is not ported to ckrenderengine_tpu_torch yet "
        f"(ROADMAP.md port queue item {item}: {PORT_QUEUE[item]})")
