"""Features of the reference package that this package does not carry yet.

Each raises ``NotImplementedError`` where it is first used, naming the item
of the port queue in ROADMAP.md that will bring it. A frame never renders
something different in their place.
"""

from __future__ import annotations

# ROADMAP.md "Port queue", in order.
PORT_QUEUE = {
    1: "quantized opaque path (CUDA opaque shade on the quantized rows, "
       "the compact rows, fused-fetch solve variant B5)",
    2: "GPU benchmark",
    3: "stencil pass",
    4: "antialias supersampling",
    5: "frame windows",
    6: "skinning and animation",
    7: "2D overlays",
    8: "line pass",
    9: "3D sprites",
    10: "material effects (TexGen, bump, cube env, channels, effect passes)",
    11: "pixel and vertex shaders",
    12: "capacity governor",
    13: "context batching and tile sharding",
    14: "rasterizer HAL",
    15: "scene IO",
    16: "patch meshes",
    17: "progressive meshes",
    18: "remaining host API (stereo, render-to-texture, picking, "
        "immediate-mode draws, debug stepping)",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error a not-yet-ported feature raises at its point of use."""
    return NotImplementedError(
        f"{what} is not ported to ckrenderengine_tpu_torch yet "
        f"(ROADMAP.md port queue item {item}: {PORT_QUEUE[item]})")
