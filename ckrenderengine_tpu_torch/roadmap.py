"""Features of the reference package that this package does not carry yet.

Each raises ``NotImplementedError`` where it is first used, naming the item
of the port queue in ROADMAP.md that will bring it. A frame never renders
something different in their place.
"""

from __future__ import annotations

# ROADMAP.md "Port queue", in order.
PORT_QUEUE = {
    1: "GPU benchmark",
    12: "multi-card context sharding and framebuffer bands",
    13: "rasterizer HAL",
    14: "scene IO",
    16: "progressive meshes",
    17: "remaining host API (stereo, render-to-texture, picking, "
        "immediate-mode draws, debug stepping, grids, the scene graph, "
        "inverse kinematics)",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error a not-yet-ported feature raises at its point of use."""
    return NotImplementedError(
        f"{what} is not ported to ckrenderengine_tpu_torch yet "
        f"(ROADMAP.md port queue item {item}: {PORT_QUEUE[item]})")
