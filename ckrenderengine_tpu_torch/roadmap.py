"""Features of the reference package that this package does not carry yet.

Each raises ``NotImplementedError`` where it is first used, naming the item
of the port queue in ROADMAP.md that will bring it. A frame never renders
something different in their place.
"""

from __future__ import annotations

# ROADMAP.md "Port queue", in order.
PORT_QUEUE = {
    1: "GPU benchmark",
    14: "image files other than DDS (LoadImage), movie sprites (LoadMovie), "
        "and fonts, sizes or characters without a baked glyph table",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error a not-yet-ported feature raises at its point of use."""
    return NotImplementedError(
        f"{what} is not ported to ckrenderengine_tpu_torch yet "
        f"(ROADMAP.md port queue item {item}: {PORT_QUEUE[item]})")
