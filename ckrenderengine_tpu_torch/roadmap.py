"""Features of the reference package that this package does not carry yet.

Each raises ``NotImplementedError`` where it is first used, naming the item
of the port queue in ROADMAP.md that will bring it. A frame never renders
something different in their place.
"""

from __future__ import annotations

# ROADMAP.md "Port queue", in order.
PORT_QUEUE = {
    1: "GPU benchmark",
    12: "multi-card context sharding, framebuffer bands and the multi-card "
        "dry run (dryrun_multichip)",
    14: "scene IO, and fonts, sizes or characters without a baked glyph "
        "table",
    16: "progressive meshes",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error a not-yet-ported feature raises at its point of use."""
    return NotImplementedError(
        f"{what} is not ported to ckrenderengine_tpu_torch yet "
        f"(ROADMAP.md port queue item {item}: {PORT_QUEUE[item]})")


def unported_methods(cls: type, item: int, names) -> None:
    """Define each of ``names`` on ``cls`` as a method that raises
    :func:`unported` naming ``cls.name`` and ``item``, whatever its
    arguments, so that a public method of the reference class that this
    package does not carry fails the way every missing feature does. The
    method's ``unported_item`` attribute holds ``item``."""
    for name in names:
        if name in vars(cls):
            raise ValueError(f"{cls.__name__}.{name} is already defined")
        setattr(cls, name, _unported_method(cls.__name__, name, item))


def _unported_method(owner: str, name: str, item: int):
    def method(self, *args, **kwargs):
        raise unported(f"{owner}.{name}", item)

    method.__name__ = name
    method.__qualname__ = f"{owner}.{name}"
    method.__doc__ = (f"Not ported yet: raises NotImplementedError (port "
                      f"queue item {item}).")
    method.unported_item = item
    return method
