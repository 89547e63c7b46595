"""The port's device mesh: a named 1-D axis of torch devices.

What ``jax.sharding.Mesh`` is to the reference's 1-D ``ctx`` and ``band``
axes (``ckrenderengine_tpu/parallel``). A mesh entry is a device that a
slice of the work (a band of a frame, a block of contexts) runs on. A list
may name one device several times: an n-entry mesh on one card runs every
entry there, one after another, which is how a machine with one card runs
the multi-card paths (the reference's tests force n virtual CPU devices
with ``--xla_force_host_platform_device_count`` for the same purpose).
"""

from __future__ import annotations

import contextlib

import torch


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an index for a CUDA card, or a
    ``ValueError`` when no such device exists here (a card index past the
    count, CUDA without a card, another device type)."""
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise ValueError(f"{device!r} names no device") from e
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"mesh devices are CUDA cards or the CPU, not {dev}")
    if not torch.cuda.is_available():
        raise ValueError(f"{dev}: no CUDA card here")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"{dev}: this machine has "
                         f"{torch.cuda.device_count()} CUDA card(s)")
    return torch.device("cuda", index)


class DeviceMesh:
    """``devices`` along one named ``axis`` ("band" or "ctx"). ``shape``
    maps the axis to the entry count (``mesh.shape[axis]``, as on a JAX
    mesh); ``size`` is that count. Every entry must exist (a device that
    does not raises ``ValueError`` here: no entry silently becomes another
    device); an entry may repeat."""

    def __init__(self, devices, axis: str = "band"):
        self.devices = tuple(check_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.shape = {axis: len(self.devices)}
        self.size = len(self.devices)

    def __repr__(self) -> str:
        return (f"DeviceMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")


def default_devices(device) -> list:
    """The devices a context on ``device`` shards over by default: every
    CUDA card for a card context, the one CPU for a CPU context."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def on(device):
    """A context in which work runs on ``device``: for a card it is the
    current CUDA device, which the kernels' C entry points (launched on that
    card's current stream) and CUDA graph capture take; nothing for the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(tree, device):
    """``tree`` with every tensor moved to ``device`` (tuples, named tuples,
    lists and dicts rebuilt around them; anything else as it is). A tensor
    already there is the same tensor, not a copy."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree
