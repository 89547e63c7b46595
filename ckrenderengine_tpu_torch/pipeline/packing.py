"""Dynamic-state packing: ONE f32 + ONE i32 upload per frame.

All per-frame dynamic state (matrices, lights, material colors, render
states, fog/camera scalars) is packed into two flat host buffers, uploaded
once, and sliced back into named fields on the device. Slices of a torch
tensor are views, so unpacking moves no data.

The layout is a static (hashable) tuple; it changes only when the scene's
capacities change (entity count, light pad, clip-plane count), and it is
the same tuple the reference package builds, so both packages read the
same buffers.
"""

from __future__ import annotations

import numpy as np
import torch


class DynLayout:
    """Accumulates the packed layout. add() during compile; freeze() yields
    the hashable key."""

    def __init__(self):
        self._f: list[tuple] = []      # (name, offset, size, shape)
        self._i: list[tuple] = []
        self.size_f = 0
        self.size_i = 0

    def add_f(self, name: str, shape: tuple) -> None:
        size = int(np.prod(shape)) if shape else 1
        self._f.append((name, self.size_f, size, tuple(shape)))
        self.size_f += size

    def add_i(self, name: str, shape: tuple) -> None:
        size = int(np.prod(shape)) if shape else 1
        self._i.append((name, self.size_i, size, tuple(shape)))
        self.size_i += size

    def freeze(self) -> tuple:
        return (tuple(self._f), tuple(self._i))

    def make_buffers(self):
        return (np.zeros(max(self.size_f, 1), np.float32),
                np.zeros(max(self.size_i, 1), np.int32))


def fill(buf_f: np.ndarray, buf_i: np.ndarray, layout_key: tuple,
         values: dict) -> None:
    """Host: write named values into the packed buffers."""
    entries_f, entries_i = layout_key
    for name, off, size, shape in entries_f:
        v = values[name]
        buf_f[off:off + size] = np.asarray(v, np.float32).reshape(-1)
    for name, off, size, shape in entries_i:
        v = values[name]
        buf_i[off:off + size] = np.asarray(v, np.int32).reshape(-1)


def unpack(dyn_f: torch.Tensor, dyn_i: torch.Tensor,
           layout_key: tuple) -> dict:
    """Device: slice named fields back out (views of the two buffers;
    scalar fields become 0-d tensors)."""
    entries_f, entries_i = layout_key
    out = {}
    for name, off, size, shape in entries_f:
        v = dyn_f[off:off + size]
        out[name] = v.reshape(shape) if shape else v[0]
    for name, off, size, shape in entries_i:
        v = dyn_i[off:off + size]
        out[name] = v.reshape(shape) if shape else v[0]
    return out


def has_field(layout_key: tuple, name: str) -> bool:
    entries_f, entries_i = layout_key
    return any(e[0] == name for e in entries_f) \
        or any(e[0] == name for e in entries_i)
