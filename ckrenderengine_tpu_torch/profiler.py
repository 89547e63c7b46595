"""Profiling: VxTimeProfiler + per-phase frame timers.

API mirror of the reference's VxTimeProfiler stopwatches woven through the
frame (10 named profilers in RCKRenderContext,
include/RCKRenderContext.h:269-280, accumulated into VxStats
by CKRenderedScene::Draw :244-350). Here the phase set maps to: scene-state
build (host), device frame dispatch, 2D bank build, callbacks.
"""

from __future__ import annotations

import time


class VxTimeProfiler:
    """Stopwatch with the reference's Reset/Current/Split semantics."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def Reset(self):
        self._t0 = time.perf_counter()

    def Current(self) -> float:
        """Elapsed milliseconds since Reset."""
        return (time.perf_counter() - self._t0) * 1000.0

    def Split(self) -> float:
        """Elapsed ms, then reset."""
        now = time.perf_counter()
        ms = (now - self._t0) * 1000.0
        self._t0 = now
        return ms


class FramePhases:
    """Named per-frame phase accumulator (the VxStats time fields:
    TimeToObjectsCallBacks/SceneTraversalTime/SkinTime/SpriteTime/
    TransparentObjectsSortTime analogues re-expressed for the one-call frame)."""

    FIELDS = (
        "SceneBuildTime",       # host pytree build (_build_scene_device)
        "BankBuildTime",        # 2D/sprite/line bank construction
        "DeviceTime",           # frame dispatch (the device runs asynchronously)
        "CallbacksTime",        # pre/post user callbacks
        "ObjectsRenderTime",    # total minus callbacks (parity name)
    )

    def __init__(self):
        self.reset()

    def reset(self):
        for f in self.FIELDS:
            setattr(self, f, 0.0)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}


class PhaseTimer:
    """Context manager adding elapsed ms to a FramePhases field."""

    def __init__(self, phases: FramePhases, field: str):
        self.phases = phases
        self.field = field

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1000.0
        setattr(self.phases, self.field,
                getattr(self.phases, self.field) + ms)
        return False
