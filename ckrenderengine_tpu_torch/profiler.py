"""Profiling: VxTimeProfiler + per-phase frame timers.

API mirror of the reference's VxTimeProfiler stopwatches woven through the
frame (10 named profilers in RCKRenderContext,
include/RCKRenderContext.h:269-280, accumulated into VxStats
by CKRenderedScene::Draw :244-350). Here the phase set maps to: scene-state
build (host), device frame dispatch, 2D bank build, callbacks.
:class:`DeviceTraceSession` records frames with ``torch.profiler``.
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


class DeviceTraceSession:
    """A ``torch.profiler`` trace of the frames between ``Start`` and
    ``Stop`` (``CKRenderManager.StartDeviceTrace`` / ``StopDeviceTrace``),
    the host's operations and, where CUDA is available, the card's kernels
    and copies. ``Stop`` writes it as a Chrome trace into ``log_dir``
    (``path``), which chrome://tracing and Perfetto open."""

    def __init__(self, log_dir: str):
        self.log_dir = str(log_dir)
        self.path = None
        self._prof = None

    def Start(self) -> bool:
        if self._prof is not None:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        return True

    def Stop(self) -> bool:
        if self._prof is None:
            return False
        import os

        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(self.path)
        return True
