"""Frame windows: W staged frames, each one replay of a CUDA graph.

The counterpart of the reference's ``render_frame_packed_window`` and
``render_frame_window_fused`` (``ckrenderengine_tpu/pipeline/frame.py``),
which run W frames as one ``lax.scan`` program with a per-frame f32
checksum of the framebuffer as the window's fence. On the card the plain
idiom for the same API is a CUDA graph: one :class:`FrameWindow` per window
key captures ONE whole device-decided frame (``frame.render_frame_packed``
with ``flags``: no host read inside it) — the unpack, a bound clip's
animate and compose stages, the 3D sprites' corners, the vertex stage, the
solve (B1/B5 or B2), the shade, the ordered pass (B3 or B4), the line pass
(L1), the 2D overlays, the Antialias resolve and the frame's checksum and
flag row — reading static input buffers. The key holds the per-compile
tensors (the sprite rows, the line bank, the static dict) by identity. A
window then:

1. packs the W frames' buffers (``dyn_f``, ``dyn_i``, a bound clip's locals
   and time) into one pinned host block and makes one ``non_blocking``
   host-to-device copy;
2. per frame copies its slot into the static input, replays the graph and
   copies the frame's row (checksum and flags) into row i of the window's
   outputs;
3. clones the last frame's fb / zb / sb out of the graph's outputs (the
   next replay overwrites them);
4. copies the (W, ``ROW_WORDS``) rows to pinned memory behind an event: the
   window's one host read, which the render context resolves later
   (:meth:`Pending.read`): flagged frames are rendered again through the
   eager path, and the capacity governor reads the rows' bin statistics.

A context batch (``CKRenderManager.ProcessBatched``) is a stacked window:
one slot per member of a group of render contexts, the first member's
frame captured, and after each replay the graph's fb / zb / sb copied into
row i of (n, ...) outputs, whose slices become the members' buffers.

A render context's vertex and pixel shaders (``raster/stage.py``) run
once, at capture; the replays re-run the kernels they launched, so what a
stage's Python closure holds is baked into the key's graph, and per-frame
inputs reach it through the scene. A stage that synchronises with the host
raises ``stage.StageCaptureError``: such a frame does not fall back to the
eager path.

On the CPU (the tests' device) :meth:`FrameWindow.run` runs the same
device-decided frame function eagerly, slot by slot, with no capture; a
CUDA window never takes that path, and a failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..raster.stage import capturing
from . import frame as fr

# A frame's row: the checksum's f32 bits, the main tiled solve's bin
# statistics (zero when the frame solves flat), then one word per flag.
ROW_SUM = 0
ROW_BINS = slice(1, 8)
FLAG_KEYS = ("StencilRemainder", "OrderedReplay", "PeelBad", "PeelMore")
ROW_FLAGS = slice(8, 8 + len(FLAG_KEYS))
ROW_WORDS = 8 + len(FLAG_KEYS)


def flag_word(key: str) -> int:
    """The row word of flag ``key`` (one of FLAG_KEYS)."""
    return ROW_FLAGS.start + FLAG_KEYS.index(key)

# A context manager factory the copy-and-replay loop of a CUDA window runs
# under (None: none). chip_smoke.py sets it to a
# ``torch.cuda.set_sync_debug_mode("error")`` scope.
REPLAY_GUARD = None


def checksum(fb: torch.Tensor) -> torch.Tensor:
    """A frame's fence entry: the f32 sum of its framebuffer (the
    reference's per-frame fence, ``render_frame_window_fused``)."""
    return fb.sum(dtype=torch.float32)


def frame_row(fb: torch.Tensor, flags: dict) -> torch.Tensor:
    """(ROW_WORDS,) int32 on fb's device: checksum bits, bin statistics,
    flags (:func:`frame.render_frame_impl`'s ``flags``)."""
    dev = fb.device
    bins = flags.get("SolveBinStats")
    if bins is None:
        bins = torch.zeros(7, dtype=torch.int32, device=dev)
    words = [checksum(fb).view(torch.int32).reshape(1),
             bins.to(torch.int32).reshape(7)]
    for k in FLAG_KEYS:
        v = flags.get(k)
        words.append(torch.zeros(1, dtype=torch.int32, device=dev)
                     if v is None else v.to(torch.int32).reshape(1))
    return torch.cat(words)


def flagged(rows: np.ndarray) -> np.ndarray:
    """(n,) bool: the frames whose device-decided result is not exact (a
    tiled solve needed its remainder, B3's phase A overflowed, or the peel
    overflowed or did not drain in its rounds)."""
    return rows[:, 3:6].any(1) | rows[:, ROW_FLAGS].any(1)


class _Same:
    """Compares by identity and keeps its object alive, so that no later
    object can take its id."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


def freeze(v, shapes: bool = False):
    """A key part for ``v``: numbers, strings and None as they are, tuples,
    lists and dicts element by element, numpy arrays by their bytes,
    anything else (tensors, banks, callables) by identity. ``shapes``:
    tensors by their shape and dtype instead (the members of a context
    batch each hold their own compile's tensors of one scene)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (tuple, list)):
        return tuple(freeze(x, shapes) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, freeze(x, shapes)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    if shapes and isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype))
    return _Same(v)


def pack_slot(slot, out: np.ndarray) -> None:
    """Write one staged frame (dyn_f, dyn_i, anim) into an int32 row:
    dyn_f's bits, dyn_i, then with a bound clip its (N,4,4) locals' bits and
    its time's."""
    dyn_f, dyn_i, anim = slot
    lf, li = dyn_f.shape[0], dyn_i.shape[0]
    out[:lf] = dyn_f.view(np.int32)
    out[lf:lf + li] = dyn_i
    if anim is not None:
        local, t = anim
        n = local.size
        out[lf + li:lf + li + n] = np.ascontiguousarray(
            local, np.float32).reshape(-1).view(np.int32)
        out[lf + li + n] = np.float32(t).view(np.int32)


class Pending:
    """A dispatched window awaiting its read: the staged slots, the frames'
    rows (pinned host memory, valid once ``done`` has passed), the fence
    (W,) f32 on the device and the last frame's fb / zb / sb (a stacked
    window's: every slot's, (n, ...))."""

    def __init__(self, window, slots, rows_host, done, rows_dev, out):
        self.window = window
        self.slots = slots
        self._rows_host = rows_host
        self._done = done
        self.fence = rows_dev[:, ROW_SUM].view(torch.float32)
        self.fb, self.zb = out[0], out[1]
        self.sb = out[2] if len(out) > 2 else None

    def read(self) -> np.ndarray:
        """(n, ROW_WORDS) int32 rows of the staged frames; waits for the
        window."""
        if self._done is not None:
            self._done.synchronize()
        return self._rows_host.numpy().copy()

    def replace(self, i: int, fb: torch.Tensor) -> None:
        """Frame i was rendered again: its fence entry (and, for the last
        frame, the padding entries that repeat it) take the new checksum."""
        n = len(self.slots)
        end = self.fence.shape[0] if i == n - 1 else i + 1
        self.fence[i:end] = checksum(fb)


class FrameWindow:
    """The graph (on CUDA) and the buffers of one window key.

    ``static`` and ``params`` are the frames' shared inputs
    (``CKRenderContext._fill_packed``); ``bank`` the bound clip's AnimBank
    (or None); ``rounds`` the peel's fixed round count; ``size`` the window
    size W (the fence's length). ``stacked``: keep every slot's fb / zb /
    sb, in (n, 4, H, W) / (n, H, W) / (n, H, W) outputs, not only the last
    one's (a context batch: one slot per member, ``ProcessBatched``).
    ``capture_ms`` (the warm-up and the capture) and ``pool_bytes`` (the
    reserved memory the capture added: the graph's private pool) are set
    by the capture."""

    def __init__(self, key, static: dict, params: dict, bank, rounds: int,
                 size: int, device, stacked: bool = False):
        self.key = key
        self.static = static
        self.params = {k: v for k, v in params.items() if k != "world_in"}
        self.bank = bank
        self.rounds = rounds
        self.size = size
        self.device = torch.device(device)
        self.stacked = stacked
        self.graph = None
        self.tiled = False
        self.capture_ms = 0.0
        self.pool_bytes = 0

    # -- the frame -----------------------------------------------------------
    def _views(self, buf: torch.Tensor):
        """(dyn_f, dyn_i, local, t) views of one packed int32 row."""
        lf, li = self._words
        dyn_f = buf[:lf].view(torch.float32)
        dyn_i = buf[lf:lf + li]
        if self.bank is None:
            return dyn_f, dyn_i, None, None
        o = lf + li
        local = buf[o:o + 16 * self.n_local].view(torch.float32).reshape(
            self.n_local, 4, 4)
        t = buf[o + 16 * self.n_local:].view(torch.float32)[0]
        return dyn_f, dyn_i, local, t

    def frame(self, dyn_f, dyn_i, local=None, t=None):
        """One device-decided frame: (fb, zb[, sb]), its row, and whether
        its main solve was tiled."""
        world = None
        if self.bank is not None:
            world = fr.eval_anim_world(local, self.static["parent"],
                                       self.bank, t, self.params["levels"])
        flags = {}
        out = fr.render_frame_packed(self.static, dyn_f, dyn_i,
                                     **self.params, world_in=world,
                                     flags=flags, peel_rounds=self.rounds)
        return out, frame_row(out[0], flags), "SolveBinStats" in flags

    def _row_width(self, slot) -> int:
        """Set the row layout from a staged frame; returns its width."""
        dyn_f, dyn_i, anim = slot
        self._words = (dyn_f.shape[0], dyn_i.shape[0])
        self.n_local = 0 if anim is None else anim[0].shape[0]
        return sum(self._words) + (16 * self.n_local + 1
                                   if anim is not None else 0)

    # -- windows -------------------------------------------------------------
    def run(self, slots: list) -> Pending:
        """Render the staged frames (at most ``size``); returns the
        :class:`Pending` window. The fence repeats the last frame's
        checksum past the staged frames."""
        if not 0 < len(slots) <= self.size:
            raise ValueError(f"{len(slots)} frames for a window of "
                             f"{self.size}")
        if self.device.type == "cuda":
            return self._replay(slots)
        return self._eager(slots)

    def _eager(self, slots: list) -> Pending:
        """The CPU: the device-decided frame slot by slot, no graph."""
        if self.device.type != "cpu":
            raise RuntimeError("the eager window runs on the CPU only")
        width = self._row_width(slots[0])
        rows, outs = [], []
        for slot in slots:
            buf = np.zeros(width, np.int32)
            pack_slot(slot, buf)
            out, row, self.tiled = self.frame(
                *self._views(torch.from_numpy(buf)))
            rows.append(row)
            outs.append(out)
        if self.stacked:
            out = tuple(torch.stack(planes) for planes in zip(*outs))
        rows = torch.stack(rows + [rows[-1]] * (self.size - len(rows)))
        return Pending(self, slots, rows[:len(slots)], None, rows, out)

    def _capture(self, slot) -> None:
        """Warm the frame up on a side stream, then capture it into the
        graph with its own memory pool, reading the static input buffer."""
        dev = self.device
        width = self._row_width(slot)
        host = np.zeros(width, np.int32)
        pack_slot(slot, host)
        self._in = torch.from_numpy(host).to(dev)
        self._host = torch.empty((self.size, width), dtype=torch.int32,
                                 pin_memory=True)
        self._host_np = self._host.numpy()
        self._stage = torch.empty((self.size, width), dtype=torch.int32,
                                  device=dev)
        self._uploaded = None
        views = self._views(self._in)
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # A user stage that synchronises with the host raises in the
        # warm-up, naming itself, before the capture begins.
        with torch.cuda.stream(side), capturing():
            self.frame(*views)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        # torch.cuda.graph empties the cache before it captures; emptied
        # here first, the reserved memory the capture adds is its pool.
        torch.cuda.empty_cache()
        before = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
        graph = torch.cuda.CUDAGraph()
        # A capture stream of the window's own device (torch's shared
        # default one belongs to the device that captured first).
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)), \
                capturing():
            self._out, self._row, self.tiled = self.frame(*views)
        torch.cuda.synchronize(dev)
        self.pool_bytes = (torch.cuda.memory_stats(dev)[
            "reserved_bytes.all.current"] - before)
        self.capture_ms = (time.monotonic() - t0) * 1e3
        self.graph = graph

    def _replay(self, slots: list) -> Pending:
        if self.graph is None:
            self._capture(slots[0])
        dev = self.device
        stream = torch.cuda.current_stream(dev)
        n = len(slots)
        if self._uploaded is not None:
            # The pinned block is free once the last upload has landed.
            self._uploaded.synchronize()
        for i, slot in enumerate(slots):
            pack_slot(slot, self._host_np[i])
        # A pinned block of its own per run: a stacked window's group may
        # run in several chunks before the first chunk's rows are read.
        rows_host = torch.empty((n, ROW_WORDS), dtype=torch.int32,
                                pin_memory=True)
        guard = REPLAY_GUARD or contextlib.nullcontext
        with guard():
            self._stage[:n].copy_(self._host[:n], non_blocking=True)
            self._uploaded = torch.cuda.Event()
            self._uploaded.record(stream)
            rows = torch.empty((self.size, ROW_WORDS), dtype=torch.int32,
                               device=dev)
            if self.stacked:
                # Every slot's buffers, each copied out of the graph's
                # outputs before the next replay overwrites them.
                out = tuple(torch.empty((n,) + tuple(t.shape),
                                        dtype=t.dtype, device=dev)
                            for t in self._out)
            for i in range(n):
                self._in.copy_(self._stage[i])
                self.graph.replay()
                rows[i].copy_(self._row)
                if self.stacked:
                    for o, t in zip(out, self._out):
                        o[i].copy_(t)
            if n < self.size:
                rows[n:].copy_(rows[n - 1].expand(self.size - n, ROW_WORDS))
            if not self.stacked:
                out = tuple(t.clone() for t in self._out)
            rows_host.copy_(rows[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return Pending(self, slots, rows_host, done, rows, out)

    def release(self) -> None:
        """Drop the graph, its pool and the buffers (the key changed)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self._out = self._row = self._in = self._stage = None
