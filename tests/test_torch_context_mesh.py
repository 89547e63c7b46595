"""Context batches over a context mesh on the port, on the CPU, where a
mesh names the CPU once per entry (``parallel.mesh.DeviceMesh``):

- ``make_context_mesh``: n entries of the CPU; more cards than there are
  raises ``ValueError``, as the reference's does;
- ``render_frames_sharded``, ``render_frames_full_sharded`` and
  ``render_frames_packed_sharded`` on a 4-entry mesh against the
  reference's on its 4-device CPU mesh (the one-triangle group of
  tests/test_torch_batch.py, 4 contexts at 48x48; the packed path with the
  bound clip's worlds), and bit-equal to the port's unsharded batch;
- ``ProcessBatched(mesh=)`` and ``_batch_packed(mesh=)``: 8 members over 4
  entries, and 2 bound-clip members over 4 entries (two blocks empty), each
  member equal to its own ``Render()`` bit for bit; anything but a mesh
  raises ``TypeError``;
- ``dryrun_multichip(4)`` prints its three ``path ok`` lines.
"""

import numpy as np
import pytest
import torch

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.parallel import context_batch as tcb

from _torch_common import to_np
from test_torch_batch import _batched, _bind_spin, _own_render_equal, \
    _tri_group

N = 4


def test_make_context_mesh():
    mesh = tcb.make_context_mesh(N, platform="cpu")
    assert mesh.devices == (torch.device("cpu"),) * N
    assert mesh.shape["ctx"] == N == mesh.size
    with pytest.raises(ValueError, match="need 2 devices"):
        tcb.make_context_mesh(2, platform="cuda")
    with pytest.raises(ValueError):
        tcb.make_context_mesh(1, platform="tpu")
    if not torch.cuda.is_available():
        assert tcb.make_context_mesh(3).devices == (torch.device("cpu"),) * 3


def _stacked(n=N):
    """The reference's and the port's stacked scenes of the one-triangle
    group (``n`` contexts at 48x48), both from the reference's packed
    inputs, and the packed inputs themselves."""
    import jax.numpy as jnp
    from ckrenderengine_tpu.parallel import context_batch as jcb
    from ckrenderengine_tpu.pipeline import frame as jfr
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    _c, _rm, rjs, _o = _tri_group(J, n=n)
    js, ts, filled = [], [], []
    for rj in rjs:
        rj.Render()
        static, dyn_f, dyn_i, params = rj._fill_packed([], [])
        static = {k: np.asarray(v) for k, v in static.items()}
        filled.append((static, dyn_f, dyn_i, params))
        js.append(jfr.unpack_scene({k: jnp.asarray(v) for k, v in
                                    static.items()}, jnp.asarray(dyn_f),
                                   jnp.asarray(dyn_i), params["layout"])[0])
        st, tf, ti, tp = convert.from_reference(static, dyn_f, dyn_i, params,
                                                "cpu")
        ts.append(tfr.unpack_scene(st, tf, ti, tp["layout"])[0])
    return jcb.stack_scenes(js), tcb.stack_scenes(ts), params["levels"], \
        filled


@pytest.mark.parametrize("fn", ["render_frames_sharded",
                                "render_frames_full_sharded"])
def test_sharded_frames(fn):
    """Each block of the context axis on its entry: against the
    reference's sharded frames, and bit-equal to the unsharded batch."""
    from ckrenderengine_tpu.parallel import context_batch as jcb

    jsc, tsc, levels, _filled = _stacked()
    fb_j, zb_j = (np.asarray(x) for x in getattr(jcb, fn)(
        jsc, jcb.make_context_mesh(N, platform="cpu"), levels, 48, 48))
    mesh = tcb.make_context_mesh(N, platform="cpu")
    fb_t, zb_t = getattr(tcb, fn)(tsc, mesh, levels, 48, 48)
    assert fb_t.shape == (N, 4, 48, 48) and zb_t.shape == (N, 48, 48)
    np.testing.assert_allclose(to_np(fb_t), fb_j, atol=2e-5)
    np.testing.assert_allclose(to_np(zb_t), zb_j, atol=2e-6)
    assert not np.array_equal(fb_j[0], fb_j[N - 1])
    base = fn.replace("_sharded", "_batched")
    fb_u, zb_u = getattr(tcb, base)(tsc, levels, 48, 48)
    assert torch.equal(fb_t, fb_u) and torch.equal(zb_t, zb_u)
    blocks = tcb.shard_scenes(tsc, tcb.make_context_mesh(3, platform="cpu"))
    assert [b.local.shape[0] for _d, b in blocks] == [2, 1, 1]


def test_packed_sharded_with_clip_worlds():
    """``render_frames_packed_sharded`` of the bound-clip group (2
    members, 4 entries: two blocks are empty) against the reference's,
    and bit-equal to the unsharded packed batch."""
    from ckrenderengine_tpu import anim as janim
    from ckrenderengine_tpu.parallel import context_batch as jcb
    from ckrenderengine_tpu_torch.pipeline import frame as tfr

    ctx_j, _rm, rjs, _o = _tri_group(J, n=2)
    clip_j = _bind_spin(J, janim, ctx_j, rjs)
    clip_j.SetFrame(6.0)
    filled = []
    for rj in rjs:
        rj.Render()
        filled.append(rj._fill_packed([], []))
    static, _f, _i, params = filled[0]
    p = {k: v for k, v in params.items()
         if k not in ("world_in", "texdev", "texdev_rects")}
    out_j = jcb.render_frames_packed_sharded(
        static, np.stack([f[1] for f in filled]),
        np.stack([f[2] for f in filled]),
        jcb.make_context_mesh(2, platform="cpu"),
        world_in=np.stack([np.asarray(f[3]["world_in"]) for f in filled]),
        **p)
    conv = [convert.from_reference({k: np.asarray(v) for k, v in
                                    f[0].items()}, *f[1:], "cpu")
            for f in filled]
    st, _tf, _ti, tp = conv[0]
    tp = {k: v for k, v in tp.items() if k != "world_in"}
    args = (st, torch.stack([c[1] for c in conv]),
            torch.stack([c[2] for c in conv]))
    worlds = torch.stack([c[3]["world_in"] for c in conv])
    out_t = tcb.render_frames_packed_sharded(
        *args, tcb.make_context_mesh(N, platform="cpu"), world_in=worlds,
        **tp)
    np.testing.assert_allclose(to_np(out_t[0]), np.asarray(out_j[0]),
                               atol=2e-5)
    np.testing.assert_allclose(to_np(out_t[1]), np.asarray(out_j[1]),
                               atol=2e-6)
    out_u = tfr.render_frames_packed_batched(*args, world_in=worlds, **tp)
    assert all(torch.equal(a, b) for a, b in zip(out_t, out_u))


def test_process_batched_over_a_mesh():
    """8 members over 4 entries (blocks of 2): every member bit-equal to
    its own Render(); the batch ran as one read; a non-mesh is refused."""
    from ckrenderengine_tpu_torch.pipeline import window as fw

    _c, rm, rcs, _o = _tri_group(O, n=8, device="cpu")
    mesh = tcb.make_context_mesh(N, platform="cpu")
    runs = []
    real = fw.FrameWindow.run

    def run(self, slots):
        runs.append(len(slots))
        return real(self, slots)

    fw.FrameWindow.run = run
    try:
        rm.ProcessBatched(mesh=mesh)
    finally:
        fw.FrameWindow.run = real
    assert runs == [2, 2, 2, 2]
    reads = {id(rc._batch_read) for rc in rcs}
    assert len(reads) == 1
    frames = [(rc.fb.clone(), rc.zb.clone()) for rc in rcs]
    assert all(rc.fb.device == torch.device("cpu") for rc in rcs)
    _own_render_equal(rcs, frames)
    with pytest.raises(TypeError, match="DeviceMesh"):
        rm.ProcessBatched(mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        rm.ProcessBatched(mesh=[torch.device("cpu")] * 2)


def test_batch_packed_over_a_mesh_with_a_clip():
    """The bound-clip group (2 members) over 4 entries through
    ``_batch_packed(mesh=)``: each member equal to the unsharded batch's
    frame and to its own Render()."""
    from ckrenderengine_tpu_torch import anim as tanim

    ctx, rm, rcs, _o = _tri_group(O, n=2, device="cpu")
    clip = _bind_spin(O, tanim, ctx, rcs)
    clip.SetFrame(6.0)
    frames = _batched(rm, rcs)
    assert rm._batch_packed(rcs, tcb.make_context_mesh(N, platform="cpu"))
    for rc, (fb, zb) in zip(rcs, frames):
        assert torch.equal(rc.fb, fb) and torch.equal(rc.zb, zb)
    _own_render_equal(rcs, frames)


def test_dryrun_multichip_on_the_cpu(capsys):
    from ckrenderengine_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(N, devices=["cpu"] * N)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "path ok" in ln]
    assert [ln.split()[1] for ln in lines] == [
        "full-sharded", "packed-sharded", "band-sharded"]
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun_multichip(N, devices=["cpu"] * 2)


def test_item_12_has_left_the_port_queue():
    """No ``unported(..., 12)`` call is left in the port, the queue has no
    key 12, and ``parallel/tile_shard.py`` exists."""
    import pathlib

    from ckrenderengine_tpu_torch import roadmap

    root = pathlib.Path(roadmap.__file__).parent
    assert 12 not in roadmap.PORT_QUEUE
    assert (root / "parallel" / "tile_shard.py").exists()
    for path in root.rglob("*.py"):
        text = path.read_text()
        start = text.find("unported(")
        while start >= 0:
            depth, i = 0, start + len("unported")
            while True:                      # the call's balanced arguments
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                if depth == 0:
                    break
                i += 1
            args = text[start:i + 1]
            assert not args.replace(" ", "").endswith(",12)"), (path, args)
            start = text.find("unported(", i)
