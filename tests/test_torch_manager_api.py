"""The render manager's API on the port (``Process`` and ``PreProcess``,
the temporary callbacks, context and object bookkeeping, the notifications,
the scene graph, the device trace) and the ``CKRenderedScene`` facade, on
the CPU, held against the reference package: each test runs one script
through both object models and compares what they return.

The cases mirror the reference's own (tests/test_render_options.py::
TestProcessBookkeeping, tests/test_context_surface.py's activation case,
tests/test_api_surface.py::TestManagerSurface, TestManagerLongTail and
TestSceneGraphFacade). Two of them hold repairs: ``Process()`` skips a
context after ``Activate(False)``, and ``PreProcess()`` saves every 3D
entity's world matrix as its last-frame matrix. Host values are compared
exactly; frames are 64x64 flat-route scenes held to the reference within
``_torch_common.ATOL``.
"""

import json
import os

import numpy as np

import ckrenderengine_tpu.objects as J
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu.objects import manager as jm
from ckrenderengine_tpu_torch.objects import manager as tm

from _torch_common import ATOL, small_ctx


def _ctx(P, size=64):
    """The reference's test context (tests/test_api_surface.py:13-19)."""
    ctx = small_ctx(P)
    rc = ctx.GetRenderManager().CreateRenderContext(size, size)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0, 0, -5))
    rc.AttachViewpointToCamera(cam)
    return ctx, rc, cam


def _tri(P, ctx, name="o"):
    """The reference's white triangle (tests/test_api_surface.py:22-34)."""
    mesh = P.CKMesh(ctx, name + "_mesh")
    mesh.SetPositions(np.array([[-1, -1, 0], [0, 1.5, 0], [1, -1, 0]],
                               np.float32))
    mesh.SetFaces(np.array([[0, 1, 2]], np.int32))
    mesh.BuildNormals()
    mat = P.CKMaterial(ctx, name + "_mat")
    mat.SetDiffuse((1, 1, 1, 1))
    mesh.ApplyGlobalMaterial(mat)
    obj = P.CK3dObject(ctx, name)
    obj.SetCurrentMesh(mesh)
    return obj, mesh, mat


def _lit(rc):
    return int((rc.framebuffer()[..., :3].sum(-1) > 0.05).sum())


def _both(script):
    """``script(P)`` through the reference (J) and the port (O)."""
    return script(J), script(O)


# -- the two repairs ---------------------------------------------------------

def _process_script(P):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    rm = ctx.GetRenderManager()
    rc2 = rm.CreateRenderContext(64, 64)
    rc2.AttachViewpointToCamera(cam)
    calls = []
    rc.AddPreRenderCallBack(lambda dev, a: calls.append("rc"))
    rc2.AddPreRenderCallBack(lambda dev, a: calls.append("rc2"))
    rm.Process()
    fb0 = rc.framebuffer().copy()
    rc.Activate(False)
    obj.Show(False)
    rm.Process()                       # must not render rc again
    out = [list(calls), rc.IsActive(),
           bool(np.array_equal(rc.framebuffer(), fb0)), _lit(rc)]
    rc.Activate(True)
    rm.Process()
    return out + [list(calls), _lit(rc)], fb0


def test_process_skips_inactive_context():
    """tests/test_context_surface.py:38-54, with a pre-render callback on
    each of two contexts: after ``rc.Activate(False)``, ``Process()``
    renders only the other one (the callback of rc fires twice in three
    Process calls, as in the reference; the port used to render every
    context) and rc keeps its frame; active again, it draws the hidden
    object's absence."""
    (ref, fb_j), (got, fb_t) = _both(_process_script)
    assert got == ref
    assert got[0] == ["rc", "rc2", "rc2"] and got[2] is True
    assert got[4].count("rc") == 2 and got[5] == 0
    np.testing.assert_allclose(fb_t, fb_j, atol=ATOL)


def _last_frame_script(P):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    child = _tri(P, ctx, "child")[0]
    child.SetParent(obj)
    rm = ctx.GetRenderManager()
    rm.PreProcess()
    before = obj.GetWorldMatrix()
    obj.SetPosition((5, 0, 0))
    out = [np.array_equal(obj.GetLastFrameMatrix(), before)]
    rm.PreProcess()
    obj.SetPosition((7, 0, 0))
    out += [obj.GetLastFrameMatrix()[3, :3].tolist(),
            child.GetLastFrameMatrix()[3, :3].tolist(),
            cam.GetLastFrameMatrix()[3, :3].tolist()]
    rm.SaveLastFrameMatrix()
    out.append(obj.GetLastFrameMatrix()[3, :3].tolist())
    return out


def test_preprocess_saves_last_frame_matrix():
    """tests/test_render_options.py:95-103: ``PreProcess()`` saves every 3D
    entity's world matrix (a child's and the camera's too), so after
    ``PreProcess(); SetPosition(5,0,0); PreProcess(); SetPosition(7,0,0)``
    the last-frame matrix stands at (5, 0, 0), as in the reference (the
    port used to answer (7, 0, 0)); ``SaveLastFrameMatrix`` alone."""
    ref, got = _both(_last_frame_script)
    assert got == ref
    assert got[1] == [5.0, 0.0, 0.0] and got[-1] == [7.0, 0.0, 0.0]


# -- bookkeeping ---------------------------------------------------------------

def _moved_script(P):
    from importlib import import_module
    et = import_module(P.__name__.rsplit(".", 1)[0] + ".scene.entity_table")
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    rm = ctx.GetRenderManager()
    rm.PreProcess()
    obj.SetPosition((1, 0, 0))
    out = [obj.id in rm._moved_entities,
           bool(ctx.entity_table.flags[obj.row] & et.VX_MOVEABLE_HASMOVED),
           [e.GetName() for e in rm.GetMovedEntities()]]
    rm.PostProcess()
    out.append(bool(ctx.entity_table.flags[obj.row]
                    & et.VX_MOVEABLE_HASMOVED))
    calls = []
    obj.AddPreRenderCallBack(
        lambda dev, o, arg: calls.append(("pre", o.GetName())), temp=False)
    obj.AddPostRenderCallBack(
        lambda dev, o, arg: calls.append(("post", o.GetName())), temp=True)
    rc.Render()
    out.append(list(calls))
    rm.PostProcess()
    calls.clear()
    rc.Render()
    return out + [calls]


def test_moved_entities_and_object_callbacks():
    """tests/test_render_options.py:83-119: the moved set and its flag
    across PreProcess / PostProcess, GetMovedEntities, and an object's
    temporary post-render callback dropped by PostProcess."""
    ref, got = _both(_moved_script)
    assert got == ref
    assert got[:4] == [True, True, ["o"], False]
    assert got[-1] == [("pre", "o")]


def _temporary_script(P):
    ctx, rc, cam = _ctx(P)
    rm = ctx.GetRenderManager()
    calls = []
    rm.AddTemporaryCallback(lambda dev, arg: calls.append("pre"))
    rm.AddTemporaryPostRenderCallback(lambda dev, arg: calls.append("post"))
    rm.AddTemporaryPreRenderCallback(lambda dev, arg: calls.append(arg),
                                     "pre_arg", rc)
    rm.Process()
    rm.PostProcess()
    rm.Process()
    out = [list(calls)]
    rm.AddTemporaryCallback(lambda dev, arg: calls.append("x"))
    rm.RemoveAllTemporaryCallbacks()
    rm.Process()
    out.append(list(calls))
    kept = lambda dev, arg: calls.append("kept")           # noqa: E731
    rc.AddPreRenderCallBack(kept)
    rm.AddTemporaryCallback(lambda dev, arg: calls.append("late"),
                            pre=False)
    gone = lambda dev, arg: calls.append("gone")           # noqa: E731
    rm.AddTemporaryCallback(gone)
    rm.RemoveTemporaryCallback(gone)
    calls.clear()
    rm.Process()
    rm.ClearTemporaryCallbacks()
    rm.Process()
    out.append(list(calls))
    if hasattr(rc, "post_sprite_callbacks"):
        rc.AddPostSpriteRenderCallBack(
            lambda dev, arg: calls.append("sprite"), temp=True)
        calls.clear()
        rm.Process()
        rm.PostProcess()
        rm.Process()
        out.append(list(calls))
    return out


def test_temporary_callbacks():
    """tests/test_api_surface.py:365-378 and the rest of the temporary
    family: a temporary pre-, post- and targeted pre-render callback fire
    in one frame and are gone after PostProcess; RemoveAllTemporaryCallbacks
    drops one before it fires; RemoveTemporaryCallback; a kept callback
    survives ClearTemporaryCallbacks; a temporary post-sprite callback
    fires once and PostProcess (CleanTemporaryCallbacks) drops it."""
    ref, got = _both(_temporary_script)
    assert got == ref
    assert got[0] == ["pre", "pre_arg", "post"]
    assert got[2] == ["kept", "late", "kept"]
    assert got[3] == ["kept", "sprite", "kept"]


def _contexts_script(P):
    ctx, rc, cam = _ctx(P)
    rm = ctx.GetRenderManager()
    out = [rm.GetFullscreenContext(),
           rm.GetRenderContextFromPoint((5, 5)) is rc,
           rm.GetRenderContextFromPoint((9999, 5))]
    i0 = rm.CreateObjectIndex()
    i1 = rm.CreateObjectIndex()
    rm.ReleaseObjectIndex(i0)
    out += [i0, i1, rm.CreateObjectIndex(), rm.CreateObjectIndex()]
    obj = _tri(P, ctx)[0]
    rm.RegisterLastFrameEntity(obj)
    out.append(sorted(rm._last_frame_entities) == [obj.id])
    rm.UnregisterLastFrameEntity(obj)
    out.append(sorted(rm._last_frame_entities))
    rc2 = rm.CreateRenderContext(16, 16)
    mask = rc2.mask
    out.append(rm.GetRenderContextMaskFree() & mask)
    rm.RemoveRenderContext(rc2)
    out += [rm.GetRenderContextCount(), ctx.GetObject(rc2.id) is rc2,
            rm.GetRenderContextMaskFree() & mask]
    free = rm.GetRenderContextMaskFree()
    rm.ReleaseRenderContextMaskFree(rc.mask)
    out.append(rm.GetRenderContextMaskFree() - free)
    return out


def test_contexts_and_object_indices():
    """tests/test_api_surface.py:224-257 and :379-386 (without the vertex
    buffers, which come with the immediate-mode draws):
    GetRenderContextFromPoint, the recycled object index, the last-frame
    entity registry, RemoveRenderContext keeping the object and freeing
    its mask bit, ReleaseRenderContextMaskFree."""
    ref, got = _both(_contexts_script)
    assert got == ref
    assert got[:3] == [None, True, None] and got[5] == got[3]


def _detach_script(P):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    rc.AddObject(obj)
    out = [obj.IsInRenderContext(rc)]
    rc.Render()
    out.append(_lit(rc))
    fb = rc.framebuffer().copy()
    ctx.GetRenderManager().DetachAllObjects()
    out.append(obj.IsInRenderContext(rc))
    rc.Render()
    out.append(_lit(rc))
    return out, fb


def test_detach_all_objects():
    """tests/test_api_surface.py:388-398: an explicit, empty membership
    after DetachAllObjects; the first frame against the reference."""
    (ref, fb_j), (got, fb_t) = _both(_detach_script)
    assert got == ref
    assert got[0] is True and got[1] > 0 and got[2:] == [False, 0]
    np.testing.assert_allclose(fb_t, fb_j, atol=ATOL)


def _teardown_script(P):
    ctx, rc, cam = _ctx(P)
    obj = _tri(P, ctx)[0]
    rc.Render()
    fb0 = rc.framebuffer().copy()
    rm = ctx.GetRenderManager()
    rm.DestroyingDevice()
    out = [rc._compiled.topology_version]
    rc.Render()
    fb1 = rc.framebuffer().copy()
    v = ctx._topology_version
    rm.SequenceAddedToScene()
    rm.SequenceRemovedFromScene([obj.id])
    rm.SequenceToBeDeleted([obj.id])
    out += [ctx._topology_version - v, obj._to_be_deleted]
    rm.SequenceDeleted([obj.id])
    out += [ctx._topology_version - v, rm.GetValidFunctionsMask(),
            rm.OnCKPause()]
    n = rm.GetEffectCount()
    rm.RegisterDefaultEffects()
    out.append(rm.GetEffectCount() - n)
    rc.AddPreRenderCallBack(lambda dev, a: None, temp=True)
    rm.AddMovedEntity(obj)
    rm.PreClearAll()
    out += [rc.GetViewpoint(), rc.pre_render_callbacks,
            rm.GetMovedEntities()]
    return out, fb0, fb1


def test_device_teardown_and_notifications():
    """tests/test_api_surface.py:400-415: DestroyingDevice leaves every
    context to recompile and the next frame equals the first (bit for bit
    in the port, where it also frees the device state); the sequence
    notifications, GetValidFunctionsMask, OnCKPause,
    RegisterDefaultEffects; PreClearAll (tests/test_api_surface.py:253-254)
    detaches the viewpoint and drops temporaries and the moved set."""
    (ref, fb0_j, fb1_j), (got, fb0_t, fb1_t) = _both(_teardown_script)
    assert got == ref
    assert got[:4] == [-1, 2, True, 3] and got[4] == 0x7F
    np.testing.assert_allclose(fb0_t, fb0_j, atol=ATOL)
    np.testing.assert_allclose(fb1_t, fb1_j, atol=ATOL)
    assert np.array_equal(fb1_t, fb0_t)


# -- scene graph -------------------------------------------------------------

def _graph_script(P):
    ctx, rc, cam = _ctx(P)
    a = _tri(P, ctx, "a")[0]
    b = _tri(P, ctx, "b")[0]
    child = _tri(P, ctx, "child")[0]
    c2 = _tri(P, ctx, "c2")[0]
    b.SetRenderPriority(10)
    child.SetParent(a)
    c2.SetParent(a)
    c2.SetRenderPriority(3)
    child.SetPosition((10, 0, 0))
    rm = ctx.GetRenderManager()
    root = rm.GetRootNode()
    out = [root is rm.GetRootNode(), root.IsToBeParsed(),
           root.GetEntity(), root.GetPriority(),
           [root.GetChild(i).GetEntity().GetName()
            for i in range(root.GetChildrenCount())]]
    node = rm.CreateNode(a)
    out += [node.GetEntity() is a,
            [node.GetChild(i).GetEntity().GetName()
             for i in range(node.GetChildrenCount())]]
    node.SetPriority(5)
    node.SetRenderContextMask(3)
    out += [a.render_priority, node.GetPriority(),
            node.GetRenderContextMask(), node.IsToBeParsed(),
            rm.CreateNode(child).IsToBeParsed()]
    child.Show(False)
    out.append(rm.CreateNode(child).IsToBeParsed())
    out += [[v.tolist() for v in node.ComputeHierarchicalBox()],
            [v.tolist() for v in root.ComputeHierarchicalBox()],
            rm.CreateNode(None).GetRenderContextMask() == ~0]
    root.AddTransparentObject(a)
    root.SortNodes()
    out.append(rm.DeleteNode(node))
    return out


def test_scene_graph_facade():
    """tests/test_api_surface.py:418-464: the root's children high priority
    first, a node's children, priority and render-context mask written
    through to the entity, IsToBeParsed, the hierarchical boxes of a node
    and of the root: equal to the reference's."""
    ref, got = _both(_graph_script)
    assert got == ref
    assert got[4].index("b") < got[4].index("a") and "child" not in got[4]
    assert got[6] == ["c2", "child"]
    assert got[-3][1][0] >= 11.0 - 1e-4


# -- the rendered-scene facade and the device trace ------------------------------

def _scene_script(P, M):
    ctx, rc, cam = _ctx(P)
    _tri(P, ctx)
    light = P.CKLight(ctx, "sun")
    scene = M.CKRenderedScene(rc)
    scene.SetBackgroundColor((0.1, 0.2, 0.3, 1.0))
    scene.SetAmbientLight((0.2, 0.2, 0.2, 1.0))
    out = [np.asarray(scene.GetBackgroundColor()).tolist(),
           np.asarray(scene.GetAmbientLight()).tolist(),
           scene.GetFogMode(), scene.GetAttachedCamera() is cam,
           [l.GetName() for l in scene.GetLights()] == [light.GetName()],
           sorted(e.GetName() for e in scene.Get3dEntities()),
           scene.Draw()]
    return out, rc.framebuffer().copy()


def test_rendered_scene_facade():
    """CKRenderedScene's nine methods (reference manager.py:547-585): the
    state setters and getters, the lights, the 3D entities, and Draw, one
    Render() of the context, whose frame equals the reference's."""
    (ref, fb_j), (got, fb_t) = _scene_script(J, jm), _scene_script(O, tm)
    assert got == ref
    assert got[-1] is True and got[4] is True
    np.testing.assert_allclose(fb_t, fb_j, atol=ATOL)


def test_device_trace(tmp_path):
    """StartDeviceTrace / StopDeviceTrace (reference manager.py:512-526)
    wrap a ``torch.profiler`` session in the port: a second Start fails
    while one runs, Stop writes a Chrome trace into the directory holding
    the frame's operations, and Stop without a session is False."""
    ctx, rc, cam = _ctx(O)
    _tri(O, ctx)
    rm = ctx.GetRenderManager()
    assert rm.StopDeviceTrace() is False
    assert rm.StartDeviceTrace(str(tmp_path / "trace")) is True
    assert rm._trace_session.Start() is False
    rc.Render()
    assert rm.StopDeviceTrace() is True
    assert rm.StopDeviceTrace() is False
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
