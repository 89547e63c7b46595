"""The object API's surface against the reference package's classes.

Every public method of the reference's ``CKRenderContext``,
``CKRenderManager`` and ``CKRenderedScene`` (names taken from the classes
with ``inspect``, inherited ones included) exists in the port, none of
them unported: ``DumpToFile``, the last, writes its PNG. A method that
carried an ``unported_item`` would have to raise ``NotImplementedError``
naming its port queue item, whatever its arguments, never
``AttributeError``.
"""

import inspect
import re

import pytest

from ckrenderengine_tpu.objects import manager as jm
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch.objects import manager as tm
from ckrenderengine_tpu_torch.roadmap import PORT_QUEUE


def _public(cls) -> list[str]:
    return sorted(n for n, v in inspect.getmembers(cls)
                  if not n.startswith("_") and callable(v))


def _check_surface(ref_cls, obj) -> int:
    """Each public name of ``ref_cls`` exists on ``obj``; the unported
    ones raise their item. Returns how many are unported."""
    missing = [n for n in _public(ref_cls) if not hasattr(obj, n)]
    assert not missing, missing
    n_unported = 0
    for name in _public(ref_cls):
        item = getattr(getattr(type(obj), name, None), "unported_item", None)
        if item is None:
            continue
        assert item in PORT_QUEUE and item == 14, (name, item)
        with pytest.raises(NotImplementedError,
                           match=rf"{re.escape(name)}.*item {item}\b"):
            getattr(obj, name)()
        with pytest.raises(NotImplementedError):
            getattr(obj, name)(1, 2, x=3)
        n_unported += 1
    return n_unported


def _rc():
    ctx = O.CKContext(device="cpu")
    return ctx.GetRenderManager(), ctx.GetRenderManager().CreateRenderContext(
        16, 16)


def test_render_context_surface(tmp_path):
    rm, rc = _rc()
    assert _check_surface(jm.CKRenderContext, rc) == 0
    assert rc.GetRasterizerContext() is rc and rc.ChangeDriver(1)
    path = tmp_path / "frame.png"
    assert rc.DumpToFile(str(path))
    assert path.read_bytes().startswith(b"\x89PNG\r\n\x1a\n")


def test_render_manager_surface():
    rm, _rc_ = _rc()
    assert _check_surface(jm.CKRenderManager, rm) == 0
    assert rm.GetRenderDriverCount() == 2
    assert rm.GetPreferredSoftwareDriver() == 1


def test_rendered_scene_surface():
    _rm, rc = _rc()
    scene = tm.CKRenderedScene(rc)
    assert scene.rc is rc
    assert _check_surface(jm.CKRenderedScene, scene) == 0
