"""The port's host geometry tools (``ckrenderengine_tpu_torch.utils``)
against the reference package's, exactly: ``RadixSorter``, ``MeshAdjacency``,
``MeshStriper``, ``NvStripifier``, ``VertexCache``,
``VertexCacheOptimizer``, ``NearestPointGrid`` and ``PlaceFitter``.

Each case runs on the native path (both packages load
``native/libckcore.so``, built from ``native/ckcore.cpp``) and on the numpy
path (each package's ``native.load`` made to return None). The two paths
are meant to agree with each other too, except where the reference's own
do not: the native radix sort orders -0.0 before +0.0 (it sorts the
float's bits), ``np.argsort`` keeps them in index order. Meshes are cut
from ``scenes.make_terrain`` and ``scenes.make_sphere``.
"""

import numpy as np
import pytest

import ckrenderengine_tpu.utils as JU
import ckrenderengine_tpu_torch.utils as TU
from ckrenderengine_tpu.utils import native as jnative
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.utils import native as tnative

RNG = np.random.default_rng(23)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Both packages on one path: the native library, or numpy."""
    if request.param == "native":
        assert jnative.load() is not None and tnative.load() is not None
    else:
        monkeypatch.setattr(jnative, "load", lambda: None)
        monkeypatch.setattr(tnative, "load", lambda: None)
    return request.param


def _terrain(n, x0=0.0):
    verts, _uv, faces = scenes.make_terrain(n, 10.0, 1.5)
    return verts + np.array([x0, 0.0, 0.0], np.float32), faces


def _sphere():
    verts, _uv, faces = scenes.make_sphere(6, 9, 2.0)
    return verts, faces


def _values(kind):
    if kind == "u32":
        return RNG.integers(0, 2**32, 3000, dtype=np.uint64).astype(
            np.uint32)
    if kind == "u32_ties":
        return RNG.integers(0, 40, 3000).astype(np.uint32)
    if kind == "f32":
        v = RNG.normal(0.0, 100.0, 3000).astype(np.float32)
        v[::7] = np.round(v[::7] / 50.0) * 50.0       # ties
        v[::11] = 0.0
        v[5::11] = -0.0
        v[::13] = -v[::13]
        v[3] = np.float32(np.inf)
        v[4] = np.float32(-np.inf)
        return v
    if kind == "i64":
        return RNG.integers(-1000, 1000, 3000)
    return np.zeros(0, np.float32)


@pytest.mark.parametrize("kind", ["u32", "u32_ties", "f32", "i64", "empty"])
def test_radix_sorter(path, kind):
    """The order the reference's RadixSorter returns, on both paths; an
    order of the values, stable on ties (on the numpy path and for other
    dtypes it is ``np.argsort(kind="stable")``)."""
    v = _values(kind)
    got = TU.RadixSorter().Sort(v).GetIndices()
    want = JU.RadixSorter().Sort(v).GetIndices()
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    if v.size:
        s = v[got]
        assert (s[1:] >= s[:-1]).all()
    if path == "numpy" or kind in ("i64", "u32", "u32_ties"):
        assert np.array_equal(got, np.argsort(v, kind="stable"))


@pytest.mark.parametrize("mesh", ["terrain", "sphere"])
def test_adjacency_and_striper(path, mesh):
    """MeshAdjacency's table and queries, MeshStriper's strips and
    ConnectAll, VertexCache and the cache optimizer, equal to the
    reference's."""
    verts, faces = _terrain(7) if mesh == "terrain" else _sphere()
    ta, ja = TU.MeshAdjacency(faces), JU.MeshAdjacency(faces)
    assert np.array_equal(ta.GetAdjacency(), ja.GetAdjacency())
    assert ta.BoundaryEdgeCount() == ja.BoundaryEdgeCount()
    assert [ta.IsBoundary(f, e) for f in range(9) for e in range(3)] == \
        [ja.IsBoundary(f, e) for f in range(9) for e in range(3)]
    ts, js = TU.MeshStriper(), JU.MeshStriper()
    ts.Compute(faces)
    js.Compute(faces)
    assert ts.GetStripCount() == js.GetStripCount() > 0
    for i in range(ts.GetStripCount()):
        assert np.array_equal(ts.GetStrip(i), js.GetStrip(i))
    joined = ts.ConnectAll()
    assert np.array_equal(joined, js.ConnectAll())
    tris = TU.strip_to_triangles(joined)
    assert np.array_equal(tris, JU.strip_to_triangles(joined))
    assert tris.shape[0] == faces.shape[0]
    order = TU.VertexCacheOptimizer(12).Optimize(faces, len(verts))
    assert np.array_equal(order, JU.VertexCacheOptimizer(12).Optimize(
        faces, len(verts)))
    assert TU.VertexCache.MissCount(faces[order], 12) == \
        JU.VertexCache.MissCount(faces[order], 12)
    cache = TU.VertexCache(4)
    assert [cache.AddEntry(v) for v in (1, 2, 1, 3, 4, 5, 1)] == \
        [True, True, False, True, True, True, True]
    cache.Clear()
    assert not cache.InCache(1)


@pytest.mark.parametrize("mesh,experiments,max_len", [
    ("terrain", 1, 0), ("terrain", 10, 0), ("terrain", 10, 8),
    ("sphere", 4, 0), ("sphere", 10, 5)])
def test_nvstripifier(path, mesh, experiments, max_len):
    """NvStripifier's strips (samples per round, MaxStripLength splits)
    and CreateStrips equal to the reference's; the strips cover every
    face once."""
    _verts, faces = _terrain(8) if mesh == "terrain" else _sphere()
    t = TU.NvStripifier(max_strip_length=max_len, experiments=experiments)
    j = JU.NvStripifier(max_strip_length=max_len, experiments=experiments)
    got, want = t.Stripify(faces), j.Stripify(faces)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == np.uint32 and np.array_equal(a, b)
    if max_len:
        assert max(len(s) for s in got) <= max_len
    else:
        n = sum(len(TU.strip_to_triangles(s)) for s in got)
        assert n == faces.shape[0]
    assert np.array_equal(t.CreateStrips(faces), j.CreateStrips(faces))


def test_nvstripify_paths_agree(monkeypatch):
    """The numpy ``_nvstripify`` is byte-identical to the native one."""
    _verts, faces = _terrain(8)
    native = TU.geometry._nvstripify(faces, 6)
    monkeypatch.setattr(tnative, "load", lambda: None)
    fallback = TU.geometry._nvstripify(faces, 6)
    assert len(native) == len(fallback)
    for a, b in zip(native, fallback):
        assert np.array_equal(a, b)


def test_nearest_point_grid(path):
    """GetNearestPoint at seeded queries and thresholds, and on an empty
    grid, equal to the reference's."""
    pts = RNG.uniform(-5.0, 5.0, (400, 3)).astype(np.float32)
    queries = np.concatenate([pts[::17] + RNG.normal(0, 0.05, (24, 3)),
                              RNG.uniform(-6.0, 6.0, (40, 3))]).astype(
        np.float32)
    for cell in (0.5, 2.0):
        tg, jg = TU.NearestPointGrid(pts, cell), JU.NearestPointGrid(pts, cell)
        for thr in (0.02, 0.1, 0.6):
            got = [tg.GetNearestPoint(q, thr) for q in queries]
            assert got == [jg.GetNearestPoint(q, thr) for q in queries]
        assert any(g is not None for g in got)
    assert TU.NearestPointGrid(np.zeros((0, 3))).GetNearestPoint(
        (0, 0, 0), 1.0) is None


def test_place_fitter(path):
    """The best-fit box between two adjacent pieces of one terrain (their
    shared column of vertices), and None where the pieces do not touch,
    equal to the reference's."""
    verts, _faces = _terrain(12)
    a, b = verts[verts[:, 0] <= 0.0], verts[verts[:, 0] >= 0.0]
    far = b + np.array([0.5, 0.0, 0.0], np.float32)
    got = TU.PlaceFitter.ComputeBestFitBBox(a, b)
    want = JU.PlaceFitter.ComputeBestFitBBox(a, b)
    assert got is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert abs(float(got[0][0])) < 1e-6 and got[2][0] > 9.0
    assert TU.PlaceFitter.ComputeBestFitBBox(a, far) is None
    assert JU.PlaceFitter.ComputeBestFitBBox(a, far) is None
