"""Scene IO in the port against the reference package, on the CPU.

- ``_rich_scene`` builds one or more objects of every class the
  serializer registers (texture, material, mesh, patch mesh, 3D entity and
  object with a skin, camera and target camera, light and target light,
  2D entity, sprite, sprite text, 3D sprite, places with a portal, grid,
  curve and curve points, object and keyed animations with every
  controller kind and a morph, character and body parts), the same
  script through both packages. Per registry class: the port's chunk bytes
  equal the reference's; after ``SaveScene`` and ``LoadScene`` into a
  fresh context the port's objects save the same chunks again (ids mapped
  to the loaded objects'), as the reference's do.
- The scene files of both packages are byte-equal (object ids agree: both
  packages create the same objects in the same order); a reference file
  loads in the port and a port file in the reference, and each saves what
  its own package's reload saves.
- Render after reload (the reference's tests/test_serialization.py:120
  scene at 64x64, the flat route): the port's reloaded frame bit-equal to
  its own first frame and within ``ATOL`` of the reference's reloaded one;
  ``scenes.build_config5_io`` cut to 96x64 reloads bit-equal, and its file
  equals the reference's file of the same level.
- ``CopyObject`` (default and full dependencies), ``RemapDependencies``,
  mesh and patch-mesh ``LoadVertices``: the same chunks and arrays as the
  reference's.
- ``DumpToFile`` in every ``what`` mode, with the same buffers in both
  contexts: each PNG decoded by Pillow holds the reference's pixels
  exactly.
"""

import os
import struct

import numpy as np
import pytest
import torch

import ckrenderengine_tpu.anim as JA
import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.io import serialize as jser
from ckrenderengine_tpu.utils import progressive as jpm
import ckrenderengine_tpu_torch.anim as TA
import ckrenderengine_tpu_torch.objects as O
from ckrenderengine_tpu_torch import scenes
from ckrenderengine_tpu_torch.io import serialize as tser
from ckrenderengine_tpu_torch.io.statechunk import CKStateChunk
from ckrenderengine_tpu_torch.utils import progressive as tpm
from tests._torch_common import assert_frames_close, small_ctx

ANIM = {O: TA, J: JA}
SER = {O: tser, J: jser}


def _rich_scene(P):
    """A context of package ``P`` holding objects of every registered
    class, made from a numpy seed."""
    A = ANIM[P]
    rng = np.random.default_rng(21)
    ctx = small_ctx(P)
    tex = P.CKTexture(ctx, "checker")
    tex.SetImage(rng.uniform(0, 1, (8, 8, 4)).astype(np.float32))
    tex.SetImage(rng.uniform(0, 1, (4, 4, 3)).astype(np.float32), slot=1)
    tex.mipmap = False
    mat = P.CKMaterial(ctx, "mat")
    mat.SetDiffuse((0.9, 0.4, 0.2, 1.0))
    mat.SetSpecular((0.5, 0.5, 0.5, 1.0))
    mat.SetPower(12.0)
    mat.SetTexture(tex)
    mat.SetTwoSided(True)
    detail = P.CKMaterial(ctx, "detail")
    detail.SetTexture(tex, 1)
    mesh = P.CKMesh(ctx, "cube")
    s = 0.5
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32)
    faces = np.array([[0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6],
                      [0, 1, 5], [0, 5, 4], [2, 6, 7], [2, 7, 3],
                      [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5]], np.int32)
    mesh.SetPositions(verts)
    mesh.SetFaces(faces)
    mesh.SetUVs(rng.uniform(0, 1, (8, 2)).astype(np.float32))
    mesh.BuildNormals()
    mesh.ApplyGlobalMaterial(mat)
    mesh.SetVertexColor(3, (0.2, 0.4, 0.6, 1.0))
    mesh.SetLineCount(2)
    mesh.SetLine(0, 0, 1)
    mesh.SetLine(1, 2, 3)
    mesh.AddChannel(detail)
    scenes.make_patch_sheet(P, ctx, n=1, iterations=2)

    parent = P.CK3dEntity(ctx, "parent")
    child = P.CK3dObject(ctx, "child")
    child.SetParent(parent)
    child.SetCurrentMesh(mesh)
    child.SetPosition((0, 1, 0), ref=parent)
    child.SetRenderPriority(3)
    parent.Rotate((0, 1, 0), 0.5)
    hidden = P.CK3dObject(ctx, "hidden")
    hidden.SetCurrentMesh(mesh)
    hidden.Show(False)
    mat.SetEffectParameter(scale=0.5, texgen=2, ref_entity=child)

    bone0, bone1 = P.CK3dEntity(ctx, "bone0"), P.CK3dEntity(ctx, "bone1")
    bone1.SetPosition((0, 1, 0))
    skinned = P.CK3dObject(ctx, "skinned")
    skinned.SetCurrentMesh(mesh)
    skin = skinned.CreateSkin()
    skin.SetObjectInitMatrix(np.eye(4, dtype=np.float32))
    skin.SetBoneCount(2)
    for i, b in enumerate((bone0, bone1)):
        skin.bones[i].SetBone(b)
        skin.bones[i].SetBoneInitialInverseMatrix(
            np.linalg.inv(b.GetWorldMatrix()).astype(np.float32))
    skin.SetRestPose(verts, mesh.normals)
    for v in range(8):
        skin.SetVertexWeights(v, [0, 1], [0.25 + v / 16, 0.75 - v / 16])

    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0, 1, -4))
    cam.SetFov(0.9)
    cam.SetAspectRatio(4, 3)
    tcam = P.CKTargetCamera(ctx, "tcam")
    tcam.SetPosition((3, 2, -3))
    tcam.SetTarget(child)
    sun = P.CKLight(ctx, "sun")
    sun.SetType(1)
    sun.SetColor((1, 0.9, 0.8, 1))
    sun.SetSpecularFlag(True)
    spot = P.CKTargetLight(ctx, "spot")
    spot.SetType(2)
    spot.SetRange(40.0)
    spot.SetTarget(child)
    mat.SetEffectParameter(light=sun)

    hud = P.CK2dEntity(ctx, "hud")
    hud.SetRect((1, 2, 11, 22))
    hud.SetColor((0, 1, 0, 0.5))
    logo = P.CKSprite(ctx, "logo")
    logo.SetImage(rng.uniform(0, 1, (6, 5, 4)).astype(np.float32))
    logo.SetParent(hud)
    label = P.CKSpriteText(ctx, "label")
    label.SetText("score 12")
    board = P.CKSprite3D(ctx, "board")
    board.SetSize((2, 3))
    board.SetMaterial(mat)

    room, annex = P.CKPlace(ctx, "room"), P.CKPlace(ctx, "annex")
    door = P.CK3dEntity(ctx, "door")
    room.AddPortal(annex, door)
    room.ViewportClip((0, 0, 32, 32))
    room.SetDefaultCamera(cam)
    grid = P.CKGrid(ctx, "grid")
    grid.SetDimensions(4, 3, 2.0, 1.5)
    grid.AddLayer("nav").SetValue(1, 2, 9)
    curve = P.CKCurve(ctx, "path")
    for p in ((0, 0, 0), (1, 1, 1), (2, 0, 1)):
        curve.AddControlPoint(p)
    curve.GetControlPoint(1).SetTension(0.25)

    ch = A.CKCharacter(ctx, "bob")
    hips, arm = A.CKBodyPart(ctx, "hips"), A.CKBodyPart(ctx, "arm")
    ch.AddBodyPart(hips)
    ch.AddBodyPart(arm)
    clip = A.CKKeyedAnimation(ctx, "walk")
    oa = A.CKObjectAnimation(ctx, "armtrack")
    oa.Set3dEntity(arm)
    for kind, keys in ((A.CKANIMATION_LINEAR_POS, [(0, 0, 0), (0, 2, 0)]),
                       (A.CKANIMATION_TCB_ROT, [(0, 0, 0, 1),
                                                (0, 0.6, 0, 0.8)]),
                       (A.CKANIMATION_BEZIER_SCL, [(1, 1, 1), (2, 1, 1)]),
                       (A.CKANIMATION_LINEAR_SCLAXIS, [(0, 0, 0, 1),
                                                       (0, 0, 0, 1)])):
        c = oa.CreateController(kind)
        c.AddKey(0.0, keys[0])
        c.AddKey(10.0, keys[1])
    mc = oa.CreateMorphController(3)
    mc.AddKey(0.0, rng.standard_normal((3, 3)).astype(np.float32))
    mc.AddKey(4.0, rng.standard_normal((3, 3)).astype(np.float32))
    clip.AddAnimation(oa)
    ch.AddAnimation(clip)
    return ctx


def _records(path):
    """(class id, object id, name, chunk bytes) of each object of a file."""
    with open(path, "rb") as f:
        assert f.read(8) == b"CKSCENE1"
        (n,) = struct.unpack("<I", f.read(4))
        out = []
        for _ in range(n):
            cid, oid, nlen = struct.unpack("<iiI", f.read(12))
            name = f.read(nlen).decode("utf-8")
            (rawn,) = struct.unpack("<Q", f.read(8))
            out.append((cid, oid, name, f.read(rawn)))
    return out


def _reload(P, path):
    """``path`` loaded into a fresh context of ``P``: (context, loaded
    objects)."""
    ctx = small_ctx(P)
    return ctx, ctx.Load(path)


def _resaved(P, path):
    """Each record of ``path`` with its object's chunk as ``P`` saves it
    again after loading the file: {class id: [(saved chunk with ids
    mapped to the loaded objects', loaded object's chunk)]}."""
    recs = _records(path)
    _ctx, loaded = _reload(P, path)
    assert len(loaded) == len(recs)
    id_map = {r[1]: o.id for r, o in zip(recs, loaded)}
    out = {}
    for (cid, _oid, name, raw), obj in zip(recs, loaded):
        assert obj.CLASS_ID == cid and obj.GetName() == name
        want = CKStateChunk.from_bytes(raw)
        want.RemapObjectIDs(id_map)
        got = SER[P].save_object(obj).to_bytes()
        out.setdefault(cid, []).append((want.to_bytes(), got))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene_io")
    out = {}
    for P, tag in ((O, "port"), (J, "ref")):
        path = str(d / f"{tag}.ck")
        n = _rich_scene(P).Save(path)
        assert n == len(_records(path))
        out[tag] = path
    return out


@pytest.fixture(scope="module")
def resaved(files):
    return {tag: _resaved(P, files[tag]) for P, tag in ((O, "port"),
                                                        (J, "ref"))}


REGISTRY = sorted((cls.__name__, cid) for cid, (cls, *_r)
                  in tser.registry().items())


def test_registry_matches_the_reference():
    assert sorted(tser.registry()) == sorted(jser.registry())
    for cid, (cls, *_r) in tser.registry().items():
        assert jser.registry()[cid][0].__name__ == cls.__name__
    for name in ("ID_COMMON", "ID_ENTITY", "ID_MESH", "ID_PATCHMESH",
                 "ID_SKIN", "ID_CURVEPOINT"):
        assert getattr(tser, name) == getattr(jser, name)


@pytest.mark.parametrize("cls_name,cid", REGISTRY)
def test_class_round_trip(files, resaved, cls_name, cid):
    recs = {tag: [r for r in _records(files[tag]) if r[0] == cid]
            for tag in ("port", "ref")}
    assert recs["port"], f"the scene holds no {cls_name}"
    # The port writes the reference's chunk for every object of the class.
    assert [r[1:] for r in recs["port"]] == [r[1:] for r in recs["ref"]]
    # Saved again after a load: what the reference's reload saves.
    port, ref = resaved["port"][cid], resaved["ref"][cid]
    assert [g for _w, g in port] == [g for _w, g in ref]
    # And where the reference's round trip keeps the chunk, the port's does.
    for (w_t, g_t), (w_j, g_j) in zip(port, ref):
        assert (g_t == w_t) == (g_j == w_j)


def test_files_are_byte_equal_and_load_across(files, resaved):
    with open(files["port"], "rb") as f, open(files["ref"], "rb") as g:
        assert f.read() == g.read()
    # The reference's file in the port, the port's in the reference.
    for P, tag, other in ((O, "port", "ref"), (J, "ref", "port")):
        across = _resaved(P, files[other])
        assert {k: [g for _w, g in v] for k, v in across.items()} == \
            {k: [g for _w, g in v] for k, v in resaved[tag].items()}
    ctx, _loaded = _reload(O, files["ref"])
    ch = ctx.GetObjectByName("bob")
    assert ch.GetBodyPartCount() == 2
    clip = ch.GetAnimation(0)
    clip.SetFrame(5.0)
    np.testing.assert_allclose(ctx.GetObjectByName("arm").GetLocalMatrix()[
        3, :3], [0, 1, 0], atol=1e-5)
    assert ctx.GetObjectByName("room").GetClipRect() == (0, 0, 32, 32)
    assert ctx.GetObjectByName("grid").GetLayer("nav").GetValue(1, 2) == 9
    assert ctx.GetObjectByName("path").GetControlPointCount() == 3


def _cube_scene(P):
    """The reference's tests/test_serialization.py:60-93 scene and a 64x64
    render context looking at it."""
    ctx = small_ctx(P)
    tex = P.CKTexture(ctx, "checker")
    img = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    tex.SetImage(np.stack([img, img, img, np.ones_like(img)], -1))
    mat = P.CKMaterial(ctx, "mat")
    mat.SetDiffuse((0.9, 0.4, 0.2, 1.0))
    mat.SetTexture(tex)
    mesh = P.CKMesh(ctx, "cube")
    verts, faces = scenes._cube(0.5)
    mesh.SetPositions(verts)
    mesh.SetFaces(faces)
    mesh.SetUVs(np.zeros((8, 2), np.float32))
    mesh.BuildNormals()
    mesh.ApplyGlobalMaterial(mat)
    parent = P.CK3dObject(ctx, "parent")
    child = P.CK3dObject(ctx, "child")
    child.SetParent(parent)
    child.SetCurrentMesh(mesh)
    child.SetPosition((0, 1, 0), ref=parent)
    parent.Rotate((0, 1, 0), 0.5)
    cam = P.CKCamera(ctx, "cam")
    cam.SetPosition((0, 1, -4))
    light = P.CKLight(ctx, "sun")
    light.SetType(1)
    light.SetColor((1, 0.9, 0.8, 1))
    rc = ctx.GetRenderManager().CreateRenderContext(64, 64)
    rc.AttachViewpointToCamera(cam)
    return ctx, rc


def test_render_after_reload_matches_the_reference(tmp_path):
    reloaded = {}
    for P in (O, J):
        ctx, rc = _cube_scene(P)
        rc.Render()
        fb, zb = rc.framebuffer().copy(), rc.zbuffer().copy()
        kw = {"device": "cpu"} if P is O else {}
        _ctx2, rc2 = scenes.reload_level(
            P, ctx, rc, str(tmp_path / f"{P.__name__}.ck"), **kw)
        rc2.Render()
        if P is O:
            assert np.array_equal(rc2.framebuffer(), fb) and fb.sum() > 0
            assert np.array_equal(rc2.zbuffer(), zb)
        reloaded[P] = rc2
    assert_frames_close(reloaded[O], reloaded[J])


def test_config5_io_level_reloads_bit_equal(tmp_path, monkeypatch):
    """The scene-IO level cut to 96x64: its reloaded frame is the saved
    level's bit for bit, and its file is the reference's file of the same
    level. The reference builds it with the port's collapse order, which
    tests/test_torch_progressive.py holds equal to its own (that takes the
    reference minutes at the 12x18 sphere)."""
    monkeypatch.setattr(jpm, "compute_collapse_order",
                        tpm.compute_collapse_order)
    cut = dict(width=96, height=64, terrain_n=12, n_balls=4)
    ctx, rc, _s = scenes.build_config5_io(O, device="cpu", **cut)
    path = str(tmp_path / "port.ck")
    ctx.Save(path)                     # before a frame, as the reference's
    rc.Render()
    ctx2, rc2 = scenes.reload_level(O, ctx, rc, str(tmp_path / "level.ck"),
                                    device="cpu")
    rc2.Render()
    assert torch.equal(rc2.fb, rc.fb) and torch.equal(rc2.zb, rc.zb)
    sphere = ctx2.GetObjectByName("sphere")
    assert sphere.GetFaceCount() == ctx.GetObjectByName(
        "sphere").GetFaceCount() < 432
    # What the reference's round trip keeps, the port keeps: the sphere
    # comes back as a plain mesh of its LOD, the DDS checker without its
    # user mip levels (README, "Scene IO").
    assert not sphere.IsPM()
    assert not ctx2.GetObjectByName("checker").user_mip_levels
    ctx_j, rc_j, _s = scenes.build_config5_io(J, **cut)
    ref = str(tmp_path / "ref.ck")
    ctx_j.Save(ref)
    with open(path, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_copy_object_matches_the_reference():
    out = []
    for P in (O, J):
        ctx = _rich_scene(P)
        child = ctx.GetObjectByName("child")
        clone = ctx.CopyObject(child, suffix="_copy")
        assert clone is not child and clone.GetName() == "child_copy"
        assert clone.GetCurrentMesh() is child.GetCurrentMesh()
        assert clone.GetParent() is child.GetParent()
        full = ctx.CopyObject(ctx.GetObjectByName("skinned"),
                              P.FULL_COPY_DEPENDENCIES, suffix="_full")
        assert full.GetCurrentMesh() is not ctx.GetObjectByName(
            "skinned").GetCurrentMesh()
        with pytest.raises(ValueError, match="not copyable"):
            ctx.CopyObject(ctx.GetRenderManager())
        out.append([(o.id, o.GetName(), SER[P].save_object(o).to_bytes())
                    for o in ctx._objects.values()
                    if o.CLASS_ID in SER[P].registry()])
    assert out[0] == out[1]


def test_remap_dependencies_matches_the_reference():
    out = []
    for P in (O, J):
        ctx = _rich_scene(P)
        cube, mat = ctx.GetObjectByName("cube"), ctx.GetObjectByName("mat")
        other = P.CKMaterial(ctx, "other")
        child = ctx.GetObjectByName("child")
        assert child.RemapDependencies({cube.id: cube.id})
        assert cube.RemapDependencies({mat.id: other.id})
        assert cube.GetMaterial(0) is other
        room = ctx.GetObjectByName("room")
        assert room.RemapDependencies({ctx.GetObjectByName("cam").id: 0})
        assert not ctx.GetRenderManager().RemapDependencies({})
        out.append([SER[P].save_object(o).to_bytes()
                    for o in (child, cube, room)])
    assert out[0] == out[1]


def test_load_vertices_match_the_reference():
    rng = np.random.default_rng(3)
    out = []
    for P in (O, J):
        ctx = _rich_scene(P)
        cube = ctx.GetObjectByName("cube")
        src = P.CKMesh(ctx, "src")
        src.SetPositions(rng.standard_normal((8, 3)).astype(np.float32)
                         if P is O else out[0][0])
        src.SetFaces(cube.faces)
        src.SetUVs(cube.uvs * 2)
        src.BuildNormals()
        assert not cube.LoadVertices(CKStateChunk())
        assert cube.LoadVertices(SER[P].save_object(src))
        sheet = ctx.GetObjectByName("patchsheet")
        donor = scenes.make_patch_sheet(P, ctx, n=2, iterations=3)
        donor.SetVerts(donor.verts + 0.5)
        assert sheet.LoadVertices(SER[P].save_object(donor))
        sheet.BuildRenderMesh()
        out.append((src.positions, cube.positions, cube.normals, cube.uvs,
                    sheet.verts, sheet.vecs, sheet.iteration_count,
                    sheet.positions))
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("what", ["color", "z", "stencil", "both"])
def test_dump_to_file_matches_the_reference(what, tmp_path):
    import jax.numpy as jnp
    from PIL import Image

    rng = np.random.default_rng(len(what))
    h, w = 12, 17
    fb = rng.uniform(-0.1, 1.1, (4, h, w)).astype(np.float32)
    zb = rng.uniform(-0.1, 1.1, (h, w)).astype(np.float32)
    sb = (rng.random((h, w)) < 0.4).astype(np.uint8)
    files = {}
    for P in (O, J):
        ctx = small_ctx(P)
        rc = ctx.GetRenderManager().CreateRenderContext(w, h)
        if P is O:
            rc.fb, rc.zb, rc.sb = (torch.from_numpy(fb), torch.from_numpy(zb),
                                   torch.from_numpy(sb))
        else:
            rc.fb, rc.zb, rc.sb = jnp.asarray(fb), jnp.asarray(zb), \
                jnp.asarray(sb)
        d = tmp_path / P.__name__
        d.mkdir()
        assert rc.DumpToFile(str(d / "frame.png"), what)
        files[P] = sorted(os.listdir(d))
        for name in files[P]:
            with Image.open(d / name) as im:
                files[P, name] = (im.mode, np.asarray(im))
    assert files[O] == files[J] and len(files[O]) == (3 if what == "both"
                                                      else 1)
    for name in files[O]:
        mode, px = files[O, name]
        assert mode == files[J, name][0] == ("RGBA" if "color" in name
                                             or what == "color" else "L")
        np.testing.assert_array_equal(px, files[J, name][1])
