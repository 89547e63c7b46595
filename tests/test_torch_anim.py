"""Animation modules of the port against the reference package on the CPU:
the quaternion and PRS functions, the host controllers of every kind, the
batched device track evaluation (``evaluate_bank_prs``, ``apply_bank``,
``apply_bank_blended``), a character's pose mid-warp and a clip's host
``SetFrame`` (the vectorized ``host_bank`` path and the per-member one).

The same scene is built through each package's object model from one numpy
seed. Poses and local matrices must match within 1e-5*(1 + |x|) per element
(the reference's XLA programs may contract multiply-adds, and its slerps,
arccos and normalizations round differently by a few ULP); the host paths,
which are the same numpy code in both packages, must match exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ckrenderengine_tpu.anim as JA
import ckrenderengine_tpu.objects as J
from ckrenderengine_tpu.anim import bank as jbank
from ckrenderengine_tpu.anim import keyframe as jkf
from ckrenderengine_tpu.math import vxmath as jvx
import ckrenderengine_tpu_torch.anim as TA
import ckrenderengine_tpu_torch.objects as T
from ckrenderengine_tpu_torch import convert
from ckrenderengine_tpu_torch.anim import bank as tbank
from ckrenderengine_tpu_torch.anim import keyframe as tkf
from ckrenderengine_tpu_torch.math import vxmath as tvx
from tests._torch_common import to_np

# Times before the first key, on keys, between keys and past the last key.
TIMES = (-3.0, 0.0, 1.25, 2.71, 5.5, 9.99, 10.0, 40.0)


def assert_close(got, ref, tol=1e-5):
    """Per element: |got - ref| <= tol * (1 + |ref|)."""
    got = np.asarray(to_np(got), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= tol, float(err.max())


def _quat(rng):
    q = rng.normal(size=4).astype(np.float32)
    return q / np.linalg.norm(q)


def _keys(rng, n):
    """n sorted key times in [0, 10] (the first at 0, the last at 10)."""
    mid = np.sort(rng.uniform(0.5, 9.5, max(n - 2, 0)))
    return [0.0, *mid.tolist(), 10.0][:n] if n > 1 else [4.0]


def _local(rng):
    ang = rng.uniform(-np.pi, np.pi)
    m = tvx.np_rotation_axis_angle(rng.normal(size=3), ang)
    m[:3, :3] *= rng.uniform(0.5, 2.0, 3)[:, None].astype(np.float32)
    m[3, :3] = rng.normal(0, 3, 3)
    return m


def _add(ctrl, rng, times, kind):
    """Keys of one controller: TCB keys get tension/continuity/bias and
    ease; quaternion tracks alternate sign so slerp must flip."""
    for i, t in enumerate(times):
        tcb = tuple(rng.uniform(-0.5, 0.5, 3)) if kind == "tcb" else (
            0.0, 0.0, 0.0)
        ease = (tuple(rng.uniform(0.0, 0.7, 2)) if kind == "tcb"
                else (0.0, 0.0))
        if ctrl.DIM == 4:
            v = _quat(rng) * (-1.0 if i % 2 else 1.0)
        else:
            v = rng.normal(0, 2, 3).astype(np.float32)
            if ctrl is not None and "Scale" in type(ctrl).__name__:
                v = np.abs(v) + 0.3
        ctrl.AddKey(float(t), v, tcb=tcb, ease=ease)


# (position, rotation, scale) controller kinds and key counts per entity;
# None = no track (the base PRS of the entity's local fills in).
PLAN = [
    (("LINEAR_POS", 3), ("LINEAR_ROT", 4), ("LINEAR_SCL", 3)),
    (("TCB_POS", 5), ("TCB_ROT", 5), ("TCB_SCL", 4)),
    (("BEZIER_POS", 4), None, ("BEZIER_SCL", 3)),
    (("LINEAR_POS", 2), None, None),
    (("TCB_POS", 1), ("TCB_ROT", 1), ("LINEAR_SCL", 1)),
    (None, None, None),
    (None, ("TCB_ROT", 2), None),
    (("BEZIER_POS", 6), ("LINEAR_ROT", 6), ("TCB_SCL", 6)),
]


def build(O, A, seed=0, **ctx_kw):
    """N entities with random locals, one object animation each (PLAN),
    all in one keyed clip. Returns (ctx, entities, clip)."""
    rng = np.random.default_rng(seed)
    ctx = O.CKContext(**ctx_kw)
    ents, clip = [], A.CKKeyedAnimation(ctx, "clip")
    for i, plan in enumerate(PLAN):
        e = O.CK3dObject(ctx, f"e{i}")
        e.SetLocalMatrix(_local(rng))
        ents.append(e)
        oa = A.CKObjectAnimation(ctx, f"oa{i}")
        oa.Set3dEntity(e)
        for spec in plan:
            if spec is None:
                continue
            kind, n = spec
            ctrl = oa.CreateController(getattr(A, "CKANIMATION_" + kind))
            _add(ctrl, rng, _keys(rng, n), kind.split("_")[0].lower())
        if i == 2:
            # Explicit Bezier control points on one key.
            oa.position_controller.SetControlPoints(
                1, rng.normal(size=3), rng.normal(size=3))
        clip.AddAnimation(oa)
    return ctx, ents, clip


@pytest.fixture(scope="module")
def pair():
    return (build(J, JA, seed=0), build(T, TA, seed=0, device="cpu"))


def test_quaternion_functions_match_reference():
    rng = np.random.default_rng(3)
    a = np.stack([_quat(rng) for _ in range(32)])
    b = np.stack([_quat(rng) for _ in range(32)])
    b[:4] = a[:4]                                 # parallel: lerp branch
    b[4:8] = -a[4:8] + 1e-4                       # antipodal
    c = np.stack([_quat(rng) for _ in range(32)])
    d = np.stack([_quat(rng) for _ in range(32)])
    u = rng.uniform(0, 1, (32, 1)).astype(np.float32)
    ta, tb, tc, td, tu = (torch.as_tensor(x) for x in (a, b, c, d, u))
    ja, jb, jc, jd, ju = (jnp.asarray(x) for x in (a, b, c, d, u))
    assert_close(tvx.quat_multiply(ta, tb), jvx.quat_multiply(ja, jb))
    assert_close(tvx.quat_to_matrix(ta), jvx.quat_to_matrix(ja))
    assert_close(tvx.quat_slerp(ta, tb, tu), jvx.quat_slerp(ja, jb, ju))
    assert_close(tvx.quat_slerp_noflip(ta, tb, tu),
                 jvx.quat_slerp_noflip(ja, jb, ju))
    assert_close(tvx.quat_log(ta), jvx.quat_log(ja))
    assert_close(tvx.quat_exp(ta[:, :3]), jvx.quat_exp(ja[:, :3]))
    assert_close(tvx.quat_squad(ta, tc, td, tb, tu),
                 jvx.quat_squad(ja, jc, jd, jb, ju))
    assert_close(tvx.quat_normalize(ta * 3.0), jvx.quat_normalize(ja * 3.0))
    mats = np.stack([_local(rng) for _ in range(32)])
    mats[0] = np.diag([-1.0, 1.0, 1.0, 1.0])      # each pivot branch
    mats[1] = np.diag([1.0, -1.0, -1.0, 1.0])
    mats[2] = np.diag([-1.0, 1.0, -1.0, 1.0])
    mats[3] = np.diag([-1.0, -1.0, 1.0, 1.0])
    tm, jm = torch.as_tensor(mats), jnp.asarray(mats)
    assert_close(tvx.quat_from_matrix(tm), jvx.quat_from_matrix(jm))
    for got, ref in zip(tvx.decompose_prs(tm), jvx.decompose_prs(jm)):
        assert_close(got, ref)
    p, r, s = (rng.normal(size=(32, k)).astype(np.float32) for k in (3, 4, 3))
    assert_close(tvx.compose_prs(*map(torch.as_tensor, (p, r, s))),
                 jvx.compose_prs(*map(jnp.asarray, (p, r, s))))


def test_numpy_quaternion_twins_match_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        a, b, c, d = (_quat(rng) for _ in range(4))
        t = float(rng.uniform())
        for name, args in (("np_quat_slerp", (a, b, t)),
                           ("np_quat_mul", (a, b)), ("np_quat_conj", (a,)),
                           ("np_quat_log", (a,)), ("np_quat_exp", (a[:3],)),
                           ("np_quat_slerp_noflip", (a, b, t)),
                           ("np_quat_squad", (a, c, d, b, t))):
            np.testing.assert_array_equal(getattr(tvx, name)(*args),
                                          getattr(jvx, name)(*args))


@pytest.mark.parametrize("t", TIMES)
def test_host_controllers_match_reference(pair, t):
    """Every controller's host Evaluate (the same numpy code): exact."""
    (_cj, _ej, clip_j), (_ct, _et, clip_t) = pair
    for oj, ot in zip(clip_j.animations, clip_t.animations):
        for name in ("position_controller", "rotation_controller",
                     "scale_controller"):
            cj, ct = getattr(oj, name), getattr(ot, name)
            if cj is None:
                assert ct is None
                continue
            np.testing.assert_array_equal(ct.Evaluate(t), cj.Evaluate(t))


def test_scale_axis_and_morph_controllers_match_reference():
    rng = np.random.default_rng(5)
    cj, ct = JA.TCBScaleAxisController(), TA.TCBScaleAxisController()
    for t in _keys(rng, 4):
        q, tcb = _quat(rng), tuple(rng.uniform(-0.4, 0.4, 3))
        cj.AddKey(t, q, tcb=tcb, ease=(0.2, 0.1))
        ct.AddKey(t, q, tcb=tcb, ease=(0.2, 0.1))
    for t in TIMES:
        np.testing.assert_array_equal(ct.Evaluate(t), cj.Evaluate(t))
    keys = rng.normal(size=(3, 10, 3)).astype(np.float32)
    nrm = rng.normal(size=(3, 10, 3)).astype(np.float32)
    mj, mt = JA.MorphController(10), TA.MorphController(10)
    for i, t in enumerate((0.0, 4.0, 10.0)):
        mj.AddKey(t, keys[i], nrm[i])
        mt.AddKey(t, keys[i], nrm[i])
    for t in TIMES:
        for g, r in zip(mt.Evaluate(t), mj.Evaluate(t)):
            np.testing.assert_array_equal(g, r)
        vt, nt = tkf.eval_morph(torch.as_tensor(mj.times),
                                torch.as_tensor(keys), torch.as_tensor(nrm),
                                3, t)
        vj, nj = jkf.eval_morph(jnp.asarray(mj.times), jnp.asarray(keys),
                                jnp.asarray(nrm), 3, t)
        assert_close(vt, vj)
        assert_close(nt, nj)


def test_bank_build_matches_reference(pair):
    """The padded bank rows are the same host arrays; the base PRS comes
    from the batched torch decomposition."""
    (ctx_j, _ej, clip_j), (ctx_t, _et, clip_t) = pair
    n = ctx_j.entity_table.count
    bj = clip_j.bank(n_entities=n)
    bt = clip_t.bank(n_entities=n, device="cpu")
    assert bt is clip_t.bank(n_entities=n, device="cpu")      # cached
    for f in tbank.AnimBank._fields:
        if f.startswith("base_"):
            assert_close(getattr(bt, f), np.asarray(getattr(bj, f)))
        else:
            np.testing.assert_array_equal(to_np(getattr(bt, f)),
                                          np.asarray(getattr(bj, f)), f)


@pytest.mark.parametrize("t", TIMES)
def test_evaluate_bank_prs_matches_reference(pair, t):
    """Every lane at every kind of time, from the reference's own bank
    (converted) and from the port's."""
    (ctx_j, _ej, clip_j), (_ct, _et, clip_t) = pair
    n = ctx_j.entity_table.count
    bj = clip_j.bank(n_entities=n)
    ref = jbank.evaluate_bank_prs(bj, t)
    for bt in (convert.anim_bank_from_reference(bj, "cpu"),
               clip_t.bank(n_entities=n, device="cpu")):
        got = tbank.evaluate_bank_prs(bt, t)
        for g, r in zip(got, ref):
            assert_close(g, np.asarray(r))
    # A 0-d tensor time takes the same branch as a float.
    got = tbank.evaluate_bank_prs(bt, torch.tensor(t, dtype=torch.float32))
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r))


def test_guarded_lanes_stay_finite():
    """Zero key intervals, single keys and missing tracks: every lane of
    every mode is finite, so a selected value never sees a NaN."""
    a, k = 3, 4
    times = torch.tensor([[0.0, 0.0, 0.0, 3e38], [2.0, 3e38, 3e38, 3e38],
                          [3e38] * 4])
    vals = torch.ones(a, k, 3)
    n = torch.tensor([3, 1, 0], dtype=torch.int32)
    ease = torch.zeros(a, k, 2)
    for mode in (0, 1, 2):
        out = tkf.eval_vector_track(times, vals, vals, vals,
                                    torch.full((a,), mode), ease, n, 0.0)
        assert torch.isfinite(out).all()
    q = torch.zeros(a, k, 4)
    q[..., 3] = 1.0
    out = tkf.eval_quat_track(times, q, q, q, torch.tensor([0, 1, 1]), ease,
                              n, 5.0)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("scatter", [False, True], ids=["inv_row", "scatter"])
def test_apply_bank_matches_reference(pair, scatter):
    (ctx_j, _ej, clip_j), (_ct, _et, clip_t) = pair
    n = ctx_j.entity_table.count
    local = ctx_j.entity_table.local[:n].copy()
    ne = None if scatter else n
    bj = clip_j.bank(n_entities=ne)
    bt = clip_t.bank(n_entities=ne, device="cpu")
    for t in (0.0, 3.3, 12.0):
        assert_close(tbank.apply_bank(torch.as_tensor(local), bt, t),
                     np.asarray(jbank.apply_bank(jnp.asarray(local), bj, t)))
    # Blend of the clip at two times (a transition warp's two banks).
    got = tbank.apply_bank_blended(torch.as_tensor(local), bt, 2.0, bt, 7.5,
                                   0.35)
    ref = jbank.apply_bank_blended(jnp.asarray(local), bj, 2.0, bj, 7.5,
                                   0.35)
    assert_close(got, np.asarray(ref))


def _character(O, A, **ctx_kw):
    """A character of 4 body parts in a chain, two 2-member clips."""
    rng = np.random.default_rng(9)
    ctx = O.CKContext(**ctx_kw)
    ch = A.CKCharacter(ctx, "ch")
    parts = []
    for i in range(4):
        p = A.CKBodyPart(ctx, f"part{i}")
        if parts:
            p.SetParent(parts[-1])
        p.SetLocalMatrix(_local(rng))
        ch.AddBodyPart(p)
        parts.append(p)
    clips = []
    for c in range(2):
        clip = A.CKKeyedAnimation(ctx, f"clip{c}")
        for i, p in enumerate(parts[:2]):
            oa = A.CKObjectAnimation(ctx, f"oa{c}{i}")
            oa.Set3dEntity(p)
            for kind in ("LINEAR_POS", "LINEAR_ROT"):
                ctrl = oa.CreateController(getattr(A, "CKANIMATION_" + kind))
                _add(ctrl, rng, _keys(rng, 3), "linear")
            clip.AddAnimation(oa)
        ch.AddAnimation(clip)
        clips.append(clip)
    ch.SetActiveAnimation(clips[0])
    for _ in range(3):
        ch.ProcessAnimation(1.5)
    ch.SetNextActiveAnimation(clips[1], A.CKAnimation.TRANSITION_BREAK,
                              warp_length=10.0)
    ch.ProcessAnimation(3.0)
    return ctx, ch


def test_character_pose_mid_warp_matches_reference():
    ctx_j, ch_j = _character(J, JA)
    ctx_t, ch_t = _character(T, TA, device="cpu")
    assert ch_j._warping and ch_t._warping
    assert ch_t._warp_frame == ch_j._warp_frame == 3.0
    n = ctx_j.entity_table.count
    np.testing.assert_array_equal(ctx_t.entity_table.local[:n],
                                  ctx_j.entity_table.local[:n])
    local = ctx_j.entity_table.local[:n].copy()
    got = ch_t.apply_pose_device(torch.as_tensor(local))
    ref = ch_j.apply_pose_device(jnp.asarray(local))
    assert_close(got, np.asarray(ref))
    # Out of the warp: one bank at the active clip's frame.
    for ch in (ch_j, ch_t):
        ch.ProcessAnimation(8.0)
    assert not ch_t._warping and not ch_j._warping
    assert_close(ch_t.apply_pose_device(torch.as_tensor(local)),
                 np.asarray(ch_j.apply_pose_device(jnp.asarray(local))))


@pytest.mark.parametrize("simple", [True, False], ids=["host_bank", "members"])
def test_host_set_frame_matches_reference(simple):
    """Unbound SetFrame: linear members take the vectorized host bank,
    TCB and eased ones the per-member SetStep; both equal the
    reference's bit for bit."""
    def scene(O, A, **ctx_kw):
        rng = np.random.default_rng(11)
        ctx = O.CKContext(**ctx_kw)
        clip = A.CKKeyedAnimation(ctx, "clip")
        for i in range(5):
            e = O.CK3dObject(ctx, f"e{i}")
            e.SetLocalMatrix(_local(rng))
            oa = A.CKObjectAnimation(ctx, f"oa{i}")
            oa.Set3dEntity(e)
            kinds = (("LINEAR_POS", "LINEAR_ROT") if simple
                     else ("TCB_POS", "TCB_ROT", "BEZIER_SCL"))
            for kind in kinds[:1 + i % len(kinds)]:
                ctrl = oa.CreateController(getattr(A, "CKANIMATION_" + kind))
                _add(ctrl, rng, _keys(rng, 4),
                     "tcb" if kind.startswith("TCB") else "linear")
            clip.AddAnimation(oa)
        return ctx, clip

    ctx_j, clip_j = scene(J, JA)
    ctx_t, clip_t = scene(T, TA, device="cpu")
    n = ctx_j.entity_table.count
    for t in TIMES:
        clip_j.SetFrame(t)
        clip_t.SetFrame(t)
        np.testing.assert_array_equal(ctx_t.entity_table.local[:n],
                                      ctx_j.entity_table.local[:n])
    assert (clip_t._host_bank[1] is not None) == simple
