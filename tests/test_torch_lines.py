"""The line pass against the reference package on the CPU: the port's
``draw_lines`` (on a CPU tensor its plain version, ``draw_lines_plain``)
against the reference's ``pipeline/lines.draw_lines``, called as its frame
calls it (under ``jax.jit``) and op by op.

Inputs are seeded: a small instanced stream over three entities seen by a
perspective camera, banks of 5, 40 and 300 segments (one chunk, two, and
ten: the reference's unrolled and ``lax.scan`` branches), degenerate
segments (both endpoints on one vertex: the ``len2`` clamp), segments with
an endpoint behind the camera, pad rows, a band offset ``row0`` and a
frame at twice the size (an Antialias frame's render size).

Tolerance. rgb and alpha are equal on every pixel but those in the
rounding band, where a segment's coverage decision lies within the f32
forward error of its two tests. For each endpoint the exact projection is
computed in float64 with a first-order bound of the f32 error of the
vertex path (world transform, view-projection product and matrix, the
division by w, the viewport), summed over the operations; delta is twice
the larger bound of a segment's endpoints (each package may round to
either side). A pixel is in the band when, for a valid segment,
|dist - 0.7| <= 2 delta + 16 u (|pax| + |pay| + |dx| + |dy|) (u = 2^-24)
while its depth can pass, or when the depth along the segment lies within
the same kind of bound of zb + 1e-4, 0 or 1. The test asserts that the
band holds under 2% of the frame and prints its share.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ckrenderengine_tpu.pipeline import lines as jl
from ckrenderengine_tpu_torch.pipeline import lines as tl
from tests._torch_common import exact_rows, line_band

H, W = 72, 96
N_ENT, N_POS, N_IV = 3, 48, 160


class _Scene:
    """The stream fields and camera draw_lines reads, as plain arrays."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _perspective(fov, aspect, near, far):
    m = np.zeros((4, 4), np.float32)
    f = 1.0 / np.tan(fov * 0.5)
    m[0, 0] = f
    m[1, 1] = f * aspect
    m[2, 2] = far / (far - near)
    m[2, 3] = 1.0
    m[3, 2] = -near * far / (far - near)
    return m


def _inputs(seed, n_lines, h=H, w=W, vp_scale=1, pad=8):
    """Seeded (scene arrays, world (N,4,4), bank dict, fb, zb) at h x w."""
    rng = np.random.default_rng(seed)
    world = np.zeros((N_ENT, 4, 4), np.float32)
    for e in range(N_ENT):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        world[e, :3, :3] = q
        world[e, 3, :3] = rng.uniform(-1.5, 1.5, 3)
        world[e, 3, 3] = 1.0
    positions = rng.uniform(-3, 3, (N_POS, 3)).astype(np.float32)
    # A few pool rows far behind the camera (at z = -8): w < 0 there.
    positions[:4, 2] = -14.0
    src_idx = rng.integers(0, N_POS, N_IV).astype(np.int32)
    vert_entity = rng.integers(0, N_ENT + 1, N_IV).astype(np.int32)
    vert_entity[:8] = N_ENT             # the identity row
    src_idx[:8] = np.arange(4).repeat(2)
    view = np.eye(4, dtype=np.float32)
    view[3, 2] = 8.0                    # camera at z = -8 looking at +z
    view[3, 0] = 0.25
    proj = _perspective(1.1, w / h, 0.5, 40.0)
    viewport = np.array([0.0, 0.0, w, h], np.float32)
    if vp_scale != 1:
        viewport = np.array([3.0, 2.0, w - 6.0, h - 5.0], np.float32)
    scene = dict(src_idx=src_idx, vert_entity=vert_entity,
                 positions=positions, view=view, proj=proj,
                 viewport=viewport)
    lp = max(pad, -(-n_lines // pad) * pad)
    idx = np.zeros((lp, 2), np.int32)
    idx[:n_lines] = rng.integers(0, N_IV, (n_lines, 2))
    idx[:n_lines:7, 1] = idx[:n_lines:7, 0]          # degenerate
    idx[1:n_lines:11, 0] = rng.integers(0, 8, len(range(1, n_lines, 11)))
    color = np.ones((lp, 4), np.float32)
    color[:n_lines] = rng.uniform(0, 1, (n_lines, 4))
    valid = np.zeros(lp, bool)
    valid[:n_lines] = True
    valid[3:n_lines:13] = False
    bank = dict(idx=idx, color=color, valid=valid)
    fb = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    zb = (0.955 + 0.045 * np.sin(xx * 0.11) * np.cos(yy * 0.07)).astype(
        np.float32)
    return scene, world, bank, fb, zb


def _reference(scene, world, bank, fb, zb, h, w, row0, jit):
    def run(f, z, sc, wd, b):
        return jl.draw_lines(f, z, _Scene(**sc), wd, jl.LineBank(**b), h, w,
                             row0=row0)

    if jit:
        run = jax.jit(run)
    return np.asarray(run(jnp.asarray(fb), jnp.asarray(zb),
                          {k: jnp.asarray(v) for k, v in scene.items()},
                          jnp.asarray(world),
                          {k: jnp.asarray(v) for k, v in bank.items()}))


def _port(scene, world, bank, fb, zb, h, w, row0, chunk=tl.CHUNK):
    tscene = _Scene(**{k: torch.as_tensor(v) for k, v in scene.items()})
    tbank = tl.LineBank(**{k: torch.as_tensor(v) for k, v in bank.items()})
    return tl.draw_lines(torch.as_tensor(fb), torch.as_tensor(zb), tscene,
                         torch.as_tensor(world), tbank, h, w, chunk=chunk,
                         row0=row0).numpy()


CASES = [
    # (name, seed, lines, h, w, row0, viewport offset)
    ("bank5", 1, 5, H, W, 0.0, 1),
    ("bank40", 2, 40, H, W, 0.0, 1),
    ("bank300_scan", 3, 300, H, W, 0.0, 1),
    ("row0_offset", 4, 40, H, W, 8.0, 2),
    ("render_2x", 5, 120, 2 * H, 2 * W, 0.0, 2),
]


@pytest.mark.parametrize("name,seed,n,h,w,row0,vps", CASES,
                         ids=[c[0] for c in CASES])
def test_draw_lines_matches_reference(name, seed, n, h, w, row0, vps):
    scene, world, bank, fb, zb = _inputs(seed, n, h, w, vps)
    got = _port(scene, world, bank, fb, zb, h, w, row0)
    rows, delta, delta_z = exact_rows(scene, world, bank)
    assert rows[:, 6].sum() >= 0.5 * n, "most segments must be valid"
    band = line_band(rows, h, w, zb, zb, delta, delta_z, row0=row0)
    share = float(band.mean())
    print(f"{name}: band {share:.4%} of the pixels, "
          f"max delta {delta[rows[:, 6] > 0].max():.3e} px")
    assert share < 0.02, share
    changed = (got != fb).any(0)
    print(f"{name}: {int(changed.sum())} pixels changed")
    assert changed.sum() >= 2 * n, "the lines must cover pixels"
    for jit in (True, False):
        want = _reference(scene, world, bank, fb, zb, h, w, row0, jit)
        differ = (got != want).any(0)
        assert not np.any(differ & ~band), (jit, np.argwhere(
            differ & ~band)[:5])


def _sequential(fb, zb, rows, h, w):
    """The reference's per-line select loop, one segment at a time, over
    the port's per-pixel tests (line_coverage)."""
    cov = tl.line_coverage(rows, torch.as_tensor(zb), h, w)
    out = torch.as_tensor(fb).clone()
    for i in range(rows.shape[0]):
        m = cov[i]
        for c in range(3):
            out[c] = torch.where(m, rows[i, 8 + c], out[c])
        out[3] = torch.where(m, torch.maximum(out[3], rows[i, 11]), out[3])
    return out


def test_vectorised_selection_equals_sequential_loop():
    """A chunk's selection in one step equals the reference's loop over its
    segments, and the chunk size does not change the frame (bit for bit)."""
    scene, world, bank, fb, zb = _inputs(6, 40)
    tscene = _Scene(**{k: torch.as_tensor(v) for k, v in scene.items()})
    tbank = tl.LineBank(**{k: torch.as_tensor(v) for k, v in bank.items()})
    rows = tl.line_rows(tscene, torch.as_tensor(world), tbank)
    got = tl.draw_lines_plain(torch.as_tensor(fb), torch.as_tensor(zb), rows,
                              H, W)
    assert torch.equal(got, _sequential(fb, zb, rows, H, W))
    for chunk in (1, 7, 64):
        assert torch.equal(got, tl.draw_lines_plain(
            torch.as_tensor(fb), torch.as_tensor(zb), rows, H, W,
            chunk=chunk))


def test_build_line_bank_matches_reference():
    rng = np.random.default_rng(9)
    for n, pad in ((1, 8), (8, 8), (13, 8), (300, 8), (5, 4)):
        segs = [dict(i0=int(a), i1=int(b), color=tuple(c))
                for a, b, c in zip(rng.integers(0, 99, n),
                                   rng.integers(0, 99, n),
                                   rng.uniform(0, 1, (n, 4)))]
        segs[0].pop("color")
        want = jl.build_line_bank(segs, pad=pad)
        got = tl.build_line_bank(segs, pad=pad, device="cpu")
        assert got.idx.shape[0] % pad == 0 and got.idx.shape[0] >= n
        for f in tl.LineBank._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert got.idx.dtype == torch.int32 and got.valid.dtype == torch.bool
    assert tl.build_line_bank([]) is None and jl.build_line_bank([]) is None


def test_empty_bank_leaves_the_frame():
    scene, world, bank, fb, zb = _inputs(7, 0)
    bank = {k: v[:0] for k, v in bank.items()}
    got = _port(scene, world, bank, fb, zb, H, W, 0.0)
    np.testing.assert_array_equal(got, fb)


def test_lines_kernel_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; the dispatcher sends a
    CPU tensor to the plain version."""
    with pytest.raises(ValueError):
        tl.lines_kernel(torch.zeros(4, 8, 8), torch.ones(8, 8),
                        torch.zeros(8, tl.ROW_FLOATS), 8, 8)


def test_nan_alpha_segment_matches_reference():
    """A segment whose colour alpha is NaN: the port's plain version puts
    NaN in the alpha of every pixel it covers, and only there, as the
    reference's jnp.maximum does (jitted and op by op), outside the
    rounding band."""
    scene, world, bank, fb, zb = _inputs(2, 40)
    tscene = _Scene(**{k: torch.as_tensor(v) for k, v in scene.items()})
    tbank = tl.LineBank(**{k: torch.as_tensor(v) for k, v in bank.items()})
    rows = tl.line_rows(tscene, torch.as_tensor(world), tbank)
    cov = tl.line_coverage(rows, torch.as_tensor(zb), H, W)
    seg = int(torch.argmax(cov.sum((1, 2))))
    bank["color"][seg, 3] = np.nan
    got = _port(scene, world, bank, fb, zb, H, W, 0.0)
    nan_got = np.isnan(got[3])
    assert nan_got.sum() >= 5
    np.testing.assert_array_equal(nan_got, cov[seg].numpy())
    rows64, delta, delta_z = exact_rows(scene, world, bank)
    band = line_band(rows64, H, W, zb, zb, delta, delta_z)
    for jit in (True, False):
        want = _reference(scene, world, bank, fb, zb, H, W, 0.0, jit)
        nan_want = np.isnan(want[3])
        assert not np.any((nan_got != nan_want) & ~band), jit
        differ = ((got != want) & ~(np.isnan(got) & np.isnan(want))).any(0)
        assert not np.any(differ & ~band), jit
