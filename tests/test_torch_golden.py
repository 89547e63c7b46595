"""The golden config-2 frame (tests/torch_golden/config2_320x240.npz, made
by tests/torch_golden/make_golden.py with the reference package): the
reference still reproduces it, and the port on the CPU matches it. The
bounds are the slice's (tests/test_torch_slice.py): winner ids equal on
>= 99.9% of the pixels, and the 8-bit image within one step wherever the
winners agree. ``chip_smoke.py`` holds the port on the GPU to the same
file and bounds."""

import os

import numpy as np
import pytest
import torch

from ckrenderengine_tpu_torch import scenes
from tests._torch_common import port_winners, to_np
from tests.torch_golden import make_golden

GOLDEN = np.load(make_golden.OUT)


def _check(rgba, ids):
    assert rgba.shape == GOLDEN["rgba"].shape and rgba.dtype == np.uint8
    match = ids == GOLDEN["ids"]
    assert match.mean() >= 0.999, match.mean()
    diff = np.abs(rgba.astype(np.int32) - GOLDEN["rgba"].astype(np.int32))
    assert diff[match].max() <= 1, diff[match].max()
    assert (GOLDEN["ids"] >= 0).mean() > 0.5


def test_golden_file_is_small():
    assert os.path.getsize(make_golden.OUT) <= 300_000


def test_reference_reproduces_golden():
    rgba, ids = make_golden.render_reference()
    _check(rgba, ids)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_port_matches_golden(device):
    import ckrenderengine_tpu_torch.objects as O

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels run only on the "
                    "card)")

    _ctx, rc, _m = scenes.build_config2(O, device=device, width=320,
                                        height=240)
    rc.Render()
    st, tf, ti, tp = rc._fill_packed([], [])
    _fb, _zb, ids = port_winners(st, torch.as_tensor(tf, device=device),
                                 torch.as_tensor(ti, device=device), tp)
    _check(rc.BackToFront(), to_np(ids))
