"""Render the golden config-2 frame with the reference package on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py

Writes ``tests/torch_golden/config2_320x240.npz``: the ``BackToFront()``
uint8 RGBA image of BASELINE config 2 (lit sphere over a textured plane,
two lights) at 320x240, and its per-pixel winner-id map (-1 = background)
from the reference's own stages and exact flat solve. The port's tests and
``chip_smoke.py`` hold the port's frame, on the CPU and on the GPU, against
this file.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "torch_golden", "config2_320x240.npz")


def render_reference():
    """(rgba uint8 (240,320,4), ids int32 (240,320)) of the reference."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import ckrenderengine_tpu.objects as J
    from ckrenderengine_tpu_torch import scenes
    from tests._torch_common import reference_winners

    _, rc, _ = scenes.build_config2(J, width=320, height=240)
    rc.Render()
    ids, _depth, _setup = reference_winners(*rc._fill_packed([], []))
    return rc.BackToFront(), ids.astype("int32")


if __name__ == "__main__":
    import numpy as np

    rgba, ids = render_reference()
    np.savez_compressed(OUT, rgba=rgba, ids=ids)
    print(OUT, os.path.getsize(OUT), "bytes")
