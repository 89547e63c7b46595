"""ckrenderengine_tpu_torch — the CK render engine on PyTorch and CUDA.

A port of ``ckrenderengine_tpu`` (the JAX/Pallas rebuild of the Virtools CK2
render engine) for one NVIDIA Hopper GPU: the same CK object API
(``CKContext`` -> ``CKRenderManager.CreateRenderContext`` ->
``CKRenderContext.Render()``), the same scene compile and packed frame
buffers, and an eager torch frame whose visibility solves are hand-written
CUDA kernels (``csrc/``). Every kernel has a plain torch version in the same
module, which a CPU tensor takes; a CUDA tensor always launches the kernel.

Subpackages keep the reference package's layout and names: ``math``,
``scene``, ``raster``, ``pipeline``, ``objects``.
"""

import torch

# compose_world and the view/projection products must stay in full f32:
# never let a float32 matmul or convolution drop to TF32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
