"""PyTorch/CUDA port of eradiate_kernel_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference. Module names mirror it
(``core/``, ``ops/``, ``render/``, ``scene/``, ``sensors/``, ``films/``,
``emitters/``, ``bsdfs/``, ``integrators/``) so each function has a
counterpart one directory over. Plain tensor code is eager PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels under ``csrc/``.

Entry points (``scene.load_dict``, ``scene.from_numpy``) place the scene
on ``cuda`` unless the caller passes ``device="cpu"``; every later call
runs on the device its tensors live on.
"""

import torch

# f32 everywhere: the reference pins matmuls to HIGHEST precision, and a
# TF32 srgb<->xyz or transform roundtrip costs 0.5-200% radiance error
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
