# Copyright 2026. Apache License 2.0.
"""medicalseg_torch: the PyTorch/CUDA port of medicalseg_tpu for NVIDIA
Hopper GPUs. It imports torch and never JAX or medicalseg_tpu; every
Pallas kernel of the JAX package on a ported path is a hand-written CUDA
kernel under ``csrc/``.
"""

__version__ = "0.1.0"

from . import core, cvlibs, datasets, io, models, ops, transforms, utils

__all__ = ["core", "cvlibs", "datasets", "io", "models", "ops", "transforms",
           "utils", "__version__"]
