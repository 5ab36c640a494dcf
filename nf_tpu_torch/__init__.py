"""nf_tpu_torch — neural importance sampling with normalizing flows, in PyTorch.

The PyTorch/CUDA counterpart of ``nf_tpu``, laid out module for module like
it (``bijectors/``, ``flows/``, ``ops/``, ``phasespace/``, ``training/``,
``utils/``) and held against it by the ``tests/test_torch_*.py`` parity
tests.  Differences in idiom:

  * conditioners and flows are ``nn.Module``s, BatchNorm running statistics
    are buffers, transforms are plain functions on tensors;
  * the device is explicit (``device=`` on every manager) and each manager
    owns a ``torch.Generator`` seeded from ``seed``; the phase space computes
    on the device of its latents;
  * the eval-mode fused sampler and the stale-statistics training forward
    and backward are hand-written CUDA kernels (``ops/csrc/``), built with
    nvcc at first use.  Importing the package compiles nothing.
"""

from nf_tpu_torch.phasespace import FlatInvertiblePhasespace, PhaseSpaceGeneratorError
from nf_tpu_torch.training.manager import (
    AffineManager,
    BasicManager,
    PWLinManager,
    PWQuadManager,
)

__all__ = ["BasicManager", "AffineManager", "PWLinManager", "PWQuadManager",
           "FlatInvertiblePhasespace", "PhaseSpaceGeneratorError"]
