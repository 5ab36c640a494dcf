from nf_tpu_torch.training import manager, multichannel, optimizers, unweight
from nf_tpu_torch.training.manager import (
    AffineManager,
    BasicManager,
    PWLinManager,
    PWQuadManager,
)

__all__ = [
    "manager",
    "multichannel",
    "optimizers",
    "unweight",
    "BasicManager",
    "AffineManager",
    "PWLinManager",
    "PWQuadManager",
]
