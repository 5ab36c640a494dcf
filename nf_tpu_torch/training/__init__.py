from nf_tpu_torch.training import manager, optimizers
from nf_tpu_torch.training.manager import (
    AffineManager,
    BasicManager,
    PWLinManager,
    PWQuadManager,
)

__all__ = [
    "manager",
    "optimizers",
    "BasicManager",
    "AffineManager",
    "PWLinManager",
    "PWQuadManager",
]
