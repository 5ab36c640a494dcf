from nf_tpu_torch.training import (ensemble, manager, metrics, multichannel, optimizers,
                                   unweight, vegas)
from nf_tpu_torch.training.manager import (
    AffineManager,
    BasicManager,
    PWLinManager,
    PWQuadManager,
)

__all__ = [
    "ensemble",
    "manager",
    "metrics",
    "multichannel",
    "optimizers",
    "unweight",
    "vegas",
    "BasicManager",
    "AffineManager",
    "PWLinManager",
    "PWQuadManager",
]
