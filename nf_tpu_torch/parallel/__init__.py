from nf_tpu_torch.parallel.mesh import (make_mesh, data_parallel_sharding,
                                        initialize_distributed)
from nf_tpu_torch.parallel.dp import make_dp_loss, make_dp_train_step
from nf_tpu_torch.parallel.sampling import dp_sample, dp_integrate

__all__ = ["make_mesh", "data_parallel_sharding", "initialize_distributed",
           "make_dp_loss", "make_dp_train_step",
           "dp_sample", "dp_integrate"]
