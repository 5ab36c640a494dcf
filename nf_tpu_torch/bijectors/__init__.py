from nf_tpu_torch.bijectors import batchnorm, conditioner, coupling, permutations

__all__ = ["batchnorm", "conditioner", "coupling", "permutations"]
