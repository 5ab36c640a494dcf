from nf_tpu_torch.utils import qmc

__all__ = ["qmc"]
