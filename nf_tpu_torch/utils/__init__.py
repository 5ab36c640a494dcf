from nf_tpu_torch.utils import checkpoint, lhe, qmc

__all__ = ["checkpoint", "lhe", "qmc"]
