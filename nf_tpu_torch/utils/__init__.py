from nf_tpu_torch.utils import checkpoint, experiment, lhe, profiling, qmc, sweep

__all__ = ["checkpoint", "experiment", "lhe", "profiling", "qmc", "sweep"]
