from nf_tpu_torch.phasespace import lhapdf_reader, lorentz, mappings, pdf, topology
from nf_tpu_torch.phasespace.generator import (
    FlatInvertiblePhasespace,
    PhaseSpaceGeneratorError,
    VirtualPhaseSpaceGenerator,
)
from nf_tpu_torch.phasespace.topology import (
    BreitWignerSMap,
    PowerSMap,
    ResonanceDecayPhasespace,
    UniformSMap,
    multichannel_integrand,
    optimize_alphas,
)

__all__ = [
    "lhapdf_reader",
    "lorentz",
    "mappings",
    "pdf",
    "topology",
    "FlatInvertiblePhasespace",
    "VirtualPhaseSpaceGenerator",
    "PhaseSpaceGeneratorError",
    "ResonanceDecayPhasespace",
    "BreitWignerSMap",
    "PowerSMap",
    "UniformSMap",
    "multichannel_integrand",
    "optimize_alphas",
]
