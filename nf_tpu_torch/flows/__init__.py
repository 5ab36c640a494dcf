from nf_tpu_torch.flows.factory import (
    adjust_pwquad_cells,
    build_affine_flow,
    build_pwlin_flow,
    build_pwquad_flow,
)
from nf_tpu_torch.flows.model import CellCfg, Flow, FlowModel, inverse, make_cell_cfg

__all__ = [
    "Flow",
    "CellCfg",
    "FlowModel",
    "inverse",
    "make_cell_cfg",
    "build_affine_flow",
    "build_pwlin_flow",
    "build_pwquad_flow",
    "adjust_pwquad_cells",
]
