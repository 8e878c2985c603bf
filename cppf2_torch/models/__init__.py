from cppf2_torch.models.cppf import DinoBranch, ShotBranch, TuplePredictions
from cppf2_torch.models.layers import ResLayer, ResMLP
from cppf2_torch.models.porting import load_beyondcppf_checkpoint, port_beyondcppf_state_dict

__all__ = [
    "ResLayer",
    "ResMLP",
    "ShotBranch",
    "DinoBranch",
    "TuplePredictions",
    "load_beyondcppf_checkpoint",
    "port_beyondcppf_state_dict",
]
