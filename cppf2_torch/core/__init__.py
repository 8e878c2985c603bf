from cppf2_torch.core.binning import prob2real, real2prob
from cppf2_torch.core.downsample import voxel_downsample
from cppf2_torch.core.geometry import (
    backproject_masked,
    fibonacci_sphere,
    map_sym,
    map_sym_discrete,
    matrix_to_quat,
    quat_to_matrix,
    rotx,
    roty,
    rotz,
    so3_exp,
)
from cppf2_torch.core.pairs import pair_targets

__all__ = [
    "real2prob",
    "prob2real",
    "backproject_masked",
    "fibonacci_sphere",
    "map_sym",
    "map_sym_discrete",
    "quat_to_matrix",
    "matrix_to_quat",
    "rotx",
    "roty",
    "rotz",
    "so3_exp",
    "pair_targets",
    "voxel_downsample",
]
