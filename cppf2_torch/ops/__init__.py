from cppf2_torch.ops.eig3 import sym_eig3x3
from cppf2_torch.ops.neighbors import knn_radius_neighbors
from cppf2_torch.ops.normals import estimate_normals
from cppf2_torch.ops.shot import compute_shot, shot_lrf

__all__ = [
    "knn_radius_neighbors",
    "sym_eig3x3",
    "estimate_normals",
    "compute_shot",
    "shot_lrf",
]
