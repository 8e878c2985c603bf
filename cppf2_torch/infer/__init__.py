from cppf2_torch.infer.alignment import align_pose
from cppf2_torch.infer.pipeline import PoseEstimate, estimate_pose_branch, estimate_pose_ensemble

__all__ = [
    "align_pose",
    "PoseEstimate",
    "estimate_pose_branch",
    "estimate_pose_ensemble",
]
