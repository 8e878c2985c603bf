from cppf2_torch.utils.viz import draw_pose_overlay

__all__ = ["draw_pose_overlay"]
