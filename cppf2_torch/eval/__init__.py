from cppf2_torch.eval.iou3d import Box, iou_with_symmetry, oriented_iou
from cppf2_torch.eval.nocs_map import compute_degree_cm_map
from cppf2_torch.eval.pose_errors import pose_error_degree_cm


def evaluate_real275_parallel(*args, **kwargs):
    """`eval/parallel_eval.py::evaluate_real275_parallel`, imported at call
    time: that module imports `parallel/`, which this package must not pull
    in on import."""
    from cppf2_torch.eval.parallel_eval import evaluate_real275_parallel as f

    return f(*args, **kwargs)


__all__ = [
    "Box",
    "oriented_iou",
    "iou_with_symmetry",
    "pose_error_degree_cm",
    "compute_degree_cm_map",
    "evaluate_real275_parallel",
]
