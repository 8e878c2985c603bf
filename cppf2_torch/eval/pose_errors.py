"""Symmetry-aware pose errors (degrees, centimeters) and the RT assembly of
a pose estimate.

The port's own copy of `cppf2_tpu/eval/pose_errors.py::pose_error_degree_cm`
and `_assemble_rt` (numpy; reference utils/util.py:588-663): rotations are
scale-normalized by det^(1/3); the rotation error is the y-axis angle for
continuously symmetric classes (bottle/can/bowl, and handle-occluded mug),
the minimum over a 180° flip for phone/eggbox/glue, and the trace formula
otherwise; the translation error is in cm.
"""

from __future__ import annotations

import numpy as np

_Y_SYM = ("bottle", "can", "bowl")
_Y_SYM_OCCLUDED = ("mug", "chair", "bathtub", "bookshelf", "bed", "sofa", "table")
_FLIP_SYM = ("phone", "eggbox", "glue")


def pose_error_degree_cm(rt1, rt2, class_name: str, handle_visibility: int = 1) -> np.ndarray:
    """np.array([theta_degrees, shift_cm]); [-1, -1] if either RT is None
    (a [-1, -1] row passes every threshold, so the drivers pre-fill pred_RTs
    with eye(4) and none reaches the match grid)."""
    if rt1 is None or rt2 is None:
        return np.array([-1.0, -1.0])

    rt1 = np.asarray(rt1, np.float64)
    rt2 = np.asarray(rt2, np.float64)
    t1, t2 = rt1[:3, 3], rt2[:3, 3]
    d1 = np.linalg.det(rt1[:3, :3])
    d2 = np.linalg.det(rt2[:3, :3])
    if not (np.isfinite(d1) and np.isfinite(d2)) or min(abs(d1), abs(d2)) < 1e-12:
        return np.array([180.0, np.linalg.norm(t1 - t2) * 100.0])
    r1 = rt1[:3, :3] / np.cbrt(d1)
    r2 = rt2[:3, :3] / np.cbrt(d2)

    if class_name in _Y_SYM or (class_name in _Y_SYM_OCCLUDED and handle_visibility == 0):
        y = np.array([0.0, 1.0, 0.0])
        y1, y2 = r1 @ y, r2 @ y
        cos = y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2))
        theta = np.arccos(np.clip(cos, -1.0, 1.0))
    elif class_name in _FLIP_SYM:
        flip = np.diag([-1.0, 1.0, -1.0])
        r = r1 @ r2.T
        r_flip = r1 @ flip @ r2.T
        theta = min(
            np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)),
            np.arccos(np.clip((np.trace(r_flip) - 1) / 2, -1, 1)),
        )
    else:
        r = r1 @ r2.T
        theta = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))

    deg = np.degrees(theta)
    if not np.isfinite(deg):
        deg = 180.0
    return np.array([deg, np.linalg.norm(t1 - t2) * 100.0])


def _assemble_rt(rot, trans, scale, snorm):
    """NOCS-convention (4, 4) RT with R * |s| in the rotation block, and the
    unit-normalized scales the mAP harness expects."""
    rt = np.eye(4)
    rt[:3, :3] = np.asarray(rot) * max(float(snorm), 1e-9)
    rt[:3, 3] = np.asarray(trans)
    scales = np.asarray(scale) / max(float(snorm), 1e-9)
    return rt, scales
