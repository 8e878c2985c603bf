"""Pose overlay: the projected 3D box and the pose axes drawn on a frame.

Counterpart of `cppf2_tpu/utils/viz.py` (reference `draw`,
utils/util.py:2208-2235, fed by demo.py:302-311 and eval.py:384-395). The
lines are `utils/imgproc.py::draw_line`, OpenCV's thick line to the pixel.
"""

from __future__ import annotations

import numpy as np

from cppf2_torch.core.geometry import calculate_2d_projections, get_3d_bbox, transform_coordinates_3d
from cppf2_torch.utils.imgproc import draw_line


def draw_bbox_axes(img: np.ndarray, imgpts: np.ndarray, axes: np.ndarray, color=(255, 0, 0),
                   size: int = 3) -> np.ndarray:
    """Draw the projected box (8 corners) and the axes onto `img` (RGB, in
    place), in the reference's order: ground edges, pillars, top edges, then
    the z, x and y axes."""
    imgpts = np.int32(imgpts).reshape(-1, 2)
    ground = tuple(int(c * 0.3) for c in color)
    pillar = tuple(int(c * 0.6) for c in color)
    for i, j in zip([4, 5, 6, 7], [5, 7, 4, 6]):
        draw_line(img, imgpts[i], imgpts[j], ground, size)
    for i, j in zip(range(4), range(4, 8)):
        draw_line(img, imgpts[i], imgpts[j], pillar, size)
    for i, j in zip([0, 1, 2, 3], [1, 3, 0, 2]):
        draw_line(img, imgpts[i], imgpts[j], color, size)
    draw_line(img, axes[0], axes[1], (0, 0, 255), size)  # z
    draw_line(img, axes[0], axes[3], (255, 0, 0), size)  # x
    draw_line(img, axes[0], axes[2], (0, 255, 0), size)  # y
    return img


def draw_pose_overlay(rgb: np.ndarray, rt: np.ndarray, scales: np.ndarray, intrinsics: np.ndarray,
                      color=(255, 0, 0), flipped: bool = True) -> np.ndarray:
    """A copy of the (H, W, 3) uint8 RGB frame with the 9-DoF pose drawn on it
    (NOCS convention: `rt` carries R * |s|, `scales` is unit-normalized).

    `flipped=True` (the default) treats `rt` as living in the backprojected
    cloud's frame, whose x and y axes are negated against the camera's
    (`core/geometry.py::backproject_masked`); it is unflipped before
    projecting."""
    if flipped:
        rt = np.diag([-1.0, -1.0, 1.0, 1.0]) @ np.asarray(rt, np.float64)
    img = np.ascontiguousarray(np.array(rgb, copy=True))
    xyz_axis = 0.3 * np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64).T
    axes = calculate_2d_projections(transform_coordinates_3d(xyz_axis, rt), intrinsics)
    proj = calculate_2d_projections(transform_coordinates_3d(get_3d_bbox(scales, 0), rt), intrinsics)
    return draw_bbox_axes(img, proj, axes, color)
