"""The port's pose overlay against the JAX package's (cv2) on posed boxes
made from seeds: the box and projection helpers exactly, the overlay pixel
for pixel, boxes partly or wholly outside the frame included."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from cppf2_torch.core import geometry as tgeo
from cppf2_torch.utils import draw_pose_overlay
from cppf2_torch.utils import viz as tviz
from cppf2_tpu.core import geometry as jgeo
from cppf2_tpu.utils import viz as jviz

K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32)


def _pose(rng, seed, near=False):
    rt = np.eye(4)
    rt[:3, :3] = Rotation.random(random_state=seed).as_matrix() * rng.uniform(0.05, 0.4)
    rt[:3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2),
                 rng.uniform(0.15, 0.3) if near else rng.uniform(0.5, 1.5)]
    scales = rng.uniform(0.3, 1.0, 3)
    return rt, scales / np.linalg.norm(scales)


def test_box_and_projection_helpers_exact():
    rng = np.random.default_rng(0)
    for seed in range(20):
        rt, scales = _pose(rng, seed)
        for shift in (0.0, 0.1):
            np.testing.assert_array_equal(tgeo.get_3d_bbox(scales, shift), jgeo.get_3d_bbox(scales, shift))
        np.testing.assert_array_equal(tgeo.get_3d_bbox(0.3), jgeo.get_3d_bbox(0.3))
        box = tgeo.get_3d_bbox(scales)
        t3 = tgeo.transform_coordinates_3d(box, rt)
        np.testing.assert_array_equal(t3, jgeo.transform_coordinates_3d(box, rt))
        np.testing.assert_array_equal(tgeo.calculate_2d_projections(t3, K),
                                      jgeo.calculate_2d_projections(t3, K))


@pytest.mark.parametrize("flipped", [True, False])
def test_overlay_equals_jax_pixel_for_pixel(flipped):
    """40 poses on random frames, every seventh one close to the camera so
    its box leaves the frame: every pixel equal (thickness-3 lines over each
    other in four colours)."""
    rng = np.random.default_rng(1)
    drawn = 0
    for seed in range(40):
        rt, scales = _pose(rng, seed, near=seed % 7 == 0)
        rgb = rng.integers(0, 256, size=(480, 640, 3)).astype(np.uint8)
        want = jviz.draw_pose_overlay(rgb, rt, scales, K, flipped=flipped)
        got = draw_pose_overlay(rgb, rt, scales, K, flipped=flipped)
        np.testing.assert_array_equal(got, want)
        drawn += int((got != rgb).any(-1).sum())
    assert drawn > 10000   # the lines were drawn, not skipped on both sides


def test_draw_bbox_axes_in_place_and_color():
    """The box and the axes drawn in place, the box colour as given."""
    img = np.zeros((100, 120, 3), np.uint8)
    pts = np.array([[10, 10], [10, 60], [60, 10], [60, 60], [30, 20], [30, 70], [80, 20], [80, 70]])
    axes = np.array([[50, 50], [50, 90], [90, 50], [20, 50]], np.int32)
    want = jviz.draw_bbox_axes(img.copy(), pts, axes, color=(0, 200, 100))
    out = tviz.draw_bbox_axes(img, pts, axes, color=(0, 200, 100))
    assert out is img
    np.testing.assert_array_equal(img, want)
