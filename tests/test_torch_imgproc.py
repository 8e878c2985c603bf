"""The port's stand-ins for the OpenCV calls of the demo path
(`cppf2_torch/utils/imgproc.py`) against the cv2 the JAX package calls
(OpenCV 5.0) on the same numpy inputs, made from seeds: at 480 x 640, at odd
sizes, and on all-zero and all-one masks. Discrete outputs (labels, masks, hulls, filled polygons,
drawn lines) must be equal; the blur equal to the bit at the widths the path
runs, and within 2 ulps anywhere."""

import cv2
import numpy as np
import pytest
from scipy import ndimage

from cppf2_torch.utils import imgproc

SIZES = [(480, 640), (37, 53), (11, 13), (5, 7), (3, 4), (1, 9), (6, 1)]


def _ulps(a, b):
    """Distance in float32 units in the last place."""
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur5_matches_cv2(hw, channels):
    """Bit for bit where the row length in floats is even (480 x 640, gray
    and colour: the segmenter's inputs) and on these sizes all but a few
    tail values; at most 2 ulps anywhere, on values of both signs."""
    rng = np.random.default_rng(hash((hw, channels)) % 2 ** 32)
    shape = hw if channels == 1 else (*hw, channels)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    want = cv2.GaussianBlur(x, (5, 5), 0)
    got = imgproc.gaussian_blur5(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulps(got, want).max() <= 2
    if hw == (480, 640):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize", [3, 4, 5, 7])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_dilate_erode_close_match_cv2(ksize, dtype):
    """Rectangular kernels, the default border (never wins), odd and even
    sizes, random values and the segmenter's +-1e6 sentinels: equal."""
    rng = np.random.default_rng(ksize)
    k = np.ones((ksize, ksize), np.uint8)
    for hw in [(480, 640), (37, 53), (4, 3)]:
        if dtype == np.uint8:
            x = (rng.uniform(size=hw) < 0.3).astype(np.uint8) * rng.integers(1, 256, size=hw).astype(np.uint8)
        else:
            x = np.where(rng.uniform(size=hw) < 0.2, -1e6, rng.normal(size=hw)).astype(np.float32)
        np.testing.assert_array_equal(imgproc.dilate(x, ksize), cv2.dilate(x, k))
        np.testing.assert_array_equal(imgproc.erode(x, ksize), cv2.erode(x, k))
        np.testing.assert_array_equal(imgproc.morph_close(x, ksize),
                                      cv2.morphologyEx(x, cv2.MORPH_CLOSE, k))
    for const in (0, 1):
        m = np.full((20, 30), const, np.uint8)
        np.testing.assert_array_equal(imgproc.dilate(m, ksize), cv2.dilate(m, k))
        np.testing.assert_array_equal(imgproc.erode(m, ksize), cv2.erode(m, k))


def _masks(seed):
    rng = np.random.default_rng(seed)
    out = [np.zeros((48, 64), bool), np.ones((48, 64), bool), np.ones((1, 1), bool)]
    for i in range(14):
        hw = (480, 640) if i < 3 else tuple(int(v) for v in rng.integers(1, 90, 2))
        m = rng.uniform(size=hw) < rng.uniform(0.05, 0.6)
        if i % 2:
            m = ndimage.binary_opening(m)
        out.append(m)
    return out


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_labels_equal_cv2(connectivity):
    """The same number of labels and every label equal, on random masks of
    480 x 640 and odd sizes, speckle and blobs (8-connectivity numbers them
    in the raster order of their first 2 x 2 block, not of their first
    pixel), and on all-zero and all-one masks."""
    for m in _masks(connectivity):
        n_cv, want = cv2.connectedComponents(m.astype(np.uint8), connectivity=connectivity)
        n, got = imgproc.connected_components(m, connectivity)
        assert n == n_cv and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        imgproc.connected_components(np.ones((3, 3)), 6)


def test_convex_hull_and_fill_match_cv2():
    """Hulls of distinct integer points (random sets in random order, and
    mask pixels in raster order as np.where lists them) equal cv2's corner
    for corner in cv2's order; the filled hull of random blobs, and of
    polygons partly outside the frame, equal cv2.fillConvexPoly's."""
    rng = np.random.default_rng(0)
    for t in range(600):
        if t % 2:
            flat = rng.choice(60 * 50, size=int(rng.integers(1, 40)), replace=False)
            pts = np.stack([flat % 60, flat // 60], -1).astype(np.int32)
        else:
            m = ndimage.binary_dilation(rng.uniform(size=(50, 60)) < 0.004,
                                        iterations=int(rng.integers(1, 5)))
            ys, xs = np.where(m)
            if not len(xs):
                continue
            pts = np.stack([xs, ys], -1).astype(np.int32)
        hull = cv2.convexHull(pts)
        np.testing.assert_array_equal(imgproc.convex_hull(pts), hull[:, 0])
        canvas = (rng.uniform(size=(45, 55)) < 0.1).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.fill_convex_poly(canvas.copy(), hull[:, 0] - 5, 1),
                                      cv2.fillConvexPoly(canvas.copy(), hull - 5, 1))


@pytest.mark.parametrize("thickness", [1, 2, 3, 5])
def test_draw_line_matches_cv2(thickness):
    """Lines of every direction, short ones, and ones with an end or both
    outside the frame (cv2 clips a thick line to the frame widened by its
    thickness first), drawn over each other in colour on a random frame:
    every pixel equal, at 480 x 640 and at an odd size."""
    rng = np.random.default_rng(thickness)
    for hw in [(480, 640), (37, 53)]:
        h, w = hw
        img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        want, got = img.copy(), img.copy()
        for t in range(150):
            p0 = tuple(int(v) for v in rng.integers(-w // 2, w + w // 2, 2))
            p1 = tuple(int(v) for v in rng.integers(-h // 2, h + h // 2, 2))
            if t % 5 == 0:
                p1 = (p0[0] + int(rng.integers(-3, 4)), p0[1] + int(rng.integers(-3, 4)))
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            cv2.line(want, p0, p1, color, thickness)
            imgproc.draw_line(got, p0, p1, color, thickness)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        imgproc.draw_line(img, (0, 0), (1, 1), (0, 0, 0), 0)
