"""The port's geometric instance proposer against the JAX package's on the
scenes of `tests/test_segmenter.py` (a tabletop plane with sphere-cap
objects, made from seeds): the proposals identical mask for mask and in the
same order, the normals within 1e-5 (they come out bit for bit), the support
plane's normal and offset within 1e-6, and the frontend's `dilate_mask`
equal pixel for pixel."""

import numpy as np
import pytest
from scipy import ndimage

from cppf2_torch.infer import frontend as tfront
from cppf2_torch.infer import segmenter as tseg
from cppf2_tpu.infer import frontend as jfront
from cppf2_tpu.infer import segmenter as jseg
from test_segmenter import K, tabletop_scene

SCENES = {
    "one": [(320, 240, 0.08, 0.9)],
    "two": [(200, 240, 0.08, 0.9), (460, 220, 0.07, 0.85)],
    "flat": [],
}


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("scale_range", [(0.12, 0.2), (0.1, 0.2), (0.55, 0.7), None])
def test_proposals_equal_jax(scene, scale_range):
    """One object, two, and a bare plane; a fitting prior, a looser one, a
    wrong scale (no proposal) and no prior: the same masks in the same
    order."""
    depth, _ = tabletop_scene(np.random.default_rng(0), SCENES[scene])
    want = jseg.propose_instances(depth, K, scale_range)
    got = tseg.propose_instances(depth, K, scale_range)
    assert _same(got, want), (len(got), len(want))
    if scene == "two" and scale_range == (0.1, 0.2):
        assert len(got) >= 2
    if scale_range == (0.55, 0.7) or scene == "flat":
        assert got == []


def test_empty_scene_and_auto_mask():
    """An all-zero frame proposes nothing in both; `auto_mask` resolves the
    category's prior as JAX's does."""
    zero = np.zeros((120, 160), np.float32)
    assert tseg.propose_instances(zero, K) == jseg.propose_instances(zero, K) == []
    depth, _ = tabletop_scene(np.random.default_rng(1), SCENES["one"])
    np.testing.assert_array_equal(tseg.auto_mask(depth, K, category="mug"),
                                  jseg.auto_mask(depth, K, category="mug"))
    assert tseg.resolve_scale_range("mug", None) == jseg.resolve_scale_range("mug", None)
    assert tseg.auto_mask(zero, K) is None


def test_normals_plane_and_edges_match_jax():
    """Backprojection and depth edges equal; normals within 1e-5 (equal
    here); the dominant plane's inliers equal, n0 and d0 within 1e-6."""
    depth, _ = tabletop_scene(np.random.default_rng(2), SCENES["two"])
    valid = depth > 0.1
    pts_j, pts_t = jseg.backproject_grid(depth, K), tseg.backproject_grid(depth, K)
    np.testing.assert_array_equal(pts_t, pts_j)
    nj, nt = jseg.grid_normals(pts_j, valid), tseg.grid_normals(pts_t, valid)
    np.testing.assert_allclose(nt, nj, atol=1e-5)
    np.testing.assert_array_equal(tseg.depth_edges(depth, valid), jseg.depth_edges(depth, valid))
    mj, n0j, d0j = jseg.dominant_plane(pts_j, nj, valid)
    mt, n0t, d0t = tseg.dominant_plane(pts_t, nt, valid)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(n0t, n0j, atol=1e-6)
    assert abs(d0t - d0j) < 1e-6
    with pytest.raises(ValueError):
        tseg.grid_normals(pts_t, valid, smooth=3)


def test_dominant_plane_orientation():
    """The bare plane at z = 1: normal along z, the camera on its positive
    side, offset 1 m; as in JAX."""
    depth, _ = tabletop_scene(np.random.default_rng(0), [])
    valid = depth > 0.1
    pts = tseg.backproject_grid(depth, K)
    mask, n0, d0 = tseg.dominant_plane(pts, tseg.grid_normals(pts, valid), valid)
    _, n0j, d0j = jseg.dominant_plane(pts, jseg.grid_normals(pts, valid), valid)
    assert mask.sum() > 0.5 * valid.sum()
    assert abs(abs(n0[2]) - 1) < 0.05 and abs(abs(d0) - 1.0) < 0.02
    np.testing.assert_allclose(n0, n0j, atol=1e-6)
    assert abs(d0 - d0j) < 1e-6


def test_dilate_mask_equals_jax():
    """Convex-hull fill and rectangular dilation, with and without the
    largest component, odd and even kernels, an empty mask: equal."""
    rng = np.random.default_rng(3)
    for t in range(40):
        m = ndimage.binary_dilation(rng.uniform(size=(120, 160)) < 0.002 * (1 + t % 5),
                                    iterations=int(rng.integers(1, 6)))
        if t == 0:
            m[:] = False
        for largest in (False, True):
            for size in (3, 5, 6):
                np.testing.assert_array_equal(tfront.dilate_mask(m, size, largest),
                                              jfront.dilate_mask(m, size, largest))
