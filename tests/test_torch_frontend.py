"""Port's geometric frontend against the JAX package: kNN, eig3, normals,
SHOT and the whole `preprocess_frame`, on the CPU at small sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.infer import frontend as tfront
from cppf2_torch.ops import eig3 as teig
from cppf2_torch.ops import neighbors as tnb
from cppf2_torch.ops import normals as tnorm
from cppf2_torch.ops import shot as tshot
from cppf2_tpu.infer import frontend as jfront
from cppf2_tpu.ops import eig3 as jeig
from cppf2_tpu.ops import neighbors as jnb
from cppf2_tpu.ops import normals as jnorm
from cppf2_tpu.ops import shot as jshot

REAL275_K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
                     np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def _surface(n=400, seed=0):
    """Points on a bumpy 4 cm patch at 2 mm spacing, a few invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.02, 0.02, size=(n, 2))
    z = 0.8 + 0.004 * np.sin(60 * xy[:, 0]) * np.cos(40 * xy[:, 1])
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    return np.where(valid[:, None], pts, 0).astype(np.float32), valid


# The JAX kNN as the JAX driver runs it: under jax.jit (`preprocess_frame` is
# jitted). XLA rounds the packed key's column norms otherwise when the
# function is called eagerly, and the port holds the jitted rounding.
jknn = jax.jit(jnb.knn_radius_neighbors, static_argnums=(2, 3),
               static_argnames=("exact", "query_chunk"))


def _neighbors(pts, valid, radius=0.02, k=24):
    return (jknn(jnp.asarray(pts), jnp.asarray(valid), radius, k),
            tnb.knn_radius_neighbors(t(pts), t(valid), radius, k))


def test_knn_indices_exact():
    """Indices and validity exact against the jitted JAX kNN, the rounding the
    JAX driver runs (the eager call rounds the key's column norms as a
    plain sum and picks other neighbours on some rows): the same packed key,
    exact top-k on both sides."""
    pts, valid = _surface()
    jn, tn = _neighbors(pts, valid)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    np.testing.assert_allclose(tn.dist.numpy(), np.asarray(jn.dist), atol=1e-7)
    np.testing.assert_allclose(tn.rel.numpy(), np.asarray(jn.rel), atol=1e-7)


def _cap_cloud(n, seed):
    """n points of a noisy 5 cm sphere cap at 0.7 m, a tenth of them invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.035, 0.035, size=(n, 2))
    z = 0.7 - np.sqrt(np.maximum(0.05 ** 2 - np.sum(xy ** 2, -1), 0.0)) + rng.normal(0, 3e-4, n)
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    return np.where(valid[:, None], pts, 0).astype(np.float32), valid


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("n", [256, 2048, 8192])
def test_knn_matches_jitted_jax_at_cloud_sizes(n, exact):
    """The frontend's kNN (radius 2 cm, k 48) on sphere caps of the pipeline's
    cloud sizes against the jitted JAX function, both routes: every valid
    row's neighbour list and validity equal. With the column norms rounded
    as the eager JAX call rounds them, 2.6%, 26.5% and 61-68% of the valid
    rows had another list at 256, 2048 and 8192 points (mostly another
    order; 0.7% and 2.4-2.8% another in-radius set at the larger two)."""
    pts, valid = _cap_cloud(n, seed=n)
    jn = jknn(jnp.asarray(pts), jnp.asarray(valid), 0.02, 48, exact=exact)
    tn = tnb.knn_radius_neighbors(t(pts), t(valid), 0.02, 48, exact=exact)
    np.testing.assert_array_equal(tn.idx.numpy()[valid], np.asarray(jn.idx)[valid])
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))


def test_sym_eig3x3():
    """Closed form on random SPD, rank-deficient and diagonal matrices:
    eigenvalues atol 1e-5 * scale, vectors (order and sign) atol 2e-4."""
    rng = np.random.default_rng(1)
    m = rng.normal(size=(300, 3, 3)).astype(np.float32)
    a = m @ np.swapaxes(m, -1, -2)
    a[:50, 2] = 0
    a[:50, :, 2] = 0
    a[50:80] = np.eye(3, dtype=np.float32) * rng.uniform(0.1, 2, size=(30, 1, 1))
    wv, wV = jeig.sym_eig3x3(jnp.asarray(a))
    gv, gV = teig.sym_eig3x3(t(a))
    scale = np.abs(a).max(axis=(1, 2))[:, None]
    np.testing.assert_allclose(gv.numpy() / scale, np.asarray(wv) / scale, atol=1e-5)
    np.testing.assert_allclose(gV.numpy(), np.asarray(wV), atol=2e-4)


def test_normals_and_shot():
    """On the jitted JAX kNN's neighbours (the JAX driver's rounding; the
    eager call's differ on some rows): normals atol 1e-4 (the 3x3 covariance
    sums 24 terms in another order and the eigen solver amplifies it); SHOT
    atol 5e-4 on unit descriptors (a soft-bin weight near a bin edge moves
    with the frame's last ulps)."""
    pts, valid = _surface()
    jn, tn = _neighbors(pts, valid)
    jnorm_ = jnorm.estimate_normals(jnp.asarray(pts), jn)
    tnorm_ = tnorm.estimate_normals(t(pts), tn)
    np.testing.assert_allclose(tnorm_.numpy(), np.asarray(jnorm_), atol=1e-4)
    jdesc = jshot.compute_shot(jnp.asarray(pts), jnorm_, jn, 0.02)
    tdesc = tshot.compute_shot(t(pts), t(np.asarray(jnorm_)), tn, 0.02)
    np.testing.assert_allclose(tdesc.numpy(), np.asarray(jdesc), atol=5e-4)
    assert tdesc.shape == (400, 352)


def _frame(h=64, w=80, seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    mask = ((xs - 38) ** 2 + (ys - 30) ** 2) < 20 ** 2
    bump = 0.02 * np.cos((xs - 38) / 12.0) * np.cos((ys - 30) / 12.0)
    depth = np.where(mask, 0.5 - bump + rng.normal(0, 3e-4, (h, w)), 0).astype(np.float32)
    return depth, mask


@pytest.mark.parametrize("crop", [None, 48])
def test_preprocess_frame(crop):
    """64x80 depth, n_max 512, the reference's own voxel draws, against the
    jitted JAX `preprocess_frame`. Cloud, validity, count and pixels exact.
    The kNN rounds its packed key as that jitted graph does, so every row
    has the same neighbour set; what remains is the last ulps of the
    covariance and the soft bins. Normals all within 1e-5 (measured
    1.9e-6); SHOT 85% of rows within 1e-5 and all within 2e-3 on unit
    descriptors (measured 3.3e-7 and 6.8e-4: a soft-bin weight at a bin
    edge). (The bounds were 0.05 and 0.2 while the port rounded the key's
    column norms as the eager JAX call does: some rim rows then had another
    neighbour set, and their normals and SHOT moved.)"""
    depth, mask = _frame()
    key = jax.random.key(5)
    want = jfront.preprocess_frame(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(REAL275_K),
                                   key, res=2e-3, n_max=512, shot_k=24, crop=crop)
    hw = tfront.window_shape(depth.shape, crop)
    n = hw[0] * hw[1]
    perm = np.asarray(jax.random.permutation(key, n))
    prio = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (n,)))
    got = tfront.preprocess_frame(t(depth), t(mask), t(REAL275_K), t(perm), t(prio),
                                  res=2e-3, n_max=512, shot_k=24, crop=crop)
    assert int(got.count) == int(want.count) and int(got.count) > 300
    np.testing.assert_array_equal(got.pc.numpy(), np.asarray(want.pc))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.pixel_yx.numpy(), np.asarray(want.pixel_yx))
    np.testing.assert_array_equal(got.window_yx.numpy(), np.asarray(want.window_yx))
    err_n = np.abs(got.normal.numpy() - np.asarray(want.normal)).max(-1)
    err_s = np.abs(got.shot.numpy() - np.asarray(want.shot)).max(-1)
    assert err_n.max() < 1e-5
    assert np.quantile(err_s, 0.85) < 1e-5 and err_s.max() < 2e-3


def test_auto_crop_matches():
    _, mask = _frame()
    assert tfront.auto_crop(mask) == jfront.auto_crop(mask)
    assert tfront.mask_bbox(mask) == jfront.mask_bbox(mask)
    assert tfront.auto_crop(np.zeros_like(mask)) is None


@pytest.mark.parametrize("channels", [3, 1])
def test_resize_crop_matches_cv2(channels):
    """The cv2-free crop against the JAX package's cv2.warpAffine path on
    [0, 1] images: 100 random frames, bboxes (some past the frame's edge),
    paddings and crop sizes (multiples of 16 and not); the same transform
    and the crop within 1e-5 (measured: equal)."""
    rng = np.random.default_rng(channels)
    for _ in range(100):
        h, w = int(rng.integers(30, 480)), int(rng.integers(30, 640))
        img = rng.uniform(size=(h, w, channels)[:2 + (channels == 3)]).astype(np.float32)
        left, top = int(rng.integers(-10, w - 5)), int(rng.integers(-10, h - 5))
        bbox = (left, top, left + int(rng.integers(2, 300)), top + int(rng.integers(2, 300)))
        out_size = int(rng.choice([16, 57, 64, 100, 256]))
        padding = float(rng.choice([0.0, 0.1, 0.25]))
        want, wt = jfront.resize_crop(img, bbox=bbox, out_size=out_size, padding=padding)
        got, gt = tfront.resize_crop(img, bbox=bbox, out_size=out_size, padding=padding)
        np.testing.assert_array_equal(gt, wt)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
    mask_img = np.zeros((40, 50, 3), np.float32)
    mask_img[10:20, 5:30] = 0.5
    for g, w in zip(tfront.resize_crop(mask_img, out_size=32), jfront.resize_crop(mask_img, out_size=32)):
        np.testing.assert_allclose(g, w, atol=1e-5)
