"""The kNN's exact route, colour SHOT (CSHOT-1344) and
`preprocess_frame(exact_knn=True)` of the port against the JAX package, on
the CPU at small sizes, with the SHOT tolerances of
`tests/test_torch_frontend.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.infer import frontend as tfront
from cppf2_torch.ops import neighbors as tnb
from cppf2_torch.ops import normals as tnorm
from cppf2_torch.ops import shot as tshot
from cppf2_tpu.infer import frontend as jfront
from cppf2_tpu.ops import neighbors as jnb
from cppf2_tpu.ops import normals as jnorm
from cppf2_tpu.ops import shot as jshot

REAL275_K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
                     np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


# The JAX functions as the JAX driver runs them: under jax.jit. Called
# eagerly, XLA rounds the kNN key's column norms as a plain sum and picks
# other neighbours on some rows; the port holds the jitted rounding.
jknn = jax.jit(jnb.knn_radius_neighbors, static_argnums=(2, 3),
               static_argnames=("exact", "query_chunk"))
jshot_features = jax.jit(jshot.compute_shot_features, static_argnums=(2,),
                         static_argnames=("k", "exact"))
jcshot_features = jax.jit(jshot.compute_cshot_features, static_argnums=(3,), static_argnames=("k",))


def _surface(n=400, seed=0, p_valid=0.95):
    """Points on a bumpy 4 cm patch at about 2 mm spacing, some invalid
    (parked at 1e6 by the kNN), with colours."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.02, 0.02, size=(n, 2))
    z = 0.8 + 0.004 * np.sin(60 * xy[:, 0]) * np.cos(40 * xy[:, 1])
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    valid = rng.uniform(size=n) < p_valid
    colors = np.clip(0.5 + 0.4 * np.sin(80 * xy[:, :1] + np.array([0.0, 2.0, 4.0]))
                     + rng.normal(0, 0.05, size=(n, 3)), 0, 1).astype(np.float32)
    return np.where(valid[:, None], pts, 0).astype(np.float32), valid, colors


@pytest.mark.parametrize("n,k,radius,p_valid", [
    (400, 24, 0.02, 0.95),    # the frontend's kNN
    (300, 64, 0.004, 0.7),    # k above most queries' in-radius count, many parked points
    (50, 50, 0.02, 0.5),      # k = n: every parked point is selected, ties at 1e6
])
def test_exact_knn_matches_jax(n, k, radius, p_valid):
    """exact=True against the jitted JAX kNN (the JAX driver's rounding of
    d2; the eager call rounds the column norms otherwise): indices exactly
    JAX's `lax.top_k(-d2)` picks (ties to the lower index among parked
    points), distances sqrt(max(d2, 0)) within 1e-6 and nondecreasing,
    validity exactly, offsets within 1e-7."""
    pts, valid, _ = _surface(n, seed=n, p_valid=p_valid)
    jn = jknn(jnp.asarray(pts), jnp.asarray(valid), radius, k, exact=True)
    tn = tnb.knn_radius_neighbors(t(pts), t(valid), radius, k, exact=True)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    np.testing.assert_allclose(tn.dist.numpy(), np.asarray(jn.dist), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tn.rel.numpy(), np.asarray(jn.rel), atol=1e-7, rtol=0)
    assert np.all(np.diff(tn.dist.numpy(), axis=-1) >= 0)
    if k > 24:   # queries whose k exceeds their in-radius neighbours
        assert (tn.valid.numpy()[valid].sum(-1) < k).any()
    if k == n:   # every parked point picked by every valid query
        assert np.isin(np.flatnonzero(~valid), tn.idx.numpy()[valid]).all()


def test_compute_cshot_matches_jax():
    """CSHOT-1344 on the JAX package's neighbours, from its kNN jitted as the
    JAX driver runs it (the eager call picks other neighbours on some rows),
    and normals: the 352 shape values and the 992 colour values as one unit
    vector, atol 5e-4 (the frontend test's SHOT tolerance; the cube root and
    the 3x3 colour product round differently in the last ulp); CIELAB
    within 1e-4."""
    pts, valid, colors = _surface()
    jn = jknn(jnp.asarray(pts), jnp.asarray(valid), 0.02, 24)
    tn = tnb.knn_radius_neighbors(t(pts), t(valid), 0.02, 24)
    normals = jnorm.estimate_normals(jnp.asarray(pts), jn)
    want = np.asarray(jshot.compute_cshot(jnp.asarray(pts), jnp.asarray(colors), normals, jn, 0.02))
    got = tshot.compute_cshot(t(pts), t(colors), t(np.asarray(normals)), tn, 0.02).numpy()
    assert got.shape == (400, tshot.CSHOT_DIM) == (400, 1344)
    assert (tshot.N_COLOR_BINS, tshot.CSHOT_DIM) == (jshot.N_COLOR_BINS, jshot.CSHOT_DIM)
    np.testing.assert_allclose(got, want, atol=5e-4)
    norms = np.linalg.norm(got, axis=-1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(tshot._rgb_to_cielab(t(colors)).numpy(),
                               np.asarray(jshot._rgb_to_cielab(jnp.asarray(colors))), atol=1e-4)


def test_compute_cshot_features_matches_jax():
    """The one-call form (the kNN, normals, CSHOT) against the JAX function
    jitted, the rounding of the JAX driver's graphs (eagerly its kNN picks
    other neighbours on some rows): normals atol 1e-4 and CSHOT atol 5e-4,
    as the frontend test holds normals and SHOT; the shape half equals
    `compute_shot` on the same inputs up to the joint norm."""
    pts, valid, colors = _surface(seed=3)
    wd, wn = jcshot_features(jnp.asarray(pts), jnp.asarray(colors), jnp.asarray(valid), 0.02, k=24)
    gd, gn = tshot.compute_cshot_features(t(pts), t(colors), t(valid), 0.02, k=24)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-4)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=5e-4)
    tn = tnb.knn_radius_neighbors(t(pts), t(valid), 0.02, 24)
    shape = tshot.compute_shot(t(pts), gn, tn, 0.02).numpy()
    half = gd.numpy()[:, :352]
    hn = np.linalg.norm(half, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.where(hn > 0, half / np.maximum(hn, 1e-12), 0), shape, atol=1e-5)


def test_compute_shot_features_exact_matches_jax():
    """compute_shot_features(exact=True) against the JAX function jitted, as
    the JAX driver runs it (eagerly its kNN rounds d2 otherwise): normals
    atol 1e-4, SHOT atol 5e-4."""
    pts, valid, _ = _surface(seed=4)
    wd, wn = jshot_features(jnp.asarray(pts), jnp.asarray(valid), 0.02, k=24, exact=True)
    gd, gn = tshot.compute_shot_features(t(pts), t(valid), 0.02, k=24, exact=True)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-4)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=5e-4)


def _frame(h=64, w=80, seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    mask = ((xs - 38) ** 2 + (ys - 30) ** 2) < 20 ** 2
    bump = 0.02 * np.cos((xs - 38) / 12.0) * np.cos((ys - 30) / 12.0)
    depth = np.where(mask, 0.5 - bump + rng.normal(0, 3e-4, (h, w)), 0).astype(np.float32)
    return depth, mask


@pytest.mark.parametrize("crop", [None, 48])
def test_preprocess_frame_exact_knn(crop):
    """preprocess_frame(exact_knn=True) against JAX's (jitted) with the same
    voxel draws: cloud, validity, count and pixels exact. Normals and SHOT
    at the frontend test's tolerances (normals all within 1e-5; SHOT 85% of
    rows within 1e-5, all within 2e-3), both against the jitted JAX
    function `preprocess_frame` calls, `compute_shot_features(exact=True)`,
    on that cloud, and against JAX's `preprocess_frame` itself (measured:
    normals 1.9e-6, SHOT 4.8e-4 at most). Both JAX graphs round the
    exact route's d2 as the port does; the function called eagerly rounds
    the column norms otherwise, and its SHOT differed from the jitted
    graph's by 6.9e-4 at the 85% quantile (the exact route's distance is
    the root of a cancelling sum, so one ulp of d2 moves it)."""
    depth, mask = _frame()
    key = jax.random.key(5)
    want = jfront.preprocess_frame(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(REAL275_K),
                                   key, res=2e-3, n_max=512, shot_k=24, crop=crop, exact_knn=True)
    hw = tfront.window_shape(depth.shape, crop)
    n = hw[0] * hw[1]
    perm = np.asarray(jax.random.permutation(key, n))
    prio = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (n,)))
    got = tfront.preprocess_frame(t(depth), t(mask), t(REAL275_K), t(perm), t(prio), res=2e-3,
                                  n_max=512, shot_k=24, crop=crop, exact_knn=True)
    assert int(got.count) == int(want.count) and int(got.count) > 300
    np.testing.assert_array_equal(got.pc.numpy(), np.asarray(want.pc))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.pixel_yx.numpy(), np.asarray(want.pixel_yx))
    shot, normal = jshot_features(want.pc, want.valid, 2e-3 * 10, k=24, exact=True)
    err_n = np.abs(got.normal.numpy() - np.asarray(normal)).max(-1)
    err_s = np.abs(got.shot.numpy() - np.asarray(shot)).max(-1)
    assert err_n.max() < 1e-5
    assert np.quantile(err_s, 0.85) < 1e-5 and err_s.max() < 2e-3
    err_p = np.abs(got.shot.numpy() - np.asarray(want.shot)).max(-1)
    err_pn = np.abs(got.normal.numpy() - np.asarray(want.normal)).max(-1)
    assert err_pn.max() < 1e-5
    assert np.quantile(err_p, 0.85) < 1e-5 and err_p.max() < 2e-3
