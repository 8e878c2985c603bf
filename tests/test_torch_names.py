"""The public names the port took over last, against the JAX package:
farthest point sampling and masked choice, `matrix_to_quat`, `so3_exp`,
`tuple_pairwise_diffs`, `iou_sampling` and the `Box` helpers,
`fetch_rt_pair(s)`, and the packages' `__all__` exports."""

import importlib
import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.core import geometry as tgeo
from cppf2_torch.core import pairs as tpairs
from cppf2_torch.eval import iou3d as tiou
from cppf2_torch.eval import pose_errors as tpe
from cppf2_torch.ops import sampling as tsamp
from cppf2_tpu.core import geometry as jgeo
from cppf2_tpu.core import pairs as jpairs
from cppf2_tpu.eval import iou3d as jiou
from cppf2_tpu.eval import pose_errors as jpe
from cppf2_tpu.ops import sampling as jsamp


def _cloud(n=300, seed=0, p_valid=0.8):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * np.array([0.1, 0.05, 0.02], np.float32)
    valid = rng.uniform(size=n) < p_valid
    return pts, valid


@pytest.mark.parametrize("m,start,p_valid", [(64, 0, 0.8), (40, 5, 0.8), (30, 3, 0.05),
                                             (8, 0, 0.0)])
def test_farthest_point_sample_matches_jax(m, start, p_valid):
    """The picks equal JAX's exactly: an invalid start moves to the first
    valid index, fewer valid points than m repeat, an all-invalid cloud
    gives m zeros."""
    pts, valid = _cloud(seed=m, p_valid=p_valid)
    if p_valid > 0.5:
        valid[start] = start != 5   # start 5 is invalid: the seed moves
    want = np.asarray(jsamp.farthest_point_sample(jnp.asarray(pts), jnp.asarray(valid), m, start))
    got = tsamp.farthest_point_sample(torch.from_numpy(pts), torch.from_numpy(valid), m, start)
    assert got.dtype == torch.int64 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    if valid.any():
        assert valid[got.numpy()].all()


def test_masked_choice_matches_jax():
    """floor(u * count) of JAX's own uniforms equals JAX's picks exactly; a
    generator draws m of them on its device."""
    key = jax.random.key(3)
    count = jnp.int32(137)
    want = np.asarray(jsamp.masked_choice(key, count, 500))
    u = np.array(jax.random.uniform(key, (500,)))
    got = tsamp.masked_choice(torch.from_numpy(u), torch.tensor(137))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tsamp.masked_choice(torch.Generator().manual_seed(0), torch.tensor(137), 1000)
    assert drawn.shape == (1000,) and int(drawn.min()) >= 0 and int(drawn.max()) < 137
    with pytest.raises(ValueError, match="m"):
        tsamp.masked_choice(torch.Generator(), torch.tensor(3))


def _rotations(seed=0, n=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rots = [np.asarray(jgeo.quat_to_matrix(jnp.asarray(x, jnp.float32))) for x in q]
    # 180-degree flips, where w = 0 and the antisymmetric part vanishes
    for axis in ([1, -1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 0], [1, -1, 1]):
        a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        rots.append((2 * np.outer(a, a) - np.eye(3)).astype(np.float32))
    rots.append(np.eye(3, dtype=np.float32))
    return rots


def test_matrix_to_quat_matches_jax():
    """The quaternion of each rotation equals JAX's within 1e-6 (sign
    included), the 180-degree flips about (1, -1, 0) and (1, 1, 0) among
    them, and maps back to the rotation within 1e-5."""
    for r in _rotations():
        want = np.asarray(jgeo.matrix_to_quat(jnp.asarray(r)))
        got = tgeo.matrix_to_quat(torch.from_numpy(r))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_allclose(tgeo.quat_to_matrix(got).numpy(), r, atol=1e-5)
    flip = (2 * np.outer([1, -1, 0], [1, -1, 0]) / 2 - np.eye(3)).astype(np.float32)
    q = tgeo.matrix_to_quat(torch.from_numpy(flip)).numpy()
    assert np.sign(q[0]) == -np.sign(q[1]) and abs(q[3]) < 1e-6


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-7, 0.0, 3.0])
def test_so3_exp_matches_jax(scale):
    """Rodrigues' map against JAX's within 1e-6, including the Taylor
    branch below theta = 1e-6 and theta = 0; the result is a rotation."""
    rng = np.random.default_rng(1)
    for _ in range(10):
        w = (rng.normal(size=3) * scale).astype(np.float32)
        want = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
        got = tgeo.so3_exp(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)


def test_tuple_pairwise_diffs_matches_jax():
    """Exactly JAX's differences, pairs in itertools.combinations order."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    idx = rng.integers(0, 50, size=(20, 5)).astype(np.int32)
    want = np.asarray(jpairs.tuple_pairwise_diffs(jnp.asarray(pts), jnp.asarray(idx)))
    got = tpairs.tuple_pairwise_diffs(torch.from_numpy(pts), torch.from_numpy(idx).long()).numpy()
    assert got.shape == (20, 10 * 3)
    np.testing.assert_array_equal(got, want)
    i, j = list(itertools.combinations(range(5), 2))[3]
    np.testing.assert_array_equal(got[:, 9:12], pts[idx[:, i]] - pts[idx[:, j]])


def _box(seed):
    rng = np.random.default_rng(seed)
    r = np.asarray(jgeo.quat_to_matrix(jnp.asarray(rng.normal(size=4), jnp.float32)), np.float64)
    return r, rng.normal(size=3) * 0.02, rng.uniform(0.05, 0.2, size=3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_sampling_and_box_helpers_match_jax(seed):
    """iou_sampling equals JAX's exactly (the same numpy stream); Box's
    vertices, fit and from_transformation as JAX's."""
    b1, b2 = (_box(seed), _box(seed + 10))
    want = jiou.iou_sampling(jiou.Box(*b1), jiou.Box(*b2), num_samples=4000, seed=seed)
    got = tiou.iou_sampling(tiou.Box(*b1), tiou.Box(*b2), num_samples=4000, seed=seed)
    assert got == want
    tb = tiou.Box.from_transformation(*b1)
    np.testing.assert_array_equal(tb.vertices, jiou.Box(*b1).vertices)
    fit_t, fit_j = tiou.Box.fit(tb.vertices), jiou.Box.fit(tb.vertices)
    for attr in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(fit_t, attr), getattr(fit_j, attr), atol=1e-12)
    # the float32 rotation is orthonormal to 1e-7, so the fit recovers the box to that
    np.testing.assert_allclose(fit_t.scale, b1[2], atol=1e-6)
    np.testing.assert_allclose(fit_t.translation, b1[1], atol=1e-6)


class _Est(NamedTuple):
    rotation: object
    translation: object
    scale: object
    scale_norm: object
    pick: object


class _Frame(NamedTuple):
    rotation: object
    translation: object
    scale_norm: object
    bound: object


def _est(rng, to):
    r = np.asarray(jgeo.quat_to_matrix(jnp.asarray(rng.normal(size=4), jnp.float32)))
    return _Est(to(r), to(rng.normal(size=3).astype(np.float32)),
                to(rng.uniform(0.05, 0.2, size=3).astype(np.float32)), to(np.float32(0.17)),
                to(np.int32(rng.integers(0, 2))))


def test_fetch_rt_pair_matches_jax(monkeypatch):
    """fetch_rt_pair / fetch_rt_pairs on the same values as JAX's: equal
    matrices, scales and extras (dtype kept), with one copy to the host
    per call; a SynthFrame-like frame; extras_per_est of the wrong length
    raises."""
    rng = np.random.default_rng(4)
    ests_np = [_est(np.random.default_rng(s), np.asarray) for s in range(3)]
    ests_t = [_Est(*[torch.from_numpy(np.array(x)) for x in e]) for e in ests_np]
    gt = _est(rng, np.asarray)
    frame_np = _Frame(gt.rotation, gt.translation, np.float32(0.21),
                      rng.uniform(0.1, 0.3, size=3).astype(np.float32))
    frame_t = _Frame(*[torch.from_numpy(np.array(x)) for x in frame_np])
    want = jpe.fetch_rt_pair(ests_np[0], frame_np, extras=(ests_np[0].pick,))
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: copies.append(1) or real_cpu(self, *a, **k))
    got = tpe.fetch_rt_pair(ests_t[0], frame_t, extras=(ests_t[0].pick,))
    assert len(copies) == 1
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert np.asarray(got[4]).dtype == np.int32
    extras = [(e.pick,) for e in ests_np[:2]] + [()]
    want_all = jpe.fetch_rt_pairs(ests_np, frame_np, extras)
    copies.clear()
    got_all = tpe.fetch_rt_pairs(ests_t, frame_t, [(e.pick,) for e in ests_t[:2]] + [()])
    assert len(copies) == 1 and len(got_all) == len(want_all) == 3
    for g_row, w_row in zip(got_all, want_all):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="extras_per_est"):
        tpe.fetch_rt_pairs(ests_t, frame_t, [()])
    gt = tpe._assemble_gt(*frame_np)
    for g, w in zip(gt, jpe._assemble_gt(*frame_np)):
        np.testing.assert_array_equal(g, w)


def test_fetch_rt_pair_takes_a_synth_frame():
    """The port's SynthFrame carries the four fields fetch_rt_pair reads."""
    from cppf2_torch.data.synthetic import SynthFrame

    assert {"rotation", "translation", "scale_norm", "bound"} <= set(SynthFrame._fields)


@pytest.mark.parametrize("pkg", ["core", "infer", "ops", "models", "eval", "data", "utils",
                                 "parallel", "train"])
def test_every_exported_name_exists_in_the_port(pkg):
    """Each name of the JAX subpackage's `__all__` is in the port's
    `__all__` of the same subpackage and resolves to an object."""
    jmod = importlib.import_module(f"cppf2_tpu.{pkg}")
    tmod = importlib.import_module(f"cppf2_torch.{pkg}")
    missing = [n for n in jmod.__all__ if n not in tmod.__all__ or not hasattr(tmod, n)]
    assert not missing, missing


@pytest.mark.parametrize("module,names", [
    ("models.dinov2", ["quantize_vit_params", "masked_window_descriptors", "ViTConfig"]),
    ("models.layers", ["QDense"]),
    ("ops.shot", ["N_COLOR_BINS", "CSHOT_DIM", "_rgb_to_cielab", "compute_cshot",
                  "compute_cshot_features"]),
    ("ops.sampling", ["farthest_point_sample", "masked_choice"]),
    ("core.geometry", ["matrix_to_quat", "so3_exp"]),
    ("core.pairs", ["tuple_pairwise_diffs"]),
    ("eval.iou3d", ["iou_sampling", "pairwise_iou_matrix"]),
    ("eval.pose_errors", ["fetch_rt_pair", "fetch_rt_pairs", "_assemble_gt"]),
    ("data.converters", ["convert_wild6d", "convert_phocal", "PHOCAL_CLASS2NOCS"]),
    ("native", ["load"]),
])
def test_names_the_port_took_over(module, names):
    """The names of the last slice, under the JAX names, in both packages;
    the config fields `quant` and `attn_chunk` with the JAX defaults."""
    jmod = importlib.import_module(f"cppf2_tpu.{module}")
    tmod = importlib.import_module(f"cppf2_torch.{module}")
    for n in names:
        if n != "QDense":
            assert hasattr(jmod, n), n
        assert hasattr(tmod, n), n
    if module == "models.dinov2":
        from cppf2_torch.models import dinov2
        from cppf2_tpu.models import dinov2 as jd

        for field in ("quant", "attn_chunk"):
            assert getattr(dinov2.ViTConfig(), field) == getattr(jd.ViTConfig(), field)
