"""Port's config, core geometry, pair targets, voxel downsample, tuple
sampling and msgpack reader against the JAX package, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cppf2_torch.config as tconfig
import cppf2_tpu.config as jconfig
from cppf2_torch.core import binning as tbin
from cppf2_torch.core import downsample as tds
from cppf2_torch.core import geometry as tgeo
from cppf2_torch.core import pairs as tpairs
from cppf2_torch.models.checkpoints import load_params_msgpack as t_load_msgpack
from cppf2_torch.ops.sampling import masked_tuple_choice as t_tuple_choice
from cppf2_tpu.core import binning as jbin
from cppf2_tpu.core import downsample as jds
from cppf2_tpu.core import geometry as jgeo
from cppf2_tpu.core import pairs as jpairs
from cppf2_tpu.ops.sampling import masked_tuple_choice as j_tuple_choice

REAL275_K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
                     np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_config_copy_is_identical():
    """The port's config is a copy: same fields, defaults and categories."""
    assert [f.name for f in dataclasses.fields(tconfig.PipelineConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.PipelineConfig)]
    assert dataclasses.asdict(tconfig.PipelineConfig()) == dataclasses.asdict(jconfig.PipelineConfig())
    assert tconfig.PipelineConfig().sphere_samples == jconfig.PipelineConfig().sphere_samples
    assert set(tconfig.CATEGORIES) == set(jconfig.CATEGORIES)
    for name in jconfig.CATEGORIES:
        assert dataclasses.asdict(tconfig.CATEGORIES[name]) == dataclasses.asdict(jconfig.CATEGORIES[name])
    assert [f.name for f in dataclasses.fields(tconfig.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.TrainConfig)]
    assert dataclasses.asdict(tconfig.TrainConfig()) == dataclasses.asdict(jconfig.TrainConfig())


@pytest.mark.parametrize("circular", [False, True], ids=["linear", "circular"])
@pytest.mark.parametrize("num_bins", [32, 5])
def test_binning_codecs_match_jax(circular, num_bins):
    """real2prob / prob2real, atol 1e-6: values on bin edges, at both ends of
    the range and, circular, on both sides of the wrap."""
    rng = np.random.default_rng(num_bins)
    max_val = 2 * np.pi if circular else 1.0
    step = max_val / (num_bins if circular else num_bins - 1)
    val = np.concatenate([rng.uniform(0, max_val, (7, 9)).ravel(), [0.0, max_val, step, 3 * step,
                          step / 2, step / 2 - 1e-4, max_val - step / 2, max_val - 1e-5]]).astype(np.float32)
    want = np.array(jbin.real2prob(jnp.asarray(val), max_val, num_bins, circular))
    got = tbin.real2prob(t(val), max_val, num_bins, circular).numpy()
    assert got.shape == want.shape == (len(val), num_bins)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    prob = rng.dirichlet(np.ones(num_bins), size=20).astype(np.float32)
    for p in (prob, want):
        np.testing.assert_allclose(tbin.prob2real(t(p), max_val, num_bins, circular).numpy(),
                                   np.asarray(jbin.prob2real(jnp.asarray(p), max_val, num_bins, circular)),
                                   atol=1e-6)
    if not circular:   # the linear codec inverts itself; the circular mean of two bins does not
        np.testing.assert_allclose(tbin.prob2real(t(got), max_val, num_bins).numpy(), val, atol=2e-5)


def _depth_frame(rng, h=48, w=64):
    ys, xs = np.mgrid[0:h, 0:w]
    mask = (xs - w / 2) ** 2 + (ys - h / 2) ** 2 < (h / 3) ** 2
    depth = np.where(mask, 0.8 + 0.01 * rng.normal(size=(h, w)), 0.0).astype(np.float32)
    return depth, mask


def test_backproject_masked_exact():
    """Exact (tolerance 0): the points feed voxel keys, where one ulp can move a point."""
    depth, mask = _depth_frame(np.random.default_rng(0))
    jp, jpix, jv = jgeo.backproject_masked(jnp.asarray(depth), jnp.asarray(REAL275_K), jnp.asarray(mask))
    tp, tpix, tv = tgeo.backproject_masked(t(depth), t(REAL275_K), t(mask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_fibonacci_and_quat():
    np.testing.assert_array_equal(tgeo.fibonacci_sphere(500), jgeo.fibonacci_sphere(500))
    q = np.array([0.1, -0.4, 0.3, 0.8], np.float32)
    np.testing.assert_allclose(tgeo.quat_to_matrix(t(q)).numpy(),
                               np.asarray(jgeo.quat_to_matrix(jnp.asarray(q))), atol=1e-6)


def test_pair_targets():
    """f32 elementwise algorithm: atol 1e-6 on unit-scale geometry (acos near 0 and pi amplifies ulps)."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(300, 3)).astype(np.float32) for _ in range(2))
    c = rng.normal(size=3).astype(np.float32)
    axes = [np.eye(3, dtype=np.float32)[i] for i in (1, 0, 2)]
    jt = jpairs.pair_targets(*(jnp.asarray(x) for x in (a, b, *axes, c)))
    tt = tpairs.pair_targets(*(t(x) for x in (a, b, *axes, c)))
    for x, y in zip(tt, jt):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    assert tpairs._comb_indices(5) == jpairs._comb_indices(5)


@pytest.mark.parametrize("n,m_max", [(3072, 256), (3072, 4096)])
def test_voxel_downsample_exact_under_injected_draws(n, m_max):
    """Exact indices with the reference's own permutation and priorities."""
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(n, 3)) * 0.03).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    key = jax.random.key(7)
    want = jds.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), 4e-3, m_max, key)
    perm = np.asarray(jax.random.permutation(key, n))
    prio = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (n,)))
    got = tds.voxel_downsample(t(pts), t(valid), 4e-3, m_max, t(perm), t(prio))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.count) == int(want.count)


def test_masked_tuple_choice_from_reference_uniforms():
    key = jax.random.key(3)
    want = np.asarray(j_tuple_choice(key, jnp.int32(437), 1000, 5))
    u = np.asarray(jax.random.uniform(key, (1000, 5)))
    got = t_tuple_choice(t(u), torch.tensor(437)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("branch", ["shot", "dino"])
def test_msgpack_reader_matches_flax(branch):
    """Array for array against the flax loader on the shipped mug checkpoints."""
    from cppf2_tpu.models import DinoBranch, ShotBranch
    from cppf2_tpu.train.checkpoints import load_params_msgpack

    path = f"ckpts_r3/{branch}/mug/params.msgpack"
    i0 = jnp.zeros((8, 5), jnp.int32)
    pc0 = jnp.zeros((16, 3))
    if branch == "shot":
        tmpl = ShotBranch().init(jax.random.key(0), pc0, jnp.zeros((16, 352)), jnp.zeros((16, 3)), i0)
    else:
        tmpl = DinoBranch().init(jax.random.key(1), pc0, jnp.zeros((16, 1024)), i0)
    want = load_params_msgpack(path, tmpl)
    got = t_load_msgpack(path)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_flat = {tuple(k): v for k, v in _flatten(got)}
    assert len(want_leaves) == len(got_flat)
    for kp, leaf in want_leaves:
        k = tuple(p.key for p in kp)
        np.testing.assert_array_equal(got_flat[k], np.asarray(leaf))
        assert got_flat[k].dtype == np.asarray(leaf).dtype


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_msgpack_reader_scalars_and_errors():
    from flax import serialization

    from cppf2_torch.models.checkpoints import loads_msgpack

    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": {"c": np.float32(2.5),
            "d": np.ones((0, 4), np.float16)}}
    got = loads_msgpack(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["b"]["c"] == np.float32(2.5)
    assert got["b"]["d"].shape == (0, 4) and got["b"]["d"].dtype == np.float16
    with pytest.raises(ValueError):
        loads_msgpack(serialization.msgpack_serialize(tree)[:-3])


def test_device_default_is_cuda_and_never_falls_back():
    from cppf2_torch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
