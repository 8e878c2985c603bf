"""Branch MLPs and the weight-carry function against the JAX package."""

import jax
import numpy as np
import pytest
import torch

from cppf2_torch.models.cppf import DinoBranch as TDino
from cppf2_torch.models.cppf import ShotBranch as TShot
from cppf2_torch.models.porting import load_branch
from cppf2_tpu.models import DinoBranch as JDino
from cppf2_tpu.models import ShotBranch as JShot

N, T = 64, 50


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(N, 3)) * 0.05).astype(np.float32)
    shot = rng.uniform(size=(N, 352)).astype(np.float32)
    nrm = rng.normal(size=(N, 3)).astype(np.float32)
    desc = rng.normal(size=(N, 1024)).astype(np.float32)
    ti = rng.integers(0, N, size=(T, 5)).astype(np.int32)
    return pts, shot, nrm, desc, ti


def _run(branch, dtype):
    pts, shot, nrm, desc, ti = _inputs()
    jdt = "float32" if dtype == "float32" else "bfloat16"
    tdt = getattr(torch, dtype)
    if branch == "shot":
        jm = JShot(dtype=jdt)
        params = jm.init(jax.random.key(0), pts, shot, nrm, ti)
        want = jm.apply(params, pts, shot, nrm, ti)
        tm = load_branch(TShot(compute_dtype=tdt), jax.device_get(params))
        got = tm(*(torch.from_numpy(x) for x in (pts, shot, nrm, ti)))
    else:
        jm = JDino(dtype=jdt)
        params = jm.init(jax.random.key(1), pts, desc, ti)
        want = jm.apply(params, pts, desc, ti)
        tm = load_branch(TDino(compute_dtype=tdt), jax.device_get(params))
        got = tm(*(torch.from_numpy(x) for x in (pts, desc, ti)))
    return got, want


def _pairs(got, want):
    for g, w in ((got.logits, want.logits), (got.scales, want.scales)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape
        yield g, w, float(np.abs(w).max())


@pytest.mark.parametrize("branch", ["shot", "dino"])
def test_branch_f32(branch):
    """f32: the same products summed in another order. Random-init outputs
    reach |x| ~ 40, so the bound is relative to that scale: 5e-6 * max|x|."""
    for g, w, scale in _pairs(*_run(branch, "float32")):
        np.testing.assert_allclose(g, w, atol=5e-6 * scale, rtol=0)


@pytest.mark.parametrize("branch", ["shot", "dino"])
def test_branch_bf16(branch):
    """bf16 compute like flax Dense(dtype=bf16): each layer rounds to bf16
    (8 significant bits) and a 1-ulp flip carries through ~15 more layers,
    so the bound is 5 bf16 ulps of the largest output (0.02 * max|x|), with
    the mean error under half an ulp (0.002 * max|x|)."""
    for g, w, scale in _pairs(*_run(branch, "bfloat16")):
        np.testing.assert_allclose(g, w, atol=0.02 * scale, rtol=0)
        assert np.mean(np.abs(g - w)) < 0.002 * scale


def test_carry_rejects_wrong_shapes():
    pts, shot, nrm, _, ti = _inputs()
    params = jax.device_get(JShot().init(jax.random.key(0), pts, shot, nrm, ti))
    with pytest.raises(ValueError):
        load_branch(TShot(shot_dim=100), params)
