"""Kernel K3 (`cppf2_torch.ops.sphere`) and the port's sampled rotation votes
against the JAX package.

The plain version of K3 against `sphere_accumulate_pallas` in interpret mode;
`vote_rotation` and `sphere_vote` against their JAX counterparts. On the CPU
the wrapper takes its plain version, which is what runs here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.core.geometry import fibonacci_sphere
from cppf2_torch.ops import _build, sphere, voting
from cppf2_tpu.ops import voting as jvoting
from cppf2_tpu.ops.pallas_kernels import sphere_accumulate_pallas

SPHERE = fibonacci_sphere(720)  # the 1-degree production sphere


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _clustered_votes(rng, v, centers, spread_deg):
    """Half uniform directions, half within `spread_deg` of sphere points."""
    dirs = _unit(rng.normal(size=(v, 3)))
    near = rng.integers(0, len(centers), v // 2)
    jitter = rng.normal(size=(v // 2, 3)) * np.deg2rad(spread_deg)
    dirs[: v // 2] = _unit(centers[near] + jitter)
    return dirs


@pytest.mark.parametrize("tol", [1.0, 5.0])
def test_plain_matches_pallas(tol):
    """Random unit dirs and weights on the 720-point sphere. Votes within 1e-6
    of the threshold are dropped (the Pallas cosine is a dot product that
    may round otherwise); the rest hit the same points, and the counts
    differ only in the order of summation: rtol 1e-5."""
    rng = np.random.default_rng(int(tol))
    dirs = _clustered_votes(rng, 3000, SPHERE[rng.integers(0, 720, 5)], tol)
    w = rng.uniform(size=3000).astype(np.float32)
    t = sphere.threshold(tol)
    keep = np.min(np.abs(dirs.astype(np.float64) @ SPHERE.T.astype(np.float64) - t), axis=1) > 1e-6
    dirs, w = dirs[keep], w[keep]
    want = np.asarray(sphere_accumulate_pallas(jnp.asarray(dirs), jnp.asarray(w), jnp.asarray(SPHERE),
                                               tol, interpret=True))
    got = sphere.sphere_accumulate(torch.from_numpy(dirs)[None], torch.from_numpy(w)[None],
                                   torch.from_numpy(SPHERE), tol)
    assert got.shape == (1, 720) and want.max() > 100
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("tol", [0.5, 1.0, 3.0, 5.0, 10.0])
def test_threshold_is_jax_float32_cosine(tol):
    assert sphere.threshold(tol) == float(jnp.cos(2 * tol / 180.0 * jnp.pi))


def test_batch_rows_are_independent_calls():
    """A (3, V) batch gives each row's B = 1 counts bit for bit, 0/1 weights
    give integer counts, and the CPU path launches nothing."""
    rng = np.random.default_rng(7)
    dirs = np.stack([_clustered_votes(rng, 2000, SPHERE[rng.integers(0, 720, 3)], 1.0)
                     for _ in range(3)])
    w = (rng.uniform(size=(3, 2000)) < 0.8).astype(np.float32)
    before = _build.launched("sphere")
    batch = sphere.sphere_accumulate(torch.from_numpy(dirs), torch.from_numpy(w),
                                     torch.from_numpy(SPHERE), 1.0)
    for i in range(3):
        row = sphere.sphere_accumulate(torch.from_numpy(dirs[i:i + 1]), torch.from_numpy(w[i:i + 1]),
                                       torch.from_numpy(SPHERE), 1.0)
        torch.testing.assert_close(batch[i:i + 1], row, atol=0, rtol=0)
    assert torch.equal(batch, torch.round(batch)) and float(batch.max()) > 50
    assert _build.launched("sphere") == before


def test_wrapper_checks_inputs():
    d, w, s = torch.zeros(1, 4, 3), torch.zeros(1, 4), torch.from_numpy(SPHERE)
    with pytest.raises(ValueError):
        sphere.sphere_accumulate(d.double(), w, s, 1.0)
    with pytest.raises(ValueError):
        sphere.sphere_accumulate(d, torch.zeros(1, 5), s, 1.0)
    with pytest.raises(ValueError):
        sphere.sphere_accumulate(d[0], w, s, 1.0)
    with pytest.raises(ValueError):
        sphere.sphere_accumulate(d, w, s[:0], 1.0)


def test_vote_rotation_matches_jax():
    """Dirs within atol 1e-6 (the same elementwise expression), masks exact;
    angles on both sides of pi/2 and a few zero-length pairs."""
    rng = np.random.default_rng(11)
    pts = (rng.normal(size=(200, 3)) * 0.05).astype(np.float32)
    idx = rng.integers(0, 200, size=(300, 2)).astype(np.int32)
    idx[:5, 1] = idx[:5, 0]
    valid = rng.uniform(size=300) > 0.1
    ang = rng.uniform(0.05, np.pi - 0.05, 300).astype(np.float32)
    jd, jw = jvoting.vote_rotation(jnp.asarray(pts), jnp.asarray(ang), jnp.asarray(idx),
                                   jnp.asarray(valid), num_rots=36)
    td, tw = voting.vote_rotation(torch.from_numpy(pts), torch.from_numpy(ang),
                                  torch.from_numpy(idx).long(), torch.from_numpy(valid), num_rots=36)
    assert td.shape == (300 * 36, 3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert not tw[:36 * 5].any()


def test_sphere_vote_matches_jax(monkeypatch):
    """Three clusters of votes within 0.5 deg of three sphere points, with
    masses about 3:2:1, over uniform noise: the same top-3 indices. JAX's CPU
    dot rounds its bf16 x bf16 -> f32 output to bf16, so the counts agree
    within bf16 rounding (rtol 2^-8). The port's counts are the plain
    accumulation of the bf16-rounded weights, through the module's K3."""
    rng = np.random.default_rng(5)
    peaks = np.array([100, 400, 650])
    mass = [3000, 2000, 1000]
    parts = [_unit(SPHERE[p] + rng.normal(size=(m, 3)) * np.deg2rad(0.25))
             for p, m in zip(peaks, mass)]
    dirs = np.concatenate(parts + [_unit(rng.normal(size=(4000, 3)))])
    w = rng.uniform(0.5, 2.0, len(dirs)).astype(np.float32)
    jdirs, jvals = jvoting.sphere_vote(jnp.asarray(dirs), jnp.asarray(w), jnp.asarray(SPHERE), 1.0,
                                       topk=3)
    calls = []
    real = sphere.sphere_accumulate

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(sphere, "sphere_accumulate", spy)
    tdirs, tvals = voting.sphere_vote(torch.from_numpy(dirs), torch.from_numpy(w),
                                      torch.from_numpy(SPHERE), 1.0, topk=3)
    assert calls == [(1, len(dirs), 3)]
    np.testing.assert_array_equal(tdirs.numpy(), SPHERE[peaks])
    np.testing.assert_array_equal(tdirs.numpy(), np.asarray(jdirs))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=2.0 ** -8)
    w_bf16 = torch.from_numpy(w).bfloat16().float()
    want = sphere.sphere_accumulate_plain(torch.from_numpy(dirs)[None], w_bf16[None],
                                          torch.from_numpy(SPHERE), 1.0)[0]
    torch.testing.assert_close(tvals, want[torch.from_numpy(peaks)], atol=0, rtol=0)


@pytest.mark.gpu
def test_sphere_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (the card run of
    chip_smoke.py checks the production shapes): 0/1 weights exact, f32
    weights within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from cppf2_torch import resolve_device

    dev = resolve_device("cuda")
    rng = np.random.default_rng(9)
    dirs = torch.from_numpy(np.stack([_clustered_votes(rng, 50000, SPHERE[rng.integers(0, 720, 4)], 1.0)
                                      for _ in range(2)])).to(dev)
    sph = torch.from_numpy(SPHERE).to(dev)
    for w in ((torch.rand(2, 50000, device=dev) < 0.7).float(), torch.rand(2, 50000, device=dev)):
        got = sphere.sphere_accumulate(dirs, w, sph, 1.0)
        want = sphere.sphere_accumulate_plain(dirs, w, sph, 1.0)
        torch.testing.assert_close(got, want, atol=0, rtol=1e-5)
