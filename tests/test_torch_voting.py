"""Pose-graph stages against the JAX package on the same inputs: the center
pyramid (through K2's plain version), the noisy-pair filter, the
closed-form cone votes, the Adam alignment and the yaw sweep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.core.geometry import fibonacci_sphere
from cppf2_torch.infer import alignment as talign
from cppf2_torch.ops import voting as tvote
from cppf2_tpu.core.pairs import pair_targets as j_pair_targets
from cppf2_tpu.infer import alignment as jalign
from cppf2_tpu.ops import voting as jvote

N, P = 600, 3000
CENTER = np.array([0.03, -0.02, 0.7], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed=0, noise=0.002):
    """A 6 cm sphere shell around CENTER, random pairs, and (proj_len, odist)
    predictions: the true targets plus noise, a fifth of them garbage."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (CENTER + 0.06 * d).astype(np.float32)
    valid = np.ones(N, bool)
    valid[-20:] = False
    pts[-20:] = 0
    pair_idx = rng.integers(0, N - 20, size=(P, 2)).astype(np.int32)
    eye = jnp.eye(3)
    tgt = j_pair_targets(jnp.asarray(pts[pair_idx[:, 0]]), jnp.asarray(pts[pair_idx[:, 1]]),
                         eye[1], eye[0], eye[2], jnp.asarray(CENTER))
    tr = np.asarray(tgt.tr) + rng.normal(0, noise, size=(P, 2))
    bad = rng.uniform(size=P) < 0.2
    tr[bad] = rng.uniform(0, 0.1, size=(bad.sum(), 2))
    pair_valid = rng.uniform(size=P) < 0.95
    return pts, valid, pair_idx, tr.astype(np.float32), pair_valid


@pytest.mark.parametrize("levels,fine", [(4, 8), (3, 12)])
def test_vote_center(levels, fine):
    """Center exact or within one fine cell (res 2 mm): the arc samples go
    through cos/sin/atan2, whose last ulp differs between XLA and PyTorch,
    and a vote on a cell boundary can move. Peak count within 1% of itself."""
    pts, valid, pair_idx, tr, pv = _scene()
    res = 2e-3
    want = jvote.vote_center(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(tr),
                             jnp.asarray(pair_idx), jnp.asarray(pv), res,
                             levels=levels, fine_samples=fine)
    got = tvote.vote_center(t(pts), t(valid), t(tr), t(pair_idx).long(), t(pv), res,
                            levels=levels, fine_samples=fine)
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center), atol=res + 1e-6)
    assert abs(float(got.peak_count) - float(want.peak_count)) <= 0.01 * float(want.peak_count)
    np.testing.assert_allclose(got.center.numpy(), CENTER, atol=4e-3)


def test_vote_center_goes_through_the_fused_level(monkeypatch):
    """Every level of vote_center is one call of K2's fused entry, which gets
    per-pair quantities and a sample table and never a candidate array; the
    result equals the pyramid written with candidate arrays and
    hist16_peak, exactly."""
    from cppf2_torch.ops import hist16

    pts, valid, pair_idx, tr, pv = _scene(seed=3)
    args = (t(pts), t(valid), t(tr), t(pair_idx).long(), t(pv), 2e-3)
    seen = []

    def level(c, x0, y0, odist, ok, samples, lo, cell, theta_star=None, span=None):
        seen.append((c.shape[0], tuple(samples.shape), theta_star is not None))
        cand, ok_v = hist16.level_candidates(c, x0, y0, odist, ok, samples, theta_star, span)
        return hist16.hist16_peak(cand, ok_v, lo, cell)

    want = tvote.vote_center(*args, levels=4, fine_samples=8)
    monkeypatch.setattr(hist16, "hist16_level_peak", level)
    monkeypatch.setattr(hist16, "hist16_peak",
                        lambda cand, ok, lo, cell: _peak_by_numpy(cand, ok, lo, cell))
    got = tvote.vote_center(*args, levels=4, fine_samples=8)
    assert seen == [(P, (2, 16), False), (P, (16,), True), (P, (8,), True), (P, (8,), True)]
    torch.testing.assert_close(got.center, want.center, atol=0, rtol=0)
    assert float(got.peak_count) == float(want.peak_count)


def _peak_by_numpy(cand, ok, lo, cell):
    """The 16^3 histogram peak of (V, 3) candidates, first maximum, in numpy."""
    f = np.floor((cand.numpy() - lo.numpy()) / cell.numpy() + np.float32(0.5))
    inside = np.all((f >= 0) & (f < 16), -1) & ok.numpy()
    ids = f[inside].astype(np.int64)
    counts = np.bincount((ids[:, 0] * 16 + ids[:, 1]) * 16 + ids[:, 2], minlength=4096)
    best = int(np.argmax(counts))
    cell_id = np.array([best // 256, (best // 16) % 16, best % 16], np.float32)
    return torch.from_numpy(lo.numpy() + cell_id * cell.numpy()), torch.tensor(float(counts[best]))


@pytest.mark.parametrize("n", [8, 12, 16])
def test_vote_center_arc_table_within_one_ulp(n):
    """The arc-sample table against jnp.linspace: XLA contracts parts of its
    lerp into fused multiply-adds, so a few entries differ by one ulp."""
    np.testing.assert_allclose(tvote._linspace(n, "cpu").numpy(),
                               np.asarray(jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)),
                               atol=1.2e-7, rtol=0)


def test_backvote_filter():
    """The kept set compared as a set (top-k ties carry no order promise);
    weights atol 1e-6 (sums of exact counts / max count)."""
    pts, valid, pair_idx, tr, pv = _scene(1)
    c = CENTER + 1e-3
    want = jvote.backvote_filter(jnp.asarray(pts), jnp.asarray(tr), jnp.asarray(pair_idx),
                                 jnp.asarray(pv), jnp.asarray(c), 300, 0.01)
    got = tvote.backvote_filter(t(pts), t(tr), t(pair_idx).long(), t(pv), t(c), 300, 0.01)
    assert set(got.kept_idx.tolist()) == set(np.asarray(want.kept_idx).tolist())
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_allclose(got.pair_weight.numpy(), np.asarray(want.pair_weight), atol=1e-6)


@pytest.mark.parametrize("tol_deg", [5.0, 1.0])
def test_sphere_vote_cone(tol_deg):
    """Top-1 directions exact (the same sphere point); scores rtol 1e-4
    (a weighted sum of 300 arc fractions in another order)."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 0.05
    pair_idx = rng.integers(0, 200, size=(300, 2)).astype(np.int32)
    a, b = pts[pair_idx[:, 0]], pts[pair_idx[:, 1]]
    u = (a - b) / np.linalg.norm(a - b, axis=-1, keepdims=True)
    axes = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    ang = np.arccos(np.clip(u @ axes.T, -1, 1)).T.astype(np.float32)
    ang += rng.normal(0, 0.02, size=ang.shape).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=300).astype(np.float32)
    w[:20] = 0
    sph = fibonacci_sphere(int(4 * np.pi / (tol_deg / 180 * np.pi)))
    jd, js = jvote.sphere_vote_cone(jnp.asarray(pts), jnp.asarray(ang), jnp.asarray(pair_idx),
                                    jnp.asarray(w), jnp.asarray(sph), tol_deg, topk=1)
    td, ts = tvote.sphere_vote_cone(t(pts), t(ang), t(pair_idx).long(), t(w), t(sph), tol_deg)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[:, 0])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, 0], rtol=1e-4)


def _align_inputs(seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 0.05 + CENTER
    pair_idx = rng.integers(0, 300, size=(200, 2)).astype(np.int32)
    th = 0.3
    r_true = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                      np.float32)
    canon = (pts[pair_idx] - CENTER) @ r_true
    pred = (canon + rng.normal(0, 0.002, size=canon.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=200).astype(np.float32)
    w[:10] = 0
    r0 = np.array([[np.cos(th + 0.05), 0, np.sin(th + 0.05)], [0, 1, 0],
                   [-np.sin(th + 0.05), 0, np.cos(th + 0.05)]], np.float32)
    t0 = (CENTER + 0.004).astype(np.float32)
    return pts, pair_idx, w, pred, r0, t0


@pytest.mark.parametrize("up_sym", [False, True])
def test_align_pose(up_sym):
    """Adam from the same start. After 20 steps the two agree to float32
    noise (R atol 1e-5, T atol 1e-6 m). Near the L1 optimum Adam's steps
    flip with the gradient's sign, so float32 noise grows: after 100 steps
    R atol 2e-3 (0.1 deg), T atol 5e-5 m, loss rtol 1e-3."""
    pts, pair_idx, w, pred, r0, t0 = _align_inputs()

    def both(steps):
        want = jalign.align_pose(jnp.asarray(pts), jnp.asarray(pair_idx), jnp.asarray(w),
                                 jnp.asarray(pred), jnp.asarray(r0), jnp.asarray(t0), up_sym,
                                 1, steps, 1e-2)
        got = talign.align_pose(t(pts), t(pair_idx).long(), t(w), t(pred), t(r0), t(t0),
                                up_sym, 1, steps, 1e-2)
        return got, want

    got, want = both(20)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-6)
    got, want = both(100)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=2e-3)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=5e-5)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-3)


def test_yaw_sweep():
    """Same refined rotation (atol 1e-5): the sweep's argmin picks the same
    delta, and the weighted median takes the mean of the two middle values
    (torch.nanquantile) like jnp.nanmedian."""
    pts, pair_idx, w, pred, r0, t0 = _align_inputs(4)
    canon = pred.copy()
    canon[:30, :, 0] += 0.04        # a radial feature (a handle) on some pairs
    want = jalign.yaw_sweep(jnp.asarray(pts), jnp.asarray(pair_idx), jnp.asarray(w),
                            jnp.asarray(pred), jnp.asarray(canon / 0.2), jnp.asarray(r0),
                            jnp.asarray(t0), 1)
    got = talign.yaw_sweep(t(pts), t(pair_idx).long(), t(w), t(pred), t(canon / 0.2), t(r0),
                           t(t0), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(np.asarray(want), r0)


def test_medians_average_the_middle_pair():
    """jnp.median / jnp.nanmedian average the two middle values; torch.median
    returns the lower one, so the port takes the 0.5 quantile."""
    from cppf2_torch.infer.pipeline import _median0

    x = np.array([[1.0, 4.0], [2.0, 3.0], [3.0, 2.0], [4.0, 1.0]], np.float32)
    np.testing.assert_array_equal(_median0(t(x)).numpy(), np.asarray(jnp.median(x, axis=0)))
    xn = np.array([1.0, np.nan, 2.0, 5.0, 3.0], np.float32)
    assert float(torch.nanquantile(t(xn), 0.5)) == float(jnp.nanmedian(xn)) == 2.5
