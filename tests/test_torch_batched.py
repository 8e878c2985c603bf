"""The pose graph's row axis against the JAX package's batch axes on the CPU.

A row is one (instance, branch) pair. The port batches every stage after
the branch MLPs over rows, where the JAX package uses jax.vmap over branches
(`cppf2_tpu/infer/pipeline.py:444`) and over a frame group's instances
(`cppf2_tpu/eval/driver.py::_frame_group_fn`). Each batched row must give the
single-row port's result to the bit up to the alignment (bin samples,
center, count, kept pairs, weights, sphere picks), and the JAX package's
vmapped result within the tolerances the single-row tests hold. The rows
come from different seeds and include a row with no valid vote (count 0)
and a repeated row.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import CATEGORIES as T_CATEGORIES
from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.core.geometry import fibonacci_sphere
from cppf2_torch.eval import driver as tdriver
from cppf2_torch.infer import alignment as talign
from cppf2_torch.infer import pipeline as tpipeline
from cppf2_torch.ops import hist16
from cppf2_torch.ops import voting as tvote
from cppf2_tpu.config import CATEGORIES as J_CATEGORIES
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.infer import alignment as jalign
from cppf2_tpu.infer import pipeline as jpipeline
from cppf2_tpu.infer.frontend import preprocess_frame
from cppf2_tpu.ops import voting as jvote
from test_torch_pipeline import K, _frame, _models, _rot_angle_deg, jax_pose_draws
from test_torch_voting import CENTER, _align_inputs, _scene

PIPE = dict(n_points=512, num_pairs=2000, angle_tol_deg=5.0)


def t(x):
    return torch.from_numpy(np.array(x))


def _rows_equal(got, want):
    """Every field of a batched result equals the single-row result, bit for bit."""
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# K2 over rows
# ---------------------------------------------------------------------------

def _level_rows(arc, sub=200, n_smp=12, seeds=(21, 22, 23)):
    """One vote level's per-pair inputs for rows from `seeds`, each with its
    own window, then a repeat of the first row and a row with no valid vote.
    Per-cell counts stay below 256, where the XLA twin's bf16 one-hot product
    is exact on the CPU."""
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        lo = rng.uniform(-0.2, 0.2, 3).astype(np.float32) + np.float32([0, 0, 0.6])
        cell = rng.uniform(0.004, 0.015, 3).astype(np.float32)
        c = (lo + cell * rng.uniform(3.0, 13.0, size=(sub, 3))).astype(np.float32)
        x0 = rng.normal(size=(sub, 3))
        x0 /= np.linalg.norm(x0, axis=-1, keepdims=True)
        y0 = rng.normal(size=(sub, 3))
        y0 -= np.sum(y0 * x0, -1, keepdims=True) * x0
        y0 /= np.linalg.norm(y0, axis=-1, keepdims=True)
        od = rng.uniform(0.3, 3.0, sub).astype(np.float32) * cell.max()
        row = dict(c=c, x0=x0.astype(np.float32), y0=y0.astype(np.float32), odist=od,
                   ok=rng.uniform(size=sub) < 0.9, lo=lo, cell=cell,
                   theta_star=rng.uniform(-np.pi, np.pi, sub).astype(np.float32),
                   span=np.clip(1.2 * 8 * cell.max() / od, 0.0, np.pi).astype(np.float32))
        rows.append(row)
    rows.append(dict(rows[0]))
    rows.append({**rows[1], "ok": np.zeros(sub, bool)})
    keys = ["c", "x0", "y0", "odist", "ok"]
    args = [t(np.stack([r[k] for r in rows])) for k in keys]
    if arc:
        samples = tvote._linspace(n_smp, "cpu")
        extra = [t(np.stack([r[k] for r in rows])) for k in ("theta_star", "span")]
    else:
        ang = torch.arange(n_smp, dtype=torch.float32) / n_smp * 2 * torch.pi
        samples, extra = torch.stack([torch.cos(ang), torch.sin(ang)]), [None, None]
    lo, cell = (t(np.stack([r[k] for r in rows])) for k in ("lo", "cell"))
    return args, samples, lo, cell, extra


@pytest.mark.parametrize("arc", [False, True], ids=["circle", "arc"])
def test_batched_level_matches_vmapped_xla_twin(arc):
    """The batched level (wrapper and plain version) against jax.vmap of
    `_hist16_matmul` over each row's candidates: exact centers and counts; a
    repeated row repeats, a row with no valid vote counts 0 at its window's
    corner; each row equals the single-row call."""
    args, samples, lo, cell, extra = _level_rows(arc)
    got_c, got_n = hist16.hist16_level_peak(*args, samples, lo, cell, *extra)
    plain_c, plain_n = hist16.hist16_level_peak_plain(*args, samples, lo, cell, *extra)
    _rows_equal((got_c, got_n), (plain_c, plain_n))
    assert got_c.shape == (5, 3) and got_n.shape == (5,)

    cands, oks = [], []
    for b in range(5):
        row = [a[b] for a in args]
        cand, ok_v = hist16.level_candidates(*row, samples, *(None if e is None else e[b] for e in extra))
        cands.append(cand.numpy())
        oks.append(ok_v.numpy())
        one_c, one_n = hist16.hist16_level_peak(*row, samples, lo[b], cell[b],
                                                *(None if e is None else e[b] for e in extra))
        _rows_equal((got_c[b], got_n[b]), (one_c, one_n))
    want_c, want_n = jax.vmap(jvote._hist16_matmul)(jnp.asarray(np.stack(cands)),
                                                   jnp.asarray(np.stack(oks)),
                                                   jnp.asarray(lo.numpy()), jnp.asarray(cell.numpy()))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert np.all(got_n.numpy()[:3] > 0) and np.all(got_n.numpy()[:3] < 256)
    _rows_equal((got_c[3], got_n[3]), (got_c[0], got_n[0]))
    assert float(got_n[4]) == 0.0
    torch.testing.assert_close(got_c[4], lo[4], atol=0, rtol=0)


def test_batched_level_wrapper_checks_rows():
    """The row form's shape checks: every per-pair input and the window carry
    the same leading axis; the sample table has none."""
    args, samples, lo, cell, extra = _level_rows(True, sub=8, n_smp=4)
    hist16.hist16_level_peak(*args, samples, lo, cell, *extra)           # well-formed
    names = ["c", "x0", "y0", "odist", "ok"]

    def call(**kw):
        a = dict(zip(names, args), samples=samples, lo=lo, cell=cell, theta_star=extra[0],
                 span=extra[1]) | kw
        return hist16.hist16_level_peak(*(a[k] for k in names), a["samples"], a["lo"], a["cell"],
                                        a["theta_star"], a["span"])

    for bad in (dict(x0=args[1][:4]),                         # fewer rows than c
                dict(odist=args[3][0]),                       # a single row's odist
                dict(ok=args[4][:, :5]),                      # fewer pairs
                dict(lo=lo[0]),                               # one window for all rows
                dict(cell=cell[:3]),
                dict(span=extra[1][:, None]),
                dict(samples=samples[None].expand(5, -1)),    # a table per row
                dict(c=args[0][None])):                       # a fourth axis
        with pytest.raises(ValueError):
            call(**bad)
    with pytest.raises(ValueError, match="rows"):
        call(**{n: a[:0] for n, a in zip(names, args)}, lo=lo[:0], cell=cell[:0],
             theta_star=extra[0][:0], span=extra[1][:0])


# ---------------------------------------------------------------------------
# The vote stages over rows
# ---------------------------------------------------------------------------

def _scene_rows(seeds=(0, 5, 6)):
    """Scenes of `test_torch_voting` from `seeds`, a repeat of the first, and
    one whose pairs are all invalid (no vote counts)."""
    scenes = [_scene(s) for s in seeds]
    scenes.append(scenes[0])
    pts, valid, pair_idx, tr, pv = scenes[1]
    scenes.append((pts, valid, pair_idx, tr, np.zeros_like(pv)))
    return [np.stack(x) for x in zip(*scenes)]


def test_vote_center_rows():
    """One K2 launch a level for all rows; each row's center and count equal
    the single-row call's to the bit, and jax.vmap's within one fine cell
    (res 2 mm) and 1% of the count (the single-row test's tolerance: the arc
    samples go through cos/sin/atan2, whose last ulp differs)."""
    pts, valid, pair_idx, tr, pv = _scene_rows()
    res = 2e-3
    calls = []
    level = hist16.hist16_level_peak

    def counting(*args):
        calls.append(args[0].shape)
        return level(*args)

    hist16.hist16_level_peak = counting
    try:
        got = tvote.vote_center(t(pts), t(valid), t(tr), t(pair_idx).long(), t(pv), res,
                                levels=4, fine_samples=8)
    finally:
        hist16.hist16_level_peak = level
    assert [s[0] for s in calls] == [5] * 4
    for b in range(5):
        one = tvote.vote_center(t(pts[b]), t(valid[b]), t(tr[b]), t(pair_idx[b]).long(), t(pv[b]),
                                res, levels=4, fine_samples=8)
        _rows_equal((got.center[b], got.peak_count[b]), one)
    want = jax.vmap(lambda *a: jvote.vote_center(*a, res, levels=4, fine_samples=8))(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(tr), jnp.asarray(pair_idx), jnp.asarray(pv))
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center), atol=res + 1e-6)
    np.testing.assert_allclose(got.peak_count.numpy(), np.asarray(want.peak_count), rtol=0.01)
    assert float(got.peak_count[4]) == 0.0 and np.all(got.peak_count.numpy()[:4] > 0)


def test_backvote_filter_rows():
    """Each row's kept pairs, mask and weights equal the single-row call's to
    the bit; against jax.vmap the kept set is equal as a set and the weights
    within 1e-6 (the single-row test's tolerance)."""
    pts, valid, pair_idx, tr, pv = _scene_rows((1, 7, 8))
    centers = (CENTER + np.float32([[1e-3, 0, 0], [0, 2e-3, 0], [0, 0, -1e-3], [1e-3, 0, 0],
                                    [0, 0, 0]])).astype(np.float32)
    got = tvote.backvote_filter(t(pts), t(tr), t(pair_idx).long(), t(pv), t(centers), 300, 0.01)
    assert got.kept_idx.shape == (5, 300) and got.pair_weight.shape == pv.shape
    for b in range(5):
        one = tvote.backvote_filter(t(pts[b]), t(tr[b]), t(pair_idx[b]).long(), t(pv[b]),
                                    t(centers[b]), 300, 0.01)
        _rows_equal([x[b] for x in got], one)
    want = jax.vmap(lambda *a: jvote.backvote_filter(*a, 300, 0.01))(
        jnp.asarray(pts), jnp.asarray(tr), jnp.asarray(pair_idx), jnp.asarray(pv), jnp.asarray(centers))
    for b in range(5):
        assert set(got.kept_idx[b].tolist()) == set(np.asarray(want.kept_idx[b]).tolist())
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_allclose(got.pair_weight.numpy(), np.asarray(want.pair_weight), atol=1e-6)
    assert not got.keep[4].any()


def test_sphere_vote_cone_rows():
    """Each row's top-1 directions and scores equal the single-row call's to
    the bit (the sum over pairs is taken row by row in the single-row order);
    against jax.vmap the directions are the same sphere points and the
    scores rtol 1e-4, as for one row. The last row has every weight 0."""
    tol_deg = 5.0
    sph = fibonacci_sphere(int(4 * np.pi / (tol_deg / 180 * np.pi)))
    rows = []
    for seed in (2, 9, 10):
        rng = np.random.default_rng(seed)
        pts = rng.normal(size=(200, 3)).astype(np.float32) * 0.05
        pair_idx = rng.integers(0, 200, size=(300, 2)).astype(np.int32)
        pair_idx[:, 1] = np.where(pair_idx[:, 1] == pair_idx[:, 0], (pair_idx[:, 0] + 1) % 200,
                                  pair_idx[:, 1])
        a, b = pts[pair_idx[:, 0]], pts[pair_idx[:, 1]]
        u = (a - b) / np.linalg.norm(a - b, axis=-1, keepdims=True)
        axes = np.linalg.qr(rng.normal(size=(3, 3)))[0][:2].astype(np.float32)
        ang = np.arccos(np.clip(u @ axes.T, -1, 1)).T.astype(np.float32)
        ang += rng.normal(0, 0.02, size=ang.shape).astype(np.float32)
        w = rng.uniform(0.5, 2.0, size=300).astype(np.float32)
        w[:20] = 0
        rows.append((pts, ang, pair_idx, w))
    rows.append(rows[0])
    rows.append((*rows[1][:3], np.zeros(300, np.float32)))
    pts, ang, pair_idx, w = (np.stack(x) for x in zip(*rows))
    got_d, got_s = tvote.sphere_vote_cone(t(pts), t(ang), t(pair_idx).long(), t(w), t(sph), tol_deg)
    assert got_d.shape == (5, 2, 3) and got_s.shape == (5, 2)
    for b in range(5):
        one = tvote.sphere_vote_cone(t(pts[b]), t(ang[b]), t(pair_idx[b]).long(), t(w[b]), t(sph),
                                     tol_deg)
        _rows_equal((got_d[b], got_s[b]), one)
    jd, js = jax.vmap(lambda *a: jvote.sphere_vote_cone(*a, jnp.asarray(sph), tol_deg, topk=1))(
        jnp.asarray(pts), jnp.asarray(ang), jnp.asarray(pair_idx), jnp.asarray(w))
    np.testing.assert_array_equal(got_d[:4].numpy(), np.asarray(jd)[:4, :, 0])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js)[..., 0], rtol=1e-4)
    assert np.all(got_s[4].numpy() == 0)


# ---------------------------------------------------------------------------
# The alignment over rows
# ---------------------------------------------------------------------------

def _align_rows():
    """Alignment inputs from three seeds and a repeat of the first."""
    rows = [_align_inputs(s) for s in (3, 12, 13)]
    rows.append(rows[0])
    return [np.stack(x) for x in zip(*rows)]


@pytest.mark.parametrize("up_sym", [False, True])
def test_align_pose_rows(up_sym):
    """One Adam loop for all rows. Each row equals its own single-row loop
    within 1e-6 (bit for bit here: the rows share no sum), and the repeated
    row repeats. Against jax.vmap of the JAX alignment: after 20 steps the
    single-row test's R atol 1e-5, T 1e-6 m; after 100 steps R 2e-3, loss
    rtol 1e-3, and T 1e-4 m where the single-row test holds 5e-5 on its one
    input: near the L1 optimum Adam's steps flip with the gradient's sign, so
    float32 noise grows by an amount that depends on the input (5.7e-5 on
    seed 12's row), and jax.vmap compiles another program than the single
    call, with its own rounding."""
    pts, pair_idx, w, pred, r0, t0 = _align_rows()
    calls = []
    grad = torch.autograd.grad

    def counting(*a, **kw):
        calls.append(1)
        return grad(*a, **kw)

    def both(steps):
        torch.autograd.grad = counting
        try:
            got = talign.align_pose(t(pts), t(pair_idx).long(), t(w), t(pred), t(r0), t(t0),
                                    up_sym, 1, steps, 1e-2)
        finally:
            torch.autograd.grad = grad
        want = jax.vmap(lambda *a: jalign.align_pose(*a, up_sym, 1, steps, 1e-2))(
            *(jnp.asarray(x) for x in (pts, pair_idx, w, pred, r0, t0)))
        return got, want

    got, want = both(20)
    assert len(calls) == 20
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-6)
    got, want = both(100)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=2e-3)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-4)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=1e-3)
    _rows_equal([x[3] for x in got], [x[0] for x in got])
    for b in range(3):
        one = talign.align_pose(t(pts[b]), t(pair_idx[b]).long(), t(w[b]), t(pred[b]), t(r0[b]),
                                t(t0[b]), up_sym, 1, 100, 1e-2)
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[b].numpy(), o.numpy(), atol=1e-6, rtol=0)


def test_yaw_sweep_rows():
    """Each row's refined rotation against jax.vmap of the JAX sweep (atol
    1e-5: the same delta picked), with a radial feature on some rows only."""
    pts, pair_idx, w, pred, r0, t0 = _align_rows()
    canon = pred.copy()
    canon[0, :30, :, 0] += 0.04
    canon[2, :40, :, 2] += 0.05
    canon[3] = canon[0]
    got = talign.yaw_sweep(t(pts), t(pair_idx).long(), t(w), t(pred), t(canon / 0.2), t(r0), t(t0), 1)
    want = jax.vmap(lambda *a: jalign.yaw_sweep(*a, 1))(
        *(jnp.asarray(x) for x in (pts, pair_idx, w, pred, canon / 0.2, r0, t0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for b in range(4):
        one = talign.yaw_sweep(t(pts[b]), t(pair_idx[b]).long(), t(w[b]), t(pred[b]),
                               t(canon[b] / 0.2), t(r0[b]), t(t0[b]), 1)
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), atol=1e-6)
    assert not np.allclose(np.asarray(want[0]), r0[0])


# ---------------------------------------------------------------------------
# The ensemble over a group
# ---------------------------------------------------------------------------

def _clouds(keys=(9, 10)):
    """The pipeline test's frame through the JAX frontend with two voxel
    draws: two clouds of one object."""
    depth, mask = _frame()
    k = K.copy()
    k[0, 2], k[1, 2] = 80.0, 60.0
    out = []
    for seed, key in enumerate(keys):
        fi = preprocess_frame(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(k),
                              jax.random.key(key), res=2e-3, n_max=512, shot_k=24)
        desc = np.random.default_rng(seed + 1).normal(size=(512, 1024)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        out.append((fi, desc))
    return out


@pytest.fixture(scope="module")
def group_reference():
    """Two instances (two clouds, two keys) through jax.vmap of the JAX
    ensemble, with and without the alignment, and the port's inputs."""
    jpipe, cat = JPipe(**PIPE), "mug"
    clouds = _clouds()
    jshot_m, shot_p, jdino_m, dino_p, tshot_m, tdino_m = _models()
    keys = [jax.random.key(31), jax.random.key(32)]

    def run(run_opt):
        def one(pc, valid, count, shot, normal, desc, key):
            return jpipeline.estimate_pose_ensemble(
                lambda p, pts, ti: jdino_m.apply({"params": p["params"]}, pts, desc, ti), dino_p,
                lambda p, pts, ti: jshot_m.apply({"params": p["params"]}, pts, shot, normal, ti),
                shot_p, pc, valid, count, key, J_CATEGORIES[cat], jpipe, run_opt=run_opt)

        stack = lambda f: jnp.stack([f(fi, d) for fi, d in clouds])  # noqa: E731
        return jax.jit(jax.vmap(one))(stack(lambda fi, d: fi.pc), stack(lambda fi, d: fi.valid),
                                      stack(lambda fi, d: fi.count), stack(lambda fi, d: fi.shot),
                                      stack(lambda fi, d: fi.normal), stack(lambda fi, d: d),
                                      jnp.stack(keys))

    inputs = []
    for (fi, desc), key in zip(clouds, keys):
        pc, valid, shot, normal = (t(x) for x in (fi.pc, fi.valid, fi.shot, fi.normal))
        desc_t = t(desc)
        inputs.append(Instance(
            lambda pts, ti, desc_t=desc_t: tdino_m(pts, desc_t, ti),
            lambda pts, ti, shot=shot, normal=normal: tshot_m(pts, shot, normal, ti),
            pc, valid, torch.tensor(int(fi.count)), [jax_pose_draws(key, jpipe, 5)],
            desc_t, shot, normal))
    return inputs, {False: run(False), True: run(True)}


class Instance(NamedTuple):
    """One instance of `group_reference`: its single-instance branch
    functions, cloud and draws, and the features they close over."""

    dino_fn: object
    shot_fn: object
    points: torch.Tensor
    point_valid: torch.Tensor
    count: torch.Tensor
    draws: list
    desc: torch.Tensor
    shot: torch.Tensor
    normal: torch.Tensor


def group_of(instances):
    """Instances stacked as one group's EnsembleInput: one forward a branch."""
    tshot_m, tdino_m = _models()[4:]
    desc, shot, normal = (torch.stack([getattr(x, f) for x in instances])
                          for f in ("desc", "shot", "normal"))
    return tpipeline.EnsembleInput(
        lambda pts, ti: tdino_m(pts, desc, ti), lambda pts, ti: tshot_m(pts, shot, normal, ti),
        *(torch.stack([getattr(x, f) for x in instances]) for f in ("points", "point_valid", "count")),
        [tpipeline.stack_draws(r) for r in zip(*(x.draws for x in instances))])


@pytest.mark.parametrize("run_opt", [False, True], ids=["voted", "adam100"])
def test_ensemble_group_matches_vmapped_jax(group_reference, run_opt):
    """A group of three instances (two clouds and a repeat of the first) as
    six rows in one call against jax.vmap of the JAX ensemble over the two
    instances: without the alignment R atol 1e-7 and T within an ulp or two
    (rtol 2.4e-7 as for one instance, and atol 6e-8, one ulp of the cloud's
    0.5-0.7 m coordinates, for a component near 0 that the peak center
    lo + id * cell cancels), with it R 0.5 deg, T 2 mm, s rtol 1e-3; the
    same picks. Each instance equals its own group of one: to the
    bit without the alignment, within 0.05 deg and 0.05 mm with it. The
    repeated instance repeats. One alignment loop and four K2 levels of six
    rows for the group."""
    inputs, want_by = group_reference
    want = want_by[run_opt]
    tpipe, cat = TPipe(**PIPE), T_CATEGORIES["mug"]
    seen = {"align": [], "level": []}
    align, level = tpipeline.align_pose, hist16.hist16_level_peak

    def count_align(points, *a, **kw):
        seen["align"].append(points.shape[0])
        return align(points, *a, **kw)

    def count_level(c, *a, **kw):
        seen["level"].append(c.shape[0])
        return level(c, *a, **kw)

    tpipeline.align_pose, hist16.hist16_level_peak = count_align, count_level
    try:
        with torch.no_grad():
            got = tpipeline.estimate_pose_ensembles(group_of(inputs + inputs[:1]), cat, tpipe,
                                                    run_opt=run_opt)
    finally:
        tpipeline.align_pose, hist16.hist16_level_peak = align, level
    assert seen == {"align": [6] if run_opt else [], "level": [6] * 4}
    assert got.rotation.shape == (3, 3, 3) and got.pick.shape == (3,)
    for i in range(2):
        r, jr = got.rotation[i].numpy(), np.asarray(want.rotation[i])
        if not run_opt:
            np.testing.assert_allclose(r, jr, atol=1e-7)
            np.testing.assert_allclose(got.translation[i].numpy(), np.asarray(want.translation[i]),
                                       rtol=2.4e-7, atol=6e-8)
        assert _rot_angle_deg(r, jr) < 0.5
        np.testing.assert_allclose(got.translation[i].numpy(), np.asarray(want.translation[i]),
                                   atol=2e-3)
        np.testing.assert_allclose(got.scale[i].numpy(), np.asarray(want.scale[i]), rtol=1e-3)
        assert int(got.pick[i]) == int(want.pick[i])
    _rows_equal([f[2] for f in got], [f[0] for f in got])
    with torch.no_grad():
        for i, x in enumerate(inputs):
            one = tpipeline.estimate_pose_ensemble(x.dino_fn, x.shot_fn, x.points, x.point_valid,
                                                   x.count, cat, tpipe, draws=x.draws[0],
                                                   run_opt=run_opt)
            if not run_opt:
                _rows_equal([f[i] for f in got], one)
            else:
                assert _rot_angle_deg(got.rotation[i].numpy(), one.rotation.numpy()) < 0.05
                np.testing.assert_allclose(got.translation[i].numpy(), one.translation.numpy(),
                                           atol=5e-5)
                assert int(got.pick[i]) == int(one.pick)


def test_pose_from_preds_rows_match_vmapped_jax(group_reference):
    """`_pose_from_preds` on four rows (two instances x two branches, bins
    drawn with the JAX keys' Gumbel noise) against jax.vmap of the JAX
    function over the same rows, without the alignment: the same kept pairs
    and median scales (rtol 1e-6), R atol 1e-7, T as in the group test.
    One geometric-only row group (use_visual=False) gives each instance's
    geometric row."""
    inputs, _ = group_reference
    tpipe, jpipe, cat = TPipe(**PIPE), JPipe(**PIPE), "mug"
    with torch.no_grad():
        members = [tpipeline.branch_outputs(x.dino_fn, x.shot_fn, x.points, x.point_valid, x.count,
                                            x.draws[0]) for x in inputs]
    rows = [torch.cat([getattr(m, f) for m in members]) for f in ("logits", "scales")]
    inst = [torch.stack([getattr(m, f) for m in members]).repeat_interleave(2, dim=0)
            for f in ("points", "point_valid", "count", "tuple_idx")]
    gumbel = torch.cat([m.gumbel for m in members])
    sph = torch.from_numpy(fibonacci_sphere(tpipe.sphere_samples))
    with torch.no_grad():
        got = tpipeline._pose_from_preds(*rows, *inst, gumbel, T_CATEGORIES[cat], tpipe, sph, False)
        geo = [tpipeline.branch_outputs(x.dino_fn, x.shot_fn, x.points, x.point_valid, x.count,
                                        x.draws[0], use_visual=False) for x in inputs]
        got_geo = tpipeline.estimate_pose_group(geo, T_CATEGORIES[cat], tpipe, run_opt=False,
                                                use_visual=False)
    np.testing.assert_array_equal(got_geo.pick.numpy(), [1, 1])
    _rows_equal((got_geo.rotation, got_geo.translation), (got.rotation[1::2], got.translation[1::2]))

    # jax.random.categorical(key, logits) is argmax(logits + gumbel(key)): the
    # port's Gumbel draws are the JAX keys' own, so one JAX key per row gives
    # the same bins
    keys = []
    for seed in (31, 32):   # the instances' keys in `group_reference`
        k = jax.random.split(jax.random.key(seed), 3)
        keys.extend([k[1], k[2]])
    sph_j = jnp.asarray(fibonacci_sphere(jpipe.sphere_samples))
    want = jax.vmap(lambda lg, sc, pts, pv, cnt, ti, key: jpipeline._pose_from_preds(
        lg, sc, pts, pv, cnt, ti, key, J_CATEGORIES[cat], jpipe, sph_j, False))(
        *(jnp.asarray(x.numpy()) for x in (*rows, *inst)), jnp.stack(keys))
    np.testing.assert_array_equal(got.kept_pairs.numpy(), np.asarray(want.kept_pairs))
    np.testing.assert_array_equal(got.kept_mask.numpy(), np.asarray(want.kept_mask))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-7)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                               rtol=2.4e-7, atol=6e-8)


# ---------------------------------------------------------------------------
# The frame driver
# ---------------------------------------------------------------------------

def test_dispatch_frame_poses_each_group_in_one_call():
    """The frame of `test_torch_frame_driver` (two mugs in one group, a bowl,
    an empty detection on the singles route), the visual branch on zero
    descriptors: one alignment loop and four K2 levels per group and per
    single, each over the group's (instance, branch) rows. Without the
    alignment each grouped row equals `dispatch_instance` of that detection
    to the bit; with it, within 0.05 deg and 0.05 mm, with the same picks."""
    from test_torch_frame_driver import K as FK
    from test_torch_frame_driver import PIPE as FPIPE
    from test_torch_frame_driver import _frame as frame

    rgb, depth, dets = frame()
    models = tdriver.load_category_models("ckpts_r3", ["mug", "bowl"], torch.float32, "cpu")
    gen = torch.Generator().manual_seed(7)
    for run_opt in (False, True):
        pipe = TPipe(**FPIPE)
        draws = [tdriver.draw_instance(depth.shape, m, n, pipe, "cpu", gen) for n, m in dets]
        kw = dict(device="cpu", run_opt=run_opt, use_visual=True)
        seen = {"align": [], "level": []}
        align, level = tpipeline.align_pose, hist16.hist16_level_peak

        def count_align(points, *a, **k):
            seen["align"].append(points.shape[0])
            return align(points, *a, **k)

        def count_level(c, *a, **k):
            seen["level"].append(c.shape[0] if c.dim() == 3 else 1)
            return level(c, *a, **k)

        tpipeline.align_pose, hist16.hist16_level_peak = count_align, count_level
        try:
            frame_out, fpicks = tdriver.fetch_frames(
                tdriver.dispatch_frame(rgb, depth, dets, FK, models, pipe, draws=draws, **kw),
                return_picks=True)
        finally:
            tpipeline.align_pose, hist16.hist16_level_peak = align, level
        # the empty detection on the singles route is dispatched first, then
        # the groups (mug: detections 0 and 2; bowl: 1)
        assert seen["level"] == [2] * 4 + [4] * 4 + [2] * 4
        assert seen["align"] == ([2, 4, 2] if run_opt else [])
        singles, spicks = tdriver.fetch_instances(
            [tdriver.dispatch_instance(rgb, depth, m, FK, models[n], n, pipe, draws=d, **kw)
             for (n, m), d in zip(dets, draws)], return_picks=True)
        assert frame_out[3] is None and singles[3] is None
        for i in (0, 1, 2):
            if not run_opt:
                np.testing.assert_array_equal(frame_out[i][0], singles[i][0])
                np.testing.assert_array_equal(frame_out[i][1], singles[i][1])
                assert frame_out[i][2] == singles[i][2]
            else:
                ra, rb = (x[:3, :3] / np.cbrt(np.linalg.det(x[:3, :3]))
                          for x in (frame_out[i][0], singles[i][0]))
                assert _rot_angle_deg(ra, rb) < 0.05
                np.testing.assert_allclose(frame_out[i][0][:3, 3], singles[i][0][:3, 3], atol=5e-5)
            assert fpicks[i] == spicks[i]
