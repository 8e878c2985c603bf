"""A frame group's instance axis before the pose graph, on the CPU.

The port runs a (category, crop tier) group's frontend (crop windows,
backprojection, voxel downsample, kNN, normals, SHOT), crop descriptors,
tuple choice and branch MLPs as one batched pass, where the JAX driver
vmaps its group program (`cppf2_tpu/eval/driver.py::_frame_group_fn`). Each
row must equal the single-instance port to the bit, and the JAX package's
vmapped frontend within the tolerances of `test_torch_frontend.py`. The
restart axis of `estimate_pose_branch_restarts` is held the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import CATEGORIES as T_CATEGORIES
from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.eval import driver as tdriver
from cppf2_torch.infer import frontend as tfront
from cppf2_torch.infer import pipeline as tpipeline
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.ops import neighbors as tnb
from cppf2_torch.ops import shot as tshot
from cppf2_tpu.infer import frontend as jfront

H, W = 360, 400
K = np.array([[591.0125, 0.0, 200.0], [0.0, 590.16775, 180.0], [0.0, 0.0, 1.0]], np.float32)
N_MAX, SHOT_K, RES = 1024, 24, 2e-3


def t(x):
    return torch.from_numpy(np.array(x))


def _rows_equal(batched, singles):
    """Row b of every field of `batched` equals the single call `singles[b]`, bit for bit."""
    for b, one in enumerate(singles):
        for i, (g, w) in enumerate(zip(batched, one)):
            assert torch.equal(g[b], w), f"row {b}, field {i}"


def _frame(seed=0):
    """Sphere caps at 0.7 m on an empty 360 x 400 frame: two small ones
    (r 2 cm, a few hundred voxels), a large one (r 5 cm, more occupied
    voxels than N_MAX) and an empty mask. Returns depth and the four masks."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    masks = []
    for cx, cy, r in ((-0.08, -0.05, 0.02), (0.07, 0.04, 0.02), (0.0, 0.0, 0.05)):
        cz = 0.7
        d2 = (xs - (K[0, 2] + K[0, 0] * cx / cz)) ** 2 + (ys - (K[1, 2] + K[1, 1] * cy / cz)) ** 2
        mask = d2 < (r * K[0, 0] / cz) ** 2
        bump = np.sqrt(np.maximum(r ** 2 - d2 * (cz / K[0, 0]) ** 2, 0.0))
        depth[mask] = (cz - bump + rng.normal(0, 3e-4, (H, W)))[mask]
        masks.append(mask)
    masks.append(np.zeros((H, W), bool))
    return depth, masks


def _voxel_draws(key, crop):
    """The voxel draws JAX's `preprocess_frame` makes from `key` (as in
    `test_torch_frontend.py`)."""
    h, w = tfront.window_shape((H, W), crop)
    return (np.asarray(jax.random.permutation(key, h * w)),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (h * w,))))


@pytest.fixture(scope="module", params=[256, 320])
def group_frontend(request):
    """One tier's group of four through the port's batched `preprocess_frame`
    and through jax.vmap of the JAX one, on the reference's voxel draws."""
    crop = request.param
    depth, masks = _frame()
    keys = jax.random.split(jax.random.key(crop), len(masks))
    draws = [_voxel_draws(k, crop) for k in keys]
    want = jax.jit(jax.vmap(lambda m, k: jfront.preprocess_frame(
        jnp.asarray(depth), m, jnp.asarray(K), k, res=RES, n_max=N_MAX, shot_k=SHOT_K,
        crop=crop)))(jnp.asarray(np.stack(masks)), keys)
    origins = [tfront.crop_origin(m, (H, W), crop) for m in masks]
    perm, prio = (t(np.stack([d[i] for d in draws])) for i in (0, 1))
    got = tfront.preprocess_frame(t(depth), t(np.stack(masks)), t(K), perm, prio, res=RES,
                                  n_max=N_MAX, shot_k=SHOT_K, crop=crop, origin=origins)
    return crop, depth, masks, draws, origins, got, want


def test_group_frontend_rows_equal_the_single_instance(group_frontend):
    """Every field of every row equals `preprocess_frame` of that instance
    alone, to the bit, at both tiers: two small caps, one whose occupied
    voxels exceed n_max (count clamps to it) and an empty mask (count 0, all
    rows zero). Without origins the windows are found on the device, with
    the same result."""
    crop, depth, masks, draws, origins, got, _ = group_frontend
    singles = [tfront.preprocess_frame(t(depth), t(m), t(K), t(p), t(u), res=RES, n_max=N_MAX,
                                       shot_k=SHOT_K, crop=crop, origin=o)
               for m, (p, u), o in zip(masks, draws, origins)]
    _rows_equal(got, singles)
    assert got.pc.shape == (4, N_MAX, 3) and got.window_yx.tolist() == [list(o) for o in origins]
    counts = got.count.tolist()
    assert 100 < counts[0] < N_MAX and 100 < counts[1] < N_MAX
    assert counts[2] == N_MAX and counts[3] == 0 and not got.valid[3].any()
    perm, prio = (t(np.stack([d[i] for d in draws[:2]])) for i in (0, 1))
    on_device = tfront.preprocess_frame(t(depth), t(np.stack(masks[:2])), t(K), perm, prio,
                                        res=RES, n_max=N_MAX, shot_k=SHOT_K, crop=crop)
    _rows_equal(on_device, singles[:2])


def test_group_frontend_matches_vmapped_jax(group_frontend):
    """The rows against jax.vmap of the JAX `preprocess_frame` (jitted) on
    the same keys, with `test_torch_frontend.py::test_preprocess_frame`'s
    bounds over the group's valid points: cloud, validity, count, pixels and
    window exact; normals all within 1e-5; SHOT 85% within 1e-5 and all
    within 2e-3 (measured 1.2e-6, 2.7e-7 and 1.6e-4). Every row has the
    jitted graph's neighbour set: the kNN rounds its packed key as XLA does
    under jit. (While the port rounded the key's column norms as the eager
    JAX call does, some rim rows had another neighbour set, not a
    near-degenerate normal: their normals moved by up to 0.02 and SHOT by
    0.345, and this test held SHOT only on rows whose neighbours' normals
    agreed.)"""
    _, _, _, _, _, got, want = group_frontend
    for name in ("pc", "valid", "count", "pixel_yx", "window_yx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    ok = got.valid.numpy()
    err_n = np.abs(got.normal.numpy() - np.asarray(want.normal)).max(-1)
    err_s = np.abs(got.shot.numpy() - np.asarray(want.shot)).max(-1)
    assert err_n[ok].max() < 1e-5
    assert np.quantile(err_s[ok], 0.85) < 1e-5 and err_s[ok].max() < 2e-3


def _clouds(n=600, seed=3):
    """Three bumpy patches of n padded points (2 mm spacing), each with its
    own invalid points; the third has only 40 valid points."""
    rng = np.random.default_rng(seed)
    pts, valid = [], []
    for b in range(3):
        xy = rng.uniform(-0.02, 0.02, size=(n, 2))
        z = 0.7 + 0.1 * b + 0.004 * np.sin(60 * xy[:, 0]) * np.cos(40 * xy[:, 1])
        ok = rng.uniform(size=n) < (0.95 if b < 2 else 40 / n)
        pts.append(np.where(ok[:, None], np.concatenate([xy, z[:, None]], -1), 0))
        valid.append(ok)
    return t(np.stack(pts).astype(np.float32)), t(np.stack(valid))


@pytest.mark.parametrize("exact", [False, True], ids=["packed", "exact"])
@pytest.mark.parametrize("block", [None, 600 * 600, 256 * 600], ids=["one-block", "per-instance",
                                                                     "query-chunks"])
def test_group_knn_rows_equal_the_single_instance(monkeypatch, exact, block):
    """Both kNN routes over a (3, 600) group equal the single calls to the
    bit: in one distance block, one instance a block, and (query chunks of
    256) three chunks an instance."""
    if block is not None:
        monkeypatch.setattr(tnb, "_BLOCK_ELEMS", block)
    if block == 256 * 600:
        monkeypatch.setattr(tnb, "_QUERY_CHUNK", 256)
    pts, valid = _clouds()
    got = tnb.knn_radius_neighbors(pts, valid, 0.02, 24, exact=exact)
    monkeypatch.undo()
    _rows_equal(got, [tnb.knn_radius_neighbors(p, v, 0.02, 24, exact=exact)
                      for p, v in zip(pts, valid)])


@pytest.mark.parametrize("exact", [False, True], ids=["packed", "exact"])
def test_group_shot_and_cshot_rows_equal_the_single_instance(exact):
    """SHOT and normals (both kNN routes) and CSHOT over a (3, 600) group
    equal the single calls to the bit: the per-point stages run once over
    the group's 1800 points, each neighbor index moved into its block."""
    pts, valid = _clouds()
    got = tshot.compute_shot_features(pts, valid, 0.02, k=24, exact=exact)
    _rows_equal(got, [tshot.compute_shot_features(p, v, 0.02, k=24, exact=exact)
                      for p, v in zip(pts, valid)])
    if not exact:
        colors = torch.rand(pts.shape, generator=torch.Generator().manual_seed(1))
        got = tshot.compute_cshot_features(pts, colors, valid, 0.02, k=24)
        _rows_equal(got, [tshot.compute_cshot_features(p, c, v, 0.02, k=24)
                          for p, c, v in zip(pts, colors, valid)])


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_group_crop_descriptors_rows_equal_the_single_instance(impl):
    """`sample_crop_descriptors` on a group's (3, 4, 4, 64) grids, (3, 500)
    pixels (some outside the crop) and (3,) transforms equals the single
    calls to the bit, for both sampling forms."""
    rng = np.random.default_rng(4)
    grids = t(rng.normal(size=(3, 4, 4, 64)).astype(np.float32))
    pix = t(rng.integers(0, 300, size=(3, 500, 2)).astype(np.int32))
    txys = t(np.array([[20.0, 30.0, 1.2], [5.0, -3.0, 0.7], [60.0, 40.0, 2.1]], np.float32))
    got = tdino.sample_crop_descriptors(grids, pix, txys, 32, impl=impl)
    for b in range(3):
        assert torch.equal(got[b], tdino.sample_crop_descriptors(grids[b], pix[b], txys[b], 32,
                                                                 impl=impl))


def test_group_branch_mlps_rows_equal_the_single_instance():
    """One forward of each float32 branch MLP over a (3, 300)-point group's
    (3, 400, 5) tuples (the flattened (1200, C) products) equals each
    instance's own forward to the bit; so does the restart form, one cloud
    with (3, 400, 5) tuples. (bfloat16 products on the CPU round a row
    otherwise when the number of rows changes, as cuBLAS may on the card;
    `chip_smoke.py` prints the largest logit difference there.)"""
    gen = torch.Generator().manual_seed(2)
    shot_m = ShotBranch().eval()
    dino_m = DinoBranch(desc_dim=64).eval()
    for m in (shot_m, dino_m):
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.1
    pts = torch.rand((3, 300, 3), generator=gen)
    feat = torch.rand((3, 300, 352), generator=gen)
    nrm = torch.nn.functional.normalize(torch.randn((3, 300, 3), generator=gen), dim=-1)
    desc = torch.rand((3, 300, 64), generator=gen)
    ti = torch.randint(0, 300, (3, 400, 5), generator=gen)
    with torch.no_grad():
        _rows_equal(shot_m(pts, feat, nrm, ti), [shot_m(*x) for x in zip(pts, feat, nrm, ti)])
        _rows_equal(dino_m(pts, desc, ti), [dino_m(*x) for x in zip(pts, desc, ti)])
        _rows_equal(shot_m(pts[0], feat[0], nrm[0], ti), [shot_m(pts[0], feat[0], nrm[0], x)
                                                          for x in ti])


def test_dispatch_frame_makes_one_frontend_pass_and_one_forward_a_branch_a_group():
    """`test_torch_frame_driver`'s frame (two mugs in one group, a bowl, an
    empty detection on the singles route) with a ViT: one `preprocess_frame`
    call, one `sample_crop_descriptors` call and one forward of each branch
    MLP per group, each over the group's instances; the singles route a
    group of one (no descriptors: its mask is empty)."""
    from test_torch_frame_driver import K as FK
    from test_torch_frame_driver import OUT, STRIDE, VIT
    from test_torch_frame_driver import PIPE as FPIPE
    from test_torch_frame_driver import _frame as frame

    rgb, depth, dets = frame()
    models = tdriver.load_category_models("ckpts_r3", ["mug", "bowl"], torch.float32, "cpu")
    vit = tdino.DinoViT(tdino.ViTConfig(**VIT)).eval()
    vit.init_random(torch.Generator().manual_seed(0))
    seen = {"frontend": [], "descriptors": [], "shot": [], "dino": []}
    front, sample = tdriver.preprocess_frame, tdriver.sample_crop_descriptors

    def count_front(depth, mask, *a, **k):
        seen["frontend"].append(mask.shape[0])
        return front(depth, mask, *a, **k)

    def count_sample(grid, *a, **k):
        seen["descriptors"].append(grid.shape[0])
        return sample(grid, *a, **k)

    hooks = [getattr(models[name], branch).register_forward_pre_hook(
        lambda mod, args, branch=branch: seen[branch].append(tuple(args[-1].shape[:-2])))
        for name in models for branch in ("shot", "dino")]
    tdriver.preprocess_frame, tdriver.sample_crop_descriptors = count_front, count_sample
    try:
        got = tdriver.fetch_frames(tdriver.dispatch_frame(
            rgb, depth, dets, FK, models, TPipe(**FPIPE), vit=vit, device="cpu", run_opt=False,
            stride=STRIDE, out_size=OUT, generator=torch.Generator().manual_seed(1)))
    finally:
        tdriver.preprocess_frame, tdriver.sample_crop_descriptors = front, sample
        for h in hooks:
            h.remove()
    # the empty detection is dispatched first (singles go as they come), then
    # the groups: mug (detections 0 and 2), bowl (1)
    assert seen == {"frontend": [1, 2, 1], "descriptors": [2, 1], "shot": [(1,), (2,), (1,)],
                    "dino": [(1,), (2,), (1,)]}
    assert got[3] is None and all(got[i] is not None for i in (0, 1, 2))


@pytest.mark.parametrize("run_opt", [False, True], ids=["voted", "adam5"])
def test_branch_restarts_rows_equal_the_sequential_passes(run_opt):
    """`estimate_pose_branch_restarts` runs its three restarts as rows of one
    pass; each row is `estimate_pose_branch` on that restart's draws, and
    the first of the lowest losses wins. Without the alignment the winner
    equals the sequential passes' winner to the bit; with 5 Adam steps over
    three rows, R within 0.05 deg and T within 0.05 mm (the group tests'
    bound), the same winner."""
    from test_torch_pipeline import _features, _models, _rot_angle_deg

    pipe = TPipe(n_points=512, num_pairs=1000, angle_tol_deg=5.0, opt_steps=5)
    cat = T_CATEGORIES["mug"]
    fi, _ = _features()
    tshot_m = _models()[4]
    pc, valid, shot, normal = (t(x) for x in (fi.pc, fi.valid, fi.shot, fi.normal))
    count = torch.tensor(int(fi.count))
    gen = torch.Generator().manual_seed(6)
    draws = [tpipeline.draw_branch(cat, pipe, "cpu", gen) for _ in range(3)]
    draws.append(draws[1])    # a tie: the first of the equal losses wins

    def fn(pts, ti):
        return tshot_m(pts, shot, normal, ti)

    with torch.no_grad():
        got = tpipeline.estimate_pose_branch_restarts(fn, pc, valid, count, cat, pipe, draws=draws,
                                                      restarts=4, run_opt=run_opt)
        seq = [tpipeline.estimate_pose_branch(fn, pc, valid, count,
                                              tpipeline.masked_tuple_choice(d.tuple_u, count),
                                              d.gumbel, cat, pipe, run_opt) for d in draws]
    losses = torch.stack([e.loss for e in seq])
    best = seq[int(torch.argmin(losses))]
    if not run_opt:
        _rows_equal([f[None] for f in got[:5]], [best[:5]])
    else:
        assert _rot_angle_deg(got.rotation.numpy(), best.rotation.numpy()) < 0.05
        np.testing.assert_allclose(got.translation.numpy(), best.translation.numpy(), atol=5e-5)
        np.testing.assert_allclose(float(got.loss), float(losses.min()), rtol=1e-3)
