"""The port's frame driver against the JAX package's on the CPU:
`dispatch_frame` + `fetch_frames` on a frame of two categories fed the
reference's own `jax.random` draws, the dispatch/fetch pair against
`estimate_instance`, the degenerate-input guards, the host crop origin, and
single-branch restarts, and the JAX driver's visual route through a
`DinoFeatureExtractor` (host crop, the extractor's own stride).

One JAX `dispatch_frame` call is compiled for the whole file (three ensemble
programs and the ViT stage; tens of seconds on the CPU).
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
from cppf2_torch.infer.pipeline import BranchDraws, PoseDraws
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models import porting as tport
from cppf2_torch.models.porting import load_vit
from cppf2_torch.utils import profiling
from cppf2_tpu.config import CATEGORIES as J_CATEGORIES
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.eval import driver as jdriver
from cppf2_tpu.infer import pipeline as jpipeline
from cppf2_tpu.models import dinov2 as jdino
from cppf2_tpu.ops.sampling import masked_tuple_choice as j_tuple_choice
from test_torch_pipeline import _features, _models, _rot_angle_deg

H, W = 240, 320
K = np.array([[591.0125, 0.0, 160.0], [0.0, 590.16775, 120.0], [0.0, 0.0, 1.0]], np.float32)
PIPE = dict(n_points=256, num_pairs=512, opt_steps=5, angle_tol_deg=5.0)
OUT, STRIDE = 32, 8
VIT = dict(embed_dim=1024, depth=1, num_heads=16, pretrain_grid=4, layerscale_init=1.0,
           compute_dtype="float32")


def _cap(depth, center, radius, rng):
    """Adds a sphere cap to `depth`; returns its mask."""
    cx, cy, cz = center
    ys, xs = np.mgrid[0:H, 0:W]
    d2 = (xs - (K[0, 2] + K[0, 0] * cx / cz)) ** 2 + (ys - (K[1, 2] + K[1, 1] * cy / cz)) ** 2
    mask = d2 < (radius * K[0, 0] / cz) ** 2
    bump = np.sqrt(np.maximum(radius ** 2 - d2 * (cz / K[0, 0]) ** 2, 0.0))
    depth[mask] = (cz - bump + rng.normal(0, 3e-4, (H, W)))[mask]
    return mask


def _frame():
    """Two mugs and a bowl (sphere caps at 0.7 m) and an empty detection."""
    rng = np.random.default_rng(0)
    depth = np.zeros((H, W), np.float32)
    dets = [("mug", _cap(depth, (-0.07, -0.03, 0.7), 0.04, rng)),
            ("bowl", _cap(depth, (0.08, -0.02, 0.72), 0.045, rng)),
            ("mug", _cap(depth, (0.0, 0.06, 0.68), 0.035, rng)),
            ("mug", np.zeros((H, W), bool))]
    rgb = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    return rgb, depth, dets


def _instance_draws(key, hw, crop, tuple_size=5):
    """The draws the JAX graphs make from one instance key
    (`cppf2_tpu/eval/driver.py:449` and `:247`), as InstanceDraws."""
    k1, k2 = jax.random.split(key)
    h, w = tfront.window_shape(hw, crop)
    k_tuple, k_dino, k_shot = jax.random.split(k2, 3)
    shape = (PIPE["num_pairs"] * 6, 32)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return tdriver.InstanceDraws(
        t(jax.random.permutation(k1, h * w)), t(jax.random.uniform(jax.random.fold_in(k1, 1), (h * w,))),
        PoseDraws(t(jax.random.uniform(k_tuple, (PIPE["num_pairs"], tuple_size))),
                  t(jax.random.gumbel(k_dino, shape)), t(jax.random.gumbel(k_shot, shape))))


def _rt_angle_deg(a, b):
    """Angle between the rotations of two NOCS RTs (R * |s| in the 3x3 block)."""
    ra, rb = (x[:3, :3] / np.cbrt(np.linalg.det(x[:3, :3])) for x in (a, b))
    return _rot_angle_deg(ra, rb)


def _frame_draws(key, dets, hw, buckets=(1, 2, 4, 8)):
    """One InstanceDraws per detection, from the keys `dispatch_frame` of the
    JAX driver hands out (`driver.py:515`, `:579-580`): singles first, in
    detection order, then each (category, tier) group's chunk, whose keys are
    split to the chunk's bucket size."""
    draws = [None] * len(dets)
    groups = {}
    for idx, (name, mask) in enumerate(dets):
        tier = tfront.auto_crop(mask)
        if tier is None:
            key, sub = jax.random.split(key)
            draws[idx] = _instance_draws(sub, hw, None)
        else:
            groups.setdefault((name, tier), []).append(idx)
    for (name, tier), members in groups.items():
        assert len(members) <= buckets[-1]
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, next(b for b in buckets if b >= len(members)))
        for k, idx in zip(keys, members):
            draws[idx] = _instance_draws(k, hw, tier)
    return draws


@pytest.fixture(scope="module")
def frame_reference():
    """The frame, both packages' models with the same weights, and the JAX
    driver's answer for key 3."""
    rgb, depth, dets = _frame()
    ext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**VIT, attn_impl="pallas", attn_block_q=128),
                                     stride=STRIDE, out_size=OUT)
    ext.init_random(hw=(OUT, OUT))
    jmodels = jdriver.load_category_models("ckpts_r3", ["mug", "bowl"], infer_dtype="float32")
    key = jax.random.key(3)
    want = jdriver.fetch_frames(jdriver.dispatch_frame(rgb, depth, dets, K, jmodels, JPipe(**PIPE), key,
                                                       dino_extractor=ext))
    tvit = load_vit(tdino.DinoViT(tdino.ViTConfig(**VIT)), jax.device_get(ext.params)).eval()
    tmodels = tdriver.load_category_models("ckpts_r3", ["mug", "bowl"], torch.float32, "cpu")
    return rgb, depth, dets, want, tvit, tmodels, _frame_draws(key, dets, depth.shape)


def test_dispatch_frame_matches_jax(frame_reference):
    """Two groups (two mugs; one bowl), the ViT stage batched over the three
    crops, and an empty detection on the singles route: the same `None`, R
    within 0.5 deg, T within 2 mm, unit scales rtol 1e-3 (the tolerance of the
    per-instance slice after the alignment's Adam steps)."""
    rgb, depth, dets, want, tvit, tmodels, draws = frame_reference
    pends = tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, TPipe(**PIPE), vit=tvit,
                                   device="cpu", draws=draws, stride=STRIDE, out_size=OUT)
    assert [type(p).__name__ for p in pends] == ["PendingFrameGroup", "PendingFrameGroup", "tuple"]
    assert [p.idxs for p in pends[:2]] == [(0, 2), (1,)] and pends[2][0] == 3
    got, picks = tdriver.fetch_frames(pends, return_picks=True)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert got[3] is None and want[3] is None
    for i in (0, 1, 2):
        (rt, scales, loss), (jrt, jscales, jloss) = got[i], want[i]
        sn, jsn = np.cbrt(np.linalg.det(rt[:3, :3])), np.cbrt(np.linalg.det(jrt[:3, :3]))
        assert _rt_angle_deg(rt, jrt) < 0.5
        np.testing.assert_allclose(rt[:3, 3], jrt[:3, 3], atol=2e-3)
        np.testing.assert_allclose(sn, jsn, rtol=1e-3)
        np.testing.assert_allclose(scales, jscales, rtol=1e-3)
        np.testing.assert_allclose(loss, jloss, rtol=0.05)
        assert picks[i] in (0, 1)


def test_frame_results_do_not_depend_on_the_grouping(frame_reference):
    """Each instance of the frame through `dispatch_instance` with its own
    draws gives the frame's answer: the grids of the batched ViT forward
    differ from the single-image ones only in float32 rounding, so R 0.5 deg,
    T 2 mm and the same pick. Generator draws go in detection order."""
    rgb, depth, dets, _, tvit, tmodels, draws = frame_reference
    pipe = TPipe(**PIPE)
    kw = dict(vit=tvit, device="cpu", stride=STRIDE, out_size=OUT)
    frame, fpicks = tdriver.fetch_frames(
        tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, pipe, draws=draws, **kw), return_picks=True)
    singles, spicks = tdriver.fetch_instances(
        [tdriver.dispatch_instance(rgb, depth, m, K, tmodels[name], name, pipe, draws=d, **kw)
         for (name, m), d in zip(dets, draws)], return_picks=True)
    assert singles[3] is None
    for i in (0, 1, 2):
        assert _rt_angle_deg(frame[i][0], singles[i][0]) < 0.5
        np.testing.assert_allclose(frame[i][0][:3, 3], singles[i][0][:3, 3], atol=2e-3)
        assert fpicks[i] == spicks[i]
    # from a generator: detection order, whatever the grouping
    a = tdriver.fetch_frames(tdriver.dispatch_frame(
        rgb, depth, dets[:3], K, tmodels, pipe, generator=torch.Generator().manual_seed(5), **kw))
    gen = torch.Generator().manual_seed(5)
    b = tdriver.fetch_instances([tdriver.dispatch_instance(rgb, depth, m, K, tmodels[name], name, pipe,
                                                           generator=gen, **kw) for name, m in dets[:3]])
    for i in range(3):
        assert _rt_angle_deg(a[i][0], b[i][0]) < 0.5
        np.testing.assert_allclose(a[i][0][:3, 3], b[i][0][:3, 3], atol=2e-3)
    with pytest.raises(ValueError, match="draws"):
        tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, pipe, draws=draws[:2], **kw)


def test_oversize_mask_takes_the_singles_route(frame_reference):
    """A mask wider than every crop tier goes through `dispatch_instance`
    with `crop=None` (the whole frame), geometry only here; at buckets
    (1, 2) five crops of three groups (2, 2 and 1 instances) pack into
    three ViT forwards of at most two crops."""
    rgb, depth, dets, _, tvit, tmodels, _ = frame_reference
    rng = np.random.default_rng(1)
    big = np.zeros((H, W), bool)
    big[60:180, 1:319] = True
    depth2 = np.where(big, 0.8 + 0.05 * np.sin(np.mgrid[0:H, 0:W][1] / 40.0)
                      + rng.normal(0, 3e-4, (H, W)), 0).astype(np.float32)
    assert tfront.auto_crop(big) is None
    pipe = TPipe(**PIPE)
    d = tdriver.draw_instance((H, W), big, "bowl", pipe, "cpu", torch.Generator().manual_seed(1))
    assert d.voxel_perm.shape == (H * W,)
    pends = tdriver.dispatch_frame(rgb, depth2, [("bowl", big)], K, tmodels, pipe, device="cpu", draws=[d])
    assert len(pends) == 1 and pends[0][0] == 0
    got = tdriver.fetch_frames(pends)[0]
    want = tdriver.fetch_instances([tdriver.dispatch_instance(
        rgb, depth2, big, K, tmodels["bowl"], "bowl", pipe, device="cpu", draws=d, crop=None)])[0]
    np.testing.assert_array_equal(got[0], want[0])
    # the cap on one ViT forward is the largest bucket: 5 crops at buckets (1, 2) are 3 forwards
    calls = []
    orig = tdriver.bbox_crop_token_grid
    tdriver.bbox_crop_token_grid = lambda vit, rgb_t, masks, **kw: (calls.append(len(masks)),
                                                                   orig(vit, rgb_t, masks, **kw))[1]
    try:
        five = [dets[0], dets[1], dets[2], dets[0], dets[1]]
        out = tdriver.fetch_frames(tdriver.dispatch_frame(
            rgb, depth, five, K, tmodels, pipe, generator=torch.Generator().manual_seed(2), vit=tvit,
            device="cpu", stride=STRIDE, out_size=OUT, buckets=(1, 2), run_opt=False))
    finally:
        tdriver.bbox_crop_token_grid = orig
    assert calls == [2, 2, 1] and sorted(out) == [0, 1, 2, 3, 4]
    assert all(v is not None for v in out.values())


def test_estimate_instance_equals_dispatch_and_fetch(frame_reference):
    """`estimate_instance` returns the raw estimate of the very graph that
    `dispatch_instance` packs; `fetch_instances` assembles it."""
    rgb, depth, dets, _, tvit, tmodels, draws = frame_reference
    pipe = TPipe(**PIPE)
    for use_visual, use_geo, run_opt in ((None, True, True), (False, True, False), (True, False, True)):
        kw = dict(vit=tvit, device="cpu", draws=draws[1], stride=STRIDE, out_size=OUT,
                  run_opt=run_opt, use_visual=use_visual, use_geo=use_geo)
        est = tdriver.estimate_instance(rgb, depth, dets[1][1], K, tmodels["bowl"], "bowl", pipe, **kw)
        (rt, scales, loss), pick = (x[0] for x in tdriver.fetch_instances(
            [tdriver.dispatch_instance(rgb, depth, dets[1][1], K, tmodels["bowl"], "bowl", pipe, **kw)],
            return_picks=True))
        want_rt, want_scales = tdriver._assemble_rt(est.rotation.numpy(), est.translation.numpy(),
                                                    est.scale.numpy(), float(est.scale_norm))
        np.testing.assert_allclose(rt, want_rt, atol=1e-6)
        np.testing.assert_allclose(scales, want_scales, atol=1e-6)
        assert loss == pytest.approx(float(est.loss)) and pick == int(est.pick)
        if use_visual is False:
            assert pick == 1
        if not use_geo:
            assert pick == 0
    assert tdriver.fetch_instances([]) == [] and tdriver.fetch_frames([]) == {}
    with pytest.raises(ValueError):
        tdriver.estimate_instance(rgb, depth, dets[1][1], K, tmodels["bowl"], "bowl", pipe,
                                  device="cpu", draws=draws[1], use_visual=False, use_geo=False)


def test_degenerate_instances_come_back_as_none(frame_reference):
    """Fewer than 32 points, or a cloud wider than 1000 voxels: None, as in
    the JAX driver (`_finalize_instance`), whose function gives the same
    verdict on the same fetched values."""
    rgb, depth, dets, _, _, tmodels, _ = frame_reference
    pipe = TPipe(**PIPE)
    gen = torch.Generator().manual_seed(0)
    tiny = np.zeros((H, W), bool)
    tiny[100:104, 100:104] = True
    depth_t = np.where(tiny, 0.7, depth).astype(np.float32)
    wide = np.zeros((H, W), bool)
    wide[100:140, 60:260] = True
    res = T_CATEGORIES["mug"].res
    far = np.where(np.mgrid[0:H, 0:W][1] < 160, 0.5, 0.5 + 1100 * res)
    depth_w = np.where(wide, far, 0).astype(np.float32)
    pends = [tdriver.dispatch_instance(rgb, d, m, K, tmodels["mug"], "mug", pipe, generator=gen,
                                       device="cpu", run_opt=False)
             for d, m in ((depth_t, tiny), (depth_w, wide), (depth, dets[0][1]))]
    out = tdriver.fetch_instances(pends)
    assert out[0] is None and out[1] is None and out[2] is not None
    for p, o in zip(pends, out):
        row = p.dev.numpy()
        want = jdriver._finalize_instance(p.res, (row[0], row[1:4], row[4:13].reshape(3, 3), row[13:16],
                                                  row[16:19], row[19], row[20]))
        assert (want is None) == (o is None)
        if o is not None:
            np.testing.assert_allclose(o[0], want[0], atol=1e-7)
            np.testing.assert_allclose(o[1], want[1], atol=1e-7)
    assert int(pends[0].dev[0]) < 32 <= int(pends[1].dev[0])
    assert float(pends[1].dev[1:4].max()) / res > 1000


def _border_masks():
    masks = {}
    for name, (ys, xs) in {"top": ((0, 30), (140, 200)), "bottom": ((215, 240), (10, 70)),
                           "left": ((90, 150), (0, 25)), "right": ((60, 100), (290, 320)),
                           "corner": ((0, 12), (0, 9)), "middle": ((100, 130), (150, 170)),
                           "all": ((0, 240), (0, 320))}.items():
        m = np.zeros((H, W), bool)
        m[ys[0]:ys[1], xs[0]:xs[1]] = True
        masks[name] = m
    masks["empty"] = np.zeros((H, W), bool)
    return masks


@pytest.mark.parametrize("name", sorted(_border_masks()))
@pytest.mark.parametrize("crop", [64, 128, 256, 320])
def test_crop_origin_equals_the_device_computation(name, crop):
    """The host arithmetic against the device's (which the JAX frontend
    shares), on masks at every border, an empty one and a full one; and
    `preprocess_frame` given the origin equals the one that computes it."""
    mask = _border_masks()[name]
    want = tfront._crop_origin_on_device(torch.from_numpy(mask), crop)
    assert tfront.crop_origin(mask, mask.shape, crop) == want
    if crop == 128 and name in ("corner", "right"):
        rng = np.random.default_rng(0)
        depth = torch.from_numpy(np.where(mask, 0.6 + 0.01 * rng.normal(size=(H, W)), 0).astype(np.float32))
        h, w = tfront.window_shape((H, W), crop)
        perm, prio = torch.randperm(h * w), torch.rand(h * w)
        args = (depth, torch.from_numpy(mask), torch.from_numpy(K), perm, prio)
        a = tfront.preprocess_frame(*args, res=2e-3, n_max=64, shot_k=8, crop=crop)
        b = tfront.preprocess_frame(*args, res=2e-3, n_max=64, shot_k=8, crop=crop, origin=want)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert b.window_yx.tolist() == list(want)


def test_single_branch_restarts_match_jax():
    """Best of three restarts of the geometric branch, the reference's keys
    (`pipeline.py:372-380`): the voted pose to the ulp, the same winner."""
    jpipe, tpipe = JPipe(n_points=512, num_pairs=1000, angle_tol_deg=5.0), \
        TPipe(n_points=512, num_pairs=1000, angle_tol_deg=5.0)
    fi, _ = _features()
    jshot_m, shot_p, _, _, tshot_m, _ = _models()
    cat = J_CATEGORIES["mug"]
    key = jax.random.key(4)
    from cppf2_tpu.core.geometry import fibonacci_sphere

    sph = jnp.asarray(fibonacci_sphere(jpipe.sphere_samples))

    @jax.jit
    def run(sp, key):
        return jpipeline.estimate_pose_branch_restarts(
            lambda p, pts, ti: jshot_m.apply({"params": p["params"]}, pts, fi.shot, fi.normal, ti), sp,
            fi.pc, fi.valid, fi.count, key, cat, jpipe, sph, restarts=3, run_opt=False)

    want = run(shot_p, key)
    draws = []
    for k in jax.random.split(key, 3):
        k1, k2 = jax.random.split(k)
        draws.append(BranchDraws(torch.from_numpy(np.array(jax.random.uniform(k1, (1000, 5)))),
                                 torch.from_numpy(np.array(jax.random.gumbel(k2, (6000, 32))))))
        assert np.array_equal(np.floor(draws[-1].tuple_u.numpy() * int(fi.count)),
                              np.asarray(j_tuple_choice(k1, fi.count, 1000, 5)))
    pc, valid, shot, normal = (torch.from_numpy(np.array(x)) for x in (fi.pc, fi.valid, fi.shot, fi.normal))
    with torch.no_grad():
        got = tpipeline.estimate_pose_branch_restarts(
            lambda pts, ti: tshot_m(pts, shot, normal, ti), pc, valid, torch.tensor(int(fi.count)),
            T_CATEGORIES["mug"], tpipe, draws=draws, restarts=3, run_opt=False)
        again = tpipeline.estimate_pose_branch_restarts(
            lambda pts, ti: tshot_m(pts, shot, normal, ti), pc, valid, torch.tensor(int(fi.count)),
            T_CATEGORIES["mug"], tpipe, generator=torch.Generator().manual_seed(0), restarts=2,
            run_opt=False)
    assert got.pick is None and torch.isfinite(again.loss)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-6)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-6)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-4)
    with pytest.raises(ValueError):
        tpipeline.estimate_pose_branch_restarts(lambda pts, ti: None, pc, valid, torch.tensor(1),
                                                T_CATEGORIES["mug"], tpipe, draws=draws, restarts=2)


def test_dispatch_instance_with_extractor_matches_jax(frame_reference):
    """The JAX driver's visual route (the masked RGB cropped on the host to
    256 x 256, DinoFeatureExtractor at stride 8 here, where the card runs
    stride 4: 1025 tokens keep the CPU run short; the cloud's pixels mapped
    into the crop) through `dispatch_instance` in both packages, the same
    extractor weights (embed 1024, depth 1, f32, the "hbm" attention of the
    JAX extractor off the TPU) and the JAX draws: the aligned pose within R
    0.5 deg, T 2 mm, unit scales rtol 1e-3, as the slice's other pose
    tests. The route needs no `vit`; giving both raises."""
    rgb, depth, dets, _, _, tmodels, _ = frame_reference
    jext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**VIT), stride=STRIDE)
    jext.init_random(hw=(256, 256), seed=1)
    text = tdino.DinoFeatureExtractor(params=jax.device_get(jext.params),
                                      cfg=tdino.ViTConfig(**VIT, attn_impl="hbm"), stride=STRIDE,
                                      device="cpu")
    jmodels = jdriver.load_category_models("ckpts_r3", ["mug"], infer_dtype="float32")
    key = jax.random.key(11)
    mask = dets[0][1]
    want = jdriver.fetch_instances([jdriver.dispatch_instance(
        rgb, depth, mask, K, jmodels["mug"], "mug", JPipe(**PIPE), key, dino_extractor=jext)])[0]
    draws = _instance_draws(key, depth.shape, tfront.auto_crop(mask))
    pipe = TPipe(**PIPE)
    got = tdriver.fetch_instances([tdriver.dispatch_instance(
        rgb, depth, mask, K, tmodels["mug"], "mug", pipe, device="cpu", draws=draws,
        dino_extractor=text)])[0]
    (rt, scales, _), (jrt, jscales, _) = got, want
    assert _rt_angle_deg(rt, jrt) < 0.5
    np.testing.assert_allclose(rt[:3, 3], jrt[:3, 3], atol=2e-3)
    np.testing.assert_allclose(scales, jscales, rtol=1e-3)
    est = tdriver.estimate_instance(rgb, depth, mask, K, tmodels["mug"], "mug", pipe, device="cpu",
                                    draws=draws, dino_extractor=text)
    np.testing.assert_allclose(tdriver._assemble_rt(est.rotation.numpy(), est.translation.numpy(),
                                                    est.scale.numpy(), float(est.scale_norm))[0], rt,
                               atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        tdriver.dispatch_instance(rgb, depth, mask, K, tmodels["mug"], "mug", pipe, device="cpu",
                                  draws=draws, dino_extractor=text, vit=text.model)


def test_dispatch_frame_with_extractor_runs_its_backbone(frame_reference):
    """`dispatch_frame(dino_extractor=)`: the grouped instances go through
    the extractor's backbone at its stride and crop size, which equals the
    `vit=` route with that backbone exactly (and so the JAX driver's frame,
    held above); the oversized mask takes the singles route through the
    extractor's host crop and equals `dispatch_instance` with it."""
    rgb, depth, dets, _, tvit, tmodels, draws = frame_reference
    pipe = TPipe(**PIPE)
    text = tdino.DinoFeatureExtractor(params=tport.vit_to_tree(tvit), cfg=tvit.cfg, stride=STRIDE,
                                      out_size=OUT, device="cpu")
    a = tdriver.fetch_frames(tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, pipe, device="cpu",
                                                    draws=draws, dino_extractor=text))
    b = tdriver.fetch_frames(tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, pipe, vit=tvit,
                                                    device="cpu", draws=draws, stride=STRIDE,
                                                    out_size=OUT))
    assert sorted(a) == sorted(b) == [0, 1, 2, 3] and a[3] is None
    for i in (0, 1, 2):
        np.testing.assert_array_equal(a[i][0], b[i][0])
    big = np.zeros((H, W), bool)
    big[60:180, 1:319] = True
    depth2 = np.where(big, 0.8 + 0.05 * np.sin(np.mgrid[0:H, 0:W][1] / 40.0)
                      + np.random.default_rng(1).normal(0, 3e-4, (H, W)), 0).astype(np.float32)
    assert tfront.auto_crop(big) is None
    d = tdriver.draw_instance((H, W), big, "bowl", pipe, "cpu", torch.Generator().manual_seed(3))
    got = tdriver.fetch_frames(tdriver.dispatch_frame(rgb, depth2, [("bowl", big)], K, tmodels, pipe,
                                                      device="cpu", draws=[d], dino_extractor=text,
                                                      run_opt=False))[0]
    want = tdriver.fetch_instances([tdriver.dispatch_instance(
        rgb, depth2, big, K, tmodels["bowl"], "bowl", pipe, device="cpu", draws=d, crop=None,
        dino_extractor=text, run_opt=False)])[0]
    np.testing.assert_array_equal(got[0], want[0])


def _flush_pending():
    """A frame of nothing, which takes what earlier calls left outside a frame."""
    with profiling.frame_span("dispatch"):
        pass


def test_a_frame_is_one_record_that_its_fetch_joins(frame_reference):
    """One `dispatch_frame` and `fetch_frames`: one frame record, `dispatch`
    its root, a draw made before it counted in it, the uploads of the groups
    (depth, K, masks, origins, rgb) and of the single (depth, mask, K)
    counted with their bytes, the ViT stage's tokens and gate elements, and
    the fetch in the same record."""
    rgb, depth, dets, _, tvit, tmodels, draws = frame_reference
    pipe = TPipe(**PIPE)
    _flush_pending()
    prev = profiling.tracing(True)
    try:
        tdriver.draw_instance((H, W), dets[0][1], "mug", pipe, "cpu", torch.Generator().manual_seed(0))
        pends = tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, pipe, vit=tvit, device="cpu",
                                       draws=draws, stride=STRIDE, out_size=OUT)
        n = len(profiling.frames())
        tdriver.fetch_frames(pends)
    finally:
        profiling.tracing(prev)
    recs = profiling.frames()
    rec = recs[-1]
    assert len(recs) == n and rec.traced
    assert {p.frame if hasattr(p, "idxs") else p[1].frame for p in pends} == {rec.id}
    assert {k: v[0] for k, v in rec.spans.items()} == {
        "draws": 1, "dispatch": 1, "plan": 1, "single": 1, "upload": 8, "vit": 1, "stack": 2,
        "group": 2, "fetch": 1}
    assert rec.counters == {"instances": 4, "singles": 1, "uploads": 8, "eager_runs": 5,
                            "upload_bytes": 2 * depth.nbytes + 2 * K.nbytes + 4 * H * W + 3 * 2 * 4
                            + rgb.nbytes,
                            # the ViT stage's three crops of 4 x 4 patches and a class token;
                            # the GELU backbone gates nothing
                            "vit_tokens": 3 * (4 * 4 + 1), "gate_elems": 0}
    parents = {(name, parent) for name, parent, _, _ in rec.intervals}
    assert parents == {("draws", None), ("dispatch", None), ("fetch", None), ("plan", "dispatch"),
                       ("single", "dispatch"), ("upload", "single"), ("upload", "dispatch"),
                       ("vit", "dispatch"), ("stack", "dispatch"), ("group", "dispatch")}
    root = next(i for i in rec.intervals if i[0] == "dispatch")
    assert rec.start_ns <= root[2] <= root[3] <= rec.end_ns


@pytest.mark.parametrize("visual", [True, False], ids=["visual", "geometric"])
def test_the_stages_of_a_frame_in_order(frame_reference, visual):
    """`stage_log()` around a frame: the single (the empty mask: zero
    descriptors on the visual route), the ViT stage, then each group's
    stages; `descriptors` only where the chunk has a visual stage."""
    rgb, depth, dets, _, tvit, tmodels, draws = frame_reference
    pose = ["targets", "targets", "center_vote", "backvote", "cone_vote", "align", "finish", "finish"]
    with profiling.stage_log() as log:
        tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, TPipe(**PIPE), vit=tvit, device="cpu",
                               draws=draws, stride=STRIDE, out_size=OUT, use_visual=visual)
    single = ["frontend", *(["mlps"] if visual else []), "mlps", *pose, "finish"]
    group = ["frontend", *(["descriptors"] if visual else []), "mlps", *pose, "finish"]
    assert log == single + (["vit"] if visual else []) + group * 2
