"""Synthetic-data accuracy benchmark: train -> eval -> NOCS mAP per category.

Counterpart of `scripts/synthetic_benchmark.py`: for each category, train a
branch on procedurally rendered frames, then pose held-out frames through
the inference path (depth -> cloud -> SHOT -> vote -> backvote -> rotation
-> alignment) and score them with the NOCS-protocol mAP harness (IoU@25/50,
5°5cm / 10°10cm ...). No asset outside the repo is needed.

    python -m cppf2_torch.scripts.synthetic_benchmark --categories can bowl --steps 20000

Every unit runs as a program (`eval/programs.py`), keyed as the JAX script
keys its `jax.jit`: the synthetic frame, the train step, the instance
frontend, the extractor and the branch's pose graph, each captured once on
the card and replayed. A seed means the JAX script's weights and frames (the
init trees and the frame draws of `models/jax_random.py`). The draws of a
train step and of an evaluated frame come from a torch.Generator seeded with
the step's and the frame's number, the counterparts of `jax.random.key(i)`
and `jax.random.key(1000 + i)`; `draws=` hands in others (the tests hand in
the JAX script's).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from cppf2_torch.config import CATEGORIES, SYNSET_NAMES, PipelineConfig, TrainConfig
from cppf2_torch.core.downsample import draw_downsample
from cppf2_torch.data.synthetic import SyntheticFrameGenerator
from cppf2_torch.device import resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.eval.driver import _frontend
from cppf2_torch.eval.nocs_map import compute_degree_cm_map
from cppf2_torch.eval.pose_errors import fetch_rt_pair, pose_error_degree_cm
from cppf2_torch.infer.pipeline import (
    BranchDraws,
    draw_branch,
    estimate_pose_branch,
    estimate_pose_branch_restarts,
)
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.dinov2 import DinoFeatureExtractor
from cppf2_torch.parallel.mesh import make_mesh, world_of_one
from cppf2_torch.train.checkpoints import export_params_msgpack
from cppf2_torch.train.driver import _frame_descriptors
from cppf2_torch.train.loop import create_train_state, make_train_step

SHOT_K = 48
# the branch pose programs, keyed as the JAX script keys its jitted pose functions
_PROGRAMS: dict = {}


def _make_extractor(seed: int, device="cuda", stride: int = 4) -> DinoFeatureExtractor:
    """The fixed random ViT-L/14 of the JAX script: `init_random(hw=(256,
    256), seed)` at stride 4."""
    return DinoFeatureExtractor(stride=stride, device=device).init_random(hw=(256, 256), seed=seed)


class _FramePool:
    """Frames (and, for the dino branch, their visual descriptors) with a
    streaming refresh. The dino branch trains on textured, lit renders
    through the ViT extractor, the end-to-end visual path."""

    def __init__(self, gen, size, branch, extractor=None):
        self.gen, self.branch, self.ext = gen, branch, extractor
        self.frames = [self._one() for _ in range(size)]

    def _one(self):
        f = self.gen.next_frame()
        return f, (_frame_descriptors(f, self.ext) if self.branch == "dino" else None)

    def refresh_one(self, rng):
        self.frames[int(rng.integers(0, len(self.frames)))] = self._one()

    def sample(self, rng):
        return self.frames[int(rng.integers(0, len(self.frames)))]


def train_one(cat_name, steps, n_points, tuples, pool_frames, seed, progress, refresh_every=0,
              branch="shot", extractor=None, handle_visible=False, device="cuda",
              draws: Optional[Callable[[int], torch.Tensor]] = None):
    """Train one branch of one category on a pool of rendered frames; returns
    the trained branch module (on `device`). The default
    TrainConfig.steps_per_epoch (200) keeps the reference's StepLR cadence:
    the lr halves every 25 virtual epochs, 5000 steps (train_shot.py:124-130
    with dataset.py:364's virtual length). Step i's tuples come from a
    generator seeded i, or from `draws(i)` ((1, tuples, tuple_size)
    uniforms). Runs on the process group there is, or a world of one."""
    dev = resolve_device(device)
    cat = CATEGORIES[cat_name]
    cfg = TrainConfig(tuples_per_step=tuples, n_points=n_points, seed=seed)
    gen = SyntheticFrameGenerator(cat, n_max=n_points, shot_k=SHOT_K, seed=seed,
                                  require_handle_visible=handle_visible, device=dev)
    t0 = time.time()
    pool = _FramePool(gen, pool_frames, branch, extractor)
    progress(f"[{cat_name}] rendered {pool_frames} frames in {time.time() - t0:.0f}s")

    if branch == "shot":
        model = ShotBranch(tuple_size=cat.tuple_size)
    else:
        model = DinoBranch(tuple_size=cat.tuple_size, desc_dim=pool.frames[0][1].shape[-1])

    def to_batch(f, desc):
        b = {"pc": f.pc[None], "pc_canon": f.pc_canon[None], "bound": f.bound[None],
             "count": f.count[None]}
        if branch == "shot":
            b["shot"], b["normal"] = f.shot[None], f.normal[None]
        else:
            b["desc"] = desc[None]
        return b

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev)
    with world_of_one(dev.type):
        state = create_train_state(model, cfg, device=dev, seed=seed)
        step = make_train_step(model, cfg, branch=branch, mesh=make_mesh(device=dev))
        t0 = time.time()
        for i in range(steps):
            if refresh_every and i % refresh_every == 0:
                # stream fresh frames through the pool (avoids the pool-overfit
                # cliff found in round 1 on asymmetric categories)
                pool.refresh_one(rng)
            f, desc = pool.sample(rng)
            if draws is not None:
                state, metrics = step(state, to_batch(f, desc), tuple_u=draws(i))
            else:
                state, metrics = step(state, to_batch(f, desc), generator=g.manual_seed(i))
        progress(f"[{cat_name}] {steps} steps in {time.time() - t0:.0f}s, "
                 f"loss {float(metrics['total']):.3f}")
    return state.module.eval()


def frame_draws(i: int, n_pixels: int, cat, pipe: PipelineConfig, restarts: int, device):
    """An evaluated frame's draws from a generator seeded 1000 + i: the voxel
    permutation and priorities, then one BranchDraws per restart."""
    g = torch.Generator(device=device).manual_seed(1000 + i)
    perm, prio = draw_downsample(n_pixels, device, g)
    return perm, prio, [draw_branch(cat, pipe, device, g) for _ in range(restarts)]


def _branch_pose(model, cat, pipe: PipelineConfig, restarts: int, branch: str):
    """The pose graph of one branch as a program: fn(pc, valid, count, feats,
    tuple_u (R, P, k), gumbel (R, P*6, bins)) -> PoseEstimate. One pass
    takes its tuples as floor(u * count), as the JAX script does; restarts
    run as `estimate_pose_branch_restarts`."""
    key = ("branch_pose", branch, cat.name, pipe, restarts, programs.weights(model))

    def fn(pc, valid, count, feats, tuple_u, gumbel):
        def apply(pts, ti):
            return model(pts, *feats, ti)

        if restarts > 1:
            return estimate_pose_branch_restarts(
                apply, pc, valid, count, cat, pipe,
                draws=[BranchDraws(u, gb) for u, gb in zip(tuple_u, gumbel)], restarts=restarts)
        ti = torch.floor(tuple_u[0] * count.to(torch.float32)).to(torch.int32)
        return estimate_pose_branch(apply, pc, valid, count, ti, gumbel[0], cat, pipe)

    def run(*args):
        return programs.program(_PROGRAMS, key, fn, args)(*args)

    return run


@torch.no_grad()
def eval_one(cat_name, model, n_frames, pipe, n_points, seed, progress, branch="shot",
             extractor=None, restarts=1, device="cuda", draws=None):
    """Pose `n_frames` held-out frames (generator seed + 77) with one trained
    branch and score them; returns (NOCS result rows, errors (n, 2),
    handle visibility (n,)). `draws(i, n_pixels)` replaces `frame_draws`."""
    dev = resolve_device(device)
    cat = CATEGORIES[cat_name]
    gen = SyntheticFrameGenerator(cat, n_max=n_points, shot_k=SHOT_K, seed=seed + 77, device=dev)
    pose = _branch_pose(model, cat, pipe, restarts, branch)
    cls_id = cat.category_id
    results, errs, vis = [], [], []
    t0 = time.time()
    for i in range(n_frames):
        f = gen.next_frame()
        handle_vis = getattr(gen, "last_handle_visible", 1)
        vis.append(handle_vis)
        n_pix = f.depth.numel()
        perm, prio, bd = (draws or (lambda i, n: frame_draws(i, n, cat, pipe, restarts, dev)))(i, n_pix)
        fi = _frontend(f.depth, f.depth > 0, gen.intrinsics, perm.to(dev), prio.to(dev), None,
                       cat.res, n_points, SHOT_K, None)
        if branch == "dino":
            # eval-path visual descriptors: the rendered gray image cropped and
            # the ViT grid sampled at the preprocessed cloud's pixels
            feats = (_frame_descriptors(f._replace(pixel_yx=fi.pixel_yx), extractor),)
        else:
            feats = (fi.shot, fi.normal)
        est = pose(fi.pc, fi.valid, fi.count, feats, torch.stack([d.tuple_u for d in bd]).to(dev),
                   torch.stack([d.gumbel for d in bd]).to(dev))
        rt, scales, gt_rt, gt_scales = fetch_rt_pair(est, f)
        results.append({
            "image_path": f"synth_{i}",
            "gt_class_ids": np.array([cls_id]),
            "gt_RTs": gt_rt[None],
            "gt_scales": gt_scales[None],
            "gt_handle_visibility": np.array([handle_vis]),
            "pred_class_ids": np.array([cls_id]),
            "pred_RTs": rt[None],
            "pred_scales": scales[None],
            "pred_scores": np.array([1.0]),
        })
        errs.append(pose_error_degree_cm(rt, gt_rt, cat_name, handle_visibility=handle_vis))
    errs = np.asarray(errs)
    progress(f"[{cat_name}] eval {n_frames} frames in {time.time() - t0:.0f}s: "
             f"median {np.median(errs[:, 0]):.1f} deg / {np.median(errs[:, 1]):.2f} cm")
    return results, errs, np.asarray(vis)


def score(all_results, out_dir):
    """The mAP harness over the rows, its artifacts in `out_dir`: (iou_aps,
    pose_aps), and the means over the categories present."""
    iou_aps, pose_aps = compute_degree_cm_map(
        all_results, SYNSET_NAMES, out_dir,
        degree_thresholds=(5, 10, 15), shift_thresholds=(5, 10, 15),
        iou_3d_thresholds=tuple(np.linspace(0, 1, 101)),
        iou_pose_thres=0.1, use_matches_for_pose=True,
    )
    # mean over the classes present (the harness's index -1 averages every
    # real class, reference-style, which is NaN when a category did not run)
    return {
        "mean_iou25": float(np.nanmean(iou_aps[1:-1, 25])),
        "mean_iou50": float(np.nanmean(iou_aps[1:-1, 50])),
        "mean_5deg5cm": float(np.nanmean(pose_aps[1:-1, 0, 0])),
        "mean_10deg10cm": float(np.nanmean(pose_aps[1:-1, 1, 1])),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--categories", nargs="+", default=list(CATEGORIES))
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--n-points", type=int, default=4096)
    ap.add_argument("--tuples", type=int, default=8192)
    ap.add_argument("--pool", type=int, default=100)
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="replace one pool frame every N steps (0 = static pool)")
    ap.add_argument("--train-handle-visible", action="store_true",
                    help="train only on frames whose mug handle is visible (yaw is "
                         "unobservable otherwise; eval still sees all frames and gates via "
                         "gt_handle_visibility)")
    ap.add_argument("--branch", default="shot", choices=["shot", "dino"],
                    help="geometric (SHOT) or visual (DINO over textured renders)")
    ap.add_argument("--num-pairs", type=int, default=20000)
    ap.add_argument("--restarts", type=int, default=1,
                    help="best-of-N eval restarts, picked by recon loss")
    ap.add_argument("--out", default="runs/synthetic_latest")
    ap.add_argument("--save-ckpts", default=None,
                    help="save trained params under {dir}/{branch}/{category}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    pipe = PipelineConfig(n_points=args.n_points, num_pairs=args.num_pairs)
    extractor = _make_extractor(args.seed, args.device) if args.branch == "dino" else None
    all_results, summary = [], {}
    for cat_name in args.categories:
        model = train_one(cat_name, args.steps, args.n_points, args.tuples, args.pool, args.seed,
                          print, refresh_every=args.refresh_every, branch=args.branch,
                          extractor=extractor, handle_visible=args.train_handle_visible,
                          device=args.device)
        if args.save_ckpts:
            path = export_params_msgpack(
                os.path.join(args.save_ckpts, args.branch, cat_name, "params.msgpack"), model)
            print(f"[{cat_name}] saved params {path}")
        results, errs, vis = eval_one(cat_name, model, args.frames, pipe, args.n_points, args.seed,
                                      print, branch=args.branch, extractor=extractor,
                                      restarts=args.restarts, device=args.device)
        all_results += results
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"errors_{cat_name}.npz"), errs=errs, handle_visible=vis)
        summary[cat_name] = {
            "median_deg": float(np.median(errs[:, 0])),
            "median_cm": float(np.median(errs[:, 1])),
            "deg5cm5": float(np.mean((errs[:, 0] < 5) & (errs[:, 1] < 5))),
        }
    os.makedirs(args.out, exist_ok=True)
    out = {"per_category": summary, **score(all_results, args.out), "steps": args.steps,
           "frames_per_cat": args.frames}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
