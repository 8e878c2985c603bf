"""Trained two-branch ensemble accuracy benchmark (synthetic, all categories).

Counterpart of `scripts/ensemble_benchmark.py`. The reference's inference
contract is the SHOT + DINO ensemble with per-branch reconstruction-loss
arbitration (eval.py:219, 358-372). Per category this script

  1. loads the SHOT-branch checkpoint (`--shot-ckpts`);
  2. trains the DINO branch on textured, randomly lit renders through the
     ViT extractor (a fixed random backbone: no pretrained weights ship with
     the repo; the path is the real one), or loads it (`--eval-only`);
  3. evaluates the ensemble (both branches competing, best of N restarts)
     on `--frames` held-out frames, with the per-branch pick rate,
     per-frame errors, Wilson intervals and the NOCS mAP artifacts, and
     optionally each branch alone (`--per-branch-cats`).

    python -m cppf2_torch.scripts.ensemble_benchmark --eval-only ckpts_r3 \\
        --shot-ckpts ckpts_r3 --frames 100 --stride 8

(RESULTS.md's reference table, `benchmarks/r5_production/`). The seeded
random ViT-L/14 and the frames are the JAX script's
(`models/jax_random.py`). Each unit is a program (`eval/programs.py`),
keyed as the JAX script keys its `jax.jit`: the synthetic frame, the
instance frontend, the extractor, and the ensemble of each variant and
branch choice (`CategoryModels.pose_fn`), captured once on the card and
replayed. A frame's voxel and pose draws come from a torch.Generator seeded
1000 + i, the counterpart of `jax.random.key(1000 + i)`; every variant and
branch choice of a frame takes the same draws, as many restarts' as it
runs. `draws=` hands in others (the tests hand in the JAX script's).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from cppf2_torch.config import CATEGORIES, PipelineConfig
from cppf2_torch.core.downsample import draw_downsample
from cppf2_torch.data.synthetic import SyntheticFrameGenerator
from cppf2_torch.device import resolve_device
from cppf2_torch.eval.driver import CategoryModels, _frontend
from cppf2_torch.eval.pose_errors import fetch_rt_pairs, pose_error_degree_cm
from cppf2_torch.infer.pipeline import draw_pose
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.dinov2 import DinoFeatureExtractor, load_backbone
from cppf2_torch.models.porting import load_branch, vit_to_tree
from cppf2_torch.scripts.synthetic_benchmark import SHOT_K, score, train_one
from cppf2_torch.train.checkpoints import export_params_msgpack
from cppf2_torch.train.driver import _frame_descriptors


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for a binomial rate."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return (max(0.0, mid - half), min(1.0, mid + half))


def _load_branch(module, path, device):
    """`module` with the params.msgpack at `path` on `device`, or None when
    there is no such file."""
    if not os.path.exists(path):
        return None
    return load_branch(module, load_params_msgpack(path)).to(resolve_device(device)).eval()


def load_shot_params(shot_root, cat_name, cat, device="cuda"):
    """The SHOT branch of `{shot_root}/shot/<cat>/params.msgpack` on
    `device`, or None when there is none."""
    return _load_branch(ShotBranch(tuple_size=cat.tuple_size),
                        os.path.join(shot_root, "shot", cat_name, "params.msgpack"), device)


def frame_draws(i: int, n_pixels: int, cat, pipe: PipelineConfig, restarts: int, device):
    """A frame's draws from a generator seeded 1000 + i: the voxel
    permutation and priorities, then one PoseDraws per restart."""
    g = torch.Generator(device=device).manual_seed(1000 + i)
    perm, prio = draw_downsample(n_pixels, device, g)
    return perm, prio, [draw_pose(cat, pipe, device, g) for _ in range(restarts)]


@torch.no_grad()
def eval_ensemble(cat_name, shot_model, dino_model, extractor, n_frames, pipe, n_points, seed,
                  progress, per_branch=False, variants=None, device="cuda", draws=None):
    """Held-out evaluation through the two-branch ensemble graph.

    `variants` ({name: PipelineConfig}) runs several pipeline
    configurations over the same frames, descriptors and draws, a paired
    comparison for the price of the extra pose graphs only; the first one
    feeds the headline summary and the mAP rows. `draws(i, n_pixels)` ->
    (perm, prio, [PoseDraws per restart]) replaces `frame_draws`. Returns
    (rows, errors, picks, handle visibility, summary, per-variant arrays)."""
    dev = resolve_device(device)
    cat = CATEGORIES[cat_name]
    gen = SyntheticFrameGenerator(cat, n_max=n_points, shot_k=SHOT_K, seed=seed + 77, device=dev)
    cls_id = cat.category_id
    variants = variants or {"base": pipe}
    models = CategoryModels(shot_model, dino_model)
    pose_variants = {n: (models.pose_fn(cat, vp, True), vp.restarts) for n, vp in variants.items()}
    pose_each = ([(models.pose_fn(cat, pipe, True, True, False), pipe.restarts),
                  (models.pose_fn(cat, pipe, True, False, True), pipe.restarts)]
                 if per_branch else [])
    restarts = max(r for _, r in list(pose_variants.values()) + pose_each)
    draws = draws or (lambda i, n: frame_draws(i, n, cat, pipe, restarts, dev))

    def to_row(fetched, i, handle_vis):
        rt, scales, gt_rt, gt_scales, pick = fetched
        res = {
            "image_path": f"synth_{i}",
            "gt_class_ids": np.array([cls_id]),
            "gt_RTs": gt_rt[None],
            "gt_scales": gt_scales[None],
            "gt_handle_visibility": np.array([handle_vis]),
            "pred_class_ids": np.array([cls_id]),
            "pred_RTs": rt[None],
            "pred_scales": scales[None],
            "pred_scores": np.array([1.0]),
        }
        err = pose_error_degree_cm(rt, gt_rt, cat_name, handle_visibility=handle_vis)
        return res, err, int(pick)

    vnames = list(pose_variants)
    results, vis = [], []
    verrs = {n: [] for n in vnames}
    vpicks = {n: [] for n in vnames}
    branch_errs = {"dino": [], "shot": []}
    t0 = time.time()
    for i in range(n_frames):
        f = gen.next_frame()
        handle_vis = getattr(gen, "last_handle_visible", 1)
        vis.append(handle_vis)
        perm, prio, pose = draws(i, f.depth.numel())
        pose = [type(p)(*(t.to(dev) for t in p)) for p in pose]
        fi = _frontend(f.depth, f.depth > 0, gen.intrinsics, perm.to(dev), prio.to(dev), None,
                       cat.res, n_points, SHOT_K, None)
        desc = _frame_descriptors(f._replace(pixel_yx=fi.pixel_yx), extractor)
        # every variant and per-branch graph queued first, then one host copy a frame
        ests = [fn(fi.pc, fi.valid, fi.count, desc, fi.shot, fi.normal, pose[:r])
                for fn, r in list(pose_variants.values()) + pose_each]
        fetched = fetch_rt_pairs(ests, f, extras_per_est=[(e.pick,) for e in ests])
        for vn, vals in zip(vnames, fetched):
            row, err, pick = to_row(vals, i, handle_vis)
            vpicks[vn].append(pick)
            verrs[vn].append(err)
            if vn == vnames[0]:
                results.append(row)
        for name, vals in zip(("dino", "shot"), fetched[len(vnames):]):
            branch_errs[name].append(to_row(vals, i, handle_vis)[1])
        if (i + 1) % 25 == 0:
            progress(f"[{cat_name}] eval {i + 1}/{n_frames} "
                     f"({(time.time() - t0) / (i + 1):.2f} s/frame)")

    def variant_summary(errs, picks):
        errs = np.asarray(errs)
        picks = np.asarray(picks)
        ok = (errs[:, 0] < 5) & (errs[:, 1] < 5)
        lo, hi = wilson_ci(int(ok.sum()), len(ok))
        return errs, picks, ok, {
            "median_deg": float(np.median(errs[:, 0])),
            "median_cm": float(np.median(errs[:, 1])),
            "deg5cm5": float(ok.mean()),
            "deg5cm5_ci95": [lo, hi],
            "visual_pick_rate": float(np.mean(picks == 0)),
            "n_frames": n_frames,
        }

    errs, picks, ok, out = variant_summary(verrs[vnames[0]], vpicks[vnames[0]])
    progress(f"[{cat_name}] {n_frames} frames: median {out['median_deg']:.1f} deg "
             f"/ {out['median_cm']:.2f} cm, 5d5cm {out['deg5cm5']:.3f} "
             f"{[round(c, 2) for c in out['deg5cm5_ci95']]}, "
             f"visual-pick {out['visual_pick_rate']:.2f}")
    if len(vnames) > 1:
        out["variants"] = {}
        for vn in vnames:
            vout = variant_summary(verrs[vn], vpicks[vn])[3]
            out["variants"][vn] = vout
            progress(f"[{cat_name}]   variant {vn}: 5d5cm {vout['deg5cm5']:.3f} "
                     f"{[round(c, 2) for c in vout['deg5cm5_ci95']]}, "
                     f"visual-pick {vout['visual_pick_rate']:.2f}")
    if per_branch:
        for name in ("dino", "shot"):
            be = np.asarray(branch_errs[name])
            okb = (be[:, 0] < 5) & (be[:, 1] < 5)
            out[f"{name}_only_deg5cm5"] = float(okb.mean())
            out[f"{name}_only_median_deg"] = float(np.median(be[:, 0]))
    # per-frame per-variant arrays for paired analysis artifacts
    arrays = {}
    if len(vnames) > 1:
        for vn in vnames:
            slug = vn.replace("=", "_")
            arrays[f"errs__{slug}"] = np.asarray(verrs[vn])
            arrays[f"picks__{slug}"] = np.asarray(vpicks[vn])
    return results, errs, picks, np.asarray(vis), out, arrays


def _extractor(args) -> DinoFeatureExtractor:
    if not args.backbone:
        return DinoFeatureExtractor(stride=args.stride, device=args.device).init_random(
            hw=(256, 256), seed=args.seed)
    # a trained compact backbone (train/driver.py --branch dino-e2e): the
    # architecture and the crop / stride convention come from the json sidecar
    loaded = load_backbone(args.backbone, device="cpu")
    if loaded is None:
        raise FileNotFoundError(f"no backbone at {args.backbone}.msgpack")
    vit, cfg, stride, out_size = loaded
    print(f"[setup] trained backbone {args.backbone}: d={cfg.embed_dim} depth={cfg.depth} "
          f"stride={stride}")
    return DinoFeatureExtractor(params=vit_to_tree(vit), cfg=cfg, stride=stride,
                                out_size=out_size, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--categories", nargs="+", default=list(CATEGORIES))
    ap.add_argument("--dino-steps", type=int, default=20000)
    ap.add_argument("--dino-steps-asym", type=int, default=30000,
                    help="training budget for mug/camera (hard categories)")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--n-points", type=int, default=4096)
    ap.add_argument("--tuples", type=int, default=8192)
    ap.add_argument("--pool", type=int, default=100)
    ap.add_argument("--refresh-every", type=int, default=50)
    ap.add_argument("--num-pairs", type=int, default=20000)
    ap.add_argument("--restarts", type=int, default=3)
    ap.add_argument("--shot-ckpts", default="ckpts_r2")
    ap.add_argument("--save-ckpts", default="runs/ckpts",
                    help="where trained dino params (and a copy of the shot params) go")
    ap.add_argument("--per-branch-cats", nargs="*", default=["mug", "camera"],
                    help="also evaluate each branch alone for these categories")
    ap.add_argument("--stride", type=int, default=4,
                    help="ViT descriptor stride (4 = reference eval setting, 8 = the "
                         "4x-faster production candidate)")
    ap.add_argument("--eval-only", default=None, metavar="DINO_CKPT_ROOT",
                    help="skip training: load dino params from {root}/dino/{cat}/params.msgpack "
                         "(e.g. ckpts_r3) and only run the ensemble eval")
    ap.add_argument("--scale-mode", default=None, choices=["pair", "head", "split"],
                    help="canonical->metric rescale override (PipelineConfig.scale_mode); "
                         "default None = each category's own default ('head' for mug)")
    ap.add_argument("--arbiter", default=None, choices=["recon", "cross", "margin"],
                    help="ensemble branch-selection rule (PipelineConfig.arbiter)")
    ap.add_argument("--arbiter-margin", type=float, default=None)
    ap.add_argument("--compare", nargs="*", default=None, metavar="FIELD=VALUE",
                    help="paired variant comparison: each token overrides one PipelineConfig "
                         "field on the base config and is evaluated on the same frames (e.g. "
                         "--compare arbiter=recon arbiter=cross arbiter=margin). The first "
                         "variant feeds the headline summary and the mAP artifact set.")
    ap.add_argument("--backbone", default=None,
                    help="prefix of a trained compact backbone (train/driver.py --branch "
                         "dino-e2e artifacts: {prefix}.msgpack + {prefix}.json) to use for the "
                         "visual extractor instead of a random ViT-L")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="runs/ensemble")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.time()

    extractor = _extractor(args)
    over = {k: v for k, v in (("arbiter", args.arbiter), ("arbiter_margin", args.arbiter_margin))
            if v is not None}
    pipe = PipelineConfig(n_points=args.n_points, num_pairs=args.num_pairs, restarts=args.restarts,
                          scale_mode=args.scale_mode, **over)
    variants = None
    if args.compare:
        variants = {}
        for tok in args.compare:
            field, _, raw = tok.partition("=")
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
            variants[tok] = dataclasses.replace(pipe, **{field: val})
    os.makedirs(args.out, exist_ok=True)
    all_results, summary = [], {}
    for cat_name in args.categories:
        cat = CATEGORIES[cat_name]
        shot_model = load_shot_params(args.shot_ckpts, cat_name, cat, args.device)
        if shot_model is None:
            raise FileNotFoundError(f"no SHOT checkpoint for {cat_name} under {args.shot_ckpts}")
        if args.eval_only:
            # the descriptor width follows the extractor (384 for a trained
            # compact backbone, 1024 for ViT-L)
            path = os.path.join(args.eval_only, "dino", cat_name, "params.msgpack")
            dino_model = _load_branch(DinoBranch(tuple_size=cat.tuple_size,
                                                 desc_dim=extractor.cfg.embed_dim), path,
                                      args.device)
            if dino_model is None:
                raise FileNotFoundError(f"no dino checkpoint at {path}")
        else:
            hard = cat_name in ("mug", "camera")
            # mug trains on every frame: hidden-handle frames are
            # yaw-canonicalized by the generator (map_sym), so their center
            # and scale targets are clean signal, not label noise
            dino_model = train_one(cat_name, args.dino_steps_asym if hard else args.dino_steps,
                                   args.n_points, args.tuples, 150 if hard else args.pool,
                                   args.seed, print, refresh_every=args.refresh_every,
                                   branch="dino", extractor=extractor, handle_visible=False,
                                   device=args.device)
            if args.save_ckpts:
                path = export_params_msgpack(
                    os.path.join(args.save_ckpts, "dino", cat_name, "params.msgpack"), dino_model)
                print(f"[{cat_name}] saved dino params {path}")
                # a complete set per run: the shot params copied beside them
                src = os.path.join(args.shot_ckpts, "shot", cat_name, "params.msgpack")
                dst = os.path.join(args.save_ckpts, "shot", cat_name, "params.msgpack")
                if os.path.abspath(src) != os.path.abspath(dst):
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copyfile(src, dst)

        results, errs, picks, vis, cat_summary, varrays = eval_ensemble(
            cat_name, shot_model, dino_model, extractor, args.frames, pipe, args.n_points,
            args.seed, print, per_branch=cat_name in (args.per_branch_cats or []),
            variants=variants, device=args.device)
        all_results += results
        summary[cat_name] = cat_summary
        np.savez(os.path.join(args.out, f"errors_{cat_name}.npz"),
                 errs=errs, picks=picks, handle_visible=vis, **varrays)
        # the summary so far, checkpointed as the run goes
        with open(os.path.join(args.out, "summary_partial.json"), "w") as f:
            json.dump(summary, f, indent=2)

    out = {"per_category": summary, **score(all_results, args.out),
           "frames_per_cat": args.frames, "restarts": args.restarts, "num_pairs": args.num_pairs}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    dev = resolve_device(args.device)
    print(f"[ensemble] {len(args.categories)} categories x {args.frames} frames in "
          f"{time.time() - t_start:.1f} s on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'the CPU'}")
    return out


if __name__ == "__main__":
    main()
