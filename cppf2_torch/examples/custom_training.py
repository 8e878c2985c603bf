"""End-to-end example: train on synthetic renders, then pose a held-out frame.

Counterpart of `examples/custom_training.py`, the framework analog of the
reference's train_custom.ipynb (render 1000 views -> dump -> train both
branches -> infer on a real frame): rendering, feature extraction and
training run online on the device, and a held-out RGB-D frame of the same
synthetic pipeline goes through the inference path (depth -> cloud -> SHOT
-> vote -> alignment) and is scored against its ground-truth pose.

    python -m cppf2_torch.examples.custom_training --category can --steps 600

With --quick it runs a reduced-size smoke. The frames, the train steps and
the held-out frame's frontend and pose graph are programs
(`eval/programs.py`): captured on the card once, the steps replayed. The
weights and frames of a seed are the JAX example's (`models/jax_random.py`);
a step's tuples come from a torch.Generator seeded with its number, and the
held-out frame's draws from generators seeded 7 (voxels) and 8 (tuples and
bins), the counterparts of the JAX example's keys; `step_draws=` and
`test_draws=` hand in others.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cppf2_torch.config import CATEGORIES, PipelineConfig, TrainConfig
from cppf2_torch.core.downsample import draw_downsample
from cppf2_torch.data.synthetic import SyntheticFrameGenerator
from cppf2_torch.device import resolve_device
from cppf2_torch.eval.driver import _frontend
from cppf2_torch.eval.pose_errors import pose_error_degree_cm
from cppf2_torch.infer.pipeline import draw_branch
from cppf2_torch.models.cppf import ShotBranch
from cppf2_torch.parallel.mesh import make_mesh, world_of_one
from cppf2_torch.scripts.synthetic_benchmark import _branch_pose
from cppf2_torch.train.loop import create_train_state, make_train_step

SHOT_K = 32


def held_out_draws(n_pixels: int, cat, pipe: PipelineConfig, device):
    """(perm, prio, tuple_u, gumbel) of the held-out frame."""
    perm, prio = draw_downsample(n_pixels, device, torch.Generator(device=device).manual_seed(7))
    bd = draw_branch(cat, pipe, device, torch.Generator(device=device).manual_seed(8))
    return perm, prio, bd.tuple_u, bd.gumbel


def run(category="can", steps=600, n_points=1024, tuples_per_step=4096, num_pairs=8192,
        pool_frames=24, render_hw=(240, 320), seed=0, progress=print, device="cuda",
        step_draws=None, test_draws=None):
    """Train the SHOT branch of `category` for `steps` steps on a pool of
    rendered frames, then pose one held-out frame. Returns its rotation,
    translation and scale errors and the first and last losses."""
    dev = resolve_device(device)
    cat = CATEGORIES[category]
    # the default steps_per_epoch=200 keeps the reference's StepLR cadence
    # (the lr halves every 5000 steps, train_shot.py:124-130)
    cfg = TrainConfig(tuples_per_step=tuples_per_step, n_points=n_points, seed=seed)
    gen = SyntheticFrameGenerator(cat, n_max=n_points, height=render_hw[0], width=render_hw[1],
                                  shot_k=SHOT_K, seed=seed, device=dev)
    progress(f"[e2e] generating {pool_frames} training frames...")
    t0 = time.time()
    pool = [gen.next_frame() for _ in range(pool_frames)]
    progress(f"[e2e] rendered in {time.time() - t0:.1f}s")

    model = ShotBranch(tuple_size=cat.tuple_size)

    def to_batch(f):
        return {"pc": f.pc[None], "pc_canon": f.pc_canon[None], "shot": f.shot[None],
                "normal": f.normal[None], "bound": f.bound[None], "count": f.count[None]}

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev)
    with world_of_one(dev.type):
        state = create_train_state(model, cfg, device=dev, seed=seed)
        step = make_train_step(model, cfg, branch="shot", mesh=make_mesh(device=dev))
        t0 = time.time()
        first = None
        for i in range(steps):
            f = pool[int(rng.integers(0, pool_frames))]
            if step_draws is not None:
                state, metrics = step(state, to_batch(f), tuple_u=step_draws(i))
            else:
                state, metrics = step(state, to_batch(f), generator=g.manual_seed(i))
            if i == 0:
                first = float(metrics["total"])
            if i % max(1, steps // 10) == 0:
                progress(f"[e2e] step {i}: loss={float(metrics['total']):.3f}")
        last = float(metrics["total"])
    progress(f"[e2e] trained {steps} steps in {time.time() - t0:.1f}s: "
             f"loss {first:.3f} -> {last:.3f}")

    # the held-out frame through the inference path
    gen_test = SyntheticFrameGenerator(cat, n_max=n_points, height=render_hw[0],
                                       width=render_hw[1], shot_k=SHOT_K, seed=seed + 1000,
                                       device=dev)
    test = gen_test.next_frame()
    pipe = PipelineConfig(n_points=n_points, num_pairs=num_pairs, opt_steps=100)
    perm, prio, tuple_u, gumbel = (test_draws or held_out_draws)(test.depth.numel(), cat, pipe, dev)
    with torch.no_grad():
        fi = _frontend(test.depth, test.depth > 0, gen_test.intrinsics, perm.to(dev), prio.to(dev),
                       None, cat.res, n_points, SHOT_K, None)
        est = _branch_pose(state.module.eval(), cat, pipe, 1, "shot")(
            fi.pc, fi.valid, fi.count, (fi.shot, fi.normal), tuple_u[None].to(dev),
            gumbel[None].to(dev))

    rt_est, rt_gt = np.eye(4), np.eye(4)
    rt_est[:3, :3] = est.rotation.cpu().numpy()
    rt_est[:3, 3] = est.translation.cpu().numpy()
    rt_gt[:3, :3] = test.rotation.cpu().numpy()
    rt_gt[:3, 3] = test.translation.cpu().numpy()
    err = pose_error_degree_cm(rt_est, rt_gt, category)
    # the predicted anisotropic bound against the ground-truth bound vector
    scale_err = float((est.scale - test.bound).abs().max())
    progress(f"[e2e] held-out pose error: {err[0]:.1f} deg, {err[1]:.2f} cm; "
             f"scale err {scale_err * 100:.1f} cm; loss first/last {first:.2f}/{last:.2f}")
    return {
        "rot_err_deg": float(err[0]),
        "trans_err_cm": float(err[1]),
        "scale_err_cm": float(scale_err * 100),
        "loss_first": first,
        "loss_last": last,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--category", default="can")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.quick:
        return run(args.category, steps=150, n_points=512, tuples_per_step=2048, num_pairs=4096,
                   pool_frames=8, device=args.device)
    return run(args.category, steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
