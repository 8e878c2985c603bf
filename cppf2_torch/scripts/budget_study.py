"""Point-budget sensitivity study.

Counterpart of `scripts/budget_study.py`. The reference caps eval clouds at
50k points after 2 mm voxel downsampling (eval.py:196-198); this framework
uses a fixed `n_points` budget with uniform random overflow dropping
(core/downsample.py). A close-range instance easily occupies more than 8192
voxels: this script measures what that overflow costs, as per-frame
occupied-voxel counts and the pose error at several budgets, on close-range
(z in 0.6-0.9 m) frames of one category, with the in-repo checkpoint
(`ckpts/shot/<cat>/params.msgpack`).

    python -m cppf2_torch.scripts.budget_study --category can --frames 15

The occupancy count (the whole frame downsampled at a budget of 65536) is
one program; each budget's frontend and pose graph are programs of their
own, keyed on the budget as the JAX script's jit closes over it. Frame i's
voxel and pose draws come from a torch.Generator seeded 1000 + i, the
counterpart of `jax.random.key(1000 + i)`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from cppf2_torch.config import CATEGORIES, PipelineConfig
from cppf2_torch.core.downsample import draw_downsample, voxel_downsample
from cppf2_torch.core.geometry import backproject_masked
from cppf2_torch.data.synthetic import SyntheticFrameGenerator
from cppf2_torch.device import resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import ShotBranch
from cppf2_torch.models.porting import load_branch
from cppf2_torch.scripts.config_validation import print_programs, rate_ci
from cppf2_torch.scripts.synthetic_benchmark import SHOT_K, error_summary, pose_study

OCCUPANCY_BUDGET = 65536
RECORD = "benchmarks/budget_study.json"   # the JAX script's report, taken on a TPU
# the occupancy programs, keyed on the voxel size and the frame's shape
_PROGRAMS: dict = {}


def occupancy(depth: torch.Tensor, intrinsics: torch.Tensor, res: float) -> torch.Tensor:
    """The occupied `res` voxels of a frame's whole depth map, uncapped: its
    voxel downsample's count at a budget of 65536, as a program. The count
    does not depend on the draws (a generator seeded 0 makes them)."""
    g = torch.Generator(device=depth.device).manual_seed(0)
    perm, prio = draw_downsample(depth.numel(), depth.device, g)

    def fn(depth, k_t, perm, prio):
        pts, _, valid = backproject_masked(depth, k_t, depth > 0)
        return voxel_downsample(pts, valid, res, OCCUPANCY_BUDGET, perm, prio).count

    args = (depth, intrinsics, perm, prio)
    return programs.program(_PROGRAMS, ("occupancy", res), fn, args)(*args)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--category", default="can")
    ap.add_argument("--frames", type=int, default=15)
    ap.add_argument("--budgets", type=int, nargs="+", default=[4096, 8192, 16384])
    ap.add_argument("--num-pairs", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpts", default="ckpts")
    ap.add_argument("--out", default="runs/budget_study.json")
    ap.add_argument("--record", default=RECORD, help="a recorded report to print the run beside")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cat = CATEGORIES[args.category]
    packed = os.path.join(args.ckpts, "shot", args.category, "params.msgpack")
    model = load_branch(ShotBranch(tuple_size=cat.tuple_size),
                        load_params_msgpack(packed)).to(dev).eval()
    print(f"loaded {packed}")

    # close-range frames: z in (0.6, 0.9) maximizes occupied 2 mm voxels
    gen = SyntheticFrameGenerator(cat, n_max=max(args.budgets), shot_k=SHOT_K,
                                  seed=args.seed + 77, z_range=(0.6, 0.9), device=dev)
    frames = [gen.next_frame() for _ in range(args.frames)]
    print(f"rendered {len(frames)} close-range frames")

    with programs.recorded() as used:
        occ = np.asarray([int(occupancy(f.depth, gen.intrinsics, cat.res)) for f in frames])
        print(f"occupied 2mm voxels: median {int(np.median(occ))}, max {occ.max()}, min {occ.min()}")
        report = {
            "category": args.category,
            "frames": args.frames,
            "median_occupied_voxels": int(np.median(occ)),
            "max_occupied_voxels": int(occ.max()),
            "budgets": {},
        }
        for budget in args.budgets:
            pipe = PipelineConfig(n_points=budget, num_pairs=args.num_pairs)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            errs, _ = pose_study(model, frames, gen.intrinsics, args.category, pipe, budget,
                                 device=dev)
            if dev.type == "cuda":
                print(f"budget {budget}: peak device memory allocated "
                      f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
            kept = np.minimum(occ, budget) / np.maximum(occ, 1)
            row = {**error_summary(errs), "mean_kept_fraction": float(kept.mean()),
                   "sec": round(time.time() - t0, 1)}
            report["budgets"][str(budget)] = row
            print(f"budget {budget}: {row}")
    print_programs(used, "budget_study")

    if os.path.exists(args.record):
        with open(args.record) as f:
            beside_record(report, json.load(f))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


def beside_record(report: dict, record: dict) -> None:
    """Print the occupancy and each budget's rate (with its Wilson interval)
    beside a recorded report's."""
    print(f"occupied voxels median {report['median_occupied_voxels']}, max "
          f"{report['max_occupied_voxels']} | record {record['median_occupied_voxels']}, "
          f"{record['max_occupied_voxels']}")
    for budget, row in report["budgets"].items():
        rec = record["budgets"].get(budget)
        if rec is None:
            continue
        print(f"budget {budget}: 5d5cm {rate_ci(row['deg5cm5'], report['frames'])} | record "
              f"{rate_ci(rec['deg5cm5'], record['frames'])}; median deg {row['median_deg']:.2f} | "
              f"record {rec['median_deg']:.2f}; kept {row['mean_kept_fraction']:.4f} | record "
              f"{rec['mean_kept_fraction']:.4f}")


if __name__ == "__main__":
    main()
