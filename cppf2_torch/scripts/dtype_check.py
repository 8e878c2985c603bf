"""Validate bf16 inference against f32 on a trained checkpoint.

Counterpart of `scripts/dtype_check.py`: one round-2 msgpack checkpoint
loaded into float32 and bfloat16 ShotBranch models, the same held-out
frames (generator seed 123) posed through the full inference path with
both (`PipelineConfig(num_pairs=...)`, 8192 points), per-frame (deg, cm)
errors side by side. The gate for making bf16 the production inference
dtype.

    python -m cppf2_torch.scripts.dtype_check --category can --frames 15

Each model's pose graph is a program keyed on its weights, as the JAX
script's jit closes over the model. Frame i's voxel and pose draws come from
a torch.Generator seeded 500 + i, the counterpart of
`jax.random.key(500 + i)`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cppf2_torch.config import CATEGORIES, PipelineConfig
from cppf2_torch.data.synthetic import SyntheticFrameGenerator
from cppf2_torch.device import resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.scripts.config_validation import print_programs, shot_models
from cppf2_torch.scripts.synthetic_benchmark import SHOT_K, pose_study


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--category", default="can")
    ap.add_argument("--frames", type=int, default=15)
    ap.add_argument("--ckpts", default="ckpts_r2")
    ap.add_argument("--num-pairs", type=int, default=50000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cat = CATEGORIES[args.category]
    pipe = PipelineConfig(num_pairs=args.num_pairs)
    n = pipe.n_points
    models = shot_models(os.path.join(args.ckpts, "shot", args.category, "params.msgpack"), cat, dev)

    gen = SyntheticFrameGenerator(cat, n_max=n, shot_k=SHOT_K, seed=123, device=dev)
    frames = [gen.next_frame() for _ in range(args.frames)]

    results = {}
    with programs.recorded() as used:
        for dt in ("float32", "bfloat16"):
            errs, _ = pose_study(models[dt], frames, gen.intrinsics, args.category, pipe, n,
                                 seed_base=500, device=dev)
            results[dt] = errs
            print(f"{dt}: median {np.median(errs[:, 0]):.2f} deg / "
                  f"{np.median(errs[:, 1]):.2f} cm, "
                  f"5d5cm {np.mean((errs[:, 0] < 5) & (errs[:, 1] < 5)):.2f}")
    print_programs(used, "dtype_check")

    d = results["bfloat16"][:, 0] - results["float32"][:, 0]
    print(f"per-frame deg delta (bf16 - f32): median {np.median(d):+.2f}, "
          f"max {np.abs(d).max():.2f}")
    return results


if __name__ == "__main__":
    main()
