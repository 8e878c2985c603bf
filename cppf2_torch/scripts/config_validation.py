"""Production-config validation table: category x {exact,approx-kNN} x {f32,bf16}.

Counterpart of `scripts/config_validation.py`. The production configuration
took two throughput shortcuts, the quantized-key kNN route
(`ops/neighbors.py`) and bf16 branch-MLP inference. For each category and
each of {approx, exact} x {bfloat16, float32} this script poses the same
held-out frames (generator seed + 77) with the trained SHOT branch
(`--ckpts`, one pass, no restarts) and reports the median rotation and
translation error and the 5°5cm rate under the JAX script's keys.

    python -m cppf2_torch.scripts.config_validation --frames 30

The bf16 and f32 configurations are `ShotBranch(compute_dtype=...)` over one
loaded msgpack. The instance frontend is a program keyed on `exact_knn`, and
each model's pose graph is a program keyed on its weights, the counterpart
of the JAX script's jit, which takes the params as an argument: approx and
exact share it. Frame i's voxel and pose draws come from a torch.Generator
seeded 1000 + i, the counterpart of `jax.random.key(1000 + i)`; `draws=`
hands in others (the tests hand in the JAX script's).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from cppf2_torch.config import CATEGORIES, PipelineConfig
from cppf2_torch.data.synthetic import SyntheticFrameGenerator
from cppf2_torch.device import resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import ShotBranch
from cppf2_torch.models.porting import load_branch
from cppf2_torch.scripts.ensemble_benchmark import wilson_ci
from cppf2_torch.scripts.synthetic_benchmark import SHOT_K, error_summary, pose_study

DTYPES = ("bfloat16", "float32")
RECORD = "benchmarks/config_validation.json"   # the JAX script's table, taken on a TPU
RECORD_FRAMES = 30                             # its frames a category (RESULTS.md)


def shot_models(path: str, cat, device="cuda") -> dict:
    """{dtype name: ShotBranch computing in it} for `DTYPES`, each loaded
    from the one params.msgpack at `path`."""
    tree = load_params_msgpack(path)
    dev = resolve_device(device)
    return {dt: load_branch(ShotBranch(tuple_size=cat.tuple_size, compute_dtype=getattr(torch, dt)),
                            tree).to(dev).eval()
            for dt in DTYPES}


def eval_config(cat_name, model, frames, pipe, n_points, seed, exact_knn, device="cuda",
                draws=None):
    """`frames` posed by `model` (one dtype's ShotBranch) with the kNN
    route `exact_knn`: the summary of their errors."""
    cat = CATEGORIES[cat_name]
    gen = SyntheticFrameGenerator(cat, n_max=n_points, shot_k=SHOT_K, seed=seed + 77, device=device)
    errs, _ = pose_study(model, frames, gen.intrinsics, cat_name, pipe, n_points,
                         exact_knn=exact_knn, device=device, draws=draws)
    return error_summary(errs)


def rate_ci(rate: float, n: int) -> str:
    """A 5°5cm rate over n frames with its Wilson 95% interval."""
    lo, hi = wilson_ci(round(rate * n), n)
    return f"{rate:.3f} [{lo:.3f}, {hi:.3f}]"


def beside_record(table: dict, record: dict, frames: int) -> None:
    """Print each cell's rate with its interval beside the recorded cell's,
    and whether it lies inside the recorded interval; then per category the
    largest |bf16 - f32| and |approx - exact| in rate and in median deg."""
    for cat_name, row in table.items():
        for key, r in row.items():
            rec = record.get(cat_name, {}).get(key)
            if rec is None:
                continue
            lo, hi = wilson_ci(round(rec["deg5cm5"] * RECORD_FRAMES), RECORD_FRAMES)
            print(f"[{cat_name}] {key}: 5d5cm {rate_ci(r['deg5cm5'], frames)} | record "
                  f"{rate_ci(rec['deg5cm5'], RECORD_FRAMES)} | "
                  f"{'inside' if lo <= r['deg5cm5'] <= hi else 'OUTSIDE'}; median deg "
                  f"{r['median_deg']:.2f} | record {rec['median_deg']:.2f}")
        for name, pairs in (("bf16 - f32", [(f"{k}_bfloat16", f"{k}_float32")
                                            for k in ("approx", "exact")]),
                            ("approx - exact", [(f"approx_{d}", f"exact_{d}") for d in DTYPES])):
            pairs = [(row[a], row[b]) for a, b in pairs if a in row and b in row]
            if pairs:
                print(f"[{cat_name}] largest |{name}|: rate "
                      f"{max(abs(a['deg5cm5'] - b['deg5cm5']) for a, b in pairs):.3f}, median deg "
                      f"{max(abs(a['median_deg'] - b['median_deg']) for a, b in pairs):.2f}")


def print_programs(used, label: str) -> None:
    """One line on the programs a run called (`programs.recorded`)."""
    progs = list(used.values())
    print(f"[{label}] {len(progs)} programs ({sum(m for *_, m in progs)} made), "
          f"{sum(p.replays - r0 for p, r0, _, _ in progs)} replays, "
          f"{sum(p.eager_runs - e0 for p, _, e0, _ in progs)} eager runs")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--categories", nargs="+", default=list(CATEGORIES))
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--n-points", type=int, default=4096)
    ap.add_argument("--num-pairs", type=int, default=20000)
    ap.add_argument("--ckpts", default="ckpts_r2")
    ap.add_argument("--out", default="runs/config_validation.json")
    ap.add_argument("--record", default=RECORD, help="a recorded table to print the run beside")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    pipe = PipelineConfig(n_points=args.n_points, num_pairs=args.num_pairs)
    table = {}
    with programs.recorded() as used:
        for cat_name in args.categories:
            cat = CATEGORIES[cat_name]
            models = shot_models(os.path.join(args.ckpts, "shot", cat_name, "params.msgpack"), cat,
                                 dev)
            # fixed frame set shared by all four configs
            gen = SyntheticFrameGenerator(cat, n_max=args.n_points, shot_k=SHOT_K,
                                          seed=args.seed + 77, device=dev)
            frames = [gen.next_frame() for _ in range(args.frames)]
            table[cat_name] = {}
            for exact in (False, True):
                for dtype in DTYPES:
                    t0 = time.time()
                    r = eval_config(cat_name, models[dtype], frames, pipe, args.n_points, args.seed,
                                    exact, dev)
                    key = f"{'exact' if exact else 'approx'}_{dtype}"
                    table[cat_name][key] = r
                    print(f"[{cat_name}] {key}: {json.dumps(r)} ({time.time() - t0:.0f}s)")
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(table, f, indent=2)
    print_programs(used, "config_validation")
    if os.path.exists(args.record):
        with open(args.record) as f:
            beside_record(table, json.load(f), args.frames)
    print(json.dumps(table, indent=2))
    return table


if __name__ == "__main__":
    main()
