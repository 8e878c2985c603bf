"""The output check's control: the plain reference put in the program's place
one precision step below what the configuration states
(`reference/precision.py`: the ViT and the branch MLPs with float8 e4m3
operands, the float32 pose graph's products in TF32), held against the
reference itself on a cell's frames and draws.

Its readings are the upper ends that the limits in `limits/<cell>.json`
are set below; the benchmark's own runs never run it. On the card:

    python3 -m perfbench.control --workload <cell> --seeds 11,12,13

prints one JSON line per seed with the numbers `perfbench/check.py`
compares. The draws are the reference's own (`draw_downsample`,
`draw_pose`), from a torch.Generator seeded as a run seeds it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import torch

from perfbench import check
from perfbench.harness import _sampled, routes
from perfbench.reference import precision
from perfbench.reference.config import CATEGORIES
from perfbench.reference.downsample import draw_downsample
from perfbench.reference.frontend import auto_crop, window_shape
from perfbench.reference.pipeline import draw_pose
from perfbench.reference.pose import Reference
from perfbench.scenes.generate import REAL275_INTRINSICS, frame_set


def readings(cfg: Dict, mix: Dict, seed: int, device) -> Dict[str, float]:
    """The control's numbers against the reference on the frames a run of
    `seed` samples."""
    dev = torch.device(device)
    frames = frame_set(mix, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    ref = Reference(cfg, seed, dev)
    gaps, desc, route = [], [], []
    for i in _sampled(mix, seed, frames, len(frames)):
        f = frames[i]
        route += routes(f.dets, cfg["buckets"])
        for cat, mask in f.dets:
            h, w = window_shape(f.depth.shape, auto_crop(mask))
            perm, prio = draw_downsample(h * w, dev, gen)
            pose = draw_pose(CATEGORIES[cat], ref.pipe, dev, gen)
            exact = ref.instance(f.rgb, f.depth, mask, cat, REAL275_INTRINSICS, perm, prio, pose)
            with precision.lower():
                low = ref.instance(f.rgb, f.depth, mask, cat, REAL275_INTRINSICS, perm, prio, pose)
            gaps.append(check.instance_gaps(low.row, exact.row, cat))
            tiered = auto_crop(mask) is not None
            desc.append(check.rel_l2(low.grid if tiered else low.desc, exact.grid if tiered else exact.desc))
    return check.summarize(gaps, desc, route)


def main(argv=None) -> int:
    from perfbench import spec

    ap = argparse.ArgumentParser(description="the output check's control on a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, mix = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = readings(cfg, mix, seed, "cuda")
        correct, _ = check.judge(numbers, limits)
        print(json.dumps({"workload": cell["name"], "seed": seed, "control_correct": correct,
                          "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
