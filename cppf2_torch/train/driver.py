"""Training driver: train a category branch on frames it renders itself or
replays from a record container.

Counterpart of `cppf2_tpu/train/driver.py` (which replaces the reference's
hydra + Lightning entry points, train_shot.py:133-150, train_dino.py:142-161):
frames come from the synthetic generator (`data/synthetic.py`) or from a
`data/records.py` container, through a pool that is refreshed one frame a
step; batches are data-parallel over the ranks of the process group, and
checkpoints and metrics go to `out_dir`.

On the card the JAX driver's compiled programs are captured CUDA graphs
(`eval/programs.py`), replayed after their first call: every step (the train
step's program), every rendered frame (the frame programs of
`data/synthetic.py`) and, for "dino", every frame's descriptors (the
extractor's program). Between two step replays only the picked batch and
the step's uniforms go up; the metrics are read at `log_every`.

Usage (one process per device; a single process starts a world of one):
    python -m cppf2_torch.train.driver --category mug --branch shot \
        --epochs 101 --steps-per-epoch 200 --out ckpts/shot/mug
    python -m cppf2_torch.train.driver --category mug --branch shot --records mug.rec ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cppf2_torch.config import CATEGORIES, TrainConfig
from cppf2_torch.data.records import RecordReader
from cppf2_torch.data.synthetic import SynthFrame, SyntheticFrameGenerator, to_host
from cppf2_torch.infer.frontend import mask_bbox, resize_crop
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.dinov2 import (VIT_S14, DinoFeatureExtractor, DinoViT, ViTConfig,
                                       save_backbone)
from cppf2_torch.parallel.mesh import axis_size, make_mesh, world_of_one
from cppf2_torch.train.checkpoints import (
    export_params_msgpack,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from cppf2_torch.train.loop import TrainState, create_train_state, make_train_step
from cppf2_torch.train.visual import create_visual_train_state, make_visual_train_step

_FEATURES = {"shot": ("shot", "normal"), "dino": ("desc",), "dino-e2e": ("crop", "kp")}


def _frame_crop_kp(frame: SynthFrame, out_size: int = 256):
    """Host-side crop and keypoints shared by the frozen-backbone descriptor
    pass and end-to-end visual training: the lambertian render cropped to
    its depth bbox squared and resized to `out_size` (the reference's
    resize_crop convention, dataset.py:322-337), and the cloud's pixels in
    crop space. One copy back from the device.

    Returns (crop (S, S, 3) float32 in [0, 1], kp_local (N, 2) float32 (x, y))."""
    host = to_host(frame, ("gray", "depth", "pixel_yx"))
    bbox = mask_bbox(host["depth"] > 0)
    rgb = np.repeat(host["gray"][..., None], 3, axis=-1)
    crop, transform = resize_crop(rgb, bbox=bbox, out_size=out_size)
    kp = host["pixel_yx"][:, ::-1].astype(np.float64)
    kp_local = (np.linalg.inv(transform) @ np.concatenate([kp, np.ones((len(kp), 1))], -1).T).T[:, :2]
    return crop.astype(np.float32), kp_local.astype(np.float32)


def _frame_descriptors(frame: SynthFrame, extractor: DinoFeatureExtractor,
                       out_size: Optional[int] = None) -> torch.Tensor:
    """Descriptors of a synthetic frame's cloud points: the render cropped
    around its depth bbox and the extractor's tokens sampled at the cloud's
    pixels (the analog of dump_data's descriptor pass, dataset.py:394-402).
    `out_size` follows the extractor's crop convention by default. Returns
    (n, D) on the extractor's device."""
    crop, kp_local = _frame_crop_kp(frame, out_size or extractor.out_size)
    return extractor(torch.from_numpy(crop), torch.from_numpy(kp_local))


def train_category(
    category: str,
    branch: str = "shot",
    cfg: Optional[TrainConfig] = None,
    out_dir: Optional[str] = None,
    n_points: int = 2048,
    batch_per_device: int = 1,
    frames_in_pool: int = 64,
    resume: bool = True,
    log_every: int = 20,
    ckpt_every_epochs: int = 10,
    render_hw: Tuple[int, int] = (480, 640),
    dino_extractor: Optional[DinoFeatureExtractor] = None,
    records: Optional[str] = None,
    progress=print,
    vit_cfg: Optional[ViTConfig] = None,
    e2e_stride: int = 8,
    e2e_out_size: int = 256,
    backbone_lr_scale: float = 1.0,
    device="cuda",
) -> TrainState:
    """Train one branch ("shot", "dino" or "dino-e2e") for one category on
    the initialized process group, one rank per device. Returns the final
    TrainState (every rank holds the same one).

    A pool of `frames_in_pool` frames is filled first and one slot is
    replaced after every step, the analog of the reference's replay buffer
    (dataset.py:341-364). Without `records` the frames are rendered by
    `SyntheticFrameGenerator(cat, n_max=n_points, height, width = render_hw,
    seed=cfg.seed)` and every replacement is a newly rendered frame; the
    "dino" branch stores each frame's descriptors from `dino_extractor`, by
    default a fixed random ViT-L/14 `DinoFeatureExtractor` at stride 4, the
    JAX package's `init_random(hw=(256, 256), seed=cfg.seed)` (no DINOv2
    weights ship with the repo; a fixed backbone still gives consistent
    features), and "dino-e2e" stores the
    crop and the cloud's pixels in it. With `records`, a container written by
    `data/records.py` with the fields pc, pc_canon, bound, count and the
    branch's features (shot + normal; desc; or crop + kp), the pool holds
    stored records and a replacement is another one. Picks come from
    `np.random.default_rng(cfg.seed + 1)` in the JAX driver's order. Rank 0
    writes `metrics.jsonl`, the checkpoints and, for "dino-e2e", the exported
    `params.msgpack` + `backbone.msgpack/.json` under `out_dir`.
    """
    if branch not in _FEATURES:
        raise ValueError(f"unknown branch {branch!r} (expected one of {sorted(_FEATURES)})")
    cat = CATEGORIES[category]
    cfg = cfg or TrainConfig(n_points=n_points)
    mesh = make_mesh(device=device)
    batch_size = batch_per_device * axis_size(mesh, "data")
    rank0 = dist.get_rank() == 0
    keys = ("pc", "pc_canon", "bound", "count") + _FEATURES[branch]

    reader = None
    if records:
        reader = RecordReader(records)
        progress(f"[train] replaying {len(reader)} records from {records} ({reader.backend} backend)")

        def record(i):
            return {k: v[0] for k, v in reader.batch([i]).items()}

        def next_frame(rng):
            return record(int(rng.integers(0, len(reader))))

        pool = [record(i) for i in range(min(frames_in_pool, len(reader)))]
    else:
        synth = SyntheticFrameGenerator(cat, n_max=n_points, height=render_hw[0],
                                        width=render_hw[1], seed=cfg.seed, device=device)
        if branch == "dino" and dino_extractor is None:
            progress("[train] no DINOv2 weights given: using a fixed random backbone")
            dino_extractor = DinoFeatureExtractor(device=device).init_random(hw=(256, 256),
                                                                             seed=cfg.seed)

        def next_frame(rng=None):   # rendered from the generator's own stream
            f = synth.next_frame()
            if branch == "shot":
                return to_host(f, keys)
            out = to_host(f, keys[:4])
            if branch == "dino-e2e":
                out["crop"], out["kp"] = _frame_crop_kp(f, e2e_out_size)
            else:
                out["desc"] = _frame_descriptors(f, dino_extractor).cpu().numpy()
            return out

        progress(f"[train] filling the frame pool ({frames_in_pool})...")
        pool = [next_frame() for _ in range(frames_in_pool)]

    def to_batch(frames):
        return {k: np.stack([f[k] for f in frames]) for k in keys}

    if branch == "dino-e2e":
        if vit_cfg is None:
            # position grid = the training token grid: no bicubic resample in
            # every forward, and evaluation at the same crop and stride matches
            vit_cfg = dataclasses.replace(VIT_S14, pretrain_grid=e2e_out_size // e2e_stride)
        vit_cfg = dataclasses.replace(vit_cfg, attn_impl="hbm")
    if branch == "shot":
        model = ShotBranch(tuple_size=cat.tuple_size, num_bins=cfg.num_bins)
    else:
        desc_dim = vit_cfg.embed_dim if branch == "dino-e2e" else pool[0]["desc"].shape[-1]
        model = DinoBranch(tuple_size=cat.tuple_size, num_bins=cfg.num_bins, desc_dim=desc_dim)
    if branch == "dino-e2e":
        vit_model = DinoViT(vit_cfg)
        state = create_visual_train_state(vit_model, model, cfg, device=device, seed=cfg.seed)
        step_fn = make_visual_train_step(vit_model, model, cfg, out_size=e2e_out_size,
                                         stride=e2e_stride, backbone_lr_scale=backbone_lr_scale,
                                         mesh=mesh)
    else:
        state = create_train_state(model, cfg, device=device, seed=cfg.seed)
        step_fn = make_train_step(model, cfg, branch=branch, mesh=mesh)
    if out_dir and resume:
        last = latest_checkpoint(out_dir)
        if last:
            state = restore_checkpoint(last, state)
            progress(f"[train] resumed from {last} at step {state.step}")

    log_path = os.path.join(out_dir, "metrics.jsonl") if out_dir else None
    if log_path and rank0:
        os.makedirs(out_dir, exist_ok=True)

    rng = np.random.default_rng(cfg.seed + 1)
    step_gen = torch.Generator()
    t0 = time.time()
    start_epoch = state.step // cfg.steps_per_epoch
    for epoch in range(start_epoch, cfg.max_epochs):
        for _ in range(cfg.steps_per_epoch):
            picks = rng.choice(len(pool), size=batch_size)
            batch = to_batch([pool[i] for i in picks])
            step_gen.manual_seed(int(rng.integers(0, 2**31)))
            state, metrics = step_fn(state, batch, generator=step_gen)
            # refresh one pool frame per step: a newly rendered frame, or
            # another stored record
            slot = int(rng.integers(0, len(pool)))
            pool[slot] = next_frame(rng)
            if state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m |= {"step": state.step, "epoch": epoch, "wall": time.time() - t0}
                progress(f"[train] {json.dumps(m)}")
                if log_path and rank0:
                    with open(log_path, "a") as fh:
                        fh.write(json.dumps(m) + "\n")
        if out_dir and ((epoch + 1) % ckpt_every_epochs == 0 or epoch + 1 == cfg.max_epochs):
            if rank0:
                progress(f"[train] saved {save_checkpoint(out_dir, state)}")
            dist.barrier()   # no rank goes on (or resumes) before the checkpoint is whole
    if branch == "dino-e2e" and out_dir and rank0:
        # the pair of artifacts the evaluation side consumes: the tuple head
        # as the standard branch params.msgpack (load_category_models) and the
        # backbone as backbone.msgpack + .json (evaluate_real275's dino_ckpt)
        export_params_msgpack(os.path.join(out_dir, "params.msgpack"), state.module.branch)
        bb = save_backbone(os.path.join(out_dir, "backbone"), state.module.backbone,
                           stride=e2e_stride, out_size=e2e_out_size)
        progress(f"[train] exported branch params.msgpack + {bb}")
    dist.barrier()
    if reader is not None:
        reader.close()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description="train one branch of one category")
    ap.add_argument("--category", required=True, choices=list(CATEGORIES))
    ap.add_argument("--branch", default="shot", choices=sorted(_FEATURES))
    ap.add_argument("--epochs", type=int, default=101)
    ap.add_argument("--steps-per-epoch", type=int, default=200)
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--tuples", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--records", default=None,
                    help="replay a data/records.py container instead of rendering")
    ap.add_argument("--backbone-lr-scale", type=float, default=1.0,
                    help="dino-e2e only: scale backbone grads vs the head")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = TrainConfig(
        lr=args.lr, max_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        tuples_per_step=args.tuples, n_points=args.n_points, seed=args.seed,
    )
    out = args.out or f"ckpts/{args.branch}/{args.category}"
    with world_of_one(args.device):   # a launcher's group (torchrun), or alone a world of one
        train_category(args.category, args.branch, cfg, out, n_points=args.n_points,
                       records=args.records, backbone_lr_scale=args.backbone_lr_scale,
                       device=args.device)


if __name__ == "__main__":
    main()
