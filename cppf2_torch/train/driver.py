"""Training driver: train a category branch from a record container.

Counterpart of `cppf2_tpu/train/driver.py` (which replaces the reference's
hydra + Lightning entry points, train_shot.py:133-150, train_dino.py:142-161):
frames replay from a `data/records.py` container through a pool that is
refreshed one frame a step, batches are data-parallel over the ranks of the
process group, and checkpoints and metrics go to `out_dir`.

Usage (one process per device; a single process starts a world of one):
    python -m cppf2_torch.train.driver --category mug --branch shot \
        --records mug.rec --epochs 101 --steps-per-epoch 200 --out ckpts/shot/mug

The JAX driver can also render its frames on the fly; that generator
(`data/synthetic.py`, `render.py`, `shapes.py`) is not ported yet, so
`records` is required here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cppf2_torch.config import CATEGORIES, TrainConfig
from cppf2_torch.data.records import RecordReader
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.dinov2 import VIT_S14, DinoViT, ViTConfig, save_backbone
from cppf2_torch.parallel.mesh import axis_size, make_mesh
from cppf2_torch.train.checkpoints import (
    export_params_msgpack,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from cppf2_torch.train.loop import TrainState, create_train_state, make_train_step
from cppf2_torch.train.visual import create_visual_train_state, make_visual_train_step

_FEATURES = {"shot": ("shot", "normal"), "dino": ("desc",), "dino-e2e": ("crop", "kp")}


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

    Frames replay from `records`, a container written by `data/records.py`
    with the fields pc, pc_canon, bound, count and the branch's features
    (shot + normal; desc; or crop + kp for "dino-e2e"). A pool of
    `frames_in_pool` records is filled first and one slot is swapped for
    another stored record after every step, the analog of the reference's
    replay buffer (dataset.py:341-364). Picks come from
    `np.random.default_rng(cfg.seed + 1)` in the JAX driver's order. Rank 0
    writes `metrics.jsonl`, the checkpoints and, for "dino-e2e", the exported
    `params.msgpack` + `backbone.msgpack/.json` under `out_dir`.
    """
    if branch not in _FEATURES:
        raise ValueError(f"unknown branch {branch!r} (expected one of {sorted(_FEATURES)})")
    if not records:
        raise NotImplementedError(
            "train_category needs `records`: the synthetic frame generator (data/synthetic.py, "
            "render.py, shapes.py) that the JAX driver renders frames with is not ported yet")
    cat = CATEGORIES[category]
    cfg = cfg or TrainConfig(n_points=n_points)
    mesh = make_mesh(device=device)
    batch_size = batch_per_device * axis_size(mesh, "data")
    rank0 = dist.get_rank() == 0
    keys = ("pc", "pc_canon", "bound", "count") + _FEATURES[branch]

    reader = RecordReader(records)
    progress(f"[train] replaying {len(reader)} records from {records} ({reader.backend} backend)")

    def record(i):
        return {k: v[0] for k, v in reader.batch([i]).items()}

    pool = [record(i) for i in range(min(frames_in_pool, len(reader)))]

    def to_batch(frames):
        return {k: np.stack([f[k] for f in frames]) for k in keys}

    gen = torch.Generator().manual_seed(cfg.seed)
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
        state = create_visual_train_state(vit_model, model, cfg, gen, device=device)
        step_fn = make_visual_train_step(vit_model, model, cfg, out_size=e2e_out_size,
                                         stride=e2e_stride, backbone_lr_scale=backbone_lr_scale,
                                         mesh=mesh)
    else:
        state = create_train_state(model, cfg, gen, device=device)
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
            # swap one pool frame for another stored record per step
            slot = int(rng.integers(0, len(pool)))
            pool[slot] = record(int(rng.integers(0, len(reader))))
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
    reader.close()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description="train one branch of one category from records")
    ap.add_argument("--category", required=True, choices=list(CATEGORIES))
    ap.add_argument("--branch", default="shot", choices=sorted(_FEATURES))
    ap.add_argument("--epochs", type=int, default=101)
    ap.add_argument("--steps-per-epoch", type=int, default=200)
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--tuples", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--records", default=None,
                    help="the data/records.py container to replay (required)")
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
    started = None
    if not dist.is_initialized():
        # a launcher (torchrun) sets RANK and WORLD_SIZE; alone, a world of one
        backend = "nccl" if args.device == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            started = tempfile.mkdtemp(prefix="cppf2_train_")
            dist.init_process_group(backend, store=dist.FileStore(os.path.join(started, "store"), 1),
                                    rank=0, world_size=1)
    try:
        train_category(args.category, args.branch, cfg, out, n_points=args.n_points,
                       records=args.records, backbone_lr_scale=args.backbone_lr_scale,
                       device=args.device)
    finally:
        if started is not None:
            dist.destroy_process_group()
            import shutil

            shutil.rmtree(started, ignore_errors=True)


if __name__ == "__main__":
    main()
