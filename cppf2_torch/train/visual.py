"""End-to-end trainable visual branch: compact ViT backbone + tuple head.

Counterpart of `cppf2_tpu/train/visual.py`: a compact ViT is trained through
the pose-tuple loss, so gradients flow tuple_loss -> DinoBranch -> bilinear
token interpolation -> ViT blocks -> patch embed. The backbone must be built
with `attn_impl="hbm"`: kernel K1 has no backward and raises under autograd.

Descriptor conventions are those of the frozen-backbone path
(`models/dinov2.py::bbox_crop_descriptors`): bbox-square crop rescaled to
`out_size`, resized to (out_size / stride * 14)^2 for the ViT, tokens
bilinearly sampled at the cloud's pixels and L2-normalized, so a trained
backbone drops into the evaluation driver unchanged.

The step is a stateful program, as `loop.make_train_step`'s is: on the card
one CUDA graph holds the ViT's forward and backward, the branch, the
all_reduce and the AdamW update, with `backbone_lr_scale` a multiply of the
backbone's gradients inside it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cppf2_torch.config import TrainConfig
from cppf2_torch.device import resolve_device
from cppf2_torch.models import jax_random
from cppf2_torch.models.jax_random import init_branch_
from cppf2_torch.models.dinov2 import DinoViT, interpolate_features, resize_bilinear_matmul
from cppf2_torch.models.porting import load_vit
from cppf2_torch.ops.sampling import masked_tuple_choice
from cppf2_torch.parallel.mesh import shard_batch
from cppf2_torch.train.loop import (
    TrainState,
    _run_step,
    _shard_uniforms,
    _update,
    init_flax_,
    make_optimizer,
    tuple_loss,
)


class VisualModel(nn.Module):
    """The {"backbone", "branch"} pair that the end-to-end step trains."""

    def __init__(self, backbone: DinoViT, branch: nn.Module):
        super().__init__()
        if backbone.cfg.attn_impl != "hbm":
            raise ValueError("the backbone trains through attn_impl='hbm'; kernel K1 has no backward")
        self.backbone = backbone
        self.branch = branch


def create_visual_train_state(vit_model: DinoViT, branch_model: nn.Module, cfg: TrainConfig,
                              generator: Optional[torch.Generator] = None,
                              device="cuda", seed: Optional[int] = None) -> TrainState:
    """Step 0 of training the pair. With `seed` both get the JAX package's
    init (`create_visual_train_state(..., jax.random.key(seed))`: the key
    split in two, the backbone's tree from the first, the head's from the
    second); with a generator both are drawn anew from it in the same
    distributions; with neither they train on from their weights."""
    dev = resolve_device(device)
    if seed is not None:
        k_vit, k_head = jax_random.split(jax_random.key(seed))
        load_vit(vit_model, jax_random.vit_init_tree(vit_model.cfg, k_vit, dev))
        init_branch_(branch_model, k_head)
    elif generator is not None:
        vit_model.init_random(generator)
        init_flax_(branch_model, generator)
    model = VisualModel(vit_model, branch_model).to(dev).train()
    opt, sched = make_optimizer(cfg, model.parameters())
    return TrainState(0, model, opt, sched)


def make_visual_train_step(vit_model: DinoViT, branch_model: nn.Module, cfg: TrainConfig,
                           out_size: int = 256, stride: int = 8, backbone_lr_scale: float = 1.0,
                           mesh=None, axis: str = "data"):
    """The data-parallel train step of the end-to-end visual branch.

    `train_step(state, batch, tuple_u=None, generator=None)` as in
    `loop.make_train_step`, with the global batch
      crop (B, S, S, 3) float32 in [0, 1], the bbox-square rescaled crop,
      kp (B, N, 2) float32, the cloud's pixels in crop space (x, y),
      pc (B, N, 3), pc_canon (B, N, 3), bound (B, 3), count (B,) int.
    `backbone_lr_scale` scales the backbone's gradients against the head's
    (1.0 trains from scratch; below 1 fine-tunes a given backbone).
    `train_step.programs` holds the step programs.
    """
    if mesh is None:
        raise ValueError("make_visual_train_step needs a mesh (parallel.make_mesh on an "
                         "initialized process group)")
    ph = out_size // stride

    def frame_loss(module, frame, u):
        resized = resize_bilinear_matmul(frame["crop"], ph * 14, ph * 14)
        grid = module.backbone(resized)
        desc = interpolate_features(grid, frame["kp"], (out_size, out_size))
        tuple_idx = masked_tuple_choice(u, frame["count"])
        preds = module.branch(frame["pc"], desc, tuple_idx)
        return tuple_loss(preds, frame["pc_canon"], tuple_idx, frame["bound"], cfg.num_bins)

    def scale(name: str) -> float:
        return backbone_lr_scale if name.startswith("backbone.") else 1.0

    def body(state, local, us):
        losses = [frame_loss(state.module, {k: v[i] for k, v in local.items()}, us[i])
                  for i in range(len(us))]
        return _update(state, losses, mesh, axis, scale if backbone_lr_scale != 1.0 else None)

    cache: Dict = {}
    key = ("visual step", vit_model.cfg, cfg, out_size, stride, backbone_lr_scale,
           branch_model.tuple_size)

    def train_step(state: TrainState, batch, tuple_u=None, generator=None):
        local = shard_batch(batch, mesh, axis)
        us = _shard_uniforms(tuple_u, generator, len(batch["pc"]), cfg, branch_model.tuple_size,
                             mesh, axis)
        return _run_step(state, cache, key, body, local, us)

    train_step.programs = cache
    return train_step
