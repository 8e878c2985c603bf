"""Training: tuple loss, optimizer, data-parallel train step.

Counterpart of `cppf2_tpu/train/loop.py` (reference train_shot.py:85-150,
train_dino.py:99-161), under autograd:

  * tuple indices are sampled on the device each step from injected uniforms
    or a generator (`ops/sampling.py::masked_tuple_choice`, the convention
    inference uses);
  * loss = KL(soft-binned canonical coords || predicted) + MSE(scale)
    (train_shot.py:97-104);
  * AdamW(lr 1e-3, wd 0) with StepLR(25 epochs, x0.5) (train_shot.py:124-130);
  * a batch of frames is split over the ranks of the mesh's `data` axis; each
    rank takes the loss of its block, and the gradients are averaged over the
    axis by one `all_reduce` on the flattened gradient.

The JAX train step reaches no TPU kernel, so this one launches no CUDA kernel
of the port: the branch MLPs are `torch.matmul` under autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from cppf2_torch.config import TrainConfig
from cppf2_torch.core.binning import real2prob
from cppf2_torch.device import resolve_device
from cppf2_torch.models.layers import Dense, lecun_normal_
from cppf2_torch.ops.sampling import masked_tuple_choice
from cppf2_torch.parallel.mesh import axis_size, rank_device, shard_batch

_KL_EPS = 1e-12


@dataclasses.dataclass
class TrainState:
    """What a train step advances, in place: the step count, the module that
    holds the parameters, its optimizer and the learning-rate scheduler."""

    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """StepLR: lr * gamma^(epoch // step_epochs) with steps_per_epoch granularity."""
    boundary = cfg.lr_step_epochs * cfg.steps_per_epoch

    def schedule(step: int) -> float:
        return cfg.lr * cfg.lr_gamma ** (step // boundary)

    return schedule


def make_optimizer(cfg: TrainConfig, params):
    """(AdamW, LambdaLR) over `params`, with optax.adamw's constants (betas
    0.9 / 0.999, eps 1e-8 outside the root). Call `scheduler.step()` after
    `optimizer.step()`: update number n (from 0) then runs at
    `make_lr_schedule(cfg)(n)`, the count before the update, as optax reads it."""
    opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    boundary = cfg.lr_step_epochs * cfg.steps_per_epoch
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: cfg.lr_gamma ** (n // boundary))
    return opt, sched


def init_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize every Dense of `module` in flax's default distributions
    (`lecun_normal` kernels: a normal truncated at two standard deviations,
    variance 1 / fan_in; zero biases), in place, from `generator`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
    return module


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None, device="cuda") -> TrainState:
    """Step 0 of training `model` on `device`. With a generator the weights
    are drawn anew (`init_flax_`); without one the model trains on from the
    weights it holds."""
    dev = resolve_device(device)
    if generator is not None:
        init_flax_(model, generator)
    model = model.to(dev).train()
    opt, sched = make_optimizer(cfg, model.parameters())
    return TrainState(0, model, opt, sched)


def tuple_loss(preds, pc_canon: torch.Tensor, tuple_idx: torch.Tensor, bound: torch.Tensor,
               num_bins: int) -> Dict[str, torch.Tensor]:
    """Classification + scale loss for one frame (train_shot.py:96-104).

    Target: the canonical coordinates (N, 3) of the two primary tuple points,
    clamped to [-0.5, 0.5], shifted to [0, 1], soft-binned; KL divergence
    with the epsilon 1e-12 inside the target's log and "batchmean"
    normalization (sum over bins and the 6 coordinates, mean over the T
    tuples). Scale: MSE against the (3,) bound, broadcast over tuples.
    """
    t = tuple_idx.shape[0]
    target = real2prob(torch.clamp(pc_canon[tuple_idx[:, :2]], -0.5, 0.5) + 0.5, 1.0,
                       num_bins).reshape(t, 6, num_bins)
    logprob = torch.log_softmax(preds.logits, dim=-1)
    kl = target * (torch.log(target + _KL_EPS) - logprob)
    loss_cls = torch.sum(kl) / t
    loss_scale = torch.mean(torch.square(preds.scales - bound[None, :]))
    return {"cls": loss_cls, "scale": loss_scale, "total": loss_cls + loss_scale}


def _shard_uniforms(tuple_u, generator, n_frames: int, cfg: TrainConfig, tuple_size: int, mesh,
                    axis: str) -> torch.Tensor:
    """This rank's block of the global (B, tuples_per_step, k) uniforms. From
    a generator every rank draws the whole batch's and keeps its block, so
    the step does not depend on the world size."""
    if tuple_u is None:
        dev = rank_device(mesh)
        gdev = generator.device if generator is not None else dev
        tuple_u = torch.rand((n_frames, cfg.tuples_per_step, tuple_size), generator=generator,
                             device=gdev)
    return shard_batch(tuple_u, mesh, axis)


def _data_parallel_step(state: TrainState, frame_losses, mesh, axis: str,
                        grad_scale: Optional[Callable[[str], float]] = None):
    """Backward of the mean of this rank's per-frame totals, gradients and
    metrics averaged over `axis`, one optimizer update."""
    metrics = {k: torch.mean(torch.stack([f[k] for f in frame_losses])) for k in frame_losses[0]}
    state.optimizer.zero_grad(set_to_none=True)
    metrics["total"].backward()
    named = [(n, p) for n, p in state.module.named_parameters() if p.grad is not None]
    if grad_scale is not None:
        for n, p in named:
            p.grad.mul_(grad_scale(n))
    keys = sorted(metrics)
    flat = torch.cat([p.grad.reshape(-1) for _, p in named]
                     + [torch.stack([metrics[k].detach() for k in keys])])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    flat /= axis_size(mesh, axis)
    off = 0
    for _, p in named:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, {k: flat[off + i] for i, k in enumerate(keys)}


def make_train_step(model: nn.Module, cfg: TrainConfig, branch: str = "shot", mesh=None,
                    axis: str = "data"):
    """Build the data-parallel train step of a branch on `mesh` (a mesh over
    an initialized process group; a world of one is started explicitly).

    `train_step(state, batch, tuple_u=None, generator=None)` -> (state,
    metrics). `batch` is the global batch, every leaf with a leading frame
    axis that divides by the `axis` size:
      pc (B, N, 3), pc_canon (B, N, 3), bound (B, 3), count (B,) int,
      and shot (B, N, 352) + normal (B, N, 3), or desc (B, N, 1024).
    `tuple_u` (B, tuples_per_step, tuple_size) in [0, 1) picks the tuples, or
    they are drawn from `generator`. The state is advanced in place; the
    metrics (cls, scale, total: means over the global batch) are 0-d tensors
    on the rank's device.
    """
    if mesh is None:
        raise ValueError("make_train_step needs a mesh (parallel.make_mesh on an initialized "
                         "process group)")
    if branch not in ("shot", "dino"):
        raise ValueError(f"unknown branch {branch!r} (expected 'shot' or 'dino')")

    def frame_loss(module, frame, u):
        tuple_idx = masked_tuple_choice(u, frame["count"])
        if branch == "shot":
            preds = module(frame["pc"], frame["shot"], frame["normal"], tuple_idx)
        else:
            preds = module(frame["pc"], frame["desc"], tuple_idx)
        return tuple_loss(preds, frame["pc_canon"], tuple_idx, frame["bound"], cfg.num_bins)

    def train_step(state: TrainState, batch, tuple_u=None, generator=None):
        local = shard_batch(batch, mesh, axis)
        us = _shard_uniforms(tuple_u, generator, len(batch["pc"]), cfg, model.tuple_size, mesh, axis)
        losses = [frame_loss(state.module, {k: v[i] for k, v in local.items()}, us[i])
                  for i in range(len(us))]
        return _data_parallel_step(state, losses, mesh, axis)

    return train_step
