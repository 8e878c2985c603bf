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

The JAX package jits its train step (the loss, `value_and_grad`, the
gradient reduction and the optax update in one program); here the step is a
stateful program (`eval/programs.py`): on the card its first call runs the
step and captures it, and every later call replays the losses, the backward,
the all_reduce and the AdamW update as one CUDA graph. AdamW is then
capturable, with its lr a 0-d device tensor that the scheduler rewrites in
place between replays; the gradients and AdamW's moments are allocated before
the first step, outside the graphs' pool, and the program is keyed on their
addresses. The step count, the scheduler and the draw of the tuple uniforms
stay outside the program. On the CPU the step runs eagerly.

The JAX train step reaches no TPU kernel, so this one launches no CUDA kernel
of the port: the branch MLPs are `torch.matmul` under autograd.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from cppf2_torch.config import TrainConfig
from cppf2_torch.core.binning import real2prob
from cppf2_torch.device import resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.models.jax_random import init_branch_
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


def make_optimizer(cfg: TrainConfig, params, capturable: Optional[bool] = None):
    """(AdamW, LambdaLR) over `params`, with optax.adamw's constants (betas
    0.9 / 0.999, eps 1e-8 outside the root). Call `scheduler.step()` after
    `optimizer.step()`: update number n (from 0) then runs at
    `make_lr_schedule(cfg)(n)`, the count before the update, as optax reads it.

    `capturable` defaults to whether the parameters lie on CUDA. A capturable
    AdamW keeps its step count on the device and takes its lr as a 0-d
    tensor there, which LambdaLR rewrites in place: a captured update reads
    the lr of each replay. It runs the multi-tensor update, CUDA's default,
    named here so that the CPU tests run the same arithmetic. The lr is
    float32, as optax's schedule is: over five steps across an lr boundary
    the loss then follows optax's within 2.8e-7 (relative), against 9.1e-5
    with a float64 lr (tests/test_torch_train_programs.py)."""
    params = list(params)
    if capturable is None:
        capturable = all(p.device.type == "cuda" for p in params)
    lr = torch.full((), cfg.lr, dtype=torch.float32, device=params[0].device) if capturable else cfg.lr
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay, capturable=capturable,
                            foreach=True if capturable else None)
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
                       generator: Optional[torch.Generator] = None, device="cuda",
                       seed: Optional[int] = None) -> TrainState:
    """Step 0 of training `model` on `device`. With `seed` the weights are
    the JAX package's `create_train_state(model, ..., jax.random.key(seed))`
    init (`init_branch_`); with a generator they are drawn anew from it
    (`init_flax_`); with neither the model trains on from the weights it
    holds."""
    dev = resolve_device(device)
    if seed is not None:
        init_branch_(model, seed)
    elif generator is not None:
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


def _allocate(state: TrainState) -> None:
    """Every gradient, and AdamW's step and moments, as zeros before the first
    step, as AdamW itself would make them at its first update: a step program
    writes them in place, outside the graphs' pool, and is keyed on where
    they lie."""
    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            st = opt.state[p]
            if not st:
                st["step"] = (torch.zeros((), device=p.device) if group["capturable"]
                              else torch.tensor(0.0))
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _update(state: TrainState, frame_losses, mesh, axis: str,
            grad_scale: Optional[Callable[[str], float]] = None):
    """Backward of the mean of this rank's per-frame totals, gradients and
    metrics averaged over `axis`, one optimizer update; returns the metrics.
    The gradients are zeroed in place, never set to None: they keep the
    addresses the step program was captured with."""
    metrics = {k: torch.mean(torch.stack([f[k] for f in frame_losses])) for k in frame_losses[0]}
    state.optimizer.zero_grad(set_to_none=False)
    metrics["total"].backward()
    named = list(state.module.named_parameters())
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
    return {k: flat[off + i] for i, k in enumerate(keys)}


def _run_step(state: TrainState, cache: Dict, key, body: Callable, local, us):
    """One step through the step program of `key` and of the inputs (the
    rank's block of the batch, its uniforms), keyed also on where the
    weights, gradients and the optimizer's state lie; then the scheduler and
    the step count, which a replay would not advance."""
    _allocate(state)
    key = key + (programs.weights(state.module), programs.trained(state.optimizer))
    prog = programs.program(cache, key, functools.partial(body, state), (local, us), stateful=True)
    metrics = prog(local, us)
    state.scheduler.step()
    state.step += 1
    return state, metrics


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
    on the rank's device. `train_step.programs` holds the step programs
    (one per state's addresses and input shapes).
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

    def body(state, local, us):
        losses = [frame_loss(state.module, {k: v[i] for k, v in local.items()}, us[i])
                  for i in range(len(us))]
        return _update(state, losses, mesh, axis)

    cache: Dict = {}

    def train_step(state: TrainState, batch, tuple_u=None, generator=None):
        local = shard_batch(batch, mesh, axis)
        us = _shard_uniforms(tuple_u, generator, len(batch["pc"]), cfg, model.tuple_size, mesh, axis)
        return _run_step(state, cache, ("step", branch, cfg, model.tuple_size), body, local, us)

    train_step.programs = cache
    return train_step
