"""Checkpoint save/restore.

Counterpart of `cppf2_tpu/train/checkpoints.py`, with the same layout of a
run directory: one `step_%08d` entry per checkpoint and a `last` file that
names the newest. An entry here is one `torch.save` file holding the step, the
parameters as a flax-layout tree (what `restore_params` returns and
`models/porting.py` loads back into a module, exactly), and the optimizer's
and scheduler's state. `export_params_msgpack` / `load_params_msgpack` use
flax's wire format, so the JAX package reads what the port trained and the
port reads the shipped checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from cppf2_torch.models.checkpoints import load_params_msgpack, save_params_msgpack
from cppf2_torch.models.porting import load_tree, module_to_tree
from cppf2_torch.train.loop import TrainState

__all__ = ["save_checkpoint", "latest_checkpoint", "restore_checkpoint", "restore_params",
           "export_params_msgpack", "load_params_msgpack"]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> str:
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state.step) if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    torch.save({
        "step": int(state.step),
        "params": _map_leaves(torch.from_numpy, module_to_tree(state.module)),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
    }, path)
    # refresh the 'last' pointer (reference keeps last.ckpt, train_shot.py:139)
    with open(os.path.join(ckpt_dir, "last"), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    marker = os.path.join(ckpt_dir, "last")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return os.path.join(ckpt_dir, f.read().strip())


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into `template` (a state of the same model and
    config, as `create_train_state` makes it), in place, and return it."""
    dev = next(template.module.parameters()).device
    ck = torch.load(os.path.abspath(path), map_location=dev, weights_only=True)
    load_tree(template.module, _map_leaves(lambda t: t.cpu().numpy(), ck["params"]))
    template.optimizer.load_state_dict(ck["optimizer"])
    template.scheduler.load_state_dict(ck["scheduler"])
    template.step = int(ck["step"])
    return template


def restore_params(path: str):
    """Only the parameters, as a flax-layout tree of numpy arrays (for the
    inference drivers), without a template."""
    ck = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _map_leaves(lambda t: t.numpy(), ck["params"])


def export_params_msgpack(path: str, params) -> str:
    """Write bare parameters in flax's msgpack format (the optimizer's state
    dropped): the small artifact that ships a trained model. `params` is a
    module of the port or a flax-layout tree of numpy arrays."""
    if isinstance(params, torch.nn.Module):
        params = module_to_tree(params)
    return save_params_msgpack(path, _map_leaves(np.asarray, params))
