"""Weight carry: the JAX package's parameter trees into the port's modules.

A tree is nested dicts of numpy arrays (as `models/checkpoints.py` reads
them from disk, or as `jax.device_get` returns them), with or without the
top-level "params" key. Two layout facts drive the mapping:
  * a flax Dense kernel is (in, out); a torch Linear weight is (out, in);
  * the ViT's `blocks` leaves carry a leading depth axis (flax `nn.scan`),
    unstacked here into one module per block.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _params(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree else tree


def _set(param: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch: module {tuple(param.shape)} vs tree {tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


def _dense(lin: nn.Linear, p: Dict[str, Any]) -> None:
    _set(lin.weight, np.asarray(p["kernel"], np.float32).T)
    _set(lin.bias, p["bias"])


def _res_mlp(mlp: nn.Module, p: Dict[str, Any]) -> None:
    for i in range(mlp.depth):
        layer, lp = getattr(mlp, f"res{i}"), p[f"res{i}"]
        _dense(layer.fc1, lp["fc1"])
        _dense(layer.fc2, lp["fc2"])
        if layer.proj is not None:
            _dense(layer.proj, lp["proj"])


def load_branch(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a ShotBranch / DinoBranch parameter tree into `module` in place."""
    p = _params(tree)
    _res_mlp(module.tuple_encoder, p["tuple_encoder"])
    _res_mlp(module.heads.logit_encoder, p["heads"]["logit_encoder"])
    _res_mlp(module.heads.scale_encoder, p["heads"]["scale_encoder"])
    if hasattr(module, "shot_encoder"):
        _res_mlp(module.shot_encoder, p["shot_encoder"])
    else:
        _dense(module.desc_transform, p["desc_transform"])
        _dense(module.desc_pair_transform, p["desc_pair_transform"])
    return module


def load_vit(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a DinoViT parameter tree (blocks stacked on a depth axis) into
    the port's `DinoViT` in place."""
    p = _params(tree)
    d = module.cfg.embed_dim
    _set(module.patch_embed.weight, np.asarray(p["patch_embed"]["kernel"], np.float32).reshape(-1, d).T)
    _set(module.patch_embed.bias, p["patch_embed"]["bias"])
    _set(module.cls_token, p["cls_token"])
    _set(module.pos_embed, p["pos_embed"])
    _set(module.norm.weight, p["norm"]["scale"])
    _set(module.norm.bias, p["norm"]["bias"])
    blk = p["blocks"]
    for i, b in enumerate(module.blocks):
        def at(x, i=i):
            return np.asarray(x, np.float32)[i]

        for name in ("norm1", "norm2"):
            ln = getattr(b, name)
            _set(ln.weight, at(blk[name]["scale"]))
            _set(ln.bias, at(blk[name]["bias"]))
        _set(b.ls1, at(blk["ls1"]))
        _set(b.ls2, at(blk["ls2"]))
        for lin, src in ((b.attn.qkv, blk["attn"]["qkv"]), (b.attn.proj, blk["attn"]["proj"]),
                         (b.mlp_fc1, blk["mlp_fc1"]), (b.mlp_fc2, blk["mlp_fc2"])):
            _dense(lin, {"kernel": at(src["kernel"]), "bias": at(src["bias"])})
    return module
