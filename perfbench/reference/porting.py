"""Weight carry: a parameter tree of the JAX layout (nested dicts of arrays,
as the packed `params.msgpack` files hold it) into the reference's modules
(a frozen copy of part of `cppf2_torch/models/porting.py`). A flax Dense
kernel is (in, out); a torch Linear weight is (out, in).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def _leaf(x):
    """A float leaf: a tensor as it is, anything else as a float32 array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _params(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree else tree


def _set(param: torch.Tensor, value) -> None:
    if isinstance(value, torch.Tensor):   # a tree made on a device (models/jax_random.py)
        value = value.float()
    else:
        value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch: module {tuple(param.shape)} vs tree {tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


def _dense(lin: nn.Linear, p: Dict[str, Any]) -> None:
    _set(lin.weight, _leaf(p["kernel"]).T)
    _set(lin.bias, p["bias"])


def _qdense(lin: nn.Module, p: Dict[str, Any]) -> None:
    """A Dense / QDense from a flax kernel (in, out), float or int8 codes,
    with `qscale` where the tree has one. Int8 codes need a QDense."""
    kernel = p["kernel"]
    if not isinstance(kernel, torch.Tensor) and np.asarray(kernel).dtype == np.int8:
        kernel = np.asarray(kernel)
        if not hasattr(lin, "set_int8"):
            raise ValueError("an int8 kernel needs a ViTConfig with quant='int8'")
        lin.set_int8(kernel.T, p["qscale"])
        _set(lin.bias, p["bias"])
        return
    _dense(lin, p)
    if hasattr(lin, "qscale"):
        _set(lin.qscale, p.get("qscale", np.ones(lin.qscale.shape, np.float32)))


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
    _set(module.patch_embed.weight, _leaf(p["patch_embed"]["kernel"]).reshape(-1, d).T)
    _set(module.patch_embed.bias, p["patch_embed"]["bias"])
    _set(module.cls_token, p["cls_token"])
    _set(module.pos_embed, p["pos_embed"])
    _set(module.norm.weight, p["norm"]["scale"])
    _set(module.norm.bias, p["norm"]["bias"])
    blk = p["blocks"]
    for i, b in enumerate(module.blocks):
        def at(x, i=i):
            return _leaf(x)[i]

        for name in ("norm1", "norm2"):
            ln = getattr(b, name)
            _set(ln.weight, at(blk[name]["scale"]))
            _set(ln.bias, at(blk[name]["bias"]))
        _set(b.ls1, at(blk["ls1"]))
        _set(b.ls2, at(blk["ls2"]))
        for lin, src in ((b.attn.qkv, blk["attn"]["qkv"]), (b.attn.proj, blk["attn"]["proj"]),
                         (b.mlp_fc1, blk["mlp_fc1"]), (b.mlp_fc2, blk["mlp_fc2"])):
            _qdense(lin, {k: v[i] if isinstance(v, torch.Tensor) else np.asarray(v)[i]
                          for k, v in src.items()})
    return module
