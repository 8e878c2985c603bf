"""Weight carry: the JAX package's parameter trees into the port's modules,
and back (`branch_to_tree`, `vit_to_tree`, `load_train_state`); and the
reference's BeyondCPPF Lightning checkpoints as such trees
(`port_beyondcppf_state_dict`, `load_beyondcppf_checkpoint`).

A tree is nested dicts of numpy arrays (as `models/checkpoints.py` reads
them from disk, or as `jax.device_get` returns them) or of tensors (a
seeded init tree made on the device, `models/jax_random.py`), with or
without the top-level "params" key. Two layout facts drive the mapping:
  * a flax Dense kernel is (in, out); a torch Linear weight is (out, in);
  * the ViT's `blocks` leaves carry a leading depth axis (flax `nn.scan`),
    unstacked here into one module per block.
An int8 ViT tree (`quantize_vit_params`) holds int8 kernels and float32
`qscale` under qkv, proj, mlp_fc1 and mlp_fc2; a quant="int8" model's tree
holds `qscale` (ones until quantized) beside float kernels.
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


# ---------------------------------------------------------------------------
# The reference's Lightning checkpoints (train_shot.py:52-73, train_dino.py:64-85)
# ---------------------------------------------------------------------------

def _sd_dense(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A torch Linear (weight (out, in)) as a flax Dense (kernel (in, out))."""
    return {"kernel": _np(torch.as_tensor(sd[f"{prefix}.weight"])).T.copy(),
            "bias": _np(torch.as_tensor(sd[f"{prefix}.bias"]))}


def _sd_res_mlp(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The `nn.Sequential` of ResLayers under `prefix` (fc1, fc2, and fc0, the
    skip projection where the widths differ) as res0, res1, ..."""
    idxs = sorted({int(m.group(1)) for k in sd
                   if (m := re.match(rf"{re.escape(prefix)}\.(\d+)\.fc1\.weight$", k))})
    if not idxs:
        raise KeyError(f"no ResLayer stack under '{prefix}' in state_dict")
    out = {}
    for i in idxs:
        p = f"{prefix}.{i}"
        layer = {"fc1": _sd_dense(sd, f"{p}.fc1"), "fc2": _sd_dense(sd, f"{p}.fc2")}
        if f"{p}.fc0.weight" in sd:
            layer["proj"] = _sd_dense(sd, f"{p}.fc0")
        out[f"res{i}"] = layer
    return out


def port_beyondcppf_state_dict(sd: Dict[str, Any], branch: str) -> Dict[str, Any]:
    """A BeyondCPPF state dict (Lightning's `ckpt["state_dict"]` or a bare
    `model.state_dict()`) as the {"params": ...} tree of a ShotBranch
    ("shot") or DinoBranch ("dino"), which `load_branch` takes."""
    if branch not in ("shot", "dino"):
        raise ValueError(f"branch must be 'shot' or 'dino', got {branch!r}")
    params: Dict[str, Any] = {
        "tuple_encoder": _sd_res_mlp(sd, "tuple_encoder"),
        "heads": {"logit_encoder": _sd_res_mlp(sd, "logit_encoder"),
                  "scale_encoder": _sd_res_mlp(sd, "scale_encoder")},
    }
    if branch == "shot":
        params["shot_encoder"] = _sd_res_mlp(sd, "shot_encoder")
    else:
        params["desc_transform"] = _sd_dense(sd, "desc_transform")
        params["desc_pair_transform"] = _sd_dense(sd, "desc_pair_transform")
    return {"params": params}


def load_beyondcppf_checkpoint(path: str, branch: str) -> Optional[Dict[str, Any]]:
    """`port_beyondcppf_state_dict` of a Lightning checkpoint or a bare state
    dict on disk, read with `torch.load(weights_only=True)`; None when there
    is no such file."""
    if not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return port_beyondcppf_state_dict(sd, branch)


# ---------------------------------------------------------------------------
# The way back: modules into flax-layout trees
# ---------------------------------------------------------------------------

def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(device="cpu", dtype=torch.float32).numpy().copy()


def _dense_tree(lin: nn.Linear) -> Dict[str, Any]:
    return {"kernel": _np(lin.weight).T.copy(), "bias": _np(lin.bias)}


def _res_mlp_tree(mlp: nn.Module) -> Dict[str, Any]:
    out = {}
    for i in range(mlp.depth):
        layer = getattr(mlp, f"res{i}")
        lp = {"fc1": _dense_tree(layer.fc1), "fc2": _dense_tree(layer.fc2)}
        if layer.proj is not None:
            lp["proj"] = _dense_tree(layer.proj)
        out[f"res{i}"] = lp
    return out


def branch_to_tree(module: nn.Module) -> Dict[str, Any]:
    """The flax tree {"params": ...} of a ShotBranch / DinoBranch, float32:
    the inverse of `load_branch`."""
    p = {"tuple_encoder": _res_mlp_tree(module.tuple_encoder),
         "heads": {"logit_encoder": _res_mlp_tree(module.heads.logit_encoder),
                   "scale_encoder": _res_mlp_tree(module.heads.scale_encoder)}}
    if hasattr(module, "shot_encoder"):
        p["shot_encoder"] = _res_mlp_tree(module.shot_encoder)
    else:
        p["desc_transform"] = _dense_tree(module.desc_transform)
        p["desc_pair_transform"] = _dense_tree(module.desc_pair_transform)
    return {"params": p}


def vit_to_tree(module: nn.Module) -> Dict[str, Any]:
    """The flax tree {"params": ...} of a DinoViT, float32 (int8 kernels stay
    int8, with their `qscale`), the blocks stacked on a leading depth axis:
    the inverse of `load_vit`."""
    c = module.cfg
    p, d = c.patch_size, c.embed_dim

    def stack(get):
        return np.stack([get(b) for b in module.blocks])

    def kernel(lin):
        w = lin.weight.detach().cpu()
        return w.numpy().T.copy() if w.dtype == torch.int8 else _np(w).T

    def dense(get):
        out = {"kernel": stack(lambda b: kernel(get(b))), "bias": stack(lambda b: _np(get(b).bias))}
        if hasattr(get(module.blocks[0]), "qscale"):
            out["qscale"] = stack(lambda b: _np(get(b).qscale))
        return out

    def ln(get):
        return {"scale": stack(lambda b: _np(get(b).weight)), "bias": stack(lambda b: _np(get(b).bias))}

    return {"params": {
        "patch_embed": {"kernel": _np(module.patch_embed.weight).T.reshape(p, p, 3, d).copy(),
                        "bias": _np(module.patch_embed.bias)},
        "cls_token": _np(module.cls_token),
        "pos_embed": _np(module.pos_embed),
        "norm": {"scale": _np(module.norm.weight), "bias": _np(module.norm.bias)},
        "blocks": {
            "norm1": ln(lambda b: b.norm1), "norm2": ln(lambda b: b.norm2),
            "ls1": stack(lambda b: _np(b.ls1)), "ls2": stack(lambda b: _np(b.ls2)),
            "attn": {"qkv": dense(lambda b: b.attn.qkv), "proj": dense(lambda b: b.attn.proj)},
            "mlp_fc1": dense(lambda b: b.mlp_fc1), "mlp_fc2": dense(lambda b: b.mlp_fc2),
        },
    }}


def load_tree(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """`load_branch`, `load_vit`, or both for a {"backbone", "branch"} tree
    into a module with those two children (the end-to-end visual model)."""
    if "backbone" in tree and "branch" in tree:
        load_vit(module.backbone, tree["backbone"])
        load_branch(module.branch, tree["branch"])
        return module
    return (load_vit if hasattr(module, "patch_embed") else load_branch)(module, tree)


def module_to_tree(module: nn.Module) -> Dict[str, Any]:
    """The inverse of `load_tree`."""
    if hasattr(module, "backbone") and hasattr(module, "branch"):
        return {"backbone": vit_to_tree(module.backbone), "branch": branch_to_tree(module.branch)}
    return (vit_to_tree if hasattr(module, "patch_embed") else branch_to_tree)(module)


def load_train_state(state, params: Dict[str, Any], mu: Dict[str, Any], nu: Dict[str, Any],
                     count: int):
    """Parameters, Adam's moments and the step count from flax-layout numpy
    trees (optax's `ScaleByAdamState.mu`, `.nu`, `.count`) into a
    `train.loop.TrainState` (its module, its Adam or AdamW optimizer over the
    module's parameters, its scheduler), in place. The moments go through the
    same layout mapping as the parameters. A capturable optimizer keeps its
    step count on the parameters' device and its tensor lr, rewritten in
    place. Returns the state."""
    import copy

    module, optimizer = state.module, state.optimizer
    load_tree(module, params)
    moments = []
    for tree in (mu, nu):
        shadow = copy.deepcopy(module)
        load_tree(shadow, tree)
        moments.append(dict(shadow.named_parameters()))
    capturable = optimizer.param_groups[0].get("capturable", False)
    for name, prm in module.named_parameters():
        st = optimizer.state[prm]
        st["step"] = torch.full((), float(count), device=prm.device if capturable else "cpu")
        st["exp_avg"] = moments[0][name].detach().to(prm.device, prm.dtype).clone()
        st["exp_avg_sq"] = moments[1][name].detach().to(prm.device, prm.dtype).clone()
    state.step = int(count)
    sched = state.scheduler
    sched.last_epoch = int(count)
    for group, base, fn in zip(optimizer.param_groups, sched.base_lrs, sched.lr_lambdas):
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(base * fn(int(count)))
        else:
            group["lr"] = base * fn(int(count))
    sched._last_lr = [g["lr"].clone() if torch.is_tensor(g["lr"]) else g["lr"]
                      for g in optimizer.param_groups]
    return state
