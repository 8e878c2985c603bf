"""The ViT's weights, made on the device from the seed, and the visual
branch's input width.

DINOv2's released weights are not in the repository, and weights do not
change the work a forward pass does. So the benchmark draws every leaf of a
ViT at the configuration's published widths from one `torch.Generator` on the
device, in two large calls: the matrices in bfloat16 (the type they are
served in), the vectors in float32. The leaves are those the configuration's
backbone file lists (`perfbench/backbones/<arch>.py::leaves`). The program
under test and the plain reference each load the same tensors by name from
`vit_tensors`, called with the same seed on the same device.

The scales follow a trained ViT's orders of magnitude, so that every block
moves the residual stream: matrices N(0, 1 / fan_in), layer scales
0.05 + 0.2 |N(0, 1)|, LayerNorm gains 1 + 0.1 N(0, 1), biases and
embeddings 0.02 N(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench import spec

_SALT = 0x5EED_0F_D1
_BRANCH_SALT = 0xDE5C_0F_D1


def vit_tensors(vit: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the ViT, drawn from `seed` on `device`: matrices and
    embeddings in bfloat16, vectors in float32."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed((int(seed) ^ _SALT) % (1 << 63))
    leaves = spec.backbone(spec.arch(vit)).leaves(vit)
    wide = [(n, s, k) for n, s, k in leaves if k in ("matrix", "embed")]
    narrow = [(n, s, k) for n, s, k in leaves if k not in ("matrix", "embed")]
    big = torch.randn(sum(math.prod(s) for _, s, _ in wide), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    small = torch.randn(sum(math.prod(s) for _, s, _ in narrow), generator=gen, device=dev)
    out, off = {}, 0
    for name, shape, kind in wide:
        n = math.prod(shape)
        std = math.sqrt(1.0 / shape[1]) if kind == "matrix" else 0.02
        out[name] = big[off:off + n].view(shape).mul_(std)
        off += n
    off = 0
    for name, shape, kind in narrow:
        n = math.prod(shape)
        x = small[off:off + n].view(shape)
        off += n
        if kind == "gain":
            out[name] = x.mul_(0.1).add_(1.0)
        elif kind == "layerscale":
            out[name] = x.abs_().mul_(0.2).add_(0.05)
        else:
            out[name] = x.mul_(0.02)
    return out


def load_vit(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Copy the drawn leaves into a ViT module whose leaves have exactly
    these names and shapes (each keeps its own dtype)."""
    own = dict(module.named_parameters())
    if set(own) != set(tensors):
        raise ValueError(f"the module's leaves differ from the drawn ones: "
                         f"{sorted(set(own) ^ set(tensors))[:6]}")
    with torch.no_grad():
        for name, t in tensors.items():
            if tuple(own[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: module {tuple(own[name].shape)}, drawn {tuple(t.shape)}")
            own[name].copy_(t)
    return module


def visual_branch_tree(tree: Dict, width: int, seed: int) -> Dict:
    """A visual branch's parameter tree that takes `width`-wide descriptors.

    Where the checkpoint's `desc_transform` kernel (d_in, d_out) already
    takes `width`, `tree` itself. Else a copy in which that one kernel is a
    (width, d_out) float32 draw from N(0, 1 / width), from a CPU
    `torch.Generator` seeded from `seed`; its bias and every other leaf stay
    the checkpoint's. The program, the reference and the model FLOPs all
    take their visual branch from here."""
    params = tree.get("params", tree)
    kernel = params["desc_transform"]["kernel"]
    if kernel.shape[0] == width:
        return tree
    gen = torch.Generator().manual_seed((int(seed) ^ _BRANCH_SALT) % (1 << 63))
    draw = torch.randn((width, kernel.shape[1]), generator=gen, dtype=torch.float32)
    wide = dict(params, desc_transform=dict(params["desc_transform"],
                                            kernel=draw.mul_(math.sqrt(1.0 / width)).numpy()))
    return dict(tree, params=wide) if "params" in tree else wide
