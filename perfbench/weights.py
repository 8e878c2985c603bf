"""The ViT's weights, made on the device from the seed.

DINOv2's released weights are not in the repository, and weights do not
change the work a forward pass does. So the benchmark draws every leaf of a
ViT at the configuration's published widths from one `torch.Generator` on the
device, in two large calls: the matrices in bfloat16 (the type they are
served in), the vectors in float32. The program under test and the plain
reference each load the same tensors by name from `vit_tensors`, called
with the same seed on the same device.

The scales follow a trained ViT's orders of magnitude, so that every block
moves the residual stream: matrices N(0, 1 / fan_in), layer scales
0.05 + 0.2 |N(0, 1)|, LayerNorm gains 1 + 0.1 N(0, 1), biases and
embeddings 0.02 N(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_SALT = 0x5EED_0F_D1


def vit_leaves(vit: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every leaf of a DINOv2 ViT with the widths of
    `vit` (the configuration's "vit" group), named as the modules name
    them. kind: "matrix", "embed", "gain", "bias" or "layerscale"."""
    d, p, g = vit["embed_dim"], vit["patch_size"], vit["pretrain_grid"]
    hidden = int(d * vit["mlp_ratio"])
    out = [("patch_embed.weight", (d, p * p * 3), "matrix"), ("patch_embed.bias", (d,), "bias"),
           ("cls_token", (1, d), "embed"), ("pos_embed", (1 + g * g, d), "embed")]
    for i in range(vit["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "gain"), (b + "norm1.bias", (d,), "bias"),
                (b + "norm2.weight", (d,), "gain"), (b + "norm2.bias", (d,), "bias"),
                (b + "attn.qkv.weight", (3 * d, d), "matrix"), (b + "attn.qkv.bias", (3 * d,), "bias"),
                (b + "attn.proj.weight", (d, d), "matrix"), (b + "attn.proj.bias", (d,), "bias"),
                (b + "mlp_fc1.weight", (hidden, d), "matrix"), (b + "mlp_fc1.bias", (hidden,), "bias"),
                (b + "mlp_fc2.weight", (d, hidden), "matrix"), (b + "mlp_fc2.bias", (d,), "bias"),
                (b + "ls1", (d,), "layerscale"), (b + "ls2", (d,), "layerscale")]
    out += [("norm.weight", (d,), "gain"), ("norm.bias", (d,), "bias")]
    return out


def vit_tensors(vit: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the ViT, drawn from `seed` on `device`: matrices and
    embeddings in bfloat16, vectors in float32."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed((int(seed) ^ _SALT) % (1 << 63))
    leaves = vit_leaves(vit)
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
