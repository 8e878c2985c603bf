"""The `dinov2` backbone: DINOv2's ViT (M. Oquab et al., arXiv:2304.07193) as
the port's `models/dinov2.py` builds it. Pre-norm blocks with LayerScale and
a GELU MLP of `mlp_ratio` x `embed_dim`, a class token and no other prefix
token, built from the `vit` group's six widths alone.

`perfbench/spec.py::backbone` finds this file by the name `dinov2`, the
architecture of a `vit` group without an `arch` key.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench import flops as yardstick

KEYS = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "pretrain_grid")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _widths(vit: Dict) -> Dict:
    """`vit` itself, refused where it holds a key this architecture does not
    build from (a key it would otherwise leave out without a word)."""
    unknown = sorted(set(vit) - set(KEYS) - {"arch"})
    if unknown:
        raise ValueError(f"the dinov2 backbone has no key {unknown}: it is built from {list(KEYS)}")
    return vit


def leaves(vit: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every leaf of a DINOv2 ViT with the widths of
    `vit` (the configuration's "vit" group), named as the modules name
    them. kind: "matrix", "embed", "gain", "bias" or "layerscale"."""
    _widths(vit)
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


def tokens(vit: Dict, grid: int) -> int:
    """The tokens one crop sends through K1: its grid x grid patches and the
    class token."""
    return grid * grid + 1


def flops(vit: Dict, tokens: int) -> float:
    """Forward FLOPs of one crop (`perfbench/flops.py::vit_flops`: the 4x MLP)."""
    return yardstick.vit_flops(tokens, vit["embed_dim"], vit["depth"])


def reference(vit: Dict, precision: Dict, device) -> torch.nn.Module:
    """The plain reference's ViT (`perfbench/reference/dinov2.py`), its weights
    not yet loaded: the "hbm" attention, linears in the configuration's
    `precision["vit"]`, and the class token and position embeddings stored in
    that type, as they are served."""
    from perfbench.reference.dinov2 import DinoViT, ViTConfig

    _widths(vit)
    dtype = _DTYPES[precision["vit"]]
    with torch.device(device):
        module = DinoViT(ViTConfig(**{k: vit[k] for k in KEYS}, compute_dtype=precision["vit"],
                                   attn_impl="hbm"))
    with torch.no_grad():
        for p in (module.cls_token, module.pos_embed):
            p.data = p.data.to(dtype)
    return module.eval()
