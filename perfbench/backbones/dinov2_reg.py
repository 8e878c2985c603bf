"""The `dinov2_reg` backbone: DINOv2 ViT-g/14 with registers
(`dinov2_vitg14_reg`, facebookresearch/dinov2 `hubconf.py`: `vit_giant2`,
`ffn_layer="swiglufused"`, `num_register_tokens=4`; M. Oquab et al.,
arXiv:2304.07193; T. Darcet et al., arXiv:2309.16588) as the port's
`models/dinov2.py` builds it with `ViTConfig(ffn="swiglu", num_registers=R)`:
pre-norm blocks with LayerScale whose feed-forward is w3(silu(a) * b), (a, b)
the halves of w12's output, each half `swiglu_hidden` wide; R register tokens
between the class token and the patches, without a position embedding.

`perfbench/spec.py::backbone` finds this file by the `vit` group's
`"arch": "dinov2_reg"`. The group's other keys are the port's `ViTConfig`
fields named in `KEYS`; `ffn` must be "swiglu".
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.reference.dinov2_reg import swiglu_hidden as reference_hidden

KEYS = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "pretrain_grid", "ffn",
        "num_registers")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _widths(vit: Dict) -> Dict:
    """`vit` itself, refused where it holds a key this architecture does not
    build from or a feed-forward other than SwiGLU."""
    unknown = sorted(set(vit) - set(KEYS) - {"arch"})
    if unknown:
        raise ValueError(f"the dinov2_reg backbone has no key {unknown}: it is built from {list(KEYS)}")
    if vit.get("ffn") != "swiglu":
        raise ValueError(f"the dinov2_reg backbone has a SwiGLU block: ffn must be 'swiglu', "
                         f"not {vit.get('ffn')!r}")
    return vit


def swiglu_hidden(vit: Dict) -> int:
    """Each half of w12 (`SwiGLUFFNFused`): 4096 at 1536 wide."""
    return reference_hidden(vit["embed_dim"], vit["mlp_ratio"])


def leaves(vit: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every leaf, named as the port's modules name
    them: `dinov2`'s list with `mlp_w12` (2h, d) and `mlp_w3` (d, h) in
    place of the GELU MLP, and `register_tokens` (R, d) of kind "embed"."""
    _widths(vit)
    d, p, g, r = vit["embed_dim"], vit["patch_size"], vit["pretrain_grid"], vit["num_registers"]
    h = swiglu_hidden(vit)
    out = [("patch_embed.weight", (d, p * p * 3), "matrix"), ("patch_embed.bias", (d,), "bias"),
           ("cls_token", (1, d), "embed"), ("register_tokens", (r, d), "embed"),
           ("pos_embed", (1 + g * g, d), "embed")]
    for i in range(vit["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "gain"), (b + "norm1.bias", (d,), "bias"),
                (b + "norm2.weight", (d,), "gain"), (b + "norm2.bias", (d,), "bias"),
                (b + "attn.qkv.weight", (3 * d, d), "matrix"), (b + "attn.qkv.bias", (3 * d,), "bias"),
                (b + "attn.proj.weight", (d, d), "matrix"), (b + "attn.proj.bias", (d,), "bias"),
                (b + "mlp_w12.weight", (2 * h, d), "matrix"), (b + "mlp_w12.bias", (2 * h,), "bias"),
                (b + "mlp_w3.weight", (d, h), "matrix"), (b + "mlp_w3.bias", (d,), "bias"),
                (b + "ls1", (d,), "layerscale"), (b + "ls2", (d,), "layerscale")]
    out += [("norm.weight", (d,), "gain"), ("norm.bias", (d,), "bias")]
    return out


def tokens(vit: Dict, grid: int) -> int:
    """The tokens one crop sends through K1: its grid x grid patches, the
    class token and the registers."""
    return grid * grid + 1 + _widths(vit)["num_registers"]


def flops(vit: Dict, tokens: int) -> float:
    """Forward FLOPs of one crop, the blocks only (as `flops.vit_flops`
    counts ViT-L's): per block 2 T (4 d^2 + 3 d h) for qkv, proj, w12 and w3
    and 4 T^2 d for the attention; 2.59 TFLOP at 1029 tokens."""
    d, h = _widths(vit)["embed_dim"], swiglu_hidden(vit)
    return vit["depth"] * (2.0 * tokens * (4.0 * d * d + 3.0 * d * h) + 4.0 * tokens * tokens * d)


def reference(vit: Dict, precision: Dict, device) -> torch.nn.Module:
    """The plain reference's ViT (`perfbench/reference/dinov2_reg.py`), its
    weights not yet loaded: the "hbm" attention, linears in the
    configuration's `precision["vit"]`, and the class token, the registers
    and the position embedding stored in that type, as they are served."""
    from perfbench.reference.dinov2_reg import DinoViTReg, RegConfig

    _widths(vit)
    dtype = _DTYPES[precision["vit"]]
    with torch.device(device):
        module = DinoViTReg(RegConfig(**{k: vit[k] for k in KEYS if k != "ffn"},
                                      compute_dtype=precision["vit"]))
    with torch.no_grad():
        for p in (module.cls_token, module.register_tokens, module.pos_embed):
            p.data = p.data.to(dtype)
    return module.eval()
