"""DINOv2 ViT-g/14 with registers, plain PyTorch, for the output check.

The architecture of `dinov2_vitg14_reg` (facebookresearch/dinov2
`hubconf.py`; arXiv:2304.07193, 2309.16588): pre-norm blocks with LayerScale
whose feed-forward is w3(silu(a) * b), (a, b) the two halves of w12's output,
a first, each half `swiglu_hidden` wide; tokens [class + pos_0, R registers,
patches + pos], the registers without a position embedding; the output is
the normed patch tokens.

It is built from the reference's own pieces, imported and not copied: the
linears are `reference/layers.py::Dense` and the attention and LayerNorm
`reference/dinov2.py`'s ("hbm" attention), so the control's float8 step
(`reference/precision.py`) reaches every linear and the attention here as
it does in ViT-L. The gate is silu(a) * b in float32 from the w12 output,
rounded once to the compute dtype, the formula of the program's gate kernel.
The residual stream and LayerNorm are float32, as in `reference/dinov2.py`.

Departures from the release (as in `cppf2_torch/reference/dinov2_reg.py`,
which this computes to the bit at the same dtype): the position grid is
resized with antialiased Keys-cubic weights (a = -0.5), where the release's
torch code uses antialiased bicubic (a = -0.75) with offset 0; LayerNorm's
variance is E[x^2] - E[x]^2 (flax's); the patch embedding is a product over
patches flattened in (py, px, channel) order; the image is (H, W, 3) in
[0, 1], normalized inside.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.device import device_constant
from perfbench.reference.dinov2 import (IMAGENET_MEAN, IMAGENET_STD, Attention, LayerNorm,
                                        ViTConfig, cubic_resize_matrix)
from perfbench.reference.layers import Dense

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RegConfig:
    patch_size: int = 14
    embed_dim: int = 1536
    depth: int = 40
    num_heads: int = 24
    mlp_ratio: float = 4.0
    pretrain_grid: int = 37
    num_registers: int = 4
    compute_dtype: str = "bfloat16"

    def attention(self) -> ViTConfig:
        """The config `reference/dinov2.py`'s attention reads: its "hbm" route."""
        return ViTConfig(embed_dim=self.embed_dim, num_heads=self.num_heads,
                         compute_dtype=self.compute_dtype, attn_impl="hbm")


def swiglu_hidden(embed_dim: int, mlp_ratio: float) -> int:
    """Each half of w12: two thirds of the mlp_ratio-wide hidden layer,
    rounded up to a multiple of 8 (the release's `SwiGLUFFNFused`)."""
    return (int(int(embed_dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def gate(x: torch.Tensor) -> torch.Tensor:
    """silu(a) * b of the halves (a, b) of the last axis, in float32,
    rounded once to `x`'s type."""
    h = x.shape[-1] // 2
    return (F.silu(x[..., :h].float()) * x[..., h:].float()).to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: RegConfig):
        super().__init__()
        dt = _DTYPES[cfg.compute_dtype]
        d = cfg.embed_dim
        hidden = swiglu_hidden(d, cfg.mlp_ratio)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.attn = Attention(cfg.attention())
        self.mlp_w12 = Dense(d, 2 * hidden, dt)
        self.mlp_w3 = Dense(hidden, d, dt)
        self.ls1 = nn.Parameter(torch.ones(d))
        self.ls2 = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attn(self.norm1(x)).float()
        return x + self.ls2 * self.mlp_w3(gate(self.mlp_w12(self.norm2(x)))).float()


class DinoViTReg(nn.Module):
    """(H, W, 3) image in [0, 1] -> (H/p, W/p, D) normed patch tokens; a
    (B, H, W, 3) stack -> (B, H/p, W/p, D). Leaves named as
    `backbones/dinov2_reg.py::leaves` names them."""

    def __init__(self, cfg: RegConfig = RegConfig()):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.embed_dim
        self.patch_embed = Dense(p * p * 3, d, _DTYPES[cfg.compute_dtype])
        self.cls_token = nn.Parameter(torch.zeros(1, d))
        self.register_tokens = nn.Parameter(torch.zeros(cfg.num_registers, d))
        self.pos_embed = nn.Parameter(torch.zeros(1 + cfg.pretrain_grid ** 2, d))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = LayerNorm(d)

    def _pos_patch(self, gh: int, gw: int) -> torch.Tensor:
        g, d = self.cfg.pretrain_grid, self.cfg.embed_dim
        pos = self.pos_embed[1:].reshape(g, g, d)
        if (gh, gw) == (g, g):
            return pos.reshape(gh * gw, d)
        rh, rw = (device_constant(("cubic_resize", g, n), lambda n=n: torch.from_numpy(
            cubic_resize_matrix(g, n)), pos.device) for n in (gh, gw))
        out = torch.einsum("oh,hwc->owc", rh, pos.float())
        out = torch.einsum("pw,owc->opc", rw, out)
        return out.to(pos.dtype).reshape(gh * gw, d)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        p, d, r = c.patch_size, c.embed_dim, c.num_registers
        lead = img.shape[:-3]
        gh, gw = img.shape[-3] // p, img.shape[-2] // p
        mean, std = (device_constant(("imagenet", name), lambda v=v: torch.as_tensor(v), img.device)
                     for name, v in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)))
        x = (img - mean) / std
        patches = x.reshape(*lead, gh, p, gw, p, 3).transpose(-4, -3).reshape(
            *lead, gh * gw, p * p * 3)
        x = self.patch_embed(patches) + self._pos_patch(gh, gw)
        cls = (self.cls_token + self.pos_embed[:1]).expand(*lead, 1, d)
        regs = self.register_tokens.expand(*lead, r, d)
        tokens = torch.cat([cls, regs, x], dim=-2).float()
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        return tokens[..., 1 + r:, :].reshape(*lead, gh, gw, d)
