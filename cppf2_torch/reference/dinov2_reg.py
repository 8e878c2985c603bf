"""DINOv2 ViT-g/14 with registers, its forward pass in plain PyTorch.

The architecture of `dinov2_vitg14_reg` (facebookresearch/dinov2
`hubconf.py`: `vit_giant2`, `ffn_layer="swiglufused"`,
`num_register_tokens=4`; M. Oquab et al., arXiv:2304.07193; T. Darcet et al.,
"Vision Transformers Need Registers", arXiv:2309.16588): 1536 wide, 40
pre-norm blocks of 24 heads of 64, each

    x = x + ls1 * proj(attn(norm1(x)))
    x = x + ls2 * w3(silu(a) * b),   (a, b) = w12(norm2(x)) split in half, a first,

w12 1536 -> 2 x 4096 and w3 4096 -> 1536 with biases (the hidden width by
`SwiGLUFFNFused`'s rule, `swiglu_hidden`); tokens [class + pos_0, R
registers, patches + pos], the registers without a position embedding; the
output is the normed patch tokens, class token and registers dropped.

This file imports nothing of `cppf2_torch` and uses no kernel: it is what
the port's `models/dinov2.py` (`ViTConfig(ffn="swiglu", num_registers=R)`)
is held against. By default it computes in float32 with TF32 off (for the
forward, restored after it). With `compute_dtype="bfloat16"` it rounds where the served
ViT rounds: each linear casts input, weight and bias to bfloat16 and rounds
its product and its bias sum; the attention logits are a bfloat16 product,
the softmax's exponentials are rounded to bfloat16, the row sum and the PV
product are float32; the residual stream, LayerNorm and the gate's silu are
float32 throughout.

Departures from the release, none of which changes the architecture:
  * the position grid is resized to the crop's patch grid with antialiased
    Keys-cubic weights (a = -0.5), as the port and the JAX package resize
    it; the release's torch code uses antialiased bicubic interpolation
    (a = -0.75) with `interpolate_offset` 0;
  * LayerNorm (epsilon 1e-6) takes its variance as E[x^2] - E[x]^2, as flax
    does, not as E[(x - E[x])^2];
  * the patch embedding is the convolution written as a product over
    patches flattened in (py, px, channel) order, its weight (D, p * p * 3);
  * the image is taken as (H, W, 3) in [0, 1] (or a stack of them) and
    normalized with ImageNet's mean and standard deviation inside;
  * the attention divides by the softmax's row sum after the PV product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RegConfig:
    """ViT-g/14 with 4 registers by default."""

    patch_size: int = 14
    embed_dim: int = 1536
    depth: int = 40
    num_heads: int = 24
    mlp_ratio: float = 4.0
    num_registers: int = 4
    pretrain_grid: int = 37
    compute_dtype: str = "float32"


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the matmuls and convolutions inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def swiglu_hidden(embed_dim: int, mlp_ratio: float) -> int:
    """The width of each half of w12: two thirds of the mlp_ratio-wide hidden
    layer, rounded up to a multiple of 8 (`SwiGLUFFNFused`)."""
    return (int(int(embed_dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def gate(x: torch.Tensor) -> torch.Tensor:
    """silu(a) * b of the halves (a, b) of the last axis, in float32,
    rounded once to `x`'s type."""
    h = x.shape[-1] // 2
    return (F.silu(x[..., :h].float()) * x[..., h:].float()).to(x.dtype)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of an antialiased Keys-cubic resize
    (a = -0.5) along one axis: the kernel widened by n_in / n_out when
    downscaling, rows normalized, samples outside the input zeroed."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale).astype(f32)
    w = _keys_cubic(x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32).T.copy()


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


class Linear(nn.Module):
    """y = x W^T + b with input, weight and bias in `dtype`, the product
    rounded to it and the bias added in it."""

    def __init__(self, d_in: int, d_out: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class Attention(nn.Module):
    def __init__(self, cfg: RegConfig):
        super().__init__()
        dt = _DTYPES[cfg.compute_dtype]
        self.cfg = cfg
        self.qkv = Linear(cfg.embed_dim, 3 * cfg.embed_dim, dt)
        self.proj = Linear(cfg.embed_dim, cfg.embed_dim, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h = self.cfg.embed_dim, self.cfg.num_heads
        hd = d // h
        lead, t = x.shape[:-2], x.shape[-2]
        dt = _DTYPES[self.cfg.compute_dtype]
        q, k, v = torch.split(self.qkv(x), d, dim=-1)
        qh = (q * (1.0 / math.sqrt(hd))).reshape(*lead, t, h, hd).transpose(-3, -2)
        kh = k.reshape(*lead, t, h, hd).transpose(-3, -2)
        vh = v.reshape(*lead, t, h, hd).transpose(-3, -2)
        logits = torch.matmul(qh, kh.transpose(-1, -2))
        m = torch.amax(logits, dim=-1, keepdim=True)
        e = torch.exp((logits - m).float()).to(dt)
        s = torch.sum(e.float(), dim=-1, keepdim=True)
        o = torch.matmul(e.float(), vh.float()) / s
        return self.proj(o.transpose(-3, -2).reshape(*lead, t, d).to(dt))


class Block(nn.Module):
    def __init__(self, cfg: RegConfig):
        super().__init__()
        dt = _DTYPES[cfg.compute_dtype]
        d = cfg.embed_dim
        hidden = swiglu_hidden(d, cfg.mlp_ratio)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.attn = Attention(cfg)
        self.mlp_w12 = Linear(d, 2 * hidden, dt)
        self.mlp_w3 = Linear(hidden, d, dt)
        self.ls1 = nn.Parameter(torch.ones(d))
        self.ls2 = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attn(self.norm1(x)).float()
        return x + self.ls2 * self.mlp_w3(gate(self.mlp_w12(self.norm2(x)))).float()


class DinoViTReg(nn.Module):
    """(H, W, 3) image in [0, 1] -> (H/p, W/p, D) normed patch tokens; a
    (B, H, W, 3) stack -> (B, H/p, W/p, D). Its parameters are named as the
    port's `DinoViT` of the same config names them."""

    def __init__(self, cfg: RegConfig = RegConfig()):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, d))
        self.register_tokens = nn.Parameter(torch.zeros(cfg.num_registers, d))
        self.pos_embed = nn.Parameter(torch.zeros(1 + cfg.pretrain_grid ** 2, d))
        self.patch_embed = Linear(p * p * 3, d, _DTYPES[cfg.compute_dtype])
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = LayerNorm(d)

    def _pos_patch(self, gh: int, gw: int) -> torch.Tensor:
        g, d = self.cfg.pretrain_grid, self.cfg.embed_dim
        pos = self.pos_embed[1:].reshape(g, g, d)
        if (gh, gw) == (g, g):
            return pos.reshape(gh * gw, d)
        rh, rw = (torch.from_numpy(cubic_resize_matrix(g, n)).to(pos.device) for n in (gh, gw))
        out = torch.einsum("oh,hwc->owc", rh, pos.float())
        out = torch.einsum("pw,owc->opc", rw, out)
        return out.to(pos.dtype).reshape(gh * gw, d)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            return self._forward(img)

    def _forward(self, img: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        p, d, r = c.patch_size, c.embed_dim, c.num_registers
        lead = img.shape[:-3]
        gh, gw = img.shape[-3] // p, img.shape[-2] // p
        mean, std = (torch.as_tensor(v, device=img.device) for v in (IMAGENET_MEAN, IMAGENET_STD))
        x = (img - mean) / std
        patches = x.reshape(*lead, gh, p, gw, p, 3).transpose(-4, -3).reshape(*lead, gh * gw, p * p * 3)
        x = self.patch_embed(patches) + self._pos_patch(gh, gw)
        cls = (self.cls_token + self.pos_embed[:1]).expand(*lead, 1, d)
        regs = self.register_tokens.expand(*lead, r, d)
        tokens = torch.cat([cls, regs, x], dim=-2).float()
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        return tokens[..., 1 + r:, :].reshape(*lead, gh, gw, d)
