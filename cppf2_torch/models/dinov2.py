"""DINOv2 ViT, the in-graph bbox-crop visual frontend and the host-crop
descriptor extractor (`DinoFeatureExtractor`).

Counterpart of `cppf2_tpu/models/dinov2.py` (reference dataset.py:40-80,
322-337): patch embed as unfold + matmul in the (gh, p, gw, p, 3) order,
the pretrained position grid resized with JAX's antialiased Keys-cubic
(a = -0.5) weights, pre-norm blocks with LayerScale whose attention is
kernel K1 (`ops/attention.py`, looked up on the module at call time), and
bilinear token sampling at the cloud's pixels.

Numerics follow the JAX module: the residual stream and LayerNorm (flax
epsilon 1e-6, variance as E[x^2] - E[x]^2) are float32; linears compute in
`cfg.compute_dtype`; GELU is the tanh form. The JAX "pallas" path pads the
token axis to a multiple of its query block; padded rows never reach a real
row (they are masked as keys), so the port does not pad.

Every function here takes one image or a stack of them: the ViT takes
(H, W, 3) or (B, H, W, 3), `bbox_crop_token_grid` one mask or (B, H, W)
masks of one frame, so a frame's crops go through one forward (what the JAX
driver gets from `jax.vmap`). K1 takes the (B, h, T, 64) views of the
batched projection in one launch per block.

`ViTConfig.attn_impl` picks the attention: "kernel" is K1, forward only, the
default because every inference entry point runs it; "hbm" is the JAX
package's default formulation in plain PyTorch, with its roundings, and is
the route autograd can follow (training the backbone, `train/visual.py`);
"chunked" is the JAX package's online softmax over key blocks of
`attn_chunk`, plain PyTorch and differentiable too.

`ViTConfig.quant="int8"` builds the blocks' four linears as `QDense` (W8A8,
`models/layers.py`); `quantize_vit_params` / `DinoViT.quantize_` turn their
float weights into int8 codes, which `DinoFeatureExtractor` and
`load_backbone` do once at load. Attention stays bf16 and on K1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import weakref
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cppf2_torch.core.geometry import norm
from cppf2_torch.device import device_constant
from cppf2_torch.models import jax_random
from cppf2_torch.models.layers import Dense, QDense, lecun_normal_, quantize_kernel
from cppf2_torch.ops import attention
from cppf2_torch.ops.voting import take_rows

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: float = 1e-5
    pretrain_grid: int = 37
    compute_dtype: str = "bfloat16"
    # "kernel": K1 (`ops/attention.py`), forward only. "hbm": (T, T) logits in
    # the compute dtype, exp in float32 rounded to the compute dtype, float32
    # row sum divided after PV; plain PyTorch, differentiable. "chunked": an
    # online softmax over key blocks of `attn_chunk` (float32 running max,
    # sum and accumulator), plain PyTorch, differentiable.
    attn_impl: str = "kernel"
    attn_chunk: int = 512
    # "none": the linears compute in compute_dtype. "int8": the blocks' qkv,
    # proj, mlp_fc1 and mlp_fc2 are `QDense` (W8A8 once their weights are
    # quantized); attention stays bf16.
    quant: str = "none"


VIT_L14 = ViTConfig()
VIT_S14 = ViTConfig(embed_dim=384, depth=12, num_heads=6)
VIT_B14 = ViTConfig(embed_dim=768, depth=12, num_heads=12)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: epsilon 1e-6, variance as E[x^2] - E[x]^2, in float32."""

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


def _linear(cfg: ViTConfig):
    """The blocks' linear layer: `QDense` under quant="int8", else `Dense`."""
    if cfg.quant not in ("none", "int8"):
        raise ValueError(f"unknown quant {cfg.quant!r} (expected 'none' or 'int8')")
    return QDense if cfg.quant == "int8" else Dense


def _chunked_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, chunk: int,
                       dt) -> torch.Tensor:
    """Online-softmax attention over key/value blocks of `chunk` keys
    (`cppf2_tpu/models/dinov2.py::_chunked_attention`): ([B,] h, T, hd)
    operands, float32 ([B,] h, T, hd) output. The keys are padded to a
    multiple of `chunk` and the padded logits masked to -inf; each block's
    logits and PV products accumulate in float32, its exponentials round to
    `dt`; running max, sum and accumulator are float32."""
    t = kh.shape[-2]
    pad = (-t) % chunk
    kp = F.pad(kh, (0, 0, 0, pad))
    vp = F.pad(vh, (0, 0, 0, pad))
    valid = torch.arange(t + pad, device=kh.device) < t
    q32 = qh.float()
    m_run = torch.full((*qh.shape[:-1], 1), -math.inf, device=qh.device)
    s_run = torch.zeros_like(m_run)
    o_run = torch.zeros(qh.shape, device=qh.device)
    for start in range(0, t + pad, chunk):
        k_blk, v_blk = kp[..., start:start + chunk, :], vp[..., start:start + chunk, :]
        logits = torch.matmul(q32, k_blk.float().transpose(-1, -2))
        logits = torch.where(valid[start:start + chunk], logits, -math.inf)
        # detached as in the "hbm" route: the softmax does not depend on the
        # shift, and its gradient through the max only adds rounding noise
        m_new = torch.maximum(m_run, torch.amax(logits.detach(), dim=-1, keepdim=True))
        scale = torch.exp(m_run - m_new)
        e = torch.exp(logits - m_new).to(dt)
        s_run = s_run * scale + torch.sum(e.float(), dim=-1, keepdim=True)
        o_run = o_run * scale + torch.matmul(e.float(), v_blk.float())
        m_run = m_new
    return o_run / s_run


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.attn_impl not in ("kernel", "hbm", "chunked"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} "
                             "(expected 'kernel', 'hbm' or 'chunked')")
        dt = _DTYPES[cfg.compute_dtype]
        self.cfg = cfg
        linear = _linear(cfg)
        self.qkv = linear(cfg.embed_dim, 3 * cfg.embed_dim, dt)
        self.proj = linear(cfg.embed_dim, cfg.embed_dim, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(T, D) tokens of one image, or (B, T, D) of B images."""
        d, h = self.cfg.embed_dim, self.cfg.num_heads
        hd = d // h
        lead, t = x.shape[:-2], x.shape[-2]
        dt = _DTYPES[self.cfg.compute_dtype]
        q, k, v = torch.split(self.qkv(x), d, dim=-1)
        qh = (q * (1.0 / math.sqrt(hd))).reshape(*lead, t, h, hd).transpose(-3, -2)
        kh = k.reshape(*lead, t, h, hd).transpose(-3, -2)
        vh = v.reshape(*lead, t, h, hd).transpose(-3, -2)
        if self.cfg.attn_impl == "kernel":
            bf = torch.bfloat16
            # ([B,] h, T, hd) views of the projection's output: K1 reads them in place
            o = attention.mha(qh.to(bf), kh.to(bf), vh.to(bf), t_real=t, out_dtype=dt)
        elif self.cfg.attn_impl == "chunked":
            o = _chunked_attention(qh, kh, vh, self.cfg.attn_chunk, dt)
        else:
            logits = torch.matmul(qh, kh.transpose(-1, -2))
            m = torch.amax(logits, dim=-1, keepdim=True).detach()
            e = torch.exp((logits - m).float()).to(dt)
            s = torch.sum(e.float(), dim=-1, keepdim=True)
            o = torch.matmul(e.float(), vh.float()) / s
        return self.proj(o.transpose(-3, -2).reshape(*lead, t, d).to(dt))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = _DTYPES[cfg.compute_dtype]
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.attn = Attention(cfg)
        linear = _linear(cfg)
        self.mlp_fc1 = linear(d, int(d * cfg.mlp_ratio), dt)
        self.mlp_fc2 = linear(int(d * cfg.mlp_ratio), d, dt)
        self.ls1 = nn.Parameter(torch.full((d,), cfg.layerscale_init))
        self.ls2 = nn.Parameter(torch.full((d,), cfg.layerscale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attn(self.norm1(x)).float()
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return x + self.ls2 * h.float()


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of jax.image.resize(method="bicubic")
    along one axis: Keys cubic a = -0.5, widened by in/out when downscaling
    (antialias), rows normalized, samples outside the input zeroed."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale).astype(f32)
    w = _keys_cubic(x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32).T.copy()


class DinoViT(nn.Module):
    """(H, W, 3) image in [0, 1] -> (H/p, W/p, D) normed patch tokens; a
    (B, H, W, 3) stack of images -> (B, H/p, W/p, D)."""

    def __init__(self, cfg: ViTConfig = VIT_L14):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.embed_dim
        self.patch_embed = Dense(p * p * 3, d, _DTYPES[cfg.compute_dtype])
        self.cls_token = nn.Parameter(torch.zeros(1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1 + cfg.pretrain_grid ** 2, d))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = LayerNorm(d)

    def init_random(self, generator: Optional[torch.Generator] = None,
                    seed: Optional[int] = None) -> "DinoViT":
        """Seeded random weights. With `seed`, the JAX package's: the init tree
        `DinoViT(cfg).init(jax.random.key(seed), image)` makes, drawn on the
        weights' device (`models/jax_random.py`) and carried in. With a
        `generator`, the same distributions drawn from it (flax's
        `lecun_normal` kernels, a normal truncated at two standard deviations
        with variance 1 / fan_in; zero biases; N(0, 0.02) position
        embedding)."""
        if (generator is None) == (seed is None):
            raise ValueError("pass a generator or a seed")
        if seed is not None:
            from cppf2_torch.models.porting import load_vit

            return load_vit(self, init_tree(self.cfg, seed, self.pos_embed.device))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
            self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=generator,
                                                    device=self.pos_embed.device))
        return self

    def quantize_(self) -> "DinoViT":
        """The int8 codes and scales of every block's qkv, proj, mlp_fc1 and
        mlp_fc2 (`QDense.quantize_`), in place; needs quant="int8". Call it
        on the float32 weights, before `cast_for_inference`, as the JAX
        extractor quantizes before it casts."""
        if self.cfg.quant != "int8":
            raise ValueError("quantize_ needs a ViTConfig with quant='int8'")
        for b in self.blocks:
            for lin in (b.attn.qkv, b.attn.proj, b.mlp_fc1, b.mlp_fc2):
                lin.quantize_()
        return self

    def cast_for_inference(self) -> "DinoViT":
        """Store matrices in the compute dtype, as the JAX extractor does
        (`DinoFeatureExtractor._cast`): Dense weights, the patch embed, the
        class token and the position embedding; vectors stay float32, and
        int8 weights stay int8."""
        dt = _DTYPES[self.cfg.compute_dtype]
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense) and m.weight.dtype != torch.int8:
                    m.weight.data = m.weight.data.to(dt)
            for prm in (self.cls_token, self.pos_embed):
                prm.data = prm.data.to(dt)
        return self

    def _pos_patch(self, gh: int, gw: int) -> torch.Tensor:
        g, d = self.cfg.pretrain_grid, self.cfg.embed_dim
        pos = self.pos_embed[1:].reshape(g, g, d)
        if (gh, gw) == (g, g):
            return pos.reshape(gh * gw, d)
        dev = pos.device
        rh, rw = (device_constant(("cubic_resize", g, n), lambda n=n: torch.from_numpy(
            cubic_resize_matrix(g, n)), dev) for n in (gh, gw))
        out = torch.einsum("oh,hwc->owc", rh, pos.float())
        out = torch.einsum("pw,owc->opc", rw, out)
        return out.to(pos.dtype).reshape(gh * gw, d)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        p = c.patch_size
        lead = img.shape[:-3]
        gh, gw = img.shape[-3] // p, img.shape[-2] // p
        mean, std = (device_constant(("imagenet", name), lambda v=v: torch.as_tensor(v), img.device)
                     for name, v in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)))
        x = (img - mean) / std
        patches = x.reshape(*lead, gh, p, gw, p, 3).transpose(-4, -3).reshape(
            *lead, gh * gw, p * p * 3)
        x = self.patch_embed(patches) + self._pos_patch(gh, gw)
        cls = (self.cls_token + self.pos_embed[:1]).expand(*lead, 1, c.embed_dim)
        tokens = torch.cat([cls, x], dim=-2).float()
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        return tokens[..., 1:, :].reshape(*lead, gh, gw, c.embed_dim)


# ---------------------------------------------------------------------------
# Resampling and keypoint sampling (dataset.py:40-59, 322-337)
# ---------------------------------------------------------------------------

def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear weights, half-pixel centers (upscale only)."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    t = (src - lo).astype(np.float64)
    w = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    w[rows, np.clip(lo, 0, n_in - 1)] += 1.0 - t
    w[rows, np.clip(lo + 1, 0, n_in - 1)] += t
    return w.astype(np.float32)


def resize_bilinear_matmul(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear upscale ([B,] H, W, C) -> ([B,] oh, ow, C) as two float32 products."""
    h, w = img.shape[-3:-1]
    if oh < h or ow < w:
        raise ValueError(f"resize_bilinear_matmul is upscale-only ({h}x{w} -> {oh}x{ow})")
    rh, rw = (device_constant(("linear_resize", n_in, n_out), lambda n_in=n_in, n_out=n_out:
                              torch.from_numpy(_linear_resize_matrix(n_in, n_out)), img.device)
              for n_in, n_out in ((h, oh), (w, ow)))
    t1 = torch.einsum("oh,...hwc->...owc", rh, img)
    return torch.einsum("pw,...owc->...opc", rw, t1)


def interpolate_features(feat_grid: torch.Tensor, pts_xy: torch.Tensor,
                         image_hw: Tuple[int, int], normalize: bool = True,
                         impl: str = "gather") -> torch.Tensor:
    """Sample the (gh, gw, D) token grid at (K, 2) image-pixel coordinates
    with F.grid_sample(bilinear, align_corners=False) semantics, zero
    outside; optionally L2-normalize. A leading (B,) axis on both samples
    each grid at its own points, each row as the single call does.

    impl="gather" takes the four taps as row gathers; impl="onehot" folds
    them into one (K, gh*gw) combination matrix and one product with the
    flattened grid, both operands rounded to bfloat16 and the sums in
    float32, as the JAX package's "onehot" form does."""
    if impl not in ("gather", "onehot"):
        raise ValueError(f"unknown impl {impl!r} (expected 'gather' or 'onehot')")
    if feat_grid.dim() == 3:
        return interpolate_features(feat_grid[None], pts_xy[None], image_hw, normalize, impl)[0]
    b, gh, gw, d = feat_grid.shape
    h, w = image_hw
    nx = ((pts_xy[..., 0] + 0.5) / w) * 2 - 1
    ny = ((pts_xy[..., 1] + 0.5) / h) * 2 - 1
    fx = ((nx + 1) * gw - 1) / 2
    fy = ((ny + 1) * gh - 1) / 2
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    wx, wy = fx - x0f, fy - y0f
    taps = ((y0, x0, (1 - wx) * (1 - wy)), (y0, x0 + 1, wx * (1 - wy)),
            (y0 + 1, x0, (1 - wx) * wy), (y0 + 1, x0 + 1, wx * wy))
    flat = feat_grid.reshape(b, gh * gw, d)

    def cell(yy, xx):
        # an out-of-range tap adds nothing (the reference's all-zero one-hot row)
        inb = (yy >= 0) & (yy < gh) & (xx >= 0) & (xx < gw)
        return inb, torch.clamp(yy, 0, gh - 1) * gw + torch.clamp(xx, 0, gw - 1)

    if impl == "onehot":
        comb = torch.zeros((b, pts_xy.shape[-2], gh * gw), device=feat_grid.device)
        for yy, xx, wt in taps:
            inb, idx = cell(yy, xx)
            comb.scatter_add_(2, idx[..., None], torch.where(inb, wt, torch.zeros_like(wt))[..., None])
        bf = torch.bfloat16
        out = torch.matmul(comb.to(bf).float(), flat.to(bf).float())
    else:
        def tap(yy, xx):
            inb, idx = cell(yy, xx)
            val = take_rows(flat, idx)
            return torch.where(inb[..., None], val, torch.zeros((), dtype=val.dtype, device=val.device))

        out = sum(tap(yy, xx) * wt[..., None] for yy, xx, wt in taps)
    if normalize:
        out = out / torch.clamp(norm(out, keepdim=True), min=1e-12)
    return out


def _hat_sample_matrix(src_coords: torch.Tensor, n_src: int) -> torch.Tensor:
    """([B,] n_dst, n_src) two-tap bilinear weights max(0, 1 - |src - j|)."""
    src = torch.arange(n_src, dtype=torch.float32, device=src_coords.device)
    return torch.clamp(1.0 - torch.abs(src_coords[..., None] - src), min=0.0)


def bbox_crop_transform(mask: torch.Tensor, out_size: int, padding: float = 0.0) -> torch.Tensor:
    """(tx, ty, s): crop pixel (x, y) samples the image at (s*x + tx, s*y + ty),
    from the mask's bbox squared and centered (dataset.py:322-337). A
    (B, H, W) stack of masks gives (B, 3)."""
    h, w = mask.shape[-2:]
    dev = mask.device
    xs, ys = torch.any(mask, dim=-2), torch.any(mask, dim=-1)
    ix = torch.arange(w, device=dev)
    iy = torch.arange(h, device=dev)
    left = torch.amin(torch.where(xs, ix, w), dim=-1)
    right = torch.amax(torch.where(xs, ix, -1), dim=-1) + 1
    top = torch.amin(torch.where(ys, iy, h), dim=-1)
    bottom = torch.amax(torch.where(ys, iy, -1), dim=-1) + 1
    size = torch.maximum(right - left, bottom - top).to(torch.float32) * (1.0 + padding)
    cx = (right + left).to(torch.float32) / 2.0
    cy = (bottom + top).to(torch.float32) / 2.0
    s = size / out_size
    return torch.stack([cx - s * (out_size / 2.0), cy - s * (out_size / 2.0), s], dim=-1)


def bbox_crop_image(rgb: torch.Tensor, mask: torch.Tensor, out_size: int = 256,
                    padding: float = 0.0):
    """The masked frame warped to the mask's bbox square at out_size x
    out_size (two hat-weight products, zero outside the frame), and the
    transform (tx, ty, s). A (B, H, W) stack of masks gives (B, out, out, 3)
    and (B, 3)."""
    h, w = rgb.shape[:2]
    img = rgb * mask[..., None].to(rgb.dtype)
    txys = bbox_crop_transform(mask, out_size, padding)
    tx, ty, s = txys[..., 0:1], txys[..., 1:2], txys[..., 2:3]
    i = torch.arange(out_size, dtype=torch.float32, device=rgb.device)
    ry = _hat_sample_matrix(s * i + ty, h)
    rx = _hat_sample_matrix(s * i + tx, w)
    crop = torch.einsum("...oh,...hwc->...owc", ry, img)
    return torch.einsum("...pw,...owc->...opc", rx, crop), txys


def bbox_crop_token_grid(model: DinoViT, rgb: torch.Tensor, mask: torch.Tensor,
                         out_size: int = 256, stride: int = 8, padding: float = 0.0):
    """Masked bbox-square warp + resize + ViT forward.
    Returns (token grid (out/stride, out/stride, D), (tx, ty, s)). With a
    (B, H, W) stack of masks of the one frame `rgb`, every crop goes through
    one ViT forward: grids (B, out/stride, out/stride, D) and (B, 3).

    The crops of a stack are warped and resized one mask at a time, as each
    mask alone would be: float32 products of another shape round in another
    order, and the bf16 linears of the ViT turn a last-bit difference in a
    crop into a bf16 step in its tokens. So a crop's grid does not depend on
    the stack it came in."""
    ph = pw = out_size // stride

    def crop(m):
        img, txy = bbox_crop_image(rgb, m, out_size, padding)
        return resize_bilinear_matmul(img, ph * 14, pw * 14), txy

    if mask.dim() == 2:
        resized, txys = crop(mask)
    else:
        parts = [crop(m) for m in mask]
        resized, txys = torch.stack([r for r, _ in parts]), torch.stack([t for _, t in parts])
    return model(resized), txys


def crop_keypoints(pixel_yx: torch.Tensor, txys: torch.Tensor) -> torch.Tensor:
    """([B,] n, 2) image pixels (y, x) as float (x, y) positions in the crop
    of transform `txys` ([B,] 3)."""
    kp = pixel_yx.flip(-1).to(torch.float32)
    return (kp - txys[..., None, :2]) / txys[..., None, 2:3]


def sample_crop_descriptors(grid: torch.Tensor, pixel_yx: torch.Tensor, txys: torch.Tensor,
                            out_size: int = 256, impl: str = "gather") -> torch.Tensor:
    """Bilinear token sampling of a crop grid at the cloud's image pixels
    (`impl` as in `interpolate_features`). A group's (B, gh, gw, D) grids,
    (B, n, 2) pixels and (B, 3) transforms give (B, n, D) in one call."""
    return interpolate_features(grid, crop_keypoints(pixel_yx, txys), (out_size, out_size), impl=impl)


def bbox_crop_descriptors(model: DinoViT, rgb: torch.Tensor, mask: torch.Tensor,
                          pixel_yx: torch.Tensor, out_size: int = 256, stride: int = 8,
                          padding: float = 0.0) -> torch.Tensor:
    """The in-graph visual frontend with the bbox-square rescale convention:
    (n, D) L2-normalized descriptors at the cloud's pixels."""
    grid, txys = bbox_crop_token_grid(model, rgb, mask, out_size, stride, padding)
    return sample_crop_descriptors(grid, pixel_yx, txys, out_size)


def masked_window_descriptors(model: DinoViT, rgb: torch.Tensor, mask: torch.Tensor,
                              pixel_yx: torch.Tensor, window_yx: torch.Tensor, crop: int = 256,
                              stride: int = 4, interp_impl: str = "gather") -> torch.Tensor:
    """The fixed-window visual frontend (`cppf2_tpu/models/dinov2.py::
    masked_window_descriptors`): the masked RGB cut at the crop window
    `preprocess_frame` used for the depth (`FrameInputs.window_yx`), resized
    bilinearly to (crop/stride * 14)^2, the ViT, and bilinear token sampling
    at the cloud's image pixels: (n, D) unit descriptors. The object keeps
    its native pixel scale, unlike the bbox-square convention the shipped
    branches were trained on (`bbox_crop_descriptors`).

    The window is cut as `jax.lax.dynamic_slice` cuts it: a negative start
    counts from the frame's end, and a start that would run past the frame
    moves back until the window fits. The keypoints are taken relative to
    the window as given, unmoved, as the JAX function takes them. The cut
    gathers rows and columns on the device, so nothing is read back."""
    h, w = rgb.shape[:2]
    ch, cw = min(crop, h), min(crop, w)
    dev = rgb.device
    window = window_yx.to(dev, torch.int64)

    def start(i, size, n):
        s0 = torch.where(window[i] < 0, window[i] + size, window[i])
        return torch.clamp(s0, 0, size - n) + torch.arange(n, device=dev)

    rows, cols = start(0, h, ch), start(1, w, cw)
    img = rgb.index_select(0, rows).index_select(1, cols)
    m = mask.to(dev).index_select(0, rows).index_select(1, cols)
    img = img * m[..., None].to(img.dtype)
    resized = resize_bilinear_matmul(img, ch // stride * 14, cw // stride * 14)
    grid = model(resized)
    kp_xy = (pixel_yx.to(dev).flip(-1) - window.flip(0)[None, :]).to(torch.float32)
    return interpolate_features(grid, kp_xy, (ch, cw), impl=interp_impl)


def init_tree(cfg: ViTConfig, seed: int, device="cpu"):
    """The JAX package's `DinoViT(cfg).init(jax.random.key(seed), image)`
    parameter tree, made on `device` (`models/jax_random.py`)."""
    return jax_random.vit_init_tree(cfg, jax_random.key(seed), device)


def init_leaves(cfg: ViTConfig, seed: int):
    """`init_tree`'s leaves one by one: the tree's layout with a function
    (device -> tensor) at each leaf."""
    return jax_random.vit_init_leaves(cfg, jax_random.key(seed))


def quantize_vit_params(variables, cfg: ViTConfig = VIT_L14):
    """A copy of a DinoViT parameter tree (the JAX layout, numpy leaves, the
    blocks stacked on a depth axis) in the int8 W8A8 layout of
    `cppf2_tpu/models/dinov2.py::quantize_vit_params`: the blocks' qkv,
    proj, mlp_fc1 and mlp_fc2 kernels become int8 (depth, d_in, d_out) codes
    with float32 per-output-channel `qscale` (depth, d_out)
    (`layers.quantize_kernel`, bit for bit the JAX function's); every other
    leaf is copied as it is. `cfg` is taken for the JAX signature's sake."""
    import copy

    variables = copy.deepcopy(variables)
    blk = (variables["params"] if "params" in variables else variables)["blocks"]
    for dense in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp_fc1"], blk["mlp_fc2"]):
        dense["kernel"], dense["qscale"] = quantize_kernel(dense["kernel"])
    return variables


def extractor_grid(model: "DinoViT", image: torch.Tensor, stride: int) -> torch.Tensor:
    """The eager resize and ViT forward of `DinoFeatureExtractor`: the
    (H, W, 3) float32 crop in [0, 1] resized bilinearly to (H/stride*14,
    W/stride*14) and through `model`; returns the (H/stride, W/stride, D)
    token grid. A program's body (the extractor's own, or the driver's
    instance visual stage) calls this, never the extractor itself."""
    h, w = image.shape[:2]
    ph, pw = h // stride, w // stride
    return model(resize_bilinear_matmul(image, ph * 14, pw * 14))


# a backbone's extractor programs, on the backbone (they read its weights where they lie)
_EXTRACTOR_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class DinoFeatureExtractor:
    """Crop image -> per-keypoint descriptors, the analog of the reference's
    `DINOV2` module (dataset.py:62-80): bilinear resize to (h/stride*14,
    w/stride*14), the ViT forward, bilinear sampling of the patch tokens at
    the keypoints, L2 normalization. The frozen-descriptor path of the
    training driver (`train/driver.py::_frame_descriptors`).

    `cfg` defaults to ViT-L/14 on kernel K1 (`attn_impl="kernel"`); at the
    default stride 4 a 256 x 256 crop becomes 896 x 896, 64 x 64 patches, so
    K1 runs at T = 4097, once per block. Weights are a parameter tree of the
    JAX layout (`params`, carried by `models/porting.py::load_vit`) or
    `init_random`; matrices are then stored in the compute dtype, as the JAX
    extractor stores them. With `cfg.quant == "int8"` the float weights are
    quantized first (`DinoViT.quantize_`; a tree that is int8 already loads
    as it is), as the JAX extractor's `_cast` quantizes. The `quant` keyword
    sets `cfg.quant`.

    The resize and the ViT forward are a program (`eval/programs.py`), as
    the JAX extractor jits them: one per (config, stride, crop size,
    weights' addresses), captured as a CUDA graph on its first call on the
    card and replayed after; eager on the CPU. The token sampling stays
    eager: the render trainer's pools call it with a keypoint count that
    changes every frame.
    """

    def __init__(self, params=None, cfg: Optional[ViTConfig] = None, stride: int = 4,
                 interp_impl: str = "gather", out_size: int = 256, quant: Optional[str] = None,
                 device="cuda"):
        from cppf2_torch.device import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else VIT_L14
        if quant is not None:
            self.cfg = dataclasses.replace(self.cfg, quant=quant)
        self.stride = stride
        self.interp_impl = interp_impl
        self.out_size = out_size  # bbox-square crop resolution (driver path)
        with torch.device(self.device):
            self.model = DinoViT(self.cfg).eval()
        self.ready = False
        if params is not None:
            from cppf2_torch.models.porting import load_vit

            load_vit(self.model, params)
            self._cast()

    def _cast(self) -> None:
        if self.cfg.quant == "int8":
            self.model.quantize_()
        self.model.cast_for_inference()
        self.ready = True

    def init_random(self, hw=(256, 256), seed: int = 0) -> "DinoFeatureExtractor":
        """Seeded random weights, then cast as loaded weights are: the JAX
        package's `init_random(hw, seed)` tree, made on the extractor's
        device (no parameter depends on `hw`, the crop it traces with). A
        torch.Generator in place of `hw` draws the same distributions from
        it instead (`DinoViT.init_random(generator)`)."""
        if isinstance(hw, torch.Generator):
            self.model.init_random(hw)
        else:
            self.model.init_random(seed=seed)
        self._cast()
        return self

    def grid(self, image: torch.Tensor) -> torch.Tensor:
        """The (H/stride, W/stride, D) token grid of an (H, W, 3) crop in
        [0, 1], through the extractor's program. The crop is moved to the
        extractor's device first, so a crop handed in from the host is
        captured on the card like one that lies there."""
        from cppf2_torch.eval import programs

        if not self.ready:
            raise RuntimeError("load or init the DINOv2 weights first")
        image = image.to(self.device, torch.float32)
        own, stride = weakref.ref(self.model), self.stride

        def fn(image):
            with torch.no_grad():
                return extractor_grid(own(), image, stride)

        cache = _EXTRACTOR_PROGRAMS.setdefault(self.model, {})
        key = ("extractor", self.cfg, stride, programs.weights(self.model))
        return programs.program(cache, key, fn, (image,))(image)

    def __call__(self, image: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
        """image: (H, W, 3) in [0, 1]; pts_xy: (K, 2) crop-pixel (x, y).
        Returns (K, D) float32 unit descriptors on the extractor's device.
        The resize is an upscale whenever stride <= 14; a downscale raises
        rather than drop the antialias `jax.image.resize` would apply."""
        h, w = image.shape[:2]
        grid = self.grid(image)
        with torch.no_grad():
            return interpolate_features(grid, pts_xy.to(self.device, torch.float32), (h, w),
                                        impl=self.interp_impl)


# ---------------------------------------------------------------------------
# The official DINOv2 torch checkpoint (counterpart of port_torch_state_dict /
# load_dinov2_params)
# ---------------------------------------------------------------------------

def port_torch_state_dict(sd, cfg: ViTConfig = VIT_L14):
    """An official DINOv2 state dict (facebookresearch/dinov2 key layout:
    `patch_embed.proj`, `blocks.N.{norm1, attn.qkv, attn.proj, ls1.gamma,
    norm2, mlp.fc1, mlp.fc2, ls2.gamma}`, `norm`, `cls_token`, `pos_embed`)
    as the JAX package's parameter tree, which `DinoFeatureExtractor(params=)`
    and `models/porting.py::load_vit` take: float32 numpy leaves, the blocks
    stacked on a depth axis.

    The patch embedding is a (D, 3, p, p) convolution; the tree keeps it as
    (p, p, 3, D), which `load_vit` flattens to a Dense over patches in
    (py, px, c) order: the convolution's weight permuted to (D, p, p, 3)."""
    def a(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, np.float32)

    def stack(suffix, transpose=False):
        return np.stack([a(sd[f"blocks.{i}.{suffix}"]).T if transpose else a(sd[f"blocks.{i}.{suffix}"])
                         for i in range(cfg.depth)])

    def dense(name):
        return {"kernel": stack(f"{name}.weight", transpose=True), "bias": stack(f"{name}.bias")}

    return {"params": {
        "patch_embed": {"kernel": a(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
                        "bias": a(sd["patch_embed.proj.bias"])},
        "cls_token": a(sd["cls_token"]).reshape(1, cfg.embed_dim),
        "pos_embed": a(sd["pos_embed"]).reshape(-1, cfg.embed_dim),
        "blocks": {
            "norm1": {"scale": stack("norm1.weight"), "bias": stack("norm1.bias")},
            "norm2": {"scale": stack("norm2.weight"), "bias": stack("norm2.bias")},
            "ls1": stack("ls1.gamma"),
            "ls2": stack("ls2.gamma"),
            "attn": {"qkv": dense("attn.qkv"), "proj": dense("attn.proj")},
            "mlp_fc1": dense("mlp.fc1"),
            "mlp_fc2": dense("mlp.fc2"),
        },
        "norm": {"scale": a(sd["norm.weight"]), "bias": a(sd["norm.bias"])},
    }}


def load_dinov2_params(path: str, cfg: ViTConfig = VIT_L14):
    """The parameter tree of an official DINOv2 `.pth` (a `{"model": sd}`
    wrapper is unwrapped), read with `torch.load(weights_only=True)`; None
    when there is no such file."""
    if not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return port_torch_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# A trained backbone on disk (counterpart of save_backbone / load_backbone)
# ---------------------------------------------------------------------------

def _float32_tree(tree):
    if isinstance(tree, dict):
        return {k: _float32_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def save_backbone(prefix: str, model: DinoViT, stride: int = 8, out_size: int = 256) -> str:
    """Write `model` as `{prefix}.msgpack` (flax layout, float32, the blocks
    stacked on a depth axis) and `{prefix}.json` (the architecture and the
    descriptor convention it was trained with). The JAX package's
    `load_backbone` reads the pair, and this module's reads what that
    package's `save_backbone` wrote. Compute dtype, attention
    implementation and quantization are choices of the loader and are not
    stored; every leaf is written as float32, as the JAX function writes it."""
    from cppf2_torch.models.checkpoints import dumps_msgpack
    from cppf2_torch.models.porting import vit_to_tree

    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(prefix + ".msgpack", "wb") as f:
        f.write(dumps_msgpack(_float32_tree(vit_to_tree(model))))
    cfg = model.cfg
    meta = {
        "patch_size": cfg.patch_size, "embed_dim": cfg.embed_dim,
        "depth": cfg.depth, "num_heads": cfg.num_heads,
        "mlp_ratio": cfg.mlp_ratio, "layerscale_init": cfg.layerscale_init,
        "pretrain_grid": cfg.pretrain_grid,
        "stride": stride, "out_size": out_size,
    }
    with open(prefix + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return prefix + ".msgpack"


def load_backbone(prefix: str, device="cuda", **cfg_overrides) -> Optional[tuple]:
    """Read a `save_backbone` pair. Returns (DinoViT on `device`, cfg, stride,
    out_size), or None when there is no such file. `cfg_overrides` set the
    loader's choices (compute_dtype, attn_impl, quant). With quant="int8"
    the returned ViT is quantized (`DinoViT.quantize_`), which the JAX
    package leaves to the `DinoFeatureExtractor` its caller builds."""
    from cppf2_torch.models.checkpoints import load_params_msgpack
    from cppf2_torch.models.porting import load_vit

    if not os.path.exists(prefix + ".msgpack"):
        return None
    with open(prefix + ".json") as f:
        meta = json.load(f)
    stride = int(meta.pop("stride"))
    out_size = int(meta.pop("out_size"))
    cfg = ViTConfig(**meta, **cfg_overrides)
    model = load_vit(DinoViT(cfg), load_params_msgpack(prefix + ".msgpack"))
    if cfg.quant == "int8":
        model.quantize_()
    return model.to(device), cfg, stride, out_size
