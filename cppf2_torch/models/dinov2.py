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
the route autograd can follow (training the backbone, `train/visual.py`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cppf2_torch.core.geometry import norm
from cppf2_torch.models.layers import Dense, lecun_normal_
from cppf2_torch.ops import attention

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
    # row sum divided after PV; plain PyTorch, differentiable.
    attn_impl: str = "kernel"


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


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.attn_impl not in ("kernel", "hbm"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} (expected 'kernel' or 'hbm')")
        dt = _DTYPES[cfg.compute_dtype]
        self.cfg = cfg
        self.qkv = Dense(cfg.embed_dim, 3 * cfg.embed_dim, dt)
        self.proj = Dense(cfg.embed_dim, cfg.embed_dim, dt)

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
        self.mlp_fc1 = Dense(d, int(d * cfg.mlp_ratio), dt)
        self.mlp_fc2 = Dense(int(d * cfg.mlp_ratio), d, dt)
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

    def init_random(self, generator: torch.Generator) -> "DinoViT":
        """Seeded random weights in the JAX init's distributions (flax's
        `lecun_normal` kernels, a normal truncated at two standard deviations
        with variance 1 / fan_in; zero biases; N(0, 0.02) position
        embedding)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
            self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=generator,
                                                    device=self.pos_embed.device))
        return self

    def cast_for_inference(self) -> "DinoViT":
        """Store matrices in the compute dtype, as the JAX extractor does
        (`DinoFeatureExtractor._cast`): Dense weights, the patch embed, the
        class token and the position embedding; vectors stay float32."""
        dt = _DTYPES[self.cfg.compute_dtype]
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
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
        rh = torch.from_numpy(cubic_resize_matrix(g, gh)).to(dev)
        rw = torch.from_numpy(cubic_resize_matrix(g, gw)).to(dev)
        out = torch.einsum("oh,hwc->owc", rh, pos.float())
        out = torch.einsum("pw,owc->opc", rw, out)
        return out.to(pos.dtype).reshape(gh * gw, d)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        p = c.patch_size
        lead = img.shape[:-3]
        gh, gw = img.shape[-3] // p, img.shape[-2] // p
        mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
        std = torch.as_tensor(IMAGENET_STD, device=img.device)
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
    rh = torch.from_numpy(_linear_resize_matrix(h, oh)).to(img.device)
    rw = torch.from_numpy(_linear_resize_matrix(w, ow)).to(img.device)
    t1 = torch.einsum("oh,...hwc->...owc", rh, img)
    return torch.einsum("pw,...owc->...opc", rw, t1)


def interpolate_features(feat_grid: torch.Tensor, pts_xy: torch.Tensor,
                         image_hw: Tuple[int, int], normalize: bool = True,
                         impl: str = "gather") -> torch.Tensor:
    """Sample the (gh, gw, D) token grid at (K, 2) image-pixel coordinates
    with F.grid_sample(bilinear, align_corners=False) semantics, zero
    outside; optionally L2-normalize.

    impl="gather" takes the four taps as row gathers; impl="onehot" folds
    them into one (K, gh*gw) combination matrix and one product with the
    flattened grid, both operands rounded to bfloat16 and the sums in
    float32, as the JAX package's "onehot" form does."""
    if impl not in ("gather", "onehot"):
        raise ValueError(f"unknown impl {impl!r} (expected 'gather' or 'onehot')")
    gh, gw, d = feat_grid.shape
    h, w = image_hw
    nx = ((pts_xy[:, 0] + 0.5) / w) * 2 - 1
    ny = ((pts_xy[:, 1] + 0.5) / h) * 2 - 1
    fx = ((nx + 1) * gw - 1) / 2
    fy = ((ny + 1) * gh - 1) / 2
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    wx, wy = fx - x0f, fy - y0f
    taps = ((y0, x0, (1 - wx) * (1 - wy)), (y0, x0 + 1, wx * (1 - wy)),
            (y0 + 1, x0, (1 - wx) * wy), (y0 + 1, x0 + 1, wx * wy))

    if impl == "onehot":
        comb = torch.zeros((pts_xy.shape[0], gh * gw), device=feat_grid.device)
        for yy, xx, wt in taps:
            inb = (yy >= 0) & (yy < gh) & (xx >= 0) & (xx < gw)
            # an out-of-range tap adds nothing (the reference's all-zero one-hot row)
            idx = torch.clamp(yy, 0, gh - 1) * gw + torch.clamp(xx, 0, gw - 1)
            comb.scatter_add_(1, idx[:, None], torch.where(inb, wt, torch.zeros_like(wt))[:, None])
        bf = torch.bfloat16
        out = torch.matmul(comb.to(bf).float(), feat_grid.reshape(gh * gw, d).to(bf).float())
    else:
        def tap(yy, xx):
            inb = (yy >= 0) & (yy < gh) & (xx >= 0) & (xx < gw)
            val = feat_grid[torch.clamp(yy, 0, gh - 1), torch.clamp(xx, 0, gw - 1)]
            return torch.where(inb[:, None], val, torch.zeros((), dtype=val.dtype, device=val.device))

        out = sum(tap(yy, xx) * wt[:, None] for yy, xx, wt in taps)
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
    """(n, 2) image pixels (y, x) as float (x, y) positions in the crop of
    transform `txys`."""
    kp = pixel_yx.flip(-1).to(torch.float32)
    return (kp - txys[None, :2]) / txys[2]


def sample_crop_descriptors(grid: torch.Tensor, pixel_yx: torch.Tensor, txys: torch.Tensor,
                            out_size: int = 256, impl: str = "gather") -> torch.Tensor:
    """Bilinear token sampling of a crop grid at the cloud's image pixels
    (`impl` as in `interpolate_features`)."""
    return interpolate_features(grid, crop_keypoints(pixel_yx, txys), (out_size, out_size), impl=impl)


def bbox_crop_descriptors(model: DinoViT, rgb: torch.Tensor, mask: torch.Tensor,
                          pixel_yx: torch.Tensor, out_size: int = 256, stride: int = 8,
                          padding: float = 0.0) -> torch.Tensor:
    """The in-graph visual frontend with the bbox-square rescale convention:
    (n, D) L2-normalized descriptors at the cloud's pixels."""
    grid, txys = bbox_crop_token_grid(model, rgb, mask, out_size, stride, padding)
    return sample_crop_descriptors(grid, pixel_yx, txys, out_size)


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
    extractor stores them.
    """

    def __init__(self, params=None, cfg: Optional[ViTConfig] = None, stride: int = 4,
                 interp_impl: str = "gather", out_size: int = 256, quant: Optional[str] = None,
                 device="cuda"):
        if quant is not None:
            raise NotImplementedError(
                f"quant={quant!r}: the int8 ViT (_QDense) is not ported yet; it waits for the "
                "slice that ports the rest of the ViT variants")
        from cppf2_torch.device import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else VIT_L14
        self.stride = stride
        self.interp_impl = interp_impl
        self.out_size = out_size  # bbox-square crop resolution (driver path)
        with torch.device(self.device):
            self.model = DinoViT(self.cfg).eval()
        self.ready = False
        if params is not None:
            from cppf2_torch.models.porting import load_vit

            load_vit(self.model, params).cast_for_inference()
            self.ready = True

    def init_random(self, generator: torch.Generator) -> "DinoFeatureExtractor":
        """Seeded random weights (`DinoViT.init_random`); `generator` lives on
        the extractor's device."""
        self.model.init_random(generator).cast_for_inference()
        self.ready = True
        return self

    def __call__(self, image: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
        """image: (H, W, 3) in [0, 1]; pts_xy: (K, 2) crop-pixel (x, y).
        Returns (K, D) float32 unit descriptors on the extractor's device.
        The resize is an upscale whenever stride <= 14; a downscale raises
        rather than drop the antialias `jax.image.resize` would apply."""
        if not self.ready:
            raise RuntimeError("load or init the DINOv2 weights first")
        h, w = image.shape[:2]
        ph, pw = h // self.stride, w // self.stride
        with torch.no_grad():
            resized = resize_bilinear_matmul(image.to(self.device, torch.float32), ph * 14, pw * 14)
            grid = self.model(resized)
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

def save_backbone(prefix: str, model: DinoViT, stride: int = 8, out_size: int = 256) -> str:
    """Write `model` as `{prefix}.msgpack` (flax layout, float32, the blocks
    stacked on a depth axis) and `{prefix}.json` (the architecture and the
    descriptor convention it was trained with). The JAX package's
    `load_backbone` reads the pair, and this module's reads what that
    package's `save_backbone` wrote. Compute dtype and attention
    implementation are choices of the loader and are not stored."""
    from cppf2_torch.models.checkpoints import dumps_msgpack
    from cppf2_torch.models.porting import vit_to_tree

    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(prefix + ".msgpack", "wb") as f:
        f.write(dumps_msgpack(vit_to_tree(model)))
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
    loader's choices (compute_dtype, attn_impl)."""
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
    return model.to(device), cfg, stride, out_size
