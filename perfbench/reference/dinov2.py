"""DINOv2 ViT and the bbox-crop visual frontend, plain PyTorch (a frozen copy
of `cppf2_torch/models/dinov2.py`'s plain routes).

Patch embed as unfold + matmul in the (gh, p, gw, p, 3) order, the
pretrained position grid resized with antialiased Keys-cubic (a = -0.5)
weights, pre-norm blocks with LayerScale, bilinear token sampling at the
cloud's pixels. The residual stream and LayerNorm (epsilon 1e-6, variance as
E[x^2] - E[x]^2) are float32; linears compute in `cfg.compute_dtype`; GELU is
the tanh form. Attention is the plain "hbm" formulation: (T, T) logits, the
softmax's exponentials rounded to the compute dtype, the row sum divided
after PV.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import precision
from perfbench.reference.device import device_constant
from perfbench.reference.geometry import norm
from perfbench.reference.layers import Dense, QDense
from perfbench.reference.voting import take_rows

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
            raise ValueError("the reference has no kernel route: use attn_impl='hbm'")
        if self.cfg.attn_impl == "chunked":
            o = _chunked_attention(qh, kh, vh, self.cfg.attn_chunk, dt)
        else:
            logits = torch.matmul(precision.low(qh), precision.low(kh).transpose(-1, -2))
            m = torch.amax(logits, dim=-1, keepdim=True).detach()
            e = torch.exp((logits - m).float()).to(dt)
            s = torch.sum(e.float(), dim=-1, keepdim=True)
            o = torch.matmul(precision.low(e.float()), precision.low(vh.float().transpose(-1, -2)).transpose(-1, -2)) / s
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


def extractor_grid(model: "DinoViT", image: torch.Tensor, stride: int) -> torch.Tensor:
    """The eager resize and ViT forward of `DinoFeatureExtractor`: the
    (H, W, 3) float32 crop in [0, 1] resized bilinearly to (H/stride*14,
    W/stride*14) and through `model`; returns the (H/stride, W/stride, D)
    token grid. A program's body (the extractor's own, or the driver's
    instance visual stage) calls this, never the extractor itself."""
    h, w = image.shape[:2]
    ph, pw = h // stride, w // stride
    return model(resize_bilinear_matmul(image, ph * 14, pw * 14))
