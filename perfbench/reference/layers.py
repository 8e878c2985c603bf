"""Residual MLP building blocks (counterpart of `cppf2_tpu/models/layers.py`)
and the ViT's W8A8 linear (`QDense`, counterpart of
`cppf2_tpu/models/dinov2.py::_QDense`).

`Dense` reproduces flax `nn.Dense(dtype=...)` exactly: input, weight and bias
are cast to the compute dtype, the product is rounded to it, and the bias is
added in it as a second rounding. Parameters are held as given (float32
unless the caller casts them).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from perfbench.reference import precision

# standard deviation of a standard normal truncated to [-2, 2]
TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill an (out, in) weight in place with flax's `lecun_normal`, the
    default kernel init of `nn.Dense`: a standard normal truncated to
    [-2, 2], times sqrt(1 / fan_in) / 0.87962566 (which gives the product
    variance 1 / fan_in). Drawn on the generator's device."""
    w = torch.empty(weight.shape, device=generator.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        weight.copy_(w * (math.sqrt(1.0 / weight.shape[1]) / TRUNC_NORMAL_STD))
    return weight


class Dense(nn.Linear):
    """nn.Linear that computes in `compute_dtype` like flax's Dense."""

    def __init__(self, d_in: int, d_out: int, compute_dtype=torch.float32):
        super().__init__(d_in, d_out)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return (torch.matmul(precision.low(x.to(dt)), precision.low(self.weight.to(dt)).t())
                + self.bias.to(dt))


# XLA folds the division by the constant 127 into a product with its float32
# reciprocal; the port takes the same product so the activation codes agree
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel int8 codes of a flax-layout kernel (..., d_in,
    d_out) and their float32 scales (..., d_out): s = max(max|w_col|,
    1e-12) / 127, codes = clip(round(w / s), -127, 127), in numpy float32 as
    `quantize_vit_params` computes them, so both agree bit for bit."""
    w = np.asarray(w, np.float32)
    s = np.maximum(np.abs(w).max(axis=-2), 1e-12) / 127.0
    codes = np.clip(np.round(w / s[..., None, :]), -127, 127).astype(np.int8)
    return codes, s.astype(np.float32)


class QDense(Dense):
    """Dense with the W8A8 int8 route of the JAX `_QDense`.

    Holds nn.Linear's (d_out, d_in) weight, a float32 bias and a float32
    per-output-channel `qscale` (ones until `quantize_`). The route follows
    the weight's dtype, as the JAX layer follows its kernel's: a float weight
    is exactly `Dense`; an int8 weight quantizes the activations per row
    (ax = max|x| in x's dtype, times 1/127 in float32, floor 1e-12; codes
    round(x / ax) half to even, clipped to +-127), multiplies the codes with
    `torch._int_mm` into int32, and returns (y * ax * qscale + bias) in the
    compute dtype. `_int_mm` has no fallback here: a shape it refuses (on
    CUDA: 16 rows or fewer, d_in or d_out not a multiple of 8) raises.

    XLA's CPU fusion contracts `* qscale + bias` into one fused multiply-add;
    the port emulates it in float64 (the product of two float32 values is
    exact there, so only a sum at an exact float32 midpoint can round
    otherwise). Every call of the int8 route adds one to `QDense.launches`.
    """

    launches = 0

    def __init__(self, d_in: int, d_out: int, compute_dtype=torch.float32):
        super().__init__(d_in, d_out, compute_dtype)
        self.register_buffer("qscale", torch.ones(d_out))

    def quantize_(self) -> "QDense":
        """Replace a float weight by its int8 codes and set `qscale`
        (`quantize_kernel` of the float32 weight); an int8 weight stays."""
        if self.weight.dtype == torch.int8:
            return self
        w = self.weight.detach().to("cpu", torch.float32).numpy().T
        codes, s = quantize_kernel(w)
        self.set_int8(codes.T, s)
        return self

    def set_int8(self, codes: np.ndarray, qscale: np.ndarray) -> None:
        """Take (d_out, d_in) int8 codes and (d_out,) scales as the weight."""
        dev = self.weight.device
        codes = torch.from_numpy(np.ascontiguousarray(codes, np.int8)).to(dev)
        if tuple(codes.shape) != tuple(self.weight.shape):
            raise ValueError(f"shape mismatch: module {tuple(self.weight.shape)} vs codes {tuple(codes.shape)}")
        self.weight = nn.Parameter(codes, requires_grad=False)
        with torch.no_grad():
            self.qscale.copy_(torch.from_numpy(np.asarray(qscale, np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype != torch.int8:
            return super().forward(x)
        QDense.launches += 1
        ax = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True).float() * _INV_127,
                         min=1e-12)
        xq = torch.clamp(torch.round(x.float() / ax), -127, 127).to(torch.int8)
        y = torch._int_mm(xq.reshape(-1, x.shape[-1]), self.weight.t())
        y = y.reshape(*x.shape[:-1], -1).float() * ax
        out = y.double() * self.qscale.double() + self.bias.double()
        return out.float().to(self.compute_dtype)


class ResLayer(nn.Module):
    """y = fc2(relu(fc1(x))) + skip, skip projected when widths differ."""

    def __init__(self, d_in: int, d_out: int, compute_dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(d_in, d_out, compute_dtype)
        self.fc2 = Dense(d_out, d_out, compute_dtype)
        self.proj = Dense(d_in, d_out, compute_dtype) if d_in != d_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.proj is None else self.proj(x)
        return self.fc2(torch.relu(self.fc1(x))) + skip


class ResMLP(nn.Module):
    """Stack of ResLayers over a width schedule, named res0, res1, ..."""

    def __init__(self, d_in: int, dims: Sequence[int], compute_dtype=torch.float32):
        super().__init__()
        widths = [d_in, *dims]
        for i, d in enumerate(dims):
            self.add_module(f"res{i}", ResLayer(widths[i], d, compute_dtype))
        self.depth = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"res{i}")(x)
        return x
