"""Residual MLP building blocks (counterpart of `cppf2_tpu/models/layers.py`).

`Dense` reproduces flax `nn.Dense(dtype=...)` exactly: input, weight and bias
are cast to the compute dtype, the product is rounded to it, and the bias is
added in it as a second rounding. Parameters are held as given (float32
unless the caller casts them).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

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
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


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
