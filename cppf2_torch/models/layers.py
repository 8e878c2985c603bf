"""Residual MLP building blocks (counterpart of `cppf2_tpu/models/layers.py`).

`Dense` reproduces flax `nn.Dense(dtype=...)` exactly: input, weight and bias
are cast to the compute dtype, the product is rounded to it, and the bias is
added in it as a second rounding. Parameters are held as given (float32
unless the caller casts them).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


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
