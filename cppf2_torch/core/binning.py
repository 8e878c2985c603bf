"""Soft bin codecs: scalar value <-> probability over bins.

Counterpart of `cppf2_tpu/core/binning.py` (reference utils/util.py:215-272):
the two-bin soft assignment that is the classification target for canonical
coordinates, written with one-hot products instead of scatters.
"""

from __future__ import annotations

import math

import torch


def real2prob(val: torch.Tensor, max_val: float, num_bins: int, circular: bool = False) -> torch.Tensor:
    """Encode values in [0, max_val] as a soft two-bin distribution.

    Non-circular: bins lie at i * max_val / (num_bins - 1) and the mass is
    split linearly between the two bracketing bins. Circular: bins tile
    [0, max_val) with wraparound.

    Args:
        val: any shape, values in [0, max_val].
    Returns:
        val.shape + (num_bins,) probabilities summing to 1 along the last axis.
    """
    if circular:
        interval = max_val / num_bins
        val_new = torch.where(val < interval / 2, val + max_val, val)
        res = real2prob(val_new - interval / 2, max_val, num_bins + 1, circular=False)
        first = res[..., 0] + res[..., -1]
        return torch.cat([first[..., None], res[..., 1:-1]], dim=-1)
    interval = max_val / (num_bins - 1)
    low = torch.clamp(torch.floor(val / interval).to(torch.int64), 0, num_bins - 2)
    frac = val / interval - low.to(val.dtype)
    w_low = 1.0 - frac
    # F.one_hot's values, without the range checks it reads back from a CPU
    # tensor (a train step's program must read nothing back)
    bins = torch.arange(num_bins, device=val.device)
    onehot_low = (low[..., None] == bins).to(val.dtype)
    onehot_high = (low[..., None] + 1 == bins).to(val.dtype)
    return onehot_low * w_low[..., None] + onehot_high * (1.0 - w_low)[..., None]


def prob2real(prob: torch.Tensor, max_val: float, num_bins: int, circular: bool = False) -> torch.Tensor:
    """Decode a distribution over bins back to a scalar expectation.

    Non-circular: the expectation over the bin centers. Circular: the angle
    of the mean unit vector, in [0, 2 pi).
    """
    idx = torch.arange(num_bins, dtype=prob.dtype, device=prob.device)
    if not circular:
        return torch.sum(prob * (idx * (max_val / (num_bins - 1))), dim=-1)
    interval = max_val / num_bins
    ang = idx * interval + interval / 2
    vec = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    res = torch.sum(prob[..., None] * vec, dim=-2)
    theta = torch.atan2(res[..., 1], res[..., 0])
    return torch.where(theta < 0, theta + 2 * math.pi, theta)
