"""Masked random tuple choice (counterpart of `cppf2_tpu/ops/sampling.py`)."""

from __future__ import annotations

import torch


def masked_tuple_choice(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(m, k) uniform indices over the valid prefix [0, count) of a padded
    cloud, from injected uniforms `u` (m, k) in [0, 1): floor(u * count).

    The one tuple-sampling convention of training (train_shot.py:88) and
    inference (eval.py:207); `voxel_downsample` packs valid points first."""
    return torch.floor(u * count).to(torch.int64)
