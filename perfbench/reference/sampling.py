"""Point sampling: farthest point sampling and masked random choice
(counterpart of `cppf2_tpu/ops/sampling.py`).

FPS is the analog of the reference's `farthest_point_sample` (utils/util.py
2165-2186 region) over a fixed sample budget with validity masking; the
random choices take injected uniforms, so a test can hand them the numbers
`jax.random` drew for the reference.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def farthest_point_sample(points: torch.Tensor, valid: torch.Tensor, m: int,
                          start: int = 0) -> torch.Tensor:
    """(m,) int64 indices of m farthest-point samples over the valid points.

    Deterministic given `start`. Invalid points are never picked (their
    distance is -inf); an invalid `start` moves to the first valid index
    (an all-invalid cloud gives m copies of index 0); with fewer than m
    valid points picks repeat. Each step takes the first index of the
    largest distance, as argmax does in both packages. Nothing is read back
    from the device."""
    n = points.shape[0]
    dev = points.device
    inf_mask = torch.where(valid, torch.zeros((), device=dev),
                           torch.full((), float("-inf"), device=dev))
    seed = torch.where(valid[start], torch.tensor(start, device=dev),
                       torch.argmax(valid.to(torch.int32)))
    picks = [seed]
    dist = torch.full((n,), float("inf"), dtype=points.dtype, device=dev)
    for _ in range(1, m):
        d = torch.sum((points - points[picks[-1]]) ** 2, dim=-1)
        dist = torch.minimum(dist, d)
        picks.append(torch.argmax(dist + inf_mask))
    return torch.stack(picks).to(torch.int64)


def masked_tuple_choice(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(m, k) uniform indices over the valid prefix [0, count) of a padded
    cloud, from injected uniforms `u` (m, k) in [0, 1): floor(u * count).
    A group's (B, m, k) uniforms with (B,) counts pick in each instance's
    own prefix.

    The one tuple-sampling convention of training (train_shot.py:88) and
    inference (eval.py:207); `voxel_downsample` packs valid points first."""
    return torch.floor(u * count[..., None, None]).to(torch.int64)


def masked_choice(u: Union[torch.Tensor, torch.Generator], count: torch.Tensor,
                  m: Optional[int] = None) -> torch.Tensor:
    """(m,) uniform indices over the valid prefix [0, count) of a padded
    cloud (dataset.py:397 / eval.py:196): floor(u * count) of injected
    uniforms `u` in [0, 1), or of m uniforms drawn from the generator `u`
    on its device."""
    if isinstance(u, torch.Generator):
        if m is None:
            raise ValueError("masked_choice draws m uniforms from a generator: pass m")
        u = torch.rand(m, generator=u, device=u.device)
    return torch.floor(u * count).to(torch.int64)
