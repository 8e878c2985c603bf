"""SE(3) alignment refinement and the yaw micro-sweep.

Counterpart of `cppf2_tpu/infer/alignment.py` (reference eval.py:319-355):
Adam over (translation, delta quaternion) minimizing the L1 distance between
the observed kept pairs brought into canonical space and the predicted
canonical pairs. The Adam step is written out with optax's constants
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0); the quaternion gradient is scaled
by pi/180 before each step (eval.py:338).

Both functions take a leading row axis (a row is one (instance, branch) pair
of the pose graph, the axis the JAX package adds with jax.vmap): one Adam
loop of `steps` steps for all rows, each row with its own loss, denominator,
moments and parameters. The step differentiates the sum of the rows' losses;
each row's loss reduces over that row's own (K, 2, 3) block, so each row's
gradient is its own loss's gradient exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cppf2_torch.core.geometry import norm, quat_to_matrix
from cppf2_torch.device import device_constant
from cppf2_torch.ops.voting import _one_row, take_rows

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8
# yaw_sweep: +-10 deg micro sweep in 41 steps, a 10-degree full-circle ring
# that must win by 25%, and the feature-mass gate
_YAW_SPAN_DEG, _YAW_NUM, _YAW_MIN_MASS, _YAW_RING_STEP_DEG, _YAW_RING_MARGIN = (
    10.0, 41, 0.005, 10.0, 0.25)


class AlignResult(NamedTuple):
    rotation: torch.Tensor     # (3, 3), or (B, 3, 3) for rows
    translation: torch.Tensor  # (3,)
    loss: torch.Tensor         # ()


def align_pose(
    points: torch.Tensor,
    pair_idx: torch.Tensor,
    pair_weight: torch.Tensor,
    pred_pairs_scaled: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    up_sym: bool,
    up_axis: int = 1,
    steps: int = 100,
    lr: float = 1e-2,
) -> AlignResult:
    """Refine (R, T) by minimizing |canon(pc)[pairs] - pred_pairs_scaled|.

    Under `up_sym` only the canonical `up_axis` coordinate enters the loss.
    Rows: points (B, N, 3), pair_idx (B, K, 2), pair_weight (B, K),
    pred_pairs_scaled (B, K, 2, 3), rotation (B, 3, 3) and translation
    (B, 3), refined together in one loop."""
    if points.dim() == 2:
        return _one_row(align_pose, points, pair_idx, pair_weight, pred_pairs_scaled, rotation,
                        translation, up_sym, up_axis, steps, lr)
    dt = points.dtype
    n_rows = points.shape[0]
    w = (pair_weight > 0).to(dt)
    w_pairs = w[..., None, None]
    denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    pair_pts = take_rows(points, pair_idx)                       # (B, K, 2, 3)
    flat_pts = pair_pts.reshape(n_rows, -1, 3)
    rotation = rotation.detach()

    def row_losses(trans, quat):   # (B,): each row's loss over its own (K, 2, 3) block
        rot = quat_to_matrix(quat) @ rotation
        canon = torch.bmm(flat_pts - trans[:, None, :], rot).reshape(pair_pts.shape)
        diff = torch.abs(canon - pred_pairs_scaled)
        if up_sym:
            return torch.sum(diff[..., up_axis] * w_pairs[..., 0], dim=(1, 2)) / (denom * 2.0)
        return torch.sum(diff * w_pairs, dim=(1, 2, 3)) / (denom * 6.0)

    quat0 = torch.zeros((n_rows, 4), dtype=dt, device=points.device)
    quat0[:, 3].fill_(1.0)
    params = [translation.detach().clone(), quat0]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    grad_scale = (1.0, math.pi / 180.0)
    with torch.enable_grad():
        for step in range(1, steps + 1):
            leaves = [p.requires_grad_(True) for p in params]
            grads = torch.autograd.grad(torch.sum(row_losses(*leaves)), leaves)
            new = []
            for i, (p, g) in enumerate(zip(params, grads)):
                g = g * grad_scale[i]
                mu[i] = _B1 * mu[i] + (1 - _B1) * g
                nu[i] = _B2 * nu[i] + (1 - _B2) * g * g
                mu_hat = mu[i] / (1 - _B1 ** step)
                nu_hat = nu[i] / (1 - _B2 ** step)
                update = mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)
                new.append(p.detach() + (-lr) * update)
            params = new
    trans, quat = params
    with torch.no_grad():
        rot = quat_to_matrix(quat) @ rotation
        loss = row_losses(trans, quat)
    return AlignResult(rot, trans, loss)


def _axis_rotations(deltas: torch.Tensor, axis: int) -> torch.Tensor:
    """(..., 3, 3) rotations by `deltas` (...) radians about canonical axis `axis`."""
    c, s = torch.cos(deltas), torch.sin(deltas)
    i, j = [k for k in range(3) if k != axis]
    # stacked, not assigned: a Python scalar written into a slice is a host
    # tensor copied to the device, which a program's capture refuses
    m = [[torch.zeros_like(c)] * 3 for _ in range(3)]
    m[axis][axis] = torch.ones_like(c)
    m[i][i], m[j][j], m[i][j], m[j][i] = c, c, -s, s
    return torch.stack([torch.stack(row, dim=-1) for row in m], dim=-2)


def yaw_sweep(
    points: torch.Tensor,
    pair_idx: torch.Tensor,
    pair_weight: torch.Tensor,
    pred_pairs_scaled: torch.Tensor,
    pred_pairs_canon: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    up_axis_index: int,
) -> torch.Tensor:
    """Feature-weighted yaw refinement about the canonical up axis; returns
    the refined (3, 3) rotation (see the JAX counterpart for the design).
    Rows as in `align_pose`; returns (B, 3, 3)."""
    if points.dim() == 2:
        return yaw_sweep(points[None], pair_idx[None], pair_weight[None], pred_pairs_scaled[None],
                         pred_pairs_canon[None], rotation[None], translation[None],
                         up_axis_index)[0]
    span_deg, num, min_feature_mass = _YAW_SPAN_DEG, _YAW_NUM, _YAW_MIN_MASS
    ring_step_deg, ring_margin = _YAW_RING_STEP_DEG, _YAW_RING_MARGIN
    dt = points.dtype
    dev = points.device
    ax = up_axis_index
    others = [k for k in range(3) if k != ax]
    valid = (pair_weight > 0).to(dt)                             # (B, K)

    # slices stacked: a list index is a host tensor uploaded, which a capture refuses
    r = norm(torch.stack([pred_pairs_canon[..., k] for k in others], dim=-1))   # (B, K, 2)
    r_pair = torch.amax(r, dim=-1)
    nan = torch.full_like(r_pair, float("nan"))
    r_med = torch.nanquantile(torch.where(valid > 0, r_pair, nan), 0.5, dim=-1, keepdim=True)
    w_feat = torch.clamp(r_pair - r_med, min=0.0) * valid
    mass = torch.sum(w_feat, dim=-1) / torch.clamp(torch.sum(valid, dim=-1), min=1.0)
    w = w_feat[:, None, :, None, None]

    pair_pts = take_rows(points, pair_idx)                       # (B, K, 2, 3)
    canon = torch.bmm((pair_pts - translation[:, None, None, :]).reshape(points.shape[0], -1, 3),
                      rotation).reshape(pair_pts.shape)

    def sweep(deltas):   # deltas (S,) shared or (B, S) per row -> (B, S) losses
        rots = _axis_rotations(deltas, ax)
        canon_s = torch.einsum("bktc,bscd->bsktd", canon, rots.expand(canon.shape[0], -1, 3, 3))
        return (torch.sum(torch.abs(canon_s - pred_pairs_scaled[:, None]) * w, dim=(2, 3, 4))
                / torch.clamp(torch.sum(w_feat, dim=-1, keepdim=True) * 6.0, min=1e-6))

    def const(x):
        x = np.asarray(x, np.float32)
        return device_constant(("yaw_sweep", x.tobytes()), lambda: torch.from_numpy(x), dev)

    tiebreak = 3e-5 * 180.0 / np.pi
    micro = const(np.linspace(-span_deg, span_deg, num) * (np.pi / 180.0))
    loss_micro_raw = torch.amin(sweep(micro), dim=-1)

    ring_np = np.arange(1, int(round(360.0 / ring_step_deg))) * ring_step_deg
    ring_np = np.where(ring_np > 180.0, ring_np - 360.0, ring_np)
    ring_np = ring_np[np.abs(ring_np) > span_deg + 1e-6]
    ring = const(np.radians(ring_np))
    loss_ring = sweep(ring)
    br = torch.argmin(loss_ring, dim=-1)
    best_ring = loss_ring.gather(-1, br[:, None])[:, 0]
    ring_wins = (best_ring < (1.0 - ring_margin) * loss_micro_raw) & (mass > 2.0 * min_feature_mass)
    center = torch.where(ring_wins, ring[br], torch.zeros((), dtype=dt, device=dev))

    deltas2 = center[:, None] + micro
    loss2 = sweep(deltas2) + tiebreak * torch.abs(micro)
    best = deltas2.gather(-1, torch.argmin(loss2, dim=-1)[:, None])[:, 0]
    delta = torch.where(mass > min_feature_mass, best, torch.zeros((), dtype=dt, device=dev))
    return rotation @ _axis_rotations(delta, ax)
