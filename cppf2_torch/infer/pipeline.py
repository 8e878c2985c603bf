"""Single-instance two-branch pose estimation (counterpart of
`cppf2_tpu/infer/pipeline.py`, reference eval.py:219-372).

Bin sampling -> pair targets -> center vote (kernel K2) -> noisy-pair filter
-> fused up/right cone votes -> alignment -> branch arbitration. The branch
axis is a two-iteration loop. The random draws (tuple uniforms and each
branch's Gumbel noise) are injected through `PoseDraws`; `draw_pose` makes
them from a torch.Generator. jax.random.categorical(key, logits) equals
argmax(logits + jax.random.gumbel(key, logits.shape)), so the tests feed the
port the reference's exact draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import torch

from cppf2_torch.config import CategoryConfig, PipelineConfig
from cppf2_torch.core.geometry import fibonacci_sphere, norm
from cppf2_torch.core.pairs import pair_targets
from cppf2_torch.infer.alignment import align_pose, yaw_sweep
from cppf2_torch.models.cppf import TuplePredictions
from cppf2_torch.ops.sampling import masked_tuple_choice
from cppf2_torch.ops.voting import backvote_filter, sphere_vote_cone, vote_center

_EPS = 1e-7

BranchFn = Callable[[torch.Tensor, torch.Tensor], TuplePredictions]


class PoseEstimate(NamedTuple):
    rotation: torch.Tensor     # (3, 3)
    translation: torch.Tensor  # (3,)
    scale: torch.Tensor        # (3,)
    scale_norm: torch.Tensor   # ()
    loss: torch.Tensor         # ()
    pick: Optional[torch.Tensor] = None  # () winning branch, 0 visual / 1 geometric


class PoseDraws(NamedTuple):
    tuple_u: torch.Tensor       # (num_pairs, tuple_size) uniforms in [0, 1)
    gumbel_dino: torch.Tensor   # (num_pairs * 6, num_bins) Gumbel noise, visual branch
    gumbel_shot: torch.Tensor   # (num_pairs * 6, num_bins) Gumbel noise, geometric branch


def draw_pose(cat: CategoryConfig, pipe: PipelineConfig, device,
              generator: Optional[torch.Generator] = None) -> PoseDraws:
    """One ensemble pass's draws from `generator` (gumbel = -log(-log(U)))."""
    p, nb = pipe.num_pairs, pipe.num_bins
    tiny = torch.finfo(torch.float32).tiny

    def gumbel():
        u = torch.rand((p * 6, nb), generator=generator, device=device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    u = torch.rand((p, cat.tuple_size), generator=generator, device=device)
    return PoseDraws(u, gumbel(), gumbel())


class BranchPose(NamedTuple):
    rotation: torch.Tensor         # (3, 3)
    translation: torch.Tensor      # (3,)
    scale: torch.Tensor            # (3,) this branch's median scale
    kept_pairs: torch.Tensor       # (K, 2) point indices of kept pairs
    kept_mask: torch.Tensor        # (K,) bool
    pred_pairs_kept: torch.Tensor  # (K, 2, 3) unscaled canonical predictions


def _axis(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _median0(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0, averaging the two middle values like jnp.median."""
    return torch.quantile(x, 0.5, dim=0)


def _pose_from_preds(
    logits: torch.Tensor,
    scales: torch.Tensor,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    count: torch.Tensor,
    tuple_idx: torch.Tensor,
    gumbel: torch.Tensor,
    cat: CategoryConfig,
    pipe: PipelineConfig,
    sphere_pts: torch.Tensor,
    run_opt: bool,
) -> BranchPose:
    """Everything downstream of one branch's tuple MLP."""
    dev = points.device
    up, right, front = _axis(cat.up, dev), _axis(cat.right, dev), _axis(cat.front, dev)
    nb = pipe.num_bins
    p = tuple_idx.shape[0]

    samples = torch.argmax(logits.reshape(p * 6, nb) + gumbel, dim=-1)
    pred_pairs = samples.reshape(p, 2, 3).to(points.dtype) / (nb - 1) - 0.5

    a_obs = points[tuple_idx[:, 0]]
    b_obs = points[tuple_idx[:, 1]]
    obs_len = norm(a_obs - b_obs)
    pred_len = norm(pred_pairs[:, 0] - pred_pairs[:, 1])
    pair_valid = (tuple_idx[:, 0] < count) & (tuple_idx[:, 1] < count) & (pred_len > _EPS)

    scale_mode = pipe.scale_mode or cat.scale_mode
    if scale_mode in ("head", "split"):
        nan = torch.full_like(scales, float("nan"))
        head_bound = torch.nanquantile(torch.where(pair_valid[:, None], scales, nan), 0.5, dim=0)
        factor = torch.amax(torch.abs(head_bound)).to(points.dtype)
        pred_pairs_scaled = pred_pairs * factor
        tr_pairs = pred_pairs_scaled
        if scale_mode == "split":
            up_loc = cat.up_axis_index
            d = pred_pairs[:, 0] - pred_pairs[:, 1]
            dy2 = torch.square(d[:, up_loc])
            dxz2 = torch.clamp(torch.sum(d * d, dim=-1) - dy2, min=0.0)
            fxz2 = torch.clamp(torch.square(obs_len) - torch.square(factor) * dy2, min=0.0)
            fxz = torch.sqrt(fxz2 / torch.clamp(dxz2, min=_EPS))
            fxz = torch.minimum(torch.maximum(fxz, 0.25 * factor), 4.0 * factor)
            fxz = torch.where(dxz2 > 1e-6, fxz, factor)
            axis_scale = torch.where(
                torch.arange(3, device=dev) == up_loc, factor, fxz[:, None]).to(points.dtype)
            tr_pairs = pred_pairs * axis_scale[:, None, :]
    else:
        pair_scale = obs_len / torch.clamp(pred_len, min=_EPS)
        pred_pairs_scaled = pred_pairs * pair_scale[:, None, None]
        tr_pairs = pred_pairs_scaled

    t = pair_targets(pred_pairs_scaled[:, 0], pred_pairs_scaled[:, 1], up, right, front)
    if tr_pairs is not pred_pairs_scaled:
        t = t._replace(tr=pair_targets(tr_pairs[:, 0], tr_pairs[:, 1], up, right, front).tr)

    cv = vote_center(points, point_valid, t.tr, tuple_idx[:, :2], pair_valid, cat.res,
                     levels=pipe.vote_levels, fine_samples=pipe.vote_fine_samples)
    t_est = cv.center

    bv = backvote_filter(points, t.tr, tuple_idx[:, :2], pair_valid, t_est,
                         pipe.num_kept_pairs, pipe.imp_wt_margin)
    ki = bv.kept_idx
    kept_pairs = tuple_idx[ki, :2]
    kept_w = bv.pair_weight[ki]
    inv_w = torch.where(kept_w > 0, 1.0 / torch.clamp(kept_w, min=_EPS), torch.zeros_like(kept_w))

    axis_angles = torch.stack([t.up_angle[ki], t.right_angle[ki]])
    top_dirs, _ = sphere_vote_cone(points, axis_angles, kept_pairs, inv_w, sphere_pts,
                                   pipe.angle_tol_deg)
    pred_up, pred_right = top_dirs[0], top_dirs[1]
    pred_right = pred_right - torch.dot(pred_up, pred_right) * pred_up
    pred_right = pred_right / (norm(pred_right) + 1e-9)

    up_loc, right_loc = cat.up_axis_index, cat.right_axis_index
    other_loc = ({0, 1, 2} - {up_loc, right_loc}).pop()
    cols = [None, None, None]
    cols[up_loc], cols[right_loc] = pred_up, pred_right
    cols[other_loc] = torch.linalg.cross(cols[(other_loc + 1) % 3], cols[(other_loc + 2) % 3], dim=-1)
    r_est = torch.stack(cols, dim=1)

    pred_scale = _median0(scales[ki])

    if run_opt:
        ar = align_pose(points, kept_pairs, kept_w, pred_pairs_scaled[ki], r_est, t_est,
                        cat.up_sym, cat.up_axis_index, pipe.opt_steps, pipe.opt_lr)
        r_est, t_est = ar.rotation, ar.translation

    do_sweep = cat.yaw_sweep if pipe.yaw_sweep is None else pipe.yaw_sweep
    if do_sweep and not cat.up_sym:
        r_est = yaw_sweep(points, kept_pairs, kept_w, pred_pairs_scaled[ki], pred_pairs[ki],
                          r_est, t_est, cat.up_axis_index)
    return BranchPose(r_est, t_est, pred_scale, kept_pairs, kept_w > 0, pred_pairs[ki])


def _recon_loss_rt(points, rotation, translation, yard: BranchPose, scale_norm, up_sym: bool,
                   up_axis: int = 1) -> torch.Tensor:
    """Clipped canonical reconstruction loss of (R, T) against one branch's
    kept pairs and predictions (eval.py:358-363)."""
    canon = (points - translation) @ rotation / torch.clamp(scale_norm, min=_EPS)
    diff = torch.abs(canon[yard.kept_pairs] - yard.pred_pairs_kept)
    if up_sym:
        diff = diff[..., up_axis:up_axis + 1]
    diff = torch.clamp(diff, 0.0, 0.1)
    wmask = yard.kept_mask.to(points.dtype)[:, None, None]
    return torch.sum(diff * wmask) / torch.clamp(torch.sum(wmask) * 2 * diff.shape[-1], min=1.0)


def _recon_loss(points, pose: BranchPose, scale_norm, up_sym: bool, up_axis: int = 1):
    return _recon_loss_rt(points, pose.rotation, pose.translation, pose, scale_norm, up_sym, up_axis)


def _arbitrate(points, poses: List[BranchPose], scale_norm, up_sym: bool, arbiter: str,
               margin: float, up_axis: int = 1):
    """(pick, reported loss) among the branch poses; see the JAX counterpart.

    "recon": argmin of each branch's own loss, ties to the visual branch;
    "cross": argmin of each pose's mean loss over every branch's yardstick;
    "margin": the visual branch (0) wins only by at least `margin`."""
    if arbiter not in ("recon", "cross", "margin"):
        raise ValueError(f"unknown arbiter {arbiter!r} (expected 'recon', 'cross' or 'margin')")
    own = torch.stack([_recon_loss(points, p, scale_norm, up_sym, up_axis) for p in poses])
    if arbiter == "cross" and len(poses) > 1:
        lmat = torch.stack([
            torch.stack([_recon_loss_rt(points, pi.rotation, pi.translation, pj, scale_norm,
                                        up_sym, up_axis) for pj in poses])
            for pi in poses])
        score = torch.mean(lmat, dim=1)
        pick = torch.argmin(score)
        return pick, score[pick]
    if arbiter == "margin" and len(poses) > 1:
        pick = torch.where(own[0] <= own[1] - margin, 0, 1)
        return pick, own[pick]
    pick = torch.argmin(own)
    return pick, own[pick]


def estimate_pose_ensemble(
    dino_fn: Optional[BranchFn],
    shot_fn: Optional[BranchFn],
    points: torch.Tensor,
    point_valid: torch.Tensor,
    count: torch.Tensor,
    cat: CategoryConfig,
    pipe: PipelineConfig,
    draws: Union[PoseDraws, Sequence[PoseDraws], None] = None,
    generator: Optional[torch.Generator] = None,
    run_opt: bool = True,
    use_visual: bool = True,
    use_geo: bool = True,
) -> PoseEstimate:
    """Run both branches on one shared tuple sample and keep the better pose.

    `dino_fn(points, tuple_idx)` / `shot_fn(points, tuple_idx)` return the
    branch's TuplePredictions. `draws` holds one PoseDraws per restart (a
    bare PoseDraws when `pipe.restarts` is 1); when None they are drawn from
    `generator`. With restarts > 1 the ensemble reruns on each draw and the
    lowest reported loss wins (first on ties).
    """
    if not (use_visual or use_geo):
        raise ValueError("at least one branch must be enabled")
    n_runs = pipe.restarts
    if draws is None:
        draws = [draw_pose(cat, pipe, points.device, generator) for _ in range(n_runs)]
    elif isinstance(draws, PoseDraws):
        draws = [draws]
    if len(draws) != n_runs:
        raise ValueError(f"expected {n_runs} PoseDraws (pipe.restarts), got {len(draws)}")
    single = dataclasses.replace(pipe, restarts=1)
    ests = [_ensemble_once(dino_fn, shot_fn, points, point_valid, count, cat, single, d,
                           run_opt, use_visual, use_geo) for d in draws]
    if n_runs == 1:
        return ests[0]
    i = torch.argmin(torch.stack([e.loss for e in ests]))
    return PoseEstimate(*(torch.stack([getattr(e, f) for e in ests])[i] for f in PoseEstimate._fields))


def _ensemble_once(dino_fn, shot_fn, points, point_valid, count, cat, pipe, draws: PoseDraws,
                   run_opt, use_visual, use_geo) -> PoseEstimate:
    sphere_pts = torch.from_numpy(fibonacci_sphere(pipe.sphere_samples)).to(points.device)
    tuple_idx = masked_tuple_choice(draws.tuple_u, count)

    branches = []
    if use_visual:
        branches.append((dino_fn(points, tuple_idx), draws.gumbel_dino))
    if use_geo:
        branches.append((shot_fn(points, tuple_idx), draws.gumbel_shot))
    poses = [_pose_from_preds(pr.logits, pr.scales, points, point_valid, count, tuple_idx, gum,
                              cat, pipe, sphere_pts, run_opt) for pr, gum in branches]

    scale = poses[0].scale
    scale_norm = norm(scale)
    pick, loss = _arbitrate(points, poses, scale_norm, cat.up_sym, pipe.arbiter,
                            pipe.arbiter_margin, cat.up_axis_index)
    branch_id = pick if use_visual else pick + 1
    return PoseEstimate(
        torch.stack([p.rotation for p in poses])[pick],
        torch.stack([p.translation for p in poses])[pick],
        scale, scale_norm, loss, branch_id.to(torch.int32))
