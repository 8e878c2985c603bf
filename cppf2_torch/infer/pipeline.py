"""Single-instance two-branch pose estimation (counterpart of
`cppf2_tpu/infer/pipeline.py`, reference eval.py:219-372).

Bin sampling -> pair targets -> center vote (kernel K2) -> noisy-pair filter
-> fused up/right cone votes -> alignment -> branch arbitration. Everything
after the branch MLPs runs once over a leading row axis, a row being one
(instance, branch) pair, instance-major: the JAX package's jax.vmap over the
branch axis (`cppf2_tpu/infer/pipeline.py:444`) and over a frame group's
instances (`cppf2_tpu/eval/driver.py::_frame_group_fn`). So a group's votes,
sorts and alignment loops are one batched computation: four K2 launches and
one Adam loop for the whole group. `estimate_pose_group` takes a group's
MLP outputs; `estimate_pose_ensembles` runs the tuple choice and one forward
of each branch MLP for the whole group (`branch_outputs`) and the restarts
(one after another, as lax.map does) around it; `estimate_pose_ensemble` is
a group of one. `estimate_pose_branch_restarts` runs its restarts as rows of
one pass, as the JAX package vmaps them. The random draws (tuple uniforms
and each branch's Gumbel noise) are injected through `PoseDraws`, one set per
instance, so batching changes no draw; `draw_pose` makes them from a
torch.Generator. jax.random.categorical(key, logits) equals
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
from cppf2_torch.device import device_constant
from cppf2_torch.infer.alignment import align_pose, yaw_sweep
from cppf2_torch.models.cppf import TuplePredictions
from cppf2_torch.ops.sampling import masked_tuple_choice
from cppf2_torch.ops.voting import backvote_filter, sphere_vote_cone, take_rows, vote_center
from cppf2_torch.utils.profiling import stage

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
    shape = (pipe.num_pairs * 6, pipe.num_bins)
    u = torch.rand((pipe.num_pairs, cat.tuple_size), generator=generator, device=device)
    return PoseDraws(u, _gumbel(shape, device, generator), _gumbel(shape, device, generator))


class BranchDraws(NamedTuple):
    """One single-branch pass's draws (`estimate_pose_branch_restarts`)."""

    tuple_u: torch.Tensor  # (num_pairs, tuple_size) uniforms in [0, 1)
    gumbel: torch.Tensor   # (num_pairs * 6, num_bins) Gumbel noise


def _gumbel(shape, device, generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_branch(cat: CategoryConfig, pipe: PipelineConfig, device,
                generator: Optional[torch.Generator] = None) -> BranchDraws:
    """One single-branch pass's draws from `generator`."""
    u = torch.rand((pipe.num_pairs, cat.tuple_size), generator=generator, device=device)
    return BranchDraws(u, _gumbel((pipe.num_pairs * 6, pipe.num_bins), device, generator))


class BranchPose(NamedTuple):
    """One branch's pose per row (the leading axis, B rows or (I, branches))."""

    rotation: torch.Tensor         # (B, 3, 3)
    translation: torch.Tensor      # (B, 3)
    scale: torch.Tensor            # (B, 3) this branch's median scale
    kept_pairs: torch.Tensor       # (B, K, 2) point indices of kept pairs
    kept_mask: torch.Tensor        # (B, K) bool
    pred_pairs_kept: torch.Tensor  # (B, K, 2, 3) unscaled canonical predictions


def _axis(v, device) -> torch.Tensor:
    return device_constant(("axis", tuple(v)), lambda: torch.tensor(v, dtype=torch.float32), device)


def _sphere(n: int, device) -> torch.Tensor:
    """The (n, 3) Fibonacci sphere of the cone vote, on `device`."""
    return device_constant(("fibonacci_sphere", n), lambda: torch.from_numpy(fibonacci_sphere(n)), device)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading i back to the host (plain
    indexing with a 0-d tensor converts it to a Python int, a device sync)."""
    return torch.index_select(x, 0, i.reshape(1)).squeeze(0)


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
    """Everything downstream of the tuple MLPs, for B rows at once: logits
    (B, P, 6, bins), scales (B, P, 3), points (B, N, 3), point_valid (B, N),
    count (B,), tuple_idx (B, P, tuple size) and Gumbel noise (B, P * 6, bins).
    Each step is a stage (`utils/profiling.py::stage`): targets, center_vote,
    backvote, cone_vote, align, finish."""
    dev = points.device
    with stage("targets", dev):
        pred_pairs, pred_pairs_scaled, t, pair_valid = _targets(
            logits, scales, points, count, tuple_idx, gumbel, cat, pipe)
    pair_idx = tuple_idx[..., :2]
    with stage("center_vote", dev):
        cv = vote_center(points, point_valid, t.tr, pair_idx, pair_valid, cat.res,
                         levels=pipe.vote_levels, fine_samples=pipe.vote_fine_samples)
    t_est = cv.center

    with stage("backvote", dev):
        bv = backvote_filter(points, t.tr, pair_idx, pair_valid, t_est,
                             pipe.num_kept_pairs, pipe.imp_wt_margin)
        ki = bv.kept_idx                                             # (B, K)
        kept_pairs = take_rows(pair_idx, ki)
        kept_w = take_rows(bv.pair_weight, ki)
        inv_w = torch.where(kept_w > 0, 1.0 / torch.clamp(kept_w, min=_EPS), torch.zeros_like(kept_w))
        axis_angles = torch.stack([take_rows(t.up_angle, ki), take_rows(t.right_angle, ki)], dim=1)
        scaled_kept = take_rows(pred_pairs_scaled, ki)
        pred_kept = take_rows(pred_pairs, ki)

    with stage("cone_vote", dev):
        top_dirs, _ = sphere_vote_cone(points, axis_angles, kept_pairs, inv_w, sphere_pts,
                                       pipe.angle_tol_deg)
        pred_up, pred_right = top_dirs[:, 0], top_dirs[:, 1]
        pred_right = pred_right - torch.sum(pred_up * pred_right, dim=-1, keepdim=True) * pred_up
        pred_right = pred_right / (norm(pred_right, keepdim=True) + 1e-9)

        up_loc, right_loc = cat.up_axis_index, cat.right_axis_index
        other_loc = ({0, 1, 2} - {up_loc, right_loc}).pop()
        cols = [None, None, None]
        cols[up_loc], cols[right_loc] = pred_up, pred_right
        cols[other_loc] = torch.linalg.cross(cols[(other_loc + 1) % 3], cols[(other_loc + 2) % 3],
                                             dim=-1)
        r_est = torch.stack(cols, dim=-1)

    if run_opt:
        with stage("align", dev):
            ar = align_pose(points, kept_pairs, kept_w, scaled_kept, r_est, t_est,
                            cat.up_sym, cat.up_axis_index, pipe.opt_steps, pipe.opt_lr)
        r_est, t_est = ar.rotation, ar.translation

    with stage("finish", dev):
        pred_scale = _median0(take_rows(scales, ki).transpose(0, 1))   # each row over its own pairs
        do_sweep = cat.yaw_sweep if pipe.yaw_sweep is None else pipe.yaw_sweep
        if do_sweep and not cat.up_sym:
            r_est = yaw_sweep(points, kept_pairs, kept_w, scaled_kept, pred_kept, r_est, t_est,
                              cat.up_axis_index)
        kept_mask = kept_w > 0
    return BranchPose(r_est, t_est, pred_scale, kept_pairs, kept_mask, pred_kept)


def _targets(logits, scales, points, count, tuple_idx, gumbel, cat: CategoryConfig,
             pipe: PipelineConfig):
    """Bin sampling (argmax with Gumbel noise), the pair scale and the pair
    targets of `_pose_from_preds`: (pred_pairs, pred_pairs_scaled,
    PairTargets, pair_valid)."""
    dev = points.device
    up, right, front = _axis(cat.up, dev), _axis(cat.right, dev), _axis(cat.front, dev)
    nb = pipe.num_bins
    n_rows, p = tuple_idx.shape[:2]

    samples = torch.argmax(logits.reshape(n_rows, p * 6, nb) + gumbel, dim=-1)
    pred_pairs = samples.reshape(n_rows, p, 2, 3).to(points.dtype) / (nb - 1) - 0.5

    a_obs = take_rows(points, tuple_idx[..., 0])
    b_obs = take_rows(points, tuple_idx[..., 1])
    obs_len = norm(a_obs - b_obs)
    pred_len = norm(pred_pairs[:, :, 0] - pred_pairs[:, :, 1])
    cnt = count[:, None]
    pair_valid = (tuple_idx[..., 0] < cnt) & (tuple_idx[..., 1] < cnt) & (pred_len > _EPS)

    scale_mode = pipe.scale_mode or cat.scale_mode
    if scale_mode in ("head", "split"):
        nan = torch.full_like(scales, float("nan"))
        head_bound = torch.nanquantile(torch.where(pair_valid[..., None], scales, nan), 0.5, dim=1)
        factor = torch.amax(torch.abs(head_bound), dim=-1).to(points.dtype)   # (B,)
        pred_pairs_scaled = pred_pairs * factor[:, None, None, None]
        tr_pairs = pred_pairs_scaled
        if scale_mode == "split":
            up_loc = cat.up_axis_index
            f = factor[:, None]
            d = pred_pairs[:, :, 0] - pred_pairs[:, :, 1]
            dy2 = torch.square(d[..., up_loc])
            dxz2 = torch.clamp(torch.sum(d * d, dim=-1) - dy2, min=0.0)
            fxz2 = torch.clamp(torch.square(obs_len) - torch.square(f) * dy2, min=0.0)
            fxz = torch.sqrt(fxz2 / torch.clamp(dxz2, min=_EPS))
            fxz = torch.minimum(torch.maximum(fxz, 0.25 * f), 4.0 * f)
            fxz = torch.where(dxz2 > 1e-6, fxz, f)
            axis_scale = torch.where(
                torch.arange(3, device=dev) == up_loc, f[..., None], fxz[..., None]).to(points.dtype)
            tr_pairs = pred_pairs * axis_scale[:, :, None, :]
    else:
        pair_scale = obs_len / torch.clamp(pred_len, min=_EPS)
        pred_pairs_scaled = pred_pairs * pair_scale[..., None, None]
        tr_pairs = pred_pairs_scaled

    t = pair_targets(pred_pairs_scaled[:, :, 0], pred_pairs_scaled[:, :, 1], up, right, front)
    if tr_pairs is not pred_pairs_scaled:
        t = t._replace(tr=pair_targets(tr_pairs[:, :, 0], tr_pairs[:, :, 1], up, right, front).tr)
    return pred_pairs, pred_pairs_scaled, t, pair_valid


def _recon_loss_rt(points, rotation, translation, yard: BranchPose, scale_norm, up_sym: bool,
                   up_axis: int = 1) -> torch.Tensor:
    """Clipped canonical reconstruction loss of (R, T) against one branch's
    kept pairs and predictions (eval.py:358-363), per row: points (B, N, 3),
    rotation (B, 3, 3), translation (B, 3), scale_norm (B,) -> (B,)."""
    canon = (torch.bmm(points - translation[:, None, :], rotation)
             / torch.clamp(scale_norm, min=_EPS)[:, None, None])
    diff = torch.abs(take_rows(canon, yard.kept_pairs) - yard.pred_pairs_kept)
    if up_sym:
        diff = diff[..., up_axis:up_axis + 1]
    diff = torch.clamp(diff, 0.0, 0.1)
    wmask = yard.kept_mask.to(points.dtype)[..., None, None]
    dims = (1, 2, 3)
    return (torch.sum(diff * wmask, dim=dims)
            / torch.clamp(torch.sum(wmask, dim=dims) * 2 * diff.shape[-1], min=1.0))


def _recon_loss(points, pose: BranchPose, scale_norm, up_sym: bool, up_axis: int = 1):
    return _recon_loss_rt(points, pose.rotation, pose.translation, pose, scale_norm, up_sym, up_axis)


def _branch(poses: BranchPose, j: int) -> BranchPose:
    return BranchPose(*(f[:, j] for f in poses))


def _arbitrate(points, poses: BranchPose, scale_norm, up_sym: bool, arbiter: str,
               margin: float, up_axis: int = 1):
    """(pick, reported loss), each (I,), among the branch poses stacked on
    axis 1 of every field of `poses` (I instances, one column per branch);
    points (I, N, 3), scale_norm (I,). See the JAX counterpart.

    "recon": argmin of each branch's own loss, ties to the visual branch;
    "cross": argmin of each pose's mean loss over every branch's yardstick;
    "margin": the visual branch (0) wins only by at least `margin`."""
    if arbiter not in ("recon", "cross", "margin"):
        raise ValueError(f"unknown arbiter {arbiter!r} (expected 'recon', 'cross' or 'margin')")
    n_br = poses.rotation.shape[1]
    branches = [_branch(poses, j) for j in range(n_br)]
    own = torch.stack([_recon_loss(points, p, scale_norm, up_sym, up_axis) for p in branches], dim=1)
    if arbiter == "cross" and n_br > 1:
        lmat = torch.stack([
            torch.stack([_recon_loss_rt(points, pi.rotation, pi.translation, pj, scale_norm,
                                        up_sym, up_axis) for pj in branches], dim=1)
            for pi in branches], dim=1)
        score = torch.mean(lmat, dim=2)
        pick = torch.argmin(score, dim=1)
        return pick, score.gather(1, pick[:, None])[:, 0]
    if arbiter == "margin" and n_br > 1:
        pick = torch.where(own[:, 0] <= own[:, 1] - margin, 0, 1)
        return pick, own.gather(1, pick[:, None])[:, 0]
    pick = torch.argmin(own, dim=1)
    return pick, own.gather(1, pick[:, None])[:, 0]


def _branch_rows(branch_fn: BranchFn, points, point_valid, count, tuple_idx, gumbel,
                 cat: CategoryConfig, pipe: PipelineConfig, run_opt: bool) -> PoseEstimate:
    """One branch on R tuple samples of one cloud as R rows of one pass: one
    MLP forward on the stacked (R, P, k) tuples, one `_pose_from_preds` and
    each row's own reconstruction loss. Every field has a leading (R,) axis."""
    sphere_pts = _sphere(pipe.sphere_samples, points.device)
    preds = branch_fn(points, tuple_idx)
    n = tuple_idx.shape[0]
    rows = [x.expand(n, *x.shape).contiguous() for x in (points, point_valid, count)]
    pose = _pose_from_preds(preds.logits, preds.scales, *rows, tuple_idx, gumbel, cat, pipe,
                            sphere_pts, run_opt)
    scale_norm = norm(pose.scale)
    loss = _recon_loss(rows[0], pose, scale_norm, cat.up_sym, cat.up_axis_index)
    return PoseEstimate(pose.rotation, pose.translation, pose.scale, scale_norm, loss)


def estimate_pose_branch(
    branch_fn: BranchFn,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    count: torch.Tensor,
    tuple_idx: torch.Tensor,
    gumbel: torch.Tensor,
    cat: CategoryConfig,
    pipe: PipelineConfig,
    run_opt: bool = True,
) -> PoseEstimate:
    """One branch's whole vote-and-align pipeline on given tuples, with its
    own reconstruction loss (`pick` stays None: there is nothing to pick)."""
    est = _branch_rows(branch_fn, points, point_valid, count, tuple_idx[None], gumbel[None], cat,
                       pipe, run_opt)
    return PoseEstimate(*(f[0] for f in est[:5]))


def estimate_pose_branch_restarts(
    branch_fn: BranchFn,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    count: torch.Tensor,
    cat: CategoryConfig,
    pipe: PipelineConfig,
    draws: Optional[Sequence[BranchDraws]] = None,
    generator: Optional[torch.Generator] = None,
    restarts: int = 3,
    run_opt: bool = True,
) -> PoseEstimate:
    """Best of `restarts` independent passes of one branch: each pass takes
    its own tuple sample and bin samples (`draws`, one BranchDraws per
    restart, or drawn from `generator`), and the lowest clipped
    reconstruction loss wins, the first on ties (eval.py:358-372). The passes
    are the rows of one batched pass, as the JAX package vmaps them:
    `branch_fn(points, tuple_idx)` gets the (restarts, P, k) tuples at once,
    and memory grows with `restarts`."""
    if draws is None:
        draws = [draw_branch(cat, pipe, points.device, generator) for _ in range(restarts)]
    if len(draws) != restarts:
        raise ValueError(f"expected {restarts} BranchDraws, got {len(draws)}")
    tuple_idx = masked_tuple_choice(torch.stack([d.tuple_u for d in draws]), count)
    ests = _branch_rows(branch_fn, points, point_valid, count, tuple_idx,
                        torch.stack([d.gumbel for d in draws]), cat, pipe, run_opt)
    i = torch.argmin(ests.loss)
    return PoseEstimate(*(_at(f, i) for f in ests[:5]))


class GroupMember(NamedTuple):
    """A group's instances after their branch MLPs, on a leading (B,)
    instance axis (none for one instance): the enabled branches' outputs
    stacked on a branch axis after it, visual first."""

    points: torch.Tensor       # ([B,] N, 3)
    point_valid: torch.Tensor  # ([B,] N)
    count: torch.Tensor        # ([B])
    tuple_idx: torch.Tensor    # ([B,] P, tuple size), shared by the branches
    logits: torch.Tensor       # ([B,] branches, P, 6, bins)
    scales: torch.Tensor       # ([B,] branches, P, 3)
    gumbel: torch.Tensor       # ([B,] branches, P * 6, bins)


class EnsembleInput(NamedTuple):
    """A group's instances before their branch MLPs, stacked on a leading
    (B,) instance axis. `dino_fn(points, tuple_idx)` / `shot_fn` take the
    group's (B, N, 3) points and (B, P, k) tuples and return (B, P, ...)
    TuplePredictions: one forward a branch for the whole group."""

    dino_fn: Optional[BranchFn]
    shot_fn: Optional[BranchFn]
    points: torch.Tensor        # (B, N, 3)
    point_valid: torch.Tensor   # (B, N)
    count: torch.Tensor         # (B,)
    draws: Sequence[PoseDraws]  # one per restart, every field (B, ...)


def stack_draws(draws: Sequence[PoseDraws]) -> PoseDraws:
    """Per-instance PoseDraws of one restart as a group's (B, ...) draws."""
    return PoseDraws(*(torch.stack(f) for f in zip(*draws)))


def branch_outputs(dino_fn, shot_fn, points, point_valid, count, draws: PoseDraws,
                   use_visual: bool = True, use_geo: bool = True) -> GroupMember:
    """Tuple choice and the enabled branch MLPs (one shared tuple sample a
    cloud, like the reference's single `point_idxs_all`): one instance, or a
    group on a leading (B,) axis with draws of (B, ...), one forward a
    branch."""
    tuple_idx = masked_tuple_choice(draws.tuple_u, count)
    outs = []
    if use_visual:
        outs.append((dino_fn(points, tuple_idx), draws.gumbel_dino))
    if use_geo:
        outs.append((shot_fn(points, tuple_idx), draws.gumbel_shot))
    axis = points.dim() - 2
    return GroupMember(points, point_valid, count, tuple_idx,
                       torch.stack([pr.logits for pr, _ in outs], dim=axis),
                       torch.stack([pr.scales for pr, _ in outs], dim=axis),
                       torch.stack([g for _, g in outs], dim=axis))


def estimate_pose_group(members: Union[GroupMember, Sequence[GroupMember]], cat: CategoryConfig,
                        pipe: PipelineConfig, run_opt: bool = True,
                        use_visual: bool = True) -> PoseEstimate:
    """The pose graph after the MLPs for a group of instances that share a
    category and a PipelineConfig: every (instance, branch) row through one
    batched vote, noisy-pair filter, cone vote and alignment, then each
    instance's branch arbitration. The counterpart of the vmapped `one` in
    the JAX driver's `_frame_group_fn`. `members` is a group's GroupMember
    (a leading (B,) axis) or a sequence of single instances' ones. Returns a
    PoseEstimate whose every field has a leading (instances,) axis;
    `use_visual` says whether the first branch is the visual one (for
    `pick`)."""
    first = members if isinstance(members, GroupMember) else members[0]
    dev = first.points.device
    with stage("targets", dev):
        if not isinstance(members, GroupMember):
            members = GroupMember(*(torch.stack(f) for f in zip(*members)))
        n_inst, n_br = members.logits.shape[:2]
        sphere_pts = _sphere(pipe.sphere_samples, dev)
        # rows are instance-major: instance 0's branches, then instance 1's
        rows = [x.repeat_interleave(n_br, dim=0) for x in members[:4]]
        preds = [x.flatten(0, 1) for x in (*members[4:6], members.gumbel)]
    poses = _pose_from_preds(*preds[:2], *rows, preds[2], cat, pipe, sphere_pts, run_opt)

    with stage("finish", dev):
        poses = BranchPose(*(f.reshape(n_inst, n_br, *f.shape[1:]) for f in poses))
        scale = poses.scale[:, 0]
        scale_norm = norm(scale)
        pick, loss = _arbitrate(members.points, poses, scale_norm, cat.up_sym, pipe.arbiter,
                                pipe.arbiter_margin, cat.up_axis_index)
        branch_id = pick if use_visual else pick + 1
        which = torch.arange(n_inst, device=dev)
        return PoseEstimate(poses.rotation[which, pick], poses.translation[which, pick], scale,
                            scale_norm, loss, branch_id.to(torch.int32))


def estimate_pose_ensembles(group: EnsembleInput, cat: CategoryConfig, pipe: PipelineConfig,
                            run_opt: bool = True, use_visual: bool = True,
                            use_geo: bool = True) -> PoseEstimate:
    """`estimate_pose_ensemble` for a group of instances at once: each
    restart runs the tuple choice and one forward of each enabled branch MLP
    for the whole group (`branch_outputs`), then one `estimate_pose_group`
    call; restarts run one after another (lax.map in the JAX package) and
    each instance keeps its lowest reported loss, the first on ties. Every
    field has a leading (instances,) axis."""
    if not (use_visual or use_geo):
        raise ValueError("at least one branch must be enabled")
    n_runs = pipe.restarts
    if len(group.draws) != n_runs:
        raise ValueError(f"expected {n_runs} PoseDraws (pipe.restarts), got {len(group.draws)}")
    single = dataclasses.replace(pipe, restarts=1)
    dev = group.points.device
    ests = []
    for d in group.draws:
        with stage("mlps", dev):
            member = branch_outputs(group.dino_fn, group.shot_fn, group.points, group.point_valid,
                                    group.count, d, use_visual, use_geo)
        ests.append(estimate_pose_group(member, cat, single, run_opt, use_visual))
    if n_runs == 1:
        return ests[0]
    with stage("finish", dev):
        i = torch.argmin(torch.stack([e.loss for e in ests]), dim=0)
        which = torch.arange(group.points.shape[0], device=i.device)
        return PoseEstimate(*(torch.stack([getattr(e, f) for e in ests])[i, which]
                              for f in PoseEstimate._fields))


def _group_of_one(fn: Optional[BranchFn]) -> Optional[BranchFn]:
    """A single instance's branch function as a group's of one instance."""
    if fn is None:
        return None
    return lambda pts, ti: TuplePredictions(*(x[None] for x in fn(pts[0], ti[0])))


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
    lowest reported loss wins (first on ties). A group of one instance for
    `estimate_pose_ensembles`: both branches are the two rows of one
    `estimate_pose_group` call.
    """
    if not (use_visual or use_geo):
        raise ValueError("at least one branch must be enabled")
    if draws is None:
        draws = [draw_pose(cat, pipe, points.device, generator) for _ in range(pipe.restarts)]
    elif isinstance(draws, PoseDraws):
        draws = [draws]
    est = estimate_pose_ensembles(
        EnsembleInput(_group_of_one(dino_fn), _group_of_one(shot_fn), points[None],
                      point_valid[None], count[None], [stack_draws([d]) for d in draws]),
        cat, pipe, run_opt, use_visual, use_geo)
    return PoseEstimate(*(f[0] for f in est))
