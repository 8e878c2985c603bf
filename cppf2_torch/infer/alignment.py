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

`align_pose` runs the plain autograd loop (`align_pose_plain`) on CPU
tensors and, on CUDA float32 tensors, the whole loop as one launch of the
hand-written kernel `csrc/align.cu`: one thread-block cluster a row, the
row's kept pairs held in shared memory for all steps, the gradient by hand
(`_align_grads_plain` is its plain twin). The kernel replaces no Pallas
kernel: the JAX package leaves this loop to XLA's `lax.fori_loop`. It is
bound neither by bytes (about 340 KB a row at 5,000 kept pairs, read once)
nor by operations (about 45 MFLOP a row for 100 steps), but by the chain of
`steps` dependent cluster-wide reductions.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cppf2_torch.core.geometry import norm, quat_to_matrix
from cppf2_torch.device import device_constant
from cppf2_torch.ops import _build
from cppf2_torch.ops.voting import _one_row, take_rows

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8
# yaw_sweep: +-10 deg micro sweep in 41 steps, a 10-degree full-circle ring
# that must win by 25%, and the feature-mass gate
_YAW_SPAN_DEG, _YAW_NUM, _YAW_MIN_MASS, _YAW_RING_STEP_DEG, _YAW_RING_MARGIN = (
    10.0, 41, 0.005, 10.0, 0.25)

SOURCE = "cppf2_torch/csrc/align.cu"
REPLACES = None   # no Pallas kernel: the JAX package's loop is XLA's lax.fori_loop


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
    (B, 3), refined together in one loop: the plain loop on the CPU, one
    kernel launch on the card (float32, with int32 or int64 indices)."""
    if points.dim() == 2:
        return _one_row(align_pose, points, pair_idx, pair_weight, pred_pairs_scaled, rotation,
                        translation, up_sym, up_axis, steps, lr)
    if points.device.type == "cpu":
        return align_pose_plain(points, pair_idx, pair_weight, pred_pairs_scaled, rotation,
                                translation, up_sym, up_axis, steps, lr)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    return _align_kernel(points, pair_idx, pair_weight, pred_pairs_scaled, rotation, translation,
                         up_sym, up_axis, steps, lr)


def cluster_plan(rows: int, n_pairs: int, sms: int) -> Tuple[int, int, bool]:
    """(blocks a row, points a block, staged) of the kernel's launch for
    `rows` rows of `n_pairs` kept pairs on a card of `sms` SMs, as
    `csrc/align.cu` plans it (needs the built kernel)."""
    fn = _build.function("align", "cppf2_align_plan", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 3)()
    _build.check(fn(rows, n_pairs, sms, ctypes.cast(out, ctypes.c_void_p)), "cluster_plan")
    return out[0], out[1], bool(out[2])


def _check_kernel_inputs(points, pair_idx, pair_weight, pred_pairs_scaled, rotation, translation):
    b, n = points.shape[:2]
    k = pair_idx.shape[1] if pair_idx.dim() == 3 else -1
    for name, x, shape in (("points", points, (b, n, 3)), ("pair_weight", pair_weight, (b, k)),
                           ("pred_pairs_scaled", pred_pairs_scaled, (b, k, 2, 3)),
                           ("rotation", rotation, (b, 3, 3)), ("translation", translation, (b, 3))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"align_pose's kernel takes {name} {shape} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if pair_idx.dtype not in (torch.int32, torch.int64) or tuple(pair_idx.shape) != (b, k, 2):
        raise ValueError(f"align_pose's kernel takes pair_idx (B, K, 2) int32 or int64, got "
                         f"{tuple(pair_idx.shape)} {pair_idx.dtype}")
    devs = {x.device for x in (points, pair_idx, pair_weight, pred_pairs_scaled, rotation,
                               translation)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if b < 1 or n < 1 or k >= 2 ** 30:
        raise ValueError(f"align_pose's kernel takes 1 or more rows of 1 or more points and "
                         f"fewer than 2^30 pairs, got {b}, {n}, {k}")


def _align_kernel(points, pair_idx, pair_weight, pred_pairs_scaled, rotation, translation, up_sym,
                  up_axis, steps, lr) -> AlignResult:
    """One launch of `csrc/align.cu` for all rows on `points`' device."""
    _check_kernel_inputs(points, pair_idx, pair_weight, pred_pairs_scaled, rotation, translation)
    if not 0 <= int(up_axis) <= 2 or int(steps) < 0:
        raise ValueError(f"up_axis {up_axis}, steps {steps}")
    dev = points.device
    b, n = points.shape[:2]
    k = pair_idx.shape[1]
    ins = [x.contiguous() for x in (points, pair_idx.long(), pair_weight, pred_pairs_scaled,
                                    rotation, translation)]
    rot = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((b, 3), dtype=torch.float32, device=dev)
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    p, pi, pw, pp, r0, t0 = (x.data_ptr() for x in ins)
    _build.launch("align", "cppf2_align_pose",
                  [ptr, i32] + [ptr] * 5 + [i32] * 3 + [ctypes.c_float, i32, i32] + [ptr] * 4,
                  dev, p, n, pi, pw, pp, r0, t0, b, k, int(steps), float(lr), int(bool(up_sym)),
                  int(up_axis), rot.data_ptr(), trans.data_ptr(), loss.data_ptr())
    return AlignResult(rot, trans, loss)


def _quat_to_matrix_vjp(quat: torch.Tensor, g_mat: torch.Tensor) -> torch.Tensor:
    """dL/dq (..., 4) from dL/dQ (..., 3, 3) for Q = quat_to_matrix(q): first
    to the normalised quaternion u = q / (|q| + 1e-12), then through it."""
    rad = torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True))
    nrm = rad + 1e-12
    x, y, z, w = (quat / nrm).unbind(-1)
    g = g_mat.reshape(*g_mat.shape[:-2], 9).unbind(-1)
    gu = torch.stack([
        2 * y * (g[1] + g[3]) + 2 * z * (g[2] + g[6]) - 4 * x * (g[4] + g[8]) + 2 * w * (g[7] - g[5]),
        2 * x * (g[1] + g[3]) + 2 * z * (g[5] + g[7]) - 4 * y * (g[0] + g[8]) + 2 * w * (g[2] - g[6]),
        2 * x * (g[2] + g[6]) + 2 * y * (g[5] + g[7]) - 4 * z * (g[0] + g[4]) + 2 * w * (g[3] - g[1]),
        2 * z * (g[3] - g[1]) + 2 * y * (g[2] - g[6]) + 2 * x * (g[7] - g[5])], dim=-1)
    dot = torch.sum(gu * quat, dim=-1, keepdim=True)
    return gu / nrm - quat * dot / (nrm * nrm * rad)


def _align_grads_plain(pair_pts, pred_pairs_scaled, pair_weight, rotation, trans, quat,
                       up_sym: bool, up_axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's gradient of each row's loss at (trans, quat), in plain
    PyTorch: (dL/dtrans (B, 3), dL/dquat (B, 4)), before the pi/180 scale.

    With G = sign(canon - pred) w / divisor for each of a row's 2K points
    (only the `up_axis` column under `up_sym`), the 12 sums M = sum (p - t)
    (x) G and S = sum G give dL/dR' = M, dL/dt = -R' S and dL/dQ = M R0^T,
    and dL/dq follows through `quat_to_matrix`'s normalisation."""
    b = pair_pts.shape[0]
    w = (pair_weight > 0).to(pair_pts.dtype)
    divisor = torch.clamp(torch.sum(w, dim=-1), min=1.0) * (2.0 if up_sym else 6.0)
    rot = quat_to_matrix(quat) @ rotation
    d = pair_pts.reshape(b, -1, 3) - trans[:, None, :]
    canon = torch.bmm(d, rot)
    mask = torch.ones(3, dtype=d.dtype, device=d.device)
    if up_sym:
        mask = torch.nn.functional.one_hot(torch.tensor(up_axis), 3).to(d)
    sign_w = (torch.sign(canon - pred_pairs_scaled.reshape(b, -1, 3))
              * w.repeat_interleave(2, dim=1)[..., None] * mask)
    m = torch.einsum("bna,bnc->bac", d, sign_w) / divisor[:, None, None]
    s = torch.sum(sign_w, dim=1) / divisor[:, None]
    g_trans = -torch.einsum("bac,bc->ba", rot, s)
    g_quat = _quat_to_matrix_vjp(quat, m @ rotation.transpose(1, 2))
    return g_trans, g_quat


def align_pose_plain(
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
    """The plain autograd loop of `align_pose`, on any device."""
    if points.dim() == 2:
        return _one_row(align_pose_plain, points, pair_idx, pair_weight, pred_pairs_scaled,
                        rotation, translation, up_sym, up_axis, steps, lr)
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


def _synthetic_rows(rng: np.random.Generator, b: int, k: int, outliers: float = 0.3,
                    deg: float = 8.0, mm: float = 15.0, pad: float = 0.1, offset: float = 0.0):
    """`b` alignment rows of `k` kept pairs on the CPU, as the card test and
    `chip_smoke.py` pose them: points on a 10 cm object about 0.8 m away,
    predictions its canonical coordinates quantised to 3 mm with a share of
    `outliers`, a share `pad` of the pairs padded (weight 0), and a start
    pose off by `deg` degrees and `mm` mm. An `offset` of 10 m moves every
    prediction so far that no residual changes sign in 100 steps: a loss
    without kinks on the path. Returns align_pose's first six arguments."""
    def axis_angle(angle):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx

    n = 2048
    rows = []
    for _ in range(b):
        canon = rng.uniform(-0.05, 0.05, size=(n, 3)).astype(np.float32)
        r_true = axis_angle(rng.uniform(0, np.pi))
        t_true = np.array([0.05, -0.02, 0.8]) + rng.uniform(-0.1, 0.1, size=3)
        pts = (canon @ r_true.T + t_true).astype(np.float32)
        pair_idx = rng.integers(0, n, size=(k, 2))
        pred = np.round(canon[pair_idx] / 0.003) * 0.003
        bad = rng.uniform(size=k) < outliers
        pred[bad] += rng.uniform(-0.05, 0.05, size=(int(bad.sum()), 2, 3))
        pred += offset
        w = rng.uniform(0.2, 1.0, size=k)
        w[rng.uniform(size=k) < pad] = 0.0
        r0 = axis_angle(np.radians(deg)) @ r_true
        shift = rng.normal(size=3)
        t0 = t_true + shift / np.linalg.norm(shift) * mm * 1e-3
        rows.append((pts, pair_idx, w, pred, r0, t0))
    out = [torch.from_numpy(np.stack(x)) for x in zip(*rows)]
    return [x.long() if i == 1 else x.float() for i, x in enumerate(out)]


def _pose_gaps(a: AlignResult, b: AlignResult) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's (degrees, mm) between two results, in float64 on the CPU:
    the angle from |A - B|_F = 2 sqrt(2) sin(angle / 2), which float32
    rounding of equal rotations does not inflate as arccos of the trace does."""
    gap = torch.linalg.norm(a.rotation.double().cpu() - b.rotation.double().cpu(), dim=(-2, -1))
    deg = torch.rad2deg(2 * torch.arcsin(torch.clamp(gap / 8 ** 0.5, max=1)))
    return deg, 1e3 * torch.linalg.norm(a.translation.double().cpu() - b.translation.double().cpu(),
                                        dim=-1)


def _row_losses64(args, res: AlignResult, up_sym: bool, up_axis: int = 1) -> torch.Tensor:
    """Each row's loss at the pose `res`, in float64 on the CPU, for
    align_pose's arguments `args` (points, pair_idx, pair_weight, pred)."""
    pts, idx, w, pred = (x.cpu() for x in args[:4])
    pair_pts = take_rows(pts.double(), idx).reshape(pts.shape[0], -1, 3)
    canon = torch.bmm(pair_pts - res.translation.double().cpu()[:, None],
                      res.rotation.double().cpu())
    w = (w > 0).double()
    diff = torch.abs(canon - pred.double().reshape(canon.shape)) * w.repeat_interleave(2, 1)[..., None]
    denom = torch.clamp(w.sum(1), min=1.0)
    if up_sym:
        return diff[..., up_axis].sum(1) / (denom * 2)
    return diff.sum((1, 2)) / (denom * 6)


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
