"""Core geometry: backprojection, the fibonacci sphere, quaternion rotations,
axis rotations, symmetry canonicalization, and the host box and projection
helpers of the pose overlay.

Counterpart of `cppf2_tpu/core/geometry.py` (reference: utils/util.py:66-81,
191-208, 858-921, 2586-2607; dataset.py:84-101; eval.py:320-355).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.device import device_constant


def backproject_masked(depth: torch.Tensor, intrinsics: torch.Tensor, mask: torch.Tensor):
    """Dense pinhole backprojection of a masked depth map, fixed shape.

    Args:
        depth: (H, W) float32 meters.
        intrinsics: (3, 3) pinhole K.
        mask: (H, W) bool instance mask.
    Returns:
        points (H*W, 3) float32 with zeros where invalid, pixel_yx (H*W, 2)
        int32 (row, col), valid (H*W,) bool. x and y are negated (the
        reference's OpenGL convention, utils/util.py:2604-2605).

    A leading (B,) axis on depth, intrinsics and mask (each window with its
    own K) gives B rows, each the single call's result to the bit.
    """
    h, w = depth.shape[-2:]
    lead = depth.shape[:-2]
    dev = depth.device
    vv, uu = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    valid = (depth > 0) & mask
    k_inv = pinhole_inverse(intrinsics)
    u = uu.to(depth.dtype)
    v = vv.to(depth.dtype)
    # uv1 @ k_inv.T, written out per component (no matmul precision question)
    rays = torch.stack(
        [u * k_inv[..., r, 0, None, None] + v * k_inv[..., r, 1, None, None]
         + k_inv[..., r, 2, None, None] for r in range(3)], dim=-1)
    pts = rays * (depth / rays[..., 2])[..., None]
    flip = device_constant(("flip_xy", depth.dtype),
                           lambda: torch.tensor([-1.0, -1.0, 1.0], dtype=depth.dtype), dev)
    pts = pts * flip
    pts = torch.where(valid[..., None], pts, torch.zeros((), dtype=depth.dtype, device=dev))
    pixel_yx = torch.stack([vv, uu], dim=-1).to(torch.int32).reshape(-1, 2)
    return (pts.reshape(*lead, h * w, 3), pixel_yx.expand(*lead, h * w, 2),
            valid.reshape(*lead, h * w))


def check_pinhole(k: np.ndarray) -> None:
    """Raise unless the host (3, 3) intrinsics are upper triangular."""
    if k[1, 0] != 0 or k[2, 0] != 0 or k[2, 1] != 0:
        raise ValueError("intrinsics must be upper triangular (a pinhole K)")


def pinhole_inverse(k: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular pinhole K by back substitution with
    reciprocal pivots, the order XLA's LU-based inverse takes, so the rays
    (and the voxel keys built from them) agree to the bit. A leading (B,)
    axis inverts each K alone."""
    # checked where it costs no read back from the device: the drivers check
    # the host array (`check_pinhole`) before they upload it
    if k.device.type == "cpu":
        for m in k.reshape(-1, 3, 3).numpy():
            check_pinhole(m)
    eye = torch.eye(3, dtype=k.dtype, device=k.device).expand(*k.shape[:-2], 3, 3)
    rows = [None, None, None]
    for i in (2, 1, 0):
        acc = eye[..., i, :]
        for j in range(i + 1, 3):
            acc = acc - k[..., i, j, None] * rows[j]
        rows[i] = acc * (1.0 / k[..., i, i, None])
    return torch.stack(rows, dim=-2)


def fibonacci_sphere(samples: int) -> np.ndarray:
    """Evenly spread unit directions on the golden-angle spiral, (S, 3) float32."""
    i = np.arange(samples, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - (i / (samples - 1)) * 2.0
    radius = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    theta = phi * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], axis=-1).astype(np.float32)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) from (x, y, z, w) quaternions (..., 4),
    each normalized inside.

    Differentiable: the alignment optimizer takes its gradient."""
    q = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + 1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion of a rotation matrix, branchless Shepperd: all
    four pivot constructions are formed and the largest diagonal pivot picks
    one (the first on a tie), so a 180-degree flip, where w = 0 and the
    antisymmetric part vanishes, keeps its axis's signs."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    pivots_sq = torch.stack([1 + tr,
                             1 + m[0, 0] - m[1, 1] - m[2, 2],
                             1 - m[0, 0] + m[1, 1] - m[2, 2],
                             1 - m[0, 0] - m[1, 1] + m[2, 2]])
    s = torch.sqrt(torch.clamp(pivots_sq, min=1e-12))   # 2 |pivot|
    d = 1.0 / (2.0 * s)
    ax, ay, az = m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]
    sxy, sxz, syz = m[0, 1] + m[1, 0], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1]
    cands = torch.stack([                    # rows: pivot w, x, y, z
        torch.stack([ax * d[0], ay * d[0], az * d[0], s[0] / 2]),
        torch.stack([s[1] / 2, sxy * d[1], sxz * d[1], ax * d[1]]),
        torch.stack([sxy * d[2], s[2] / 2, syz * d[2], ay * d[2]]),
        torch.stack([sxz * d[3], syz * d[3], s[3] / 2, az * d[3]]),
    ])
    q = cands[torch.argmax(pivots_sq)]
    return q / (norm(q) + 1e-12)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues), with the Taylor forms of
    sin(t)/t and (1 - cos(t))/t^2 below t = 1e-6; K @ K is formed
    elementwise as omega omega^T - t^2 I."""
    theta = norm(omega)
    theta_sq = theta * theta
    small = theta < 1e-6
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1 - torch.cos(theta)) / torch.where(small, one, theta_sq))
    wx, wy, wz = omega[0], omega[1], omega[2]
    zero = torch.zeros_like(wx)
    k = torch.stack([torch.stack([zero, -wz, wy]), torch.stack([wz, zero, -wx]),
                     torch.stack([-wy, wx, zero])])
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    ksq = omega[:, None] * omega[None, :] - theta_sq * eye
    return eye + a * k + b * ksq


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm as sqrt(sum(x * x)), the formula XLA lowers `norm` to."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


# ---------------------------------------------------------------------------
# Rotations and symmetry canonicalization (reference: dataset.py:84-101,
# utils/util.py:66-81)
# ---------------------------------------------------------------------------

def _cos_sin(a):
    """cos and sin of an angle in float32, as Python floats."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return float(torch.cos(a)), float(torch.sin(a))


def rotx(a) -> torch.Tensor:
    """4x4 float32 rotation about x (reference: dataset.py:97-101)."""
    c, s = _cos_sin(a)
    return torch.tensor([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=torch.float32)


def roty(a) -> torch.Tensor:
    """4x4 float32 rotation about y (reference: dataset.py:91-95)."""
    c, s = _cos_sin(a)
    return torch.tensor([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=torch.float32)


def rotz(a) -> torch.Tensor:
    """4x4 float32 rotation about z (reference: dataset.py:84-88)."""
    c, s = _cos_sin(a)
    return torch.tensor([[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32)


def map_sym(rot: torch.Tensor, axis: int) -> torch.Tensor:
    """Canonicalize a (3, 3) rotation for continuous symmetry about `axis`:
    the in-plane rotation S about `axis` minimizing ||S @ rot - I|| in the
    plane orthogonal to it, applied (S @ rot)."""
    o0, o1 = (i for i in range(3) if i != axis)
    alpha = torch.atan2(rot[o1, o0] - rot[o0, o1], rot[o0, o0] + rot[o1, o1])
    c, s = torch.cos(alpha), torch.sin(alpha)
    sym = torch.eye(3, dtype=rot.dtype, device=rot.device)
    sym[o0, o0] = c
    sym[o0, o1] = s
    sym[o1, o0] = -s
    sym[o1, o1] = c
    return sym @ rot


def map_sym_discrete(rot: torch.Tensor, sym_rots: torch.Tensor) -> torch.Tensor:
    """Snap a (3, 3) rotation to the nearest member of a discrete symmetry
    group `sym_rots` (S, 3, 3): sym^T @ rot for the sym with the smallest
    Frobenius distance of sym^T @ rot to I (the first on ties)."""
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    diff = sym_rots.transpose(-1, -2) @ rot - eye
    idx = torch.argmin(torch.sqrt(torch.sum(diff * diff, dim=(-2, -1))))
    # index_select, not sym_rots[idx]: a 0-d tensor index is a read back on CUDA
    return torch.index_select(sym_rots, 0, idx.reshape(1))[0].transpose(-1, -2) @ rot


# ---------------------------------------------------------------------------
# Box / projection helpers of the overlay (reference: utils/util.py:858-921),
# host numpy in float64 as in the JAX package
# ---------------------------------------------------------------------------

def get_3d_bbox(scale, shift=0.0) -> np.ndarray:
    """The 8 corners (3, 8) of an axis-aligned box of size `scale` (a scalar
    or 3 sides) centred at `shift`."""
    s = np.asarray(scale, dtype=np.float64)
    if s.ndim == 0:
        s = np.array([s, s, s])
    sx, sy, sz = s / 2.0
    corners = np.array([
        [sx, sy, sz], [sx, sy, -sz], [-sx, sy, sz], [-sx, sy, -sz],
        [sx, -sy, sz], [sx, -sy, -sz], [-sx, -sy, sz], [-sx, -sy, -sz],
    ]) + shift
    return corners.T


def transform_coordinates_3d(coords: np.ndarray, rt: np.ndarray) -> np.ndarray:
    """A 4x4 homogeneous transform applied to (3, N) coordinates."""
    hom = np.vstack([coords, np.ones((1, coords.shape[1]))])
    out = rt @ hom
    return out[:3] / out[3:4]


def calculate_2d_projections(coords3d: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """(3, N) camera coordinates projected to (N, 2) int32 pixels (x, y),
    truncated toward zero."""
    proj = intrinsics @ coords3d
    proj = proj[:2] / proj[2:3]
    return proj.T.astype(np.int32)
