"""Exact oriented 3D bounding-box IoU under the NOCS protocol.

The port's own copy of `cppf2_tpu/eval/iou3d.py` (reference utils/box.py,
utils/iou.py via Sutherland-Hodgman clipping, utils/util.py:475-547
symmetric-class handling): each box's faces are clipped against the other
box's slabs and the IoU is the convex-hull volume of the intersection
points. `pairwise_iou_matrix` runs the repo's native core
(`native/iou3d.cpp`, through `cppf2_torch.native`) where it builds, as the
JAX function does, and the Python path otherwise; `LAST_ROUTE` names the
route of the last call ("native" or "python").
"""

from __future__ import annotations

import math

import numpy as np

_EPS_PLANE = 1e-6

LAST_ROUTE = None   # "native" or "python": the route of the last pairwise_iou_matrix

# Quad faces of a unit box with corners indexed by (x sign, y sign, z sign) in
# binary order 0..7: index = 4*sx + 2*sy + sz with s in {0 (-), 1 (+)}.
_FACES = np.array(
    [
        [4, 5, 7, 6],  # +x
        [0, 2, 3, 1],  # -x
        [2, 6, 7, 3],  # +y
        [0, 1, 5, 4],  # -y
        [1, 3, 7, 5],  # +z
        [0, 4, 6, 2],  # -z
    ],
    np.int32,
)

_CORNER_SIGNS = np.array(
    [[2 * ((i >> 2) & 1) - 1, 2 * ((i >> 1) & 1) - 1, 2 * (i & 1) - 1] for i in range(8)],
    np.float64,
)


class Box:
    """Oriented box: rotation (3,3), translation (3,), scale (3,) extents."""

    def __init__(self, rotation, translation, scale):
        self.rotation = np.asarray(rotation, np.float64)
        self.translation = np.asarray(translation, np.float64).reshape(3)
        self.scale = np.asarray(scale, np.float64).reshape(3)

    @classmethod
    def from_transformation(cls, rotation, translation, scale):
        return cls(rotation, translation, scale)

    @property
    def corners(self) -> np.ndarray:
        local = _CORNER_SIGNS * (self.scale / 2.0)
        return local @ self.rotation.T + self.translation

    @property
    def vertices(self) -> np.ndarray:
        """9-keypoint form: center + 8 corners (utils/box.py:24-36 layout)."""
        return np.vstack([self.translation, self.corners])

    @property
    def volume(self) -> float:
        return float(abs(np.prod(self.scale) * np.linalg.det(self.rotation)))

    @classmethod
    def fit(cls, vertices: np.ndarray) -> "Box":
        """(R, t, s) from 9 keypoints (center + 8 corners): the mean length
        of each axis's four edges, then least squares (utils/box.py:117-149)."""
        v = np.asarray(vertices, np.float64)
        if v.shape != (9, 3):
            raise ValueError(f"Box.fit takes (9, 3) keypoints, got {v.shape}")
        corners = v[1:]
        scale = np.zeros(3)
        for axis, bit in ((0, 4), (1, 2), (2, 1)):
            lengths = [np.linalg.norm(corners[i | bit] - corners[i]) for i in range(8) if not i & bit]
            scale[axis] = sum(lengths) / len(lengths)
        local = np.vstack([[0.0, 0.0, 0.0], _CORNER_SIGNS * (scale / 2.0)])
        system = np.concatenate([local, np.ones((9, 1))], axis=1)
        solution, *_ = np.linalg.lstsq(system, v, rcond=None)
        return cls(solution[:3].T, solution[3], scale)


def _clip_poly_axis(poly: np.ndarray, axis: int, bound: float, sign: float) -> np.ndarray:
    """Sutherland-Hodgman clip of a 3D polygon against plane sign*(x[axis]-bound) >= 0."""
    if len(poly) == 0:
        return poly
    d = sign * (poly[:, axis] - bound)
    keep_in = d >= -_EPS_PLANE
    out = []
    n = len(poly)
    for i in range(n):
        j = (i + 1) % n
        if keep_in[i]:
            out.append(poly[i])
        if keep_in[i] != keep_in[j]:
            t = d[i] / (d[i] - d[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 3))


def _intersection_points_one_way(box_a: Box, box_b: Box) -> list:
    """Points of box_b's faces clipped inside box_a, in world coordinates."""
    inv_rot = box_a.rotation.T
    half = box_a.scale / 2.0
    corners_b_local = (box_b.corners - box_a.translation) @ inv_rot.T
    pts = []
    for face in _FACES:
        poly = corners_b_local[face].astype(np.float64)
        for axis in range(3):
            poly = _clip_poly_axis(poly, axis, -half[axis], +1.0)
            poly = _clip_poly_axis(poly, axis, +half[axis], -1.0)
            if len(poly) == 0:
                break
        for p in poly:
            pts.append(p @ inv_rot + box_a.translation)
    inside = np.all(np.abs(corners_b_local) <= half + _EPS_PLANE, axis=1)
    for p in corners_b_local[inside]:
        pts.append(p @ inv_rot + box_a.translation)
    return pts


def oriented_iou(box1: Box, box2: Box) -> float:
    """Exact IoU of two oriented boxes (utils/iou.py:23-36)."""
    pts = _intersection_points_one_way(box1, box2) + _intersection_points_one_way(box2, box1)
    if len(pts) < 4:
        return 0.0
    try:
        from scipy.spatial import ConvexHull

        inter = ConvexHull(np.asarray(pts), qhull_options="QJ").volume
    except Exception:
        return 0.0
    union = box1.volume + box2.volume - inter
    if union <= 0:
        return 0.0
    return float(min(inter / union, 1.0))


def iou_sampling(box1: Box, box2: Box, num_samples: int = 10000, seed: int = 0) -> float:
    """Monte-Carlo IoU estimate (utils/iou.py:38-69 `iou_sampling`): uniform
    samples of each box (numpy `default_rng(seed)`, box 1's first) tested
    against the other box."""
    rng = np.random.default_rng(seed)

    def inside(box, pts):
        local = (pts - box.translation) @ box.rotation
        return np.all(np.abs(local) <= box.scale / 2 + 1e-9, axis=1)

    def sample(box):
        local = rng.uniform(-0.5, 0.5, size=(num_samples, 3)) * box.scale
        return local @ box.rotation.T + box.translation

    v1, v2 = box1.volume, box2.volume
    inter = (v1 * inside(box2, sample(box1)).mean() + v2 * inside(box1, sample(box2)).mean()) / 2.0
    union = v1 + v2 - inter
    return float(inter / union) if union > 0 else 0.0


def iou_with_symmetry(rt1, rt2, scales1, scales2, handle_visibility: int, class_name_1: str,
                      class_name_2: str) -> float:
    """NOCS-protocol IoU with the 36-rotation max for symmetric classes
    (utils/util.py:475-547 `compute_3d_iou_new`)."""
    if rt1 is None or rt2 is None:
        return -1.0

    def norm_rt(rt):
        rt = np.array(rt, np.float64)
        det = np.linalg.det(rt[:3, :3])
        rt[:3, :3] = rt[:3, :3] / np.cbrt(det)
        return rt

    def plain_iou(rt_a, rt_b):
        try:
            a = norm_rt(rt_a)
            b = norm_rt(rt_b)
            return oriented_iou(Box(a[:3, :3], a[:3, 3], scales1), Box(b[:3, :3], b[:3, 3], scales2))
        except Exception:
            return 0.0

    symmetric = (
        class_name_1 in ("bottle", "bowl", "can") and class_name_1 == class_name_2
    ) or (class_name_1 == "mug" and class_name_2 == "mug" and handle_visibility == 0)
    if not symmetric:
        return plain_iou(rt1, rt2)

    best = 0.0
    for i in range(36):
        theta = 2 * math.pi * i / 36.0
        c, s = math.cos(theta), math.sin(theta)
        ry = np.eye(4)
        ry[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        best = max(best, plain_iou(np.asarray(rt1, np.float64) @ ry, rt2))
    return best


def _native_norm(rts, scales):
    """Rotation blocks divided by det^(1/3), float64 and contiguous. A
    degenerate block (det about 0 or not finite) is parked on an identity
    with zero scales, so the native core returns a finite zero overlap where
    the Python path's try/except returns 0."""
    rts = np.ascontiguousarray(rts, np.float64).copy()
    scales = np.ascontiguousarray(scales, np.float64).copy()
    det = np.linalg.det(rts[:, :3, :3])
    bad = ~np.isfinite(det) | (np.abs(det) < 1e-12)
    det = np.where(bad, 1.0, det)
    rts[:, :3, :3] = np.where(bad[:, None, None], np.eye(3), rts[:, :3, :3])
    scales = np.ascontiguousarray(np.where(bad[:, None], 0.0, scales))
    rts[:, :3, :3] /= np.cbrt(det)[:, None, None]
    return rts, scales


def _pairwise_native(lib, pred_rts, pred_scales, gt_rts, gt_scales, gt_handle_visibility,
                     class_name: str) -> np.ndarray:
    n_p, n_g = len(pred_rts), len(gt_rts)
    out = np.zeros((n_p, n_g))
    p_rts, p_s = _native_norm(pred_rts, pred_scales)
    g_rts, g_s = _native_norm(gt_rts, gt_scales)
    vis = np.asarray(gt_handle_visibility)
    if class_name == "mug":
        groups = [(vis == 0, 1), (vis != 0, 0)]
    else:
        groups = [(np.ones(n_g, bool), 1 if class_name in ("bottle", "bowl", "can") else 0)]
    for sel, sym in groups:
        if not sel.any():
            continue
        sub_g = np.ascontiguousarray(g_rts[sel])
        sub_s = np.ascontiguousarray(g_s[sel])
        buf = np.zeros((n_p, int(sel.sum())))
        lib.batch_iou_sym(p_rts.ctypes.data, p_s.ctypes.data, n_p, sub_g.ctypes.data,
                          sub_s.ctypes.data, int(sel.sum()), int(sym), buf.ctypes.data)
        out[:, sel] = buf
    return out


def pairwise_iou_matrix(pred_rts, pred_scales, gt_rts, gt_scales, gt_handle_visibility,
                        class_name: str) -> np.ndarray:
    """All-pairs (P, G) IoU with NOCS symmetry handling: the native core
    when the library loads, else the Python path (`LAST_ROUTE` says which
    ran)."""
    global LAST_ROUTE
    from cppf2_torch.native import load

    n_p, n_g = len(pred_rts), len(gt_rts)
    out = np.zeros((n_p, n_g))
    if n_p == 0 or n_g == 0:
        return out
    lib = load()
    if lib is not None:
        LAST_ROUTE = "native"
        return _pairwise_native(lib, pred_rts, pred_scales, gt_rts, gt_scales,
                                gt_handle_visibility, class_name)
    LAST_ROUTE = "python"
    for i in range(n_p):
        for j in range(n_g):
            out[i, j] = iou_with_symmetry(
                pred_rts[i], gt_rts[j], pred_scales[i], gt_scales[j],
                gt_handle_visibility[j], class_name, class_name,
            )
    return out
