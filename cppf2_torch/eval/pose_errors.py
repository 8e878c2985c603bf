"""Symmetry-aware pose errors (degrees, centimeters), the RT assembly of a
pose estimate and of a frame's ground truth, and their fetch in one copy.

The port's own copy of `cppf2_tpu/eval/pose_errors.py` (numpy; reference
utils/util.py:588-663): rotations are
scale-normalized by det^(1/3); the rotation error is the y-axis angle for
continuously symmetric classes (bottle/can/bowl, and handle-occluded mug),
the minimum over a 180° flip for phone/eggbox/glue, and the trace formula
otherwise; the translation error is in cm.
"""

from __future__ import annotations

import numpy as np

_Y_SYM = ("bottle", "can", "bowl")
_Y_SYM_OCCLUDED = ("mug", "chair", "bathtub", "bookshelf", "bed", "sofa", "table")
_FLIP_SYM = ("phone", "eggbox", "glue")


def pose_error_degree_cm(rt1, rt2, class_name: str, handle_visibility: int = 1) -> np.ndarray:
    """np.array([theta_degrees, shift_cm]); [-1, -1] if either RT is None
    (a [-1, -1] row passes every threshold, so the drivers pre-fill pred_RTs
    with eye(4) and none reaches the match grid)."""
    if rt1 is None or rt2 is None:
        return np.array([-1.0, -1.0])

    rt1 = np.asarray(rt1, np.float64)
    rt2 = np.asarray(rt2, np.float64)
    t1, t2 = rt1[:3, 3], rt2[:3, 3]
    d1 = np.linalg.det(rt1[:3, :3])
    d2 = np.linalg.det(rt2[:3, :3])
    if not (np.isfinite(d1) and np.isfinite(d2)) or min(abs(d1), abs(d2)) < 1e-12:
        return np.array([180.0, np.linalg.norm(t1 - t2) * 100.0])
    r1 = rt1[:3, :3] / np.cbrt(d1)
    r2 = rt2[:3, :3] / np.cbrt(d2)

    if class_name in _Y_SYM or (class_name in _Y_SYM_OCCLUDED and handle_visibility == 0):
        y = np.array([0.0, 1.0, 0.0])
        y1, y2 = r1 @ y, r2 @ y
        cos = y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2))
        theta = np.arccos(np.clip(cos, -1.0, 1.0))
    elif class_name in _FLIP_SYM:
        flip = np.diag([-1.0, 1.0, -1.0])
        r = r1 @ r2.T
        r_flip = r1 @ flip @ r2.T
        theta = min(
            np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)),
            np.arccos(np.clip((np.trace(r_flip) - 1) / 2, -1, 1)),
        )
    else:
        r = r1 @ r2.T
        theta = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))

    deg = np.degrees(theta)
    if not np.isfinite(deg):
        deg = 180.0
    return np.array([deg, np.linalg.norm(t1 - t2) * 100.0])


def _fetch(values):
    """Host numpy copies of tensors (and array-likes) in one device-to-host
    copy: every value flattened to float64 on the first tensor's device,
    concatenated, and read back once; each comes back in its shape and dtype
    (float32, and integers below 2^53, pass float64 exactly)."""
    import torch

    dev = next((v.device for v in values if isinstance(v, torch.Tensor)), torch.device("cpu"))
    tensors = [torch.as_tensor(v, device=dev) for v in values]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].astype(str(t.dtype).replace("torch.", "")).reshape(tuple(t.shape)))
        off += n
    return out


def fetch_rt_pair(est, frame, extras=()):
    """A pose estimate and its ground-truth frame as NOCS-convention
    matrices in one device-to-host copy: (rt, scales, gt_rt, gt_scales,
    *extras). `rt` / `gt_rt` carry R * |s| in the rotation block with
    unit-normalized `scales`, as the mAP harness expects (utils/util.py:
    2619-2634 divides the norm back out by det^(1/3)). `frame` is a
    `data.synthetic.SynthFrame` or any object with rotation, translation,
    scale_norm and bound; `extras` are more values (e.g. est.pick) that ride
    the same copy."""
    vals = _fetch((est.rotation, est.translation, est.scale, est.scale_norm,
                   frame.rotation, frame.translation, frame.scale_norm, frame.bound)
                  + tuple(extras))
    rt, scales = _assemble_rt(*vals[:4])
    gt_rt, gt_scales = _assemble_gt(*vals[4:8])
    return (rt, scales, gt_rt, gt_scales) + tuple(vals[8:])


def fetch_rt_pairs(ests, frame, extras_per_est=None):
    """`fetch_rt_pair` for many estimates against one frame in one copy: a
    list of (rt, scales, gt_rt, gt_scales, *extras_i) in `ests` order;
    `extras_per_est`, a list as long as `ests`, gives each its extras."""
    extras_per_est = extras_per_est or [()] * len(ests)
    if len(extras_per_est) != len(ests):
        raise ValueError(f"extras_per_est has {len(extras_per_est)} entries for {len(ests)} "
                         "estimates: zip would silently drop the tail")
    flat = tuple(x for est, ex in zip(ests, extras_per_est)
                 for x in (est.rotation, est.translation, est.scale, est.scale_norm) + tuple(ex))
    vals = _fetch(flat + (frame.rotation, frame.translation, frame.scale_norm, frame.bound))
    gt_rt, gt_scales = _assemble_gt(*vals[-4:])
    out, off = [], 0
    for ex in extras_per_est:
        rt, scales = _assemble_rt(*vals[off:off + 4])
        out.append((rt, scales, gt_rt, gt_scales) + tuple(vals[off + 4:off + 4 + len(ex)]))
        off += 4 + len(ex)
    return out


def _assemble_rt(rot, trans, scale, snorm):
    """NOCS-convention (4, 4) RT with R * |s| in the rotation block, and the
    unit-normalized scales the mAP harness expects."""
    rt = np.eye(4)
    rt[:3, :3] = np.asarray(rot) * max(float(snorm), 1e-9)
    rt[:3, 3] = np.asarray(trans)
    scales = np.asarray(scale) / max(float(snorm), 1e-9)
    return rt, scales


def _assemble_gt(g_rot, g_trans, g_snorm, g_bound):
    """The ground truth's (4, 4) RT with R * scale_norm in the rotation block,
    and the bound divided by scale_norm."""
    gt_rt = np.eye(4)
    gt_rt[:3, :3] = np.asarray(g_rot) * float(g_snorm)
    gt_rt[:3, 3] = np.asarray(g_trans)
    gt_scales = np.asarray(g_bound) / float(g_snorm)
    return gt_rt, gt_scales
