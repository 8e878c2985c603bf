"""Frame frontend: crop window, backprojection, voxel downsample, SHOT.

Counterpart of `cppf2_tpu/infer/frontend.py::preprocess_frame` (reference
eval.py:185-216) and of its host helpers `mask_bbox` / `auto_crop`. The
crop-window origin is computed on the device and read back once, to slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cppf2_torch.core.downsample import voxel_downsample
from cppf2_torch.core.geometry import backproject_masked
from cppf2_torch.ops.shot import compute_shot_features


def mask_bbox(mask: np.ndarray):
    """(left, top, right, bottom) of a host mask, or None when empty."""
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return None
    return (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)


def auto_crop(mask: np.ndarray, tiers=(256, 320)):
    """The dense-pass crop window for an instance mask (host side): the
    smallest tier whose bbox-centered window holds every masked pixel."""
    bb = mask_bbox(mask)
    if bb is None:
        return None
    ext = max(bb[2] - bb[0], bb[3] - bb[1])
    for t in tiers:
        if ext <= t - 4:
            return t
    return None


def window_shape(hw: Tuple[int, int], crop: Optional[int]) -> Tuple[int, int]:
    """(h, w) of the dense pass: the crop window, or the whole frame."""
    h, w = hw
    return (h, w) if crop is None else (min(crop, h), min(crop, w))


class FrameInputs(NamedTuple):
    pc: torch.Tensor         # (n_max, 3)
    valid: torch.Tensor      # (n_max,)
    count: torch.Tensor      # ()
    shot: torch.Tensor       # (n_max, 352)
    normal: torch.Tensor     # (n_max, 3)
    pixel_yx: torch.Tensor   # (n_max, 2) image pixels per point
    window_yx: torch.Tensor  # (2,) crop-window origin


def preprocess_frame(
    depth: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    voxel_perm: torch.Tensor,
    voxel_prio: torch.Tensor,
    res: float = 2e-3,
    n_max: int = 8192,
    shot_k: int = 64,
    crop: Optional[int] = None,
) -> FrameInputs:
    """depth + mask -> padded downsampled cloud + SHOT features.

    With `crop`, a crop x crop window centered on the mask's bbox is cut out
    before backprojection (the caller picks `crop` with `auto_crop`). The
    voxel draws are sized for the window: `window_shape(depth.shape, crop)`
    pixels.
    """
    dev = depth.device
    if crop is not None:
        h, w = depth.shape
        c = crop
        rows = torch.any(mask, dim=1)
        cols = torch.any(mask, dim=0)
        ridx = torch.arange(h, device=dev)
        cidx = torch.arange(w, device=dev)
        y_min = torch.amin(torch.where(rows, ridx, h))
        y_max = torch.amax(torch.where(rows, ridx, -1))
        x_min = torch.amin(torch.where(cols, cidx, w))
        x_max = torch.amax(torch.where(cols, cidx, -1))
        cy = torch.clamp(torch.div(y_min + y_max, 2, rounding_mode="floor"), 0, h - 1)
        cx = torch.clamp(torch.div(x_min + x_max, 2, rounding_mode="floor"), 0, w - 1)
        y0t = torch.clamp(cy - c // 2, 0, max(h - c, 0))
        x0t = torch.clamp(cx - c // 2, 0, max(w - c, 0))
        y0, x0 = (int(v) for v in torch.stack([y0t, x0t]).tolist())
        ch, cw = window_shape((h, w), c)
        depth = depth[y0:y0 + ch, x0:x0 + cw]
        mask = mask[y0:y0 + ch, x0:x0 + cw]
        intrinsics = intrinsics.clone()
        intrinsics[0, 2] -= x0
        intrinsics[1, 2] -= y0
    else:
        y0 = x0 = 0

    pts_all, pixel_yx, valid_all = backproject_masked(depth, intrinsics, mask)
    ds = voxel_downsample(pts_all, valid_all, res, n_max, voxel_perm, voxel_prio)
    pc = torch.where(ds.valid[:, None], pts_all[ds.indices], torch.zeros((), device=dev))
    pix = torch.where(ds.valid[:, None], pixel_yx[ds.indices], torch.zeros((), dtype=torch.int32, device=dev))
    if crop is not None:
        off = torch.tensor([[y0, x0]], dtype=pix.dtype, device=dev)
        pix = torch.where(ds.valid[:, None], pix + off, torch.zeros_like(pix))
    shot, normal = compute_shot_features(pc, ds.valid, res * 10, k=shot_k)
    return FrameInputs(pc, ds.valid, torch.clamp(ds.count, max=n_max), shot, normal, pix,
                       torch.tensor([y0, x0], dtype=torch.int32, device=dev))
