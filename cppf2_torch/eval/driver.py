"""Per-instance pose entry point: depth + mask + RGB -> two-branch 9-DoF pose.

Counterpart of the JAX serving path (`cppf2_tpu/eval/driver.py::
dispatch_instance` with the in-graph bbox-crop visual frontend that
`dispatch_frame` and `bench.py::e2e_full` use): `preprocess_frame` ->
`bbox_crop_descriptors` (ViT, kernel K1) -> `estimate_pose_ensemble`
(center votes through kernel K2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from cppf2_torch.config import CATEGORIES, PipelineConfig, get_category
from cppf2_torch.core.downsample import draw_downsample
from cppf2_torch.device import resolve_device
from cppf2_torch.infer.frontend import auto_crop, preprocess_frame, window_shape
from cppf2_torch.infer.pipeline import PoseDraws, PoseEstimate, draw_pose, estimate_pose_ensemble
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.dinov2 import DinoViT, bbox_crop_descriptors
from cppf2_torch.models.porting import load_branch

# REAL275 evaluation intrinsics (eval.py:82)
REAL275_INTRINSICS = np.array(
    [[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32
)


@dataclass
class CategoryModels:
    shot: ShotBranch
    dino: DinoBranch


def load_category_models(ckpt_root: Optional[str], categories: Sequence[str] = None,
                         compute_dtype=torch.bfloat16, device="cuda") -> Dict[str, CategoryModels]:
    """Branch models per category from `{root}/{shot,dino}/<cat>/params.msgpack`.

    A missing file leaves that branch with torch's default random init: the
    pipeline still runs, like the JAX loader's random fallback."""
    dev = resolve_device(device)
    out = {}
    for name in categories or CATEGORIES:
        cat = CATEGORIES[name]
        shot = ShotBranch(tuple_size=cat.tuple_size, compute_dtype=compute_dtype)
        dino = DinoBranch(tuple_size=cat.tuple_size, compute_dtype=compute_dtype)
        for branch, module in (("shot", shot), ("dino", dino)):
            path = os.path.join(ckpt_root, branch, name, "params.msgpack") if ckpt_root else None
            if path and os.path.exists(path):
                load_branch(module, load_params_msgpack(path))
        out[name] = CategoryModels(shot.to(dev).eval(), dino.to(dev).eval())
    return out


def _cloud_extent(pc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-axis extent (3,) of the valid points of a padded cloud."""
    mx = torch.amax(torch.where(valid[:, None], pc, -torch.inf), dim=0)
    mn = torch.amin(torch.where(valid[:, None], pc, torch.inf), dim=0)
    return mx - mn


class InstanceDraws(NamedTuple):
    voxel_perm: torch.Tensor  # permutation of the dense-pass pixels
    voxel_prio: torch.Tensor  # uniform priorities of the dense-pass pixels
    pose: Union[PoseDraws, List[PoseDraws]]  # one per restart when pipe.restarts > 1


def draw_instance(hw, mask: np.ndarray, cat_name: str, pipe: PipelineConfig, device,
                  generator: Optional[torch.Generator] = None) -> InstanceDraws:
    """Every random draw one `estimate_instance` call needs, from `generator`."""
    h, w = window_shape(hw, auto_crop(mask))
    perm, prio = draw_downsample(h * w, device, generator)
    cat = get_category(cat_name)
    pose = [draw_pose(cat, pipe, device, generator) for _ in range(pipe.restarts)]
    return InstanceDraws(perm, prio, pose[0] if pipe.restarts == 1 else pose)


@torch.no_grad()
def estimate_instance(
    rgb: np.ndarray,
    depth: np.ndarray,
    mask: np.ndarray,
    intrinsics: np.ndarray,
    models: CategoryModels,
    cat_name: str,
    pipe: PipelineConfig,
    generator: Optional[torch.Generator] = None,
    vit: Optional[DinoViT] = None,
    device="cuda",
    draws: Optional[InstanceDraws] = None,
    stride: int = 8,
    out_size: int = 256,
) -> PoseEstimate:
    """Pose one detected instance; the slice's entry point.

    Args:
        rgb: (H, W, 3) uint8 frame; depth: (H, W) meters; mask: (H, W) bool.
        intrinsics: (3, 3) pinhole K.
        models: the category's branch models; vit: the DINOv2 backbone, or
            None for a geometric-only pose (the visual branch is skipped).
        generator: source of the random draws unless `draws` is given.
        device: "cuda" (default) or "cpu"; nothing falls back silently.
    Returns:
        PoseEstimate(rotation, translation, scale, scale_norm, loss, pick)
        as tensors on `device`.
    """
    dev = resolve_device(device)
    cat = get_category(cat_name)
    mask = np.asarray(mask, bool)
    if draws is None:
        draws = draw_instance(depth.shape, mask, cat_name, pipe, dev, generator)
    crop = auto_crop(mask)
    depth_t = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    k_t = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    fi = preprocess_frame(depth_t, mask_t, k_t, draws.voxel_perm, draws.voxel_prio,
                          res=cat.res, n_max=pipe.n_points, shot_k=pipe.neighbor_k, crop=crop)

    use_visual = vit is not None
    if use_visual:
        rgb_t = torch.as_tensor(np.asarray(rgb), device=dev).to(torch.float32) / 255.0
        desc = bbox_crop_descriptors(vit, rgb_t, mask_t, fi.pixel_yx, out_size=out_size,
                                     stride=stride)
    else:
        desc = None

    def dino_fn(points, tuple_idx):
        return models.dino(points, desc, tuple_idx)

    def shot_fn(points, tuple_idx):
        return models.shot(points, fi.shot, fi.normal, tuple_idx)

    return estimate_pose_ensemble(dino_fn, shot_fn, fi.pc, fi.valid, fi.count, cat, pipe,
                                  draws=draws.pose, use_visual=use_visual)
