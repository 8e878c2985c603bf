"""The plain reference of one detected instance, end to end.

Given the frame (RGB, depth, the instance's mask, the intrinsics) and the
instance's draws, it runs what the frame driver runs for that instance, one
instance at a time, in the precision the configuration states (its
`precision` group: the ViT's and the branch MLPs' linears in bfloat16 with
float32 accumulation, everything else float32 with TF32 off), with the plain
versions of the kernels' computations: the crop window and the frontend (cloud, normals,
SHOT), the ViT's token grid at the configuration's stride and the token
sampling at the cloud's pixels, both branch MLPs, and the pose graph (votes,
noisy-pair filter, cone votes, alignment, arbitration). It returns the 22
values the driver packs for an instance and the ViT's token grid.

Its weights are its own: the branches read with its own msgpack reader from
the configuration's checkpoint root (the visual branch's input as wide as the
backbone, `weights.visual_branch_tree`), the ViT drawn again from the seed
(`perfbench/weights.py`). The ViT module is the configuration's backbone
file's (`perfbench/backbones/<arch>.py::reference`).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from perfbench import spec
from perfbench.reference import precision
from perfbench.reference.checkpoints import load_params_msgpack
from perfbench.reference.config import CATEGORIES, PipelineConfig
from perfbench.reference.cppf import DinoBranch, ShotBranch
from perfbench.reference.dinov2 import (bbox_crop_token_grid, extractor_grid, interpolate_features,
                                        sample_crop_descriptors)
from perfbench.reference.frontend import auto_crop, crop_origin, mask_bbox, preprocess_frame, resize_crop
from perfbench.reference.pipeline import EnsembleInput, PoseDraws, estimate_pose_ensembles, stack_draws
from perfbench.reference.porting import load_branch
from perfbench.weights import load_vit, visual_branch_tree, vit_tensors


class Result(NamedTuple):
    row: np.ndarray              # (22,) as the driver packs an instance
    grid: torch.Tensor           # the ViT's token grid of the instance's crop
    desc: torch.Tensor           # (N, D) descriptors at the cloud's pixels
    pixel_yx: torch.Tensor       # (N, 2) the cloud's pixels


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _branches(root: str, name: str, width: int, seed: int, dtype, device):
    cat = CATEGORIES[name]
    shot = ShotBranch(tuple_size=cat.tuple_size, compute_dtype=dtype)
    tree = visual_branch_tree(load_params_msgpack(os.path.join(root, "dino", name, "params.msgpack")),
                              width, seed)
    dino = DinoBranch(tuple_size=cat.tuple_size, desc_dim=width, compute_dtype=dtype)
    load_branch(shot, load_params_msgpack(os.path.join(root, "shot", name, "params.msgpack")))
    load_branch(dino, tree)
    return shot.to(device).eval(), dino.to(device).eval()


class Reference:
    def __init__(self, cfg: Dict, seed: int, device):
        precision.exact()
        self.dev = torch.device(device)
        self.cfg = cfg
        self.pipe = PipelineConfig(**cfg["pipeline"])
        v = cfg["vit"]
        self.seed = seed
        self.branch_dtype = _DTYPES[cfg["precision"]["branches"]]
        self.vit = spec.backbone(spec.arch(v)).reference(v, cfg["precision"], self.dev)
        load_vit(self.vit, {k: t.float() for k, t in vit_tensors(v, seed, self.dev).items()})
        self.branches: Dict[str, tuple] = {}

    def _models(self, name):
        if name not in self.branches:
            self.branches[name] = _branches(self.cfg["branches"], name, self.cfg["vit"]["embed_dim"],
                                            self.seed, self.branch_dtype, self.dev)
        return self.branches[name]

    def _visual(self, rgb: np.ndarray, mask: np.ndarray, mask_t, pixel_yx, tiered: bool):
        """(token grid, descriptors at `pixel_yx`) as the driver's route for
        this instance computes them."""
        stride, size = self.cfg["stride"], self.cfg["crop"]
        if self.cfg["route"] == "vit" or tiered:
            rgb_f = torch.as_tensor(rgb, device=self.dev).to(torch.float32) / 255.0
            grid, txy = bbox_crop_token_grid(self.vit, rgb_f, mask_t, out_size=size, stride=stride)
            return grid, sample_crop_descriptors(grid, pixel_yx, txy, size, impl="gather")
        # the extractor's singles route: the masked RGB cropped on the host
        masked = np.where(mask[..., None], rgb, 0).astype(np.uint8)
        crop, transform = resize_crop(masked, bbox=mask_bbox(mask), out_size=size)
        inv = torch.as_tensor(np.linalg.inv(transform).astype(np.float32), device=self.dev)
        grid = extractor_grid(self.vit, torch.as_tensor(crop, device=self.dev) / 255.0, stride)
        xy = pixel_yx.flip(-1).to(torch.float32)
        ones = torch.ones((xy.shape[0], 1), dtype=xy.dtype, device=xy.device)
        kp = (torch.cat([xy, ones], dim=-1) @ inv.T)[:, :2]
        return grid, interpolate_features(grid, kp, crop.shape[:2], impl="gather")

    @torch.no_grad()
    def instance(self, rgb: np.ndarray, depth: np.ndarray, mask: np.ndarray, cat_name: str,
                 intrinsics: np.ndarray, voxel_perm, voxel_prio, pose) -> Result:
        dev = self.dev
        cat = CATEGORIES[cat_name]
        pipe = self.pipe
        crop = auto_crop(mask)
        origin = None
        if crop is not None:
            origin = torch.as_tensor(np.asarray([crop_origin(mask, mask.shape, crop)], np.int32),
                                     device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        fi = preprocess_frame(torch.as_tensor(depth, device=dev), mask_t[None],
                              torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev),
                              voxel_perm.to(dev)[None], voxel_prio.to(dev)[None], res=cat.res,
                              n_max=pipe.n_points, shot_k=pipe.neighbor_k, crop=crop, origin=origin)
        pixel_yx = fi.pixel_yx[0]
        grid, desc = self._visual(rgb, mask, mask_t, pixel_yx, crop is not None)
        shot_m, dino_m = self._models(cat_name)
        draws = PoseDraws(*(t.to(dev) for t in pose))
        group = EnsembleInput(lambda pts, ti: dino_m(pts, desc[None], ti),
                              lambda pts, ti: shot_m(pts, fi.shot, fi.normal, ti),
                              fi.pc, fi.valid, fi.count, [stack_draws([draws])])
        est = estimate_pose_ensembles(group, cat, pipe, True, True, True)
        pc, valid = fi.pc[0], fi.valid[0]
        hi = torch.amax(torch.where(valid[:, None], pc, -torch.inf), dim=0)
        lo = torch.amin(torch.where(valid[:, None], pc, torch.inf), dim=0)
        parts = (fi.count[0], hi - lo, est.rotation[0], est.translation[0], est.scale[0],
                 est.scale_norm[0], est.loss[0], est.pick[0])
        row = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()
        return Result(row, grid, desc, pixel_yx)
