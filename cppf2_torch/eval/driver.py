"""REAL275 evaluation driver: detections -> per-instance pose -> NOCS mAP.

Counterpart of `cppf2_tpu/eval/driver.py` (reference eval.py:54-412). Three
levels, each built on the one before:

  * one instance: `dispatch_instance` queues `preprocess_frame` -> the
    visual descriptors (ViT, kernel K1) -> `estimate_pose_ensemble` (center
    votes through kernel K2) and reads nothing back; the frontend, the
    visual stage (`_instance_visual`) and the ensemble
    (`CategoryModels.pose_fn`) are three programs;
    `fetch_instances` brings a list of them to the host in one copy, applies
    the degenerate-input guards and assembles (RT, scales, loss) in the NOCS
    convention. `estimate_instance` is the same graph returning the raw
    `PoseEstimate` on the device.
  * one frame: `dispatch_frame` groups the detections by (category, crop
    tier), cuts each group into chunks of at most the largest bucket and
    pads each chunk up to a bucket, packs the chunks' crops into as few ViT
    forwards as the largest bucket holds (`_pack_vit_chunks`), then runs
    each chunk as one batched pass (`_pose_group`: frontend, descriptor
    sampling, tuple choice and branch MLPs over the group's instances, the
    pose graph over its (instance, branch) rows); `fetch_frames` is the
    frame's one host copy and drops the padded rows.
  * the dataset: `evaluate_real275` walks the detection pkls with frame k + 1
    dispatched before frame k is fetched, writes the result pkls and scores
    them; `main` is its command line (`python -m cppf2_torch.eval.driver`).

The visual descriptors take one of two routes, as the caller chooses:
  * `dino_extractor=` (a `DinoFeatureExtractor`), the JAX driver's route: a
    single instance's masked RGB is cropped on the host (`resize_crop`) and
    goes through the extractor at its own stride, the cloud's pixels mapped
    into the crop on the device; grouped instances of a frame go through the
    extractor's backbone in the in-graph bbox-crop frontend, at its stride;
  * `vit=` (a bare `DinoViT`, with `stride` and `out_size`): the in-graph
    bbox-crop frontend (`models/dinov2.py`) for every instance, the route
    the JAX package's benchmark times.

Branch weights come from `{root}/{shot,dino}/<cat>`: a packed
`params.msgpack`, a training run's newest checkpoint, or the reference
release's Lightning `last.ckpt` tree (`models/porting.py`).

Each of these units is a program (`eval/programs.py`), as the JAX driver
jits them: on the card it is captured once as a CUDA graph per key (the JAX
key with the inputs' shapes and the weights' addresses) and replayed; on the
CPU, and inside `programs.disable_capture()`, it runs eagerly. The caches:
a category's ensembles and groups on its `CategoryModels`, the instance
frontend's in `_FRONTENDS`, a backbone's ViT stages in `_VIT_STAGES` and its
instance visual stages in `_VISUALS`. A mask that fits no crop tier runs as
any instance does, through the three programs at crop None.

Randomness is injected: one `InstanceDraws` per instance, given or drawn
from a torch.Generator in detection order, so a result does not depend on how
the instances were grouped. A padded row repeats its chunk's last instance:
its mask, crop origin and draws.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cppf2_torch.config import CATEGORIES, SYNSET_NAMES, PipelineConfig, get_category
from cppf2_torch.core.downsample import draw_downsample
from cppf2_torch.core.geometry import check_pinhole
from cppf2_torch.device import resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.eval.nocs_map import compute_degree_cm_map
from cppf2_torch.eval.png import read_png16, read_png_rgb8, write_png_rgb8
from cppf2_torch.eval.pose_errors import _assemble_rt, pose_error_degree_cm
from cppf2_torch.infer.frontend import (
    FrameInputs,
    auto_crop,
    crop_origin,
    mask_bbox,
    preprocess_frame,
    resize_crop,
    window_shape,
)
from cppf2_torch.infer.pipeline import (
    EnsembleInput,
    PoseDraws,
    PoseEstimate,
    draw_pose,
    estimate_pose_ensembles,
    stack_draws,
)
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.dinov2 import (
    DinoFeatureExtractor,
    DinoViT,
    bbox_crop_descriptors,
    bbox_crop_token_grid,
    extractor_grid,
    interpolate_features,
    load_backbone,
    load_dinov2_params,
    sample_crop_descriptors,
)
from cppf2_torch.models.jax_random import init_branch_
from cppf2_torch.models.porting import load_beyondcppf_checkpoint, load_branch
from cppf2_torch.utils.viz import draw_pose_overlay

# REAL275 evaluation intrinsics (eval.py:82)
REAL275_INTRINSICS = np.array(
    [[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32
)


@dataclass
class CategoryModels:
    shot: ShotBranch
    dino: DinoBranch
    # this category's ensemble and group programs, keyed as `programs.program` keys them
    _programs: dict = field(default_factory=dict, repr=False, compare=False)

    def pose_fn(self, cat, pipe: PipelineConfig, run_opt: bool, use_visual: bool = True,
                use_geo: bool = True):
        """One instance's ensemble as a program, one per configuration and
        input shapes, reused for every instance of the category: returns
        fn(pc, valid, count, desc, shot, normal, pose) -> PoseEstimate, with
        the frontend's single-instance outputs, `desc` (N, D) descriptors (or
        None: zeros) and `pose` one PoseDraws per restart; the JAX package's
        `CategoryModels.pose_fn`."""
        key = ("pose", cat.name, pipe, run_opt, use_visual, use_geo,
               programs.weights(self.shot, self.dino))

        def fn(pc, valid, count, desc, shot, normal, pose):
            est = _ensemble(self, cat, pipe, run_opt, use_visual, use_geo, pc[None], valid[None],
                            count[None], None if desc is None else desc[None], shot[None],
                            normal[None], [stack_draws([p]) for p in pose])
            return PoseEstimate(*(f[0] for f in est))

        def run(*args):
            return programs.program(self._programs, key, fn, args)(*args)

        return run


def _reference_ckpt_path(root: str, branch: str, name: str) -> Optional[str]:
    """The reference release's Lightning checkpoint of a category, or None:
    `{root}/{branch}/{name}-num_more-*/lightning_logs/version_*/checkpoints/
    last.ckpt` (eval.py:88-99), the newest version by number (version_10
    after version_9), else a flat `{root}/{branch}/{name}/last.ckpt`."""
    def natural(path):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", path)]

    for pattern in (os.path.join(root, branch, f"{name}-num_more-*", "lightning_logs", "version_*",
                                 "checkpoints", "last.ckpt"),
                    os.path.join(root, branch, name, "last.ckpt")):
        hits = sorted(glob.glob(pattern), key=natural)
        if hits:
            return hits[-1]
    return None


def _check_hydra_sidecar(ckpt_path: str, cat) -> None:
    """Hold the run's hydra config (`.hydra/config.yaml` in the checkpoint's
    directory or up to three above it) against the category: `num_more` + 2
    must be its tuple size, else ValueError. Without a sidecar the
    checkpoint loads unchecked."""
    d = os.path.dirname(ckpt_path)
    for _ in range(4):
        cand = os.path.join(d, ".hydra", "config.yaml")
        if os.path.exists(cand):
            with open(cand) as f:
                m = re.search(r"^\s*num_more:\s*(\d+)", f.read(), re.M)
            if m and int(m.group(1)) + 2 != cat.tuple_size:
                raise ValueError(f"{cand}: num_more={m.group(1)} implies tuple size {int(m.group(1)) + 2}, "
                                 f"but category '{cat.name}' uses {cat.tuple_size}")
            return
        d = os.path.dirname(d)


def load_category_models(ckpt_root: Optional[str], categories: Sequence[str] = None,
                         compute_dtype=torch.bfloat16, device="cuda") -> Dict[str, CategoryModels]:
    """Branch models per category from `{root}/{shot,dino}/<cat>`: the packed
    `params.msgpack`, else the newest checkpoint of a training run there,
    else the reference release's Lightning checkpoint
    (`_reference_ckpt_path`, held against its hydra sidecar).

    A branch with none gets the JAX loader's random fallback, its init from
    `jax.random.key(0)` (shot) or `key(1)` (dino) (`models/jax_random.py`):
    the pipeline still runs. The visual branch takes the descriptor width
    its weights were trained on."""
    from cppf2_torch.train.checkpoints import latest_checkpoint, restore_params

    dev = resolve_device(device)
    out = {}
    for name in categories or CATEGORIES:
        cat = CATEGORIES[name]
        trees = {}
        for branch in ("shot", "dino"):
            run = os.path.join(ckpt_root, branch, name) if ckpt_root else None
            ref = _reference_ckpt_path(ckpt_root, branch, name) if ckpt_root else None
            if run and os.path.exists(os.path.join(run, "params.msgpack")):
                trees[branch] = load_params_msgpack(os.path.join(run, "params.msgpack"))
            elif run and latest_checkpoint(run):
                trees[branch] = restore_params(latest_checkpoint(run))
            elif ref:
                _check_hydra_sidecar(ref, cat)
                trees[branch] = load_beyondcppf_checkpoint(ref, branch)
        shot = ShotBranch(tuple_size=cat.tuple_size, compute_dtype=compute_dtype)
        width = {}
        if "dino" in trees:
            p = trees["dino"].get("params", trees["dino"])
            width = {"desc_dim": p["desc_transform"]["kernel"].shape[0]}
        dino = DinoBranch(tuple_size=cat.tuple_size, compute_dtype=compute_dtype, **width)
        for seed, (branch, module) in enumerate((("shot", shot), ("dino", dino))):
            if branch in trees:
                load_branch(module, trees[branch])
            else:
                init_branch_(module, seed)
        out[name] = CategoryModels(shot.to(dev).eval(), dino.to(dev).eval())
    return out


def _cloud_extent(pc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-axis extent ([B,] 3) of the valid points of a padded cloud."""
    mx = torch.amax(torch.where(valid[..., None], pc, -torch.inf), dim=-2)
    mn = torch.amin(torch.where(valid[..., None], pc, torch.inf), dim=-2)
    return mx - mn


class InstanceDraws(NamedTuple):
    voxel_perm: torch.Tensor  # permutation of the dense-pass pixels
    voxel_prio: torch.Tensor  # uniform priorities of the dense-pass pixels
    pose: Union[PoseDraws, List[PoseDraws]]  # one per restart when pipe.restarts > 1


def draw_instance(hw, mask: np.ndarray, cat_name: str, pipe: PipelineConfig, device,
                  generator: Optional[torch.Generator] = None, crop="auto") -> InstanceDraws:
    """Every random draw one instance needs, from `generator`; the voxel
    draws are sized for the dense-pass window of `crop` ("auto": the mask's
    `auto_crop` tier)."""
    h, w = window_shape(hw, auto_crop(mask) if crop == "auto" else crop)
    perm, prio = draw_downsample(h * w, device, generator)
    cat = get_category(cat_name)
    pose = [draw_pose(cat, pipe, device, generator) for _ in range(pipe.restarts)]
    return InstanceDraws(perm, prio, pose[0] if pipe.restarts == 1 else pose)


def _draws_on(d: InstanceDraws, dev) -> InstanceDraws:
    def move(p):
        return PoseDraws(*(t.to(dev) for t in p))

    pose = [move(p) for p in d.pose] if isinstance(d.pose, list) else move(d.pose)
    return InstanceDraws(d.voxel_perm.to(dev), d.voxel_prio.to(dev), pose)


def _stacked(draws: Sequence[InstanceDraws]):
    """A group's draws as (voxel_perm (B, pixels), voxel_prio (B, pixels),
    one stacked PoseDraws per restart)."""
    restarts = [d.pose if isinstance(d.pose, list) else [d.pose] for d in draws]
    return (torch.stack([d.voxel_perm for d in draws]), torch.stack([d.voxel_prio for d in draws]),
            [stack_draws(r) for r in zip(*restarts)])


def _ensemble(models: CategoryModels, cat, pipe: PipelineConfig, run_opt: bool, use_visual: bool,
              use_geo: bool, pc, valid, count, desc, shot, normal, pose) -> PoseEstimate:
    """The ensemble of a group from its frontend's (B, ...) outputs and
    (B, N, D) descriptors (None: zeros, as in the JAX driver), `pose` one
    stacked PoseDraws per restart: per restart one forward of each enabled
    branch MLP and one batched pose graph over the (instance, branch) rows."""
    if use_visual and desc is None:
        desc = torch.zeros((pc.shape[0], pipe.n_points, models.dino.desc_transform.in_features),
                           device=pc.device)
    group = EnsembleInput(lambda pts, ti: models.dino(pts, desc, ti),
                          lambda pts, ti: models.shot(pts, shot, normal, ti), pc, valid, count, pose)
    return estimate_pose_ensembles(group, cat, pipe, run_opt, use_visual, use_geo)


def _pose_group(depth, masks, origins, perm, prio, pose, k_t, crop, models: CategoryModels, cat,
                pipe: PipelineConfig, run_opt: bool, use_visual: bool, use_geo: bool, desc_fn=None):
    """Frontend + ensemble of a group of B instances of one category and crop
    tier on the device, nothing read back, as the JAX driver's vmapped group
    program: one batched frontend pass (`preprocess_frame` over the (B, H, W)
    `masks`, `depth` (H, W) shared or (B, H, W)), one descriptor call
    (`desc_fn(pixel_yx (B, N, 2)) -> (B, N, D)`; zeros without one), then
    `_ensemble`. `origins` holds each window's (y0, x0) from the host mask
    ((B, 2) on the device or numbers; None without `crop`), `perm`, `prio`
    and `pose` the group's stacked draws on the device (`_stacked`). Returns
    (FrameInputs, PoseEstimate), every field with a leading (B,) axis."""
    fi = preprocess_frame(depth, masks, k_t, perm, prio, res=cat.res, n_max=pipe.n_points,
                          shot_k=pipe.neighbor_k, crop=crop, origin=origins)
    desc = desc_fn(fi.pixel_yx) if use_visual and desc_fn is not None else None
    return fi, _ensemble(models, cat, pipe, run_opt, use_visual, use_geo, fi.pc, fi.valid, fi.count,
                         desc, fi.shot, fi.normal, pose)


# the instance frontend's programs, keyed on preprocess_frame's static arguments (every category's)
_FRONTENDS: dict = {}


def _frontend(depth, mask, k_t, perm, prio, origin, res: float, n_max: int, shot_k: int, crop,
              exact_knn: bool = False) -> FrameInputs:
    """One instance's `preprocess_frame` as a program, keyed as the JAX
    package jits it: on (res, n_max, shot_k, crop, exact_knn) and the input
    shapes. `origin` is the window's (2,) int32 origin on the device (None
    without `crop`). It runs as a group of one."""
    def fn(depth, mask, k_t, perm, prio, origin):
        fi = preprocess_frame(depth, mask[None], k_t, perm[None], prio[None], res=res, n_max=n_max,
                              shot_k=shot_k, crop=crop, origin=None if origin is None else origin[None],
                              exact_knn=exact_knn)
        return FrameInputs(*(f[0] for f in fi))

    args = (depth, mask, k_t, perm, prio, origin)
    return programs.program(_FRONTENDS, ("frontend", res, n_max, shot_k, crop, exact_knn), fn,
                            args)(*args)


def _kp_to_crop(pixel_yx: torch.Tensor, inv_transform: torch.Tensor) -> torch.Tensor:
    """Cloud pixels (y, x) as (x, y) positions in the host crop, through the
    inverse of the `resize_crop` transform, on the device."""
    xy = pixel_yx.flip(-1).to(torch.float32)
    ones = torch.ones((xy.shape[0], 1), dtype=xy.dtype, device=xy.device)
    return (torch.cat([xy, ones], dim=-1) @ inv_transform.T)[:, :2]


def _visual_source(vit, dino_extractor, use_visual):
    """`use_visual` resolved (default: a backbone is given); one backbone at most."""
    if vit is not None and dino_extractor is not None:
        raise ValueError("pass a ViT (the bbox-crop route) or a DinoFeatureExtractor (the host-crop "
                         "route), not both")
    return (vit is not None or dino_extractor is not None) if use_visual is None else use_visual


# a backbone's instance visual-stage programs, on the backbone (they read its weights where they lie)
_VISUALS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _instance_visual(rgb, mask: np.ndarray, mask_t, pixel_yx, dev, vit, dino_extractor, stride: int,
                     out_size: int) -> torch.Tensor:
    """One instance's (N, D) descriptors at its cloud's pixels, the visual
    stage as a program on the backbone, one per route, backbone config,
    stride, crop size (sampling form) and weights' addresses:
      * `dino_extractor`, the JAX driver's route: the masked RGB cropped on
        the host (`resize_crop`, 256 x 256 float32), uploaded, scaled on the
        device, the cloud's pixels mapped into the crop (`_kp_to_crop`), the
        extractor's resize and ViT at its stride and its token sampling: the
        jitted `_kp_to_crop` and `DinoFeatureExtractor` of the JAX package;
      * `vit`: `bbox_crop_descriptors` on the uint8 frame and the mask, the
        in-graph route of the JAX package's benchmark.
    The body calls the eager `extractor_grid`, not the extractor, whose own
    call is a program: programs do not nest."""
    if dino_extractor is not None:
        masked = np.where(mask[..., None], np.asarray(rgb), 0).astype(np.uint8)
        crop_img, transform = resize_crop(masked, bbox=mask_bbox(mask), out_size=256)
        args = (torch.as_tensor(crop_img, device=dev),
                torch.as_tensor(np.linalg.inv(transform).astype(np.float32), device=dev), pixel_yx)
        backbone, stride, impl = dino_extractor.model, dino_extractor.stride, dino_extractor.interp_impl
        own = weakref.ref(backbone)   # the cache lives as long as the backbone, not longer

        def fn(crop, inv_t, pixel_yx):
            grid = extractor_grid(own(), crop / 255.0, stride)
            return interpolate_features(grid, _kp_to_crop(pixel_yx, inv_t), crop.shape[:2], impl=impl)

        key = ("visual", "extractor", backbone.cfg, stride, impl, programs.weights(backbone))
    else:
        args = (torch.as_tensor(np.asarray(rgb, np.uint8), device=dev), mask_t, pixel_yx)
        backbone = vit
        own = weakref.ref(backbone)

        def fn(rgb_u8, mask, pixel_yx):
            return bbox_crop_descriptors(own(), rgb_u8.to(torch.float32) / 255.0, mask, pixel_yx,
                                         out_size=out_size, stride=stride)

        key = ("visual", "vit", backbone.cfg, stride, out_size, programs.weights(backbone))
    cache = _VISUALS.setdefault(backbone, {})
    return programs.program(cache, key, fn, args)(*args)


def _instance_graph(rgb, depth, mask, intrinsics, models, cat_name, pipe, generator, vit, dev,
                    draws, stride, out_size, run_opt, use_visual, use_geo, crop, dino_extractor=None):
    """One instance as three programs (the frontend, the visual stage, the
    ensemble) around the host's crop origin and, on the extractor's route,
    its host crop."""
    cat = get_category(cat_name)
    mask = np.asarray(mask, bool)
    use_visual = _visual_source(vit, dino_extractor, use_visual)
    if crop == "auto":
        crop = auto_crop(mask)
    if draws is None:
        draws = draw_instance(depth.shape, mask, cat_name, pipe, dev, generator, crop=crop)
    draws = _draws_on(draws, dev)
    depth_t = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    check_pinhole(np.asarray(intrinsics))
    k_t = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    origin = None
    if crop is not None:
        origin = torch.as_tensor(np.asarray(crop_origin(mask, mask.shape, crop), np.int32), device=dev)
    fi = _frontend(depth_t, mask_t, k_t, draws.voxel_perm, draws.voxel_prio, origin, cat.res,
                   pipe.n_points, pipe.neighbor_k, crop)
    # an all-empty detection mask has no bbox to crop: the pose graph still
    # runs on zero descriptors and the count guard rejects the instance
    desc = None
    if use_visual and (vit is not None or dino_extractor is not None) and mask.any():
        desc = _instance_visual(rgb, mask, mask_t, fi.pixel_yx, dev, vit, dino_extractor, stride,
                                out_size)
    pose = draws.pose if isinstance(draws.pose, list) else [draws.pose]
    est = models.pose_fn(cat, pipe, run_opt, use_visual, use_geo)(
        fi.pc, fi.valid, fi.count, desc, fi.shot, fi.normal, pose)
    return cat, (fi, est)


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
    run_opt: bool = True,
    use_visual: Optional[bool] = None,
    use_geo: bool = True,
    crop="auto",
    dino_extractor: Optional[DinoFeatureExtractor] = None,
) -> PoseEstimate:
    """Pose one detected instance and return the raw estimate on the device.

    The JAX package's `estimate_instance` returns `(RT, scales, loss)` or
    None for a degenerate input; that convention is
    `fetch_instances([dispatch_instance(...)])[0]` here, on the same graph.

    Args:
        rgb: (H, W, 3) uint8 frame; depth: (H, W) meters; mask: (H, W) bool.
        intrinsics: (3, 3) pinhole K.
        models: the category's branch models.
        vit: the DINOv2 backbone of the in-graph bbox-crop route, at
            `stride` on an `out_size` crop.
        dino_extractor: the JAX driver's route instead: the masked RGB
            cropped to 256 x 256 on the host, descriptors from the extractor
            at its own stride. Giving both raises.
        generator: source of the random draws unless `draws` is given.
        device: "cuda" (default) or "cpu"; nothing falls back silently.
        run_opt: run the alignment after the votes.
        use_visual: the visual branch competes; defaults to "a backbone is
            given" (without one it would see zero descriptors).
        use_geo: the geometric branch competes.
        crop: dense-pass window, "auto" for the mask's `auto_crop` tier, an
            int, or None for the whole frame.
    Returns:
        PoseEstimate(rotation, translation, scale, scale_norm, loss, pick)
        as tensors on `device`.
    """
    dev = resolve_device(device)
    _, (_, est) = _instance_graph(rgb, depth, mask, intrinsics, models, cat_name, pipe, generator,
                                  vit, dev, draws, stride, out_size, run_opt, use_visual, use_geo,
                                  crop, dino_extractor)
    return est


# ---------------------------------------------------------------------------
# Dispatch now, fetch later: one host copy per list of instances
# ---------------------------------------------------------------------------

class PendingInstance(NamedTuple):
    """One dispatched instance, not yet fetched: 22 float32 values on the
    device (count, extent 3, rotation 9, translation 3, scale 3, scale norm,
    loss, pick) and the category's voxel resolution for the extent guard."""

    dev: torch.Tensor
    res: float


def _pack(fi, est: PoseEstimate) -> torch.Tensor:
    """The 22 values of one instance, or (B, 22) rows for a group's
    FrameInputs and PoseEstimate with a leading (B,) axis."""
    parts = (fi.count, _cloud_extent(fi.pc, fi.valid), est.rotation, est.translation, est.scale,
             est.scale_norm, est.loss, est.pick)
    lead = fi.count.shape
    return torch.cat([p.reshape(*lead, -1).to(torch.float32) for p in parts], dim=-1)


@torch.no_grad()
def dispatch_instance(
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
    run_opt: bool = True,
    use_visual: Optional[bool] = None,
    use_geo: bool = True,
    crop="auto",
    dino_extractor: Optional[DinoFeatureExtractor] = None,
) -> PendingInstance:
    """Queue one instance's whole pose graph; nothing is read back from the
    device (the crop window's origin comes from the host mask). Arguments as
    `estimate_instance`. A degenerate instance costs one wasted graph; it is
    rejected in `fetch_instances`."""
    dev = resolve_device(device)
    cat, (fi, est) = _instance_graph(rgb, depth, mask, intrinsics, models, cat_name, pipe,
                                     generator, vit, dev, draws, stride, out_size, run_opt,
                                     use_visual, use_geo, crop, dino_extractor)
    return PendingInstance(_pack(fi, est), cat.res)


def _finalize_instance(res: float, row: np.ndarray):
    """(RT, scales, loss) of one fetched row, or None for a degenerate input:
    fewer than 32 points, or a cloud more than 1000 voxels wide (eval.py:200)."""
    count, extent = row[0], row[1:4]
    if int(count) < 32 or extent.max() / res > 1000:
        return None
    rt, scales = _assemble_rt(row[4:13].reshape(3, 3), row[13:16], row[16:19], row[19])
    return rt, scales, float(row[20])


def _fetch(rows: List[torch.Tensor]) -> np.ndarray:
    """One device-to-host copy of every pending row."""
    return torch.cat([r.reshape(-1, 22) for r in rows]).cpu().numpy()


def fetch_instances(pendings: Sequence[PendingInstance], return_picks: bool = False):
    """One host copy for a list of dispatched instances. Each result is
    (RT 4x4, scales 3, loss) in the NOCS convention (R * |s| in the rotation
    block with the clamped scale norm, unit-normalized scales), or None for a
    degenerate input (eval.py:200-201, 370-372): the JAX package's return
    convention. With `return_picks`, also the winning branch of each (0
    visual, 1 geometric)."""
    if not pendings:
        return ([], []) if return_picks else []
    rows = _fetch([p.dev for p in pendings])
    out = [_finalize_instance(p.res, row) for p, row in zip(pendings, rows)]
    return (out, [int(r[21]) for r in rows]) if return_picks else out


# ---------------------------------------------------------------------------
# The frame path: one batched ViT forward, then one batched pose graph a group
# ---------------------------------------------------------------------------

class PendingFrameGroup(NamedTuple):
    """The dispatched instances of one chunk of a (category, crop tier) group
    of a frame: (batch, 22) rows as in `PendingInstance`, and the detection
    index of each real row; the rows past them are padding."""

    dev: torch.Tensor
    res: float
    idxs: Tuple[int, ...]


# a backbone's ViT-stage programs, on the backbone (they read its weights where they lie)
_VIT_STAGES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# novel multi-chunk pack signatures a backbone captures; past them each chunk runs alone
_VIT_STAGE_MULTI_CAP = 8


def _pack_vit_chunks(batches, cap):
    """First-fit-decreasing packing of the chunks' ViT batch sizes into packs
    of at most `cap` crops: [(chunk ids, sizes)], typically one pack (one ViT
    forward) for a whole frame. The JAX driver's `_pack_vit_chunks`."""
    order = sorted(range(len(batches)), key=lambda c: -batches[c])
    packs = []   # [ids, sizes, total]
    for ci in order:
        b = batches[ci]
        for p in packs:
            if p[2] + b <= cap:
                p[0].append(ci)
                p[1].append(b)
                p[2] += b
                break
        else:
            packs.append([[ci], [b], b])
    return [(ids, tuple(sizes)) for ids, sizes, _ in packs]


def _vit_stage(backbone: DinoViT, stride: int, out_size: int, batches: tuple, rgb_u8, masks):
    """The frame-wide ViT stage as a program: every crop of a pack of chunks
    (`masks` (sum(batches), H, W) of the frame `rgb_u8` (H, W, 3) uint8) in
    one `bbox_crop_token_grid` forward, split into each chunk's (grids,
    txys). One program per backbone, stride, crop size and pack signature, as
    the JAX driver's `_vit_stage_fn`."""
    own = weakref.ref(backbone)   # the cache lives as long as the backbone, not longer

    def fn(rgb_u8, masks):
        grids, txys = bbox_crop_token_grid(own(), rgb_u8.to(torch.float32) / 255.0, masks,
                                           out_size=out_size, stride=stride)
        parts, off = [], 0
        for b in batches:
            parts.append((grids[off:off + b], txys[off:off + b]))
            off += b
        return tuple(parts)

    cache = _VIT_STAGES.setdefault(backbone, {})
    key = ("vit", backbone.cfg, stride, out_size, batches, programs.weights(backbone))
    return programs.program(cache, key, fn, (rgb_u8, masks))(rgb_u8, masks)


def _vit_packs(backbone: DinoViT, stride: int, out_size: int, batches, cap: int):
    """`_pack_vit_chunks` at `cap`, with the JAX driver's budget: a pack of
    several chunks whose signature has no program yet runs as one forward only
    while the backbone holds fewer than `_VIT_STAGE_MULTI_CAP` such programs;
    past that each of its chunks runs alone, a (b,) signature of a bounded
    set."""
    cache = _VIT_STAGES.get(backbone, {})
    known = {k[0][4] for k in cache if k[0][1:4] == (backbone.cfg, stride, out_size)}
    n_multi = sum(len(sizes) > 1 for sizes in known)
    out = []
    for ids, sizes in _pack_vit_chunks(batches, cap):
        novel = len(sizes) > 1 and sizes not in known
        if novel and n_multi >= _VIT_STAGE_MULTI_CAP:
            out.extend(([ci], (b,)) for ci, b in zip(ids, sizes))
            continue
        if novel:
            known.add(sizes)
            n_multi += 1
        out.append((ids, sizes))
    return out


def _group_program(models: CategoryModels, cat, pipe: PipelineConfig, run_opt: bool,
                   use_visual: bool, use_geo: bool, crop: int, stride: int, ext_key, batch: int,
                   args) -> programs.Program:
    """The program of one chunk of a (category, crop tier) group, padded to
    `batch` rows: `_pose_group` with descriptors sampled from the ViT stage's
    (grids, txys), and the packed rows out. Keyed as the JAX driver's
    `_frame_group_fn`, on the extractor's behaviour (`ext_key`: config,
    stride, crop size and sampling form), which is all the program reads of
    it, and not on its identity."""
    out_size, impl = (ext_key[2], ext_key[3]) if ext_key is not None else (0, None)

    def fn(depth, masks, origins, k_t, perm, prio, pose, grids, txys):
        desc_fn = None
        if grids is not None:
            def desc_fn(pixel_yx):
                return sample_crop_descriptors(grids, pixel_yx, txys, out_size, impl=impl)
        fi, est = _pose_group(depth, masks, origins, perm, prio, pose, k_t, crop, models, cat, pipe,
                              run_opt, use_visual, use_geo, desc_fn)
        return _pack(fi, est)

    key = ("frame", cat.name, pipe, run_opt, use_visual, use_geo, crop, stride, ext_key, batch,
           programs.weights(models.shot, models.dino))
    return programs.program(models._programs, key, fn, args)


@torch.no_grad()
def dispatch_frame(
    rgb: np.ndarray,
    depth: np.ndarray,
    detections,
    intrinsics: np.ndarray,
    models: Dict[str, CategoryModels],
    pipe: PipelineConfig,
    generator: Optional[torch.Generator] = None,
    vit: Optional[DinoViT] = None,
    device="cuda",
    draws: Optional[Sequence[InstanceDraws]] = None,
    stride: int = 8,
    out_size: int = 256,
    run_opt: bool = True,
    use_visual: Optional[bool] = None,
    use_geo: bool = True,
    buckets: Sequence[int] = (1, 2, 4, 8),
    dino_extractor: Optional[DinoFeatureExtractor] = None,
):
    """Queue all of a frame's instances; nothing is read back from the
    device. Finalize with `fetch_frames`.

    `detections` is an iterable of (category name, (H, W) bool mask). The
    instances are grouped by (category, `auto_crop` tier) as in the JAX
    driver; a mask that fits no tier goes through `dispatch_instance` with
    `crop=None` (the whole frame), as three programs like any instance. A
    group is cut into chunks of at most `buckets[-1]` instances, and each
    chunk padded up to the smallest bucket that holds it, its padded rows
    repeating its last instance, so the programs number O(categories x
    tiers x len(buckets)) whatever a frame holds. The visual stage packs the chunks' crops into ViT forwards of at
    most `buckets[-1]` crops (`_vit_packs`), across groups. Each chunk then
    runs as one program: one frontend call, one descriptor sampling and one
    forward of each enabled branch MLP for its rows, and one pose graph over
    its (instance, branch) rows.

    With `dino_extractor` (the JAX driver's route) the grouped instances go
    through its backbone at its stride, crop size and sampling form, and the
    singles through its host crop (`dispatch_instance`).

    `draws` holds one InstanceDraws per detection, in detection order, each
    sized for that detection's `auto_crop` window; without it they are drawn
    in that order from `generator`.
    """
    dev = resolve_device(device)
    use_visual = _visual_source(vit, dino_extractor, use_visual)
    backbone, impl = vit, "gather"
    if dino_extractor is not None:
        backbone, impl = dino_extractor.model, dino_extractor.interp_impl
        stride, out_size = dino_extractor.stride, dino_extractor.out_size
    dets = [(name, np.asarray(m, bool)) for name, m in detections]
    if draws is None:
        draws = [draw_instance(depth.shape, m, name, pipe, dev, generator) for name, m in dets]
    if len(draws) != len(dets):
        raise ValueError(f"{len(draws)} draws for {len(dets)} detections")
    buckets = tuple(sorted(int(b) for b in buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive batch sizes, got {buckets}")
    cap = buckets[-1]

    groups: Dict[tuple, list] = {}
    singles = []
    for idx, (name, mask) in enumerate(dets):
        tier = auto_crop(mask)
        if tier is None:
            singles.append((idx, dispatch_instance(
                rgb, depth, mask, intrinsics, models[name], name, pipe, vit=vit, device=dev,
                draws=draws[idx], stride=stride, out_size=out_size, run_opt=run_opt,
                use_visual=use_visual, use_geo=use_geo, crop=None, dino_extractor=dino_extractor)))
        else:
            groups.setdefault((name, tier), []).append(idx)

    # chunks of at most `cap` instances, each padded to its bucket by repeating its last one
    chunks = []   # (name, tier, real detection indices, the batch's detection indices)
    for (name, tier), members in groups.items():
        for lo in range(0, len(members), cap):
            idxs = tuple(members[lo:lo + cap])
            batch = next(b for b in buckets if b >= len(idxs))
            chunks.append((name, tier, idxs, idxs + (idxs[-1],) * (batch - len(idxs))))

    pendings: list = []
    if chunks:
        check_pinhole(np.asarray(intrinsics))
        depth_t = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
        k_t = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
        rows = [i for c in chunks for i in c[3]]
        masks_t = torch.as_tensor(np.stack([dets[i][1] for i in rows]), device=dev)
        origins_t = torch.as_tensor(np.asarray(
            [crop_origin(dets[i][1], depth.shape, tier) for _, tier, _, batch in chunks for i in batch],
            np.int32), device=dev)
        starts = np.cumsum([0] + [len(c[3]) for c in chunks]).tolist()
        visual_on = use_visual and backbone is not None
        ext_key = (backbone.cfg, stride, out_size, impl) if visual_on else None
        parts: Dict[int, tuple] = {}
        if visual_on:
            rgb_t = torch.as_tensor(np.asarray(rgb, np.uint8), device=dev)
            for ids, sizes in _vit_packs(backbone, stride, out_size, [len(c[3]) for c in chunks], cap):
                pack = torch.cat([masks_t[starts[c]:starts[c + 1]] for c in ids])
                parts.update(zip(ids, _vit_stage(backbone, stride, out_size, sizes, rgb_t, pack)))
        for c, (name, tier, idxs, batch) in enumerate(chunks):
            cat = get_category(name)
            lo, hi = starts[c], starts[c + 1]
            grids, txys = parts.get(c, (None, None))
            args = (depth_t, masks_t[lo:hi], origins_t[lo:hi], k_t,
                    *_stacked([_draws_on(draws[i], dev) for i in batch]), grids, txys)
            prog = _group_program(models[name], cat, pipe, run_opt, use_visual, use_geo, tier,
                                  stride if visual_on else 0, ext_key, len(batch), args)
            pendings.append(PendingFrameGroup(prog(*args), cat.res, idxs))
    pendings.extend(singles)
    return pendings


def fetch_frames(pendings, return_picks: bool = False):
    """One host copy for everything `dispatch_frame` queued for a frame.
    Returns {detection index -> (RT, scales, loss) or None} with the result
    convention and guards of `fetch_instances`; with `return_picks`, also
    {detection index -> winning branch}."""
    if not pendings:
        return ({}, {}) if return_picks else {}
    keyed = []  # (detection index, res) per fetched row
    for p in pendings:
        if isinstance(p, PendingFrameGroup):
            keyed.extend((idx, p.res) for idx in p.idxs)
        else:
            keyed.append((p[0], p[1].res))
    # a chunk's padded rows come back with it and are dropped here
    rows = _fetch([p.dev[:len(p.idxs)] if isinstance(p, PendingFrameGroup) else p[1].dev
                   for p in pendings])
    out = {idx: _finalize_instance(res, row) for (idx, res), row in zip(keyed, rows)}
    if return_picks:
        return out, {idx: int(row[21]) for (idx, _), row in zip(keyed, rows)}
    return out


# ---------------------------------------------------------------------------
# The dataset loop
# ---------------------------------------------------------------------------

def _debug_frame(res, posed, base, rgb, out_dir):
    """Per-instance rotation and translation errors against the first
    ground-truth instance of the same class, and the frame with every posed
    instance's overlay as `{out_dir}/debug/<base>.png` (reference
    eval.py:374-395)."""
    gt_ids = [int(c) for c in res["gt_class_ids"]]
    overlay = rgb
    for i in posed:
        cls_id = int(res["pred_class_ids"][i])
        if cls_id in gt_ids:
            g = gt_ids.index(cls_id)
            hv = int(np.asarray(res["gt_handle_visibility"])[g])
            err = pose_error_degree_cm(res["pred_RTs"][i], res["gt_RTs"][g], SYNSET_NAMES[cls_id],
                                       handle_visibility=hv)
            print(f"[debug] {base} inst {i} {SYNSET_NAMES[cls_id]}: "
                  f"rot {err[0]:.1f} deg, tr {err[1]:.1f} cm")
        overlay = draw_pose_overlay(overlay, res["pred_RTs"][i], res["pred_scales"][i],
                                    REAL275_INTRINSICS)
    if posed:
        os.makedirs(os.path.join(out_dir, "debug"), exist_ok=True)
        write_png_rgb8(os.path.join(out_dir, "debug", base.replace(".pkl", "") + ".png"), overlay)


def _load_vit(dino_ckpt: str, dev) -> Tuple[DinoViT, int, int]:
    """A `save_backbone` pair named by its prefix (or its .msgpack): (the
    backbone, its stride, its crop size)."""
    prefix = dino_ckpt[:-len(".msgpack")] if dino_ckpt.endswith(".msgpack") else dino_ckpt
    loaded = load_backbone(prefix, device=dev)
    if loaded is None:
        raise FileNotFoundError(f"{prefix}.json has no {prefix}.msgpack beside it")
    vit, _, stride, out_size = loaded
    return vit.eval().cast_for_inference(), stride, out_size


def load_dino_extractor(dino_ckpt: str, device="cuda") -> DinoFeatureExtractor:
    """The official DINOv2 ViT-L/14 `.pth` as the JAX driver's default
    extractor (stride 4, 256 x 256 crops, K1 at 4097 tokens). A named file
    that does not exist raises."""
    params = load_dinov2_params(dino_ckpt)
    if params is None:
        raise FileNotFoundError(f"no DINOv2 checkpoint at {dino_ckpt}")
    return DinoFeatureExtractor(params=params, device=device)


def evaluate_real275(
    detections_dir: str,
    image_root: str,
    out_dir: str,
    ckpt_root: Optional[str] = "ckpts",
    pipe: Optional[PipelineConfig] = None,
    dino_ckpt: Optional[str] = None,
    limit: Optional[int] = None,
    run_opt: bool = True,
    seed: int = 0,
    debug: bool = False,
    vit: Optional[DinoViT] = None,
    device="cuda",
    draws: Optional[Sequence[Sequence[InstanceDraws]]] = None,
    stride: int = 8,
    out_size: int = 256,
    models: Optional[Dict[str, CategoryModels]] = None,
    dino_extractor: Optional[DinoFeatureExtractor] = None,
    buckets: Sequence[int] = (1, 2, 4, 8),
):
    """Full REAL275 evaluation: detection pkls + frames -> result pkls under
    `out_dir` and the (iou_aps, pose_aps) tables of `compute_degree_cm_map`.

    Frames are pipelined two deep: frame k + 1 is decoded and dispatched
    while frame k computes, and frame k is fetched (its one host copy) only
    after that. `dino_ckpt` names a `save_backbone` pair (`{prefix}.json`
    beside it), run on the bbox-crop route at its stride, or else an
    official DINOv2 `.pth`, run as the JAX driver's stride-4
    `DinoFeatureExtractor`. `vit` (with `stride` and `out_size`) or
    `dino_extractor` hands in a built backbone instead. `draws`, when
    given, holds for each frame one InstanceDraws per detection of a known
    category, in detection order; otherwise they come from one generator
    seeded by `seed`. `debug` prints each posed instance's errors and writes
    each frame's overlay to `{out_dir}/debug/`. `buckets` are
    `dispatch_frame`'s.
    """
    dev = resolve_device(device)
    pipe = pipe or PipelineConfig()
    pkls = sorted(glob.glob(os.path.join(detections_dir, "results_*.pkl")))
    if not pkls:
        raise FileNotFoundError(f"no detection pkls under {detections_dir}")
    if limit:
        pkls = pkls[:limit]
    if draws is not None and len(draws) != len(pkls):
        raise ValueError(f"draws for {len(draws)} frames, {len(pkls)} frames to evaluate")

    if models is None:
        models = load_category_models(ckpt_root, device=dev)
    if dino_ckpt and vit is None and dino_extractor is None:
        prefix = dino_ckpt[:-len(".msgpack")] if dino_ckpt.endswith(".msgpack") else dino_ckpt
        if os.path.exists(prefix + ".json"):
            vit, stride, out_size = _load_vit(dino_ckpt, dev)
        else:
            dino_extractor = load_dino_extractor(dino_ckpt, dev)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = []

    def finish(pf):
        res, det_idx, pends, base, rgb = pf
        outs = fetch_frames(pends)
        posed = []
        for j, i in enumerate(det_idx):
            if outs.get(j) is None:
                continue
            res["pred_RTs"][i], res["pred_scales"][i], _ = outs[j]
            posed.append(i)
        if debug:
            _debug_frame(res, posed, base, rgb, out_dir)
        results.append(res)
        with open(os.path.join(out_dir, base), "wb") as f:
            pickle.dump(res, f)

    pending_frame = None
    for k, pkl_path in enumerate(pkls):
        with open(pkl_path, "rb") as f:
            res = pickle.load(f)
        if "gt_handle_visibility" not in res:
            res["gt_handle_visibility"] = np.ones_like(res["gt_class_ids"])
        image_path = os.path.join(image_root, os.path.relpath(res["image_path"], "data/real/test"))
        try:
            rgb = read_png_rgb8(image_path + "_color.png")
            depth = read_png16(image_path + "_depth.png").astype(np.float32) / 1000.0
        except OSError as e:
            raise FileNotFoundError(
                f"unreadable REAL275 frame: {image_path}_color.png / _depth.png") from e

        n_inst = len(res["pred_class_ids"])
        res["pred_RTs"] = np.stack([np.eye(4) for _ in range(n_inst)])
        res["pred_scales"] = np.ones((n_inst, 3))
        dets, det_idx = [], []
        for i in range(n_inst):
            cat_name = SYNSET_NAMES[int(res["pred_class_ids"][i])]
            if cat_name not in CATEGORIES:
                continue
            dets.append((cat_name, res["pred_masks"][:, :, i].astype(bool)))
            det_idx.append(i)
        pends = dispatch_frame(rgb, depth, dets, REAL275_INTRINSICS, models, pipe, generator=gen,
                               vit=vit, device=dev, draws=None if draws is None else draws[k],
                               stride=stride, out_size=out_size, run_opt=run_opt,
                               buckets=buckets, dino_extractor=dino_extractor)
        if pending_frame is not None:
            finish(pending_frame)
        pending_frame = (res, det_idx, pends, os.path.basename(pkl_path), rgb)
    if pending_frame is not None:
        finish(pending_frame)

    return compute_degree_cm_map(
        results, SYNSET_NAMES, os.path.join(out_dir, "plots"),
        degree_thresholds=(5, 10, 15), shift_thresholds=(5, 10, 15),
        iou_3d_thresholds=tuple(np.linspace(0, 1, 101)),
        iou_pose_thres=0.1, use_matches_for_pose=True,
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="REAL275 evaluation of the two-branch pose estimator")
    ap.add_argument("--detections", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", default="nocs_output")
    ap.add_argument("--ckpts", default="ckpts")
    ap.add_argument("--dino-ckpt", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no-opt", action="store_true")
    ap.add_argument("--debug", action="store_true",
                    help="per-instance errors and overlay PNGs (eval.py:374-395)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    evaluate_real275(
        args.detections, args.images, args.out, args.ckpts,
        dino_ckpt=args.dino_ckpt, limit=args.limit, run_opt=not args.no_opt,
        debug=args.debug, device=args.device,
    )


if __name__ == "__main__":
    main()
