"""Image-parallel REAL275 evaluation over a torch.distributed process group.

Counterpart of `cppf2_tpu/eval/parallel_eval.py` (geometry branch). Instances
are grouped by (category, crop tier) and flushed in chunks of
n_ranks * `flush_multiple`. Each rank poses its contiguous block of a chunk
as one pose group, as the JAX counterpart vmaps it: one batched preprocess,
one forward of the geometric branch MLP and one batched pose graph over the
block's rows (`driver._pose_group`, the visual branch off), and
`all_gather_object` brings the outputs together. Rank 0 writes the result
pkls and scores them; the other ranks return None.

A rank's block is one program (`eval/programs.py`), as the JAX counterpart
jits its vmapped graph: keyed on ("rows", category, pipeline, the branch
switches, crop tier), the weights' addresses and the block's shapes, so a
short last block has a program of its own, as a new shape retraces the JAX
jit. The crop windows are cut on the device from (B, 2) origins computed on
the host from the masks; the block's one host copy and the
`all_gather_object` stay outside the program.

Randomness: one `InstanceDraws` per instance in serial instance order,
injected or drawn from one torch.Generator seeded by `seed`. Every rank walks
the serial order and keeps the generator's state at each instance, so a rank
redraws exactly its own instances' draws and the result does not depend on
the world size.
"""

from __future__ import annotations

import functools
import glob
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from cppf2_torch.config import CATEGORIES, SYNSET_NAMES, PipelineConfig, get_category
from cppf2_torch.core.geometry import check_pinhole
from cppf2_torch.eval import programs
from cppf2_torch.eval.driver import (
    REAL275_INTRINSICS,
    CategoryModels,
    InstanceDraws,
    _draws_on,
    _finalize_instance,
    _pack,
    _pose_group,
    _stacked,
    draw_instance,
    load_category_models,
)
from cppf2_torch.eval.nocs_map import compute_degree_cm_map
from cppf2_torch.eval.png import read_png16
from cppf2_torch.infer.frontend import auto_crop, crop_origin
from cppf2_torch.parallel.mesh import _require_group, axis_size, make_mesh, rank_device

Lazy = Union[np.ndarray, InstanceDraws, Callable[[], object]]


def _get(x):
    return x() if callable(x) else x


def _rows_program(models: CategoryModels, cat, pipe: PipelineConfig, run_opt: bool,
                  use_visual: bool, use_geo: bool, crop: Optional[int], args) -> programs.Program:
    """The program of a rank's block: `_pose_group` over its (B, ...) inputs
    (depths, masks, (B, 2) origins or None, intrinsics, stacked draws) and
    the packed (B, 22) rows out."""
    def fn(depth, masks, origins, k_t, perm, prio, pose):
        fi, est = _pose_group(depth, masks, origins, perm, prio, pose, k_t, crop, models, cat, pipe,
                              run_opt, use_visual, use_geo)
        return _pack(fi, est)

    key = ("rows", cat.name, pipe, run_opt, use_visual, use_geo, crop,
           programs.weights(models.shot, models.dino))
    return programs.program(models._programs, key, fn, args)


def _make_rows_fn(models: CategoryModels, cat_name: str, pipe: PipelineConfig, mesh, run_opt: bool,
                  use_visual: bool, use_geo: bool, intrinsics: np.ndarray, crop: Optional[int],
                  axis: str):
    """(depths, masks, draws) -> the (N, 22) rows of `driver.PendingInstance`
    for the whole batch, on every rank, posed block by block over `axis`,
    each rank's block as one pose group in one program (`_rows_program`)."""
    _require_group()
    cat = get_category(cat_name)
    dev = rank_device(mesh)
    check_pinhole(np.asarray(intrinsics))
    k_t = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    n_ranks, rank, group = axis_size(mesh, axis), mesh.get_local_rank(axis), mesh.get_group(axis)

    @torch.no_grad()
    def fn(depths: Sequence[Lazy], masks: Sequence[Lazy], draws: Sequence[Lazy]) -> np.ndarray:
        n = len(draws)
        if n == 0 or len(depths) != n or len(masks) != n:
            raise ValueError(f"batch of {len(depths)} depths, {len(masks)} masks, {n} draws")
        per = -(-n // n_ranks)
        lo, hi = min(rank * per, n), min((rank + 1) * per, n)
        block = np.zeros((0, 22), np.float32)
        if hi > lo:
            own = [np.asarray(_get(masks[i]), bool) for i in range(lo, hi)]
            depth = np.stack([np.asarray(_get(depths[i]), np.float32) for i in range(lo, hi)])
            origins = None
            if crop is not None:
                origins = torch.as_tensor(np.asarray([crop_origin(m, m.shape, crop) for m in own],
                                                     np.int32), device=dev)
            args = (torch.as_tensor(depth, device=dev), torch.as_tensor(np.stack(own), device=dev),
                    origins, k_t,
                    *_stacked([_draws_on(_get(draws[i]), dev) for i in range(lo, hi)]))
            rows = _rows_program(models, cat, pipe, run_opt, use_visual, use_geo, crop, args)(*args)
            block = rows.cpu().numpy()   # one host copy for the rank's block
        blocks: List = [None] * n_ranks
        dist.all_gather_object(blocks, block, group=group)
        return np.concatenate(blocks)

    return fn


def make_batched_instance_fn(
    models: CategoryModels,
    cat_name: str,
    pipe: PipelineConfig,
    mesh,
    run_opt: bool = True,
    use_visual: bool = False,
    use_geo: bool = True,
    intrinsics: np.ndarray = REAL275_INTRINSICS,
    crop: Optional[int] = None,
    axis: str = "data",
):
    """(depths, masks, draws) -> pose outputs of the whole batch, posed
    block by block over the `axis` ranks.

    depths (N, H, W) meters, masks (N, H, W) bool and draws (N InstanceDraws,
    each sized for `window_shape((H, W), crop)`) are the global batch; any
    entry may be a zero-argument callable, called only on the rank that poses
    it. Each rank's block is one pose group: one batched preprocess with
    `crop`, then one batched ensemble for the block (zero descriptors when
    the visual branch is on, as in the JAX counterpart). Returns on every
    rank, as numpy arrays:
    (rotation (N, 3, 3), translation (N, 3), scale (N, 3), scale_norm (N,),
    loss (N,), count (N,), extent (N,)), the last two from the frontend.
    """
    rows_fn = _make_rows_fn(models, cat_name, pipe, mesh, run_opt, use_visual, use_geo, intrinsics,
                            crop, axis)

    def fn(depths: Sequence[Lazy], masks: Sequence[Lazy], draws: Sequence[Lazy]):
        r = rows_fn(depths, masks, draws)
        return (r[:, 4:13].reshape(-1, 3, 3), r[:, 13:16], r[:, 16:19], r[:, 19], r[:, 20],
                r[:, 0].astype(np.int32), r[:, 1:4].max(axis=1))

    return fn


def _redraw(state: torch.Tensor, mask: np.ndarray, cat_name: str, pipe: PipelineConfig,
            dev) -> InstanceDraws:
    gen = torch.Generator(device=dev)
    gen.set_state(state)
    return draw_instance(mask.shape, mask, cat_name, pipe, dev, gen)


def evaluate_real275_parallel(
    detections_dir: str,
    image_root: str,
    out_dir: str,
    ckpt_root: Optional[str] = "ckpts",
    pipe: Optional[PipelineConfig] = None,
    limit: Optional[int] = None,
    run_opt: bool = True,
    seed: int = 0,
    n_devices: Optional[int] = None,
    flush_multiple: int = 4,
    draws: Optional[Sequence[InstanceDraws]] = None,
    device="cuda",
    models: Optional[Dict[str, CategoryModels]] = None,
):
    """Rank-parallel REAL275 evaluation (geometry branch) on the initialized
    process group, one rank per device.

    Produces the result pkls and AP tables of the serial protocol; `draws`,
    when given, holds one InstanceDraws per instance of a known category in
    serial order (each sized for the instance's `auto_crop` window). Returns
    (iou_aps, pose_aps) on rank 0 and None on every other rank. `models`
    hands in loaded branch models (on the rank's device), as
    `evaluate_real275` takes them; their block programs are kept on them, so
    a second run replays what the first captured. Categories it lacks are
    loaded from `ckpt_root`.
    """
    pipe = pipe or PipelineConfig()
    pkls = sorted(glob.glob(os.path.join(detections_dir, "results_*.pkl")))
    if not pkls:
        raise FileNotFoundError(f"no detection pkls under {detections_dir}")
    if limit:
        pkls = pkls[:limit]

    mesh = make_mesh(n_devices, device=device)
    n_dev = axis_size(mesh, "data")
    dev = rank_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(seed) if draws is None else None

    # pass 1: load results, fix each instance's draws in serial order, group
    # the work by (category, crop tier)
    results: List[Dict] = []
    paths: List[str] = []
    depth_paths: List[str] = []
    work: Dict = {(c, cr): [] for c in CATEGORIES for cr in (256, 320, None)}
    serial = 0
    for pkl_path in pkls:
        with open(pkl_path, "rb") as f:
            res = pickle.load(f)
        if "gt_handle_visibility" not in res:
            res["gt_handle_visibility"] = np.ones_like(res["gt_class_ids"])
        image_path = os.path.join(image_root, os.path.relpath(res["image_path"], "data/real/test"))
        n_inst = len(res["pred_class_ids"])
        res["pred_RTs"] = np.stack([np.eye(4) for _ in range(n_inst)])
        res["pred_scales"] = np.ones((n_inst, 3))
        img_idx = len(results)
        results.append(res)
        paths.append(pkl_path)
        depth_paths.append(image_path + "_depth.png")
        for i in range(n_inst):
            cat_name = SYNSET_NAMES[int(res["pred_class_ids"][i])]
            if cat_name not in CATEGORIES:
                continue
            mask = res["pred_masks"][:, :, i].astype(bool)
            if draws is None:
                # keep the state at this instance, then step past its draws
                src = functools.partial(_redraw, gen.get_state(), mask, cat_name, pipe, dev)
                draw_instance(mask.shape, mask, cat_name, pipe, dev, gen)
            elif serial < len(draws):
                src = draws[serial]
            else:
                raise ValueError(f"{len(draws)} injected draws for more instances")
            serial += 1
            work[(cat_name, auto_crop(mask))].append((img_idx, i, mask, src))
    if draws is not None and len(draws) != serial:
        raise ValueError(f"{len(draws)} injected draws for {serial} instances")

    # pass 2: per (category, crop) group, flush chunks over the ranks
    models = dict(models or {})
    for (cat_name, crop), items in work.items():
        if not items:
            continue
        if cat_name not in models:
            models.update(load_category_models(ckpt_root, [cat_name], device=dev))
        fn = _make_rows_fn(models[cat_name], cat_name, pipe, mesh, run_opt, False, True,
                           REAL275_INTRINSICS, crop, "data")
        bsz = n_dev * flush_multiple
        for lo in range(0, len(items), bsz):
            chunk = items[lo:lo + bsz]

            @functools.lru_cache(maxsize=None)
            def depth(idx):
                return read_png16(depth_paths[idx]).astype(np.float32) / 1000.0

            rows = fn([functools.partial(depth, c[0]) for c in chunk], [c[2] for c in chunk],
                      [c[3] for c in chunk])
            for row, (img_idx, inst_idx, _, _) in zip(rows, chunk):
                out = _finalize_instance(CATEGORIES[cat_name].res, row)
                if out is not None:
                    res = results[img_idx]
                    res["pred_RTs"][inst_idx], res["pred_scales"][inst_idx], _ = out

    # pass 3: rank 0 writes the pkls and scores them
    if dist.get_rank() != 0:
        return None
    os.makedirs(out_dir, exist_ok=True)
    for res, pkl_path in zip(results, paths):
        with open(os.path.join(out_dir, os.path.basename(pkl_path)), "wb") as f:
            pickle.dump(res, f)
    return compute_degree_cm_map(
        results, SYNSET_NAMES, os.path.join(out_dir, "plots"),
        degree_thresholds=(5, 10, 15), shift_thresholds=(5, 10, 15),
        iou_3d_thresholds=tuple(np.linspace(0, 1, 101)),
        iou_pose_thres=0.1, use_matches_for_pose=True,
    )
