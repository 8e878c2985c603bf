"""In-the-wild single-object pose demo over RGB-D frames.

Counterpart of `cppf2_tpu/demo.py` (the reference's demo.py:60-317): per
frame, mask -> host crop -> DINOv2 descriptors (kernel K1) -> cloud ->
two-branch ensemble pose (center votes through kernel K2) -> overlay PNG and
`_pose.npz`. The reference takes its masks from a torchvision Mask R-CNN
(demo.py:95-115), whose weights are not here, so masks come from files
(`--mask`) or from the geometric instance proposer (`--auto-mask`,
`infer/segmenter.py`).

Usage (the reference's example_data layout: rgb.png, depth.png in mm,
mask.png), on the card or, with `--device cpu`, on the CPU:

    python -m cppf2_torch.demo --rgb rgb.png --depth depth.png --mask mask.png \\
        --category mug --ckpts ckpts_r3 --dino-ckpt dinov2_vitl14.pth --out predictions/

Images are PNGs, read and written without cv2 (`eval/png.py`): a JPEG frame
raises, since there is no JPEG decoder here, and so does `--video-out`,
which needs cv2's mp4 encoder; the per-frame overlay PNGs are the output.
Random draws come from one `torch.Generator` seeded by `--seed`, frame after
frame, where the JAX demo splits `jax.random.key(0)`.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np
import torch

from cppf2_torch.config import PipelineConfig
from cppf2_torch.device import resolve_device
from cppf2_torch.eval.driver import (
    CategoryModels,
    InstanceDraws,
    dispatch_instance,
    fetch_instances,
    load_category_models,
    load_dino_extractor,
)
from cppf2_torch.eval.png import read_png8, read_png16, read_png_rgb8, write_png_rgb8
from cppf2_torch.infer.segmenter import backproject_grid, propose_instances, resolve_scale_range
from cppf2_torch.utils.imgproc import connected_components
from cppf2_torch.utils.viz import draw_pose_overlay

# intrinsics of the reference's example capture (the NOCS camera)
DEFAULT_INTRINSICS = np.array(
    [[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32
)


def depth_band_mask(depth_m: np.ndarray, lo: float = 0.2, hi: float = 1.5) -> np.ndarray:
    """Last-resort segmenter: the largest 8-connected component in a depth
    band (the first of equal ones)."""
    band = ((depth_m > lo) & (depth_m < hi)).astype(np.uint8)
    n, labels = connected_components(band, connectivity=8)
    if n <= 1:
        return band.astype(bool)
    sizes = np.bincount(labels.ravel(), minlength=n)[1:]
    return labels == 1 + int(np.argmax(sizes))


def auto_instance_mask(depth_m, intrinsics, category=None, scale_range=None, mask_index=0,
                       verbose=False, prev_mask=None):
    """Segment the frame with the geometric instance proposer and pick one
    proposal: `mask_index` among the ranked ones, or, given the previous
    frame's pick `prev_mask`, the proposal that overlaps it best (IoU above
    0.2), so that the posed object keeps its identity across frames when
    two similar objects swap ranks. Without any proposal, the depth-band
    mask.

    Returns (mask, from_proposal): `from_proposal` is False for the
    depth-band mask, which callers must not keep as `prev_mask` (it is often
    the support surface)."""
    scale_range = resolve_scale_range(category, scale_range)
    props = propose_instances(depth_m, intrinsics, scale_range)
    if not props:
        return depth_band_mask(depth_m), False
    pick = min(mask_index, len(props) - 1)
    if pick != mask_index:
        print(f"[demo] --mask-index {mask_index} out of range: only "
              f"{len(props)} proposal(s) this frame, using {pick}")
    if prev_mask is not None:
        ious = [(m & prev_mask).sum() / max((m | prev_mask).sum(), 1) for m in props]
        best = int(np.argmax(ious))
        if ious[best] > 0.2:
            pick = best
    if verbose:
        pts = backproject_grid(depth_m, intrinsics)
        for i, m in enumerate(props):
            p = pts[m]
            ext = float((p.max(0) - p.min(0)).max())
            tag = " <- selected" if i == pick else ""
            print(f"[demo] proposal {i}: {int(m.sum())} px, "
                  f"max extent {ext * 100:.1f} cm, "
                  f"median depth {float(np.median(p[:, 2])):.2f} m{tag}")
    return props[pick], True


def run_frame(rgb, depth_m, mask, category, models: CategoryModels, pipe: PipelineConfig,
              intrinsics=DEFAULT_INTRINSICS, generator: Optional[torch.Generator] = None,
              dino_extractor=None, run_opt: bool = True, device="cuda",
              draws: Optional[InstanceDraws] = None):
    """Pose one frame's instance: (overlay RGB, RT, scales), or (rgb, None,
    None) for a degenerate input. The draws come from `generator` unless
    `draws` is given; with `dino_extractor` the visual branch competes."""
    out = fetch_instances([dispatch_instance(
        rgb, depth_m, mask, intrinsics, models, category, pipe, generator=generator,
        device=device, draws=draws, run_opt=run_opt, dino_extractor=dino_extractor)])[0]
    if out is None:
        return rgb, None, None
    rt, scales, _ = out
    return draw_pose_overlay(rgb, rt, scales, intrinsics), rt, scales


def _read_depth(path: str, depth_scale: float) -> np.ndarray:
    """A depth frame: .npy in metres (the reference's record3d capture,
    demo.py:98) or a 16-bit PNG divided by `depth_scale`."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return read_png16(path).astype(np.float32) / depth_scale


def _frame_paths(args):
    """(RGB paths, depth paths): explicit files, or a sorted capture
    directory with a [start:end] window, like the reference's
    `sorted(glob)[410:700]`."""
    if not args.rgb_dir:
        if not (args.rgb and args.depth):
            raise SystemExit("provide --rgb/--depth or --rgb-dir")
        return args.rgb, args.depth
    rgb_paths = sorted(p for p in glob.glob(os.path.join(args.rgb_dir, "*"))
                       if p.lower().endswith((".png", ".jpg", ".jpeg")))[args.start:args.end]
    ddir = args.depth_dir or args.rgb_dir.replace("rgb", "depth")
    if args.depth_dir is None and ddir == args.rgb_dir:
        # without 'rgb' in the path the substitution is a no-op, and the RGB
        # PNGs would be read as depth frames
        raise SystemExit(f"--depth-dir required: cannot derive a depth dir from "
                         f"{args.rgb_dir!r} (no 'rgb' in the path)")
    depth_paths = []
    for p in rgb_paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        for ext in (".npy", ".png"):
            cand = os.path.join(ddir, stem + ext)
            if os.path.exists(cand):
                depth_paths.append(cand)
                break
        else:
            raise SystemExit(f"no depth frame for {stem} under {ddir}")
    return rgb_paths, depth_paths


def main(argv=None):
    ap = argparse.ArgumentParser(description="Category-level 9-DoF pose of one object in RGB-D frames")
    ap.add_argument("--rgb", nargs="+", default=None, help="RGB frame files (or use --rgb-dir)")
    ap.add_argument("--depth", nargs="+", default=None,
                    help="depth frames: 16-bit png (mm) or .npy (meters)")
    ap.add_argument("--rgb-dir", default=None,
                    help="directory of RGB frames, processed sorted (the reference's record3d "
                         "capture layout, demo.py:96-98)")
    ap.add_argument("--depth-dir", default=None, help="directory of depth frames matching --rgb-dir stems")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--video-out", default=None,
                    help="an mp4 of the overlays: needs cv2's encoder, which this package does not "
                         "use, so it raises; the overlay PNGs are the output")
    ap.add_argument("--fps", type=float, default=15.0)
    ap.add_argument("--mask", nargs="*", default=None)
    ap.add_argument("--auto-mask", action="store_true",
                    help="segment with the geometric instance proposer (depth edges + support-plane "
                         "removal + category scale prior): no mask files needed")
    ap.add_argument("--mask-index", type=int, default=0,
                    help="with --auto-mask: which ranked proposal to pose (the first frame prints "
                         "the ranked list)")
    ap.add_argument("--intrinsics", default=None, help=".npy 3x3 camera matrix (default: NOCS camera)")
    ap.add_argument("--category", required=True)
    ap.add_argument("--ckpts", default="ckpts")
    ap.add_argument("--dino-ckpt", default=None, help="official DINOv2 ViT-L/14 .pth")
    ap.add_argument("--depth-scale", type=float, default=1000.0)
    ap.add_argument("--out", default="predictions")
    ap.add_argument("--no-opt", action="store_true")
    ap.add_argument("--restarts", type=int, default=1, help="best-of-N pose restarts by reconstruction loss")
    ap.add_argument("--n-points", type=int, default=None)
    ap.add_argument("--num-pairs", type=int, default=None)
    ap.add_argument("--angle-tol", type=float, default=None,
                    help="rotation-vote tolerance in degrees (coarser = faster)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0, help="seed of the torch.Generator of the draws")
    args = ap.parse_args(argv)

    if args.video_out:
        raise SystemExit("--video-out needs cv2.VideoWriter's mp4 encoder, which this package does "
                         "not use; the per-frame overlay PNGs under --out are the output")
    rgb_paths, depth_paths = _frame_paths(args)
    jpegs = [p for p in rgb_paths if p.lower().endswith((".jpg", ".jpeg"))]
    if jpegs:
        raise SystemExit(f"{jpegs[0]}: JPEG frames need a JPEG decoder (cv2 or PIL), which this "
                         "package does not use; convert the frames to PNG")
    if not (args.mask or args.auto_mask):
        raise SystemExit("provide --mask files or --auto-mask")

    dev = resolve_device(args.device)
    models = load_category_models(args.ckpts, [args.category], device=dev)[args.category]
    over = {k: v for k, v in (("n_points", args.n_points), ("num_pairs", args.num_pairs),
                              ("angle_tol_deg", args.angle_tol)) if v is not None}
    pipe = PipelineConfig(restarts=args.restarts, **over)
    dino_extractor = load_dino_extractor(args.dino_ckpt, dev) if args.dino_ckpt else None
    intrinsics = (np.load(args.intrinsics).astype(np.float32) if args.intrinsics
                  else DEFAULT_INTRINSICS)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    os.makedirs(args.out, exist_ok=True)
    prev_mask = None
    for i, (rgb_p, depth_p) in enumerate(zip(rgb_paths, depth_paths)):
        rgb = read_png_rgb8(rgb_p)
        depth = _read_depth(depth_p, args.depth_scale)
        if args.mask:
            m = read_png8(args.mask[i])
            mask = (m > 0) if m.ndim == 2 else (m.sum(-1) > 0)
        else:
            mask, from_proposal = auto_instance_mask(
                depth, intrinsics, category=args.category, mask_index=args.mask_index,
                verbose=(i == 0), prev_mask=prev_mask)
            # only a real proposal re-seeds the identity tracking
            if from_proposal:
                prev_mask = mask
        overlay, rt, scales = run_frame(rgb, depth, mask, args.category, models, pipe,
                                        intrinsics=intrinsics, generator=gen,
                                        dino_extractor=dino_extractor, run_opt=not args.no_opt,
                                        device=dev)
        out_p = os.path.join(args.out, f"{i:04d}.png")
        write_png_rgb8(out_p, overlay)
        if rt is not None:
            np.savez(out_p.replace(".png", "_pose.npz"), RT=rt, scales=scales)
            print(f"[demo] {rgb_p}: T={rt[:3, 3]} -> {out_p}")
        else:
            print(f"[demo] {rgb_p}: no pose (degenerate input)")


if __name__ == "__main__":
    main()
