"""Frame frontend: crop window, backprojection, voxel downsample, SHOT, the
host bbox-square crop and the host mask dilation.

Counterpart of `cppf2_tpu/infer/frontend.py::preprocess_frame` (reference
eval.py:185-216) and of its host helpers `mask_bbox` / `auto_crop` /
`resize_crop` (reference dataset.py:322-337) / `dilate_mask` (reference
utils/util.py:83-101). The
crop window is a slice, so its origin must be known on the host: a caller that
holds the mask as a numpy array computes it there (`crop_origin`) and passes
it in, and nothing is read back from the device; without it the origin is
computed on the device and read back once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cppf2_torch.core.downsample import voxel_downsample
from cppf2_torch.core.geometry import backproject_masked
from cppf2_torch.ops.shot import compute_shot_features
from cppf2_torch.utils.imgproc import connected_components, convex_hull, dilate, fill_convex_poly, fma32


def resize_crop_transform(bbox, out_size: int = 256, padding: float = 0.0) -> np.ndarray:
    """Square crop transform for a bbox (left, top, right, bottom): the 3x3
    matrix mapping crop-pixel homogeneous coordinates to image pixels
    (reference: dataset.py:334-336); invert it to map image points into the
    crop."""
    left, top, right, bottom = bbox
    size = max(right - left, bottom - top) * (1.0 + padding)
    cx, cy = (right + left) / 2.0, (bottom + top) / 2.0
    s = size / out_size
    return np.array(
        [[s, 0.0, cx - s * out_size / 2.0],
         [0.0, s, cy - s * out_size / 2.0],
         [0.0, 0.0, 1.0]],
        np.float64,
    )


# Columns per block of cv2.warpAffine's vectorized source-coordinate loop in
# the OpenCV 5.0.0 x86-64 build whose output `resize_crop` reproduces: it
# computes the first (out_size - out_size % 16) columns with FMA, the rest in
# its scalar tail. The width is a property of that binary's vectorization,
# not of warpAffine's definition: a build for another SIMD width moves the
# boundary, and the tail columns then differ from cv2's in the last ulp of
# the source coordinate (test_torch_frontend's cv2 parity test shows it).
_CV_WARP_BLOCK = 16


def _warp_scale_translate(img: np.ndarray, m: np.ndarray, out_size: int) -> np.ndarray:
    """`cv2.warpAffine(img, m, (out_size, out_size), flags=INTER_LINEAR)`
    with its default BORDER_CONSTANT 0, for float32 images and a scale +
    translate `m` (the image -> crop map), reproducing OpenCV 5's arithmetic:
    the inverse (crop -> image) map in float64 as cv2 inverts it, cast to
    float32; source rows M4 * y + M5 in two float32 roundings; source columns
    fma(M0, x, M2) in float32, except the row's last (out_size % _CV_WARP_BLOCK) columns,
    which cv2's scalar tail computes as M0 * x + M2; bilinear taps, zero
    outside the image, combined as fma(ay, v1 - v0, v0) over
    v = fma(ax, p1 - p0, p0). (OpenCV 4 before 4.11 quantized the source
    coordinates to 1/32 pixel instead; the JAX package's `resize_crop` calls
    whichever cv2 is installed.)"""
    a, b, c, d, e, f = (float(x) for x in np.asarray(m, np.float64).ravel())
    if b != 0.0 or d != 0.0:
        raise ValueError("only scale + translate maps (resize_crop_transform's) are supported")
    det = a * e
    det = 1.0 / det if det != 0 else 0.0
    m0, m4 = e * det, a * det
    m2, m5 = -m0 * c, -m4 * f
    f32 = np.float32
    xs = np.arange(out_size, dtype=f32)
    src_x = fma32(f32(m0), xs, f32(m2))
    vec = out_size - out_size % _CV_WARP_BLOCK
    src_x[vec:] = f32(m0) * xs[vec:] + f32(m2)
    src_y = f32(m4) * xs + f32(m5)
    x0 = np.floor(src_x).astype(np.int64)
    y0 = np.floor(src_y).astype(np.int64)
    ax = (src_x - x0).astype(f32)[None, :, None]
    ay = (src_y - y0).astype(f32)[:, None, None]
    src = img if img.ndim == 3 else img[..., None]
    h, w = src.shape[:2]

    def tap(yy, xx):
        ok = ((yy >= 0) & (yy < h))[:, None] & ((xx >= 0) & (xx < w))[None, :]
        v = src[np.clip(yy, 0, h - 1)[:, None], np.clip(xx, 0, w - 1)[None, :]]
        return np.where(ok[..., None], v, f32(0))

    p00, p01, p10, p11 = tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    v0 = fma32(ax, p01 - p00, p00)
    v1 = fma32(ax, p11 - p10, p10)
    out = fma32(ay, v1 - v0, v0)
    return out if img.ndim == 3 else out[..., 0]


def resize_crop(img: np.ndarray, bbox=None, out_size: int = 256, padding: float = 0.0):
    """Crop a host image to a square around `bbox` (left, top, right,
    bottom; the nonzero pixels' bbox when None) and resize it to (out_size,
    out_size) with bilinear taps, zero outside the image. Returns (crop
    float32, transform) with transform as in `resize_crop_transform`. The
    values are those of the JAX package's cv2 path, without cv2."""
    if bbox is None:
        ys, xs = np.where(img.sum(-1) if img.ndim == 3 else img)
        bbox = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    t = resize_crop_transform(bbox, out_size, padding)
    # the image -> crop map, as the reference hands it to cv2.warpAffine
    return _warp_scale_translate(img.astype(np.float32), np.linalg.inv(t)[:2], out_size), t


def mask_bbox(mask: np.ndarray):
    """(left, top, right, bottom) of a host mask, or None when empty."""
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return None
    return (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)


def dilate_mask(mask: np.ndarray, size: int = 5, largest_comp: bool = False) -> np.ndarray:
    """Convex-hull fill and rectangular dilation of an instance mask
    (reference utils/util.py:83-101), optionally keeping the largest
    8-connected component first (the first of equal ones): the JAX
    package's cv2 calls through `utils/imgproc.py`, pixel for pixel."""
    m = np.asarray(mask).astype(np.uint8)
    if largest_comp:
        n, labels = connected_components(m, connectivity=8)
        if n > 1:
            sizes = np.bincount(labels.ravel(), minlength=n)[1:]
            m = (labels == 1 + int(np.argmax(sizes))).astype(np.uint8)
    ys, xs = np.where(m)
    if len(xs) == 0:
        return m.astype(bool)
    fill_convex_poly(m, convex_hull(np.stack([xs, ys], -1)), 1)
    return dilate(m, size).astype(bool)


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


def crop_origin(mask: np.ndarray, hw: Tuple[int, int], crop: int) -> Tuple[int, int]:
    """(y0, x0) of the crop x crop window centered on a host mask's bbox and
    clamped into the (h, w) frame: the integer arithmetic `preprocess_frame`
    does on the device when it is given no origin (an empty mask centers the
    window on the frame)."""
    h, w = hw
    rows = np.flatnonzero(np.any(mask, axis=1))
    cols = np.flatnonzero(np.any(mask, axis=0))
    y_min, y_max = (int(rows[0]), int(rows[-1])) if rows.size else (h, -1)
    x_min, x_max = (int(cols[0]), int(cols[-1])) if cols.size else (w, -1)
    cy = min(max((y_min + y_max) // 2, 0), h - 1)
    cx = min(max((x_min + x_max) // 2, 0), w - 1)
    return (min(max(cy - crop // 2, 0), max(h - crop, 0)),
            min(max(cx - crop // 2, 0), max(w - crop, 0)))


class FrameInputs(NamedTuple):
    pc: torch.Tensor         # (n_max, 3)
    valid: torch.Tensor      # (n_max,)
    count: torch.Tensor      # ()
    shot: torch.Tensor       # (n_max, 352)
    normal: torch.Tensor     # (n_max, 3)
    pixel_yx: torch.Tensor   # (n_max, 2) image pixels per point
    window_yx: torch.Tensor  # (2,) crop-window origin


def _crop_origin_on_device(mask: torch.Tensor, c: int) -> Tuple[int, int]:
    """`crop_origin` for a mask that lies on the device: one read back."""
    h, w = mask.shape
    dev = mask.device
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
    return y0, x0


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
    origin: Optional[Tuple[int, int]] = None,
) -> FrameInputs:
    """depth + mask -> padded downsampled cloud + SHOT features.

    With `crop`, a crop x crop window centered on the mask's bbox is cut out
    before backprojection (the caller picks `crop` with `auto_crop`). The
    voxel draws are sized for the window: `window_shape(depth.shape, crop)`
    pixels. `origin` is the window's (y0, x0) from `crop_origin` on the host
    mask; given it, this function reads nothing back from the device.
    `intrinsics` that already lie on the device are not validated here (that
    would be a read back): they must have passed `check_pinhole` on the host.
    """
    dev = depth.device
    if crop is not None:
        h, w = depth.shape
        y0, x0 = origin if origin is not None else _crop_origin_on_device(mask, crop)
        ch, cw = window_shape((h, w), crop)
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
