"""Synthetic frames: pose sampling -> render on the device -> features.

Counterpart of `cppf2_tpu/data/synthetic.py`, the analog of the reference's
`ShapeNetDirectDataset.get_item_impl` (dataset.py:202-319): the host draws a
mesh, a pose and a scale; the device renders the depth map, backprojects,
voxel-downsamples, computes SHOT features and the canonical cloud; one copy
back to the host per attempt carries what the retry and symmetry logic
needs.

The device part of an attempt (render, cloud, features, canonical frame) is
a program (`eval/programs.py`), as the JAX package jits `_device_frame` and
`_device_frame_raster`: one per renderer, static arguments (res, n_max,
height, width, shot_k), draws (lighting and albedo drawn or not) and input
shapes, captured as a CUDA graph on its first call on the card and replayed
after; raster meshes are padded to buckets, so there is one raster program
per bucket. The scale travels as a 0-d tensor, not as a key.

The numpy stream is the reference's, draw for draw: the same seed gives the
same meshes, poses and scales, and `SyntheticFrameGenerator.rng` is in the
same state after N frames. The two integers the reference turns into
`jax.random` keys for each attempt are passed to `draw_fn`, which makes the
device-side draws (`FrameDraws`). The default, `threefry_draws`, makes the
reference's own `jax.random` numbers from them (`models/jax_random.py`), so
a seed gives the JAX package's frames, the gray image included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cppf2_torch.config import CategoryConfig
from cppf2_torch.core.downsample import voxel_downsample
from cppf2_torch.core.geometry import backproject_masked, check_pinhole, map_sym
from cppf2_torch.data.render import (
    NOCS_INTRINSICS,
    AlbedoDraw,
    default_lighting,
    procedural_albedo,
    raster_render_depth,
    sample_lighting,
    splat_render_depth,
)
from cppf2_torch.data.shapes import make_category_mesh, sample_surface, subdivide_mesh
from cppf2_torch.device import device_constant, resolve_device
from cppf2_torch.eval import programs
from cppf2_torch.models import jax_random as jr
from cppf2_torch.ops.shot import compute_shot_features

_FLIP = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)  # backproject's x/y flip
_FRAME_PROGRAMS: Dict = {}   # the frame programs, by renderer, static arguments and inputs


class SynthFrame(NamedTuple):
    pc: torch.Tensor           # (n_max, 3) padded downsampled cloud
    pc_canon: torch.Tensor     # (n_max, 3) canonical coordinates (max-extent normalized)
    shot: torch.Tensor         # (n_max, 352)
    normal: torch.Tensor       # (n_max, 3)
    valid: torch.Tensor        # (n_max,) bool
    count: torch.Tensor        # () number of valid points
    bound: torch.Tensor        # (3,) metric bbox extents
    rotation: torch.Tensor     # (3, 3) ground-truth rotation (cloud frame)
    translation: torch.Tensor  # (3,) ground-truth translation (cloud frame)
    scale_norm: torch.Tensor   # () = bound.max()
    gray: torch.Tensor         # (H, W) lambertian render (visual branch input)
    depth: torch.Tensor        # (H, W)
    pixel_yx: torch.Tensor     # (n_max, 2) pixel of each cloud point


class FrameDraws(NamedTuple):
    """The device-side random numbers of one render attempt."""
    perm: torch.Tensor    # (H*W,) permutation for voxel_downsample
    prio: torch.Tensor    # (H*W,) uniform priorities for voxel_downsample
    lighting: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # direction, intensity, ambient
    albedo: Optional[AlbedoDraw]   # the texture's numbers, or None


def threefry_draws(frame_seed: int, light_seed: Optional[int], n_pixels: int, texture: bool,
                   device) -> FrameDraws:
    """The default `draw_fn`: the JAX package's draws from the same two
    integers (`models/jax_random.py`). key(frame_seed) gives
    `voxel_downsample`'s permutation and its fold_in(key, 1) priorities;
    key(light_seed), split in a lighting and an albedo key, gives
    `sample_lighting`'s draws (split in 3) and `procedural_albedo`'s (split
    in 4). Uniforms and the permutation equal JAX's to the bit, normals to
    a few ulps."""
    key = jr.key(frame_seed)
    perm = jr.permutation(key, n_pixels, device)
    prio = jr.uniform(jr.fold_in(key, 1), (n_pixels,), device=device)
    if light_seed is None:
        return FrameDraws(perm, prio, None, None)
    lk, ak = jr.split(jr.key(light_seed))
    k1, k2, k3 = jr.split(lk, 3)
    lighting = (jr.normal(k1, (3,), device), jr.uniform(k2, (), 0.5, 1.0, device),
                jr.uniform(k3, (), 0.05, 0.3, device))
    if not texture:
        return FrameDraws(perm, prio, lighting, None)
    kd, kf, kp, ka = jr.split(ak, 4)
    albedo = AlbedoDraw(jr.normal(kd, (4, 3), device), jr.uniform(kf, (4,), 1.5, 3.0, device),
                        jr.uniform(kp, (4,), 0.0, 2 * math.pi, device),
                        jr.uniform(ka, (4,), 0.3, 1.0, device))
    return FrameDraws(perm, prio, lighting, albedo)


def to_host(frame: SynthFrame, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """The named fields of a frame as numpy arrays, through one
    device-to-host copy (integer and bool fields travel as float32, exact for
    counts and pixel indices; they come back as int32 and bool)."""
    parts = [getattr(frame, n) for n in names]
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()
    out, at = {}, 0
    for name, p in zip(names, parts):
        x = flat[at:at + p.numel()].reshape(p.shape)
        at += p.numel()
        if p.dtype == torch.bool:
            x = x != 0
        elif not p.dtype.is_floating_point:
            x = x.astype(np.int32)
        out[name] = x
    return out


def _frame_from_render(depth, gray, r_obj, t_obj, scale, bound_canon, intrinsics, res, draws,
                       n_max, shot_k) -> SynthFrame:
    """Shared tail of the frame functions: rendered (depth, gray) -> padded
    cloud + features + canonical frame (the pc_canon invariant lives here and
    only here)."""
    dev = depth.device
    pts_all, pixel_yx, valid_all = backproject_masked(depth, intrinsics, depth > 0)
    ds = voxel_downsample(pts_all, valid_all, res, n_max, draws.perm, draws.prio)
    pc = torch.where(ds.valid[:, None], pts_all[ds.indices], torch.zeros((), device=dev))
    pix = torch.where(ds.valid[:, None], pixel_yx[ds.indices],
                      torch.zeros((), dtype=pixel_yx.dtype, device=dev))
    shot, normal = compute_shot_features(pc, ds.valid, res * 10, k=shot_k)
    flip = device_constant("synthetic.flip", lambda: torch.from_numpy(_FLIP), dev)
    rot = flip @ r_obj
    trans = flip @ t_obj
    bound = bound_canon * scale
    scale_norm = torch.max(bound)
    pc_canon = ((pc - trans) @ rot) / scale_norm
    pc_canon = torch.where(ds.valid[:, None], pc_canon, torch.zeros((), device=dev))
    return SynthFrame(pc, pc_canon, shot, normal, ds.valid, torch.clamp(ds.count, max=n_max), bound,
                      rot, trans, scale_norm, gray, depth, pix)


def _lighting(draws: FrameDraws, device):
    return default_lighting(device) if draws.lighting is None else sample_lighting(*draws.lighting)


def splat_frame(samples, sample_normals, r_obj, t_obj, scale, bound_canon, intrinsics, res, draws,
                n_max=8192, height=480, width=640, shot_k=64) -> SynthFrame:
    """One frame through the point-splat renderer (per-frame lighting and,
    when drawn, the value-noise albedo at the surface samples)."""
    albedo = None if draws.albedo is None else procedural_albedo(samples, draws.albedo)
    depth, gray = splat_render_depth(samples, sample_normals, r_obj, t_obj, scale, intrinsics,
                                     height, width, lighting=_lighting(draws, samples.device),
                                     albedo=albedo)
    return _frame_from_render(depth, gray, r_obj, t_obj, scale, bound_canon, intrinsics, res, draws,
                              n_max, shot_k)


def raster_frame(verts, faces, r_obj, t_obj, scale, bound_canon, intrinsics, res, draws,
                 n_max=8192, height=480, width=640, shot_k=64) -> SynthFrame:
    """The triangle-raster variant of `splat_frame` (hole-free at close range)."""
    depth, gray = raster_render_depth(verts, faces, r_obj, t_obj, scale, intrinsics, height, width,
                                      lighting=_lighting(draws, verts.device), albedo=draws.albedo)
    return _frame_from_render(depth, gray, r_obj, t_obj, scale, bound_canon, intrinsics, res, draws,
                              n_max, shot_k)


def frame_program(renderer: str, args, res: float, n_max: int, height: int, width: int,
                  shot_k: int) -> SynthFrame:
    """`splat_frame` (args: samples, sample normals, ...) or `raster_frame`
    (args: verts, faces, ...) through its program; the rest of `args` is
    (r_obj, t_obj, scale as a 0-d tensor, bound_canon, intrinsics, draws)."""
    render = splat_frame if renderer == "splat" else raster_frame

    def body(a, b, r_obj, t_obj, scale, bound_canon, intrinsics, draws):
        return render(a, b, r_obj, t_obj, scale, bound_canon, intrinsics, res, draws, n_max=n_max,
                      height=height, width=width, shot_k=shot_k)

    key = ("synthetic frame", renderer, res, n_max, height, width, shot_k)
    return programs.program(_FRAME_PROGRAMS, key, body, args)(*args)


def _pad_mesh(verts: np.ndarray, faces: np.ndarray, v_mult=1024, f_mult=2048):
    """Pad mesh buffers to multiples of (v_mult, f_mult), as the reference
    does, so the raster pass sees the same buffers. Padded faces are (0, 0,
    0): degenerate, skipped by the raster pass."""
    vp = -len(verts) % v_mult
    fp = -len(faces) % f_mult
    verts = np.pad(verts, ((0, vp), (0, 0)))
    faces = np.pad(faces, ((0, fp), (0, 0)))
    return verts.astype(np.float32), faces.astype(np.int32)


_FETCHED = ("count", "pc", "pc_canon", "valid", "rotation", "translation", "scale_norm")


@dataclasses.dataclass
class SyntheticFrameGenerator:
    """Streams randomized synthetic frames for a category.

    Pose distribution follows the reference (dataset.py:216-226): either the
    NOCS-subset rotation — yaw U(0, 2pi) . pitch U(10°, 80°) . roll U(±20°) —
    or full SO(3); translation x, y ~ U(±0.3), z ~ U(0.6, 2.0) in front of the
    camera; metric scale from the category's range (dataset.py:165-172).
    """

    cat: CategoryConfig
    n_max: int = 8192
    full_rot: bool = False
    surface_samples: int = 250000
    height: int = 480
    width: int = 640
    shot_k: int = 64
    seed: int = 0
    min_points: int = 100    # retry threshold (dataset.py:275-276)
    randomize_lighting: bool = True   # per-frame light dir/intensity/ambient
    texture: bool = True              # value-noise albedo (visual branch input)
    renderer: str = "splat"           # "splat" | "raster"
    z_range: tuple = (0.6, 2.0)       # camera distance (dataset.py:226)
    # training-side filter: redraw poses until the mug handle is visible.
    # Invisible-handle frames make the yaw component of the canonical-coord
    # targets unobservable — label noise for the rotation head (the eval
    # protocol forgives those frames via gt_handle_visibility instead).
    require_handle_visible: bool = False
    device: str = "cuda"
    # (frame_seed, light_seed or None, n_pixels, texture, device) -> FrameDraws
    draw_fn: Callable[..., FrameDraws] = threefry_draws

    def __post_init__(self):
        if self.renderer not in ("splat", "raster"):
            raise ValueError(f"unknown renderer {self.renderer!r} (expected 'splat' or 'raster')")
        self.device = resolve_device(self.device)
        self.rng = np.random.default_rng(self.seed)
        # scale the NOCS pinhole to the render resolution (the reference
        # renders at exactly 640x480, dataset.py:210; smaller sizes are for tests)
        k = NOCS_INTRINSICS.copy()
        k[0] *= self.width / 640.0
        k[1] *= self.height / 480.0
        check_pinhole(k)   # on the host: backprojection does not read a device K back
        self.intrinsics_np = k
        self.intrinsics = torch.as_tensor(k, device=self.device)
        self._subdiv_for = None

    def _draw_pose(self):
        if self.full_rot:
            from scipy.stats import special_ortho_group

            r = special_ortho_group.rvs(3, random_state=self.rng).astype(np.float32)
        else:
            ya = self.rng.uniform(0, 2 * np.pi)
            xa = self.rng.uniform(np.deg2rad(10), np.deg2rad(80))
            yya = self.rng.uniform(-np.deg2rad(20), np.deg2rad(20))

            def ry(a):
                c, s = np.cos(a), np.sin(a)
                return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)

            def rx(a):
                c, s = np.cos(a), np.sin(a)
                return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)

            r = ry(yya) @ rx(xa) @ ry(ya)
        t = np.array(
            [
                self.rng.uniform(-0.3, 0.3),
                self.rng.uniform(-0.3, 0.3),
                self.rng.uniform(*self.z_range),
            ],
            np.float32,
        )
        return r, t

    def _raster_mesh(self, mesh, m):
        """Subdivide coarse faces below the fragment-grid size (canonical
        meshes are about unit sized: 1/48 is about 6 px at close range). A
        fixed caller-supplied mesh is subdivided once, keyed by identity and
        a content fingerprint, so one whose arrays change in place is
        subdivided again."""
        fp = None if mesh is None else (id(mesh), m[0].shape, float(np.sum(m[0])))
        if fp is not None and self._subdiv_for == fp:
            return self._subdiv_cache
        out = _pad_mesh(*subdivide_mesh(m, max_edge=1.0 / 48.0))
        if fp is not None:
            self._subdiv_for, self._subdiv_cache = fp, out
        return out

    def _canonicalize(self, frame, host, rot):
        """The continuous symmetry about `up` taken out of the rotation
        (dataset.py:265-266): rot' = map_sym(rot^T, up)^T, pc_canon derived
        again on the host copy."""
        rot_c = map_sym(torch.from_numpy(np.ascontiguousarray(rot.T)), self.cat.up_axis_index).numpy().T
        pc_canon = (host["pc"] - host["translation"]) @ rot_c / float(host["scale_norm"])
        pc_canon = np.where(host["valid"][:, None], pc_canon, 0.0).astype(np.float32)
        frame = frame._replace(rotation=torch.as_tensor(np.ascontiguousarray(rot_c), device=self.device),
                               pc_canon=torch.as_tensor(pc_canon, device=self.device))
        return frame, pc_canon

    def next_frame(self, mesh=None) -> SynthFrame:
        dev = self.device
        for _ in range(20):
            if mesh is None:
                m, meta = make_category_mesh(self.cat.name, self.rng, return_meta=True)
            else:
                m, meta = mesh, {}
            bound_canon = (m[0].max(0) - m[0].min(0)).astype(np.float32)
            r_obj, t_obj = self._draw_pose()
            scale = np.float32(self.rng.uniform(*self.cat.scale_range))
            frame_seed = int(self.rng.integers(0, 2**31))
            light_seed = int(self.rng.integers(0, 2**31)) if self.randomize_lighting else None
            draws = self.draw_fn(frame_seed, light_seed, self.height * self.width, self.texture, dev)
            pose = (torch.as_tensor(r_obj, device=dev), torch.as_tensor(t_obj, device=dev),
                    torch.as_tensor(scale, device=dev), torch.as_tensor(bound_canon, device=dev),
                    self.intrinsics, draws)
            if self.renderer == "raster":
                geometry = self._raster_mesh(mesh, m)
            else:
                geometry = sample_surface(m, self.surface_samples, self.rng)
            frame = frame_program(self.renderer, tuple(torch.as_tensor(x, device=dev) for x in geometry)
                                  + pose, float(self.cat.res), self.n_max, self.height, self.width,
                                  self.shot_k)
            # one copy back per attempt, of everything the host needs below
            host = to_host(frame, _FETCHED)
            if int(host["count"]) < self.min_points:
                continue
            pc_canon, rot = host["pc_canon"], host["rotation"]
            if self.cat.up_sym:
                frame, pc_canon = self._canonicalize(frame, host, rot)
            # NOCS handle-visibility flag (mug): does the rendered cloud
            # contain handle points? (the evaluation gates yaw on this, the
            # protocol's gt_handle_visibility, utils/util.py:588-663)
            self.last_meta = meta
            self.last_handle_visible = 1
            if "handle_cut" in meta:
                pcc = pc_canon[host["valid"]]
                ax, az = meta["axis_xz"]
                cyl = np.hypot(pcc[:, 0] - ax, pcc[:, 2] - az)
                self.last_handle_visible = int((cyl > meta["handle_cut"]).sum() >= 15)
                if self.require_handle_visible and not self.last_handle_visible:
                    continue  # redraw pose and mesh until the yaw cue is visible
                if not self.last_handle_visible:
                    # Body-only cloud: yaw is unobservable, so the canonical
                    # x/z of every target point would be label noise with
                    # respect to the input. Re-canonicalize the yaw as the
                    # up-symmetric categories do (map_sym, dataset.py:265-266):
                    # targets become a function of the visible geometry, and
                    # the evaluation protocol forgives yaw on these frames
                    # (gt_handle_visibility=0, utils/util.py:637-657), while
                    # body-only clouds stay in the distribution the center
                    # and scale heads see.
                    frame, _ = self._canonicalize(frame, host, rot)
            return frame
        raise RuntimeError("could not render a frame with enough points")

    def batch(self, size: int) -> Dict[str, np.ndarray]:
        """Stack frames into the training-batch layout (train/loop.py)."""
        names = ("pc", "pc_canon", "shot", "normal", "bound", "count")
        frames = [to_host(self.next_frame(), names) for _ in range(size)]
        return {k: np.stack([f[k] for f in frames]) for k in names}
