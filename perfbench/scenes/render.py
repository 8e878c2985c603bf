"""Rasterizing several posed meshes into one RGB-D frame with instance ids.

The fragment pass is the benchmark's frozen copy of the barycentric raster in
`cppf2_torch/data/render.py::raster_render_depth`: each face emits a G x G
fragment grid over its integer screen bbox, an edge-function inside test,
1/z interpolated linearly in screen space, flat lambertian shading times a
band-limited value-noise albedo (`procedural_albedo`) at the fragment's
canonical position. Here every instance adds its fragments to one list, and
one z-buffer over all of them gives the depth, the colour and the id of the
nearest instance at each pixel. Meshes are subdivided first, so that no
face spans more than the fragment grid.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Albedo(NamedTuple):
    """The random numbers of one procedural texture."""
    directions: np.ndarray   # (octaves, 3) standard normal
    frequencies: np.ndarray  # (octaves,) U(1.5, 3)
    phases: np.ndarray       # (octaves,) U(0, 2 pi)
    amplitudes: np.ndarray   # (octaves,) U(0.3, 1)


class Posed(NamedTuple):
    """One instance to draw: a canonical mesh, its pose and its look."""
    verts: np.ndarray      # (V, 3) canonical
    faces: np.ndarray      # (F, 3)
    rotation: np.ndarray   # (3, 3) canonical -> camera
    translation: np.ndarray  # (3,) meters, camera frame
    scale: float           # metric size of the canonical unit
    albedo: Albedo
    tint: np.ndarray       # (3,) RGB multipliers


def draw_albedo(rng: np.random.Generator, octaves: int = 4) -> Albedo:
    return Albedo(rng.standard_normal((octaves, 3)).astype(np.float32),
                  rng.uniform(1.5, 3.0, octaves).astype(np.float32),
                  rng.uniform(0.0, 2 * math.pi, octaves).astype(np.float32),
                  rng.uniform(0.3, 1.0, octaves).astype(np.float32))


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def procedural_albedo(pos: torch.Tensor, draw: Albedo) -> torch.Tensor:
    """Value-noise albedo in [0.3, 1] at (..., 3) canonical positions."""
    dev = pos.device
    dirs = torch.as_tensor(draw.directions, device=dev)
    dirs = dirs / torch.clamp(_norm(dirs, keepdim=True), min=1e-6)
    octaves = dirs.shape[0]
    freq = 2.0 ** torch.arange(octaves, device=dev) * torch.as_tensor(draw.frequencies, device=dev)
    amp = torch.as_tensor(draw.amplitudes, device=dev)
    amp = amp / torch.sum(amp) * 1.5
    proj = torch.einsum("...c,oc->...o", pos, dirs)
    val = torch.sum(amp * torch.sin(2 * math.pi * freq * proj + torch.as_tensor(draw.phases, device=dev)),
                    dim=-1)
    return 0.65 + 0.35 * torch.tanh(val)


def _fragments(p: Posed, intrinsics: torch.Tensor, light: torch.Tensor, height: int, width: int,
               frag_grid: int, face_chunk: int) -> Tuple[torch.Tensor, ...]:
    """(pixel index, depth, RGB, valid) of every fragment of one instance."""
    dev = intrinsics.device
    verts = torch.as_tensor(p.verts, device=dev)
    faces = torch.as_tensor(p.faces, device=dev)
    rot = torch.as_tensor(np.asarray(p.rotation, np.float32), device=dev)
    trans = torch.as_tensor(np.asarray(p.translation, np.float32), device=dev)
    tint = torch.as_tensor(np.asarray(p.tint, np.float32), device=dev)
    v_cam = (verts * p.scale) @ rot.T + trans
    z = torch.clamp(v_cam[:, 2], min=1e-6)
    uvw = v_cam @ intrinsics.T
    sx, sy, inv_z = uvw[:, 0] / z, uvw[:, 1] / z, 1.0 / z
    g = frag_grid
    steps = torch.arange(g, device=dev)
    out = []
    for start in range(0, faces.shape[0], face_chunk):
        fc = faces[start:start + face_chunk].to(torch.int64)
        ax, ay = sx[fc[:, 0]], sy[fc[:, 0]]
        bx, by = sx[fc[:, 1]], sy[fc[:, 1]]
        cx, cy = sx[fc[:, 2]], sy[fc[:, 2]]
        vz = inv_z[fc]
        vc = v_cam[fc]
        fn = torch.linalg.cross(vc[:, 1] - vc[:, 0], vc[:, 2] - vc[:, 0])
        fn = fn / torch.clamp(_norm(fn, keepdim=True), min=1e-12)
        fn = fn * torch.where(torch.sum(fn * vc[:, 0], -1) > 0, -1.0, 1.0)[:, None]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        ok_face = torch.abs(area) > 1e-12
        x0 = torch.floor(torch.minimum(torch.minimum(ax, bx), cx)).to(torch.int64)
        y0 = torch.floor(torch.minimum(torch.minimum(ay, by), cy)).to(torch.int64)
        x1 = torch.ceil(torch.maximum(torch.maximum(ax, bx), cx)).to(torch.int64)
        y1 = torch.ceil(torch.maximum(torch.maximum(ay, by), cy)).to(torch.int64)
        strx = torch.clamp((x1 - x0 + g) // g, min=1)
        stry = torch.clamp((y1 - y0 + g) // g, min=1)
        xs = x0[:, None] + steps[None, :] * strx[:, None]
        ys = y0[:, None] + steps[None, :] * stry[:, None]
        px = xs[:, None, :].to(torch.float32)
        py = ys[:, :, None].to(torch.float32)

        def e(a):
            return a[:, None, None]

        w0 = e(cx - bx) * (py - e(by)) - e(cy - by) * (px - e(bx))
        w1 = e(ax - cx) * (py - e(cy)) - e(ay - cy) * (px - e(cx))
        w2 = e(bx - ax) * (py - e(ay)) - e(by - ay) * (px - e(ax))
        s = e(torch.sign(area))
        inside = (w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0)
        b0, b1, b2 = w0 / e(area), w1 / e(area), w2 / e(area)
        frag_inv_z = b0 * e(vz[:, 0]) + b1 * e(vz[:, 1]) + b2 * e(vz[:, 2])
        valid = (inside & e(ok_face) & (frag_inv_z > 1e-9)
                 & (xs[:, None, :] >= 0) & (xs[:, None, :] < width)
                 & (ys[:, :, None] >= 0) & (ys[:, :, None] < height))
        frag_z = 1.0 / torch.clamp(frag_inv_z, min=1e-9)
        pix = torch.where(valid, ys[:, :, None] * width + xs[:, None, :], 0)
        lambert = torch.clamp(-torch.sum(fn * light, dim=-1), 0.0, 1.0)
        shade = torch.clamp(lambert * 0.85 + 0.15, 0.0, 1.0)
        vcan = verts[fc]
        num = (b0[..., None] * (vcan[:, 0] * vz[:, 0, None])[:, None, None, :]
               + b1[..., None] * (vcan[:, 1] * vz[:, 1, None])[:, None, None, :]
               + b2[..., None] * (vcan[:, 2] * vz[:, 2, None])[:, None, None, :])
        pcan = num / torch.clamp(frag_inv_z[..., None], min=1e-9)
        gray = e(shade) * procedural_albedo(pcan, p.albedo)
        keep = valid.reshape(-1)
        out.append((pix.reshape(-1)[keep], frag_z.reshape(-1)[keep],
                    (gray.reshape(-1, 1)[keep] * tint)))
    return tuple(torch.cat(x) for x in zip(*out))


def render(instances: Sequence[Posed], intrinsics: np.ndarray, height: int, width: int,
           device, frag_grid: int = 12, face_chunk: int = 8192):
    """Depth (H, W) float32 meters (0 where empty), RGB (H, W, 3) uint8 and
    instance ids (H, W) int32 (0 background, i + 1 for instance i) on the
    host, from one z-buffer over every instance's fragments."""
    dev = torch.device(device)
    k = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    light = torch.as_tensor(np.array([0.3, -0.5, -0.8], np.float32), device=dev)
    light = light / _norm(light)
    pix, zs, cols, ids = [], [], [], []
    for i, p in enumerate(instances):
        pi, zi, ci = _fragments(p, k, light, height, width, frag_grid, face_chunk)
        pix.append(pi)
        zs.append(zi)
        cols.append(ci)
        ids.append(torch.full_like(pi, i + 1))
    pix, z, col, inst = torch.cat(pix), torch.cat(zs), torch.cat(cols), torch.cat(ids)
    n = height * width
    zbuf = torch.full((n,), float("inf"), device=dev).scatter_reduce_(0, pix, z, "amin")
    win = z <= zbuf[pix]
    id_buf = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, pix[win], inst[win], "amax")
    # the colour of the winning instance's nearest fragment
    mine = win & (inst == id_buf[pix])
    rgb = torch.zeros((n, 3), device=dev)
    for c in range(3):
        rgb[:, c].scatter_reduce_(0, pix[mine], col[mine, c], "amax")
    covered = torch.isfinite(zbuf)
    depth = torch.where(covered, zbuf, 0.0).reshape(height, width)
    rgb = (torch.clamp(rgb, 0.0, 1.0) * 255.0).round().to(torch.uint8).reshape(height, width, 3)
    return (depth.cpu().numpy(), rgb.cpu().numpy(),
            id_buf.to(torch.int32).reshape(height, width).cpu().numpy())


def tiers_of(masks: List[np.ndarray], tiers=(256, 320)) -> List:
    """The crop tier of each mask as the frame driver chooses it: the smallest
    tier whose bbox-centred window holds the mask with 4 pixels to spare, or
    None."""
    out = []
    for m in masks:
        rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
        if rows.size == 0:
            out.append(None)
            continue
        ext = max(rows[-1] + 1 - rows[0], cols[-1] + 1 - cols[0])
        out.append(next((t for t in tiers if ext <= t - 4), None))
    return out
