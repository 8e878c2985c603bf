"""Rendering on the device: point-splat and barycentric triangle passes.

Counterpart of `cppf2_tpu/data/render.py`, which replaces the reference's
pyrender EGL offscreen renderer (dataset.py:206-255):

  * `splat_render_depth` — surface samples transformed by the object pose,
    pinhole-projected, z-min reduced per pixel (`scatter_reduce_` "amin"
    into a +inf buffer), back-face culled. Fast; can leave holes at close
    range.
  * `raster_render_depth` — triangle rasterization: each face emits a fixed
    G x G fragment grid over its screen bbox, barycentric inside tests,
    perspective-correct 1/z, scatter-min. No holes while face bboxes fit the
    fragment grid. Faces go through in `face_chunk` blocks.

Shading mirrors the reference's randomized pyrender lighting (dataset.py:
247-253): a light direction, diffuse intensity and ambient floor per frame,
and `procedural_albedo`, band-limited value noise over canonical coordinates
(the stand-in for ShapeNet textures feeding the descriptors, dataset.py:
394-402). Each random stage is split into a draw and an apply:
`data/synthetic.py::threefry_draws` makes the reference's `jax.random`
numbers, and `sample_lighting` / `procedural_albedo` take them.

Camera convention: OpenCV (+z forward, x right, y down); objects sit at
positive z.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cppf2_torch.core.geometry import norm
from cppf2_torch.device import device_constant

# NOCS-camera pinhole used by the reference for synthesis (dataset.py:189)
NOCS_INTRINSICS = np.array(
    [[591.0125, 0, 320.0], [0, 590.16775, 240.0], [0, 0, 1.0]], np.float32
)


class Lighting(NamedTuple):
    direction: torch.Tensor   # (3,) unit, pointing *from* the light
    intensity: torch.Tensor   # () diffuse strength
    ambient: torch.Tensor     # () ambient floor


class AlbedoDraw(NamedTuple):
    """The random numbers of one `procedural_albedo` texture."""
    directions: torch.Tensor   # (octaves, 3) standard normal
    frequencies: torch.Tensor  # (octaves,) U(1.5, 3)
    phases: torch.Tensor       # (octaves,) U(0, 2 pi)
    amplitudes: torch.Tensor   # (octaves,) U(0.3, 1)


def default_lighting(device="cuda") -> Lighting:
    """The fixed light of a frame drawn without lighting. Its numbers reach
    the device as a constant and fills: a frame program's body builds it,
    and a capture cannot record a copy from the host."""
    d = device_constant("render.light_direction", lambda: torch.tensor([0.3, -0.5, -0.8]), device)
    return Lighting(d / norm(d), torch.full((), 0.85, device=device), torch.full((), 0.15, device=device))


def sample_lighting(direction: torch.Tensor, intensity: torch.Tensor,
                    ambient: torch.Tensor) -> Lighting:
    """Per-frame lighting from its draws (reference: dataset.py:247-253
    randomizes the directional and spot intensities): the drawn direction
    normalized and turned to the camera side (negative z)."""
    d = direction / torch.clamp(norm(direction), min=1e-6)
    d = d * torch.where(d[2] > 0, -1.0, 1.0)
    return Lighting(d, intensity, ambient)


def procedural_albedo(pos: torch.Tensor, draw: AlbedoDraw) -> torch.Tensor:
    """Band-limited value-noise albedo in [0.3, 1] at (..., 3) canonical
    positions: a plane-wave mixture with per-octave direction, frequency,
    phase and amplitude from `draw`."""
    octaves = draw.frequencies.shape[0]
    dirs = draw.directions / torch.clamp(norm(draw.directions, keepdim=True), min=1e-6)
    freq = 2.0 ** torch.arange(octaves, device=pos.device) * draw.frequencies
    amp = draw.amplitudes / torch.sum(draw.amplitudes) * 1.5
    proj = torch.einsum("...c,oc->...o", pos, dirs)
    val = torch.sum(amp * torch.sin(2 * math.pi * freq * proj + draw.phases), dim=-1)
    return 0.65 + 0.35 * torch.tanh(val)


def _shade(normals_cam: torch.Tensor, lighting: Lighting) -> torch.Tensor:
    lambert = torch.clamp(-torch.sum(normals_cam * lighting.direction, dim=-1), 0.0, 1.0)
    return torch.clamp(lambert * lighting.intensity + lighting.ambient, 0.0, 1.0)


def _zbuffer(pix: torch.Tensor, z: torch.Tensor, shade: torch.Tensor, ok: torch.Tensor,
             height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter fragments (pixel index, depth, shade, valid; invalid ones
    parked at pixel 0 with depth +inf) into (depth, gray) maps: z-min per
    pixel, then the largest shade among fragments within 1e-5 of the
    pixel's winning depth."""
    dev = z.device
    inf = torch.full((), float("inf"), device=dev)
    zbuf = torch.full((height * width,), float("inf"), device=dev).scatter_reduce_(0, pix, z, "amin")
    # pixel 0 holds the parked fragments: it is covered only if a valid one landed there
    zbuf[0] = torch.where(torch.any(ok & (pix == 0)), zbuf[0], inf)
    depth = torch.where(torch.isfinite(zbuf), zbuf, torch.zeros((), device=dev)).reshape(height, width)
    winner = ok & (z <= zbuf[pix] + 1e-5)
    gray = torch.zeros(height * width, device=dev).scatter_reduce_(
        0, pix, torch.where(winner, shade, torch.zeros((), device=dev)), "amax")
    gray = torch.where(depth > 0, gray.reshape(height, width), torch.zeros((), device=dev))
    return depth, gray


def splat_render_depth(
    samples: torch.Tensor,      # (S, 3) canonical surface samples
    normals: torch.Tensor,      # (S, 3) canonical surface normals
    rotation: torch.Tensor,     # (3, 3) object rotation (camera frame)
    translation: torch.Tensor,  # (3,) object translation (camera frame, z > 0)
    scale: float,               # metric scale multiplier
    intrinsics: torch.Tensor,   # (3, 3)
    height: int = 480,
    width: int = 640,
    lighting: Optional[Lighting] = None,
    albedo: Optional[torch.Tensor] = None,   # (S,) per-sample albedo (texture)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a depth map and a shaded gray image of a posed object.

    Returns depth (H, W) float32, 0 where empty, and gray (H, W) float32 in
    [0, 1], lambertian shading x albedo (the visual branch's input when no
    textures exist).
    """
    dev = samples.device
    pts = (samples * scale) @ rotation.T + translation
    nrm = normals @ rotation.T
    # back-face culling: keep samples facing the camera (normal . view < 0)
    facing = torch.sum(nrm * pts, dim=-1) < 0.0
    z = pts[:, 2]
    ok = facing & (z > 1e-3)
    uvw = pts @ intrinsics.T
    u = uvw[:, 0] / torch.clamp(uvw[:, 2], min=1e-6)
    v = uvw[:, 1] / torch.clamp(uvw[:, 2], min=1e-6)
    ui = torch.round(u).to(torch.int64)   # half to even, as jnp.round
    vi = torch.round(v).to(torch.int64)
    inside = ok & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    pix = torch.where(inside, vi * width + ui, torch.zeros((), dtype=torch.int64, device=dev))
    zval = torch.where(inside, z, torch.full((), float("inf"), device=dev))
    shade = _shade(nrm, lighting if lighting is not None else default_lighting(dev))
    if albedo is not None:
        shade = shade * albedo
    return _zbuffer(pix, zval, shade, inside, height, width)


def raster_render_depth(
    verts: torch.Tensor,        # (V, 3) canonical vertices
    faces: torch.Tensor,        # (F, 3) integer
    rotation: torch.Tensor,     # (3, 3) object rotation (camera frame)
    translation: torch.Tensor,  # (3,) object translation (camera frame, z > 0)
    scale: float,               # metric scale multiplier
    intrinsics: torch.Tensor,   # (3, 3)
    height: int = 480,
    width: int = 640,
    lighting: Optional[Lighting] = None,
    albedo: Optional[AlbedoDraw] = None,   # procedural texture at each fragment
    frag_grid: int = 16,
    face_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barycentric triangle rasterization with perspective-correct depth.

    Each face emits a `frag_grid`^2 fragment grid over its integer screen
    bbox; fragments run a barycentric inside test, interpolate 1/z linearly
    in screen space (exact for perspective) and scatter-min into the
    z-buffer. Coverage is exact while a face's bbox fits the grid; a larger
    face strides across its bbox. Shading is flat lambertian x the optional
    value-noise albedo at the fragment's canonical position. Faces with two
    equal first indices (the (0, 0, 0) padding) are skipped.

    Returns (depth (H, W), gray (H, W)) like `splat_render_depth`.
    """
    dev = verts.device
    lighting = lighting if lighting is not None else default_lighting(dev)
    v_cam = (verts * scale) @ rotation.T + translation        # (V, 3)
    z = torch.clamp(v_cam[:, 2], min=1e-6)
    uvw = v_cam @ intrinsics.T
    sx, sy, inv_z = uvw[:, 0] / z, uvw[:, 1] / z, 1.0 / z
    g = frag_grid
    steps = torch.arange(g, device=dev)
    zero = torch.zeros((), device=dev)
    inf = torch.full((), float("inf"), device=dev)
    parts = []
    for start in range(0, faces.shape[0], face_chunk):
        fc = faces[start:start + face_chunk].to(torch.int64)
        ax, ay = sx[fc[:, 0]], sy[fc[:, 0]]
        bx, by = sx[fc[:, 1]], sy[fc[:, 1]]
        cx, cy = sx[fc[:, 2]], sy[fc[:, 2]]
        vz = inv_z[fc]                                        # (C, 3)
        vc = v_cam[fc]                                        # (C, 3, 3)
        fn = torch.linalg.cross(vc[:, 1] - vc[:, 0], vc[:, 2] - vc[:, 0])
        fn = fn / torch.clamp(norm(fn, keepdim=True), min=1e-12)
        # no back-face culling: winding is not guaranteed consistent (OBJ and
        # procedural meshes) and closed surfaces self-occlude through z-min;
        # normals are turned to the view side for shading only
        fn = fn * torch.where(torch.sum(fn * vc[:, 0], -1) > 0, -1.0, 1.0)[:, None]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)  # signed 2x area
        ok_face = (torch.abs(area) > 1e-12) & (fc[:, 0] != fc[:, 1])

        x0 = torch.floor(torch.minimum(torch.minimum(ax, bx), cx)).to(torch.int64)
        y0 = torch.floor(torch.minimum(torch.minimum(ay, by), cy)).to(torch.int64)
        x1 = torch.ceil(torch.maximum(torch.maximum(ax, bx), cx)).to(torch.int64)
        y1 = torch.ceil(torch.maximum(torch.maximum(ay, by), cy)).to(torch.int64)
        # integer pixel rows and columns covering the bbox; faces wider than
        # the grid stride across it (splat-like, no crop bias)
        strx = torch.clamp((x1 - x0 + g) // g, min=1)
        stry = torch.clamp((y1 - y0 + g) // g, min=1)
        xs = x0[:, None] + steps[None, :] * strx[:, None]     # (C, g)
        ys = y0[:, None] + steps[None, :] * stry[:, None]
        px = xs[:, None, :].to(torch.float32)                 # (C, 1, g)
        py = ys[:, :, None].to(torch.float32)                 # (C, g, 1)

        def e(a):
            return a[:, None, None]

        # barycentric weights at pixel centers (edge functions)
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
        pix = torch.where(valid, ys[:, :, None] * width + xs[:, None, :],
                          torch.zeros((), dtype=torch.int64, device=dev))
        shade = _shade(fn, lighting)                          # (C,)
        if albedo is not None:
            # perspective-correct canonical position of each fragment
            vcan = verts[fc]                                  # (C, 3, 3)
            num = (b0[..., None] * (vcan[:, 0] * vz[:, 0, None])[:, None, None, :]
                   + b1[..., None] * (vcan[:, 1] * vz[:, 1, None])[:, None, None, :]
                   + b2[..., None] * (vcan[:, 2] * vz[:, 2, None])[:, None, None, :])
            pcan = num / torch.clamp(frag_inv_z[..., None], min=1e-9)
            frag_shade = e(shade) * procedural_albedo(pcan, albedo)
        else:
            frag_shade = e(shade).expand(frag_z.shape)
        parts.append((pix.reshape(-1), torch.where(valid, frag_z, inf).reshape(-1),
                      torch.where(valid, frag_shade, zero).reshape(-1), valid.reshape(-1)))
    pix, zf, sh, ok = (torch.cat(x) for x in zip(*parts))
    return _zbuffer(pix, zf, sh, ok, height, width)
