"""Procedural category meshes: the benchmark's frozen copy of
`make_category_mesh` and `subdivide_mesh` from `cppf2_torch/data/shapes.py`.

Meshes are (vertices (V, 3) float32, faces (F, 3) int32) in the NOCS
canonical frame (y up, bbox max extent 1), randomized per draw from a
`np.random.Generator`. The copy lives here so that a change to the
program's data module cannot move the scenes the benchmark measures on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Mesh = Tuple[np.ndarray, np.ndarray]  # (vertices, faces)


def _revolve(profile_r: np.ndarray, profile_y: np.ndarray, segments: int = 48) -> Mesh:
    """Revolve a (r(y), y) profile around the y axis into a triangle mesh."""
    n = len(profile_r)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    cs, sn = np.cos(ang), np.sin(ang)
    verts = np.stack(
        [
            (profile_r[:, None] * cs[None, :]).ravel(),
            np.repeat(profile_y, segments),
            (profile_r[:, None] * sn[None, :]).ravel(),
        ],
        axis=-1,
    ).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(segments):
            j2 = (j + 1) % segments
            a, b = i * segments + j, i * segments + j2
            c, d = (i + 1) * segments + j, (i + 1) * segments + j2
            faces.append([a, c, b])
            faces.append([b, c, d])
    return verts, np.asarray(faces, np.int32)


def _box(extents, center=(0.0, 0.0, 0.0)) -> Mesh:
    ex, ey, ez = np.asarray(extents) / 2.0
    cx, cy, cz = center
    v = np.array(
        [
            [cx - ex, cy - ey, cz - ez], [cx + ex, cy - ey, cz - ez],
            [cx + ex, cy + ey, cz - ez], [cx - ex, cy + ey, cz - ez],
            [cx - ex, cy - ey, cz + ez], [cx + ex, cy - ey, cz + ez],
            [cx + ex, cy + ey, cz + ez], [cx - ex, cy + ey, cz + ez],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
            [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
            [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
        ],
        np.int32,
    )
    return v, f


def _merge(*meshes: Mesh) -> Mesh:
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def _torus(
    r_major, r_minor, center, axis="x", seg=24, tube=12, u_range=(0.0, np.pi)
) -> Mesh:
    u = np.linspace(u_range[0], u_range[1], seg)  # arc segment (handle)
    v = np.linspace(0, 2 * np.pi, tube, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring_x = (r_major + r_minor * np.cos(vv)) * np.cos(uu)
    ring_y = (r_major + r_minor * np.cos(vv)) * np.sin(uu)
    ring_z = r_minor * np.sin(vv)
    pts = np.stack([ring_x, ring_y, ring_z], -1)  # (seg, tube, 3)
    if axis == "x":
        pts = pts[..., [2, 1, 0]]
    verts = (pts.reshape(-1, 3) + np.asarray(center)).astype(np.float32)
    faces = []
    for i in range(seg - 1):
        for j in range(tube):
            j2 = (j + 1) % tube
            a, b = i * tube + j, i * tube + j2
            c, d = (i + 1) * tube + j, (i + 1) * tube + j2
            faces.append([a, c, b])
            faces.append([b, c, d])
    return verts, np.asarray(faces, np.int32)


def _normalize_canonical(v: np.ndarray) -> np.ndarray:
    """Center on the bbox center and scale so the max bbox extent is 1
    (ShapeNet model_normalized convention, dataset.py:229-234)."""
    lo, hi = v.min(0), v.max(0)
    v = v - (lo + hi) / 2
    return (v / max(float((hi - lo).max()), 1e-9)).astype(np.float32)


def make_category_mesh(
    category: str, rng: np.random.Generator, return_meta: bool = False
):
    """A randomized procedural mesh for a NOCS category, canonical frame.

    With `return_meta=True` also returns a dict of canonical-frame semantic
    measurements (currently: mug `handle_cut` — the cylinder radius separating
    body from handle, used for NOCS handle-visibility gating)."""
    meta = {}
    if category == "can":
        r = rng.uniform(0.3, 0.45)
        h = 1.0
        prof_r = np.array([0.0, r, r, 0.0])
        prof_y = np.array([-h / 2, -h / 2, h / 2, h / 2])
        v, f = _revolve(prof_r, prof_y)
    elif category == "bottle":
        body_r = rng.uniform(0.28, 0.4)
        neck_r = body_r * rng.uniform(0.25, 0.45)
        shoulder = rng.uniform(0.1, 0.25)
        prof_r = np.array([0.0, body_r, body_r, neck_r, neck_r, 0.0])
        prof_y = np.array([-0.5, -0.5, 0.5 - shoulder - 0.15, 0.5 - 0.12, 0.5, 0.5])
        v, f = _revolve(prof_r, prof_y)
    elif category == "bowl":
        r = 0.5
        t = rng.uniform(0.03, 0.06)  # wall thickness
        th = np.linspace(-np.pi / 2, -0.15 * np.pi * rng.uniform(0.3, 1.0), 12)
        outer_r = r * np.cos(th)
        outer_y = r * np.sin(th) * rng.uniform(0.55, 0.8)
        inner_r = (outer_r - t)[::-1]
        inner_y = (outer_y + t)[::-1]
        prof_r = np.concatenate([[0.0], outer_r, inner_r, [0.0]])
        prof_y = np.concatenate([[outer_y[0]], outer_y, inner_y, [inner_y[-1]]])
        v, f = _revolve(prof_r, prof_y)
    elif category == "mug":
        # varied body (taper, height, wall) + varied handle (ring radius,
        # tube thickness, vertical placement) — mug yaw is defined solely by
        # the handle, so handle diversity is what the rotation head must
        # generalize over
        r = rng.uniform(0.28, 0.4)
        h = rng.uniform(0.75, 1.05)
        t = rng.uniform(0.04, 0.065)
        taper = rng.uniform(0.82, 1.0)  # bottom radius fraction
        prof_r = np.array([0.0, r * taper, r, r - t, (r - t) * taper, 0.0])
        prof_y = np.array([-h / 2, -h / 2, h / 2, h / 2, -h / 2 + t, -h / 2 + t])
        body = _revolve(prof_r, prof_y)
        ring = h * rng.uniform(0.22, 0.36)
        tube = rng.uniform(0.04, 0.07)
        hy = float(rng.uniform(-0.1, 0.1)) * h
        # the handle arcs in the x-y plane: anchored at the wall, bulging to
        # x = r + ring (a handle in the y-z plane would protrude only by the
        # tube radius — an almost invisible yaw cue)
        handle = _torus(
            ring, tube, center=(r - tube / 2, hy, 0.0), axis=None,
            u_range=(-np.pi / 2, np.pi / 2),
        )
        v, f = _merge(body, handle)
        meta["handle_cut_raw"] = r + 0.02
    elif category == "laptop":
        w = 1.0
        d = rng.uniform(0.6, 0.75)
        t = rng.uniform(0.03, 0.05)
        ang = rng.uniform(np.deg2rad(95), np.deg2rad(125))
        base = _box((w, t, d), center=(0, t / 2, d / 2))
        lid_v, lid_f = _box((w, t, d), center=(0, t / 2, d / 2))
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        lid_v = lid_v @ rot.T
        v, f = _merge(base, (lid_v, lid_f))
    elif category == "camera":
        # randomized body/lens/finder/grip proportions (+ optional flash
        # block) — pose is defined by these asymmetries, so they must vary
        bw = rng.uniform(0.88, 1.0)
        bh = rng.uniform(0.5, 0.7)
        bd = rng.uniform(0.32, 0.48)
        body = _box((bw, bh, bd), center=(0, 0, 0))
        lens_r = rng.uniform(0.14, 0.24)
        lens_len = rng.uniform(0.22, 0.38)
        prof_r = np.array([0.0, lens_r, lens_r, 0.0])
        prof_y = np.array([0.0, 0.0, lens_len, lens_len])
        lens_v, lens_f = _revolve(prof_r, prof_y, segments=32)
        # lens along +x (camera canonical front is +x, config/category/camera.yaml)
        lens_v = lens_v[:, [1, 0, 2]] * np.array([1, 1, 1], np.float32)
        lens_v[:, 0] += bw / 2 - 0.02
        lens_v[:, 1] += float(rng.uniform(-0.08, 0.08))
        lens_v[:, 2] += float(rng.uniform(-0.06, 0.06))
        finder = _box(
            (
                rng.uniform(0.22, 0.36),
                rng.uniform(0.1, 0.18),
                rng.uniform(0.18, 0.3),
            ),
            center=(rng.uniform(0.0, 0.2), bh / 2 + 0.07, -0.02),
        )
        grip = _box(
            (0.16, bh, rng.uniform(0.08, 0.16)),
            center=(-bw / 2 + 0.08, 0.0, bd / 2 + 0.05),
        )
        parts = [body, (lens_v.astype(np.float32), lens_f), finder, grip]
        if rng.uniform() < 0.5:  # flash block on the other shoulder
            parts.append(
                _box(
                    (0.14, 0.1, 0.14),
                    center=(-rng.uniform(0.25, 0.38), bh / 2 + 0.05, 0.0),
                )
            )
        v, f = _merge(*parts)
    else:
        raise ValueError(f"unknown category {category!r}")
    lo, hi = v.min(0), v.max(0)
    center = (lo + hi) / 2
    max_extent = max(float((hi - lo).max()), 1e-9)
    v_norm = _normalize_canonical(v)
    if return_meta:
        if "handle_cut_raw" in meta:
            meta["handle_cut"] = meta.pop("handle_cut_raw") / max_extent
            # revolve axis in canonical coords (bbox centering shifts it off 0)
            meta["axis_xz"] = (
                float(-center[0] / max_extent),
                float(-center[2] / max_extent),
            )
        return (v_norm, f), meta
    return v_norm, f


# ---------------------------------------------------------------------------
# Surface sampling
# ---------------------------------------------------------------------------

def subdivide_mesh(mesh: Mesh, max_edge: float, max_faces: int = 65536) -> Mesh:
    """Adaptive midpoint subdivision: 4-way split only of faces whose longest
    edge exceeds `max_edge`, until none remain (or the face budget is hit).
    Output is a triangle soup (vertices not welded — rasterization and surface
    sampling don't need connectivity). Used to bring coarse procedural or
    ShapeNet faces under the raster pass's fragment-grid size."""
    v, f = np.asarray(mesh[0], np.float32), np.asarray(mesh[1], np.int64)
    tri = v[f]                                     # (F, 3, 3) soup
    while True:
        e = np.linalg.norm(tri - tri[:, [1, 2, 0]], axis=-1)
        need = e.max(-1) > max_edge
        n_need = int(need.sum())
        if n_need == 0 or len(tri) + 3 * n_need > max_faces:
            break
        t = tri[need]
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        new = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ],
            axis=0,
        )
        tri = np.concatenate([tri[~need], new], axis=0)
    verts = tri.reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces
