"""The one traffic generator: a mix file's parameters -> a fixed set of frames.

A mix (`perfbench/traffic/<name>.json`) says how many distinct frames to
render, how many instances each holds (the frames take the listed counts in
turn), which categories, how far from the camera, which crop tiers the masks
may fall in and how many frames carry one instance too large for any tier
(the frame driver's singles route; those of the frames with the fewest
instances). The seed draws the categories, shapes, sizes, poses, textures
and layout; the multiset of instance counts and of tierless instances is the mix's own, the
same for every seed, so that two seeds ask the same work of the program in
another order. A frame is drawn again until every mask has its planned tier
and enough pixels.

Frames are 480 x 640 at REAL275's evaluation intrinsics (reference
eval.py:82), depth in whole millimetres as a REAL275 depth PNG holds it.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from perfbench.scenes.render import Posed, draw_albedo, render, tiers_of
from perfbench.scenes.shapes import make_category_mesh, subdivide_mesh

REAL275_INTRINSICS = np.array(
    [[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32)
HEIGHT, WIDTH = 480, 640
# metric size (bbox max extent) per category, as the reference's generator
# draws ShapeNet scales (dataset.py:165-172)
SIZES = {"bottle": (0.16, 0.25), "bowl": (0.1851, 0.26), "camera": (0.1430, 0.28),
         "can": (0.128, 0.18), "laptop": (0.3862, 0.58), "mug": (0.1501, 0.1995)}
TIERS = (256, 320)
_EDGE_PX = 12.0      # subdivide until no face edge spans more pixels than this
_TRIES = 200


class Frame(NamedTuple):
    rgb: np.ndarray      # (H, W, 3) uint8
    depth: np.ndarray    # (H, W) float32 meters
    dets: List[Tuple[str, np.ndarray]]   # (category, (H, W) bool mask) per instance


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _upright(rng) -> np.ndarray:
    """An object standing on a table seen from a camera 20-50 degrees above
    it: canonical y up, front towards the camera, turned about its up axis."""
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return _rot_x(math.radians(rng.uniform(20.0, 50.0))) @ flip @ _rot_y(rng.uniform(0, 2 * math.pi))


def _extent_px(verts, rot, trans, scale, k) -> float:
    """Larger side of the frame-clipped bbox of the projected vertices."""
    cam = (verts * scale) @ rot.T + trans
    uv = cam[:, :2] / cam[:, 2:3] * np.array([k[0, 0], k[1, 1]]) + np.array([k[0, 2], k[1, 2]])
    lo = np.clip(uv.min(0), 0, [WIDTH, HEIGHT])
    hi = np.clip(uv.max(0), 0, [WIDTH, HEIGHT])
    return float(max(hi - lo))


def _wants(tier, allowed) -> bool:
    return tier is None if allowed is None else tier in allowed


def _place(rng, cat: str, target, mix: Dict, u: float, v: float) -> Optional[Posed]:
    """One instance at image position (u, v) whose unoccluded bbox falls in
    `target` (a set of tiers, or None for tierless), or None."""
    k = REAL275_INTRINSICS
    lo, hi = mix["distance_m"]
    verts, faces = make_category_mesh(cat, rng)
    scale = rng.uniform(*SIZES[cat])
    for _ in range(_TRIES):
        rot = _upright(rng)
        z = rng.uniform(lo, hi)
        trans = np.array([(u - k[0, 2]) / k[0, 0] * z, (v - k[1, 2]) / k[1, 1] * z, z], np.float32)
        ext = _extent_px(verts, rot, trans, scale, k)
        # a margin of 12 px to the tier edges: occlusion only shrinks a mask
        tier = next((t for t in TIERS if ext <= t - 16), None)
        if target is None and ext < TIERS[-1] + 12:
            continue
        if target is not None and (tier is None or tier not in target or ext < 60):
            continue
        max_edge = _EDGE_PX * (z - scale) / (k[0, 0] * scale)
        sv, sf = subdivide_mesh((verts, faces), max(max_edge, 1e-3), max_faces=1 << 17)
        tint = rng.uniform(0.55, 1.0, 3).astype(np.float32)
        return Posed(sv, sf, rot, trans, float(scale), draw_albedo(rng), tint)
    return None


def _plan(mix: Dict, rng) -> List[Tuple[int, bool, Optional[str]]]:
    """Per frame: (instances, carries a tierless one, the category of a
    one-category frame). The counts and flags are the mix's own multiset;
    the seed only orders them."""
    n = mix["frames"]
    counts = [mix["instances"][i % len(mix["instances"])] for i in range(n)]
    # the frames with the fewest instances carry the tierless ones
    fewest = sorted(range(n), key=lambda i: (counts[i], i))[:mix.get("tierless_frames", 0)]
    tierless = [i in fewest for i in range(n)]
    pool = mix["categories"]
    one = [pool[i % len(pool)] if mix["per_frame"] == "one" else None for i in range(n)]
    order = rng.permutation(n)
    return [(counts[i], tierless[i], one[i]) for i in order]


def _categories(rng, mix: Dict, n: int, tierless: bool, one: Optional[str]) -> List[str]:
    if one is not None:
        return [one] * n
    pool = list(mix["categories"])
    first = []
    if tierless:
        first = [str(rng.choice(mix["tierless_categories"]))]
        pool.remove(first[0])
    return first + [str(c) for c in rng.choice(pool, n - len(first), replace=False)]


def _frame(rng, mix: Dict, n: int, tierless: bool, one: Optional[str], device) -> Frame:
    allowed = set(int(t) for t in mix["tiers"])
    for _ in range(_TRIES):
        cats = _categories(rng, mix, n, tierless, one)
        targets = [None if tierless and i == 0 else allowed for i in range(n)]
        slots = rng.permutation(n)
        insts = []
        for i, cat in enumerate(cats):
            u = (slots[i] + 0.5) / n * WIDTH + rng.normal(0.0, WIDTH / (8 * n))
            v = HEIGHT / 2 + rng.uniform(-HEIGHT / 10, HEIGHT / 10)
            p = _place(rng, cat, targets[i], mix, float(np.clip(u, 40, WIDTH - 40)), v)
            if p is None:
                break
            insts.append(p)
        if len(insts) != n:
            continue
        depth, rgb, ids = render(insts, REAL275_INTRINSICS, HEIGHT, WIDTH, device)
        masks = [ids == i + 1 for i in range(n)]
        if any(int(m.sum()) < mix["min_pixels"] for m in masks):
            continue
        if not all(_wants(t, g) for t, g in zip(tiers_of(masks, TIERS), targets)):
            continue
        depth = (np.round(depth * 1000.0) / 1000.0).astype(np.float32)
        return Frame(rgb, depth, list(zip(cats, masks)))
    raise RuntimeError(f"no frame of {n} instances met the mix's tiers in {_TRIES} draws")


def frame_set(mix: Dict, seed: int, device) -> List[Frame]:
    """The mix's distinct frames for `seed`, rendered on `device`."""
    rng = np.random.default_rng(seed)
    return [_frame(rng, mix, n, tl, one, device) for n, tl, one in _plan(mix, rng)]
