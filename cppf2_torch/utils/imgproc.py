"""The OpenCV calls of the demo path, on numpy and scipy.

The JAX package calls cv2 in its instance proposer (`infer/segmenter.py`),
its pose overlay (`utils/viz.py`) and its mask dilation
(`infer/frontend.py::dilate_mask`); the card's machine has no cv2. Each
function here reproduces the one call the JAX package makes, with its
arguments and its defaults, and says which:

  * `gaussian_blur5`: `cv2.GaussianBlur(x, (5, 5), 0)` on float32, bit for
    bit, with OpenCV's rounding order (below);
  * `dilate`, `erode`, `morph_close`: rectangular kernels with the default
    border, which never wins (-inf for dilate, +inf for erode);
  * `connected_components`: `cv2.connectedComponents`, labels number for
    number (4-connectivity numbers components in raster order of their first
    pixel, 8-connectivity in raster order of their first 2 x 2 block, as
    OpenCV's block-based labelling does);
  * `convex_hull`, `fill_convex_poly`, `draw_line`: `cv2.convexHull`,
    `cv2.fillConvexPoly` and `cv2.line` (8-connected), in OpenCV's integer
    and 16-bit fixed-point arithmetic: a line thicker than one pixel is a
    filled quadrilateral with a filled circle at each end.

Everything runs on the host: these calls take a few milliseconds on a
480 x 640 frame and feed discrete decisions (masks, rankings), where a
result equal to the reference's matters more than speed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# ---------------------------------------------------------------------------
# Smoothing and morphology
# ---------------------------------------------------------------------------

def _taps(x: np.ndarray, axis: int):
    """The five taps of a 5-wide window along `axis`, border reflect-101."""
    pad = [(2, 2) if i == axis else (0, 0) for i in range(x.ndim)]
    p = np.pad(x, pad, mode="reflect")
    n = x.shape[axis]
    return [np.take(p, np.arange(i, i + n), axis=axis) for i in range(5)]


def fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32, for float32 operands (their
    product is exact in float64): the fused multiply-add of OpenCV's
    vectorized loops."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


def gaussian_blur5(x: np.ndarray) -> np.ndarray:
    """`cv2.GaussianBlur(x, (5, 5), 0)` of a float32 (H, W) or (H, W, C) image.

    With sigma 0 and 5 taps OpenCV takes the fixed binomial kernel
    [1, 4, 6, 4, 1] / 16 (no Gaussian is evaluated), border reflect-101, a
    row pass then a column pass. The rounding order is that of OpenCV's
    vectorized symmetric filters: rows as ((s-1 + s+1) / 4, then s0 * 3/8
    fused into it, then + (s-2 + s+2) / 16), except the last float of a row
    of odd length, which its scalar loop rounds as columns are rounded:
    (s0 * 3/8 + (s-1 + s+1) / 4) + (s-2 + s+2) / 16. The weights 1/4 and
    1/16 are powers of two, so only the 3/8 product rounds."""
    x = np.asarray(x, np.float32)
    if x.ndim not in (2, 3):
        raise ValueError(f"gaussian_blur5 takes an (H, W) or (H, W, C) image, got {x.shape}")
    f32 = np.float32
    k0, k1, k2 = f32(0.375), f32(0.25), f32(0.0625)

    def plain(s):
        return (s[2] * k0 + (s[1] + s[3]) * k1) + (s[0] + s[4]) * k2

    s = _taps(x, 1)
    rows = fma32(s[2], 0.375, (s[1] + s[3]) * k1) + (s[0] + s[4]) * k2
    h, w = x.shape[:2]
    width = w * (x.shape[2] if x.ndim == 3 else 1)
    if width % 2:
        flat = rows.reshape(h, width)
        flat[:, -1] = plain(s).reshape(h, width)[:, -1]
    return plain(_taps(rows, 0))


def dilate(x: np.ndarray, ksize: int) -> np.ndarray:
    """`cv2.dilate(x, np.ones((ksize, ksize), np.uint8))`: the border never
    wins, so padding with the nearest pixel gives the same maximum."""
    return ndimage.maximum_filter(np.asarray(x), size=ksize, mode="nearest")


def erode(x: np.ndarray, ksize: int) -> np.ndarray:
    """`cv2.erode(x, np.ones((ksize, ksize), np.uint8))`."""
    return ndimage.minimum_filter(np.asarray(x), size=ksize, mode="nearest")


def morph_close(x: np.ndarray, ksize: int) -> np.ndarray:
    """`cv2.morphologyEx(x, cv2.MORPH_CLOSE, np.ones((ksize, ksize)))`:
    dilate, then erode, with the same borders."""
    return erode(dilate(x, ksize), ksize)


def connected_components(mask: np.ndarray, connectivity: int = 8) -> Tuple[int, np.ndarray]:
    """`cv2.connectedComponents(mask, connectivity=...)`: (number of labels
    with the background's 0, int32 labels). Component numbers follow
    OpenCV's labelling order: raster order of each component's first pixel
    for 4-connectivity, of its first 2 x 2 block for 8-connectivity."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    mask = np.asarray(mask) != 0
    structure = ndimage.generate_binary_structure(2, 1 if connectivity == 4 else 2)
    labels, n = ndimage.label(mask, structure=structure)
    labels = labels.astype(np.int32)
    if connectivity == 8 and n > 1:
        ys, xs = np.nonzero(labels)
        key = (ys // 2).astype(np.int64) * ((mask.shape[1] + 1) // 2) + xs // 2
        first = np.full(n + 1, np.iinfo(np.int64).max)
        np.minimum.at(first, labels[ys, xs], key)
        remap = np.zeros(n + 1, np.int32)
        remap[np.argsort(first[1:], kind="stable") + 1] = np.arange(1, n + 1, dtype=np.int32)
        labels = remap[labels]
    return n + 1, labels


# ---------------------------------------------------------------------------
# Polygons and lines in OpenCV's integer arithmetic
# ---------------------------------------------------------------------------

def _cross(o, a, b) -> int:
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def convex_hull(points: np.ndarray) -> np.ndarray:
    """`cv2.convexHull(points)[:, 0]` of distinct integer (N, 2) points
    (x, y): the hull's corners without collinear points, clockwise on the
    image (y down), in cv2's order. That order starts from the corner of
    largest (x, y), then is shifted cyclically, as cv2 does, to make the
    corners' input indices ascending or descending where a shift can."""
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    index = {}
    for i, p in enumerate(map(tuple, pts.tolist())):
        index.setdefault(p, i)
    srt = sorted(index)
    if len(srt) <= 2:
        return np.asarray(srt[::-1], np.int32).reshape(-1, 2)
    lower, upper = [], []
    for p in srt:
        while len(lower) >= 2 and _cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(srt):
        while len(upper) >= 2 and _cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    hull = lower[:-1] + upper[:-1]
    start = hull.index(max(hull))
    hull = hull[start:] + hull[:start]
    return np.asarray(_ascending_shift(hull, [index[p] for p in hull]), np.int32)


def _ascending_shift(hull, idx):
    """cv2.convexHull's last step: the cyclic shift of the hull that makes the
    input indices of its corners an ascending or descending run, where the
    indices allow one."""
    n = len(idx)
    if n < 3:
        return hull
    mn = mx = lt = 0
    for i in range(1, n):
        lt += idx[i - 1] < idx[i]
        if 1 < lt <= i - 2:
            break
        if idx[i] < idx[mn]:
            mn = i
        if idx[i] > idx[mx]:
            mx = i
    dist = abs(mx - mn)
    if (dist == 1 or dist == n - 1) and (lt <= 1 or lt >= n - 2):
        ascending = (mx + 1) % n == mn
        i0 = mn if ascending else mx
        if i0 > 0:
            order = [(i0 + i) % n for i in range(n)]
            if all(ascending == (idx[a] < idx[b]) for a, b in zip(order, order[1:])):
                return [hull[j] for j in order]
    return hull


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine to [0, w-1] x [0, h-1]: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's `Line` (LineIterator, 8-connected, left to right) between
    integer pixels."""
    h, w = img.shape[:2]
    x1, y1 = p1
    x2, y2 = p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    x, y = x1, y1
    for _ in range(major + 1):
        img[y, x] = color
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's `Line2`: an 8-connected line between 16-bit fixed-point ends."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex(img: np.ndarray, v: Sequence[Tuple[int, int]], color, shift: int) -> None:
    """OpenCV's `FillConvexPoly` for 8-connected drawing: the outline first
    (`Line` at shift 0, `Line2` otherwise), then the scanlines between the
    two edges walked from the topmost vertex, in 16-bit fixed point."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    px, py = v[-1][0] << up, v[-1][1] << up
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        qx, qy = x << up, y << up
        if shift == 0:
            _line8(img, (px >> XY_SHIFT, py >> XY_SHIFT), (qx >> XY_SHIFT, qy >> XY_SHIFT), color)
        else:
            _line2(img, (px, py), (qx, qy), color)
        px, py = qx, qy
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    half = XY_ONE >> 1
    edges = npts
    # per edge: [vertex index, direction, x, dx, end row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            x1, x2 = (left[2] + half) >> XY_SHIFT, (right[2] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def fill_convex_poly(img: np.ndarray, points: np.ndarray, color) -> np.ndarray:
    """`cv2.fillConvexPoly(img, points, color)` with integer (N, 2) vertices
    (x, y) and shift 0, in place; returns `img`."""
    v = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    if v:
        _fill_convex(img, v, color, 0)
    return img


def _fill_circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled `Circle` (midpoint circle, horizontal spans)."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, a, b in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                         (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and b >= 0 and a < w:
                img[yy, max(a, 0):min(b, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, p0, p1, color, thickness)` (8-connected, integer ends),
    in place; returns `img`. Thickness 1 is OpenCV's Bresenham line. A
    thicker line is first clipped to the frame widened by `thickness` on
    every side, then drawn as OpenCV's `ThickLine`: the quadrilateral of the
    segment widened by `thickness` in 16-bit fixed point, filled, and a
    filled circle of radius (thickness + 1) // 2 at each end."""
    if not 0 < thickness <= 32767:
        raise ValueError(f"thickness must be in [1, 32767], got {thickness}")
    (a, b), (c, d) = (tuple(int(v) for v in p) for p in (p0, p1))
    if thickness == 1:
        _line8(img, (a, b), (c, d), color)
        return img
    h, w = img.shape[:2]
    m = thickness
    inside, a, b, c, d = _clip_line(w + 2 * m, h + 2 * m, a + m, b + m, c + m, d + m)
    if not inside:
        return img
    x0, y0, x1, y1 = ((v - m) << XY_SHIFT for v in (a, b, c, d))
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r)
        ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))   # cvRound: ties to even
        _fill_convex(img, [(x0 + ex, y0 + ey), (x0 - ex, y0 - ey), (x1 - ex, y1 - ey),
                           (x1 + ex, y1 + ey)], color, XY_SHIFT)
    for x, y in ((x0, y0), (x1, y1)):
        _fill_circle(img, (x + (XY_ONE >> 1)) >> XY_SHIFT, (y + (XY_ONE >> 1)) >> XY_SHIFT,
                     (t + (XY_ONE >> 1)) >> XY_SHIFT, color)
    return img
