#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`cppf2_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the kernel build: every
     `cppf2_torch/csrc/*.cu` compiled with nvcc for sm_90a, in parallel;
  2. each kernel against its plain PyTorch version on the same inputs on the
     card, with its time (CUDA events, after warm-up) beside the plain
     version's, one PyTorch library call's and the bound of the card:
       K2 hist16_peak at 100k and 400k votes with a forced peak tie: exact;
       K1 mha at (16, 1025, 64), (16, 1152, 64) with t_real 1025 and
       (16, 4097, 64), bf16: atol 2e-2 (about 2 bf16 ulps of |o| < 1);
  3. the slice at full width: `estimate_instance` for one mug on a 480x640
     synthetic frame (REAL275 K), 8192 points, 50,000 pairs, 1-degree
     sphere, 100 alignment steps, ViT-L/14 at stride 8 with seeded random
     weights, bf16 branches with the shipped mug weights. The launch counts
     are zeroed just before it and read just after: 24 K1 launches (one ViT
     forward) and 8 K2 launches (4 levels x 2 branches). It runs again with
     every kernel swapped for its plain version and the same draws, and the
     two poses must agree. Then the e2e time per instance.
  4. the multi-device path, on a world-1 NCCL process group (FileStore in a
     temporary directory, no network):
       K3 sphere_accumulate against its plain version at (1, 900k, 720) and
       (4, 900k, 720), tol 1 degree: 0/1 weights (vote_rotation masks) exact
       with the same top index, random f32 weights rtol 1e-5;
       rotation votes: vote_rotation over 5,000 pairs of the slice frame's
       cloud with the true angles to a known axis, accumulated by
       tuple_sharded_sphere_vote, must find the axis within 2 tol;
       image_sharded_tuple_vote on a (1, 1) ("dcn", "data") mesh at B = 4
       must equal four B = 1 calls; 6 K3 launches;
       evaluate_real275_parallel end to end on a one-frame REAL275-format
       folder written here (4 instances, a 16-bit depth PNG) at the
       production PipelineConfig: 16 K2 launches (4 levels x 4 instances,
       geometry branch) in each of two runs; the first run's poses become
       the frame's ground truth, so the second (same seed) must score finite
       APs of 1; the time per instance of the second run.

Before the last line: one JSON object with every kernel's numbers, then the
card's name and power limit. The last line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pickle
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
PEAK_F32_INSTR = 67e12 / 2  # H100 SXM f32 instructions/s: 67 TFLOP/s counts an FMA as two
K3_INSTR = 7               # f32 instructions per (vote, point): 3 FMUL, 2 FADD, FSETP, FADD
REAL275_K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
                     np.float32)


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_frame(rng, h=480, w=640, radius=0.11, center=(0.05, -0.02, 0.82)):
    """A ~20 cm sphere cap at 0.8 m, ~25k mask pixels (more than the
    8192-voxel budget, like a close REAL275 instance), and a random RGB."""
    cx, cy, cz = center
    fx, fy = REAL275_K[0, 0], REAL275_K[1, 1]
    uu = REAL275_K[0, 2] - fx * cx / cz
    vv = REAL275_K[1, 2] - fy * cy / cz
    ys, xs = np.mgrid[0:h, 0:w]
    d2 = (xs - uu) ** 2 + (ys - vv) ** 2
    mask = d2 < (radius * fx / cz) ** 2
    bump = np.sqrt(np.maximum(radius ** 2 - d2 * (cz / fx) ** 2, 0.0))
    depth = np.where(mask, cz - bump + rng.normal(0, 3e-4, (h, w)), 0.0).astype(np.float32)
    rgb = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    return rgb, depth, mask


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def hist16_votes(v: int, dev, seed: int):
    """Clustered votes around a window, with the cells (9, 3, 4) and
    (2, 12, 7) forced to the same, largest count: the lower flat index,
    (2, 12, 7), must win."""
    import torch

    from cppf2_torch.ops import hist16

    g = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([-0.1, 0.05, 0.6], device=dev)
    cell = torch.tensor([0.011, 0.007, 0.013], device=dev)
    cand = lo + (8.0 + 4.0 * torch.randn((v, 3), generator=g, device=dev)) * cell
    ok = torch.rand(v, generator=g, device=dev) < 0.9
    flat, _ = hist16._quantize(cand, ok, lo, cell)
    ok &= (flat != 9 * 256 + 3 * 16 + 4) & (flat != 2 * 256 + 12 * 16 + 7)
    tie = v // 50
    cand[:tie] = lo + torch.tensor([9.0, 3.0, 4.0], device=dev) * cell
    cand[tie:2 * tie] = lo + torch.tensor([2.0, 12.0, 7.0], device=dev) * cell
    ok[:2 * tie] = True
    return cand.contiguous(), ok, lo, cell


def check_hist16(dev):
    import torch

    from cppf2_torch.ops import hist16

    rows = []
    for v in (100_000, 400_000):
        cand, ok, lo, cell = hist16_votes(v, dev, seed=v)
        c_k, n_k = hist16.hist16_peak(cand, ok, lo, cell)
        c_p, n_p = hist16.hist16_peak_plain(cand, ok, lo, cell)
        counts = hist16.hist16_counts_plain(cand, ok, lo, cell)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(c_k - c_p)))
        if err != 0.0 or float(n_k) != float(n_p):
            raise AssertionError(f"hist16 V={v}: kernel {c_k.tolist()} {float(n_k)} "
                                 f"vs plain {c_p.tolist()} {float(n_p)}")
        best = int(torch.argmax(counts))
        want = [best // 256, (best // 16) % 16, best % 16]
        got = torch.round((c_k - lo) / cell).long().tolist()
        if got != want or want != [2, 12, 7] or float(n_k) != float(counts.max()):
            raise AssertionError(f"hist16 V={v}: peak {got}, plain argmax {want}, tie at [2, 12, 7]")
        flat, inside = hist16._quantize(cand, ok, lo, cell)
        w = inside.float()
        ms = time_ms(lambda: hist16.hist16_peak(cand, ok, lo, cell))
        plain_ms = time_ms(lambda: hist16.hist16_peak_plain(cand, ok, lo, cell))
        lib_ms = time_ms(lambda: torch.bincount(flat, weights=w, minlength=4096))
        bytes_moved = v * (3 * 4 + 1) + 2 * 3 * 4 + 4 * 4
        bound_ms = bytes_moved / PEAK_BYTES * 1e3
        say(f"[K2 hist16_peak] V={v} peak={got} count={int(n_k)} exact  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bincount {lib_ms:.4f} ms  bound {bound_ms:.5f} ms (bytes)")
        rows.append(dict(v=v, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms))
    return rows


def check_mha(dev):
    import torch
    import torch.nn.functional as F

    from cppf2_torch.ops import attention

    rows = []
    for t, t_real in ((1025, 1025), (1152, 1025), (4097, 4097)):
        g = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn((16, t, 64), generator=g, device=dev) for _ in range(3))
        q = (q / 8.0).bfloat16()
        k, v = k.bfloat16(), v.bfloat16()
        out_k = attention.mha(q, k, v, t_real=t_real)
        out_p = attention.mha_plain(q, k, v, t_real=t_real)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(out_k.float() - out_p.float())[:, :t_real]))
        if not math.isfinite(err) or err > 2e-2:
            raise AssertionError(f"mha T={t} t_real={t_real}: max |kernel - plain| = {err}")
        ms = time_ms(lambda: attention.mha(q, k, v, t_real=t_real))
        plain_ms = time_ms(lambda: attention.mha_plain(q, k, v, t_real=t_real), iters=5)
        qs, ks, vs = (x[None, :, :t_real].contiguous() for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0))
        flops = 4 * 16 * t * t_real * 64
        bytes_moved = 4 * 16 * t * 64 * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_BYTES) * 1e3
        say(f"[K1 mha] h=16 T={t} t_real={t_real} max_abs_err={err:.3g}  kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
            f"bound {bound_ms:.5f} ms (operations)")
        rows.append(dict(t=t, t_real=t_real, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms))
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------

def run_slice(dev, pipe, vit_cfg, frame_hw=(480, 640)):
    """The slice through `estimate_instance`; returns (launches, e2e ms)."""
    import torch

    from cppf2_torch.eval import driver
    from cppf2_torch.models.dinov2 import DinoViT
    from cppf2_torch.ops import attention, hist16

    rgb, depth, mask = make_frame(np.random.default_rng(0), *frame_hw)
    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    models = driver.load_category_models(ckpts, ["mug"], torch.bfloat16, dev)["mug"]
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        vit = DinoViT(vit_cfg).eval()
    vit.init_random(gen).cast_for_inference()
    draws = driver.draw_instance(depth.shape, mask, "mug", pipe, dev, gen)

    def once():
        est = driver.estimate_instance(rgb, depth, mask, REAL275_K, models, "mug", pipe,
                                       vit=vit, device=dev, draws=draws)
        torch.cuda.synchronize()
        return est

    attention.mha.launches = 0
    hist16.hist16_peak.launches = 0
    t0 = time.perf_counter()
    est = once()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"mha": attention.mha.launches, "hist16_peak": hist16.hist16_peak.launches}
    say(f"[slice] first call {first_ms:.1f} ms, launches {launches}")
    if launches != {"mha": vit_cfg.depth, "hist16_peak": pipe.vote_levels * 2}:
        raise AssertionError(f"launch counts {launches}: expected 24 K1 and 8 K2")

    r = est.rotation.double().cpu().numpy()
    vals = [est.rotation, est.translation, est.scale, est.scale_norm, est.loss]
    if not all(bool(torch.isfinite(x).all()) for x in vals):
        raise AssertionError(f"non-finite pose: {est}")
    if est.rotation.shape != (3, 3) or est.translation.shape != (3,) or est.scale.shape != (3,):
        raise AssertionError("pose of the wrong shape")
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-4) or abs(np.linalg.det(r) - 1) > 1e-4:
        raise AssertionError(f"rotation not orthonormal: {r}")
    say(f"[slice] R={np.round(r, 4).tolist()} T={est.translation.tolist()} "
        f"s={est.scale.tolist()} loss={float(est.loss):.5f} pick={int(est.pick)}")

    kernel_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        once()
        kernel_times.append((time.perf_counter() - t0) * 1e3)

    # the same draws with every kernel swapped for its plain version
    saved = attention.mha, hist16.hist16_peak
    attention.mha, hist16.hist16_peak = attention.mha_plain, hist16.hist16_peak_plain
    try:
        plain = once()
        t0 = time.perf_counter()
        once()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        attention.mha, hist16.hist16_peak = saved
    rp = plain.rotation.double().cpu().numpy()
    ang = math.degrees(math.acos(max(-1.0, min(1.0, (np.trace(r.T @ rp) - 1) / 2))))
    dt = float(torch.max(torch.abs(est.translation - plain.translation)))
    ds = float(torch.max(torch.abs(est.scale - plain.scale) / torch.abs(plain.scale)))
    say(f"[slice] kernels vs plain: R {ang:.4f} deg, T {dt * 1e3:.4f} mm, s rel {ds:.2e}, "
        f"pick {int(est.pick)} vs {int(plain.pick)}")
    # Tolerance: the same draws and exact K2 counts give the same votes; K1
    # and its plain version round P to bf16 at different points, which can
    # flip a bf16 descriptor and so a bin sample of the visual branch, and
    # the L1 alignment's Adam steps amplify float noise near the optimum.
    if ang > 1.0 or dt > 3e-3 or ds > 2e-2 or int(est.pick) != int(plain.pick):
        raise AssertionError("kernel path and plain path disagree")
    e2e_ms = statistics.median(kernel_times)
    say(f"[slice] e2e per instance: kernels {e2e_ms:.1f} ms (median of {kernel_times}), "
        f"plain {plain_ms:.1f} ms")
    stage_breakdown(once)
    device_busy(once, e2e_ms)
    return launches, e2e_ms


@contextlib.contextmanager
def timed_calls(targets):
    """Swap each (module, name) function for one that adds its host time,
    bracketed by device synchronizations, to spent[name]; yields spent."""
    import torch

    spent = {name: 0.0 for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield spent
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def stage_breakdown(once):
    """Host time of each stage of one instance, each stage bracketed by
    device synchronizations (which add a little time of their own)."""
    from cppf2_torch.eval import driver
    from cppf2_torch.infer import pipeline

    targets = [(driver, "preprocess_frame"), (driver, "bbox_crop_descriptors"),
               (pipeline, "vote_center"), (pipeline, "backvote_filter"),
               (pipeline, "sphere_vote_cone"), (pipeline, "align_pose")]
    with timed_calls(targets) as spent:
        t0 = time.perf_counter()
        once()
        total = (time.perf_counter() - t0) * 1e3
    rest = total - sum(spent.values())
    parts = ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
    say(f"[slice] stages (ms, both branches summed): {parts}, rest {rest:.1f}, total {total:.1f}")


def device_busy(once, e2e_ms):
    """Sum of the device time of every kernel of one instance (torch.profiler),
    against the instance's unprofiled wall time. Only the kernel events are
    summed: an operator's own row repeats the time of the kernels it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        once()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    say(f"[slice] device busy {dev_ms:.1f} ms of {e2e_ms:.1f} ms wall "
        f"({100 * dev_ms / e2e_ms:.1f}% busy); top kernels: " +
        "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms" for e in top))


# ---------------------------------------------------------------------------
# Phase 4: the multi-device path
# ---------------------------------------------------------------------------

def frame_cloud(dev, pipe):
    """The valid points of the slice frame's downsampled cloud."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.eval import driver
    from cppf2_torch.infer.frontend import auto_crop, preprocess_frame

    _, depth, mask = make_frame(np.random.default_rng(0))
    draws = driver.draw_instance(depth.shape, mask, "mug", pipe, dev,
                                 torch.Generator(device=dev).manual_seed(1))
    fi = preprocess_frame(torch.as_tensor(depth, device=dev), torch.as_tensor(mask, device=dev),
                          torch.as_tensor(REAL275_K, device=dev), draws.voxel_perm, draws.voxel_prio,
                          res=get_category("mug").res, n_max=pipe.n_points, shot_k=pipe.neighbor_k,
                          crop=auto_crop(mask))
    return fi.pc[:int(fi.count)]


def rotation_votes(pts, axis, n_pairs, seed):
    """vote_rotation over `n_pairs` random pairs of `pts`, given each pair's
    true angle to `axis`: (dirs (n_pairs * 180, 3), 0/1 weights)."""
    import torch

    from cppf2_torch.ops import voting

    g = torch.Generator(device=pts.device).manual_seed(seed)
    idx = torch.randint(0, pts.shape[0], (n_pairs, 2), generator=g, device=pts.device)
    ab = pts[idx[:, 0]] - pts[idx[:, 1]]
    length = torch.linalg.norm(ab, dim=-1)
    ang = torch.arccos(torch.clamp((ab / length.clamp(min=1e-9)[:, None]) @ axis, -1.0, 1.0))
    dirs, ok = voting.vote_rotation(pts, ang, idx, length > 1e-4, num_rots=180)
    return dirs.contiguous(), ok.float()


def k3_bound_ms(b, v, s):
    ops = b * v * s * K3_INSTR
    bytes_moved = b * v * 16 + s * 12 + b * s * 4
    return max(ops / PEAK_F32_INSTR, bytes_moved / PEAK_BYTES) * 1e3, ops


def check_sphere(dev, votes, sph, tol):
    """K3 against its plain version at (1, V, S) and (4, V, S)."""
    import torch

    from cppf2_torch.ops import sphere

    t = sphere.threshold(tol)
    rows = []
    for b in (1, 4):
        dirs = torch.stack([d for d, _ in votes[:b]])
        masks = torch.stack([w for _, w in votes[:b]])
        g = torch.Generator(device=dev).manual_seed(b)
        rand_w = torch.rand(masks.shape, generator=g, device=dev)
        c_k = sphere.sphere_accumulate(dirs, masks, sph, tol)
        c_p = sphere.sphere_accumulate_plain(dirs, masks, sph, tol)
        r_k = sphere.sphere_accumulate(dirs, rand_w, sph, tol)
        r_p = sphere.sphere_accumulate_plain(dirs, rand_w, sph, tol)
        torch.cuda.synchronize()
        if not torch.equal(c_k, c_p) or not torch.equal(c_k.argmax(-1), c_p.argmax(-1)):
            raise AssertionError(f"K3 B={b}: 0/1 counts differ by {float((c_k - c_p).abs().max())}")
        rel = float(torch.max(torch.abs(r_k - r_p) / torch.clamp(torch.abs(r_p), min=1e-30)))
        err = float(torch.max(torch.abs(r_k - r_p)))
        if not torch.allclose(r_k, r_p, rtol=1e-5, atol=0.0):
            raise AssertionError(f"K3 B={b}: f32-weight counts differ, max rel {rel:.3g}")
        v = dirs.shape[1]

        def library():
            # the chunked two-matmul form of sphere_vote, TF32 off
            out = torch.zeros((b, sph.shape[0]), device=dev)
            for i in range(b):
                for lo in range(0, v, sphere.PLAIN_CHUNK):
                    hits = (dirs[i, lo:lo + sphere.PLAIN_CHUNK] @ sph.T > t).float()
                    out[i] += rand_w[i, lo:lo + sphere.PLAIN_CHUNK] @ hits
            return out

        ms = time_ms(lambda: sphere.sphere_accumulate(dirs, rand_w, sph, tol))
        plain_ms = time_ms(lambda: sphere.sphere_accumulate_plain(dirs, rand_w, sph, tol), iters=3)
        lib_ms = time_ms(library, iters=5)
        bound_ms, ops = k3_bound_ms(b, v, sph.shape[0])
        say(f"[K3 sphere_accumulate] B={b} V={v} S={sph.shape[0]} 0/1 exact (peak "
            f"{int(c_k.max())} at {c_k.argmax(-1).tolist()}), f32 max_abs_err={err:.3g} "
            f"max_rel={rel:.3g}  kernel {ms:.4f} ms ({ops / ms / 1e9:.2f} T f32 op/s)  "
            f"plain {plain_ms:.4f} ms  two-matmul {lib_ms:.4f} ms  bound {bound_ms:.5f} ms "
            f"(operations)")
        rows.append(dict(b=b, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, tflops=ops / ms / 1e9))
    return rows


def write_png16(path, img):
    """A 16-bit grayscale PNG (filter 0 on every row) from zlib and struct."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    h, w = img.shape
    raw = b"".join(b"\x00" + img[y].astype(">u2").tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_real275_frame(root, h=480, w=640):
    """One REAL275-format frame: four sphere caps of four categories at
    0.8-0.9 m, their masks as detections, a depth PNG in millimetres."""
    from cppf2_torch.config import SYNSET_NAMES

    cats = ["bottle", "bowl", "can", "mug"]
    centers = [(-0.13, -0.08, 0.82), (0.12, -0.07, 0.88), (-0.11, 0.09, 0.85), (0.13, 0.08, 0.8)]
    radii = [0.045, 0.07, 0.05, 0.06]
    rng = np.random.default_rng(4)
    fx, fy = REAL275_K[0, 0], REAL275_K[1, 1]
    ys, xs = np.mgrid[0:h, 0:w]
    depth = np.zeros((h, w), np.float32)
    masks, rts, scales = [], [], []
    for (cx, cy, cz), r in zip(centers, radii):
        d2 = (xs - (REAL275_K[0, 2] + fx * cx / cz)) ** 2 + (ys - (REAL275_K[1, 2] + fy * cy / cz)) ** 2
        m = d2 < (r * fx / cz) ** 2
        bump = np.sqrt(np.maximum(r ** 2 - d2 * (cz / fx) ** 2, 0.0))
        depth = np.where(m, cz - bump + rng.normal(0, 3e-4, (h, w)), depth).astype(np.float32)
        masks.append(m)
        rt = np.eye(4)
        rt[:3, 3] = (cx, cy, cz)
        rts.append(rt)
        scales.append(np.full(3, 2 * r))
    os.makedirs(os.path.join(root, "detections"))
    os.makedirs(os.path.join(root, "images"))
    write_png16(os.path.join(root, "images", "scene_1_0000_depth.png"),
                np.round(depth * 1000).astype(np.uint16))
    ids = np.array([SYNSET_NAMES.index(c) for c in cats])
    res = {"image_path": "data/real/test/scene_1_0000", "gt_class_ids": ids,
           "gt_RTs": np.stack(rts), "gt_scales": np.stack(scales),
           "gt_handle_visibility": np.ones(4, np.int64), "pred_class_ids": ids,
           "pred_masks": np.stack(masks, -1), "pred_bboxes": np.zeros((4, 4), np.int64),
           "pred_scores": np.ones(4)}
    with open(os.path.join(root, "detections", "results_scene_1_0000.pkl"), "wb") as f:
        pickle.dump(res, f)
    return os.path.join(root, "detections"), os.path.join(root, "images")


def zero_counts():
    from cppf2_torch.ops import attention, hist16, sphere

    attention.mha.launches = hist16.hist16_peak.launches = sphere.sphere_accumulate.launches = 0


def read_counts():
    from cppf2_torch.ops import attention, hist16, sphere

    return {"mha": attention.mha.launches, "hist16_peak": hist16.hist16_peak.launches,
            "sphere_accumulate": sphere.sphere_accumulate.launches}


def run_multi_device(dev, pipe, tmp, backend="nccl", n_pairs=5000):
    """Phase 4 on a world-1 process group; returns (K3 rows, K3 launches,
    eval launches, eval ms per instance, the same without model loading and
    scoring)."""
    import torch
    import torch.distributed as dist

    from cppf2_torch import parallel
    from cppf2_torch.core.geometry import fibonacci_sphere
    from cppf2_torch.eval import parallel_eval

    tol = pipe.angle_tol_deg
    sph = torch.from_numpy(fibonacci_sphere(pipe.sphere_samples)).to(dev)
    pts = frame_cloud(dev, pipe)
    rng = np.random.default_rng(2)
    axes = rng.choice(sph.shape[0], 4, replace=False)
    votes = [rotation_votes(pts, sph[a], n_pairs, seed=i) for i, a in enumerate(axes)]
    say(f"[votes] {len(votes)} images x {votes[0][0].shape[0]} votes ({n_pairs} pairs x 180) on "
        f"the {sph.shape[0]}-point sphere, tol {tol} deg, cloud of {pts.shape[0]} points")
    k3 = check_sphere(dev, votes, sph, tol)

    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    try:
        zero_counts()
        mesh = parallel.make_mesh(device=dev.type)
        best, count = parallel.tuple_sharded_sphere_vote(votes[0][0], votes[0][1], sph, tol, mesh)
        off = math.degrees(math.acos(max(-1.0, min(1.0, float(best @ sph[axes[0]])))))
        say(f"[votes] tuple_sharded_sphere_vote: {off:.4f} deg from the true axis, count "
            f"{float(count):.0f}")
        if off > 2 * tol:
            raise AssertionError(f"voted axis {off:.3f} deg from the true one (limit {2 * tol})")
        slice_mesh = parallel.make_slice_mesh(1, 1, device=dev.type)
        dirs_b = torch.stack([d for d, _ in votes])
        w_b = torch.stack([w for _, w in votes])
        many = parallel.image_sharded_tuple_vote(dirs_b, w_b, sph, tol, slice_mesh)
        for i in range(len(votes)):
            one = parallel.image_sharded_tuple_vote(dirs_b[i:i + 1], w_b[i:i + 1], sph, tol,
                                                    slice_mesh)
            if not (torch.equal(one.best[0], many.best[i]) and torch.equal(one.count[0], many.count[i])):
                raise AssertionError(f"image {i}: B=4 {many.best[i].tolist()} {float(many.count[i])} "
                                     f"vs B=1 {one.best[0].tolist()} {float(one.count[0])}")
        hit = [math.degrees(math.acos(max(-1.0, min(1.0, float(many.best[i] @ sph[a])))))
               for i, a in enumerate(axes)]
        k3_launches = read_counts()
        say(f"[votes] image_sharded_tuple_vote B=4 equals four B=1 calls; axes off by "
            f"{[round(x, 4) for x in hit]} deg; launches {k3_launches}")
        if k3_launches != {"mha": 0, "hist16_peak": 0, "sphere_accumulate": 6}:
            raise AssertionError(f"launch counts {k3_launches}: expected 6 K3")

        det_dir, img_dir = write_real275_frame(os.path.join(tmp, "real275"))
        ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
        # run 0 poses the frame; its poses then become the frame's ground
        # truth, so run 1 (same seed) must pose identically and score AP 1
        runs = []
        for i in range(2):
            zero_counts()
            with timed_calls([(parallel_eval, "load_category_models"),
                              (parallel_eval, "compute_degree_cm_map")]) as spent:
                t0 = time.perf_counter()
                iou_aps, pose_aps = parallel_eval.evaluate_real275_parallel(
                    det_dir, img_dir, os.path.join(tmp, f"eval{i}"), ckpt_root=ckpts, pipe=pipe,
                    seed=0, device=dev.type)
                wall = (time.perf_counter() - t0) * 1e3
            launches = read_counts()
            with open(os.path.join(tmp, f"eval{i}", "results_scene_1_0000.pkl"), "rb") as f:
                res = pickle.load(f)
            pose_ms = wall - sum(spent.values())
            runs.append((wall, launches, pose_ms))
            say(f"[eval] run {i}: {wall:.1f} ms for 4 instances ({wall / 4:.1f} ms per instance): "
                f"model loading {spent['load_category_models']:.1f} ms, scoring "
                f"{spent['compute_degree_cm_map']:.1f} ms, the rest {pose_ms:.1f} ms "
                f"({pose_ms / 4:.1f} ms per instance); launches {launches}; mean 3D IoU AP@25 "
                f"{iou_aps[-1, 25]:.3f} @50 {iou_aps[-1, 50]:.3f}, 5deg5cm AP {pose_aps[-1, 0, 0]:.3f}")
            if launches != {"mha": 0, "hist16_peak": 16, "sphere_accumulate": 0}:
                raise AssertionError(f"launch counts {launches}: expected 16 K2")
            rts = res["pred_RTs"]
            if not np.isfinite(rts).all() or any(np.allclose(rt, np.eye(4)) for rt in rts):
                raise AssertionError(f"an instance was not posed: {rts}")
            if i == 0:
                det_pkl = os.path.join(det_dir, "results_scene_1_0000.pkl")
                with open(det_pkl, "rb") as f:
                    det = pickle.load(f)
                det["gt_RTs"], det["gt_scales"] = res["pred_RTs"], res["pred_scales"]
                with open(det_pkl, "wb") as f:
                    pickle.dump(det, f)
            elif not (np.isfinite(iou_aps[-1, :100]).all() and np.isfinite(pose_aps[-1]).all()
                      and iou_aps[-1, 50] == 1.0 and pose_aps[-1, 0, 0] == 1.0):
                raise AssertionError("run 1 against run 0's poses: APs not finite or not 1")
    finally:
        dist.destroy_process_group()
    wall, launches, pose_ms = runs[1]
    return k3, k3_launches["sphere_accumulate"], launches, wall / 4, pose_ms / 4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from cppf2_torch import resolve_device
    from cppf2_torch.ops import _build, attention, hist16, sphere

    dev = resolve_device("cuda")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    card = card_line()
    say(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    paths = _build.build(verbose=True)
    say(f"[build] {sorted(p.name for p in paths.values())} in {time.perf_counter() - t0:.1f} s")

    k2 = check_hist16(dev)
    k1 = check_mha(dev)
    from cppf2_torch.config import PipelineConfig
    from cppf2_torch.models.dinov2 import VIT_L14

    pipe = PipelineConfig()
    if (pipe.n_points, pipe.num_pairs, pipe.angle_tol_deg, pipe.opt_steps) != (8192, 50000, 1.0, 100):
        raise AssertionError(f"not the production configuration: {pipe}")
    launches, e2e_ms = run_slice(dev, pipe, VIT_L14)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k3, k3_launches, eval_launches, eval_ms, pose_ms = run_multi_device(dev, pipe, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    k1_main = k1[0]      # (16, 1025, 64): the ViT-L stride-8 shape
    k2_main = k2[1]      # 400k votes: a fine level
    k3_main = k3[0]      # (1, 900k, 720): one instance's sampled rotation votes
    kernels = [
        dict(name="mha", route="cuda", source=attention.SOURCE, replaces=attention.REPLACES,
             launches=launches["mha"], max_abs_err=max(r["err"] for r in k1),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by="operations", library_ms=k1_main["library_ms"]),
        dict(name="hist16_peak", route="cuda", source=hist16.SOURCE, replaces=hist16.REPLACES,
             launches=launches["hist16_peak"], max_abs_err=max(r["err"] for r in k2),
             ms=k2_main["ms"], plain_ms=k2_main["plain_ms"], bound_ms=k2_main["bound_ms"],
             bound_by="bytes", library_ms=k2_main["library_ms"]),
        dict(name="sphere_accumulate", route="cuda", source=sphere.SOURCE, replaces=sphere.REPLACES,
             launches=k3_launches, max_abs_err=max(r["err"] for r in k3),
             ms=k3_main["ms"], plain_ms=k3_main["plain_ms"], bound_ms=k3_main["bound_ms"],
             bound_by="operations", library_ms=k3_main["library_ms"]),
    ]
    say(f"[slice] e2e_ms_per_instance {e2e_ms:.1f}")
    say(f"[eval] evaluate_real275_parallel ms_per_instance {eval_ms:.1f}, without model loading "
        f"and scoring {pose_ms:.1f} (world 1, launches {eval_launches})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
