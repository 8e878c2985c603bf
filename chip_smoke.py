#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`cppf2_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the kernel build: every
     `cppf2_torch/csrc/*.cu` compiled with nvcc for sm_90a, in parallel;
  2. each kernel against its plain PyTorch version on the same inputs on the
     card, with its time beside the plain version's, one PyTorch library
     call's and the bound of the card. Every time is taken two ways: back to
     back (CUDA events around 20 calls through the wrapper, as the path calls
     it; for K1 and K2 the wrapper's host time exceeds the kernel's, so this
     moves with the host's load) and on the device alone (the device time of
     the call's kernels as torch.profiler records them). A kernel time below
     the card's bound fails the run:
       K2 hist16_peak at 100k and 400k votes with a forced peak tie, twice in
       a row on one stream (the kernel leaves its scratch zeroed): exact;
       K1 mha at T = 1, 64, 65 (the edges of one tile, untimed), then at
       (16, 1025, 64), (16, 1152, 64) with t_real 1025 and (16, 4097, 64),
       bf16 and f32 output: atol 2^-8 (measured 2^-10 to 2^-9 on an H100;
       with q / 8 a typical |o| at T = 4097 is about 0.026, so a kernel
       that returns zeros fails);
       strided (h, T, 64) views of a (T, 3 * 1024) tensor equal the
       contiguous call;
  3. the slice at full width: `estimate_instance` for one mug on a 480x640
     synthetic frame (REAL275 K), 8192 points, 50,000 pairs, 1-degree
     sphere, 100 alignment steps, ViT-L/14 at stride 8 with seeded random
     weights, bf16 branches with the shipped mug weights. The launch counts
     are zeroed just before it and read just after: 24 K1 launches (one ViT
     forward) and 8 K2 launches (4 levels x 2 branches). It runs again with
     every kernel swapped for its plain version and the same draws, and the
     two poses must agree. Then the e2e time per instance, the stage
     breakdown and the device-busy share. Then the fused level
     (hist16_level_peak) against its plain version on the inputs of all 8
     levels of that instance (both branches): the same peak cell and the
     same count, exactly; timed at level 0, a coarse arc level and a fine one.
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

  5. K1 on a batch of images: `mha` on the (B, 16, 1025, 64) views of a
     (B, 1025, 3072) projection, B = 4 and 8, in one launch, against
     `mha_plain` (max |diff| at most the single image's 0.00195) and against B
     launches on single images (equal); its time beside B x the single-image
     time, SDPA on the same shape and B x the single-image bound.
  6. the frame driver: two REAL275-format frames written here (four instances
     of four categories each, a 16-bit depth PNG and an 8-bit colour PNG)
     through `evaluate_real275` at the production PipelineConfig, ViT-L/14 at
     stride 8 (seeded random weights), bf16 branches from ckpts_r3, injected
     draws. One ViT forward per frame: 24 K1 launches a frame, and 8 K2
     launches an instance. Every instance is posed; each pose equals
     `fetch_instances([dispatch_instance(...)])` on the same draws within R
     1 degree, T 3 mm, with the same branch pick; the batched token grids
     equal the single-image grids within 2e-2; the first frame's
     `dispatch_frame` runs under torch.cuda.set_sync_debug_mode("warn") and
     the profiler, and any device-to-host copy in it fails the run; a second
     run scores AP 1 against the first run's poses. Then ms per frame and per
     instance, the same eight instances one by one (each fetched before the
     next is dispatched), the visual stage both ways, the device-busy share.
  7. the trainer, on a world-1 NCCL group: 64 sphere-cap frames (2048 points)
     written as record containers, then `train_category` for `shot` and
     `dino` (40 steps, 10,000 tuples, full-width branches) and 10 steps of
     `dino-e2e` (ViT-S/14, stride 8, 1025 tokens, "hbm" attention). Finite
     metrics; the loss of the last 10 steps below the first 10; a checkpoint
     restores to the same step and the same next-step loss, bit for bit;
     the exported params.msgpack poses an instance; the backbone's
     parameters move; no kernel of the port is launched by a train step, and
     K1 raises when handed a tensor that requires grad. ms per step.

  8. the trainer on frames it renders itself, on a world-1 NCCL group: a mug
     through both renderers (480x640; 250,000 surface samples; the raster
     pass on the mesh subdivided to 1/48) on the card and on the CPU with the
     same draws, coverage equal on 99.9% of pixels, depth and gray within
     1e-5; ms per rendered frame of each renderer, split into host mesh +
     samples, device render, frame tail and the one read;
     DinoFeatureExtractor (ViT-L/14 at stride 4, K1 at (16, 4097, 64)) on a
     rendered frame, its K1 route against its "hbm" route at layer scale 1
     (max |diff| 2e-3, cosine 0.9999), ms per call and K1's share of the
     production extractor's device time; then
     `train_category` without records for `shot`, `dino` (40 steps) and
     `dino-e2e` (10 steps), pools of 64 frames of 2048 points, 10,000
     tuples: 24 K1 launches per pool frame and per refresh of the "dino" pool
     and none in any step, the loss falling, ms per step (one render each);
     a rendered frame posed through `estimate_instance` with the exported
     weights.

  9. the demo (`python -m cppf2_torch.demo`, called in process as
     `demo.main([...])`): three 480x640 tabletop frames written here as PNGs
     (a plane at 1 m, a mug-sized sphere cap and a small one, moving from
     frame to frame), a seeded random ViT-L/14 written as an official DINOv2
     .pth (1.2 GB, its write timed apart), and a reference-release Lightning
     tree whose version_10 holds ckpts_r3's mug branches in BeyondCPPF's key
     layout and version_9 the bowl's (loaded branches equal ckpts_r3's, every
     tensor); then `--auto-mask` at the production PipelineConfig with the
     extractor at stride 4: 24 K1 launches at (16, 4097, 64) and 8 K2
     launches per frame, the .pth loads as the ViT it came from, an overlay
     PNG and a pose file per frame read back, the proposer's pick overlaps the
     mug on every frame (IoU 0.5); the same run with every kernel swapped for
     its plain version: the same masks and branch picks, R within 1 degree, T
     within 3 mm. ms per frame split into image read, proposer, descriptor
     stage, pose, overlay + PNG write, and the device-busy share.

Before the last line: one JSON object with every kernel's numbers (K2 is one
row: the 8 launches of the slice, all through the fused entry, with a fine
level's times, and the demo's launches; the candidate-array entry's times
stand inside it; K1's row holds the batched shape and the stride-4 shape
nested, the latter with the demo's launches), then the card's name and power
limit. The last line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
PEAK_F32_INSTR = 67e12 / 2  # H100 SXM f32 instructions/s: 67 TFLOP/s counts an FMA as two
K3_INSTR = 7               # f32 instructions per (vote, point): 3 FMUL, 2 FADD, FSETP, FADD
# f32 instructions per vote of a fused K2 level: 15 for the candidate (5 per
# axis), 3 x (FSUB, an IEEE division of about 8, FADD, floor) for the cell,
# 6 compares; an arc level adds 2 for theta and two library trig calls of
# about 40 each on the fast path.
LEVEL_INSTR_CIRCLE = 15 + 3 * 11 + 6
LEVEL_INSTR_ARC = LEVEL_INSTR_CIRCLE + 2 + 2 * 40
# What the kernels that K1 and K2 replaced (mma.sync attention; count kernel,
# peak kernel and a memset per histogram) read back to back in this script on
# an H100 80GB HBM3 at 700 W, keyed by T and by the number of votes.
K1_REPLACED_MS = {1025: 0.0750, 4097: 0.642}
K2_REPLACED_MS = {100_000: 0.0819, 400_000: 0.0708}
REAL275_K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
                     np.float32)


_T0 = time.perf_counter()


def say(*parts):
    """One line of the report, with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:6.1f}s]", *parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3, repeats=5) -> float:
    """Time of one call, back to back: CUDA events around `iters` calls, the
    median of `repeats` such windows. Where the wrapper's host time exceeds
    the kernel's, this is the host time, which varies with the host's load."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return statistics.median(windows)


def device_ms(fn, iters=20) -> float:
    """Time of one call on the device alone: the device time of every kernel,
    copy and memset that `iters` calls ran, as torch.profiler records them.
    No host time is in it, whatever the wrapper costs. The tracer now and
    then drops records (a run once read half a kernel's true time from the
    sum over `iters`), so each kind of record counts with its mean time,
    times its number per call rounded up; a window without any record is
    profiled again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count > 0]
        per_call_us = sum(e.self_device_time_total / e.count * math.ceil(e.count / iters)
                          for e in records)
        if per_call_us > 0:
            break
        say(f"[profiler] window {attempt}: no device record at all, profiled again")
    else:
        # a tracer that records nothing three times over: CUDA events around the same
        # calls, which include the wrapper's host time and so read no lower
        ms = time_ms(fn, iters=iters, repeats=1)
        say(f"[profiler] no device time in three windows: this row's time on the device alone "
            f"is the back-to-back time of CUDA events, {ms:.4f} ms")
        return ms
    dropped = sorted(e.key[:40] for e in records if e.count % iters)
    if dropped:
        say(f"[profiler] records missing of {dropped}: their mean time per record is used")
    return per_call_us / 1e3


def timed(fn, iters=20, repeats=5):
    """(back-to-back ms, device-only ms) of one call of `fn`."""
    return time_ms(fn, iters=iters, repeats=repeats), device_ms(fn, iters=iters)


def above_bound(name, bound_ms, **times):
    """No kernel runs faster than the card can: a time below the bound means
    the measurement is wrong, and the run fails."""
    for what, ms in times.items():
        if ms < bound_ms:
            raise AssertionError(f"{name}: {what} {ms:.5f} ms is below the card's bound "
                                 f"{bound_ms:.5f} ms")


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
        c_p, n_p = hist16.hist16_peak_plain(cand, ok, lo, cell)
        counts = hist16.hist16_counts_plain(cand, ok, lo, cell)
        best = int(torch.argmax(counts))
        want = [best // 256, (best // 16) % 16, best % 16]
        # twice in a row on one stream: the second call finds the scratch the
        # first one left, so any count left behind would show in its result
        for call in range(2):
            c_k, n_k = hist16.hist16_peak(cand, ok, lo, cell)
            torch.cuda.synchronize()
            err = max(float(torch.max(torch.abs(c_k - c_p))), abs(float(n_k) - float(n_p)))
            if err != 0.0:
                raise AssertionError(f"hist16 V={v} call {call}: kernel {c_k.tolist()} "
                                     f"{float(n_k)} vs plain {c_p.tolist()} {float(n_p)}")
            got = torch.round((c_k - lo) / cell).long().tolist()
            if got != want or want != [2, 12, 7] or float(n_k) != float(counts.max()):
                raise AssertionError(f"hist16 V={v}: peak {got}, plain argmax {want}, "
                                     f"tie at [2, 12, 7]")
        flat, inside = hist16._quantize(cand, ok, lo, cell)
        w = inside.float()
        ms, dev_ms = timed(lambda: hist16.hist16_peak(cand, ok, lo, cell))
        plain_ms, plain_dev_ms = timed(lambda: hist16.hist16_peak_plain(cand, ok, lo, cell), iters=10)
        lib_ms, lib_dev_ms = timed(lambda: torch.bincount(flat, weights=w, minlength=4096))
        bytes_moved = v * (3 * 4 + 1) + 2 * 3 * 4 + 4 * 4
        bound_ms = bytes_moved / PEAK_BYTES * 1e3
        above_bound(f"hist16_peak V={v}", bound_ms, ms=ms, device_ms=dev_ms)
        say(f"[K2 hist16_peak] V={v} peak={got} count={int(n_k)} exact, two calls in a row equal  "
            f"back to back / on the device alone, ms: kernel {ms:.4f} / {dev_ms:.4f}  "
            f"plain {plain_ms:.4f} / {plain_dev_ms:.4f}  bincount {lib_ms:.4f} / {lib_dev_ms:.4f}  "
            f"replaced kernels {K2_REPLACED_MS[v]:.4f} back to back  bound {bound_ms:.5f} ms (bytes)")
        rows.append(dict(v=v, err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms))
    return rows


def mha_inputs(t, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn((16, t, 64), generator=g, device=dev) for _ in range(3))
    return (q / 8.0).bfloat16(), k.bfloat16(), v.bfloat16()


def check_mha(dev):
    import torch
    import torch.nn.functional as F

    from cppf2_torch.ops import attention

    def max_err(q, k, v, t_real, out_dtype):
        out_k = attention.mha(q, k, v, t_real=t_real, out_dtype=out_dtype)
        out_p = attention.mha_plain(q, k, v, t_real=t_real, out_dtype=out_dtype)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(out_k.float() - out_p.float())[:, :t_real]))
        if not math.isfinite(err) or err > 2.0 ** -8:
            raise AssertionError(f"mha T={q.shape[1]} t_real={t_real} {out_dtype}: "
                                 f"max |kernel - plain| = {err} (limit 2^-8)")
        return err

    # the edges of one tile, untimed
    edge = {t: max(max_err(*mha_inputs(t, dev), t, dt) for dt in (torch.bfloat16, torch.float32))
            for t in (1, 64, 65)}
    say(f"[K1 mha] h=16 T=1, 64, 65 bf16 and f32 out: max_abs_err "
        f"{', '.join(f'{e:.3g}' for e in edge.values())}")

    # (h, T, 64) views of a (T, 3 * 1024) projection are read in place
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = torch.randn((1025, 3 * 1024), generator=g, device=dev).bfloat16()
    views = [x.reshape(1025, 16, 64).transpose(0, 1) for x in torch.split(qkv, 1024, dim=-1)]
    if not all(attention._tma_readable(x) and not x.is_contiguous() for x in views):
        raise AssertionError("the projection's views are not read in place")
    if not torch.equal(attention.mha(*views), attention.mha(*(x.contiguous() for x in views))):
        raise AssertionError("mha on strided views differs from the contiguous call")
    say("[K1 mha] strided views of a (1025, 3072) projection equal the contiguous call")

    # ViT-S/14 at stride 8, the backbone the trainer's end-to-end step exports and
    # `estimate_instance` then poses with: 6 heads, as a tensor of its own and as the heads of a
    # (1025, 3 * 384) projection read in place, against the plain version at the
    # single image's limit
    g = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn((1025, 3 * 384), generator=g, device=dev)
    qkv[:, :384] /= 8.0
    qkv = qkv.bfloat16()
    views = [x.reshape(1025, 6, 64).transpose(0, 1) for x in torch.split(qkv, 384, dim=-1)]
    if not all(attention._tma_readable(x) and not x.is_contiguous() for x in views):
        raise AssertionError("the 6-head projection's views are not read in place")
    plain6 = attention.mha_plain(*views)
    err6 = {}
    for label, args in (("(6, 1025, 64)", [x.contiguous() for x in views]),
                        ("heads of a (1025, 1152) projection", views)):
        out6 = attention.mha(*args)
        torch.cuda.synchronize()
        err6[label] = float(torch.max(torch.abs(out6.float() - plain6.float())))
        if not math.isfinite(err6[label]) or err6[label] > 2.0 ** -9:
            raise AssertionError(f"mha h=6 {label}: max |kernel - plain| = {err6[label]}")
    say("[K1 mha] h=6 T=1025 (ViT-S/14 stride 8): max_abs_err "
        + ", ".join(f"{k} {e:.3g}" for k, e in err6.items()) + " (limit 2^-9)")

    rows = []
    for t, t_real in ((1025, 1025), (1152, 1025), (4097, 4097)):
        q, k, v = mha_inputs(t, dev)
        err = max(edge.values()) if not rows else 0.0
        err = max(err, max_err(q, k, v, t_real, torch.bfloat16), max_err(q, k, v, t_real, torch.float32))
        ms, dev_ms = timed(lambda: attention.mha(q, k, v, t_real=t_real))
        plain_ms, plain_dev_ms = timed(lambda: attention.mha_plain(q, k, v, t_real=t_real),
                                       iters=5, repeats=1)
        qs, ks, vs = (x[None, :, :t_real].contiguous() for x in (q, k, v))
        lib_ms, lib_dev_ms = timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0))
        flops = 4 * 16 * t * t_real * 64
        bytes_moved = 4 * 16 * t * 64 * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_BYTES) * 1e3
        above_bound(f"mha T={t}", bound_ms, ms=ms, device_ms=dev_ms)
        say(f"[K1 mha] h=16 T={t} t_real={t_real} max_abs_err={err:.3g}  back to back / on the "
            f"device alone, ms: kernel {ms:.4f} / {dev_ms:.4f} ({flops / dev_ms / 1e9:.1f} TFLOP/s "
            f"on the device)  plain {plain_ms:.4f} / {plain_dev_ms:.4f}  sdpa {lib_ms:.4f} / "
            f"{lib_dev_ms:.4f}  "
            + (f"replaced kernel {K1_REPLACED_MS[t]:.4f} back to back  " if t in K1_REPLACED_MS else "")
            + f"bound {bound_ms:.5f} ms (operations)")
        rows.append(dict(t=t, t_real=t_real, err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms))
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------

def run_slice(dev, pipe, vit_cfg, frame_hw=(480, 640)):
    """The slice through `estimate_instance`; returns (launches, e2e ms, the
    fused-level rows of `check_levels`)."""
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

    zero_counts()
    t0 = time.perf_counter()
    est = once()
    first_ms = (time.perf_counter() - t0) * 1e3
    # hist16_peak.launches counts every K2 launch, hist16_level_peak.launches
    # the ones through the fused entry: on this path all of them
    launches = {"mha": attention.mha.launches, "hist16_peak": hist16.hist16_peak.launches,
                "hist16_level_peak": hist16.hist16_level_peak.launches}
    say(f"[slice] first call {first_ms:.1f} ms, launches {launches}")
    if launches != {"mha": vit_cfg.depth, "hist16_peak": pipe.vote_levels * 2,
                    "hist16_level_peak": pipe.vote_levels * 2}:
        raise AssertionError(f"launch counts {launches}: expected 24 K1 and 8 K2, all fused levels")

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
    saved = attention.mha, hist16.hist16_peak, hist16.hist16_level_peak
    attention.mha, hist16.hist16_peak = attention.mha_plain, hist16.hist16_peak_plain
    hist16.hist16_level_peak = hist16.hist16_level_peak_plain
    try:
        plain = once()
        t0 = time.perf_counter()
        once()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        attention.mha, hist16.hist16_peak, hist16.hist16_level_peak = saved
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
    level_rows = check_levels(once, pipe)
    stage_breakdown(once, "fused levels", repeats=2)

    def written_out(c, x0, y0, odist, ok, samples, lo, cell, theta_star=None, span=None):
        # a level as it ran before the fusion: the candidates in device memory, read back by K2
        cand, ok_v = hist16.level_candidates(c, x0, y0, odist, ok, samples, theta_star, span)
        return hist16.hist16_peak(cand, ok_v, lo, cell)

    fused, hist16.hist16_level_peak = hist16.hist16_level_peak, written_out
    try:
        stage_breakdown(once, "candidates written out, as before the fusion", repeats=1)
    finally:
        hist16.hist16_level_peak = fused
    device_busy(once, e2e_ms)
    return launches, e2e_ms, level_rows


def check_levels(once, pipe):
    """The fused K2 level against its plain version on the inputs of every
    level of one instance (both branches): the same peak cell and the same
    count, exactly. Then its time at level 0, a coarse arc level and a fine
    level of the first branch. Returns one row per timed level."""
    import torch

    from cppf2_torch.ops import hist16

    calls, errs = [], []
    kernel = hist16.hist16_level_peak

    def both(*args):
        got = kernel(*args)
        want = hist16.hist16_level_peak_plain(*args)
        torch.cuda.synchronize()
        calls.append(args)
        errs.append(max(float(torch.max(torch.abs(got[0] - want[0]))),
                        abs(float(got[1]) - float(want[1]))))
        if errs[-1] != 0.0 or not torch.equal(got[0], want[0]):
            raise AssertionError(f"fused level {len(calls) - 1}: kernel {got[0].tolist()} "
                                 f"{float(got[1])} vs plain {want[0].tolist()} {float(want[1])}")
        return got

    hist16.hist16_level_peak = both
    try:
        once()
    finally:
        hist16.hist16_level_peak = kernel
    levels = pipe.vote_levels
    if len(calls) != 2 * levels:
        raise AssertionError(f"{len(calls)} fused levels in one instance, expected {2 * levels}")
    say(f"[K2 hist16_level_peak] {len(calls)} levels of both branches: peak cell and count equal "
        f"the plain version's exactly")
    rows = []
    for level in (0, 1, levels - 1):
        args = calls[level]
        c, samples, theta_star = args[0], args[5], args[8] if len(args) > 8 else None
        sub, n_smp, arc = c.shape[0], samples.shape[-1], theta_star is not None
        ms, dev_ms = timed(lambda: kernel(*args))
        plain_ms, plain_dev_ms = timed(lambda: hist16.hist16_level_peak_plain(*args), iters=10)
        per_pair = (9 + 1 + (2 if arc else 0)) * 4 + 1
        bytes_moved = sub * per_pair + samples.numel() * 4 + 2 * 3 * 4 + 4 * 4
        ops = sub * n_smp * (LEVEL_INSTR_ARC if arc else LEVEL_INSTR_CIRCLE)
        by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32_INSTR * 1e3
        above_bound(f"hist16_level_peak level {level}", max(by_bytes, by_ops), ms=ms,
                    device_ms=dev_ms)
        say(f"[K2 hist16_level_peak] level {level} ({'arc' if arc else 'circle'}) {sub} pairs x "
            f"{n_smp} samples  back to back / on the device alone, ms: kernel {ms:.4f} / "
            f"{dev_ms:.4f}  plain {plain_ms:.4f} / {plain_dev_ms:.4f}  bound "
            f"{max(by_bytes, by_ops):.5f} ms ({'operations' if by_ops > by_bytes else 'bytes'}; "
            f"bytes {by_bytes:.5f}, operations {by_ops:.5f})")
        rows.append(dict(level=level, err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=max(by_bytes, by_ops),
                         bound_by="operations" if by_ops > by_bytes else "bytes"))
    return rows


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


def stage_breakdown(once, label, repeats=3):
    """Host time of each stage of one instance, each stage bracketed by
    device synchronizations (which add a little time of their own): the
    median over `repeats` instances, stage by stage."""
    from cppf2_torch.eval import driver
    from cppf2_torch.infer import pipeline

    targets = [(driver, "preprocess_frame"), (driver, "bbox_crop_descriptors"),
               (pipeline, "vote_center"), (pipeline, "backvote_filter"),
               (pipeline, "sphere_vote_cone"), (pipeline, "align_pose")]
    runs = []
    for _ in range(repeats):
        with timed_calls(targets) as spent:
            t0 = time.perf_counter()
            once()
            total = (time.perf_counter() - t0) * 1e3
        runs.append({**spent, "rest": total - sum(spent.values()), "total": total})
    mid = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    parts = ", ".join(f"{k} {v:.1f}" for k, v in mid.items())
    say(f"[slice] stages ({label}; ms, both branches summed, median of {repeats}): {parts}")


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

        ms, dev_ms = timed(lambda: sphere.sphere_accumulate(dirs, rand_w, sph, tol))
        plain_ms = time_ms(lambda: sphere.sphere_accumulate_plain(dirs, rand_w, sph, tol), iters=3, repeats=1)
        lib_ms = time_ms(library, iters=5, repeats=1)
        bound_ms, ops = k3_bound_ms(b, v, sph.shape[0])
        above_bound(f"sphere_accumulate B={b}", bound_ms, ms=ms, device_ms=dev_ms)
        say(f"[K3 sphere_accumulate] B={b} V={v} S={sph.shape[0]} 0/1 exact (peak "
            f"{int(c_k.max())} at {c_k.argmax(-1).tolist()}), f32 max_abs_err={err:.3g} "
            f"max_rel={rel:.3g}  kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms on the device "
            f"alone ({ops / ms / 1e9:.2f} T f32 op/s)  "
            f"plain {plain_ms:.4f} ms  two-matmul {lib_ms:.4f} ms  bound {bound_ms:.5f} ms "
            f"(operations)")
        rows.append(dict(b=b, err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, tflops=ops / ms / 1e9))
    return rows


FRAME_CATS = ["bottle", "bowl", "can", "mug"]


def write_real275_frame(root, h=480, w=640, name="scene_1_0000", seed=4, shift=0.0, color=False):
    """One REAL275-format frame: four sphere caps of four categories at
    0.8-0.9 m (moved sideways by `shift` metres), their masks as detections, a
    depth PNG in millimetres and, with `color`, a random 8-bit colour PNG."""
    from cppf2_torch.config import SYNSET_NAMES
    from cppf2_torch.eval.png import write_png16, write_png_rgb8

    cats = FRAME_CATS
    centers = [(-0.13 + shift, -0.08, 0.82), (0.12 + shift, -0.07, 0.88),
               (-0.11 + shift, 0.09, 0.85), (0.13 + shift, 0.08, 0.8)]
    radii = [0.045, 0.07, 0.05, 0.06]
    rng = np.random.default_rng(seed)
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
    os.makedirs(os.path.join(root, "detections"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    write_png16(os.path.join(root, "images", f"{name}_depth.png"),
                np.round(depth * 1000).astype(np.uint16))
    if color:
        write_png_rgb8(os.path.join(root, "images", f"{name}_color.png"),
                       rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8))
    ids = np.array([SYNSET_NAMES.index(c) for c in cats])
    res = {"image_path": f"data/real/test/{name}", "gt_class_ids": ids,
           "gt_RTs": np.stack(rts), "gt_scales": np.stack(scales),
           "gt_handle_visibility": np.ones(4, np.int64), "pred_class_ids": ids,
           "pred_masks": np.stack(masks, -1), "pred_bboxes": np.zeros((4, 4), np.int64),
           "pred_scores": np.ones(4)}
    with open(os.path.join(root, "detections", f"results_{name}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return os.path.join(root, "detections"), os.path.join(root, "images")


def zero_counts():
    from cppf2_torch.ops import attention, hist16, sphere

    attention.mha.launches = sphere.sphere_accumulate.launches = 0
    hist16.hist16_peak.launches = hist16.hist16_level_peak.launches = 0


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


# ---------------------------------------------------------------------------
# Phase 5: K1 on a batch of images
# ---------------------------------------------------------------------------

def check_mha_batched(dev, single):
    """K1 at (B, 16, 1025, 64), the shape a frame's ViT forward gives it, for
    B = 4 and 8. `single` is check_mha's row of the (16, 1025, 64) shape."""
    import torch
    import torch.nn.functional as F

    from cppf2_torch.ops import attention

    rows = []
    for b in (4, 8):
        g = torch.Generator(device=dev).manual_seed(b)
        qkv = torch.randn((b, 1025, 3 * 1024), generator=g, device=dev)
        qkv[..., :1024] /= 8.0
        qkv = qkv.bfloat16()
        q, k, v = (x.reshape(b, 1025, 16, 64).transpose(1, 2) for x in torch.split(qkv, 1024, dim=-1))
        if not all(attention._tma_readable(x) and not x.is_contiguous() for x in (q, k, v)):
            raise AssertionError("the batched projection's views are not read in place")
        before = attention.mha.launches
        out = attention.mha(q, k, v)
        if attention.mha.launches != before + 1:
            raise AssertionError("a batch of images took more than one launch")
        plain = torch.stack([attention.mha_plain(q[i], k[i], v[i]) for i in range(b)])
        each = torch.stack([attention.mha(q[i], k[i], v[i]) for i in range(b)])
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(out.float() - plain.float())))
        if not math.isfinite(err) or err > 2.0 ** -9:   # one bf16 ulp of |o| < 0.5, as the single image
            raise AssertionError(f"mha B={b}: max |kernel - plain| = {err}")
        if not torch.equal(out, each):
            raise AssertionError(f"mha B={b}: one launch differs from {b} launches on single images")
        ms, dev_ms = timed(lambda: attention.mha(q, k, v))
        plain_ms = time_ms(lambda: [attention.mha_plain(q[i], k[i], v[i]) for i in range(b)],
                           iters=3, repeats=1)
        qs, ks, vs = (x.contiguous() for x in (q, k, v))
        lib_ms, lib_dev_ms = timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0))
        bound_ms = b * single["bound_ms"]
        above_bound(f"mha B={b}", bound_ms, ms=ms, device_ms=dev_ms)
        say(f"[K1 mha, batched] B={b} (B, 16, 1025, 64) views of a (B, 1025, 3072) projection, one "
            f"launch: max_abs_err={err:.3g}, equal to {b} single-image launches  back to back / on "
            f"the device alone, ms: kernel {ms:.4f} / {dev_ms:.4f}  B x the single image "
            f"{b * single['ms']:.4f} / {b * single['device_ms']:.4f}  plain {plain_ms:.4f}  sdpa "
            f"{lib_ms:.4f} / {lib_dev_ms:.4f}  bound {bound_ms:.5f} ms (operations)")
        rows.append(dict(b=b, err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms))
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the frame driver
# ---------------------------------------------------------------------------

def rt_angle_deg(a, b):
    """Angle between the rotations of two NOCS RTs (R * |s| in the 3x3 block)."""
    ra, rb = (x[:3, :3] / np.cbrt(np.linalg.det(x[:3, :3])) for x in (a, b))
    return math.degrees(math.acos(max(-1.0, min(1.0, (np.trace(ra.T @ rb) - 1) / 2))))


def dispatch_without_reads(dispatch):
    """Run `dispatch()` with the sync debug mode on "warn" and under the
    profiler (device records only); returns (its result, the warnings, the
    device-to-host copies it made, the kinds of copy it made, the device time
    of everything it queued in ms). Uploads of host arrays warn too (a
    blocking copy is a synchronizing call); what must not be there is a copy
    back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    reads = [(e.key, e.count) for e in prof.key_averages() if "dtoh" in e.key.lower()]
    memcpys = sorted({e.key for e in prof.key_averages() if "memcpy" in e.key.lower()})
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    return out, syncs, reads, memcpys, busy_ms


def run_frame_driver(dev, pipe, vit_cfg, tmp, hw=(480, 640), n_frames=2, stride=8, out_size=256):
    """Phase 6; returns (launches of the timed run, ms per frame, ms per
    instance one by one, visual stage ms per frame batched and one by one)."""
    import torch

    from cppf2_torch.eval import driver
    from cppf2_torch.eval.pose_errors import pose_error_degree_cm
    from cppf2_torch.models.dinov2 import DinoViT, bbox_crop_token_grid

    root = os.path.join(tmp, "frames")
    names = [f"scene_1_{i:04d}" for i in range(n_frames)]
    for i, name in enumerate(names):
        det_dir, img_dir = write_real275_frame(root, *hw, name=name, seed=10 + i, shift=0.01 * i,
                                               color=True)
    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    models = driver.load_category_models(ckpts, FRAME_CATS, torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.device(dev):
        vit = DinoViT(vit_cfg).eval()
    vit.init_random(gen).cast_for_inference()

    frames, draws = [], []
    for name in names:
        with open(os.path.join(det_dir, f"results_{name}.pkl"), "rb") as f:
            res = pickle.load(f)
        rgb = driver.read_png_rgb8(os.path.join(img_dir, f"{name}_color.png"))
        depth = driver.read_png16(os.path.join(img_dir, f"{name}_depth.png")).astype(np.float32) / 1000
        dets = [(c, res["pred_masks"][:, :, i].astype(bool)) for i, c in enumerate(FRAME_CATS)]
        frames.append((rgb, depth, dets))
        draws.append([driver.draw_instance(depth.shape, m, c, pipe, dev, gen) for c, m in dets])
    n_inst = sum(len(f[2]) for f in frames)
    kw = dict(vit=vit, device=dev, stride=stride, out_size=out_size)

    def evaluate(out):
        with timed_calls([(driver, "compute_degree_cm_map")]) as spent:
            t0 = time.perf_counter()
            aps = driver.evaluate_real275(det_dir, img_dir, os.path.join(tmp, out), None, pipe=pipe,
                                          draws=draws, models=models, **kw)
            wall = (time.perf_counter() - t0) * 1e3
        results = []
        for name in names:
            with open(os.path.join(tmp, out, f"results_{name}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return aps, results, wall - spent["compute_degree_cm_map"]

    # run 0 poses the frames (and warms up); its poses become the ground truth
    zero_counts()
    _, first, _ = evaluate("frames0")
    launches = read_counts()
    want = {"mha": vit_cfg.depth * n_frames, "hist16_peak": 2 * pipe.vote_levels * n_inst,
            "sphere_accumulate": 0}
    say(f"[frames] evaluate_real275 on {n_frames} frames x {len(FRAME_CATS)} instances: launches "
        f"{launches} (one ViT forward a frame: {vit_cfg.depth} K1 launches; "
        f"{2 * pipe.vote_levels} K2 launches an instance)")
    if launches != want:
        raise AssertionError(f"launch counts {launches}: expected {want}")
    for name, res in zip(names, first):
        rts = res["pred_RTs"]
        if not np.isfinite(rts).all() or any(np.allclose(rt, np.eye(4)) for rt in rts):
            raise AssertionError(f"{name}: an instance was not posed: {rts}")

    # each frame again through dispatch_frame (the first one watched for reads from the
    # device), against its instances one by one on the same draws
    worst = dict(r=0.0, t=0.0, grid=0.0, own=0.0, vis_r=0.0, vis_t=0.0)
    all_picks = []
    busy_ms = singles_ms = 0.0
    for n, ((rgb, depth, dets), d, res) in enumerate(zip(frames, draws, first)):
        def dispatch():
            return driver.dispatch_frame(rgb, depth, dets, REAL275_K, models, pipe, draws=d, **kw)

        if n == 0:
            # the uploads of the frame's arrays are certain: a profile without any copy
            # is a tracer that recorded nothing and proves nothing, so it is taken again
            for attempt in range(3):
                pends, syncs, reads, memcpys, busy_ms = dispatch_without_reads(dispatch)
                if memcpys:
                    break
                say(f"[profiler] dispatch_frame, window {attempt}: no copy recorded, profiled again")
            else:
                raise AssertionError("the profiler recorded no copy in three dispatches of a frame")
            where = sorted({f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs})
            say(f"[frames] dispatch_frame under sync debug mode: {len(syncs)} synchronizing calls "
                f"reported (blocking uploads of host arrays), at {where}; copies in the profile: "
                f"{memcpys}; device-to-host copies: {reads}")
            if reads:
                raise AssertionError(f"dispatch_frame read from the device: {reads}")
        else:
            pends = dispatch()
        got, picks = driver.fetch_frames(pends, return_picks=True)
        # one by one, each fetched (a device sync) before the next is dispatched: the graph
        # of estimate_instance, timed
        singles, spicks = [], []
        t0 = time.perf_counter()
        for (c, m), di in zip(dets, d):
            out, pick = driver.fetch_instances(
                [driver.dispatch_instance(rgb, depth, m, REAL275_K, models[c], c, pipe, draws=di, **kw)],
                return_picks=True)
            singles.append(out[0])
            spicks.append(pick[0])
        singles_ms += (time.perf_counter() - t0) * 1e3
        for i in range(len(dets)):
            if got[i] is None or singles[i] is None:
                raise AssertionError(f"instance {i} came back as None")
            ang = rt_angle_deg(got[i][0], singles[i][0])
            dt = float(np.max(np.abs(got[i][0][:3, 3] - singles[i][0][:3, 3])))
            worst["r"], worst["t"] = max(worst["r"], ang), max(worst["t"], dt)
            worst["own"] = max(worst["own"], float(np.max(np.abs(got[i][0] - res["pred_RTs"][i]))))
            if ang > 1.0 or dt > 3e-3 or picks[i] != spicks[i]:
                raise AssertionError(f"instance {i}: frame vs single R {ang:.3f} deg, T {dt * 1e3:.3f} mm, "
                                     f"picks {picks[i]} vs {spicks[i]}")
        all_picks.extend(int(picks[i]) for i in range(len(dets)))
        # the same with the visual branch posing alone, so that the batched forward's
        # grids decide every pose that is compared
        vis_frame = driver.fetch_frames(
            driver.dispatch_frame(rgb, depth, dets, REAL275_K, models, pipe, draws=d, use_geo=False, **kw))
        vis_single = driver.fetch_instances(
            [driver.dispatch_instance(rgb, depth, m, REAL275_K, models[c], c, pipe, draws=di,
                                      use_geo=False, **kw) for (c, m), di in zip(dets, d)])
        for i in range(len(dets)):
            if vis_frame[i] is None or vis_single[i] is None:
                raise AssertionError(f"instance {i}, visual branch alone: came back as None")
            # the repo's symmetry-aware error: about its axis a bottle, bowl or can has no
            # rotation to agree on, and the visual vote alone lands wherever its noise puts it
            ang, cm = pose_error_degree_cm(vis_frame[i][0], vis_single[i][0], dets[i][0])
            dt = cm / 100
            worst["vis_r"], worst["vis_t"] = max(worst["vis_r"], ang), max(worst["vis_t"], dt)
            if ang > 1.0 or dt > 3e-3:
                raise AssertionError(f"instance {i}, visual branch alone: frame vs single R {ang:.3f} "
                                     f"deg, T {dt * 1e3:.3f} mm")
        rgb_t = torch.as_tensor(rgb, device=dev).float() / 255.0
        masks_t = torch.as_tensor(np.stack([m for _, m in dets]), device=dev)
        with torch.no_grad():
            grids, _ = bbox_crop_token_grid(vit, rgb_t, masks_t, out_size=out_size, stride=stride)
            for i in range(len(dets)):
                g1, _ = bbox_crop_token_grid(vit, rgb_t, masks_t[i], out_size=out_size, stride=stride)
                worst["grid"] = max(worst["grid"], float(torch.max(torch.abs(grids[i] - g1))))
    say(f"[frames] frame vs instance by instance on the same draws: R {worst['r']:.4f} deg, T "
        f"{worst['t'] * 1e3:.4f} mm, the same picks {all_picks} (0 visual, 1 geometric); with the "
        f"visual branch posing alone (symmetry-aware error) R {worst['vis_r']:.4f} deg, T "
        f"{worst['vis_t'] * 1e3:.4f} mm; "
        f"batched vs single-image token grids max |diff| "
        f"{worst['grid']:.3g}; dispatch_frame vs evaluate_real275's pkls max |diff| {worst['own']:.3g}")
    if worst["grid"] > 2e-2:
        raise AssertionError(f"batched token grids differ from single-image grids by {worst['grid']}")

    # run 1 against run 0's poses as ground truth: AP 1; this is the timed run
    for name, res in zip(names, first):
        det_pkl = os.path.join(det_dir, f"results_{name}.pkl")
        with open(det_pkl, "rb") as f:
            det = pickle.load(f)
        det["gt_RTs"], det["gt_scales"] = res["pred_RTs"], res["pred_scales"]
        with open(det_pkl, "wb") as f:
            pickle.dump(det, f)
    zero_counts()
    (iou_aps, pose_aps), _, frames_ms = evaluate("frames1")
    timed_launches = read_counts()
    if timed_launches != want:
        raise AssertionError(f"launch counts {timed_launches}: expected {want}")
    if not (np.isfinite(iou_aps[-1, :100]).all() and np.isfinite(pose_aps[-1]).all()
            and iou_aps[-1, 50] == 1.0 and pose_aps[-1, 0, 0] == 1.0):
        raise AssertionError(f"run 1 against run 0's poses: APs not finite or not 1 "
                             f"(IoU50 {iou_aps[-1, 50]}, 5deg5cm {pose_aps[-1, 0, 0]})")

    def visual(batched):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for m in ([masks_t] if batched else list(masks_t)):
                bbox_crop_token_grid(vit, rgb_t, m, out_size=out_size, stride=stride)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    vis_batched = statistics.median(visual(True) for _ in range(3))
    vis_singles = statistics.median(visual(False) for _ in range(3))
    say(f"[frames] evaluate_real275 without scoring: {frames_ms / n_frames:.1f} ms per frame, "
        f"{frames_ms / n_inst:.1f} ms per instance; the same {n_inst} instances one by one (the "
        f"graph of estimate_instance, each fetched before the next) {singles_ms / n_inst:.1f} ms per "
        f"instance; visual stage per "
        f"frame of {len(FRAME_CATS)} crops: one batched forward {vis_batched:.1f} ms, instance by "
        f"instance {vis_singles:.1f} ms; mean 3D IoU AP@50 {iou_aps[-1, 50]:.3f}, 5deg5cm AP "
        f"{pose_aps[-1, 0, 0]:.3f}")
    frame_ms = frames_ms / n_frames
    say(f"[frames] device busy {busy_ms:.1f} ms (the profile of the first frame's dispatch) of "
        f"{frame_ms:.1f} ms wall per frame ({100 * busy_ms / frame_ms:.1f}% busy)")
    return timed_launches, frames_ms / n_frames, singles_ms / n_inst, vis_batched, vis_singles


# ---------------------------------------------------------------------------
# Phase 7: the trainer
# ---------------------------------------------------------------------------

def write_train_records(dev, tmp, vit, n_frames, n_points, hw=(480, 640), out_size=256):
    """`n_frames` sphere-cap frames through `preprocess_frame`, with the
    canonical cloud and the bound of the known pose (R = I, t = the cap's
    center, s = its diameter on every axis), as three record containers: the
    geometric features, the ViT's descriptors, and the crop with the cloud's
    pixels in crop space. Returns their paths and the last frame."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.core.downsample import draw_downsample
    from cppf2_torch.core.geometry import check_pinhole
    from cppf2_torch.data.records import RecordWriter
    from cppf2_torch.infer.frontend import auto_crop, crop_origin, preprocess_frame, window_shape
    from cppf2_torch.models.dinov2 import (bbox_crop_image, crop_keypoints, interpolate_features,
                                           resize_bilinear_matmul)

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    res = get_category("mug").res
    check_pinhole(REAL275_K)   # on the host: preprocess_frame does not read a device K back
    k_t = torch.as_tensor(REAL275_K, device=dev)
    base = {"pc": ((n_points, 3), np.float32), "pc_canon": ((n_points, 3), np.float32),
            "bound": ((3,), np.float32), "count": ((), np.int32)}
    d_vit = vit.cfg.embed_dim
    schemas = {"shot": {**base, "shot": ((n_points, 352), np.float32), "normal": ((n_points, 3), np.float32)},
               "dino": {**base, "desc": ((n_points, d_vit), np.float32)},
               "dino-e2e": {**base, "crop": ((out_size, out_size, 3), np.float32),
                            "kp": ((n_points, 2), np.float32)}}
    paths = {b: os.path.join(tmp, f"{b}.rec") for b in schemas}
    writers = {b: RecordWriter(paths[b], schemas[b]) for b in schemas}
    ph = out_size // 8
    with torch.no_grad():
        for _ in range(n_frames):
            radius = float(rng.uniform(0.07, 0.11))
            center = (float(rng.uniform(-0.1, 0.1)), float(rng.uniform(-0.08, 0.08)),
                      float(rng.uniform(0.75, 0.95)))
            rgb, depth, mask = make_frame(rng, *hw, radius=radius, center=center)
            crop = auto_crop(mask)
            h, w = window_shape(depth.shape, crop)
            perm, prio = draw_downsample(h * w, dev, gen)
            mask_t = torch.as_tensor(mask, device=dev)
            fi = preprocess_frame(torch.as_tensor(depth, device=dev), mask_t, k_t, perm, prio, res=res,
                                  n_max=n_points, crop=crop,
                                  origin=crop_origin(mask, mask.shape, crop) if crop else None)
            bound = torch.full((3,), 2 * radius, device=dev)
            canon = (fi.pc - torch.tensor(center, device=dev)) / torch.linalg.norm(bound)
            canon = torch.where(fi.valid[:, None], canon, torch.zeros((), device=dev))
            rgb_t = torch.as_tensor(rgb, device=dev).float() / 255.0
            img, txys = bbox_crop_image(rgb_t, mask_t, out_size)
            kp = crop_keypoints(fi.pixel_yx, txys)
            grid = vit(resize_bilinear_matmul(img, ph * 14, ph * 14))
            desc = interpolate_features(grid, kp, (out_size, out_size))
            rec = {k: v.float().cpu().numpy() for k, v in dict(
                pc=fi.pc, pc_canon=canon, bound=bound, shot=fi.shot, normal=fi.normal, desc=desc,
                crop=img, kp=kp).items()}
            rec["count"] = np.int32(int(fi.count))
            for b, wr in writers.items():
                wr.append(rec)
    for wr in writers.values():
        wr.close()
    return paths, (rgb, depth, mask)


def run_trainer(dev, pipe, vit_cfg, tmp, backend="nccl", n_frames=64, n_points=2048, steps=40,
                e2e_steps=10, tuples=10000, e2e_vit=None, hw=(480, 640), out_size=256):
    """Phase 7 on a world-1 process group; returns {branch: ms per step}."""
    import torch
    import torch.distributed as dist

    from cppf2_torch import parallel, train
    from cppf2_torch.config import TrainConfig
    from cppf2_torch.data.records import RecordReader
    from cppf2_torch.eval import driver
    from cppf2_torch.models.cppf import DinoBranch, ShotBranch
    from cppf2_torch.models.dinov2 import VIT_S14, DinoViT
    from cppf2_torch.ops import attention
    from cppf2_torch.train import checkpoints
    from cppf2_torch.train.driver import train_category

    # K1 has no backward, and says so
    q = torch.zeros((16, 65, 64), dtype=torch.bfloat16, device=dev, requires_grad=True)
    try:
        attention.mha(q, q.detach(), q.detach())
    except RuntimeError as e:
        say(f"[train] K1 refuses a tensor that requires grad: {str(e)[:60]}...")
    else:
        raise AssertionError("mha took a tensor that requires grad and returned")

    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.device(dev):
        vit = DinoViT(vit_cfg).eval()
    vit.init_random(gen).cast_for_inference()
    t0 = time.perf_counter()
    paths, (rgb, depth, mask) = write_train_records(dev, tmp, vit, n_frames, n_points, hw, out_size)
    say(f"[train] {n_frames} frames x {n_points} points written as records in "
        f"{time.perf_counter() - t0:.1f} s: " +
        ", ".join(f"{b} {os.path.getsize(p) / 1e6:.0f} MB" for b, p in paths.items()))
    e2e_vit = e2e_vit or dataclasses.replace(VIT_S14, pretrain_grid=out_size // 8)

    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "train_store"), 1),
                            rank=0, world_size=1)
    ms_per_step = {}
    try:
        mesh = parallel.make_mesh(device=dev.type)
        for branch, n_steps in (("shot", steps), ("dino", steps), ("dino-e2e", e2e_steps)):
            cfg = TrainConfig(n_points=n_points, steps_per_epoch=n_steps, max_epochs=1,
                              tuples_per_step=tuples)
            out = os.path.join(tmp, "ck", "dino" if branch != "shot" else "shot", "mug")
            if branch == "dino-e2e":
                out = os.path.join(tmp, "ck_e2e", "dino", "mug")
            zero_counts()
            state = train_category("mug", branch, cfg, out, n_points=n_points, records=paths[branch],
                                   log_every=1, progress=lambda s: None, vit_cfg=e2e_vit,
                                   e2e_out_size=out_size, device=dev.type)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if any(read_counts().values()):
                raise AssertionError(f"a train step launched a kernel of the port: {read_counts()}")
            with open(os.path.join(out, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            totals = [r["total"] for r in rows]
            if len(rows) != n_steps or not all(math.isfinite(r[k]) for r in rows
                                               for k in ("cls", "scale", "total")):
                raise AssertionError(f"{branch}: {len(rows)} metric rows, or a non-finite one: {rows[-1]}")
            walls = [r["wall"] for r in rows]
            ms = statistics.median(np.diff(walls)) * 1e3
            ms_per_step[branch] = ms
            n_mean = min(10, n_steps // 2)
            head, tail = totals[:n_mean], totals[-n_mean:]
            say(f"[train] {branch}: {n_steps} steps, {ms:.1f} ms per step (median, the metrics read "
                f"back every step), total loss {totals[0]:.3f} -> {totals[-1]:.3f} (mean of the first "
                f"{n_mean} {np.mean(head):.3f}, of the last {n_mean} {np.mean(tail):.3f})")
            if not np.mean(tail) < np.mean(head):
                raise AssertionError(f"{branch}: the loss did not fall")

            if branch != "dino-e2e":
                checkpoints.export_params_msgpack(os.path.join(out, "params.msgpack"), state.module)

            # the checkpoint restores to the same step and the same next-step loss
            if branch == "shot":
                fresh_model = ShotBranch()
            else:
                width = e2e_vit.embed_dim if branch == "dino-e2e" else vit_cfg.embed_dim
                fresh_model = DinoBranch(desc_dim=width)
            if branch == "dino-e2e":
                vit_model = DinoViT(dataclasses.replace(e2e_vit, attn_impl="hbm"))
                fresh = train.create_visual_train_state(vit_model, fresh_model, cfg, device=dev.type)
                step_fn = train.make_visual_train_step(vit_model, fresh_model, cfg, out_size=out_size,
                                                       mesh=mesh)
                untrained = train.create_visual_train_state(
                    DinoViT(vit_model.cfg), DinoBranch(desc_dim=width), cfg,
                    torch.Generator().manual_seed(cfg.seed), device=dev.type)
                with torch.no_grad():
                    moved = max(float(torch.max(torch.abs(a - b))) for a, b in
                                zip(state.module.backbone.parameters(),
                                    untrained.module.backbone.parameters()))
                say(f"[train] dino-e2e: the backbone's parameters moved by up to {moved:.3g}")
                if not moved > 0:
                    raise AssertionError("the backbone's parameters did not move")
            else:
                fresh = train.create_train_state(fresh_model, cfg, device=dev.type)
                step_fn = train.make_train_step(fresh_model, cfg, branch, mesh)
            fresh = checkpoints.restore_checkpoint(checkpoints.latest_checkpoint(out), fresh)
            if fresh.step != state.step or state.step != n_steps:
                raise AssertionError(f"{branch}: restored step {fresh.step}, trained {state.step}")
            reader = RecordReader(paths[branch])
            batch = {k: v for k, v in reader.batch([0]).items()}
            losses = []
            for st in (state, fresh):
                _, m = step_fn(st, batch, generator=torch.Generator().manual_seed(5))
                losses.append(m["total"])
            if not torch.equal(losses[0], losses[1]):
                raise AssertionError(f"{branch}: next-step loss {float(losses[0])} in memory, "
                                     f"{float(losses[1])} from the checkpoint")
            say(f"[train] {branch}: checkpoint restores step {n_steps} and the next step's loss "
                f"{float(losses[1]):.6f} bit for bit")

        # the trained weights pose an instance: shot + dino with the ViT that made the
        # descriptors, then the e2e head with its own backbone (K1 at 6 heads)
        ck_e2e = os.path.join(tmp, "ck_e2e")
        small_vit, stride, size = driver._load_vit(os.path.join(ck_e2e, "dino", "mug", "backbone"), dev)
        for label, root, v, kw in (("shot + dino", os.path.join(tmp, "ck"), vit, {}),
                                   ("dino-e2e", ck_e2e, small_vit, dict(stride=stride, out_size=size))):
            models = driver.load_category_models(root, ["mug"], torch.bfloat16, dev)["mug"]
            zero_counts()
            est = driver.estimate_instance(rgb, depth, mask, REAL275_K, models, "mug", pipe, vit=v,
                                           generator=torch.Generator(device=dev).manual_seed(1),
                                           device=dev, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            posed, want = read_counts(), {"mha": v.cfg.depth, "hist16_peak": 2 * pipe.vote_levels,
                                          "sphere_accumulate": 0}
            if posed != want:
                raise AssertionError(f"{label}: launch counts {posed}, expected {want}")
            vals = [est.rotation, est.translation, est.scale, est.loss]
            if not all(bool(torch.isfinite(x).all()) for x in vals):
                raise AssertionError(f"{label}: non-finite pose from the trained weights: {est}")
            say(f"[train] {label}: exported params.msgpack -> load_category_models -> one instance "
                f"posed, T={[round(x, 4) for x in est.translation.tolist()]} pick={int(est.pick)}, "
                f"launches {posed}")
    finally:
        dist.destroy_process_group()
    return ms_per_step


# ---------------------------------------------------------------------------
# Phase 8: the trainer on frames it renders itself
# ---------------------------------------------------------------------------

def check_renderers(dev, hw, samples, seed=21):
    """A mug through both renderers on the card and on the CPU with the same
    draws (made on the card): coverage equal on at least 99.9% of pixels,
    depth within 1e-5 m and gray within 1e-5 where both cover."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.data import render, shapes, synthetic

    h, w = hw
    rng = np.random.default_rng(seed)
    mesh = shapes.make_category_mesh("mug", rng)
    pts, nrm = shapes.sample_surface(mesh, samples, rng)
    verts, faces = synthetic._pad_mesh(*shapes.subdivide_mesh(mesh, max_edge=1.0 / 48.0))
    gen = synthetic.SyntheticFrameGenerator(get_category("mug"), height=h, width=w, seed=seed,
                                            device=dev.type, z_range=(0.6, 0.8))
    r, t = gen._draw_pose()
    scale = float(rng.uniform(0.15, 0.25))
    draws = synthetic.draw_frame(1, 2, h * w, True, dev)
    cpu = torch.device("cpu")
    rows = {}
    for name in ("splat", "raster"):
        out = []
        for d in (dev, cpu):
            light = render.sample_lighting(*(x.to(d) for x in draws.lighting))
            albedo = render.AlbedoDraw(*(x.to(d) for x in draws.albedo))
            pose = (torch.as_tensor(r, device=d), torch.as_tensor(t, device=d), scale,
                    torch.as_tensor(gen.intrinsics_np, device=d), h, w)
            if name == "splat":
                pts_d = torch.as_tensor(pts, device=d)
                depth, gray = render.splat_render_depth(pts_d, torch.as_tensor(nrm, device=d), *pose,
                                                        lighting=light,
                                                        albedo=render.procedural_albedo(pts_d, albedo))
            else:
                depth, gray = render.raster_render_depth(torch.as_tensor(verts, device=d),
                                                         torch.as_tensor(faces, device=d), *pose,
                                                         lighting=light, albedo=albedo)
            out.append((depth.cpu().numpy(), gray.cpu().numpy()))
        (cd, cg), (pd, pg) = out
        both = (cd > 0) & (pd > 0)
        cover = float(np.mean((cd > 0) == (pd > 0)))
        d_err = float(np.abs(cd - pd)[both].max())
        g_err = float(np.abs(cg - pg)[both].max())
        say(f"[render] {name} {h}x{w}, mug, card vs CPU on the same draws: coverage equal on "
            f"{100 * cover:.3f}% of pixels ({int(both.sum())} covered by both), max |depth diff| "
            f"{d_err:.3g} m, max |gray diff| {g_err:.3g}" + (f", {len(faces)} faces" if name == "raster"
                                                             else f", {samples} samples"))
        if cover < 0.999 or both.sum() < h * w // 400 or d_err > 1e-5 or g_err > 1e-5:
            raise AssertionError(f"{name}: the card's render differs from the CPU's")
        rows[name] = dict(cover=cover, depth_err=d_err, gray_err=g_err)
    return rows


def render_breakdown(dev, hw, samples, n_points, renderer, frames=6):
    """ms per rendered frame of `SyntheticFrameGenerator.next_frame`, unbroken
    (median over `frames`), then split into its stages, each bracketed by
    device synchronizations (medians)."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.data import synthetic

    gen = synthetic.SyntheticFrameGenerator(get_category("mug"), n_max=n_points, height=hw[0],
                                            width=hw[1], surface_samples=samples, seed=5,
                                            renderer=renderer, device=dev.type)
    gen.next_frame()   # warm-up
    walls = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.next_frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    mesh = ([(synthetic, "make_category_mesh"), (synthetic, "sample_surface")] if renderer == "splat"
            else [(synthetic, "make_category_mesh"), (synthetic, "subdivide_mesh")])
    render = (synthetic, "splat_render_depth" if renderer == "splat" else "raster_render_depth")
    targets = mesh + [render, (synthetic, "_frame_from_render"), (synthetic, "to_host")]
    runs = []
    for _ in range(frames):
        with timed_calls(targets) as spent:
            t0 = time.perf_counter()
            gen.next_frame()
            total = (time.perf_counter() - t0) * 1e3
        runs.append({"host mesh + samples": sum(spent[n] for _, n in mesh), "device render": spent[render[1]],
                     "frame tail": spent["_frame_from_render"], "the one read": spent["to_host"],
                     "rest": total - sum(spent.values())})
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    ms = statistics.median(walls)
    say(f"[render] {renderer}: {ms:.1f} ms per frame (median of {frames}, {hw[0]}x{hw[1]}, "
        f"{samples if renderer == 'splat' else 'subdivided'} surface, {n_points} points); stages, ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    if dev.type == "cuda":
        reads, attempts = frame_reads(gen)
        say(f"[render] {renderer}: {reads} device-to-host copies in a frame of {attempts} attempt(s)")
        if reads != attempts:
            raise AssertionError(f"{renderer}: {reads} copies back for {attempts} attempts, not one each")
    return ms, parts


def frame_reads(gen):
    """(device-to-host copies, attempts) of one `next_frame`, from the
    profiler's copy records; the frame's uploads are certain, so a profile
    without any copy is a tracer that recorded nothing and is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cppf2_torch.data import synthetic

    real = synthetic.to_host
    attempts = []
    synthetic.to_host = lambda *a, **k: attempts.append(1) or real(*a, **k)
    try:
        for _ in range(3):
            attempts.clear()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                gen.next_frame()
                torch.cuda.synchronize()
            keys = [(e.key.lower(), e.count) for e in prof.key_averages()]
            if any("memcpy" in k for k, _ in keys):
                return sum(n for k, n in keys if "dtoh" in k), len(attempts)
            say("[profiler] next_frame: no copy recorded, profiled again")
    finally:
        synthetic.to_host = real
    raise AssertionError("the profiler recorded no copy in three frames")


def check_extractor(dev, vit_cfg, hw, samples, n_points, out_size=256):
    """DinoFeatureExtractor (stride 4, 256 x 256 crop, K1 at T = 4097) on one
    rendered frame. The production extractor (`vit_cfg`, layer scale 1e-5)
    gives the launch count (24 K1 launches a call), ms per call and K1's
    share of the call's device time. Its K1 route is held against its "hbm"
    route with the same seeded weights at layer scale 1.0, as the CPU test
    of the extractor holds them (`tests/test_torch_dinov2.py`), since at 1e-5 the
    attention branch moves the descriptors by about 1e-5 and any K1 would
    pass. At 1.0 a K1 that returned zeros would drop a branch as large as
    the residual stream. Limits: max |diff| at most 2e-3 and every cosine
    at least 0.9999 on the unit descriptors (entries about 0.024; this
    check's line reads 5.8e-4 and 0.999991 on an H100 80GB HBM3 at 700 W)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cppf2_torch.config import get_category
    from cppf2_torch.data.synthetic import SyntheticFrameGenerator
    from cppf2_torch.models.dinov2 import DinoFeatureExtractor
    from cppf2_torch.ops import attention
    from cppf2_torch.train.driver import _frame_crop_kp

    gen = SyntheticFrameGenerator(get_category("mug"), n_max=n_points, height=hw[0], width=hw[1],
                                  surface_samples=samples, seed=8, device=dev.type)
    crop, kp = (torch.as_tensor(x, device=dev) for x in _frame_crop_kp(gen.next_frame(), out_size))

    def extractor(**kw):
        return DinoFeatureExtractor(cfg=dataclasses.replace(vit_cfg, **kw), out_size=out_size,
                                    device=dev.type).init_random(torch.Generator(device=dev).manual_seed(0))

    ext = extractor()
    before = attention.mha.launches
    ext(crop, kp)
    calls = attention.mha.launches - before
    k1_route, plain = (extractor(attn_impl=a, layerscale_init=1.0) for a in ("kernel", "hbm"))
    got, want = k1_route(crop, kp), plain(crop, kp)
    err = float(torch.max(torch.abs(got - want)))
    cos = float(torch.min(torch.sum(got * want, dim=-1)))
    if calls != vit_cfg.depth or not math.isfinite(err) or err > 2e-3 or cos < 0.9999:
        raise AssertionError(f"extractor: {calls} K1 launches, K1 vs hbm at layer scale 1 max |diff| {err}, "
                             f"min cos {cos}")
    del k1_route, got, want
    ms = time_ms(lambda: ext(crop, kp), iters=5, repeats=3)
    plain_ms = time_ms(lambda: plain(crop, kp), iters=2, repeats=1)
    busy = k1 = 0.0
    for _ in range(3):   # a window in which the tracer recorded nothing is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ext(crop, kp)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        k1 = sum(e.self_device_time_total for e in events if "mha_fwd_kernel" in e.key) / 1e3
        if busy > 0:
            break
    else:
        raise AssertionError("the profiler recorded no device time in three calls of the extractor")
    say(f"[extractor] DinoFeatureExtractor ViT-L/14 stride 4, 256x256 crop -> 896x896, {len(kp)} "
        f"keypoints: K1 route vs hbm route at layer scale 1 max |diff| {err:.3g}, min cos {cos:.6f} "
        f"(limits 2e-3, 0.9999); {calls} K1 launches a "
        f"call; {ms:.1f} ms per call back to back (hbm route {plain_ms:.1f}); device time of one call "
        f"{busy:.2f} ms, K1 {k1:.2f} ms of it ({100 * k1 / busy:.1f}%)")
    return dict(err=err, cos=cos, ms=ms, plain_ms=plain_ms, busy_ms=busy, k1_ms=k1)


def run_render_trainer(dev, pipe, tmp, backend="nccl", hw=(480, 640), samples=250_000, n_points=2048,
                       tuples=10000, pool=64, steps=40, e2e_steps=10, vit_cfg=None, e2e_vit=None,
                       out_size=256, frames=6):
    """Phase 8; returns (K1 launches of the "dino" run, the render rows, the
    extractor row, {branch: ms per step})."""
    import torch
    import torch.distributed as dist

    from cppf2_torch.config import TrainConfig, get_category
    from cppf2_torch.data.synthetic import SyntheticFrameGenerator
    from cppf2_torch.eval import driver
    from cppf2_torch.models.dinov2 import VIT_L14, VIT_S14, DinoFeatureExtractor
    from cppf2_torch.train import checkpoints
    from cppf2_torch.train.driver import train_category

    vit_cfg = vit_cfg or VIT_L14
    e2e_vit = e2e_vit or dataclasses.replace(VIT_S14, pretrain_grid=out_size // 8)
    renders = check_renderers(dev, hw, samples)
    for renderer in ("splat", "raster"):
        renders[renderer]["ms"], renders[renderer]["stages"] = render_breakdown(
            dev, hw, samples, n_points, renderer, frames)
    extractor = check_extractor(dev, vit_cfg, hw, samples, n_points, out_size)

    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "render_store"), 1),
                            rank=0, world_size=1)
    ms_per_step, dino_launches = {}, None
    try:
        for branch, n_steps in (("shot", steps), ("dino", steps), ("dino-e2e", e2e_steps)):
            cfg = TrainConfig(n_points=n_points, steps_per_epoch=n_steps, max_epochs=1,
                              tuples_per_step=tuples)
            root = "rck_e2e" if branch == "dino-e2e" else "rck"
            out = os.path.join(tmp, root, "shot" if branch == "shot" else "dino", "mug")
            zero_counts()
            t0 = time.perf_counter()
            state = train_category("mug", branch, cfg, out, n_points=n_points, frames_in_pool=pool,
                                   render_hw=hw, log_every=1, progress=lambda s: None, vit_cfg=e2e_vit,
                                   e2e_out_size=out_size, device=dev.type)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = read_counts()
            want = {"mha": vit_cfg.depth * (pool + n_steps) if branch == "dino" else 0,
                    "hist16_peak": 0, "sphere_accumulate": 0}
            if launches != want:
                raise AssertionError(f"{branch}: launch counts {launches}, expected {want} (the pool's "
                                     f"and every refresh's descriptors, none in a step)")
            if branch == "dino":
                dino_launches = launches["mha"]
            with open(os.path.join(out, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            if len(rows) != n_steps or not all(math.isfinite(r[k]) for r in rows
                                               for k in ("cls", "scale", "total")):
                raise AssertionError(f"{branch}: {len(rows)} metric rows, or a non-finite one: {rows[-1]}")
            totals = [r["total"] for r in rows]
            walls = [r["wall"] for r in rows]
            ms = statistics.median(np.diff(walls)) * 1e3
            ms_per_step[branch] = ms
            n_mean = min(10, n_steps // 2)
            head, tail = np.mean(totals[:n_mean]), np.mean(totals[-n_mean:])
            say(f"[render train] {branch}: pool of {pool} rendered frames + {n_steps} steps, each step "
                f"refreshing one frame: {ms:.1f} ms per step (median), {total_s - walls[-1]:.1f} s before "
                f"the first step (pool and set-up), launches {launches}; total loss {totals[0]:.3f} -> "
                f"{totals[-1]:.3f} (mean of the first {n_mean} {head:.3f}, of the last {n_mean} {tail:.3f})")
            if not tail < head:
                raise AssertionError(f"{branch}: the loss did not fall")
            if branch != "dino-e2e":
                checkpoints.export_params_msgpack(os.path.join(out, "params.msgpack"), state.module)

        # a rendered frame posed with the exported weights: shot + dino with the
        # extractor's ViT at stride 4 (the descriptors the head was trained on),
        # then the e2e head with its own backbone
        gen = SyntheticFrameGenerator(get_category("mug"), n_max=n_points, height=hw[0], width=hw[1],
                                      surface_samples=samples, seed=9, device=dev.type)
        frame = gen.next_frame()
        depth = frame.depth.cpu().numpy()
        rgb = np.repeat((frame.gray.cpu().numpy() * 255).round().astype(np.uint8)[..., None], 3, axis=-1)
        mask = depth > 0
        truth = frame.translation.cpu().numpy()
        big = DinoFeatureExtractor(cfg=vit_cfg, device=dev.type).init_random(
            torch.Generator(device=dev).manual_seed(TrainConfig().seed))
        small, stride, size = driver._load_vit(os.path.join(tmp, "rck_e2e", "dino", "mug", "backbone"), dev)
        for label, root, v, kw in (("shot + dino", "rck", big.model, dict(stride=4, out_size=out_size)),
                                   ("dino-e2e", "rck_e2e", small, dict(stride=stride, out_size=size))):
            models = driver.load_category_models(os.path.join(tmp, root), ["mug"], torch.bfloat16, dev)["mug"]
            zero_counts()
            est = driver.estimate_instance(rgb, depth, mask, gen.intrinsics_np, models, "mug", pipe, vit=v,
                                           generator=torch.Generator(device=dev).manual_seed(1),
                                           device=dev, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            posed, want = read_counts(), {"mha": v.cfg.depth, "hist16_peak": 2 * pipe.vote_levels,
                                          "sphere_accumulate": 0}
            if posed != want:
                raise AssertionError(f"{label}: launch counts {posed}, expected {want}")
            if not all(bool(torch.isfinite(x).all()) for x in (est.rotation, est.translation, est.scale)):
                raise AssertionError(f"{label}: non-finite pose of a rendered frame: {est}")
            say(f"[render train] {label}: a rendered mug posed with the exported weights, T "
                f"{[round(x, 4) for x in est.translation.tolist()]} (true "
                f"{[round(float(x), 4) for x in truth]}), pick {int(est.pick)}, launches {posed}")
    finally:
        dist.destroy_process_group()
    return dino_launches, renders, extractor, ms_per_step


# ---------------------------------------------------------------------------
# Phase 9: the in-the-wild demo
# ---------------------------------------------------------------------------

def tabletop_frames(n, h=480, w=640, seed=30, step=8):
    """n RGB-D frames of a table plane at 1 m (tilted a little) with a mug-sized
    sphere cap (radius 9 cm: a max extent of about 18 cm, inside mug's scale
    range) and a small one (radius 3.5 cm) beside it, both moving `step` px
    right per frame, depth noise 1 mm; a random colour image. Returns
    [(rgb, depth in m, the mug's mask)]."""
    rng = np.random.default_rng(seed)
    fx, cx, cy = REAL275_K[0, 0], REAL275_K[0, 2], REAL275_K[1, 2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        depth = (1.0 + 0.0002 * (ys - cy)).astype(np.float32)
        masks = []
        for (u, v, radius, z) in ((cx - 40 + step * i, cy + 10, 0.09, 0.9),
                                  (cx + 150 + step * i, cy - 60, 0.035, 0.93)):
            d2 = (xs - u) ** 2 + (ys - v) ** 2
            m = d2 < (radius * fx / z) ** 2
            bump = np.sqrt(np.maximum(radius ** 2 - d2 * (z / fx) ** 2, 0.0))
            depth = np.where(m, z - bump, depth)
            masks.append(m)
        depth = (depth + rng.normal(0, 1e-3, (h, w))).astype(np.float32)
        out.append((rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8), depth, masks[0]))
    return out


def dinov2_state_dict(vit):
    """A DinoViT's weights in facebookresearch/dinov2's key layout, float32 on
    the host: the inverse of `models/dinov2.py::port_torch_state_dict`."""
    import torch

    c = vit.cfg
    d, p = c.embed_dim, c.patch_size

    def host(t):
        return t.detach().to("cpu", torch.float32).clone()

    sd = {"patch_embed.proj.weight": host(vit.patch_embed.weight).reshape(d, p, p, 3).permute(0, 3, 1, 2)
          .contiguous(),
          "patch_embed.proj.bias": host(vit.patch_embed.bias),
          "cls_token": host(vit.cls_token).reshape(1, 1, d), "pos_embed": host(vit.pos_embed)[None],
          "mask_token": torch.zeros(1, d), "norm.weight": host(vit.norm.weight),
          "norm.bias": host(vit.norm.bias)}
    for i, b in enumerate(vit.blocks):
        for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "attn.qkv"),
                             ("attn.proj", "attn.proj"), ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            m = b.get_submodule(ours)
            sd[f"blocks.{i}.{theirs}.weight"] = host(m.weight)
            sd[f"blocks.{i}.{theirs}.bias"] = host(m.bias)
        sd[f"blocks.{i}.ls1.gamma"] = host(b.ls1)
        sd[f"blocks.{i}.ls2.gamma"] = host(b.ls2)
    return sd


def beyondcppf_state_dict(tree):
    """A branch's parameter tree (Dense kernels as (in, out)) in the
    reference's BeyondCPPF Lightning key layout (train_shot.py:52-73,
    train_dino.py:64-85): the inverse of
    `models/porting.py::port_beyondcppf_state_dict`."""
    import torch

    p = tree.get("params", tree)
    sd = {}

    def dense(prefix, d):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(d["kernel"], np.float32).T))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(d["bias"], np.float32))

    def res_mlp(prefix, mlp):
        for name, layer in mlp.items():
            i = int(name[len("res"):])
            dense(f"{prefix}.{i}.fc1", layer["fc1"])
            dense(f"{prefix}.{i}.fc2", layer["fc2"])
            if "proj" in layer:
                dense(f"{prefix}.{i}.fc0", layer["proj"])

    res_mlp("tuple_encoder", p["tuple_encoder"])
    res_mlp("logit_encoder", p["heads"]["logit_encoder"])
    res_mlp("scale_encoder", p["heads"]["scale_encoder"])
    if "shot_encoder" in p:
        res_mlp("shot_encoder", p["shot_encoder"])
    else:
        dense("desc_transform", p["desc_transform"])
        dense("desc_pair_transform", p["desc_pair_transform"])
    return sd


def write_release_tree(root, ckpts, cat="mug", older="bowl"):
    """The reference release's Lightning tree under `root`:
    {shot,dino}/<cat>-num_more-3/lightning_logs/version_{9,10}/checkpoints/
    last.ckpt and .hydra/config.yaml. version_10 holds `ckpts`' <cat>
    weights in BeyondCPPF's key layout, version_9 its <older> weights, so
    only a numeric version order loads the right ones."""
    import torch

    from cppf2_torch.models.checkpoints import load_params_msgpack

    for branch in ("shot", "dino"):
        run = os.path.join(root, branch, f"{cat}-num_more-3")
        os.makedirs(os.path.join(run, ".hydra"), exist_ok=True)
        with open(os.path.join(run, ".hydra", "config.yaml"), "w") as f:
            f.write(f"category:\n  name: {cat}\nnum_more: 3\nres: 0.002\n")
        for version, src in ((9, older), (10, cat)):
            ck = os.path.join(run, "lightning_logs", f"version_{version}", "checkpoints")
            os.makedirs(ck, exist_ok=True)
            tree = load_params_msgpack(os.path.join(ckpts, branch, src, "params.msgpack"))
            torch.save({"state_dict": beyondcppf_state_dict(tree), "epoch": 100, "global_step": 20200},
                       os.path.join(ck, "last.ckpt"))


@contextlib.contextmanager
def recorded(mod, name, record):
    """Swap mod.name for a function that passes each call's (args, kwargs,
    result) to `record` and returns the result."""
    fn = getattr(mod, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        record(args, kwargs, out)
        return out

    setattr(mod, name, wrapper)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def run_demo(dev, tmp, vit_cfg=None, n_frames=3, pipe_args=()):
    """Phase 9; returns (K1 launches, K2 launches, ms per frame, {stage: ms
    per frame}, the device-busy share in percent)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cppf2_torch import demo
    from cppf2_torch.config import PipelineConfig
    from cppf2_torch.eval import driver
    from cppf2_torch.eval.png import read_png_rgb8, write_png16, write_png_rgb8
    from cppf2_torch.models.dinov2 import VIT_L14, DinoFeatureExtractor, DinoViT
    from cppf2_torch.ops import attention, hist16

    vit_cfg = vit_cfg or VIT_L14
    pipe = PipelineConfig()
    root = os.path.join(tmp, "demo")
    rgb_dir, depth_dir = os.path.join(root, "rgb"), os.path.join(root, "depth")
    os.makedirs(rgb_dir)
    os.makedirs(depth_dir)
    frames = tabletop_frames(n_frames)
    for i, (rgb, depth, _) in enumerate(frames):
        write_png_rgb8(os.path.join(rgb_dir, f"{i:04d}.png"), rgb)
        write_png16(os.path.join(depth_dir, f"{i:04d}.png"), np.round(depth * 1000).astype(np.uint16))

    # the backbone: seeded random weights, written as an official DINOv2 .pth
    with torch.device(dev):
        vit = DinoViT(vit_cfg).eval()
    vit.init_random(torch.Generator(device=dev).manual_seed(5))
    pth = os.path.join(root, "dinov2_vitl14.pth")
    sd = dinov2_state_dict(vit)
    t0 = time.perf_counter()
    torch.save(sd, pth)
    write_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in sd.values())
    del sd
    vit.cast_for_inference()
    say(f"[demo] {vit_cfg.depth}-block ViT ({n_params / 1e6:.1f} M parameters) written as a DINOv2 .pth "
        f"({os.path.getsize(pth) / 2 ** 30:.2f} GiB) in {write_s:.1f} s")

    # the branches: ckpts_r3's mug as a reference release tree, checked on load
    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    tree = os.path.join(root, "ckpts")
    write_release_tree(tree, ckpts)
    got = driver.load_category_models(tree, ["mug"], torch.bfloat16, dev)["mug"]
    want = driver.load_category_models(ckpts, ["mug"], torch.bfloat16, dev)["mug"]
    for branch in ("shot", "dino"):
        a, b = getattr(got, branch).state_dict(), getattr(want, branch).state_dict()
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"{branch}: the Lightning tree's version_10 does not load as ckpts_r3's mug")
    del got, want
    say("[demo] mug branches from a Lightning tree (version_9 and version_10): equal to ckpts_r3's "
        "params.msgpack, every tensor")

    def run(out, extra_targets=(), extra_args=()):
        """demo.main on the frames; returns ({calls}, {target: ms}, seconds)."""
        calls = {"masks": [], "picks": [], "k1_shapes": [], "extractor": []}
        argv = ["--rgb-dir", rgb_dir, "--depth-dir", depth_dir, "--auto-mask", "--category", "mug",
                "--ckpts", tree, "--dino-ckpt", pth, "--out", out, "--device", dev.type, "--seed", "0",
                *pipe_args, *extra_args]
        real_fetch = demo.fetch_instances

        def fetch_with_picks(pendings):
            outs, picks = real_fetch(pendings, return_picks=True)
            calls["picks"].extend(picks)
            return outs

        with contextlib.ExitStack() as stack:
            stack.enter_context(recorded(demo, "auto_instance_mask",
                                         lambda a, k, o: calls["masks"].append(o[0])))
            stack.enter_context(recorded(demo, "load_dino_extractor",
                                         lambda a, k, o: calls["extractor"].append(o)))
            stack.enter_context(recorded(attention, "mha",
                                         lambda a, k, o: calls["k1_shapes"].append(tuple(a[0].shape))))
            demo.fetch_instances = fetch_with_picks
            stack.callback(setattr, demo, "fetch_instances", real_fetch)
            spent = stack.enter_context(timed_calls(list(extra_targets)))
            t0 = time.perf_counter()
            demo.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        return calls, spent, seconds

    # the kernel route
    out_k = os.path.join(root, "out_kernel")
    zero_counts()
    calls, _, run_s = run(out_k)
    launches = {"mha": attention.mha.launches, "hist16_peak": hist16.hist16_peak.launches,
                "hist16_level_peak": hist16.hist16_level_peak.launches}
    want_launches = {"mha": vit_cfg.depth * n_frames, "hist16_peak": 2 * pipe.vote_levels * n_frames,
                     "hist16_level_peak": 2 * pipe.vote_levels * n_frames}
    t_tokens = (256 // 4) ** 2 + 1
    if launches != want_launches or set(calls["k1_shapes"]) != {(vit_cfg.num_heads, t_tokens, 64)}:
        raise AssertionError(f"demo: launches {launches} at K1 shapes {set(calls['k1_shapes'])}, expected "
                             f"{want_launches} at ({vit_cfg.num_heads}, {t_tokens}, 64)")
    loaded = calls["extractor"][0].model.state_dict()
    if not all(torch.equal(v, loaded[k]) for k, v in vit.state_dict().items()):
        raise AssertionError("the .pth does not load as the ViT it was written from")
    del loaded, calls["extractor"][:]
    poses = []
    for i, (rgb, _, truth) in enumerate(frames):
        img = read_png_rgb8(os.path.join(out_k, f"{i:04d}.png"))
        pose = np.load(os.path.join(out_k, f"{i:04d}_pose.npz"))
        m = calls["masks"][i]
        iou = (m & truth).sum() / max((m | truth).sum(), 1)
        if img.shape != rgb.shape or not (img != rgb).any() or not np.isfinite(pose["RT"]).all():
            raise AssertionError(f"frame {i}: overlay {img.shape} drawn {(img != rgb).any()}, RT {pose['RT']}")
        if iou < 0.5:
            raise AssertionError(f"frame {i}: the proposer's pick overlaps the mug at IoU {iou:.3f}")
        poses.append((pose["RT"], pose["scales"]))
        say(f"[demo] frame {i}: the pick overlaps the mug at IoU {iou:.3f}; T {np.round(pose['RT'][:3, 3], 4)}, "
            f"branch {calls['picks'][i]}")
    say(f"[demo] kernel route: {n_frames} frames in {run_s:.1f} s (set-up included), launches {launches}, "
        f"K1 at {calls['k1_shapes'][0]}; {n_frames} overlay PNGs and pose files read back")

    # every kernel swapped for its plain version, the same seed
    saved = attention.mha, hist16.hist16_peak, hist16.hist16_level_peak
    attention.mha, hist16.hist16_peak = attention.mha_plain, hist16.hist16_peak_plain
    hist16.hist16_level_peak = hist16.hist16_level_peak_plain
    try:
        plain_calls, _, plain_s = run(os.path.join(root, "out_plain"))
    finally:
        attention.mha, hist16.hist16_peak, hist16.hist16_level_peak = saved
    for i, (rt, scales) in enumerate(poses):
        prt = np.load(os.path.join(root, "out_plain", f"{i:04d}_pose.npz"))["RT"]
        ang, dt = rt_angle_deg(rt, prt), float(np.abs(rt[:3, 3] - prt[:3, 3]).max())
        same = np.array_equal(plain_calls["masks"][i], calls["masks"][i])
        say(f"[demo] frame {i} kernel vs plain: R {ang:.4f} deg, T {dt * 1e3:.4f} mm, branch "
            f"{calls['picks'][i]} vs {plain_calls['picks'][i]}, the same mask {same}")
        if ang > 1.0 or dt > 3e-3 or calls["picks"][i] != plain_calls["picks"][i] or not same:
            raise AssertionError(f"frame {i}: the kernel route and the plain route disagree")

    # the frame's stages, each bracketed by device synchronizations
    targets = [(demo, "read_png_rgb8"), (demo, "_read_depth"), (demo, "auto_instance_mask"),
               (driver, "resize_crop"), (DinoFeatureExtractor, "__call__"), (demo, "run_frame"),
               (demo, "draw_pose_overlay"), (demo, "write_png_rgb8"), (demo, "load_category_models"),
               (demo, "load_dino_extractor")]
    _, spent, total_s = run(os.path.join(root, "out_timed"), targets)
    per = {k: v / n_frames for k, v in spent.items()}
    setup_ms = spent["load_category_models"] + spent["load_dino_extractor"]
    frame_ms = (total_s * 1e3 - setup_ms) / n_frames
    stages = {"image read": per["read_png_rgb8"] + per["_read_depth"],
              "proposer": per["auto_instance_mask"],
              "descriptors (host crop + extractor)": per["resize_crop"] + per["__call__"],
              "pose": per["run_frame"] - per["resize_crop"] - per["__call__"] - per["draw_pose_overlay"],
              "overlay + PNG write": per["draw_pose_overlay"] + per["write_png_rgb8"]}
    stages["rest"] = frame_ms - sum(stages.values())
    say(f"[demo] ms per frame {frame_ms:.1f} (mean of {n_frames}; set-up {setup_ms / 1e3:.1f} s apart: "
        f"the .pth read and the branch loads): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))

    # the device-busy share of a frame: profiler kernel time against the wall,
    # on the first frame alone (the tracer's cost grows with the ~30,000
    # kernels of a frame)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, spent, total_s = run(os.path.join(root, "out_profiled"),
                                [(demo, "load_category_models"), (demo, "load_dino_extractor")],
                                ["--end", "1"])
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and "memcpy htod" not in e.key.lower()]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = total_s * 1e3 - spent["load_category_models"] - spent["load_dino_extractor"]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    say(f"[demo] device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms of the first frame "
        f"({100 * busy_ms / wall_ms:.1f}%; profiled, uploads left out); top kernels: "
        + "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms" for e in top))
    return launches["mha"], launches["hist16_peak"], frame_ms, stages, 100 * busy_ms / wall_ms


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
    paths = _build.build(verbose=True).values()   # one nvcc per source, all started at once
    say(f"[build] {sorted(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s")

    k2 = check_hist16(dev)
    k1 = check_mha(dev)
    from cppf2_torch.config import PipelineConfig
    from cppf2_torch.models.dinov2 import VIT_L14

    pipe = PipelineConfig()
    if (pipe.n_points, pipe.num_pairs, pipe.angle_tol_deg, pipe.opt_steps) != (8192, 50000, 1.0, 100):
        raise AssertionError(f"not the production configuration: {pipe}")
    launches, e2e_ms, k2_levels = run_slice(dev, pipe, VIT_L14)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k3, k3_launches, eval_launches, eval_ms, pose_ms = run_multi_device(dev, pipe, tmp)
        k1_batched = check_mha_batched(dev, k1[0])
        frame_launches, frame_ms, single_ms, vis_batched, vis_singles = run_frame_driver(
            dev, pipe, VIT_L14, tmp)
        train_ms = run_trainer(dev, pipe, VIT_L14, tmp)
        t_phase = time.perf_counter()
        dino_launches, renders, extractor, render_train_ms = run_render_trainer(dev, pipe, tmp)
        say(f"[render train] the phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        demo_k1, demo_k2, demo_ms, demo_stages, demo_busy = run_demo(dev, tmp)
        say(f"[demo] the phase took {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    k1_main = k1[0]      # (16, 1025, 64): the ViT-L stride-8 shape
    k2_cand = k2[1]      # the candidate-array entry at 400k votes, which no path launches now
    k2_level = k2_levels[-1]   # the last (fine) level of the slice's first branch
    k3_main = k3[0]      # (1, 900k, 720): one instance's sampled rotation votes
    k1_frame = k1_batched[0]   # (4, 16, 1025, 64): the four crops of one written frame
    k1_4097 = k1[2]      # (16, 4097, 64): the ViT-L stride-4 shape of DinoFeatureExtractor
    kernels = [
        dict(name="mha", route="cuda", source=attention.SOURCE, replaces=attention.REPLACES,
             launches=launches["mha"], max_abs_err=max(r["err"] for r in k1),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by="operations", library_ms=k1_main["library_ms"],
             device_ms=k1_main["device_ms"],
             # the frame driver's call: one launch per ViT block for all of a frame's crops
             batched=dict(shape=[k1_frame["b"], 16, 1025, 64], launches=frame_launches["mha"],
                          max_abs_err=k1_frame["err"], ms=k1_frame["ms"],
                          device_ms=k1_frame["device_ms"], plain_ms=k1_frame["plain_ms"],
                          bound_ms=k1_frame["bound_ms"], bound_by="operations",
                          library_ms=k1_frame["library_ms"]),
             # the frozen-descriptor pass of the "dino" branch trained on rendered
             # frames: DinoFeatureExtractor at stride 4 on a 256 x 256 crop
             # and of the demo, 24 launches per frame (phase 9): `demo_launches`
             stride4=dict(shape=[16, 4097, 64], launches=dino_launches, demo_launches=demo_k1,
                          max_abs_err=k1_4097["err"],
                          ms=k1_4097["ms"], device_ms=k1_4097["device_ms"], plain_ms=k1_4097["plain_ms"],
                          bound_ms=k1_4097["bound_ms"], bound_by="operations",
                          library_ms=k1_4097["library_ms"])),
        # One row for K2. The main path launches it 8 times, all through the
        # fused entry hist16_level_peak, so the row's times and bound are those
        # of a fine level of the slice; no single PyTorch call makes a level's
        # candidates and histograms them. The candidate-array entry hist16_peak
        # is the same kernel behind another reader; its numbers at 400k votes,
        # with torch.bincount as the library call, stand beside it.
        dict(name="hist16_peak", route="cuda", source=hist16.SOURCE, replaces=hist16.REPLACES,
             entry="hist16_level_peak", launches=launches["hist16_peak"], demo_launches=demo_k2,
             max_abs_err=max(r["err"] for r in k2 + k2_levels),
             ms=k2_level["ms"], plain_ms=k2_level["plain_ms"], bound_ms=k2_level["bound_ms"],
             bound_by=k2_level["bound_by"], library_ms=None, device_ms=k2_level["device_ms"],
             candidate_array_entry=dict(ms=k2_cand["ms"], device_ms=k2_cand["device_ms"],
                                        plain_ms=k2_cand["plain_ms"], bound_ms=k2_cand["bound_ms"],
                                        bound_by="bytes", library_ms=k2_cand["library_ms"])),
        dict(name="sphere_accumulate", route="cuda", source=sphere.SOURCE, replaces=sphere.REPLACES,
             launches=k3_launches, max_abs_err=max(r["err"] for r in k3),
             ms=k3_main["ms"], plain_ms=k3_main["plain_ms"], bound_ms=k3_main["bound_ms"],
             bound_by="operations", library_ms=k3_main["library_ms"],
             device_ms=k3_main["device_ms"]),
    ]
    say(f"[slice] e2e_ms_per_instance {e2e_ms:.1f}")
    say(f"[eval] evaluate_real275_parallel ms_per_instance {eval_ms:.1f}, without model loading "
        f"and scoring {pose_ms:.1f} (world 1, launches {eval_launches})")
    say(f"[frames] evaluate_real275 ms_per_frame {frame_ms:.1f}, instance by instance "
        f"ms_per_instance {single_ms:.1f}, visual stage ms_per_frame batched {vis_batched:.1f} / "
        f"instance by instance {vis_singles:.1f} (launches {frame_launches})")
    say("[train] ms_per_step " + ", ".join(f"{b} {ms:.1f}" for b, ms in train_ms.items()))
    say("[render train] ms_per_frame " + ", ".join(f"{r} {renders[r]['ms']:.1f}" for r in renders)
        + f"; DinoFeatureExtractor ms_per_call {extractor['ms']:.1f} (K1 {extractor['k1_ms']:.2f} of "
        f"{extractor['busy_ms']:.2f} device ms); ms_per_step "
        + ", ".join(f"{b} {ms:.1f}" for b, ms in render_train_ms.items()))
    say(f"[demo] ms_per_frame {demo_ms:.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in demo_stages.items())
        + f"), device busy {demo_busy:.1f}%, launches K1 {demo_k1}, K2 {demo_k2}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
