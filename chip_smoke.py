#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`cppf2_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero. Phases 3
to 10 run the driver's programs eagerly (`programs.disable_capture()`), as
they ran before the programs were captured: their plain swaps, stage timers
and recorded kernel inputs need the eager route (phases 7 and 8 are the
training programs' eager baseline). Phases 11 to 14 run the captured programs:
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
     forward) and 4 K2 launches (4 levels, both branches as the two rows of
     each launch). It runs again with
     every kernel swapped for its plain version and the same draws, and the
     two poses must agree. Then the e2e time per instance, the stage
     breakdown and the device-busy share. Then the fused level
     (hist16_level_peak) against its plain version on the inputs of all 4
     levels of that instance (two rows each): the same peak cell and the
     same count on every row, exactly; timed at level 0, a coarse arc level
     and a fine one. Then the fused level over rows at the production shapes
     (6,250 x 16 circle, 6,250 x 16 arc, 50,000 x 8 arc twice) for B = 2, 8
     and 16 rows of different windows, row 0 without a valid vote and every
     other row with a forced tie: one launch a call, each row exact against
     the batched plain version; the fine level timed beside B single-row
     launches and its bound, B x the single row's.
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
     draws. One ViT forward per frame: 24 K1 launches a frame, and 4 K2
     launches a (category, crop tier) group. Every instance is posed; each pose equals
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
     extractor at stride 4: 24 K1 launches at (16, 4097, 64) and 4 K2
     launches per frame, the .pth loads as the ViT it came from, an overlay
     PNG and a pose file per frame read back, the proposer's pick overlaps the
     mug on every frame (IoU 0.5); the same run with every kernel swapped for
     its plain version: the same masks and branch picks, R within 1 degree, T
     within 3 mm. ms per frame split into image read, proposer, descriptor
     stage, pose, overlay + PNG write, and the device-busy share.

 10. the int8 ViT and the variants: DinoFeatureExtractor(quant="int8")
     (ViT-L/14 at stride 4, layer scale 1, seeded weights quantized at load):
     96 int8 linears and 24 K1 launches at (16, 4097, 64) a call, K1 against
     its plain version under the int8 weights (max |diff| 1e-2, cosine
     0.999), descriptor cosine of int8 and bf16 against the float32 "hbm"
     route of the same weights (int8 0.999, bf16 0.9999), ms back to back
     and on the device beside the bf16 extractor's; `estimate_instance` with
     an int8 ViT-L/14 at stride 8 against its all-plain route (the same
     pick, R 1 degree, T 3 mm), e2e and descriptor ms beside the bf16 ViT's;
     `masked_window_descriptors` at crop 256 stride 4 (K1 against plain,
     2e-3 and 0.9999); the chunked attention against "hbm" (cosine 0.9999);
     colour SHOT of the slice's cloud on the card against the CPU; the exact
     kNN against the default one in `preprocess_frame`; the native IoU and
     record reader on the card's host, each equal to its Python route.

 11. a frame group's instances in one batched pass: two REAL275-format
     frames of eight instances (eight mugs, one group of 16 rows; four mugs,
     two bowls and two cans, groups of 8, 4 and 4 rows) through
     `dispatch_frame` and through groups of one (`dispatch_instance` for each
     detection) on the same draws: the same picks, R within 1 degree, T
     within 3 mm; per frame and route the ms, the K2 launches (4 a group),
     the `align_pose` calls (one a group) and rows, the frontend calls and
     each branch MLP's forwards (one a group, each over the group's
     instances), the peak device memory, and the batched route's
     device-busy share. Per group, the frontend alone batched against one
     call an instance, and the largest |logit| difference between one MLP
     forward for the group and one an instance. Then `evaluate_real275_parallel` at world 1 on the two
     frames, a rank block of four instances one pose group (4 rows), against
     each instance alone on the same draws (R 1 degree, T 3 mm) and its
     launches (4 K2 a block). Both routes run once before they are counted:
     their programs are captured then, and the counted runs replay them;
     the counts of `align_pose` calls, frontend calls and MLP forwards are
     those the programs credit at each replay. The evaluator runs eagerly
     here, its counts those of one pass; phase 13 replays its blocks.
 12. the captured programs (`cppf2_torch/eval/programs.py`): phase 11's two
     layouts and eleven mugs (r 4 cm at 0.85 m: chunks of 8 and 3, the 3
     padded to 4) through `dispatch_frame`, each captured on one frame and
     replayed three times on a second frame of the same keys with fresh
     draws, then that frame twice through the eager route: the replayed
     rows equal the eager ones to the bit (or, where two eager runs differ,
     R 1 degree, T 3 mm, the same picks), the launches of a replay equal
     what its programs credit (24 K1 a ViT pack, 4 K2 a chunk), the padded
     row is dropped at fetch; per frame the first dispatch's ms, the
     replay's e2e and host ms per `dispatch_frame` call, the eager ms, the
     busy share, the programs captured and replayed, the eager peak memory
     beside the shared graph pool's reserved MiB. Then `estimate_instance`
     captured on phase 3's frame and replayed on another, against eager on
     the same inputs (equal to the bit), e2e ms and busy share of both.
 13. the serving programs that ran eagerly before, each captured on one
     input and replayed on another with fresh draws, against the eager route
     on the same inputs (equal to the bit, or within the spread of two eager
     runs, printed where there is one): `estimate_instance` on the `vit=`
     route (stride 8) and the `dino_extractor=` route (stride 4, the host
     crop): three programs replayed a call (frontend, visual stage,
     ensemble), nothing eager, 24 K1 and 4 K2 credited a replay, no
     device-to-host copy while dispatching, replay and eager ms and busy
     shares, the replay's stages (frontend, host crop, visual, the rest);
     a frame of three mugs and a bowl whose mask fits no crop tier
     through `dispatch_frame` + `fetch_frames`: the bowl's three programs
     replayed, no program and no frontend eager in a replayed frame, replay
     and eager ms; `evaluate_real275_parallel` at world 1 on phase 11's
     frames with its models handed in: a first run (captures), a replayed
     run and two eager runs, ms per instance, the block programs and their
     sizes, 4 K2 a block; the extractor alone at 256 x 256, stride 4, bf16
     and int8: replay and eager ms, 24 K1 (and 96 int8 linears) a replay.

 14. the training programs: a splat and a raster frame (480x640, 250,000
     samples, 2048 points) of a fixed mug, each captured on one draw and
     replayed on another, equal to the eager route on the same inputs in
     depth, gray, cloud, SHOT and count, bit for bit; ms per frame replayed
     and eager on fresh meshes (a frame whose mesh captures a new raster
     bucket's program left out), split into host mesh + samples, the device
     part and the one read, the programs made and the first call's ms. Then,
     on a world-1 NCCL group, the `shot`, `dino` and `dino-e2e` steps (phase
     7's records, 10,000 tuples, the lr halved after step 10), 20 steps each
     from the same weights, batches and uniforms, replayed against the eager
     route with the same capturable AdamW (losses and final parameters equal,
     or within two eager runs' spread), AdamW's step count 20, the lr of
     `make_lr_schedule` after steps 10 and 20, the plain AdamW's losses within
     1e-3 relative, no kernel of the port launched; ms per step replayed and
     eager and the busy shares, and eager with the plain AdamW. Then `train_category("mug", "dino")` on a
     rendered pool of 64 frames with every program replayed: 24 K1 credited
     for each pool frame and refresh, the loss falling, ms per step beside
     phase 8's; the checkpoint restores and the next two steps' losses equal
     those of the state in memory. The graph pool's reserved MiB and the
     raster programs (one per mesh bucket).
 15. the accuracy entry points (`cppf2_torch/scripts/`, `examples/`): the
     seeded ViT-L/14 built on the card (the JAX package's seed-0 init tree,
     made on the device) and a few of its leaves held to the same function
     on the CPU (at most 4 ulps, at least 99.9% of their bf16 casts equal;
     block 0 from a depth-1 tree, which the fold-like split makes the same);
     `ensemble_benchmark.main` with RESULTS.md's reference flags
     (`--eval-only ckpts_r3 --shot-ckpts ckpts_r3 --stride 8`: 4096
     points, 20,000 pairs, 3 restarts, per-branch mug) on 4 frames each of
     can and mug: per-frame errors beside the first rows of
     `benchmarks/r5_production/errors_<cat>.npz`, the mug frames' handle
     visibility equal to r5's, every per-frame unit a program replayed with
     no eager run, K1 24 a frame and K2 12 an ensemble pass (3 restarts x 4
     levels), each program's launches accounted for; the first 2 frames of
     each again through `eval_ensemble`, on the kernel route and all-plain
     and eager (same picks and handle visibility, R 1 deg, T 3 mm); then
     `custom_training --quick`, its 150 steps one program replayed: the
     loss falls, the held-out error printed.

Before the last line: one JSON object with every kernel's numbers (K2 is one
row: the 4 launches of the slice, all through the fused entry at two rows,
with a fine level's times, and the demo's launches; the candidate-array
entry's times stand inside it, and the fine level at 16 rows as `batched`,
with phase 11's launches; K1's row holds the batched shape and the stride-4 shape
nested, the latter with the demo's launches; K1 and K2 carry the launches of
phase 10's int8 paths as `int8_launches`; both carry `replay_launches`,
what one replay of phase 12's eight-mug frame launches, and
`serving_replay_launches`, what one replay of each of phase 13's programs
credits; K1 carries `train_replay_launches`, the launches of phase 14's
replayed "dino" render trainer; K1 and K2 carry `accuracy_launches`, phase
15's ensemble run), then the card's name and power limit. The last line:
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
import types
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
    # the ones through the fused entry: on this path all of them, one a level
    # for both branches (B = 2 rows)
    launches = {"mha": attention.mha.launches, "hist16_peak": hist16.hist16_peak.launches,
                "hist16_level_peak": hist16.hist16_level_peak.launches}
    say(f"[slice] first call {first_ms:.1f} ms, launches {launches}")
    if launches != {"mha": vit_cfg.depth, "hist16_peak": pipe.vote_levels,
                    "hist16_level_peak": pipe.vote_levels}:
        raise AssertionError(f"launch counts {launches}: expected 24 K1 and 4 K2 (two rows each), "
                             f"all fused levels")

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
        # a level as it ran before the fusion: each row's candidates in device
        # memory, read back by a K2 launch of their own
        peaks = []
        for r in range(c.shape[0]):
            arc = (None, None) if theta_star is None else (theta_star[r], span[r])
            cand, ok_v = hist16.level_candidates(c[r], x0[r], y0[r], odist[r], ok[r], samples, *arc)
            peaks.append(hist16.hist16_peak(cand, ok_v, lo[r], cell[r]))
        return torch.stack([p[0] for p in peaks]), torch.stack([p[1] for p in peaks])

    fused, hist16.hist16_level_peak = hist16.hist16_level_peak, written_out
    try:
        stage_breakdown(once, "candidates written out, as before the fusion", repeats=1)
    finally:
        hist16.hist16_level_peak = fused
    device_busy(once, e2e_ms)
    return launches, e2e_ms, level_rows


def level_bound(sub, n_smp, arc, rows=1):
    """(bound ms, what bounds it) of one fused K2 level over `rows` rows of
    `sub` pairs x `n_smp` samples: each row's pair data read once (c, x0, y0,
    odist, ok and, on an arc level, theta_star and span), the shared table,
    each row's window read and (4,) result written; the f32 instructions of
    every vote."""
    per_pair = (9 + 1 + (2 if arc else 0)) * 4 + 1
    table = (1 if arc else 2) * n_smp * 4
    bytes_moved = rows * (sub * per_pair + 2 * 3 * 4 + 4 * 4) + table
    ops = rows * sub * n_smp * (LEVEL_INSTR_ARC if arc else LEVEL_INSTR_CIRCLE)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32_INSTR * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops > by_bytes else "bytes")


def check_levels(once, pipe):
    """The fused K2 level against its plain version on the inputs of every
    level of one instance, both branches as the two rows of each launch:
    the same peak cell and the same count on every row, exactly. Then its
    time at level 0, a coarse arc level and a fine level. Returns one row per
    timed level."""
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
                        float(torch.max(torch.abs(got[1] - want[1])))))
        if errs[-1] != 0.0 or not torch.equal(got[0], want[0]):
            raise AssertionError(f"fused level {len(calls) - 1}: kernel {got[0].tolist()} "
                                 f"{got[1].tolist()} vs plain {want[0].tolist()} {want[1].tolist()}")
        return got

    hist16.hist16_level_peak = both
    try:
        once()
    finally:
        hist16.hist16_level_peak = kernel
    levels = pipe.vote_levels
    if len(calls) != levels or any(a[0].shape[0] != 2 for a in calls):
        raise AssertionError(f"{[tuple(a[0].shape) for a in calls]}: expected {levels} fused levels "
                             f"of two rows in one instance")
    say(f"[K2 hist16_level_peak] {len(calls)} levels, both branches as two rows of each launch: "
        f"peak cell and count equal the plain version's exactly on every row")
    rows = []
    for level in (0, 1, levels - 1):
        args = calls[level]
        c, samples, theta_star = args[0], args[5], args[8] if len(args) > 8 else None
        n_rows, sub, n_smp, arc = c.shape[0], c.shape[1], samples.shape[-1], theta_star is not None
        ms, dev_ms = timed(lambda: kernel(*args))
        plain_ms, plain_dev_ms = timed(lambda: hist16.hist16_level_peak_plain(*args), iters=10)
        bound_ms, bound_by = level_bound(sub, n_smp, arc, n_rows)
        above_bound(f"hist16_level_peak level {level}", bound_ms, ms=ms, device_ms=dev_ms)
        say(f"[K2 hist16_level_peak] level {level} ({'arc' if arc else 'circle'}) {n_rows} rows x "
            f"{sub} pairs x {n_smp} samples  back to back / on the device alone, ms: kernel "
            f"{ms:.4f} / {dev_ms:.4f}  plain {plain_ms:.4f} / {plain_dev_ms:.4f}  bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        rows.append(dict(level=level, rows=n_rows, err=max(errs), ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
    return rows


def batched_level_inputs(dev, n_rows, sub, n_smp, arc, seed):
    """One fused level's inputs for `n_rows` rows at the pose graph's shapes,
    each row its own window (cells of 1 to 12 mm around a center at 0.6 to
    1 m) and its own pairs. Row 0 has no valid vote; rows 1, 3, 5, ... have a
    tie: two cells, (2, 12, 7) and (9, 3, 4), get the same count, above every
    other cell's, from pairs whose circle is far smaller than a cell, and no
    other vote falls into either (the lower flat index, (2, 12, 7), must
    win). Returns the args of `hist16_level_peak`."""
    import torch

    from cppf2_torch.ops import hist16, voting

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    cell = 0.001 + 0.011 * rand(n_rows, 3)
    lo = torch.tensor([0.0, 0.0, 0.6], device=dev) + 0.4 * rand(n_rows, 3) - cell * 8
    c = lo[:, None] + cell[:, None] * (2.0 + 12.0 * rand(n_rows, sub, 3))
    x0 = torch.nn.functional.normalize(torch.randn((n_rows, sub, 3), generator=g, device=dev), dim=-1)
    y0 = torch.randn((n_rows, sub, 3), generator=g, device=dev)
    y0 = torch.nn.functional.normalize(y0 - (y0 * x0).sum(-1, keepdim=True) * x0, dim=-1)
    od = cell.amax(-1, keepdim=True) * (0.3 + 5.0 * rand(n_rows, sub))
    ok = rand(n_rows, sub) < 0.9
    ok[0] = False
    if arc:
        samples = voting._linspace(n_smp, dev)
        theta_star = (2 * rand(n_rows, sub) - 1) * math.pi
        span = torch.clamp(1.2 * 8 * cell.amax(-1, keepdim=True) / od, 0.0, math.pi)
        extra = [theta_star, span]
    else:
        ang = torch.arange(n_smp, dtype=torch.float32, device=dev) / n_smp * 2 * math.pi
        samples, extra = torch.stack([torch.cos(ang), torch.sin(ang)]), [None, None]
    tie_cells = torch.tensor([[2.0, 12.0, 7.0], [9.0, 3.0, 4.0]], device=dev)
    for r in range(1, n_rows, 2):
        # keep every other vote out of the two tie cells, then give each the same count
        cand, _ = hist16.level_candidates(c[r], x0[r], y0[r], od[r], ok[r], samples,
                                          *(None if e is None else e[r] for e in extra))
        flat, inside = hist16._quantize(cand, torch.ones_like(cand[:, 0], dtype=torch.bool), lo[r],
                                        cell[r])
        hits = inside & ((flat == 2 * 256 + 12 * 16 + 7) | (flat == 9 * 256 + 3 * 16 + 4))
        ok[r] &= ~hits.reshape(sub, n_smp).any(-1)
        counts = hist16.hist16_counts_plain(cand, ok[r].repeat_interleave(n_smp), lo[r], cell[r])
        n_tie = int(counts.max()) // n_smp + 2
        for k in range(2):
            sl = slice(k * n_tie, (k + 1) * n_tie)
            c[r, sl] = lo[r] + tie_cells[k] * cell[r]
            od[r, sl] = cell[r].min() * 1e-3
            ok[r, sl] = True
            if arc:
                extra[1][r, sl] = 0.0
    return [c, x0, y0, od, ok, samples, lo, cell, *extra], tie_cells


def check_hist16_batched(dev):
    """The batched fused level against its batched plain version on all 4
    levels of the center vote at the production shapes (50,000 pairs; the
    coarse levels' 6,250), at B = 2, 8 and 16 rows: the same center and count
    on every row, exactly, the tie rows' peak at the lower flat index and the
    empty row at count 0; one launch per call. Then the fine level's time at
    each B beside B single-row launches and its bound (B x the single-row
    bound). Returns one row per B, with the fine level's numbers."""
    import torch

    from cppf2_torch.ops import hist16

    shapes = [(6250, 16, False), (6250, 16, True), (50000, 8, True), (50000, 8, True)]
    out = []
    for n_rows in (2, 8, 16):
        err = 0.0
        for level, (sub, n_smp, arc) in enumerate(shapes):
            args, tie_cells = batched_level_inputs(dev, n_rows, sub, n_smp, arc, seed=100 * n_rows + level)
            before = hist16.hist16_level_peak.launches
            got_c, got_n = hist16.hist16_level_peak(*args)
            if hist16.hist16_level_peak.launches != before + 1:
                raise AssertionError(f"B={n_rows} level {level}: more than one launch")
            want_c, want_n = hist16.hist16_level_peak_plain(*args)
            torch.cuda.synchronize()
            err = max(err, float(torch.max(torch.abs(got_c - want_c))),
                      float(torch.max(torch.abs(got_n - want_n))))
            if not (torch.equal(got_c, want_c) and torch.equal(got_n, want_n)):
                bad = [r for r in range(n_rows) if not (torch.equal(got_c[r], want_c[r])
                                                        and torch.equal(got_n[r], want_n[r]))]
                raise AssertionError(f"B={n_rows} level {level}: rows {bad} differ: kernel "
                                     f"{got_c[bad].tolist()} {got_n[bad].tolist()} vs plain "
                                     f"{want_c[bad].tolist()} {want_n[bad].tolist()}")
            lo, cell = args[6], args[7]
            ids = torch.round((got_c - lo) / cell)
            if float(got_n[0]) != 0.0 or not all(torch.equal(ids[r], tie_cells[0])
                                                 for r in range(1, n_rows, 2)):
                raise AssertionError(f"B={n_rows} level {level}: empty row count {float(got_n[0])}, "
                                     f"tie rows' peaks {ids[1::2].tolist()}")
        # the fine level, timed: one launch of B rows, B launches of one row, the plain version
        single = [[a if a is None or a is args[5] else a[r] for a in args] for r in range(n_rows)]
        ms, dev_ms = timed(lambda: hist16.hist16_level_peak(*args))
        each_ms, each_dev_ms = timed(lambda: [hist16.hist16_level_peak(*a) for a in single], iters=5)
        plain_ms = time_ms(lambda: hist16.hist16_level_peak_plain(*args), iters=2, repeats=1)
        bound_ms, bound_by = level_bound(50000, 8, True, n_rows)
        above_bound(f"hist16_level_peak B={n_rows}", bound_ms, ms=ms, device_ms=dev_ms)
        say(f"[K2 hist16_level_peak, rows] B={n_rows}: 4 levels (6,250 x 16 circle, 6,250 x 16 arc, "
            f"50,000 x 8 arc twice), one launch each, every row exact (the empty row 0, the tie rows "
            f"at (2, 12, 7)); fine level back to back / on the device alone, ms: one launch "
            f"{ms:.4f} / {dev_ms:.4f}  {n_rows} single-row launches {each_ms:.4f} / {each_dev_ms:.4f}"
            f"  plain {plain_ms:.4f}  bound {bound_ms:.5f} ms ({bound_by}; B x the single row's "
            f"{level_bound(50000, 8, True)[0]:.5f})")
        out.append(dict(b=n_rows, err=err, ms=ms, device_ms=dev_ms, singles_ms=each_ms,
                        singles_device_ms=each_dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by))
    return out


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


def cap_frame(rng, h, w, centers, radii):
    """Sphere caps of `radii` at `centers` on an empty (h, w) depth map in
    metres (REAL275 K), with depth noise from `rng`: (depth, masks)."""
    fx, fy = REAL275_K[0, 0], REAL275_K[1, 1]
    ys, xs = np.mgrid[0:h, 0:w]
    depth = np.zeros((h, w), np.float32)
    masks = []
    for (cx, cy, cz), r in zip(centers, radii):
        d2 = (xs - (REAL275_K[0, 2] + fx * cx / cz)) ** 2 + (ys - (REAL275_K[1, 2] + fy * cy / cz)) ** 2
        m = d2 < (r * fx / cz) ** 2
        bump = np.sqrt(np.maximum(r ** 2 - d2 * (cz / fx) ** 2, 0.0))
        depth = np.where(m, cz - bump + rng.normal(0, 3e-4, (h, w)), depth).astype(np.float32)
        masks.append(m)
    return depth, masks


def write_real275_frame(root, h=480, w=640, name="scene_1_0000", seed=4, shift=0.0, color=False,
                        cats=None, centers=None, radii=None):
    """One REAL275-format frame: sphere caps (by default four, of four
    categories, at 0.8-0.9 m) moved sideways by `shift` metres, their masks
    as detections, a depth PNG in millimetres and, with `color`, a random
    8-bit colour PNG."""
    from cppf2_torch.config import SYNSET_NAMES
    from cppf2_torch.eval.png import write_png16, write_png_rgb8

    cats = cats or FRAME_CATS
    centers = centers or [(-0.13, -0.08, 0.82), (0.12, -0.07, 0.88), (-0.11, 0.09, 0.85),
                          (0.13, 0.08, 0.8)]
    centers = [(x + shift, y, z) for x, y, z in centers]
    radii = radii or [0.045, 0.07, 0.05, 0.06]
    n = len(cats)
    rng = np.random.default_rng(seed)
    depth, masks = cap_frame(rng, h, w, centers, radii)
    rts, scales = [], []
    for (cx, cy, cz), r in zip(centers, radii):
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
           "gt_handle_visibility": np.ones(n, np.int64), "pred_class_ids": ids,
           "pred_masks": np.stack(masks, -1), "pred_bboxes": np.zeros((n, 4), np.int64),
           "pred_scores": np.ones(n)}
    with open(os.path.join(root, "detections", f"results_{name}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return os.path.join(root, "detections"), os.path.join(root, "images")


def zero_counts():
    """The launch counters, on the wrappers themselves (`_MHA`, `_PEAK`,
    `_LEVEL`), where they stay while a module's name is swapped and where
    the programs credit their replays."""
    from cppf2_torch.ops import attention, hist16, sphere

    attention._MHA.launches = sphere.sphere_accumulate.launches = 0
    hist16._PEAK.launches = hist16._LEVEL.launches = 0


def read_counts():
    from cppf2_torch.ops import attention, hist16, sphere

    return {"mha": attention._MHA.launches, "hist16_peak": hist16._PEAK.launches,
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
    n_groups = sum(len(_groups(f[2])) for f in frames)
    want = {"mha": vit_cfg.depth * n_frames, "hist16_peak": pipe.vote_levels * n_groups,
            "sphere_accumulate": 0}
    say(f"[frames] evaluate_real275 on {n_frames} frames x {len(FRAME_CATS)} instances: launches "
        f"{launches} (one ViT forward a frame: {vit_cfg.depth} K1 launches; "
        f"{pipe.vote_levels} K2 launches a (category, crop tier) group, {n_groups} groups)")
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
            posed, want = read_counts(), {"mha": v.cfg.depth, "hist16_peak": pipe.vote_levels,
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
    draws = synthetic.threefry_draws(1, 2, h * w, True, dev)
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
            posed, want = read_counts(), {"mha": v.cfg.depth, "hist16_peak": pipe.vote_levels,
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
    from cppf2_torch.models.dinov2 import VIT_L14, DinoViT
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
    # both branches of a frame's one instance are the two rows of each level's launch
    want_launches = {"mha": vit_cfg.depth * n_frames, "hist16_peak": pipe.vote_levels * n_frames,
                     "hist16_level_peak": pipe.vote_levels * n_frames}
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
               (driver, "_instance_visual"), (demo, "run_frame"),
               (demo, "draw_pose_overlay"), (demo, "write_png_rgb8"), (demo, "load_category_models"),
               (demo, "load_dino_extractor")]
    _, spent, total_s = run(os.path.join(root, "out_timed"), targets)
    per = {k: v / n_frames for k, v in spent.items()}
    setup_ms = spent["load_category_models"] + spent["load_dino_extractor"]
    frame_ms = (total_s * 1e3 - setup_ms) / n_frames
    stages = {"image read": per["read_png_rgb8"] + per["_read_depth"],
              "proposer": per["auto_instance_mask"],
              "descriptors (host crop + extractor)": per["_instance_visual"],
              "pose": per["run_frame"] - per["_instance_visual"] - per["draw_pose_overlay"],
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


# ---------------------------------------------------------------------------
# Phase 10: the int8 ViT and the variants
# ---------------------------------------------------------------------------

def unit_cos(a, b):
    """(min, mean) cosine of two sets of unit descriptors, over the rows
    where the reference is not zero (keypoints outside the grid)."""
    import torch

    keep = torch.linalg.norm(b, dim=-1) > 0
    cos = torch.sum(a * b, dim=-1)[keep]
    return float(cos.min()), float(cos.mean())


def check_int8_extractor(dev, vit_cfg, out_size=256, n_pts=8192):
    """Phase 10, part 1: DinoFeatureExtractor(quant="int8") at stride 4
    (ViT-L/14, K1 at (16, 4097, 64)) with seeded random weights at layer
    scale 1, on a random 256 x 256 crop and 8192 random keypoints (the
    inputs of `scripts/dinov2_bench.py --parity`). The same seed gives
    every route the same float weights. Returns the part's numbers."""
    import torch

    from cppf2_torch.models.dinov2 import DinoFeatureExtractor
    from cppf2_torch.models.layers import QDense
    from cppf2_torch.ops import attention

    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(0, 1, (out_size, out_size, 3)).astype(np.float32), device=dev)
    kp = torch.as_tensor(rng.uniform(0, out_size - 1, (n_pts, 2)).astype(np.float32), device=dev)

    def extractor(**kw):
        cfg = dataclasses.replace(vit_cfg, layerscale_init=1.0, **kw)
        return DinoFeatureExtractor(cfg=cfg, out_size=out_size, device=dev.type).init_random(
            torch.Generator(device=dev).manual_seed(0))

    t0 = time.perf_counter()
    int8 = extractor(quant="int8")
    quant_s = time.perf_counter() - t0
    shapes = []
    QDense.launches = 0
    before = attention.mha.launches
    with recorded(attention, "mha", lambda a, k, out: shapes.append(tuple(a[0].shape))):
        got = int8(img, kp)
        torch.cuda.synchronize()
    k1 = attention.mha.launches - before
    qd = QDense.launches
    if (qd, k1) != (4 * vit_cfg.depth, vit_cfg.depth) or set(shapes) != {(16, 4097, 64)}:
        raise AssertionError(f"int8 extractor: {qd} int8 linears and {k1} K1 launches at "
                             f"{sorted(set(shapes))}; expected 96 and 24 at (16, 4097, 64)")
    # K1 against its plain version under the same int8 weights: K1 swapped
    # for mha_plain, nothing else changed
    saved = attention.mha
    attention.mha = attention.mha_plain
    try:
        plain = int8(img, kp)
    finally:
        attention.mha = saved
    err = float(torch.max(torch.abs(got - plain)))
    cos_min, cos_mean = unit_cos(got, plain)
    # Limits: max |diff| 1e-2, every cosine 0.999. The int8 activation codes
    # turn a last-bit difference of a linear's input into a step of
    # max|x| / 127, so the bf16 extractor's limits (2e-3, 0.9999) do not
    # hold here: on the CPU an online softmax over 64-key blocks in place of
    # the plain attention (K1's rounding of P, block by block) read 2.25e-3
    # and 0.99984 at ViT-L width, depth 12, layer scale 1 (0.00056 and
    # 0.99999 for bf16 linears). A K1 that returned zeros drops a branch as
    # large as the residual stream and fails both.
    if not math.isfinite(err) or err > 1e-2 or cos_min < 0.999:
        raise AssertionError(f"int8 extractor: K1 vs plain attention max |diff| {err}, min cos {cos_min}")
    bf16 = extractor()
    ref = extractor(compute_dtype="float32", attn_impl="hbm")
    want = ref(img, kp)
    q_cos = unit_cos(got, want)
    b_cos = unit_cos(bf16(img, kp), want)
    # the repo's int8 bound (tests/test_dinov2.py: every cosine against f32
    # above 0.999), and the bf16 extractor's 0.9999
    if q_cos[0] < 0.999 or b_cos[0] < 0.9999:
        raise AssertionError(f"descriptor cosine vs f32: int8 {q_cos}, bf16 {b_cos}")
    del ref, want
    ms, dev_ms = timed(lambda: int8(img, kp), iters=5, repeats=3)
    bf_ms, bf_dev_ms = timed(lambda: bf16(img, kp), iters=5, repeats=3)
    top_kernels(lambda: int8(img, kp), "int8 extractor")
    say(f"[int8 extractor] ViT-L/14 stride 4, 256x256 crop -> 896x896, {n_pts} keypoints, layer "
        f"scale 1: {qd} int8 linears and {k1} K1 launches at (16, 4097, 64) a call; K1 vs plain "
        f"attention max |diff| {err:.3g}, min cos {cos_min:.6f}, mean {cos_mean:.6f} (limits 1e-2, "
        f"0.999); descriptor cosine vs f32 hbm: int8 mean {q_cos[1]:.5f} min {q_cos[0]:.5f}, "
        f"bf16 mean {b_cos[1]:.5f} min {b_cos[0]:.5f}; ms per call back to back / device: int8 "
        f"{ms:.2f} / {dev_ms:.2f}, bf16 {bf_ms:.2f} / {bf_dev_ms:.2f}; load + quantize "
        f"{quant_s:.1f} s")
    return dict(img=img, kp=kp, bf16=bf16, int8=int8, err=err, cos_min=cos_min, cos_mean=cos_mean,
                int8_vs_f32=q_cos, bf16_vs_f32=b_cos, ms=ms, device_ms=dev_ms, bf16_ms=bf_ms,
                bf16_device_ms=bf_dev_ms, qdense=qd, k1=k1)


def top_kernels(fn, label, n=8):
    """The device time of one call of `fn` by kernel name (torch.profiler),
    the `n` largest, printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
    say(f"[{label}] device time of one call {total:.2f} ms; top kernels: "
        + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms" for e in top))


def check_int8_instance(dev, pipe, vit_cfg, frame_hw=(480, 640)):
    """Phase 10, part 2: `estimate_instance` on the slice's frame with an
    int8 ViT-L/14 at stride 8 (the int8 route of `bench.py:183`), seeded
    production weights (layer scale 1e-5): the kernel route against the
    all-plain route on the same draws (the same pick, R 1 degree, T 3 mm);
    e2e ms and `bbox_crop_descriptors` ms beside the bf16 ViT's, in turns.
    Returns (launches, e2e ms int8 / bf16, descriptor ms int8 / bf16,
    the two poses)."""
    import torch

    from cppf2_torch.eval import driver
    from cppf2_torch.models.dinov2 import DinoFeatureExtractor
    from cppf2_torch.models.layers import QDense
    from cppf2_torch.ops import attention, hist16

    rgb, depth, mask = make_frame(np.random.default_rng(0), *frame_hw)
    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    models = driver.load_category_models(ckpts, ["mug"], torch.bfloat16, dev)["mug"]

    def backbone(**kw):
        return DinoFeatureExtractor(cfg=dataclasses.replace(vit_cfg, **kw), device=dev.type).init_random(
            torch.Generator(device=dev).manual_seed(0)).model

    vits = {"int8": backbone(quant="int8"), "bf16": backbone()}
    draws = driver.draw_instance(depth.shape, mask, "mug", pipe, dev,
                                 torch.Generator(device=dev).manual_seed(0))

    def once(vit):
        est = driver.estimate_instance(rgb, depth, mask, REAL275_K, models, "mug", pipe, vit=vit,
                                       device=dev, draws=draws, stride=8)
        torch.cuda.synchronize()
        return est

    QDense.launches = 0
    counts0 = read_counts()
    est = once(vits["int8"])
    launches = {k: v - counts0[k] for k, v in read_counts().items()}
    launches["qdense"] = QDense.launches
    if launches != {"mha": vit_cfg.depth, "hist16_peak": pipe.vote_levels, "sphere_accumulate": 0,
                    "qdense": 4 * vit_cfg.depth}:
        raise AssertionError(f"int8 instance launches {launches}")
    saved = attention.mha, hist16.hist16_peak, hist16.hist16_level_peak
    attention.mha, hist16.hist16_peak = attention.mha_plain, hist16.hist16_peak_plain
    hist16.hist16_level_peak = hist16.hist16_level_peak_plain
    try:
        plain = once(vits["int8"])
    finally:
        attention.mha, hist16.hist16_peak, hist16.hist16_level_peak = saved
    vals = [est.rotation, est.translation, est.scale, est.scale_norm, est.loss]
    if not all(bool(torch.isfinite(x).all()) for x in vals):
        raise AssertionError(f"int8 instance: non-finite pose {est}")
    r, rp = (e.rotation.double().cpu().numpy() for e in (est, plain))
    ang = rt_angle_deg(r, rp)
    dt = float(torch.max(torch.abs(est.translation - plain.translation)))
    say(f"[int8 instance] kernels vs plain: R {ang:.4f} deg, T {dt * 1e3:.4f} mm, pick "
        f"{int(est.pick)} vs {int(plain.pick)}; launches {launches}")
    if ang > 1.0 or dt > 3e-3 or int(est.pick) != int(plain.pick):
        raise AssertionError("int8 instance: kernel path and plain path disagree")
    e2e = {k: [] for k in vits}
    desc = {k: [] for k in vits}
    for name in ("bf16", "int8", "int8", "bf16", "bf16", "int8"):   # in turns
        with timed_calls([(driver, "bbox_crop_descriptors")]) as spent:
            t0 = time.perf_counter()
            once(vits[name])
            e2e[name].append((time.perf_counter() - t0) * 1e3)
        desc[name].append(spent["bbox_crop_descriptors"])
    e2e_ms = {k: statistics.median(v) for k, v in e2e.items()}
    desc_ms = {k: statistics.median(v) for k, v in desc.items()}
    say(f"[int8 instance] e2e ms per instance (median of 3, in turns): int8 {e2e_ms['int8']:.1f}, "
        f"bf16 {e2e_ms['bf16']:.1f}; bbox_crop_descriptors ms: int8 {desc_ms['int8']:.2f}, bf16 "
        f"{desc_ms['bf16']:.2f}")
    return launches, e2e_ms, desc_ms, (est, plain)


def check_variants(dev, pipe, ext, frame_hw=(480, 640), out_size=256):
    """Phase 10, part 3: `masked_window_descriptors` at crop 256 stride 4
    (K1 against its plain version, the bf16 extractor's backbone at layer
    scale 1); the chunked attention against "hbm" at stride 4; colour SHOT
    on the slice's cloud, card against CPU; the exact kNN against the
    default one in `preprocess_frame`. Returns the part's numbers."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.eval import driver
    from cppf2_torch.infer.frontend import auto_crop, crop_origin, preprocess_frame
    from cppf2_torch.models.dinov2 import DinoFeatureExtractor, masked_window_descriptors
    from cppf2_torch.ops import attention
    from cppf2_torch.ops.neighbors import knn_radius_neighbors
    from cppf2_torch.ops.shot import compute_cshot_features

    out = {}
    rgb, depth, mask = make_frame(np.random.default_rng(0), *frame_hw)
    cat = get_category("mug")
    crop = auto_crop(mask)
    draws = driver.draw_instance(depth.shape, mask, "mug", pipe, dev,
                                 torch.Generator(device=dev).manual_seed(1))
    k_t = torch.as_tensor(REAL275_K, device=dev)
    depth_t, mask_t = torch.as_tensor(depth, device=dev), torch.as_tensor(mask, device=dev)

    def frontend(exact):
        fi = preprocess_frame(depth_t, mask_t, k_t, draws.voxel_perm, draws.voxel_prio, res=cat.res,
                              n_max=pipe.n_points, shot_k=pipe.neighbor_k, crop=crop,
                              origin=crop_origin(mask, mask.shape, crop) if crop else None,
                              exact_knn=exact)
        torch.cuda.synchronize()
        return fi

    fi = frontend(False)
    n = int(fi.count)

    # the fixed window at the frame's own crop origin, 256 x 256, stride 4
    rgb_t = torch.as_tensor(rgb, device=dev).float() / 255.0
    window = torch.tensor(crop_origin(mask, mask.shape, out_size), device=dev)
    model = ext["bf16"].model
    with torch.no_grad():
        shapes = []
        before = attention.mha.launches
        with recorded(attention, "mha", lambda a, k, o: shapes.append(tuple(a[0].shape))):
            got = masked_window_descriptors(model, rgb_t, mask_t, fi.pixel_yx[:n], window,
                                            crop=out_size, stride=4)
        k1 = attention.mha.launches - before
        saved = attention.mha
        attention.mha = attention.mha_plain
        try:
            want = masked_window_descriptors(model, rgb_t, mask_t, fi.pixel_yx[:n], window,
                                             crop=out_size, stride=4)
        finally:
            attention.mha = saved
    err = float(torch.max(torch.abs(got - want)))
    cos = unit_cos(got, want)
    if k1 != model.cfg.depth or set(shapes) != {(16, 4097, 64)} or err > 2e-3 or cos[0] < 0.9999:
        raise AssertionError(f"masked_window_descriptors: {k1} K1 launches at {sorted(set(shapes))}, "
                             f"K1 vs plain max |diff| {err}, min cos {cos[0]}")
    mw_ms = time_ms(lambda: masked_window_descriptors(model, rgb_t, mask_t, fi.pixel_yx[:n], window,
                                                      crop=out_size, stride=4), iters=3, repeats=3)
    say(f"[variants] masked_window_descriptors 256 x 256 stride 4, {n} points: {k1} K1 launches at "
        f"(16, 4097, 64), K1 vs plain max |diff| {err:.3g}, min cos {cos[0]:.6f} (limits 2e-3, "
        f"0.9999); {mw_ms:.2f} ms")
    out["masked_window"] = dict(err=err, cos=cos, ms=mw_ms, k1=k1)

    # chunked against hbm, both bf16, the same weights
    def extractor(**kw):
        cfg = dataclasses.replace(model.cfg, **kw)
        return DinoFeatureExtractor(cfg=cfg, out_size=out_size, device=dev.type).init_random(
            torch.Generator(device=dev).manual_seed(0))

    img, kp = ext["img"], ext["kp"]
    chunked, hbm = extractor(attn_impl="chunked"), extractor(attn_impl="hbm")
    cos = unit_cos(chunked(img, kp), hbm(img, kp))
    ch_ms = time_ms(lambda: chunked(img, kp), iters=2, repeats=2)
    hbm_ms = time_ms(lambda: hbm(img, kp), iters=2, repeats=2)
    # the same online softmax as K1's plain version's rounding, in another order
    if cos[0] < 0.9999:
        raise AssertionError(f"chunked vs hbm: min cos {cos[0]}")
    say(f"[variants] chunked (512-key blocks) vs hbm at stride 4, layer scale 1: cos min "
        f"{cos[0]:.6f} mean {cos[1]:.6f}; ms per call chunked {ch_ms:.1f}, hbm {hbm_ms:.1f}")
    out["chunked"] = dict(cos=cos, ms=ch_ms, hbm_ms=hbm_ms)
    del chunked, hbm

    # colour SHOT of the slice's cloud: the card against the port on the CPU
    colors = rgb_t[fi.pixel_yx[:, 0], fi.pixel_yx[:, 1]]
    radius = cat.res * 10

    def cshot(d):
        return compute_cshot_features(fi.pc.to(d), colors.to(d), fi.valid.to(d), radius,
                                      k=pipe.neighbor_k)

    got_d, got_n = cshot(dev)
    torch.cuda.synchronize()
    want_d, want_n = cshot(torch.device("cpu"))
    valid = fi.valid.cpu()
    err_d = torch.max(torch.abs(got_d.cpu() - want_d), dim=-1).values[valid]
    err_n = torch.max(torch.abs(got_n.cpu() - want_n), dim=-1).values[valid]
    q_d, q_n = float(torch.quantile(err_d, 0.85)), float(torch.quantile(err_n, 0.99))
    cs_ms = time_ms(lambda: cshot(dev), iters=3, repeats=3)
    say(f"[variants] compute_cshot_features on {n} points, k {pipe.neighbor_k}: card vs CPU "
        f"CSHOT 85% of rows within {q_d:.3g}, max {float(err_d.max()):.3g}; normals 99% within "
        f"{q_n:.3g}, max {float(err_n.max()):.3g} (limits 1e-3 / 0.5, 1e-4); {cs_ms:.2f} ms")
    # the frontend tests' quantiles, a decade looser: the card's products and
    # sums round otherwise than the CPU's, and a soft bin near its edge moves
    if not (q_d <= 1e-3 and float(err_d.max()) <= 0.5 and q_n <= 1e-4
            and got_d.shape == (pipe.n_points, 1344)):
        raise AssertionError("compute_cshot_features: card and CPU disagree")
    out["cshot"] = dict(q85=q_d, max=float(err_d.max()), normals_q99=q_n, ms=cs_ms)

    # the exact kNN against the default one on the same cloud, over the
    # in-radius neighbours (beyond the radius the default route's keys all
    # clip to r^2 and follow the column order, the exact route's the distance)
    nb = [knn_radius_neighbors(fi.pc, fi.valid, radius, pipe.neighbor_k, exact=e) for e in (False, True)]
    within = [torch.where(x.valid, x.idx, -1) for x in nb]
    same_list = float(torch.all(within[0] == within[1], dim=-1)[fi.valid].float().mean())
    same_set = float(torch.all(torch.sort(within[0], dim=-1).values == torch.sort(within[1], dim=-1).values,
                               dim=-1)[fi.valid].float().mean())
    ms_default = time_ms(lambda: frontend(False), iters=3, repeats=3)
    ms_exact = time_ms(lambda: frontend(True), iters=3, repeats=3)
    say(f"[variants] exact kNN vs default on {n} points: equal in-radius neighbour lists "
        f"{100 * same_list:.2f}%, equal sets {100 * same_set:.2f}%; preprocess_frame ms default {ms_default:.2f}, "
        f"exact_knn {ms_exact:.2f}")
    if same_set < 0.5:
        raise AssertionError(f"exact kNN: only {same_set:.3f} of the neighbour sets equal the default's")
    out["exact_knn"] = dict(same_list=same_list, same_set=same_set, ms=ms_exact, default_ms=ms_default)
    return out


def check_native(poses, records_path):
    """Phase 10, part 4: the host C++ core on the card's machine. The IoU
    matrix of part 2's two poses against shifted and turned copies of them
    must take the native route and equal the Python route within 1e-6; the
    trainer's record file must open on the native backend and gather what
    the Python backend gathers. Returns the two routes' ms."""
    import torch

    from cppf2_torch import native
    from cppf2_torch.data.records import RecordReader
    from cppf2_torch.eval import iou3d
    from cppf2_torch.eval.pose_errors import _assemble_rt

    lib = native.load()
    if lib is None:
        raise AssertionError("the native library did not build (g++ missing or failing)")
    preds = [_assemble_rt(*(x.detach().cpu().numpy() for x in (e.rotation, e.translation, e.scale,
                                                               e.scale_norm))) for e in poses]
    p_rts = np.stack([rt for rt, _ in preds])
    p_s = np.stack([s for _, s in preds])
    turn = np.eye(4)
    turn[:3, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    g_rts = np.concatenate([p_rts + np.pad(np.full((2, 3, 1), 0.01), ((0, 0), (0, 1), (3, 0))),
                            p_rts @ turn])
    g_s = np.concatenate([p_s, p_s * 0.8])
    rows = {}
    for cls, vis in (("mug", np.array([0, 1, 1, 0])), ("laptop", np.ones(4, int))):
        t0 = time.perf_counter()
        got = iou3d.pairwise_iou_matrix(p_rts, p_s, g_rts, g_s, vis, cls)
        nat_ms = (time.perf_counter() - t0) * 1e3
        route = iou3d.LAST_ROUTE
        saved = native.load
        native.load = lambda: None
        try:
            t0 = time.perf_counter()
            want = iou3d.pairwise_iou_matrix(p_rts, p_s, g_rts, g_s, vis, cls)
            py_ms = (time.perf_counter() - t0) * 1e3
            py_route = iou3d.LAST_ROUTE
        finally:
            native.load = saved
        err = float(np.max(np.abs(got - want)))
        if (route, py_route) != ("native", "python") or err > 1e-6 or not got.max() > 0.5:
            raise AssertionError(f"pairwise_iou_matrix {cls}: routes {route}/{py_route}, max |diff| "
                                 f"{err}, {got.tolist()}")
        rows[cls] = dict(err=err, native_ms=nat_ms, python_ms=py_ms)
    readers = [RecordReader(records_path)]
    saved = native.load
    native.load = lambda: None
    try:
        readers.append(RecordReader(records_path))
    finally:
        native.load = saved
    if [r.backend for r in readers] != ["native", "python"] or len(readers[0]) != len(readers[1]):
        raise AssertionError(f"RecordReader backends {[r.backend for r in readers]}")
    ids = np.random.default_rng(3).integers(0, len(readers[0]), 16)
    ms, batches = [], []
    for r in readers:
        t0 = time.perf_counter()
        batches.append(r.batch(ids))
        ms.append((time.perf_counter() - t0) * 1e3)
        r.close()
    for name in batches[0]:
        if not np.array_equal(batches[0][name], batches[1][name]):
            raise AssertionError(f"RecordReader native and python differ on field {name}")
    rows["records"] = dict(path=os.path.basename(records_path), n=len(readers[0]),
                           native_ms=ms[0], python_ms=ms[1])
    say(f"[native] {native.library_path().name}: pairwise_iou_matrix route native, equal to the "
        f"python route within " + ", ".join(f"{c} {rows[c]['err']:.2g} ({rows[c]['native_ms']:.2f} vs "
                                            f"{rows[c]['python_ms']:.2f} ms)" for c in ("mug", "laptop"))
        + f"; RecordReader backend native on {rows['records']['path']} ({rows['records']['n']} "
        f"records), 16 records gathered as the python backend gathers them "
        f"({ms[0]:.2f} vs {ms[1]:.2f} ms)")
    return rows


def run_int8_variants(dev, pipe, records, vit_cfg=None, frame_hw=(480, 640)):
    """Phase 10 (`records`: the trainer's record container, phase 7's);
    returns (the int8 launches {mha, hist16_peak, qdense}, the parts'
    numbers)."""
    import torch

    from cppf2_torch.models.dinov2 import VIT_L14
    from cppf2_torch.models.layers import QDense

    vit_cfg = vit_cfg or VIT_L14
    with torch.no_grad():
        # the phase's int8 paths: the extractor and the instance, counts zeroed just before
        zero_counts()
        QDense.launches = 0
        ext = check_int8_extractor(dev, vit_cfg)
        launches, e2e_ms, desc_ms, poses = check_int8_instance(dev, pipe, vit_cfg, frame_hw)
        int8_launches = {"mha": ext["k1"] + launches["mha"], "hist16_peak": launches["hist16_peak"],
                         "qdense": ext["qdense"] + launches["qdense"]}
        variants = check_variants(dev, pipe, ext, frame_hw)
    native_rows = check_native(poses, records)
    numbers = dict(extractor={k: v for k, v in ext.items() if k not in ("img", "kp", "bf16", "int8")},
                   instance=dict(e2e_ms=e2e_ms, desc_ms=desc_ms), variants=variants,
                   native=native_rows)
    return int8_launches, numbers


# ---------------------------------------------------------------------------
# Phase 11: a frame group's instances in one batched pose graph
# ---------------------------------------------------------------------------

BATCH_LAYOUTS = [["mug"] * 8, ["mug"] * 4 + ["bowl"] * 2 + ["can"] * 2]
BATCH_CENTERS = [(x, y, 0.85) for y in (-0.09, 0.09) for x in (-0.21, -0.07, 0.07, 0.21)]


# What the driver's stages did, one item a call: the rows of each `align_pose`
# call of the pose graph, the instances of each frontend call
# (`driver.preprocess_frame`) and of each branch MLP's forward. The counting
# wrappers stay from `install_tallies` on, and every capture of a program
# records what they counted, which its replays credit (`programs.count_replays`).
TALLY = types.SimpleNamespace(align=[], frontend=[], shot=[], dino=[])
# Python runs of the driver's frontend, which no program credits: a replay adds none
RAN = types.SimpleNamespace(frontend=0)


def install_tallies():
    """Wrap `align_pose` and the driver's frontend for the rest of the run."""
    from cppf2_torch.eval import driver, programs
    from cppf2_torch.infer import pipeline

    align, front = pipeline.align_pose, driver.preprocess_frame

    def counting_align(points, *args, **kwargs):
        TALLY.align.append(points.shape[0])
        return align(points, *args, **kwargs)

    def counting_front(depth, mask, *args, **kwargs):
        TALLY.frontend.append(mask.shape[0])
        RAN.frontend += 1
        return front(depth, mask, *args, **kwargs)

    pipeline.align_pose, driver.preprocess_frame = counting_align, counting_front
    for name in vars(TALLY):
        programs.count_replays(TALLY, name)


def tally_mlps(models):
    """Count each branch MLP forward of `models`, with the instances it took,
    from now on (before the first capture with them)."""
    for m in models.values():
        for branch in ("shot", "dino"):
            getattr(m, branch).register_forward_pre_hook(
                lambda mod, args, branch=branch: getattr(TALLY, branch).append(args[-1].shape[0]))


@contextlib.contextmanager
def counted_align():
    """The rows of each `align_pose` call made inside."""
    TALLY.align.clear()
    yield TALLY.align


@contextlib.contextmanager
def counted_group_stages():
    """The frontend calls and each branch MLP's forwards made inside, each
    with the instances it took."""
    for name in ("frontend", "shot", "dino"):
        getattr(TALLY, name).clear()
    yield {"frontend": TALLY.frontend, "shot": TALLY.shot, "dino": TALLY.dino}


def group_stages(dev, pipe, models, vit, rgb, depth, dets, draws, groups, stride, out_size):
    """Each group's frontend on its own: one batched `preprocess_frame` call
    against one call per instance (back to back, CUDA events: 3 windows of 3
    calls), and the largest |logit| difference of each branch MLP between
    one forward over the group's tuples and one forward per instance, on the
    group's real descriptors and the instances' tuple draws."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.infer.frontend import crop_origin, preprocess_frame
    from cppf2_torch.models.dinov2 import bbox_crop_token_grid, sample_crop_descriptors
    from cppf2_torch.ops.sampling import masked_tuple_choice

    depth_t = torch.as_tensor(depth, device=dev)
    k_t = torch.as_tensor(REAL275_K, device=dev)
    rgb_t = torch.as_tensor(rgb, device=dev).to(torch.float32) / 255.0
    out = []
    for (name, tier), members in groups.items():
        masks_t = torch.as_tensor(np.stack([dets[i][1] for i in members]), device=dev)
        origins = [crop_origin(dets[i][1], depth.shape, tier) for i in members]
        perm = torch.stack([draws[i].voxel_perm for i in members])
        prio = torch.stack([draws[i].voxel_prio for i in members])
        kw = dict(res=get_category(name).res, n_max=pipe.n_points, shot_k=pipe.neighbor_k, crop=tier)

        def batched():
            return preprocess_frame(depth_t, masks_t, k_t, perm, prio, origin=origins, **kw)

        def singles():
            return [preprocess_frame(depth_t, masks_t[j], k_t, perm[j], prio[j], origin=origins[j],
                                     **kw) for j in range(len(members))]

        with torch.no_grad():
            ms = time_ms(batched, iters=3, warmup=1, repeats=3)
            singles_ms = time_ms(singles, iters=3, warmup=1, repeats=3)
            fi = batched()
            grids, txys = bbox_crop_token_grid(vit, rgb_t, masks_t, out_size=out_size, stride=stride)
            desc = sample_crop_descriptors(grids, fi.pixel_yx, txys, out_size)
            ti = masked_tuple_choice(torch.stack([draws[i].pose.tuple_u for i in members]), fi.count)
            m = models[name]
            pairs = {"shot": (m.shot(fi.pc, fi.shot, fi.normal, ti),
                              [m.shot(fi.pc[j], fi.shot[j], fi.normal[j], ti[j])
                               for j in range(len(members))]),
                     "dino": (m.dino(fi.pc, desc, ti),
                              [m.dino(fi.pc[j], desc[j], ti[j]) for j in range(len(members))])}
        dlogit = {b: max(float((g.logits[j] - one.logits).abs().max()) for j, one in enumerate(ones))
                  for b, (g, ones) in pairs.items()}
        if not all(math.isfinite(v) for v in dlogit.values()):
            raise AssertionError(f"group {name}/{tier}: batched MLP logits not finite: {dlogit}")
        out.append(dict(group=f"{name}/{tier}", instances=len(members), ms=ms, singles_ms=singles_ms,
                        dlogit=dlogit))
    return out


def run_batched_frames(dev, pipe, vit_cfg, tmp, hw=(480, 640), stride=8, out_size=256,
                       backend="nccl"):
    """Phase 11: two REAL275-format frames of eight instances (eight mugs: one
    group of 16 rows; four mugs, two bowls, two cans: groups of 8, 4 and 4
    rows) through `dispatch_frame`, whose groups each make one batched pose
    call, and through groups of one (`dispatch_instance` for each detection,
    the same draws). The same picks, R within 1 degree, T within 3 mm; K2
    launches and `align_pose` calls per frame on each route, ms per frame
    on each route and the busy share of the batched one. Then
    `evaluate_real275_parallel` at world 1 on the two frames, whose rank
    block of four instances is one pose group (geometry branch: 4 rows),
    against `dispatch_instance` of each instance on the same draws. Returns
    a dict of the phase's numbers."""
    import torch
    import torch.distributed as dist

    from cppf2_torch.eval import driver, parallel_eval, programs
    from cppf2_torch.models.dinov2 import DinoViT

    root = os.path.join(tmp, "batched")
    names = [f"scene_2_{i:04d}" for i in range(len(BATCH_LAYOUTS))]
    for i, (name, cats) in enumerate(zip(names, BATCH_LAYOUTS)):
        det_dir, img_dir = write_real275_frame(root, *hw, name=name, seed=40 + i, shift=0.01 * i,
                                               color=True, cats=cats, centers=BATCH_CENTERS,
                                               radii=[0.04] * len(cats))
    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    cat_names = sorted({c for cats in BATCH_LAYOUTS for c in cats})
    models = driver.load_category_models(ckpts, cat_names, torch.bfloat16, dev)
    tally_mlps(models)
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.device(dev):
        vit = DinoViT(vit_cfg).eval()
    vit.init_random(gen).cast_for_inference()
    kw = dict(vit=vit, device=dev, stride=stride, out_size=out_size)

    out = dict(frames=[])
    worst = dict(r=0.0, t=0.0)
    for name, cats in zip(names, BATCH_LAYOUTS):
        with open(os.path.join(det_dir, f"results_{name}.pkl"), "rb") as f:
            res = pickle.load(f)
        rgb = driver.read_png_rgb8(os.path.join(img_dir, f"{name}_color.png"))
        depth = driver.read_png16(os.path.join(img_dir, f"{name}_depth.png")).astype(np.float32) / 1000
        dets = [(c, res["pred_masks"][:, :, i].astype(bool)) for i, c in enumerate(cats)]
        draws = [driver.draw_instance(depth.shape, m, c, pipe, dev, gen) for c, m in dets]
        groups = _groups(dets)
        if None in {tier for _, tier in groups}:
            raise AssertionError(f"{name}: a mask fits no crop tier")
        rows = sorted((2 * len(v) for v in groups.values()), reverse=True)

        def batched():
            got = driver.fetch_frames(driver.dispatch_frame(rgb, depth, dets, REAL275_K, models, pipe,
                                                            draws=draws, **kw), return_picks=True)
            torch.cuda.synchronize()
            return got

        def singles():
            got = driver.fetch_instances(
                [driver.dispatch_instance(rgb, depth, m, REAL275_K, models[c], c, pipe, draws=d, **kw)
                 for (c, m), d in zip(dets, draws)], return_picks=True)
            torch.cuda.synchronize()
            return got

        # both routes once before they are counted: their programs are captured
        # now, and the counted runs replay them (the counts are those of a replay)
        batched()
        singles()
        routes = {}
        for label, fn in (("batched", batched), ("groups of one", singles)):
            torch.cuda.reset_peak_memory_stats()
            base_mb = torch.cuda.memory_allocated() / 2**20
            zero_counts()
            with counted_align() as aligned, counted_group_stages() as stages:
                t0 = time.perf_counter()
                got = fn()
                ms = (time.perf_counter() - t0) * 1e3
            routes[label] = dict(got=got, ms=ms, launches=read_counts(), align=list(aligned),
                                 stages={k: list(v) for k, v in stages.items()}, base_mb=base_mb,
                                 peak_mb=torch.cuda.max_memory_allocated() / 2**20)
        b, one = routes["batched"], routes["groups of one"]
        sizes = sorted((len(v) for v in groups.values()), reverse=True)
        want_stages = {k: sizes for k in ("frontend", "shot", "dino")}
        got_stages = {k: sorted(v, reverse=True) for k, v in b["stages"].items()}
        if got_stages != want_stages or one["stages"] != {k: [1] * len(dets) for k in want_stages}:
            raise AssertionError(f"{name}: frontend calls and MLP forwards (instances each) batched "
                                 f"{b['stages']} (expected {want_stages}), groups of one "
                                 f"{one['stages']}")
        want_b = {"mha": vit_cfg.depth, "hist16_peak": pipe.vote_levels * len(groups),
                  "sphere_accumulate": 0}
        want_1 = {"mha": vit_cfg.depth * len(dets), "hist16_peak": pipe.vote_levels * len(dets),
                  "sphere_accumulate": 0}
        if b["launches"] != want_b or sorted(b["align"], reverse=True) != rows:
            raise AssertionError(f"{name} batched: launches {b['launches']} (expected {want_b}), "
                                 f"align_pose rows {b['align']} (expected {rows})")
        if one["launches"] != want_1 or one["align"] != [2] * len(dets):
            raise AssertionError(f"{name} groups of one: launches {one['launches']} (expected "
                                 f"{want_1}), align_pose rows {one['align']}")
        (res_b, picks_b), (res_1, picks_1) = b["got"], one["got"]
        for i in range(len(dets)):
            if res_b[i] is None or res_1[i] is None:
                raise AssertionError(f"{name} instance {i} came back as None")
            ang = rt_angle_deg(res_b[i][0], res_1[i][0])
            dt = float(np.max(np.abs(res_b[i][0][:3, 3] - res_1[i][0][:3, 3])))
            worst["r"], worst["t"] = max(worst["r"], ang), max(worst["t"], dt)
            if ang > 1.0 or dt > 3e-3 or picks_b[i] != picks_1[i]:
                raise AssertionError(f"{name} instance {i}: batched vs groups of one R {ang:.3f} deg, "
                                     f"T {dt * 1e3:.3f} mm, picks {picks_b[i]} vs {picks_1[i]}")
        busy_ms = device_ms(batched, iters=1)
        say(f"[batched frames] {name}: {len(dets)} instances in groups of {rows} rows; batched route "
            f"{b['ms']:.1f} ms per frame, K2 launches {b['launches']['hist16_peak']}, align_pose "
            f"calls {len(b['align'])} (rows {b['align']}); groups of one {one['ms']:.1f} ms, K2 "
            f"launches {one['launches']['hist16_peak']}, align_pose calls {len(one['align'])}; same "
            f"picks {[picks_b[i] for i in range(len(dets))]}; device busy {busy_ms:.1f} ms of "
            f"{b['ms']:.1f} ({100 * busy_ms / b['ms']:.1f}%, the batched route profiled)")
        say(f"[batched frames] {name}: frontend calls {len(b['stages']['frontend'])} (instances "
            f"{b['stages']['frontend']}) against {len(one['stages']['frontend'])}; MLP forwards shot "
            f"{len(b['stages']['shot'])}, dino {len(b['stages']['dino'])} (instances "
            f"{b['stages']['shot']}) against {len(one['stages']['shot'])} and "
            f"{len(one['stages']['dino'])}; peak device memory batched {b['peak_mb']:.1f} MiB "
            f"({b['peak_mb'] - b['base_mb']:.1f} over the {b['base_mb']:.1f} held before), groups of "
            f"one {one['peak_mb']:.1f} MiB")
        stages = group_stages(dev, pipe, models, vit, rgb, depth, dets, draws, groups, stride,
                              out_size)
        for g in stages:
            say(f"[batched frames] {name} group {g['group']} ({g['instances']} instances): frontend "
                f"{g['ms']:.2f} ms batched against {g['singles_ms']:.2f} one call an instance; "
                f"largest |logit| difference, one MLP forward for the group against one an "
                f"instance: shot {g['dlogit']['shot']:.3g}, dino {g['dlogit']['dino']:.3g}")
        out["frames"].append(dict(name=name, instances=len(dets), rows=rows, ms=b["ms"],
                                  singles_ms=one["ms"], k2=b["launches"]["hist16_peak"],
                                  singles_k2=one["launches"]["hist16_peak"], align=len(b["align"]),
                                  singles_align=len(one["align"]), busy_ms=busy_ms,
                                  frontend_calls=len(b["stages"]["frontend"]),
                                  singles_frontend_calls=len(one["stages"]["frontend"]),
                                  forwards=len(b["stages"]["shot"]),
                                  singles_forwards=len(one["stages"]["shot"]),
                                  peak_mb=b["peak_mb"], base_mb=b["base_mb"],
                                  singles_peak_mb=one["peak_mb"], groups=stages,
                                  draws=draws, dets=dets, depth=depth))
    say(f"[batched frames] batched vs groups of one on the same draws: R {worst['r']:.4f} deg, T "
        f"{worst['t'] * 1e3:.4f} mm, the same picks")
    out.update(r_deg=worst["r"], t_mm=worst["t"] * 1e3)

    # evaluate_real275_parallel on the two frames: a rank block of four instances is one
    # group; eagerly, so that its counts are those of one pass (phase 13 runs its
    # block programs captured, against this route)
    serial = [d for f in out["frames"] for d in f["draws"]]
    out["eval_inputs"] = (det_dir, img_dir, serial)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store11"), 1),
                            rank=0, world_size=1)
    try:
        zero_counts()
        with counted_align() as aligned, programs.disable_capture():
            t0 = time.perf_counter()
            parallel_eval.evaluate_real275_parallel(det_dir, img_dir, os.path.join(tmp, "eval11"),
                                                    ckpt_root=ckpts, pipe=pipe, draws=serial,
                                                    device=dev.type)
            eval_ms = (time.perf_counter() - t0) * 1e3
        eval_launches = read_counts()
    finally:
        dist.destroy_process_group()
    # the parallel driver groups by (category, crop tier) over all frames, in blocks of 4 at world 1
    per_group = {}
    for f in out["frames"]:
        for key, members in _groups(f["dets"]).items():
            per_group[key] = per_group.get(key, 0) + len(members)
    blocks = sum(-(-n // 4) for n in per_group.values())
    if eval_launches["hist16_peak"] != pipe.vote_levels * blocks or len(aligned) != blocks \
            or max(aligned) != 4:
        raise AssertionError(f"evaluate_real275_parallel: K2 launches {eval_launches}, align_pose rows "
                             f"{aligned}, expected {blocks} blocks of at most 4 rows")
    worst_eval = dict(r=0.0, t=0.0)
    for f in out["frames"]:
        with open(os.path.join(tmp, "eval11", f"results_{f['name']}.pkl"), "rb") as fh:
            res = pickle.load(fh)
        one = driver.fetch_instances(
            [driver.dispatch_instance(None, f["depth"], m, REAL275_K, models[c], c, pipe, draws=d,
                                      device=dev, use_visual=False)
             for (c, m), d in zip(f["dets"], f["draws"])])
        for i, o in enumerate(one):
            ang = rt_angle_deg(res["pred_RTs"][i], o[0])
            dt = float(np.max(np.abs(res["pred_RTs"][i][:3, 3] - o[0][:3, 3])))
            worst_eval["r"], worst_eval["t"] = max(worst_eval["r"], ang), max(worst_eval["t"], dt)
            if ang > 1.0 or dt > 3e-3:
                raise AssertionError(f"evaluate_real275_parallel {f['name']} instance {i}: R {ang:.3f} "
                                     f"deg, T {dt * 1e3:.3f} mm from the instance alone")
    n_inst = sum(f["instances"] for f in out["frames"])
    say(f"[batched frames] evaluate_real275_parallel (world 1) on the two frames: {eval_ms:.1f} ms for "
        f"{n_inst} instances ({eval_ms / n_inst:.1f} ms per instance, model loading and scoring "
        f"included), K2 launches {eval_launches['hist16_peak']}, align_pose rows {aligned}; against "
        f"each instance alone (geometry branch, same draws) R {worst_eval['r']:.4f} deg, T "
        f"{worst_eval['t'] * 1e3:.4f} mm")
    for f in out["frames"]:
        for k in ("draws", "dets", "depth"):
            del f[k]
    out.update(eval_ms_per_instance=eval_ms / n_inst, eval_k2=eval_launches["hist16_peak"],
               eval_align=list(aligned))
    return out


# ---------------------------------------------------------------------------
# Phase 12: the captured programs
# ---------------------------------------------------------------------------

# phase 11's two layouts, and eleven mugs: a group cut into chunks of 8 and 3, the 3 padded to 4
CAPTURE_LAYOUTS = BATCH_LAYOUTS + [["mug"] * 11]
ELEVEN_CENTERS = [(x, y, 0.85) for y in (-0.12, 0.0, 0.12) for x in (-0.24, -0.12, 0.0, 0.12)][:11]


def programs_census(models, backbones):
    """Every program the driver, the evaluator and the extractor keep for
    these models and backbones, by key."""
    from cppf2_torch.eval import driver
    from cppf2_torch.models import dinov2

    progs = dict(driver._FRONTENDS)
    for b in backbones:
        for cache in (driver._VIT_STAGES, driver._VISUALS, dinov2._EXTRACTOR_PROGRAMS):
            progs.update(cache.get(b, {}))
    for m in models.values():
        progs.update(m._programs)
    return progs


def pool_mib(handle):
    """MiB reserved in the graph memory pool `handle`, from the allocator's
    snapshot; None where the snapshot names no segment's pool."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in s for s in segs):
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s.get("segment_pool_id", ())) == tuple(handle)) / 2**20


def rows_diff(a, b) -> float:
    """Largest |difference| of the packed rows of two dispatches of a frame."""
    import torch

    return max(float(torch.max(torch.abs(x.dev - y.dev))) for x, y in zip(a, b))


def poses_apart(a, b):
    """(largest R angle in degrees, largest |T| difference in m, picks equal)
    of two `fetch_frames(..., return_picks=True)` results."""
    (ra, pa), (rb, pb) = a, b
    ang = max(rt_angle_deg(ra[i][0], rb[i][0]) for i in ra)
    dt = max(float(np.max(np.abs(ra[i][0][:3, 3] - rb[i][0][:3, 3]))) for i in ra)
    return ang, dt, pa == pb


def run_captured_programs(dev, pipe, vit_cfg, hw=(480, 640), stride=8, out_size=256):
    """Phase 12: `dispatch_frame` and `estimate_instance` through their
    captured programs, each captured on one frame and replayed on another
    frame of the same keys with fresh draws, against the eager route
    (`programs.disable_capture()`) on those inputs. Returns a dict of the
    phase's numbers."""
    import torch

    from cppf2_torch.eval import driver, programs
    from cppf2_torch.models.dinov2 import DinoViT
    from cppf2_torch.ops import attention, hist16

    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    models = driver.load_category_models(ckpts, sorted({c for cats in CAPTURE_LAYOUTS for c in cats}),
                                         torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    with torch.device(dev):
        vit = DinoViT(vit_cfg).eval()
    vit.init_random(gen).cast_for_inference()
    kw = dict(vit=vit, device=dev, stride=stride, out_size=out_size)
    pool = programs.pool_handle(dev)

    def census():
        return programs_census(models, [vit])

    def make(cats, seed, shift):
        centers = ELEVEN_CENTERS if len(cats) == 11 else BATCH_CENTERS
        rng = np.random.default_rng(seed)
        depth, masks = cap_frame(rng, *hw, [(x + shift, y, z) for x, y, z in centers],
                                 [0.04] * len(cats))
        rgb = rng.integers(0, 256, size=(*hw, 3)).astype(np.uint8)
        dets = list(zip(cats, masks))
        return rgb, depth, dets, [driver.draw_instance(hw, m, c, pipe, dev, gen) for c, m in dets]

    def run(f):
        """(pendings, fetched results and picks, host ms of the dispatch call, e2e ms)"""
        rgb, depth, dets, draws = f
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pends = driver.dispatch_frame(rgb, depth, dets, REAL275_K, models, pipe, draws=draws, **kw)
        host_ms = (time.perf_counter() - t0) * 1e3
        got = driver.fetch_frames(pends, return_picks=True)
        torch.cuda.synchronize()
        return pends, got, host_ms, (time.perf_counter() - t0) * 1e3

    out = dict(frames=[])
    for i, cats in enumerate(CAPTURE_LAYOUTS):
        name = f"{len(cats)} instances ({', '.join(sorted(set(cats)))})"
        first, again = make(cats, 60 + i, 0.0), make(cats, 70 + i, 0.01)
        before = census()
        _, _, _, capture_ms = run(first)
        new = {k: p for k, p in census().items() if k not in before}
        if not new or any(p.graph is None for p in new.values()):
            raise AssertionError(f"{name}: the first dispatch captured no program")
        replays = []
        for _ in range(3):
            seen = {k: p.replays for k, p in census().items()}
            zero_counts()
            replays.append(run(again))
        counts = read_counts()
        pends, got, host_ms, _ = replays[-1]
        replay_ms = statistics.median(r[3] for r in replays)
        if census().keys() != before.keys() | new.keys():
            raise AssertionError(f"{name}: the replay frame made programs of its own")
        used = [p for k, p in census().items() if p.replays > seen[k]]
        credited = {"mha": sum(p.credited(attention._MHA) for p in used),
                    "hist16_peak": sum(p.credited(hist16._PEAK) for p in used)}
        chunks = [(len(p.idxs), p.dev.shape[0]) for p in pends]
        if counts["mha"] != credited["mha"] or counts["hist16_peak"] != credited["hist16_peak"] \
                or counts["hist16_peak"] != pipe.vote_levels * len(chunks):
            raise AssertionError(f"{name}: launches of a replay {counts}, credited by the programs "
                                 f"{credited}, chunks {chunks}")
        if len(cats) == 11 and chunks != [(8, 8), (3, 4)]:
            raise AssertionError(f"eleven mugs ran as chunks {chunks}, not 8 and 3 padded to 4")
        if sorted(got[0]) != list(range(len(cats))) or any(v is None for v in got[0].values()):
            raise AssertionError(f"{name}: not every instance came back posed: {sorted(got[0])}")

        with programs.disable_capture():
            base_mb = torch.cuda.memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()
            eager = run(again)
            eager_peak = torch.cuda.max_memory_allocated() / 2**20 - base_mb
            eager2 = run(again)
        same = rows_diff(pends, eager[0])
        noise = rows_diff(eager[0], eager2[0])
        ang, dt, picks = poses_apart(got, eager[1])
        if same != 0.0 and (noise == 0.0 or ang > 1.0 or dt > 3e-3 or not picks):
            raise AssertionError(f"{name}: replay vs eager rows differ by {same:.3g} (two eager runs "
                                 f"by {noise:.3g}): R {ang:.4f} deg, T {dt * 1e3:.4f} mm, picks "
                                 f"equal {picks}")
        busy = device_ms(lambda: run(again), iters=1)
        frame = dict(name=name, chunks=chunks, capture_ms=capture_ms, replay_ms=replay_ms,
                     host_ms=host_ms, eager_ms=statistics.median([eager[3], eager2[3]]),
                     busy_ms=busy, programs=len(new), used=len(used), k1=counts["mha"],
                     k2=counts["hist16_peak"],
                     rows_diff=same, eager_noise=noise, r_deg=ang, t_mm=dt * 1e3,
                     eager_peak_mb=eager_peak, pool_mb=pool_mib(pool),
                     capture_each_ms={p.key[0][0]: round(p.capture_ms, 1) for p in new.values()})
        out["frames"].append(frame)
        say(f"[captured] {name}: chunks (real, padded) {chunks}; {len(new)} programs captured, "
            f"{len(used)} replayed a frame "
            f"({frame['capture_each_ms']} ms warm-up + capture, by kind); first dispatch "
            f"{capture_ms:.1f} ms; replay on a second frame {replay_ms:.1f} ms e2e (median of 3), "
            f"{host_ms:.1f} ms host per dispatch_frame call; eager {frame['eager_ms']:.1f} ms; "
            f"busy {busy:.1f} ms of {replay_ms:.1f} ({100 * busy / replay_ms:.1f}%); launches "
            f"credited per replay K1 {counts['mha']}, K2 {counts['hist16_peak']}; replay vs eager "
            f"rows max |diff| {same:.3g} (two eager runs {noise:.3g}; R {ang:.4f} deg, T "
            f"{dt * 1e3:.4f} mm, same picks {picks}); eager peak {eager_peak:.1f} MiB over the "
            f"base, graph pool reserved {frame['pool_mb']} MiB")

    # the slice's instance: captured on phase 3's frame, replayed on another one
    mug = models["mug"]
    frames = [make_frame(np.random.default_rng(0), *hw),
              make_frame(np.random.default_rng(1), *hw, center=(-0.02, 0.03, 0.85))]
    draws = [driver.draw_instance(hw, m, "mug", pipe, dev, gen) for _, _, m in frames]

    def instance(j):
        rgb, depth, mask = frames[j]
        est = driver.estimate_instance(rgb, depth, mask, REAL275_K, mug, "mug", pipe, draws=draws[j],
                                       **kw)
        torch.cuda.synchronize()
        return est

    def e2e(j, n=3):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            est = instance(j)
            times.append((time.perf_counter() - t0) * 1e3)
        return est, statistics.median(times)

    t0 = time.perf_counter()
    instance(0)
    inst_capture_ms = (time.perf_counter() - t0) * 1e3
    est, inst_ms = e2e(1)
    inst_busy = device_ms(lambda: instance(1), iters=1)
    with programs.disable_capture():
        est_eager, inst_eager_ms = e2e(1)
        inst_eager_busy = device_ms(lambda: instance(1), iters=1)
    inst_diff = max(float(torch.max(torch.abs(a.float() - b.float()))) for a, b in zip(est, est_eager))
    if inst_diff != 0.0:
        raise AssertionError(f"estimate_instance replayed vs eager: max |diff| {inst_diff:.3g}")
    out["instance"] = dict(capture_ms=inst_capture_ms, ms=inst_ms, eager_ms=inst_eager_ms,
                           busy_ms=inst_busy, eager_busy_ms=inst_eager_busy, diff=inst_diff)
    say(f"[captured] estimate_instance, captured on one frame and replayed on another: first call "
        f"{inst_capture_ms:.1f} ms; replay {inst_ms:.1f} ms e2e (median of 3), busy {inst_busy:.1f} "
        f"ms ({100 * inst_busy / inst_ms:.1f}%); eager {inst_eager_ms:.1f} ms, busy "
        f"{inst_eager_busy:.1f} ms ({100 * inst_eager_busy / inst_eager_ms:.1f}%); replay vs eager "
        f"max |diff| {inst_diff:.3g}")
    out.update(programs=len(census()), pool_mb=pool_mib(pool),
               eager_peak_mb=max(f["eager_peak_mb"] for f in out["frames"]))
    say(f"[captured] {out['programs']} programs cached; graph pool reserved {out['pool_mb']} MiB "
        f"for all of them against the largest eager peak of a frame, {out['eager_peak_mb']:.1f} MiB")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the serving programs that ran eagerly before
# ---------------------------------------------------------------------------

# a frame of three 4 cm mugs in their crop tier and one bowl, a 26 cm cap at
# 0.95 m, whose mask (about 323 px wide) fits no tier: the singles route
SINGLES_CATS = ["mug", "bowl", "mug", "mug"]
SINGLES_CENTERS = [(0.16, -0.1, 0.85), (-0.2, 0.0, 0.95), (0.16, 0.1, 0.85), (0.27, 0.0, 0.85)]
SINGLES_RADII = [0.04, 0.26, 0.04, 0.04]


def replayed(census, before):
    """(programs replayed, replays, eager runs) since `before`, a
    {key: (replays, eager_runs)} of an earlier census."""
    used = [p for k, p in census.items() if p.replays > before.get(k, (0, 0))[0]]
    replays = sum(p.replays - before.get(k, (0, 0))[0] for k, p in census.items())
    eager = sum(p.eager_runs - before.get(k, (0, 0))[1] for k, p in census.items())
    return used, replays, eager


def held_to_eager(name, replay, eager, eager2):
    """Replayed outputs against eager ones on the same inputs: equal to the
    bit, or, where two eager runs on the card differ, within that spread.
    Returns (replay vs eager, eager vs eager) max |diff|."""
    import torch

    def diff(a, b):
        return max(float(torch.max(torch.abs(x.double() - y.double()))) for x, y in zip(a, b))

    same, noise = diff(replay, eager), diff(eager, eager2)
    if same > noise:
        raise AssertionError(f"{name}: replay vs eager max |diff| {same:.3g}, above two eager runs' "
                             f"{noise:.3g}")
    if noise:
        say(f"[serving] {name}: two eager runs differ by {noise:.3g} (the spread the replay is held to)")
    return same, noise


def run_serving_programs(dev, pipe, vit_cfg, eval_inputs, tmp, hw=(480, 640), backend="nccl"):
    """Phase 13: the serving units that ran eagerly before, each captured on
    one input and replayed on another with fresh draws, against the eager
    route (`programs.disable_capture()`) on the same inputs: the instance on
    both visual routes, a frame with a mask that fits no crop tier, the
    parallel evaluator's blocks, the extractor alone in bf16 and int8.
    Returns a dict of the phase's numbers."""
    import torch
    import torch.distributed as dist

    from cppf2_torch.eval import driver, parallel_eval, programs
    from cppf2_torch.models.dinov2 import DinoFeatureExtractor
    from cppf2_torch.models.layers import QDense
    from cppf2_torch.ops import attention, hist16

    ckpts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ckpts_r3")
    models = driver.load_category_models(ckpts, ["bowl", "can", "mug"], torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    ext = DinoFeatureExtractor(cfg=vit_cfg, device=dev.type).init_random(gen)   # stride 4
    vit = ext.model                   # the same backbone on the bbox-crop route at stride 8
    backbones = [vit]
    pool = programs.pool_handle(dev)
    out = {}

    def census():
        return programs_census(models, backbones)

    def mark():
        return {k: (p.replays, p.eager_runs) for k, p in census().items()}

    # 1. the instance on both visual routes: three programs a call
    frames = [make_frame(np.random.default_rng(0), *hw),
              make_frame(np.random.default_rng(1), *hw, center=(-0.02, 0.03, 0.85))]
    draws = [driver.draw_instance(hw, m, "mug", pipe, dev, gen) for _, _, m in frames]
    routes = {"vit (stride 8)": dict(vit=vit, stride=8), "dino_extractor (stride 4)": dict(dino_extractor=ext)}
    out["instance"] = {}
    for label, route in routes.items():
        def instance(j, route=route):
            rgb, depth, mask = frames[j]
            est = driver.estimate_instance(rgb, depth, mask, REAL275_K, models["mug"], "mug", pipe,
                                           draws=draws[j], device=dev, **route)
            torch.cuda.synchronize()
            return est

        def e2e(n=3):
            times, est = [], None
            for _ in range(n):
                t0 = time.perf_counter()
                est = instance(1)
                times.append((time.perf_counter() - t0) * 1e3)
            return est, statistics.median(times)

        t0 = time.perf_counter()
        instance(0)
        capture_ms = (time.perf_counter() - t0) * 1e3
        seen = mark()
        zero_counts()
        before_ran = RAN.frontend
        est = instance(1)
        counts = read_counts()
        used, n_replays, n_eager = replayed(census(), seen)
        if len(used) != 3 or n_replays != 3 or n_eager or RAN.frontend != before_ran:
            raise AssertionError(f"instance {label}: {len(used)} programs, {n_replays} replays, "
                                 f"{n_eager} eager runs, {RAN.frontend - before_ran} frontend runs "
                                 f"in a call (expected 3 programs replayed once each, nothing eager)")
        if counts["mha"] != vit_cfg.depth or counts["hist16_peak"] != pipe.vote_levels:
            raise AssertionError(f"instance {label}: launches credited per replay {counts}")
        _, ms = e2e()
        busy = device_ms(lambda: instance(1), iters=1)
        # where the replayed call's time goes: each stage bracketed by synchronizations
        parts = []
        for _ in range(3):
            with timed_calls([(driver, "_frontend"), (driver, "resize_crop"),
                              (driver, "_instance_visual")]) as spent:
                t0 = time.perf_counter()
                instance(1)
                total = (time.perf_counter() - t0) * 1e3
            parts.append({"frontend": spent["_frontend"], "host crop": spent["resize_crop"],
                          "visual": spent["_instance_visual"] - spent["resize_crop"],
                          "ensemble and the rest": total - spent["_frontend"]
                          - spent["_instance_visual"]})
        stages = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
        pend, syncs, reads, kinds, _ = dispatch_without_reads(lambda: driver.dispatch_instance(
            frames[1][0], frames[1][1], frames[1][2], REAL275_K, models["mug"], "mug", pipe,
            draws=draws[1], device=dev, **route))
        if reads:
            raise AssertionError(f"instance {label}: device-to-host copies while dispatching {reads}")
        with programs.disable_capture():
            est_eager, eager_ms = e2e()
            est_eager2 = instance(1)
            eager_busy = device_ms(lambda: instance(1), iters=1)
        same, noise = held_to_eager(f"instance {label}", est, est_eager, est_eager2)
        out["instance"][label] = dict(capture_ms=capture_ms, ms=ms, eager_ms=eager_ms, busy_ms=busy,
                                      eager_busy_ms=eager_busy, stages=stages,
                                      programs=len(used), k1=counts["mha"],
                                      k2=counts["hist16_peak"], reads=len(reads), diff=same,
                                      eager_noise=noise)
        say(f"[serving] estimate_instance via {label}: first call {capture_ms:.1f} ms; replay "
            f"{ms:.1f} ms e2e (median of 3), busy {busy:.1f} ms ({100 * busy / ms:.1f}%), by stage "
            f"(synchronized, median of 3) " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
            + f"; eager {eager_ms:.1f} ms, busy {eager_busy:.1f} ms "
            f"({100 * eager_busy / eager_ms:.1f}%); programs replayed per call {len(used)} ({sorted(p.key[0][0] for p in used)}); launches "
            f"credited per replay K1 {counts['mha']}, K2 {counts['hist16_peak']}; device-to-host "
            f"copies while dispatching {len(reads)} (copies {kinds}); replay vs eager max |diff| "
            f"{same:.3g} (two eager runs {noise:.3g})")

    # 2. a frame with a mask that fits no crop tier beside tiered ones
    def singles_frame(seed, shift):
        rng = np.random.default_rng(seed)
        depth, masks = cap_frame(rng, *hw, [(x + shift, y, z) for x, y, z in SINGLES_CENTERS],
                                 SINGLES_RADII)
        rgb = rng.integers(0, 256, size=(*hw, 3)).astype(np.uint8)
        dets = list(zip(SINGLES_CATS, masks))
        return rgb, depth, dets, [driver.draw_instance(hw, m, c, pipe, dev, gen) for c, m in dets]

    first, again = singles_frame(80, 0.0), singles_frame(81, 0.01)
    groups = _groups(first[2])
    if groups != _groups(again[2]) or ("bowl", None) not in groups:
        raise AssertionError(f"singles frame: groups {groups} and {_groups(again[2])}, the bowl "
                             f"must fit no tier in both")
    kw = dict(vit=vit, device=dev, stride=8, out_size=256)

    def frame_run(f):
        rgb, depth, dets, d = f
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pends = driver.dispatch_frame(rgb, depth, dets, REAL275_K, models, pipe, draws=d, **kw)
        got = driver.fetch_frames(pends, return_picks=True)
        torch.cuda.synchronize()
        return pends, got, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    frame_run(first)
    frame_capture_ms = (time.perf_counter() - t0) * 1e3
    runs = []
    for _ in range(3):
        seen = mark()
        zero_counts()
        before_ran = RAN.frontend
        runs.append(frame_run(again))
        used, n_replays, n_eager = replayed(census(), seen)
        counts = read_counts()
        if n_eager or RAN.frontend != before_ran:
            raise AssertionError(f"singles frame: {n_eager} programs and {RAN.frontend - before_ran} "
                                 f"frontends ran eagerly in a replayed frame")
    pends, got, _ = runs[-1]
    kinds = sorted(p.key[0][0] for p in used)
    if kinds.count("frontend") != 1 or kinds.count("visual") != 1 or kinds.count("pose") != 1:
        raise AssertionError(f"singles frame: programs replayed {kinds}, expected the single's "
                             f"frontend, visual stage and ensemble")
    if sorted(got[0]) != list(range(len(SINGLES_CATS))) or any(v is None for v in got[0].values()):
        raise AssertionError(f"singles frame: not every instance came back posed: {got[0]}")
    _, _, reads, _, _ = dispatch_without_reads(lambda: driver.dispatch_frame(
        again[0], again[1], again[2], REAL275_K, models, pipe, draws=again[3], **kw))
    if reads:
        raise AssertionError(f"singles frame: device-to-host copies while dispatching {reads}")
    replay_ms = statistics.median(r[2] for r in runs)
    busy = device_ms(lambda: frame_run(again), iters=1)
    with programs.disable_capture():
        eager = [frame_run(again) for _ in range(2)]
    same, noise = held_to_eager("singles frame", [p.dev if hasattr(p, "dev") else p[1].dev for p in pends],
                                [p.dev if hasattr(p, "dev") else p[1].dev for p in eager[0][0]],
                                [p.dev if hasattr(p, "dev") else p[1].dev for p in eager[1][0]])
    out["singles"] = dict(groups=[f"{c}/{t}" for c, t in groups], capture_ms=frame_capture_ms,
                          ms=replay_ms, eager_ms=statistics.median(e[2] for e in eager), busy_ms=busy,
                          programs=len(used), kinds=kinds, k1=counts["mha"], k2=counts["hist16_peak"],
                          reads=len(reads), diff=same, eager_noise=noise)
    say(f"[serving] frame of {len(SINGLES_CATS)} detections, groups {out['singles']['groups']} (the "
        f"bowl fits no tier): first dispatch {frame_capture_ms:.1f} ms; replay {replay_ms:.1f} ms e2e "
        f"(median of 3), busy {busy:.1f} ms ({100 * busy / replay_ms:.1f}%); eager "
        f"{out['singles']['eager_ms']:.1f} ms; programs replayed a frame {len(used)} ({kinds}), none "
        f"eager; launches credited per replay K1 {counts['mha']}, K2 {counts['hist16_peak']}; "
        f"device-to-host copies while dispatching {len(reads)}; replay vs eager max |diff| {same:.3g} "
        f"(two eager runs {noise:.3g})")

    # 3. the parallel evaluator's blocks on phase 11's frames, at world 1
    det_dir, img_dir, serial = eval_inputs
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store13"), 1),
                            rank=0, world_size=1)
    runs = {}
    try:
        def evaluate(label):
            zero_counts()
            with timed_calls([(parallel_eval, "compute_degree_cm_map")]) as spent:
                t0 = time.perf_counter()
                parallel_eval.evaluate_real275_parallel(
                    det_dir, img_dir, os.path.join(tmp, f"eval13_{label}"), ckpt_root=ckpts,
                    pipe=pipe, draws=serial, device=dev.type, models=models)
                ms = (time.perf_counter() - t0) * 1e3
            poses = {}
            for name in sorted(os.listdir(os.path.join(tmp, f"eval13_{label}"))):
                if name.endswith(".pkl"):
                    with open(os.path.join(tmp, f"eval13_{label}", name), "rb") as fh:
                        poses[name] = pickle.load(fh)["pred_RTs"]
            runs[label] = dict(ms=ms, scoring_ms=spent["compute_degree_cm_map"], poses=poses,
                               launches=read_counts())

        rows_before = {k for m in models.values() for k in m._programs if k[0][0] == "rows"}
        evaluate("first")
        rows = [p for m in models.values() for k, p in m._programs.items()
                if k[0][0] == "rows" and k not in rows_before]
        seen = [p.replays for p in rows]
        evaluate("replay")
        blocks = sum(p.replays - n for p, n in zip(rows, seen))
        with programs.disable_capture():
            evaluate("eager")
            evaluate("eager2")
    finally:
        dist.destroy_process_group()
    n_inst = len(serial)
    if runs["replay"]["launches"]["hist16_peak"] != pipe.vote_levels * blocks:
        raise AssertionError(f"evaluator: K2 launches of a replayed run {runs['replay']['launches']}, "
                             f"expected {pipe.vote_levels} a block, {blocks} blocks")
    diff = max(float(np.max(np.abs(runs["replay"]["poses"][n] - runs["eager"]["poses"][n])))
               for n in runs["eager"]["poses"])
    noise = max(float(np.max(np.abs(runs["eager2"]["poses"][n] - runs["eager"]["poses"][n])))
                for n in runs["eager"]["poses"])
    if diff > noise:
        raise AssertionError(f"evaluator: replayed poses vs eager max |diff| {diff:.3g}, two eager "
                             f"runs {noise:.3g}")
    per = {k: (r["ms"] - r["scoring_ms"]) / n_inst for k, r in runs.items()}
    out["evaluator"] = dict(instances=n_inst, programs=len(rows), blocks=blocks,
                            block_shapes=sorted(int(p.static[0].shape[0]) for p in rows),
                            ms_per_instance={k: r["ms"] / n_inst for k, r in runs.items()},
                            posing_ms_per_instance=per, diff=diff, eager_noise=noise,
                            k2_per_block=pipe.vote_levels)
    say(f"[serving] evaluate_real275_parallel (world 1) on phase 11's frames, {n_inst} instances in "
        f"{blocks} blocks: {len(rows)} block programs (block sizes "
        f"{out['evaluator']['block_shapes']}); ms per instance, scoring left out: first run (captures) "
        f"{per['first']:.1f}, replayed {per['replay']:.1f}, eager {per['eager']:.1f} / "
        f"{per['eager2']:.1f}; with scoring {runs['replay']['ms'] / n_inst:.1f} replayed, "
        f"{runs['eager']['ms'] / n_inst:.1f} eager; replayed poses vs eager max |diff| {diff:.3g} (two "
        f"eager runs {noise:.3g}); K2 launches of the replayed run {runs['replay']['launches']}")

    # 4. the extractor alone at (256, 256), stride 4, bf16 and int8
    ext8 = DinoFeatureExtractor(cfg=vit_cfg, quant="int8", device=dev.type).init_random(gen)
    backbones.append(ext8.model)
    img = torch.rand(256, 256, 3, generator=gen, device=dev)
    kp = torch.rand(8192, 2, generator=gen, device=dev) * 256
    out["extractor"] = {}
    for label, e in (("bf16", ext), ("int8", ext8)):
        e(img, kp)   # the capture
        zero_counts()
        QDense.launches = 0
        got = e(img, kp)
        credits = dict(k1=attention._MHA.launches, qdense=QDense.launches)
        want_q = 4 * vit_cfg.depth if label == "int8" else 0
        if credits != dict(k1=vit_cfg.depth, qdense=want_q):
            raise AssertionError(f"extractor {label}: launches credited per replay {credits}")
        ms = time_ms(lambda: e(img, kp), iters=10, repeats=3)
        dms = device_ms(lambda: e(img, kp), iters=5)
        with programs.disable_capture():
            eager = e(img, kp)
            eager2 = e(img, kp)
            eager_ms = time_ms(lambda: e(img, kp), iters=5, repeats=3)
        same, noise = held_to_eager(f"extractor {label}", [got], [eager], [eager2])
        out["extractor"][label] = dict(ms=ms, device_ms=dms, eager_ms=eager_ms, diff=same,
                                       eager_noise=noise, **credits)
        say(f"[serving] DinoFeatureExtractor {label} (256x256, stride 4, 8192 keypoints): replay "
            f"{ms:.2f} ms back to back (device {dms:.2f}), eager {eager_ms:.2f} ms; credited per "
            f"replay K1 {credits['k1']}, int8 linears {credits['qdense']}; replay vs eager max |diff| "
            f"{same:.3g} (two eager runs {noise:.3g})")

    every = census()
    out.update(programs=len(every), pool_mb=pool_mib(pool),
               by_kind={k: sum(p.key[0][0] == k for p in every.values())
                        for k in sorted({p.key[0][0] for p in every.values()})})
    say(f"[serving] {out['programs']} programs of this phase's models and backbones "
        f"({out['by_kind']}); graph pool reserved {out['pool_mb']} MiB (every program of the run)")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the training programs
# ---------------------------------------------------------------------------

FRAME_FIELDS = ("depth", "gray", "pc", "shot", "count")


def frame_attempt(gen, mesh):
    """(frame program inputs, static arguments) of the first attempt of one
    `gen.next_frame(mesh)`, which runs as it always does."""
    from cppf2_torch.data import synthetic

    seen, real = [], synthetic.frame_program

    def recording(renderer, args, *static):
        seen.append((args, static))
        return real(renderer, args, *static)

    synthetic.frame_program = recording
    try:
        gen.next_frame(mesh)
    finally:
        synthetic.frame_program = real
    return seen[0]


def frame_split(gen, renderer, frames):
    """ms per `next_frame` (fresh meshes), split into the host's mesh and
    samples, the frame program (the device part), the one read and the rest,
    each stage bracketed by device synchronizations: medians over `frames`
    frames. A frame whose mesh falls in a raster bucket not met before
    captures a program; such frames are left out (at most 3 x `frames` are
    drawn), and their number is returned beside the medians."""
    from cppf2_torch.data import synthetic

    mesh = [(synthetic, "make_category_mesh"),
            (synthetic, "sample_surface" if renderer == "splat" else "subdivide_mesh")]
    targets = mesh + [(synthetic, "frame_program"), (synthetic, "to_host")]

    def captured():
        return sum(p.graph is not None for p in synthetic._FRAME_PROGRAMS.values())

    runs, left_out = [], 0
    while len(runs) < frames and len(runs) + left_out < 3 * frames:
        before = captured()
        with timed_calls(targets) as spent:
            t0 = time.perf_counter()
            gen.next_frame()
            total = (time.perf_counter() - t0) * 1e3
        if captured() != before:
            left_out += 1
            continue
        runs.append({"host mesh + samples": sum(spent[n] for _, n in mesh),
                     "device part": spent["frame_program"], "the one read": spent["to_host"],
                     "rest": total - sum(spent.values()), "total": total})
    if not runs:
        raise AssertionError(f"{renderer}: every one of {left_out} frames captured a program")
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}, left_out


def check_frame_programs(dev, hw, samples, n_points, frames=6):
    """The frame programs of both renderers: each captured on one draw of a
    fixed mug and replayed on another, against the eager route on the same
    inputs (depth, gray, cloud, SHOT and count equal to the bit); then ms per
    frame replayed and eager on fresh meshes, by stage."""
    import torch

    from cppf2_torch.config import get_category
    from cppf2_torch.data import shapes, synthetic
    from cppf2_torch.eval import programs

    out = {}
    for renderer in ("splat", "raster"):
        gen = synthetic.SyntheticFrameGenerator(get_category("mug"), n_max=n_points, height=hw[0],
                                                width=hw[1], surface_samples=samples, seed=31,
                                                renderer=renderer, device=dev.type)
        fixed = shapes.make_category_mesh("mug", np.random.default_rng(31))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args, static = frame_attempt(gen, fixed)   # the capture
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        prog = synthetic._FRAME_PROGRAMS[(("synthetic frame", renderer) + static,
                                          programs._signature(args))]
        args, static = frame_attempt(gen, fixed)   # another draw: pose, scale, lighting, texture
        replays = prog.replays
        got = synthetic.frame_program(renderer, args, *static)
        if prog.replays != replays + 1 or prog.graph is None:
            raise AssertionError(f"{renderer}: the frame did not replay its program")
        with programs.disable_capture():
            eager = synthetic.frame_program(renderer, args, *static)
            eager2 = synthetic.frame_program(renderer, args, *static)
        noise = max(float(torch.max(torch.abs(getattr(eager, f).double() - getattr(eager2, f).double())))
                    for f in FRAME_FIELDS)
        apart = [f for f in FRAME_FIELDS if not torch.equal(getattr(got, f), getattr(eager, f))]
        if apart or noise:
            raise AssertionError(f"{renderer}: replayed frame vs eager differ in {apart} (two eager "
                                 f"runs {noise:.3g})")
        split, left_out = frame_split(gen, renderer, frames)
        with programs.disable_capture():
            eager_split, _ = frame_split(gen, renderer, frames)
        mine = [p for k, p in synthetic._FRAME_PROGRAMS.items() if k[0][1] == renderer]
        n_progs, n_graphs = len(mine), sum(p.graph is not None for p in mine)
        out[renderer] = dict(first_ms=first_ms, capture_ms=prog.capture_ms, programs=n_progs,
                             captured=n_graphs, count=int(got.count), split=split,
                             eager_split=eager_split, capturing_frames=left_out)
        say(f"[train programs] {renderer} frame {hw[0]}x{hw[1]}, "
            f"{samples if renderer == 'splat' else 'subdivided'} surface, {n_points} points: replay on "
            f"a second draw equal to eager on it in {', '.join(FRAME_FIELDS)} (count {int(got.count)}); "
            f"first call {first_ms:.1f} ms (warm-up + capture {prog.capture_ms:.1f}); {n_progs} "
            f"{renderer} program(s) of the run, {n_graphs} captured; ms per frame replayed (median "
            f"of {frames}, {left_out} frames left out that captured a new bucket's program) "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + "; eager "
            + ", ".join(f"{k} {v:.1f}" for k, v in eager_split.items()))
    return out


def check_step_programs(dev, mesh, records, steps=20, n_points=2048, tuples=10000, out_size=256,
                        e2e_vit=None):
    """The three train steps, `steps` steps each from the same weights,
    batches and uniforms: replayed (capturable AdamW) against the eager route
    with the same optimizer, twice, and against the plain AdamW; the lr
    halves after step steps // 2. Returns {branch: numbers}."""
    import torch

    from cppf2_torch import train
    from cppf2_torch.config import TrainConfig
    from cppf2_torch.data.records import RecordReader
    from cppf2_torch.eval import programs
    from cppf2_torch.models.cppf import DinoBranch, ShotBranch
    from cppf2_torch.models.dinov2 import VIT_S14, DinoViT
    from cppf2_torch.ops import attention

    e2e_vit = dataclasses.replace(e2e_vit or dataclasses.replace(VIT_S14, pretrain_grid=out_size // 8),
                                  attn_impl="hbm")
    cfg = TrainConfig(n_points=n_points, tuples_per_step=tuples, steps_per_epoch=steps // 2,
                      lr_step_epochs=1)
    schedule = train.make_lr_schedule(cfg)
    out = {}
    for branch in ("shot", "dino", "dino-e2e"):
        reader = RecordReader(records[branch])
        rng = np.random.default_rng(3)
        batches = [reader.batch([int(rng.integers(0, len(reader)))]) for _ in range(steps)]
        reader.close()
        ug = torch.Generator().manual_seed(4)
        us = [torch.rand((1, tuples, 5), generator=ug) for _ in range(steps)]
        width = batches[0]["desc"].shape[-1] if branch == "dino" else e2e_vit.embed_dim

        def route(capturable=True):
            gen = torch.Generator().manual_seed(0)
            if branch == "dino-e2e":
                vit, head = DinoViT(e2e_vit), DinoBranch(desc_dim=width)
                state = train.create_visual_train_state(vit, head, cfg, gen, device=dev.type)
                step = train.make_visual_train_step(vit, head, cfg, out_size=out_size, mesh=mesh)
            else:
                model = ShotBranch() if branch == "shot" else DinoBranch(desc_dim=width)
                state = train.create_train_state(model, cfg, gen, device=dev.type)
                step = train.make_train_step(model, cfg, branch, mesh)
            if not capturable:
                state.optimizer, state.scheduler = train.make_optimizer(
                    cfg, state.module.parameters(), capturable=False)
            return state, step

        def run(state, step):
            lr = state.optimizer.param_groups[0]["lr"]
            losses, lrs = [], []
            for s in range(steps):
                _, m = step(state, batches[s], tuple_u=us[s])
                losses.append(m["total"])
                if s + 1 in (steps // 2, steps):
                    now = state.optimizer.param_groups[0]["lr"]
                    if torch.is_tensor(lr) and now is not lr:
                        raise AssertionError(f"{branch}: the scheduler replaced the lr tensor")
                    lrs.append(now.clone() if torch.is_tensor(now) else now)
            torch.cuda.synchronize()
            return torch.stack(losses), [p.detach().clone() for p in state.module.parameters()], lrs

        zero_counts()
        rs, rstep = route()
        replay = run(rs, rstep)
        launched = read_counts()
        progs = list(rstep.programs.values())
        if len(progs) != 1 or progs[0].replays != steps - 1 or progs[0].credits:
            raise AssertionError(f"{branch}: step programs {len(progs)}, replays "
                                 f"{[p.replays for p in progs]}, credits {[p.credits for p in progs]} "
                                 f"(expected one program, replayed after its first step, crediting "
                                 f"no kernel)")
        if any(launched.values()):
            raise AssertionError(f"{branch}: a train step launched a kernel of the port: {launched}")
        adam = {float(st["step"]) for st in rs.optimizer.state.values()}
        want_lr = [float(np.float32(schedule(n))) for n in (steps // 2, steps)]
        got_lr = [float(x) for x in replay[2]]
        if adam != {float(steps)} or got_lr != want_lr:
            raise AssertionError(f"{branch}: AdamW step {adam}, lr after steps {steps // 2} and "
                                 f"{steps} {got_lr} (want {float(steps)}, {want_lr})")
        with programs.disable_capture():
            eager = run(*route())
            eager2 = run(*route())
            plain = run(*route(capturable=False))

        def apart(a, b):
            return max(float(torch.max(torch.abs(x.double() - y.double())))
                       for x, y in zip([a[0]] + a[1], [b[0]] + b[1]))

        same, noise = apart(replay, eager), apart(eager, eager2)
        if same > noise:
            raise AssertionError(f"{branch}: replayed losses and parameters vs eager max |diff| "
                                 f"{same:.3g}, above two eager runs' {noise:.3g}")
        loss_rel = float(torch.max(torch.abs(plain[0] - replay[0]) / torch.abs(plain[0])))
        param_diff = max(float(torch.max(torch.abs(x - y))) for x, y in zip(plain[1], replay[1]))
        if loss_rel > 1e-3:
            raise AssertionError(f"{branch}: capturable vs plain AdamW, the losses differ by "
                                 f"{loss_rel:.3g} relative (limit 1e-3)")
        # time: the state and the programs as a user's loop has them
        batch, u = batches[0], us[0]

        def one(state, step):
            step(state, batch, tuple_u=u)

        def steady(state, step, n=10):
            one(state, step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                one(state, step)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        ms = steady(rs, rstep)
        busy = device_ms(lambda: one(rs, rstep), iters=5)
        with programs.disable_capture():
            es, estep = route()
            eager_ms = steady(es, estep)
            eager_busy = device_ms(lambda: one(es, estep), iters=5)
            plain_ms = steady(*route(capturable=False))
        out[branch] = dict(ms=ms, eager_ms=eager_ms, busy_ms=busy, eager_busy_ms=eager_busy,
                           plain_ms=plain_ms,
                           capture_ms=progs[0].capture_ms, diff=same, eager_noise=noise,
                           plain_loss_rel=loss_rel, plain_param_diff=param_diff, lr=got_lr,
                           k1=attention._MHA.launches)
        say(f"[train programs] {branch} step ({n_points} points, {tuples} tuples, batch 1): {steps} "
            f"steps replayed (one program, first call {progs[0].capture_ms:.1f} ms with its capture) "
            f"vs eager: losses and parameters max |diff| {same:.3g} (two eager runs {noise:.3g}); "
            f"AdamW step {steps}; lr after {steps // 2} and {steps} steps {got_lr}; capturable vs "
            f"plain AdamW losses within {loss_rel:.3g} relative (limit 1e-3), parameters "
            f"{param_diff:.3g}; no kernel of the port launched; ms per step replayed {ms:.2f} (busy "
            f"{busy:.2f} ms, {100 * busy / ms:.1f}%), eager {eager_ms:.2f} (busy {eager_busy:.2f} ms, "
            f"{100 * eager_busy / eager_ms:.1f}%), eager with the plain AdamW {plain_ms:.2f}")
    return out


def check_render_trainer(dev, mesh, tmp, records, vit_cfg, eager_ms, hw=(480, 640), n_points=2048,
                         tuples=10000, pool=64, steps=40):
    """`train_category("mug", "dino")` on a rendered pool with every program
    replayed: 24 K1 credited for each pool frame and refresh, the loss
    falling, ms per step beside phase 8's eager one; then the checkpoint
    restores and the next steps' losses are those of the state in memory."""
    import torch

    from cppf2_torch import train
    from cppf2_torch.config import TrainConfig
    from cppf2_torch.data.records import RecordReader
    from cppf2_torch.models.cppf import DinoBranch
    from cppf2_torch.models import dinov2
    from cppf2_torch.ops import attention
    from cppf2_torch.train import checkpoints
    from cppf2_torch.train.driver import train_category

    cfg = TrainConfig(n_points=n_points, steps_per_epoch=steps, max_epochs=1, tuples_per_step=tuples)
    # the driver's default extractor, made here so that its program is captured before the count
    ext = dinov2.DinoFeatureExtractor(cfg=vit_cfg, device=dev.type).init_random(
        torch.Generator(device=dev).manual_seed(cfg.seed))
    ext(torch.rand(ext.out_size, ext.out_size, 3, device=dev), torch.rand(16, 2, device=dev))
    (prog,) = dinov2._EXTRACTOR_PROGRAMS[ext.model].values()
    replays0 = prog.replays
    out = os.path.join(tmp, "tck", "dino", "mug")
    zero_counts()
    t0 = time.perf_counter()
    state = train_category("mug", "dino", cfg, out, n_points=n_points, frames_in_pool=pool,
                           render_hw=hw, log_every=1, progress=lambda s: None, dino_extractor=ext,
                           device=dev.type)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = read_counts()
    want = vit_cfg.depth * (pool + steps)
    if launched != {"mha": want, "hist16_peak": 0, "sphere_accumulate": 0} or \
            prog.replays - replays0 != pool + steps or prog.credited(attention._MHA) != vit_cfg.depth:
        raise AssertionError(f"dino: launches {launched}, extractor replays {prog.replays - replays0}, "
                             f"credited {prog.credited(attention._MHA)} (expected {want} K1, one replay "
                             f"crediting {vit_cfg.depth} for each of {pool} pool frames and {steps} "
                             f"refreshes)")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    totals = [r["total"] for r in rows]
    if len(rows) != steps or not all(math.isfinite(r[k]) for r in rows for k in ("cls", "scale", "total")):
        raise AssertionError(f"dino: {len(rows)} metric rows, or a non-finite one: {rows[-1]}")
    ms = statistics.median(np.diff([r["wall"] for r in rows])) * 1e3
    n_mean = min(10, steps // 2)
    head, tail = np.mean(totals[:n_mean]), np.mean(totals[-n_mean:])
    if not tail < head:
        raise AssertionError("dino: the loss did not fall")
    # the checkpoint: two steps of the state in memory and of the restored one
    fresh = train.create_train_state(DinoBranch(desc_dim=vit_cfg.embed_dim), cfg, device=dev.type)
    fresh = checkpoints.restore_checkpoint(checkpoints.latest_checkpoint(out), fresh)
    if fresh.step != state.step or state.step != steps:
        raise AssertionError(f"dino: restored step {fresh.step}, trained {state.step}")
    step_fn = train.make_train_step(state.module, cfg, "dino", mesh)
    reader = RecordReader(records["dino"])
    batch = reader.batch([0])
    reader.close()
    losses = []
    for st in (state, fresh):
        gen = torch.Generator().manual_seed(5)
        losses.append(torch.stack([step_fn(st, batch, generator=gen)[1]["total"] for _ in range(2)]))
    if not torch.equal(losses[0], losses[1]) or len(step_fn.programs) != 2:
        raise AssertionError(f"dino: next steps' losses {losses[0].tolist()} in memory, "
                             f"{losses[1].tolist()} from the checkpoint ({len(step_fn.programs)} "
                             f"programs)")
    res = dict(ms=ms, eager_ms=eager_ms, k1=launched["mha"], per_frame=vit_cfg.depth,
               set_up_s=total_s - rows[-1]["wall"], first=totals[0], last=totals[-1], head=head,
               tail=tail, next_losses=losses[1].tolist())
    say(f"[train programs] train_category dino on rendered frames, every program replayed: pool of "
        f"{pool} + {steps} steps, {ms:.1f} ms per step (median; phase 8 eager {eager_ms:.1f}; the "
        f"metrics read back every step), {res['set_up_s']:.1f} s before the first step; K1 {want} "
        f"credited ({vit_cfg.depth} per pool frame and refresh, {prog.replays - replays0} extractor "
        f"replays); total loss {totals[0]:.3f} -> {totals[-1]:.3f} (mean of the first {n_mean} "
        f"{head:.3f}, of the last {n_mean} {tail:.3f}); the checkpoint restores step {steps} and the "
        f"next two steps' losses {[round(x, 6) for x in losses[1].tolist()]} bit for bit (captured)")
    return res


def run_training_programs(dev, tmp, records, vit_cfg, eager_ms, backend="nccl", hw=(480, 640),
                          samples=250_000, n_points=2048, tuples=10000, steps=20, pool=64,
                          train_steps=40, e2e_vit=None, out_size=256, frames=6):
    """Phase 14: the synthetic frames, the three train steps and the render
    trainer through their programs. Returns a dict of the phase's numbers."""
    import torch
    import torch.distributed as dist

    from cppf2_torch import parallel
    from cppf2_torch.data import synthetic
    from cppf2_torch.eval import programs

    out = dict(frames=check_frame_programs(dev, hw, samples, n_points, frames))
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store14"), 1),
                            rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(device=dev.type)
        out["steps"] = check_step_programs(dev, mesh, records, steps, n_points, tuples, out_size,
                                           e2e_vit)
        out["trainer"] = check_render_trainer(dev, mesh, tmp, records, vit_cfg, eager_ms, hw, n_points,
                                              tuples, pool, train_steps)
    finally:
        dist.destroy_process_group()
    out["raster_programs"] = sum(k[0][1] == "raster" for k in synthetic._FRAME_PROGRAMS)
    out["pool_mb"] = pool_mib(programs.pool_handle(dev))
    say(f"[train programs] {len(synthetic._FRAME_PROGRAMS)} frame programs ({out['raster_programs']} "
        f"raster, one per padded mesh bucket); graph pool reserved {out['pool_mb']} MiB (every program "
        f"of the run, the training programs added); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return out


@contextlib.contextmanager
def programs_used():
    """The programs called inside, found or made: {id: (program, its replays
    when first called here, whether that call made it)}. The programs of a
    script's models die with them; this keeps them."""
    from cppf2_torch.eval import programs

    used, find = {}, programs.program

    def program(cache, key, fn, args, stateful=False):
        prog = find(cache, key, fn, args, stateful)
        used.setdefault(id(prog), (prog, prog.replays, prog.graph is None))
        return prog

    programs.program = program
    try:
        yield used
    finally:
        programs.program = find


def check_seeded_vit(dev):
    """Phase 15, part 1: the seeded ViT-L/14 extractor (stride 8) built on
    the card, a few leaves held to the CPU's. Returns (extractor, numbers)."""
    import torch

    from cppf2_torch.models import dinov2

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ext = dinov2.DinoFeatureExtractor(stride=8, device=dev.type).init_random(hw=(256, 256), seed=0)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    full = dinov2.init_leaves(dinov2.VIT_L14, 0)
    # the fold-like split gives block 0 of a depth-1 tree the full tree's block-0 keys
    one = dinov2.init_leaves(dataclasses.replace(dinov2.VIT_L14, depth=1), 0)
    leaves = {}
    for path in (("pos_embed",), ("patch_embed", "kernel"), ("blocks", "attn", "qkv", "kernel"),
                 ("blocks", "mlp_fc2", "kernel")):
        maker = full
        for name in path:
            maker = maker[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = maker(dev)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if path[0] == "blocks":
            cpu_maker = one
            for name in path:
                cpu_maker = cpu_maker[name]
            cpu, card = cpu_maker("cpu")[0], card[0]
        else:
            cpu = maker("cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if path == ("blocks", "attn", "qkv", "kernel"):
            w = ext.model.blocks[0].attn.qkv.weight
            if not torch.equal(w, card.t().to(w.dtype)):
                raise AssertionError("the extractor's block-0 qkv is not the seeded leaf, cast")
        host = card.cpu()
        ulps = int((host.view(torch.int32).long() - cpu.view(torch.int32).long()).abs().max())
        bf16 = float((host.bfloat16() == cpu.bfloat16()).double().mean())
        if ulps > 4 or bf16 < 0.999:
            raise AssertionError(f"seeded leaf {'/'.join(path)}: card vs CPU {ulps} ulps, "
                                 f"{100 * bf16:.3f}% of bf16 casts equal")
        leaves["/".join(path)] = dict(ulps=ulps, bf16_equal=bf16, card_ms=card_ms, cpu_ms=cpu_ms,
                                      size=cpu.numel())
        say(f"[accuracy] seeded leaf {'/'.join(path)} ({cpu.numel()} values): card vs CPU max "
            f"{ulps} ulps, {100 * bf16:.4f}% of bf16 casts equal; card {card_ms:.1f} ms, CPU "
            f"{cpu_ms:.1f} ms")
    say(f"[accuracy] seeded ViT-L/14 extractor (stride 8) built on the card in {build_ms:.1f} ms")
    return ext, dict(build_ms=build_ms, leaves=leaves)


def run_accuracy(dev, tmp, frames=4, plain_frames=2):
    """Phase 15: the seeded backbone, `ensemble_benchmark.main` with
    RESULTS.md's reference flags on `frames` frames of can and mug through
    the programs, the first `plain_frames` again all-plain and eager, and
    `custom_training --quick`. Returns a dict of the phase's numbers."""
    import torch

    from cppf2_torch.config import CATEGORIES, PipelineConfig
    from cppf2_torch.eval import programs
    from cppf2_torch.examples import custom_training
    from cppf2_torch.ops import attention, hist16
    from cppf2_torch.scripts import ensemble_benchmark as eb

    ext, seeded = check_seeded_vit(dev)
    root = os.path.dirname(os.path.abspath(__file__))
    ckpts = os.path.join(root, "ckpts_r3")
    out = os.path.join(tmp, "ensemble")
    cats = ("can", "mug")
    zero_counts()
    t0 = time.perf_counter()
    with programs_used() as used:
        summary = eb.main(["--eval-only", ckpts, "--shot-ckpts", ckpts, "--frames", str(frames),
                           "--stride", "8", "--categories", *cats, "--out", out])
    run_s = time.perf_counter() - t0
    counts = read_counts()
    # (program, replays here, 1 if its first call was here: a warm-up's launches)
    runs = [(p, p.replays - r0, int(made)) for p, r0, made in used.values()]
    eager = sum(p.eager_runs for p, _, _ in runs)
    if eager:
        raise AssertionError(f"{eager} eager runs of a program in the ensemble run")
    # every launch of the run is a warm-up's or a replay's of one of its
    # programs; a program's first call warms up, captures and replays
    for obj, name in ((attention._MHA, "mha"), (hist16._PEAK, "hist16_peak")):
        want = sum(p.credited(obj) * (n + made) for p, n, made in runs)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches, the programs account for {want}")
    k1 = [(p.credited(attention._MHA), n) for p, n, _ in runs if p.credited(attention._MHA)]
    if k1 != [(24, len(cats) * frames)]:
        raise AssertionError(f"K1 (launches a replay, replays): {k1}, want one extractor program "
                             f"of 24 replayed {len(cats) * frames} times")
    # can: the ensemble; mug: the ensemble and each branch alone
    k2 = [(p.credited(hist16._PEAK), n) for p, n, _ in runs if p.credited(hist16._PEAK)]
    if k2 != [(12, frames)] * 4:
        raise AssertionError(f"K2 (launches a replay, replays): {k2}, want 4 ensemble programs of "
                             f"12 replayed {frames} times")
    say(f"[accuracy] ensemble_benchmark.main on {frames} frames each of {', '.join(cats)} in "
        f"{run_s:.1f} s: {len(runs)} programs ({sum(m for _, _, m in runs)} made), "
        f"{sum(n for _, n, _ in runs)} replays, 0 eager runs; launches K1 {counts['mha']} (24 a "
        f"frame and the warm-up), K2 {counts['hist16_peak']} (12 an ensemble pass and the "
        f"warm-ups)")

    rows = {}
    r5_dir = os.path.join(root, "benchmarks", "r5_production")
    for cat in cats:
        got = np.load(os.path.join(out, f"errors_{cat}.npz"))
        r5 = np.load(os.path.join(r5_dir, f"errors_{cat}.npz"))
        if not np.array_equal(got["handle_visible"], r5["handle_visible"][:frames]):
            raise AssertionError(f"{cat}: handle visibility {got['handle_visible'].tolist()}, "
                                 f"r5 {r5['handle_visible'][:frames].tolist()}")
        rows[cat] = dict(errs=got["errs"].tolist(), r5_errs=r5["errs"][:frames].tolist(),
                         picks=got["picks"].tolist(), r5_picks=r5["picks"][:frames].tolist(),
                         handle_visible=got["handle_visible"].tolist())
        for i in range(frames):
            say(f"[accuracy] {cat} frame {i}: {got['errs'][i][0]:.2f} deg {got['errs'][i][1]:.2f} cm "
                f"pick {int(got['picks'][i])} | r5 (TPU) {r5['errs'][i][0]:.2f} deg "
                f"{r5['errs'][i][1]:.2f} cm pick {int(r5['picks'][i])} | handle visible "
                f"{int(got['handle_visible'][i])}")

    # the first frames again through eval_ensemble: the kernel route (its
    # programs), then every kernel swapped for its plain version, eagerly
    pipe = PipelineConfig(n_points=4096, num_pairs=20000, restarts=3)

    def ensemble(cat):
        shot = eb.load_shot_params(ckpts, cat, CATEGORIES[cat], dev.type)
        dino = eb._load_branch(eb.DinoBranch(tuple_size=CATEGORIES[cat].tuple_size),
                               os.path.join(ckpts, "dino", cat, "params.msgpack"), dev.type)
        rows_, _, picks, vis, _, _ = eb.eval_ensemble(cat, shot, dino, ext, plain_frames, pipe, 4096,
                                                      0, lambda *_: None, per_branch=cat == "mug",
                                                      device=dev.type)
        return [r["pred_RTs"][0] for r in rows_], picks.tolist(), vis.tolist()

    kernel = {cat: ensemble(cat) for cat in cats}
    saved = attention.mha, hist16.hist16_peak, hist16.hist16_level_peak
    attention.mha, hist16.hist16_peak = attention.mha_plain, hist16.hist16_peak_plain
    hist16.hist16_level_peak = hist16.hist16_level_peak_plain
    zero_counts()
    t0 = time.perf_counter()
    try:
        with programs.disable_capture():
            plain = {cat: ensemble(cat) for cat in cats}
    finally:
        attention.mha, hist16.hist16_peak, hist16.hist16_level_peak = saved
    plain_s = time.perf_counter() - t0
    if any(read_counts().values()):
        raise AssertionError(f"the all-plain run launched kernels: {read_counts()}")
    for cat in cats:
        (k_rt, k_picks, k_vis), (p_rt, p_picks, p_vis) = kernel[cat], plain[cat]
        if k_picks != p_picks or k_vis != p_vis or k_picks != rows[cat]["picks"][:plain_frames]:
            raise AssertionError(f"{cat}: picks / visibility kernel {k_picks} / {k_vis}, plain "
                                 f"{p_picks} / {p_vis}, main {rows[cat]['picks'][:plain_frames]}")
        ang = max(rt_angle_deg(a, b) for a, b in zip(k_rt, p_rt))
        dt = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(k_rt, p_rt))
        if ang > 1.0 or dt > 3e-3:
            raise AssertionError(f"{cat}: kernel vs all-plain route R {ang:.3g} deg, T {dt:.3g} m")
        rows[cat]["plain_vs_kernel"] = dict(r_deg=ang, t_m=dt)
    say(f"[accuracy] kernel route against the all-plain eager route on {plain_frames} frames each "
        f"(plain {plain_s:.1f} s): same picks and handle visibility; "
        + ", ".join(f"{c} R {rows[c]['plain_vs_kernel']['r_deg']:.3g} deg, T "
                    f"{1e3 * rows[c]['plain_vs_kernel']['t_m']:.3g} mm" for c in cats))

    t0 = time.perf_counter()
    with programs_used() as used:
        quick = custom_training.main(["--quick"])
    quick_s = time.perf_counter() - t0
    steps = [p for p, _, made in used.values() if made and p.stateful]
    if len(steps) != 1 or steps[0].replays != 149 or steps[0].eager_runs:
        raise AssertionError(f"custom_training --quick: step programs "
                             f"{[(p.replays, p.eager_runs) for p in steps]}, want one replayed 149 "
                             f"times")
    if not quick["loss_last"] < quick["loss_first"] or not np.isfinite(quick["rot_err_deg"]):
        raise AssertionError(f"custom_training --quick: {quick}")
    say(f"[accuracy] custom_training --quick in {quick_s:.1f} s: 150 steps, one program replayed "
        f"149 times; loss {quick['loss_first']:.3f} -> {quick['loss_last']:.3f}; held-out "
        f"{quick['rot_err_deg']:.2f} deg, {quick['trans_err_cm']:.2f} cm, scale "
        f"{quick['scale_err_cm']:.2f} cm")
    return dict(seeded=seeded, summary=summary, run_s=run_s, launches=counts, rows=rows,
                plain_s=plain_s, quick=quick, quick_s=quick_s)


def _groups(dets):
    from cppf2_torch.infer.frontend import auto_crop

    groups = {}
    for i, (c, m) in enumerate(dets):
        groups.setdefault((c, auto_crop(m)), []).append(i)
    return groups


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

    from cppf2_torch.config import PipelineConfig
    from cppf2_torch.eval import programs
    from cppf2_torch.models.dinov2 import VIT_L14

    pipe = PipelineConfig()
    if (pipe.n_points, pipe.num_pairs, pipe.angle_tol_deg, pipe.opt_steps) != (8192, 50000, 1.0, 100):
        raise AssertionError(f"not the production configuration: {pipe}")
    install_tallies()
    k2 = check_hist16(dev)
    k1 = check_mha(dev)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # phases 3 to 10 run the eager route, as they did before the programs
        # (their plain swaps, stage timers and recorded inputs need it); phases
        # 11 to 14 run the captured programs
        with programs.disable_capture():
            launches, e2e_ms, k2_levels = run_slice(dev, pipe, VIT_L14)
            t_phase = time.perf_counter()
            k2_rows = check_hist16_batched(dev)
            say(f"[K2 rows] the check took {time.perf_counter() - t_phase:.1f} s")
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
            t_phase = time.perf_counter()
            int8_launches, int8 = run_int8_variants(dev, pipe, os.path.join(tmp, "shot.rec"))
            say(f"[int8] the phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        batched = run_batched_frames(dev, pipe, VIT_L14, tmp)
        say(f"[batched frames] the phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        captured = run_captured_programs(dev, pipe, VIT_L14)
        say(f"[captured] the phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        serving = run_serving_programs(dev, pipe, VIT_L14, batched.pop("eval_inputs"), tmp)
        say(f"[serving] the phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        training = run_training_programs(dev, tmp, {b: os.path.join(tmp, f"{b}.rec")
                                                    for b in ("shot", "dino", "dino-e2e")},
                                         VIT_L14, render_train_ms["dino"])
        say(f"[train programs] the phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        accuracy = run_accuracy(dev, tmp)
        say(f"[accuracy] the phase took {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    k1_main = k1[0]      # (16, 1025, 64): the ViT-L stride-8 shape
    k2_cand = k2[1]      # the candidate-array entry at 400k votes, which no path launches now
    k2_level = k2_levels[-1]   # the last (fine) level of the slice: both branches, two rows
    k2_b16 = k2_rows[-1]       # the fine level at 16 rows: a group of eight instances
    k3_main = k3[0]      # (1, 900k, 720): one instance's sampled rotation votes
    k1_frame = k1_batched[0]   # (4, 16, 1025, 64): the four crops of one written frame
    k1_4097 = k1[2]      # (16, 4097, 64): the ViT-L stride-4 shape of DinoFeatureExtractor
    kernels = [
        dict(name="mha", route="cuda", source=attention.SOURCE, replaces=attention.REPLACES,
             launches=launches["mha"], int8_launches=int8_launches["mha"],
             replay_launches=captured["frames"][0]["k1"],
             # what one replay of each of phase 13's serving programs credits
             serving_replay_launches=dict(
                 **{f"instance {k}": v["k1"] for k, v in serving["instance"].items()},
                 singles_frame=serving["singles"]["k1"],
                 **{f"extractor {k}": v["k1"] for k, v in serving["extractor"].items()}),
             # phase 14's "dino" render trainer, every program replayed: 24 a pool
             # frame and a refresh
             train_replay_launches=training["trainer"]["k1"],
             # phase 15's ensemble run: 24 a frame, and the extractor program's warm-up
             accuracy_launches=accuracy["launches"]["mha"],
             max_abs_err=max(r["err"] for r in k1),
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
        # One row for K2. The main path launches it 4 times, all through the
        # fused entry hist16_level_peak with both branches as two rows, so the
        # row's times and bound are those of a fine level of the slice at
        # B = 2; no single PyTorch call makes a level's candidates and
        # histograms them. The candidate-array entry hist16_peak is the same
        # kernel behind another reader; its numbers at 400k votes, with
        # torch.bincount as the library call, stand beside it. `batched` is the
        # fine level at 16 rows (a frame group of eight instances, phase 11's
        # first frame), its launches those of phase 11's batched frame route;
        # `by_rows` holds B = 2, 8 and 16.
        dict(name="hist16_peak", route="cuda", source=hist16.SOURCE, replaces=hist16.REPLACES,
             entry="hist16_level_peak", launches=launches["hist16_peak"], demo_launches=demo_k2,
             int8_launches=int8_launches["hist16_peak"],
             replay_launches=captured["frames"][0]["k2"],
             serving_replay_launches=dict(
                 **{f"instance {k}": v["k2"] for k, v in serving["instance"].items()},
                 singles_frame=serving["singles"]["k2"],
                 evaluator_block=serving["evaluator"]["k2_per_block"]),
             accuracy_launches=accuracy["launches"]["hist16_peak"],
             max_abs_err=max(r["err"] for r in k2 + k2_levels + k2_rows),
             ms=k2_level["ms"], plain_ms=k2_level["plain_ms"], bound_ms=k2_level["bound_ms"],
             bound_by=k2_level["bound_by"], library_ms=None, device_ms=k2_level["device_ms"],
             rows=k2_level["rows"],
             batched=dict(shape=[k2_b16["b"], 50000, 8],
                          launches=sum(f["k2"] for f in batched["frames"]),
                          max_abs_err=max(r["err"] for r in k2_rows), ms=k2_b16["ms"],
                          device_ms=k2_b16["device_ms"], plain_ms=k2_b16["plain_ms"],
                          bound_ms=k2_b16["bound_ms"], bound_by=k2_b16["bound_by"], library_ms=None,
                          singles_ms=k2_b16["singles_ms"],
                          singles_device_ms=k2_b16["singles_device_ms"],
                          by_rows=[{k: r[k] for k in ("b", "ms", "device_ms", "singles_ms",
                                                      "singles_device_ms", "plain_ms", "bound_ms")}
                                   for r in k2_rows]),
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
    ix, iv = int8["extractor"], int8["variants"]
    say(f"[int8] extractor ms_per_call int8 {ix['ms']:.2f} (device {ix['device_ms']:.2f}) vs bf16 "
        f"{ix['bf16_ms']:.2f} (device {ix['bf16_device_ms']:.2f}); cosine vs f32 int8 "
        f"{ix['int8_vs_f32'][1]:.5f} / {ix['int8_vs_f32'][0]:.5f}, bf16 {ix['bf16_vs_f32'][1]:.5f} / "
        f"{ix['bf16_vs_f32'][0]:.5f} (mean / min); e2e_ms_per_instance int8 "
        f"{int8['instance']['e2e_ms']['int8']:.1f} vs bf16 {int8['instance']['e2e_ms']['bf16']:.1f}; "
        f"chunked {iv['chunked']['ms']:.1f} vs hbm {iv['chunked']['hbm_ms']:.1f} ms; cshot "
        f"{iv['cshot']['ms']:.2f} ms; exact kNN equal lists {100 * iv['exact_knn']['same_list']:.2f}%; "
        f"int8 launches {int8_launches}")
    for f in batched["frames"]:
        say(f"[batched frames] {f['name']}: ms_per_frame batched {f['ms']:.1f} / groups of one "
            f"{f['singles_ms']:.1f}; K2 launches {f['k2']} / {f['singles_k2']}; align_pose calls "
            f"{f['align']} / {f['singles_align']}; frontend calls {f['frontend_calls']} / "
            f"{f['singles_frontend_calls']}; MLP forwards per branch {f['forwards']} / "
            f"{f['singles_forwards']}; busy {100 * f['busy_ms'] / f['ms']:.1f}%; peak memory "
            f"{f['peak_mb']:.1f} / {f['singles_peak_mb']:.1f} MiB; frontend ms batched / one an "
            f"instance " + ", ".join(f"{g['group']} {g['ms']:.2f} / {g['singles_ms']:.2f}"
                                     for g in f["groups"])
            + "; largest |logit| difference " + ", ".join(
                f"{g['group']} shot {g['dlogit']['shot']:.3g} dino {g['dlogit']['dino']:.3g}"
                for g in f["groups"]))
    say(f"[batched frames] evaluate_real275_parallel ms_per_instance "
        f"{batched['eval_ms_per_instance']:.1f} (blocks of {batched['eval_align']} rows, K2 launches "
        f"{batched['eval_k2']})")
    for f in captured["frames"]:
        say(f"[captured] {f['name']}: ms_per_frame replay {f['replay_ms']:.1f} / eager "
            f"{f['eager_ms']:.1f} / first dispatch {f['capture_ms']:.1f}; host ms per dispatch_frame "
            f"{f['host_ms']:.1f}; busy {100 * f['busy_ms'] / f['replay_ms']:.1f}%; chunks "
            f"{f['chunks']}; launches per replay K1 {f['k1']}, K2 {f['k2']}; rows replay vs eager "
            f"{f['rows_diff']:.3g}")
    ci = captured["instance"]
    say(f"[captured] estimate_instance ms replay {ci['ms']:.1f} / eager {ci['eager_ms']:.1f}; busy "
        f"{100 * ci['busy_ms'] / ci['ms']:.1f}% / {100 * ci['eager_busy_ms'] / ci['eager_ms']:.1f}%; "
        f"{captured['programs']} programs, graph pool {captured['pool_mb']} MiB against an eager "
        f"peak of {captured['eager_peak_mb']:.1f} MiB")
    for label, r in serving["instance"].items():
        say(f"[serving] estimate_instance via {label}: ms replay {r['ms']:.1f} / eager "
            f"{r['eager_ms']:.1f}; busy {100 * r['busy_ms'] / r['ms']:.1f}% / "
            f"{100 * r['eager_busy_ms'] / r['eager_ms']:.1f}%; {r['programs']} programs a call; "
            f"K1 {r['k1']}, K2 {r['k2']} a replay; reads while dispatching {r['reads']}")
    sf, ev = serving["singles"], serving["evaluator"]
    say(f"[serving] frame with a tierless mask: ms replay {sf['ms']:.1f} / eager {sf['eager_ms']:.1f}; "
        f"evaluate_real275_parallel ms_per_instance (scoring left out) replayed "
        f"{ev['posing_ms_per_instance']['replay']:.1f} / eager {ev['posing_ms_per_instance']['eager']:.1f}"
        f" / first run {ev['posing_ms_per_instance']['first']:.1f}, {ev['programs']} block programs; "
        + "; ".join(f"extractor {k} ms {v['ms']:.2f} replay / {v['eager_ms']:.2f} eager"
                    for k, v in serving["extractor"].items())
        + f"; {serving['programs']} programs, graph pool {serving['pool_mb']} MiB")
    fr, st, tr = training["frames"], training["steps"], training["trainer"]
    say("[train programs] ms per frame replayed / eager: " + ", ".join(
        f"{r} {fr[r]['split']['total']:.1f} / {fr[r]['eager_split']['total']:.1f}" for r in fr)
        + "; ms per step replayed / eager: " + ", ".join(
        f"{b} {v['ms']:.2f} / {v['eager_ms']:.2f}" for b, v in st.items())
        + f"; render trainer dino ms per step {tr['ms']:.1f} replayed / {tr['eager_ms']:.1f} eager "
        f"(phase 8); graph pool {training['pool_mb']} MiB, {training['raster_programs']} raster "
        f"programs")
    acc = accuracy["summary"]["per_category"]
    say("[accuracy] ensemble_benchmark 5deg5cm " + ", ".join(
        f"{c} {v['deg5cm5']:.2f} {[round(x, 2) for x in v['deg5cm5_ci95']]}" for c, v in acc.items())
        + f"; mAP 5deg5cm {accuracy['summary']['mean_5deg5cm']:.3f}, IoU50 "
        f"{accuracy['summary']['mean_iou50']:.3f} (a few frames: a smoke, not the table)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
