"""One run of one cell: set-up, the measured window, the output check.

`run_cell` takes the cell's configuration, traffic mix and limits as data;
`perfbench/run.py` finds them by the names in `BENCHMARK.json`.

Set-up renders the mix's distinct frames, builds the system under test,
and sends every frame once through the timed path, which captures every
program the window will replay (each (category, tier, bucket) group, each
ViT pack signature, each single's programs). The window then cycles through
the same frames with fresh draws:

  * `eval`: the closed depth-2 loop of `evaluate_real275`, frame r + 1
    dispatched before frame r is fetched; `instances_per_s` is every
    instance fetched over the whole window;
  * `stream`: one frame in flight; each frame's time runs from its draws and
    `dispatch_frame` to the return of `fetch_frames`, and `frame_ms_p50` /
    `frame_ms_p95` are over every frame of the window.

A capture or an eager run of a program inside the window is an error
(`programs.recorded()`). With `trace`, the mix's `trace_frames` frames go
through twice: untraced, for the host's numbers (dispatch time, replays),
then under torch.profiler, the traced window that the device's per-layer
metrics are read from. After the window the program is freed and the sampled frames
go through the plain reference (`perfbench/check.py`).
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check, flops, spec, stats, trace
from perfbench.reference.frontend import auto_crop
from perfbench.scenes.generate import REAL275_INTRINSICS, frame_set
from perfbench.system import System, Taps, rows_of, vit_config
from perfbench.weights import visual_branch_tree


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _range(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _sampled(mix: Dict, seed: int, frames, limit: int) -> List[int]:
    """The window's dispatch indices whose outputs the check compares: drawn
    from the seed among the first `limit` dispatches, one of them a frame
    with the most instances and, where there are as many, `check_tierless`
    of them frames that hold a single (an instance no crop tier holds)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    n = min(limit, len(frames))
    k = min(mix["check_frames"], n)
    sizes = [len(frames[i].dets) for i in range(n)]
    largest = [i for i in range(n) if sizes[i] == max(sizes)]
    chosen = [int(rng.choice(largest))]
    tierless = [i for i in range(n) if i not in chosen
                and any(not _tiered(m) for _, m in frames[i].dets)]
    t = min(mix.get("check_tierless", 0), len(tierless), k - 1)
    chosen += [int(i) for i in rng.choice(tierless, t, replace=False)] if t else []
    rest = [i for i in range(n) if i not in chosen]
    chosen += [int(i) for i in rng.choice(rest, k - len(chosen), replace=False)]
    return sorted(chosen)


def routes(dets, buckets) -> List[str]:
    """The route of each detection as `dispatch_frame` cuts a frame:
    "single" for a mask no crop tier holds, else "group<b>", b the bucket of
    its chunk (a (category, tier) group cut into chunks of at most the
    largest bucket, each padded up to the smallest bucket that holds it)."""
    out, groups = [None] * len(dets), {}
    for i, (cat, mask) in enumerate(dets):
        tier = auto_crop(mask)
        if tier is None:
            out[i] = "single"
        else:
            groups.setdefault((cat, tier), []).append(i)
    cap = max(buckets)
    for members in groups.values():
        for lo in range(0, len(members), cap):
            chunk = members[lo:lo + cap]
            b = min(b for b in buckets if b >= len(chunk))
            for i in chunk:
                out[i] = f"group{b}"
    return out


def _census(used: Dict) -> (int, List[str]):
    """(replays in the window, faults): a program made or run eagerly in it."""
    replays, faults = 0, []
    for prog, replays0, eager0, made in used.values():
        replays += prog.replays - replays0
        if made or prog.graph is None:
            faults.append(f"captured inside the window: {prog.key[0]!r}")
        if prog.eager_runs != eager0:
            faults.append(f"ran eagerly inside the window: {prog.key[0]!r}")
    return replays, faults


def _window(system: System, frames, mix: Dict, gen, seconds: float, count: Optional[int],
            sampled: List[int], taps: Taps, traced: bool = False):
    """The measured loop: for `seconds` (and on until every sampled frame is
    dispatched), or over `count` frames. Returns its record: frames and
    instances done, frame times, dispatch host times, the kept outputs of
    sampled frames, failures, and the window's length."""
    k = REAL275_INTRINSICS
    n = len(frames)
    rec = SimpleNamespace(frames=0, instances=0, failed=0, frame_ms=[], dispatch_ms=[], kept={},
                          model_items=[])
    want = set(sampled)

    def done(i, pends):
        outs, _ = system.fetch(pends)
        rec.frames += 1
        rec.instances += len(outs)
        rec.failed += sum(1 for v in outs.values() if v is None or not np.all(np.isfinite(v[0])))
        rec.model_items.extend(frames[i % n].dets)

    t_start = time.perf_counter()
    stop = t_start + seconds
    pending = None
    i = 0
    last = max(sampled) if sampled else 0
    # the window runs its seconds, and on until every sampled frame is dispatched
    while (i < count) if count else (i <= last or time.perf_counter() < stop):
        f = frames[i % n]
        t0 = time.perf_counter()
        taps.keep = {} if i in want else None
        with _range(traced, "perfbench.draws"):
            draws = system.draws(f, gen)
        with _range(traced, "perfbench.dispatch"):
            pends = system.dispatch(f, k, draws)
        rec.dispatch_ms.append(1e3 * (time.perf_counter() - t0))
        if i in want:
            rec.kept[i] = (f, draws, pends, taps.keep)
        taps.keep = None
        if mix["loop"] == "stream":
            with _range(traced, "perfbench.fetch"):
                done(i, pends)
            rec.frame_ms.append(1e3 * (time.perf_counter() - t0))
        else:
            if pending is not None:
                with _range(traced, "perfbench.fetch"):
                    done(*pending)
            pending = (i, pends)
        i += 1
    if pending is not None:
        with _range(traced, "perfbench.fetch"):
            done(*pending)
    _sync(system.dev)
    rec.seconds = time.perf_counter() - t_start
    return rec


def _bounds(system: System, cfg: Dict, taps: Taps):
    """The least device time of the window's K1 and K2 calls, from shapes."""
    v = cfg["vit"]
    tokens = spec.backbone(spec.arch(v)).tokens(v, cfg["crop"] // cfg["stride"])
    k1 = sum(v["depth"] * flops.k1_seconds(b, v["num_heads"], tokens, v["embed_dim"] // v["num_heads"])
             for b in taps.vit_calls)
    pipe = system.pipe
    levels = flops.vote_levels(pipe.num_pairs, pipe.vote_levels, pipe.vote_fine_samples)
    rows = [2 * b for b in taps.group_rows] + [2] * taps.singles
    k2 = sum(flops.k2_seconds(r, p, s, arc) for r in rows for p, s, arc in levels)
    return k1, k2, tokens


def _model_flops(cfg: Dict, items, tokens: int, pipe, seed: int) -> float:
    """Forward FLOPs of the backbone over each item's crop and of both branch
    MLPs, the visual branch as wide as the backbone (`visual_branch_tree`)."""
    from perfbench.reference.checkpoints import load_params_msgpack

    v = cfg["vit"]
    per_vit = spec.backbone(spec.arch(v)).flops(v, tokens)
    cache = {}
    total = 0.0
    for cat, _ in items:
        if cat not in cache:
            shot, dino = (load_params_msgpack(os.path.join(cfg["branches"], b, cat, "params.msgpack"))
                          for b in ("shot", "dino"))
            dino = visual_branch_tree(dino, v["embed_dim"], seed)
            cache[cat] = flops.branch_flops(shot, dino, pipe.n_points, pipe.num_pairs)
        total += per_vit + cache[cat]
    return total


def _compare(cfg: Dict, seed: int, dev, kept: Dict) -> Dict[str, float]:
    """The plain reference over the sampled frames, against what the window
    produced for them."""
    from perfbench.reference.pose import Reference

    ref = Reference(cfg, seed, dev)
    gaps, desc, route = [], [], []
    for i in sorted(kept):
        f, draws, pends, taps_kept = kept[i]
        rows = rows_of(pends)
        results = []
        for j, (cat, mask) in enumerate(f.dets):
            d = draws[j]
            res = ref.instance(f.rgb, f.depth, mask, cat, REAL275_INTRINSICS, d.voxel_perm,
                               d.voxel_prio, d.pose)
            results.append(res)
            gaps.append(check.instance_gaps(rows[j], res.row, cat))
        route += routes(f.dets, cfg["buckets"])
        masks = [torch.as_tensor(m, device=dev) for _, m in f.dets]
        for _, parts, pack_masks in taps_kept.get("stages", []):
            grids = torch.cat([g for g, _ in parts])
            for c in range(grids.shape[0]):
                j = next(j for j, m in enumerate(masks) if torch.equal(m, pack_masks[c]))
                desc.append(check.rel_l2(grids[c], results[j].grid))
        singles = [j for j in range(len(f.dets)) if not _tiered(f.dets[j][1])]
        for (pixel_yx, d_prog), j in zip(taps_kept.get("singles_desc", []), singles):
            if torch.equal(pixel_yx, results[j].pixel_yx):
                desc.append(check.rel_l2(d_prog, results[j].desc))
            else:
                desc.append(math.inf)
        del results
    for g, r in zip(gaps, route):
        if check.is_off(g):
            print(f"[perfbench] off the reference on route {r}: " + " ".join(
                f"{k}={v:.6g}" for k, v in g.items()), file=sys.stderr)
    return check.summarize(gaps, desc, route)


def _tiered(mask) -> bool:
    return auto_crop(mask) is not None


def run_cell(cell_name: str, cfg: Dict, mix: Dict, limits: Dict, metrics_e2e: List[Dict],
             metrics_layer: List[Dict], seed: int, seconds: float, traced: bool, device,
             t_process: float, log=sys.stderr) -> Dict:
    """One run; returns the result line's object."""
    dev = torch.device(device)
    t0 = t_process
    # a vit group that the program or the backbone's reference cannot build as
    # it states fails here, before set-up, and never runs as another model
    vit_config(cfg["vit"])
    spec.backbone(spec.arch(cfg["vit"])).leaves(cfg["vit"])
    frames = frame_set(mix, seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system = System(cfg, seed, dev)
    from cppf2_torch.eval import programs

    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    for f in frames:                      # set-up: every program the window will replay
        system.fetch(system.dispatch(f, REAL275_INTRINSICS, system.draws(f, gen)))
    _sync(dev)
    limit = mix["trace_frames"] if traced else len(frames)
    sampled = _sampled(mix, seed, frames, limit)
    setup_s = time.perf_counter() - t0

    taps = Taps(system.driver, spans=traced)
    prof = None
    with contextlib.ExitStack() as stack:
        stack.enter_context(taps)
        used = stack.enter_context(programs.recorded())
        if not traced:
            rec = _window(system, frames, mix, gen, seconds, None, sampled, taps)
        else:
            # the host's own numbers from the frames untraced (the profiler
            # slows the host several times over), then the device's traced
            count = mix["trace_frames"]
            host = _window(system, frames, mix, gen, seconds, count, [], taps)
            replays_host, _ = _census(used)
            taps.vit_calls.clear()
            taps.group_rows.clear()
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = stack.enter_context(profile(activities=acts))
            with _range(True, trace.WINDOW):
                rec = _window(system, frames, mix, gen, seconds, count, sampled, taps, traced=True)
    taps.singles = sum(1 for i in range(rec.frames) for _, m in frames[i % len(frames)].dets
                       if not _tiered(m))
    replays, faults = _census(used)
    if faults and dev.type == "cuda":
        raise RuntimeError("the window compiled or ran eagerly: " + "; ".join(faults[:5]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics: Dict[str, Dict] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = trace.load(path)
        finally:
            os.unlink(path)
        k1, k2, tokens = _bounds(system, cfg, taps)
        ctx = SimpleNamespace(trace=tr, frames=rec.frames, instances=rec.instances,
                              dispatch_ms=host.dispatch_ms, replays=replays_host,
                              host_frames=host.frames, traced_dispatch_ms=rec.dispatch_ms,
                              vit_crops=sum(taps.vit_calls), k1_bound_s=k1, k2_bound_s=k2,
                              model_flops=_model_flops(cfg, rec.model_items, tokens, system.pipe,
                                                        seed))
        for m in metrics_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = trace.busy_seconds(tr)
        device_info["window_s"] = trace.window_seconds(tr)
        breakdown = {"device_ops": trace.top_ops(tr), "idle_gaps": trace.idle_gaps(tr)}
        print(f"[perfbench] traced window {device_info['window_s']:.3f} s, device busy "
              f"{device_info['busy_s']:.3f} s, {100 * tr.credited_share:.1f}% of device time "
              f"credited to a span; dispatch {sum(rec.dispatch_ms) / rec.frames:.2f} ms traced, "
              f"{sum(host.dispatch_ms) / host.frames:.2f} ms untraced", file=log)
    else:
        e2e = {"setup_s": setup_s}
        if rec.frame_ms:
            e2e["frame_ms_p50"] = stats.percentile(rec.frame_ms, 50)
            e2e["frame_ms_p95"] = stats.percentile(rec.frame_ms, 95)
        e2e["instances_per_s"] = stats.rate(rec.instances, rec.seconds)
        for m in metrics_e2e:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    print(f"[perfbench] {cell_name} seed {seed}: set-up {setup_s:.3f} s, {rec.frames} frames, "
          f"{rec.instances} instances in {rec.seconds:.3f} s, {replays} replays, "
          f"{len(rec.kept)} frames checked, draws + dispatch {stats.percentile(rec.dispatch_ms, 50):.2f} "
          f"ms median", file=log)

    kept = rec.kept
    system.close()
    del system
    numbers = _compare(cfg, seed, dev, kept)
    del kept
    correct, checked = check.judge(numbers, limits)
    print("[perfbench] readings " + " ".join(f"{k}={v!r}" for k, v in numbers.items()), file=log)
    out = {"correct": bool(correct and rec.failed == 0), "attempted": rec.instances,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    for line in check.lines(checked):
        print(line, file=log)
    return out
