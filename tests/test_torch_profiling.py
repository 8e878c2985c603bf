"""The port's profiling utilities (`cppf2_torch/utils/profiling.py`) on the
two cases of `tests/test_profiling.py`, beside the JAX package's: a chained
timer over a dependent chain, and the StepTimer's JSONL records with the
same fields as JAX's. Times here are host times on the CPU and are checked
for sign only; the trace is written where it is asked to be."""

import json
import os

import jax
import jax.numpy as jnp
import torch

from cppf2_torch.utils import profiling as tprof
from cppf2_tpu.utils import profiling as jprof


def test_chained_timer_measures_positive_time():
    ms = tprof.chained_timer(lambda x: x * 2.0 + 1.0, lambda args, out: (out,), (torch.ones(8, 8),),
                             iters=4, warmup=1)
    want = jprof.chained_timer(jax.jit(lambda x: x * 2.0 + 1.0), lambda args, out: (out,),
                               (jnp.ones((8, 8)),), iters=4, warmup=1)
    assert ms >= 0.0 and want >= 0.0


def test_step_timer_jsonl_matches_jax_fields(tmp_path):
    rows = {}
    for name, mod in (("torch", tprof), ("jax", jprof)):
        p = str(tmp_path / f"{name}.jsonl")
        t = mod.StepTimer(p)
        t.tick(1)
        r2 = t.tick(2, extra={"loss": 0.5})
        assert r2["avg_ms"] > 0
        rows[name] = [json.loads(line) for line in open(p)]
    assert [sorted(r) for r in rows["torch"]] == [sorted(r) for r in rows["jax"]]
    assert rows["torch"][1]["loss"] == 0.5 and rows["torch"][1]["step"] == 2


def test_trace_writes_a_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files), files


# ---------------------------------------------------------------------------
# The frame path's spans, counters and frame records
# ---------------------------------------------------------------------------

def _a_frame(n_draws=2):
    """Draws made before the frame, then one frame of nested spans; returns
    the frame's id. An empty frame first takes what earlier calls left
    outside a frame."""
    with tprof.frame_span("dispatch"):
        pass
    for _ in range(n_draws):
        with tprof.span("draws"):
            pass
    with tprof.frame_span("dispatch") as fid:
        with tprof.span("plan"):
            pass
        with tprof.span("group"):
            with tprof.span("launch"):
                tprof.count("replays")
        tprof.count("upload_bytes", 640)
    with tprof.span("fetch", frame=fid):
        pass
    return fid


def test_spans_off_count_but_keep_no_interval_and_open_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    prev = tprof.tracing(False)
    try:
        fid = _a_frame()
    finally:
        tprof.tracing(prev)
    rec = tprof.frames()[-1]
    assert rec.id == fid and not rec.traced and rec.intervals == []
    assert {k: v[0] for k, v in rec.spans.items()} == {"draws": 2, "dispatch": 1, "plan": 1,
                                                       "group": 1, "launch": 1, "fetch": 1}
    assert all(ns >= 0 for _, ns in rec.spans.values())
    assert rec.counters == {"replays": 1, "upload_bytes": 640}
    assert rec.start_ns <= rec.end_ns


def test_spans_on_under_the_profiler_keep_intervals_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert tprof.tracing_on() is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tprof.tracing_on() is True
        fid = _a_frame()
    rec = tprof.frames()[-1]
    assert rec.id == fid and rec.traced
    parents = {name: parent for name, parent, _, _ in rec.intervals}
    assert parents == {"draws": None, "dispatch": None, "plan": "dispatch", "group": "dispatch",
                       "launch": "group", "fetch": None}
    for _, _, start, end in rec.intervals:
        assert start <= end
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_us = int(doc.get("baseTimeNanoseconds", 0)) / 1e3
    events = {e["name"]: e for e in doc["traceEvents"] if e.get("name", "").startswith("cppf2.")}
    assert set(events) == {"cppf2." + n for n in parents}
    for name, _, start, end in rec.intervals:
        e = events["cppf2." + name]
        assert abs(float(e["ts"]) + base_us - start / 1e3) < 500.0, name
        assert abs(float(e["ts"]) + float(e["dur"]) + base_us - end / 1e3) < 500.0, name


def test_the_override_beats_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    prev = tprof.tracing(True)
    try:
        _a_frame(0)
        assert tprof.frames()[-1].traced and tprof.frames()[-1].intervals
        tprof.tracing(False)
        with profile(activities=[ProfilerActivity.CPU]):
            _a_frame(0)
        assert not tprof.frames()[-1].traced and not tprof.frames()[-1].intervals
    finally:
        tprof.tracing(prev)


def test_the_frame_ring_stays_bounded():
    first = _a_frame(0)
    for _ in range(tprof.FRAMES_KEPT + 5):
        with tprof.frame_span("dispatch"):
            pass
    recs = tprof.frames()
    assert len(recs) == tprof.FRAMES_KEPT
    assert [r.id for r in recs] == sorted(r.id for r in recs) and recs[0].id > first
    with tprof.span("fetch", frame=first):   # a frame gone from the ring counts nowhere
        tprof.count("replays")
    assert all(r.id != first for r in tprof.frames())
