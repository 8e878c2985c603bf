"""The readers of the program's own instrumentation, on synthetic traces and
frame records: the stage split of a replay by its marker kernels, the host
pass's records, and the program's spans aligned to the trace's clock
through the harness's `perfbench.dispatch` ranges, refused past 50 us."""

from types import SimpleNamespace

import pytest

from perfbench import spec, trace
from perfbench.metrics import _program

G, S, V = "perfbench.group", "perfbench.single", "perfbench.vit"


def _tr(acts, host=(), window=(0.0, 1000.0)):
    acts = [trace.Activity(n, s, e, sp) for n, s, e, sp in acts]
    return trace.Trace(window, acts, sorted(host), 1.0)


def _replay(t0):
    """One replay: a static-input copy, three stages (a vit range's kernel
    between the align markers counts for nothing), an output clone. 100 us
    of pose work, 10 of copies, 6 of markers."""
    return [("Memcpy DtoD", t0, t0 + 4, G),
            ("stage_mark_frontend", t0 + 5, t0 + 6, G), ("shot_kernel", t0 + 6, t0 + 26, G),
            ("stage_mark_end", t0 + 26, t0 + 27, G),
            ("stage_mark_center_vote", t0 + 27, t0 + 28, G), ("hist16_kernel", t0 + 28, t0 + 38, G),
            ("stage_mark_end", t0 + 38, t0 + 39, G),
            ("stage_mark_align", t0 + 39, t0 + 40, G), ("gemm", t0 + 40, t0 + 110, G),
            ("mha_fwd_kernel", t0 + 110, t0 + 111, V),
            ("stage_mark_end", t0 + 111, t0 + 112, G),
            ("copy_kernel", t0 + 112, t0 + 118, G)]


def test_the_stage_split_of_replays():
    tr = _tr(_replay(0.0) + _replay(200.0) + [("vit_kernel", 400.0, 450.0, V)])
    by, why = _program.split(tr)
    assert why is None
    assert by["align"] == pytest.approx({"stage_mark_align": 2e-6, "gemm": 140e-6,
                                         "stage_mark_end": 2e-6})
    assert sum(by[None].values()) == pytest.approx(20e-6)   # the copies, outside any stage
    assert sum(sum(k.values()) for k in by.values()) == pytest.approx(
        trace.span_seconds(tr, G, S))
    ctx = SimpleNamespace(trace=tr, instances=2)
    assert spec.reader("align_device_ms_per_instance.eval")(ctx) == pytest.approx(0.072)
    assert spec.reader("vote_device_ms_per_instance.stream")(ctx) == pytest.approx(0.012)


def test_a_lost_marker_is_repaired_where_the_others_alternate(capsys):
    """One record lost of twenty replays' markers (a center_vote's end) moves
    only that marker's microsecond; a marker lost in each of them reads
    None."""
    replays = [_replay(200.0 * k) for k in range(20)]
    clean, _ = _program.split(_tr([a for r in replays for a in r], window=(0.0, 4000.0)))
    lost = [a for k, r in enumerate(replays) for j, a in enumerate(r) if not (k == 7 and j == 6)]
    ctx = SimpleNamespace(trace=_tr(lost, window=(0.0, 4000.0)), instances=20)
    by, why = _program.split(ctx.trace)
    assert why.startswith("repaired 1 of 119 markers out of turn")
    assert by["align"] == pytest.approx(clean["align"])
    assert by["center_vote"]["stage_mark_end"] == pytest.approx(
        clean["center_vote"]["stage_mark_end"] - 1e-6)
    assert spec.reader("align_device_ms_per_instance.eval")(ctx) == pytest.approx(0.072)
    assert "stage split repaired" in capsys.readouterr().err
    every = [a for r in replays for j, a in enumerate(r) if j != 6]
    assert _program.split(_tr(every, window=(0.0, 4000.0)))[0] is None


@pytest.mark.parametrize("acts", [
    [("gemm", 0.0, 5.0, G)],                                                 # no markers
    [("stage_mark_align", 0.0, 1.0, G), ("stage_mark_mlps", 1.0, 2.0, G)],  # a begin in a stage
    [("stage_mark_end", 0.0, 1.0, G)],                                       # an end outside
    [("stage_mark_align", 0.0, 1.0, G), ("gemm", 1.0, 5.0, G)],             # never ended
], ids=["none", "nested", "stray_end", "open"])
def test_markers_that_do_not_alternate_read_none(acts):
    ctx = SimpleNamespace(trace=_tr(acts), instances=1)
    assert _program.split(ctx.trace)[0] is None
    assert spec.reader("align_device_ms_per_instance.eval")(ctx) is None


def _rec(traced, upload_ns=0, start_us=0.0, end_us=0.0, intervals=()):
    return SimpleNamespace(traced=traced, spans={"upload": [3, upload_ns]}, counters={"uploads": 3},
                           start_ns=start_us * 1e3, end_ns=end_us * 1e3, intervals=list(intervals))


def test_the_host_pass_is_the_untraced_records_before_the_traced(monkeypatch):
    recs = ([_rec(False, 9_000_000)] * 2 + [_rec(False, n) for n in (1_000_000, 2_000_000, 3_000_000)]
            + [_rec(True, 50_000_000)] * 3)
    monkeypatch.setattr(_program, "frame_records", lambda: recs)
    read = spec.reader("upload_host_ms.eval")
    assert read(SimpleNamespace(host_frames=3)) == pytest.approx(2.0)
    assert read(SimpleNamespace(host_frames=6)) is None      # fewer untraced records than that
    monkeypatch.setattr(_program, "frame_records", lambda: recs[:5])
    assert read(SimpleNamespace(host_frames=3)) is None      # no traced record yet


T0 = 1.7e12   # microseconds on the program's clock (time.time_ns() / 1e3)


def _frame(at, end=185.0):
    """A program frame `at` us into the trace: its draws, its dispatch (a
    group inside) and its fetch, on the program's clock, 5 us late."""
    t = T0 + at + 5
    return _rec(True, start_us=t, end_us=t + end, intervals=[
        ("draws", None, (t - 45) * 1e3, (t - 15) * 1e3),
        ("dispatch", None, t * 1e3, (t + end) * 1e3),
        ("group", "dispatch", (t + 45) * 1e3, (t + 145) * 1e3),
        ("fetch", None, (t + 200) * 1e3, (t + 250) * 1e3)])


def _idle_ctx(recs, monkeypatch):
    monkeypatch.setattr(_program, "frame_records", lambda: [_rec(False)] + recs)
    host = [(100.0, 300.0, "perfbench.dispatch"), (500.0, 700.0, "perfbench.dispatch"),
            (50.0, 95.0, "perfbench.draws")]
    # device idle: 60-70 (draws), 130-150 (dispatch), 600-620 (group), 700-760 (fetch),
    # 900-1000 (outside any span)
    busy = [(0.0, 60.0), (70.0, 130.0), (150.0, 600.0), (620.0, 700.0), (760.0, 900.0)]
    return SimpleNamespace(trace=_tr([("k", s, e, None) for s, e in busy], host), frames=2)


def test_the_program_spans_align_to_the_trace_and_name_the_idle_gaps(monkeypatch):
    ctx = _idle_ctx([_frame(100.0), _frame(500.0)], monkeypatch)
    recs, offset = _program.traced_frames(ctx)
    assert offset == pytest.approx(-T0 - 5.0)
    by = _program.idle_by_span(ctx, recs, offset)
    assert {k: round(v[0], 6) for k, v in by.items()} == {
        "draws": 0.01, "dispatch": 0.02, "group": 0.02, "fetch": 0.06, "outside": 0.1}
    assert sum(v[0] for v in by.values()) == pytest.approx(
        1e3 * (trace.window_seconds(ctx.trace) - trace.busy_seconds(ctx.trace)))
    # draws, dispatch and group count; fetch and outside do not
    assert spec.reader("dispatch_idle_ms.eval")(ctx) == pytest.approx(0.025)


def test_a_span_outside_its_harness_range_refuses_the_alignment(monkeypatch):
    ctx = _idle_ctx([_frame(100.0), _frame(500.0, end=256.0)], monkeypatch)   # 56 us past 700
    assert _program.traced_frames(ctx) is None
    assert spec.reader("dispatch_idle_ms.stream")(ctx) is None
    ctx = _idle_ctx([_frame(100.0), _frame(500.0, end=244.0)], monkeypatch)   # 44 us past: kept
    assert _program.traced_frames(ctx) is not None


def test_a_program_without_records_reads_none(monkeypatch):
    monkeypatch.setattr(_program, "frame_records", lambda: None)
    ctx = SimpleNamespace(trace=_tr([]), frames=1, host_frames=1)
    assert spec.reader("dispatch_idle_ms.eval")(ctx) is None
    assert spec.reader("upload_host_ms.stream")(ctx) is None
