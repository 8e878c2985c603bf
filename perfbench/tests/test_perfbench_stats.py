"""Percentiles over every frame, rates over the whole window, and the loops
that collect them."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness, stats


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys_linear_rule_over_all_samples(q):
    xs = np.random.default_rng(1).exponential(size=237)
    assert stats.percentile(list(xs), q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(300, 12.0) == 25.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


class _Fake:
    """Frames of 1, 2, 3 instances; dispatch takes 1 ms, fetch 2 ms."""

    dev = SimpleNamespace(type="cpu")

    def draws(self, frame, gen):
        return [None] * len(frame.dets)

    def dispatch(self, frame, k, draws):
        time.sleep(0.001)
        return len(frame.dets)

    def fetch(self, n):
        time.sleep(0.002)
        return {i: (np.eye(4), np.ones(3), 0.0) for i in range(n)}, {}


@pytest.mark.parametrize("loop", ["stream", "eval"])
def test_the_window_counts_every_frame_and_its_whole_length(loop):
    frames = [SimpleNamespace(dets=[("mug", None)] * n) for n in (1, 2, 3)]
    mix = {"loop": loop}
    taps = SimpleNamespace(keep=None)
    rec = harness._window(_Fake(), frames, mix, None, 0.3, None, [0, 2], taps)
    assert rec.frames >= 3 and sorted(rec.kept) == [0, 2]
    assert rec.instances == sum(len(frames[i % 3].dets) for i in range(rec.frames))
    assert len(rec.dispatch_ms) == rec.frames
    assert rec.seconds >= 0.3
    if loop == "stream":
        assert len(rec.frame_ms) == rec.frames
        assert min(rec.frame_ms) >= 3.0
    else:
        assert rec.frame_ms == []
