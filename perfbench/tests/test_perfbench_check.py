"""The output check's counting: off instances in all and by route, the
routes a frame's detections take, and a sample that holds the singles."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import check, harness

H, W = 480, 640


def _mask(side: int, x0: int = 10) -> np.ndarray:
    m = np.zeros((H, W), bool)
    m[10:10 + min(side, H - 20), x0:x0 + side] = True
    return m


def _gap(rot=0.0, trans=0.0, scale=0.0):
    return {"count_gap": 0.0, "extent_mm": 0.0, "rot_deg": rot, "trans_mm": trans, "scale_rel": scale,
            "pick": 0.0, "loss_rel": 0.0}


@pytest.mark.parametrize("gap, off", [
    (_gap(), False), (_gap(rot=0.29, trans=0.9, scale=0.09), False), (_gap(rot=0.31), True),
    (_gap(trans=1.01), True), (_gap(scale=0.11), True), (_gap(rot=math.nan), True),
    (_gap(trans=math.inf), True)])
def test_an_instance_is_off_past_any_of_its_thresholds(gap, off):
    assert check.is_off(gap) is off


def test_off_instances_are_counted_in_all_and_by_route():
    gaps = [_gap(), _gap(rot=5.0), _gap(trans=3.0), _gap(), _gap(scale=0.5)]
    routes = ["group1", "group1", "single", "single", "group8"]
    n = check.summarize(gaps, [0.001, 0.002], routes)
    assert n["off_instances"] == 3.0
    assert (n["off.group1"], n["off.single"], n["off.group8"]) == (1.0, 1.0, 1.0)
    assert (n["instances.group1"], n["instances.single"], n["instances.group8"]) == (2.0, 2.0, 1.0)
    assert n["instances"] == 5.0 and n["desc_rel"] == 0.002
    assert n["off_route_share"] == 0.0   # no route holds three instances
    ok, checked = check.judge(n, {"desc_rel": 0.01, "off_instances": 2})
    assert not ok and checked["off_instances"] == {"value": 3.0, "limit": 2}
    assert check.judge(check.summarize(gaps[:3], [0.001], routes[:3]),
                       {"desc_rel": 0.01, "off_instances": 2})[0]


def test_a_fault_confined_to_one_route_is_its_share():
    fine, moved = _gap(), _gap(trans=8.66)
    routes = ["group1"] * 20 + ["single"] * 3
    sound = check.summarize([fine] * 19 + [moved] + [fine, moved, fine], [0.002], routes)
    assert sound["off_instances"] == 2.0 and sound["off_route_share"] == pytest.approx(1 / 3)
    fault = check.summarize([fine] * 20 + [moved] * 3, [0.002], routes)
    assert fault["off_instances"] == 3.0 and fault["off_route_share"] == 1.0
    limits = {"desc_rel": 0.01, "off_instances": 4, "off_route_share": 0.7}
    assert check.judge(sound, limits)[0] and not check.judge(fault, limits)[0]


def test_routes_cut_groups_into_bucketed_chunks_as_the_driver_does():
    small, big = _mask(100), _mask(400)
    dets = ([("can", small)] * 11 + [("mug", small), ("laptop", big), ("mug", _mask(300, 200))]
            + [("bowl", small)] * 2)
    r = harness.routes(dets, (1, 2, 4, 8))
    assert r[:8] == ["group8"] * 8 and r[8:11] == ["group4"] * 3   # a chunk of 8, the rest
    assert r[11] == r[13] == "group1"   # one category in two crop tiers: two groups
    assert r[12] == "single" and r[14:] == ["group2"] * 2


def test_the_sample_holds_the_largest_frame_and_the_asked_singles():
    small, big = _mask(100), _mask(400)
    frames = ([SimpleNamespace(dets=[("can", small)] * 6)]
              + [SimpleNamespace(dets=[("laptop", big), ("mug", small)]) for _ in range(4)]
              + [SimpleNamespace(dets=[("can", small)] * 2) for _ in range(10)])
    mix = {"check_frames": 5, "check_tierless": 3}
    for seed in (1, 2 ** 31 + 5, 77):
        s = harness._sampled(mix, seed, frames, len(frames))
        assert len(s) == 5 and 0 in s
        assert sum(1 for i in s if 1 <= i <= 4) >= 3
    assert harness._sampled(mix, 9, frames, len(frames)) == harness._sampled(mix, 9, frames, len(frames))
