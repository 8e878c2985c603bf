"""The output check against faults of the timed path, and the control.

A whole run on the CPU at a size a test can hold: the clutter cell's
configuration with a one-block ViT and a small pose budget, three frames of
four cans. The check's own look for a card is skipped (the run is handed the
CPU). A sound run is correct; each fault the frame driver can have, planted
underneath, makes it not correct: an answer altered where it is produced,
half of a group's rows left out (the rest repeated in their place), and a
ViT stage that returns its previous state. The control (the reference one
precision step down) fails the cell's limits. The same for the singles route
alone: the evaluation cell at that size, three frames that each hold a
near laptop (a single) beside one grouped instance, sound and with a
translation moved by 5 mm in the singles route only.

oneDNN is switched off for these runs: it rounds a bfloat16 product
otherwise for each number of rows, so on the CPU a group's rows would part
from the single instance's, and at this small pose budget a near-tie of the
votes then moves a pose by degrees. The card's readings are in PERF.md.
"""

import copy
import time

import pytest
import torch

from perfbench import control, harness, spec
from perfbench.scenes.generate import frame_set

CELL = "s8-clutter-eval"
SINGLES_CELL = "s8-real275-eval"
SEED = 2 ** 31 + 29


def _setup():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    cfg = copy.deepcopy(spec.config(bench, cell["config"]))
    cfg["pipeline"].update(n_points=512, num_pairs=2000, opt_steps=5)
    cfg["vit"].update(depth=1, pretrain_grid=4)
    mix = dict(spec.traffic(cell["traffic"]), frames=3, instances=[4], categories=["can"],
               check_frames=3, distance_m=[0.8, 1.0])
    return bench, cfg, mix, spec.limits(CELL)


@pytest.fixture(scope="module")
def cell():
    threads, onednn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(4)
    torch.backends.mkldnn.enabled = False
    try:
        bench, cfg, mix, limits = _setup()
        yield bench, cfg, mix, limits, frame_set(mix, SEED, "cpu")
    finally:
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = onednn


@pytest.fixture(scope="module")
def singles_cell():
    threads, onednn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(4)
    torch.backends.mkldnn.enabled = False
    try:
        bench = spec.benchmark()
        cell = spec.cell(bench, SINGLES_CELL)
        cfg = copy.deepcopy(spec.config(bench, cell["config"]))
        cfg["pipeline"].update(n_points=512, num_pairs=2000, opt_steps=5)
        cfg["vit"].update(depth=1, pretrain_grid=4)
        mix = dict(spec.traffic(cell["traffic"]), frames=3, instances=[2], tierless_frames=3,
                   check_frames=3, check_tierless=3)
        yield bench, cfg, mix, spec.limits(SINGLES_CELL), frame_set(mix, SEED, "cpu")
    finally:
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = onednn


def _run(cell, monkeypatch, name=CELL):
    bench, cfg, mix, limits, frames = cell
    monkeypatch.setattr(harness, "frame_set", lambda m, s, d: frames)
    return harness.run_cell(name, cfg, mix, limits, spec.metrics_of(bench, name, "end_to_end"),
                            spec.metrics_of(bench, name, "per_layer"), SEED, 0.0, False, "cpu",
                            time.perf_counter())


def test_a_sound_run_is_correct(cell, monkeypatch):
    out = _run(cell, monkeypatch)
    assert out["correct"] is True, out["checked"]
    assert set(out["checked"]) == set(spec.limits(CELL))


def _altered_answer(driver, monkeypatch):
    orig = driver._pack

    def pack(fi, est):
        rows = orig(fi, est)
        return torch.cat([rows[..., :13], rows[..., 13:16] + 0.01, rows[..., 16:]], dim=-1)
    monkeypatch.setattr(driver, "_pack", pack)


def _half_the_group(driver, monkeypatch):
    orig = driver._pack

    def pack(fi, est):
        rows = orig(fi, est)
        if rows.dim() == 2 and rows.shape[0] > 1:
            half = rows.shape[0] // 2
            rows = torch.cat([rows[:rows.shape[0] - half], rows[:half]])
        return rows
    monkeypatch.setattr(driver, "_pack", pack)


def _stale_vit_stage(driver, monkeypatch):
    orig = driver._vit_stage
    last = []

    def stage(backbone, stride, out_size, batches, rgb_u8, masks):
        out = orig(backbone, stride, out_size, batches, rgb_u8, masks)
        prev = last[-1] if last else out
        last.append(out)
        return prev
    monkeypatch.setattr(driver, "_vit_stage", stage)


@pytest.mark.parametrize("fault", [_altered_answer, _half_the_group, _stale_vit_stage],
                         ids=["answer_altered", "half_the_group", "state_unchanged"])
def test_a_fault_of_the_timed_path_is_not_correct(cell, monkeypatch, fault):
    from cppf2_torch.eval import driver

    fault(driver, monkeypatch)
    out = _run(cell, monkeypatch)
    assert out["correct"] is False, out["checked"]


def test_the_control_fails_the_cells_limits(cell):
    _, cfg, mix, _, frames = cell
    numbers = control.readings(cfg, mix, SEED, "cpu")
    ok, checked = control.check.judge(numbers, spec.limits(CELL))
    assert not ok, checked


def test_a_sound_run_with_singles_is_correct(singles_cell, monkeypatch):
    out = _run(singles_cell, monkeypatch, SINGLES_CELL)
    assert out["correct"] is True, out["checked"]


def test_a_fault_of_the_singles_route_alone_is_not_correct(singles_cell, monkeypatch):
    from cppf2_torch.eval import driver

    orig = driver.dispatch_instance

    def dispatch_instance(*args, **kw):
        p = orig(*args, **kw)
        return p._replace(dev=torch.cat([p.dev[:13], p.dev[13:16] + 0.005, p.dev[16:]]))
    monkeypatch.setattr(driver, "dispatch_instance", dispatch_instance)
    out = _run(singles_cell, monkeypatch, SINGLES_CELL)
    assert out["correct"] is False, out["checked"]
    assert out["checked"]["off_route_share"]["value"] == 1.0
