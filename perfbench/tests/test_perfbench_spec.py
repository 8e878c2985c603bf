"""Cells, mixes, limits and metric readers are found by name: a new one is a
new file and entry, and no existing file changes."""

import json
import shutil
from pathlib import Path

from perfbench import spec

HERE = Path(spec.__file__).resolve().parent


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    here = root / "perfbench"
    (here / "configs" / "new-config.json").write_text(json.dumps({"route": "vit", "stride": 8}))
    (here / "traffic" / "new-mix.json").write_text(json.dumps({"loop": "eval", "frames": 3}))
    (here / "limits" / "new-cell.json").write_text(json.dumps({"count_gap": 0}))
    (here / "metrics" / "new_metric.eval.py").write_text("def read(ctx):\n    return ctx.frames * 2.0\n")
    bench["configs"].append({"name": "new-config", "source": "s", "file": "perfbench/configs/new-config.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config", "traffic": "new-mix",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new_metric.eval", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "driver", "moves": "instances_per_s",
                               "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.benchmark(root)
    cell = spec.cell(b, "new-cell")
    assert spec.config(b, cell["config"], root) == {"route": "vit", "stride": 8}
    assert spec.traffic(cell["traffic"], here)["frames"] == 3
    assert spec.limits("new-cell", here) == {"count_gap": 0}
    names = [m["name"] for m in spec.metrics_of(b, "new-cell", "per_layer")]
    assert names == ["new_metric.eval"]
    assert spec.reader("new_metric.eval", here)(type("C", (), {"frames": 4})) == 8.0
    # no file that was there changed
    assert all(p.read_bytes() == data for p, data in before.items())


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    b = spec.benchmark()
    for w in b["workloads"]:
        spec.config(b, w["config"])
        assert spec.traffic(w["traffic"])["loop"] in ("eval", "stream")
        assert isinstance(spec.limits(w["name"]), dict)
        layer = spec.metrics_of(b, w["name"], "per_layer")
        e2e = {m["name"] for m in spec.metrics_of(b, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_per_layer_metric_without_workloads_follows_what_it_moves():
    b = {"end_to_end": [{"name": "a", "workloads": ["c1"]}, {"name": "setup_s"}],
         "per_layer": [{"name": "x", "moves": "a"}, {"name": "y", "moves": "a", "workloads": ["c2"]}]}
    assert [m["name"] for m in spec.metrics_of(b, "c1", "per_layer")] == ["x"]
    assert [m["name"] for m in spec.metrics_of(b, "c2", "per_layer")] == ["y"]
    assert [m["name"] for m in spec.metrics_of(b, "c2", "end_to_end")] == ["setup_s"]


def test_a_split_metric_without_a_file_of_its_own_reads_its_base(tmp_path):
    here = tmp_path / "perfbench"
    (here / "metrics").mkdir(parents=True)
    (here / "metrics" / "per_frame.py").write_text("def read(ctx):\n    return ctx.frames + 1.0\n")
    (here / "metrics" / "per_frame.train.py").write_text("def read(ctx):\n    return -1.0\n")
    ctx = type("C", (), {"frames": 4})
    assert spec.reader("per_frame.eval", here)(ctx) == 5.0
    assert spec.reader("per_frame.stream", here)(ctx) == 5.0
    assert spec.reader("per_frame.train", here)(ctx) == -1.0   # a file of its own wins
