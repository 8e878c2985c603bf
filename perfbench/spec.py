"""Finding a cell's files by the names `BENCHMARK.json` gives.

A configuration is the file its entry names; a traffic mix is
`perfbench/traffic/<traffic>.json`; a per-layer metric is
`perfbench/metrics/<metric>.py` with a `read(ctx)` function (a split such as
`<metric>.eval` without a file of its own reads `<metric>.py`); the limits of a
cell's output check are `perfbench/limits/<cell>.json`; a backbone
architecture is `perfbench/backbones/<arch>.py`, named by the `arch` key of a
configuration's `vit` group (`dinov2` where it has none). A later cell or
metric is added by adding such files and entries, never by editing one.

A new backbone architecture adds its backbone file (`leaves(vit)`, the drawn
weights' names, shapes and kinds; `tokens(vit, grid)`, the tokens one crop
sends through K1; `flops(vit, tokens)`, one crop's forward FLOPs;
`reference(vit, precision, device)`, the plain reference's module), its plain
reference under `perfbench/reference/`, its configuration, its cell and the
cell's limits. The program's side needs the port's `ViTConfig` to have a
field for every other key of the `vit` group.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing: run from the root of a checkout")
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> Dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str, here: Path = HERE) -> Dict:
    with open(here / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def reader(metric: str, here: Path = HERE) -> Callable:
    """The `read` function of `metrics/<metric>.py`, or, where there is no
    such file, of the file named by the metric's name before its last dot
    (`k1_roofline.eval` -> `metrics/k1_roofline.py`)."""
    path = here / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = here / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch(vit: Dict) -> str:
    """The backbone architecture a configuration's `vit` group names."""
    return vit.get("arch", "dinov2")


def backbone(name: str, here: Path = HERE):
    """The module `backbones/<name>.py`, with its `leaves`, `tokens`, `flops`
    and `reference` functions."""
    path = here / "backbones" / f"{name}.py"
    if not path.exists():
        known = sorted(p.stem for p in (here / "backbones").glob("*.py"))
        raise FileNotFoundError(f"no backbone {name!r}: {path} is missing (known: {known})")
    mod_name = "perfbench_backbone_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries a cell reports: those whose
    `workloads` list it; without that list, an end-to-end metric is every
    cell's and a per-layer one is that of every cell reporting what it moves."""
    e2e = {m["name"] for m in metrics_of(bench, cell_name, "end_to_end")} if kind == "per_layer" else None
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
