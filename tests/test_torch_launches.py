"""The one seam of the hand-written kernels (`cppf2_torch/ops/_build.py`).

A kernel is found by its file, `csrc/<name>.cu`; its wrapper launches it
through `_build.launch`, which counts every launch in one table keyed by
(kernel, entry); a captured program (`eval/programs.py`) takes back what its
capture counted and credits it again at every replay. On the CPU: the list
of kernels against the files, a new file built with no list edited (nvcc
stood in for), the launch path with the C function stood in for, and the
table's snapshot, difference, take-back and credit on a made-up kernel.
"""

import importlib.util
import os
import re
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from cppf2_torch.eval import programs
from cppf2_torch.ops import _build


def test_the_kernels_are_the_csrc_files_and_each_wrapper_launches_its_own():
    """`KERNELS` is the sorted stems of `csrc/*.cu`; every module of the
    package that names a `SOURCE` names one of those files and launches that
    kernel by its stem through `_build.launch`, and every kernel is launched
    somewhere (the stage markers from `utils/profiling.py`)."""
    stems = tuple(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    assert _build.KERNELS == stems
    assert {"align", "attention", "hist16", "knn", "sphere", "stage", "swiglu"} <= set(stems)
    launched, wrappers = set(), {}
    for path in sorted(_build.CSRC.parent.rglob("*.py")):
        text = path.read_text()
        launched |= set(re.findall(r'_build\.launch\("(\w+)", ', text))
        for source in re.findall(r'^SOURCE = "([^"]+)"', text, re.M):
            wrappers[path.name] = Path(source).stem
            assert Path(source).parent.name == "csrc" and Path(source).stem in stems, source
            assert f'_build.launch("{Path(source).stem}", ' in text, path
    assert {("alignment.py", "align"), ("attention.py", "attention"), ("hist16.py", "hist16"),
            ("neighbors.py", "knn"), ("sphere.py", "sphere"),
            ("swiglu.py", "swiglu")} <= set(wrappers.items())
    assert launched == set(stems)


def test_a_new_kernel_file_is_built_with_no_list_edited(tmp_path, monkeypatch):
    """A copy of `_build.py` beside a `csrc/` that holds one new `toy.cu`
    lists it and builds it (nvcc stood in for by a script that writes the
    library): adding a kernel edits no list."""
    pkg = tmp_path / "pkg"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    shutil.copy(_build.__file__, pkg / "ops" / "_build.py")
    (pkg / "csrc" / "toy.cu").write_text('extern "C" int cppf2_toy(void* stream) { return 0; }\n')
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    spec = importlib.util.spec_from_file_location("toy_build", pkg / "ops" / "_build.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert copy.KERNELS == ("toy",)
    paths = copy.build()
    assert list(paths) == ["toy"] and paths["toy"] == copy.library_path("toy")
    assert paths["toy"].parent == pkg / "_build" and paths["toy"].exists()


def test_launch_binds_launches_checks_and_counts(monkeypatch):
    """`launch` calls the bound C function with the stream last, counts a
    launch that returns 0 under its (kernel, entry), and raises naming the
    kernel, counting nothing, on an error code."""
    calls, codes = [], [0, 0, 719]

    def fake(*args):
        calls.append(args)
        return codes[len(calls) - 1]

    bound = []
    monkeypatch.setattr(_build, "function",
                        lambda kernel, entry, argtypes: bound.append((kernel, entry)) or fake)
    monkeypatch.setattr(_build, "raw_stream", lambda idx: 1000 + idx)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    before = _build.snapshot()
    dev = torch.device("cuda", 0)
    _build.launch("toy", "toy_a", [], dev, 1, 2)
    _build.launch("toy", "toy_b", [], dev, 3)
    assert calls == [(1, 2, 1000), (3, 1000)]
    assert bound == [("toy", "toy_a"), ("toy", "toy_b")]
    with pytest.raises(RuntimeError, match="toy toy_a: CUDA launch failed with cudaError 719"):
        _build.launch("toy", "toy_a", [], dev, 4)
    assert _build.since(before) == {("toy", "toy_a"): 1, ("toy", "toy_b"): 1}


def test_the_table_counts_and_a_capture_takes_back_what_a_replay_credits(monkeypatch):
    """`count`, `launched` by kernel and by entry, `snapshot`, `since` and
    `total`;
    then what a capture counted (launches of a made-up kernel, and a tally a
    caller registered) is taken back and credited again at every replay."""
    tally = types.SimpleNamespace(rows=[], calls=0)
    monkeypatch.setattr(programs, "_tallies", [])
    programs.count_replays(tally, "rows")
    programs.count_replays(tally, "calls")
    programs.count_replays(tally, "calls")
    assert programs._tallies == [(tally, "rows"), (tally, "calls")]
    n0, a0 = _build.launched("toy2"), _build.launched("toy2", "toy2_a")
    before = programs._counts()
    _build.count("toy2", "toy2_a")
    _build.count("toy2", "toy2_b", 2)
    tally.rows.append(16)
    tally.calls += 1
    assert _build.launched("toy2") == n0 + 3 and _build.launched("toy2", "toy2_a") == a0 + 1
    assert _build.since(before[0]) == {("toy2", "toy2_a"): 1, ("toy2", "toy2_b"): 2}
    assert _build.total(_build.since(before[0]), "toy2", "toy2_b") == 2

    prog = programs.Program(("toy2",), lambda: None)
    prog.credits, prog.tallies = programs._take_back(before)
    assert _build.since(before[0]) == {} and _build.launched("toy2") == n0
    assert tally.rows == [] and tally.calls == 0
    assert prog.credited("toy2") == 3 and prog.credited("toy2", "toy2_b") == 2
    assert prog.credited("attention") == 0
    for _ in range(2):
        prog._credit()
    assert _build.launched("toy2") == n0 + 6 and _build.launched("toy2", "toy2_a") == a0 + 2
    assert tally.rows == [16, 16] and tally.calls == 2
