"""The port's build of the repo's host C++ core (`cppf2_torch/native.py`) and
its two routes: `pairwise_iou_matrix`'s native IoU and `RecordReader`'s
mmap backend, each against the port's Python route and against the JAX
package's native route."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import special_ortho_group

from cppf2_torch import native
from cppf2_torch.data import records as trec
from cppf2_torch.eval import iou3d as tiou

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    out = native.load()
    assert out is not None, "the native library must build where g++ is installed"
    return out


def test_builds_into_the_build_directory(lib):
    """The library is `cppf2_torch/_build/native-<hash>.so`, named by the
    sources and flags; nothing is written under `native/`."""
    before = sorted(os.listdir(ROOT / "native"))
    path = native.library_path()
    assert path.parent == ROOT / "cppf2_torch" / "_build" and path.exists()
    assert path.name.startswith("native-") and path.suffix == ".so"
    assert native.load() is lib
    assert sorted(os.listdir(ROOT / "native")) == before
    assert native.CXX_FLAGS == ("-O3", "-fPIC", "-std=c++17", "-shared")


def _boxes(rng, n, degenerate=False):
    rts = np.zeros((n, 4, 4))
    for i in range(n):
        rts[i] = np.eye(4)
        rts[i, :3, :3] = special_ortho_group.rvs(3, random_state=rng) * rng.uniform(0.5, 2.0)
        rts[i, :3, 3] = rng.uniform(-0.05, 0.05, 3)
    if degenerate:
        rts[-1, :3, :3] = 0.0
    return rts, rng.uniform(0.05, 0.15, (n, 3))


@pytest.mark.parametrize("class_name,vis", [("mug", [0, 1, 0]), ("mug", [1, 1, 1]),
                                            ("bottle", [1, 1, 1]), ("laptop", [0, 1, 1]),
                                            ("camera", [1, 0, 1])])
def test_pairwise_iou_native_matches_python_and_jax(lib, monkeypatch, class_name, vis):
    """The native route against the port's Python route within 1e-6 (the
    symmetric classes take the best of 36 turns in both), a zeroed rotation
    block scoring 0 (the native core parks it as a box of zero size: below
    1e-12); against the JAX package's native route within 1e-12 (the same
    C++ on the same normalized boxes; the JAX package's tracked library was
    built with -march=native, which may fuse multiply-adds: the two differ by
    up to 3.3e-16). `LAST_ROUTE` records each."""
    from cppf2_tpu.eval import iou3d as jiou

    rng = np.random.default_rng(len(class_name) + sum(vis))
    p_rts, p_s = _boxes(rng, 4, degenerate=True)
    g_rts, g_s = _boxes(rng, 3)
    g_rts[1] = p_rts[0].copy()   # one pair overlaps fully
    g_s[1] = p_s[0]
    args = (p_rts, p_s, g_rts, g_s, np.asarray(vis), class_name)
    got = tiou.pairwise_iou_matrix(*args)
    assert tiou.LAST_ROUTE == "native"
    assert got.shape == (4, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jiou.pairwise_iou_matrix(*args), atol=1e-12, rtol=0)
    monkeypatch.setattr(native, "load", lambda: None)
    py = tiou.pairwise_iou_matrix(*args)
    assert tiou.LAST_ROUTE == "python"
    np.testing.assert_allclose(got, py, atol=1e-6)
    assert got[0, 1] > 0.999 and np.all(got[-1] < 1e-12) and np.all(py[-1] == 0)
    empty = tiou.pairwise_iou_matrix(p_rts[:0], p_s[:0], g_rts, g_s, np.asarray(vis), class_name)
    assert empty.shape == (0, 3)


def _write(path, n=300, tail=0):
    rng = np.random.default_rng(0)
    schema = {"pc": ((64, 3), np.float32), "shot": ((64, 352), np.float32),
              "bound": ((3,), np.float32), "count": ((), np.int32), "kp": ((2, 2, 2), np.int32)}
    rows = []
    with trec.RecordWriter(str(path), schema) as w:
        for i in range(n):
            row = {"pc": rng.normal(size=(64, 3)), "shot": rng.uniform(size=(64, 352)),
                   "bound": rng.uniform(size=3), "count": np.int32(i),
                   "kp": rng.integers(-9, 9, size=(2, 2, 2))}
            w.append(row)
            rows.append(row)
        if tail:   # records appended after the last header patch, as a crashed writer leaves them
            w._f.flush()
            for i in range(tail):
                row = dict(rows[i], count=np.int32(n + i))
                w._f.write(b"".join(np.asarray(row[k], dt).tobytes() for k, (_, dt) in schema.items()))
                rows.append(row)
            w._f.flush()
            os.fsync(w._f.fileno())
            w._f.close()
            w._f = None
    return schema, rows


@pytest.mark.parametrize("tail", [0, 5])
def test_record_reader_native_matches_python_and_jax(lib, monkeypatch, tmp_path, tail):
    """A container the port's writer made (300 records, and 5 more past the
    header's count as a crashed writer leaves them): the native backend,
    the Python backend and the JAX package's reader give the same fields,
    count and gathers, exactly; an id outside the file raises."""
    from cppf2_tpu.data.records import RecordReader as JaxReader

    path = tmp_path / "x.rec"
    schema, rows = _write(path, tail=tail)
    ids = np.random.default_rng(1).integers(0, len(rows), size=40)
    readers = [trec.RecordReader(str(path))]
    monkeypatch.setattr(native, "load", lambda: None)
    readers.append(trec.RecordReader(str(path)))
    monkeypatch.undo()
    readers.append(JaxReader(str(path)))
    assert [r.backend for r in readers] == ["native", "python", "native"]
    for r in readers:
        assert len(r) == len(rows) == 300 + tail
        assert [f[0] for f in r.fields] == list(schema)
        assert [tuple(f[1]) for f in r.fields] == [s for s, _ in schema.values()]
    for name, (shape, dt) in schema.items():
        want = np.stack([np.asarray(rows[i][name], dt).reshape(shape) for i in ids])
        for r in readers:
            np.testing.assert_array_equal(r.gather(name, ids), want)
    batch = readers[0].batch([3, 1, 3])
    np.testing.assert_array_equal(batch["count"], [3, 1, 3])
    with pytest.raises(IndexError):
        readers[0].gather("pc", [len(rows)])
    for r in readers:
        r.close()


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes that build the library into an empty directory at the
    same moment both load a whole library and leave no temporary file."""
    code = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        from cppf2_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        lib = native.load()
        assert lib is not None
        import numpy as np
        r = np.eye(3).ravel(); t = np.zeros(3); s = np.ones(3)
        print(native.library_path().name, lib.box_iou(r.ctypes.data, t.ctypes.data, s.ctypes.data,
                                                      r.ctypes.data, t.ctypes.data, s.ctypes.data))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        name, iou = out.split()
        assert name == native.library_path().name and abs(float(iou) - 1.0) < 1e-9
    assert sorted(os.listdir(tmp_path)) == [native.library_path().name]
