"""The port's record container against the JAX package's: the same bytes on
disk, and each package reads what the other wrote."""

import numpy as np
import pytest
import torch

from cppf2_torch.data import records as trec
from cppf2_tpu.data import records as jrec

N = 24
SCHEMA = {
    "pc": ((N, 3), np.float32),
    "desc": ((N, 16), np.float32),
    "bound": ((3,), np.float32),
    "count": ((), np.int32),
    "idx": ((2, 3, 4, 5), np.int32),
}


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"pc": rng.normal(size=(N, 3)).astype(np.float32),
             "desc": rng.normal(size=(N, 16)).astype(np.float32),
             "bound": rng.uniform(size=3).astype(np.float32),
             "count": np.int32(rng.integers(1, N)),
             "idx": rng.integers(0, 100, (2, 3, 4, 5)).astype(np.int32)} for _ in range(n)]


def _write(mod, path, recs):
    with mod.RecordWriter(str(path), SCHEMA) as w:
        for r in recs:
            w.append(r)


@pytest.fixture
def python_reader(monkeypatch):
    """The JAX package's reader on its numpy path (its native core is
    optional and reads the same bytes)."""
    import cppf2_tpu.native as native

    monkeypatch.setattr(native, "load", lambda: None)


@pytest.mark.parametrize("n", [0, 3, 300])
def test_container_bytes_equal(n, tmp_path):
    """300 records cross the writer's count-patch interval (256)."""
    recs = _records(n)
    _write(trec, tmp_path / "t.rec", recs)
    _write(jrec, tmp_path / "j.rec", recs)
    assert (tmp_path / "t.rec").read_bytes() == (tmp_path / "j.rec").read_bytes()


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_each_package_reads_the_other(writer, reader, tmp_path, python_reader):
    recs = _records(7, seed=1)
    _write(trec if writer == "torch" else jrec, tmp_path / "x.rec", recs)
    r = (trec if reader == "torch" else jrec).RecordReader(str(tmp_path / "x.rec"))
    assert len(r) == 7 and r.backend == "python"
    assert [(n, tuple(s), np.dtype(d)) for n, s, d in r.fields] == \
        [(n, tuple(s), np.dtype(d)) for n, (s, d) in SCHEMA.items()]
    ids = [5, 0, 5, 6]
    batch = r.batch(ids)
    for name in SCHEMA:
        want = np.stack([recs[i][name] for i in ids])
        assert batch[name].dtype == want.dtype and batch[name].shape == want.shape
        np.testing.assert_array_equal(batch[name], want)
    np.testing.assert_array_equal(r.gather("count", [1]), [recs[1]["count"]])
    r.close()


def test_reader_recovers_the_tail_and_refuses_other_files(tmp_path):
    """The file size gives the record count: records appended after the last
    header patch are read, as in the JAX package's reader."""
    recs = _records(5, seed=2)
    w = trec.RecordWriter(str(tmp_path / "crash.rec"), SCHEMA)
    for r in recs:
        w.append(r)
    w._f.flush()   # no close: the header still says 0 records
    assert len(trec.RecordReader(str(tmp_path / "crash.rec"))) == 5
    w.close()
    (tmp_path / "bad.rec").write_bytes(b"not a container" * 4)
    with pytest.raises(ValueError):
        trec.RecordReader(str(tmp_path / "bad.rec"))
    with pytest.raises(ValueError):
        trec.RecordWriter(str(tmp_path / "f64.rec"), {"x": ((2,), np.float64)})
    with pytest.raises(ValueError):
        _write(trec, tmp_path / "short.rec", [dict(recs[0], pc=np.zeros((N - 1, 3), np.float32))])
    with pytest.raises(KeyError):
        trec.RecordReader(str(tmp_path / "crash.rec")).gather("nope", [0])


def test_dump_frames_takes_tensors_and_matches_jax(tmp_path, python_reader):
    rng = np.random.default_rng(3)

    class Frame:
        def __init__(self):
            self.pc = rng.normal(size=(N, 3)).astype(np.float32)
            self.pc_canon = rng.normal(size=(N, 3)).astype(np.float32)
            self.shot = rng.uniform(size=(N, 352)).astype(np.float32)
            self.normal = rng.normal(size=(N, 3)).astype(np.float32)
            self.bound = rng.uniform(size=3).astype(np.float32)
            self.count = 17

    frames = [Frame() for _ in range(3)]
    jrec.dump_frames(str(tmp_path / "j.rec"), frames, N)
    as_tensors = [{k: torch.as_tensor(v) for k, v in vars(f).items()} for f in frames]
    trec.dump_frames(str(tmp_path / "t.rec"), as_tensors, N)
    assert (tmp_path / "t.rec").read_bytes() == (tmp_path / "j.rec").read_bytes()
    got = trec.RecordReader(str(tmp_path / "j.rec")).batch([2])
    np.testing.assert_array_equal(got["shot"][0], frames[2].shot)
    assert got["count"].tolist() == [17]
