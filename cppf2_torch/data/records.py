"""Binary training-record store: one container file per category.

Counterpart of `cppf2_tpu/data/records.py` (which replaces the reference's
120k-pickle replay dataset, dataset.py:341-413), with the same bytes on disk:
a file written by either package is read by the other. The reader takes the
repo's native mmap core (`native/records.cpp`, through `cppf2_torch.native`)
where it builds, as the JAX reader does, and a numpy memmap with the same
semantics otherwise; `RecordReader.backend` says which ("native" or
"python").

Record schema is arbitrary (name -> fixed-shape f32/i32 array); the training
schema is {pc, pc_canon, shot, normal, bound, count} (train/loop.py), with
`desc` for the frozen-backbone visual branch or `crop` and `kp` for the
end-to-end one.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Sequence

import numpy as np

_MAGIC = b"CPPF2REC"
_DTYPES = {0: np.float32, 1: np.int32}
_DTYPE_IDS = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}
_FIELD_STRUCT = struct.Struct("<32sII4QQ")  # name, dtype, ndim, shape[4], offset


class RecordWriter:
    """Stream records of a fixed schema into a container file.

    Records go straight to disk (the header's record count is patched on
    close and every `count_patch_every` appends, so a crash mid-dump loses
    at most the tail since the last patch rather than the whole file), so
    dumping a reference-scale 120k-record dataset holds one record in
    memory, not the file."""

    COUNT_PATCH_EVERY = 256

    def __init__(self, path: str, schema: Dict[str, tuple]):
        """schema: name -> (shape tuple, dtype)."""
        self.path = path
        self.fields = []
        offset = 0
        for name, (shape, dtype) in schema.items():
            dt = np.dtype(dtype)
            if dt not in _DTYPE_IDS:
                raise ValueError(f"unsupported dtype {dt} for field {name!r}")
            nbytes = int(np.prod(shape or (1,))) * dt.itemsize
            self.fields.append((name, tuple(shape), dt, offset))
            offset += nbytes
        self.stride = offset
        self.n = 0
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._count_pos = self._f.tell()
        self._f.write(struct.pack("<QQQ", 0, len(self.fields), self.stride))
        for name, shape, dt, off in self.fields:
            shp = list(shape) + [0] * (4 - len(shape))
            self._f.write(
                _FIELD_STRUCT.pack(
                    name.encode()[:32].ljust(32, b"\0"),
                    _DTYPE_IDS[dt], len(shape), *shp, off,
                )
            )

    def append(self, record: Dict[str, np.ndarray]):
        for name, shape, dt, _ in self.fields:
            arr = np.asarray(record[name], dtype=dt)
            want = tuple(shape)
            if int(arr.size) != int(np.prod(want or (1,))):
                raise ValueError(f"field {name!r}: shape {arr.shape} does not fill {want}")
            self._f.write(arr.reshape(want).tobytes())
        self.n += 1
        if self.n % self.COUNT_PATCH_EVERY == 0:
            self._patch_count()

    def _patch_count(self):
        end = self._f.tell()
        self._f.seek(self._count_pos)
        self._f.write(struct.pack("<Q", self.n))
        self._f.seek(end)
        self._f.flush()

    def close(self):
        if self._f is None:
            return
        self._patch_count()
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordReader:
    """Random-access reader: the native mmap core when the library loads
    and opens the file, else a numpy memmap of the container."""

    def __init__(self, path: str):
        from cppf2_torch.native import load

        self.path = path
        self._lib = load()
        self._h = self._lib.rec_open(path.encode()) if self._lib is not None else None
        if self._h:
            self._open_native()
            self.backend = "native"
        else:
            self._open_python(path)
            self.backend = "python"

    def _open_native(self):
        lib, h = self._lib, self._h
        self.n = int(lib.rec_count(h))
        self.fields = []
        for i in range(int(lib.rec_field_count(h))):
            shp = (ctypes.c_uint64 * 4)()
            lib.rec_field_shape(h, i, shp)
            shape = tuple(int(v) for v in shp[:lib.rec_field_ndim(h, i)])
            self.fields.append((lib.rec_field_name(h, i).decode(), shape,
                                np.dtype(_DTYPES[lib.rec_field_dtype(h, i)])))

    def _open_python(self, path: str):
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] != _MAGIC:
                raise ValueError(f"{path}: not a record container")
            self.n, nf, self.stride = struct.unpack("<QQQ", head[8:])
            self.fields = []
            self._offsets = []
            for _ in range(nf):
                raw = f.read(_FIELD_STRUCT.size)
                name, dtid, ndim, s0, s1, s2, s3, off = _FIELD_STRUCT.unpack(raw)
                shape = tuple(int(s) for s in (s0, s1, s2, s3)[:ndim])
                self.fields.append((name.rstrip(b"\0").decode(), shape, np.dtype(_DTYPES[dtid])))
                self._offsets.append(off)
            data_start = f.tell()
        self._mm = np.memmap(path, np.uint8, "r", offset=data_start)
        if self.stride:
            # the file size is the authoritative record count: it recovers
            # the tail a crashed writer appended after its last header patch,
            # and clamps safely if the file was truncated (the header count
            # is only patched every COUNT_PATCH_EVERY appends + on close)
            self.n = len(self._mm) // self.stride

    def gather(self, name: str, record_ids: Sequence[int]) -> np.ndarray:
        """Stack one field over record ids -> (len(ids), *shape)."""
        idx = [i for i, (n, _, _) in enumerate(self.fields) if n == name]
        if not idx:
            raise KeyError(f"no field {name!r} in {self.path}")
        fi = idx[0]
        _, shape, dt = self.fields[fi]
        ids = np.ascontiguousarray(np.asarray(record_ids, np.int64).reshape(-1))
        out = np.empty((len(ids), *shape), dt)
        if self.backend == "native":
            if len(ids) and (ids.min() < 0 or ids.max() >= self.n):
                raise IndexError(f"record ids outside [0, {self.n}) in {self.path}")
            self._lib.rec_gather(self._h, ids.ctypes.data, len(ids), fi, out.ctypes.data)
            return out
        nbytes = int(np.prod(shape or (1,))) * dt.itemsize
        off = self._offsets[fi]
        for k, rid in enumerate(ids):
            start = int(rid) * self.stride + off
            out[k] = np.frombuffer(self._mm[start:start + nbytes], dtype=dt).reshape(shape)
        return out

    def batch(self, record_ids: Sequence[int]) -> Dict[str, np.ndarray]:
        return {n: self.gather(n, record_ids) for n, _, _ in self.fields}

    def close(self):
        if self.backend == "native" and self._h:
            self._lib.rec_close(self._h)
            self._h = None
        self._mm = None

    def __len__(self):
        return self.n


def _field(frame, name: str) -> np.ndarray:
    x = frame[name] if isinstance(frame, dict) else getattr(frame, name)
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def dump_frames(path: str, frames, n_points: int):
    """Write frames (objects or dicts with pc, pc_canon, shot, normal, bound
    and count, as numpy arrays or tensors) in the geometric branch's training
    schema: the analog of the reference's dump_data."""
    schema = {
        "pc": ((n_points, 3), np.float32),
        "pc_canon": ((n_points, 3), np.float32),
        "shot": ((n_points, 352), np.float32),
        "normal": ((n_points, 3), np.float32),
        "bound": ((3,), np.float32),
        "count": ((), np.int32),
    }
    with RecordWriter(path, schema) as w:
        for f in frames:
            w.append({name: _field(f, name) for name in schema})
