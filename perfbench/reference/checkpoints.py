"""Reader and writer for flax's msgpack parameter files, in pure Python.

The branch checkpoints (`ckpts_r3/{shot,dino}/<cat>/params.msgpack`) are
written by flax's `serialization.to_bytes`: a msgpack map of maps whose
leaves are numpy arrays packed as ext type 1 holding the msgpack triple
(shape, dtype name, raw bytes); numpy scalars are ext type 3 holding the
same triple with an empty shape. Neither `msgpack` nor `flax` is installed where the
port runs, so this module decodes and encodes the format itself. The writer
emits the bytes `flax.serialization.msgpack_serialize` emits for the same
tree (the shortest msgpack form of every header, each map's keys sorted).
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        fixed = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            return getattr(self, kind)(n)
        if 0xD4 <= b <= 0xD8:                             # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at {self.pos - 1}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload).value()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def loads_msgpack(data: bytes):
    """Decode one flax msgpack document into nested dicts of numpy arrays."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack document")
    return out


def load_params_msgpack(path: str):
    """Read a flax `params.msgpack` file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return loads_msgpack(f.read())
