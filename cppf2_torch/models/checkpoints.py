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


def _pack_int(n: int) -> bytes:
    if n < 0:
        raise ValueError("only non-negative integers are written")
    if n < 0x80:
        return struct.pack(">B", n)
    for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I")):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_sized(n: int, fix, codes) -> bytes:
    """Header of a str, bin, array or map of length n: the fix form when
    there is one and it fits, else the narrowest sized form."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in codes:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} is too long for msgpack")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _pack_sized(len(raw), (0xA0, 31), ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                               (0xDB, ">I", 0xFFFFFFFF))) + raw


def _pack_array(arr: np.ndarray, code: int) -> bytes:
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    raw = arr.tobytes()
    body = (b"\x93" + _pack_sized(arr.ndim, (0x90, 15), ((0xDC, ">H", 0xFFFF),))
            + b"".join(_pack_int(int(d)) for d in arr.shape) + _pack_str(arr.dtype.name)
            + _pack_sized(len(raw), None, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                           (0xC6, ">I", 0xFFFFFFFF))) + raw)
    n = len(body)
    if n in (1, 2, 4, 8, 16):
        head = bytes([0xD4 + n.bit_length() - 1])
    else:
        head = _pack_sized(n, None, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                     (0xC9, ">I", 0xFFFFFFFF)))
    return head + struct.pack(">b", code) + body


def _pack(value) -> bytes:
    if isinstance(value, dict):
        head = _pack_sized(len(value), (0x80, 15), ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
        return head + b"".join(_pack_str(k) + _pack(value[k]) for k in sorted(value))
    if isinstance(value, np.generic):
        return _pack_array(np.asarray(value), _EXT_NPSCALAR)
    if isinstance(value, np.ndarray):
        return _pack_array(value, _EXT_NDARRAY)
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(f"cannot write a {type(value).__name__} leaf (expected numpy arrays)")
    return _pack_int(value)


def dumps_msgpack(tree) -> bytes:
    """Encode nested dicts of numpy arrays (and numpy scalars, non-negative
    ints) as one flax msgpack document. Arrays of 2**30 bytes or more, which
    flax writes in chunks, are refused."""
    def check(v):
        if isinstance(v, dict):
            for x in v.values():
                check(x)
        elif isinstance(v, np.ndarray) and v.nbytes >= 2 ** 30:
            raise ValueError("arrays of 2**30 bytes or more are not written")

    check(tree)
    return _pack(tree)


def save_params_msgpack(path: str, tree) -> str:
    """Write `tree` as a flax `params.msgpack` file; returns the path."""
    import os

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(dumps_msgpack(tree))
    return path
