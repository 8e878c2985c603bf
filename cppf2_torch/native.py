"""The repo's host C++ core, built and loaded with ctypes (counterpart of
`cppf2_tpu/native.py`).

`native/iou3d.cpp` is the exact oriented-box IoU of the mAP loop and
`native/records.cpp` the mmap'd record store; both are host code, not
kernels. The sources are compiled at first use with g++ and the Makefile's
flags into `cppf2_torch/_build/native-<hash of the sources and flags>.so`
(a git-ignored directory): `make` is never run and nothing is written under
`native/`. A build goes to a temporary name and is renamed into place, so
processes that build at once each load a whole library. Every caller keeps
its Python route for a machine without a compiler; `load()` then returns
None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[1]
SOURCES = (_ROOT / "native" / "iou3d.cpp", _ROOT / "native" / "records.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path. Raises
    RuntimeError when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *map(str, SOURCES)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.box_iou.restype = ctypes.c_double
    lib.box_iou.argtypes = [ctypes.c_void_p] * 6
    lib.batch_iou_sym.restype = None
    lib.batch_iou_sym.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rec_open.restype = ctypes.c_void_p
    lib.rec_open.argtypes = [ctypes.c_char_p]
    lib.rec_close.restype = None
    lib.rec_close.argtypes = [ctypes.c_void_p]
    lib.rec_count.restype = ctypes.c_uint64
    lib.rec_count.argtypes = [ctypes.c_void_p]
    lib.rec_field_count.restype = ctypes.c_uint64
    lib.rec_field_count.argtypes = [ctypes.c_void_p]
    lib.rec_field_name.restype = ctypes.c_char_p
    lib.rec_field_name.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rec_field_dtype.restype = ctypes.c_uint32
    lib.rec_field_dtype.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rec_field_ndim.restype = ctypes.c_uint32
    lib.rec_field_ndim.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rec_field_shape.restype = None
    lib.rec_field_shape.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
    lib.rec_gather.restype = None
    lib.rec_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p,
    ]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built or loaded (the callers then take their Python routes). The first
    answer holds for the life of the process."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        _LIB = _declare(ctypes.CDLL(str(build())))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        _LIB = None
    return _LIB
