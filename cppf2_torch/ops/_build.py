"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with
nvcc into `cppf2_torch/_build/<name>-<hash>.so` (a git-ignored directory), which
is then loaded with ctypes. The hash covers the source and the flags, so an
edited source never loads a stale library. `build()` starts one nvcc per
missing library, all at once, and waits for them together.

A kernel is found by its file: `KERNELS` is the stems of `csrc/*.cu`. Its
wrapper launches each entry through `launch`, which binds the C function,
launches it on the device's current stream, raises naming the kernel on an
error code and adds one to the launch table, keyed by (kernel, entry): the
`.cu` stem and the C symbol. `launched` reads a kernel's total or one entry's
count (`total` reads it from any such table); `snapshot` and `since` give
what the table gained over a stretch of work, which is how a captured
program (`eval/programs.py`) credits its replays. A counted route with no
`.cu` of its own (`QDense`'s int8 matmul) adds to the table with `count`
under a name of its own.

Nothing here builds at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_launches: Dict[Tuple[str, str], int] = {}   # (kernel, entry) -> launches in this process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {n}]\n{log}")
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function `symbol` of kernel `name`, returning an int (a CUDA
    error code), with its argument types set once."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def launch(kernel: str, entry: str, argtypes: Sequence, dev, *args) -> None:
    """Launch `entry(*args, stream)` of kernel `kernel` (`argtypes` as for
    `function`, the stream's last) on `dev`'s current stream, with `dev` the
    current device; raise naming the kernel if it returns an error code, and
    count the launch. The device is switched only when it is not the current
    one already: the switch costs more host time than a small kernel runs."""
    import torch

    fn = function(kernel, entry, argtypes)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx == torch.cuda.current_device():
        err = fn(*args, raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, raw_stream(idx))
    check(err, f"{kernel} {entry}")
    count(kernel, entry)


def count(kernel: str, entry: str, n: int = 1) -> None:
    """Add `n` launches of `entry` of `kernel` to the launch table."""
    key = (kernel, entry)
    _launches[key] = _launches.get(key, 0) + n


def launched(kernel: str, entry: Optional[str] = None) -> int:
    """Launches of `kernel` in this process (replays credited), or of its one
    `entry`."""
    return total(_launches, kernel, entry)


def total(table: Dict[Tuple[str, str], int], kernel: str, entry: Optional[str] = None) -> int:
    """`kernel`'s count in `table` (the launch table, a `snapshot`, a
    difference), or its one `entry`'s."""
    return sum(n for (k, e), n in table.items() if k == kernel and entry in (None, e))


def snapshot() -> Dict[Tuple[str, str], int]:
    """The launch table as it stands."""
    return dict(_launches)


def since(before: Dict[Tuple[str, str], int]) -> Dict[Tuple[str, str], int]:
    """What each (kernel, entry) gained since `snapshot()` gave `before`."""
    return {key: n - before.get(key, 0) for key, n in _launches.items() if n != before.get(key, 0)}


def raw_stream(idx: int) -> int:
    """The cudaStream_t of device `idx`'s current stream, as an int."""
    import torch

    return torch._C._cuda_getCurrentRawStream(idx)


def check(err: int, what: str) -> None:
    if err >= 100000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
