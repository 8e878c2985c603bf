"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with
nvcc into `cppf2_torch/_build/<name>-<hash>.so` (a git-ignored directory), which
is then loaded with ctypes. The hash covers the source and the flags, so an
edited source never loads a stale library. `build()` starts one nvcc per
missing library, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("attention", "hist16", "sphere", "stage", "align", "swiglu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


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


def launch(fn, dev, *args) -> int:
    """Call the C function `fn(*args, stream)` with `dev` as the current
    device and its current stream; returns the function's error code. The
    device is switched only when it is not the current one already: the
    switch costs more host time than a small kernel runs."""
    import torch

    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx == torch.cuda.current_device():
        return fn(*args, raw_stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, raw_stream(idx))


def raw_stream(idx: int) -> int:
    """The cudaStream_t of device `idx`'s current stream, as an int."""
    import torch

    return torch._C._cuda_getCurrentRawStream(idx)


def check(err: int, what: str) -> None:
    if err >= 100000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
