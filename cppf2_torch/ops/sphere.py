"""Kernel K3: weighted thresholded-cosine votes on the fibonacci sphere.

Replaces the TPU kernel `cppf2_tpu/ops/pallas_kernels.py::
sphere_accumulate_pallas` (`_sphere_kernel`, pallas_call at :122) and
computes what its XLA twins compute (`ops/voting.py::sphere_vote`,
`parallel/mesh.py::tuple_sharded_sphere_vote` and `image_sharded_tuple_vote`):

    counts[b, s] = sum_v w[b, v] * [dirs[b, v] . sphere[s] > cos(2 tol)]

with each cosine rounded as (d0*p0 + d1*p1) + d2*p2, in the kernel and in the
plain version alike, so that both agree on every hit. The threshold is JAX's:
the f32 cosine of the f32-rounded angle.

On the H100 (source `csrc/sphere.cu`): one block per chunk of 1024 votes of
one batch row, each thread holding its sphere points and their sums in
registers, votes staged through shared memory as float4; a second launch adds
the per-chunk partials in a fixed order (no float atomics, so the counts are
the same bits on every run). At B = 1, V = 900k, S = 720 the call is 4.5 G
f32 instructions, about 0.135 ms on the card: bound by operations.

`sphere_accumulate` launches the kernel for CUDA tensors and uses the plain
version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cppf2_torch.ops import _build

SOURCE = "cppf2_torch/csrc/sphere.cu"
REPLACES = "cppf2_tpu/ops/pallas_kernels.py:122"  # the TPU kernel's pallas_call
KERNEL_CHUNK = 1024    # votes per block of the kernel's first pass
PLAIN_CHUNK = 131072   # votes per step of the plain version, as sphere_vote chunks them


def threshold(angle_tol_deg: float) -> float:
    """cos(2 tol) as the JAX package computes it: the float32 cosine of the
    float32-rounded angle 2 * tol / 180 * pi."""
    angle = torch.tensor(2 * angle_tol_deg / 180.0 * math.pi, dtype=torch.float32)
    return float(torch.cos(angle))


def _cosine(d: torch.Tensor, sphere: torch.Tensor) -> torch.Tensor:
    """(V, 3) x (S, 3) -> (V, S) cosines, elementwise in the kernel's order."""
    return ((d[:, None, 0] * sphere[None, :, 0] + d[:, None, 1] * sphere[None, :, 1])
            + d[:, None, 2] * sphere[None, :, 2])


def sphere_accumulate_plain(dirs: torch.Tensor, weights: torch.Tensor, sphere: torch.Tensor,
                            angle_tol_deg: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, PLAIN_CHUNK votes at a time (a
    whole (900k, 720) f32 block would take 2.6 GB per intermediate)."""
    t = threshold(angle_tol_deg)
    b, v, _ = dirs.shape
    counts = torch.zeros((b, sphere.shape[0]), dtype=torch.float32, device=dirs.device)
    for i in range(b):
        for lo in range(0, v, PLAIN_CHUNK):
            d = dirs[i, lo:lo + PLAIN_CHUNK]
            w = weights[i, lo:lo + PLAIN_CHUNK]
            hits = _cosine(d, sphere) > t
            counts[i] += torch.sum(torch.where(hits, w[:, None], 0.0), dim=0)
    return counts


def _check(dirs, weights, sphere):
    if dirs.dtype != torch.float32 or dirs.dim() != 3 or dirs.shape[2] != 3:
        raise ValueError(f"dirs must be (B, V, 3) float32, got {tuple(dirs.shape)} {dirs.dtype}")
    if weights.dtype != torch.float32 or weights.shape != dirs.shape[:2]:
        raise ValueError(f"weights must be (B, V) float32, got {tuple(weights.shape)} "
                         f"{weights.dtype}")
    if sphere.dtype != torch.float32 or sphere.dim() != 2 or sphere.shape[1] != 3 \
            or sphere.shape[0] < 1:
        raise ValueError(f"sphere must be (S, 3) float32, got {tuple(sphere.shape)} {sphere.dtype}")
    devs = {t.device for t in (dirs, weights, sphere)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if dirs.shape[0] < 1 or dirs.shape[0] > 65535:
        raise ValueError(f"batch of {dirs.shape[0]} rows: the kernel takes 1 to 65535")
    if dirs.shape[1] >= 2 ** 31 or sphere.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31 votes or sphere points")


def sphere_accumulate(dirs: torch.Tensor, weights: torch.Tensor, sphere: torch.Tensor,
                      angle_tol_deg: float) -> torch.Tensor:
    """Weighted votes of `dirs` (B, V, 3) with `weights` (B, V) on the sphere
    points (S, 3) within 2 * `angle_tol_deg` degrees. Returns (B, S) f32."""
    _check(dirs, weights, sphere)
    if dirs.device.type == "cpu":
        return sphere_accumulate_plain(dirs, weights, sphere, angle_tol_deg)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    b, v, _ = dirs.shape
    s = sphere.shape[0]
    dirs, weights, sphere = dirs.contiguous(), weights.contiguous(), sphere.contiguous()
    n_chunks = -(-v // KERNEL_CHUNK)
    partial = torch.empty((b, n_chunks, s), dtype=torch.float32, device=dirs.device)
    counts = torch.empty((b, s), dtype=torch.float32, device=dirs.device)
    _build.launch("sphere", "cppf2_sphere_accumulate",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3, dirs.device,
                  dirs.data_ptr(), weights.data_ptr(), sphere.data_ptr(), b, v, s,
                  threshold(angle_tol_deg), KERNEL_CHUNK, n_chunks, partial.data_ptr(),
                  counts.data_ptr())
    return counts
