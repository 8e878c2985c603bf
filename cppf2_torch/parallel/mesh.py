"""Device meshes and the sharded sphere votes on torch.distributed.

Counterpart of `cppf2_tpu/parallel/mesh.py`. The JAX package shards over a
`jax.sharding.Mesh` inside one program; here every rank is a process of an
initialized `torch.distributed` process group, and a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the whole world with JAX's axis
names: ("data",), or ("dcn", "data") for the two-level slice mesh. The callers
pass the global arrays, as they do in JAX, and each rank takes its contiguous
block of the sharded axis, as `PartitionSpec(axis)` places it. The vote
reductions run as `all_reduce(SUM)` on the `data` group only: no collective
crosses `dcn` (the layout rule of the JAX package: the slow axis carries
independent images, the fast one the reductions).

Every function raises when no process group is initialized: a world of one
is started explicitly, never implied.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from cppf2_torch.device import resolve_device
from cppf2_torch.ops import sphere


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group is initialized: call "
                           "torch.distributed.init_process_group first (a world of one is fine)")


def _init_mesh(shape: Sequence[int], names: Sequence[str], device):
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device="cuda"):
    """A one-axis mesh over every rank; `n_devices`, when given, must be the
    world size. Each rank of a CUDA mesh uses cuda:LOCAL_RANK."""
    _require_group()
    n = dist.get_world_size() if n_devices is None else n_devices
    return _init_mesh((n,), (axis,), device)


def make_slice_mesh(n_slices: int = 2, chips_per_slice: int = 4, device="cuda"):
    """Two-level ("dcn", "data") mesh: slices outer, chips of a slice inner,
    so that a rank's `data` group is the ranks of its own slice."""
    return _init_mesh((n_slices, chips_per_slice), ("dcn", "data"), device)


def rank_device(mesh) -> torch.device:
    """The device this rank computes on for `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tree_map(fn, tree):
    """`fn` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _block(n: int, mesh, axis: str, what: str):
    """(lo, hi) of this rank's contiguous block of a length-n axis."""
    parts = axis_size(mesh, axis)
    if n % parts:
        raise ValueError(f"{what}: {n} rows do not divide over the {parts} ranks of '{axis}'")
    per = n // parts
    r = mesh.get_local_rank(axis)
    return r * per, (r + 1) * per


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's block of every leaf's leading (frame) axis, on its device."""
    _require_group()
    dev = rank_device(mesh)

    def take(x):
        lo, hi = _block(len(x), mesh, axis, "shard_batch")
        return torch.as_tensor(x[lo:hi]).to(dev)

    return _tree_map(take, batch)


def replicate(tree, mesh):
    """Every leaf on this rank's device, broadcast from rank 0."""
    _require_group()
    dev = rank_device(mesh)

    def bcast(x):
        t = torch.as_tensor(x).to(dev, copy=True).contiguous()  # broadcast writes in place
        dist.broadcast(t, src=0)
        return t

    return _tree_map(bcast, tree)


def _as_f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=torch.float32).contiguous()


def tuple_sharded_sphere_vote(dirs, weights, sphere_pts, angle_tol_deg: float, mesh,
                              axis: str = "data"):
    """Sphere accumulation with the vote axis sharded over `axis`.

    Each rank counts its block of the (V, 3) votes against the whole sphere
    with kernel K3 (f32 weights), and the partial counts are summed by an
    `all_reduce` on the `axis` group. V must divide by the axis size.
    Returns (best direction (3,), its count ()) on every rank; ties go to
    the lower sphere index.
    """
    _require_group()
    dev = rank_device(mesh)
    lo, hi = _block(dirs.shape[0], mesh, axis, "tuple_sharded_sphere_vote")
    sph = _as_f32(sphere_pts, dev)
    counts = sphere.sphere_accumulate(_as_f32(dirs[lo:hi], dev)[None],
                                      _as_f32(weights[lo:hi], dev)[None], sph, angle_tol_deg)[0]
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    best = torch.argmax(counts)
    return sph[best], counts[best]


class ImageVotes(NamedTuple):
    best: torch.Tensor   # (B / n_dcn, 3) best direction of each of this rank's images
    count: torch.Tensor  # (B / n_dcn,) its count
    offset: int          # index of this rank's first image in the global batch


def image_sharded_tuple_vote(dirs_b, weights_b, sphere_pts, angle_tol_deg: float,
                             mesh) -> ImageVotes:
    """Two-level sharded sphere vote on a ("dcn", "data") mesh: images over
    `dcn`, each image's votes over `data`.

    The rank counts its (B / n_dcn, V / n_data) block in one K3 launch and
    sums the counts over its `data` group only; it issues no collective on
    `dcn`, so each slice owns its images outright. Returns this rank's images
    (gathering them over `dcn` is the caller's step).
    """
    _require_group()
    if tuple(mesh.mesh_dim_names or ()) != ("dcn", "data"):
        raise ValueError(f"needs a ('dcn', 'data') mesh, got {mesh.mesh_dim_names}")
    dev = rank_device(mesh)
    b_lo, b_hi = _block(dirs_b.shape[0], mesh, "dcn", "image_sharded_tuple_vote images")
    v_lo, v_hi = _block(dirs_b.shape[1], mesh, "data", "image_sharded_tuple_vote votes")
    sph = _as_f32(sphere_pts, dev)
    counts = sphere.sphere_accumulate(_as_f32(dirs_b[b_lo:b_hi, v_lo:v_hi], dev),
                                      _as_f32(weights_b[b_lo:b_hi, v_lo:v_hi], dev), sph,
                                      angle_tol_deg)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.get_group("data"))
    best = torch.argmax(counts, dim=-1)
    return ImageVotes(sph[best], counts.gather(1, best[:, None])[:, 0], b_lo)
