"""The port's mesh functions on torch.distributed against the JAX package's
shard_map versions on the conftest's 8 virtual CPU devices.

Each rank is a plain subprocess that joins a gloo process group through a
FileStore under tmp_path (no TCP port, so parallel test workers cannot
collide) and never imports JAX. Inputs go to the ranks, and results come
back, as .npz files.
"""

import pathlib
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest

from cppf2_torch import parallel
from cppf2_torch.core.geometry import fibonacci_sphere
from cppf2_torch.eval import parallel_eval
from cppf2_tpu import parallel as jparallel

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPHERE = fibonacci_sphere(179)
TOL = 10.0

_PRELUDE = """
import sys
for _name in ("jax", "jaxlib", "flax", "optax", "cppf2_tpu"):
    sys.modules[_name] = None
import datetime
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(TMP + "/store", WORLD), rank=RANK,
                        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
try:
{body}
finally:
    dist.destroy_process_group()
"""


def run_ranks(world: int, body: str, tmp, timeout: float = 300.0):
    """Run `body` on `world` gloo ranks (RANK, WORLD, TMP and np/torch/dist
    are in scope); fail with the stderr of a rank that failed."""
    code = _PRELUDE.format(body=textwrap.indent(textwrap.dedent(body), "    "))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(tmp)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [p.communicate() for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return [o for o, _ in outs]


def _votes(seed, shape):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=shape + (3,)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs, rng.uniform(0.5, 1.5, shape).astype(np.float32)


def _dense(dirs, w):
    """The dense numpy oracle of the JAX package's slice-mesh test."""
    hits = (dirs @ SPHERE.T > np.cos(np.deg2rad(2 * TOL))).astype(np.float32)
    return np.einsum("...v,...vs->...s", w, hits)


def test_tuple_sharded_sphere_vote_world2(tmp_path):
    dirs, w = _votes(1, (1024,))
    np.savez(tmp_path / "in.npz", dirs=dirs, w=w, sphere=SPHERE)
    run_ranks(2, f"""
        from cppf2_torch import parallel
        x = np.load(TMP + "/in.npz")
        mesh = parallel.make_mesh(device="cpu")
        best, count = parallel.tuple_sharded_sphere_vote(x["dirs"], x["w"], x["sphere"], {TOL}, mesh)
        np.savez(TMP + f"/out{{RANK}}.npz", best=best.numpy(), count=count.numpy())
    """, tmp_path)
    jbest, jcount = jparallel.tuple_sharded_sphere_vote(
        jnp.asarray(dirs), jnp.asarray(w), jnp.asarray(SPHERE), TOL, jparallel.make_mesh(2))
    dense = _dense(dirs, w)
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(out["best"], np.asarray(jbest))
        np.testing.assert_array_equal(out["best"], SPHERE[dense.argmax()])
        np.testing.assert_allclose(out["count"], np.asarray(jcount), rtol=1e-5)
        np.testing.assert_allclose(out["count"], dense.max(), rtol=1e-5)


def test_image_sharded_tuple_vote_world4_slice_mesh(tmp_path):
    """A (2, 2) ("dcn", "data") mesh: each rank returns its slice's two
    images. Every collective on a group other than the rank's `data` group
    (its `dcn` group or the world) raises, and the `data` all_reduce runs."""
    dirs, w = _votes(3, (4, 256))
    np.savez(tmp_path / "in.npz", dirs=dirs, w=w, sphere=SPHERE)
    run_ranks(4, f"""
        from cppf2_torch import parallel
        x = np.load(TMP + "/in.npz")
        mesh = parallel.make_slice_mesh(2, 2, device="cpu")
        ranks = lambda g: tuple(dist.get_process_group_ranks(g)) if g is not None else None
        data = ranks(mesh.get_group("data"))
        assert ranks(mesh.get_group("dcn")) != data
        calls = []

        def guard(name, fn):
            def wrapped(*args, **kwargs):
                group = kwargs.get("group")
                if group is None:
                    group = next((a for a in args if isinstance(a, dist.ProcessGroup)), None)
                if ranks(group) != data:
                    raise AssertionError(f"{{name}} on group {{ranks(group)}}, not data {{data}}")
                calls.append(name)
                return fn(*args, **kwargs)
            return wrapped

        for name in ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
                     "all_gather_object", "reduce", "reduce_scatter", "reduce_scatter_tensor",
                     "all_to_all", "all_to_all_single", "gather", "scatter", "barrier",
                     "broadcast_object_list", "send", "recv", "isend", "irecv"):
            if hasattr(dist, name):
                setattr(dist, name, guard(name, getattr(dist, name)))
        out = parallel.image_sharded_tuple_vote(x["dirs"], x["w"], x["sphere"], {TOL}, mesh)
        assert calls == ["all_reduce"], calls
        np.savez(TMP + f"/out{{RANK}}.npz", best=out.best.numpy(), count=out.count.numpy(),
                 offset=out.offset)
    """, tmp_path)
    jbest, jcount = jparallel.image_sharded_tuple_vote(
        jnp.asarray(dirs), jnp.asarray(w), jnp.asarray(SPHERE), TOL, jparallel.make_slice_mesh(2, 2))
    dense = _dense(dirs, w)
    for r in range(4):
        out = np.load(tmp_path / f"out{r}.npz")
        lo = 2 * (r // 2)
        assert int(out["offset"]) == lo and out["best"].shape == (2, 3)
        np.testing.assert_array_equal(out["best"], np.asarray(jbest)[lo:lo + 2])
        np.testing.assert_array_equal(out["best"], SPHERE[dense.argmax(-1)][lo:lo + 2])
        np.testing.assert_allclose(out["count"], np.asarray(jcount)[lo:lo + 2], rtol=1e-5)
        np.testing.assert_allclose(out["count"], dense.max(-1)[lo:lo + 2], rtol=1e-5)


def test_shard_batch_replicate_and_mesh_checks_world2(tmp_path):
    run_ranks(2, """
        from cppf2_torch import parallel
        mesh = parallel.make_mesh(device="cpu")
        part = parallel.shard_batch({"x": np.arange(24).reshape(8, 3), "y": [np.arange(4)]}, mesh)
        rep = parallel.replicate({"a": np.full(3, RANK + 5, np.int64)}, mesh)
        errors = 0
        for bad in (lambda: parallel.make_mesh(3, device="cpu"),
                    lambda: parallel.shard_batch({"x": np.arange(5)}, mesh),
                    lambda: parallel.tuple_sharded_sphere_vote(np.zeros((5, 3)), np.zeros(5),
                                                               np.eye(3), 1.0, mesh),
                    lambda: parallel.image_sharded_tuple_vote(np.zeros((2, 4, 3)), np.zeros((2, 4)),
                                                              np.eye(3), 1.0, mesh)):
            try:
                bad()
            except ValueError:
                errors += 1
        np.savez(TMP + f"/out{RANK}.npz", x=part["x"].numpy(), y=part["y"][0].numpy(),
                 a=rep["a"].numpy(), errors=errors)
    """, tmp_path)
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(out["x"], np.arange(24).reshape(8, 3)[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["y"], np.arange(4)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["a"], [5, 5, 5])
        assert int(out["errors"]) == 4


@pytest.mark.parametrize("call", [
    lambda: parallel.make_mesh(device="cpu"),
    lambda: parallel.make_slice_mesh(1, 1, device="cpu"),
    lambda: parallel.shard_batch({"x": np.zeros(2)}, None),
    lambda: parallel.replicate({"x": np.zeros(2)}, None),
    lambda: parallel.tuple_sharded_sphere_vote(np.zeros((2, 3)), np.zeros(2), SPHERE, 1.0, None),
    lambda: parallel.image_sharded_tuple_vote(np.zeros((1, 2, 3)), np.zeros((1, 2)), SPHERE, 1.0, None),
    lambda: parallel_eval.make_batched_instance_fn(None, "can", None, None),
], ids=["make_mesh", "make_slice_mesh", "shard_batch", "replicate", "tuple_sharded_sphere_vote",
        "image_sharded_tuple_vote", "make_batched_instance_fn"])
def test_raises_without_process_group(call):
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        call()
