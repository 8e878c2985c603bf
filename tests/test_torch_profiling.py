"""The port's profiling utilities (`cppf2_torch/utils/profiling.py`) on the
two cases of `tests/test_profiling.py`, beside the JAX package's: a chained
timer over a dependent chain, and the StepTimer's JSONL records with the
same fields as JAX's. Times here are host times on the CPU and are checked
for sign only; the trace is written where it is asked to be."""

import json
import os

import jax
import jax.numpy as jnp
import torch

from cppf2_torch.utils import profiling as tprof
from cppf2_tpu.utils import profiling as jprof


def test_chained_timer_measures_positive_time():
    ms = tprof.chained_timer(lambda x: x * 2.0 + 1.0, lambda args, out: (out,), (torch.ones(8, 8),),
                             iters=4, warmup=1)
    want = jprof.chained_timer(jax.jit(lambda x: x * 2.0 + 1.0), lambda args, out: (out,),
                               (jnp.ones((8, 8)),), iters=4, warmup=1)
    assert ms >= 0.0 and want >= 0.0


def test_step_timer_jsonl_matches_jax_fields(tmp_path):
    rows = {}
    for name, mod in (("torch", tprof), ("jax", jprof)):
        p = str(tmp_path / f"{name}.jsonl")
        t = mod.StepTimer(p)
        t.tick(1)
        r2 = t.tick(2, extra={"loss": 0.5})
        assert r2["avg_ms"] > 0
        rows[name] = [json.loads(line) for line in open(p)]
    assert [sorted(r) for r in rows["torch"]] == [sorted(r) for r in rows["jax"]]
    assert rows["torch"][1]["loss"] == 0.5 and rows["torch"][1]["step"] == 2


def test_trace_writes_a_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files), files
