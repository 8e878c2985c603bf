"""The benchmark's entry point: one run of one cell, one result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds `BENCHMARK.json`. It finds the
cell's configuration, traffic mix, limits and metric files by name, refuses
to run without the CUDA cards the cell asks for, and prints the result as
the last line of standard output: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checked`, each
number the output check compared beside its limit (also the last lines of
standard error). It exits non-zero, printing no result, if JAX, flax or the
JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import os
import time

T_PROCESS = time.perf_counter()
# one host thread: the host's dispatch lies on a frame's path, and idle BLAS
# and OpenMP workers would spin on the cores it runs on
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cppf2_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    torch.set_num_threads(1)
    from perfbench.harness import run_cell

    result = run_cell(
        cell["name"], spec.config(bench, cell["config"]), spec.traffic(cell["traffic"]),
        spec.limits(cell["name"]), spec.metrics_of(bench, cell["name"], "end_to_end"),
        spec.metrics_of(bench, cell["name"], "per_layer"), args.seed, args.seconds,
        bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
