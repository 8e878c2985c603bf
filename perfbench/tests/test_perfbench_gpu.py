"""Cell 1 on the card for 10 seconds, through the benchmark's command."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_cell_one_runs_ten_seconds_and_is_correct(cuda_card):
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "s8-real275-eval",
                          "--seed", "2147483659", "--seconds", "10", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checked"]
    assert result["metrics"]["instances_per_s"]["value"] > 0
    assert result["device"]["platform"] == "gpu"
