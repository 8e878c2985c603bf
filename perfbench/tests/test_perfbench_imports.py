"""What the benchmark imports: nothing of JAX, flax or the JAX package on its
run path (top-level names compared whole), and nothing of the program in the
plain reference."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cppf2_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in out.stdout.split()}


def test_the_run_path_loads_no_jax():
    code = ("import perfbench.run, perfbench.harness, perfbench.control, perfbench.system\n"
            "import cppf2_torch.eval.driver, cppf2_torch.eval.programs, cppf2_torch.models.dinov2\n"
            "from perfbench import spec\n"
            "[spec.reader(m['name']) for m in spec.benchmark()['per_layer']]")
    top = _loaded(code)
    assert "cppf2_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(p.stem for p in (HERE / "reference").glob("*.py") if p.stem != "__init__")
    top = _loaded("\n".join(f"import perfbench.reference.{m}" for m in mods))
    assert not top & (FORBIDDEN | {"cppf2_torch"})


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_no_reference_source_imports_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {"cppf2_torch"}), (path, names)


def test_the_run_names_a_forbidden_module_by_its_whole_top_level_name(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "flax.core", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    found = run.forbidden_modules()
    assert "flax" in found and "jaxtyping" not in found
