"""The port stands alone: no module of `cppf2_torch` and no line of
`chip_smoke.py` imports JAX, flax, optax or the JAX package, nor cv2, PIL or
msgpack, which the card's machine does not have."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cppf2_tpu")
NOT_ON_CARD = ("cv2", "PIL", "msgpack")


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED + NOT_ON_CARD!r}:
            sys.modules[name] = None
        import importlib, pkgutil
        import cppf2_torch
        names = [m.name for m in pkgutil.walk_packages(cppf2_torch.__path__, "cppf2_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED + NOT_ON_CARD!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        # the demo path's modules, which replace the JAX package's cv2 calls
        demo_path = {{"cppf2_torch.demo", "cppf2_torch.utils", "cppf2_torch.utils.imgproc",
                      "cppf2_torch.utils.viz", "cppf2_torch.utils.profiling",
                      "cppf2_torch.infer.segmenter"}}
        assert demo_path <= set(names), demo_path - set(names)
        # the last slice's modules: the native host core's loader and the
        # dataset converters, whose JAX counterparts call cv2
        last_slice = {{"cppf2_torch.native", "cppf2_torch.data.converters",
                       "cppf2_torch.eval.png"}}
        assert last_slice <= set(names), last_slice - set(names)
        # the seeded streams and the accuracy entry points, which stand in
        # for the JAX package's scripts and example
        accuracy = {{"cppf2_torch.models.jax_random", "cppf2_torch.scripts",
                     "cppf2_torch.scripts.ensemble_benchmark",
                     "cppf2_torch.scripts.synthetic_benchmark", "cppf2_torch.examples",
                     "cppf2_torch.examples.custom_training"}}
        assert accuracy <= set(names), accuracy - set(names)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 63


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        (ROOT / "cppf2_torch").rglob("*.py")) + ["chip_smoke.py"])
def test_no_source_imports_the_reference(path):
    mods = {m.split(".")[0] for m in _imports(ROOT / path)}
    assert not mods & set(BLOCKED + NOT_ON_CARD), (path, mods & set(BLOCKED + NOT_ON_CARD))


def test_chip_smoke_names_none_of_them():
    text = (ROOT / "chip_smoke.py").read_text()
    for name in BLOCKED:
        assert name not in text, name
