"""cppf2_torch — the PyTorch/CUDA port of cppf2_tpu for NVIDIA Hopper.

The module layout mirrors `cppf2_tpu` so each function's counterpart is found
under the same path. The JAX package is the reference: every ported function
is held against it in `tests/test_torch_*.py` on the CPU, and the two
hand-written CUDA kernels (`ops/attention.py`, `ops/hist16.py`) are held
against their plain PyTorch versions on the card by `chip_smoke.py`.

Rules the package keeps:
  * it imports torch and numpy, never JAX or anything of `cppf2_tpu`;
  * entry points take an explicit `device` and default to "cuda"; they run on
    the CPU only when asked to, and raise when CUDA is asked for but absent;
  * every stochastic stage accepts injected draws, so the tests can feed it
    the exact numbers `jax.random` drew for the reference.
"""

__version__ = "0.1.0"

from cppf2_torch.config import CATEGORIES, CategoryConfig, PipelineConfig, get_category
from cppf2_torch.device import resolve_device

__all__ = [
    "CATEGORIES",
    "CategoryConfig",
    "PipelineConfig",
    "get_category",
    "resolve_device",
    "__version__",
]
