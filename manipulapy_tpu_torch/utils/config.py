"""Environment/config flags.

Counterpart of ``manipulapy_tpu/utils/config.py``. The one environment
variable the port reads is ``MANIPULAPY_TPU_CACHE_DIR``: the root that the
CUDA kernels build into and load from (``ops/_build.py::build_root``), where
the JAX package keeps its persistent XLA compilation cache.
"""

from __future__ import annotations

import os

import torch

__all__ = ["env_flag", "configure_cpu_precision", "configure_cache"]


def env_flag(name: str, default: bool = False) -> bool:
    """Parse a boolean environment flag ('1'/'true'/'yes' => True)."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def configure_cpu_precision() -> None:
    """Opt into float64 as the default dtype of new tensors, the
    counterpart of JAX's ``jax_enable_x64``.

    TF32 stays off and the float32 matmul precision stays ``"highest"``.
    The JAX function also sets ``XLA_FLAGS=--xla_cpu_enable_fast_math=false``;
    that flag has no meaning to PyTorch, whose CPU kernels do not lower f64
    transcendentals to approximations, so nothing here replaces it.
    """
    torch.set_default_dtype(torch.float64)


def configure_cache(path: str | None = None) -> None:
    """Set the root that the port's kernels build into and load from:
    ``path``; None goes back to ``$MANIPULAPY_TPU_CACHE_DIR``, else
    ``build/manipulapy_tpu_torch/`` beside the package. Read at each build
    (``ops/_build.py::build_root``), so a later call moves the next build."""
    from ..ops import _build

    _build._CACHE_DIR = path
