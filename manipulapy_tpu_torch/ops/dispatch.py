"""Which rollout engine, and which elementwise pass, serves a call.

Counterpart of ``manipulapy_tpu/ops/dispatch.py``. The rule is by device,
dtype and shape alone: a float32 call on a CUDA device with (B, n) initial
states goes to the CUDA kernel (``ops/cuda_rollout.py``); CPU tensors,
other dtypes and unbatched (n,) states go to the plain PyTorch version
(``ops/fd_step.py::build_rollout``), the JAX rule at
``manipulapy_tpu/trajectory.py::_rollout_engine_for``. There is no
work-size threshold: the JAX package's ``MIN_PALLAS_ELEMENTS`` was measured
on a TPU and nothing measured on the GPU says a small call is better
served by the plain version.

The elementwise planning passes (K9, K10; ``ops/elementwise.py``) follow the
same rule: float32 on a CUDA device with no input requiring grad goes to the
kernel, everything else to the generic tensor formulation. The JAX package
dispatches neither of its Pallas twins because XLA fuses the jnp
formulation; eager PyTorch does not fuse.
"""

from __future__ import annotations

import torch

__all__ = ["rollout_kind", "rollout_engine", "elementwise_kind"]


def rollout_kind(device: torch.device, dtype: torch.dtype, batched_2d: bool) -> str:
    """``"cuda"`` for a float32 (B, n) call on a CUDA device, else ``"torch"``."""
    if torch.device(device).type == "cuda" and dtype == torch.float32 and batched_2d:
        return "cuda"
    return "torch"


def rollout_engine(model, dt: float, intRes: int, g, kind: str):
    """A new rollout engine (``nn.Module``) of the given kind. The cached
    public route is ``trajectory.forward_dynamics_trajectory``."""
    if kind == "cuda":
        from .cuda_rollout import build_cuda_rollout

        return build_cuda_rollout(model, dt=dt, intRes=intRes, g=g)
    if kind == "torch":
        from .fd_step import build_rollout

        return build_rollout(model, dt=dt, intRes=intRes, g=g)
    raise ValueError(f"unknown rollout kind {kind!r}")


def elementwise_kind(device: torch.device, dtype: torch.dtype, needs_grad: bool) -> str:
    """``"cuda"`` for a float32 call on a CUDA device with no input requiring
    grad (the kernels have no backward), else ``"torch"``."""
    if torch.device(device).type == "cuda" and dtype == torch.float32 and not needs_grad:
        return "cuda"
    return "torch"
