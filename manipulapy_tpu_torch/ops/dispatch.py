"""Which rollout engine serves a call.

Counterpart of ``manipulapy_tpu/ops/dispatch.py``. The rule is by device,
dtype and shape alone: a float32 call on a CUDA device with (B, n) initial
states goes to the CUDA kernel (``ops/cuda_rollout.py``); CPU tensors,
other dtypes and unbatched (n,) states go to the plain PyTorch version
(``ops/fd_step.py::build_rollout``), the JAX rule at
``manipulapy_tpu/trajectory.py::_rollout_engine_for``. There is no
work-size threshold: the JAX package's ``MIN_PALLAS_ELEMENTS`` was measured
on a TPU and nothing measured on the GPU says a small call is better
served by the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["rollout_kind", "rollout_engine"]


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
