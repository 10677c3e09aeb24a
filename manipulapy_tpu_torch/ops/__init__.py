"""Kernels and their plain PyTorch versions: the step-program emitter
(``cgen``, ``fd_step``), the CUDA rollout (``cuda_rollout``) and the
engine choice (``dispatch``), and the batched MPC kernels
(``cuda_mpc_batch``). Re-exports the small Cholesky helpers of
``smallinalg``, as the JAX package's ``ops`` does."""

from .smallinalg import chol_factor_small, chol_solve_small, solve_spd_small

__all__ = ["chol_factor_small", "chol_solve_small", "solve_spd_small"]
