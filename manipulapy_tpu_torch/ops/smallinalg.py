"""Scalar-unrolled Cholesky for tiny SPD systems.

Counterpart of ``manipulapy_tpu/ops/smallinalg.py``: the factorization and
both triangular solves are unrolled over the static matrix size n (robot
DoF), so every operation is one elementwise op over the batch.
"""

from __future__ import annotations

import torch

__all__ = ["chol_factor_small", "chol_solve_small", "solve_spd_small"]


def chol_factor_small(M: torch.Tensor) -> list:
    """Cholesky factor of a (..., n, n) SPD matrix as a lower-triangular
    list of lists of (...,) tensors (``L[i][j]`` for j <= i)."""
    n = M.shape[-1]
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def chol_solve_small(L: list, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = rhs`` for (..., n) rhs by unrolled forward and
    backward substitution."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve_spd_small(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``M^{-1} rhs`` for small SPD ``M`` (..., n, n) and rhs (..., n)."""
    return chol_solve_small(chol_factor_small(M), rhs)
