"""Scalar-unrolled Cholesky for tiny SPD systems.

Counterpart of ``manipulapy_tpu/ops/smallinalg.py``: the factorization and
both triangular solves are unrolled over the static matrix size n (robot
DoF), so every operation is one elementwise op over the batch.
"""

from __future__ import annotations

import torch

__all__ = [
    "chol_factor_small",
    "chol_solve_small",
    "chol_solve_small_mat",
    "solve_spd_small",
    "solve_spd_small_mat",
    "solve_general_small_mat",
]


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


def chol_solve_small_mat(L: list, rhs: torch.Tensor) -> torch.Tensor:
    """Matrix right-hand side: solve ``L L^T X = rhs`` for (..., n, k) rhs;
    each row of rhs broadcasts against the scalar factor entries."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    return torch.stack(x, dim=-2)


def solve_spd_small_mat(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``M^{-1} rhs`` for small SPD ``M`` (..., n, n) and rhs (..., n, k)."""
    return chol_solve_small_mat(chol_factor_small(M), rhs)


def solve_general_small_mat(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``M^{-1} rhs`` for a small general ``M`` (..., m, m) and rhs (..., m,
    k) by unrolled LU without pivoting. Safe only where the leading
    principal minors stay away from zero, as for ``I + C J`` with C, J
    positive semi-definite (the parallel-Riccati combine matrices)."""
    m = M.shape[-1]
    k = rhs.shape[-1]
    a = [[M[..., i, j] for j in range(m)] for i in range(m)]
    x = [[rhs[..., i, j] for j in range(k)] for i in range(m)]
    for p in range(m):
        inv_p = 1.0 / a[p][p]
        for i in range(p + 1, m):
            f = a[i][p] * inv_p
            for j in range(p + 1, m):
                a[i][j] = a[i][j] - f * a[p][j]
            for j in range(k):
                x[i][j] = x[i][j] - f * x[p][j]
    for p in range(m - 1, -1, -1):
        inv_p = 1.0 / a[p][p]
        for j in range(k):
            s = x[p][j]
            for q in range(p + 1, m):
                s = s - a[p][q] * x[q][j]
            x[p][j] = s * inv_p
    return torch.stack([torch.stack(row, dim=-1) for row in x], dim=-2)
