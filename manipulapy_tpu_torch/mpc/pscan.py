"""Parallel-scan (associative) Riccati backward pass.

Counterpart of ``manipulapy_tpu/mpc/pscan.py``. The LQR value-function
recursion of the iLQR subproblem is a composition of affine-quadratic maps,
which is associative, so every ``V_{t+1}`` comes out of one suffix scan
with O(log H) sequential depth (the temporal parallelization of Särkkä and
García-Fernández), in deviation coordinates (``x' = A dx + B du``, no
drift).

Each element ``(A, b, C, eta, J)`` stands for the conditional value
function

    V_e(x, z) = 1/2 x^T J x - eta^T x + 1/2 (z - A x - b)^T C^+ (z - A x - b)

and composition eliminates the intermediate state:

    A_ij = A_j (I + C_i J_j)^{-1} A_i
    b_ij = A_j (I + C_i J_j)^{-1} (b_i + C_i eta_j) + b_j
    C_ij = A_j (I + C_i J_j)^{-1} C_i A_j^T + C_j
    eta_ij = A_i^T (I + J_j C_i)^{-1} (eta_j - J_j b_i) + eta_i
    J_ij = A_i^T (I + J_j C_i)^{-1} J_j A_i + J_i

A step with running cost ``1/2 x^T Q x + q^T x + 1/2 u^T R u + r^T u + u^T
P x`` starts as ``A - B R^-1 P``, ``-B R^-1 r``, ``B R^-1 B^T``, ``-(q - P^T
R^-1 r)``, ``Q - P^T R^-1 P``; the terminal cost as ``(0, 0, 0, -q_T,
Q_T)``. The gains then come out of one batched Cholesky pass over all H
steps.

PyTorch has no public associative scan, so the reverse suffix scan is
written out: ``ceil(log2(H + 1))`` levels, level ``d`` combining element
``t`` with element ``t + 2^d`` for every ``t`` at once (one batched
:func:`_combine` a level). The combine's two solves are library solves
(``torch.linalg.solve``), as the JAX module's are: ``I + C J`` with C, J
positive semi-definite has every eigenvalue at least 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.smallinalg import chol_factor_small, chol_solve_small, chol_solve_small_mat

__all__ = ["parallel_riccati"]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.mT)


def _combine(ei, ej):
    """Associative combination over a leading batch of element pairs: ``ei``
    is EARLIER in time, ``ej`` LATER."""
    A_i, b_i, C_i, eta_i, J_i = ei
    A_j, b_j, C_j, eta_j, J_j = ej
    eye = torch.eye(A_i.shape[-1], dtype=A_i.dtype, device=A_i.device)
    M1 = eye + C_i @ J_j
    M2 = eye + J_j @ C_i
    AjM1 = torch.linalg.solve(M1.mT, A_j.mT).mT  # A_j M1^{-1}
    A_ij = AjM1 @ A_i
    b_ij = _mv(AjM1, b_i + _mv(C_i, eta_j)) + b_j
    C_ij = AjM1 @ C_i @ A_j.mT + C_j
    AiTM2 = torch.linalg.solve(M2.mT, A_i).mT  # A_i^T M2^{-1}
    eta_ij = _mv(AiTM2, eta_j - _mv(J_j, b_i)) + eta_i
    J_ij = AiTM2 @ J_j @ A_i + J_i
    # Symmetrize against drift (C, J are symmetric by construction).
    return (A_ij, b_ij, _sym(C_ij), eta_ij, _sym(J_ij))


def _suffix_scan(elems):
    """Inclusive reverse scan along axis 0: ``out[t] = e_t o e_{t+1} o ... o
    e_last``, in ceil(log2(len)) levels of one batched combine each."""
    length = elems[0].shape[0]
    d = 1
    while d < length:
        head = _combine(tuple(e[: length - d] for e in elems), tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([h, e[length - d :]], dim=0) for h, e in zip(head, elems))
        d *= 2
    return elems


def parallel_riccati(
    A: torch.Tensor,  # (H, nx, nx)
    B: torch.Tensor,  # (H, nx, nu)
    lx: torch.Tensor,  # (H, nx)
    lu: torch.Tensor,  # (H, nu)
    lxx: torch.Tensor,  # (H, nx, nx)
    luu: torch.Tensor,  # (H, nu, nu), already regularised
    lux: torch.Tensor,  # (H, nu, nx)
    Vx_T: torch.Tensor,  # (nx,) terminal gradient
    Vxx_T: torch.Tensor,  # (nx, nx) terminal Hessian
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All feedback gains of the LQR subproblem in O(log H) depth.

    Returns ``(ks, Ks, dV, ok)`` with the contract of the sequential sweep
    (:func:`manipulapy_tpu_torch.mpc.ilqr.riccati_sweep`)."""
    nx = A.shape[-1]
    nu = B.shape[-1]
    L_R = chol_factor_small(luu)  # batched over the H steps
    RinvP = chol_solve_small_mat(L_R, lux)  # (H, nu, nx)
    Rinvr = chol_solve_small(L_R, lu)  # (H, nu)
    RinvBt = chol_solve_small_mat(L_R, B.mT)  # (H, nu, nx)

    A_e = A - B @ RinvP
    b_e = -_mv(B, Rinvr)
    C_e = _sym(B @ RinvBt)
    J_e = _sym(lxx - lux.mT @ RinvP)
    eta_e = -(lx - _mv(lux.mT, Rinvr))

    zero_m = torch.zeros((1, nx, nx), dtype=A.dtype, device=A.device)
    zero_v = torch.zeros((1, nx), dtype=A.dtype, device=A.device)
    elems = (
        torch.cat([A_e, zero_m]),
        torch.cat([b_e, zero_v]),
        torch.cat([C_e, zero_m]),
        torch.cat([eta_e, -Vx_T[None]]),
        torch.cat([J_e, Vxx_T[None]]),
    )
    suffix = _suffix_scan(elems)
    # suffix[t] composes steps t..T, so V_t(x) = 1/2 x^T J x - eta^T x; the
    # gains of step t need V_{t+1}.
    S = suffix[4][1:]  # (H, nx, nx)
    s = -suffix[3][1:]  # (H, nx)

    Qu = lu + _mv(B.mT, s)
    Quu = luu + B.mT @ S @ B
    Qux = lux + B.mT @ S @ A
    L = chol_factor_small(Quu)
    diag = torch.stack([L[i][i] for i in range(nu)], dim=-1)
    ok = torch.isfinite(diag).all() & (diag > 0).all()
    ks = -chol_solve_small(L, Qu)
    Ks = -chol_solve_small_mat(L, Qux)
    dV = torch.sum(ks * Qu) + 0.5 * torch.sum(ks * _mv(Quu, ks))
    return ks, Ks, dV, ok & torch.isfinite(ks).all()
