"""Exact manipulator dynamics on tensors.

Counterpart of ``manipulapy_tpu/dynamics.py``, batched over the leading
dimensions of ``q``:

* the Lagrangian form: ``M = sum_k J_k^T G_k J_k`` over per-link CoM body
  Jacobians, gravity through per-link CoM wrenches, Coriolis through the
  Christoffel symbols of ``dM/dq``, where ``dM/dq`` is exact forward-mode
  autodiff (``torch.func.jacfwd``);
* recursive Newton-Euler (``rnea``) in link-CoM frames, O(n) per call,
  and ``forward_dynamics_fast`` on top of it, the rollout's formulation.
"""

from __future__ import annotations

import torch

from .core import lie
from .core.lie import _matvec
from .kinematics import com_transforms, jacobian, link_prefix_transforms
from .models.robot import RobotModel

__all__ = [
    "mass_matrix",
    "com_jacobians",
    "coriolis_forces",
    "gravity_forces",
    "inverse_dynamics",
    "forward_dynamics",
    "rnea",
    "bias_forces",
    "forward_dynamics_fast",
]

_DEFAULT_GRAVITY = (0.0, 0.0, -9.81)


def _gravity(model: RobotModel, g) -> torch.Tensor:
    return torch.as_tensor(
        _DEFAULT_GRAVITY if g is None else g, dtype=model.dtype, device=model.device
    )


def com_jacobians(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Body Jacobians of every link CoM, (..., n, 6, n); columns of joints
    downstream of link k are zero."""
    n = model.num_joints
    J_s = jacobian(model, q, frame="space")  # (..., 6, n)
    Ad_inv = lie.adjoint(lie.trans_inv(com_transforms(model, q)))  # (..., n, 6, 6)
    J_all = Ad_inv @ J_s.unsqueeze(-3)  # (..., n, 6, n)
    mask = torch.tril(torch.ones((n, n), dtype=model.dtype, device=model.device))
    return J_all * mask[:, None, :]


def mass_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrix ``M(q) = sum_k J_k^T G_k J_k``, symmetrized."""
    Jc = com_jacobians(model, q)
    M = torch.einsum("...kai,kab,...kbj->...ij", Jc, model.inertias, Jc)
    return 0.5 * (M + M.transpose(-1, -2))


def gravity_forces(model: RobotModel, q: torch.Tensor, g=None) -> torch.Tensor:
    """Gravity torques ``sum_k J_k^T [0; m_k R_k^T (-g)]``."""
    g = _gravity(model, g)
    Jc = com_jacobians(model, q)
    R = com_transforms(model, q)[..., :3, :3]  # (..., n, 3, 3)
    masses = model.inertias[:, 3, 3]
    f_lin = masses[:, None] * torch.einsum("...kji,j->...ki", R, -g)
    F = torch.cat([torch.zeros_like(f_lin), f_lin], dim=-1)  # (..., n, 6)
    return torch.einsum("...kai,...ka->...i", Jc, F)


def coriolis_forces(model: RobotModel, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Velocity-quadratic torques ``c_i = sum_jk Gamma_ijk dq_j dq_k`` with
    ``Gamma_ijk = (dM_ij/dq_k + dM_ik/dq_j - dM_jk/dq_i) / 2`` and an exact
    ``dM/dq`` from ``torch.func.jacfwd``."""
    n = model.num_joints
    dM_of = torch.func.jacfwd(lambda qq: mass_matrix(model, qq))
    flat = q.reshape(-1, n)
    dM = torch.func.vmap(dM_of)(flat).reshape(q.shape[:-1] + (n, n, n))
    gamma = 0.5 * (dM + dM.transpose(-1, -2) - dM.permute(*range(dM.dim() - 3), -1, -3, -2))
    return torch.einsum("...ijk,...j,...k->...i", gamma, dq, dq)


def _tip_torque(model: RobotModel, q: torch.Tensor, f_tip) -> torch.Tensor:
    f = torch.as_tensor(f_tip, dtype=model.dtype, device=model.device)
    return _matvec(jacobian(model, q).transpose(-1, -2), f)


def inverse_dynamics(model, q, dq, ddq, g=None, f_tip=None) -> torch.Tensor:
    """``tau = M(q) ddq + c(q, dq) + grav(q) + J_s^T F_tip``."""
    tau = _matvec(mass_matrix(model, q), ddq)
    tau = tau + coriolis_forces(model, q, dq) + gravity_forces(model, q, g)
    if f_tip is not None:
        tau = tau + _tip_torque(model, q, f_tip)
    return tau


def forward_dynamics(model, q, dq, tau, g=None, f_tip=None) -> torch.Tensor:
    """``ddq = M^{-1} (tau - c - grav - J^T F_tip)`` by a Cholesky solve."""
    rhs = tau - coriolis_forces(model, q, dq) - gravity_forces(model, q, g)
    if f_tip is not None:
        rhs = rhs - _tip_torque(model, q, f_tip)
    L = torch.linalg.cholesky(mass_matrix(model, q))
    y = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True).squeeze(-1)


def _rnea_frames(model: RobotModel):
    """``A_k = Ad(Mc_k^-1) S_k`` (joint k's screw in link k's CoM frame) and
    ``M_prev_k = Mc_{k-1}^-1 Mc_k`` (``Mc_0`` is the base: identity)."""
    Mc = model.com_home
    A = _matvec(lie.adjoint(lie.trans_inv(Mc)), model.screws_space)  # (n, 6)
    eye = torch.eye(4, dtype=model.dtype, device=model.device)[None]
    prev = torch.cat([eye, Mc[:-1]], dim=0)
    return A, lie.trans_inv(prev) @ Mc


def rnea(model, q, dq, ddq, g=None, f_tip=None) -> torch.Tensor:
    """Recursive Newton-Euler inverse dynamics in link-CoM frames.

    Forward:  ``V_k = Ad(T_k,k-1) V_{k-1} + A_k dq_k``;
              ``Vd_k = Ad(T_k,k-1) Vd_{k-1} + ad(V_k) A_k dq_k + A_k ddq_k``.
    Backward: ``F_k = Ad(T_k+1,k)^T F_{k+1} + G_k Vd_k - ad(V_k)^T G_k V_k``;
              ``tau_k = A_k . F_k``.

    Gravity enters as the base acceleration ``Vd_0 = [0; -g]``; the tip
    wrench (space-frame coordinates) maps into link n's CoM frame through
    ``Ad(T_space,com_n)^T``.
    """
    n = model.num_joints
    g = _gravity(model, g)
    A, M_prev = _rnea_frames(model)
    batch = q.shape[:-1]

    V = q.new_zeros(batch + (6,))
    Vd = torch.cat([g.new_zeros(3), -g]).expand(batch + (6,))
    V_list, Vd_list, AdT_list = [], [], []
    for k in range(n):
        T_down = lie.exp_twist(A[k], -q[..., k]) @ lie.trans_inv(M_prev[k])
        AdT = lie.adjoint(T_down)
        V = _matvec(AdT, V) + A[k] * dq[..., k, None]
        Vd = (
            _matvec(AdT, Vd)
            + _matvec(lie.ad_twist(V), A[k]) * dq[..., k, None]
            + A[k] * ddq[..., k, None]
        )
        V_list.append(V)
        Vd_list.append(Vd)
        AdT_list.append(AdT)

    F = q.new_zeros(batch + (6,))
    if f_tip is not None:
        T_sn = link_prefix_transforms(model, q)[..., n, :, :] @ model.com_home[n - 1]
        f = torch.as_tensor(f_tip, dtype=model.dtype, device=model.device)
        F = _matvec(lie.adjoint(T_sn).transpose(-1, -2), f)
    taus = [None] * n
    for k in range(n - 1, -1, -1):
        Gk = model.inertias[k]
        F = (
            F
            + _matvec(Gk, Vd_list[k])
            - _matvec(lie.ad_twist(V_list[k]).transpose(-1, -2), _matvec(Gk, V_list[k]))
        )
        taus[k] = torch.sum(A[k] * F, dim=-1)
        F = _matvec(AdT_list[k].transpose(-1, -2), F)
    return torch.stack(taus, dim=-1)


def bias_forces(model, q, dq, g=None) -> torch.Tensor:
    """Coriolis + gravity torques ``h(q, dq) = rnea(q, dq, 0)``."""
    return rnea(model, q, dq, torch.zeros_like(q), g=g)


def forward_dynamics_fast(model, q, dq, tau, g=None, f_tip=None) -> torch.Tensor:
    """``ddq = M^{-1} (tau - rnea(q, dq, 0, g, f_tip))`` with the unrolled
    SPD solve — the formulation the rollout step program emits."""
    from .ops.smallinalg import solve_spd_small

    rhs = tau - rnea(model, q, dq, torch.zeros_like(q), g=g, f_tip=f_tip)
    return solve_spd_small(mass_matrix(model, q), rhs)
