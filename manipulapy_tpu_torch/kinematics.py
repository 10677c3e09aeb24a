"""Forward kinematics and Jacobians on tensors.

Counterpart of ``manipulapy_tpu/kinematics.py``. Every function takes
joint configurations ``q`` of shape (..., n) and batches over the leading
dimensions natively; the per-joint product chain is a Python loop over the
n joints.
"""

from __future__ import annotations

import torch

from .core import lie
from .core.lie import _matvec
from .models.robot import RobotModel

__all__ = [
    "forward_kinematics",
    "link_prefix_transforms",
    "com_transforms",
    "jacobian",
    "jacobian_body",
]


def _eye4(model: RobotModel, batch) -> torch.Tensor:
    eye = torch.eye(4, dtype=model.dtype, device=model.device)
    return eye.expand(tuple(batch) + (4, 4))


def forward_kinematics(model: RobotModel, q: torch.Tensor, frame: str = "space") -> torch.Tensor:
    """Product-of-exponentials FK: (..., n) -> (..., 4, 4).

    ``space``: ``T = exp([S1]q1) ... exp([Sn]qn) M``;
    ``body``:  ``T = M exp([B1]q1) ... exp([Bn]qn)``.
    """
    if frame == "space":
        T = _eye4(model, q.shape[:-1])
        for i in range(model.num_joints):
            T = T @ lie.exp_twist(model.screws_space[i], q[..., i])
        return T @ model.home
    if frame == "body":
        T = model.home
        for i in range(model.num_joints):
            T = T @ lie.exp_twist(model.screws_body[i], q[..., i])
        return T
    raise ValueError("frame must be 'space' or 'body'")


def link_prefix_transforms(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Prefix products ``P_k = exp([S1]q1) ... exp([Sk]qk)``, k = 0..n,
    stacked as (..., n + 1, 4, 4) with ``P_0 = I``."""
    prefixes = [_eye4(model, q.shape[:-1])]
    for i in range(model.num_joints):
        prefixes.append(prefixes[-1] @ lie.exp_twist(model.screws_space[i], q[..., i]))
    return torch.stack(prefixes, dim=-3)


def com_transforms(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Base -> link-k CoM poses ``P_k @ com_home_k``: (..., n, 4, 4)."""
    return link_prefix_transforms(model, q)[..., 1:, :, :] @ model.com_home


def jacobian(model: RobotModel, q: torch.Tensor, frame: str = "space") -> torch.Tensor:
    """Space or body Jacobian, (..., 6, n), by incremental adjoints.

    Space: column i is ``Ad(P_{i-1}) S_i``; body: column i is
    ``Ad(exp(-[B_n]q_n) ... exp(-[B_{i+1}]q_{i+1})) B_i``.
    """
    n = model.num_joints
    batch = q.shape[:-1]
    if frame == "space":
        cols = []
        T = _eye4(model, batch)
        for i in range(n):
            cols.append(_matvec(lie.adjoint(T), model.screws_space[i]))
            T = T @ lie.exp_twist(model.screws_space[i], q[..., i])
        return torch.stack(cols, dim=-1)
    if frame == "body":
        cols = [None] * n
        cols[n - 1] = model.screws_body[n - 1].expand(tuple(batch) + (6,))
        T = _eye4(model, batch)
        for i in range(n - 2, -1, -1):
            T = T @ lie.exp_twist(model.screws_body[i + 1], -q[..., i + 1])
            cols[i] = _matvec(lie.adjoint(T), model.screws_body[i])
        return torch.stack(cols, dim=-1)
    raise ValueError("frame must be 'space' or 'body'")


def jacobian_body(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    return jacobian(model, q, frame="body")
