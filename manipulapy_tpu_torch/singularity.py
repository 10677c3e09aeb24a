"""Singularity and manipulability analysis on tensors.

Counterpart of ``manipulapy_tpu/singularity.py``: SVD-based singularity
detection, the condition number, manipulability ellipsoids and measure, and
Monte-Carlo workspace sampling. Every function takes configurations ``q``
of shape (..., n) and batches over the leading dimensions (the JAX
functions take one configuration and are batched with ``vmap``). The
singular values come from ``torch.linalg.svdvals`` / ``svd``, as the JAX
package takes them from XLA's SVD outside any kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .kinematics import forward_kinematics, jacobian
from .models.robot import RobotModel

__all__ = [
    "Ellipsoid",
    "singularity_measure",
    "is_singular",
    "near_singularity",
    "condition_number",
    "manipulability_ellipsoid",
    "manipulability_measure",
    "monte_carlo_workspace",
]

_SINGULARITY_THRESHOLD = 1e-4


def _measure_jacobian(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """The Jacobian whose rank loss defines "singular" for this robot: the
    space Jacobian for n >= 6; for n < 6, where the full 6 x n Jacobian
    never loses rank (the angular rows keep its columns independent), the
    linear block of the body Jacobian."""
    if model.num_joints >= 6:
        return jacobian(model, q, frame="space")
    return jacobian(model, q, frame="body")[..., 3:, :]


def singularity_measure(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Smallest singular value of the task Jacobian, (...)."""
    return torch.linalg.svdvals(_measure_jacobian(model, q))[..., -1]


def is_singular(model: RobotModel, q: torch.Tensor, threshold: float = _SINGULARITY_THRESHOLD):
    """``sigma_min < 1e-4``."""
    return singularity_measure(model, q) < threshold


def near_singularity(model: RobotModel, q: torch.Tensor, threshold: float = 1e-2):
    """The early warning: the same test with a looser threshold."""
    return singularity_measure(model, q) < threshold


def condition_number(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """``sigma_max / sigma_min`` of the task Jacobian."""
    s = torch.linalg.svdvals(_measure_jacobian(model, q))
    return s[..., 0] / torch.clamp(s[..., -1], min=1e-30)


class Ellipsoid(NamedTuple):
    """Principal radii and axes of a manipulability ellipsoid."""

    radii: torch.Tensor  # (..., 3)
    axes: torch.Tensor  # (..., 3, 3), columns = principal directions


def manipulability_ellipsoid(model: RobotModel, q: torch.Tensor):
    """(linear, angular) manipulability ellipsoids: the singular values and
    left singular vectors of each 3 x n block of the space Jacobian."""
    J = jacobian(model, q)

    def ell(Jb):
        U, s, _ = torch.linalg.svd(Jb, full_matrices=False)
        return Ellipsoid(radii=s, axes=U)

    return ell(J[..., 3:, :]), ell(J[..., :3, :])


def manipulability_measure(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Yoshikawa's measure ``sqrt(det(J J^T))``, as the product of the
    singular values."""
    return torch.prod(torch.linalg.svdvals(_measure_jacobian(model, q)), dim=-1)


def monte_carlo_workspace(
    model: RobotModel, generator: torch.Generator, num_samples: int = 10000
) -> torch.Tensor:
    """(num_samples, 3) reachable end-effector positions from joint angles
    drawn uniformly within the limits (an unbounded joint draws from [-pi,
    pi]). ``generator`` lives on the model's device and takes the place of
    the JAX function's key."""
    lo = torch.where(torch.isfinite(model.joint_lower), model.joint_lower, torch.full_like(model.joint_lower, -math.pi))
    hi = torch.where(torch.isfinite(model.joint_upper), model.joint_upper, torch.full_like(model.joint_upper, math.pi))
    u = torch.rand((num_samples, model.num_joints), generator=generator, dtype=model.dtype, device=model.device)
    return forward_kinematics(model, lo + u * (hi - lo))[..., :3, 3]
