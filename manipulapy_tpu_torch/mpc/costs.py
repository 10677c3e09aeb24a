"""Cost library for the MPC solvers.

Counterpart of ``manipulapy_tpu/mpc/costs.py``: joint-space quadratic
tracking, a task-space pose cost through the SE(3) log, a hinge-squared
obstacle cost over link spheres (``potential_field.obstacle_clearance``),
and the (running, terminal) pair of the tracking solvers, whose
``extra_cost`` hook takes the obstacle cost. Every cost is a plain function
of one state ``x = [q; dq]`` (2n,), one control ``u`` (n,) and the time
index ``t``, differentiable with ``torch.func``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import lie
from ..kinematics import forward_kinematics
from ..models.robot import RobotModel
from ..potential_field import LinkSpheres, obstacle_clearance

__all__ = ["quadratic_tracking_cost", "pose_tracking_cost", "obstacle_cost", "make_tracking_costs"]


def quadratic_tracking_cost(x_ref: torch.Tensor, w_q: float = 1.0, w_dq: float = 0.1, w_u: float = 1e-4):
    """Running cost ``l(x, u, t)`` tracking a (H+1, 2n) state reference,
    or a single (2n,) goal state (broadcast over t)."""
    x_ref = torch.as_tensor(x_ref)

    def cost(x, u, t):
        ref = x_ref if x_ref.dim() == 1 else x_ref[t]
        n = x.shape[-1] // 2
        err = x - ref
        return w_q * torch.sum(err[:n] ** 2) + w_dq * torch.sum(err[n:] ** 2) + w_u * torch.sum(u**2)

    return cost


def pose_tracking_cost(
    model: RobotModel,
    T_goal: torch.Tensor,
    w_pos: float = 100.0,
    w_rot: float = 10.0,
    w_dq: float = 0.01,
    w_u: float = 1e-5,
):
    """Task-space running cost: the squared SE(3) log error of the
    end-effector pose, through FK and the log map."""

    def cost(x, u, t):
        n = x.shape[-1] // 2
        T = forward_kinematics(model, x[:n])
        err = lie.se3_log(lie.trans_inv(T_goal) @ T)
        return (
            w_rot * torch.sum(err[:3] ** 2)
            + w_pos * torch.sum(err[3:] ** 2)
            + w_dq * torch.sum(x[n:] ** 2)
            + w_u * torch.sum(u**2)
        )

    return cost


def obstacle_cost(
    model: RobotModel,
    spheres: LinkSpheres,
    obstacle_points: torch.Tensor,
    weight: float = 100.0,
    margin: float = 0.05,
):
    """Hinge-squared clearance penalty of the link spheres against (O, 3)
    obstacle points: ``weight * sum_k min(clearance_k - margin, 0)^2``."""

    def cost(x, u, t):
        clear = obstacle_clearance(model, x[: model.num_joints], spheres, obstacle_points)
        viol = torch.minimum(clear - margin, torch.zeros_like(clear))
        return weight * torch.sum(viol * viol)

    return cost


def make_tracking_costs(
    model: RobotModel,
    q_goal: torch.Tensor,
    w_q: float = 10.0,
    w_dq: float = 0.5,
    w_u: float = 1e-4,
    w_terminal: float = 100.0,
    extra_cost: Optional[Callable] = None,
):
    """(running, terminal) cost pair steering to a joint-space goal at
    rest, the setup of the fused tracking solvers."""
    q_goal = torch.as_tensor(q_goal)
    x_goal = torch.cat([q_goal, torch.zeros_like(q_goal)])
    base = quadratic_tracking_cost(x_goal, w_q, w_dq, w_u)

    def running(x, u, t):
        c = base(x, u, t)
        if extra_cost is not None:
            c = c + extra_cost(x, u, t)
        return c

    def terminal(x):
        n = q_goal.shape[-1]
        err = x - x_goal
        return w_terminal * (torch.sum(err[:n] ** 2) + 0.1 * torch.sum(err[n:] ** 2))

    return running, terminal
