"""Potential fields and sphere-based collision checking on tensors.

Counterpart of ``manipulapy_tpu/potential_field.py``:

* joint-space attractive and repulsive potentials and their analytic
  gradient, as plain functions that batch over leading dimensions;
* :func:`cartesian_potential_field`, the fused Cartesian potential and
  gradient over obstacle points. A float32 call on a CUDA device with no
  input requiring grad goes to the hand-written kernel K10
  (``ops/elementwise.py``); every other call takes the tensor formulation;
* link-sphere collision geometry (:class:`LinkSpheres`), differentiable
  clearances (:func:`self_collision_distances`, :func:`obstacle_clearance`)
  and the waypoint-nudging avoidance pass
  (:func:`apply_collision_avoidance`);
* the :class:`PotentialField` facade and :func:`build_link_adjacency`.

Every function takes configurations ``q`` of shape (..., n). The minima are
``torch.amin`` and ``torch.minimum``, whose gradients split evenly among
ties, as ``jnp.min``'s and ``jnp.minimum``'s do. The URDF-geometry
``CollisionChecker`` of the JAX package comes with the port's ``urdf/``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kinematics import clip_to_limits, com_transforms
from .models.robot import RobotModel
from .ops import dispatch

__all__ = [
    "attractive_potential",
    "repulsive_potential",
    "potential_gradient",
    "cartesian_potential_field",
    "PotentialField",
    "build_link_adjacency",
    "LinkSpheres",
    "default_link_spheres",
    "link_positions",
    "self_collision_distances",
    "check_self_collision",
    "obstacle_clearance",
    "apply_collision_avoidance",
]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def attractive_potential(q: torch.Tensor, q_goal: torch.Tensor, k_att: float = 1.0) -> torch.Tensor:
    """``U_att = 1/2 k ||q - q_goal||^2``."""
    d = q - q_goal
    return 0.5 * k_att * torch.sum(d * d, dim=-1)


def repulsive_potential(
    q: torch.Tensor, obstacles: torch.Tensor, k_rep: float = 1.0, d0: float = 0.5
) -> torch.Tensor:
    """``U_rep = 20 k sum_i (1/d_i - 1/d0)^2`` over the (O, n) obstacles
    inside the influence distance ``d0``."""
    d = _norm(q[..., None, :] - obstacles)  # (..., O)
    d_safe = torch.clamp(d, min=1e-9)
    term = (1.0 / d_safe - 1.0 / d0) ** 2
    return 20.0 * k_rep * torch.sum(torch.where(d < d0, term, torch.zeros_like(term)), dim=-1)


def potential_gradient(
    q: torch.Tensor,
    q_goal: torch.Tensor,
    obstacles: Optional[torch.Tensor] = None,
    k_att: float = 1.0,
    k_rep: float = 1.0,
    d0: float = 0.5,
) -> torch.Tensor:
    """Analytic gradient of the total potential: attractive ``k (q -
    q_goal)`` plus the repulsive term that pushes away from each obstacle
    inside ``d0``; at exact overlap the escape direction is fixed (-1 along
    the first coordinate)."""
    grad = k_att * (q - q_goal)
    if obstacles is not None and obstacles.shape[-2] > 0:
        diff = q[..., None, :] - obstacles  # (..., O, n)
        d = _norm(diff)  # (..., O)
        d_safe = torch.clamp(d, min=1e-9)
        # dU/dq = -40 k (1/d - 1/d0) (1/d^2) (diff/d)
        coeff = -40.0 * k_rep * (1.0 / d_safe - 1.0 / d0) / (d_safe * d_safe)
        push = coeff[..., None] * (diff / d_safe[..., None])
        escape = torch.zeros_like(diff)
        escape[..., 0] = -1.0
        push = torch.where((d < 1e-9)[..., None], escape, push)
        grad = grad + torch.sum(torch.where((d < d0)[..., None], push, torch.zeros_like(push)), dim=-2)
    return grad


def cartesian_potential_field(
    positions: torch.Tensor,
    goal: torch.Tensor,
    obstacles: torch.Tensor,
    influence_distance: float = 0.5,
):
    """3D potential and gradient over a batch of Cartesian points:
    attractive ``1/2 ||p - goal||^2``, repulsive ``1/2 (1/d - 1/d0)^2``
    summed over the obstacles within ``influence_distance``.

    Args:
        positions: (..., 3) query points.
        goal: (3,) attractor.
        obstacles: (O, 3) repulsors; O may be 0.

    Returns:
        (potential, gradient): shapes (...,) and (..., 3).
    """
    goal = torch.as_tensor(goal, dtype=positions.dtype, device=positions.device)
    obstacles = torch.as_tensor(obstacles, dtype=positions.dtype, device=positions.device)
    needs_grad = any(x.requires_grad for x in (positions, goal, obstacles))
    if dispatch.elementwise_kind(positions.device, positions.dtype, needs_grad) == "cuda":
        from .ops.elementwise import cartesian_potential_kernel

        batch = positions.shape[:-1]
        U, grad = cartesian_potential_kernel(
            positions.reshape(-1, 3).contiguous(), goal.contiguous(), obstacles.contiguous(), influence_distance
        )
        return U.reshape(batch), grad.reshape(batch + (3,))
    return _cartesian_potential_field_generic(positions, goal, obstacles, influence_distance)


def _cartesian_potential_field_generic(positions, goal, obstacles, influence_distance):
    """The tensor formulation over (..., O, 3) intermediates: any dtype and
    device, autograd."""
    dp = positions - goal
    U = 0.5 * torch.sum(dp * dp, dim=-1)
    grad = dp

    diff = positions[..., None, :] - obstacles  # (..., O, 3)
    d = _norm(diff)
    d_safe = torch.clamp(d, min=1e-9)
    inside = d < influence_distance
    inv_d = 1.0 / d_safe
    inv_d0 = 1.0 / influence_distance
    U_rep = 0.5 * (inv_d - inv_d0) ** 2
    U = U + torch.sum(torch.where(inside, U_rep, torch.zeros_like(U_rep)), dim=-1)
    coeff = -(inv_d - inv_d0) * inv_d * inv_d
    g_rep = coeff[..., None] * (diff * inv_d[..., None])
    grad = grad + torch.sum(torch.where(inside[..., None], g_rep, torch.zeros_like(g_rep)), dim=-2)
    return U, grad


# -- Collision checking ------------------------------------------------------


class LinkSpheres(NamedTuple):
    """Sphere approximation of the robot's collision geometry: one sphere
    per link, centred at the link's CoM. ``allowed`` is the (n, n)
    allowed-collision matrix: for a serial chain a link may touch itself,
    its parent and child, and its grandparent and grandchild."""

    radii: torch.Tensor  # (n,)
    allowed: torch.Tensor  # (n, n) bool


def default_link_spheres(model: RobotModel, radius: float = 0.08) -> LinkSpheres:
    n = model.num_joints
    idx = torch.arange(n, device=model.device)
    allowed = (idx[:, None] - idx[None, :]).abs() <= 2
    return LinkSpheres(radii=torch.full((n,), radius, dtype=model.dtype, device=model.device), allowed=allowed)


def link_positions(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """World positions of every link CoM: (..., n) -> (..., n, 3)."""
    return com_transforms(model, q)[..., :3, 3]


def self_collision_distances(model: RobotModel, q: torch.Tensor, spheres: LinkSpheres) -> torch.Tensor:
    """Pairwise signed clearances between link spheres, (..., n, n);
    allowed pairs are +inf, a negative entry is a collision. The 1e-9
    offset keeps the gradient finite on the diagonal (a zero offset)."""
    p = link_positions(model, q)
    d = _norm(p[..., :, None, :] - p[..., None, :, :] + 1e-9)
    clearance = d - (spheres.radii[:, None] + spheres.radii[None, :])
    return torch.where(spheres.allowed, torch.full_like(clearance, float("inf")), clearance)


def check_self_collision(model: RobotModel, q: torch.Tensor, spheres: LinkSpheres):
    """(colliding?, smallest clearance), each of shape (...)."""
    min_c = torch.amin(self_collision_distances(model, q, spheres), dim=(-2, -1))
    return min_c < 0.0, min_c


def obstacle_clearance(
    model: RobotModel, q: torch.Tensor, spheres: LinkSpheres, obstacle_points: torch.Tensor
) -> torch.Tensor:
    """Clearance from each link sphere to the nearest of the (O, 3) world
    points: (..., n). The 1e-9 offset is part of the function: where a link
    centre lies on a point, the plain norm has a NaN gradient; with the
    offset it is a finite unit direction that pushes the link off."""
    p = link_positions(model, q)
    d = _norm(p[..., :, None, :] - obstacle_points + 1e-9)  # (..., n, O)
    return torch.amin(d, dim=-1) - spheres.radii


def apply_collision_avoidance(
    model: RobotModel,
    trajectory: torch.Tensor,
    q_goal: torch.Tensor,
    spheres: LinkSpheres,
    obstacle_points: torch.Tensor,
    *,
    step_size: float = 0.01,
    max_steps: int = 100,
    clearance_margin: float = 0.0,
) -> torch.Tensor:
    """Gradient-descent waypoint nudging: every (..., n) waypoint that is
    closer to the obstacle points than ``clearance_margin`` descends ``sum
    min(clearance - margin, 0)^2 + 1e-3 ||q - q_goal||^2`` with step
    ``step_size`` for up to ``max_steps`` steps, and stops (masked, per
    waypoint) once clear. All waypoints advance together, a fixed number of
    steps with nothing read back to the host in between. The result carries
    no autograd graph."""
    q = trajectory.detach()
    for _ in range(max_steps):
        with torch.enable_grad():
            q_var = q.detach().requires_grad_(True)
            clear = obstacle_clearance(model, q_var, spheres, obstacle_points)
            viol = torch.minimum(clear - clearance_margin, torch.zeros_like(clear))
            # Waypoints are independent, so the gradient of the summed cost
            # is each waypoint's own.
            cost = torch.sum(viol * viol) + 1e-3 * torch.sum((q_var - q_goal) ** 2)
            (grad,) = torch.autograd.grad(cost, q_var)
        done = torch.amin(clear.detach(), dim=-1) >= clearance_margin
        q_new = clip_to_limits(model, q - step_size * grad)
        q = torch.where(done[..., None], q, q_new)
    return q


# -- Class facade ------------------------------------------------------------


class PotentialField:
    """Stateful facade over the joint-space potential functions, holding the
    two gains and the influence distance."""

    def __init__(
        self,
        attractive_gain: float = 1.0,
        repulsive_gain: float = 1.0,
        influence_distance: float = 0.5,
    ):
        self.attractive_gain = float(attractive_gain)
        self.repulsive_gain = float(repulsive_gain)
        self.influence_distance = float(influence_distance)

    def compute_attractive_potential(self, q, q_goal):
        q = torch.as_tensor(q).reshape(-1)
        return attractive_potential(q, torch.as_tensor(q_goal).to(q).reshape(-1), self.attractive_gain)

    def compute_repulsive_potential(self, q, obstacles):
        q = torch.as_tensor(q).reshape(-1)
        obstacles = torch.atleast_2d(torch.as_tensor(obstacles).to(q))
        return repulsive_potential(q, obstacles, self.repulsive_gain, self.influence_distance)

    def compute_gradient(self, q, q_goal, obstacles=None):
        q = torch.as_tensor(q).reshape(-1)
        obs = None if obstacles is None else torch.atleast_2d(torch.as_tensor(obstacles).to(q))
        return potential_gradient(
            q,
            torch.as_tensor(q_goal).to(q).reshape(-1),
            obs,
            self.attractive_gain,
            self.repulsive_gain,
            self.influence_distance,
        )


def build_link_adjacency(urdf) -> dict:
    """Allowed-collision sets from a robot description's connectivity: each
    link may touch itself, its parent and children, and its grandparent and
    grandchildren. ``urdf`` needs ``.links`` (each with ``.name``) and
    ``.joints`` (each with ``.parent`` and ``.child``).

    Returns ``{link_name: set_of_allowed_link_names}``.
    """
    allowed = {link.name: {link.name} for link in urdf.links}
    parent_of = {}
    for j in urdf.joints:
        if j.parent and j.child:
            parent_of[j.child] = j.parent
            allowed[j.parent].add(j.child)
            allowed[j.child].add(j.parent)
    for child, parent in parent_of.items():
        grand = parent_of.get(parent)
        if grand is not None:
            allowed[child].add(grand)
            allowed[grand].add(child)
    return allowed
