"""Stateful planning facade over the trajectory and dynamics functions.

Counterpart of ``manipulapy_tpu/planner.py``: a convenient stateful API
bound to one robot, the collision-avoidance pass after a joint trajectory,
``plan_trajectory`` waypoint planning, and per-operation timing statistics
(first call against the later ones: on the card a first call pays for the
kernels' builds, as JAX's pays for the compile). Inputs are converted to
the model's dtype and device, so the planner runs where its model lives.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from . import trajectory as traj
from .models.robot import RobotModel
from .potential_field import (
    LinkSpheres,
    apply_collision_avoidance,
    check_self_collision,
    default_link_spheres,
    potential_gradient,
)

__all__ = ["TrajectoryPlanner", "create_planner"]


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    return found


class TrajectoryPlanner:
    """Stateful planner bound to one robot model.

    Args:
        model: robot model.
        spheres: collision geometry for the avoidance pass (defaults to
            per-link CoM spheres).
        obstacle_points: (O, 3) world points treated as obstacles by the
            collision-avoidance pass.
    """

    def __init__(
        self,
        model: RobotModel,
        spheres: Optional[LinkSpheres] = None,
        obstacle_points=None,
    ):
        self.model = model
        self.spheres = spheres or default_link_spheres(model)
        self.obstacle_points = None if obstacle_points is None else self._tensor(obstacle_points)
        self.performance_stats: Dict[str, object] = {
            "calls": 0,
            "total_time": 0.0,
            "compile_time": 0.0,  # the first call of each operation
            "steady_time": 0.0,
            "steady_calls": 0,
            "per_op": {},
        }

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.model.dtype, device=self.model.device)

    # -- bookkeeping -----------------------------------------------------------

    def _timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and book its host time, waiting for the CUDA devices
        its outputs lie on (PyTorch returns before the device finishes)."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for device in _cuda_devices(out, set()):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        stats = self.performance_stats
        stats["calls"] += 1
        stats["total_time"] += dt
        op = stats["per_op"].setdefault(name, {"calls": 0, "time": 0.0, "first_time": None})
        if op["first_time"] is None:
            op["first_time"] = dt
            stats["compile_time"] += dt
        else:
            stats["steady_time"] += dt
            stats["steady_calls"] += 1
        op["calls"] += 1
        op["time"] += dt
        return out

    def get_performance_stats(self) -> Dict[str, object]:
        """The statistics with derived averages; ``compile_amortization`` is
        the first calls' time over the average later call's."""
        s = dict(self.performance_stats)
        s["avg_time"] = s["total_time"] / max(s["calls"], 1)
        s["avg_steady_time"] = s["steady_time"] / max(s["steady_calls"], 1)
        s["compile_amortization"] = (
            s["compile_time"] / s["avg_steady_time"] if s["steady_calls"] else float("inf")
        )
        return s

    def reset_performance_stats(self) -> None:
        self.__init__(self.model, self.spheres, self.obstacle_points)

    # -- trajectory API ----------------------------------------------------------

    def joint_trajectory(
        self,
        theta_start,
        theta_end,
        Tf: float,
        N: int,
        method: int = 5,
        avoid_collisions: bool = False,
        avoidance_steps: int = 100,
        avoidance_step_size: float = 0.01,
        clearance_margin: float = 0.0,
    ) -> traj.Trajectory:
        theta_end = self._tensor(theta_end)
        out = self._timed(
            "joint_trajectory", traj.joint_trajectory, self.model, self._tensor(theta_start), theta_end, Tf, N, method
        )
        if avoid_collisions and self.obstacle_points is not None:
            fixed = self._timed(
                "collision_avoidance",
                apply_collision_avoidance,
                self.model,
                out.position,
                theta_end,
                self.spheres,
                self.obstacle_points,
                max_steps=avoidance_steps,
                step_size=avoidance_step_size,
                clearance_margin=clearance_margin,
            )
            out = traj.Trajectory(fixed, out.velocity, out.acceleration)
        return out

    def batch_joint_trajectory(self, theta_start, theta_end, Tf, N, method: int = 5):
        return self._timed(
            "batch_joint_trajectory",
            traj.batch_joint_trajectory,
            self.model,
            self._tensor(theta_start),
            self._tensor(theta_end),
            Tf,
            N,
            method,
        )

    def cartesian_trajectory(self, X_start, X_end, Tf, N, method: int = 5):
        return self._timed(
            "cartesian_trajectory", traj.cartesian_trajectory, self._tensor(X_start), self._tensor(X_end), Tf, N, method
        )

    def inverse_dynamics_trajectory(self, thetamat, dthetamat, ddthetamat, g=None, Ftip=None):
        return self._timed(
            "inverse_dynamics_trajectory",
            traj.inverse_dynamics_trajectory,
            self.model,
            self._tensor(thetamat),
            self._tensor(dthetamat),
            self._tensor(ddthetamat),
            g,
            Ftip,
        )

    def forward_dynamics_trajectory(
        self, thetalist, dthetalist, taumat, g=None, Ftipmat=None, dt=0.01, intRes: int = 1
    ):
        """The rollout, through ``trajectory.forward_dynamics_trajectory`` and
        its engine cache: the CUDA kernel for float32 (B, n) states on the
        card."""
        return self._timed(
            "forward_dynamics_trajectory",
            traj.forward_dynamics_trajectory,
            self.model,
            self._tensor(thetalist).contiguous(),
            self._tensor(dthetalist).contiguous(),
            self._tensor(taumat).contiguous(),
            g,
            Ftipmat,
            dt,
            intRes,
        )

    # -- waypoint planning ---------------------------------------------------------

    def plan_trajectory(
        self,
        q_start,
        q_goal,
        num_waypoints: int = 5,
        obstacle_points=None,
        descent_steps: int = 100,
        step_size: float = 0.01,
    ) -> torch.Tensor:
        """Linear waypoint interpolation, then potential-field nudging: with
        obstacle points (given here or at construction) every waypoint
        takes the collision-avoidance pass; without, each interior waypoint
        takes one descent step of the joint-space potential toward the
        goal. The endpoints stay pinned. Returns (num_waypoints, n)."""
        if num_waypoints < 2:
            raise ValueError(f"num_waypoints must be at least 2, got {num_waypoints}")
        q_start, q_goal = self._tensor(q_start), self._tensor(q_goal)
        frac = torch.linspace(0.0, 1.0, num_waypoints, dtype=q_start.dtype, device=q_start.device)
        waypoints = q_start + frac[:, None] * (q_goal - q_start)
        obstacles = self._tensor(obstacle_points) if obstacle_points is not None else self.obstacle_points
        if obstacles is not None:
            waypoints = self._timed(
                "plan_trajectory_avoidance",
                apply_collision_avoidance,
                self.model,
                waypoints,
                q_goal,
                self.spheres,
                obstacles,
                step_size=step_size,
                max_steps=descent_steps,
            )
        else:
            interior = waypoints[1:-1]
            waypoints = torch.cat(
                [waypoints[:1], interior - step_size * potential_gradient(interior, q_goal), waypoints[-1:]]
            )
        return torch.cat([q_start[None], waypoints[1:-1], q_goal[None]])

    # -- queries ------------------------------------------------------------------

    def check_self_collision(self, q):
        colliding, min_c = check_self_collision(self.model, self._tensor(q), self.spheres)
        return bool(colliding), float(min_c)


def create_planner(
    model: RobotModel,
    obstacle_points=None,
    sphere_radius: float = 0.08,
) -> TrajectoryPlanner:
    """A planner with per-link spheres of ``sphere_radius``."""
    return TrajectoryPlanner(
        model,
        spheres=default_link_spheres(model, radius=sphere_radius),
        obstacle_points=obstacle_points,
    )
