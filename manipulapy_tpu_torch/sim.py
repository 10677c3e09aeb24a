"""Simulation: the exact forward dynamics as the plant, PyBullet optional.

Counterpart of ``manipulapy_tpu/sim.py``. The port's own forward dynamics
(``dynamics.forward_dynamics_fast``) is the simulator, the same engine the
MPC layer plans with; PyBullet stays an optional visual replay client,
checked when it is asked for (an ``ImportError`` at call time, never at
import).

The plant's substep is its own, not the rollout kernel's step (K1): it
subtracts the viscous joint damping from the applied torque and clamps the
velocity to its limit before the position moves. ``Simulation`` keeps the
JAX class's vocabulary: ``run_trajectory``, ``run_controller``,
``set_joint_positions``, ``check_self_collision``, ``save_joint_states``
(CSV). Its state lives on the model's device; ``history`` holds host copies.
"""

from __future__ import annotations

import csv
import importlib.util
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .control import ControlState, computed_torque_control
from .core.lie import _matvec
from .dynamics import bias_forces, forward_dynamics_fast, mass_matrix
from .kinematics import forward_kinematics
from .models.robot import RobotModel
from .potential_field import LinkSpheres, check_self_collision, default_link_spheres

__all__ = ["Simulation", "pybullet_available"]


def pybullet_available() -> bool:
    return importlib.util.find_spec("pybullet") is not None


def _check_pybullet():
    """Call-time guard: the simulator itself needs no PyBullet."""
    if not pybullet_available():
        raise ImportError(
            "PyBullet is not installed. The native simulator does not need "
            "it; install pybullet only for visual replay (`use_pybullet=True`)."
        )


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, lo), hi)  # jnp.clip's order


class Simulation:
    """Manipulator simulation driven by the exact dynamics.

    Args:
        model: robot model (the plant); the state lives on its device.
        dt: integration step.
        g: gravity vector.
        substeps: semi-implicit Euler substeps per ``dt``.
        joint_damping: viscous joint damping applied by the plant.
        spheres: collision geometry for self-collision queries.
        use_pybullet: attach a PyBullet GUI/DIRECT client for visual
            replay (optional extra; raises at call time if absent).
    """

    def __init__(
        self,
        model: RobotModel,
        dt: float = 0.01,
        g=(0.0, 0.0, -9.81),
        substeps: int = 4,
        joint_damping: float = 0.0,
        spheres: Optional[LinkSpheres] = None,
        use_pybullet: bool = False,
    ):
        self.model = model
        self.dt = float(dt)
        self.g = torch.as_tensor(g, dtype=model.dtype, device=model.device)
        self.substeps = int(substeps)
        self.joint_damping = float(joint_damping)
        self.spheres = spheres or default_link_spheres(model)
        self.q = self._zeros()
        self.dq = self._zeros()
        self.time = 0.0
        self.history: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._step_fn = self._build_step()

        self._pb = None
        if use_pybullet:
            _check_pybullet()
            import pybullet as p

            try:
                self._pb_client = p.connect(p.GUI)
            except Exception:
                self._pb_client = p.connect(p.DIRECT)
            self._pb = p

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.model.num_joints, dtype=self.model.dtype, device=self.model.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.model.dtype, device=self.model.device)

    def _build_step(self) -> Callable:
        model, g, damping = self.model, self.g, self.joint_damping
        sub_dt = self.dt / self.substeps
        v_lim = model.velocity_limit

        def step(q, dq, tau):
            for _ in range(self.substeps):
                tau_eff = tau - damping * dq
                ddq = forward_dynamics_fast(model, q, dq, tau_eff, g)
                dq = _clip(dq + ddq * sub_dt, -v_lim, v_lim)
                q = _clip(q + dq * sub_dt, model.joint_lower, model.joint_upper)
            return q, dq

        return step

    # -- state management ----------------------------------------------------

    def reset(self, q=None, dq=None) -> None:
        self.q = self._tensor(q) if q is not None else self._zeros()
        self.dq = self._tensor(dq) if dq is not None else self._zeros()
        self.time = 0.0
        self.history.clear()

    def set_joint_positions(self, q) -> None:
        """Teleport to a configuration (clamped to the limits), at rest."""
        self.q = _clip(self._tensor(q), self.model.joint_lower, self.model.joint_upper)
        self.dq = torch.zeros_like(self.q)

    def get_joint_positions(self) -> np.ndarray:
        return self.q.cpu().numpy()

    def end_effector_pose(self) -> np.ndarray:
        return forward_kinematics(self.model, self.q).cpu().numpy()

    # -- stepping ------------------------------------------------------------

    def step(self, tau) -> None:
        """Advance one ``dt`` under applied torques (clamped to the limits)."""
        lim = self.model.torque_limit
        tau = _clip(self._tensor(tau), -lim, lim)
        self.q, self.dq = self._step_fn(self.q, self.dq, tau)
        self.time += self.dt
        self.history.append((self.time, self.q.cpu().numpy(), self.dq.cpu().numpy()))

    def run_trajectory(
        self,
        joint_trajectory,
        settle_steps: int = 100,
        Kp: float = 100.0,
        Kd: float = 20.0,
    ) -> np.ndarray:
        """Replay a (N, n) joint trajectory with mass-scaled PD tracking
        (closed loop ``q'' = Kp e - Kd dq`` whatever the inertia), then hold
        the last waypoint for ``settle_steps``; returns the final EE
        position."""
        traj = joint_trajectory.cpu().numpy() if isinstance(joint_trajectory, torch.Tensor) else np.asarray(joint_trajectory)
        waypoints = list(traj) + [traj[-1]] * settle_steps
        for q_des in waypoints:
            q_des_t = self._tensor(q_des)
            M = mass_matrix(self.model, self.q)
            tau = _matvec(M, Kp * (q_des_t - self.q) - Kd * self.dq) + bias_forces(
                self.model, self.q, self.dq, self.g
            )
            self.step(tau)
            if self._pb is not None:
                self._pb_sync()
        return self.end_effector_pose()[:3, 3]

    def run_controller(
        self,
        thetalistd,
        dthetalistd,
        ddthetalistd,
        Kp=100.0,
        Ki=1.0,
        Kd=20.0,
    ) -> np.ndarray:
        """Closed-loop computed-torque tracking of a desired trajectory
        ((N, n) arrays or tensors). Returns the (N, n) achieved positions."""
        qd_all, dqd_all, ddqd_all = (self._tensor(x) for x in (thetalistd, dthetalistd, ddthetalistd))
        state = ControlState.zero(self.model.num_joints, dtype=self.model.dtype, device=self.model.device)
        achieved = []
        for qd, dqd, ddqd in zip(qd_all, dqd_all, ddqd_all):
            tau, state = computed_torque_control(
                self.model, qd, dqd, ddqd, self.q, self.dq, self.g, self.dt, Kp, Ki, Kd, state
            )
            self.step(tau)
            achieved.append(self.history[-1][1])
        return np.stack(achieved)

    # -- queries -------------------------------------------------------------

    def check_self_collision(self) -> Tuple[bool, float]:
        """(colliding?, min clearance) at the current state."""
        colliding, min_c = check_self_collision(self.model, self.q, self.spheres)
        # A short chain can have no checkable (non-adjacent) pairs; report a
        # large finite clearance rather than +inf so callers can do math on it.
        return bool(colliding), float(min(float(min_c), 1e3))

    def save_joint_states(self, path: str) -> None:
        """CSV export of the state history."""
        n = self.model.num_joints
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["time"] + [f"q{i}" for i in range(n)] + [f"dq{i}" for i in range(n)])
            for t, q, dq in self.history:
                writer.writerow([t] + list(q) + list(dq))

    # -- optional PyBullet mirroring ----------------------------------------

    def attach_pybullet_body(self, body_id: int, joint_indices: Sequence[int]) -> None:
        """Mirror the native state onto a loaded PyBullet body."""
        _check_pybullet()
        self._pb_body = body_id
        self._pb_joints = list(joint_indices)

    def _pb_sync(self) -> None:
        if self._pb is None or not hasattr(self, "_pb_body"):
            return
        for idx, val in zip(self._pb_joints, self.q.cpu().numpy()):
            self._pb.resetJointState(self._pb_body, idx, float(val))

    def close(self) -> None:
        if self._pb is not None:
            self._pb.disconnect(self._pb_client)
            self._pb = None
