"""PyBullet world bridge: world setup, GUI controls, replay, contacts.

Counterpart of ``manipulapy_tpu/pybullet_bridge.py``, the same host-side
NumPy code over the port's :func:`~manipulapy_tpu_torch.sim.pybullet_available`.
Deepens the optional PyBullet side of :mod:`manipulapy_tpu_torch.sim` to full
capability parity with the reference's ``Simulation`` world layer
(``sim.py:225-581``): plane + robot ``loadURDF`` with self-collision
flags and per-pair collision filters, GUI joint sliders + reset button,
position control with torque-limit-derived forces, trajectory replay,
end-effector trails as *real capsule geometry* (visible to
``getCameraImage``, unlike debug lines — the reference makes the same
point, ``sim.py:171-172`` of its plot_trajectory docstring), self-
collision contact queries including the base link (``sim.py:889-913``),
and a manual slider-control loop (``sim.py:947``).

Everything here is optional-dependency-gated like the reference
(import-time soft failure, call-time ``ImportError`` — ``sim.py:84-97``);
the port's own plant in :class:`manipulapy_tpu_torch.sim.Simulation` never
needs it. The module accepts an injected ``pb_module`` for testing
against a fake client (the reference's conftest trick,
``tests/conftest.py:681-705``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .sim import pybullet_available

__all__ = ["PyBulletBridge"]


def _resolve_pb(pb_module):
    if pb_module is not None:
        return pb_module
    if not pybullet_available():
        raise ImportError(
            "PyBullet is not installed. Install the 'simulation' extra "
            "(pip install manipulapy-tpu[simulation]) for the visual bridge; "
            "the native simulator works without it."
        )
    import pybullet as p

    return p


class PyBulletBridge:
    """A PyBullet world mirroring the reference's simulation environment.

    Args:
        urdf_path: robot URDF to load.
        time_step: physics timestep.
        enable_self_collision: pass ``URDF_USE_SELF_COLLISION`` at load
            (reference ``sim.py:240-244``).
        disable_pairs: link-name pairs whose mutual collision should be
            filtered out (the reference's ACM adjacency exclusions).
        torque_limits: (n,) motor force caps for position control; the
            reference derives motor forces from its torque limits
            (``sim.py:361-399``).
        pb_module: injected pybullet-like module (tests).
    """

    def __init__(
        self,
        urdf_path: str,
        time_step: float = 1.0 / 240.0,
        enable_self_collision: bool = True,
        disable_pairs: Optional[Sequence[Tuple[str, str]]] = None,
        torque_limits: Optional[np.ndarray] = None,
        use_fixed_base: bool = True,
        load_plane: bool = True,
        pb_module=None,
    ):
        self._p = _resolve_pb(pb_module)
        self.urdf_path = str(urdf_path)
        self.time_step = float(time_step)
        self.enable_self_collision = bool(enable_self_collision)
        self._disable_pairs = list(disable_pairs or [])
        self.torque_limits = (
            np.asarray(torque_limits, dtype=np.float64) if torque_limits is not None else None
        )
        self.use_fixed_base = bool(use_fixed_base)
        self.load_plane = bool(load_plane)
        self.client = self._connect()
        self.plane_id: Optional[int] = None
        self.robot_id: Optional[int] = None
        self.non_fixed_joints: List[int] = []
        self.joint_sliders: Dict[int, int] = {}
        self.reset_button: Optional[int] = None
        self._reset_count = 0
        self._trail_bodies: List[int] = []
        self.setup_world()

    # -- connection / world ---------------------------------------------------

    def _connect(self) -> int:
        """GUI-with-DIRECT-fallback connect honoring
        ``MANIPULAPY_PYBULLET_CONNECT`` (reference ``sim.py:173-199``)."""
        p = self._p
        mode = os.getenv("MANIPULAPY_PYBULLET_CONNECT", "").strip().upper()
        if mode == "DIRECT":
            return p.connect(p.DIRECT)
        if mode == "GUI":
            return p.connect(p.GUI)
        try:
            client = p.connect(p.GUI)
            if client < 0:
                raise RuntimeError("GUI connect failed")
            return client
        except Exception:
            return p.connect(p.DIRECT)

    def setup_world(self) -> None:
        """Reset + plane + robot with self-collision flags and per-pair
        filters (reference ``sim.py:225-273``)."""
        p = self._p
        p.resetSimulation()
        p.setGravity(0, 0, -9.81)
        p.setTimeStep(self.time_step)
        if self.load_plane:
            try:
                import pybullet_data

                p.setAdditionalSearchPath(pybullet_data.getDataPath())
                self.plane_id = p.loadURDF("plane.urdf")
            except Exception:
                self.plane_id = None  # no bundled data in minimal installs

        flags = p.URDF_USE_SELF_COLLISION if self.enable_self_collision else 0
        self.robot_id = p.loadURDF(
            self.urdf_path, useFixedBase=self.use_fixed_base, flags=flags
        )
        num_joints = p.getNumJoints(self.robot_id)
        self.non_fixed_joints = [
            i for i in range(num_joints)
            if p.getJointInfo(self.robot_id, i)[2] != p.JOINT_FIXED
        ]
        if self.enable_self_collision and self._disable_pairs:
            link_name_to_idx = {}
            for i in range(num_joints):
                name = p.getJointInfo(self.robot_id, i)[12]
                if isinstance(name, bytes):
                    name = name.decode()
                link_name_to_idx[name] = i
            for a, b in self._disable_pairs:
                ia, ib = link_name_to_idx.get(a), link_name_to_idx.get(b)
                if ia is not None and ib is not None:
                    p.setCollisionFilterPair(self.robot_id, self.robot_id, ia, ib, 0)

    # -- GUI controls -----------------------------------------------------------

    def add_joint_sliders(self) -> None:
        """One debug slider per non-fixed joint (reference ``sim.py:335-359``)."""
        p = self._p
        for j in self.non_fixed_joints:
            info = p.getJointInfo(self.robot_id, j)
            name = info[1].decode() if isinstance(info[1], bytes) else str(info[1])
            lo, hi = float(info[8]), float(info[9])
            if not lo < hi:
                lo, hi = -np.pi, np.pi
            self.joint_sliders[j] = p.addUserDebugParameter(name, lo, hi, 0.0)

    def add_reset_button(self) -> None:
        p = self._p
        self.reset_button = p.addUserDebugParameter("Reset", 1, 0, 1)
        self._reset_count = int(p.readUserDebugParameter(self.reset_button))

    def read_sliders(self) -> np.ndarray:
        p = self._p
        return np.array(
            [p.readUserDebugParameter(s) for s in self.joint_sliders.values()]
        )

    def reset_pressed(self) -> bool:
        if self.reset_button is None:
            return False
        count = int(self._p.readUserDebugParameter(self.reset_button))
        pressed = count > self._reset_count
        self._reset_count = count
        return pressed

    # -- motion -----------------------------------------------------------------

    def _motor_forces(self) -> Optional[List[float]]:
        if self.torque_limits is None:
            return None
        lims = np.broadcast_to(
            np.abs(self.torque_limits), (len(self.non_fixed_joints),)
        )
        return [float(x) if np.isfinite(x) else 1e6 for x in lims]

    def set_joint_positions(self, q, use_motors: bool = True) -> None:
        """Position control with torque-limit forces (reference
        ``sim.py:361-399``); ``use_motors=False`` teleports via
        ``resetJointState``."""
        p = self._p
        q = np.asarray(q, dtype=np.float64)
        if use_motors:
            kwargs = dict(
                bodyUniqueId=self.robot_id,
                jointIndices=self.non_fixed_joints[: len(q)],
                controlMode=p.POSITION_CONTROL,
                targetPositions=[float(x) for x in q],
            )
            forces = self._motor_forces()
            if forces is not None:
                kwargs["forces"] = forces[: len(q)]
            p.setJointMotorControlArray(**kwargs)
        else:
            for j, val in zip(self.non_fixed_joints, q):
                p.resetJointState(self.robot_id, j, float(val))

    def get_joint_positions(self) -> np.ndarray:
        p = self._p
        return np.array(
            [p.getJointState(self.robot_id, j)[0] for j in self.non_fixed_joints]
        )

    def step(self) -> None:
        self._p.stepSimulation()

    def end_effector_position(self) -> np.ndarray:
        p = self._p
        last = max(self.non_fixed_joints) if self.non_fixed_joints else 0
        state = p.getLinkState(self.robot_id, last)
        return np.asarray(state[0], dtype=np.float64)

    def run_trajectory(
        self,
        joint_trajectory,
        real_time_factor: float = 0.0,
        draw_trail: bool = False,
    ) -> np.ndarray:
        """Replay a (N, n) trajectory through position control + physics
        stepping; returns the final EE position (reference
        ``sim.py:697-732``). ``real_time_factor > 0`` sleeps
        ``time_step / factor`` per waypoint like the reference."""
        traj = np.asarray(joint_trajectory, dtype=np.float64)
        ee_points = []
        for q in traj:
            self.set_joint_positions(q)
            self.step()
            ee_points.append(self.end_effector_position())
            if real_time_factor > 0:
                time.sleep(self.time_step / real_time_factor)
        if draw_trail and ee_points:
            self.plot_trajectory(np.asarray(ee_points))
        return ee_points[-1] if ee_points else np.zeros(3)

    # -- EE trail as real geometry (visible to getCameraImage) -------------------

    def _capsule_line(self, a, b, radius: float, rgba) -> Optional[int]:
        """Thin capsule from a to b (reference ``sim.py:411-494``): real
        collision-free geometry so the trail shows up in camera captures,
        which ``addUserDebugLine`` does not."""
        p = self._p
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        d = b - a
        length = float(np.linalg.norm(d))
        if length < 1e-9:
            return None
        mid = (a + b) / 2.0
        # PyBullet capsules align with +z; rotate z onto d.
        z = np.array([0.0, 0.0, 1.0])
        axis = np.cross(z, d / length)
        s = float(np.linalg.norm(axis))
        c = float(np.dot(z, d / length))
        if s < 1e-9:
            quat = [0.0, 0.0, 0.0, 1.0] if c > 0 else [1.0, 0.0, 0.0, 0.0]
        else:
            axis = axis / s
            half = np.arctan2(s, c) / 2.0
            quat = [*(axis * np.sin(half)), np.cos(half)]
        try:
            vis = p.createVisualShape(
                p.GEOM_CAPSULE, radius=radius, length=length, rgbaColor=list(rgba)
            )
            body = p.createMultiBody(
                baseMass=0,
                baseVisualShapeIndex=vis,
                basePosition=[float(x) for x in mid],
                baseOrientation=[float(x) for x in quat],
            )
            self._trail_bodies.append(body)
            return body
        except Exception:
            return None

    def plot_trajectory(
        self, points: np.ndarray, radius: float = 0.004, rgba=(0.9, 0.2, 0.2, 1.0)
    ) -> int:
        """Render an EE path as capsule segments; returns segment count."""
        pts = np.asarray(points, dtype=np.float64)
        count = 0
        for a, b in zip(pts[:-1], pts[1:]):
            if self._capsule_line(a, b, radius, rgba) is not None:
                count += 1
        return count

    def clear_trail(self) -> None:
        for body in self._trail_bodies:
            try:
                self._p.removeBody(body)
            except Exception:
                pass
        self._trail_bodies.clear()

    # -- queries ------------------------------------------------------------------

    def check_self_collision(self) -> Tuple[bool, List[Tuple[int, int]]]:
        """Contact-based self-collision query including the base link
        (reference ``sim.py:889-913``). Returns (colliding?, link pairs)."""
        p = self._p
        p.performCollisionDetection()
        contacts = p.getContactPoints(bodyA=self.robot_id, bodyB=self.robot_id)
        pairs = []
        for ct in contacts or ():
            link_a, link_b = ct[3], ct[4]
            if link_a != link_b:
                pairs.append((link_a, link_b))
        return bool(pairs), pairs

    # -- manual control --------------------------------------------------------------

    def manual_control_loop(self, steps: int = 0, home=None) -> None:
        """Slider-driven control loop (reference ``sim.py:947``): each
        tick reads the sliders, applies position control, steps physics,
        and honors the reset button. ``steps=0`` means run until the
        client disconnects."""
        if not self.joint_sliders:
            self.add_joint_sliders()
        if self.reset_button is None:
            self.add_reset_button()
        home = (
            np.zeros(len(self.non_fixed_joints))
            if home is None
            else np.asarray(home, dtype=np.float64)
        )
        i = 0
        while steps == 0 or i < steps:
            try:
                if self.reset_pressed():
                    self.set_joint_positions(home, use_motors=False)
                q = self.read_sliders()
                self.set_joint_positions(q)
                self.step()
            except Exception:
                break  # client disconnected
            i += 1

    def close(self) -> None:
        try:
            self._p.disconnect(self.client)
        except Exception:
            pass
