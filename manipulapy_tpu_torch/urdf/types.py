"""URDF data model: plain dataclasses for links, joints, and geometry.

Counterpart of ``manipulapy_tpu/urdf/types.py``, the same NumPy code.
Capability parity with the reference's ``ManipulaPy/urdf/types.py`` (851
LoC of dataclasses). These are *host-side* structures — parsing and model
assembly happen in NumPy on CPU once, producing an immutable
:class:`~manipulapy_tpu_torch.models.RobotModel` of tensors for the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "JointType",
    "Origin",
    "Inertial",
    "Geometry",
    "Box",
    "Cylinder",
    "Sphere",
    "Mesh",
    "Collision",
    "Visual",
    "Link",
    "JointLimit",
    "JointDynamics",
    "JointMimic",
    "SafetyController",
    "JointCalibration",
    "Actuator",
    "TransmissionJoint",
    "Transmission",
    "Joint",
]


class JointType(Enum):
    REVOLUTE = "revolute"
    CONTINUOUS = "continuous"
    PRISMATIC = "prismatic"
    FIXED = "fixed"
    FLOATING = "floating"
    PLANAR = "planar"


def _quat_to_rotation(q: np.ndarray) -> np.ndarray:
    """[qx, qy, qz, qw] -> 3x3 rotation; normalized, identity for ~zero
    quaternions (reference ``urdf/types.py:714-748``)."""
    qx, qy, qz, qw = (float(x) for x in q)
    norm = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if norm < 1e-10:
        return np.eye(3)
    qx, qy, qz, qw = qx / norm, qy / norm, qz / norm, qw / norm
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis RPY -> 3x3 rotation (Rz(y) Ry(p) Rx(r))."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


@dataclass
class Origin:
    """<origin xyz rpy> element (reference ``urdf/types.py:82-180``)."""

    xyz: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rpy: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def __post_init__(self):
        self.xyz = np.asarray(self.xyz, dtype=np.float64).reshape(3)
        self.rpy = np.asarray(self.rpy, dtype=np.float64).reshape(3)

    @property
    def matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = _rpy_matrix(self.rpy)
        T[:3, 3] = self.xyz
        return T


@dataclass
class Inertial:
    """<inertial> element: mass, CoM origin, 3x3 inertia about the CoM.

    ``spatial_inertia`` reproduces the reference's contract exactly
    (``urdf/types.py:203-239``): the rotational block is the CoM inertia
    parallel-axis-shifted to the link origin (NO rotation applied — a
    documented reference quirk kept for output parity), the translational
    block is ``m I``. ``spatial_inertia_at_com`` gives the unshifted form.
    """

    mass: float = 0.0
    origin: Origin = field(default_factory=Origin)
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))

    def __post_init__(self):
        self.inertia = np.asarray(self.inertia, dtype=np.float64).reshape(3, 3)

    @property
    def spatial_inertia(self) -> np.ndarray:
        G = np.zeros((6, 6))
        r = self.origin.xyz
        if np.linalg.norm(r) < 1e-10:
            G[:3, :3] = self.inertia
        else:
            G[:3, :3] = self.inertia + self.mass * (float(r @ r) * np.eye(3) - np.outer(r, r))
        G[3:, 3:] = self.mass * np.eye(3)
        return G

    @property
    def spatial_inertia_at_com(self) -> np.ndarray:
        G = np.zeros((6, 6))
        G[:3, :3] = self.inertia
        G[3:, 3:] = self.mass * np.eye(3)
        return G


@dataclass
class Box:
    size: np.ndarray = field(default_factory=lambda: np.ones(3))


@dataclass
class Cylinder:
    radius: float = 0.0
    length: float = 0.0


@dataclass
class Sphere:
    radius: float = 0.0


@dataclass
class Mesh:
    filename: str = ""
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))


Geometry = object  # union of Box | Cylinder | Sphere | Mesh


@dataclass
class Collision:
    origin: Origin = field(default_factory=Origin)
    geometry: Optional[Geometry] = None


@dataclass
class Visual:
    origin: Origin = field(default_factory=Origin)
    geometry: Optional[Geometry] = None
    material: Optional[str] = None


@dataclass
class Link:
    name: str = ""
    inertial: Optional[Inertial] = None
    visuals: List[Visual] = field(default_factory=list)
    collisions: List[Collision] = field(default_factory=list)

    def bounding_radius(self, default: float = 0.08) -> float:
        """Conservative sphere radius from the collision (preferred) or
        visual geometry — feeds the sphere-based collision checker."""
        geoms = [c.geometry for c in self.collisions] or [v.geometry for v in self.visuals]
        radius = 0.0
        for g in geoms:
            if isinstance(g, Sphere):
                radius = max(radius, g.radius)
            elif isinstance(g, Cylinder):
                radius = max(radius, float(np.hypot(g.radius, g.length / 2)))
            elif isinstance(g, Box):
                radius = max(radius, float(np.linalg.norm(g.size) / 2))
        return radius or default


@dataclass
class JointLimit:
    lower: Optional[float] = None
    upper: Optional[float] = None
    effort: Optional[float] = None
    velocity: Optional[float] = None


@dataclass
class JointDynamics:
    damping: float = 0.0
    friction: float = 0.0


@dataclass
class JointMimic:
    joint: str = ""
    multiplier: float = 1.0
    offset: float = 0.0


@dataclass
class SafetyController:
    """<safety_controller> element: soft position limits and the
    position/velocity gains enforcing them (reference
    ``urdf/types.py:514-520``)."""

    soft_lower_limit: float = 0.0
    soft_upper_limit: float = 0.0
    k_position: float = 0.0
    k_velocity: float = 0.0


@dataclass
class JointCalibration:
    """<calibration> element: rising/falling reference positions
    (reference ``urdf/types.py:523-527``)."""

    rising: Optional[float] = None
    falling: Optional[float] = None


@dataclass
class Actuator:
    """<actuator> child of a transmission (reference
    ``urdf/types.py:535-540``)."""

    name: str
    mechanical_reduction: float = 1.0
    hardware_interface: Optional[str] = None


@dataclass
class TransmissionJoint:
    """<joint> child of a transmission (reference
    ``urdf/types.py:544-548``)."""

    name: str
    hardware_interface: Optional[str] = None


@dataclass
class Transmission:
    """<transmission> element linking actuators to joints (reference
    ``urdf/types.py:552-571``)."""

    name: str
    type: str = ""
    joints: List[TransmissionJoint] = field(default_factory=list)
    actuators: List[Actuator] = field(default_factory=list)


@dataclass
class Joint:
    """<joint> element (reference ``urdf/types.py:641-841``)."""

    name: str = ""
    joint_type: JointType = JointType.FIXED
    parent: str = ""
    child: str = ""
    origin: Origin = field(default_factory=Origin)
    axis: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    limit: Optional[JointLimit] = None
    dynamics: Optional[JointDynamics] = None
    mimic: Optional[JointMimic] = None
    safety_controller: Optional[SafetyController] = None
    calibration: Optional[JointCalibration] = None

    def __post_init__(self):
        self.axis = np.asarray(self.axis, dtype=np.float64).reshape(3)

    @property
    def is_actuated(self) -> bool:
        return self.joint_type in (
            JointType.REVOLUTE,
            JointType.CONTINUOUS,
            JointType.PRISMATIC,
        ) and self.mimic is None

    def child_pose(self, value=0.0) -> np.ndarray:
        """Parent-link -> child-link transform at joint value ``value``
        (reference ``Joint.get_child_pose``, ``urdf/types.py:641-748``).

        ``value`` is a scalar for revolute/continuous (rad) and prismatic
        (m); for planar joints it is ``[x, y, theta]`` (in-plane
        translation + rotation about the joint z axis) and for floating
        joints ``[x, y, z, qx, qy, qz, qw]`` (position + quaternion),
        matching the reference's configuration conventions. Scalars (or
        short arrays) fill the leading components, rest zero/identity.
        """
        T = self.origin.matrix
        if self.joint_type in (JointType.REVOLUTE, JointType.CONTINUOUS):
            axis = self.axis / (np.linalg.norm(self.axis) or 1.0)
            K = np.array(
                [
                    [0, -axis[2], axis[1]],
                    [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0],
                ]
            )
            R = np.eye(3) + np.sin(value) * K + (1 - np.cos(value)) * (K @ K)
            Tj = np.eye(4)
            Tj[:3, :3] = R
            return T @ Tj
        if self.joint_type == JointType.PRISMATIC:
            Tj = np.eye(4)
            Tj[:3, 3] = self.axis / (np.linalg.norm(self.axis) or 1.0) * value
            return T @ Tj
        if self.joint_type == JointType.PLANAR:
            v = np.atleast_1d(np.asarray(value, dtype=np.float64)).ravel()
            Tj = np.eye(4)
            if v.size >= 2:
                Tj[0, 3], Tj[1, 3] = v[0], v[1]
            if v.size >= 3:
                c, s = np.cos(v[2]), np.sin(v[2])
                Tj[0, 0], Tj[0, 1] = c, -s
                Tj[1, 0], Tj[1, 1] = s, c
            return T @ Tj
        if self.joint_type == JointType.FLOATING:
            v = np.atleast_1d(np.asarray(value, dtype=np.float64)).ravel()
            Tj = np.eye(4)
            if v.size >= 3:
                Tj[:3, 3] = v[:3]
            if v.size >= 7:
                Tj[:3, :3] = _quat_to_rotation(v[3:7])
            return T @ Tj
        return T
