"""Programmatic robot catalog.

NumPy copies of the factories in ``manipulapy_tpu/models/catalog.py``
(``ur5``, ``panda``, ``two_link_planar``, ``serial_chain``), built from the
same public kinematic and inertial specifications with the same f64
arithmetic, so every field equals the JAX catalog's host arrays. The
URDF-backed and DH-generated catalogs of the JAX package wait for the port
of ``urdf/``. Every factory builds on the CUDA card unless ``device`` names
another device (``device="cpu"``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from .robot import RobotModel, make_robot_model

__all__ = [
    "ur5",
    "panda",
    "two_link_planar",
    "serial_chain",
    "list_robots",
    "get_robot",
]


def _link_inertia(mass: float, com: np.ndarray, radius: float = 0.06) -> np.ndarray:
    """Spatial inertia: solid-sphere-like inertia about the CoM, shifted to
    the link frame by the parallel-axis theorem; translational block m I."""
    I_com = np.eye(3) * (0.4 * mass * radius * radius)
    r = np.asarray(com, dtype=np.float64)
    I_origin = I_com + mass * (float(r @ r) * np.eye(3) - np.outer(r, r))
    G = np.zeros((6, 6))
    G[:3, :3] = I_origin
    G[3:, 3:] = mass * np.eye(3)
    return G


def _pose(xyz, R=None) -> np.ndarray:
    T = np.eye(4)
    if R is not None:
        T[:3, :3] = R
    T[:3, 3] = xyz
    return T


def ur5(dtype=torch.float32, device=None) -> RobotModel:
    """Universal Robots UR5 (6-DoF) from textbook screw parameters (Lynch &
    Park, Example 4.5) and the published link masses."""
    W1, W2 = 0.109, 0.082
    L1, L2 = 0.425, 0.392
    H1, H2 = 0.089, 0.095
    M = np.array(
        [
            [-1.0, 0.0, 0.0, L1 + L2],
            [0.0, 0.0, 1.0, W1 + W2],
            [0.0, 1.0, 0.0, H1 - H2],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    S = np.array(
        [
            [0, 0, 1, 0, 0, 0],
            [0, 1, 0, -H1, 0, 0],
            [0, 1, 0, -H1, 0, L1],
            [0, 1, 0, -H1, 0, L1 + L2],
            [0, 0, -1, -W1, L1 + L2, 0],
            [0, 1, 0, H2 - H1, 0, L1 + L2],
        ],
        dtype=np.float64,
    )
    masses = [3.7, 8.393, 2.275, 1.219, 1.219, 0.1879]
    com_positions = [
        [0.0, 0.0, H1 * 0.5],
        [L1 * 0.5, 0.0, H1],
        [L1 + L2 * 0.5, 0.0, H1],
        [L1 + L2, W1 * 0.5, H1],
        [L1 + L2, W1, H1 * 0.5],
        [L1 + L2, W1 + W2 * 0.5, H1 - H2],
    ]
    com_home = np.stack([_pose(p) for p in com_positions])
    inertias = np.stack([_link_inertia(m, np.zeros(3)) for m in masses])
    two_pi = 2.0 * np.pi
    return make_robot_model(
        M,
        S,
        inertias=inertias,
        com_home=com_home,
        joint_limits=[(-two_pi, two_pi)] * 6,
        velocity_limits=[np.pi] * 6,
        torque_limits=[150.0, 150.0, 150.0, 28.0, 28.0, 28.0],
        dtype=dtype,
        device=device,
    )


def panda(dtype=torch.float32, device=None) -> RobotModel:
    """Franka Emika Panda (7-DoF) from Franka's public modified-DH table."""
    dh = [
        (0.0, 0.333, 0.0),
        (0.0, 0.0, -np.pi / 2),
        (0.0, 0.316, np.pi / 2),
        (0.0825, 0.0, np.pi / 2),
        (-0.0825, 0.384, -np.pi / 2),
        (0.0, 0.0, np.pi / 2),
        (0.088, 0.0, np.pi / 2),
    ]
    flange = 0.107

    def mdh_transform(a, d, alpha, theta=0.0):
        ca, sa = np.cos(alpha), np.sin(alpha)
        ct, st = np.cos(theta), np.sin(theta)
        return np.array(
            [
                [ct, -st, 0.0, a],
                [st * ca, ct * ca, -sa, -d * sa],
                [st * sa, ct * sa, ca, d * ca],
                [0.0, 0.0, 0.0, 1.0],
            ]
        )

    T = np.eye(4)
    S_rows: List[np.ndarray] = []
    joint_origins: List[np.ndarray] = []
    for a, d, alpha in dh:
        T = T @ mdh_transform(a, d, alpha)
        w = T[:3, 2]
        p = T[:3, 3]
        S_rows.append(np.concatenate([w, -np.cross(w, p)]))
        joint_origins.append(T.copy())
    M = T @ _pose([0.0, 0.0, flange])
    S = np.stack(S_rows)
    masses = [4.97, 0.647, 3.23, 3.59, 1.23, 1.67, 0.735]
    com_home = np.stack([jo @ _pose([0.0, 0.0, -0.05]) for jo in joint_origins])
    inertias = np.stack([_link_inertia(m, np.zeros(3), radius=0.05) for m in masses])
    lower = [-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973]
    upper = [2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973]
    return make_robot_model(
        M,
        S,
        inertias=inertias,
        com_home=com_home,
        joint_limits=list(zip(lower, upper)),
        velocity_limits=[2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61],
        torque_limits=[87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0],
        dtype=dtype,
        device=device,
    )


def two_link_planar(
    dtype=torch.float32, l1: float = 1.0, l2: float = 1.0, device=None
) -> RobotModel:
    """2R planar arm, the analytically checkable fixture."""
    M = _pose([l1 + l2, 0.0, 0.0])
    S = np.array([[0, 0, 1, 0, 0, 0], [0, 0, 1, 0, -l1, 0]], dtype=np.float64)
    com_home = np.stack([_pose([l1 * 0.5, 0, 0]), _pose([l1 + l2 * 0.5, 0, 0])])
    inertias = np.stack(
        [_link_inertia(1.0, np.zeros(3), 0.05), _link_inertia(1.0, np.zeros(3), 0.05)]
    )
    return make_robot_model(
        M,
        S,
        inertias=inertias,
        com_home=com_home,
        joint_limits=[(-np.pi, np.pi)] * 2,
        dtype=dtype,
        device=device,
    )


def serial_chain(
    n: int, link_length: float = 0.3, mass: float = 1.0, dtype=torch.float32, device=None
) -> RobotModel:
    """Generic n-DoF chain with alternating z/y axes."""
    S_rows, com_poses = [], []
    p = np.zeros(3)
    for i in range(n):
        w = np.array([0.0, 0.0, 1.0]) if i % 2 == 0 else np.array([0.0, 1.0, 0.0])
        S_rows.append(np.concatenate([w, -np.cross(w, p)]))
        com_poses.append(_pose(p + np.array([link_length * 0.5, 0.0, 0.0])))
        p = p + np.array([link_length, 0.0, 0.0])
    return make_robot_model(
        _pose(p),
        np.stack(S_rows),
        inertias=np.stack([_link_inertia(mass, np.zeros(3), 0.05)] * n),
        com_home=np.stack(com_poses),
        joint_limits=[(-np.pi, np.pi)] * n,
        dtype=dtype,
        device=device,
    )


_REGISTRY: Dict[str, Callable[..., RobotModel]] = {
    "ur5": ur5,
    "panda": panda,
    "two_link_planar": two_link_planar,
}


def list_robots() -> List[str]:
    return sorted(_REGISTRY)


def get_robot(name: str, **kwargs) -> RobotModel:
    """The catalog robot called ``name`` (case-insensitive)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"Unknown robot {name!r}. Available: {list_robots()}")
    return _REGISTRY[key](**kwargs)
