"""Multi-robot kinematic scene.

Counterpart of ``manipulapy_tpu/urdf/scene.py``, the same NumPy code.
Capability parity with the reference's ``ManipulaPy/urdf/scene.py``
(``Scene`` + ``RobotInstance``, 516 LoC): named robot instances with
world base transforms, cross-robot world-frame FK, and inter-robot
collision checks. The reference checks pairwise AABBs of hull points
host-side (``scene.py:352-419``); here the same AABB semantics run over
link sphere clouds, and a vectorized sphere-distance check is provided.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import URDF

__all__ = ["RobotInstance", "Scene"]


@dataclass
class RobotInstance:
    """A robot placed in the world (reference ``scene.py:55-120``)."""

    name: str
    urdf: URDF
    base_transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    configuration: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.base_transform = np.asarray(self.base_transform, dtype=np.float64).reshape(4, 4)

    def set_configuration(self, cfg: Dict[str, float]) -> None:
        self.configuration = dict(cfg)

    def set_joint_values(self, values) -> None:
        """Positional joint values for the actuated chain."""
        names = [j.name for j in self.urdf.actuated_joints]
        self.configuration = dict(zip(names, np.asarray(values, dtype=np.float64)))


class Scene:
    """Named robots in a shared world frame (reference ``scene.py:122-513``)."""

    def __init__(self):
        self.robots: Dict[str, RobotInstance] = {}

    # -- management ------------------------------------------------------------

    def add_robot(
        self,
        name: str,
        urdf: URDF,
        base_transform: Optional[np.ndarray] = None,
        base_position: Optional[np.ndarray] = None,
    ) -> RobotInstance:
        if name in self.robots:
            raise ValueError(f"Robot {name!r} already in scene")
        T = np.eye(4)
        if base_transform is not None:
            T = np.asarray(base_transform, dtype=np.float64).reshape(4, 4)
        elif base_position is not None:
            T[:3, 3] = np.asarray(base_position, dtype=np.float64).reshape(3)
        inst = RobotInstance(name=name, urdf=urdf, base_transform=T)
        self.robots[name] = inst
        return inst

    def remove_robot(self, name: str) -> None:
        del self.robots[name]

    def __contains__(self, name: str) -> bool:
        return name in self.robots

    def __len__(self) -> int:
        return len(self.robots)

    # -- world-frame kinematics --------------------------------------------------

    def world_link_fk(self, name: str) -> Dict[str, np.ndarray]:
        """World pose of every link of robot ``name`` at its current
        configuration (reference ``scene.py:201-234``)."""
        inst = self.robots[name]
        fk = inst.urdf.link_fk(inst.configuration)
        return {link: inst.base_transform @ T for link, T in fk.items()}

    def all_world_link_fk(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {name: self.world_link_fk(name) for name in self.robots}

    def world_end_effector(self, name: str) -> np.ndarray:
        inst = self.robots[name]
        fk = self.world_link_fk(name)
        return fk[inst.urdf.end_links[0]]

    # -- collision ----------------------------------------------------------------

    def _link_spheres(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(centers (L, 3), radii (L,)) for every link of robot ``name``
        at its current world pose. Radii come from each link's bounding
        geometry (``Link.bounding_radius``)."""
        inst = self.robots[name]
        fk = self.world_link_fk(name)
        centers, radii = [], []
        for link_name, T in fk.items():
            link = inst.urdf._links[link_name]
            centers.append(T[:3, 3])
            radii.append(link.bounding_radius())
        return np.asarray(centers), np.asarray(radii)

    def robot_aabb(self, name: str, margin: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """World AABB over the robot's link spheres (the reference's
        hull-point AABB, ``scene.py:352-380``)."""
        centers, radii = self._link_spheres(name)
        lo = (centers - radii[:, None]).min(axis=0) - margin
        hi = (centers + radii[:, None]).max(axis=0) + margin
        return lo, hi

    def check_robot_collision(self, name_a: str, name_b: str, margin: float = 0.0):
        """(colliding?, min clearance) between two robots.

        Phase 1 reproduces the reference's conservative AABB overlap test
        (``scene.py:352-419``); when the boxes overlap, phase 2 refines
        with exact pairwise link-sphere distances.
        """
        lo_a, hi_a = self.robot_aabb(name_a, margin)
        lo_b, hi_b = self.robot_aabb(name_b, margin)
        if np.any(hi_a < lo_b) or np.any(hi_b < lo_a):
            gap = np.maximum(lo_b - hi_a, lo_a - hi_b).max()
            return False, float(gap)
        ca, ra = self._link_spheres(name_a)
        cb, rb = self._link_spheres(name_b)
        d = np.linalg.norm(ca[:, None, :] - cb[None, :, :], axis=-1)
        clearance = d - (ra[:, None] + rb[None, :]) - margin
        min_c = float(clearance.min())
        return min_c < 0.0, min_c

    def check_all_collisions(self, margin: float = 0.0) -> List[Tuple[str, str, float]]:
        """All colliding robot pairs with their clearances."""
        names = sorted(self.robots)
        out = []
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                colliding, c = self.check_robot_collision(a, b, margin)
                if colliding:
                    out.append((a, b, c))
        return out
