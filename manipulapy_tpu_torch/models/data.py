"""Bundled robot catalog: 25 nominal robot models generated from public
kinematic tables.

Counterpart of ``manipulapy_tpu/models/data.py``: the same specifications
and the same f64 NumPy generator, so every URDF document is byte for byte
the JAX package's. Models build on the CUDA card unless ``device`` names
another device.

Counterpart of the reference's ``ManipulaPy_data/`` package (25 bundled
URDFs + 143 MB of meshes, registry at
``ManipulaPy_data/__init__.py:317-592`` — ``get_robot_urdf``,
``list_robots``, ``get_robots_by_dof``, ``print_robot_catalog``).

Instead of shipping mesh data, every robot is defined by a compact
Denavit-Hartenberg specification (standard or modified convention) from
the manufacturer's published kinematics, from which the module generates:

* a valid URDF document (``robot_urdf_string`` / ``get_robot_urdf``),
* a device-ready :class:`RobotModel` (``load_robot``), via the full
  URDF -> screw-extraction pipeline so the catalog also exercises the
  parser on every robot.

Kinematic (a, alpha, d) values are the manufacturers' published numbers;
link masses/inertias are *nominal* (total robot mass distributed along
the chain with a rod/sphere approximation) — exact inertial calibration
loads through :class:`~manipulapy_tpu_torch.urdf.URDFModifier` calibration
files, mirroring how users calibrate the reference's bundled models.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "RobotSpec",
    "ROBOT_SPECS",
    "list_robots",
    "get_robots_by_dof",
    "get_robot_info",
    "robot_urdf_string",
    "get_robot_urdf",
    "load_robot",
    "print_robot_catalog",
]


@dataclass(frozen=True)
class RobotSpec:
    """One catalog entry: DH rows + nominal physical data."""

    name: str
    manufacturer: str
    dof: int
    convention: str  # "dh" (standard) or "mdh" (Craig / modified)
    # rows: (a, alpha, d, theta_offset) per joint
    rows: Tuple[Tuple[float, float, float, float], ...]
    tool: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # flange offset (xyz in last frame)
    total_mass: float = 20.0
    payload: float = 5.0
    reach: float = 1.0
    lower: Optional[Tuple[float, ...]] = None
    upper: Optional[Tuple[float, ...]] = None
    effort: Optional[Tuple[float, ...]] = None
    velocity: Optional[Tuple[float, ...]] = None
    description: str = ""


_PI = np.pi
_H = _PI / 2


def _ur(name: str, d1, a2, a3, d4, d5, d6, total_mass, payload, reach, effort) -> RobotSpec:
    """Universal Robots family: shared standard-DH pattern."""
    return RobotSpec(
        name=name,
        manufacturer="Universal Robots",
        dof=6,
        convention="dh",
        rows=(
            (0.0, _H, d1, 0.0),
            (a2, 0.0, 0.0, 0.0),
            (a3, 0.0, 0.0, 0.0),
            (0.0, _H, d4, 0.0),
            (0.0, -_H, d5, 0.0),
            (0.0, 0.0, d6, 0.0),
        ),
        total_mass=total_mass,
        payload=payload,
        reach=reach,
        lower=(-2 * _PI,) * 6,
        upper=(2 * _PI,) * 6,
        effort=effort,
        velocity=(_PI,) * 6,
        description=f"{name.upper()} collaborative 6-DoF arm",
    )


ROBOT_SPECS: Dict[str, RobotSpec] = {}


def _add(spec: RobotSpec) -> None:
    ROBOT_SPECS[spec.name] = spec


# -- Universal Robots (published DH) -------------------------------------------
_add(_ur("ur3", 0.1519, -0.24365, -0.21325, 0.11235, 0.08535, 0.0819, 11.0, 3.0, 0.5, (56, 56, 28, 12, 12, 12)))
_add(_ur("ur3e", 0.15185, -0.24355, -0.2132, 0.13105, 0.08535, 0.0921, 11.2, 3.0, 0.5, (56, 56, 28, 12, 12, 12)))
_add(_ur("ur5", 0.089159, -0.425, -0.39225, 0.10915, 0.09465, 0.0823, 18.4, 5.0, 0.85, (150, 150, 150, 28, 28, 28)))
_add(_ur("ur5e", 0.1625, -0.425, -0.3922, 0.1333, 0.0997, 0.0996, 20.6, 5.0, 0.85, (150, 150, 150, 28, 28, 28)))
_add(_ur("ur10", 0.1273, -0.612, -0.5723, 0.163941, 0.1157, 0.0922, 28.9, 10.0, 1.3, (330, 330, 150, 56, 56, 56)))
_add(_ur("ur10e", 0.1807, -0.6127, -0.57155, 0.17415, 0.11985, 0.11655, 33.5, 12.5, 1.3, (330, 330, 150, 56, 56, 56)))
_add(_ur("ur16e", 0.1807, -0.4784, -0.36, 0.17415, 0.11985, 0.11655, 33.1, 16.0, 0.9, (330, 330, 150, 56, 56, 56)))

# -- Franka Emika Panda (published modified-DH) ----------------------------------
_add(
    RobotSpec(
        name="panda",
        manufacturer="Franka Emika",
        dof=7,
        convention="mdh",
        rows=(
            (0.0, 0.0, 0.333, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, _H, 0.316, 0.0),
            (0.0825, _H, 0.0, 0.0),
            (-0.0825, -_H, 0.384, 0.0),
            (0.0, _H, 0.0, 0.0),
            (0.088, _H, 0.0, 0.0),
        ),
        tool=(0.0, 0.0, 0.107),
        total_mass=17.8,
        payload=3.0,
        reach=0.855,
        lower=(-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973),
        upper=(2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973),
        effort=(87, 87, 87, 87, 12, 12, 12),
        velocity=(2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61),
        description="Panda 7-DoF torque-controlled arm",
    )
)

# -- KUKA (published frame offsets) -----------------------------------------------
for nm, d_list, mass, payload in (
    ("iiwa7", (0.34, 0.0, 0.4, 0.0, 0.4, 0.0, 0.126), 23.9, 7.0),
    ("iiwa14", (0.36, 0.0, 0.42, 0.0, 0.4, 0.0, 0.126), 29.9, 14.0),
):
    _add(
        RobotSpec(
            name=nm,
            manufacturer="KUKA",
            dof=7,
            convention="dh",
            rows=tuple(
                (0.0, alpha, d, 0.0)
                for alpha, d in zip((-_H, _H, _H, -_H, -_H, _H, 0.0), d_list)
            ),
            total_mass=mass,
            payload=payload,
            reach=0.8,
            lower=(-2.967, -2.094, -2.967, -2.094, -2.967, -2.094, -3.054),
            upper=(2.967, 2.094, 2.967, 2.094, 2.967, 2.094, 3.054),
            effort=(176, 176, 110, 110, 110, 40, 40),
            velocity=(1.71, 1.71, 1.75, 2.27, 2.44, 3.14, 3.14),
            description=f"LBR {nm} 7-DoF sensitive arm",
        )
    )
_add(
    RobotSpec(
        name="kr6_r900",
        manufacturer="KUKA",
        dof=6,
        convention="dh",
        rows=(
            (0.025, -_H, 0.4, 0.0),
            (0.455, 0.0, 0.0, -_H),
            (0.035, -_H, 0.0, 0.0),
            (0.0, _H, 0.42, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.08, 0.0),
        ),
        total_mass=52.0,
        payload=6.0,
        reach=0.9,
        lower=(-2.967, -3.316, -2.094, -3.228, -2.094, -6.109),
        upper=(2.967, 0.785, 2.722, 3.228, 2.094, 6.109),
        effort=(200, 200, 100, 60, 60, 40),
        velocity=(6.28, 5.24, 6.28, 6.65, 6.77, 10.73),
        description="KR 6 R900 AGILUS industrial 6-DoF",
    )
)

# -- Kinova -----------------------------------------------------------------------
_add(
    RobotSpec(
        name="gen3",
        manufacturer="Kinova",
        dof=7,
        convention="dh",
        rows=(
            (0.0, _H, 0.2848, 0.0),
            (0.0, -_H, 0.0118, 0.0),
            (0.0, _H, 0.4208, 0.0),
            (0.0, -_H, 0.0128, 0.0),
            (0.0, _H, 0.3143, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.1674, 0.0),
        ),
        total_mass=8.2,
        payload=4.0,
        reach=0.902,
        lower=(-_PI, -2.41, -_PI, -2.66, -_PI, -2.23, -_PI),
        upper=(_PI, 2.41, _PI, 2.66, _PI, 2.23, _PI),
        effort=(39, 39, 39, 39, 9, 9, 9),
        velocity=(1.39, 1.39, 1.39, 1.39, 1.22, 1.22, 1.22),
        description="Gen3 7-DoF ultra-light arm",
    )
)
_add(
    RobotSpec(
        name="gen3_lite",
        manufacturer="Kinova",
        dof=6,
        convention="dh",
        rows=(
            (0.0, _H, 0.2433, 0.0),
            (0.28, 0.0, 0.03, -_H),
            (0.0, _H, 0.02, _H),
            (0.0, -_H, 0.245, 0.0),
            (0.0, _H, 0.057, 0.0),
            (0.0, 0.0, 0.2353, 0.0),
        ),
        total_mass=5.4,
        payload=0.5,
        reach=0.76,
        lower=(-2.68, -2.61, -2.61, -2.6, -2.53, -2.6),
        upper=(2.68, 2.61, 2.61, 2.6, 2.53, 2.6),
        effort=(10, 14, 10, 7, 7, 7),
        velocity=(1.6,) * 6,
        description="Gen3 lite 6-DoF educational arm",
    )
)
_add(
    RobotSpec(
        name="jaco2",
        manufacturer="Kinova",
        dof=6,
        convention="dh",
        rows=(
            (0.0, _H, 0.2755, 0.0),
            (0.41, 0.0, 0.0, -_H),
            (0.0, _H, -0.0098, _H),
            (0.0, -_H, 0.2501, 0.0),
            (0.0, _H, 0.0856, 0.0),
            (0.0, 0.0, 0.2028, 0.0),
        ),
        total_mass=4.4,
        payload=1.6,
        reach=0.9,
        lower=(-2 * _PI,) * 6,
        upper=(2 * _PI,) * 6,
        effort=(30.5, 30.5, 30.5, 6.8, 6.8, 6.8),
        velocity=(0.63, 0.63, 0.63, 0.84, 0.84, 0.84),
        description="JACO2 6-DoF assistive arm",
    )
)

# -- UFactory xArm ------------------------------------------------------------------
_add(
    RobotSpec(
        name="xarm6",
        manufacturer="UFactory",
        dof=6,
        convention="dh",
        rows=(
            (0.0, -_H, 0.267, 0.0),
            (0.28949, 0.0, 0.0, -1.3849179),
            (0.0775, -_H, 0.0, 1.3849179),
            (0.0, _H, 0.3425, 0.0),
            (0.076, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.097, 0.0),
        ),
        total_mass=12.2,
        payload=5.0,
        reach=0.7,
        lower=(-2 * _PI, -2.059, -3.927, -2 * _PI, -1.69297, -2 * _PI),
        upper=(2 * _PI, 2.0944, 0.19198, 2 * _PI, _PI, 2 * _PI),
        effort=(50, 50, 30, 30, 30, 20),
        velocity=(_PI,) * 6,
        description="xArm 6 6-DoF arm (the reference's benchmark robot)",
    )
)
_add(
    RobotSpec(
        name="xarm7",
        manufacturer="UFactory",
        dof=7,
        convention="dh",
        rows=(
            (0.0, -_H, 0.267, 0.0),
            (0.0, _H, 0.0, 0.0),
            (0.0525, _H, 0.293, 0.0),
            (0.0775, _H, 0.0, 0.0),
            (0.0, _H, 0.3425, 0.0),
            (0.076, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.097, 0.0),
        ),
        total_mass=13.7,
        payload=3.5,
        reach=0.7,
        lower=(-2 * _PI, -2.059, -2 * _PI, -0.19198, -2 * _PI, -1.69297, -2 * _PI),
        upper=(2 * _PI, 2.0944, 2 * _PI, 3.927, 2 * _PI, _PI, 2 * _PI),
        effort=(50, 50, 30, 30, 30, 20, 20),
        velocity=(_PI,) * 7,
        description="xArm 7 7-DoF arm",
    )
)
_add(
    RobotSpec(
        name="lite6",
        manufacturer="UFactory",
        dof=6,
        convention="dh",
        rows=(
            (0.0, -_H, 0.2435, 0.0),
            (0.2, 0.0, 0.0, -1.5708),
            (0.087, -_H, 0.0, 1.5708),
            (0.0, _H, 0.2276, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.0615, 0.0),
        ),
        total_mass=7.2,
        payload=0.6,
        reach=0.44,
        lower=(-2 * _PI, -2.61, -0.061, -2 * _PI, -2.1642, -2 * _PI),
        upper=(2 * _PI, 2.61, 5.236, 2 * _PI, 2.1642, 2 * _PI),
        effort=(20, 20, 15, 10, 10, 10),
        velocity=(_PI,) * 6,
        description="Lite 6 compact 6-DoF arm",
    )
)

# -- ABB ------------------------------------------------------------------------------
_add(
    RobotSpec(
        name="irb120",
        manufacturer="ABB",
        dof=6,
        convention="dh",
        rows=(
            (0.0, -_H, 0.29, 0.0),
            (0.27, 0.0, 0.0, -_H),
            (0.07, -_H, 0.0, 0.0),
            (0.0, _H, 0.302, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.072, _PI),
        ),
        total_mass=25.0,
        payload=3.0,
        reach=0.58,
        lower=(-2.87979, -1.91986, -1.91986, -2.79253, -2.094395, -6.98132),
        upper=(2.87979, 1.91986, 1.22173, 2.79253, 2.094395, 6.98132),
        effort=(60, 60, 40, 20, 20, 20),
        velocity=(4.36, 4.36, 4.36, 5.58, 5.58, 7.33),
        description="IRB 120 compact industrial 6-DoF",
    )
)
_add(
    RobotSpec(
        name="irb1600",
        manufacturer="ABB",
        dof=6,
        convention="dh",
        rows=(
            (0.15, -_H, 0.4865, 0.0),
            (0.475, 0.0, 0.0, -_H),
            (0.0, -_H, 0.0, 0.0),
            (0.0, _H, 0.6, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.065, _PI),
        ),
        total_mass=250.0,
        payload=10.0,
        reach=1.45,
        lower=(-3.14159, -1.0995, -4.1015, -3.4906, -2.0071, -6.9813),
        upper=(3.14159, 2.6179, 1.0995, 3.4906, 2.0071, 6.9813),
        effort=(600, 600, 300, 80, 80, 80),
        velocity=(3.14, 3.14, 3.14, 5.5, 6.3, 8.7),
        description="IRB 1600 industrial 6-DoF",
    )
)

# -- Fanuc -----------------------------------------------------------------------------
_add(
    RobotSpec(
        name="lrmate200id",
        manufacturer="Fanuc",
        dof=6,
        convention="dh",
        rows=(
            (0.05, -_H, 0.33, 0.0),
            (0.33, 0.0, 0.0, -_H),
            (0.035, -_H, 0.0, 0.0),
            (0.0, _H, 0.335, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.08, _PI),
        ),
        total_mass=25.0,
        payload=7.0,
        reach=0.717,
        lower=(-2.965, -1.745, -2.450, -3.315, -2.18, -6.285),
        upper=(2.965, 2.530, 4.890, 3.315, 2.18, 6.285),
        effort=(120, 120, 60, 30, 30, 30),
        velocity=(7.85, 6.63, 9.08, 9.60, 9.51, 17.45),
        description="LR Mate 200iD compact 6-DoF",
    )
)
_add(
    RobotSpec(
        name="m20ia",
        manufacturer="Fanuc",
        dof=6,
        convention="dh",
        rows=(
            (0.15, -_H, 0.525, 0.0),
            (0.79, 0.0, 0.0, -_H),
            (0.15, -_H, 0.0, 0.0),
            (0.0, _H, 0.86, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.1, _PI),
        ),
        total_mass=250.0,
        payload=20.0,
        reach=1.811,
        lower=(-2.967, -1.745, -2.775, -3.49, -2.443, -4.712),
        upper=(2.967, 2.793, 4.537, 3.49, 2.443, 4.712),
        effort=(800, 800, 400, 100, 100, 100),
        velocity=(3.40, 3.05, 3.57, 6.11, 6.11, 9.16),
        description="M-20iA industrial 6-DoF",
    )
)
_add(
    RobotSpec(
        name="crx10ia",
        manufacturer="Fanuc",
        dof=6,
        convention="dh",
        rows=(
            (0.0, -_H, 0.245, 0.0),
            (0.54, 0.0, 0.0, -_H),
            (0.0, -_H, 0.0, 0.0),
            (0.0, _H, 0.54, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.16, _PI),
        ),
        total_mass=40.0,
        payload=10.0,
        reach=1.249,
        lower=(-3.14, -3.14, -4.71, -3.31, -3.14, -3.92),
        upper=(3.14, 3.14, 4.71, 3.31, 3.14, 3.92),
        effort=(150, 150, 100, 50, 50, 50),
        velocity=(2.09, 2.09, 3.14, 3.14, 3.14, 3.14),
        description="CRX-10iA collaborative 6-DoF",
    )
)

# -- Others ------------------------------------------------------------------------------
_add(
    RobotSpec(
        name="gp8",
        manufacturer="Yaskawa Motoman",
        dof=6,
        convention="dh",
        rows=(
            (0.04, -_H, 0.33, 0.0),
            (0.345, 0.0, 0.0, -_H),
            (0.04, -_H, 0.0, 0.0),
            (0.0, _H, 0.34, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.08, _PI),
        ),
        total_mass=32.0,
        payload=8.0,
        reach=0.727,
        lower=(-2.967, -1.134, -1.222, -3.316, -2.164, -7.941),
        upper=(2.967, 2.531, 3.316, 3.316, 2.164, 7.941),
        effort=(150, 150, 80, 40, 40, 40),
        velocity=(7.94, 6.80, 9.42, 9.76, 9.76, 14.66),
        description="GP8 industrial 6-DoF",
    )
)
_add(
    RobotSpec(
        name="tx90",
        manufacturer="Staubli",
        dof=6,
        convention="dh",
        rows=(
            (0.05, -_H, 0.478, 0.0),
            (0.425, 0.0, 0.05, -_H),
            (0.0, _H, 0.0, _H),
            (0.0, -_H, 0.425, 0.0),
            (0.0, _H, 0.0, 0.0),
            (0.0, 0.0, 0.1, 0.0),
        ),
        total_mass=111.0,
        payload=7.0,
        reach=1.0,
        lower=(-3.14, -2.27, -2.53, -4.71, -2.44, -4.71),
        upper=(3.14, 2.57, 2.53, 4.71, 2.44, 4.71),
        effort=(318, 318, 176, 48, 48, 48),
        velocity=(6.98, 6.51, 7.77, 9.60, 9.95, 13.96),
        description="TX90 industrial 6-DoF",
    )
)
_add(
    RobotSpec(
        name="tm5_900",
        manufacturer="Omron / Techman",
        dof=6,
        convention="dh",
        rows=(
            (0.0, _H, 0.1452, 0.0),
            (-0.429, 0.0, 0.0, -_H),
            (-0.4115, 0.0, 0.0, 0.0),
            (0.0, _H, 0.1223, _H),
            (0.0, -_H, 0.106, 0.0),
            (0.0, 0.0, 0.1144, 0.0),
        ),
        total_mass=22.6,
        payload=4.0,
        reach=0.9,
        lower=(-4.71, -3.14, -2.70, -3.14, -3.14, -4.71),
        upper=(4.71, 3.14, 2.70, 3.14, 3.14, 4.71),
        effort=(157, 157, 157, 43, 43, 43),
        velocity=(3.14, 3.14, 3.14, 3.93, 3.93, 3.93),
        description="TM5-900 collaborative 6-DoF",
    )
)
_add(
    RobotSpec(
        name="m1013",
        manufacturer="Doosan",
        dof=6,
        convention="dh",
        rows=(
            (0.0, -_H, 0.1525, 0.0),
            (0.62, 0.0, 0.0345, -_H),
            (0.0, _H, 0.0, _H),
            (0.0, -_H, 0.559, 0.0),
            (0.0, _H, 0.0, 0.0),
            (0.0, 0.0, 0.121, 0.0),
        ),
        total_mass=33.0,
        payload=10.0,
        reach=1.3,
        lower=(-6.28, -6.28, -2.79, -6.28, -2.79, -6.28),
        upper=(6.28, 6.28, 2.79, 6.28, 2.79, 6.28),
        effort=(190, 190, 120, 40, 40, 40),
        velocity=(2.09, 2.09, 3.14, 3.93, 3.93, 3.93),
        description="M1013 collaborative 6-DoF",
    )
)
_add(
    RobotSpec(
        name="vs068",
        manufacturer="Denso",
        dof=6,
        convention="dh",
        rows=(
            (0.03, -_H, 0.1975, 0.0),
            (0.34, 0.0, 0.0, -_H),
            (0.02, -_H, 0.0, 0.0),
            (0.0, _H, 0.34, 0.0),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.073, _PI),
        ),
        total_mass=30.0,
        payload=7.0,
        reach=0.71,
        lower=(-2.967, -2.094, -2.181, -4.712, -2.094, -6.283),
        upper=(2.967, 2.094, 2.705, 4.712, 2.094, 6.283),
        effort=(100, 100, 60, 30, 30, 30),
        velocity=(6.54, 5.23, 7.06, 9.42, 9.42, 12.57),
        description="VS-068 industrial 6-DoF",
    )
)
_add(
    RobotSpec(
        name="z1",
        manufacturer="Unitree",
        dof=6,
        convention="dh",
        rows=(
            (0.0, _H, 0.1035, 0.0),
            (-0.35, 0.0, 0.0, 0.0),
            (-0.225, 0.0, 0.0, 0.0),
            (0.0, _H, 0.0, _H),
            (0.0, -_H, 0.0, 0.0),
            (0.0, 0.0, 0.05, 0.0),
        ),
        total_mass=4.5,
        payload=2.0,
        reach=0.74,
        lower=(-2.62, 0.0, -2.88, -1.52, -1.34, -2.79),
        upper=(2.62, 2.97, 0.0, 1.52, 1.34, 2.79),
        effort=(30, 60, 30, 10, 10, 10),
        velocity=(3.14,) * 6,
        description="Z1 lightweight 6-DoF arm",
    )
)
_add(
    RobotSpec(
        name="robotiq_2f85",
        manufacturer="Robotiq",
        dof=1,
        convention="dh",
        rows=((0.0, 0.0, 0.06, 0.0),),
        total_mass=0.9,
        payload=5.0,
        reach=0.085,
        lower=(0.0,),
        upper=(0.8,),
        effort=(5.0,),
        velocity=(2.0,),
        description="2F-85 adaptive gripper (1 actuated DoF)",
    )
)


# -- URDF generation ------------------------------------------------------------


def _rot_to_rpy(R: np.ndarray) -> np.ndarray:
    sy = float(np.hypot(R[0, 0], R[1, 0]))
    if sy > 1e-9:
        return np.array(
            [
                np.arctan2(R[2, 1], R[2, 2]),
                np.arctan2(-R[2, 0], sy),
                np.arctan2(R[1, 0], R[0, 0]),
            ]
        )
    return np.array([np.arctan2(-R[1, 2], R[1, 1]), np.arctan2(-R[2, 0], sy), 0.0])


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4)
    T[1:3, 1:3] = [[c, -s], [s, c]]
    return T


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


def _trans(x, y, z):
    T = np.eye(4)
    T[:3, 3] = [x, y, z]
    return T


def _joint_frames(spec: RobotSpec) -> List[np.ndarray]:
    """Constant parent->child transforms O_1..O_n (+ tool O_{n+1}) such
    that the URDF chain ``prod_i O_i Rz(theta_i)`` reproduces the DH chain.

    Standard DH:  T_i = Rz(theta_i + off) Tz(d) Tx(a) Rx(alpha)
                  => O_1 = Rz(off_1), O_{i+1} = [Tz Tx Rx]_i Rz(off_{i+1}).
    Modified DH:  T_i = Rx(alpha_{i-1}) Tx(a_{i-1}) Tz(d_i) Rz(theta_i + off)
                  => O_i = Rx(alpha) Tx(a) Tz(d) Rz(off) of row i.
    """
    frames: List[np.ndarray] = []
    if spec.convention == "dh":
        prev = np.eye(4)
        for a, alpha, d, off in spec.rows:
            frames.append(prev @ _rz(off))
            prev = _trans(0, 0, d) @ _trans(a, 0, 0) @ _rx(alpha)
        frames.append(prev @ _trans(*spec.tool))
    elif spec.convention == "mdh":
        for a, alpha, d, off in spec.rows:
            frames.append(_rx(alpha) @ _trans(a, 0, 0) @ _trans(0, 0, d) @ _rz(off))
        frames.append(_trans(*spec.tool))
    else:
        raise ValueError(f"Unknown DH convention {spec.convention!r}")
    return frames


def robot_urdf_string(name: str) -> str:
    """Generate the URDF document for a catalog robot."""
    from ..urdf.modifiers import urdf_to_xml
    from ..urdf.parser import ParsedRobot
    from ..urdf.types import (
        Collision,
        Cylinder,
        Inertial,
        Joint,
        JointLimit,
        JointType,
        Link,
        Origin,
    )

    spec = ROBOT_SPECS[name]
    frames = _joint_frames(spec)
    n = spec.dof

    # Nominal mass distribution: heavier near the base (geometric decay).
    w = np.array([0.75**i for i in range(n)])
    masses = spec.total_mass * 0.85 * w / w.sum()  # 15% stays in the base link

    links = [
        Link(
            name="base_link",
            inertial=Inertial(mass=spec.total_mass * 0.15, inertia=np.eye(3) * 0.01),
        )
    ]
    joints = []
    for i in range(n):
        T_next = frames[i + 1]
        seg = T_next[:3, 3]
        seg_len = float(np.linalg.norm(seg))
        com = seg / 2.0
        r = max(0.04, seg_len / 6.0)
        # Rod + sphere nominal inertia about the CoM.
        I = np.eye(3) * (0.4 * masses[i] * r * r + masses[i] * seg_len * seg_len / 12.0)
        links.append(
            Link(
                name=f"link{i + 1}",
                inertial=Inertial(mass=float(masses[i]), origin=Origin(xyz=com), inertia=I),
                collisions=[
                    Collision(
                        origin=Origin(xyz=com),
                        geometry=Cylinder(radius=r, length=max(seg_len, 2 * r)),
                    )
                ],
            )
        )
        T = frames[i]
        lower = spec.lower[i] if spec.lower else -_PI
        upper = spec.upper[i] if spec.upper else _PI
        joints.append(
            Joint(
                name=f"joint{i + 1}",
                joint_type=JointType.REVOLUTE,
                parent="base_link" if i == 0 else f"link{i}",
                child=f"link{i + 1}",
                origin=Origin(xyz=T[:3, 3], rpy=_rot_to_rpy(T[:3, :3])),
                axis=np.array([0.0, 0.0, 1.0]),
                limit=JointLimit(
                    lower=float(lower),
                    upper=float(upper),
                    effort=float(spec.effort[i]) if spec.effort else 100.0,
                    velocity=float(spec.velocity[i]) if spec.velocity else _PI,
                ),
            )
        )
    # Fixed flange/tool frame.
    T = frames[n]
    links.append(Link(name="tool0"))
    joints.append(
        Joint(
            name="tool_joint",
            joint_type=JointType.FIXED,
            parent=f"link{n}",
            child="tool0",
            origin=Origin(xyz=T[:3, 3], rpy=_rot_to_rpy(T[:3, :3])),
        )
    )
    return urdf_to_xml(ParsedRobot(spec.name, links, joints))


_URDF_CACHE_DIR = os.path.join(tempfile.gettempdir(), "manipulapy_tpu_torch_urdf")


def get_robot_urdf(name: str, directory: Optional[str] = None) -> str:
    """Materialize the catalog robot's URDF to a file and return the path
    (reference ``get_robot_urdf``, ``ManipulaPy_data/__init__.py:317``)."""
    if name not in ROBOT_SPECS:
        raise KeyError(f"Unknown robot {name!r}. Available: {list_robots()}")
    directory = directory or _URDF_CACHE_DIR
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.urdf")
    if not os.path.exists(path):
        # Written under another name and moved into place, so a concurrent
        # reader never sees a half-written document.
        fd, tmp = tempfile.mkstemp(suffix=".urdf", dir=directory)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(robot_urdf_string(name))
        os.replace(tmp, path)
    return path


def load_robot(name: str, dtype=None, device=None):
    """Catalog name -> :class:`RobotModel` through the full URDF pipeline,
    float32 on the CUDA card unless ``dtype`` and ``device`` say otherwise."""
    from ..urdf.core import URDF

    return URDF.from_string(robot_urdf_string(name)).to_robot_model(
        tip_link="tool0", dtype=torch.float32 if dtype is None else dtype, device=device
    )


def list_robots() -> List[str]:
    return sorted(ROBOT_SPECS)


def get_robots_by_dof(dof: int) -> List[str]:
    """Reference ``get_robots_by_dof`` (``ManipulaPy_data/__init__.py``)."""
    return sorted(name for name, s in ROBOT_SPECS.items() if s.dof == dof)


def get_robot_info(name: str) -> RobotSpec:
    return ROBOT_SPECS[name]


def print_robot_catalog() -> None:
    """Human-readable catalog table (reference ``print_robot_catalog``)."""
    print(f"{'name':<14} {'manufacturer':<18} {'dof':>3} {'payload':>8} {'reach':>6}  description")
    print("-" * 88)
    for name in list_robots():
        s = ROBOT_SPECS[name]
        print(
            f"{name:<14} {s.manufacturer:<18} {s.dof:>3} {s.payload:>7.1f}kg "
            f"{s.reach:>5.2f}m  {s.description}"
        )
