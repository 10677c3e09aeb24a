"""Calibrated robot catalog backed by the vendored reference URDFs.

Counterpart of ``manipulapy_tpu/models/robot_data.py``, with the same
table, keys and aliases. This is the counterpart of the reference's bundled robot data package
(``ManipulaPy/ManipulaPy_data/__init__.py:317-592`` — ``get_robot_urdf``,
``list_robots``, ``get_robots_by_dof``, ``print_robot_catalog``), but the
models it produces are built through this framework's native URDF parser
and screw extraction (:mod:`manipulapy_tpu_torch.urdf.core`), which matches the
reference's ``extract_screw_axes`` (``urdf/core.py:657-756``) bit-exactly
on all bundled robots (see ``tests/test_reference_parity.py``).

Unlike :mod:`manipulapy_tpu_torch.models.data` (DH-table generated models with
*nominal* rod/sphere inertias), the robots here carry the reference's real
calibrated inertial parameters, so torques computed on them are directly
comparable to the reference's exact CPU dynamics path
(``dynamics.py:313-369`` through ``urdf_processor.py:287-302``).

URDF XML lookup order:
1. this package's own verbatim copy under ``manipulapy_tpu_torch/data/robots/``
   (sha256 of each file in its ``PROVENANCE.md``);
2. ``$MANIPULAPY_TPU_DATA`` if set.

Models build on the CUDA card unless ``device`` names another device.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = [
    "ROBOT_DATABASE",
    "RobotInfo",
    "get_robot_urdf",
    "get_robots_by_dof",
    "list_robots",
    "load_robot",
    "print_robot_catalog",
]

_VENDORED = Path(__file__).resolve().parent.parent / "data" / "robots"


class RobotInfo(NamedTuple):
    name: str
    manufacturer: str
    dof: int
    payload: str
    reach: str
    urdf: str  # path relative to the data root
    description: str


_PRIMARY_KEYS: List[str] = []


def _families() -> Dict[str, RobotInfo]:
    """Robot metadata table. Facts (DoF, payload, reach) are public
    manufacturer specs; keys and relative URDF paths mirror the reference
    registry so user code ports 1:1."""
    db: Dict[str, RobotInfo] = {}

    def add(key, name, manu, dof, payload, reach, urdf, desc, aliases=()):
        info = RobotInfo(name, manu, dof, payload, reach, urdf, desc)
        db[key] = info
        _PRIMARY_KEYS.append(key)
        for a in aliases:
            db[a] = info

    # Universal Robots (CB + e-Series)
    for k, payload, reach in [
        ("ur3", "3 kg", "500 mm"), ("ur5", "5 kg", "850 mm"),
        ("ur10", "10 kg", "1300 mm"), ("ur3e", "3 kg", "500 mm"),
        ("ur5e", "5 kg", "850 mm"), ("ur10e", "12.5 kg", "1300 mm"),
        ("ur16e", "16 kg", "900 mm"),
    ]:
        add(k, f"Universal Robots {k.upper()}", "Universal Robots", 6,
            payload, reach, f"universal_robots/{k}/{k}.urdf",
            "6-DOF collaborative robot")
    add("panda", "Franka Emika Panda", "Franka Emika", 7, "3 kg", "855 mm",
        "franka_panda/panda.urdf", "7-DOF research robot with torque sensing",
        aliases=("franka_panda",))
    add("iiwa7", "KUKA LBR iiwa 7 R800", "KUKA", 7, "7 kg", "800 mm",
        "kuka_iiwa/iiwa7/iiwa7.urdf", "7-DOF collaborative robot")
    add("iiwa14", "KUKA LBR iiwa 14 R820", "KUKA", 7, "14 kg", "820 mm",
        "kuka_iiwa/iiwa14/iiwa14.urdf", "7-DOF collaborative robot",
        aliases=("kuka_iiwa",))
    add("gen3", "Kinova Gen3", "Kinova", 7, "4 kg", "902 mm",
        "kinova/gen3/gen3.urdf", "7-DOF lightweight robot arm",
        aliases=("kinova_gen3",))
    add("jaco_6dof", "Kinova Jaco 6-DOF", "Kinova", 6, "1.6 kg", "900 mm",
        "kinova/jaco/jaco_6dof.urdf", "6-DOF assistive robot arm")
    add("jaco_7dof", "Kinova Jaco 7-DOF", "Kinova", 7, "1.6 kg", "900 mm",
        "kinova/jaco/jaco_7dof.urdf", "7-DOF assistive robot arm")
    add("fanuc_lrmate", "Fanuc LR Mate 200iB", "Fanuc", 6, "5 kg", "704 mm",
        "fanuc/lrmate200ib.urdf", "6-DOF compact industrial robot")
    add("fanuc_m16ib", "Fanuc M-16iB", "Fanuc", 6, "16 kg", "1885 mm",
        "fanuc/m16ib.urdf", "6-DOF industrial robot")
    for k, payload, reach in [
        ("crx5ia", "5 kg", "994 mm"), ("crx10ia", "10 kg", "1249 mm"),
        ("crx10ia_l", "10 kg", "1418 mm"), ("crx20ia_l", "20 kg", "1418 mm"),
        ("crx30ia", "30 kg", "1252 mm"),
    ]:
        add(k, f"Fanuc CRX-{k[3:].replace('_l', '/L').upper()}", "Fanuc", 6,
            payload, reach, f"fanuc_crx/{k}.urdf",
            "6-DOF collaborative robot")
    add("abb_irb2400", "ABB IRB 2400", "ABB", 6, "7-20 kg", "1550 mm",
        "abb/irb2400.urdf", "6-DOF industrial robot")
    add("xarm6", "UFactory xArm6", "UFactory", 6, "5 kg", "700 mm",
        "xarm/xarm6_robot.urdf", "6-DOF robot arm")
    add("xarm6_gripper", "UFactory xArm6 with Gripper", "UFactory", 6,
        "5 kg", "700 mm", "xarm/xarm6_with_gripper.urdf",
        "6-DOF robot arm with gripper")
    add("robotiq_2f_85", "Robotiq 2F-85", "Robotiq", 1, "N/A", "85 mm stroke",
        "robotiq/robotiq_2f_85.urdf", "Adaptive parallel gripper")
    add("robotiq_2f_140", "Robotiq 2F-140", "Robotiq", 1, "N/A", "140 mm stroke",
        "robotiq/robotiq_2f_140.urdf", "Adaptive parallel gripper")
    return db


ROBOT_DATABASE: Dict[str, RobotInfo] = _families()


def _data_roots() -> List[Path]:
    roots = [_VENDORED]
    env = os.environ.get("MANIPULAPY_TPU_DATA")
    if env:
        roots.append(Path(env))
    return roots


def get_robot_urdf(robot_name: str) -> str:
    """Absolute path of the robot's calibrated URDF XML
    (reference ``ManipulaPy_data/__init__.py:317``)."""
    key = robot_name.lower()
    if key not in ROBOT_DATABASE:
        raise KeyError(
            f"Unknown robot {robot_name!r}. Available: {list_robots()}"
        )
    rel = ROBOT_DATABASE[key].urdf
    for root in _data_roots():
        cand = root / rel
        if cand.is_file():
            return str(cand)
    raise FileNotFoundError(
        f"URDF for {robot_name!r} not found under any data root "
        f"({[str(r) for r in _data_roots()]}); the package's data/robots/ copy is missing"
    )


def _canonical_keys() -> List[str]:
    """One key per physical robot: the PRIMARY registration keys (the
    spelling the artifacts and URDF paths use), aliases excluded."""
    return sorted(_PRIMARY_KEYS)


def list_robots(include_aliases: bool = False) -> List[str]:
    """Catalog keys; aliases ('franka_panda' for 'panda', ...) excluded
    by default — a caller enumerating robots to benchmark must not
    process the same robot twice."""
    return sorted(ROBOT_DATABASE) if include_aliases else _canonical_keys()


def get_robots_by_dof(dof: int, include_aliases: bool = False) -> List[str]:
    keys = sorted(ROBOT_DATABASE) if include_aliases else _canonical_keys()
    return [k for k in keys if ROBOT_DATABASE[k].dof == dof]


@lru_cache(maxsize=None)
def _extract(key: str, tip_link: Optional[str], chain_joints_only: bool = False):
    from ..urdf.core import URDF

    u = URDF.load(get_robot_urdf(key))
    return u, u.extract_screw_axes(tip_link, chain_joints_only=chain_joints_only)


def load_robot(
    name: str,
    dtype=None,
    tip_link: Optional[str] = None,
    chain_joints_only: bool = False,
    device=None,
):
    """Build a :class:`RobotModel` from the calibrated URDF, float32 on the
    CUDA card unless ``dtype`` and ``device`` say otherwise. Host-side
    parsing/extraction AND the built model are cached per
    (robot, dtype, device, tip_link, chain_joints_only) — RobotModel is
    immutable, so sharing one object is safe, and returning the same
    object keeps downstream engine caches
    (``trajectory._ENGINE_CACHE``) warm across repeated loads.

    ``tip_link`` picks the end-effector frame; ``chain_joints_only=True``
    additionally restricts the joints to the root->tip chain (e.g.
    ``load_robot("panda", tip_link="panda_hand", chain_joints_only=True)``
    is the 7-DOF arm without the finger joint)."""
    key = name.lower()
    if key not in ROBOT_DATABASE:
        raise KeyError(f"Unknown robot {name!r}. Available: {list_robots()}")
    dtype = torch.float32 if dtype is None else dtype
    device = torch.device("cuda" if device is None else device)
    return _build_model_cached(key, dtype, device, tip_link, chain_joints_only)


@lru_cache(maxsize=64)
def _build_model_cached(
    key: str,
    dtype: torch.dtype,
    device: torch.device,
    tip_link: Optional[str],
    chain_joints_only: bool,
):
    from .robot import make_robot_model

    _, data = _extract(key, tip_link, chain_joints_only)
    return make_robot_model(
        data["M"],
        data["S_list"],
        screws_body=data["B_list"],
        inertias=data["G_list"],
        com_home=data["Mlist_per_link"],
        joint_limits=list(zip(data["joint_lower"], data["joint_upper"])),
        velocity_limits=data["velocity"],
        torque_limits=data["effort"],
        dtype=dtype,
        device=device,
    )


def print_robot_catalog() -> None:
    seen = set()
    print(f"{'key':<16} {'dof':>3}  {'payload':<9} {'reach':<14} name")
    for key in list_robots():
        info = ROBOT_DATABASE[key]
        if info in seen:
            continue
        seen.add(info)
        print(f"{key:<16} {info.dof:>3}  {info.payload:<9} {info.reach:<14} {info.name}")
