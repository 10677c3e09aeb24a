"""URDF modification & re-export: calibration edits on a deep copy.

Counterpart of ``manipulapy_tpu/urdf/modifiers.py``, the same code.

Capability parity with the reference's ``ManipulaPy/urdf/modifiers.py``
(``URDFModifier``, 797 LoC): joint origin/axis/limit edits, joint zero
offsets, link mass/inertia/CoM edits, payload attachment, mass scaling,
renaming, re-export to URDF XML, and calibration-file save/load. All
edits operate on a deep copy of the parsed document — the original URDF
object is never mutated — and ``modified_urdf`` re-runs tree construction
so downstream ``to_robot_model`` picks the edits up.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional
from xml.etree import ElementTree as ET

import numpy as np

from .core import URDF
from .parser import ParsedRobot
from .types import (
    Box,
    Collision,
    Cylinder,
    Inertial,
    Joint,
    JointLimit,
    JointType,
    Link,
    Mesh,
    Origin,
    Sphere,
    Visual,
)

__all__ = ["URDFModifier", "urdf_to_xml"]


class URDFModifier:
    """Stateful editor over a deep-copied :class:`ParsedRobot`
    (reference ``modifiers.py:50-797``)."""

    def __init__(self, urdf: URDF):
        self._source = urdf
        self.robot: ParsedRobot = copy.deepcopy(urdf.robot)
        # Joint zero offsets are calibration state, applied at export.
        self.zero_offsets: Dict[str, float] = {}

    # -- lookups --------------------------------------------------------------

    def _joint(self, name: str) -> Joint:
        try:
            return self.robot.joint_map[name]
        except KeyError:
            raise KeyError(f"Unknown joint {name!r}") from None

    def _link(self, name: str) -> Link:
        try:
            return self.robot.link_map[name]
        except KeyError:
            raise KeyError(f"Unknown link {name!r}") from None

    # -- joint edits (reference modifiers.py:92-250) ---------------------------

    def set_joint_origin(self, joint: str, xyz=None, rpy=None) -> None:
        j = self._joint(joint)
        if xyz is not None:
            j.origin.xyz = np.asarray(xyz, dtype=np.float64).reshape(3)
        if rpy is not None:
            j.origin.rpy = np.asarray(rpy, dtype=np.float64).reshape(3)

    def set_joint_axis(self, joint: str, axis) -> None:
        a = np.asarray(axis, dtype=np.float64).reshape(3)
        norm = np.linalg.norm(a)
        if norm < 1e-12:
            raise ValueError("Joint axis must be non-zero")
        self._joint(joint).axis = a / norm

    def set_joint_limits(
        self, joint: str, lower=None, upper=None, effort=None, velocity=None
    ) -> None:
        j = self._joint(joint)
        if j.limit is None:
            j.limit = JointLimit()
        if lower is not None:
            j.limit.lower = float(lower)
        if upper is not None:
            j.limit.upper = float(upper)
        if effort is not None:
            j.limit.effort = float(effort)
        if velocity is not None:
            j.limit.velocity = float(velocity)

    def set_joint_zero_offset(self, joint: str, offset: float) -> None:
        """Calibration zero offset, folded into the joint origin at export
        (rotation about / translation along the joint axis by ``offset``,
        reference ``modifiers.py:180-229``)."""
        self._joint(joint)  # existence check
        self.zero_offsets[joint] = float(offset)

    # -- link edits (reference modifiers.py:252-370) ----------------------------

    def set_link_mass(self, link: str, mass: float) -> None:
        l = self._link(link)
        if l.inertial is None:
            l.inertial = Inertial(mass=float(mass))
        else:
            l.inertial.mass = float(mass)

    def set_link_inertia(self, link: str, inertia) -> None:
        l = self._link(link)
        I = np.asarray(inertia, dtype=np.float64).reshape(3, 3)
        if l.inertial is None:
            l.inertial = Inertial(inertia=I)
        else:
            l.inertial.inertia = I

    def set_link_com(self, link: str, xyz) -> None:
        l = self._link(link)
        if l.inertial is None:
            l.inertial = Inertial()
        l.inertial.origin.xyz = np.asarray(xyz, dtype=np.float64).reshape(3)

    def scale_masses(self, factor: float, links: Optional[List[str]] = None) -> None:
        """Uniform mass (and inertia) scaling (reference
        ``modifiers.py:431-470``)."""
        names = links if links is not None else list(self.robot.link_map)
        for name in names:
            l = self._link(name)
            if l.inertial is not None:
                l.inertial.mass *= factor
                l.inertial.inertia = l.inertial.inertia * factor

    def attach_payload(
        self,
        link: str,
        mass: float,
        com_offset=(0.0, 0.0, 0.0),
        inertia=None,
        name: str = "payload",
    ) -> None:
        """Rigidly attach a point-mass payload to ``link`` by merging it
        into the link's inertial properties (reference
        ``modifiers.py:372-429``): combined mass, mass-weighted CoM, and
        parallel-axis-combined inertia about the new CoM."""
        l = self._link(link)
        if l.inertial is None:
            l.inertial = Inertial()
        m1 = l.inertial.mass
        c1 = l.inertial.origin.xyz
        I1 = l.inertial.inertia
        m2 = float(mass)
        c2 = np.asarray(com_offset, dtype=np.float64).reshape(3)
        I2 = (
            np.asarray(inertia, dtype=np.float64).reshape(3, 3)
            if inertia is not None
            else np.zeros((3, 3))
        )
        m = m1 + m2
        c = (m1 * c1 + m2 * c2) / m if m > 0 else c1

        def shift(I, mi, ci):
            d = ci - c
            return I + mi * (float(d @ d) * np.eye(3) - np.outer(d, d))

        l.inertial.mass = m
        l.inertial.origin.xyz = c
        l.inertial.inertia = shift(I1, m1, c1) + shift(I2, m2, c2)

    # -- renames (reference modifiers.py:472-540) -------------------------------

    def rename_link(self, old: str, new: str) -> None:
        if new in self.robot.link_map:
            raise ValueError(f"Link name {new!r} already exists")
        l = self._link(old)
        l.name = new
        self.robot.link_map[new] = self.robot.link_map.pop(old)
        for j in self.robot.joints:
            if j.parent == old:
                j.parent = new
            if j.child == old:
                j.child = new

    def rename_joint(self, old: str, new: str) -> None:
        if new in self.robot.joint_map:
            raise ValueError(f"Joint name {new!r} already exists")
        j = self._joint(old)
        j.name = new
        self.robot.joint_map[new] = self.robot.joint_map.pop(old)
        if old in self.zero_offsets:
            self.zero_offsets[new] = self.zero_offsets.pop(old)
        for other in self.robot.joints:
            if other.mimic is not None and other.mimic.joint == old:
                other.mimic.joint = new

    # -- materialization ---------------------------------------------------------

    def _apply_zero_offsets(self, robot: ParsedRobot) -> ParsedRobot:
        for name, offset in self.zero_offsets.items():
            j = robot.joint_map[name]
            if j.joint_type in (JointType.REVOLUTE, JointType.CONTINUOUS):
                extra = Joint(
                    name=name, joint_type=j.joint_type, origin=j.origin, axis=j.axis
                ).child_pose(offset)
            else:
                extra = j.origin.matrix.copy()
                extra[:3, 3] += j.axis * offset
            # Fold the offset pose back into an Origin (rotation -> rpy).
            R = extra[:3, :3]
            sy = np.hypot(R[0, 0], R[1, 0])
            if sy > 1e-9:
                rpy = [
                    np.arctan2(R[2, 1], R[2, 2]),
                    np.arctan2(-R[2, 0], sy),
                    np.arctan2(R[1, 0], R[0, 0]),
                ]
            else:
                rpy = [np.arctan2(-R[1, 2], R[1, 1]), np.arctan2(-R[2, 0], sy), 0.0]
            j.origin = Origin(xyz=extra[:3, 3], rpy=rpy)
        return robot

    def modified_urdf(self) -> URDF:
        """A fresh :class:`URDF` from the edited document."""
        robot = self._apply_zero_offsets(copy.deepcopy(self.robot))
        return URDF(robot)

    def to_xml(self) -> str:
        """Re-export the edited document as URDF XML (reference
        ``modifiers.py:542-711``)."""
        return urdf_to_xml(self._apply_zero_offsets(copy.deepcopy(self.robot)))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_xml())

    # -- calibration files (reference modifiers.py:713-797) ----------------------

    def save_calibration(self, path: str) -> None:
        """JSON snapshot of the *edits* relative to the source document."""
        cal = {"zero_offsets": dict(self.zero_offsets), "joints": {}, "links": {}}
        for name, j in self.robot.joint_map.items():
            src = self._source.robot.joint_map.get(name)
            if src is None:
                continue
            entry = {}
            if not np.allclose(j.origin.xyz, src.origin.xyz) or not np.allclose(
                j.origin.rpy, src.origin.rpy
            ):
                entry["origin"] = {"xyz": j.origin.xyz.tolist(), "rpy": j.origin.rpy.tolist()}
            if not np.allclose(j.axis, src.axis):
                entry["axis"] = j.axis.tolist()
            if entry:
                cal["joints"][name] = entry
        for name, l in self.robot.link_map.items():
            src = self._source.robot.link_map.get(name)
            if src is None or l.inertial is None:
                continue
            if (
                src.inertial is None
                or l.inertial.mass != src.inertial.mass
                or not np.allclose(l.inertial.origin.xyz, src.inertial.origin.xyz)
                or not np.allclose(l.inertial.inertia, src.inertial.inertia)
            ):
                cal["links"][name] = {
                    "mass": l.inertial.mass,
                    "com": l.inertial.origin.xyz.tolist(),
                    "inertia": l.inertial.inertia.tolist(),
                }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(cal, f, indent=2)

    def load_calibration(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            cal = json.load(f)
        for name, off in cal.get("zero_offsets", {}).items():
            self.set_joint_zero_offset(name, off)
        for name, entry in cal.get("joints", {}).items():
            if "origin" in entry:
                self.set_joint_origin(name, entry["origin"]["xyz"], entry["origin"]["rpy"])
            if "axis" in entry:
                self.set_joint_axis(name, entry["axis"])
        for name, entry in cal.get("links", {}).items():
            self.set_link_mass(name, entry["mass"])
            self.set_link_com(name, entry["com"])
            self.set_link_inertia(name, entry["inertia"])


# -- XML writer ----------------------------------------------------------------


def _fmt(values) -> str:
    return " ".join(f"{float(v):.12g}" for v in np.atleast_1d(values))


def _origin_el(parent: ET.Element, origin: Origin) -> None:
    if np.allclose(origin.xyz, 0) and np.allclose(origin.rpy, 0):
        return
    ET.SubElement(parent, "origin", xyz=_fmt(origin.xyz), rpy=_fmt(origin.rpy))


def _geometry_el(parent: ET.Element, geom) -> None:
    g = ET.SubElement(parent, "geometry")
    if isinstance(geom, Box):
        ET.SubElement(g, "box", size=_fmt(geom.size))
    elif isinstance(geom, Cylinder):
        ET.SubElement(g, "cylinder", radius=f"{geom.radius:.12g}", length=f"{geom.length:.12g}")
    elif isinstance(geom, Sphere):
        ET.SubElement(g, "sphere", radius=f"{geom.radius:.12g}")
    elif isinstance(geom, Mesh):
        attrs = {"filename": geom.filename}
        if not np.allclose(geom.scale, 1.0):
            attrs["scale"] = _fmt(geom.scale)
        ET.SubElement(g, "mesh", **attrs)


def urdf_to_xml(robot: ParsedRobot) -> str:
    """Serialize a :class:`ParsedRobot` back to URDF XML."""
    root = ET.Element("robot", name=robot.name)
    for link in robot.links:
        el = ET.SubElement(root, "link", name=link.name)
        if link.inertial is not None:
            inel = ET.SubElement(el, "inertial")
            _origin_el(inel, link.inertial.origin)
            ET.SubElement(inel, "mass", value=f"{link.inertial.mass:.12g}")
            I = link.inertial.inertia
            ET.SubElement(
                inel,
                "inertia",
                ixx=f"{I[0,0]:.12g}",
                ixy=f"{I[0,1]:.12g}",
                ixz=f"{I[0,2]:.12g}",
                iyy=f"{I[1,1]:.12g}",
                iyz=f"{I[1,2]:.12g}",
                izz=f"{I[2,2]:.12g}",
            )
        for v in link.visuals:
            vel = ET.SubElement(el, "visual")
            _origin_el(vel, v.origin)
            if v.geometry is not None:
                _geometry_el(vel, v.geometry)
            if v.material:
                ET.SubElement(vel, "material", name=v.material)
        for c in link.collisions:
            cel = ET.SubElement(el, "collision")
            _origin_el(cel, c.origin)
            if c.geometry is not None:
                _geometry_el(cel, c.geometry)
    for j in robot.joints:
        el = ET.SubElement(root, "joint", name=j.name, type=j.joint_type.value)
        _origin_el(el, j.origin)
        ET.SubElement(el, "parent", link=j.parent)
        ET.SubElement(el, "child", link=j.child)
        if j.joint_type != JointType.FIXED:
            ET.SubElement(el, "axis", xyz=_fmt(j.axis))
        if j.limit is not None:
            attrs = {}
            for k in ("lower", "upper", "effort", "velocity"):
                v = getattr(j.limit, k)
                if v is not None:
                    attrs[k] = f"{v:.12g}"
            if attrs:
                ET.SubElement(el, "limit", **attrs)
        if j.dynamics is not None:
            ET.SubElement(
                el,
                "dynamics",
                damping=f"{j.dynamics.damping:.12g}",
                friction=f"{j.dynamics.friction:.12g}",
            )
        if j.mimic is not None:
            ET.SubElement(
                el,
                "mimic",
                joint=j.mimic.joint,
                multiplier=f"{j.mimic.multiplier:.12g}",
                offset=f"{j.mimic.offset:.12g}",
            )
        if j.safety_controller is not None:
            sc = j.safety_controller
            ET.SubElement(
                el,
                "safety_controller",
                soft_lower_limit=f"{sc.soft_lower_limit:.12g}",
                soft_upper_limit=f"{sc.soft_upper_limit:.12g}",
                k_position=f"{sc.k_position:.12g}",
                k_velocity=f"{sc.k_velocity:.12g}",
            )
        if j.calibration is not None:
            attrs = {}
            if j.calibration.rising is not None:
                attrs["rising"] = f"{j.calibration.rising:.12g}"
            if j.calibration.falling is not None:
                attrs["falling"] = f"{j.calibration.falling:.12g}"
            ET.SubElement(el, "calibration", **attrs)
    for t in getattr(robot, "transmissions", []):
        tel = ET.SubElement(root, "transmission", name=t.name)
        if t.type:
            type_el = ET.SubElement(tel, "type")
            type_el.text = t.type
        for tj in t.joints:
            jel = ET.SubElement(tel, "joint", name=tj.name)
            if tj.hardware_interface:
                hw = ET.SubElement(jel, "hardwareInterface")
                hw.text = tj.hardware_interface
        for act in t.actuators:
            ael = ET.SubElement(tel, "actuator", name=act.name)
            if act.mechanical_reduction != 1.0:
                mr = ET.SubElement(ael, "mechanicalReduction")
                mr.text = f"{act.mechanical_reduction:.12g}"
            if act.hardware_interface:
                hw = ET.SubElement(ael, "hardwareInterface")
                hw.text = act.hardware_interface
    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)
