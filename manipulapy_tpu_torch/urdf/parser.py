"""Native URDF XML parser (no external dependencies).

Counterpart of ``manipulapy_tpu/urdf/parser.py``, the same code.
Capability parity with the reference's ``ManipulaPy/urdf/parser.py``
(~875 LoC): parses ``<robot>`` documents into the dataclasses of
:mod:`manipulapy_tpu_torch.urdf.types`, resolving ``package://`` URIs through a
:class:`PackageResolver`. Malformed-XML recovery mirrors the reference's
behavior (``parser.py:189-227``): common breakages (stray ampersands,
missing closing tags) are repaired before re-raising.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .types import (
    Actuator,
    Box,
    Collision,
    Cylinder,
    Inertial,
    Joint,
    JointCalibration,
    JointDynamics,
    JointLimit,
    JointMimic,
    JointType,
    Link,
    Mesh,
    Origin,
    SafetyController,
    Sphere,
    Transmission,
    TransmissionJoint,
    Visual,
)

__all__ = ["URDFParser", "PackageResolver", "ParsedRobot"]


class PackageResolver:
    """Resolve ``package://`` / ``file://`` / relative URIs to paths.

    Counterpart of the reference's resolver (``urdf/resolver.py``):
    explicit package map > search paths > ``ROS_PACKAGE_PATH`` entries.
    """

    def __init__(
        self,
        package_map: Optional[Dict[str, str]] = None,
        search_paths: Optional[List[str]] = None,
    ):
        self.package_map = dict(package_map or {})
        self.search_paths = list(search_paths or [])
        ros_path = os.environ.get("ROS_PACKAGE_PATH", "")
        self.search_paths += [p for p in ros_path.split(":") if p]

    def resolve(self, uri: str, base_dir: Optional[str] = None) -> str:
        if uri.startswith("package://"):
            rest = uri[len("package://") :]
            pkg, _, rel = rest.partition("/")
            if pkg in self.package_map:
                return os.path.join(self.package_map[pkg], rel)
            for root in self.search_paths:
                cand = os.path.join(root, pkg, rel)
                if os.path.exists(cand):
                    return cand
            # Fall back to a sibling-directory guess relative to the URDF.
            if base_dir is not None:
                cand = os.path.join(base_dir, rel)
                if os.path.exists(cand):
                    return cand
            return rest
        if uri.startswith("file://"):
            return uri[len("file://") :]
        if base_dir is not None and not os.path.isabs(uri):
            return os.path.join(base_dir, uri)
        return uri


class ParsedRobot:
    """Raw parse result: named links/joints/transmissions plus document
    metadata."""

    def __init__(
        self,
        name: str,
        links: List[Link],
        joints: List[Joint],
        transmissions: Optional[List[Transmission]] = None,
    ):
        self.name = name
        self.links = links
        self.joints = joints
        self.transmissions = list(transmissions or [])
        self.link_map = {l.name: l for l in links}
        self.joint_map = {j.name: j for j in joints}


def _floats(
    text: Optional[str], n: int, default: float = 0.0, broadcast: bool = False
) -> np.ndarray:
    """Parse a whitespace/comma-separated float vector, padding missing
    components with ``default``. ``broadcast=True`` additionally expands
    a single value to all ``n`` components — correct for mesh *scale*
    (the URDF convention), but silently wrong for origin xyz/rpy or a
    joint axis, where ``xyz="0.5"`` must mean [0.5, default, default],
    not a displacement on three axes."""
    if not text:
        return np.full(n, default)
    vals = [float(x) for x in text.replace(",", " ").split()]
    if broadcast and len(vals) == 1 and n > 1:
        vals = vals * n
    return np.asarray(vals[:n] + [default] * (n - len(vals)))


class URDFParser:
    """XML -> dataclasses (reference ``URDFParser``, ``urdf/parser.py:60``)."""

    def __init__(self, resolver: Optional[PackageResolver] = None):
        self.resolver = resolver or PackageResolver()

    def parse_file(self, path: str) -> ParsedRobot:
        with open(path, "r", encoding="utf-8") as f:
            content = f.read()
        return self.parse_string(content, base_dir=os.path.dirname(os.path.abspath(path)))

    def parse_string(self, content: str, base_dir: Optional[str] = None) -> ParsedRobot:
        try:
            root = ET.fromstring(content)
        except ET.ParseError:
            root = ET.fromstring(self._repair_xml(content))
        if root.tag != "robot":
            raise ValueError(f"Expected <robot> root element, got <{root.tag}>")
        name = root.get("name", "robot")
        links = [self._parse_link(el, base_dir) for el in root.findall("link")]
        joints = [self._parse_joint(el) for el in root.findall("joint")]
        transmissions = [self._parse_transmission(el) for el in root.findall("transmission")]
        return ParsedRobot(name, links, joints, transmissions)

    @staticmethod
    def _repair_xml(content: str) -> str:
        """Best-effort recovery for common authoring mistakes
        (behavioural parity with ``parser.py:189-227``): stray
        ampersands, trailing junk after ``</robot>``, and a truncated
        document missing its closing tags."""
        fixed = re.sub(r"&(?!amp;|lt;|gt;|quot;|apos;|#)", "&amp;", content)
        end = fixed.rfind("</robot>")
        if end != -1:
            # Strip anything after the final closing tag (trailing junk).
            fixed = fixed[: end + len("</robot>")]
        elif "<robot" in fixed:
            # Truncated document: close any dangling open elements (in
            # reverse open order), then the root itself.
            open_tags = []
            for m in re.finditer(r"<(/?)([A-Za-z_][\w.-]*)([^<>]*?)(/?)>", fixed):
                closing, tag, _, selfclose = m.groups()
                if selfclose or tag.startswith("?") or tag.startswith("!"):
                    continue
                if closing:
                    while open_tags and open_tags[-1] != tag:
                        open_tags.pop()
                    if open_tags:
                        open_tags.pop()
                else:
                    open_tags.append(tag)
            # Drop a trailing partial tag (e.g. the file ends mid-'<link').
            last_lt = fixed.rfind("<")
            if last_lt > fixed.rfind(">"):
                fixed = fixed[:last_lt]
            fixed += "".join(f"</{t}>" for t in reversed(open_tags))
        return fixed

    # -- element parsers ----------------------------------------------------

    def _parse_origin(self, el: Optional[ET.Element]) -> Origin:
        if el is None:
            return Origin()
        return Origin(xyz=_floats(el.get("xyz"), 3), rpy=_floats(el.get("rpy"), 3))

    def _parse_geometry(self, el: Optional[ET.Element], base_dir: Optional[str]):
        if el is None:
            return None
        box = el.find("box")
        if box is not None:
            return Box(size=_floats(box.get("size"), 3, 1.0))
        cyl = el.find("cylinder")
        if cyl is not None:
            return Cylinder(
                radius=float(cyl.get("radius", 0.0)), length=float(cyl.get("length", 0.0))
            )
        sph = el.find("sphere")
        if sph is not None:
            return Sphere(radius=float(sph.get("radius", 0.0)))
        mesh = el.find("mesh")
        if mesh is not None:
            fn = mesh.get("filename", "")
            return Mesh(
                filename=self.resolver.resolve(fn, base_dir) if fn else "",
                scale=_floats(mesh.get("scale"), 3, 1.0, broadcast=True),
            )
        return None

    def _parse_inertial(self, el: Optional[ET.Element]) -> Optional[Inertial]:
        if el is None:
            return None
        mass_el = el.find("mass")
        mass = float(mass_el.get("value", 0.0)) if mass_el is not None else 0.0
        inertia = np.zeros((3, 3))
        in_el = el.find("inertia")
        if in_el is not None:
            ixx = float(in_el.get("ixx", 0.0))
            iyy = float(in_el.get("iyy", 0.0))
            izz = float(in_el.get("izz", 0.0))
            ixy = float(in_el.get("ixy", 0.0))
            ixz = float(in_el.get("ixz", 0.0))
            iyz = float(in_el.get("iyz", 0.0))
            inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        return Inertial(mass=mass, origin=self._parse_origin(el.find("origin")), inertia=inertia)

    def _parse_link(self, el: ET.Element, base_dir: Optional[str]) -> Link:
        visuals = [
            Visual(
                origin=self._parse_origin(v.find("origin")),
                geometry=self._parse_geometry(v.find("geometry"), base_dir),
                material=(v.find("material").get("name") if v.find("material") is not None else None),
            )
            for v in el.findall("visual")
        ]
        collisions = [
            Collision(
                origin=self._parse_origin(c.find("origin")),
                geometry=self._parse_geometry(c.find("geometry"), base_dir),
            )
            for c in el.findall("collision")
        ]
        return Link(
            name=el.get("name", ""),
            inertial=self._parse_inertial(el.find("inertial")),
            visuals=visuals,
            collisions=collisions,
        )

    def _parse_joint(self, el: ET.Element) -> Joint:
        jtype_str = el.get("type", "fixed")
        try:
            jtype = JointType(jtype_str)
        except ValueError:
            raise ValueError(f"Unknown joint type {jtype_str!r} in joint {el.get('name')!r}")

        parent_el = el.find("parent")
        child_el = el.find("child")
        axis_el = el.find("axis")
        limit_el = el.find("limit")
        dyn_el = el.find("dynamics")
        mimic_el = el.find("mimic")

        limit = None
        if limit_el is not None:
            limit = JointLimit(
                lower=(float(limit_el.get("lower")) if limit_el.get("lower") else None),
                upper=(float(limit_el.get("upper")) if limit_el.get("upper") else None),
                effort=(float(limit_el.get("effort")) if limit_el.get("effort") else None),
                velocity=(float(limit_el.get("velocity")) if limit_el.get("velocity") else None),
            )
        dynamics = None
        if dyn_el is not None:
            dynamics = JointDynamics(
                damping=float(dyn_el.get("damping", 0.0)),
                friction=float(dyn_el.get("friction", 0.0)),
            )
        mimic = None
        if mimic_el is not None:
            mimic = JointMimic(
                joint=mimic_el.get("joint", ""),
                multiplier=float(mimic_el.get("multiplier", 1.0)),
                offset=float(mimic_el.get("offset", 0.0)),
            )
        safety = None
        safety_el = el.find("safety_controller")
        if safety_el is not None:
            safety = SafetyController(
                soft_lower_limit=float(safety_el.get("soft_lower_limit", 0.0)),
                soft_upper_limit=float(safety_el.get("soft_upper_limit", 0.0)),
                k_position=float(safety_el.get("k_position", 0.0)),
                k_velocity=float(safety_el.get("k_velocity", 0.0)),
            )
        calibration = None
        cal_el = el.find("calibration")
        if cal_el is not None:
            rising, falling = cal_el.get("rising"), cal_el.get("falling")
            calibration = JointCalibration(
                rising=float(rising) if rising is not None else None,
                falling=float(falling) if falling is not None else None,
            )
        return Joint(
            name=el.get("name", ""),
            joint_type=jtype,
            parent=parent_el.get("link", "") if parent_el is not None else "",
            child=child_el.get("link", "") if child_el is not None else "",
            origin=self._parse_origin(el.find("origin")),
            axis=_floats(axis_el.get("xyz"), 3) if axis_el is not None else np.array([1.0, 0, 0]),
            limit=limit,
            dynamics=dynamics,
            mimic=mimic,
            safety_controller=safety,
            calibration=calibration,
        )

    def _parse_transmission(self, el: ET.Element) -> Transmission:
        """<transmission> -> :class:`Transmission` (reference
        ``urdf/parser.py:793-860``): type from a <type> child or ``type``
        attribute; nameless joints/actuators skipped; hardware interfaces
        from <hardwareInterface> children."""
        type_el = el.find("type")
        trans_type = (
            type_el.text.strip()
            if type_el is not None and type_el.text
            else el.get("type", "")
        )

        def hw_interface(parent: ET.Element) -> Optional[str]:
            hw = parent.find("hardwareInterface")
            return hw.text.strip() if hw is not None and hw.text else None

        joints = [
            TransmissionJoint(name=j.get("name"), hardware_interface=hw_interface(j))
            for j in el.findall("joint")
            if j.get("name")
        ]

        def reduction(a: ET.Element) -> float:
            # Non-numeric values exist in shipped URDFs (the vendored xarm
            # gripper has literal '<mechanicalReduction>reduction</...>');
            # the reference defaults those to 1.0 (urdf/parser.py:847-853).
            mech = a.find("mechanicalReduction")
            raw = (
                mech.text.strip()
                if mech is not None and mech.text
                else a.get("mechanicalReduction", "1.0")
            )
            try:
                return float(raw)
            except ValueError:
                return 1.0

        actuators = [
            Actuator(
                name=a.get("name"),
                mechanical_reduction=reduction(a),
                hardware_interface=hw_interface(a),
            )
            for a in el.findall("actuator")
            if a.get("name")
        ]
        return Transmission(
            name=el.get("name", ""), type=trans_type, joints=joints, actuators=actuators
        )
