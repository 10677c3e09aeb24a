"""URDF structural validation.

Counterpart of ``manipulapy_tpu/urdf/validation.py``, the same code.

Capability parity with the reference's ``ManipulaPy/urdf/validation.py``
(``URDFValidator`` -> ``ValidationResult``, 378 LoC): unreachable links,
cycles/multi-parent links, dangling joint references, limit sanity,
inertial sanity (non-negative mass, symmetric positive-semidefinite
inertia, triangle inequality), mimic references, and duplicate names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

import numpy as np

from .parser import ParsedRobot
from .types import JointType

__all__ = ["Severity", "ValidationIssue", "ValidationResult", "URDFValidator", "validate"]


class Severity(Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


@dataclass
class ValidationIssue:
    severity: Severity
    code: str
    message: str
    element: Optional[str] = None

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        where = f" [{self.element}]" if self.element else ""
        return f"{self.severity.value.upper()} {self.code}{where}: {self.message}"


@dataclass
class ValidationResult:
    issues: List[ValidationIssue] = field(default_factory=list)

    @property
    def errors(self) -> List[ValidationIssue]:
        return [i for i in self.issues if i.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[ValidationIssue]:
        return [i for i in self.issues if i.severity == Severity.WARNING]

    @property
    def is_valid(self) -> bool:
        return not self.errors

    def add(self, severity: Severity, code: str, message: str, element: str = None):
        self.issues.append(ValidationIssue(severity, code, message, element))


class URDFValidator:
    """Structural checker over a parsed document (reference
    ``validation.py:40-378``)."""

    def validate(self, robot: ParsedRobot) -> ValidationResult:
        res = ValidationResult()
        self._check_names(robot, res)
        self._check_references(robot, res)
        self._check_structure(robot, res)
        self._check_limits(robot, res)
        self._check_inertials(robot, res)
        self._check_mimics(robot, res)
        self._check_transmissions(robot, res)
        return res

    # -- individual passes -----------------------------------------------------

    def _check_names(self, robot: ParsedRobot, res: ValidationResult) -> None:
        seen = set()
        for l in robot.links:
            if not l.name:
                res.add(Severity.ERROR, "empty_link_name", "Link with empty name")
            elif l.name in seen:
                res.add(Severity.ERROR, "duplicate_link", f"Duplicate link name {l.name!r}", l.name)
            seen.add(l.name)
        seen = set()
        for j in robot.joints:
            if not j.name:
                res.add(Severity.ERROR, "empty_joint_name", "Joint with empty name")
            elif j.name in seen:
                res.add(Severity.ERROR, "duplicate_joint", f"Duplicate joint name {j.name!r}", j.name)
            seen.add(j.name)

    def _check_references(self, robot: ParsedRobot, res: ValidationResult) -> None:
        links = set(robot.link_map)
        for j in robot.joints:
            if j.parent not in links:
                res.add(
                    Severity.ERROR,
                    "unknown_parent",
                    f"Joint {j.name!r} references unknown parent link {j.parent!r}",
                    j.name,
                )
            if j.child not in links:
                res.add(
                    Severity.ERROR,
                    "unknown_child",
                    f"Joint {j.name!r} references unknown child link {j.child!r}",
                    j.name,
                )
            if j.parent == j.child:
                res.add(
                    Severity.ERROR,
                    "self_loop",
                    f"Joint {j.name!r} connects link {j.parent!r} to itself",
                    j.name,
                )

    def _check_structure(self, robot: ParsedRobot, res: ValidationResult) -> None:
        """Cycles / multi-parent / unreachable links
        (reference ``validation.py:252-279``)."""
        parents = {}
        for j in robot.joints:
            if j.child in parents:
                res.add(
                    Severity.ERROR,
                    "multiple_parents",
                    f"Link {j.child!r} has multiple parent joints",
                    j.child,
                )
            parents[j.child] = j.parent
        roots = [name for name in robot.link_map if name not in parents]
        if not roots and robot.links:
            res.add(Severity.ERROR, "no_root", "No root link: the joint graph is cyclic")
            return
        # Reachability from the roots.
        children = {}
        for j in robot.joints:
            children.setdefault(j.parent, []).append(j.child)
        reachable = set()
        stack = list(roots)
        while stack:
            link = stack.pop()
            if link in reachable:
                res.add(Severity.ERROR, "cycle", f"Cycle through link {link!r}", link)
                continue
            reachable.add(link)
            stack.extend(children.get(link, []))
        for name in robot.link_map:
            if name not in reachable:
                res.add(
                    Severity.ERROR,
                    "unreachable_link",
                    f"Link {name!r} is not reachable from any root",
                    name,
                )
        if len(roots) > 1:
            res.add(
                Severity.WARNING,
                "multiple_roots",
                f"Document has {len(roots)} root links: {roots}",
            )

    def _check_limits(self, robot: ParsedRobot, res: ValidationResult) -> None:
        for j in robot.joints:
            if j.joint_type in (JointType.REVOLUTE, JointType.PRISMATIC):
                if j.limit is None:
                    res.add(
                        Severity.WARNING,
                        "missing_limit",
                        f"{j.joint_type.value} joint {j.name!r} has no <limit>",
                        j.name,
                    )
                    continue
                if (
                    j.limit.lower is not None
                    and j.limit.upper is not None
                    and j.limit.lower > j.limit.upper
                ):
                    res.add(
                        Severity.ERROR,
                        "inverted_limits",
                        f"Joint {j.name!r} lower limit exceeds upper limit",
                        j.name,
                    )
                if j.limit.effort is not None and j.limit.effort < 0:
                    res.add(Severity.ERROR, "negative_effort", f"Joint {j.name!r} effort < 0", j.name)
                if j.limit.velocity is not None and j.limit.velocity < 0:
                    res.add(Severity.ERROR, "negative_velocity", f"Joint {j.name!r} velocity < 0", j.name)
            if np.linalg.norm(j.axis) < 1e-12 and j.joint_type not in (
                JointType.FIXED,
                JointType.FLOATING,
            ):
                res.add(Severity.ERROR, "zero_axis", f"Joint {j.name!r} has a zero axis", j.name)

    def _check_inertials(self, robot: ParsedRobot, res: ValidationResult) -> None:
        for l in robot.links:
            if l.inertial is None:
                continue
            if l.inertial.mass < 0:
                res.add(Severity.ERROR, "negative_mass", f"Link {l.name!r} mass < 0", l.name)
            I = l.inertial.inertia
            if not np.allclose(I, I.T, atol=1e-9):
                res.add(
                    Severity.ERROR, "asymmetric_inertia", f"Link {l.name!r} inertia not symmetric", l.name
                )
                continue
            if np.any(I):
                eig = np.linalg.eigvalsh(I)
                if eig.min() < -1e-9:
                    res.add(
                        Severity.ERROR,
                        "indefinite_inertia",
                        f"Link {l.name!r} inertia has negative eigenvalue {eig.min():.3g}",
                        l.name,
                    )
                else:
                    a, b, c = np.sort(eig)
                    if a + b < c - 1e-9:
                        res.add(
                            Severity.WARNING,
                            "inertia_triangle",
                            f"Link {l.name!r} principal inertias violate the triangle inequality",
                            l.name,
                        )

    def _check_mimics(self, robot: ParsedRobot, res: ValidationResult) -> None:
        for j in robot.joints:
            if j.mimic is None:
                continue
            if j.mimic.joint not in robot.joint_map:
                res.add(
                    Severity.ERROR,
                    "unknown_mimic",
                    f"Joint {j.name!r} mimics unknown joint {j.mimic.joint!r}",
                    j.name,
                )
            elif j.mimic.joint == j.name:
                res.add(Severity.ERROR, "self_mimic", f"Joint {j.name!r} mimics itself", j.name)

    def _check_transmissions(self, robot: ParsedRobot, res: ValidationResult) -> None:
        """Transmission sanity (reference ``validation.py:328-360``):
        empty joint/actuator lists and dangling joint references warn;
        additionally a non-positive mechanical reduction is flagged."""
        for t in getattr(robot, "transmissions", []):
            tname = t.name or "<unnamed>"
            if not t.joints:
                res.add(
                    Severity.WARNING,
                    "transmission_no_joints",
                    f"Transmission {tname!r} has no joints",
                    tname,
                )
            if not t.actuators:
                res.add(
                    Severity.WARNING,
                    "transmission_no_actuators",
                    f"Transmission {tname!r} has no actuators",
                    tname,
                )
            for tj in t.joints:
                if tj.name not in robot.joint_map:
                    res.add(
                        Severity.WARNING,
                        "transmission_unknown_joint",
                        f"Transmission {tname!r} references unknown joint {tj.name!r}",
                        tname,
                    )
            for act in t.actuators:
                if act.mechanical_reduction <= 0:
                    res.add(
                        Severity.WARNING,
                        "transmission_bad_reduction",
                        f"Transmission {tname!r} actuator {act.name!r} has "
                        f"non-positive mechanical reduction {act.mechanical_reduction}",
                        tname,
                    )


def validate(robot: ParsedRobot) -> ValidationResult:
    """Convenience wrapper: ``URDFValidator().validate(robot)``."""
    return URDFValidator().validate(robot)
