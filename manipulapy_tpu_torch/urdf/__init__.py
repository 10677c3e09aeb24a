"""Native URDF subsystem: parser, kinematic tree, model export.

Counterpart of ``manipulapy_tpu/urdf/`` with the same modules and public
names; everything but :meth:`URDF.to_robot_model` and
:class:`URDFToRobotModel` is host-side NumPy copied from it.
``URDF.load(path).to_robot_model()`` is the pipeline from a robot
description file to the tensors of a
:class:`~manipulapy_tpu_torch.models.RobotModel`, on the CUDA card unless
``device`` names another device.
"""

from .core import URDF
from .geometry import TriMesh, box_mesh, cylinder_mesh, load_mesh, load_obj, load_stl, sphere_mesh
from .modifiers import URDFModifier, urdf_to_xml
from .parser import PackageResolver, URDFParser
from .processor import URDFToRobotModel
from .scene import RobotInstance, Scene
from .validation import URDFValidator, ValidationResult, validate
from .visualization import animate_robot, show_robot
from .xacro import XacroProcessor, process_xacro
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

__all__ = [
    "URDF",
    "URDFParser",
    "PackageResolver",
    "URDFToRobotModel",
    "Origin",
    "Inertial",
    "Link",
    "Joint",
    "JointType",
    "JointLimit",
    "JointDynamics",
    "JointMimic",
    "SafetyController",
    "JointCalibration",
    "Actuator",
    "TransmissionJoint",
    "Transmission",
    "Box",
    "Cylinder",
    "Sphere",
    "Mesh",
    "Visual",
    "Collision",
    "URDFModifier",
    "urdf_to_xml",
    "URDFValidator",
    "ValidationResult",
    "validate",
    "XacroProcessor",
    "process_xacro",
    "Scene",
    "RobotInstance",
    "TriMesh",
    "load_mesh",
    "load_stl",
    "load_obj",
    "box_mesh",
    "cylinder_mesh",
    "sphere_mesh",
    "show_robot",
    "animate_robot",
]
