"""Robot models: the :class:`RobotModel` dataclass and the catalogs.

Counterpart of ``manipulapy_tpu/models/__init__.py``, with its exports.
``catalog`` holds the programmatic factories and ``get_robot``;
``robot_data`` the calibrated catalog of vendored reference URDFs;
``data`` the DH-table generated catalog.
"""

from . import catalog, data, robot_data  # noqa: F401
from .data import get_robots_by_dof, load_robot, print_robot_catalog  # noqa: F401
from .robot import (  # noqa: F401
    HOST_ARRAY_KEYS,
    RobotModel,
    from_host_arrays,
    host_arrays,
    make_robot_model,
)
from .robot_data import get_robot_urdf  # noqa: F401

__all__ = [
    "RobotModel",
    "make_robot_model",
    "HOST_ARRAY_KEYS",
    "host_arrays",
    "from_host_arrays",
    "catalog",
    "data",
    "robot_data",
    "get_robot_urdf",
    "get_robots_by_dof",
    "load_robot",
    "print_robot_catalog",
]
