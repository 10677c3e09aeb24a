"""Robot models: the :class:`RobotModel` dataclass and the catalog."""

from . import catalog  # noqa: F401
from .robot import (  # noqa: F401
    HOST_ARRAY_KEYS,
    RobotModel,
    from_host_arrays,
    host_arrays,
    make_robot_model,
)
