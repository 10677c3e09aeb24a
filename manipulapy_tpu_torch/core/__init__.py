"""L0 math: SO(3)/SE(3) primitives and polynomial time scaling."""

from . import lie, time_scaling  # noqa: F401
