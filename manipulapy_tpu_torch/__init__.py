"""manipulapy_tpu_torch — the PyTorch + CUDA port of ``manipulapy_tpu``.

Each module here has exactly one counterpart of the same name in the JAX
package, which stays the reference: the port's tests feed both the same
inputs and compare. The port imports ``torch`` and ``numpy`` and never
``jax``, not even indirectly, so it runs on hosts without JAX.

Idiom:

* plain functions on tensors, batched over leading dimensions;
* :class:`~manipulapy_tpu_torch.models.RobotModel`, a frozen dataclass of
  tensors, with an explicit ``.to(device, dtype)``;
* ``nn.Module`` rollout engines (``ops/fd_step.py::build_rollout``, the
  plain PyTorch version, and ``ops/cuda_rollout.py``, the hand-written
  CUDA kernel for Hopper), chosen per call by ``ops/dispatch.py``;
* the planning path: ``trajectory.joint_trajectory`` and
  ``potential_field.cartesian_potential_field`` over two more hand-written
  CUDA kernels (``ops/elementwise.py``), the stateful
  ``planner.TrajectoryPlanner``, the controllers of ``control`` and the
  checks of ``singularity``;
* the batched fused MPC solver (``mpc/fused_batch.py``) over four
  hand-written CUDA kernels (``ops/cuda_mpc_batch.py``), each with its
  plain PyTorch version, and the generic iLQR (``mpc/ilqr.py``) with its
  sequential or associative-scan (``mpc/pscan.py``) Riccati pass;
* the closed loop and the fleet: the simulated plant (``sim``), the IK
  family (``ik``, ``ik_cache``, ``trac_ik``) as masked batched loops, and
  ``parallel``, a mesh of devices that splits the scenario axis of the
  rollout (K1), IK and the batched fused solver (K2-K5) over a fleet of
  robots;
* models and entry points on the CUDA card unless the caller names the
  CPU.

Importing the package flips no global state. In particular TF32 stays
off: ``torch.get_float32_matmul_precision()`` keeps its default
``"highest"``, the counterpart of the JAX package's full-precision matmul
default (``manipulapy_tpu/__init__.py``), which exists because reduced
precision passes moved UR5 torques by about 0.8 N·m.

Submodules load lazily on first attribute access.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "core",
    "models",
    "kinematics",
    "dynamics",
    "trajectory",
    "potential_field",
    "planner",
    "control",
    "ik",
    "ik_cache",
    "trac_ik",
    "singularity",
    "mpc",
    "parallel",
    "ops",
    "sim",
)

_LAZY_ATTRS = {
    "RobotModel": ("models", "RobotModel"),
    "make_robot_model": ("models", "make_robot_model"),
    "from_host_arrays": ("models", "from_host_arrays"),
    "TrajectoryPlanner": ("planner", "TrajectoryPlanner"),
    "create_planner": ("planner", "create_planner"),
}


def __getattr__(name: str):
    if name in _SUBMODULES:
        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    if name in _LAZY_ATTRS:
        mod_name, attr = _LAZY_ATTRS[name]
        value = getattr(importlib.import_module(f".{mod_name}", __name__), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES) | set(_LAZY_ATTRS))
