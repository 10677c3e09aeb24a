"""Immutable robot model: a frozen dataclass of tensors.

Counterpart of ``manipulapy_tpu/models/robot.py``. Every kinematics and
dynamics routine of the port is a plain function ``f(model, q, ...)`` over
a :class:`RobotModel`, whose nine fields are tensors on one device in one
dtype. Screw axes are row-major ``(n, 6)``. The factories here build on the
CUDA card unless ``device`` names another device.

The f64 NumPy source arrays of every model built here are kept in a host
registry with a sha256 digest, keyed by the model object and evicted when
the model is collected. The code generators (``ops/fd_step.py``) fold
robot geometry from these f64 arrays, and the rollout engine cache keys on
the digest. :func:`from_host_arrays` builds a model from the dict that the
JAX package's ``host_arrays(model)`` returns, so both packages can be given
the same robot.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "RobotModel",
    "HOST_ARRAY_KEYS",
    "host_arrays",
    "make_robot_model",
    "from_host_arrays",
]

HOST_ARRAY_KEYS = (
    "home",
    "screws_space",
    "screws_body",
    "inertias",
    "com_home",
    "joint_lower",
    "joint_upper",
    "velocity_limit",
    "torque_limit",
)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Product-of-exponentials model of a serial manipulator.

    Attributes:
        home: (4, 4) end-effector pose at the zero configuration.
        screws_space: (n, 6) space-frame screw axes ``[omega; v]`` rows.
        screws_body: (n, 6) body-frame screw axes.
        inertias: (n, 6, 6) spatial inertias, rotational block about the
            link frame, paired with CoM-frame Jacobians (the JAX package's
            contract).
        com_home: (n, 4, 4) base -> link-CoM transforms at q = 0.
        joint_lower / joint_upper: (n,) position limits (+-inf when absent).
        velocity_limit / torque_limit: (n,) magnitudes (+inf when absent).
    """

    home: torch.Tensor
    screws_space: torch.Tensor
    screws_body: torch.Tensor
    inertias: torch.Tensor
    com_home: torch.Tensor
    joint_lower: torch.Tensor
    joint_upper: torch.Tensor
    velocity_limit: torch.Tensor
    torque_limit: torch.Tensor

    @property
    def num_joints(self) -> int:
        return self.screws_space.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.screws_space.dtype

    @property
    def device(self) -> torch.device:
        return self.screws_space.device

    def to(self, device=None, dtype=None) -> "RobotModel":
        """The same robot with every field moved to ``device`` / cast to
        ``dtype``. The copy shares the f64 host arrays of this model: it
        has the same content, so it keeps the same digest."""
        moved = RobotModel(
            **{
                f.name: getattr(self, f.name).to(device=device, dtype=dtype)
                for f in dataclasses.fields(self)
            }
        )
        host = host_arrays(self)
        if host is not None:
            _register(moved, host)
        return moved

    def astype(self, dtype) -> "RobotModel":
        """The same robot with every field cast to ``dtype`` (the JAX
        package's name for ``to(dtype=...)``); it keeps the digest."""
        return self.to(dtype=dtype)

    @property
    def joint_limits(self) -> torch.Tensor:
        """(n, 2) stacked [lower, upper] limits."""
        return torch.stack([self.joint_lower, self.joint_upper], dim=-1)


_HOST_ARRAYS: dict = {}


def _register(model: RobotModel, frozen: dict) -> None:
    key = id(model)
    _HOST_ARRAYS[key] = frozen
    weakref.finalize(model, _HOST_ARRAYS.pop, key, None)


def _register_host_arrays(model: RobotModel, arrays: dict) -> None:
    """Remember immutable f64 copies of a model's source arrays and their
    sha256 digest, keyed by the identity of the model object.

    Keying by a shared tensor would serve stale arrays to a
    ``dataclasses.replace`` derivative with other limits; such a derivative
    misses here and callers read its tensors back instead. The digest is
    the JAX package's (sorted names, f64 bytes), so a robot has the same
    digest in both packages."""
    frozen = {}
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.array(arrays[name], dtype=np.float64, copy=True)
        a.setflags(write=False)
        frozen[name] = a
        h.update(name.encode())
        h.update(a.tobytes())
    frozen["digest"] = h.hexdigest()
    _register(model, frozen)


def host_arrays(model: RobotModel) -> Optional[dict]:
    """f64 NumPy source arrays of ``model`` (plus ``"digest"``), or None
    when the model was not built by this module (for example a
    ``dataclasses.replace`` derivative)."""
    return _HOST_ARRAYS.get(id(model))


def _trans_inv_np(T: np.ndarray) -> np.ndarray:
    R, p = T[:3, :3], T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -(R.T @ p)
    return out


def _adjoint_np(T: np.ndarray) -> np.ndarray:
    R, p = T[:3, :3], T[:3, 3]
    sk = np.array([[0.0, -p[2], p[1]], [p[2], 0.0, -p[0]], [-p[1], p[0], 0.0]])
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, :3] = sk @ R
    A[3:, 3:] = R
    return A


def _model_from_f64(arrays: dict, dtype, device) -> RobotModel:
    # Models live on the card unless the caller names another device; on a
    # host without one, this raises CUDA's own error.
    device = torch.device("cuda") if device is None else torch.device(device)
    fields = {
        name: torch.from_numpy(np.array(arrays[name], dtype=np.float64)).to(
            device=device, dtype=dtype
        )
        for name in HOST_ARRAY_KEYS
    }
    model = RobotModel(**fields)
    _register_host_arrays(model, {name: arrays[name] for name in HOST_ARRAY_KEYS})
    return model


def from_host_arrays(
    arrays: dict, dtype=torch.float32, device=None
) -> RobotModel:
    """Build a :class:`RobotModel` from a dict of f64 arrays keyed
    ``home ... torque_limit`` (the dict the JAX package's
    ``host_arrays(model)`` returns; its ``"digest"`` entry is ignored and
    recomputed)."""
    missing = [k for k in HOST_ARRAY_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"host arrays lack {missing}")
    return _model_from_f64(arrays, dtype, device)


def make_robot_model(
    home: np.ndarray,
    screws_space: np.ndarray,
    *,
    screws_body: Optional[np.ndarray] = None,
    inertias: Optional[np.ndarray] = None,
    com_home: Optional[np.ndarray] = None,
    joint_limits: Optional[Sequence[Tuple[Optional[float], Optional[float]]]] = None,
    velocity_limits: Optional[Sequence[float]] = None,
    torque_limits: Optional[Sequence[float]] = None,
    layout: str = "rows",
    dtype=torch.float32,
    device=None,
) -> RobotModel:
    """Build a :class:`RobotModel` from raw screw-theory data (f64 NumPy).

    Derivations as in the JAX package: body screws default to
    ``Ad(M^-1) S``; inertias default to identity; CoM homes default to the
    end-effector home; absent limits are +-inf. Screws are (n, 6) rows;
    ``layout="cols"`` takes (6, n) columns.
    """
    home = np.asarray(home, dtype=np.float64)
    S = np.asarray(screws_space, dtype=np.float64)
    if layout == "cols":
        S = S.T
    if S.ndim != 2 or S.shape[1] != 6:
        raise ValueError(
            f"screws_space must be (n, 6) row-major (got {S.shape}); pass "
            "layout='cols' for (6, n) column-major arrays"
        )
    n = S.shape[0]

    if screws_body is None:
        B = S @ _adjoint_np(_trans_inv_np(home)).T  # B_i = Ad(M^-1) S_i
    else:
        B = np.asarray(screws_body, dtype=np.float64)
        if layout == "cols":
            B = B.T
        if B.shape != (n, 6):
            raise ValueError(f"screws_body must be ({n}, 6), got {B.shape}")

    if inertias is None:
        G = np.tile(np.eye(6), (n, 1, 1))
    else:
        G = np.asarray(inertias, dtype=np.float64).reshape(n, 6, 6)
    if com_home is None:
        Mc = np.tile(home, (n, 1, 1))
    else:
        Mc = np.asarray(com_home, dtype=np.float64).reshape(n, 4, 4)

    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    if joint_limits is not None:
        for i, lim in enumerate(joint_limits):
            lo, hi = lim if lim is not None else (None, None)
            if lo is not None:
                lower[i] = lo
            if hi is not None:
                upper[i] = hi
    vel = np.full(n, np.inf)
    if velocity_limits is not None:
        vel = np.where(np.isfinite(velocity_limits), np.abs(velocity_limits), np.inf)
    tau = np.full(n, np.inf)
    if torque_limits is not None:
        tau = np.where(np.isfinite(torque_limits), np.abs(torque_limits), np.inf)

    arrays = {
        "home": home, "screws_space": S, "screws_body": B, "inertias": G,
        "com_home": Mc, "joint_lower": lower, "joint_upper": upper,
        "velocity_limit": np.asarray(vel, np.float64),
        "torque_limit": np.asarray(tau, np.float64),
    }
    return _model_from_f64(arrays, dtype, device)
