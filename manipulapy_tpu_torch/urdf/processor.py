"""One-stop URDF → robot model facade.

Counterpart of ``manipulapy_tpu/urdf/processor.py``. Behavioural
counterpart of the reference's ``URDFToSerialManipulator``
(``urdf_processor.py:57-677``): load a URDF (path, string, or catalog
name), extract the screw-axis model, and hand back ready-to-use
kinematics/dynamics/IK entry points. Where the reference constructs
stateful ``SerialManipulator``/``ManipulatorDynamics`` objects, this
facade produces one immutable
:class:`~manipulapy_tpu_torch.models.RobotModel`, the single artifact every
function of the port takes.

The reference's optional PyBullet joint-limit override
(``urdf_processor.py:220-262``) is supported via ``joint_limits``
overrides; its batch-FK passthrough (``urdf_processor.py:435-483``)
becomes one call of :func:`~manipulapy_tpu_torch.kinematics.forward_kinematics`,
which batches over leading dimensions; its IK method dispatch
(``urdf_processor.py:502-534``) maps to the ``ik``/``trac_ik`` solvers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.robot import RobotModel
from .core import URDF

__all__ = ["URDFToRobotModel"]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class URDFToRobotModel:
    """Load a URDF and expose the full manipulator stack.

    Parameters
    ----------
    source:
        Filesystem path to a ``.urdf``/``.xacro`` file, a raw URDF XML
        string (detected by a leading ``<``), or a bundled catalog robot
        name (e.g. ``"ur5"`` — resolved via
        :func:`manipulapy_tpu_torch.models.data.get_robot_urdf`).
    tip_link:
        End-effector link; defaults to the deepest leaf of the chain.
    joint_limits:
        Optional ``(lower, upper)`` arrays overriding the URDF limits
        (the reference's PyBullet-override escape hatch).
    dtype:
        Numeric dtype of the resulting model (default float32 — the
        kernels' dtype; use float64 for oracle-grade parity).
    device:
        Device of the model's tensors; the CUDA card unless named.
    """

    def __init__(
        self,
        source: str,
        tip_link: Optional[str] = None,
        joint_limits: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
        dtype=torch.float32,
        device=None,
    ):
        self.source = source
        if source.lstrip().startswith("<"):
            self.urdf = URDF.from_string(source)
        elif os.path.exists(source):
            self.urdf = URDF.load(source)
        else:
            from ..models.data import get_robot_urdf

            self.urdf = URDF.load(get_robot_urdf(source))
        self.tip_link = tip_link
        model = self.urdf.to_robot_model(tip_link=tip_link, dtype=dtype, device=device)
        if joint_limits is not None:
            lower = torch.as_tensor(joint_limits[0], dtype=dtype, device=model.device)
            upper = torch.as_tensor(joint_limits[1], dtype=dtype, device=model.device)
            model = dataclasses.replace(model, joint_lower=lower, joint_upper=upper)
        self.model: RobotModel = model

    # -- introspection -------------------------------------------------
    @property
    def num_joints(self) -> int:
        return self.model.num_joints

    def robot_data(self) -> Dict[str, np.ndarray]:
        """The raw extracted arrays (M, Slist, Blist, Glist, limits) —
        shape-compatible with the reference's ``_extract_robot_data``
        dict (``urdf_processor.py:170-196``)."""
        m = self.model
        return {
            "M": _np(m.home),
            "Slist": _np(m.screws_space).T,  # (6, n) reference layout
            "Blist": _np(m.screws_body).T,
            "Glist": _np(m.inertias),
            "joint_limits": np.stack([_np(m.joint_lower), _np(m.joint_upper)], axis=1),
            "chain_links": list(self.urdf.get_chain(self.tip_link)),
        }

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.model.dtype, device=self.model.device)

    # -- kinematics ----------------------------------------------------
    def forward_kinematics(self, q, frame: str = "space") -> torch.Tensor:
        from ..kinematics import forward_kinematics

        return forward_kinematics(self.model, self._tensor(q), frame)

    def batch_forward_kinematics(self, qs) -> torch.Tensor:
        """(B, n) joint configs → (B, 4, 4) EE poses in one batched call —
        the reference loops ``link_fk_batch`` on host
        (``urdf_processor.py:435-483``)."""
        from ..kinematics import forward_kinematics

        return forward_kinematics(self.model, self._tensor(qs))

    def jacobian(self, q, frame: str = "space") -> torch.Tensor:
        from ..kinematics import jacobian

        return jacobian(self.model, self._tensor(q), frame)

    # -- IK dispatch (reference: urdf_processor.py:502-534) -------------
    def inverse_kinematics(self, T_desired, theta0=None, method: str = "iterative", **kw):
        model = self.model
        T_desired = self._tensor(T_desired)
        if theta0 is None:
            theta0 = 0.5 * (model.joint_lower + model.joint_upper)
        theta0 = self._tensor(theta0)
        if method in ("iterative", "dls"):
            from ..ik import solve_ik

            return solve_ik(model, T_desired, theta0, **kw)
        if method in ("smart", "robust", "multi_start"):
            from ..ik import multi_start_ik

            return multi_start_ik(model, T_desired, theta0=theta0, **kw)
        if method == "trac_ik":
            from ..trac_ik import trac_ik_solve

            return trac_ik_solve(model, T_desired, theta0=theta0, **kw)
        raise ValueError(
            f"unknown IK method {method!r}; expected iterative|dls|smart|robust|multi_start|trac_ik"
        )

    # -- dynamics ------------------------------------------------------
    def inverse_dynamics(self, q, dq, ddq, g=None, f_tip=None) -> torch.Tensor:
        from ..dynamics import inverse_dynamics

        t = self._tensor
        return inverse_dynamics(self.model, t(q), t(dq), t(ddq), g=g, f_tip=f_tip)

    def forward_dynamics(self, q, dq, tau, g=None, f_tip=None) -> torch.Tensor:
        from ..dynamics import forward_dynamics

        t = self._tensor
        return forward_dynamics(self.model, t(q), t(dq), t(tau), g=g, f_tip=f_tip)

    # -- convenience ---------------------------------------------------
    def planner(self, **kw):
        from ..planner import TrajectoryPlanner

        return TrajectoryPlanner(self.model, **kw)

    def simulation(self, **kw):
        from ..sim import Simulation

        return Simulation(self.model, **kw)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"URDFToRobotModel({self.source!r}, n={self.model.num_joints}, "
            f"dtype={self.model.dtype})"
        )
