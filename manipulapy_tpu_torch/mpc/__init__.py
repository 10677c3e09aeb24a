"""Receding-horizon MPC: the generic iLQR, its cost library, the batched
fused tracking solver (kernels K2-K5, ``ops/cuda_mpc_batch.py``) and the
single-problem fused tracking solver (kernels K6-K8,
``ops/cuda_mpc_single.py``)."""

from .costs import make_tracking_costs, obstacle_cost, pose_tracking_cost, quadratic_tracking_cost
from .fused import TrackingMPC, build_tracking_mpc
from .fused_batch import BatchTrackingMPC, batch_mpc_step, build_batch_tracking_mpc
from .ilqr import ILQRParams, ILQRResult, ilqr, make_step_fn, mpc_step

__all__ = [
    "ILQRParams",
    "ILQRResult",
    "ilqr",
    "make_step_fn",
    "mpc_step",
    "TrackingMPC",
    "build_tracking_mpc",
    "BatchTrackingMPC",
    "build_batch_tracking_mpc",
    "batch_mpc_step",
    "quadratic_tracking_cost",
    "pose_tracking_cost",
    "make_tracking_costs",
    "obstacle_cost",
]
