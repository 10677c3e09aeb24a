"""Hand-written CUDA kernels of the planning path's elementwise passes (K9,
K10), with their plain PyTorch versions.

Counterpart of ``manipulapy_tpu/ops/pallas_kernels.py``:

* K9 ``trajectory`` (``_traj_kernel`` behind ``trajectory_pallas``): (B, J)
  start and end points, a duration ``Tf > 0`` and ``N > 1`` waypoints give
  positions, velocities and accelerations, each (B, N, J), under cubic (3),
  quintic (5) or linear (anything else) time scaling. Positions are not
  clipped to joint limits;
* K10 ``potential`` (``_potential_kernel`` behind
  ``cartesian_potential_pallas``): (P, 3) points, a (3,) goal, (O, 3)
  obstacle points and an influence distance give the potential (P,) and its
  gradient (P, 3); ``O`` may be 0.

The kernels are ``csrc/elementwise.cuh``, one static translation unit (no
robot constants), built once at first use. PyTorch runs eagerly and does
not fuse: the tensor formulation of K9 is ten ops and three passes over the
output, that of K10 some twenty ops over (P, O) intermediates, so on the
card these kernels serve ``trajectory.joint_trajectory`` and
``potential_field.cartesian_potential_field``.

:func:`trajectory_plain` and :func:`cartesian_potential_plain` repeat the
kernels' arithmetic operation for operation in eager PyTorch (K10: a loop
over the obstacles, in order), so with ``--fmad=false`` kernel and plain
version agree bitwise on the card.

:func:`trajectory_kernel` and :func:`cartesian_potential_kernel` are the
wrappers. On CPU tensors they run the plain version, and only because the
tensors lie on the CPU. On CUDA tensors they launch the kernel or raise:
float32, contiguous, one device, no input requiring grad (the kernels have
no backward). Each launch adds one to
``ElementwiseKernels.launch_count[stage]``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ._build import KernelSet

__all__ = [
    "ElementwiseKernels",
    "STAGES",
    "kernels",
    "trajectory_plain",
    "trajectory_kernel",
    "cartesian_potential_plain",
    "cartesian_potential_kernel",
]

TEMPLATE = Path(__file__).resolve().parents[1] / "csrc" / "elementwise.cuh"
STAGES = ("trajectory", "potential")
_P = ctypes.c_void_p
_ARGTYPES = {
    "trajectory": [_P] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int, _P],
    "potential": [_P] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [_P],
}


class ElementwiseKernels(KernelSet):
    """K9 and K10: one translation unit, two stages."""

    UNITS = {"elementwise": STAGES}
    ARGTYPES = _ARGTYPES
    LIB_PREFIX = "planning"
    launch_count: Dict[str, int] = dict.fromkeys(STAGES, 0)  # all instances

    def __init__(self):
        self.sources = {"elementwise": TEMPLATE.read_text()}


_KERNELS = None


def kernels() -> ElementwiseKernels:
    """The process's kernel set (built at its first launch or ``.build()``)."""
    global _KERNELS
    if _KERNELS is None:
        _KERNELS = ElementwiseKernels()
    return _KERNELS


# -- K9 ------------------------------------------------------------------------


def _check_trajectory(theta_start, theta_end, Tf, N):
    if theta_start.dim() != 2 or theta_start.shape != theta_end.shape:
        raise ValueError(
            f"endpoints must both be (B, J), got {tuple(theta_start.shape)} and {tuple(theta_end.shape)}"
        )
    Tf = float(Tf)
    if not Tf > 0.0 or int(N) <= 1:
        raise ValueError(f"the trajectory kernel takes Tf > 0 and N > 1, got Tf={Tf}, N={N}")
    return Tf, int(N)


def trajectory_plain(theta_start: torch.Tensor, theta_end: torch.Tensor, Tf, N: int, method: int = 5):
    """K9's arithmetic in eager PyTorch, operation for operation: (B, J)
    endpoints -> (pos, vel, acc), each (B, N, J), unclipped."""
    Tf, N = _check_trajectory(theta_start, theta_end, Tf, N)
    dtype, device = theta_start.dtype, theta_start.device
    t = torch.arange(N, dtype=dtype, device=device)
    # A tensor divisor: by a Python number PyTorch's CUDA division multiplies
    # by the reciprocal, which is not the kernel's IEEE division.
    tau = torch.clamp(t / torch.tensor(float(N - 1), dtype=dtype, device=device), 0.0, 1.0)
    inv_tf = 1.0 / torch.tensor(Tf, dtype=dtype, device=device)
    if method == 3:
        s = 3.0 * (tau * tau) - 2.0 * (tau * tau * tau)
        s_dot = 6.0 * tau * (1.0 - tau) * inv_tf
        s_ddot = 6.0 * (1.0 - 2.0 * tau) * inv_tf * inv_tf
    elif method == 5:
        tau2 = tau * tau
        tau3 = tau2 * tau
        tau4 = tau2 * tau2
        s = 10.0 * tau3 - 15.0 * tau4 + 6.0 * tau4 * tau
        s_dot = (30.0 * tau2 - 60.0 * tau3 + 30.0 * tau4) * inv_tf
        s_ddot = (60.0 * tau - 180.0 * tau2 + 120.0 * tau3) * inv_tf * inv_tf
    else:
        s = tau
        s_dot = inv_tf.expand(N)
        s_ddot = torch.zeros_like(tau)
    start = theta_start[:, None, :]
    delta = (theta_end - theta_start)[:, None, :]
    pos = start + s[None, :, None] * delta
    vel = s_dot[None, :, None] * delta
    acc = s_ddot[None, :, None] * delta
    return pos, vel, acc


def trajectory_kernel(theta_start: torch.Tensor, theta_end: torch.Tensor, Tf, N: int, method: int = 5):
    """K9: (B, J) endpoints -> (pos, vel, acc), each (B, N, J), unclipped."""
    Tf, N = _check_trajectory(theta_start, theta_end, Tf, N)
    B, J = theta_start.shape
    K = kernels()
    shape = {"theta_start": (B, J), "theta_end": (B, J)}
    if not K._route("trajectory", {"theta_start": theta_start, "theta_end": theta_end}, shape):
        return trajectory_plain(theta_start, theta_end, Tf, N, method)
    pos, vel, acc = (
        torch.empty((B, N, J), dtype=theta_start.dtype, device=theta_start.device) for _ in range(3)
    )
    if B == 0 or J == 0:  # nothing to compute: no launch, no count
        return pos, vel, acc
    K._launch("trajectory", theta_start.device, theta_start, theta_end, pos, vel, acc, B, N, J, Tf, int(method))
    return pos, vel, acc


# -- K10 -----------------------------------------------------------------------


def _check_potential(positions, goal, obstacles, influence_distance):
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (P, 3), got {tuple(positions.shape)}")
    if obstacles.dim() != 2 or obstacles.shape[1] != 3:
        raise ValueError(f"obstacles must be (O, 3), got {tuple(obstacles.shape)}")
    P, O = positions.shape[0], obstacles.shape[0]
    if P >= 2**31 or O >= 2**31:
        raise ValueError("P and O must fit in a 32-bit int")
    d0 = float(influence_distance)
    if not d0 > 0.0:
        raise ValueError(f"influence_distance must be positive, got {d0}")
    return P, O, d0


def cartesian_potential_plain(
    positions: torch.Tensor, goal: torch.Tensor, obstacles: torch.Tensor, influence_distance: float = 0.5
):
    """K10's arithmetic in eager PyTorch, operation for operation, the
    obstacles added one after the other: (P, 3) points -> (U (P,), grad
    (P, 3))."""
    _, O, d0 = _check_potential(positions, goal, obstacles, influence_distance)
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    dx, dy, dz = px - goal[0], py - goal[1], pz - goal[2]
    u = 0.5 * (dx * dx + dy * dy + dz * dz)
    gx, gy, gz = dx, dy, dz
    inv_d0 = 1.0 / d0
    zero = torch.zeros_like(u)
    for o in range(O):
        ox, oy, oz = px - obstacles[o, 0], py - obstacles[o, 1], pz - obstacles[o, 2]
        d = torch.sqrt(ox * ox + oy * oy + oz * oz)
        d_safe = torch.clamp(d, min=1e-9)
        inside = d < d0
        inv_d = 1.0 / d_safe
        diff_inv = inv_d - inv_d0
        u = u + torch.where(inside, 0.5 * diff_inv * diff_inv, zero)
        coeff = torch.where(inside, -diff_inv * inv_d * inv_d * inv_d, zero)
        gx, gy, gz = gx + coeff * ox, gy + coeff * oy, gz + coeff * oz
    return u, torch.stack([gx, gy, gz], dim=-1)


def cartesian_potential_kernel(
    positions: torch.Tensor, goal: torch.Tensor, obstacles: torch.Tensor, influence_distance: float = 0.5
):
    """K10: (P, 3) points, (3,) goal, (O, 3) obstacles -> (U (P,), grad
    (P, 3))."""
    P, O, d0 = _check_potential(positions, goal, obstacles, influence_distance)
    K = kernels()
    tensors = {"positions": positions, "goal": goal, "obstacles": obstacles}
    if not K._route("potential", tensors, {"positions": (P, 3), "goal": (3,), "obstacles": (O, 3)}):
        return cartesian_potential_plain(positions, goal, obstacles, d0)
    U = torch.empty((P,), dtype=positions.dtype, device=positions.device)
    grad = torch.empty((P, 3), dtype=positions.dtype, device=positions.device)
    if P == 0:  # nothing to compute: no launch, no count
        return U, grad
    K._launch("potential", positions.device, positions, goal, obstacles, U, grad, P, O, d0, 1.0 / d0)
    return U, grad
