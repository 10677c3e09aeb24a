"""Hand-written CUDA rollout kernel for Hopper (K1, with K0 inlined).

Counterpart of ``manipulapy_tpu/ops/pallas_rollout.py``: one kernel launch
integrates the whole rollout with the exact coupled dynamics, the state
carried in registers across the horizon. The kernel template is
``csrc/rollout.cuh``; its per-robot ``fd_step`` device function is emitted
by ``ops/fd_step.py::build_fd_step_source`` from the same emitter as the
plain PyTorch version (``ops/fd_step.py::build_rollout``), with the robot
geometry, ``dt / intRes``, g and the clip flags folded in as constants.

Contract (that of ``pallas_rollout.py``): ``(q0, dq0, taumat) -> (qs, dqs,
ddqs)`` with (B, n) initial states and (B, N, n) torques, outputs (B, N, n)
where row t is the state at waypoint t and ``ddqs[t]`` the last-substep
acceleration. There is no tile staging: the (8, 128) layout came from the
TPU's vector registers.

On CPU tensors the module runs the plain version, and only because the
tensors lie on the CPU. On CUDA tensors it launches the kernel or raises:
float32, contiguous, one device. Each launch adds one to
``CudaRollout.launch_count`` (all instances) and to the instance's
``launches``. The kernel has no backward.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch import nn

from ._build import build_library
from .fd_step import DEFAULT_G, build_fd_step_source, build_rollout
from ..models.robot import RobotModel, host_arrays

__all__ = ["CudaRollout", "build_cuda_rollout", "rollout_source", "BLOCK"]

TEMPLATE = Path(__file__).resolve().parents[1] / "csrc" / "rollout.cuh"
BLOCK = 128  # threads per block


def rollout_source(model: RobotModel, dt: float, intRes: int, g=DEFAULT_G) -> str:
    """The full CUDA translation unit of the rollout kernel for this robot."""
    n, step_src, ops = build_fd_step_source(
        model, float(dt) / intRes, g=g, clip_limits=True, clip_velocity=True
    )
    host = host_arrays(model)
    digest = host["digest"] if host is not None else "unregistered model"
    header = (
        f"// Generated: robot {digest}, dt {float(dt)!r}, intRes {int(intRes)}, "
        f"g {tuple(float(x) for x in g)!r}, {ops} step statements.\n"
        f"#define MPT_NJ {n}\n#define MPT_INT_RES {int(intRes)}\n#define MPT_BLOCK {BLOCK}\n"
    )
    return header + "#include <math.h>\n" + step_src + "\n" + TEMPLATE.read_text()


class CudaRollout(nn.Module):
    """The fused CUDA rollout for one (robot, dt, intRes, g)."""

    kind = "cuda"
    launch_count = 0  # launches of the kernel by every instance

    def __init__(self, model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G):
        super().__init__()
        if intRes < 1:
            raise ValueError("intRes must be >= 1")
        self.n = model.num_joints
        self.source = rollout_source(model, dt, intRes, g)
        self.plain = build_rollout(model, dt=dt, intRes=intRes, g=g)
        self.launches = 0
        self._built = None

    @classmethod
    def reset_launch_count(cls) -> None:
        cls.launch_count = 0

    def build(self):
        """Compile (once per source) and load the kernel's library; returns
        the :class:`~manipulapy_tpu_torch.ops._build.BuiltLibrary`."""
        if self._built is None:
            built = build_library(self.source, "rollout")
            lib = built.lib
            lib.launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.launch.restype = ctypes.c_int
            lib.kernel_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
            lib.kernel_attributes.restype = ctypes.c_int
            self._built = built
        return self._built

    def kernel_attributes(self) -> dict:
        """Registers per thread, spill (local) bytes per thread and the
        largest block size, from ``cudaFuncGetAttributes``."""
        lib = self.build().lib
        regs, local, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.kernel_attributes(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(threads))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {err}")
        return {"num_regs": regs.value, "local_bytes": local.value, "max_threads": threads.value}

    def _check(self, q0, dq0, taumat):
        n = self.n
        if q0.dim() != 2 or q0.shape[1] != n:
            raise ValueError(f"q0 must be (B, {n}), got {tuple(q0.shape)}")
        B = q0.shape[0]
        if tuple(dq0.shape) != (B, n):
            raise ValueError(f"dq0 must be ({B}, {n}), got {tuple(dq0.shape)}")
        if taumat.dim() != 3 or taumat.shape[0] != B or taumat.shape[2] != n:
            raise ValueError(f"taumat must be ({B}, N, {n}), got {tuple(taumat.shape)}")
        for name, x in (("q0", q0), ("dq0", dq0), ("taumat", taumat)):
            if x.device != q0.device:
                raise ValueError(f"{name} is on {x.device}, q0 on {q0.device}")
            if x.dtype != torch.float32:
                raise TypeError(f"the CUDA rollout takes float32; {name} is {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.requires_grad:
                raise ValueError("the CUDA rollout has no backward; detach the inputs")
        if B >= 2**31 or taumat.shape[1] >= 2**31:
            raise ValueError("B and N must fit in a 32-bit int")

    def forward(self, q0: torch.Tensor, dq0: torch.Tensor, taumat: torch.Tensor):
        tensors = (q0, dq0, taumat)
        if all(x.device.type == "cpu" for x in tensors):
            return self.plain(q0, dq0, taumat)
        if any(x.device.type != "cuda" for x in tensors):
            raise ValueError(f"inputs must all lie on one CUDA device, got {[str(x.device) for x in tensors]}")
        self._check(q0, dq0, taumat)
        lib = self.build().lib
        B, N = taumat.shape[0], taumat.shape[1]
        qs = torch.empty_like(taumat)
        dqs = torch.empty_like(taumat)
        ddqs = torch.empty_like(taumat)
        with torch.cuda.device(q0.device):
            stream = torch.cuda.current_stream(q0.device).cuda_stream
            err = lib.launch(
                q0.data_ptr(), dq0.data_ptr(), taumat.data_ptr(),
                qs.data_ptr(), dqs.data_ptr(), ddqs.data_ptr(), B, N, stream,
            )
        if err:
            raise RuntimeError(f"rollout kernel launch failed with CUDA error {err}")
        self.launches += 1
        CudaRollout.launch_count += 1
        return qs, dqs, ddqs


def build_cuda_rollout(model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G) -> CudaRollout:
    """Build the CUDA rollout for this robot (compiled at first CUDA call
    or :meth:`CudaRollout.build`)."""
    return CudaRollout(model, dt=dt, intRes=intRes, g=g)
