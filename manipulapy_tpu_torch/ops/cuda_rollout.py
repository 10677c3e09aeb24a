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
acceleration. The TPU's (8, 128) layout came from its vector registers and
is gone; the kernel stages ``CHUNK`` waypoints of its block's rows through
shared memory instead, so the public row-major layout reads and writes in
whole sectors. A block has ``BLOCK`` threads, the fastest of 32, 64 and
128 at both the rollout's and the planning path's shapes (PERF.md §6).

Two forms of the step (``CudaRollout.form``): ``"emitted"``, the straight-line
``fd_step`` above, or ``"looped"``, ``csrc/fd_step_loop.cuh``: the same step
as a loop over links with the robot's geometry, dt and g in a table
(``ops/fd_step.py::link_table``) passed with each launch, so one unit per
(joint count, intRes) serves every robot; its plain version is
``ops/fd_step.py::LoopRollout``. By default a robot takes the looped form
where its emitted step has more statements than its joint count's
threshold (:func:`step_form`), the only public choice of form. A looped unit that fails to build or launch
raises.

On CPU tensors the module runs the plain version of its form, and only
because the tensors lie on the CPU. On CUDA tensors it launches the kernel
or raises: float32, contiguous, one device. Each launch adds one to
``CudaRollout.launch_count`` (all instances), to
``CudaRollout.launch_counts[form]`` and to the instance's ``launches``.
The kernel has no backward.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch import nn

from . import cgen as cg
from ._build import build_library
from .fd_step import (
    DEFAULT_G, build_fd_step_source, build_loop_rollout, build_rollout, loop_step_ops, loop_supported,
    table_defines,
)
from ..models.robot import RobotModel, host_arrays

__all__ = [
    "CudaRollout", "build_cuda_rollout", "rollout_source", "loop_unit_source", "step_form",
    "loop_threshold", "BLOCK", "CHUNK", "FORMS", "LOOP_THRESHOLD", "LOOP_THRESHOLDS",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
TEMPLATE = CSRC / "rollout.cuh"
LOOP_STEP = CSRC / "fd_step_loop.cuh"
BLOCK = 128  # threads a block
CHUNK = 3  # waypoints a block stages through shared memory at a time
FORMS = ("emitted", "looped")
# The route: a robot whose emitted step has more statements than its joint
# count's threshold takes the looped form (LOOP_THRESHOLDS, else
# LOOP_THRESHOLD). Set from both forms timed in one call on the 25
# calibrated chains and the programmatic UR5 and Panda at B=131072, N=50
# (chip_smoke.py phases 6b, 25 and 32; PERF.md §5; H100 80GB HBM3, 700 W):
# past ~5700 statements the emitted step's rate halves (the fetch of its
# code) and the looped one is 1.3-2.3x faster at 7 and 8 joints, while
# below it the emitted one is 1.07-1.45x faster; at 6 joints the forms are
# within 2% from 4336 statements and the emitted 1.35-1.46x faster below
# 3000; at one joint, where the staging bounds both, the looped one is
# 9-17% faster. Other joint counts were not measured and take 5700.
LOOP_THRESHOLD = 5700
LOOP_THRESHOLDS = {1: 0, 6: 4000}


def loop_threshold(n: int) -> int:
    """The route's threshold on the emitted step's statements for n joints."""
    return LOOP_THRESHOLDS.get(int(n), LOOP_THRESHOLD)


def step_form(model: RobotModel, statements: int) -> str:
    """The form the route gives a robot whose emitted step has
    ``statements`` statements: ``"looped"`` past its joint count's
    threshold (where the looped step takes the robot,
    ``fd_step.loop_supported``), else ``"emitted"``."""
    if statements > loop_threshold(model.num_joints) and loop_supported(model):
        return "looped"
    return "emitted"


def loop_unit_source(n: int, intRes: int) -> str:
    """The rollout kernel's translation unit on the looped step: one per
    (joint count, intRes), for every robot of n joints (the robot is the
    table each launch carries)."""
    header = (
        f"// Generated: the looped step for {int(n)} joints, intRes {int(intRes)}.\n"
        f"#define MPT_NJ {int(n)}\n#define MPT_INT_RES {int(intRes)}\n#define MPT_CHUNK {CHUNK}\n"
        f"#define MPT_BLOCK {BLOCK}\n#define MPT_LOOP_STEP 1\n"
    )
    return header + table_defines() + "#include <math.h>\n" + LOOP_STEP.read_text() + "\n" + TEMPLATE.read_text()


def rollout_source(model: RobotModel, dt: float, intRes: int, g=DEFAULT_G):
    """The full CUDA translation unit of the rollout kernel for this robot
    on the emitted step, the statement count of that step and its longest
    chain of dependent statements (the yardstick of either form's bound):
    ``(source, statements, chain)``."""
    ems = []
    n, step_src, ops = build_fd_step_source(
        model, float(dt) / intRes, g=g, clip_limits=True, clip_velocity=True, emitter=ems
    )
    chain = cg.chain_length(ems[0])
    host = host_arrays(model)
    digest = host["digest"] if host is not None else "unregistered model"
    header = (
        f"// Generated: robot {digest}, dt {float(dt)!r}, intRes {int(intRes)}, "
        f"g {tuple(float(x) for x in g)!r}, {ops} step statements.\n"
        f"#define MPT_NJ {n}\n#define MPT_INT_RES {int(intRes)}\n#define MPT_CHUNK {CHUNK}\n"
        f"#define MPT_BLOCK {BLOCK}\n"
    )
    return header + "#include <math.h>\n" + step_src + "\n" + TEMPLATE.read_text(), ops, chain


class CudaRollout(nn.Module):
    """The fused CUDA rollout for one (robot, dt, intRes, g), in the form
    :func:`step_form` gives it (``_form``, not a public option, names one
    for the card's comparison of the two forms). ``statements``
    and ``chain`` are the emitted step's (the bound's yardstick in either
    form); ``loop_ops`` the looped step's operations, in that form."""

    kind = "cuda"
    launch_count = 0  # launches of the kernel by every instance
    launch_counts = dict.fromkeys(FORMS, 0)  # the same, by form

    def __init__(self, model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G, _form=None):
        super().__init__()
        if intRes < 1:
            raise ValueError("intRes must be >= 1")
        if _form not in FORMS + (None,):
            raise ValueError(f"_form must be one of {FORMS} or None, got {_form!r}")
        self.n = model.num_joints
        self.source, self.statements, self.chain = rollout_source(model, dt, intRes, g)  # per step
        self.form = _form or step_form(model, self.statements)
        self.table, self.loop_ops = None, None
        if self.form == "looped":
            self.source = loop_unit_source(self.n, intRes)
            self.plain = build_loop_rollout(model, dt=dt, intRes=intRes, g=g)
            self.table = self.plain.table  # float32 on the host, copied into each launch
            self.loop_ops = loop_step_ops(self.n)
        else:
            self.plain = build_rollout(model, dt=dt, intRes=intRes, g=g)
        self.launches = 0
        self._built = None
        self._prepared = set()  # devices on which the kernel may take its tiles

    @classmethod
    def reset_launch_count(cls) -> None:
        cls.launch_count = 0
        cls.launch_counts = dict.fromkeys(FORMS, 0)

    def build(self):
        """Compile (once per source) and load the kernel's library; returns
        the :class:`~manipulapy_tpu_torch.ops._build.BuiltLibrary`."""
        if self._built is None:
            built = build_library(self.source, "rollout")
            lib = built.lib
            lib.launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + (
                [ctypes.c_void_p] if self.form == "looped" else [])
            lib.launch.restype = ctypes.c_int
            lib.table_floats.argtypes = []
            lib.table_floats.restype = ctypes.c_int
            expected = 0 if self.table is None else self.table.numel()
            if lib.table_floats() != expected:
                raise RuntimeError(f"the rollout unit takes {lib.table_floats()} table floats, not {expected}")
            lib.prepare.argtypes = []
            lib.prepare.restype = ctypes.c_int
            lib.kernel_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.kernel_attributes.restype = ctypes.c_int
            self._built = built
        return self._built

    def kernel_attributes(self) -> dict:
        """Registers per thread, spill (local) bytes per thread, the
        largest block size, static and dynamic shared bytes a block
        (``cudaFuncGetAttributes``), and the blocks an SM holds with the
        tiles and without them
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), on the current
        device."""
        keys = ("num_regs", "local_bytes", "max_threads", "smem_bytes", "dynamic_smem_bytes",
                "blocks_per_sm", "blocks_per_sm_without_tiles")
        out = (ctypes.c_int * len(keys))()
        err = self.build().lib.kernel_attributes(out)
        if err:
            raise RuntimeError(f"the rollout kernel's attributes failed with CUDA error {err}")
        return dict(zip(keys, out))

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
            if q0.device.index not in self._prepared:
                err = lib.prepare()
                if err:
                    raise RuntimeError(f"the rollout kernel's shared-memory limit failed with CUDA error {err}")
                self._prepared.add(q0.device.index)
            stream = torch.cuda.current_stream(q0.device).cuda_stream
            table = () if self.table is None else (self.table.data_ptr(),)
            err = lib.launch(
                q0.data_ptr(), dq0.data_ptr(), taumat.data_ptr(),
                qs.data_ptr(), dqs.data_ptr(), ddqs.data_ptr(), B, N, stream, *table,
            )
        if err:
            raise RuntimeError(f"rollout kernel launch failed with CUDA error {err}")
        self.launches += 1
        CudaRollout.launch_count += 1
        CudaRollout.launch_counts[self.form] += 1
        return qs, dqs, ddqs


def build_cuda_rollout(model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G, _form=None) -> CudaRollout:
    """Build the CUDA rollout for this robot (compiled at first CUDA call
    or :meth:`CudaRollout.build`), in the form :func:`step_form` gives it."""
    return CudaRollout(model, dt=dt, intRes=intRes, g=g, _form=_form)
