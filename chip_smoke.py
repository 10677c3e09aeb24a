#!/usr/bin/env python3
"""Smoke run of manipulapy_tpu_torch on one CUDA card.

Drives the port's main path, the exact-dynamics rollout behind
``trajectory.forward_dynamics_trajectory``, at the full width of the JAX
package's benchmark (UR5, B=131072, N=50, dt=0.01, float32), through the
hand-written CUDA rollout kernel built from ``manipulapy_tpu_torch/csrc``
with nvcc for sm_90a. Phases, one line each:

1. device: the card, its power limit, CUDA, matmul precision "highest";
2. build: the rollout kernel for UR5 (intRes 1 and 3) and Panda, with
   build seconds, registers and spill bytes;
3. kernel vs its plain PyTorch version, both on the card, in float32;
4. the main path at full width, served by the kernel, checked against the
   plain version on its first 4096 rows;
5. the pipeline quintic trajectory -> inverse dynamics -> rollout;
6. time of the kernel and of the plain version (CUDA events, 2 warm-ups,
   median of 5).

Any failure raises, so the script exits nonzero before its last line. It
needs one card and imports no JAX. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from manipulapy_tpu_torch import trajectory
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.ops.cuda_rollout import CudaRollout, build_cuda_rollout
from manipulapy_tpu_torch.ops.fd_step import build_rollout

# Per-output float32 tolerances (tests/test_pallas.py of the JAX package):
# ddq reaches ~1e3 on the wrist joints, so each quantity has its own scale.
TOL = {"q": 1e-4, "dq": 1e-3, "ddq": 2e-1}
B_FULL, N_FULL, DT = 131072, 50, 0.01
KERNEL_SOURCE = "manipulapy_tpu_torch/csrc/rollout.cuh"
REPLACES = "manipulapy_tpu/ops/pallas_rollout.py:219"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(gen: torch.Generator, B: int, N: int, n: int):
    """q0 in [-1, 1], dq0 in [-0.5, 0.5], tau in [-10, 10] (the JAX
    package's bench.py distributions), float32 on the card."""
    u = lambda *shape: torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)
    return u(B, n) * 2 - 1, u(B, n) - 0.5, u(B, N, n) * 20 - 10


def max_errors(a, b) -> dict:
    return {k: float((x - y).abs().max()) for k, x, y in zip(("q", "dq", "ddq"), a, b)}


def check_close(label: str, errs: dict) -> None:
    for k, tol in TOL.items():
        if not errs[k] <= tol:  # also fails on NaN
            raise AssertionError(f"{label}: max |d{k}| = {errs[k]} exceeds {tol}")


def time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    # 1. Device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise AssertionError(f"float32 matmul precision is {precision!r}, not 'highest'")
    phase("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count(), matmul_precision=precision)
    gen = torch.Generator("cuda").manual_seed(0)

    # 2. Build.
    ur5 = catalog.ur5(dtype=torch.float32, device="cuda")
    panda = catalog.panda(dtype=torch.float32, device="cuda")
    engines = {
        "ur5": build_cuda_rollout(ur5, dt=DT, intRes=1),
        "ur5_intres3": build_cuda_rollout(ur5, dt=DT, intRes=3),
        "panda": build_cuda_rollout(panda, dt=DT, intRes=1),
    }
    attrs = {}
    for name, eng in engines.items():
        built = eng.build()
        attrs[name] = eng.kernel_attributes()
        ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
        phase("build", robot=name, seconds=f"{built.compile_seconds:.2f}", **attrs[name],
              ptxas=repr(" | ".join(ptxas)))

    # 3. Kernel vs plain version, both on the card.
    worst = {"q": 0.0, "dq": 0.0, "ddq": 0.0}
    cases = (("ur5", ur5, 1, 4097, 50), ("ur5_intres3", ur5, 3, 1000, 8), ("panda", panda, 1, 2048, 20))
    for name, model, int_res, B, N in cases:
        q0, dq0, tau = inputs(gen, B, N, model.num_joints)
        got = engines[name](q0, dq0, tau)
        ref = build_rollout(model, dt=DT, intRes=int_res)(q0, dq0, tau)
        torch.cuda.synchronize()
        errs = max_errors(got, ref)
        check_close(name, errs)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        phase("parity", robot=name, B=B, N=N, intRes=int_res,
              **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()})

    # 4. The main path at full width, through the public entry point.
    q0, dq0, tau = inputs(gen, B_FULL, N_FULL, 6)
    CudaRollout.reset_launch_count()
    t0 = time.perf_counter()
    qs, dqs, ddqs = trajectory.forward_dynamics_trajectory(ur5, q0, dq0, tau, dt=DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if CudaRollout.launch_count != 1:
        raise AssertionError(f"the kernel did not serve the main path ({CudaRollout.launch_count} launches)")
    for name, x in (("q", qs), ("dq", dqs), ("ddq", ddqs)):
        if tuple(x.shape) != (B_FULL, N_FULL, 6) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"main path {name}: shape {tuple(x.shape)} or non-finite values")
    rows = 4096
    ref = build_rollout(ur5, dt=DT)(q0[:rows], dq0[:rows], tau[:rows])
    errs = max_errors((qs[:rows], dqs[:rows], ddqs[:rows]), ref)
    check_close("main path", errs)
    worst = {k: max(worst[k], errs[k]) for k in worst}
    phase("main_path", B=B_FULL, N=N_FULL, wall_s=f"{wall:.4f}", kernel_launches=CudaRollout.launch_count,
          **{f"max_abs_err_{k}_first{rows}": f"{v:.3e}" for k, v in errs.items()})

    # 5. Pipeline: quintic trajectory -> inverse dynamics -> rollout.
    start = (torch.rand((1024, 6), generator=gen, device="cuda") * 2 - 1) * 0.5
    goal = start + (torch.rand((1024, 6), generator=gen, device="cuda") * 2 - 1) * 0.25
    plan = trajectory.joint_trajectory(ur5, start, goal, Tf=(N_FULL - 1) * DT, N=N_FULL)
    torques = trajectory.inverse_dynamics_trajectory(ur5, plan.position, plan.velocity, plan.acceleration)
    sim_q, _, _ = trajectory.forward_dynamics_trajectory(
        ur5, plan.position[:, 0].contiguous(), plan.velocity[:, 0].contiguous(), torques.contiguous(), dt=DT
    )
    torch.cuda.synchronize()
    track = float((sim_q - plan.position).abs().max())
    if not np.isfinite(track):
        raise AssertionError(f"pipeline tracking error is {track}")
    launches = CudaRollout.launch_count
    if launches < 2:
        raise AssertionError(f"the kernel did not serve the pipeline's rollout ({launches} launches)")
    phase("pipeline", B=1024, N=N_FULL, max_abs_tracking_error_rad=f"{track:.4e}", kernel_launches=launches)

    # 6. Time: kernel vs plain version at the main path's shape.
    kernel = engines["ur5"]
    plain = build_rollout(ur5, dt=DT)
    plain_ms = time_ms(lambda: plain(q0, dq0, tau))
    kernel_ms = time_ms(lambda: kernel(q0, dq0, tau))
    kernel_ms_2 = time_ms(lambda: kernel(q0, dq0, tau))
    plain_ms_2 = time_ms(lambda: plain(q0, dq0, tau))
    k_ms, p_ms = min(kernel_ms, kernel_ms_2), min(plain_ms, plain_ms_2)
    steps = B_FULL * N_FULL
    phase("time", card=repr(card), B=B_FULL, N=N_FULL,
          kernel_ms=f"{kernel_ms:.4f},{kernel_ms_2:.4f}", plain_ms=f"{plain_ms:.2f},{plain_ms_2:.2f}",
          kernel_steps_per_s=f"{steps / (k_ms * 1e-3):.4e}", plain_steps_per_s=f"{steps / (p_ms * 1e-3):.4e}")

    record = {
        "name": "rollout (K1, step program K0 inlined)",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "max_abs_err_per_output": worst,
        "tolerance": TOL,
        "ms": k_ms,
        "plain_ms": p_ms,
        "num_regs": attrs["ur5"]["num_regs"],
        "local_bytes": attrs["ur5"]["local_bytes"],
    }
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
