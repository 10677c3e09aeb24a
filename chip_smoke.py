#!/usr/bin/env python3
"""Smoke run of manipulapy_tpu_torch on one CUDA card.

Drives the port's main paths at full width through hand-written CUDA
kernels built from ``manipulapy_tpu_torch/csrc`` with nvcc for sm_90a:

* the exact-dynamics rollout (K1, step program K0 inlined) behind
  ``trajectory.forward_dynamics_trajectory``, at the JAX package's
  benchmark shape: UR5, B=131072, N=50, dt=0.01, float32;
* the batched fused tracking MPC (K2-K5) behind
  ``mpc.fused_batch.build_batch_tracking_mpc(...).solve`` and
  ``batch_mpc_step``, at the width the JAX package times: Panda, B=1024
  per-scenario goals, H=50, dt=0.01, 4 iterations, 6 line-search alphas;
* the single-problem fused tracking MPC (K6-K8) behind
  ``mpc.fused.build_tracking_mpc(...).solve``, at the shape the JAX
  package's benchmark times (``mpc_panda_H50_fused_single``): Panda, H=50,
  dt=0.01, 4 iterations, 6 alphas, one solve and 20 receding-horizon
  rounds;
* the planning path (K9, K10, and K1 again) behind
  ``planner.create_planner`` and the public functions: UR5, B=1024
  start/goal pairs, quintic plans of N=1000 waypoints over Tf=2 s
  (``batch_joint_trajectory``), the link positions of every waypoint (6.1 M
  points) in a Cartesian potential field of 32 obstacle points
  (``cartesian_potential_field``), the plans' exact inverse dynamics and
  their rollout at dt = Tf / (N - 1); then one plan with the
  collision-avoidance pass, one Cartesian trajectory, the singularity
  measure along the plans and 200 periods of computed-torque control.

Phases, one line each (or one line per case):

1. device: the card, its power limit, CUDA, matmul precision "highest";
2. build: every kernel at once, one nvcc per translation unit, all started
   together (the rollout for UR5 with intRes 1 and 3, at the planning
   path's dt, and for Panda; K2-K5 for Panda and UR5; K6-K8 for Panda; the
   static unit of K9 and K10), with build seconds, registers, spill
   bytes and static shared bytes per block (K3, one warp per scenario, and
   K7, one block, keep their state there; K7 must have no local bytes,
   K6 no spills and no more than sinf/cosf's 32-byte frame); K6's design
   (warps, lanes a block, phases, slots, critical length, dynamic shared
   bytes, nvcc seconds);
   K1 with its block and chunk, its tiles' dynamic shared bytes and the
   blocks an SM holds with and without them (they must be equal, and local
   bytes at most 32);
3. rollout: kernel vs its plain PyTorch version on the card;
4. rollout main path at full width, checked against the plain version on
   its first 4096 rows (launch count read just after it);
5. the pipeline quintic trajectory -> inverse dynamics -> rollout;
6. rollout time, kernel vs plain version (CUDA events), the DRAM rate the
   kernel achieves (the bytes of its bound over its time) and its us a
   waypoint;
7. MPC parity: each of K2-K5 against its plain version on the card, fed
   from a nominal trajectory (K2 and K3) and from K3's gains (K4, with and
   without every alpha's trajectory, and K5), at Panda B=257 H=8 (not a
   multiple of the block, so the ``b < B`` guard is exercised; random
   torques) and at the main path's shapes, B=1024 H=50 (the solver's own
   controls), there also with a Levenberg-heavy ``reg`` of 10; max |d| per
   output within 1e-5 of that output's largest magnitude for K3, and 0 for
   K2, K4 and K5 (the plain version's emitted operations in its order);
8. MPC main path: one solve and 3 rounds of ``batch_mpc_step`` with goals
   passed at run time, launch counts read just after (per solve K2 4, K3
   4, K4 4 with the trajectories, K5 1: the initial rollout), finite
   outputs, costs below the zero-control rollout's, |u| <= u_lim; then the
   whole solve against the plain solver on the card at Panda B=64 H=10
   with 2 iterations;
9. MPC time: the plain versions at full width and the plain solver at
   B=64; then each stage's kernel and one solve (CUDA events, median) at
   B=1024, 4096 and 16384, with K2's and K3's achieved rates (their
   bounds' operations over their times; K2 also the statements it runs),
   K4 (with its trajectories, every alpha; NaN where the plain version has
   NaN) and K5 against their plain versions at each width, max |d| = 0,
   and K4 built with 32 and 64 threads a block (variant
   units of the fwd unit, built with the others) held bitwise to the
   default and timed at each width; K4's and K5's records carry an
   estimate of their dependent chains' least time (``chain_bound_ms``),
   K4's its trajectory bytes, costs-only time and block variants, K5's its
   one thread a scenario;
10. single-problem parity: each of K6-K8 against its plain version on the
    card at Panda H=50 (the solver's own controls), H=37 (random torques
    within 30% of the limits; K6's H*m lanes end mid-block) and H=50
    again with a Levenberg-heavy reg of 10, max |d| per output 0 for each:
    K6 (the lean one-seed body, one thread a lane or split over a team of
    warps; its record carries its design), K7 (one block of threads whose
    phases do the plain version's operations in its order) and K8 (one
    team of warps a block, as K5; its record carries its team);
11. single-problem main path: one solve from rest at the middle of the
    joint limits towards the benchmark's goal, then 20 receding-horizon
    rounds (x <- xs[1], the warm start shifted by one), the goal
    re-targeted at run time in round 10; launch counts read just after
    (4/4/5 per solve), finite outputs, |u| <= u_lim, the cost below the
    zero-control cost, the distance to each goal shrinking; then the whole
    solve against the plain solver on the card at H=10, 2 iterations;
12. single-problem time: each kernel at H=50 (device time per launch, over
    20 back-to-back launches), one solve at 4 and at 2 iterations, one
    receding round, and the glue (the solve minus its kernels' sum),
    CUDA-event medians; then a ``torch.profiler`` trace of 3 solves: each
    kernel's device time per solve, the glue's, and the device's busy
    share. K6-K8's records carry, beside the throughput bound, an estimate
    of their dependent chains' least time (``chain_bound_ms``);
13. ``elementwise_build``: the static unit's nvcc seconds, registers and
    spills;
14. ``traj_parity``: K9 against its plain version for the cubic, quintic
    and linear methods at (B, N, J) = (3, 300, 6), (1024, 4096, 6) and
    (2, 101, 3); max |d| within 2e-6 / 2e-5 / 2e-4 on pos / vel / acc;
15. ``potential_parity``: K10 against its plain version at P=400 O=5,
    P=262144 O=32, no obstacle at all, and with one point on an obstacle;
    rtol 1e-4, atol 1e-5 on U and 1e-4 on its gradient;
16. ``plan_path``: the planning path, launch counts read just after its
    open-loop part (K9, K10 and K1 once each) and at its end; finite
    outputs, positions inside the joint limits, the plans' boundary
    conditions, the avoided plan clear of the cloud it would have hit;
17. ``plan_time``: CUDA-event medians of K9 and K10 at the path's shapes and
    at two more each, beside their device times in a ``torch.profiler``
    trace, their bounds, their plain versions and the tensor formulations
    they replace; and of K1 at the path's two shapes (the plans' rollout,
    one control period), with its us a waypoint and, beside its bound, an
    estimate of its dependent chain's least time (``chain_bound_ms``);
18. ``plan_path_parity``: K9, K10 and K1 (the unit built for the plans'
    dt) against their plain versions on the very tensors the path gave
    them: the 1024 start/goal pairs, the 6.144 M points and 32 obstacles,
    the plans' torques (the rollout's first 250 steps of 1000) and the
    last control period; then one more ``traj_parity`` line, the quintic
    at 174763 x 4096 x 6 (past 2**32 elements; its first and last 64
    rows).

Between phases 17 and 18, the closed loop and the fleet layer, on a
one-device mesh (``parallel.make_mesh(1)``):

19. ``fleet_fused``: one ``parallel.fleet_mpc_round(solver="fused_batch")``
    of a Panda and a UR5 padded to 7 joints, S=1024 scenarios each, H=50,
    4 iterations, 6 alphas; K2-K5 launched per robot (launch counts read
    just after the round); each robot's controls and costs bitwise its own
    ``build_batch_tracking_mpc(...).solve`` on the same inputs, the UR5's
    padded joint 0, the fleet cost the mean; the round's time (CUDA
    events) beside the two solves';
20. ``distributed_rollout``: ``parallel.distributed_rollout`` at UR5
    B=131072 N=50, one K1 launch, bitwise the public rollout; its time
    beside K1's;
21. ``ik``: UR5 ``ik.solve_ik_batch`` at B=1000, 150 iterations, FK targets
    of q in U[-1.5, 1.5] from q + N(0, 0.3): float64 success rate at least
    0.9 and every success within 1e-5 m, float32's rate reported; ms a
    solve and device launches an iteration (two ``torch.profiler``
    traces); then ``TracIKSolver.solve`` and ``ik_cache.smart_ik`` on 64
    targets each;
22. ``sim``: the Panda ``Simulation`` (dt 0.01, 4 substeps) tracking a
    500-waypoint quintic by ``run_controller``, with joint damping 0.1
    (error reported) and without (final error within 0.05 rad); ms a step;
23. ``pscan``: the generic iLQR on Panda, H=50, float64, one iteration,
    with the associative-scan and the sequential Riccati pass at reg 0
    (gains within 1e-6 relative), and both backward passes timed.

Then one JSON line of every kernel, the card's name and power limit, and
the result line. Any failure raises, so the script exits nonzero before its
last line. It needs one card and imports no JAX. Run from the repository
root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from manipulapy_tpu_torch import control, create_planner, ik, ik_cache, parallel, potential_field, singularity, trajectory
from manipulapy_tpu_torch.kinematics import forward_kinematics
from manipulapy_tpu_torch.mpc.costs import make_tracking_costs
from manipulapy_tpu_torch.mpc.ilqr import ILQRParams, ilqr, make_step_fn, riccati_sweep
from manipulapy_tpu_torch.mpc.pscan import parallel_riccati
from manipulapy_tpu_torch.sim import Simulation
from manipulapy_tpu_torch.trac_ik import TracIKSolver
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
from manipulapy_tpu_torch.mpc.fused_batch import batch_mpc_step, build_batch_tracking_mpc
from manipulapy_tpu_torch.ops.cuda_mpc_batch import BLOCK as BLOCK_MPC, LIN_BLOCK, BatchMPCKernels
from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels
from manipulapy_tpu_torch.ops.cuda_rollout import BLOCK, CHUNK, CudaRollout, build_cuda_rollout
from manipulapy_tpu_torch.ops import elementwise as ew
from manipulapy_tpu_torch.ops.fd_step import build_rollout

# Per-output float32 tolerances (tests/test_pallas.py of the JAX package):
# ddq reaches ~1e3 on the wrist joints, so each quantity has its own scale.
TOL = {"q": 1e-4, "dq": 1e-3, "ddq": 2e-1}
B_FULL, N_FULL, DT = 131072, 50, 0.01
# The MPC kernels against their plain versions: the same emitted operations
# with --fmad=false, so 0 is expected; the gate is 1e-5 of each output's
# largest magnitude.
MPC_RTOL = 1e-5
B_MPC, H_MPC, ITERS, ALPHAS = 1024, 50, 4, 6
B_MPC_WIDE = (4096, 16384)  # more widths for the solve's and stages' times
B_PARITY, H_PARITY = 257, 8  # kernel vs plain version, off the block size
REG_HEAVY = 10.0  # a Levenberg-heavy parity case at full width
B_SMALL, H_SMALL = 64, 10  # the whole solve vs the plain solver
# The single-problem solver: the JAX benchmark's goal, then another for the
# rounds after the re-target; the parity horizons and the small solve's.
Q_GOAL7 = (0.3, -0.4, 0.2, -1.6, 0.1, 1.4, 0.4)
Q_GOAL7_B = (-0.3, 0.2, -0.2, -2.0, -0.1, 1.8, -0.4)
H_ODD, ODD_SEED, ROUNDS, RETARGET = 37, 2, 20, 10
ROLLOUT_CASES = (("ur5", 1, 4097, 50), ("ur5_intres3", 3, 1000, 8), ("panda", 1, 2048, 20))
ROWS_CHECKED, B_PIPELINE = 4096, 1024
STEPS_CHECKED = 250  # of the plans' rollout: its plain version takes 70 ms of host time a step
DEV = "cuda"
# The least time: bytes over the HBM3 rate, and emitted f32 operations over
# one non-FMA instruction per lane per clock (67 TFLOP/s counts an FMA as
# two operations; the kernels are built with --fmad=false).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
# A dependent f32 operation's latency in cycles, for the estimate of a
# single-problem kernel's least time along its longest chain of statements.
CHAIN_CYCLES = 4
ROLLOUT_SOURCE = "manipulapy_tpu_torch/csrc/rollout.cuh"
MPC_SOURCE = "manipulapy_tpu_torch/csrc/mpc_batch.cuh"
MPC_KERNELS = {  # the main path's stage of each kernel: (id and name, the TPU kernel's pallas_call)
    "linearize": ("K2 linearize (forward mode over K0)", "manipulapy_tpu/mpc/fused_batch.py:249"),
    "backward": ("K3 Riccati backward", "manipulapy_tpu/mpc/fused_batch.py:372"),
    "linesearch": ("K4 line search, every alpha's cost and trajectory (K0 inlined)",
                   "manipulapy_tpu/mpc/fused_batch.py:453"),
    "replay": ("K5 replay (K0 inlined)", "manipulapy_tpu/mpc/fused_batch.py:507"),
}
MPC_STAGES = ("linearize", "backward", "linesearch_costs", "linesearch", "replay")
BITWISE_STAGES = ("linearize", "linesearch_costs", "linesearch", "replay")  # max |d| must be 0
K4_BLOCKS = (32, 64)  # K4's block-shape variants besides the unit's BLOCK
SINGLE_SOURCE = "manipulapy_tpu_torch/csrc/mpc_single.cuh"
SINGLE_KERNELS = {  # stage: (id and name, the TPU kernel's pallas_call, the CUDA kernel's name)
    "linearize": ("K6 single-problem linearize (forward mode over K0)", "manipulapy_tpu/mpc/fused.py:213", "mps_lin_kernel"),
    "backward": ("K7 single-problem Riccati backward (Gauss-Jordan)", "manipulapy_tpu/mpc/fused.py:303", "mps_bwd_block_kernel"),
    "forward": ("K8 single-problem line-search forward (K0 inlined)", "manipulapy_tpu/mpc/fused.py:375", "mps_fwd_kernel"),
}
# The planning path: widths, tolerances (those of the JAX package's kernel
# tests) and the shapes timed besides the path's own.
B_PLAN, N_PLAN, TF_PLAN, O_PLAN, D0_PLAN = 1024, 1000, 2.0, 32, 0.5
DT_PLAN = TF_PLAN / (N_PLAN - 1)
TRAJ_ATOL = {"pos": 2e-6, "vel": 2e-5, "acc": 2e-4}
TRAJ_PARITY = ((3, 300, 6, 2.0), (1024, 4096, 6, 2.0), (2, 101, 3, 1.0))  # B, N, J, Tf
TRAJ_TIMED = ((256, 1000, 6), (1024, 4096, 6))
# B * N * J just past 2**32 elements (51.5 GB of outputs): the last
# TRAJ_WIDE_ROWS scenarios lie at flat indices that need more than 32 bits.
TRAJ_WIDE, TRAJ_WIDE_ROWS = (174763, 4096, 6, 2.0), 64
POT_RTOL, POT_ATOL = 1e-4, {"U": 1e-5, "grad": 1e-4}
POT_PARITY = ((400, 5, 0.6), (262144, 32, 0.5), (1031, 0, 0.5))  # P, O, d0
POT_TIMED = (16384, 262144)
# The avoidance pass: descend until every waypoint is AVOID_MARGIN clear. Its
# pull toward the goal (1e-3 |q - goal|^2) holds the last few mm back, hence
# the slack in the gate.
AVOID_MARGIN, AVOID_SLACK, AVOID_STEPS, AVOID_STEP_SIZE = 0.05, 0.01, 100, 0.5
CTRL_STEPS, CTRL_KP, CTRL_KD = 200, 100.0, 20.0
# Operations per output element (K9, by method) and per point and obstacle
# (K10), counted from csrc/elementwise.cuh.
TRAJ_OPS = {3: 23, 5: 30, 1: 8}
POT_OPS_POINT, POT_OPS_OBSTACLE = 9, 28
ELEMENTWISE_SOURCE = "manipulapy_tpu_torch/csrc/elementwise.cuh"
# The closed loop and the fleet layer (phases 19-23), at widths the repo
# already uses: the fleet at the batched solve's (a Panda and a UR5 padded
# to 7 joints, S scenarios each, on a one-device mesh), the distributed
# rollout at the rollout's, IK at the README's batch (targets the FK poses
# of q in U[-1.5, 1.5], guesses q + N(0, 0.3), the JAX test's protocol), the
# plant over a 500-waypoint quintic, the associative-scan Riccati pass at
# the single solve's horizon.
IK_B, IK_ITERS, IK_SUCCESS_BAR, IK_TRANS_BAR = 1000, 150, 0.9, 1e-5
# The strategy layers answer one target a call and are bound by the host's
# launches (~29 ms an iteration of 8 lanes on an H100 machine), so each of
# their 64 calls runs 30 iterations a family.
IK_STRATEGY_TARGETS, IK_STRATEGY_ITERS = 64, 30
SIM_WAYPOINTS, SIM_SUBSTEPS, SIM_DAMPING, SIM_TRACK_BAR = 500, 4, 0.1, 0.05
# The damped run against the CPU's: float32 and float64 plants differ by
# 1.5e-6 rad over the 500 waypoints on a CPU, and the damping moves the
# last position by 0.08 rad.
SIM_CPU_ATOL = 1e-4
PSCAN_REL_BAR = 1e-6


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(gen: torch.Generator, B: int, N: int, n: int):
    """q0 in [-1, 1], dq0 in [-0.5, 0.5], tau in [-10, 10] (the JAX
    package's bench.py distributions), float32 on the card."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=DEV, dtype=torch.float32)
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


def per_call_ms(fn, calls: int = 20) -> float:
    """A launch's device time: the median over ``time_ms`` of ``calls``
    back-to-back calls, divided by their count, so the host's time per call
    hides behind the device's."""
    return time_ms(lambda: [fn() for _ in range(calls)]) / calls


def device_profile(fn, reps: int = 3) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn``: per kernel name the
    device ms per call, the device's busy share of the traced span, its busy
    ms and its launches per call. Empty when the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return {}
    by_name, busy, open_s, open_e = {}, 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / reps / 1e3
        if start > open_e:
            busy, open_s = busy + open_e - open_s, start
        open_e = max(open_e, end)
    busy += open_e - open_s
    return {"by_name": by_name, "busy_share": busy / (open_e - spans[0][0]), "busy_ms": busy / reps / 1e3,
            "launches": len(spans) / reps}


def bound(nbytes: float, ops: float):
    """(least time in ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_all(rollouts: dict, mpc_kernels: dict, planning: ew.ElementwiseKernels) -> dict:
    """Start every build at once; each MPC kernel set (K2-K5 or K6-K8)
    starts its three units in parallel itself."""
    jobs = {**{("rollout", k): e.build for k, e in rollouts.items()},
            **{("mpc", k): m.build for k, m in mpc_kernels.items()},
            ("planning", "elementwise"): planning.build}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(fn) for key, fn in jobs.items()}
        built = {key: f.result() for key, f in futures.items()}
    return built, time.perf_counter() - t0


def ptxas_lines(log: str) -> str:
    return " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln)


# ---------------------------------------------------------------------------
# MPC helpers
# ---------------------------------------------------------------------------


def panda_problem(gen: torch.Generator, model, B: int):
    """Initial states at rest inside the joint limits and per-scenario goals
    within 0.3 rad of them, on the card: x0 (B, 2n), goals (B, n)."""
    lo, hi = model.joint_lower, model.joint_upper
    u = lambda *shape: torch.rand(shape, generator=gen, device=DEV, dtype=torch.float32) * 2 - 1
    q0 = (lo + hi) / 2 + u(B, model.num_joints) * 0.5 * (hi - lo) / 2
    goals = torch.clamp(q0 + u(B, model.num_joints) * 0.3, lo, hi)
    return torch.cat([q0, torch.zeros_like(q0)], dim=1), goals


def timed(fn):
    """(result, CUDA-event ms) of one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def compare(stage: str, got, ref, label: str) -> dict:
    errs = {}
    for name, g, r in zip(("0", "1", "2"), got, ref):
        if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(r).all())):
            raise AssertionError(f"{label} {stage}[{name}]: non-finite values")
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        if not err <= MPC_RTOL * scale:
            raise AssertionError(f"{label} {stage}[{name}]: max |d| = {err} exceeds {MPC_RTOL} x {scale}")
        errs[name] = err
    return errs


def bit_diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    """0.0 when ``got`` has ``ref``'s bits, NaN where ``ref`` has NaN; else
    the largest |d| over the entries both hold finite (inf where their NaNs
    differ or no entry is finite)."""
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    if torch.equal(got.view(torch.int32)[~nan], ref.view(torch.int32)[~nan]):
        return 0.0
    both = torch.isfinite(got) & torch.isfinite(ref)
    return float((got - ref)[both].abs().max()) if bool(both.any()) else float("inf")


def stage_vs_plain(K, stage: str, args, label: str, errs, plain_ms: dict, plain_calls: int):
    """Run one stage's kernel and, unless ``errs`` is None, its plain
    version on the same inputs: record the max |d| in ``errs`` and, for
    ``plain_calls`` of 1 or 2, the plain version's CUDA-event ms (the least
    of that many calls) in ``plain_ms``. Returns the kernel's outputs."""
    got = getattr(K, stage)(*args)
    got = got if isinstance(got, tuple) else (got,)
    if errs is None:
        return got
    plain = getattr(K.plain(), stage)
    ref, ms = timed(lambda: plain(*args))
    e = compare(stage, got, ref if isinstance(ref, tuple) else (ref,), label)
    errs[stage] = max(errs.get(stage, 0.0), *e.values())
    if plain_calls:
        plain_ms[stage] = min([ms] + [timed(lambda: plain(*args))[1] for _ in range(plain_calls - 1)])
    return got


def mpc_stage_parity(K: BatchMPCKernels, x0, goals, us, label: str, time_plain: bool, check: bool = True,
                     reg: float = 1e-6):
    """Feed every stage, kernel and plain version alike, from a nominal
    trajectory (the torques ``us`` (H, n, B) from ``x0`` (B, 2n), rolled
    by K5 with zero gains) and K3's gains under the Levenberg term ``reg``.
    Returns per stage the max |d|, the stage's inputs (for timing the
    kernels) and, if asked, the plain version's CUDA-event ms at these
    shapes. ``check=False`` runs the kernels alone, for their inputs."""
    n, nx = K.n, K.nx
    H, B = us.shape[0], us.shape[2]
    x0_t, goal_t = x0.T.contiguous(), goals.T.contiguous()
    reg = torch.full((B,), reg, device=DEV)
    alphas = 0.5 ** torch.arange(ALPHAS, device=DEV, dtype=torch.float32)
    alpha = alphas[torch.arange(B, device=DEV) % ALPHAS].contiguous()
    f32 = dict(dtype=torch.float32, device=DEV)
    init = (x0_t, torch.zeros((H, nx, B), **f32), us, torch.zeros((H, n, 1 + nx, B), **f32), goal_t, torch.zeros((B,), **f32))

    errs, plain_ms = ({} if check else None), {}

    def both(stage, args):
        return stage_vs_plain(K, stage, args, label, errs, plain_ms, 1 if time_plain else 0)

    xs0 = both("replay", init)[0]
    sd_x = torch.cat([x0_t[None], xs0[:-1]]).contiguous()
    AB = both("linearize", (sd_x, us))[0]
    bwd_args = (AB, sd_x, us, xs0[-1].contiguous(), goal_t, reg)
    kK = both("backward", bwd_args)[0]
    ls_args = (x0_t, sd_x, us, kK, goal_t, alphas)
    both("linesearch_costs", ls_args)
    both("linesearch", ls_args)
    rep_args = (x0_t, sd_x, us, kK, goal_t, alpha)
    both("replay", rep_args)
    stage_args = {"linearize": (sd_x, us), "backward": bwd_args, "linesearch_costs": ls_args,
                  "linesearch": ls_args, "replay": rep_args}
    return errs, stage_args, plain_ms


def stage_bytes_ops(K: BatchMPCKernels, B: int, H: int, A: int) -> dict:
    """Per stage, the bytes each call must move (inputs read once, outputs
    written once, f32) and the emitted operations its function needs: K2's
    primal step once per (scenario, step), its tangent once per seed."""
    n, nx, m, kk = K.n, K.nx, K.m, K.n * (1 + K.nx)
    s = K.statements
    f = 4
    return {
        "linearize": (
            (H * nx * B + H * n * B + H * nx * m * B) * f,
            (s["step"] + m * (s["linearize"] - s["step"])) * B * H,
        ),
        "backward": (
            (H * nx * m * B + H * nx * B + H * n * B + nx * B + n * B + B + H * kk * B) * f,
            s["backward"] * B * H + s["value_terminal"] * B,
        ),
        "linesearch_costs": (
            (nx * B + H * (nx + n) * B + H * kk * B + n * B + A + A * B) * f,
            (s["linesearch_costs"] * H + s["cost_terminal"]) * B * A,
        ),
        # the same, and every alpha's trajectory written once
        "linesearch": (
            (nx * B + H * (nx + n) * B + H * kk * B + n * B + A + A * B + A * H * (nx + n) * B) * f,
            (s["linesearch"] * H + s["cost_terminal"]) * B * A,
        ),
        "replay": (
            (nx * B + H * (nx + n) * B + H * kk * B + n * B + B + H * (nx + n) * B + B) * f,
            (s["replay"] * H + s["cost_terminal"]) * B,
        ),
    }


def lin_statements(K: BatchMPCKernels, B: int, H: int) -> int:
    """The statements K2 runs: its thread's body (one seed, or a group) once
    per (scenario, seed or group of seeds, step)."""
    return K.statements["linearize_group"] * (K.m // K.LIN_SEEDS) * B * H


def team_figures(K, stage: str = None) -> dict:
    """K5's, K8's or K6's team (``stage``) as built (warps, scenarios,
    alphas or lanes a team, teams a block, phases a step, slots, dynamic
    shared bytes a block) and its partition's critical length and
    statements a step."""
    team = K.team_attributes(stage)
    step = K.lin_team if stage == "linearize" else K.team
    return dict(team, critical=step.partition.critical, step_statements=step.statements,
                team_shared_bytes=team["dynamic_smem_bytes"] // team["teams_per_block"])


def lin_figures(S: SingleMPCKernels, built: dict) -> dict:
    """K6's design as built: warps, lanes a block, phases, slots, critical
    length (statements a lane in a row, the largest warp's of each phase),
    dynamic shared bytes, its unit's nvcc seconds and ptxas's spill bytes
    (stores and loads). One thread a lane is one warp of 32 lanes, one
    phase and the whole body."""
    if S.lin_team is None:
        fig = {"warps": 1, "lanes": 32, "phases": 1, "slots": 0, "critical": S.statements["linearize_group"],
               "dynamic_smem_bytes": 0}
    else:
        t = team_figures(S, "linearize")
        fig = {"warps": t["warps"], "lanes": t["scenarios"], "phases": t["phases"], "slots": t["slots"],
               "critical": t["critical"], "dynamic_smem_bytes": t["dynamic_smem_bytes"]}
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", built["lin"].log)
    return dict(fig, thread_statements=S.statements["linearize_group"], nvcc_seconds=built["lin"].compile_seconds,
                spill_bytes=sum(int(a) + int(b) for a, b in spills))


def batch_chain_ms(K: BatchMPCKernels, H: int) -> dict:
    """K4's and K5's estimate of their least time along the dependent chain:
    each scenario's (and alpha's) H steps follow one another, then its
    terminal cost; the longest chain of the emitted step's statements
    (``K.chains``), CHAIN_CYCLES cycles a link at the card's largest SM
    clock, as for K6-K8."""
    mhz = float(card_line("clocks.max.sm").split()[0])
    ms = (H * K.chains["replay"] + K.chains["cost_terminal"]) * CHAIN_CYCLES / (mhz * 1e3)
    return {"linesearch": ms, "replay": ms}


def mid_rest(model) -> torch.Tensor:
    """At rest at the middle of each joint's limits, (2n,) on the card (the
    zero pose lies outside the catalog Panda's joint-4 limit)."""
    q = (model.joint_lower + model.joint_upper) / 2
    return torch.cat([q, torch.zeros_like(q)]).contiguous()


def random_single_problem(model, H: int, seed: int):
    """x0 (2n,) at rest inside the limits, a goal (n,) near it and torques
    (H, n) within 30% of the limits, from numpy (so a CPU run of the plain
    versions shows these inputs stay finite)."""
    n = model.num_joints
    rng = np.random.default_rng(seed)
    lo, hi = model.joint_lower.cpu().double().numpy(), model.joint_upper.cpu().double().numpy()
    q0 = (lo + hi) / 2 + rng.uniform(-0.5, 0.5, n) * (hi - lo) / 2
    goal = np.clip(q0 + rng.uniform(-0.3, 0.3, n), lo, hi)
    us = rng.uniform(-0.3, 0.3, (H, n)) * model.torque_limit.cpu().double().numpy()
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEV).contiguous()
    return f32(np.concatenate([q0, np.zeros(n)])), f32(goal), f32(us)


def terminal_value(S: SingleMPCKernels, x_last, goal) -> torch.Tensor:
    """K7's input Vterm (nx+1, nx): diag(2 wT), then 2 wT (x_T - goal)."""
    two_wT = torch.tensor([2.0 * w for w in S.P.wT], dtype=torch.float32, device=DEV)
    Vx = two_wT * (x_last - torch.cat([goal, torch.zeros_like(goal)]))
    return torch.cat([torch.diag(two_wT), Vx[None]]).contiguous()


def single_stage_parity(S: SingleMPCKernels, x0, goal, us, label: str, plain_calls: int, reg: float = 1e-6):
    """K6-K8 against their plain versions, fed from the open loop of ``us``
    (H, n) from ``x0`` (K8 with one alpha of 0 and zero gains) and K7's
    gains under the Levenberg term ``reg``. Returns per stage the max |d|,
    the stage's inputs and the plain versions' ms (for ``plain_calls`` >
    0)."""
    n, nx, H = S.n, S.nx, us.shape[0]
    f32 = dict(dtype=torch.float32, device=DEV)
    errs, plain_ms = {}, {}
    both = lambda stage, args: stage_vs_plain(S, stage, args, label, errs, plain_ms, plain_calls)
    init = (x0, torch.zeros((H, nx), **f32), us, torch.zeros((H, n, 1 + nx), **f32), goal, torch.zeros((1,), **f32))
    xs0 = both("forward", init)[0][0]
    sd_x = torch.cat([x0[None], xs0[:-1]]).contiguous()
    AB = both("linearize", (sd_x, us))[0]
    bwd_args = (AB, sd_x, us, goal, terminal_value(S, xs0[-1], goal), torch.tensor(reg, **f32))
    kK = both("backward", bwd_args)[0]
    fwd_args = (x0, sd_x, us, kK, goal, 0.5 ** torch.arange(ALPHAS, **f32))
    both("forward", fwd_args)
    return errs, {"linearize": (sd_x, us), "backward": bwd_args, "forward": fwd_args}, plain_ms


def single_bytes_ops(S: SingleMPCKernels, H: int, A: int) -> dict:
    """Per stage, the bytes each call must move (inputs read once, outputs
    written once, f32) and the emitted operations its function needs: K6's
    primal step once per step, its tangent once per seed; K7's step H
    times; K8's step A*H times and its terminal cost A times."""
    n, nx, m, kk = S.n, S.nx, S.m, S.n * (1 + S.nx)
    s = S.statements
    f = 4
    return {
        "linearize": ((H * nx + H * n + H * nx * m) * f, (s["step"] + m * (s["linearize"] - s["step"])) * H),
        "backward": ((H * nx * m + H * nx + H * n + n + (nx + 1) * nx + 1 + H * kk) * f, s["backward"] * H),
        "forward": (
            (nx + H * (nx + n) + H * kk + n + A + A * H * (nx + n) + A) * f,
            (s["forward"] * H + s["cost_terminal"]) * A,
        ),
    }


def single_chain_ms(S: SingleMPCKernels, H: int) -> dict:
    """Per stage, an estimate of the least time along its dependent
    chains: the longest chain of the emitted step's statements
    (``S.chains``, from cgen's SSA output), CHAIN_CYCLES cycles a link at
    the card's largest SM clock. K6's H steps run side by side, one step a
    thread; K7's H steps follow one another, and so do each alpha's H steps
    of K8 before its terminal cost."""
    mhz = float(card_line("clocks.max.sm").split()[0])
    ms = lambda links: links * CHAIN_CYCLES / (mhz * 1e3)
    c = S.chains
    return {"linearize": ms(c["linearize"]), "backward": ms(H * c["backward"]),
            "forward": ms(H * c["forward"] + c["cost_terminal"])}


def single_path(panda, single, attrs: dict, card: str, built: dict) -> list:
    """Phases 10-12, the single-problem solver; returns its kernels'
    records."""
    S = single.kernels
    H, f32 = H_MPC, dict(dtype=torch.float32, device=DEV)
    u_lim = torch.tensor(S.P.u_lim, **f32)
    goal_a, goal_b = torch.tensor(Q_GOAL7, **f32), torch.tensor(Q_GOAL7_B, **f32)
    x0 = mid_rest(panda)

    # 10. K6-K8 vs their plain versions: at H=50 on the solver's own
    # controls (plain versions timed there, once), at the odd horizon on
    # random torques, and at H=50 with a Levenberg-heavy reg.
    us_nom = single.solve(x0, torch.zeros((H, 7), **f32))[0].contiguous()
    x0_r, goal_r, us_r = random_single_problem(panda, H_ODD, ODD_SEED)
    err = dict.fromkeys(SINGLE_KERNELS, 0.0)
    for nominal, x0_c, goal_c, us_c, calls, reg in (
        ("solver's controls", x0, goal_a, us_nom, 1, 1e-6), ("random torques", x0_r, goal_r, us_r, 0, 1e-6),
        ("solver's controls", x0, goal_a, us_nom, 0, REG_HEAVY),
    ):
        label = f"panda single H={us_c.shape[0]} reg={reg}"
        errs, args, ms = single_stage_parity(S, x0_c, goal_c, us_c, label, calls, reg)
        for stage in SINGLE_KERNELS:  # each does the plain version's operations in its order
            if errs[stage] != 0.0:
                raise AssertionError(f"{label} {stage}: max |d| = {errs[stage]}, not 0")
        err = {k: max(err[k], errs[k]) for k in err}
        if calls:
            stage_args, plain_ms = args, ms
        phase("single_parity", robot="panda", H=us_c.shape[0], reg=reg, nominal=repr(nominal),
              **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()})

    # 11. The main path: one solve, then ROUNDS receding-horizon rounds.
    cost_zero = single.forward(x0, torch.zeros((H, 14), **f32), torch.zeros((H, 7), **f32),
                               torch.zeros((H, 7, 15), **f32), goal_a, torch.zeros((1,), **f32))[2][0]

    def check(label, us, xs, cost):
        if tuple(us.shape) != (H, 7) or tuple(xs.shape) != (H + 1, 14) or tuple(cost.shape) != ():
            raise AssertionError(f"{label}: shapes {tuple(us.shape)}, {tuple(xs.shape)}, {tuple(cost.shape)}")
        for name, v in (("us", us), ("xs", xs), ("cost", cost)):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{label}: non-finite {name}")
        if not bool((us.abs() <= u_lim).all()):
            raise AssertionError(f"{label}: a control exceeds its torque limit")

    launches_at = lambda iters: {"linearize": iters, "backward": iters, "forward": iters + 1}
    SingleMPCKernels.reset_launch_count()
    t0 = time.perf_counter()
    us, xs, cost = single.solve(x0, torch.zeros((H, 7), **f32))
    torch.cuda.synchronize()
    solve_wall = time.perf_counter() - t0
    per_solve = dict(SingleMPCKernels.launch_count)
    if per_solve != launches_at(ITERS):
        raise AssertionError(f"launches per solve {per_solve}, expected {ITERS}/{ITERS}/{ITERS + 1}")
    check("solve", us, xs, cost)
    if not float(cost) < float(cost_zero):
        raise AssertionError(f"solve: cost {float(cost)} not below the zero-control {float(cost_zero)}")
    dist = lambda x, goal: float((x[:7] - goal).norm())
    x, us_warm = xs[1], torch.cat([us[1:], us[-1:]])
    d_start, dists = dist(x0, goal_a), []
    for r in range(ROUNDS):
        goal = goal_a if r < RETARGET else goal_b
        us_r, xs_r, cost_r = single.solve(x, us_warm, None if r < RETARGET else goal_b)
        check(f"round {r}", us_r, xs_r, cost_r)
        if r == RETARGET:
            d_retarget = dist(x, goal_b)
        x, us_warm = xs_r[1], torch.cat([us_r[1:], us_r[-1:]])
        dists.append(dist(x, goal))
    torch.cuda.synchronize()
    launches = dict(SingleMPCKernels.launch_count)
    if launches != {k: (ROUNDS + 1) * v for k, v in per_solve.items()}:
        raise AssertionError(f"launches over {ROUNDS + 1} solves {launches}")
    if not (dists[RETARGET - 1] < d_start and dists[-1] < d_retarget):
        raise AssertionError(f"distance to the goal did not shrink: {d_start} -> {dists[RETARGET - 1]}, "
                             f"then {d_retarget} -> {dists[-1]}")
    phase("single_main_path", robot="panda", H=H, iterations=ITERS, alphas=ALPHAS, solve_wall_s=f"{solve_wall:.4f}",
          launches_per_solve=json.dumps(per_solve).replace(" ", ""), launches_run=json.dumps(launches).replace(" ", ""),
          cost=f"{float(cost):.6e}", zero_control_cost=f"{float(cost_zero):.6e}",
          goal_distance=f"{d_start:.4f}->{dists[RETARGET - 1]:.4f},retarget:{d_retarget:.4f}->{dists[-1]:.4f}")

    # The whole solve against the plain solver on the card.
    small = build_tracking_mpc(panda, Q_GOAL7, H_SMALL, DT, iterations=2, line_search_steps=ALPHAS)
    us_k, xs_k, c_k = small.solve(x0, torch.zeros((H_SMALL, 7), **f32))
    (us_p, xs_p, c_p), small_plain_ms = timed(lambda: small.solve_plain(x0, torch.zeros((H_SMALL, 7), **f32)))
    d_cost = float((c_k - c_p).abs() / c_p.abs())
    d_x, d_u = float((xs_k[-1] - xs_p[-1]).abs().max()), float((us_k - us_p).abs().max())
    if not (d_cost <= 1e-5 and d_x <= 5e-4 and d_u <= 5e-3):
        raise AssertionError(f"single solve vs plain solver: cost rel {d_cost}, final state {d_x}, controls {d_u}")
    phase("single_solve_vs_plain", robot="panda", H=H_SMALL, iterations=2, cost_rel_err=f"{d_cost:.3e}",
          final_state_err=f"{d_x:.3e}", controls_err=f"{d_u:.3e}", plain_solve_ms=f"{small_plain_ms:.1f}")

    # 12. Time: each kernel (device time per launch), a solve at 4 and 2
    # iterations, one round; then a device trace of the solve.
    ms = {s: per_call_ms(lambda s=s: getattr(S, s)(*stage_args[s])) for s in SINGLE_KERNELS}
    zeros_us = torch.zeros((H, 7), **f32)
    solve_ms = time_ms(lambda: single.solve(x0, zeros_us))
    warm2 = build_tracking_mpc(panda, Q_GOAL7, H, DT, iterations=2, line_search_steps=ALPHAS)
    solve2_ms = time_ms(lambda: warm2.solve(x0, zeros_us))

    def round_():
        us_r, xs_r, _ = single.solve(x, us_warm)
        return xs_r[1], torch.cat([us_r[1:], us_r[-1:]])

    round_ms = time_ms(round_)
    kernel_sum = sum(ms[s] * k for s, k in launches_at(ITERS).items())
    kernel_sum2 = sum(ms[s] * k for s, k in launches_at(2).items())
    phase("single_time", card=repr(card), robot="panda", H=H, **{f"{s}_ms": f"{v:.4f}" for s, v in ms.items()},
          solve_ms=f"{solve_ms:.4f}", kernels_ms_per_solve=f"{kernel_sum:.4f}", glue_ms=f"{solve_ms - kernel_sum:.4f}",
          kernel_share=f"{kernel_sum / solve_ms:.4f}", solve_2it_ms=f"{solve2_ms:.4f}",
          glue_2it_ms=f"{solve2_ms - kernel_sum2:.4f}", kernel_share_2it=f"{kernel_sum2 / solve2_ms:.4f}",
          round_ms=f"{round_ms:.4f}", **{f"{s}_plain_ms": f"{v:.2f}" for s, v in plain_ms.items()})
    trace = device_profile(lambda: single.solve(x0, zeros_us))
    if trace:
        ours = {s: sum(v for k, v in trace["by_name"].items() if k.startswith(name[2])) for s, name in SINGLE_KERNELS.items()}
        phase("single_trace", robot="panda", H=H, iterations=ITERS, **{f"{k}_device_ms_per_solve": f"{v:.4f}" for k, v in ours.items()},
              glue_device_ms_per_solve=f"{trace['busy_ms'] - sum(ours.values()):.4f}",
              device_busy_ms_per_solve=f"{trace['busy_ms']:.4f}", device_busy_share=f"{trace['busy_share']:.4f}",
              device_launches_per_solve=f"{trace['launches']:.1f}")
    else:
        phase("single_trace", device_time="not measured (the profiler saw no device activity)")

    bo = single_bytes_ops(S, H, ALPHAS)
    chain = single_chain_ms(S, H)
    phase("single_chain", robot="panda", H=H, clocks_max_sm=repr(card_line("clocks.max.sm")),
          cycles_per_link=CHAIN_CYCLES, **{f"{s}_links": v for s, v in S.chains.items()},
          **{f"{s}_chain_bound_ms": f"{v:.5f}" for s, v in chain.items()})
    records = []
    for stage, (name, replaces, _) in SINGLE_KERNELS.items():
        b_ms, b_by = bound(*bo[stage])
        records.append({
            "name": name, "route": "cuda", "source": SINGLE_SOURCE, "replaces": replaces,
            "launches": launches[stage], "max_abs_err": err[stage],
            "tolerance": "0",
            "ms": ms[stage], "plain_ms": plain_ms[stage], "bound_ms": b_ms, "bound_by": b_by,
            "chain_bound_ms": chain[stage], "chain_bound": "estimate: longest chain of emitted statements x "
            f"{CHAIN_CYCLES} cycles at clocks.max.sm", "library_ms": None,
            "num_regs": attrs[stage]["num_regs"], "local_bytes": attrs[stage]["local_bytes"],
            "smem_bytes": attrs[stage]["smem_bytes"],
        })
        if stage == "forward":
            records[-1].update(team_figures(S))
        if stage == "linearize":
            records[-1].update(lin_figures(S, built))
    return records

# ---------------------------------------------------------------------------
# The planning path (K9, K10, K1)
# ---------------------------------------------------------------------------


def traj_bound(B: int, N: int, J: int, method: int = 5):
    """K9: both endpoints read once, three (B, N, J) outputs written once."""
    return bound((2 * B * J + 3 * B * N * J) * 4, TRAJ_OPS[method] * B * N * J)


def potential_bound(P: int, O: int):
    """K10: points, goal and obstacles read once, U and its gradient written
    once (28 bytes per point)."""
    return bound((3 * P + 3 + 3 * O + P + 3 * P) * 4, (POT_OPS_POINT + POT_OPS_OBSTACLE * O) * P)


def traj_errors(label: str, got, ref) -> dict:
    """Max |d| of K9's outputs against the plain version's, gated at
    TRAJ_ATOL."""
    errs = {k: float((g - r).abs().max()) for k, g, r in zip(TRAJ_ATOL, got, ref)}
    for k, tol in TRAJ_ATOL.items():
        if not errs[k] <= tol:  # also fails on NaN
            raise AssertionError(f"K9 {label}: max |d{k}| = {errs[k]} exceeds {tol}")
    return errs


def potential_errors(label: str, got, ref) -> dict:
    """Max |d| of K10's outputs against the plain version's, gated at
    POT_RTOL and POT_ATOL."""
    errs = {}
    for (k, atol), g, r in zip(POT_ATOL.items(), got, ref):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"K10 {label}: non-finite {k}")
        if not bool(((g - r).abs() <= atol + POT_RTOL * r.abs()).all()):
            raise AssertionError(f"K10 {label} {k}: max |d| = {float((g - r).abs().max())} over rtol {POT_RTOL}, atol {atol}")
        errs[k] = float((g - r).abs().max())
    return errs


def fmt_errs(errs: dict) -> dict:
    return {f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()}


def planning_parity(gen: torch.Generator) -> dict:
    """Phases 14 and 15: K9 and K10 against their plain versions on the card.
    Returns the largest |d| per kernel."""
    rand = lambda *shape: torch.rand(shape, generator=gen, device=DEV, dtype=torch.float32) * 2 - 1
    worst = {"trajectory": 0.0, "potential": 0.0}
    for B, N, J, Tf in TRAJ_PARITY:
        start, end = rand(B, J), rand(B, J)
        for method in (3, 5, 1):
            got = ew.trajectory_kernel(start, end, Tf, N, method)
            ref = ew.trajectory_plain(start, end, Tf, N, method)
            torch.cuda.synchronize()
            errs = traj_errors(f"B={B} N={N} J={J} method={method}", got, ref)
            worst["trajectory"] = max(worst["trajectory"], *errs.values())
            phase("traj_parity", B=B, N=N, J=J, Tf=Tf, method=method, **fmt_errs(errs))
    cases = [(P, O, d0, False) for P, O, d0 in POT_PARITY] + [(POT_PARITY[0] + (True,))]
    for P, O, d0, overlap in cases:
        pts, goal, obstacles = rand(P, 3), rand(3), rand(O, 3)
        if overlap:
            pts[P // 2] = obstacles[O - 1]
        got = ew.cartesian_potential_kernel(pts, goal, obstacles, d0)
        ref = ew.cartesian_potential_plain(pts, goal, obstacles, d0)
        torch.cuda.synchronize()
        errs = potential_errors(f"P={P} O={O}", got, ref)
        if overlap and not float(got[0][P // 2]) > 1e17:
            raise AssertionError("K10: the point on an obstacle did not get the overlap potential")
        worst["potential"] = max(worst["potential"], *errs.values())
        phase("potential_parity", P=P, O=O, d0=d0, point_on_obstacle=overlap, **fmt_errs(errs))
    return worst


def traj_wide_parity() -> float:
    """K9 past 32-bit flat indices: the first and the last rows against the
    plain version of those rows (the whole plain version would not fit the
    card beside the kernel's 51.5 GB). Returns the largest |d|."""
    B, N, J, Tf = TRAJ_WIDE
    torch.cuda.empty_cache()
    gen = torch.Generator(DEV).manual_seed(1)
    start, end = (torch.rand((B, J), generator=gen, device=DEV) * 2 - 1 for _ in range(2))
    got = ew.trajectory_kernel(start, end, Tf, N, 5)
    errs = dict.fromkeys(TRAJ_ATOL, 0.0)
    for rows in (slice(0, TRAJ_WIDE_ROWS), slice(B - TRAJ_WIDE_ROWS, B)):
        ref = ew.trajectory_plain(start[rows], end[rows], Tf, N, 5)
        e = traj_errors(f"B={B} N={N} J={J} rows {rows.start}:{rows.stop}", [g[rows] for g in got], ref)
        errs = {k: max(errs[k], e[k]) for k in errs}
    phase("traj_parity", B=B, N=N, J=J, Tf=Tf, method=5, elements=B * N * J, rows_checked=f"first and last {TRAJ_WIDE_ROWS}",
          first_flat_index_of_last_rows=(B - TRAJ_WIDE_ROWS) * N * J, **fmt_errs(errs))
    del got, ref
    torch.cuda.empty_cache()
    return max(errs.values())


def planning_path(ur5, gen: torch.Generator):
    """Phase 16. Returns the launches of K9, K10 and K1 over the path, and
    the inputs of K9 and K10 on it (for their timing)."""
    f32 = dict(dtype=torch.float32, device=DEV)
    rand = lambda *shape: torch.rand(shape, generator=gen, **f32) * 2 - 1
    lo, hi = ur5.joint_lower, ur5.joint_upper
    start = rand(B_PLAN, 6)
    goal = torch.clamp(start + rand(B_PLAN, 6) * 0.8, lo, hi)
    # 30 obstacle points around the arm, and 2 in the way of the single plan
    # below (beside two link centres at its middle configuration).
    q_a = torch.tensor([0.0, -1.0, 1.2, 0.0, 0.5, 0.0], **f32)
    q_b = torch.tensor([1.2, -0.6, 0.8, 0.3, 0.2, 0.4], **f32)
    mid = potential_field.link_positions(ur5, 0.5 * (q_a + q_b))
    in_the_way = mid[[3, 5]] + torch.tensor([[0.02, 0.0, 0.03], [0.0, 0.03, -0.02]], **f32)
    cloud = torch.cat([rand(O_PLAN - 2, 3) * 0.8, in_the_way]).contiguous()
    field_goal = torch.tensor([0.4, 0.1, 0.3], **f32)
    planner = create_planner(ur5, obstacle_points=cloud)

    ew.ElementwiseKernels.reset_launch_count()
    CudaRollout.reset_launch_count()
    stage_ms = {}
    with torch.no_grad():
        plan, stage_ms["batch_joint_trajectory"] = timed(lambda: planner.batch_joint_trajectory(start, goal, TF_PLAN, N_PLAN))
        points, stage_ms["link_positions"] = timed(lambda: potential_field.link_positions(ur5, plan.position))
        (U, grad), stage_ms["cartesian_potential_field"] = timed(
            lambda: potential_field.cartesian_potential_field(points, field_goal, cloud, D0_PLAN))
        tau, stage_ms["inverse_dynamics_trajectory"] = timed(lambda: planner.inverse_dynamics_trajectory(*plan))
        (sim_q, sim_dq, _), stage_ms["forward_dynamics_trajectory"] = timed(
            lambda: planner.forward_dynamics_trajectory(plan.position[:, 0], plan.velocity[:, 0], tau, dt=DT_PLAN))
    torch.cuda.synchronize()
    open_loop = {**ew.ElementwiseKernels.launch_count, "rollout": CudaRollout.launch_count}
    if open_loop != {"trajectory": 1, "potential": 1, "rollout": 1}:
        raise AssertionError(f"the open-loop planning path launched {open_loop}, expected one launch per kernel")
    shapes = {"position": (plan.position, (B_PLAN, N_PLAN, 6)), "velocity": (plan.velocity, (B_PLAN, N_PLAN, 6)),
              "acceleration": (plan.acceleration, (B_PLAN, N_PLAN, 6)), "points": (points, (B_PLAN, N_PLAN, 6, 3)),
              "U": (U, (B_PLAN, N_PLAN, 6)), "grad": (grad, (B_PLAN, N_PLAN, 6, 3)), "tau": (tau, (B_PLAN, N_PLAN, 6)),
              "sim_q": (sim_q, (B_PLAN, N_PLAN, 6)), "sim_dq": (sim_dq, (B_PLAN, N_PLAN, 6))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"plan_path {name}: shape {tuple(x.shape)} or non-finite values")
    for name, x in (("plan", plan.position), ("rollout", sim_q)):
        if not bool(((x >= lo) & (x <= hi)).all()):
            raise AssertionError(f"plan_path: a {name} position lies outside the joint limits")
    ends = {"start": float((plan.position[:, 0] - start).abs().max()), "goal": float((plan.position[:, -1] - goal).abs().max()),
            "vel": float(plan.velocity[:, (0, -1)].abs().max())}
    if not (ends["start"] <= 1e-6 and ends["goal"] <= 1e-6 and ends["vel"] <= 1e-5):
        raise AssertionError(f"plan_path: boundary conditions of the plans off by {ends}")
    saturated = float((tau.abs() >= ur5.torque_limit).float().mean())  # inverse dynamics clamps to the limits
    if not bool((U >= 0).all()):
        raise AssertionError("plan_path: a negative potential")
    open_loop_err = float((sim_q - plan.position).abs().max())

    # One plan with the avoidance pass, against the cloud its straight line hits.
    kw = dict(avoidance_steps=AVOID_STEPS, avoidance_step_size=AVOID_STEP_SIZE, clearance_margin=AVOID_MARGIN)
    straight = planner.joint_trajectory(q_a, q_b, TF_PLAN, N_PLAN)
    avoided = planner.joint_trajectory(q_a, q_b, TF_PLAN, N_PLAN, avoid_collisions=True, **kw)
    clear = lambda q: float(potential_field.obstacle_clearance(ur5, q, planner.spheres, cloud).min())
    before, after = clear(straight.position), clear(avoided.position)
    if not (before < 0.0 and after >= AVOID_MARGIN - AVOID_SLACK and bool(torch.isfinite(avoided.position).all())):
        raise AssertionError(f"avoidance: min clearance {before} -> {after}, wanted < 0 -> >= {AVOID_MARGIN - AVOID_SLACK}")
    if not bool(((avoided.position >= lo) & (avoided.position <= hi)).all()):
        raise AssertionError("avoidance: a waypoint lies outside the joint limits")
    colliding, self_clear = planner.check_self_collision(q_a)

    # One Cartesian trajectory between the poses of that plan's ends.
    X_a, X_b = forward_kinematics(ur5, q_a), forward_kinematics(ur5, q_b)
    poses, lin_vel, _ = planner.cartesian_trajectory(X_a, X_b, TF_PLAN, N_PLAN)
    cart = max(float((poses[0] - X_a).abs().max()), float((poses[-1] - X_b).abs().max()))
    if tuple(poses.shape) != (N_PLAN, 4, 4) or not cart <= 1e-5 or not bool(torch.isfinite(lin_vel).all()):
        raise AssertionError(f"cartesian_trajectory: shape {tuple(poses.shape)}, ends off by {cart}")

    # The singularity measure along every plan.
    with torch.no_grad():
        sigma, sigma_ms = timed(lambda: singularity.singularity_measure(ur5, plan.position))
    if tuple(sigma.shape) != (B_PLAN, N_PLAN) or not bool(torch.isfinite(sigma).all()) or not bool((sigma >= 0).all()):
        raise AssertionError("singularity_measure: wrong shape, negative or non-finite values")

    # Closed loop: computed-torque control tracks the plans' first waypoints,
    # each period one step of the exact dynamics through the rollout kernel.
    q, dq = plan.position[:, 0].contiguous(), plan.velocity[:, 0].contiguous()
    state = control.ControlState(torch.zeros((B_PLAN, 6), **f32))
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(CTRL_STEPS):
            u, state = control.computed_torque_control(
                ur5, plan.position[:, t], plan.velocity[:, t], plan.acceleration[:, t], q, dq, None, DT_PLAN,
                CTRL_KP, 0.0, CTRL_KD, state)
            _, _, u = control.enforce_limits(ur5, q, dq, u)
            period = (q, dq, u[:, None, :].expand(-1, 2, -1).contiguous())
            qs, dqs, _ = trajectory.forward_dynamics_trajectory(ur5, *period, dt=DT_PLAN)
            q, dq = qs[:, 1].contiguous(), dqs[:, 1].contiguous()
    torch.cuda.synchronize()
    ctrl_wall = time.perf_counter() - t0
    closed_loop_err = float((q - plan.position[:, CTRL_STEPS]).abs().max())
    if not np.isfinite(closed_loop_err):
        raise AssertionError("closed loop: non-finite state")
    launches = {**ew.ElementwiseKernels.launch_count, "rollout": CudaRollout.launch_count}
    if launches != {"trajectory": 3, "potential": 1, "rollout": 1 + CTRL_STEPS}:
        raise AssertionError(f"the planning path launched {launches}")
    stats = planner.get_performance_stats()
    phase("plan_path", robot="ur5", B=B_PLAN, N=N_PLAN, Tf=TF_PLAN, O=O_PLAN, d0=D0_PLAN, points=points.shape[0] * N_PLAN * 6,
          launches_open_loop=json.dumps(open_loop).replace(" ", ""), launches=json.dumps(launches).replace(" ", ""),
          **{f"{k}_ms": f"{v:.3f}" for k, v in stage_ms.items()}, singularity_measure_ms=f"{sigma_ms:.3f}",
          boundary_err=json.dumps({k: float(f"{v:.3e}") for k, v in ends.items()}).replace(" ", ""),
          saturated_torque_share=f"{saturated:.4e}", open_loop_tracking_err_rad=f"{open_loop_err:.4e}", closed_loop_tracking_err_rad=f"{closed_loop_err:.4e}",
          control_periods=CTRL_STEPS, control_wall_s=f"{ctrl_wall:.3f}", min_clearance=f"{before:.4f}->{after:.4f}",
          self_collision=f"{colliding},{self_clear:.4f}", cartesian_ends_err=f"{cart:.3e}",
          sigma_min=f"{float(sigma.min()):.4e}", near_singular_waypoints=int((sigma < 1e-2).sum()))
    phase("plan_path_stats", calls=stats["calls"], total_s=f"{stats['total_time']:.4f}", first_calls_s=f"{stats['compile_time']:.4f}",
          avg_later_call_s=f"{stats['avg_steady_time']:.4f}",
          per_op=json.dumps({k: [v["calls"], round(v["time"], 4)] for k, v in stats["per_op"].items()}).replace(" ", ""))
    inputs_on_path = {"trajectory": (start, goal), "potential": (points.reshape(-1, 3).contiguous(), field_goal, cloud),
                      "rollout": (plan.position[:, 0].contiguous(), plan.velocity[:, 0].contiguous(), tau.contiguous()),
                      "control_period": period}
    return launches, inputs_on_path


def planning_path_parity(ur5, inputs_on_path: dict) -> dict:
    """Each kernel of the planning path against its plain version on the
    tensors the path gave it: K9 on the B_PLAN start/goal pairs, K10 on the
    link points of every waypoint, K1 (the unit built for dt = DT_PLAN) on
    the plans' torques (all N_PLAN steps through the kernel, its first
    STEPS_CHECKED held against the plain version of those steps: a rollout
    is causal) and on the last control period's. Made after the path's
    launch counts were read. Returns the largest |d| per kernel."""
    worst = {}
    with torch.no_grad():
        start, goal = inputs_on_path["trajectory"]
        got = ew.trajectory_kernel(start, goal, TF_PLAN, N_PLAN, 5)
        ref = ew.trajectory_plain(start, goal, TF_PLAN, N_PLAN, 5)
        errs = traj_errors("on the path's inputs", got, ref)
        worst["trajectory"] = max(errs.values())
        phase("plan_path_parity", kernel="K9", shape=f"{B_PLAN}x{N_PLAN}x6", **fmt_errs(errs))
        pts, field_goal, cloud = inputs_on_path["potential"]
        got = ew.cartesian_potential_kernel(pts, field_goal, cloud, D0_PLAN)
        ref = ew.cartesian_potential_plain(pts, field_goal, cloud, D0_PLAN)
        errs = potential_errors("on the path's inputs", got, ref)
        worst["potential"] = max(errs.values())
        phase("plan_path_parity", kernel="K10", P=pts.shape[0], O=cloud.shape[0], **fmt_errs(errs))
        del got, ref
        plain = build_rollout(ur5, dt=DT_PLAN)
        worst["rollout"] = dict.fromkeys(TOL, 0.0)
        for use in ("rollout", "control_period"):
            q0, dq0, taus = inputs_on_path[use]
            steps = min(taus.shape[1], STEPS_CHECKED)
            got = trajectory.forward_dynamics_trajectory(ur5, q0, dq0, taus, dt=DT_PLAN)
            ref, plain_ms = timed(lambda: plain(q0, dq0, taus[:, :steps].contiguous()))
            errs = max_errors([g[:, :steps] for g in got], ref)
            check_close(f"K1 on the planning path ({use})", errs)
            worst["rollout"] = {k: max(worst["rollout"][k], errs[k]) for k in TOL}
            phase("plan_path_parity", kernel="K1", use=use, shape="x".join(map(str, taus.shape)), dt=f"{DT_PLAN:.6f}",
                  steps_checked=steps, plain_ms=f"{plain_ms:.1f}", **fmt_errs(errs))
    return worst


def planning_time(ur5, gen: torch.Generator, inputs_on_path: dict, card: str):
    """Phase 17. Returns per kernel its ms, its plain version's and the
    replaced tensor formulation's, at the path's shapes. Every time is a
    CUDA-event median per call over back-to-back calls, so for the short
    kernels it is the larger of the device's time and the host's time to
    launch one call; ``device_ms`` is the kernel's own time in a
    ``torch.profiler`` trace of 5 launches."""
    rand = lambda *shape: torch.rand(shape, generator=gen, device=DEV, dtype=torch.float32) * 2 - 1

    def device_ms(fn, kernel_name: str):
        trace = device_profile(fn, reps=5)
        found = [v for k, v in trace.get("by_name", {}).items() if kernel_name in k]
        return sum(found) if found else None  # None: the profiler saw no device activity

    fmt = lambda v, digits=4: "not measured" if v is None else f"{v:.{digits}f}"
    rate = lambda count, ms, spec: "not measured" if ms is None else format(count / (ms * 1e-3), spec)

    out = {}
    start, goal = inputs_on_path["trajectory"]
    traj_cases = [("path", start, goal, N_PLAN)] + [(f"B{B}_N{N}", rand(B, J), rand(B, J), N) for B, N, J in TRAJ_TIMED]
    for label, a, b, N in traj_cases:
        with torch.no_grad():
            k_ms = per_call_ms(lambda: ew.trajectory_kernel(a, b, TF_PLAN, N, 5))
            d_ms = device_ms(lambda: ew.trajectory_kernel(a, b, TF_PLAN, N, 5), "mpt_traj_kernel")
            p_ms = per_call_ms(lambda: ew.trajectory_plain(a, b, TF_PLAN, N, 5), calls=5)
            g_ms = per_call_ms(lambda: trajectory._joint_trajectory_generic(ur5, a, b, TF_PLAN, N, 5, True), calls=5)
            e_ms = per_call_ms(lambda: trajectory.joint_trajectory(ur5, a, b, TF_PLAN, N), calls=5)
        b_ms, b_by = traj_bound(a.shape[0], N, a.shape[1])
        if label == "path":
            out["trajectory"] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, generic_ms=g_ms, bound_ms=b_ms, bound_by=b_by)
        phase("plan_time", card=repr(card), kernel="K9", shape=f"{a.shape[0]}x{N}x{a.shape[1]}", on_path=label == "path",
              kernel_ms=f"{k_ms:.4f}", device_ms=fmt(d_ms), bound_ms=f"{b_ms:.4f}", bound_by=b_by, plain_ms=f"{p_ms:.4f}",
              tensor_formulation_with_clip_ms=f"{g_ms:.4f}", entry_point_with_clip_ms=f"{e_ms:.4f}",
              written_GBps_device=rate(3 * a.shape[0] * N * a.shape[1] * 4 / 1e9, d_ms, ".1f"))
    pts, field_goal, cloud = inputs_on_path["potential"]
    pot_cases = [("path", pts)] + [(f"P{P}", rand(P, 3)) for P in POT_TIMED]
    for label, x in pot_cases:
        P = x.shape[0]
        with torch.no_grad():
            k_ms = per_call_ms(lambda: ew.cartesian_potential_kernel(x, field_goal, cloud, D0_PLAN), calls=20 if P < 10**6 else 5)
            d_ms = device_ms(lambda: ew.cartesian_potential_kernel(x, field_goal, cloud, D0_PLAN), "mpt_potential_kernel")
            p_ms = time_ms(lambda: ew.cartesian_potential_plain(x, field_goal, cloud, D0_PLAN), warmup=1, reps=3)
            g_ms = time_ms(lambda: potential_field._cartesian_potential_field_generic(x, field_goal, cloud, D0_PLAN), warmup=1, reps=3)
        b_ms, b_by = potential_bound(P, O_PLAN)
        if label == "path":
            out["potential"] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, generic_ms=g_ms, bound_ms=b_ms, bound_by=b_by)
        phase("plan_time", card=repr(card), kernel="K10", P=P, O=O_PLAN, on_path=label == "path", kernel_ms=f"{k_ms:.4f}",
              device_ms=fmt(d_ms), bound_ms=f"{b_ms:.4f}", bound_by=b_by, plain_ms=f"{p_ms:.3f}",
              tensor_formulation_ms=f"{g_ms:.3f}", point_obstacle_pairs_per_s_device=rate(P * O_PLAN, d_ms, ".4e"))
    # K1 at the path's two shapes: the plans' rollout, and one control period.
    # Beside its bound, an estimate of its least time along the dependent
    # chain: each scenario's N steps follow one another, the longest chain
    # of a step's statements (cgen.chain_length) at CHAIN_CYCLES a link and
    # the card's largest SM clock, as for K6-K8.
    q0, dq0, tau = inputs_on_path["rollout"]
    engine = build_cuda_rollout(ur5, dt=DT_PLAN)
    chain = engine.chain  # links of one step
    mhz = float(card_line("clocks.max.sm").split()[0])
    one_step = tau[:, :2].contiguous()
    for label, taus, ms in (
        ("plans", tau, time_ms(lambda: trajectory.forward_dynamics_trajectory(ur5, q0, dq0, tau, dt=DT_PLAN))),
        ("control_period", one_step, per_call_ms(lambda: trajectory.forward_dynamics_trajectory(ur5, q0, dq0, one_step, dt=DT_PLAN))),
    ):
        B, N = taus.shape[0], taus.shape[1]
        b_ms, b_by = bound((2 * B * 6 + 4 * B * N * 6) * 4, engine.statements * B * N)
        chain_ms = chain * N * CHAIN_CYCLES / (mhz * 1e3)
        out[f"rollout_{label}"] = dict(ms=ms, us_per_step=ms * 1e3 / N, bound_ms=b_ms, chain_bound_ms=chain_ms)
        phase("plan_time", card=repr(card), kernel="K1", shape=f"{B}x{N}x6", use=label, block=BLOCK,
              kernel_ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by, chain_links=chain * N,
              chain_bound_ms=f"{chain_ms:.4f}", clocks_max_sm=f"{mhz:.0f}", us_per_step=f"{ms * 1e3 / N:.2f}")
    return out

# ---------------------------------------------------------------------------
# The closed loop and the fleet layer (phases 19-23)
# ---------------------------------------------------------------------------


def fleet_problem(gen: torch.Generator, robots, S: int, H: int):
    """Fleet-shaped inputs: each robot's ``panda_problem`` in the first n_r
    joints of (R, S, 2 n_max) states and (R, S, n_max) goals, zero warm
    starts."""
    n_max = max(m.num_joints for m in robots)
    f32 = dict(dtype=torch.float32, device=DEV)
    x0 = torch.zeros((len(robots), S, 2 * n_max), **f32)
    goals = torch.zeros((len(robots), S, n_max), **f32)
    for r, m in enumerate(robots):
        n = m.num_joints
        x0_r, goals_r = panda_problem(gen, m, S)
        x0[r, :, :n], x0[r, :, n_max:n_max + n], goals[r, :, :n] = x0_r[:, :n], x0_r[:, n:], goals_r
    return x0, torch.zeros((len(robots), S, H, n_max), **f32), goals


def fleet_fused(panda, ur5, mesh, card: str) -> dict:
    """Phase 19: one fleet-MPC round of a Panda and a UR5 (padded to 7) on
    the batched fused solver, through ``parallel.fleet_mpc_round``; each
    robot's controls and costs bitwise its own solver's, the UR5's padded
    joint 0, the fleet cost the mean. The UR5's units (K2 at its own seeds a
    thread, K3-K5 for 6 joints) are held against their plain versions at
    the round's shapes, from the round's own controls, as the Panda's are in
    phase 7. Returns the round's launches and the UR5 stages' max |d|."""
    robots = (panda, ur5)
    S, H = B_MPC, H_MPC
    fleet = parallel.stack_models(list(robots))
    x0, us0, goals = fleet_problem(torch.Generator(DEV).manual_seed(19), robots, S, H)
    params = ILQRParams(horizon=H, dt=DT, iterations=ITERS, line_search_steps=ALPHAS)
    fused = parallel.build_fleet_fused_mpc(fleet, mesh, S, H, DT, iterations=ITERS, line_search_steps=ALPHAS)

    def round_():
        return parallel.fleet_mpc_round(fleet, mesh, x0, us0, goals, params, solver="fused_batch", fused_mpc=fused)

    BatchMPCKernels.reset_launch_count()
    us, costs, fleet_cost = round_()
    torch.cuda.synchronize()
    launches = dict(BatchMPCKernels.launch_count)
    expected = {"linearize": 2 * ITERS, "backward": 2 * ITERS, "linesearch_costs": 0, "linesearch": 2 * ITERS,
                "replay": 2}
    if launches != expected:
        raise AssertionError(f"the fleet round launched {launches}, expected {expected}")
    if tuple(us.shape) != (2, S, H, 7) or not bool(torch.isfinite(us).all() and torch.isfinite(costs).all()):
        raise AssertionError(f"fleet round: shape {tuple(us.shape)} or non-finite values")
    own, d_us, d_cost = [], 0.0, 0.0
    for r, m in enumerate(robots):
        n = m.num_joints
        solver = build_batch_tracking_mpc(m, goals[r, :, :n], S, H, DT, iterations=ITERS, line_search_steps=ALPHAS)
        x0_r = torch.cat([x0[r, :, :n], x0[r, :, 7:7 + n]], dim=1)
        us0_r = torch.zeros((S, H, n), device=DEV)
        us_r, _, cost_r = solver.solve(x0_r, us0_r)
        d_us = max(d_us, float((us[r, :, :, :n] - us_r).abs().max()))
        d_cost = max(d_cost, float((costs[r] - cost_r).abs().max()))
        own.append(lambda solver=solver, x0_r=x0_r, us0_r=us0_r: solver.solve(x0_r, us0_r))
    pad = float(us[1, :, :, 6].abs().max())
    mean_rel = abs(float(fleet_cost) - float(costs.mean())) / abs(float(costs.mean()))
    if d_us != 0.0 or d_cost != 0.0 or pad != 0.0 or not mean_rel <= 1e-6:
        raise AssertionError(f"fleet round: max |d us| {d_us}, |d cost| {d_cost} against each robot's own "
                             f"solver, padded joint {pad}, fleet cost against the mean {mean_rel}")
    # The UR5's kernels, the round ran them, against their plain versions.
    K_ur5 = fused.solvers[1].local[0].kernels
    x0_ur5 = torch.cat([x0[1, :, :6], x0[1, :, 7:13]], dim=1)
    us_ur5 = us[1, :, :, :6].permute(1, 2, 0).contiguous()
    ur5_errs = mpc_stage_parity(K_ur5, x0_ur5, goals[1, :, :6], us_ur5, f"fleet ur5 B={S} H={H}", False)[0]
    for stage in BITWISE_STAGES:
        if ur5_errs[stage] != 0.0:
            raise AssertionError(f"fleet ur5 B={S} H={H} {stage}: max |d| = {ur5_errs[stage]}, not 0")
    phase("mpc_parity", robot="ur5 (fleet)", B=S, H=H, reg=1e-6, nominal=repr("the fleet round's controls"),
          lin_seeds=K_ur5.LIN_SEEDS, **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in ur5_errs.items()})
    round_ms = time_ms(round_)
    own_ms = [time_ms(f) for f in own]
    round_ms_2 = time_ms(round_)
    phase("fleet_fused", card=repr(card), robots="panda,ur5(7)", S=S, H=H, iterations=ITERS, alphas=ALPHAS,
          mesh_devices=mesh.size, launches_round=json.dumps(launches).replace(" ", ""),
          max_abs_diff_us=d_us, max_abs_diff_cost=d_cost, padded_joint_max_abs_u=pad,
          fleet_cost=f"{float(fleet_cost):.6e}", fleet_cost_rel_to_mean=f"{mean_rel:.3e}",
          round_ms=f"{round_ms:.4f},{round_ms_2:.4f}", solve_ms_panda=f"{own_ms[0]:.4f}",
          solve_ms_ur5=f"{own_ms[1]:.4f}", solves_sum_ms=f"{sum(own_ms):.4f}")
    return {"launches": launches, "round_ms": min(round_ms, round_ms_2), "solves_sum_ms": sum(own_ms),
            "ur5_errs": ur5_errs}


def distributed_rollout_phase(ur5, mesh, engine, card: str) -> dict:
    """Phase 20: ``parallel.distributed_rollout`` at the rollout's shape on
    the one-device mesh: one K1 launch, bitwise the unsharded public call."""
    q0, dq0, tau = inputs(torch.Generator(DEV).manual_seed(20), B_FULL, N_FULL, 6)
    CudaRollout.reset_launch_count()
    got = parallel.distributed_rollout(ur5, mesh, q0, dq0, tau, dt=DT)
    torch.cuda.synchronize()
    launches = CudaRollout.launch_count
    if launches != mesh.size:
        raise AssertionError(f"distributed_rollout launched K1 {launches} times on {mesh.size} device(s)")
    ref = trajectory.forward_dynamics_trajectory(ur5, q0, dq0, tau, dt=DT)
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError("distributed_rollout differs from forward_dynamics_trajectory")
    k1 = lambda: engine(q0, dq0, tau)
    dist = lambda: parallel.distributed_rollout(ur5, mesh, q0, dq0, tau, dt=DT)
    k1_ms, dist_ms, dist_ms_2, k1_ms_2 = time_ms(k1), time_ms(dist), time_ms(dist), time_ms(k1)
    phase("distributed_rollout", card=repr(card), robot="ur5", B=B_FULL, N=N_FULL, mesh_devices=mesh.size,
          launches=launches, bitwise=True, ms=f"{dist_ms:.4f},{dist_ms_2:.4f}", k1_ms=f"{k1_ms:.4f},{k1_ms_2:.4f}")
    return {"launches": launches, "ms": min(dist_ms, dist_ms_2), "k1_ms": min(k1_ms, k1_ms_2)}


def ik_launches_per_iteration(model, T, guesses) -> float:
    """Device launches of one solve iteration: the difference of two
    ``torch.profiler`` traces, 20 and 10 iterations, over 10."""
    counts = {}
    for iters in (10, 20):
        trace = device_profile(lambda: ik.solve_ik_batch(model, T, guesses, max_iterations=iters), reps=1)
        counts[iters] = trace.get("launches", float("nan"))
    return (counts[20] - counts[10]) / 10


def ik_phase(ur5, card: str) -> None:
    """Phase 21: UR5 ``solve_ik_batch`` at B = 1000 in float64 (success
    rate at least 0.9, every success within 1e-5 m when its FK is taken
    again) and float32 (success rate reported); ms a solve and launches an
    iteration; then ``TracIKSolver.solve`` and ``smart_ik`` on 64 targets."""
    rng = np.random.default_rng(21)
    q_np = rng.uniform(-1.5, 1.5, (IK_B, 6))
    guess_np = q_np + rng.normal(0.0, 0.3, (IK_B, 6))
    for dtype in (torch.float64, torch.float32):
        model = ur5.to(dtype=dtype)
        q, guesses = (torch.tensor(a, dtype=dtype, device=DEV) for a in (q_np, guess_np))
        T = forward_kinematics(model, q)
        solve = lambda: ik.solve_ik_batch(model, T, guesses, max_iterations=IK_ITERS)
        res = solve()
        _, _, trans = ik.geometric_error(forward_kinematics(model, res.theta), T)
        rate = float(res.success.double().mean())
        worst = float(trans[res.success].max()) if bool(res.success.any()) else float("nan")
        if dtype == torch.float64 and not (rate >= IK_SUCCESS_BAR and worst < IK_TRANS_BAR):
            raise AssertionError(f"IK f64: success rate {rate}, worst success trans_err {worst}")
        ms = time_ms(solve, warmup=0, reps=2)
        per_iter = ik_launches_per_iteration(model, T, guesses)
        phase("ik", card=repr(card), robot="ur5", dtype=str(dtype).split(".")[1], B=IK_B, max_iterations=IK_ITERS,
              success_rate=rate, worst_success_trans_err=f"{worst:.3e}",
              mean_iterations=f"{float(res.iterations.double().mean()):.2f}", ms_per_solve=f"{ms:.2f}",
              launches_per_iteration=per_iter)
    model = ur5.to(dtype=torch.float64)
    T = forward_kinematics(model, torch.tensor(q_np[:IK_STRATEGY_TARGETS], dtype=torch.float64, device=DEV))
    solver = TracIKSolver(model, timeout=0.0, dls_iterations=IK_STRATEGY_ITERS, sqp_iterations=IK_STRATEGY_ITERS)
    cache = ik_cache.IKInitialGuessCache()
    for name, call in (("trac_ik", lambda T_i: solver.solve(T_i)),
                       ("smart_ik", lambda T_i: ik_cache.smart_ik(model, T_i, cache=cache,
                                                                  max_iterations=IK_STRATEGY_ITERS))):
        t0 = time.perf_counter()
        ok = [bool(call(T_i).success) for T_i in T]
        wall = time.perf_counter() - t0
        phase("ik_strategy", card=repr(card), robot="ur5", solver=name, targets=len(ok), iterations=IK_STRATEGY_ITERS,
              success_rate=sum(ok) / len(ok), ms_per_call=f"{wall * 1e3 / len(ok):.2f}")


def sim_phase(panda, card: str) -> None:
    """Phase 22: the Panda plant (dt 0.01, 4 substeps) tracking a
    500-waypoint quintic by computed torque, with viscous joint damping 0.1
    and without. Undamped, the last achieved position must lie within 0.05
    rad of the plan's end (the JAX test's bar, set on an undamped plant).
    Damped, computed torque does not model the damping and the wrist's small
    inertia leaves its last joint behind (0.082 rad), so that bar cannot
    hold; there every achieved position must agree within
    ``SIM_CPU_ATOL`` rad with the same plant, on the same plan, run on the
    host's CPU, which holds the damped substep on the card."""
    start = mid_rest(panda)[:7]
    end = torch.tensor(Q_GOAL7, dtype=torch.float32, device=DEV)
    plan = trajectory.joint_trajectory(panda, start, end, Tf=(SIM_WAYPOINTS - 1) * DT, N=SIM_WAYPOINTS)
    for damping in (SIM_DAMPING, 0.0):
        sim = Simulation(panda, dt=DT, substeps=SIM_SUBSTEPS, joint_damping=damping)
        sim.reset(q=start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        achieved = sim.run_controller(plan.position, plan.velocity, plan.acceleration)
        wall = time.perf_counter() - t0
        err = float(np.abs(achieved[-1] - end.cpu().numpy()).max())
        track = float(np.abs(achieved - plan.position.cpu().numpy()).max())
        if achieved.shape != (SIM_WAYPOINTS, 7) or not np.isfinite(achieved).all() or len(sim.history) != SIM_WAYPOINTS:
            raise AssertionError(f"sim damping {damping}: shape {achieved.shape} or non-finite positions")
        if damping == 0.0:
            gate = {"final_error_bar_rad": SIM_TRACK_BAR}
            if not err <= SIM_TRACK_BAR:
                raise AssertionError(f"sim: final error {err} (bar {SIM_TRACK_BAR})")
        else:
            host = Simulation(panda.to(device="cpu"), dt=DT, substeps=SIM_SUBSTEPS, joint_damping=damping)
            host.reset(q=start.cpu())
            t0 = time.perf_counter()
            ref = host.run_controller(plan.position.cpu(), plan.velocity.cpu(), plan.acceleration.cpu())
            d_cpu = float(np.abs(achieved - ref).max())
            gate = {"max_abs_diff_cpu_rad": f"{d_cpu:.3e}", "cpu_atol_rad": SIM_CPU_ATOL,
                    "cpu_ms_per_step": f"{(time.perf_counter() - t0) * 1e3 / SIM_WAYPOINTS:.3f}"}
            if not d_cpu <= SIM_CPU_ATOL:
                raise AssertionError(f"sim damping {damping}: achieved positions differ from the CPU plant's by "
                                     f"{d_cpu} rad (atol {SIM_CPU_ATOL})")
        phase("sim", card=repr(card), robot="panda", waypoints=SIM_WAYPOINTS, substeps=SIM_SUBSTEPS,
              joint_damping=damping, final_error_rad=f"{err:.3e}", max_tracking_error_rad=f"{track:.3e}",
              **gate, ms_per_step=f"{wall * 1e3 / SIM_WAYPOINTS:.3f}")


def pscan_phase(panda, card: str) -> None:
    """Phase 23: the generic iLQR on Panda, H = 50, float64, one iteration,
    with the sequential Riccati sweep and with the associative scan, at
    ``reg_init = 0`` (the scan bakes reg into the whole value recursion and
    the sweep into the factorised Quu only, so only without it are they the
    same function); the gains within 1e-6 relative. Then both backward
    passes timed on the same derivatives, and the gains' distance at the
    default reg of 1e-6."""
    model = panda.to(dtype=torch.float64)
    f64 = dict(dtype=torch.float64, device=DEV)
    step = make_step_fn(model, DT, fused=False)
    running, terminal = make_tracking_costs(model, torch.tensor(Q_GOAL7, **f64))
    x0 = mid_rest(model)
    us0 = torch.zeros((H_MPC, 7), **f64)
    limits = dict(u_min=-model.torque_limit, u_max=model.torque_limit)
    gains = {}
    for par in (True, False):
        params = ILQRParams(horizon=H_MPC, dt=DT, iterations=1, reg_init=0.0, parallel_riccati=par)
        gains[par] = ilqr(step, running, terminal, x0, us0, params, **limits).gains_K
    rel = float((gains[True] - gains[False]).abs().max() / gains[False].abs().max())
    if not rel <= PSCAN_REL_BAR:
        raise AssertionError(f"pscan: the gains differ by {rel} relative")
    # The derivatives along the zero-control rollout, as ilqr forms them.
    xs = [x0]
    for t in range(H_MPC):
        xs.append(step(xs[-1], us0[t]))
    x, ts = torch.stack(xs[:-1]), torch.arange(H_MPC, device=DEV)
    A, B = vmap(jacfwd(step, argnums=0))(x, us0), vmap(jacfwd(step, argnums=1))(x, us0)
    lx, lu = vmap(grad(running, argnums=0))(x, us0, ts), vmap(grad(running, argnums=1))(x, us0, ts)
    lxx, luu = vmap(hessian(running, argnums=0))(x, us0, ts), vmap(hessian(running, argnums=1))(x, us0, ts)
    lux = vmap(jacfwd(grad(running, argnums=1), argnums=0))(x, us0, ts)
    Vx, Vxx = grad(terminal)(xs[-1]), hessian(terminal)(xs[-1])
    eye = torch.eye(7, **f64)
    seq = lambda reg: riccati_sweep(A, B, lx, lu, lxx, luu, lux, Vx, Vxx, reg)
    par = lambda reg: parallel_riccati(A, B, lx, lu, lxx, luu + reg * eye, lux, Vx, Vxx)
    rel_default = float((par(1e-6)[1] - seq(1e-6)[1]).abs().max() / seq(1e-6)[1].abs().max())
    seq_ms, par_ms, par_ms_2, seq_ms_2 = (time_ms(lambda f=f: f(1e-6)) for f in (seq, par, par, seq))
    phase("pscan", card=repr(card), robot="panda", H=H_MPC, dtype="float64", gains_rel_diff_reg0=f"{rel:.3e}",
          gains_rel_diff_default_reg=f"{rel_default:.3e}", sequential_backward_ms=f"{seq_ms:.3f},{seq_ms_2:.3f}",
          parallel_backward_ms=f"{par_ms:.3f},{par_ms_2:.3f}", scan_levels=int(np.ceil(np.log2(H_MPC + 1))))


def closed_loop(ur5, panda, engine, card: str, records: list) -> None:
    """Phases 19-23 on a one-device mesh; the fleet round's launches of K2-K5
    and the distributed rollout's of K1 go into their kernels' records."""
    mesh = parallel.make_mesh(1)
    if mesh.devices[0].type != "cuda":
        raise AssertionError(f"make_mesh() chose {mesh.devices}")
    fleet = fleet_fused(panda, ur5, mesh, card)
    rollout = distributed_rollout_phase(ur5, mesh, engine, card)
    records[0].update(launches_distributed_rollout=rollout["launches"], distributed_rollout_ms=rollout["ms"],
                      distributed_rollout_k1_ms=rollout["k1_ms"])
    for rec in records[1:]:
        stage = next((s for s, (name, _) in MPC_KERNELS.items() if rec["name"] == name), None)
        if stage is not None:
            err = fleet["ur5_errs"][stage]
            if stage == "linesearch":  # K4 serves both stages
                err = max(err, fleet["ur5_errs"]["linesearch_costs"])
            rec.update(launches_fleet_round=fleet["launches"][stage], fleet_round_ms=fleet["round_ms"],
                       fleet_solves_sum_ms=fleet["solves_sum_ms"], max_abs_err_fleet_ur5=err,
                       max_abs_err=max(rec["max_abs_err"], err))
    ik_phase(ur5, card)
    sim_phase(panda, card)
    pscan_phase(panda, card)


def planning_timed(ur5, card: str) -> dict:
    """Phases 14-17: the planning kernels' parity, the planning path and its
    times; returns what ``planning_records`` needs."""
    gen = torch.Generator(DEV).manual_seed(0)
    worst = planning_parity(gen)
    launches, inputs_on_path = planning_path(ur5, gen)
    times = planning_time(ur5, gen, inputs_on_path, card)
    return {"worst": worst, "launches": launches, "inputs_on_path": inputs_on_path, "times": times}


def planning_records(ur5, attrs: dict, k1_record: dict, timed: dict) -> list:
    """Phase 18, the planning path's long plain versions; returns the
    records of K9 and K10, and adds the planning path's launches and errors
    of K1 to its record."""
    worst, launches, inputs_on_path, times = (timed[k] for k in ("worst", "launches", "inputs_on_path", "times"))
    # After the timings: the plain rollout is a hundred thousand launches.
    on_path = planning_path_parity(ur5, inputs_on_path)
    worst = {stage: max(worst[stage], on_path[stage]) for stage in worst}
    worst["trajectory"] = max(worst["trajectory"], traj_wide_parity())
    per_output = {k: max(k1_record["max_abs_err_per_output"][k], on_path["rollout"][k]) for k in TOL}
    plans, period = times["rollout_plans"], times["rollout_control_period"]
    k1_record.update(max_abs_err=max(per_output.values()), max_abs_err_per_output=per_output,
                     launches_planning_path=launches["rollout"], planning_ms=plans["ms"],
                     planning_us_per_step=plans["us_per_step"], planning_bound_ms=plans["bound_ms"],
                     planning_chain_bound_ms=plans["chain_bound_ms"], control_period_ms=period["ms"],
                     chain_bound="estimate: longest chain of a step's emitted statements x N x "
                                 f"{CHAIN_CYCLES} cycles at clocks.max.sm")
    names = {
        "trajectory": ("K9 joint trajectory (time scaling x joint delta)", "manipulapy_tpu/ops/pallas_kernels.py:122",
                       f"atol {TRAJ_ATOL}"),
        "potential": ("K10 Cartesian potential field and gradient", "manipulapy_tpu/ops/pallas_kernels.py:211",
                      f"rtol {POT_RTOL}, atol {POT_ATOL}"),
    }
    return [{
        "name": name, "route": "cuda", "source": ELEMENTWISE_SOURCE, "replaces": replaces, "launches": launches[stage],
        "max_abs_err": worst[stage], "tolerance": tolerance, "ms": times[stage]["ms"], "plain_ms": times[stage]["plain_ms"],
        "bound_ms": times[stage]["bound_ms"], "bound_by": times[stage]["bound_by"], "library_ms": None,
        "device_ms": times[stage]["device_ms"], "tensor_formulation_ms": times[stage]["generic_ms"],
        "num_regs": attrs[stage]["num_regs"],
        "local_bytes": attrs[stage]["local_bytes"],
    } for stage, (name, replaces, tolerance) in names.items()]


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
    gen = torch.Generator(DEV).manual_seed(0)

    # 2. Build, everything at once.
    ur5 = catalog.ur5(dtype=torch.float32)
    panda = catalog.panda(dtype=torch.float32)
    if ur5.device.type != DEV or panda.device.type != DEV:
        raise AssertionError("the catalog did not build on the card by default")
    engines = {
        "ur5": build_cuda_rollout(ur5, dt=DT, intRes=1),
        "ur5_intres3": build_cuda_rollout(ur5, dt=DT, intRes=3),
        "panda": build_cuda_rollout(panda, dt=DT, intRes=1),
        "ur5_plan": build_cuda_rollout(ur5, dt=DT_PLAN, intRes=1),  # what the planning path's rollout builds
    }
    mpc_panda = build_batch_tracking_mpc(panda, np.zeros(7), B_MPC, H_MPC, DT, iterations=ITERS)
    single = build_tracking_mpc(panda, Q_GOAL7, H_MPC, DT, iterations=ITERS, line_search_steps=ALPHAS)
    K_panda = mpc_panda.kernels
    k4_blocks = {threads: type("K4Block", (BatchMPCKernels,), {
        "UNITS": {"fwd": BatchMPCKernels.UNITS["fwd"]}, "DEFINES": {**BatchMPCKernels.DEFINES, "MPT_BLOCK": threads}})(
        panda, DT, w_q=K_panda.P.w_q, w_dq=K_panda.P.w_dq, w_u=K_panda.P.w_u, w_terminal=K_panda.P.wT[0],
        u_lim=K_panda.P.u_lim) for threads in K4_BLOCKS}
    mpc_kernels = {"panda": K_panda, "ur5": build_batch_tracking_mpc(ur5, np.zeros(6), 1, H_MPC, DT).kernels,
                   "panda single": single.kernels, **{f"panda K4 T{t}": V for t, V in k4_blocks.items()}}
    built, build_wall = build_all(engines, mpc_kernels, ew.kernels())
    attrs = {}
    for name, eng in engines.items():
        b = built["rollout", name]
        a = attrs[name] = eng.kernel_attributes()
        phase("build", kernel="K1 rollout", robot=name, block=BLOCK, chunk=CHUNK,
              seconds=f"{b.compile_seconds:.2f}", **a, ptxas=repr(ptxas_lines(b.log)))
        # The tiles live in dynamic shared memory and may cost no block an
        # SM; no more local bytes than sinf/cosf's 32-byte frame.
        if a["local_bytes"] > 32 or a["blocks_per_sm"] != a["blocks_per_sm_without_tiles"]:
            raise AssertionError(f"K1 {name}: {a}")
    mpc_attrs = {}
    for robot, K in mpc_kernels.items():
        mpc_attrs[robot] = K.kernel_attributes()
        for unit, b in built["mpc", robot].items():
            phase("build", kernel=f"mpc unit {unit}", robot=robot, seconds=f"{b.compile_seconds:.2f}",
                  ptxas=repr(ptxas_lines(b.log)))
        names = SINGLE_KERNELS if isinstance(K, SingleMPCKernels) else {
            **MPC_KERNELS, "linesearch_costs": ("K4 line-search costs alone (K0 inlined)",)}
        for stage, a in mpc_attrs[robot].items():
            extra = {"seeds_per_thread": K.LIN_SEEDS, "thread_statements": K.statements["linearize_group"],
                     "block": LIN_BLOCK} if isinstance(K, BatchMPCKernels) and stage == "linearize" else {}
            if isinstance(K, BatchMPCKernels) and stage == "backward":
                extra = {"dynamic_smem_bytes": K.layout_bytes()["backward"]}
            phase("build", kernel=names[stage][0], robot=robot, statements=K.statements[stage], **extra, **a)
        if robot == "panda single":
            phase("build", kernel=names["forward"][0], robot=robot, **team_figures(K))
            phase("build", kernel=names["linearize"][0], robot=robot, **lin_figures(K, built["mpc", robot]))
    if mpc_attrs["panda single"]["backward"]["local_bytes"] != 0:  # its state lives in shared memory
        raise AssertionError(f"K7 uses local memory: {mpc_attrs['panda single']['backward']}")
    # K6 spills nothing (ptxas's report); no more local bytes than sinf/cosf's 32-byte frame.
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", built["mpc", "panda single"]["lin"].log)
    if not spills or any(st != "0" or ld != "0" for st, ld in spills) \
            or mpc_attrs["panda single"]["linearize"]["local_bytes"] > 32:
        raise AssertionError(f"K6 spills: {spills}, {mpc_attrs['panda single']['linearize']}")
    # 13. The static unit of K9 and K10.
    ew_attrs = ew.kernels().kernel_attributes()
    for unit, b in built["planning", "elementwise"].items():
        phase("elementwise_build", unit=unit, seconds=f"{b.compile_seconds:.2f}", ptxas=repr(ptxas_lines(b.log)),
              **{f"{stage}_{k}": v for stage, a in ew_attrs.items() for k, v in a.items()})
    phase("build", wall_seconds=f"{build_wall:.2f}", units=len(engines) + 1 + sum(len(b) for k, b in built.items() if k[0] == "mpc"))

    # 3. Rollout kernel vs plain version, both on the card.
    worst = {"q": 0.0, "dq": 0.0, "ddq": 0.0}
    for name, int_res, B, N in ROLLOUT_CASES:
        model = panda if name == "panda" else ur5
        q0, dq0, tau = inputs(gen, B, N, model.num_joints)
        got = engines[name](q0, dq0, tau)
        ref = build_rollout(model, dt=DT, intRes=int_res)(q0, dq0, tau)
        torch.cuda.synchronize()
        errs = max_errors(got, ref)
        check_close(name, errs)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        phase("parity", robot=name, B=B, N=N, intRes=int_res,
              **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()})

    # 4. The rollout main path at full width, through the public entry point.
    q0, dq0, tau = inputs(gen, B_FULL, N_FULL, 6)
    CudaRollout.reset_launch_count()
    t0 = time.perf_counter()
    qs, dqs, ddqs = trajectory.forward_dynamics_trajectory(ur5, q0, dq0, tau, dt=DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rollout_launches = CudaRollout.launch_count
    if rollout_launches != 1:
        raise AssertionError(f"the kernel did not serve the main path ({rollout_launches} launches)")
    for name, x in (("q", qs), ("dq", dqs), ("ddq", ddqs)):
        if tuple(x.shape) != (B_FULL, N_FULL, 6) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"main path {name}: shape {tuple(x.shape)} or non-finite values")
    rows = ROWS_CHECKED
    ref = build_rollout(ur5, dt=DT)(q0[:rows], dq0[:rows], tau[:rows])
    errs = max_errors((qs[:rows], dqs[:rows], ddqs[:rows]), ref)
    check_close("main path", errs)
    worst = {k: max(worst[k], errs[k]) for k in worst}
    phase("main_path", B=B_FULL, N=N_FULL, wall_s=f"{wall:.4f}", kernel_launches=rollout_launches,
          **{f"max_abs_err_{k}_first{rows}": f"{v:.3e}" for k, v in errs.items()})

    # 5. Pipeline: quintic trajectory -> inverse dynamics -> rollout.
    start = (torch.rand((B_PIPELINE, 6), generator=gen, device=DEV) * 2 - 1) * 0.5
    goal = start + (torch.rand((B_PIPELINE, 6), generator=gen, device=DEV) * 2 - 1) * 0.25
    plan = trajectory.joint_trajectory(ur5, start, goal, Tf=(N_FULL - 1) * DT, N=N_FULL)
    torques = trajectory.inverse_dynamics_trajectory(ur5, plan.position, plan.velocity, plan.acceleration)
    sim_q, _, _ = trajectory.forward_dynamics_trajectory(
        ur5, plan.position[:, 0].contiguous(), plan.velocity[:, 0].contiguous(), torques.contiguous(), dt=DT
    )
    torch.cuda.synchronize()
    track = float((sim_q - plan.position).abs().max())
    if not np.isfinite(track):
        raise AssertionError(f"pipeline tracking error is {track}")
    if CudaRollout.launch_count < 2:
        raise AssertionError(f"the kernel did not serve the pipeline's rollout ({CudaRollout.launch_count} launches)")
    phase("pipeline", B=B_PIPELINE, N=N_FULL, max_abs_tracking_error_rad=f"{track:.4e}",
          kernel_launches=CudaRollout.launch_count)

    # 6. Rollout time: kernel vs plain version at the main path's shape.
    kernel = engines["ur5"]
    plain = build_rollout(ur5, dt=DT)
    plain_ms = time_ms(lambda: plain(q0, dq0, tau))
    kernel_ms = time_ms(lambda: kernel(q0, dq0, tau))
    kernel_ms_2 = time_ms(lambda: kernel(q0, dq0, tau))
    plain_ms_2 = time_ms(lambda: plain(q0, dq0, tau))
    k_ms, p_ms = min(kernel_ms, kernel_ms_2), min(plain_ms, plain_ms_2)
    steps = B_FULL * N_FULL
    n6 = 6
    k1_bytes = (2 * B_FULL * n6 + B_FULL * N_FULL * n6 + 3 * B_FULL * N_FULL * n6) * 4
    k1_bound, k1_by = bound(k1_bytes, kernel.statements * B_FULL * N_FULL)
    phase("time", card=repr(card), B=B_FULL, N=N_FULL, block=BLOCK, chunk=CHUNK,
          kernel_ms=f"{kernel_ms:.4f},{kernel_ms_2:.4f}", plain_ms=f"{plain_ms:.2f},{plain_ms_2:.2f}",
          kernel_steps_per_s=f"{steps / (k_ms * 1e-3):.4e}", plain_steps_per_s=f"{steps / (p_ms * 1e-3):.4e}",
          dram_GBps=f"{k1_bytes / (k_ms * 1e6):.1f}", us_per_step=f"{k_ms * 1e3 / N_FULL:.3f}")
    records = [{
        "name": "K1 rollout (step program K0 inlined)",
        "route": "cuda",
        "source": ROLLOUT_SOURCE,
        "replaces": "manipulapy_tpu/ops/pallas_rollout.py:219",
        "launches": rollout_launches,
        "max_abs_err": max(worst.values()),
        "max_abs_err_per_output": worst,
        "tolerance": TOL,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "num_regs": attrs["ur5"]["num_regs"],
        "local_bytes": attrs["ur5"]["local_bytes"],
        "smem_bytes": attrs["ur5"]["smem_bytes"],
        "dynamic_smem_bytes": attrs["ur5"]["dynamic_smem_bytes"],
        "blocks_per_sm": attrs["ur5"]["blocks_per_sm"],
        "block": BLOCK,
        "chunk": CHUNK,
        "dram_GBps": k1_bytes / (k_ms * 1e6),
        "us_per_step": k_ms * 1e3 / N_FULL,
    }]

    # 7. MPC kernels vs their plain versions on the card.
    K = mpc_panda.kernels
    mpc_err = dict.fromkeys(MPC_STAGES, 0.0)
    # Off the block size: random torques within 30% of the limits. At full
    # width, 50 such steps leave some scenarios non-finite (open loop, the
    # wrist's small inertias), so the nominal there is the solver's own
    # answer from rest, the trajectory its last iteration linearises.
    u_lim = torch.tensor(K.P.u_lim, device=DEV)
    x0_s, goals_s = panda_problem(gen, panda, B_PARITY)
    us_s = (torch.rand((H_PARITY, 7, B_PARITY), generator=gen, device=DEV) * 2 - 1) * 0.3 * u_lim[:, None]
    x0_f, goals_f = panda_problem(gen, panda, B_MPC)
    us_f = mpc_panda.solve(x0_f, torch.zeros((B_MPC, H_MPC, 7), device=DEV), goals_f)[0]
    # The last case is Levenberg-heavy: reg = 10 dominates Quu's diagonal.
    us_f = us_f.permute(1, 2, 0).contiguous()
    cases = (("random torques", x0_s, goals_s, us_s.contiguous(), False, 1e-6),
             ("solver's controls", x0_f, goals_f, us_f, True, 1e-6),
             ("solver's controls", x0_f, goals_f, us_f, False, REG_HEAVY))
    for nominal, x0_c, goals_c, us_c, full, reg in cases:
        B, H = us_c.shape[2], us_c.shape[0]
        errs, args, plain_ms = mpc_stage_parity(K, x0_c, goals_c, us_c, f"panda B={B} H={H} reg={reg}", full, reg=reg)
        for stage in BITWISE_STAGES:  # K2, K4 and K5 do the plain version's operations in its order
            if errs[stage] != 0.0:
                raise AssertionError(f"panda B={B} H={H} {stage}: max |d| = {errs[stage]}, not 0")
        if full:
            stage_args, stage_plain_ms = args, plain_ms
        mpc_err = {k: max(mpc_err[k], errs[k]) for k in mpc_err}
        phase("mpc_parity", robot="panda", B=B, H=H, reg=reg, nominal=repr(nominal),
              **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()})

    # 8. The MPC main path at full width, through the public entry points.
    x0, goals = panda_problem(gen, panda, B_MPC)
    mpc = build_batch_tracking_mpc(panda, goals, B_MPC, H_MPC, DT, iterations=ITERS)
    u_lim = torch.tensor(K.P.u_lim, device=DEV)
    us_warm = torch.zeros((B_MPC, H_MPC, 7), device=DEV)
    f32 = dict(dtype=torch.float32, device=DEV)
    cost_zero = mpc.replay(
        x0.T.contiguous(), torch.zeros((H_MPC, 14, B_MPC), **f32), torch.zeros((H_MPC, 7, B_MPC), **f32),
        torch.zeros((H_MPC, 7, 15, B_MPC), **f32), goals.T.contiguous(), torch.zeros((B_MPC,), **f32),
    )[2]
    BatchMPCKernels.reset_launch_count()
    t0 = time.perf_counter()
    us, xs, cost = mpc.solve(x0, us_warm)
    torch.cuda.synchronize()
    solve_wall = time.perf_counter() - t0
    per_solve = dict(BatchMPCKernels.launch_count)
    if per_solve != {"linearize": ITERS, "backward": ITERS, "linesearch_costs": 0, "linesearch": ITERS, "replay": 1}:
        raise AssertionError(f"launches per solve {per_solve}, expected K2 {ITERS}, K3 {ITERS}, K4 {ITERS} "
                             "(with the trajectories), K5 1")

    def check_solution(label, us, xs, cost):
        if tuple(us.shape) != (B_MPC, H_MPC, 7) or tuple(xs.shape) != (B_MPC, H_MPC + 1, 14):
            raise AssertionError(f"{label}: shapes {tuple(us.shape)}, {tuple(xs.shape)}")
        for name, v in (("us", us), ("xs", xs), ("cost", cost)):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{label}: non-finite {name}")
        if not bool((us.abs() <= u_lim).all()):
            raise AssertionError(f"{label}: a control exceeds its torque limit")

    check_solution("solve", us, xs, cost)
    if not (bool((cost <= cost_zero).all()) and float(cost.mean()) < float(cost_zero.mean())):
        raise AssertionError(f"solve: mean cost {float(cost.mean())} not below the zero-control {float(cost_zero.mean())}")
    x, us_warm = xs[:, 1].contiguous(), torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    round_costs = []
    for r in range(3):
        _, goals_r = panda_problem(gen, panda, B_MPC)
        u_first, us_warm, (us_r, xs_r, cost_r) = batch_mpc_step(mpc, x, us_warm, goals_r)
        check_solution(f"round {r}", us_r, xs_r, cost_r)
        x = xs_r[:, 1].contiguous()
        round_costs.append(float(cost_r.mean()))
    torch.cuda.synchronize()
    mpc_launches = dict(BatchMPCKernels.launch_count)
    if mpc_launches != {k: 4 * v for k, v in per_solve.items()}:
        raise AssertionError(f"launches over 4 solves {mpc_launches}")
    phase("mpc_main_path", robot="panda", B=B_MPC, H=H_MPC, iterations=ITERS, solve_wall_s=f"{solve_wall:.4f}",
          launches_per_solve=json.dumps(per_solve).replace(" ", ""), launches_4_solves=json.dumps(mpc_launches).replace(" ", ""),
          mean_cost=f"{float(cost.mean()):.6e}", mean_zero_control_cost=f"{float(cost_zero.mean()):.6e}",
          round_mean_costs=",".join(f"{c:.6e}" for c in round_costs))

    # The whole solve against the plain solver on the card, at a size the
    # plain version affords (it is host-bound).
    Bs, Hs = B_SMALL, H_SMALL
    small = build_batch_tracking_mpc(panda, goals[:Bs], Bs, Hs, DT, iterations=2)
    xs0_small = x0[:Bs].contiguous()
    (us_k, xs_k, c_k), small_kernel_ms = timed(lambda: small.solve(xs0_small, torch.zeros((Bs, Hs, 7), **f32)))
    (us_p, xs_p, c_p), small_plain_ms = timed(lambda: small.solve_plain(xs0_small, torch.zeros((Bs, Hs, 7), **f32)))
    d_cost = float(((c_k - c_p).abs() / c_p.abs()).max())
    d_x = float((xs_k[:, -1] - xs_p[:, -1]).abs().max())
    d_u = float((us_k - us_p).abs().max())
    if not (d_cost <= 1e-5 and d_x <= 5e-4 and d_u <= 5e-3):
        raise AssertionError(f"solve vs plain solver: cost rel {d_cost}, final state {d_x}, controls {d_u}")
    phase("mpc_solve_vs_plain", robot="panda", B=Bs, H=Hs, iterations=2, cost_rel_err=f"{d_cost:.3e}",
          final_state_err=f"{d_x:.3e}", controls_err=f"{d_u:.3e}")

    # 9. MPC time: each stage and the whole solve, per width.
    phase("mpc_time_plain", card=repr(card), robot="panda", B=B_MPC, H=H_MPC,
          **{f"{s}_plain_ms": f"{v:.2f}" for s, v in stage_plain_ms.items()},
          **{f"plain_solve_ms_B{Bs}_H{Hs}": f"{small_plain_ms:.1f}", f"kernel_solve_ms_B{Bs}_H{Hs}": f"{small_kernel_ms:.4f}"})
    replay_err_by_B, linesearch_err_by_B = {}, {}
    block_ms = {threads: {} for threads in K4_BLOCKS}
    for B in (B_MPC,) + B_MPC_WIDE:
        if B == B_MPC:
            handle, x0_b, args = mpc, x0, stage_args
        else:
            x0_b, goals_b = panda_problem(gen, panda, B)
            handle = build_batch_tracking_mpc(panda, goals_b, B, H_MPC, DT, iterations=ITERS)
            us_b = handle.solve(x0_b, torch.zeros((B, H_MPC, 7), **f32))[0].permute(1, 2, 0).contiguous()
            args = mpc_stage_parity(K, x0_b, goals_b, us_b, f"panda B={B}", False, check=False)[1]
        ms = {s: time_ms(lambda s=s: getattr(K, s)(*args[s])) for s in MPC_STAGES}
        solve = time_ms(lambda: handle.solve(x0_b, torch.zeros((B, H_MPC, 7), **f32)))
        for threads, V in k4_blocks.items():
            block_ms[threads][B] = time_ms(lambda V=V: V.linesearch(*args["linesearch"]))
        # K5 and K4 bit for bit at every width, K4's block variants bit for
        # bit as the unit (after the timings: the plain versions run long).
        got, ref = K.replay(*args["replay"]), K.replay_plain(*args["replay"])
        replay_err_by_B[B] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        if replay_err_by_B[B] != 0.0 or not all(bool(torch.isfinite(r).all()) for r in ref):
            raise AssertionError(f"panda B={B} replay: max |d| = {replay_err_by_B[B]}, not 0")
        # Every alpha of every scenario: some diverge (alpha 1 on a nominal
        # far from the optimum), in the plain version too; the solve's
        # isfinite test rejects them. Bit for bit, NaN where it is NaN.
        got, ref = K.linesearch(*args["linesearch"]), K.linesearch_plain(*args["linesearch"])
        linesearch_err_by_B[B] = max(bit_diff(g, r) for g, r in zip(got, ref))
        nonfinite = int((~torch.isfinite(ref[0])).sum())
        if linesearch_err_by_B[B] != 0.0:
            raise AssertionError(f"panda B={B} linesearch: max |d| = {linesearch_err_by_B[B]}, not 0")
        for threads, V in k4_blocks.items():
            if not all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                       for g, r in zip(V.linesearch(*args["linesearch"]), got)):
                raise AssertionError(f"panda B={B}: K4 with {threads} threads a block differs from the unit")
        kernel_sum = sum(ms[s] * per_solve[s] for s in MPC_STAGES)
        if B == B_MPC:
            stage_ms = ms
        # K3's achieved rates: the bytes it must move (AB, xs, us read once,
        # kK written once) and its emitted operations, over its time; K2's
        # operations (its bound's) and the statements it runs, over its time.
        bo_b = stage_bytes_ops(K, B, H_MPC, ALPHAS)
        k3_bytes, k3_ops = bo_b["backward"]
        rates = {"linearize_Gops_per_s": bo_b["linearize"][1] / (ms["linearize"] * 1e6),
                 "linearize_Gstatements_per_s": lin_statements(K, B, H_MPC) / (ms["linearize"] * 1e6)}
        if B == B_MPC:
            lin_rates = rates
        phase("mpc_time", card=repr(card), robot="panda", B=B, H=H_MPC, iterations=ITERS,
              **{f"{s}_ms": f"{v:.4f}" for s, v in ms.items()},
              **{f"linesearch_ms_T{t}": f"{block_ms[t][B]:.4f}" for t in K4_BLOCKS}, solve_ms=f"{solve:.4f}",
              solves_per_s=f"{B / (solve * 1e-3):.4e}", kernels_ms_per_solve=f"{kernel_sum:.4f}",
              kernel_share=f"{kernel_sum / solve:.4f}", replay_max_abs_err=f"{replay_err_by_B[B]:.3e}",
              linesearch_max_abs_err=f"{linesearch_err_by_B[B]:.3e}", linesearch_nonfinite_costs=nonfinite,
              backward_GBps=f"{k3_bytes / (ms['backward'] * 1e6):.1f}",
              backward_Gops_per_s=f"{k3_ops / (ms['backward'] * 1e6):.1f}",
              **{k: f"{v:.1f}" for k, v in rates.items()})

    bo = stage_bytes_ops(K, B_MPC, H_MPC, ALPHAS)
    batch_chain = batch_chain_ms(K, H_MPC)
    phase("mpc_chain", robot="panda", H=H_MPC, clocks_max_sm=repr(card_line("clocks.max.sm")),
          cycles_per_link=CHAIN_CYCLES, **{f"{s}_links": v for s, v in K.chains.items()},
          **{f"{s}_chain_bound_ms": f"{v:.5f}" for s, v in batch_chain.items()})
    for stage, (name, replaces) in MPC_KERNELS.items():
        b_ms, b_by = bound(*bo[stage])
        a = mpc_attrs["panda"][stage]
        launches, err = mpc_launches[stage], mpc_err[stage]
        if stage == "linesearch":  # K4 serves both stages
            launches, err = launches + mpc_launches["linesearch_costs"], max(err, mpc_err["linesearch_costs"])
        records.append({
            "name": name, "route": "cuda", "source": MPC_SOURCE, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "tolerance": "0" if stage in BITWISE_STAGES else f"{MPC_RTOL} x max|plain|",
            "ms": stage_ms[stage], "plain_ms": stage_plain_ms[stage], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "num_regs": a["num_regs"], "local_bytes": a["local_bytes"],
            "smem_bytes": a["smem_bytes"],
        })
        if stage in batch_chain:
            records[-1].update(chain_bound_ms=batch_chain[stage], chain_bound="estimate: longest chain of emitted "
                               f"statements x {CHAIN_CYCLES} cycles at clocks.max.sm")
        if stage == "replay":
            records[-1].update(threads_per_scenario=1, block=BLOCK_MPC, max_abs_err_by_B=replay_err_by_B)
        if stage == "linesearch":
            c_ms, c_by = bound(*bo["linesearch_costs"])
            c_attrs = mpc_attrs["panda"]["linesearch_costs"]
            records[-1].update(
                block=BLOCK_MPC, max_abs_err_by_B=linesearch_err_by_B,
                trajectory_bytes=ALPHAS * H_MPC * (K.nx + K.n) * B_MPC * 4,
                costs_only_ms=stage_ms["linesearch_costs"], costs_only_plain_ms=stage_plain_ms["linesearch_costs"],
                costs_only_bound_ms=c_ms, costs_only_bound_by=c_by, costs_only_num_regs=c_attrs["num_regs"],
                costs_only_local_bytes=c_attrs["local_bytes"],
                block_variants={t: {**{f"ms_B{B}": v for B, v in block_ms[t].items()},
                                    "num_regs": mpc_attrs[f"panda K4 T{t}"]["linesearch"]["num_regs"],
                                    "local_bytes": mpc_attrs[f"panda K4 T{t}"]["linesearch"]["local_bytes"]}
                                for t in K4_BLOCKS})
        if stage == "backward":
            records[-1].update(dynamic_smem_bytes=K.layout_bytes()["backward"])
        if stage == "linearize":
            records[-1].update(seeds_per_thread=K.LIN_SEEDS, block=LIN_BLOCK,
                               thread_statements=K.statements["linearize_group"],
                               Gops_per_s=lin_rates["linearize_Gops_per_s"],
                               Gstatements_per_s=lin_rates["linearize_Gstatements_per_s"],
                               backward_Gops_per_s=bo["backward"][1] / (stage_ms["backward"] * 1e6))

    records += single_path(panda, single, mpc_attrs["panda single"], card, built["mpc", "panda single"])
    plan_timed = planning_timed(ur5, card)
    closed_loop(ur5, panda, engines["ur5"], card, records)
    records += planning_records(ur5, ew_attrs, records[0], plan_timed)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
