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
2. build: every kernel through one bounded pool of nvcc processes
   (``os.cpu_count() - 1``, fewer where memory is short; each unit once),
   phase 32's units queued behind these and built while phases 27-31 and
   3-26 run (the rollout for UR5 with intRes 1 and 3, at the planning
   path's dt, and for Panda; K2-K5 for Panda and UR5, and K2 alone in
   both its forms for each; K6-K8 for Panda, and K8 alone in both its
   forms (the team and the looped one); the
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
6. rollout time, kernel vs plain version (CUDA events; the plain version
   one call a turn), the DRAM rate the
   kernel achieves (the bytes of its bound over its time) and its us a
   waypoint;
6b. ``looped_time``: K1 on the looped step (``csrc/fd_step_loop.cuh``, the
   robot in a table; one unit per joint count) at that shape on the
   programmatic UR5 and Panda: the first 4096 rows and 10 steps bitwise
   ``LoopRollout`` on the card, both forms timed in turns, registers, local bytes, blocks
   an SM and each form's SASS instructions;
7. MPC parity: each of K2-K5 against its plain version on the card, fed
   from a nominal trajectory (K2 and K3) and from K3's gains (K4, with and
   without every alpha's trajectory, and K5), at Panda B=257 H=8 (not a
   multiple of the block, so the ``b < B`` guard is exercised; random
   torques) and at the main path's shapes, B=1024 H=50 (the solver's own
   controls), there also with a Levenberg-heavy ``reg`` of 10 (K3 held on
   the sweep's last 10 steps); max |d| per
   output within 1e-5 of that output's largest magnitude for K3, and 0 for
   K2, K4 and K5 (the plain version's emitted operations in its order);
   K2 in the form the route did not give the Panda at 0 on the same inputs,
   and both forms of K2 on the programmatic UR5 at B=257 H=8 and at B=1024
   H=50 on its solver's own controls (K2's looped form,
   ``csrc/fd_step_loop_jvp.cuh``, against ``fd_step_loop_jvp_planes``);
   K4 (both stages) and K5 in the form the route did not give the Panda,
   and both forms on the UR5, at 0 against one plain call over the A + 1
   alphas (K4's, then each scenario's own; the looped form,
   ``csrc/mpc_batch.cuh`` with ``MPT_FWD_LOOP``, against
   ``loop_fwd_rollout_plain``), and both forms once more at B=257 with
   scenario 5's velocity NaN, NaN in the same places;
8. MPC main path: one solve and 3 rounds of ``batch_mpc_step`` with goals
   passed at run time, launch counts read just after (per solve K2 4, K3
   4, K4 4 with the trajectories, K5 1: the initial rollout; K2's by form,
   all 4 of the form the route gives the Panda; K4's and K5's likewise,
   ``fwd_launches``), finite
   outputs, costs below the zero-control rollout's, |u| <= u_lim; then the
   whole solve against the plain solver on the card at Panda B=64 H=10
   with 2 iterations;
9. MPC time: the plain versions at full width and the plain solver at
   B=64; then each stage's kernel and one solve (CUDA events, median) at
   B=1024, 4096 and 16384, with K2's and K3's achieved rates (their
   bounds' operations over their times; K2 also the statements it runs),
   K4 (with its trajectories, every alpha; NaN where the plain version has
   NaN) and K5 against their plain versions at each width, max |d| = 0
   (at B=1024 phase 7's check on the same inputs; at B = 4096 and 16384
   on the solve of K2's emitted form, the nominal
   they had before K2 had a looped form), and K4 built with 32 and 64
   threads a block (variant units of the fwd unit, built with the others)
   held bitwise to the
   default and timed at each width; K4's and K5's records carry an
   estimate of their dependent chains' least time (``chain_bound_ms``),
   K4's its trajectory bytes, costs-only time and block variants, K5's its
   one thread a scenario; ``mpc_time_k2_forms``: both forms of K2 timed in
   turns (emitted, looped, looped, emitted) at each width, each form's
   seeds a thread, registers, local bytes, blocks an SM and SASS
   instructions (``cuobjdump``), and one solve on each form;
   ``mpc_time_k45_forms``: K4 (with its trajectories) and K5 in both forms
   the same way, per kernel registers, local bytes, blocks an SM and SASS
   instructions, and one solve on each form (the UR5's at B=1024 in
   phase 7's line);
10. single-problem parity: each of K6-K8 against its plain version on the
    card at Panda H=50 (the solver's own controls), H=37 (random torques
    within 30% of the limits; K6's H*m lanes end mid-block) and H=50
    again with a Levenberg-heavy reg of 10 (in these two K7 held on the
    sweep's last 10 steps), max |d| per output 0 for each:
    K6 (the lean one-seed body, one thread a lane or split over a team of
    warps; its record carries its design), K7 (one block of threads whose
    phases do the plain version's operations in its order) and K8 in the
    solver's form (the team's); K8 in its looped form against its own
    plain version on the same inputs, at A = 1 (the initial rollout) and
    A = 6 (on the first 10 steps in the reg = 10 case); both forms once
    more with alpha 2 NaN, NaN where the plain version has it and every
    other alpha's bits kept (the team K8: the emitted step split over a
    team of warps, as K5's variant; the looped K8, ``csrc/fwd_loop_lanes.cuh``:
    one warp an alpha, its lanes over the joints, against
    ``loop_forward_plain``);
11. single-problem main path: one solve from rest at the middle of the
    joint limits towards the benchmark's goal, then 20 receding-horizon
    rounds (x <- xs[1], the warm start shifted by one), the goal
    re-targeted at run time in round 10; launch counts read just after
    (4/4/5 per solve, K8's all the team's, ``forward_launches``),
    finite outputs, |u| <= u_lim, the cost below the
    zero-control cost, the distance to each goal shrinking; then the whole
    solve against the plain solver on the card at H=10, 2 iterations;
12. single-problem time: each kernel at H=50 (device time per launch, over
    20 back-to-back launches), one solve at 4 and at 2 iterations, one
    receding round, and the glue (the solve minus its kernels' sum),
    CUDA-event medians; ``single_time_k8_forms``: both K8 forms timed in
    turns (team, looped, looped, team) at A = 6 and A = 1, each form's
    registers, local and shared bytes and SASS instructions (each form's
    time the median of its four turns, beside the turns' spread), and one
    solve at 4 and at 2 iterations on the looped form (K8's launches in
    the first are the looped record's); then a ``torch.profiler``
    trace of 3 solves: each
    kernel's device time per solve, the glue's, and the device's busy
    share. K6-K8's records carry, beside the throughput bound, an estimate
    of their dependent chains' least time (``chain_bound_ms``; the team's
    for K8, whose emitted step it reads; the looped K8's record has none);
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
    the plans' torques (the rollout's first 100 steps of 1000) and the
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
    traces); then ``TracIKSolver.solve`` and ``ik_cache.smart_ik`` on 16
    targets each;
22. ``sim``: the Panda ``Simulation`` (dt 0.01, 4 substeps) tracking a
    200-waypoint quintic by ``run_controller``, with joint damping 0.1
    (error reported) and without (final error within 0.05 rad); ms a step;
23. ``pscan``: the generic iLQR on Panda, H=50, float64, one iteration,
    with the associative-scan and the sequential Riccati pass at reg 0
    (gains within 1e-6 relative), and both backward passes timed.

After phase 18, the calibrated URDF robots, the ones
``models.catalog.get_robot`` resolves to by default (their K1 and K2-K5
units join phase 2's build):

24. ``urdf_models``: parse and extract every calibrated (25) and DH (29)
    robot on the host, their seconds, and a line per robot with its joints
    and digest; ``get_robot("ur5")`` must have the calibrated UR5's digest,
    not the programmatic one's;
25. ``urdf_rollout``: K1 through ``trajectory.forward_dynamics_trajectory``
    at B=131072, N=50, dt=0.01 on the calibrated UR5, the Gen3 (no position
    limit on joints 1, 3, 5 and 7) and the 8-joint Panda (its finger
    prismatic, [0, 0.04] m at 0.2 m/s): q0 uniform within the limits
    clipped to [-1, 1], dq0 in [-0.5, 0.5], tau in [-10, 10]; one launch
    each, of the form the route gives the robot; then both forms (the
    emitted step and the looped one), each its first 4096 rows and 10
    steps bitwise its own plain version's, timed in turns (CUDA events, medians of 5 after 2
    warm-ups), their registers, local bytes, blocks an SM and SASS
    instructions, and whether the route's form is within 5% of the other;
    the finger inside its clamps; the route's time beside the programmatic
    UR5's;
26. ``urdf_mpc``: ``build_batch_tracking_mpc(...).solve`` and 3 rounds of
    ``batch_mpc_step`` on the calibrated Panda arm (``tip_link="panda_hand",
    chain_joints_only=True``, 7 joints, its own torque limits) at phase 8's
    shape; launch counts 4/4/4/1 a solve, finite outputs, |u| <= u_lim,
    costs below the zero-control rollout's; K2-K5 against their plain
    versions fed the solver's own controls (K2, K4, K5 bitwise, K3 within
    1e-5 of scale on the sweep's last 10 steps); the solve's time beside the programmatic Panda's.

Right after phase 2's build, before any long eager plain version (one left
``torch.profiler`` blind in PR 4), the runtime layer on the units built
there (``utils``, ``vision``, ``perception``):

27. ``features``: ``utils.get_available_features()`` ("cuda" must be
    true) and ``utils.test_installation()`` on the card, true with one K1
    launch;
28. ``profile_trace``: one Panda batched solve (B=1024, H=50, 4
    iterations) under ``utils.profile_trace``; its Chrome trace must hold
    K2-K5's device events by kernel name, 4/4/4/1, with their device ms;
    ``utils.benchmark_fn`` of the solve beside its CUDA-event median;
29. ``checkpoint_resume``: 3 rounds of ``batch_mpc_step`` at that shape (a
    disturbance from a CUDA generator each round), a
    ``utils.CheckpointManager`` save of the state, warm start, round,
    generator state and a bf16 copy of the warm start, a restore onto the
    card into a freshly built solver and 2 more rounds: x, the warm start,
    us, xs and cost bitwise 5 uninterrupted rounds, the bf16 leaf bitwise,
    launches 4/4/4/1 a solve;
30. ``aot_first_solve``: ``utils.aot.save_batch_mpc`` (that solver) and
    ``save_tracking_mpc`` (the Panda single-problem solver, H=50), loaded
    in a fresh process with no nvcc on PATH, no CUDA_HOME or CUDA_PATH, an
    empty build root and ``nvcc_path`` made to raise: its seconds to import
    torch, to load each and to its first solve; every unit's
    ``compile_seconds`` 0; its solves bitwise the in-process ones; an
    artifact whose meta names another card refused (the process runs
    beside phase 7's Panda cases, and its line is printed after them);
31. ``perception_plan``: a 640 x 480 depth frame of three boxes (the
    perception example's, at twice its size) seen by a camera looking at
    the UR5's workspace, through ``Perception(Vision(...))``: 3 detections
    with cv2, 1 on the NumPy fallback, within 1e-5 m of the f64 pinhole
    truth; ``pixel_to_camera`` + ``camera_to_world`` over 64 whole frames
    (19.7 M pixels) timed beside their bytes bound and traced, within 1e-6
    of scale of the f64 formula; the perceived positions as the obstacle
    cloud of the planning path at phase 16's shape (K9, link positions,
    K10, inverse dynamics, K1: one launch each), K10 timed on it; then K9,
    K10 and K1 (its first 50 steps) against their plain versions on those
    tensors.

After phase 26, the calibrated fleet (``benchmarks/fleet_benchmark.py``'s
robots: the first key of each vendored URDF, 25 root-to-tip chains of 1 to
8 joints, and the fully actuated 10-joint Jaco besides):

32. ``fleet``: the pool's wall seconds for the fleet's units, its workers
    and slowest unit; per model, at B=1024, H=50, 4 iterations, 6 alphas
    with the benchmark's draws (one ``default_rng(0)`` in the fleet's
    order: goals mid +- 0.3 half, q0 mid +- 0.2 half of the limits clipped
    to +-pi), ``build_batch_tracking_mpc(...).solve`` and 3 rounds of
    ``batch_mpc_step``: launches 4/4/4/1 a solve; per scenario finite
    outputs, |u| <= u_lim and a cost at most its zero-control cost (a
    round's: its warm start's rollout's), wherever that rollout is finite
    (the Jaco's overflows f32 in a few scenarios; their count is printed);
    the cost equal to it and every control +0.0 on the three robots whose
    URDFs give effort="0";
    K2, K4 and K5 bitwise against their plain versions on the solver's own
    controls (K4's and K5's is one ``replay_plain`` call on the first 10
    steps; K2 in both forms,
    each against its own plain version, then timed in turns with each
    form's figures; the form the public solve took, 4 launches a solve; K4
    and K5 likewise, the looped form's plain version once per joint count
    with the robots side by side, ``fleet_fwd_looped_plain``, the route's
    form 4 + 1 launches a solve, ``fleet_fwd_route`` naming the robots
    outside the 5% rule), K3 within 1e-5 of
    scale (its plain version once per joint count, the robots' inputs side
    by side, on the sweep's last 10 steps); the solve's and each launch's CUDA-event medians, registers,
    local bytes, K3's shared bytes, K2's seeds a thread; the mean cost
    beside the one ``benchmarks/fleet_results.json`` records; the
    multiplexed round (the 25 chains' solves back to back, one
    synchronisation) beside the sum of their solves; K1 on each chain at
    B=131072, N=50 as in phase 25 (``k1_forms``: the public route's one
    launch, both forms bitwise on their first 10 steps and timed in turns; phase 25's three robots
    are reused), and the robots whose route is outside the 5% rule (a
    line, not a gate: timings); K6-K8 on ``robotiq_2f_85`` and the Jaco's chain at
    H=50: launches 4/4/5 (K8's all the team's, ``forward_launches``),
    each stage bitwise on the solver's own controls
    (K7 on the sweep's last 10 steps, K8 on the first 10), the solve timed;
    ``fleet_k8``: K8 in both forms on K8_ROBOTS (the Robotiq, the ABB, the UR5, the iiwa14, the Gen3,
    the 8-joint Panda, the Jaco chain, the 10-joint Jaco; the programmatic
    Panda's are phase 12's) on the fleet's first scenario with the batched
    solve's nominal and K3's gains, each form bitwise its own plain version
    on the first 10 steps (the looped one's once per joint count with the
    robots side by side, ``fleet_k8_looped_plain``), both timed in turns,
    and a ``fleet_k8_route`` line: the solver's K8 is the team's on every
    robot, the robots where the looped form is more than 5% faster
    (outside the rule), and those where either form's turns spread by
    more than 5% (unresolved: no ratio is read there).

Then one JSON line of every kernel (K1's record also names the URDF robots
it was held on, and K1 on the looped step has a record of its own, its
launches the public route's on the robots it serves; K2's two forms have a
record each, its launches the public route's of that form (phase 8 and the
fleet), each form launched at least once, and so have K4's and K5's and
K8's (the team's launches phase 11's and the fleet's public solves', the
looped form's those of phase 12's solve built with ``_fwd_form="looped"``;
each form's figures on K8_ROBOTS inside); K2-K5's the Panda arm; every record its launches and
errors in phases 27-31; a record per fleet model and kernel), the card's
name and power limit, and the result line. Any failure raises, so the script exits nonzero before its
last line. It needs one card and imports no JAX. Run from the repository
root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import atexit
import concurrent.futures
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from manipulapy_tpu_torch import control, create_planner, ik, ik_cache, parallel, potential_field, singularity, trajectory
from manipulapy_tpu_torch import utils, vision
from manipulapy_tpu_torch.perception import Perception
from manipulapy_tpu_torch.utils import CheckpointManager, aot
from manipulapy_tpu_torch.vision import CameraConfig, Vision
from manipulapy_tpu_torch.kinematics import forward_kinematics
from manipulapy_tpu_torch.mpc.costs import make_tracking_costs
from manipulapy_tpu_torch.mpc.ilqr import ILQRParams, ilqr, make_step_fn, riccati_sweep
from manipulapy_tpu_torch.mpc.pscan import parallel_riccati
from manipulapy_tpu_torch.sim import Simulation
from manipulapy_tpu_torch.trac_ik import TracIKSolver
from manipulapy_tpu_torch.models import catalog, data, host_arrays, robot_data
from manipulapy_tpu_torch.urdf import URDF
from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
from manipulapy_tpu_torch.mpc.fused_batch import batch_mpc_step, build_batch_tracking_mpc
from manipulapy_tpu_torch.ops.cuda_mpc_batch import BLOCK as BLOCK_MPC, FWD_FORMS, LIN_BLOCK, LIN_FORMS, BatchMPCKernels
from manipulapy_tpu_torch.ops.cuda_mpc_batch import loop_fwd_rollout_plain
from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels, loop_forward_plain
from manipulapy_tpu_torch.ops.cuda_rollout import BLOCK, CHUNK, FORMS, CudaRollout, build_cuda_rollout
from manipulapy_tpu_torch.ops._build import build_library, library_key, nvcc_path
from manipulapy_tpu_torch.ops import elementwise as ew
from manipulapy_tpu_torch.ops.fd_step import DEFAULT_G, build_rollout, loop_rollout_plain

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
# The plain versions run on the host's clock, a launch a statement, so a
# check's cost is its steps, not its rows. Phases 6b, 25 and 32 hold K1,
# and phase 32 K4, K5 and K8, on the first FIRST_STEPS_CHECKED of their 50
# steps (a rollout is causal; the costs from a launch on those steps), and
# phases 19, 26 and 32 and the Levenberg-heavy and odd-horizon cases of
# phases 7 and 10 hold K3 or K7 on the Riccati sweep's last
# RICCATI_STEPS_CHECKED (a backward sweep: its last steps need no earlier
# one); every kernel runs at full shape. Phase 7's first full-width case
# and phase 10's first case hold K3 and K7 on the whole sweep.
FIRST_STEPS_CHECKED, RICCATI_STEPS_CHECKED = 10, 10
STEPS_CHECKED = 100  # of the plans' rollout: its plain version takes 70 ms of host time a step
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
LOOP_SOURCE = "manipulapy_tpu_torch/csrc/fd_step_loop.cuh"
# The route's rule (PERF.md §2): a robot's default form may be no more than
# this much slower than its other form in the same call.
ROUTE_SLACK = 1.05
# K8's forms are timed over this many back-to-back launches a turn, each
# form's time the median of its four turns (``k8_turns``).
K8_CALLS = 40
K1_NAMES = {"emitted": "K1 rollout (step program K0 inlined)",
            "looped": "K1 rollout, looped step (K0 as a loop over links, the robot in a table)"}
K1_SOURCES = {"emitted": ROLLOUT_SOURCE, "looped": LOOP_SOURCE}
MPC_SOURCE = "manipulapy_tpu_torch/csrc/mpc_batch.cuh"
MPC_KERNELS = {  # the main path's stage of each kernel: (id and name, the TPU kernel's pallas_call)
    "linearize": ("K2 linearize (forward mode over K0)", "manipulapy_tpu/mpc/fused_batch.py:249"),
    "backward": ("K3 Riccati backward", "manipulapy_tpu/mpc/fused_batch.py:372"),
    "linesearch": ("K4 line search, every alpha's cost and trajectory (K0 inlined)",
                   "manipulapy_tpu/mpc/fused_batch.py:453"),
    "replay": ("K5 replay (K0 inlined)", "manipulapy_tpu/mpc/fused_batch.py:507"),
}
# K2's two forms: the emitted step's forward mode and the looped one.
K2_NAMES = {"emitted": MPC_KERNELS["linearize"][0],
            "looped": "K2 linearize, looped forward mode (K0 as a loop over links, the robot in a table)"}
K2_SOURCES = {"emitted": "manipulapy_tpu_torch/csrc/mpc_batch.cuh",
              "looped": "manipulapy_tpu_torch/csrc/fd_step_loop_jvp.cuh"}
# K4's and K5's two forms: the emitted closed-loop step and the looped one
# (csrc/mpc_batch.cuh with MPT_FWD_LOOP, over csrc/fd_step_loop.cuh).
FWD_NAMES = {
    "linesearch": {"emitted": MPC_KERNELS["linesearch"][0],
                   "looped": "K4 line search, every alpha's cost and trajectory, looped step (K0 as a loop over "
                             "links, the robot in a table)"},
    "replay": {"emitted": MPC_KERNELS["replay"][0],
               "looped": "K5 replay, looped step (K0 as a loop over links, the robot in a table)"},
}
K45_STAGES = ("linesearch_costs", "linesearch", "replay")
MPC_STAGES = ("linearize", "backward", "linesearch_costs", "linesearch", "replay")
BITWISE_STAGES = ("linearize", "linesearch_costs", "linesearch", "replay")  # max |d| must be 0
K4_BLOCKS = (32, 64)  # K4's block-shape variants besides the unit's BLOCK
SINGLE_SOURCE = "manipulapy_tpu_torch/csrc/mpc_single.cuh"
SINGLE_KERNELS = {  # stage: (id and name, the TPU kernel's pallas_call, the CUDA kernel's name)
    "linearize": ("K6 single-problem linearize (forward mode over K0)", "manipulapy_tpu/mpc/fused.py:213", "mps_lin_kernel"),
    "backward": ("K7 single-problem Riccati backward (Gauss-Jordan)", "manipulapy_tpu/mpc/fused.py:303", "mps_bwd_block_kernel"),
    "forward": ("K8 single-problem line-search forward (K0 inlined)", "manipulapy_tpu/mpc/fused.py:375", "mps_fwd_kernel"),
}
# K8's two forms: the emitted step split over a team of warps, and the
# looped step with a warp an alpha (csrc/fwd_loop_lanes.cuh).
K8_NAMES = {"emitted": SINGLE_KERNELS["forward"][0],
            "looped": "K8 single-problem line-search forward, looped step (K0 as a loop over links, one warp an "
                      "alpha, its lanes over the joints)"}
K8_SOURCES = {"emitted": SINGLE_SOURCE, "looped": "manipulapy_tpu_torch/csrc/fwd_loop_lanes.cuh"}
K8_KERNELS = {"emitted": "mps_fwd_kernel", "looped": "mps_fwd_loop_kernel"}
# The robots K8's two forms are timed on (phase 32): fleet labels, and the
# programmatic Panda of phases 10-12.
K8_ROBOTS = ("robotiq_2f_85", "abb_irb2400", "ur5", "iiwa14", "gen3", "panda", "jaco_7dof",
                   "jaco_7dof (10 joints)", "panda (programmatic)")
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
# plant over a 200-waypoint quintic, the associative-scan Riccati pass at
# the single solve's horizon.
IK_B, IK_ITERS, IK_SUCCESS_BAR, IK_TRANS_BAR = 1000, 150, 0.9, 1e-5
# The strategy layers answer one target a call and are bound by the host's
# launches (~29 ms an iteration of 8 lanes on an H100 machine), so each of
# their 16 calls runs 30 iterations a family. The strategy layers' targets
# (once 64) and the plant's waypoints (once 500) were cut to make room for
# phase 32 in the smoke's time: both are host-bound, ~140 s and ~197 s of a
# 764 s smoke on an H100 machine.
IK_STRATEGY_TARGETS, IK_STRATEGY_ITERS = 16, 30
SIM_WAYPOINTS, SIM_SUBSTEPS, SIM_DAMPING, SIM_TRACK_BAR = 200, 4, 0.1, 0.05
# The damped run against the CPU's: float32 and float64 plants differ by
# 1.5e-6 rad over 500 waypoints on a CPU, and the damping moves the last
# position by 0.08 rad.
SIM_CPU_ATOL = 1e-4
PSCAN_REL_BAR = 1e-6
# The calibrated URDF robots a user gets from the catalogs (phases 24-26):
# K1 on the UR5, the Gen3 (no position limit on joints 1, 3, 5 and 7) and
# the 8-joint Panda (its finger prismatic); K2-K5 on the Panda arm.
URDF_ROLLOUT = ("ur5", "gen3", "panda")
PANDA_ARM = dict(tip_link="panda_hand", chain_joints_only=True)
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# The bounded pool of nvcc processes: the resident memory one nvcc of the
# largest units may take (K2's unit for the 10-joint Jaco).
NVCC_GIB = 2.0
# The calibrated fleet (phase 32): benchmarks/fleet_benchmark.py's robots,
# the first key of each vendored URDF, each as its root-to-tip chain, and the
# fully actuated Jaco (10 joints, its fingers off the chain) besides; K6-K8
# on the narrowest and the widest chain; the three robots whose URDFs give
# every joint effort="0", so their controls are clamped to 0.
FLEET_FULL = "jaco_7dof"
FLEET_SINGLE = ("robotiq_2f_85", "jaco_7dof")
FLEET_ZERO_U = ("abb_irb2400", "fanuc_lrmate", "fanuc_m16ib")
FLEET_ROUNDS = 3
FLEET_STAGES = ("linearize", "backward", "linesearch", "replay")  # the solve's K2-K5
FLEET_RESULTS = os.path.join(REPO_ROOT, "benchmarks", "fleet_results.json")


T_START = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One line of ``fields``, ending with the run's seconds so far."""
    fields["t_s"] = f"{time.perf_counter() - T_START:.1f}"
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


def nvcc_workers() -> int:
    """The size of the one pool every nvcc of the run goes through: a CPU
    each, less one for the phases that run while it builds, and no more
    than the available memory holds at NVCC_GIB each."""
    cpus = os.cpu_count() or 1
    try:
        with open("/proc/meminfo") as f:
            avail = next(int(line.split()[1]) for line in f if line.startswith("MemAvailable:")) / 2**20
    except (OSError, StopIteration):
        avail = float("inf")
    return max(1, min(cpus - 1, int(avail // NVCC_GIB)))


def unit_specs(obj) -> dict:
    """unit: (source, library name, nvcc flags besides NVCC_FLAGS) of a
    kernel object, or of a rollout unit's source."""
    if isinstance(obj, str):
        return {"rollout": (obj, "rollout", ())}
    if isinstance(obj, CudaRollout):
        return {"rollout": (obj.source, "rollout", ())}
    return {u: (obj.sources[u], f"{obj.LIB_PREFIX}_{u}", obj.UNIT_FLAGS.get(u, ())) for u in obj.UNITS}


class UnitPool:
    """Every translation unit of the run through one bounded pool of
    ``nvcc_workers()`` threads, each unit once (by its library key): a
    kernel object's ``build()`` then loads its libraries without nvcc."""

    def __init__(self):
        self.workers = nvcc_workers()
        self.pool = concurrent.futures.ThreadPoolExecutor(self.workers)
        self.futures, self.names = {}, {}

    def _build(self, source, name, flags):
        built = build_library(source, name, flags)
        return built, time.perf_counter()

    def submit(self, objects: dict) -> dict:
        """key -> {unit: future of (BuiltLibrary, the time it was done)}."""
        out = {}
        for key, obj in objects.items():
            out[key] = {}
            for unit, spec in unit_specs(obj).items():
                lib_key = library_key(spec[0], spec[1], spec[2])
                if lib_key not in self.futures:
                    self.futures[lib_key] = self.pool.submit(self._build, *spec)
                    self.names[lib_key] = f"{key} {unit}"
                out[key][unit] = self.futures[lib_key]
        return out

    @staticmethod
    def wait(futures: dict):
        """(key -> {unit: BuiltLibrary}, the time the last was done)."""
        done = {key: {u: f.result() for u, f in units.items()} for key, units in futures.items()}
        last = max(t for units in done.values() for _, t in units.values())
        return {key: {u: b for u, (b, _) in units.items()} for key, units in done.items()}, last

    @staticmethod
    def slowest(built: dict):
        """(key and unit, nvcc seconds) of the slowest unit built."""
        return max(((f"{key} {u}", b.compile_seconds) for key, units in built.items() for u, b in units.items()),
                   key=lambda kv: kv[1])


def build_all(pool: UnitPool, rollouts: dict, mpc_kernels: dict, planning: ew.ElementwiseKernels, meanwhile):
    """Phase 2's units through the pool, and ``meanwhile()`` while they
    build; returns ``built`` (per rollout its BuiltLibrary, per kernel set
    {unit: BuiltLibrary}), the wall seconds and what ``meanwhile``
    returned."""
    t0 = time.perf_counter()
    futures = pool.submit({**{("rollout", k): e for k, e in rollouts.items()},
                           **{("mpc", k): m for k, m in mpc_kernels.items()},
                           ("planning", "elementwise"): planning})
    later = meanwhile()
    done, last = UnitPool.wait(futures)
    for obj in (*rollouts.values(), *mpc_kernels.values(), planning):
        obj.build()  # from disk: the pool built every unit
    built = {key: (units["rollout"] if key[0] == "rollout" else units) for key, units in done.items()}
    return built, last - t0, later


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


def check_solution(label: str, us, xs, cost, u_lim) -> None:
    """A batched solve's answer at the main path's shape: finite, inside
    the torque limits."""
    n = u_lim.shape[0]
    if tuple(us.shape) != (B_MPC, H_MPC, n) or tuple(xs.shape) != (B_MPC, H_MPC + 1, 2 * n):
        raise AssertionError(f"{label}: shapes {tuple(us.shape)}, {tuple(xs.shape)}")
    for name, v in (("us", us), ("xs", xs), ("cost", cost)):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if not bool((us.abs() <= u_lim).all()):
        raise AssertionError(f"{label}: a control exceeds its torque limit")


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


def stage_vs_plain(K, stage: str, args, label: str, errs, plain_ms: dict, plain_calls: int, last: int = None):
    """Run one stage's kernel and, unless ``errs`` is None, its plain
    version on the same inputs: record the max |d| in ``errs`` and, for
    ``plain_calls`` of 1 or 2, the plain version's CUDA-event ms (the least
    of that many calls) in ``plain_ms``. With ``last`` (a Riccati sweep,
    its first three inputs by step) the plain version sweeps the last
    ``last`` steps alone and is held to those rows of the kernel's.
    Returns the kernel's outputs."""
    got = getattr(K, stage)(*args)
    got = got if isinstance(got, tuple) else (got,)
    if errs is None:
        return got
    plain = getattr(K.plain(), stage)
    if last is not None:
        args = tuple(x[-last:].contiguous() for x in args[:3]) + tuple(args[3:])
    ref, ms = timed(lambda: plain(*args))
    e = compare(stage, got if last is None else tuple(g[-last:] for g in got),
                ref if isinstance(ref, tuple) else (ref,), label)
    errs[stage] = max(errs.get(stage, 0.0), *e.values())
    if plain_calls:
        plain_ms[stage] = min([ms] + [timed(lambda: plain(*args))[1] for _ in range(plain_calls - 1)])
    return got


def mpc_stage_parity(K: BatchMPCKernels, x0, goals, us, label: str, time_plain: bool, check: bool = True,
                     reg: float = 1e-6, riccati_last: int = None):
    """Feed every stage, kernel and plain version alike, from a nominal
    trajectory (the torques ``us`` (H, n, B) from ``x0`` (B, 2n), rolled
    by K5 with zero gains) and K3's gains under the Levenberg term ``reg``.
    Returns per stage the max |d|, the stage's inputs (for timing the
    kernels) and, if asked, the plain version's CUDA-event ms at these
    shapes. ``check=False`` runs the kernels alone, for their inputs;
    ``riccati_last`` holds K3 on the sweep's last steps (``stage_vs_plain``)."""
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
        return stage_vs_plain(K, stage, args, label, errs, plain_ms, 1 if time_plain else 0,
                              riccati_last if stage == "backward" else None)

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
    per (scenario, seed or group of seeds, step); in the looped form its
    operations (``loop_ops``)."""
    if K.form == "looped":
        return K.loop_ops["total"] * B * H
    return K.statements["linearize_group"] * (K.m // K.LIN_SEEDS) * B * H


OTHER_FORM = {"emitted": "looped", "looped": "emitted"}


def lin_only(model, form: str) -> BatchMPCKernels:
    """K2 alone in ``form`` for ``model`` at the smoke's dt and g (its unit
    reads neither the cost weights nor the torque limits)."""
    cls = type("K2Form", (BatchMPCKernels,), {"UNITS": {"lin": ("linearize",)}})
    return cls(model, DT, u_lim=[1.0] * model.num_joints, _form=form)


def k2_figures(K: BatchMPCKernels) -> dict:
    """K2's kernel as built: its form, seeds a thread, block, registers,
    local bytes, blocks an SM, SASS instructions, nvcc seconds and, looped,
    its operations a (scenario, step) (``fd_step.loop_jvp_ops``)."""
    a, lib = K.kernel_attributes()["linearize"], K.build()["lin"]
    looped = K.form == "looped"
    return {"form": K.form, "seeds_per_thread": K.LIN_LOOP_SEEDS if looped else K.LIN_SEEDS,
            "block": LIN_BLOCK, "num_regs": a["num_regs"],
            "local_bytes": a["local_bytes"], "blocks_per_sm": K.lin_blocks_per_sm(),
            "sass_instructions": sass_count(str(lib.path)), "nvcc_seconds": lib.compile_seconds,
            "loop_ops": K.loop_ops if looped else None}


def k2_forms(label: str, Ks: dict, args, check: bool = True) -> dict:
    """K2 in both forms (``Ks``: form -> kernel set) on the same inputs: each
    form bitwise its own plain version (``plain().linearize``, NaN where it
    has NaN) unless ``check`` is False, then both timed in turns (emitted,
    looped, looped, emitted; CUDA-event medians of 5 after 2 warm-ups).
    Per form: ``k2_figures``, the times and their least, |d| and plain ms."""
    out = {}
    for form, K in Ks.items():
        out[form] = {**k2_figures(K), "ms_turns": []}
        if check:
            got = K.linearize(*args)
            ref, plain_ms = timed(lambda: K.plain().linearize(*args))
            err = bit_diff(got, ref)
            if err != 0.0:
                raise AssertionError(f"{label}: K2 {form} against its plain version: max |d| = {err}, not 0")
            out[form].update(max_abs_err=err, plain_ms=plain_ms)
    for form in ("emitted", "looped", "looped", "emitted"):
        out[form]["ms_turns"].append(time_ms(lambda: Ks[form].linearize(*args)))
    for form in LIN_FORMS:
        out[form]["ms"] = min(out[form]["ms_turns"])
    return out


def k2_fields(forms: dict) -> dict:
    """A phase line's fields of ``k2_forms``' result."""
    keys = ("seeds_per_thread", "num_regs", "local_bytes", "blocks_per_sm", "sass_instructions")
    out = {f"{f}_ms": ",".join(f"{t:.4f}" for t in forms[f]["ms_turns"]) for f in LIN_FORMS}
    out.update({f"{f}_{k}": forms[f][k] for f in LIN_FORMS for k in keys})
    out.update({f"{f}_max_abs_err": f"{forms[f]['max_abs_err']:.3e}" for f in LIN_FORMS if "max_abs_err" in forms[f]})
    out["looped_loop_ops"] = forms["looped"]["loop_ops"]["total"]
    return out


def k2_ur5_phase(ur5, forms: dict, fwd_forms: dict) -> dict:
    """Phase 7 on the programmatic UR5: K2 in both forms (``forms``, K2
    alone) bitwise its plain version at B=257 H=8 (random torques within
    30% of the limits) and at the main path's B=1024 H=50 on the UR5
    solver's own controls, there also both timed in turns; K4 (both stages)
    and K5 in both forms (``fwd_forms``) bitwise theirs on the same inputs,
    and at B=257 once more with a NaN scenario. Its own generator: the later
    phases' draws do not depend on it. Returns per B the |d| of each K2
    form, the timings (``k2_forms``) and per case the |d| of each K4/K5
    form."""
    gen = torch.Generator(DEV).manual_seed(7)
    mpc = build_batch_tracking_mpc(ur5, np.zeros(6), B_MPC, H_MPC, DT, iterations=ITERS)
    K = mpc.kernels
    u_lim = torch.tensor(K.P.u_lim, device=DEV)
    x0_s, goals_s = panda_problem(gen, ur5, B_PARITY)
    us_s = ((torch.rand((H_PARITY, 6, B_PARITY), generator=gen, device=DEV) * 2 - 1) * 0.3 * u_lim[:, None]).contiguous()
    x0_f, goals_f = panda_problem(gen, ur5, B_MPC)
    us_f = mpc.solve(x0_f, torch.zeros((B_MPC, H_MPC, 6), device=DEV), goals_f)[0].permute(1, 2, 0).contiguous()
    out, fwd_out = {}, {}
    for nominal, x0_c, goals_c, us_c in (("random torques", x0_s, goals_s, us_s),
                                         ("solver's controls", x0_f, goals_f, us_f)):
        B, H = us_c.shape[2], us_c.shape[0]
        all_args = mpc_stage_parity(K, x0_c, goals_c, us_c, f"ur5 B={B}", False, check=False)[1]
        args, ls, rep = all_args["linearize"], all_args["linesearch"], all_args["replay"]
        errs = {f: bit_diff(Kf.linearize(*args), Kf.plain().linearize(*args)) for f, Kf in forms.items()}
        if any(v != 0.0 for v in errs.values()):
            raise AssertionError(f"ur5 B={B} H={H}: K2 against its plain version {errs}, not 0")
        fwd_errs = {f: max(k45_errs(k45_outputs(Kf, ls, rep), Kf.plain().replay(*k45_plain_inputs(ls, rep))).values())
                    for f, Kf in fwd_forms.items()}
        if any(v != 0.0 for v in fwd_errs.values()):
            raise AssertionError(f"ur5 B={B} H={H}: K4/K5 against its plain version {fwd_errs}, not 0")
        phase("mpc_parity", robot="ur5", B=B, H=H, nominal=repr(nominal), k2_route_form=K.form,
              k45_route_form=K.fwd_form, **{f"max_abs_err_linearize_{f}": f"{v:.3e}" for f, v in errs.items()},
              **{f"max_abs_err_k45_{f}": f"{v:.3e}" for f, v in fwd_errs.items()})
        out[B], fwd_out[B] = errs, fwd_errs
        if B == B_PARITY:
            fwd_out["nan"] = k45_nan_check(f"ur5 B={B}", fwd_forms, ls, rep)
            phase("mpc_parity", robot="ur5", B=B, H=H, nominal=repr("random torques, scenario 5's dq NaN"),
                  **{f"max_abs_err_k45_{f}": f"{v:.3e}" for f, v in fwd_out["nan"].items()})
    timing = k2_forms("ur5", forms, args, check=False)
    route_ok = timing[K.form]["ms"] <= ROUTE_SLACK * timing[OTHER_FORM[K.form]]["ms"]
    phase("mpc_time_k2_forms", robot="ur5", B=B_MPC, H=H_MPC, route=K.form, route_within_slack=route_ok,
          **k2_fields(timing))
    fwd_timing = k45_forms("ur5", fwd_forms, ls, rep, check=False)
    fwd_ok = fwd_timing[K.fwd_form]["solve_share_ms"] <= ROUTE_SLACK * fwd_timing[OTHER_FORM[K.fwd_form]]["solve_share_ms"]
    phase("mpc_time_k45_forms", robot="ur5", B=B_MPC, H=H_MPC, route=K.fwd_form, route_within_slack=fwd_ok,
          fwd_statements=K.statements["replay"], **k45_fields(fwd_timing))
    fwd_out["timing"] = fwd_timing
    return out, timing, fwd_out


def fwd_only(K: BatchMPCKernels, model, form: str) -> BatchMPCKernels:
    """K4 and K5 alone in ``form`` for ``model`` with ``K``'s cost weights
    and torque limits, at the smoke's dt and g."""
    cls = type("K45Form", (BatchMPCKernels,), {"UNITS": {"fwd": BatchMPCKernels.UNITS["fwd"]}})
    P = K.P
    return cls(model, DT, w_q=P.w_q, w_dq=P.w_dq, w_u=P.w_u, w_terminal=P.wT[0], u_lim=P.u_lim, _fwd_form=form)


_SASS_KERNELS: dict = {}


def sass_by_kernel(path: str) -> dict:
    """The SASS instructions of each K4/K5 kernel in the fwd library at
    ``path`` (``cuobjdump -sass``, its ``Function :`` sections), per stage;
    {} without cuobjdump."""
    if path not in _SASS_KERNELS:
        tool = os.path.join(os.path.dirname(os.path.realpath(nvcc_path())), "cuobjdump")
        if not os.path.exists(tool):
            return {}
        sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True, timeout=120).stdout
        counts, name = {}, None
        for ln in sass.splitlines():
            m = re.match(r"\s+Function : (\S+)", ln)
            if m:
                f = m.group(1)
                name = ("linesearch_costs" if "mpt_cost_kernelILb0" in f else "linesearch" if "mpt_cost_kernelILb1" in f
                        else "replay" if "mpt_replay_kernel" in f else f)
            elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln):
                counts[name] = counts.get(name, 0) + 1
        _SASS_KERNELS[path] = counts
    return _SASS_KERNELS[path]


def fwd_figures(K: BatchMPCKernels) -> dict:
    """K4's and K5's kernels as built: the form, per stage registers, local
    bytes, blocks an SM and SASS instructions, the unit's nvcc seconds and,
    looped, its step's operations (``fd_step.loop_fwd_ops``)."""
    attrs, lib, blocks = K.kernel_attributes(), K.build()["fwd"], K.fwd_blocks_per_sm()
    sass = sass_by_kernel(str(lib.path))
    return {"form": K.fwd_form, "nvcc_seconds": lib.compile_seconds, "loop_ops": K.fwd_loop_ops,
            **{s: {"num_regs": attrs[s]["num_regs"], "local_bytes": attrs[s]["local_bytes"],
                   "blocks_per_sm": blocks[s], "sass_instructions": sass.get(s)} for s in K45_STAGES}}


def k45_plain_inputs(ls, rep, k: int = None):
    """The inputs of the one plain call that holds K4 (both stages) and K5:
    ``ls``'s x0, sd_x, sd_u, kK (the first ``k`` steps where given) and
    goal, and alphas (A + 1, B), K4's A alphas then each scenario's own
    (``rep``'s)."""
    A, B = ls[5].shape[0], ls[0].shape[1]
    both = torch.cat([ls[5][:, None].expand(A, B), rep[5][None]]).contiguous()
    cut = (lambda x: x[:k].contiguous()) if k else (lambda x: x)
    return (ls[0], *(cut(x) for x in ls[1:4]), ls[4], both)


def k45_outputs(K: BatchMPCKernels, ls, rep, k: int = None) -> dict:
    """K's K4 (both stages) and K5 on ``ls`` and ``rep``: the trajectories
    of launches at full horizon (their first ``k`` steps where given), the
    costs of launches on those steps alone."""
    first = (lambda a: (a[0], *(x[:k].contiguous() for x in a[1:4]), *a[4:])) if k else (lambda a: a)
    _, xs_all, us_all = K.linesearch(*ls)
    xs, us, _ = K.replay(*rep)
    cut = (lambda x: x[:k].contiguous()) if k else (lambda x: x)
    return {"costs": K.linesearch(*first(ls))[0], "costs_only": K.linesearch_costs(*first(ls)),
            "xs_all": cut(xs_all), "us_all": cut(us_all), "xs": cut(xs), "us": cut(us),
            "cost": K.replay(*first(rep))[2]}


def k45_errs(got: dict, ref) -> dict:
    """Per stage the largest ``bit_diff`` of ``k45_outputs`` against the one
    plain call's (xs (k, nx, A + 1, B), us, cost (A + 1, B))."""
    xs_p, us_p, cost_p = ref
    A = cost_p.shape[0] - 1
    col = lambda x, a: x[:, :, a].contiguous()
    return {"linesearch": max(bit_diff(got["costs"], cost_p[:A].contiguous()),
                              bit_diff(got["xs_all"], xs_p[:, :, :A].contiguous()),
                              bit_diff(got["us_all"], us_p[:, :, :A].contiguous())),
            "linesearch_costs": bit_diff(got["costs_only"], cost_p[:A].contiguous()),
            "replay": max(bit_diff(got["xs"], col(xs_p, A)), bit_diff(got["us"], col(us_p, A)),
                          bit_diff(got["cost"], cost_p[A].contiguous()))}


def k45_forms(label: str, Ks: dict, ls, rep, k: int = None, check: bool = True, pending: list = None) -> dict:
    """K4 and K5 in both forms (``Ks``: form -> kernel set) on the same
    inputs: unless ``check`` is False, each form's K4 (both stages) and K5
    bitwise (NaN where it has NaN) its own plain version, one call over the
    A + 1 alphas (``k45_plain_inputs``; the first ``k`` steps where given;
    with ``pending`` the looped form's goes there for
    ``fwd_looped_plain_grouped``); then both timed in turns (emitted,
    looped, looped, emitted; ``per_call_ms``, a launch's device time over 20
    back-to-back launches: a one-joint arm's launch takes ~0.1 ms, within
    the spread of single-launch timings), K4 with its trajectories and K5.
    Per form: ``fwd_figures``, the times and their least, |d| and plain
    ms."""
    out = {}
    for form, K in Ks.items():
        out[form] = {**fwd_figures(K), "ms_turns": {"linesearch": [], "replay": []}}
        if not check:
            continue
        got = k45_outputs(K, ls, rep, k)
        if form == "looped" and pending is not None:
            pending.append((label, K, k45_plain_inputs(ls, rep, k), got, out[form]))
            continue
        ref, plain_ms = timed(lambda: K.plain().replay(*k45_plain_inputs(ls, rep, k)))
        errs = k45_errs(got, ref)
        if any(v != 0.0 for v in errs.values()):
            raise AssertionError(f"{label}: K4/K5 {form} against its plain version {errs}, not 0")
        out[form].update(max_abs_err=errs, plain_ms=plain_ms)
    for form in ("emitted", "looped", "looped", "emitted"):
        for stage, args in (("linesearch", ls), ("replay", rep)):
            out[form]["ms_turns"][stage].append(per_call_ms(lambda: getattr(Ks[form], stage)(*args)))
    for form in FWD_FORMS:
        out[form]["ms"] = {s: min(t) for s, t in out[form]["ms_turns"].items()}
        out[form]["solve_share_ms"] = ITERS * out[form]["ms"]["linesearch"] + out[form]["ms"]["replay"]
    return out


def fwd_looped_plain_grouped(pending: list) -> None:
    """The looped K4's and K5's checks of ``k45_forms`` (``pending``) against
    one plain call per joint count: the robots' inputs side by side along
    the scenario axis, each column with its robot's table and weights
    (``loop_fwd_rollout_plain`` over a (T, B) table), so the host's
    launches are paid once a joint count. Each robot bitwise; its figures
    get the |d| and the group's plain ms."""
    groups = {}
    for item in pending:
        groups.setdefault(item[1].n, []).append(item)
    for n, items in sorted(groups.items()):
        cols = [x[0].shape[1] for _, _, x, _, _ in items]
        tab = torch.cat([K.fwd_table[:, None].expand(-1, c) for (_, K, _, _, _), c in zip(items, cols)], dim=1).to(DEV)
        ins = [torch.cat([x[i] for _, _, x, _, _ in items], dim=-1).contiguous() for i in range(6)]
        ref, plain_ms = timed(lambda: loop_fwd_rollout_plain(tab, n, *ins))
        at = 0
        for (label, _, _, got, fig), c in zip(items, cols):
            part = tuple(r[..., at:at + c] for r in ref)
            errs = k45_errs(got, part)
            if any(v != 0.0 for v in errs.values()):
                raise AssertionError(f"{label}: K4/K5 looped against its plain version {errs}, not 0")
            fig.update(max_abs_err=errs, plain_ms=plain_ms,
                       plain_scope=f"one loop_fwd_rollout_plain call for the {len(items)} robots of {n} joints")
            at += c
        phase("fleet_fwd_looped_plain", joints=n, robots=",".join(i[0] for i in items), scenarios=sum(cols),
              steps=ins[1].shape[0], plain_ms=f"{plain_ms:.1f}",
              max_abs_err=f"{max(max(i[4]['max_abs_err'].values()) for i in items):.3e}")


def k45_fields(forms: dict) -> dict:
    """A phase line's fields of ``k45_forms``' result."""
    out = {}
    for f in FWD_FORMS:
        for s in ("linesearch", "replay"):
            out[f"{f}_{s}_ms"] = ",".join(f"{t:.4f}" for t in forms[f]["ms_turns"][s])
        out[f"{f}_solve_share_ms"] = f"{forms[f]['solve_share_ms']:.4f}"
        for s in K45_STAGES:
            out.update({f"{f}_{s}_{k}": forms[f][s][k] for k in ("num_regs", "local_bytes", "blocks_per_sm",
                                                                  "sass_instructions")})
        if "max_abs_err" in forms[f]:
            out[f"{f}_max_abs_err"] = f"{max(forms[f]['max_abs_err'].values()):.3e}"
    out["looped_loop_ops"] = forms["looped"]["loop_ops"]
    return out


def k45_nan_check(label: str, Ks: dict, ls, rep) -> dict:
    """Both forms' K4 and K5 with scenario 5's initial velocity NaN: NaN in
    the same places as the plain version, bitwise elsewhere, the other
    scenarios finite where the clean run was. Returns |d| per form."""
    x0 = ls[0].clone()
    x0[x0.shape[0] // 2, 5] = float("nan")
    ls_n, rep_n = (x0, *ls[1:]), (x0, *rep[1:])
    out = {}
    for form, K in Ks.items():
        got = k45_outputs(K, ls_n, rep_n)
        ref = K.plain().replay(*k45_plain_inputs(ls_n, rep_n))
        errs = k45_errs(got, ref)
        if any(v != 0.0 for v in errs.values()) or not bool(torch.isnan(got["cost"][5])):
            raise AssertionError(f"{label}: K4/K5 {form} with a NaN scenario against its plain version {errs}")
        out[form] = max(errs.values())
    return out


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


def single_stage_parity(S: SingleMPCKernels, x0, goal, us, label: str, plain_calls: int, reg: float = 1e-6,
                        riccati_last: int = None, first: int = None):
    """K6-K8 against their plain versions, fed from the open loop of ``us``
    (H, n) from ``x0`` (K8 with one alpha of 0 and zero gains) and K7's
    gains under the Levenberg term ``reg``. Returns per stage the max |d|,
    the stage's inputs and the plain versions' ms (for ``plain_calls`` >
    0). ``riccati_last`` holds K7 on the sweep's last steps
    (``stage_vs_plain``), ``first`` K8 on the replay's first steps (its
    trajectories at full horizon, its costs from a launch on those steps)."""
    n, nx, H = S.n, S.nx, us.shape[0]
    f32 = dict(dtype=torch.float32, device=DEV)
    errs, plain_ms = {}, {}
    both = lambda stage, args: stage_vs_plain(S, stage, args, label, errs, plain_ms, plain_calls,
                                              riccati_last if stage == "backward" else None)

    def forward(args):
        if first is None:
            return both("forward", args)
        got = S.forward(*args)
        cut = (args[0], *(x[:first].contiguous() for x in args[1:4]), *args[4:])  # sd_x, sd_u, kK by step
        ref, ms = timed(lambda: S.plain().forward(*cut))
        e = compare("forward", (got[0][:, :first], got[1][:, :first], S.forward(*cut)[2]), ref, label)
        errs["forward"] = max(errs.get("forward", 0.0), *e.values())
        if plain_calls:
            plain_ms["forward"] = ms
        return got

    init = (x0, torch.zeros((H, nx), **f32), us, torch.zeros((H, n, 1 + nx), **f32), goal, torch.zeros((1,), **f32))
    xs0 = forward(init)[0][0]
    sd_x = torch.cat([x0[None], xs0[:-1]]).contiguous()
    AB = both("linearize", (sd_x, us))[0]
    bwd_args = (AB, sd_x, us, goal, terminal_value(S, xs0[-1], goal), torch.tensor(reg, **f32))
    kK = both("backward", bwd_args)[0]
    fwd_args = (x0, sd_x, us, kK, goal, 0.5 ** torch.arange(ALPHAS, **f32))
    forward(fwd_args)
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


def k8_only(S: SingleMPCKernels, model, form: str, **attrs) -> SingleMPCKernels:
    """K8 alone in ``form`` for ``model`` with ``S``'s cost weights and
    torque limits, at the smoke's dt and g (``S``'s form shares its unit
    with ``S``); ``attrs`` override class attributes (``FWD_LOOP_WARPS``)."""
    cls = type("K8Form", (SingleMPCKernels,), {"UNITS": {"fwd": SingleMPCKernels.UNITS["fwd"]}, **attrs})
    P = S.P
    return cls(model, DT, w_q=P.w_q, w_dq=P.w_dq, w_u=P.w_u, w_terminal=P.wT[0], u_lim=P.u_lim, _fwd_form=form)


def k8_figures(K: SingleMPCKernels) -> dict:
    """K8 as built in its form: registers, local bytes, static shared bytes
    a block, SASS instructions (``cuobjdump``), the unit's nvcc seconds;
    the team's design (emitted) or the looped layout and its step's
    operations (looped)."""
    a, lib = K.kernel_attributes()["forward"], K.build()["fwd"]
    fig = {"form": K.fwd_form, "num_regs": a["num_regs"], "local_bytes": a["local_bytes"],
           "smem_bytes": a["smem_bytes"], "sass_instructions": sass_count(str(lib.path)),
           "nvcc_seconds": lib.compile_seconds}
    if K.fwd_form == "looped":
        fig.update(layout=K.loop_layout(), loop_ops=K.fwd_loop_ops)
    else:
        fig.update(team=team_figures(K))
    return fig


def k8_check(K: SingleMPCKernels, args, first: int = None):
    """``K``'s K8 on ``args`` against its own form's plain version: the
    trajectories of a launch at full horizon (their first ``first`` steps
    where given) and the costs of a launch on those steps; ``bit_diff``
    (NaN where it has NaN). Returns (max |d|, the plain version's ms)."""
    got = K.forward(*args)
    if first is not None:
        args = (args[0], *(x[:first].contiguous() for x in args[1:4]), *args[4:])
        got = (got[0][:, :first], got[1][:, :first], K.forward(*args)[2])
    ref, ms = timed(lambda: K.plain().forward(*args))
    return max(bit_diff(g, r) for g, r in zip(got, ref)), ms


def k8_nan_check(label: str, K: SingleMPCKernels, args) -> float:
    """``args``' alpha 2 made NaN: K8 NaN where its plain version is, bit for
    bit elsewhere, alpha 2's loop NaN and every other alpha's the clean
    run's bits. Returns the max |d|."""
    clean = K.forward(*args)
    alphas = args[5].clone()
    alphas[2] = float("nan")
    nan_args = (*args[:5], alphas)
    err, _ = k8_check(K, nan_args)
    got = K.forward(*nan_args)
    keep = [a for a in range(alphas.shape[0]) if a != 2]
    if err != 0.0 or not bool(torch.isnan(got[2][2])) or not all(
            torch.equal(g[keep].view(torch.int32), c[keep].view(torch.int32)) for g, c in zip(got, clean)):
        raise AssertionError(f"{label}: K8 {K.fwd_form} with a NaN alpha: |d| {err}, or the NaN left its warp")
    return err


def k8_turns(Ks: dict, args) -> dict:
    """The K8 sets ``Ks`` (name -> kernel set) on ``args`` timed in turns:
    in order, then in reverse, twice (four turns each), each a launch's
    device time over K8_CALLS back-to-back launches (``per_call_ms``). Per
    set: the turns, their median (``ms``) and their spread, (max - min) /
    median. A comparison whose sets spread by more than ROUTE_SLACK - 1 is
    unresolved (``k8_resolved``)."""
    order = list(Ks) + list(reversed(list(Ks)))
    turns = {name: [] for name in Ks}
    for name in order * 2:
        turns[name].append(per_call_ms(lambda: Ks[name].forward(*args), K8_CALLS))
    out = {}
    for name, t in turns.items():
        mid = statistics.median(t)
        out[name] = {"ms_turns": t, "ms": mid, "spread": (max(t) - min(t)) / mid}
    return out


def k8_resolved(forms: dict) -> bool:
    """Whether both K8 forms' turns spread by at most ROUTE_SLACK - 1, so
    that their ratio is read."""
    return all(forms[f]["spread"] <= ROUTE_SLACK - 1 for f in FWD_FORMS)


def single_path(panda, single, attrs: dict, card: str, built: dict, k8_sets: dict) -> tuple:
    """Phases 10-12, the single-problem solver; returns its kernels'
    records."""
    S = single.kernels
    H, f32 = H_MPC, dict(dtype=torch.float32, device=DEV)
    u_lim = torch.tensor(S.P.u_lim, **f32)
    goal_a, goal_b = torch.tensor(Q_GOAL7, **f32), torch.tensor(Q_GOAL7_B, **f32)
    x0 = mid_rest(panda)

    # 10. K6-K8 vs their plain versions: at H=50 on the solver's own
    # controls (plain versions timed there, once), at the odd horizon on
    # random torques, and at H=50 with a Levenberg-heavy reg (K7 on the
    # whole sweep in the first case, on its last steps in the others).
    us_nom = single.solve(x0, torch.zeros((H, 7), **f32))[0].contiguous()
    x0_r, goal_r, us_r = random_single_problem(panda, H_ODD, ODD_SEED)
    err = dict.fromkeys(SINGLE_KERNELS, 0.0)
    # K8 in its looped form (the solver runs the team's), on the same inputs:
    # at A = 1 (the initial rollout) and A = 6, on the whole horizon in the
    # first two cases and on the first steps in the third.
    route, other = S.fwd_form, OTHER_FORM[S.fwd_form]
    k8_err = dict.fromkeys(FWD_FORMS, 0.0)
    k8_plain_ms = {}
    for nominal, x0_c, goal_c, us_c, calls, reg in (
        ("solver's controls", x0, goal_a, us_nom, 1, 1e-6), ("random torques", x0_r, goal_r, us_r, 0, 1e-6),
        ("solver's controls", x0, goal_a, us_nom, 0, REG_HEAVY),
    ):
        label = f"panda single H={us_c.shape[0]} reg={reg}"
        errs, args, ms = single_stage_parity(S, x0_c, goal_c, us_c, label, calls, reg,
                                             None if calls else RICCATI_STEPS_CHECKED)
        for stage in SINGLE_KERNELS:  # each does the plain version's operations in its order
            if errs[stage] != 0.0:
                raise AssertionError(f"{label} {stage}: max |d| = {errs[stage]}, not 0")
        err = {k: max(err[k], errs[k]) for k in err}
        k8_err[route] = max(k8_err[route], errs["forward"])
        Hc = us_c.shape[0]
        init = (x0_c, torch.zeros((Hc, S.nx), **f32), us_c, torch.zeros((Hc, S.n, 1 + S.nx), **f32), goal_c,
                torch.zeros((1,), **f32))
        other_errs = {}
        for A_, a_args in ((1, init), (ALPHAS, args["forward"])):
            e_, ms_ = k8_check(k8_sets[other], a_args, None if calls or reg == 1e-6 else FIRST_STEPS_CHECKED)
            if e_ != 0.0:
                raise AssertionError(f"{label}: K8 {other} at A={A_}: max |d| = {e_}, not 0")
            other_errs[A_] = e_
            if calls and A_ == ALPHAS:
                k8_plain_ms[other] = ms_
        k8_err[other] = max(k8_err[other], *other_errs.values())
        if calls:
            stage_args, plain_ms = args, ms
            k8_plain_ms[route] = ms["forward"]
            nan_err = {f: k8_nan_check(f"{label} NaN alpha", K8, args["forward"]) for f, K8 in k8_sets.items()}
        phase("single_parity", robot="panda", H=us_c.shape[0], reg=reg, nominal=repr(nominal), k8_route=route,
              **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
              **{f"max_abs_err_forward_{other}_A{A_}": f"{v:.3e}" for A_, v in other_errs.items()},
              **({f"max_abs_err_forward_{f}_nan_alpha": f"{v:.3e}" for f, v in nan_err.items()} if calls else {}))

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
    if SingleMPCKernels.forward_launches != {route: ITERS + 1, other: 0}:
        raise AssertionError(f"K8 launches by form {SingleMPCKernels.forward_launches}, expected {ITERS + 1} {route}")
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
    k8_launches = dict(SingleMPCKernels.forward_launches)
    if launches != {k: (ROUNDS + 1) * v for k, v in per_solve.items()} or k8_launches[route] != launches["forward"]:
        raise AssertionError(f"launches over {ROUNDS + 1} solves {launches}, K8's by form {k8_launches}")
    if not (dists[RETARGET - 1] < d_start and dists[-1] < d_retarget):
        raise AssertionError(f"distance to the goal did not shrink: {d_start} -> {dists[RETARGET - 1]}, "
                             f"then {d_retarget} -> {dists[-1]}")
    phase("single_main_path", robot="panda", H=H, iterations=ITERS, alphas=ALPHAS, solve_wall_s=f"{solve_wall:.4f}",
          launches_per_solve=json.dumps(per_solve).replace(" ", ""), launches_run=json.dumps(launches).replace(" ", ""),
          k8_launches_by_form=json.dumps(k8_launches).replace(" ", ""),
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
          round_ms=f"{round_ms:.4f}", k8_route=route, **{f"{s}_plain_ms": f"{v:.2f}" for s, v in plain_ms.items()})
    # Both K8 forms in turns at A = 6 and A = 1, and a solve at 4 and 2
    # iterations on each form (the route's are the solves above).
    fwd6 = stage_args["forward"]
    fwd1 = (*fwd6[:5], fwd6[5][:1].contiguous())
    k8_by_A = {ALPHAS: k8_turns(k8_sets, fwd6), 1: k8_turns(k8_sets, fwd1)}
    k8_fig = {f: k8_figures(K8) for f, K8 in k8_sets.items()}
    solves = {route: {ITERS: solve_ms, 2: solve2_ms}}
    for iters in (ITERS, 2):
        h = build_tracking_mpc(panda, Q_GOAL7, H, DT, iterations=iters, line_search_steps=ALPHAS, _fwd_form=other)
        if iters == ITERS:  # the looped K8's own path: one solve, its counts read just after
            SingleMPCKernels.reset_launch_count()
            us_o, xs_o, cost_o = h.solve(x0, zeros_us)
            torch.cuda.synchronize()
            k8_launches[other] = SingleMPCKernels.forward_launches[other]
            if dict(SingleMPCKernels.forward_launches) != {other: ITERS + 1, route: 0}:
                raise AssertionError(f"the {other}-K8 solve's launches by form {SingleMPCKernels.forward_launches}")
            check(f"{other}-K8 solve", us_o, xs_o, cost_o)
        solves.setdefault(other, {})[iters] = time_ms(lambda: h.solve(x0, zeros_us))
    phase("single_time_k8_forms", card=repr(card), robot="panda", H=H, route=route,
          fwd_statements=S.statements["forward"],
          **{f"{f}_ms_A{A_}": ",".join(f"{t:.4f}" for t in r[f]["ms_turns"]) for A_, r in k8_by_A.items() for f in FWD_FORMS},
          **{f"{f}_median_ms_A{A_}": f"{r[f]['ms']:.4f}" for A_, r in k8_by_A.items() for f in FWD_FORMS},
          **{f"{f}_spread_A{A_}": f"{r[f]['spread']:.4f}" for A_, r in k8_by_A.items() for f in FWD_FORMS},
          **{f"resolved_A{A_}": k8_resolved(r) for A_, r in k8_by_A.items()},
          **{f"solve_ms_{f}_{it}it": f"{v:.4f}" for f, d in solves.items() for it, v in d.items()},
          **{f"{f}_{k}": v for f, fig in k8_fig.items() for k, v in fig.items() if not isinstance(v, (dict, str))},
          looped_layout=json.dumps(k8_fig["looped"]["layout"]).replace(" ", ""),
          emitted_team=json.dumps({k: k8_fig["emitted"]["team"][k] for k in ("warps", "phases", "slots")}).replace(" ", ""))
    trace = device_profile(lambda: single.solve(x0, zeros_us))
    if trace:
        names = {**{s: name[2] for s, name in SINGLE_KERNELS.items()}, "forward": K8_KERNELS[route]}
        ours = {s: sum(v for k, v in trace["by_name"].items() if k.startswith(name)) for s, name in names.items()}
        phase("single_trace", robot="panda", H=H, iterations=ITERS, k8_route=route,
              **{f"{k}_device_ms_per_solve": f"{v:.4f}" for k, v in ours.items()},
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
    records, k8_records = [], {}
    for stage, (name, replaces, _) in SINGLE_KERNELS.items():
        b_ms, b_by = bound(*bo[stage])
        if stage == "forward":  # a record a form: the team's launches the public solves' (phase 11, then
            # phase 32's), the looped form's its own solve's above
            for form in (route, other):
                fig = k8_fig[form]
                k8_records[form] = {
                    "name": K8_NAMES[form], "route": "cuda", "source": K8_SOURCES[form], "replaces": replaces,
                    "launches": k8_launches[form], "max_abs_err": k8_err[form], "tolerance": "0",
                    "ms": k8_by_A[ALPHAS][form]["ms"], "plain_ms": k8_plain_ms[form], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "robot": "panda", "fwd_form": form, "k8_route": route,
                    "ms_turns": k8_by_A[ALPHAS][form]["ms_turns"], "spread": k8_by_A[ALPHAS][form]["spread"],
                    "ms_A1": k8_by_A[1][form]["ms"],
                    "ms_turns_A1": k8_by_A[1][form]["ms_turns"],
                    "solve_ms_by_iterations": solves[form], **{k: v for k, v in fig.items() if k != "form"},
                    "max_abs_err_nan_alpha": nan_err[form],
                }
                if form == "looped":
                    k8_records[form].update(
                        step_replaces="manipulapy_tpu/ops/fd_step.py:274", step_source=LOOP_SOURCE,
                        loop_ops_bound_ms=bound(0, fig["loop_ops"] * H * ALPHAS)[0], public_route=False,
                        launches_from=f"one solve built with _fwd_form={other!r} (phase 12)")
                else:
                    k8_records[form].update(chain_bound_ms=chain[stage], chain_bound="estimate: longest chain of "
                                            f"emitted statements x {CHAIN_CYCLES} cycles at clocks.max.sm")
                records.append(k8_records[form])
            continue
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
        if stage == "linearize":
            records[-1].update(lin_figures(S, built))
    return records, k8_records

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
    phase 7 (K3 on the sweep's last RICCATI_STEPS_CHECKED steps). Returns the round's launches and the UR5 stages' max |d|."""
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
    ur5_errs = mpc_stage_parity(K_ur5, x0_ur5, goals[1, :, :6], us_ur5, f"fleet ur5 B={S} H={H}", False,
                                riccati_last=RICCATI_STEPS_CHECKED)[0]
    for stage in BITWISE_STAGES:
        if ur5_errs[stage] != 0.0:
            raise AssertionError(f"fleet ur5 B={S} H={H} {stage}: max |d| = {ur5_errs[stage]}, not 0")
    phase("mpc_parity", robot="ur5 (fleet)", B=S, H=H, reg=1e-6, nominal=repr("the fleet round's controls"),
          k2_form=K_ur5.form, **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in ur5_errs.items()})
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
    ``torch.profiler`` traces, 10 and 5 iterations, over 5."""
    counts = {}
    for iters in (5, 10):
        trace = device_profile(lambda: ik.solve_ik_batch(model, T, guesses, max_iterations=iters), reps=1)
        counts[iters] = trace.get("launches", float("nan"))
    return (counts[10] - counts[5]) / 5


def ik_phase(ur5, card: str) -> None:
    """Phase 21: UR5 ``solve_ik_batch`` at B = 1000 in float64 (success
    rate at least 0.9, every success within 1e-5 m when its FK is taken
    again) and float32 (success rate reported); ms a solve and launches an
    iteration; then ``TracIKSolver.solve`` and ``smart_ik`` on 16 targets."""
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
        ms = time_ms(solve, warmup=0, reps=1)  # host-bound, ~5 s a solve
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
    200-waypoint quintic by computed torque, with viscous joint damping 0.1
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
    seq_ms, par_ms, par_ms_2, seq_ms_2 = (time_ms(lambda f=f: f(1e-6), warmup=1, reps=3) for f in (seq, par, par, seq))
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


# ---------------------------------------------------------------------------
# The calibrated URDF robots (phases 24-26)
# ---------------------------------------------------------------------------


def looped_bench_phase(ur5, panda, engines: dict, card: str) -> dict:
    """Phase 6b: the looped K1 (csrc/fd_step_loop.cuh) at the main path's
    shape, B=131072, N=50, on the programmatic UR5 and Panda: its first
    ROWS_CHECKED rows and FIRST_STEPS_CHECKED steps bitwise
    ``LoopRollout``'s on the card, and both
    forms timed in turns (emitted, looped, looped, emitted). Its inputs come
    from its own generator: the later phases' draws do not depend on it."""
    gen = torch.Generator(DEV).manual_seed(6)
    out = {}
    for name, model in (("ur5", ur5), ("panda", panda)):
        t0 = time.perf_counter()
        forms = {"emitted": engines[name], "looped": engines[f"{name} looped"]}
        n, rows = model.num_joints, ROWS_CHECKED
        q0, dq0, tau = inputs(gen, B_FULL, N_FULL, n)
        got, steps = forms["looped"](q0, dq0, tau), FIRST_STEPS_CHECKED
        ref, plain_ms = timed(lambda: forms["looped"].plain(q0[:rows], dq0[:rows], tau[:rows, :steps].contiguous()))
        errs = {k: bit_diff(g[:rows, :steps], r) for k, g, r in zip(TOL, got, ref)}
        if any(v != 0.0 for v in errs.values()) or not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"looped K1 {name}: against LoopRollout {errs}, not 0, or non-finite outputs")
        turns = {f: [] for f in FORMS}
        for form in ("emitted", "looped", "looped", "emitted"):
            turns[form].append(time_ms(lambda: forms[form](q0, dq0, tau)))
        a = forms["looped"].kernel_attributes()
        b_ms, b_by = bound((2 * B_FULL * n + 4 * B_FULL * N_FULL * n) * 4, forms["looped"].statements * B_FULL * N_FULL)
        out[name] = {"joints": n, "max_abs_err": max(errs.values()), "ms": min(turns["looped"]),
                     "emitted_ms": min(turns["emitted"]), "plain_ms": plain_ms,
                     "plain_scope": f"the first {rows} rows, {steps} steps", "bound_ms": b_ms, "bound_by": b_by,
                     "statements": forms["looped"].statements, "loop_ops": forms["looped"].loop_ops,
                     "num_regs": a["num_regs"], "local_bytes": a["local_bytes"], "blocks_per_sm": a["blocks_per_sm"],
                     "sass_instructions": sass_instructions(forms["looped"]),
                     "emitted_sass_instructions": sass_instructions(forms["emitted"])}
        phase("looped_time", card=repr(card), robot=name, B=B_FULL, N=N_FULL,
              **{f"max_abs_err_{k}_first{rows}": f"{v:.3e}" for k, v in errs.items()}, steps_checked=steps,
              **{f"{f}_ms": ",".join(f"{t:.4f}" for t in turns[f]) for f in FORMS}, plain_ms=f"{plain_ms:.1f}",
              bound_ms=f"{b_ms:.4f}", statements=out[name]["statements"], loop_ops=out[name]["loop_ops"],
              num_regs=a["num_regs"], local_bytes=a["local_bytes"], blocks_per_sm=a["blocks_per_sm"],
              sass_instructions=out[name]["sass_instructions"],
              emitted_sass_instructions=out[name]["emitted_sass_instructions"], phase_s=f"{time.perf_counter() - t0:.2f}")
    return out


def looped_record(bench: dict, urdf_rollout: dict, fleet_records: list) -> dict:
    """The kernels line's record of K1 on the looped step: its launches on
    the public route (phases 25 and 32, the robots the route gives the
    looped form), its largest |d| against ``LoopRollout`` anywhere, and the
    Gen3's figures (phase 25) as its time, plain version and bound."""
    launches = sum(r["launches"]["looped"] for r in urdf_rollout.values())
    launches += sum(r["launches"] for r in fleet_records
                    if r["name"].startswith(K1_NAMES["looped"]) and r.get("reused") is None)
    looped_figures = [r["looped"] for r in urdf_rollout.values()] + [
        r if r["route_form"] == "looped" else r["other_form"] for r in fleet_records
        if r["name"].startswith((K1_NAMES["looped"], K1_NAMES["emitted"])) and r.get("reused") is None]
    if launches < 1:
        raise AssertionError("the public route launched the looped K1 on no robot")
    gen3 = urdf_rollout["gen3"]["looped"]
    return {
        "name": K1_NAMES["looped"], "route": "cuda", "source": LOOP_SOURCE,
        "replaces": "manipulapy_tpu/ops/pallas_rollout.py:219", "step_replaces": "manipulapy_tpu/ops/fd_step.py:274",
        "launches": launches, "max_abs_err": max([b["max_abs_err"] for b in bench.values()]
                                                 + [f["max_abs_err"] for f in looped_figures]),
        "tolerance": "0 (first rows)", "robot": "gen3", "ms": gen3["ms"], "plain_ms": gen3["plain_ms"],
        "plain_scope": f"the first {ROWS_CHECKED} rows, {FIRST_STEPS_CHECKED} steps",
        "bound_ms": gen3["bound_ms"], "bound_by": gen3["bound_by"], "library_ms": None,
        "loop_ops": gen3["loop_ops"], "loop_ops_bound_ms": gen3["loop_ops_bound_ms"],
        "num_regs": gen3["num_regs"], "local_bytes": gen3["local_bytes"], "blocks_per_sm": gen3["blocks_per_sm"],
        "bench_shape": bench, "block": BLOCK, "chunk": CHUNK,
    }


def urdf_robots() -> dict:
    """The models of phases 25 and 26, float32 on the card, from the
    catalogs as a user loads them."""
    return {
        "ur5": catalog.get_robot("ur5"),
        "gen3": robot_data.load_robot("gen3"),
        "panda": robot_data.load_robot("panda"),
        "panda_arm": catalog.get_robot("panda", source="calibrated", **PANDA_ARM),
    }


def urdf_models_phase() -> None:
    """Phase 24: parse and extract every calibrated and DH robot on the
    host; ``get_robot("ur5")`` must be the calibrated UR5."""
    t0 = time.perf_counter()
    for name in robot_data.list_robots():
        URDF.load(robot_data.get_robot_urdf(name)).extract_screw_axes()
    for name in data.list_robots():
        URDF.from_string(data.robot_urdf_string(name)).extract_screw_axes(tip_link="tool0")
    parse_s = time.perf_counter() - t0
    for source, names, load in (("calibrated", robot_data.list_robots(), robot_data.load_robot),
                                ("dh", data.list_robots(), data.load_robot)):
        for name in names:
            model = load(name)
            phase("urdf_models", source=source, robot=name, joints=model.num_joints, digest=host_arrays(model)["digest"])
    auto = host_arrays(catalog.get_robot("ur5"))["digest"]
    calibrated = host_arrays(robot_data.load_robot("ur5"))["digest"]
    programmatic = host_arrays(catalog.ur5())["digest"]
    if auto != calibrated or auto == programmatic:
        raise AssertionError(f"get_robot('ur5') is {auto}, not the calibrated UR5 {calibrated}")
    phase("urdf_models", calibrated=len(robot_data.list_robots()), dh=len(data.list_robots()),
          parse_extract_s=f"{parse_s:.4f}", get_robot_ur5=repr("calibrated"), digest=auto,
          phase_s=f"{time.perf_counter() - t0:.2f}")


def urdf_inputs(gen: torch.Generator, model, B: int, N: int):
    """q0 uniform within each joint's limits clipped to [-1, 1], dq0 in
    [-0.5, 0.5], tau in [-10, 10], float32 on the card."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=DEV, dtype=torch.float32)
    lo, hi = torch.clamp(model.joint_lower, min=-1.0), torch.clamp(model.joint_upper, max=1.0)
    n = model.num_joints
    return lo + u(B, n) * (hi - lo), u(B, n) - 0.5, u(B, N, n) * 20 - 10


def public_engine(model):
    """The engine ``trajectory.forward_dynamics_trajectory`` serves a
    float32 (B, n) call on the card with, from its cache."""
    return trajectory._rollout_engine_for(model, DT, 1, DEFAULT_G, torch.device(DEV), torch.float32, True)


_SASS_COUNTS: dict = {}


def sass_instructions(engine: CudaRollout):
    """The SASS instructions of the rollout kernel in ``engine``'s library
    (``cuobjdump -sass``, beside nvcc), or None where cuobjdump is missing."""
    return sass_count(str(engine.build().path))


def sass_count(path: str):
    """The SASS instructions in the library at ``path`` (its one kernel's:
    a K1 unit, or a K2 unit built alone), or None without cuobjdump."""
    if path not in _SASS_COUNTS:
        tool = os.path.join(os.path.dirname(os.path.realpath(nvcc_path())), "cuobjdump")
        if not os.path.exists(tool):
            return None
        sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True, timeout=120).stdout
        _SASS_COUNTS[path] = sum(1 for ln in sass.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln))
    return _SASS_COUNTS[path]


def k1_forms(label: str, model, forms: dict, gen: torch.Generator, card: str, phase_name: str,
             pending: list = None) -> dict:
    """K1 on one robot at B=131072, N=50 in both forms (``forms``: form ->
    CudaRollout, prebuilt). The public route first, its counts set to 0
    just before: one launch, of the form the route gives the robot, finite
    outputs. Then each form's outputs bitwise its own plain version's on
    the first ROWS_CHECKED rows and FIRST_STEPS_CHECKED steps, both forms timed in turns (emitted, looped,
    looped, emitted; CUDA-event medians of 5 after 2 warm-ups), each form's
    registers, local bytes, blocks an SM and SASS instructions. With
    ``pending`` the looped form's rows go there for ``looped_plain_grouped``
    instead. Returns the route's form, its outputs and launches, and per
    form its figures."""
    t0 = time.perf_counter()
    n = model.num_joints
    q0, dq0, tau = urdf_inputs(gen, model, B_FULL, N_FULL)
    CudaRollout.reset_launch_count()
    outs = trajectory.forward_dynamics_trajectory(model, q0, dq0, tau, dt=DT)
    torch.cuda.synchronize()
    counts, engine = dict(CudaRollout.launch_counts), public_engine(model)
    route = engine.form
    if CudaRollout.launch_count != 1 or counts[route] != 1:
        raise AssertionError(f"{label}: K1 launches {counts}, not one of the route's {route} form")
    for name, x in zip(TOL, outs):
        if tuple(x.shape) != (B_FULL, N_FULL, n) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label} K1 {name}: shape {tuple(x.shape)} or non-finite values")
    rows, steps, out = ROWS_CHECKED, FIRST_STEPS_CHECKED, {}
    if any(eng.form != form for form, eng in forms.items()) or forms[route].source != engine.source:
        raise AssertionError(f"{label}: the engines are not the route's units")
    for form, eng in forms.items():
        got = outs if form == route else eng(q0, dq0, tau)
        a = eng.kernel_attributes()
        out[form] = {"num_regs": a["num_regs"], "local_bytes": a["local_bytes"], "blocks_per_sm": a["blocks_per_sm"],
                     "sass_instructions": sass_instructions(eng), "ms_turns": []}
        if form == "looped" and pending is not None:
            pending.append((label, eng, [q0[:rows].clone(), dq0[:rows].clone(), tau[:rows, :steps].contiguous()],
                            [g[:rows, :steps].contiguous() for g in got]))
            continue
        ref, plain_ms = timed(lambda: eng.plain(q0[:rows], dq0[:rows], tau[:rows, :steps].contiguous()))
        errs = {k: bit_diff(g[:rows, :steps], r) for k, g, r in zip(TOL, got, ref)}
        if any(v != 0.0 for v in errs.values()):
            raise AssertionError(f"{label}: K1 {form} against its plain version {errs}, not 0")
        out[form].update(max_abs_err=max(errs.values()), plain_ms=plain_ms)
    for form in ("emitted", "looped", "looped", "emitted"):
        out[form]["ms_turns"].append(time_ms(lambda: forms[form](q0, dq0, tau)))
    if public_engine(model) is not engine:
        raise AssertionError(f"{label}: the engine left the cache during the timings")
    statements = forms["emitted"].statements
    b_ms, b_by = bound((2 * B_FULL * n + 4 * B_FULL * N_FULL * n) * 4, statements * B_FULL * N_FULL)
    loop_ops = forms["looped"].loop_ops
    for form in FORMS:
        out[form].update(ms=min(out[form]["ms_turns"]), bound_ms=b_ms, bound_by=b_by)
    out["looped"].update(loop_ops=loop_ops, loop_ops_bound_ms=bound(0, loop_ops * B_FULL * N_FULL)[0])
    other = "looped" if route == "emitted" else "emitted"
    route_ok = out[route]["ms"] <= ROUTE_SLACK * out[other]["ms"]
    phase(phase_name, card=repr(card), robot=label, joints=n, B=B_FULL, N=N_FULL, route=route,
          route_launches=counts[route], statements=statements, loop_ops=loop_ops,
          **{f"{f}_ms": ",".join(f"{t:.4f}" for t in out[f]["ms_turns"]) for f in FORMS},
          bound_ms=f"{b_ms:.4f}", bound_by=b_by, route_within_slack=route_ok, steps_checked=steps,
          **{f"{f}_{k}": out[f][k] for f in FORMS for k in ("num_regs", "local_bytes", "blocks_per_sm", "sass_instructions")},
          **{f"{f}_max_abs_err_first{rows}": f"{out[f]['max_abs_err']:.3e}" for f in FORMS if "max_abs_err" in out[f]},
          **{f"{f}_plain_ms_first{rows}": f"{out[f]['plain_ms']:.1f}" for f in FORMS if "plain_ms" in out[f]},
          engine_cache=len(trajectory._ENGINE_CACHE), phase_s=f"{time.perf_counter() - t0:.2f}")
    return {"joints": n, "route_form": route, "launches": counts, "route_within_slack": route_ok,
            "statements": statements, "outputs": outs, **{f: out[f] for f in FORMS}}


def looped_plain_grouped(pending: list, results: dict) -> None:
    """The looped K1's rows of ``k1_forms`` (``pending``) against
    ``LoopRollout``'s arithmetic, one plain call per joint count: the
    robots' first rows side by side, each row with its robot's table
    (``fd_step.loop_rollout_plain`` over a (T, rows) table), so the host's
    launches are paid once a joint count and not once a robot. Each robot's
    rows bitwise; its ``looped`` figures in ``results`` get the |d| and the
    group's plain ms."""
    groups = {}
    for item in pending:
        groups.setdefault(item[1].n, []).append(item)
    for n, items in groups.items():
        rows = [x[0].shape[0] for _, _, x, _ in items]
        tab = torch.cat([eng.table[:, None].expand(-1, r) for (_, eng, _, _), r in zip(items, rows)], dim=1).to(DEV)
        inputs_n = [torch.cat([x[i] for _, _, x, _ in items]) for i in range(3)]
        ref, plain_ms = timed(lambda: loop_rollout_plain(tab, n, 1, *inputs_n))
        at = 0
        for (label, _, _, got), r in zip(items, rows):
            errs = {k: bit_diff(g, x[at:at + r]) for k, g, x in zip(TOL, got, ref)}
            if any(v != 0.0 for v in errs.values()):
                raise AssertionError(f"{label}: K1 looped against its plain version {errs}, not 0")
            results[label]["looped"].update(max_abs_err=max(errs.values()), plain_ms=plain_ms,
                                            plain_scope=f"one LoopRollout call for the {len(items)} robots of {n} joints, "
                                                        f"{FIRST_STEPS_CHECKED} steps")
            at += r
        phase("fleet_looped_plain", joints=n, robots=",".join(i[0] for i in items), rows=sum(rows), steps=FIRST_STEPS_CHECKED,
              plain_ms=f"{plain_ms:.1f}", max_abs_err=f"{max(results[i[0]]['looped']['max_abs_err'] for i in items):.3e}")


def urdf_rollout_phase(robots: dict, ur5, engines: dict, card: str) -> dict:
    """Phase 25: K1 at B=131072, N=50 on each calibrated robot through the
    public entry point and in both forms (``k1_forms``); the Panda's finger
    inside its clamps; the route's form's time beside the programmatic
    UR5's."""
    gen = torch.Generator(DEV).manual_seed(0)
    out = {}
    for name in URDF_ROLLOUT:
        model = robots[name]
        r = k1_forms(name, model, {f: engines[f"urdf {name} {f}"] for f in FORMS}, gen, card, "urdf_rollout")
        qs, dqs, _ = r.pop("outputs")
        if name == "panda":  # the prismatic finger inside its clamps after the first row
            fq, fdq = qs[:, 1:, 7], dqs[:, 1:, 7]
            if not bool((fq >= 0).all() and (fq <= 0.04).all() and (fdq.abs() <= 0.2).all()):
                raise AssertionError("urdf panda: the finger left its clamps")
        ur5_engine, ur5_in = public_engine(ur5), urdf_inputs(gen, ur5, B_FULL, N_FULL)
        r["programmatic_ur5_ms"] = time_ms(lambda: ur5_engine(*ur5_in))
        phase("urdf_rollout", robot=name, route=r["route_form"], route_ms=f"{r[r['route_form']]['ms']:.4f}",
              programmatic_ur5_kernel_ms=f"{r['programmatic_ur5_ms']:.4f}")
        out[name] = r
    return out


def urdf_mpc_phase(arm, panda, card: str) -> dict:
    """Phase 26: the batched solve and 3 rounds on the calibrated Panda arm
    at the main path's shape; K2-K5 against their plain versions fed the
    solver's own controls; its time beside the programmatic Panda's."""
    t0 = time.perf_counter()
    gen = torch.Generator(DEV).manual_seed(1)
    f32 = dict(dtype=torch.float32, device=DEV)
    n, nx = arm.num_joints, 2 * arm.num_joints
    x0, goals = panda_problem(gen, arm, B_MPC)
    mpc = build_batch_tracking_mpc(arm, goals, B_MPC, H_MPC, DT, iterations=ITERS)
    K = mpc.kernels
    u_lim = torch.tensor(K.P.u_lim, device=DEV)
    if not torch.equal(u_lim.cpu(), arm.torque_limit.cpu()):
        raise AssertionError(f"u_lim {K.P.u_lim} is not the model's torque limits")
    cost_zero = mpc.replay(
        x0.T.contiguous(), torch.zeros((H_MPC, nx, B_MPC), **f32), torch.zeros((H_MPC, n, B_MPC), **f32),
        torch.zeros((H_MPC, n, 1 + nx, B_MPC), **f32), goals.T.contiguous(), torch.zeros((B_MPC,), **f32),
    )[2]
    BatchMPCKernels.reset_launch_count()
    us, xs, cost = mpc.solve(x0, torch.zeros((B_MPC, H_MPC, n), **f32))
    torch.cuda.synchronize()
    per_solve = dict(BatchMPCKernels.launch_count)
    if per_solve != {"linearize": ITERS, "backward": ITERS, "linesearch_costs": 0, "linesearch": ITERS, "replay": 1}:
        raise AssertionError(f"urdf panda arm: launches per solve {per_solve}")
    check_solution("urdf solve", us, xs, cost, u_lim)
    if not (bool((cost <= cost_zero).all()) and float(cost.mean()) < float(cost_zero.mean())):
        raise AssertionError(f"urdf solve: mean cost {float(cost.mean())} not below the zero-control "
                             f"{float(cost_zero.mean())}")
    x, us_warm = xs[:, 1].contiguous(), torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    for r in range(3):
        _, goals_r = panda_problem(gen, arm, B_MPC)
        _, us_warm, (us_r, xs_r, cost_r) = batch_mpc_step(mpc, x, us_warm, goals_r)
        check_solution(f"urdf round {r}", us_r, xs_r, cost_r, u_lim)
        x = xs_r[:, 1].contiguous()
    torch.cuda.synchronize()
    launches = dict(BatchMPCKernels.launch_count)
    if launches != {k: 4 * v for k, v in per_solve.items()}:
        raise AssertionError(f"urdf panda arm: launches over 4 solves {launches}")
    # K2-K5 against their plain versions, fed the solver's own controls: K3
    # within MPC_RTOL of each output's scale on the sweep's last
    # RICCATI_STEPS_CHECKED steps, the others bit for bit (NaN where the
    # plain version has NaN: some alphas diverge).
    _, args, _ = mpc_stage_parity(K, x0, goals, us.permute(1, 2, 0).contiguous(), "urdf panda arm", False, check=False)
    errs, plain, k = {}, K.plain(), RICCATI_STEPS_CHECKED
    for stage in MPC_STAGES:
        got = getattr(K, stage)(*args[stage])
        if stage == "backward":
            a = args[stage]
            got, ref = got[-k:], plain.backward(*(x[-k:].contiguous() for x in a[:3]), *a[3:])
        else:
            ref = getattr(plain, stage)(*args[stage])
        got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
        if stage in BITWISE_STAGES:
            errs[stage] = max(bit_diff(g, r) for g, r in zip(got, ref))
            if errs[stage] != 0.0:
                raise AssertionError(f"urdf panda arm {stage}: max |d| = {errs[stage]}, not 0")
        else:
            errs[stage] = max(compare(stage, got, ref, "urdf panda arm").values())
    zeros = torch.zeros((B_MPC, H_MPC, n), **f32)
    x0_p, goals_p = panda_problem(gen, panda, B_MPC)
    prog = build_batch_tracking_mpc(panda, goals_p, B_MPC, H_MPC, DT, iterations=ITERS)
    arm_ms = [time_ms(lambda: mpc.solve(x0, zeros))]
    prog_ms = [time_ms(lambda: prog.solve(x0_p, zeros)) for _ in range(2)]
    arm_ms.append(time_ms(lambda: mpc.solve(x0, zeros)))
    phase("urdf_mpc", card=repr(card), robot="panda arm (calibrated)", joints=n, B=B_MPC, H=H_MPC, iterations=ITERS,
          alphas=ALPHAS, launches_per_solve=json.dumps(per_solve).replace(" ", ""),
          launches_4_solves=json.dumps(launches).replace(" ", ""), mean_cost=f"{float(cost.mean()):.6e}",
          mean_zero_control_cost=f"{float(cost_zero.mean()):.6e}",
          **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
          solve_ms=",".join(f"{v:.4f}" for v in arm_ms), programmatic_panda_solve_ms=",".join(f"{v:.4f}" for v in prog_ms),
          u_lim=",".join(f"{v:g}" for v in K.P.u_lim), k2_form=K.form, phase_s=f"{time.perf_counter() - t0:.2f}")
    return {"per_solve": per_solve, "errs": errs, "solve_ms": min(arm_ms), "programmatic_solve_ms": min(prog_ms),
            "k2_form": K.form}


def urdf_records(records: list, rollout: dict, mpc: dict) -> None:
    """Name the URDF robots K1 and K2-K5 were held on in their records."""
    records[0]["urdf_robots"] = rollout
    for rec in records[1:]:
        stage = next((s for s, (name, _) in MPC_KERNELS.items() if rec["name"] == name), None)
        if rec["name"] in K2_NAMES.values():  # the form the arm's route took
            stage = "linearize" if rec["name"] == K2_NAMES[mpc["k2_form"]] else None
        if stage is None:
            continue
        err = mpc["errs"][stage]
        if stage == "linesearch":  # K4 serves both stages
            err = max(err, mpc["errs"]["linesearch_costs"])
        rec["urdf_panda_arm"] = {"launches_per_solve": mpc["per_solve"][stage], "max_abs_err": err,
                                 "solve_ms": mpc["solve_ms"], "programmatic_panda_solve_ms": mpc["programmatic_solve_ms"]}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)


# ---------------------------------------------------------------------------
# The runtime layer (phases 27-31): utils, vision, perception
# ---------------------------------------------------------------------------

# A depth frame at the default CameraConfig (640 x 480, fx = fy = 500): the
# three boxes of examples/intermediate/perception_demo.py at twice its
# 320 x 240, (rows, cols, depth) over a 5 m background; the camera at
# CAM_POSITION looks along -x at the UR5's workspace, image down = world down.
SCENE_BOXES = (((120, 200), (100, 180), 1.2), ((280, 400), (400, 520), 2.0), ((60, 140), (480, 580), 2.6))
SCENE_BACKGROUND, SCENE_THRESHOLD, SCENE_MIN_AREA = 5.0, 3.0, 100
CAM_POSITION = (1.8, 0.0, 0.4)
CAM_AXES = ((0.0, 0.0, -1.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0))  # rows of R: columns x_c, y_c, z_c in world
PERCEIVED_ATOL = 1e-5  # m, against the f64 pinhole truth
UNPROJECT_FRAMES, UNPROJECT_RTOL = 64, 1e-6
PERCEIVED_STEPS_CHECKED = 50  # of the plans' rollout against its plain version (a rollout is causal)
FIELD_GOAL = (0.4, 0.1, 0.3)
# The AOT load runs in a fresh process: no nvcc on PATH, no CUDA_HOME or
# CUDA_PATH, an empty build root; nvcc_path also looks in /usr/local/cuda,
# which an environment cannot hide, so the child makes it raise.
AOT_CHILD = r'''
import time
t_start = time.perf_counter()
import json, os, shutil, sys
import torch
t_torch = time.perf_counter() - t_start
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t_cuda = time.perf_counter() - t_start - t_torch
from manipulapy_tpu_torch.ops import _build


def no_nvcc():
    raise RuntimeError("an AOT load called nvcc")


_build.nvcc_path = no_nvcc
from manipulapy_tpu_torch.utils import aot

t_port = time.perf_counter() - t_start - t_torch - t_cuda
work = sys.argv[1]
inputs = torch.load(os.path.join(work, "inputs.pt"))
report = {"import_torch_s": t_torch, "cuda_init_s": t_cuda, "import_port_s": t_port,
          "nvcc_on_path": shutil.which("nvcc"), "build_root": str(_build.build_root())}
outputs = {}
for kind, load in (("batch", aot.load_batch_mpc), ("tracking", aot.load_tracking_mpc)):
    t0 = time.perf_counter()
    solve = load(os.path.join(work, kind + ".aot"))
    load_s = time.perf_counter() - t0
    if solve is None:
        raise SystemExit(kind + ": the artifact was refused")
    x0, us = inputs[kind]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs[kind] = solve(x0, us)
    torch.cuda.synchronize()
    report[kind] = {"load_s": load_s, "first_solve_s": time.perf_counter() - t0,
                    "compile_seconds": {u: b.compile_seconds for u, b in solve.handle.kernels.build().items()}}
torch.save(outputs, os.path.join(work, "outputs.pt"))
print(json.dumps(report))
'''


def scene_camera() -> CameraConfig:
    T = np.eye(4)
    T[:3, :3] = np.asarray(CAM_AXES).T
    T[:3, 3] = CAM_POSITION
    return CameraConfig(extrinsic=T)


def scene_depth(cam: CameraConfig) -> np.ndarray:
    d = np.full((cam.height, cam.width), SCENE_BACKGROUND, dtype=np.float32)
    for (r0, r1), (c0, c1), z in SCENE_BOXES:
        d[r0:r1, c0:c1] = z
    return d


def scene_truth(cam: CameraConfig, depth: np.ndarray, one_box: bool) -> np.ndarray:
    """The world positions the detector must report, f64 in NumPy: each
    box's centre at its depth (cv2's components), or without cv2 the one box
    around every near pixel at their median depth (the JAX fallback)."""
    if one_box:
        rows = [r for r, _, _ in SCENE_BOXES]
        cols = [c for _, c, _ in SCENE_BOXES]
        r0, r1, c0, c1 = min(r[0] for r in rows), max(r[1] for r in rows), min(c[0] for c in cols), max(c[1] for c in cols)
        roi = depth[r0:r1, c0:c1].astype(np.float64)
        boxes = [((r0, r1), (c0, c1), float(np.median(roi[roi < SCENE_THRESHOLD])))]
    else:
        boxes = SCENE_BOXES
    T = np.asarray(cam.extrinsic, dtype=np.float64)
    out = []
    for (r0, r1), (c0, c1), z in boxes:
        u, v = (c0 + c1) / 2.0, (r0 + r1) / 2.0
        p = np.array([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z])
        out.append(T[:3, :3] @ p + T[:3, 3])
    return np.stack(out)


def features_phase(card: str) -> dict:
    """Phase 27: the feature table, and ``test_installation`` on the card,
    whose rollout is one K1 launch."""
    feats = utils.get_available_features(refresh=True)
    if not feats["cuda"]:
        raise AssertionError(f"the 'cuda' feature is not available: {feats}")
    CudaRollout.reset_launch_count()
    t0 = time.perf_counter()
    ok = utils.test_installation()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if ok is not True or CudaRollout.launch_count != 1:
        raise AssertionError(f"test_installation() = {ok} with {CudaRollout.launch_count} K1 launches, expected True and 1")
    phase("features", card=repr(card), features=json.dumps(feats).replace(" ", ""), test_installation=ok,
          k1_launches=CudaRollout.launch_count, seconds=f"{seconds:.4f}")
    return {"test_installation_launches": CudaRollout.launch_count}


def profile_trace_phase(mpc, x0, card: str) -> dict:
    """Phase 28: one batched solve under ``utils.profile_trace``; its Chrome
    trace must hold K2-K5's device events. Then ``benchmark_fn`` beside the
    CUDA-event median of the same solve (a report)."""
    us0 = torch.zeros((B_MPC, H_MPC, mpc.n), device=DEV)
    mpc.solve(x0, us0)  # warm
    torch.cuda.synchronize()
    names = {"K2": "mpt_lin_kernel", "K3": "mpt_bwd_warp_kernel", "K4": "mpt_cost_kernel", "K5": "mpt_replay_kernel"}
    with tempfile.TemporaryDirectory() as work:
        with utils.profile_trace(os.path.join(work, "trace")) as log_dir:
            mpc.solve(x0, us0)
        path = os.path.join(log_dir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {}
    for k, name in names.items():
        hits = [e for e in kernels if name in e.get("name", "")]
        if not hits:
            raise AssertionError(f"the trace holds no device event of {k} ({name}); kernels: "
                                 f"{sorted({e.get('name', '')[:60] for e in kernels})}")
        found[k] = {"name": hits[0]["name"], "events": len(hits), "device_ms": sum(e["dur"] for e in hits) / 1e3}
    if [found[k]["events"] for k in names] != [ITERS, ITERS, ITERS, 1]:
        raise AssertionError(f"the trace's K2-K5 events {found}, expected {ITERS}/{ITERS}/{ITERS}/1")
    bench = utils.benchmark_fn(mpc.solve, x0, us0, warmup=2, iters=10)
    median = time_ms(lambda: mpc.solve(x0, us0))
    phase("profile_trace", card=repr(card), robot="panda", B=B_MPC, H=H_MPC, trace_bytes=trace_bytes,
          device_events=len(kernels), **{f"{k}_name": repr(v["name"]) for k, v in found.items()},
          **{f"{k}_device_ms": f"{v['device_ms']:.4f}" for k, v in found.items()},
          benchmark_fn=json.dumps({k: round(v, 4) for k, v in bench.items()}).replace(" ", ""),
          cuda_event_median_ms=f"{median:.4f}")
    return {"trace": found, "benchmark_fn": bench, "cuda_event_median_ms": median}


def checkpoint_phase(panda, goals, x0, card: str) -> dict:
    """Phase 29: 3 rounds of ``batch_mpc_step`` (a disturbance drawn from a
    CUDA generator each round), a ``CheckpointManager`` save of the state,
    the warm start, the round, the generator's state and a bf16 copy of the
    warm start, a restore into a freshly built solver and 2 more rounds:
    bitwise 5 rounds in one go, 4/4/4/1 launches a solve."""
    build = lambda: build_batch_tracking_mpc(panda, goals, B_MPC, H_MPC, DT, iterations=ITERS)
    us0 = torch.zeros((B_MPC, H_MPC, panda.num_joints), device=DEV)

    def rounds(mpc, x, us_warm, g, count):
        for _ in range(count):
            _, us_warm, (us, xs, cost) = batch_mpc_step(mpc, x, us_warm)
            x = xs[:, 1] + 1e-4 * torch.randn(x.shape, generator=g, device=DEV)
        return x, us_warm, (us, xs, cost)

    ref = rounds(build(), x0, us0, torch.Generator(DEV).manual_seed(7), 5)
    gen = torch.Generator(DEV).manual_seed(7)
    x, us_warm, _ = rounds(build(), x0, us0, gen, 3)
    with tempfile.TemporaryDirectory() as work:
        mgr = CheckpointManager(work)
        t0 = time.perf_counter()
        path = mgr.save(3, {"x": x, "us_warm": us_warm, "round": 3, "gen": gen.get_state(),
                            "us_bf16": us_warm.to(torch.bfloat16)}, meta={"robot": "panda"})
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        step, state = mgr.restore_latest(device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if step != 3 or int(state["round"]) != 3 or state["x"].device.type != DEV:
        raise AssertionError(f"restored step {step}, round {state['round']}, on {state['x'].device}")
    bf16_bits = torch.equal(state["us_bf16"].view(torch.int16), us_warm.to(torch.bfloat16).view(torch.int16))
    if not bf16_bits or state["us_bf16"].dtype != torch.bfloat16:
        raise AssertionError("the bf16 leaf did not round-trip bit for bit")
    resumed = torch.Generator(DEV)
    resumed.set_state(state["gen"].cpu())
    fresh = build()
    BatchMPCKernels.reset_launch_count()
    got = rounds(fresh, state["x"], state["us_warm"], resumed, 2)
    torch.cuda.synchronize()
    launches = dict(BatchMPCKernels.launch_count)
    expected = {"linearize": 2 * ITERS, "backward": 2 * ITERS, "linesearch_costs": 0, "linesearch": 2 * ITERS, "replay": 2}
    if launches != expected:
        raise AssertionError(f"the resumed rounds launched {launches}, expected {expected}")
    names = ("x", "us_warm", "us", "xs", "cost")
    for name, g, r in zip(names, [got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]):
        if not torch.equal(g, r):
            raise AssertionError(f"resumed {name} differs from the uninterrupted run by {float((g - r).abs().max())}")
    phase("checkpoint_resume", card=repr(card), robot="panda", B=B_MPC, H=H_MPC, iterations=ITERS, rounds="3+2",
          bitwise=",".join(names), bf16_leaf_bitwise=bf16_bits, file_bytes=size, save_s=f"{save_s:.4f}",
          restore_s=f"{restore_s:.4f}", launches_2_solves=json.dumps(launches).replace(" ", ""))
    return {"launches": launches}


def aot_phase(mpc, single, panda, x0) -> dict:
    """Phase 30, begun: both solvers saved as AOT artifacts (an artifact
    naming another card refused) and the process that loads them started,
    without nvcc and with an empty build root. It runs beside the phases
    that follow until ``aot_result`` waits for it."""
    n = mpc.n
    x0_s = mid_rest(panda)
    inputs = {"batch": (x0.contiguous(), torch.zeros((B_MPC, H_MPC, n), device=DEV)),
              "tracking": (x0_s, torch.zeros((H_MPC, n), device=DEV))}
    refs = {"batch": mpc.solve(*inputs["batch"]), "tracking": single.solve(*inputs["tracking"])}
    torch.cuda.synchronize()
    work = tempfile.mkdtemp()
    t0 = time.perf_counter()
    paths = {"batch": aot.save_batch_mpc(mpc, os.path.join(work, "batch.aot")),
             "tracking": aot.save_tracking_mpc(single, os.path.join(work, "tracking.aot"))}
    save_s = time.perf_counter() - t0
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    # An artifact whose meta names another card is refused.
    with open(paths["batch"], "rb") as f:
        header, blob = f.readline(), pickle.load(f)
    blob["meta"]["device_name"] = "another card"
    other = os.path.join(work, "other.aot")
    with open(other, "wb") as f:
        f.write(header)
        pickle.dump(blob, f)
    if aot.load_batch_mpc(other) is not None:
        raise AssertionError("an artifact naming another card was loaded")
    root = os.path.join(work, "empty_root")
    os.makedirs(root)
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(os.pathsep)
                                  if p and not os.path.exists(os.path.join(p, "nvcc")))
    env.update(MANIPULAPY_TPU_CACHE_DIR=root, PYTHONPATH=REPO_ROOT)
    with open(os.path.join(work, "child.out"), "w") as out, open(os.path.join(work, "child.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", AOT_CHILD, work], env=env, cwd=REPO_ROOT, stdout=out, stderr=err)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "t0": time.perf_counter(), "work": work, "root": root, "refs": refs, "sizes": sizes,
            "save_s": save_s}


def aot_result(started: dict, card: str) -> dict:
    """Phase 30, ended: the load process's solves bitwise the in-process
    ones and every unit's compile_seconds 0; its seconds to import torch,
    to load each artifact and to its first solve."""
    proc, work, root = started["proc"], started["work"], started["root"]
    try:
        rc = proc.wait(timeout=600)
        child_s = time.perf_counter() - started["t0"]
        if rc != 0:
            with open(os.path.join(work, "child.err")) as f:
                raise AssertionError(f"the AOT load process failed ({rc}):\n{f.read()[-4000:]}")
        with open(os.path.join(work, "child.out")) as f:
            report = json.loads(f.read().strip().splitlines()[-1])
        outputs = torch.load(os.path.join(work, "outputs.pt"))
        unpacked = sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if report["nvcc_on_path"] is not None or report["build_root"] != root:
        raise AssertionError(f"the load process saw nvcc at {report['nvcc_on_path']} or the root {report['build_root']}")
    for kind in ("batch", "tracking"):
        seconds = report[kind]["compile_seconds"]
        if len(seconds) != 3 or any(s != 0.0 for s in seconds.values()):
            raise AssertionError(f"{kind}: the loaded units compiled: {seconds}")
        for name, g, r in zip(("us", "xs", "cost"), outputs[kind], started["refs"][kind]):
            if not torch.equal(g, r):
                raise AssertionError(f"{kind}: the loaded solve's {name} differs by {float((g - r).abs().max())}")
    phase("aot_first_solve", card=repr(card), robot="panda", batch=f"B={B_MPC} H={H_MPC}",
          tracking=f"H={H_MPC} iterations={ITERS}", artifact_bytes=json.dumps(started["sizes"]).replace(" ", ""),
          save_s=f"{started['save_s']:.4f}", child_process_s=f"{child_s:.3f}",
          import_torch_s=f"{report['import_torch_s']:.3f}", cuda_init_s=f"{report['cuda_init_s']:.3f}",
          import_port_s=f"{report['import_port_s']:.3f}",
          **{f"{k}_load_s": f"{report[k]['load_s']:.4f}" for k in ("batch", "tracking")},
          **{f"{k}_first_solve_s": f"{report[k]['first_solve_s']:.4f}" for k in ("batch", "tracking")},
          compile_seconds=json.dumps({k: report[k]["compile_seconds"] for k in ("batch", "tracking")}).replace(" ", ""),
          unpacked=len(unpacked), bitwise="us,xs,cost", other_card_refused=True, beside="phase 7")
    return {k: {"load_s": report[k]["load_s"], "first_solve_s": report[k]["first_solve_s"]} for k in ("batch", "tracking")}


def perception_plan_phase(ur5, gen: torch.Generator, card: str) -> dict:
    """Phase 31: a depth frame -> ``Perception(Vision(...))`` -> the
    perceived positions as the obstacle cloud of the UR5 planning path
    (K9, link positions, K10, inverse dynamics, K1), one launch each; the
    positions against the f64 pinhole truth; the unprojection of 64 frames
    timed against its bytes bound; then K9, K10 and K1 against their plain
    versions on the very tensors the path gave them."""
    cam = scene_camera()
    depth = scene_depth(cam)
    rgb = np.zeros((cam.height, cam.width, 3), np.uint8)
    has_cv2 = vision._HAS_CV2
    per = Perception(Vision([cam], device=DEV))
    t0 = time.perf_counter()
    positions, labels = per.detect_and_cluster_obstacles(rgb, depth, depth_threshold=SCENE_THRESHOLD,
                                                         min_blob_area=SCENE_MIN_AREA, eps=0.5, min_samples=1)
    detect_s = time.perf_counter() - t0
    expected = 3 if has_cv2 else 1
    if positions.shape != (expected, 3) or positions.dtype != np.float32:
        raise AssertionError(f"detected {positions.shape} {positions.dtype}, expected ({expected}, 3) float32 "
                             f"({'cv2' if has_cv2 else 'the NumPy one-box fallback'})")
    truth = scene_truth(cam, depth, one_box=not has_cv2)
    order = lambda p: p[np.argsort(p[:, 0])]  # cv2 numbers components in raster order; the boxes differ in x
    pos_err = float(np.abs(order(positions.astype(np.float64)) - order(truth)).max())
    if not pos_err <= PERCEIVED_ATOL:
        raise AssertionError(f"perceived positions off the pinhole truth by {pos_err} m")

    # The unprojection of whole frames: 64 noisy copies of the scene.
    f32 = dict(dtype=torch.float32, device=DEV)
    frames = torch.from_numpy(depth).to(DEV)[None] + 0.01 * torch.rand((UNPROJECT_FRAMES, cam.height, cam.width),
                                                                       generator=gen, **f32)
    u = torch.arange(cam.width, **f32).expand(cam.height, cam.width)
    v = torch.arange(cam.height, **f32)[:, None].expand(cam.height, cam.width)
    unproject = lambda: vision.camera_to_world(vision.pixel_to_camera(u, v, frames, cam), cam)
    with torch.no_grad():
        world = unproject()
        un_ms = time_ms(unproject)
        un_trace = {}  # where the eager ops' time goes, by the first 48 characters of each kernel's name
        for name, ms in device_profile(unproject).get("by_name", {}).items():
            un_trace[name[:48]] = un_trace.get(name[:48], 0.0) + ms
    pixels = frames.numel()
    un_bound = pixels * (4 + 12) / HBM_BYTES_PER_S * 1e3
    T = np.asarray(cam.extrinsic, dtype=np.float64)
    uu, vv = np.meshgrid(np.arange(cam.width, dtype=np.float64), np.arange(cam.height, dtype=np.float64))
    worst, scale = 0.0, 0.0
    for i in range(UNPROJECT_FRAMES):
        z = frames[i].double().cpu().numpy()
        p = np.stack([(uu - cam.cx) / cam.fx * z, (vv - cam.cy) / cam.fy * z, z], -1) @ T[:3, :3].T + T[:3, 3]
        worst = max(worst, float(np.abs(world[i].double().cpu().numpy() - p).max()))
        scale = max(scale, float(np.abs(p).max()))
    un_rel = worst / scale
    if not un_rel <= UNPROJECT_RTOL:
        raise AssertionError(f"unprojection: max |d| {worst} over max |ref| {scale} = {un_rel} > {UNPROJECT_RTOL}")
    del world

    # The planning path against the perceived cloud.
    cloud = torch.as_tensor(positions, **f32).contiguous()
    rand = lambda *shape: torch.rand(shape, generator=gen, **f32) * 2 - 1
    lo, hi = ur5.joint_lower, ur5.joint_upper
    start = rand(B_PLAN, 6)
    goal = torch.clamp(start + rand(B_PLAN, 6) * 0.8, lo, hi)
    field_goal = torch.tensor(FIELD_GOAL, **f32)
    planner = create_planner(ur5, obstacle_points=cloud)
    ew.ElementwiseKernels.reset_launch_count()
    CudaRollout.reset_launch_count()
    stage_ms = {}
    with torch.no_grad():
        plan, stage_ms["batch_joint_trajectory"] = timed(lambda: planner.batch_joint_trajectory(start, goal, TF_PLAN, N_PLAN))
        points, stage_ms["link_positions"] = timed(lambda: potential_field.link_positions(ur5, plan.position))
        (U, grad_U), stage_ms["cartesian_potential_field"] = timed(
            lambda: potential_field.cartesian_potential_field(points, field_goal, cloud, D0_PLAN))
        tau, stage_ms["inverse_dynamics_trajectory"] = timed(lambda: planner.inverse_dynamics_trajectory(*plan))
        (sim_q, sim_dq, sim_ddq), stage_ms["forward_dynamics_trajectory"] = timed(
            lambda: planner.forward_dynamics_trajectory(plan.position[:, 0], plan.velocity[:, 0], tau, dt=DT_PLAN))
    torch.cuda.synchronize()
    launches = {**ew.ElementwiseKernels.launch_count, "rollout": CudaRollout.launch_count}
    if launches != {"trajectory": 1, "potential": 1, "rollout": 1}:
        raise AssertionError(f"the perceived planning path launched {launches}, expected one launch per kernel")
    for name, x in (("U", U), ("grad", grad_U), ("sim_q", sim_q), ("tau", tau)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"perception_plan: non-finite {name}")
    pts = points.reshape(-1, 3).contiguous()
    with torch.no_grad():
        k10_ms = per_call_ms(lambda: ew.cartesian_potential_kernel(pts, field_goal, cloud, D0_PLAN), calls=5)
    k10_bound, k10_by = potential_bound(pts.shape[0], cloud.shape[0])

    # The kernels against their plain versions on these tensors (after the
    # timings: the plain rollout is thousands of launches a step).
    errs = {}
    with torch.no_grad():
        errs["K9"] = traj_errors("perceived path", ew.trajectory_kernel(start, goal, TF_PLAN, N_PLAN, 5),
                                 ew.trajectory_plain(start, goal, TF_PLAN, N_PLAN, 5))
        errs["K10"] = potential_errors("perceived cloud", ew.cartesian_potential_kernel(pts, field_goal, cloud, D0_PLAN),
                                       ew.cartesian_potential_plain(pts, field_goal, cloud, D0_PLAN))
        steps = PERCEIVED_STEPS_CHECKED
        q0, dq0 = plan.position[:, 0].contiguous(), plan.velocity[:, 0].contiguous()
        ref = build_rollout(ur5, dt=DT_PLAN)(q0, dq0, tau[:, :steps].contiguous())
        errs["K1"] = max_errors([x[:, :steps] for x in (sim_q, sim_dq, sim_ddq)], ref)
        check_close("K1 on the perceived planning path", errs["K1"])
    phase("perception_plan", card=repr(card), cv2=has_cv2, detections=positions.shape[0], labels=labels.tolist(),
          max_abs_err_positions_m=f"{pos_err:.3e}", detect_and_cluster_s=f"{detect_s:.4f}",
          unproject_frames=UNPROJECT_FRAMES, unproject_pixels=pixels, unproject_ms=f"{un_ms:.4f}",
          unproject_bound_ms=f"{un_bound:.4f}", unproject_rel_err=f"{un_rel:.3e}",
          unproject_device_ms=f"{sum(un_trace.values()):.4f}" if un_trace else "not measured",
          unproject_kernels=json.dumps({k: round(v, 4) for k, v in sorted(un_trace.items(), key=lambda kv: -kv[1])}
                                       ).replace(" ", ""),
          plan=f"B={B_PLAN} N={N_PLAN} O={cloud.shape[0]} d0={D0_PLAN}",
          launches=json.dumps(launches).replace(" ", ""), **{f"{k}_ms": f"{v:.3f}" for k, v in stage_ms.items()},
          k10_ms=f"{k10_ms:.4f}", k10_bound_ms=f"{k10_bound:.4f}", k10_bound_by=k10_by, k1_steps_checked=steps,
          **{f"{k}_{fmt}": v for k, e in errs.items() for fmt, v in fmt_errs(e).items()})
    return {"launches": launches, "errs": errs, "k10_ms": k10_ms, "k10_bound_ms": k10_bound, "O": cloud.shape[0],
            "unproject_ms": un_ms, "unproject_bound_ms": un_bound}


def runtime_phases(ur5, panda, single, card: str) -> dict:
    """Phases 27-31, right after the build: before any long eager plain
    version, which left ``torch.profiler`` blind once (PR 4). Phase 30 is
    returned unbegun: its load process runs beside phase 7."""
    gen = torch.Generator(DEV).manual_seed(15)
    x0, goals = panda_problem(gen, panda, B_MPC)
    mpc = build_batch_tracking_mpc(panda, goals, B_MPC, H_MPC, DT, iterations=ITERS)
    out = {"features": features_phase(card), "profile_trace": profile_trace_phase(mpc, x0, card),
           "checkpoint": checkpoint_phase(panda, goals, x0, card),
           "aot": lambda: aot_phase(mpc, single, panda, x0)}  # begun before phase 7
    out["perception"] = perception_plan_phase(ur5, gen, card)
    return out


def runtime_records(records: list, runtime: dict) -> None:
    """Add each kernel's launches and errors in phases 27-31 to its record."""
    per = runtime["perception"]
    by_name = {rec["name"]: rec for rec in records}
    k1 = records[0]
    k1["runtime_phases"] = {"test_installation_launches": runtime["features"]["test_installation_launches"],
                            "perception_plan_launches": per["launches"]["rollout"],
                            "perception_plan_max_abs_err_per_output": per["errs"]["K1"]}
    k1["max_abs_err"] = max(k1["max_abs_err"], *per["errs"]["K1"].values())
    k2_route = next(r["route_form"] for r in records if r["name"] == K2_NAMES["emitted"])
    for stage, (name, _) in MPC_KERNELS.items():
        name = K2_NAMES[k2_route] if stage == "linearize" else name
        launches = runtime["checkpoint"]["launches"][stage]
        if stage == "linesearch":
            launches += runtime["checkpoint"]["launches"]["linesearch_costs"]
        by_name[name]["runtime_phases"] = {"checkpoint_resume_launches_2_solves": launches,
                                           "profile_trace_device_ms": runtime["profile_trace"]["trace"][name[:2]]["device_ms"],
                                           "aot_loaded_solve": "bitwise"}
    for stage, (name, _, _) in SINGLE_KERNELS.items():
        by_name[name]["runtime_phases"] = {"aot_loaded_solve": "bitwise"}
    for key, prefix in (("K9", "K9 "), ("K10", "K10 ")):
        rec = next(r for r in records if r["name"].startswith(prefix))
        rec["runtime_phases"] = {"perception_plan_launches": per["launches"]["trajectory" if key == "K9" else "potential"],
                                 "perception_plan_errs": per["errs"][key]}
        rec["max_abs_err"] = max(rec["max_abs_err"], *per["errs"][key].values())
    k10 = next(r for r in records if r["name"].startswith("K10 "))
    k10["runtime_phases"].update(perceived_obstacles=per["O"], perceived_ms=per["k10_ms"],
                                 perceived_bound_ms=per["k10_bound_ms"])


# ---------------------------------------------------------------------------
# The calibrated fleet (phase 32)
# ---------------------------------------------------------------------------


def fleet_keys() -> list:
    """The fleet benchmark's robots (fleet_benchmark.py:185-197): the first
    key of each URDF in ``robot_data.list_robots()``."""
    seen, keys = set(), []
    for key in robot_data.list_robots():
        urdf = robot_data.ROBOT_DATABASE[key].urdf
        if urdf not in seen:
            seen.add(urdf)
            keys.append(key)
    return keys


def fleet_draws(models: dict) -> dict:
    """fleet_benchmark.py:67-81, one ``default_rng(0)`` drawn in the
    fleet's order: the limits without inf, clipped to +-pi; goals mid +-
    0.3 half, q0 mid +- 0.2 half, at rest. label -> (x0 (B, 2n), goals
    (B, n)), float32 on the card."""
    rng = np.random.default_rng(0)
    out = {}
    for label, model in models.items():
        host = host_arrays(model)
        lo = np.clip(np.nan_to_num(host["joint_lower"], neginf=-np.pi, posinf=np.pi), -np.pi, np.pi)
        hi = np.clip(np.nan_to_num(host["joint_upper"], neginf=-np.pi, posinf=np.pi), -np.pi, np.pi)
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        n = model.num_joints
        goals = (mid + rng.uniform(-0.3, 0.3, (B_MPC, n)) * half).astype(np.float32)
        q0 = (mid + rng.uniform(-0.2, 0.2, (B_MPC, n)) * half).astype(np.float32)
        x0 = np.concatenate([q0, np.zeros_like(q0)], axis=1)
        out[label] = tuple(torch.from_numpy(a).to(DEV).contiguous() for a in (x0, goals))
    return out


def fleet_setup(pool: UnitPool) -> dict:
    """Phase 32's models, problem, solvers and units, made at phase 2: the
    units go into the pool behind phase 2's and build while phases 27-31
    and 3-26 run. K1 in both forms for the 25 chains (the emitted unit a
    robot, the looped one a joint count), K2-K5 for all 26 models and K2 in
    the form their route did not take, K4 and K5 likewise, K6-K8 for the two
    of FLEET_SINGLE."""
    t0 = time.perf_counter()
    models = {key: robot_data.load_robot(key, chain_joints_only=True) for key in fleet_keys()}
    # K4 and K5 in the form their route did not take: the looped units are
    # one a joint count, the emitted ones a robot's.
    models[f"{FLEET_FULL} (10 joints)"] = robot_data.load_robot(FLEET_FULL)
    problem = fleet_draws(models)
    handles = {label: build_batch_tracking_mpc(m, problem[label][1], B_MPC, H_MPC, DT, iterations=ITERS,
                                               line_search_steps=ALPHAS) for label, m in models.items()}
    singles = {key: build_tracking_mpc(models[key], problem[key][1][0], H_MPC, DT, iterations=ITERS,
                                       line_search_steps=ALPHAS) for key in FLEET_SINGLE}
    k2_other = {label: lin_only(models[label], OTHER_FORM[h.kernels.form]) for label, h in handles.items()}
    fwd_other = {label: fwd_only(h.kernels, models[label], OTHER_FORM[h.kernels.fwd_form]) for label, h in handles.items()}
    chains = [label for label in models if label in fleet_keys()]
    k1 = {label: {form: CudaRollout(models[label], DT, _form=form) for form in FORMS} for label in chains}
    # K8 alone in both forms on the fleet robots of K8_ROBOTS (the
    # programmatic Panda's are phase 2's): the looped units are one a joint
    # count, the emitted ones a robot's.
    k8 = {label: {f: k8_only(singles[label].kernels if label in singles else handles[label].kernels, models[label], f)
                  for f in FWD_FORMS} for label in K8_ROBOTS if label in models}
    units = {**{("K1", label, form): e for label, forms in k1.items() for form, e in forms.items()},
             **{("K2-K5", label): h.kernels for label, h in handles.items()},
             **{("K2", label): k for label, k in k2_other.items()},
             **{("K4K5", label): k for label, k in fwd_other.items()},
             **{("K6-K8", key): s.kernels for key, s in singles.items()},
             **{("K8", label, f): k for label, forms in k8.items() for f, k in forms.items()}}
    emit_s = time.perf_counter() - t0
    t_submit = time.perf_counter()
    futures = pool.submit(units)
    return {"models": models, "problem": problem, "handles": handles, "singles": singles, "chains": chains,
            "k1": k1, "k2_other": k2_other, "fwd_other": fwd_other, "k8": k8, "futures": futures,
            "t_submit": t_submit, "emit_s": emit_s}


def fleet_jax_costs() -> dict:
    """Per robot, the mean cost ``benchmarks/fleet_results.json`` records
    (the JAX package's solve of the same problem; its speeds are another
    device's and are not read) and whether its draws were this run's: the
    stream of default_rng(0) reached the robot at the same place (that
    run's order put the Panda, then keyed franka_panda, before the Gen3)."""
    try:
        with open(FLEET_RESULTS) as f:
            rows = json.load(f)["robots"]
    except (OSError, KeyError, ValueError):
        return {}
    key = lambda k: "panda" if k == "franka_panda" else k
    theirs, at = {}, 0
    for k, row in rows.items():
        theirs[key(k)] = at
        at += 2 * row.get("batch", B_MPC) * row.get("n_joints", 0)
    ours, at = {}, 0
    for k in fleet_keys():
        ours[k] = at
        at += 2 * B_MPC * robot_data.load_robot(k, chain_joints_only=True).num_joints
    return {key(k): {"mean_cost": row.get("mean_cost"), "same_draws": theirs[key(k)] == ours.get(key(k))}
            for k, row in rows.items()}


def fleet_stage_records(label: str, r: dict) -> list:
    """One record per K2-K5 kernel of one fleet robot (``fleet_robot``'s
    result)."""
    K, attrs = r["K"], r["attrs"]
    bo = stage_bytes_ops(K, B_MPC, H_MPC, ALPHAS)
    unit_of = {s: u for u, stages in K.UNITS.items() for s in stages}
    records = []
    for stage in FLEET_STAGES:
        name, replaces = MPC_KERNELS[stage]
        b_ms, b_by = bound(*bo[stage])
        source = MPC_SOURCE
        if stage == "linearize":  # the route's form, the other's figures inside
            name, source = K2_NAMES[K.form], K2_SOURCES[K.form]
        rec = {"name": f"{name} [{label}]", "route": "cuda", "source": source, "replaces": replaces,
               "launches": r["launches"][stage], "max_abs_err": r["errs"][stage],
               "tolerance": "0" if stage in BITWISE_STAGES else f"{MPC_RTOL} x max|plain|",
               "ms": r["ms"][stage], "plain_ms": r["plain_ms"][stage], "plain_scope": r["scope"][stage],
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "robot": label, "joints": K.n,
               "statements": K.statements[stage], "num_regs": attrs[stage]["num_regs"],
               "local_bytes": attrs[stage]["local_bytes"], "smem_bytes": attrs[stage]["smem_bytes"],
               "nvcc_seconds": r["nvcc_s"][unit_of[stage]], "solve_ms": r["solve_ms"]}
        if stage == "linearize":
            k2 = r["k2"]
            rec.update(route_form=K.form, thread_statements=K.statements["linearize_group"],
                       **{k: k2[K.form][k] for k in ("seeds_per_thread", "blocks_per_sm", "sass_instructions",
                                                    "loop_ops")},
                       ms_turns=k2[K.form]["ms_turns"], max_abs_err=max(k2[f]["max_abs_err"] for f in LIN_FORMS),
                       other_form={k: v for k, v in k2[OTHER_FORM[K.form]].items()})
        if stage in ("linesearch", "replay"):  # the route's form, the other's figures inside
            k45, form = r["k45"], K.fwd_form
            other = OTHER_FORM[form]
            rec.update(name=f"{FWD_NAMES[stage][form]} [{label}]", fwd_form=form, ms_turns=k45[form]["ms_turns"][stage],
                       blocks_per_sm=k45[form][stage]["blocks_per_sm"],
                       sass_instructions=k45[form][stage]["sass_instructions"], loop_ops=k45[form]["loop_ops"],
                       solve_share_ms=k45[form]["solve_share_ms"],
                       other_form={"form": other, "ms": k45[other]["ms"][stage], "ms_turns": k45[other]["ms_turns"][stage],
                                   "solve_share_ms": k45[other]["solve_share_ms"], "loop_ops": k45[other]["loop_ops"],
                                   "max_abs_err": k45[other]["max_abs_err"], "plain_ms": k45[other]["plain_ms"],
                                   "nvcc_seconds": k45[other]["nvcc_seconds"], **k45[other][stage]})
            if form == "looped":
                rec.update(step_source=LOOP_SOURCE, loop_ops_bound_ms=bound(
                    0, k45[form]["loop_ops"] * H_MPC * B_MPC * (ALPHAS if stage == "linesearch" else 1))[0])
        if stage == "backward":
            rec.update(dynamic_smem_bytes=K.layout_bytes()["backward"])
        records.append(rec)
    return records


def fleet_held(us, xs, cost, ref_cost, u_lim) -> torch.Tensor:
    """Per scenario (B,): finite controls inside the torque limits, finite
    states, and a finite cost at most ``ref_cost``, the cost of the
    rollout the solve starts from. A scenario may fail this only where that
    rollout overflows f32 (the Jaco's fingers, grams under 2000 N m limits:
    JAX's solve of the Jaco chain reports an infinite mean cost): its
    replayed controls go NaN past the overflow (the zero gains times an
    infinite state), as JAX's do, and no alpha need bring it back."""
    inside = (torch.isfinite(us) & (us.abs() <= u_lim)).flatten(1).all(dim=1)
    return inside & torch.isfinite(xs).flatten(1).all(dim=1) & torch.isfinite(cost) & (cost <= ref_cost)


def fleet_robot(label: str, mpc, other, fwd_other, x0, goals, built: dict, card: str, jax_costs: dict,
                pending: list) -> dict:
    """One fleet robot through the batched solver: one solve and
    FLEET_ROUNDS receding rounds (launches 4/4/4/1 a solve); per scenario
    (``fleet_held``) finite outputs, |u| <= u_lim and a cost at most its
    zero-control cost (a round's: its warm start's), wherever that rollout
    is finite; the cost equal to it and every control +0.0 where the limits
    are 0; K2, K4 and K5 against their plain versions fed the solver's own controls, bit
    for bit (K4's and K5's plain version is one function, ``replay_plain``:
    one call over every alpha of every scenario and, as a last row, each
    scenario's own alpha computes both, over the first FIRST_STEPS_CHECKED
    steps); K3's inputs and outputs for its
    plain version, which runs once per joint count; CUDA-event medians.
    K2 in both forms (``other``: K2 alone in the form the route did not
    take), each bitwise its own plain version, timed in turns; K4 and K5
    likewise (``fwd_other``; ``k45_forms``, the looped form's check into
    ``pending``, one plain call a joint count later)."""
    t0 = time.perf_counter()
    K = mpc.kernels
    n, nx, B, H, A = K.n, K.nx, B_MPC, H_MPC, ALPHAS
    f32 = dict(dtype=torch.float32, device=DEV)
    zeros = lambda *shape: torch.zeros(shape, **f32)
    u_lim = torch.tensor(K.P.u_lim, **f32)
    x0_t, goal_t = x0.T.contiguous(), goals.T.contiguous()
    cost_zero = mpc.replay(x0_t, zeros(H, nx, B), zeros(H, n, B), zeros(H, n, 1 + nx, B), goal_t, zeros(B))[2]
    BatchMPCKernels.reset_launch_count()
    us, xs, cost = mpc.solve(x0, zeros(B, H, n))
    torch.cuda.synchronize()
    per_solve = dict(BatchMPCKernels.launch_count)
    expected = {"linearize": ITERS, "backward": ITERS, "linesearch_costs": 0, "linesearch": ITERS, "replay": 1}
    if per_solve != expected or BatchMPCKernels.lin_launches != {K.form: ITERS, OTHER_FORM[K.form]: 0} \
            or BatchMPCKernels.fwd_launches != {K.fwd_form: ITERS + 1, OTHER_FORM[K.fwd_form]: 0}:
        raise AssertionError(f"fleet {label}: launches per solve {per_solve}, K2's by form "
                             f"{BatchMPCKernels.lin_launches}, K4's and K5's {BatchMPCKernels.fwd_launches}, expected "
                             f"{expected}, K2 the route's {K.form}, K4 and K5 the route's {K.fwd_form}")
    if tuple(us.shape) != (B, H, n) or tuple(xs.shape) != (B, H + 1, nx) or tuple(cost.shape) != (B,):
        raise AssertionError(f"fleet {label}: shapes {tuple(us.shape)}, {tuple(xs.shape)}, {tuple(cost.shape)}")
    held = fleet_held(us, xs, cost, cost_zero, u_lim)
    if not bool((held | ~torch.isfinite(cost_zero)).all()):
        raise AssertionError(f"fleet {label}: a scenario whose zero-control rollout is finite has a non-finite "
                             "control, state or cost, a control past its limit, or a cost above it")
    overflow_solve = int((~held).sum())
    if label in FLEET_ZERO_U:
        plus_zero = torch.equal(us.view(torch.int32), torch.zeros_like(us).view(torch.int32))
        if not (torch.equal(cost, cost_zero) and plus_zero):
            raise AssertionError(f"fleet {label}: torque limits of 0, yet the controls are not all +0.0 "
                                 f"({plus_zero}) or the cost is not the zero-control cost")
    x, us_warm = xs[:, 1].contiguous(), torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    rounds = []
    for r in range(FLEET_ROUNDS):
        x_r, warm_r = x, us_warm
        _, us_warm, (us_r, xs_r, cost_r) = batch_mpc_step(mpc, x, us_warm)
        rounds.append((x_r, warm_r, us_r, xs_r, cost_r))
        x = xs_r[:, 1].contiguous()
    torch.cuda.synchronize()
    launches = dict(BatchMPCKernels.launch_count)
    if launches != {k: (1 + FLEET_ROUNDS) * v for k, v in per_solve.items()}:
        raise AssertionError(f"fleet {label}: launches over {1 + FLEET_ROUNDS} solves {launches}")
    launches["linesearch"] += launches["linesearch_costs"]
    # Each round against its warm start's own rollout, the solve's first
    # (K5 again, after the launches were read), as the solve against the
    # zero-control rollout.
    overflow = 0
    for r, (x_r, warm_r, us_r, xs_r, cost_r) in enumerate(rounds):
        warm_cost = mpc.replay(x_r.T.contiguous(), zeros(H, nx, B), warm_r.permute(1, 2, 0).contiguous(),
                               zeros(H, n, 1 + nx, B), goal_t, zeros(B))[2]
        held = fleet_held(us_r, xs_r, cost_r, warm_cost, u_lim)
        if not bool((held | ~torch.isfinite(warm_cost)).all()):
            raise AssertionError(f"fleet {label} round {r}: a scenario whose warm start's rollout is finite has "
                                 "a non-finite control, state or cost, a control past its limit, or a cost above it")
        overflow += int((~held).sum())

    # The stages on the solver's own controls: K2 and K4 + K5 against their
    # plain versions here, K3's plain version later (once per joint count).
    _, args, _ = mpc_stage_parity(K, x0, goals, us.permute(1, 2, 0).contiguous(), f"fleet {label}", False,
                                  check=False)
    errs, plain_ms, scope = {}, {}, {}
    k2 = k2_forms(f"fleet {label}", {K.form: K, other.form: other}, args["linearize"])
    errs["linearize"], plain_ms["linearize"] = k2[K.form]["max_abs_err"], k2[K.form]["plain_ms"]
    scope["linearize"] = "this robot"
    # K4 and K5 in both forms over the first FIRST_STEPS_CHECKED steps (a
    # replay is causal): their trajectories at full horizon, their costs
    # from a launch on those steps alone, against one plain call on them
    # (A + 1 rows: K4's alphas, K5's own), the looped form's once a joint
    # count (``fwd_looped_plain_grouped``).
    ls, rep, k = args["linesearch"], args["replay"], FIRST_STEPS_CHECKED
    k45 = k45_forms(f"fleet {label}", {K.fwd_form: K, fwd_other.fwd_form: fwd_other}, ls, rep, k, pending=pending)
    if errs["linearize"] != 0.0:
        raise AssertionError(f"fleet {label} linearize: max |d| = {errs['linearize']}, not 0")
    if label in FLEET_ZERO_U:
        for Kf in (K, fwd_other):
            us_all_k = Kf.linesearch(*ls)[2]
            if not torch.equal(us_all_k.view(torch.int32), torch.zeros_like(us_all_k).view(torch.int32)):
                raise AssertionError(f"fleet {label}: K4 {Kf.fwd_form} has an alpha's control that is not +0.0")
    kK = K.backward(*args["backward"])

    ms = {s: time_ms(lambda s=s: getattr(K, s)(*args[s])) for s in FLEET_STAGES}
    solve_ms = time_ms(lambda: mpc.solve(x0, zeros(B, H, n)))
    attrs = K.kernel_attributes()
    nvcc_s = {u: b.compile_seconds for u, b in built[("K2-K5", label)].items()}
    jax = jax_costs.get(label, {})  # none for the fully actuated Jaco
    phase("fleet", card=repr(card), robot=label, joints=n, B=B, H=H, iterations=ITERS, alphas=A,
          launches_per_solve=json.dumps(per_solve).replace(" ", ""),
          launches_run=json.dumps({k: v for k, v in launches.items() if k != "linesearch_costs"}).replace(" ", ""),
          **{f"max_abs_err_{s}": f"{v:.3e}" for s, v in errs.items()},
          **{f"max_abs_err_k45_{f}": f"{max(k45[f]['max_abs_err'].values()):.3e}" for f in FWD_FORMS
             if "max_abs_err" in k45[f]}, finite=True,
          overflowing_scenarios=overflow_solve, round_overflowing_scenarios=overflow,
          cost_le_zero_control=True, zero_u_lim=label in FLEET_ZERO_U,
          mean_cost=f"{float(cost.mean()):.6e}", mean_zero_control_cost=f"{float(cost_zero.mean()):.6e}",
          jax_mean_cost=jax.get("mean_cost", "none"), jax_same_draws=jax.get("same_draws", "none"),
          solve_ms=f"{solve_ms:.4f}", **{f"{s}_ms": f"{v:.4f}" for s, v in ms.items()},
          step_statements=K.statements["step"], k2_route=K.form, **k2_fields(k2),
          fwd_statements=K.statements["replay"], k45_route=K.fwd_form, **{f"k45_{k}": v for k, v in k45_fields(k45).items()},
          **{f"{s}_regs": attrs[s]["num_regs"] for s in FLEET_STAGES},
          **{f"{s}_local_bytes": attrs[s]["local_bytes"] for s in FLEET_STAGES},
          backward_dynamic_smem_bytes=K.layout_bytes()["backward"],
          phase_s=f"{time.perf_counter() - t0:.2f}")
    return {"K": K, "k2": k2, "k45": k45, "errs": errs, "ms": ms, "plain_ms": plain_ms, "scope": scope, "attrs": attrs,
            "nvcc_s": nvcc_s,
            "launches": launches, "solve_ms": solve_ms, "bwd_args": args["backward"], "kK": kK, "n": n,
            "mean_cost": float(cost.mean()), "solve": lambda: mpc.solve(x0, zeros(B, H, n))}


def compare_nan(got: torch.Tensor, ref: torch.Tensor, label: str) -> float:
    """K3's gate where a scenario's inputs went NaN: NaN and infinities
    where the plain version has them, and over the entries both hold finite
    max |d| within MPC_RTOL of their largest magnitude; returns that max."""
    if not (torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.equal(torch.isinf(got), torch.isinf(ref))):
        raise AssertionError(f"{label}: NaN or infinities where the plain version has none")
    both = torch.isfinite(ref)
    err, scale = float((got - ref)[both].abs().max()), float(ref[both].abs().max())
    if not err <= MPC_RTOL * scale:
        raise AssertionError(f"{label}: max |d| = {err} exceeds {MPC_RTOL} x {scale}")
    return err


def fleet_backward_plain(robots: dict) -> None:
    """K3 against its plain version on every fleet robot, within MPC_RTOL of
    each output's scale. The plain Riccati sweep reads the robot only
    through its Jacobians (inputs) and the cost weights, the same for the
    whole fleet, so one call per joint count serves every robot of it: the
    robots' inputs side by side along the scenario axis (an elementwise
    function, so each scenario's bits are those of a call of its own), over
    the sweep's last RICCATI_STEPS_CHECKED steps (the kernel's at full
    horizon: those rows need no earlier step)."""
    groups, k = {}, RICCATI_STEPS_CHECKED
    for label, r in robots.items():
        groups.setdefault(r["n"], []).append(label)
    for n, labels in sorted(groups.items()):
        Ks = [robots[label]["K"] for label in labels]
        weights = {(tuple(K.P.w_x), K.P.w_u, tuple(K.P.wT)) for K in Ks}
        if len(weights) != 1:
            raise AssertionError(f"fleet K3 n={n}: the robots' cost weights differ ({len(weights)})")
        cat = [torch.cat([robots[label]["bwd_args"][i] for label in labels], dim=-1).contiguous() for i in range(6)]
        cat = [x[-k:].contiguous() for x in cat[:3]] + cat[3:]  # AB, xs, us by step; x_last, goal, reg
        ref, ms = timed(lambda: Ks[0].backward_plain(*cat))
        for j, label in enumerate(labels):
            part = ref[..., j * B_MPC:(j + 1) * B_MPC]
            err = compare_nan(robots[label]["kK"][-k:], part, f"fleet {label} backward")
            robots[label]["errs"]["backward"] = err
            robots[label]["plain_ms"]["backward"] = ms
            robots[label]["scope"]["backward"] = (f"one backward_plain call for the {len(labels)} robots of {n} joints, "
                                                  f"the last {k} steps")
        phase("fleet_backward_plain", joints=n, robots=",".join(labels), scenarios=len(labels) * B_MPC, steps=k,
              plain_ms=f"{ms:.1f}", max_abs_err=f"{max(robots[l]['errs']['backward'] for l in labels):.3e}")


def fleet_rollout(fleet: dict, urdf_rollout: dict, card: str) -> list:
    """K1 on each of the 25 chains at the rollout's shape in both forms
    (``k1_forms``: the public route's one launch, each form bitwise its
    plain version on the first ROWS_CHECKED rows and FIRST_STEPS_CHECKED steps, the looped one once per
    joint count, both timed in turns). Phase 25's three robots are the
    same models (their digests) and are not run twice. One record per
    chain, of its route's form, the other form's figures inside it."""
    gen = torch.Generator(DEV).manual_seed(32)
    results, pending = {}, []
    for label in fleet["chains"]:
        if label in urdf_rollout:
            results[label] = dict(urdf_rollout[label], reused="phase 25")
        else:
            results[label] = k1_forms(label, fleet["models"][label], fleet["k1"][label], gen, card, "fleet_rollout",
                                      pending)
            results[label].pop("outputs")
    looped_plain_grouped(pending, results)
    records, slack_misses, looped = [], [], []
    for label, r in results.items():
        if not r["route_within_slack"]:
            slack_misses.append(label)
        form = r["route_form"]
        other = "looped" if form == "emitted" else "emitted"
        if form == "looped":
            looped.append(label)
        nvcc = {f: fleet["built"][("K1", label, f)]["rollout"].compile_seconds for f in FORMS}
        rec = {k: v for k, v in r.items() if k not in FORMS}
        rec.update(r[form], launches=r["launches"][form], nvcc_seconds=nvcc[form],
                   other_form={"form": other, **r[other], "nvcc_seconds": nvcc[other]})
        records.append({"name": f"{K1_NAMES[form]} [{label}]", "route": "cuda", "source": K1_SOURCES[form],
                        "replaces": "manipulapy_tpu/ops/pallas_rollout.py:219", "tolerance": "0 (first rows)",
                        "library_ms": None, "robot": label,
                        "plain_scope": f"the first {ROWS_CHECKED} rows, {FIRST_STEPS_CHECKED} steps", **rec})
    phase("fleet_rollout_route", robots=len(fleet["chains"]), slack=ROUTE_SLACK, looped=",".join(looped) or "none",
          outside_slack=",".join(slack_misses) or "none")
    return records


def fleet_single(fleet: dict, card: str) -> list:
    """K6-K8 on the narrowest and the widest chain: one solve from the
    fleet's first scenario (H=50, 4 iterations, 6 alphas; launches
    4/4/5), finite, |u| <= u_lim, the cost at most the zero-control cost;
    each stage against its plain version on the solver's own controls, bit
    for bit; a launch's device time and the solve's (CUDA events)."""
    records = []
    for key in FLEET_SINGLE:
        t0 = time.perf_counter()
        single, S = fleet["singles"][key], fleet["singles"][key].kernels
        n, nx, H = S.n, S.nx, H_MPC
        f32 = dict(dtype=torch.float32, device=DEV)
        x0, goal = fleet["problem"][key][0][0].contiguous(), fleet["problem"][key][1][0].contiguous()
        u_lim = torch.tensor(S.P.u_lim, **f32)
        cost_zero = single.forward(x0, torch.zeros((H, nx), **f32), torch.zeros((H, n), **f32),
                                   torch.zeros((H, n, 1 + nx), **f32), goal, torch.zeros((1,), **f32))[2][0]
        SingleMPCKernels.reset_launch_count()
        us, xs, cost = single.solve(x0, torch.zeros((H, n), **f32))
        torch.cuda.synchronize()
        launches = dict(SingleMPCKernels.launch_count)
        k8_launches = dict(SingleMPCKernels.forward_launches)
        if launches != {"linearize": ITERS, "backward": ITERS, "forward": ITERS + 1} \
                or k8_launches != {S.fwd_form: ITERS + 1, OTHER_FORM[S.fwd_form]: 0}:
            raise AssertionError(f"fleet single {key}: launches {launches}, K8's by form {k8_launches}")
        if not all(bool(torch.isfinite(v).all()) for v in (us, xs, cost)) or not bool((us.abs() <= u_lim).all()):
            raise AssertionError(f"fleet single {key}: non-finite outputs or a control past its limit")
        if not float(cost) <= float(cost_zero):
            raise AssertionError(f"fleet single {key}: cost {float(cost)} above the zero-control {float(cost_zero)}")
        errs, args, plain_ms = single_stage_parity(S, x0, goal, us.contiguous(), f"fleet single {key}", 1,
                                                   riccati_last=RICCATI_STEPS_CHECKED, first=FIRST_STEPS_CHECKED)
        for stage, v in errs.items():
            if v != 0.0:
                raise AssertionError(f"fleet single {key} {stage}: max |d| = {v}, not 0")
        ms = {s: per_call_ms(lambda s=s: getattr(S, s)(*args[s])) for s in SINGLE_KERNELS}
        solve_ms = time_ms(lambda: single.solve(x0, torch.zeros((H, n), **f32)))
        attrs, bo = S.kernel_attributes(), single_bytes_ops(S, H, ALPHAS)
        phase("fleet_single", card=repr(card), robot=key, joints=n, H=H, iterations=ITERS, alphas=ALPHAS,
              launches_per_solve=json.dumps(launches).replace(" ", ""), k8_form=S.fwd_form,
              k8_launches_by_form=json.dumps(k8_launches).replace(" ", ""), cost=f"{float(cost):.6e}",
              zero_control_cost=f"{float(cost_zero):.6e}", **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
              **{f"{s}_ms": f"{v:.4f}" for s, v in ms.items()}, solve_ms=f"{solve_ms:.4f}",
              **{f"{s}_plain_ms": f"{v:.1f}" for s, v in plain_ms.items()},
              phase_s=f"{time.perf_counter() - t0:.2f}")
        for stage, (name, replaces, _) in SINGLE_KERNELS.items():
            b_ms, b_by = bound(*bo[stage])
            source = SINGLE_SOURCE
            if stage == "forward":  # the route's form, its launches the public solve's
                name, source = K8_NAMES[S.fwd_form], K8_SOURCES[S.fwd_form]
            records.append({"name": f"{name} [{key}]", "route": "cuda", "source": source, "replaces": replaces,
                            "launches": launches[stage], "max_abs_err": errs[stage], "tolerance": "0",
                            "ms": ms[stage], "plain_ms": plain_ms[stage], "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "robot": key, "joints": n, "solve_ms": solve_ms,
                            "plain_scope": {"backward": f"the last {RICCATI_STEPS_CHECKED} steps",
                                            "forward": f"the first {FIRST_STEPS_CHECKED} steps"}.get(stage, "H=50"),
                            "num_regs": attrs[stage]["num_regs"], "local_bytes": attrs[stage]["local_bytes"],
                            "smem_bytes": attrs[stage]["smem_bytes"]})
            if stage == "forward":
                records[-1].update(fwd_form=S.fwd_form, k8_public=True)
    return records


def fleet_k8(fleet: dict, robots: dict, card: str, pool: UnitPool) -> dict:
    """K8 in both forms on the fleet robots of K8_ROBOTS, on one
    problem each: the fleet's first scenario, its nominal and gains those
    of the batched solve (K3's on the solver's own controls), 6 alphas.
    Each form bitwise (NaN where it has NaN) its own plain version over
    the first FIRST_STEPS_CHECKED steps (trajectories of a launch at full
    horizon, costs of a launch on those steps), the looped form's plain
    version once per joint count with the robots side by side (a column a
    (robot, alpha), each with its robot's table); both forms timed in turns
    (``k8_turns``); registers, local and shared bytes, SASS. Returns label
    -> form -> figures."""
    k = FIRST_STEPS_CHECKED
    f32 = dict(dtype=torch.float32, device=DEV)
    alphas = 0.5 ** torch.arange(ALPHAS, **f32)
    with concurrent.futures.ThreadPoolExecutor(pool.workers) as sass_pool:
        list(sass_pool.map(sass_count, sorted({str(K.build()["fwd"].path)
                                               for forms in fleet["k8"].values() for K in forms.values()})))
    out, pending = {}, {}
    for label, Ks in fleet["k8"].items():
        t0 = time.perf_counter()
        r = robots[label]
        _, sd_x, us, _, goal, _ = r["bwd_args"]
        x0 = fleet["problem"][label][0][0].contiguous()
        ins = (x0, sd_x[..., 0].contiguous(), us[..., 0].contiguous(), r["kK"][..., 0].contiguous(),
               goal[:, 0].contiguous(), alphas)
        cut = (ins[0], *(x[:k].contiguous() for x in ins[1:4]), *ins[4:])
        out[label] = {f: k8_figures(K) for f, K in Ks.items()}
        for f, K in Ks.items():
            got = K.forward(*ins)
            got = (got[0][:, :k], got[1][:, :k], K.forward(*cut)[2])
            if f == "looped":
                pending.setdefault(K.n, []).append((label, K, cut, got))
                continue
            ref, ms_ = timed(lambda: K.plain().forward(*cut))
            err = max(bit_diff(g, rr) for g, rr in zip(got, ref))
            if err != 0.0:
                raise AssertionError(f"fleet {label}: K8 {f} against its plain version, max |d| = {err}, not 0")
            out[label][f].update(max_abs_err=err, plain_ms=ms_)
        for f, t in k8_turns(Ks, ins).items():
            out[label][f].update(t)
        out[label]["route"] = "emitted"  # the solver's K8 on every robot
        phase("fleet_k8", card=repr(card), robot=label, joints=Ks["emitted"].n, H=H_MPC, alphas=ALPHAS, route="emitted",
              fwd_statements=Ks["emitted"].statements["forward"],
              **{f"{f}_ms": ",".join(f"{t:.4f}" for t in out[label][f]["ms_turns"]) for f in FWD_FORMS},
              **{f"{f}_median_ms": f"{out[label][f]['ms']:.4f}" for f in FWD_FORMS},
              **{f"{f}_spread": f"{out[label][f]['spread']:.4f}" for f in FWD_FORMS},
              resolved=k8_resolved(out[label]),
              **{f"{f}_{key}": out[label][f][key] for f in FWD_FORMS
                 for key in ("num_regs", "local_bytes", "smem_bytes", "sass_instructions")},
              phase_s=f"{time.perf_counter() - t0:.2f}")
    for n, items in sorted(pending.items()):
        cols = ALPHAS
        tab = torch.cat([K.fwd_table[:, None].expand(-1, cols) for _, K, _, _ in items], dim=1).to(DEV)
        col = lambda x: x[..., None].expand(*x.shape, cols)
        ins = [torch.cat([col(c[i]) for _, _, c, _ in items], dim=-1).contiguous() for i in range(5)]
        ins.append(torch.cat([c[5] for _, _, c, _ in items]).contiguous())
        ref, plain_ms = timed(lambda: loop_forward_plain(tab, n, *ins))
        for at, (label, _, _, got) in enumerate(items):
            part = tuple(rr[at * cols:(at + 1) * cols] for rr in ref)
            err = max(bit_diff(g, rr) for g, rr in zip(got, part))
            if err != 0.0:
                raise AssertionError(f"fleet {label}: K8 looped against its plain version, max |d| = {err}, not 0")
            out[label]["looped"].update(max_abs_err=err, plain_ms=plain_ms,
                                        plain_scope=f"one loop_forward_plain call for the {len(items)} robots of {n} "
                                                    f"joints, the first {k} steps")
        phase("fleet_k8_looped_plain", joints=n, robots=",".join(i[0] for i in items), columns=len(items) * cols,
              steps=k, plain_ms=f"{plain_ms:.1f}", max_abs_err="0.000e+00")
    return out


def fleet_phase(fleet: dict, pool: UnitPool, urdf_rollout: dict, card: str) -> list:
    """Phase 32: the calibrated fleet through K1, K2-K5 and K6-K8; returns
    its kernels' records."""
    t0 = time.perf_counter()
    built, last = UnitPool.wait(fleet["futures"])
    fleet["built"] = built
    slowest = UnitPool.slowest(built)
    phase("fleet_build", cpu_count=os.cpu_count(), nvcc_workers=pool.workers, units=sum(len(u) for u in built.values()),
          wall_seconds=f"{last - fleet['t_submit']:.2f}", waited_s=f"{time.perf_counter() - t0:.2f}",
          emit_s=f"{fleet['emit_s']:.2f}", slowest_unit=repr(slowest[0]), slowest_seconds=f"{slowest[1]:.2f}")
    jax_costs = fleet_jax_costs()
    # Every K1 and K2 unit's SASS count at once (a cuobjdump each, in
    # parallel), before the robots read them one at a time.
    libs = {str(K.build()["lin"].path) for K in [h.kernels for h in fleet["handles"].values()]
            + list(fleet["k2_other"].values())}
    libs |= {str(e.build().path) for forms in fleet["k1"].values() for e in forms.values()}
    fwd_libs = {str(K.build()["fwd"].path) for K in [h.kernels for h in fleet["handles"].values()]
                + list(fleet["fwd_other"].values())}
    with concurrent.futures.ThreadPoolExecutor(pool.workers) as sass_pool:
        list(sass_pool.map(sass_count, sorted(libs)))
        list(sass_pool.map(sass_by_kernel, sorted(fwd_libs)))
    robots, pending = {}, []
    for label, mpc in fleet["handles"].items():
        x0, goals = fleet["problem"][label]
        robots[label] = fleet_robot(label, mpc, fleet["k2_other"][label], fleet["fwd_other"][label], x0, goals, built,
                                    card, jax_costs, pending)
    fwd_looped_plain_grouped(pending)
    for label, r in robots.items():  # K4's and K5's checks of the route's form, now complete
        f = r["k45"][r["K"].fwd_form]
        r["errs"]["linesearch"] = max(f["max_abs_err"]["linesearch"], f["max_abs_err"]["linesearch_costs"])
        r["errs"]["replay"] = f["max_abs_err"]["replay"]
        r["plain_ms"]["linesearch"] = r["plain_ms"]["replay"] = f["plain_ms"]
        r["scope"]["linesearch"] = r["scope"]["replay"] = f.get(
            "plain_scope", f"one replay_plain call of A + 1 rows (K4's alphas, K5's own) over the first "
                           f"{FIRST_STEPS_CHECKED} steps: the kernels' trajectories at H={H_MPC}, their costs at "
                           f"H={FIRST_STEPS_CHECKED}")
    fleet_backward_plain(robots)
    k2_misses = [label for label, r in robots.items()
                 if r["k2"][r["K"].form]["ms"] > ROUTE_SLACK * r["k2"][OTHER_FORM[r["K"].form]]["ms"]]
    phase("fleet_k2_route", robots=len(robots), slack=ROUTE_SLACK,
          looped=",".join(label for label, r in robots.items() if r["K"].form == "looped") or "none",
          outside_slack=",".join(k2_misses) or "none")
    # K4's and K5's route against the other form: 4 K4 + K5, a solve's share.
    fwd_misses = [label for label, r in robots.items()
                  if r["k45"][r["K"].fwd_form]["solve_share_ms"] > ROUTE_SLACK * r["k45"][OTHER_FORM[r["K"].fwd_form]][
                      "solve_share_ms"]]
    phase("fleet_fwd_route", robots=len(robots), slack=ROUTE_SLACK,
          looped=",".join(label for label, r in robots.items() if r["K"].fwd_form == "looped") or "none",
          outside_slack=",".join(fwd_misses) or "none")
    records = []
    for label, r in robots.items():
        records += fleet_stage_records(label, r)
    # The multiplexed round: the 25 chains' solves back to back, one
    # synchronization, against the sum of their own solves' times.
    solves = [robots[label]["solve"] for label in fleet["chains"]]
    round_ms = time_ms(lambda: [s() for s in solves])
    own_sum = sum(robots[label]["solve_ms"] for label in fleet["chains"])
    scenarios = len(solves) * B_MPC
    phase("fleet_multiplexed", card=repr(card), robots=len(solves), scenarios=scenarios, round_ms=f"{round_ms:.4f}",
          scenarios_per_s=f"{scenarios / (round_ms * 1e-3):.4e}", solves_sum_ms=f"{own_sum:.4f}",
          round_over_sum=f"{round_ms / own_sum:.4f}")
    for rec in records:
        rec.update(fleet_round_ms=round_ms, fleet_round_scenarios_per_s=scenarios / (round_ms * 1e-3))
    records = fleet_rollout(fleet, urdf_rollout, card) + records + fleet_single(fleet, card)
    fleet["k8_route"] = fleet_k8(fleet, robots, card, pool)
    phase("fleet_done", robots=len(robots), records=len(records), phase_s=f"{time.perf_counter() - t0:.2f}")
    return records


def k8_fleet_records(k8_records: dict, fleet_records: list, fleet_k8_route: dict, panda_route: str) -> None:
    """K8's records by form completed from phase 32: the team's launches on
    FLEET_SINGLE's robots, each form's |d| on K8_ROBOTS (``fleet_k8``, and
    the programmatic Panda's of phases 10-12), a ``fleet_k8_route`` line
    naming the robots where the solver's form (the team's) is more than 5%
    slower than the looped one and those whose turns spread too far to
    tell (``k8_resolved``); fails if a form was launched no time."""
    for rec in fleet_records:
        if rec.get("k8_public"):
            k8_records[rec["fwd_form"]]["launches"] += rec["launches"]
            k8_records[rec["fwd_form"]].setdefault("fleet_robots", []).append(rec["robot"])
            k8_records[rec["fwd_form"]]["max_abs_err"] = max(k8_records[rec["fwd_form"]]["max_abs_err"],
                                                             rec["max_abs_err"])
    k8_route = {**fleet_k8_route, "panda (programmatic)": {
        **{f: {k: r[k] for k in ("ms", "ms_turns", "spread", "max_abs_err")} for f, r in k8_records.items()},
        "route": panda_route}}
    for label, forms in k8_route.items():
        for f in FWD_FORMS:
            k8_records[f]["max_abs_err"] = max(k8_records[f]["max_abs_err"], forms[f]["max_abs_err"])
            k8_records[f].setdefault("route_robots", {})[label] = {
                "route": forms["route"], **{k: forms[f][k] for k in ("ms", "ms_turns", "spread", "max_abs_err")},
                **{k: forms[f][k] for k in ("num_regs", "local_bytes", "smem_bytes", "sass_instructions", "plain_scope")
                   if k in forms[f]}}
    unresolved = [label for label, forms in k8_route.items() if not k8_resolved(forms)]
    k8_misses = [label for label, forms in k8_route.items() if label not in unresolved
                 and forms[forms["route"]]["ms"] > ROUTE_SLACK * forms[OTHER_FORM[forms["route"]]]["ms"]]
    phase("fleet_k8_route", robots=len(k8_route), slack=ROUTE_SLACK,
          looped=",".join(label for label, forms in k8_route.items() if forms["route"] == "looped") or "none",
          outside_slack=",".join(k8_misses) or "none", unresolved=",".join(unresolved) or "none",
          looped_over_team=json.dumps({label: round(forms["looped"]["ms"] / forms["emitted"]["ms"], 4)
                                       for label, forms in k8_route.items()}).replace(" ", ""))
    if any(rec["launches"] < 1 for rec in k8_records.values()):
        raise AssertionError(f"a K8 form was launched no time: {[(f, r['launches']) for f, r in k8_records.items()]}")


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
        "ur5 looped": build_cuda_rollout(ur5, dt=DT, _form="looped"),  # phase 6's looped K1
        "panda looped": build_cuda_rollout(panda, dt=DT, _form="looped"),
    }
    robots = urdf_robots()  # phases 24-26: their units join this build
    engines.update({f"urdf {name} {form}": build_cuda_rollout(robots[name], dt=DT, _form=form)
                    for name in URDF_ROLLOUT for form in FORMS})
    mpc_panda = build_batch_tracking_mpc(panda, np.zeros(7), B_MPC, H_MPC, DT, iterations=ITERS)
    single = build_tracking_mpc(panda, Q_GOAL7, H_MPC, DT, iterations=ITERS, line_search_steps=ALPHAS)
    K_panda = mpc_panda.kernels
    k4_blocks = {threads: type("K4Block", (BatchMPCKernels,), {
        "UNITS": {"fwd": BatchMPCKernels.UNITS["fwd"]}, "DEFINES": {**BatchMPCKernels.DEFINES, "MPT_BLOCK": threads}})(
        panda, DT, w_q=K_panda.P.w_q, w_dq=K_panda.P.w_dq, w_u=K_panda.P.w_u, w_terminal=K_panda.P.wT[0],
        u_lim=K_panda.P.u_lim) for threads in K4_BLOCKS}
    mpc_kernels = {"panda": K_panda, "ur5": build_batch_tracking_mpc(ur5, np.zeros(6), 1, H_MPC, DT).kernels,
                   "panda single": single.kernels, **{f"panda K4 T{t}": V for t, V in k4_blocks.items()},
                   "urdf panda arm": build_batch_tracking_mpc(robots["panda_arm"], np.zeros(7), 1, H_MPC, DT).kernels}
    # K2 alone in each form, for phases 7 and 9 (the route's shares its unit).
    k2_sets = {robot: {f: lin_only(model, f) for f in LIN_FORMS} for robot, model in (("panda", panda), ("ur5", ur5))}
    mpc_kernels.update({f"{robot} K2 {f}": k for robot, forms in k2_sets.items() for f, k in forms.items()})
    # K4 and K5 alone in each form, for phases 7 and 9 (the route's shares its unit).
    fwd_sets = {robot: {f: fwd_only(mpc_kernels[robot], model, f) for f in FWD_FORMS}
                for robot, model in (("panda", panda), ("ur5", ur5))}
    mpc_kernels.update({f"{robot} K4K5 {f}": k for robot, forms in fwd_sets.items() for f, k in forms.items()})
    # K8 alone in each form, for phases 10 and 12 (the route's shares its unit).
    k8_sets = {f: k8_only(single.kernels, panda, f) for f in FWD_FORMS}
    mpc_kernels.update({f"panda K8 {f}": k for f, k in k8_sets.items()})
    # Phase 32's units queue behind phase 2's in the same pool and build
    # while phases 27-31 and 3-26 run.
    pool = UnitPool()
    built, build_wall, fleet = build_all(pool, engines, mpc_kernels, ew.kernels(), lambda: fleet_setup(pool))
    attrs = {}
    for name, eng in engines.items():
        b = built["rollout", name]
        a = attrs[name] = eng.kernel_attributes()
        phase("build", kernel="K1 rollout", robot=name, form=eng.form, block=BLOCK, chunk=CHUNK,
              seconds=f"{b.compile_seconds:.2f}", **a, ptxas=repr(ptxas_lines(b.log)))
        # The tiles live in dynamic shared memory and may cost no block an
        # SM; no more local bytes than sinf/cosf's 32-byte frame. The URDF
        # robots' units (phase 25) are reported, not held to the textbook
        # arms' figures: their steps are up to 2.1x the UR5's statements.
        if not name.startswith("urdf") and (
                a["local_bytes"] > 32 or a["blocks_per_sm"] != a["blocks_per_sm_without_tiles"]):
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
            extra, name = {}, names[stage][0]
            if isinstance(K, SingleMPCKernels) and stage == "forward":
                name = K8_NAMES[K.fwd_form]
            if isinstance(K, BatchMPCKernels) and stage == "linearize":
                looped = K.form == "looped"
                name = K2_NAMES[K.form]
                extra = {"form": K.form, "seeds_per_thread": K.LIN_LOOP_SEEDS if looped else K.LIN_SEEDS,
                         "thread_statements": K.statements["linearize_group"],
                         "block": LIN_BLOCK,
                         "loop_ops": K.loop_ops["total"] if looped else None}
            if isinstance(K, BatchMPCKernels) and stage == "backward":
                extra = {"dynamic_smem_bytes": K.layout_bytes()["backward"]}
            if isinstance(K, BatchMPCKernels) and stage in K45_STAGES:
                extra = {"form": K.fwd_form, "loop_ops": K.fwd_loop_ops}
                name = FWD_NAMES.get(stage, {}).get(K.fwd_form, name)
            phase("build", kernel=name, robot=robot, statements=K.statements[stage], **extra, **a)
        if robot == "panda single":
            phase("build", kernel=names["linearize"][0], robot=robot, **lin_figures(K, built["mpc", robot]))
        if robot.startswith("panda K8"):
            fig = k8_figures(K)
            phase("build", kernel=K8_NAMES[K.fwd_form], robot=robot, route=single.kernels.fwd_form,
                  **{k: json.dumps(v).replace(" ", "") if isinstance(v, dict) else v for k, v in fig.items()})
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
    slowest = UnitPool.slowest({k: (v if isinstance(v, dict) else {"rollout": v}) for k, v in built.items()})
    phase("build", wall_seconds=f"{build_wall:.2f}", units=len(engines) + 1 + sum(len(b) for k, b in built.items() if k[0] == "mpc"),
          cpu_count=os.cpu_count(), nvcc_workers=pool.workers, slowest_unit=repr(slowest[0]),
          slowest_seconds=f"{slowest[1]:.2f}")

    # 27-31. The runtime layer, on the units just built, before any long
    # eager plain version.
    runtime = runtime_phases(ur5, panda, single, card)

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

    # 6. Rollout time: kernel vs plain version at the main path's shape (the
    # plain version one call a turn: it is host-bound, ~3 s a call).
    kernel = engines["ur5"]
    plain = build_rollout(ur5, dt=DT)
    plain_ms = timed(lambda: plain(q0, dq0, tau))[1]
    kernel_ms = time_ms(lambda: kernel(q0, dq0, tau))
    kernel_ms_2 = time_ms(lambda: kernel(q0, dq0, tau))
    plain_ms_2 = timed(lambda: plain(q0, dq0, tau))[1]
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
    looped_bench = looped_bench_phase(ur5, panda, engines, card)
    aot_started = runtime["aot"]()  # 30: its load process runs beside phase 7's Panda cases

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
    # K2's other form (the route's is K's) on the same inputs, bit for bit too.
    other = k2_sets["panda"][OTHER_FORM[K.form]]
    k2_err = dict.fromkeys(LIN_FORMS, 0.0)
    # K4's and K5's other form (the route's is K's) likewise: one plain call
    # over the A + 1 alphas.
    fwd_other = fwd_sets["panda"][OTHER_FORM[K.fwd_form]]
    fwd_err, fwd_plain_ms = dict.fromkeys(FWD_FORMS, 0.0), {}
    for nominal, x0_c, goals_c, us_c, full, reg in cases:
        B, H = us_c.shape[2], us_c.shape[0]
        errs, args, plain_ms = mpc_stage_parity(K, x0_c, goals_c, us_c, f"panda B={B} H={H} reg={reg}", full, reg=reg,
                                                riccati_last=RICCATI_STEPS_CHECKED if reg == REG_HEAVY else None)
        for stage in BITWISE_STAGES:  # K2, K4 and K5 do the plain version's operations in its order
            if errs[stage] != 0.0:
                raise AssertionError(f"panda B={B} H={H} {stage}: max |d| = {errs[stage]}, not 0")
        got = other.linearize(*args["linearize"])
        ref, other_plain_ms = timed(lambda: other.plain().linearize(*args["linearize"]))
        other_err = bit_diff(got, ref)
        if other_err != 0.0:
            raise AssertionError(f"panda B={B} H={H} K2 {other.form}: max |d| = {other_err}, not 0")
        k2_err = {K.form: max(k2_err[K.form], errs["linearize"]), other.form: max(k2_err[other.form], other_err)}
        ls_c, rep_c = args["linesearch"], args["replay"]
        got = k45_outputs(fwd_other, ls_c, rep_c)
        ref, other_fwd_ms = timed(lambda: fwd_other.plain().replay(*k45_plain_inputs(ls_c, rep_c)))
        other_fwd_err = max(k45_errs(got, ref).values())
        if other_fwd_err != 0.0:
            raise AssertionError(f"panda B={B} H={H} K4/K5 {fwd_other.fwd_form}: max |d| = {other_fwd_err}, not 0")
        fwd_err = {K.fwd_form: max(fwd_err[K.fwd_form], *(errs[s] for s in K45_STAGES)),
                   fwd_other.fwd_form: max(fwd_err[fwd_other.fwd_form], other_fwd_err)}
        if B == B_PARITY:
            small_args = args
        if full:
            stage_args, stage_plain_ms, stage_errs = args, plain_ms, errs
            k2_plain_ms = {K.form: plain_ms["linearize"], other.form: other_plain_ms}
            fwd_plain_ms = {K.fwd_form: plain_ms["linesearch"], fwd_other.fwd_form: other_fwd_ms}
        mpc_err = {k: max(mpc_err[k], errs[k]) for k in mpc_err}
        phase("mpc_parity", robot="panda", B=B, H=H, reg=reg, nominal=repr(nominal), k2_route_form=K.form,
              k45_route_form=K.fwd_form, **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
              **{f"max_abs_err_linearize_{other.form}": f"{other_err:.3e}"},
              **{f"max_abs_err_k45_{fwd_other.fwd_form}": f"{other_fwd_err:.3e}"})
    nan_errs = k45_nan_check(f"panda B={B_PARITY}", fwd_sets["panda"], small_args["linesearch"], small_args["replay"])
    fwd_err = {f: max(fwd_err[f], nan_errs[f]) for f in FWD_FORMS}
    phase("mpc_parity", robot="panda", B=B_PARITY, H=H_PARITY, nominal=repr("random torques, scenario 5's dq NaN"),
          **{f"max_abs_err_k45_{f}": f"{v:.3e}" for f, v in nan_errs.items()})
    runtime["aot"] = aot_result(aot_started, card)
    k2_ur5, k2_ur5_timing, fwd_ur5 = k2_ur5_phase(ur5, k2_sets["ur5"], fwd_sets["ur5"])
    k2_err = {f: max([k2_err[f]] + [e[f] for e in k2_ur5.values()]) for f in LIN_FORMS}
    fwd_err = {f: max([fwd_err[f]] + [e[f] for k, e in fwd_ur5.items() if k != "timing"]) for f in FWD_FORMS}

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
    k2_form = mpc.kernels.form  # the route's
    k2_per_solve = dict(BatchMPCKernels.lin_launches)
    if k2_per_solve != {k2_form: ITERS, OTHER_FORM[k2_form]: 0}:
        raise AssertionError(f"K2 launches per solve by form {k2_per_solve}, expected {ITERS} of the route's {k2_form}")
    fwd_route = mpc.kernels.fwd_form
    fwd_per_solve = dict(BatchMPCKernels.fwd_launches)
    if fwd_per_solve != {fwd_route: ITERS + 1, OTHER_FORM[fwd_route]: 0}:
        raise AssertionError(f"K4 and K5 launches per solve by form {fwd_per_solve}, expected {ITERS + 1} of the "
                             f"route's {fwd_route}")
    check_solution("solve", us, xs, cost, u_lim)
    if not (bool((cost <= cost_zero).all()) and float(cost.mean()) < float(cost_zero.mean())):
        raise AssertionError(f"solve: mean cost {float(cost.mean())} not below the zero-control {float(cost_zero.mean())}")
    x, us_warm = xs[:, 1].contiguous(), torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    round_costs = []
    for r in range(3):
        _, goals_r = panda_problem(gen, panda, B_MPC)
        u_first, us_warm, (us_r, xs_r, cost_r) = batch_mpc_step(mpc, x, us_warm, goals_r)
        check_solution(f"round {r}", us_r, xs_r, cost_r, u_lim)
        x = xs_r[:, 1].contiguous()
        round_costs.append(float(cost_r.mean()))
    torch.cuda.synchronize()
    mpc_launches = dict(BatchMPCKernels.launch_count)
    k2_launches = dict(BatchMPCKernels.lin_launches)
    fwd_launches = dict(BatchMPCKernels.fwd_launches)
    if mpc_launches != {k: 4 * v for k, v in per_solve.items()} or k2_launches != {k: 4 * v for k, v in k2_per_solve.items()} \
            or fwd_launches != {k: 4 * v for k, v in fwd_per_solve.items()}:
        raise AssertionError(f"launches over 4 solves {mpc_launches}, K2's by form {k2_launches}, K4's and K5's "
                             f"{fwd_launches}")
    phase("mpc_main_path", robot="panda", B=B_MPC, H=H_MPC, iterations=ITERS, solve_wall_s=f"{solve_wall:.4f}",
          k2_form=k2_form, k2_launches_by_form=json.dumps(k2_launches).replace(" ", ""),
          k45_form=fwd_route, k45_launches_by_form=json.dumps(fwd_launches).replace(" ", ""),
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
    k2_by_B, other_solve_ms, route_solve_ms = {}, {}, {}
    fwd_by_B, fwd_other_solve_ms = {}, {}
    for B in (B_MPC,) + B_MPC_WIDE:
        if B == B_MPC:
            handle, x0_b, goals_b = mpc, x0, goals
        else:
            x0_b, goals_b = panda_problem(gen, panda, B)
            handle = build_batch_tracking_mpc(panda, goals_b, B, H_MPC, DT, iterations=ITERS)
        # A solve on each form of K2 (their units are the route's and phase
        # 2's: nothing builds).
        other_handle = build_batch_tracking_mpc(panda, goals_b, B, H_MPC, DT, iterations=ITERS,
                                                _form=OTHER_FORM[k2_form])
        fwd_other_handle = build_batch_tracking_mpc(panda, goals_b, B, H_MPC, DT, iterations=ITERS,
                                                    _fwd_form=OTHER_FORM[fwd_route])
        if B == B_MPC:
            args = stage_args
        else:
            # The stages' inputs at this width: the emitted form's solve, the
            # nominal K4's and K5's gates had before K2 had a looped form. On
            # the looped form's, one scenario's alpha-1 replay leaves f32 in
            # K5 and its plain version alike (tests/k5_shifted_draw.py,
            # PERF.md §7), which K5's gate refuses.
            nominal = handle if k2_form == "emitted" else other_handle
            us_b = nominal.solve(x0_b, torch.zeros((B, H_MPC, 7), **f32))[0].permute(1, 2, 0).contiguous()
            args = mpc_stage_parity(K, x0_b, goals_b, us_b, f"panda B={B}", False, check=False)[1]
        ms = {s: time_ms(lambda s=s: getattr(K, s)(*args[s])) for s in MPC_STAGES}
        solve = time_ms(lambda: handle.solve(x0_b, torch.zeros((B, H_MPC, 7), **f32)))
        route_solve_ms[B] = solve
        k2_by_B[B] = k2_forms(f"panda B={B}", k2_sets["panda"], args["linearize"], check=False)
        other_solve_ms[B] = time_ms(lambda: other_handle.solve(x0_b, torch.zeros((B, H_MPC, 7), **f32)))
        fwd_by_B[B] = k45_forms(f"panda B={B}", fwd_sets["panda"], args["linesearch"], args["replay"], check=False)
        fwd_other_solve_ms[B] = time_ms(lambda: fwd_other_handle.solve(x0_b, torch.zeros((B, H_MPC, 7), **f32)))
        for threads, V in k4_blocks.items():
            block_ms[threads][B] = time_ms(lambda V=V: V.linesearch(*args["linesearch"]))
        # K5 and K4 bit for bit at every width, K4's block variants bit for
        # bit as the unit (after the timings: the plain versions run long).
        # At B_MPC these are phase 7's inputs, where both were held (finite).
        if B == B_MPC:
            got = K.linesearch(*args["linesearch"])
            replay_err_by_B[B], linesearch_err_by_B[B] = stage_errs["replay"], stage_errs["linesearch"]
            nonfinite = int((~torch.isfinite(got[0])).sum())
        else:
            got, ref = K.replay(*args["replay"]), K.plain().replay(*args["replay"])
            replay_err_by_B[B] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            if replay_err_by_B[B] != 0.0 or not all(bool(torch.isfinite(r).all()) for r in ref):
                raise AssertionError(f"panda B={B} replay: max |d| = {replay_err_by_B[B]}, not 0")
            # Every alpha of every scenario: some diverge (alpha 1 on a
            # nominal far from the optimum), in the plain version too; the
            # solve's isfinite test rejects them. Bit for bit, NaN where it
            # is NaN.
            got, ref = K.linesearch(*args["linesearch"]), K.plain().linesearch(*args["linesearch"])
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
        phase("mpc_time", card=repr(card), robot="panda", B=B, H=H_MPC, iterations=ITERS,
              **{f"{s}_ms": f"{v:.4f}" for s, v in ms.items()},
              **{f"linesearch_ms_T{t}": f"{block_ms[t][B]:.4f}" for t in K4_BLOCKS}, solve_ms=f"{solve:.4f}",
              solves_per_s=f"{B / (solve * 1e-3):.4e}", kernels_ms_per_solve=f"{kernel_sum:.4f}",
              kernel_share=f"{kernel_sum / solve:.4f}", replay_max_abs_err=f"{replay_err_by_B[B]:.3e}",
              linesearch_max_abs_err=f"{linesearch_err_by_B[B]:.3e}", linesearch_nonfinite_costs=nonfinite,
              backward_GBps=f"{k3_bytes / (ms['backward'] * 1e6):.1f}",
              backward_Gops_per_s=f"{k3_ops / (ms['backward'] * 1e6):.1f}",
              **{k: f"{v:.1f}" for k, v in rates.items()})
        phase("mpc_time_k2_forms", card=repr(card), robot="panda", B=B, H=H_MPC, route=k2_form,
              **{f"solve_ms_{k2_form}": f"{solve:.4f}", f"solve_ms_{OTHER_FORM[k2_form]}": f"{other_solve_ms[B]:.4f}"},
              bound_ms=f"{bound(*stage_bytes_ops(K, B, H_MPC, ALPHAS)['linearize'])[0]:.4f}",
              **k2_fields(k2_by_B[B]))
        phase("mpc_time_k45_forms", card=repr(card), robot="panda", B=B, H=H_MPC, route=fwd_route,
              fwd_statements=K.statements["replay"],
              **{f"solve_ms_{fwd_route}": f"{solve:.4f}", f"solve_ms_{OTHER_FORM[fwd_route]}": f"{fwd_other_solve_ms[B]:.4f}"},
              linesearch_bound_ms=f"{bound(*bo_b['linesearch'])[0]:.4f}", replay_bound_ms=f"{bound(*bo_b['replay'])[0]:.4f}",
              **k45_fields(fwd_by_B[B]))

    bo = stage_bytes_ops(K, B_MPC, H_MPC, ALPHAS)
    batch_chain = batch_chain_ms(K, H_MPC)
    phase("mpc_chain", robot="panda", H=H_MPC, clocks_max_sm=repr(card_line("clocks.max.sm")),
          cycles_per_link=CHAIN_CYCLES, **{f"{s}_links": v for s, v in K.chains.items()},
          **{f"{s}_chain_bound_ms": f"{v:.5f}" for s, v in batch_chain.items()})
    k2_records, fwd_records = {}, {}
    for stage, (name, replaces) in MPC_KERNELS.items():
        b_ms, b_by = bound(*bo[stage])
        if stage == "linearize":  # a record a form, its launches the route's (phase 8, then phase 32's)
            for form in LIN_FORMS:
                f = k2_by_B[B_MPC][form]
                solves = route_solve_ms if form == k2_form else other_solve_ms
                k2_records[form] = {
                    "name": K2_NAMES[form], "route": "cuda", "source": K2_SOURCES[form], "replaces": replaces,
                    "launches": k2_launches[form], "max_abs_err": k2_err[form], "tolerance": "0",
                    "ms": f["ms"], "plain_ms": k2_plain_ms[form], "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "robot": "panda", "route_form": k2_form,
                    **{k: f[k] for k in ("seeds_per_thread", "block", "num_regs", "local_bytes", "blocks_per_sm",
                                         "sass_instructions", "nvcc_seconds")},
                    "ms_by_B": {B: k2_by_B[B][form]["ms"] for B in k2_by_B},
                    "solve_ms_by_B": dict(solves), "Gops_per_s": bo["linearize"][1] / (f["ms"] * 1e6),
                    "ur5": {k: k2_ur5_timing[form][k] for k in ("ms", "seeds_per_thread", "num_regs", "local_bytes",
                                                                 "sass_instructions")},
                }
                if form == "looped":
                    k2_records[form].update(
                        step_replaces="manipulapy_tpu/ops/fd_step.py:274", loop_ops=f["loop_ops"],
                        loop_ops_bound_ms=bound(0, f["loop_ops"]["total"] * B_MPC * H_MPC)[0])
                else:
                    k2_records[form].update(thread_statements=k2_sets["panda"][form].statements["linearize_group"])
                records.append(k2_records[form])
            records[-1].update(backward_Gops_per_s=bo["backward"][1] / (stage_ms["backward"] * 1e6))
            continue
        a = mpc_attrs["panda"][stage]
        launches, err = mpc_launches[stage], mpc_err[stage]
        if stage == "linesearch":  # K4 serves both stages
            launches, err = launches + mpc_launches["linesearch_costs"], max(err, mpc_err["linesearch_costs"])
        if stage in FWD_NAMES:  # a record a form, its launches the route's (phase 8, then phase 32's)
            name, err = FWD_NAMES[stage][fwd_route], fwd_err[fwd_route]
            other_f = fwd_by_B[B_MPC][OTHER_FORM[fwd_route]]
            fwd_records[stage, OTHER_FORM[fwd_route]] = {
                "name": FWD_NAMES[stage][OTHER_FORM[fwd_route]], "route": "cuda", "source": MPC_SOURCE,
                "replaces": replaces, "launches": 0, "max_abs_err": fwd_err[OTHER_FORM[fwd_route]], "tolerance": "0",
                "ms": other_f["ms"][stage], "plain_ms": fwd_plain_ms[OTHER_FORM[fwd_route]],
                "plain_scope": "one plain call of A + 1 rows (K4's alphas, K5's own), B=1024 H=50",
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "robot": "panda", "fwd_form": OTHER_FORM[fwd_route],
                "fwd_route": fwd_route, **other_f[stage], "nvcc_seconds": other_f["nvcc_seconds"],
                "loop_ops": other_f["loop_ops"], "block": BLOCK_MPC,
                "ms_by_B": {B: fwd_by_B[B][OTHER_FORM[fwd_route]]["ms"][stage] for B in fwd_by_B},
                "solve_ms_by_B": dict(fwd_other_solve_ms),
                "ur5": {"ms": fwd_ur5["timing"][OTHER_FORM[fwd_route]]["ms"][stage],
                        **fwd_ur5["timing"][OTHER_FORM[fwd_route]][stage]},
            }
            if OTHER_FORM[fwd_route] == "looped":
                fwd_records[stage, "looped"].update(step_source=LOOP_SOURCE, loop_ops_bound_ms=bound(
                    0, other_f["loop_ops"] * H_MPC * B_MPC * (ALPHAS if stage == "linesearch" else 1))[0])
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
        if stage in FWD_NAMES:
            route_f = fwd_by_B[B_MPC][fwd_route]
            fwd_records[stage, fwd_route] = records[-1]
            records[-1].update(fwd_form=fwd_route, fwd_route=fwd_route, **route_f[stage],
                               ms_by_B={B: fwd_by_B[B][fwd_route]["ms"][stage] for B in fwd_by_B},
                               solve_ms_by_B=dict(route_solve_ms),
                               ur5={"ms": fwd_ur5["timing"][fwd_route]["ms"][stage], **fwd_ur5["timing"][fwd_route][stage]})
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
        if stage in FWD_NAMES:  # the other form's record after the route's
            records.append(fwd_records[stage, OTHER_FORM[fwd_route]])

    single_records, k8_records = single_path(panda, single, mpc_attrs["panda single"], card, built["mpc", "panda single"],
                                             k8_sets)
    records += single_records
    plan_timed = planning_timed(ur5, card)
    closed_loop(ur5, panda, engines["ur5"], card, records)
    records += planning_records(ur5, ew_attrs, records[0], plan_timed)
    urdf_models_phase()
    urdf_rollout = urdf_rollout_phase(robots, ur5, engines, card)
    urdf_records(records, urdf_rollout, urdf_mpc_phase(robots["panda_arm"], panda, card))
    runtime_records(records, runtime)
    # 32. The calibrated fleet.
    fleet_records = fleet_phase(fleet, pool, urdf_rollout, card)
    for rec in fleet_records:  # the public route's K2 launches on the fleet, by form
        if rec.get("route_form") and rec["name"].startswith(K2_NAMES[rec["route_form"]] + " ["):
            k2_records[rec["route_form"]]["launches"] += rec["launches"]
            k2_records[rec["route_form"]].setdefault("fleet_robots", []).append(rec["robot"])
    if any(rec["launches"] < 1 for rec in k2_records.values()):
        raise AssertionError(f"a K2 form no public route launched: {[(f, r['launches']) for f, r in k2_records.items()]}")
    for rec in fleet_records:  # the public route's K4 and K5 launches on the fleet, by form
        for stage in FWD_NAMES:
            if rec.get("fwd_form") and rec["name"].startswith(FWD_NAMES[stage][rec["fwd_form"]] + " ["):
                fwd_records[stage, rec["fwd_form"]]["launches"] += rec["launches"]
                fwd_records[stage, rec["fwd_form"]].setdefault("fleet_robots", []).append(rec["robot"])
                fwd_records[stage, rec["fwd_form"]]["max_abs_err"] = max(fwd_records[stage, rec["fwd_form"]]["max_abs_err"],
                                                                         rec["max_abs_err"])
                other = fwd_records[stage, OTHER_FORM[rec["fwd_form"]]]  # held on this robot too
                other["max_abs_err"] = max(other["max_abs_err"], *rec["other_form"]["max_abs_err"].values())
    if any(rec["launches"] < 1 for rec in fwd_records.values()):
        raise AssertionError(f"a K4 or K5 form no public route launched: "
                             f"{[(k, r['launches']) for k, r in fwd_records.items()]}")
    k8_fleet_records(k8_records, fleet_records, fleet["k8_route"], single.kernels.fwd_form)
    records.insert(1, looped_record(looped_bench, urdf_rollout, fleet_records))
    records += fleet_records
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
