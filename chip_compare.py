#!/usr/bin/env python3
"""Time the port's end-to-end paths and its MPC kernels, for comparing two
checkouts on one CUDA card.

Imports ``manipulapy_tpu_torch`` from ``--root`` (default: this file's
directory), builds what it times there, and prints one JSON line: the card,
then CUDA-event medians (5 timings after 2 warm-ups) of

* the UR5 and the Panda rollout, B=131072, N=50
  (``trajectory.forward_dynamics_trajectory``);
* the open loop of ``chip_smoke.py``'s planning path, warmed: UR5, 1024
  quintic plans of 1000 waypoints (``create_planner(...).batch_joint_trajectory``)
  -> ``link_positions`` -> ``cartesian_potential_field`` against 32 points
  -> ``inverse_dynamics_trajectory`` -> ``forward_dynamics_trajectory``;
* K1 per launch on that path's own tensors: the plans' rollout (B=1024,
  N=1000) and one control period (their first 2 waypoints, 20 back-to-back
  launches), through the public route and, where the tree builds K1 with
  ``MPT_BLOCK``, through a unit built for each of 32, 64 and 128 threads a
  block (``rollout_<shape>_ms_T<threads>``, the rollout shape too), each
  held bitwise to the default's outputs; the control period also over 200
  back-to-back calls (``rollout_control_ms_x200``) and, where the tree's
  unit raises its shared-memory limit in ``prepare()``, over 200 calls
  that each call it first (``..._prepare_each_call``), the two in turns;
* the Panda batched solve (H=50, 4 iterations, 6 alphas) at B=1024, 4096 and
  16384, and each of K2-K5 on that solve's own nominal (the solver's
  controls, as ``chip_smoke.py`` feeds them), K4 with its trajectories
  (``linesearch``) where the tree has it; K2's, K3's, K4's and K5's registers,
  local bytes and nvcc seconds (0 when the library was already on disk),
  and where K5 is a team of warps, its team (warps, scenarios, teams a
  block, phases, slots, dynamic shared bytes). With ``--variants``, in a
  tree whose K5 runs one thread a scenario by default: K2 at each of
  ``LIN_VARIANTS`` seeds a thread (``linearize_ms_B<B>_G<seeds>``), UR5's
  K2 at each B on its own solve's nominal as built and at the other of 1
  and 3 seeds a thread (``ur5_linearize_ms_B<B>``, ``..._G<seeds>``), K4 built with each of ``K4_BLOCKS`` threads a block
  (``linesearch_ms_B<B>_T<threads>``, ``linesearch_costs_ms_...``) and K5's
  team variant for each shape of ``REPLAY_VARIANTS``
  (``replay_ms_B<B>_W<warps>_S<scenarios>_T<teams a block>``), each with
  its registers, local bytes and nvcc seconds and held bitwise to the
  default's outputs;
* the Panda single-problem solve, H=50, 6 alphas, at 4 and at 2 iterations,
  the device's busy share over 3 solves at 4 (``torch.profiler``), and each
  of K6-K8 per launch (20 back-to-back launches) on that solve's own
  nominal; where the tree builds K7 with ``MPT_BWD_THREADS``, K7 also with
  each other block size of 128, 256 and 512 threads
  (``single_backward_ms_<threads>_threads``, and its local bytes), held
  bitwise to the default's gains; K8's registers, local bytes and nvcc
  seconds and, where the tree builds K8 as a team (``FWD_WARPS``), its team
  and K8 built for each other of ``FORWARD_WARPS``
  (``single_forward_ms_W<warps>``, the same figures), held bitwise to the
  default's outputs. Where the tree has K6's designs (``LIN_WARPS``), K6's
  registers, local bytes, nvcc seconds and team, and with ``--variants``
  K6 built for each other of ``LIN_WARPS`` (0: one thread a lane) and as
  its unit was before the lean body (``jvp``: the one-seed
  ``fd_step_jvp``, ptxas -O3), each with the same figures and held bitwise
  to the default's AB, then all of them timed per launch in turns, five
  rounds (``single_linearize_ms_turns``, ``..._turns_W<warps>``,
  ``..._turns_jvp``, medians).

Compare trees within one call, in turns (e.g. older, parent, change,
change, parent, older), one process each; unpack each other tree with
``git archive <commit> | tar -x -C build/<name>`` first:

    python3 chip_compare.py --root build/parent > parent_1.json
    python3 chip_compare.py --variants > change_1.json

Any number of trees take turns so, each its own ``--root``;
``--batched-only`` times the batched solve and its kernels alone. It needs
one card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

B_WIDTHS, H, ITERS, ALPHAS, DT = (1024, 4096, 16384), 50, 4, 6, 0.01
# K2 at these seeds a thread besides the unit's one, for Panda (m = 21): G
# = 7's and G = 21's units take nvcc minutes (PERF.md section 6) and are
# left out.
LIN_VARIANTS = (3,)
# K4's threads a block besides the unit's BLOCK.
K4_BLOCKS = (32, 64)
# K5's team shapes (warps, scenarios a team, teams a block) and K8's warps,
# each built as a variant unit where the tree's unit is a team.
REPLAY_VARIANTS = ((8, 32, 1), (8, 32, 2), (16, 32, 1), (16, 32, 2), (32, 32, 1), (8, 16, 4))
FORWARD_WARPS = (4, 8, 16, 32)
# K6's designs where the tree has them (``LIN_WARPS``): one thread a lane
# (0) and a team of each other number of warps, each a variant unit.
LIN_WARPS = (0, 2, 4, 8, 16)
Q_GOAL7 = (0.3, -0.4, 0.2, -1.6, 0.1, 1.4, 0.4)


def variant_units(K, model, unit: str, variants, build: bool = True) -> dict:
    """Kernel sets like ``K`` with each variant's class attributes, only
    ``unit`` built, all at once (one nvcc each): ``{name: kernel set}``."""
    sets = {name: type("Variant", (type(K),), {**attrs, "UNITS": {unit: type(K).UNITS[unit]}})(
        model, DT, w_q=K.P.w_q, w_dq=K.P.w_dq, w_u=K.P.w_u,
        w_terminal=K.P.wT[0], u_lim=K.P.u_lim) for name, attrs in variants}
    if build:
        build_sets(sets.values())
    return sets


def build_sets(sets) -> None:
    """Build kernel sets' units, all at once (one nvcc each)."""
    import concurrent.futures

    sets = list(sets)
    if sets:
        with concurrent.futures.ThreadPoolExecutor(len(sets)) as pool:
            list(pool.map(lambda V: V.build(), sets))


def unit_figures(K, prefix: str, unit: str, stage: str) -> dict:
    """A stage's registers, local bytes and its unit's nvcc seconds (0 when
    the library was already on disk) and, for a team (K6's where the stage
    is ``linearize``), its shape."""
    attrs = K.kernel_attributes()[stage]
    out = {f"{prefix}_num_regs": attrs["num_regs"], f"{prefix}_local_bytes": attrs["local_bytes"],
           f"{prefix}_nvcc_s": K.build()[unit].compile_seconds}
    team = getattr(K, "lin_team", None) if stage == "linearize" else getattr(K, "team", None)
    if team is not None:
        shape = K.team_attributes() if stage == K.TEAM_STAGE else K.team_attributes(stage)
        out.update({f"{prefix}_{k}": v for k, v in shape.items()})
        out.update({f"{prefix}_critical": team.partition.critical})
    return out


def k6_jvp_unit(S, model):
    """K6's unit as it was before the lean body: the one-seed ``fd_step_jvp``
    one thread a lane, blocks of one warp, ptxas at its default -O3 (the
    one-thread unit with its body swapped back)."""

    class JVP(type(S)):
        LIN_WARPS, UNITS, UNIT_FLAGS = 0, {"lin": type(S).UNITS["lin"]}, {}

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            src = self.sources["lin"].replace(
                self.linearize_group_source, self.linearize_seed_source + "#define fd_step_jvp_group fd_step_jvp\n")
            self.sources["lin"] = src.replace('asm volatile(".pragma \\"enable_smem_spilling\\";");', "")

    return JVP(model, DT, w_q=S.P.w_q, w_dq=S.P.w_dq, w_u=S.P.w_u, w_terminal=S.P.wT[0], u_lim=S.P.u_lim)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--batched-only", action="store_true",
                        help="time the batched solve and K2-K5 alone (no rollout, planning or single solve)")
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the design variants of K1, K2, K4, K5, K7 and K8")
    cli = parser.parse_args()
    root = os.path.abspath(cli.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device is available", file=sys.stderr)
        return 1
    from manipulapy_tpu_torch import create_planner, potential_field, trajectory
    from manipulapy_tpu_torch.models import catalog
    from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
    from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc

    def per_call_ms(fn, calls: int = 20) -> float:
        return time_ms(lambda: [fn() for _ in range(calls)]) / calls

    def busy_share(fn, reps: int = 3):
        """The device's busy share of the span its kernels cover, over
        ``reps`` calls of ``fn`` (None when the trace has no device time)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if not spans:
            return None
        busy, open_s, open_e = 0.0, spans[0][0], spans[0][1]
        for start, end in spans:
            if start > open_e:
                busy, open_s = busy + open_e - open_s, start
            open_e = max(open_e, end)
        return (busy + open_e - open_s) / (open_e - spans[0][0])

    def time_ms(fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    ur5, panda = catalog.ur5(), catalog.panda()
    out = {"root": root, "card": card}

    if not cli.batched_only:  # the rollouts, the planning path and K1
        q0, dq0, tau = rand(131072, 6) * 2 - 1, rand(131072, 6) - 0.5, rand(131072, 50, 6) * 20 - 10
        out["rollout_ms"] = time_ms(lambda: trajectory.forward_dynamics_trajectory(ur5, q0, dq0, tau, dt=DT))
        qp, dqp, taup = rand(131072, 7) * 2 - 1, rand(131072, 7) - 0.5, rand(131072, 50, 7) * 20 - 10
        out["rollout_panda_ms"] = time_ms(lambda: trajectory.forward_dynamics_trajectory(panda, qp, dqp, taup, dt=DT))
        del qp, dqp, taup

        start = rand(1024, 6) * 2 - 1
        goal = torch.clamp(start + (rand(1024, 6) * 2 - 1) * 0.8, ur5.joint_lower, ur5.joint_upper)
        cloud, field_goal = (rand(32, 3) * 2 - 1) * 0.8, torch.tensor([0.4, 0.1, 0.3], device="cuda")
        planner = create_planner(ur5, obstacle_points=cloud)

        def plan_path():
            with torch.no_grad():
                plan = planner.batch_joint_trajectory(start, goal, 2.0, 1000)
                points = potential_field.link_positions(ur5, plan.position)
                potential_field.cartesian_potential_field(points, field_goal, cloud, 0.5)
                tau = planner.inverse_dynamics_trajectory(*plan)
                return planner.forward_dynamics_trajectory(plan.position[:, 0], plan.velocity[:, 0], tau, dt=2.0 / 999)

        out["plan_path_ms"] = time_ms(plan_path)

        from manipulapy_tpu_torch.ops import cuda_rollout

        with torch.no_grad():
            plan = planner.batch_joint_trajectory(start, goal, 2.0, 1000)
            path_tau = planner.inverse_dynamics_trajectory(*plan).contiguous()
        path_q0, path_dq0 = plan.position[:, 0].contiguous(), plan.velocity[:, 0].contiguous()
        period_tau = path_tau[:, :2].contiguous()
        rollout = lambda q, dq, t, dt: trajectory.forward_dynamics_trajectory(ur5, q, dq, t, dt=dt)
        out["rollout_plan_ms"] = time_ms(lambda: rollout(path_q0, path_dq0, path_tau, 2.0 / 999))
        out["rollout_control_ms"] = per_call_ms(lambda: rollout(path_q0, path_dq0, period_tau, 2.0 / 999))
        period = lambda: rollout(path_q0, path_dq0, period_tau, 2.0 / 999)
        lib = cuda_rollout.build_cuda_rollout(ur5, dt=2.0 / 999).build().lib  # the route's library
        variants = {"rollout_control_ms_x200": period}
        if hasattr(lib, "prepare"):
            variants["rollout_control_ms_x200_prepare_each_call"] = lambda: (lib.prepare(), period())
        times = {k: [] for k in variants}
        for _ in range(5):
            for k, fn in variants.items():
                times[k].append(per_call_ms(fn, 200))
        out.update({k: statistics.median(v) for k, v in times.items()})
        shapes = {"rollout": (q0, dq0, tau, DT), "plan": (path_q0, path_dq0, path_tau, 2.0 / 999),
                  "control": (path_q0, path_dq0, period_tau, 2.0 / 999)}
        define = f"#define MPT_BLOCK {getattr(cuda_rollout, 'BLOCK', None)}\n"
        for threads in (32, 64, 128) if cli.variants and define in cuda_rollout.build_cuda_rollout(ur5).source else ():
            for shape, (q, dq, t, dt) in shapes.items():
                engine = cuda_rollout.build_cuda_rollout(ur5, dt=dt)  # the library is loaded once per source
                ref = engine(q, dq, t)
                engine.source = engine.source.replace(define, f"#define MPT_BLOCK {threads}\n")
                engine._built = None
                if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(engine(q, dq, t), ref)):
                    raise AssertionError(f"K1 with {threads} threads a block differs from the default at {shape}")
                run = lambda: engine(q, dq, t)
                out[f"rollout_{shape}_ms_T{threads}"] = per_call_ms(run) if shape == "control" else time_ms(run)

    gen.manual_seed(1)  # the batched section's data, whatever ran before it
    lo, hi = panda.joint_lower, panda.joint_upper
    same = lambda a, b: all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))
    # Design variants where the tree's K5 runs one thread a scenario, all
    # built at once: K2's seeds, K4's blocks, K5's teams (Panda) and UR5's
    # K2 at its other seeds a thread.
    from manipulapy_tpu_torch.ops import cuda_mpc_batch

    lin_variants = block_variants = replay_variants = {}
    ur5_other = None
    if cli.variants and getattr(cuda_mpc_batch.BatchMPCKernels, "TEAM_WARPS", None) == 0:
        Kp = build_batch_tracking_mpc(panda, torch.zeros(7, device="cuda"), 1, H, DT).kernels
        lin_variants = variant_units(Kp, panda, "lin", [(g, {"LIN_SEEDS": g}) for g in LIN_VARIANTS], build=False)
        block_variants = variant_units(Kp, panda, "fwd", [(t, {"DEFINES": {**Kp.DEFINES, "MPT_BLOCK": t}})
                                                          for t in K4_BLOCKS], build=False)
        replay_variants = variant_units(Kp, panda, "fwd", [
            (f"W{w}_S{sc}_T{t}", {"TEAM_WARPS": w, "TEAM_S": sc, "TEAM_PER_BLOCK": t})
            for w, sc, t in REPLAY_VARIANTS], build=False)
        Ku = build_batch_tracking_mpc(ur5, torch.zeros(6, device="cuda"), 1, H, DT).kernels
        ur5_seeds = 1 if Ku.LIN_SEEDS == 3 else 3
        ur5_other = variant_units(Ku, ur5, "lin", [(ur5_seeds, {"LIN_SEEDS": ur5_seeds})], build=False)[ur5_seeds]
        build_sets([*lin_variants.values(), *block_variants.values(), *replay_variants.values(), ur5_other, Ku])
        for g, V in lin_variants.items():
            out.update(unit_figures(V, f"linearize_G{g}", "lin", "linearize"))
        for t, V in block_variants.items():
            out.update(unit_figures(V, f"linesearch_T{t}", "fwd", "linesearch"))
        for name, V in replay_variants.items():
            out.update(unit_figures(V, f"replay_{name}", "fwd", "replay"))
        out.update(unit_figures(Ku, "ur5_linearize", "lin", "linearize"))
        out.update(unit_figures(ur5_other, f"ur5_linearize_G{ur5_seeds}", "lin", "linearize"))
    for B in B_WIDTHS:
        x0 = torch.cat([(lo + hi) / 2 + (rand(B, 7) * 2 - 1) * 0.25 * (hi - lo), torch.zeros(B, 7, device="cuda")], 1)
        goals = torch.clamp(x0[:, :7] + (rand(B, 7) * 2 - 1) * 0.3, lo, hi)
        mpc = build_batch_tracking_mpc(panda, goals, B, H, DT, iterations=ITERS)
        zeros = torch.zeros((B, H, 7), device="cuda")
        us = mpc.solve(x0, zeros)[0].permute(1, 2, 0).contiguous()
        out[f"solve_ms_B{B}"] = time_ms(lambda: mpc.solve(x0, zeros))
        K, x0_t, goal_t = mpc.kernels, x0.T.contiguous(), goals.T.contiguous()
        f = lambda *s: torch.zeros(s, device="cuda")
        xs = K.replay(x0_t, f(H, 14, B), us, f(H, 7, 15, B), goal_t, f(B))[0]
        sd_x = torch.cat([x0_t[None], xs[:-1]]).contiguous()
        bwd_args = (K.linearize(sd_x, us), sd_x, us, xs[-1].contiguous(), goal_t, torch.full((B,), 1e-6, device="cuda"))
        kK = K.backward(*bwd_args)
        alphas = 0.5 ** torch.arange(ALPHAS, device="cuda", dtype=torch.float32)
        args = {"linearize": (sd_x, us), "backward": bwd_args, "linesearch_costs": (x0_t, sd_x, us, kK, goal_t, alphas),
                "replay": (x0_t, sd_x, us, kK, goal_t, alphas[torch.arange(B, device="cuda") % ALPHAS].contiguous())}
        if hasattr(K, "linesearch"):
            args["linesearch"] = args["linesearch_costs"]
        for stage, a in args.items():
            out[f"{stage}_ms_B{B}"] = time_ms(lambda: getattr(K, stage)(*a))
        if B == B_WIDTHS[0]:
            out.update(unit_figures(K, "linearize", "lin", "linearize"))
            out.update(unit_figures(K, "backward", "bwd", "backward"))
            out.update(unit_figures(K, "replay", "fwd", "replay"))
            if "linesearch" in args:
                out.update(unit_figures(K, "linesearch", "fwd", "linesearch"))
        AB = K.linearize(sd_x, us)
        for g, V in lin_variants.items():
            if not same((V.linearize(sd_x, us),), (AB,)):
                raise AssertionError(f"K2 with {g} seeds a thread differs from the default at B={B}")
            out[f"linearize_ms_B{B}_G{g}"] = time_ms(lambda: V.linearize(sd_x, us))
        for t, V in block_variants.items():
            for stage in ("linesearch", "linesearch_costs"):
                got, ref = getattr(V, stage)(*args[stage]), getattr(K, stage)(*args[stage])
                if not same(*[(x,) if isinstance(x, torch.Tensor) else x for x in (got, ref)]):
                    raise AssertionError(f"K4 {stage} with {t} threads a block differs from the default at B={B}")
                out[f"{stage}_ms_B{B}_T{t}"] = time_ms(lambda: getattr(V, stage)(*args[stage]))
        ref = K.replay(*args["replay"])
        for name, V in replay_variants.items():
            if not same(V.replay(*args["replay"]), ref):
                raise AssertionError(f"K5 {name} differs from the default at B={B}")
            out[f"replay_ms_B{B}_{name}"] = time_ms(lambda: V.replay(*args["replay"]))
        if ur5_other is not None:  # UR5's K2, as built and at the other seeds a thread, on its own solve's nominal
            q0 = (ur5.joint_lower + ur5.joint_upper) / 2 + (rand(B, 6) * 2 - 1) * 0.25 * (ur5.joint_upper - ur5.joint_lower)
            x0u = torch.cat([q0, torch.zeros(B, 6, device="cuda")], 1)
            mpc_u = build_batch_tracking_mpc(ur5, torch.clamp(q0 + (rand(B, 6) * 2 - 1) * 0.3, ur5.joint_lower,
                                                              ur5.joint_upper), B, H, DT, iterations=ITERS)
            us_u = mpc_u.solve(x0u, torch.zeros((B, H, 6), device="cuda"))[0].permute(1, 2, 0).contiguous()
            Ku = mpc_u.kernels
            xs_u = Ku.replay(x0u.T.contiguous(), f(H, 12, B), us_u, f(H, 6, 13, B), f(6, B), f(B))[0]
            sd_u = torch.cat([x0u.T.contiguous()[None], xs_u[:-1]]).contiguous()
            if not same((ur5_other.linearize(sd_u, us_u),), (Ku.linearize(sd_u, us_u),)):
                raise AssertionError(f"UR5's K2 with {ur5_seeds} seeds a thread differs from the default at B={B}")
            out[f"ur5_linearize_ms_B{B}"] = time_ms(lambda: Ku.linearize(sd_u, us_u))
            out[f"ur5_linearize_ms_B{B}_G{ur5_seeds}"] = time_ms(lambda: ur5_other.linearize(sd_u, us_u))

    if not cli.batched_only:  # the single-problem solve and K6-K8
        single = build_tracking_mpc(panda, Q_GOAL7, H, DT, iterations=ITERS, line_search_steps=ALPHAS)
        x1 = torch.cat([(lo + hi) / 2, torch.zeros(7, device="cuda")]).contiguous()
        zeros1 = torch.zeros((H, 7), device="cuda")
        out["single_solve_ms"] = time_ms(lambda: single.solve(x1, zeros1))
        single2 = build_tracking_mpc(panda, Q_GOAL7, H, DT, iterations=2, line_search_steps=ALPHAS)
        out["single_solve_2it_ms"] = time_ms(lambda: single2.solve(x1, zeros1))
        out["single_device_busy_share"] = busy_share(lambda: single.solve(x1, zeros1))
        S, f = single.kernels, lambda *s: torch.zeros(s, device="cuda")
        goal1 = torch.tensor(Q_GOAL7, device="cuda")
        us1 = single.solve(x1, zeros1)[0].contiguous()
        xs1 = S.forward(x1, f(H, 14), us1, f(H, 7, 15), goal1, f(1))[0][0]
        sd1 = torch.cat([x1[None], xs1[:-1]]).contiguous()
        two_wT = torch.tensor([2.0 * w for w in S.P.wT], device="cuda")
        Vterm = torch.cat([torch.diag(two_wT), (two_wT * (xs1[-1] - torch.cat([goal1, f(7)])))[None]]).contiguous()
        bwd_args = (S.linearize(sd1, us1), sd1, us1, goal1, Vterm, torch.tensor(1e-6, device="cuda"))
        kK = S.backward(*bwd_args)
        alphas = 0.5 ** torch.arange(ALPHAS, device="cuda", dtype=torch.float32)
        args = {"linearize": (sd1, us1), "backward": bwd_args, "forward": (x1, sd1, us1, kK, goal1, alphas)}
        for stage, a in args.items():
            out[f"single_{stage}_ms"] = per_call_ms(lambda: getattr(S, stage)(*a))
        out.update(unit_figures(S, "single_forward", "fwd", "forward"))
        out.update(unit_figures(S, "single_linearize", "lin", "linearize"))
        if cli.variants and hasattr(S, "LIN_WARPS"):  # K6's designs, timed in turns, each bitwise to the default
            lin_variants = variant_units(S, panda, "lin", [
                (f"W{w}", {"LIN_WARPS": w}) for w in LIN_WARPS if w != S.LIN_WARPS], build=False)
            lin_variants["jvp"] = k6_jvp_unit(S, panda)
            build_sets(lin_variants.values())
            AB = S.linearize(*args["linearize"])
            runs = {"": S, **{f"_{name}": V for name, V in lin_variants.items()}}
            for name, V in lin_variants.items():
                out.update(unit_figures(V, f"single_linearize_{name}", "lin", "linearize"))
                if not torch.equal(V.linearize(*args["linearize"]).view(torch.int32), AB.view(torch.int32)):
                    raise AssertionError(f"K6 {name} differs from the default")
            times = {k: [] for k in runs}
            for _ in range(5):
                for k, V in runs.items():
                    times[k].append(per_call_ms(lambda: V.linearize(*args["linearize"])))
            out.update({f"single_linearize_ms_turns{k}": statistics.median(v) for k, v in times.items()})
        fwd_ref = S.forward(*args["forward"])
        forward_variants = variant_units(S, panda, "fwd", [
            (f"W{w}", {"FWD_WARPS": w}) for w in (FORWARD_WARPS if cli.variants and hasattr(S, "FWD_WARPS") else ())
            if w != S.FWD_WARPS])
        for name, V in forward_variants.items():
            out.update(unit_figures(V, f"single_forward_{name}", "fwd", "forward"))
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(V.forward(*args["forward"]), fwd_ref)):
                raise AssertionError(f"K8 {name} differs from the default")
            out[f"single_forward_ms_{name}"] = per_call_ms(lambda: V.forward(*args["forward"]))
        bwd_variants = variant_units(S, panda, "bwd", [
            (threads, {"DEFINES": {**S.DEFINES, "MPT_BWD_THREADS": threads}})
            for threads in ((128, 256, 512) if cli.variants and "MPT_BWD_THREADS" in S.DEFINES else ())
            if threads != S.DEFINES["MPT_BWD_THREADS"]])
        for threads, other in bwd_variants.items():
            if not torch.equal(other.backward(*bwd_args).view(torch.int32), kK.view(torch.int32)):
                raise AssertionError(f"K7 with {threads} threads a block gives other gains than the default")
            out[f"single_backward_ms_{threads}_threads"] = per_call_ms(lambda: other.backward(*bwd_args))
            out[f"single_backward_local_bytes_{threads}_threads"] = other.kernel_attributes()["backward"]["local_bytes"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
