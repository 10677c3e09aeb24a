#!/usr/bin/env python3
"""Time the port's end-to-end paths and its MPC kernels, for comparing two
checkouts on one CUDA card.

Imports ``manipulapy_tpu_torch`` from ``--root`` (default: this file's
directory), builds what it times there, and prints one JSON line: the card,
then CUDA-event medians (5 timings after 2 warm-ups) of

* the UR5 rollout, B=131072, N=50 (``trajectory.forward_dynamics_trajectory``);
* the open loop of ``chip_smoke.py``'s planning path, warmed: UR5, 1024
  quintic plans of 1000 waypoints (``create_planner(...).batch_joint_trajectory``)
  -> ``link_positions`` -> ``cartesian_potential_field`` against 32 points
  -> ``inverse_dynamics_trajectory`` -> ``forward_dynamics_trajectory``;
* the Panda batched solve (H=50, 4 iterations, 6 alphas) at B=1024, 4096 and
  16384, and each of K2-K5 on that solve's own nominal (the solver's
  controls, as ``chip_smoke.py`` feeds them);
* the Panda single-problem solve, H=50, 6 alphas, at 4 and at 2 iterations,
  the device's busy share over 3 solves at 4 (``torch.profiler``), and each
  of K6-K8 per launch (20 back-to-back launches) on that solve's own
  nominal; where the tree builds K7 with ``MPT_BWD_THREADS``, K7 also with
  each other block size of 128, 256 and 512 threads
  (``single_backward_ms_<threads>_threads``, and its local bytes), held
  bitwise to the default's gains.

Compare two trees within one call, in turns (parent, change, change,
parent), one process each:

    python3 chip_compare.py --root path/to/parent > parent_1.json

It needs one card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

B_WIDTHS, H, ITERS, ALPHAS, DT = (1024, 4096, 16384), 50, 4, 6, 0.01
Q_GOAL7 = (0.3, -0.4, 0.2, -1.6, 0.1, 1.4, 0.4)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(parser.parse_args().root)
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

    q0, dq0, tau = rand(131072, 6) * 2 - 1, rand(131072, 6) - 0.5, rand(131072, 50, 6) * 20 - 10
    out["rollout_ms"] = time_ms(lambda: trajectory.forward_dynamics_trajectory(ur5, q0, dq0, tau, dt=DT))

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

    lo, hi = panda.joint_lower, panda.joint_upper
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
        for stage, a in args.items():
            out[f"{stage}_ms_B{B}"] = time_ms(lambda: getattr(K, stage)(*a))

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
    for threads in (128, 256, 512) if "MPT_BWD_THREADS" in S.DEFINES else ():
        if threads == S.DEFINES["MPT_BWD_THREADS"]:
            continue
        other = type("Other", (type(S),), {"DEFINES": {**S.DEFINES, "MPT_BWD_THREADS": threads},
                                           "UNITS": {"bwd": ("backward",)}})(
            panda, DT, w_q=S.P.w_q, w_dq=S.P.w_dq, w_u=S.P.w_u, w_terminal=S.P.wT[0], u_lim=S.P.u_lim)
        if not torch.equal(other.backward(*bwd_args).view(torch.int32), kK.view(torch.int32)):
            raise AssertionError(f"K7 with {threads} threads a block gives other gains than the default")
        out[f"single_backward_ms_{threads}_threads"] = per_call_ms(lambda: other.backward(*bwd_args))
        out[f"single_backward_local_bytes_{threads}_threads"] = other.kernel_attributes()["backward"]["local_bytes"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
