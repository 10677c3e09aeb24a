#!/usr/bin/env python3
"""Time the port's end-to-end paths and its MPC kernels, for comparing two
checkouts on one CUDA card.

Imports ``manipulapy_tpu_torch`` from ``--root`` (default: this file's
directory), builds what it times there, and prints one JSON line: the card,
then CUDA-event medians (5 timings after 2 warm-ups) of

* the UR5 rollout, B=131072, N=50 (``trajectory.forward_dynamics_trajectory``);
* the Panda batched solve (H=50, 4 iterations, 6 alphas) at B=1024, 4096 and
  16384, and each of K2-K5 on that solve's own nominal (the solver's
  controls, as ``chip_smoke.py`` feeds them);
* the Panda single-problem solve, H=50, 4 iterations.

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
    from manipulapy_tpu_torch import trajectory
    from manipulapy_tpu_torch.models import catalog
    from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
    from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc

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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
