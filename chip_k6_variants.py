#!/usr/bin/env python3
"""Build K6 (the single-problem linearization kernel) in the variants its
design was chosen from, and find what bounds it, on one CUDA card.

Panda, dt 0.01. Builds every variant's unit at once (one nvcc each), prints
its nvcc seconds, registers, local bytes, ptxas's spill report, its
kernel's SASS instructions (``cuobjdump -sass``) and, for a team, its
shape; holds each bitwise against the plain linearization at H = 50, 37
and 1; then prints

* per launch at H=50 (20 back-to-back launches), every variant in turns,
  five rounds, and their medians;
* the scan: per launch of ``W0``, ``jvp``, ``W8`` and ``W16`` at H = 1, 7,
  50, 200, 400 and 800 (21 to 16800 lanes; one block to several an SM),
  medians of three.

A variant is ``SingleMPCKernels``'s lin unit:

* ``W0``: one thread a lane, the lean one-seed body, ptxas -O1;
* ``W<k>``: a team of k warps per 32 lanes, ptxas -O1;
* ``+O3``: ptxas's default level instead;
* ``+smem``: the team kernel with ptxas's shared-memory spilling pragma
  (the one-thread unit has it);
* ``jvp``: the unit before the lean body: the one-seed ``fd_step_jvp``,
  ptxas -O3 (``chip_compare.k6_jvp_unit``).

A variant that does not build is reported with the lines of nvcc's output
that say why, and left out of the timings. States inside the joint limits
at the middle +-80% of each half-range, velocities in [-0.5, 0.5], torques
within 30% of the limits, from numpy seeds. The last line is one JSON
object of every number.

    python3 chip_k6_variants.py

It needs one card and imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from chip_compare import DT, Q_GOAL7, k6_jvp_unit
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
from manipulapy_tpu_torch.ops._build import nvcc_path

VARIANTS = ("W0", "W0+O3", "jvp", "W2", "W4", "W8", "W8+O3", "W8+smem", "W16")
SCAN = ("W0", "jvp", "W8", "W16")
SCAN_H = (1, 7, 50, 200, 400, 800)
PRAGMA = 'asm volatile(".pragma \\"enable_smem_spilling\\";");'
TEAM_ENTRY = "  extern __shared__ float mpt_team_smem[];\n  lin_team("


def variant(S, model, name: str):
    """S's kernel set with only K6's unit, changed as ``name`` says."""
    if name == "jvp":
        return k6_jvp_unit(S, model)
    parts = name.split("+")
    attrs = {"LIN_WARPS": int(parts[0][1:]), "UNITS": {"lin": ("linearize",)}}
    if "O3" in parts:
        attrs["UNIT_FLAGS"] = {"lin": ()}
    K = type("K6", (type(S),), attrs)(model, DT, w_q=S.P.w_q, w_dq=S.P.w_dq, w_u=S.P.w_u,
                                      w_terminal=S.P.wT[0], u_lim=S.P.u_lim)
    if "smem" in parts:
        K.sources["lin"] = K.sources["lin"].replace(TEAM_ENTRY, f"  {PRAGMA}\n{TEAM_ENTRY}")
    return K


def sass_count(K) -> int:
    """Instructions of ``mps_lin_kernel`` in the unit's library."""
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(K.build()["lin"].path)], capture_output=True, text=True,
                          check=True).stdout
    count, inside = 0, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "mps_lin_kernel" in line
        elif inside and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            count += 1
    return count


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_k6_variants: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    panda = catalog.panda()
    S = build_tracking_mpc(panda, Q_GOAL7, 50, DT).kernels
    sets = {name: variant(S, panda, name) for name in VARIANTS}
    failed = {}

    def build(name):
        try:
            sets[name].build()
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines() if re.search(r"ptxas|fatal|error|pragma", ln, re.I)]
            failed[name] = " | ".join(lines)[:1500] or str(e)[-1500:]

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sets)) as pool:
        list(pool.map(build, sets))
    out = {"card": card, "build_wall_s": time.perf_counter() - t0, "failed": failed}
    print(f"built {len(sets)} units in {out['build_wall_s']:.1f} s", flush=True)
    for name, why in failed.items():
        print(f"[failed] {name}: {why}", flush=True)
        sets.pop(name)
    for name, K in sets.items():
        attrs = K.kernel_attributes()["linearize"]
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", K.build()["lin"].log)
        fig = {"nvcc_s": K.build()["lin"].compile_seconds, "num_regs": attrs["num_regs"],
               "local_bytes": attrs["local_bytes"], "spill_bytes": sum(int(a) + int(b) for a, b in spills),
               "sass": sass_count(K)}
        if K.lin_team is not None:
            fig.update(K.team_attributes("linearize"), critical=K.lin_team.partition.critical)
        out[name] = fig
        print(f"[unit] {name} {json.dumps(fig)}", flush=True)

    lo, hi = panda.joint_lower.cpu().double().numpy(), panda.joint_upper.cpu().double().numpy()
    u_lim = panda.torque_limit.cpu().double().numpy()

    def states(H, seed):
        rng = np.random.default_rng(seed)
        q = (lo + hi) / 2 + rng.uniform(-0.8, 0.8, (H, 7)) * (hi - lo) / 2
        x = np.concatenate([q, rng.uniform(-0.5, 0.5, (H, 7))], 1)
        f32 = lambda a: torch.from_numpy(a.astype(np.float32)).cuda().contiguous()
        return f32(x), f32(rng.uniform(-0.3, 0.3, (H, 7)) * u_lim)

    for H in (50, 37, 1):
        xs, us = states(H, H)
        ref = S.linearize_plain(xs, us)
        for name, K in sets.items():
            if not torch.equal(K.linearize(xs, us).view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K6 {name} differs from the plain version at H={H}")
    print("[parity] every variant bitwise at H = 50, 37, 1", flush=True)

    def per_launch(fn, calls=20):
        for _ in range(2):
            [fn() for _ in range(calls)]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        [fn() for _ in range(calls)]
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    xs, us = states(50, 50)
    turns = {name: [] for name in sets}
    for _ in range(5):
        for name, K in sets.items():
            turns[name].append(per_launch(lambda: K.linearize(xs, us)))
    out["ms_H50"] = {name: statistics.median(v) for name, v in turns.items()}
    out["ms_H50_rounds"] = turns
    print(f"[time] H=50 per launch, medians of 5 rounds in turns: {json.dumps(out['ms_H50'])}", flush=True)
    scan = {}
    for H in SCAN_H:
        xh, uh = states(H, H)
        for name in SCAN:
            if name in sets:
                scan[f"{name}_H{H}"] = statistics.median(per_launch(lambda: sets[name].linearize(xh, uh))
                                                         for _ in range(3))
    out["scan_ms"] = scan
    print(f"[scan] per launch by H (lanes H*21): {json.dumps(scan)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
