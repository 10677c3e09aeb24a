#!/usr/bin/env python3
"""Build K2 (the batched linearization kernel) in the variants its design
was chosen from, and time each on one CUDA card.

For each robot (``--robots``) and each variant (``--variants``, names
below, or ``all``), builds K2's unit alone (all units at once, one nvcc
each, ``--limit`` seconds each at most), prints its nvcc seconds, the
ptxas report, its registers, local and shared bytes, holds it bitwise
against the plain linearization at (B, H) = (257, 8), (1024, 50), (3, 1),
and prints CUDA-event medians of K2 at H=50 for each B of ``--widths``.
States lie inside the joint limits, velocities in [-0.5, 0.5], torques
within 30% of the limits, from ``torch.Generator`` seed 0. A variant is
the unit as ``BatchMPCKernels`` builds it, changed in one or more ways:

* ``unit``: as built (G = LIN_SEEDS, lean order, ptxas -O1, blocks of
  LIN_BLOCK, shared-memory spilling);
* ``G<k>``: k seeds a thread (k must divide 3n; others are skipped);
* ``O3``: ptxas's default optimisation level instead of -O1;
* ``T<k>``: k threads a block;
* ``nosmem``: without the shared-memory spilling pragma;
* ``nokeep``: ``mpt_keep`` an identity the compiler sees through;
* ``interleaved``: the step emitted in the plain order instead of the
  lean one (``ops/fd_step.py::_emit_dynamics``);

joined with ``+``, e.g. ``interleaved+O3+T128+nosmem``. The last line is
one JSON object of every variant's numbers.

    python3 chip_k2_variants.py --variants unit,G7,interleaved+O3+T128+nosmem

It needs one card and imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import torch

from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.ops import _build
from manipulapy_tpu_torch.ops import cuda_mpc_batch as cmb
from manipulapy_tpu_torch.ops import fd_step

PARITY = ((257, 8), (1024, 50), (3, 1))


def kernel_set(model, variant: str):
    """K2-K5 for ``model`` at dt 0.01, its lin unit changed as ``variant``
    says; only the lin unit is built."""
    parts = set(variant.split("+")) - {"unit"}
    attrs = {"UNITS": {"lin": ("linearize",)}}
    for p in parts:
        if p.startswith("G"):
            attrs["LIN_SEEDS"] = int(p[1:])
        elif p == "O3":
            attrs["UNIT_FLAGS"] = {}
    n = model.num_joints
    if (3 * n) % attrs.get("LIN_SEEDS", cmb.LIN_SEEDS):
        return None
    planes = fd_step.build_fd_step_jvp_planes
    if "interleaved" in parts:  # the group source asks for lean=True
        fd_step.build_fd_step_jvp_planes = lambda *a, **k: planes(*a, **{**k, "lean": False})
    try:
        K = type("Variant", (cmb.BatchMPCKernels,), attrs)(model, 0.01, u_lim=[10.0] * n)
    finally:
        fd_step.build_fd_step_jvp_planes = planes
    src = K.sources["lin"]
    for p in parts:
        if p.startswith("T"):
            src = src.replace(f"#define MPT_LIN_BLOCK {cmb.LIN_BLOCK}\n", f"#define MPT_LIN_BLOCK {int(p[1:])}\n")
        elif p == "nosmem":
            src = src.replace('  asm volatile(".pragma \\"enable_smem_spilling\\";");\n', "")
        elif p == "nokeep":
            src = src.replace('  asm volatile("" : "+f"(v));\n', "")
    K.sources["lin"] = src
    return K


def time_ms(fn, reps: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--robots", default="panda,ur5")
    parser.add_argument("--variants", default="unit")
    parser.add_argument("--widths", default="1024,4096,16384")
    parser.add_argument("--limit", type=float, default=300.0, help="nvcc seconds a unit may take")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k2_variants: no CUDA device is available", file=sys.stderr)
        return 1
    run = subprocess.run
    _build.subprocess = type("Limited", (), {"run": staticmethod(lambda *a, **k: run(*a, timeout=args.limit, **k))})
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print("card", card, flush=True)
    sets = {}
    for robot in args.robots.split(","):
        model = catalog.get_robot(robot)
        for variant in args.variants.split(","):
            K = kernel_set(model, variant)
            if K is not None:
                sets[robot, variant] = (model, K)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sets)) as pool:
        futures = {key: pool.submit(K.build) for key, (_, K) in sets.items()}
    built = {}
    for key, f in futures.items():
        try:
            built[key] = f.result()["lin"]
        except (RuntimeError, subprocess.TimeoutExpired) as err:
            print(f"{key[0]} {key[1]}: not built: {str(err).splitlines()[0]}", flush=True)
    print(f"build wall {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"card": card}
    for (robot, variant), lib in built.items():
        model, K = sets[robot, variant]
        n = model.num_joints
        gen = torch.Generator("cuda").manual_seed(0)
        lo, hi = model.joint_lower[None, :, None], model.joint_upper[None, :, None]
        u_lim = model.torque_limit[None, :, None]

        def states(B, H):
            r = lambda *s: torch.rand(s, generator=gen, device="cuda") * 2 - 1
            q = (lo + hi) / 2 + r(H, n, B) * 0.5 * (hi - lo) / 2
            return torch.cat([q, r(H, n, B) * 0.5], 1).contiguous(), (r(H, n, B) * 0.3 * u_lim).contiguous()

        rec = out[f"{robot}:{variant}"] = {"seeds": K.LIN_SEEDS, "nvcc_s": lib.compile_seconds,
                                           "group_statements": K.statements["linearize_group"],
                                           **K.kernel_attributes()["linearize"]}
        for B, H in PARITY:
            xs, us = states(B, H)
            got, ref = K.linearize(xs, us), K.linearize_plain(xs, us)
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"{robot} {variant}: K2 differs from its plain version at B={B} H={H}")
        for B in [int(b) for b in args.widths.split(",") if b]:
            xs, us = states(B, 50)
            rec[f"ms_B{B}"] = time_ms(lambda: K.linearize(xs, us))
        ptxas = " | ".join(ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln)
        print(f"{robot} {variant}: " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                                for k, v in rec.items()) + f" ptxas={ptxas!r}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
