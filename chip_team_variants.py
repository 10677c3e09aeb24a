#!/usr/bin/env python3
"""Measure what bounds K5 and K8, the closed-loop kernels whose step a team
of warps runs (``ops/cgen.py::team_function``), on one CUDA card.

Imports ``manipulapy_tpu_torch`` from ``--root`` (default: this file's
directory) and prints one JSON line per measurement, then one JSON object of
all of them:

* ``barrier``: the cycles one barrier costs (``clock64`` over 10000 in a
  row): ``bar.sync`` over 256 and 512 threads, and ``barrier.cluster`` over
  clusters of 2, 4 and 8 blocks of 32 threads;
* ``forward``: K8 a launch (20 back-to-back launches, 6 alphas, H=50) on
  the two-link arm, UR5 and Panda, held bitwise to ``forward_plain``, with
  its kernel's SASS instructions (``cuobjdump -sass``) and the cycles of one
  step at the card's largest SM clock; where the tree builds K8 as a team,
  for W = 8, 16 and 32 warps, with each team's phases, critical length,
  slots, crossing values and their loads;
* ``replay``: K5 on Panda at B = 32 (one team), 1024, 4096 and 16384, each
  variant held bitwise to the first: where the tree builds K5 as a team,
  the unit (W8 S32 T2), W8 S32 T1, W32 S32 T1, the unit without its row
  copies (``nocopy``: wrong results, timed only) and with the teams of a
  block on one barrier (``lockstep``); else the one-thread kernel with
  blocks of 32, 64 and 128 threads.

Inputs: x0 at rest inside the limits, nominal states from the open loop of
torques within 30% of 10 (two-link arm, UR5) or of 3 N m (Panda), gains of
0.01 scale, from ``torch.Generator`` seed 0. Run it on a tree and its
parent in one call:

    python3 chip_team_variants.py --root path/to/parent; python3 chip_team_variants.py

It needs one card and imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

H, DT, ALPHAS = 50, 0.01, 6
BARRIER_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void block_bar(int n, long long* out) {
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) asm volatile("bar.sync 1, %0;" :: "r"((int)blockDim.x) : "memory");
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
__global__ void cluster_bar(int n, long long* out) {
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
extern "C" int run(int cluster, int threads, int n, long long* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster > 0 ? cluster : 1;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster > 0 ? cluster : 1);
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cluster > 0 ? cudaLaunchKernelEx(&cfg, cluster_bar, n, out)
                                      : cudaLaunchKernelEx(&cfg, block_bar, n, out);
  return err != cudaSuccess ? (int)err : (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(parser.parse_args().root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_team_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from manipulapy_tpu_torch.models import catalog
    from manipulapy_tpu_torch.ops._build import nvcc_path
    from manipulapy_tpu_torch.ops.cuda_mpc_batch import BatchMPCKernels
    from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels

    out = {"root": root}
    smi = lambda q: subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                                   capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi("name,power.limit")
    mhz = float(smi("clocks.max.sm").split()[0])

    def report(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    def time_ms(fn, reps=5):
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

    def sass(K, unit, kernel):
        """Instructions of ``kernel`` in the unit's library."""
        cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        text = subprocess.run([cuobjdump, "-sass", str(K.build()[unit].path)], capture_output=True,
                              text=True, check=True).stdout
        count, inside = 0, False
        for line in text.splitlines():
            if "Function :" in line:
                inside = kernel in line
            elif inside and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                count += 1
        return count

    def build_all(sets):
        with concurrent.futures.ThreadPoolExecutor(len(sets)) as pool:
            for f in [pool.submit(K.build) for K in sets.values()]:
                f.result()

    same = lambda a, b: all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))
    team = hasattr(BatchMPCKernels, "TEAM_STAGE")
    gen = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")

    # Barriers.
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "barrier.cu"), os.path.join(tmp, "barrier.so")
        with open(cu, "w") as f:
            f.write(BARRIER_SOURCE)
        subprocess.run([nvcc_path(), "-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so, cu], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        ticks = torch.zeros(16, dtype=torch.int64, device="cuda")
        for cluster, threads in ((0, 256), (0, 512), (2, 32), (4, 32), (8, 32)):
            err = lib.run(cluster, threads, 10000, ctypes.c_void_p(ticks.data_ptr()))
            if err:
                raise RuntimeError(f"barrier probe failed with CUDA error {err}")
            name = f"cluster_{cluster}_blocks" if cluster else f"block_{threads}_threads"
            report(f"barrier_cycles_{name}", float(ticks[:max(cluster, 1)].double().mean()) / 10000)

    # K8 on three robots.
    robots = {r: catalog.get_robot(r) for r in ("two_link_planar", "ur5", "panda")}
    sets = {}
    for name, model in robots.items():
        lim = [10.0] * model.num_joints
        for w in (8, 16, 32) if team else (None,):
            attrs = {"UNITS": {"fwd": ("forward",)}, **({"FWD_WARPS": w} if w else {})}
            sets[name, w] = type("Variant", (SingleMPCKernels,), attrs)(model, DT, u_lim=lim)
    build_all(sets)
    for (name, w), S in sets.items():
        model = robots[name]
        n = model.num_joints
        lo, hi = model.joint_lower.clamp(-3, 3), model.joint_upper.clamp(-3, 3)
        x0 = torch.cat([(lo + hi) / 2, torch.zeros(n, device="cuda")]).contiguous()
        us = ((rand(H, n) * 2 - 1) * 3).contiguous()
        z = lambda *s: torch.zeros(s, device="cuda")
        xs = S.forward_plain(x0, z(H, 2 * n), us, z(H, n, 1 + 2 * n), x0[:n].contiguous(), z(1))[0][0]
        sd_x = torch.cat([x0[None], xs[:-1]]).contiguous()
        a = (x0, sd_x, us, ((rand(H, n, 1 + 2 * n) * 2 - 1) * 0.01).contiguous(), x0[:n].contiguous(),
             0.5 ** torch.arange(ALPHAS, device="cuda", dtype=torch.float32))
        if not same(S.forward(*a), S.forward_plain(*a)):
            raise AssertionError(f"K8 {name} W={w} differs from its plain version")
        ms = time_ms(lambda: [S.forward(*a) for _ in range(20)]) / 20
        rec = dict(ms=ms, cycles_a_step=ms * 1e3 * mhz / H, sass=sass(S, "fwd", "mps_fwd_kernel"),
                   statements=S.statements["forward"])
        if w:
            t = S.team
            rec.update(phases=t.partition.phases, critical=t.partition.critical, slots=t.slots,
                       crossings=sum(1 for c in t.crossings if c[1] >= 0), loads=sum(len(c[3]) for c in t.crossings))
        report(f"forward_{name}" + (f"_W{w}" if w else ""), rec)

    # K5 on Panda.
    panda = robots["panda"]
    lim = [87.0] * 4 + [12.0] * 3
    fwd = {"UNITS": {"fwd": ("linesearch_costs", "replay")}}
    if team:
        shapes = {"unit": {}, "W8_S32_T1": {"TEAM_PER_BLOCK": 1}, "W32_S32_T1": {"TEAM_WARPS": 32, "TEAM_PER_BLOCK": 1},
                  "nocopy": {}, "lockstep": {}}
    else:
        shapes = {f"T{t}": {"DEFINES": {"MPT_BLOCK": t}} for t in (128, 32, 64)}
    sets = {k: type("Variant", (BatchMPCKernels,), {**fwd, **v})(panda, DT, u_lim=lim) for k, v in shapes.items()}
    if team:
        K = sets["nocopy"]  # the row copies cut out: timing only
        for call in ("mpt_team_copy4", "mpt_team_copy"):
            line = f"      {call}(dst + e, ok ? base + (size_t)k * B + s : src, ok);\n"
            if line not in K.sources["fwd"]:
                raise AssertionError(f"K5's row copy {call} not found")
            K.sources = {"fwd": K.sources["fwd"].replace(line, "")}
        K = sets["lockstep"]  # one barrier for the block's teams: none returns early
        w, t = K.TEAM_WARPS, K.TEAM_PER_BLOCK
        K.sources = {"fwd": K.sources["fwd"]
                     .replace(f"mpt_team_sync(bar, {32 * w});", f"mpt_team_sync(bar, {32 * w * t});")
                     .replace("mpt_team_sync(bar, MPT_TEAM_THREADS);", "mpt_team_sync(bar, MPT_TEAM_THREADS * MPT_TEAM_PER_BLOCK);")
                     .replace("  if (b0 >= B) return;  // the whole team: its barrier is its own\n", "")
                     .replace("replay_team((int)threadIdx.x % MPT_TEAM_THREADS, 1 + team,",
                              "replay_team((int)threadIdx.x % MPT_TEAM_THREADS, 1,")}
        if sets["nocopy"].sources == sets["unit"].sources or sets["lockstep"].sources == sets["unit"].sources:
            raise AssertionError("a patched K5 variant is the unit itself")
    build_all(sets)
    report("replay_sass", {k: sass(V, "fwd", "mpt_replay_kernel") for k, V in sets.items()})
    lo, hi = panda.joint_lower, panda.joint_upper
    for B in (32, 1024, 4096, 16384):
        x0 = torch.cat([(lo + hi)[:, None] / 2 + (rand(7, B) * 2 - 1) * 0.25 * (hi - lo)[:, None],
                        torch.zeros(7, B, device="cuda")]).contiguous()
        us = ((rand(H, 7, B) * 2 - 1) * 3).contiguous()
        first = next(iter(sets.values()))
        z = lambda *s: torch.zeros(s, device="cuda")
        xs = first.replay(x0, z(H, 14, B), us, z(H, 7, 15, B), x0[:7].contiguous(), z(B))[0]
        a = (x0, torch.cat([x0[None], xs[:-1]]).contiguous(), us,
             ((rand(H, 7, 15, B) * 2 - 1) * 0.01).contiguous(), x0[:7].contiguous(), torch.full((B,), 0.5, device="cuda"))
        ref = first.replay(*a)
        for k, V in sets.items():
            if k != "nocopy" and not same(V.replay(*a), ref):
                raise AssertionError(f"K5 {k} differs from {next(iter(sets))} at B={B}")
            ms = time_ms(lambda: V.replay(*a))
            report(f"replay_B{B}_{k}", dict(ms=ms, cycles_a_step=ms * 1e3 * mhz / H))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
