#!/usr/bin/env python3
"""K8's design variants on one CUDA card: the team K8 (the emitted step
split over a team of warps) against the looped K8 (``csrc/fwd_loop_lanes.cuh``,
one warp an alpha) built for 1, 2, 4 and 8 warps a block, and timing-only
variants of the looped step that show where its time goes.

Per robot (the programmatic Panda, the Jaco's 8-joint chain, the 10-joint
Jaco, the Robotiq gripper, the programmatic UR5): every unit built at once
(one nvcc each), ptxas's registers and spills, SASS instructions
(``cuobjdump``); each looped unit bitwise its plain version
(``loop_forward_plain``) at H=50, A=6 on the card; then every variant timed
in turns by ``chip_smoke.k8_turns`` (forward, then backward through the
list, twice; each turn a launch's device time over ``chip_smoke.K8_CALLS``
back-to-back launches; per variant the turns, their median and their
spread), at A=6 and A=1. The inputs: rest at the
middle of the limits, zero nominal torques, gains from K7 on the emitted
form's nominal.

The timing-only variants (``--diagnose``, on the Panda and the 10-joint
Jaco) patch the looped unit's source (each edit's text must be found in it,
or the script stops) and compute wrong values: ``nosync``
drops the lanes' ``__syncwarp``; ``fastsin`` takes ``__sinf``/``__cosf``;
``unroll_links`` unrolls the loop over links; ``no_solve`` skips the
Cholesky factor and both solves; ``smem_table`` reads the robot's table
from shared memory instead of the launch's parameter space.

Prints one JSON line per robot. Run from the repository root on a machine
with a card:

    python3 chip_k8_variants.py [--diagnose]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import time

import numpy as np
import torch

import chip_smoke as cs
from manipulapy_tpu_torch.models import catalog, host_arrays, robot_data
from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels

H, WARPS = 50, (1, 2, 4, 8)
FACTOR = "  // The Cholesky factor, column by column (mpt_chol_factor): lane j forms"
EULER = "  // Semi-implicit Euler and the clamps (fd_step_loop), lane j's joint."
CALL = ("  __shared__ float sm[MPT_L_FLOATS];\n  fwd_loop_block((int)threadIdx.x, sm, x0, sd_x, sd_u, kK, goal, alphas, xs, "
        "us, costs, H, A,\n                 (int)blockIdx.x * MPT_FWDL_WARPS, tab.v);")
LOOP = ("#pragma unroll 1\n  for (int k = 0; k < MPT_NJ; ++k) {\n    const float* L = tab + MPT_TAB_HEAD + k * "
        "MPT_TAB_STRIDE;\n    const float* A = L + MPT_TAB_A;\n    const float dqk = X[")
DIAGNOSTICS = {
    "nosync": [("  __syncwarp();\n#elif", "\n#elif")],
    "fastsin": [("const float s = sinf(qk), c = cosf(qk);", "const float s = __sinf(qk), c = __cosf(qk);")],
    "unroll_links": [(LOOP, LOOP.replace("#pragma unroll 1", "#pragma unroll"))],
    "no_solve": [(FACTOR, "#if 0\n" + FACTOR), (EULER, "#endif\n  const float x_own = bias + uj;\n" + EULER)],
    "smem_table": [(CALL, CALL.replace("tab.v);", "st);").replace(
        "  __shared__ float sm[MPT_L_FLOATS];\n",
        "  __shared__ float sm[MPT_L_FLOATS];\n  __shared__ float st[MPT_TAB_FLOATS + MPT_COST_FLOATS];\n"
        "  for (int i = threadIdx.x; i < MPT_TAB_FLOATS + MPT_COST_FLOATS; i += blockDim.x) st[i] = tab.v[i];\n"
        "  __syncthreads();\n"))],
}
ROBOTS = {
    "panda": lambda: catalog.panda(dtype=torch.float32),
    "jaco_7dof": lambda: robot_data.load_robot("jaco_7dof", chain_joints_only=True),
    "jaco_7dof (10 joints)": lambda: robot_data.load_robot("jaco_7dof"),
    "robotiq_2f_85": lambda: robot_data.load_robot("robotiq_2f_85", chain_joints_only=True),
    "ur5": lambda: catalog.ur5(dtype=torch.float32),
}
DIAGNOSED = ("panda", "jaco_7dof (10 joints)")


def k8_set(full: SingleMPCKernels, model, form: str, warps: int = None, edits=()) -> SingleMPCKernels:
    """K8 alone in ``form`` (``chip_smoke.k8_only``; the looped one for
    ``warps`` a block), its unit's source patched by ``edits``."""
    K = cs.k8_only(full, model, form, **({"FWD_LOOP_WARPS": warps} if warps else {}))
    for a, b in edits:
        if a not in K.sources["fwd"]:
            raise AssertionError(f"the looped unit has no {a[:50]!r}")
        K.sources["fwd"] = K.sources["fwd"].replace(a, b)
    return K


def inputs(model, full: SingleMPCKernels):
    """x0 at rest at the middle of the limits, a goal near it, zero nominal
    torques, their open loop as the nominal and K7's gains on it."""
    n, nx = model.num_joints, 2 * model.num_joints
    f32 = dict(dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    lo, hi = (np.clip(v.cpu().double().numpy(), -np.pi, np.pi) for v in (model.joint_lower, model.joint_upper))
    x0 = cs.mid_rest(model)
    goal = torch.tensor(((lo + hi) / 2 + rng.uniform(-0.3, 0.3, n) * (hi - lo) / 2).astype(np.float32), device="cuda")
    us = torch.zeros((H, n), **f32)
    xs0 = full.forward(x0, torch.zeros((H, nx), **f32), us, torch.zeros((H, n, 1 + nx), **f32), goal,
                       torch.zeros((1,), **f32))[0][0]
    sd_x = torch.cat([x0[None], xs0[:-1]]).contiguous()
    kK = full.backward(full.linearize(sd_x, us), sd_x, us, goal, cs.terminal_value(full, xs0[-1], goal),
                       torch.tensor(1e-6, **f32))
    return x0, sd_x, us, kK, goal


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--diagnose", action="store_true", help="also the timing-only variants")
    args = parser.parse_args()
    t0 = time.perf_counter()
    card = cs.card_line()
    sets = {}
    for name, make in ROBOTS.items():
        model = make()
        full = SingleMPCKernels(model, cs.DT, u_lim=list(host_arrays(model)["torque_limit"]))
        variants = {"team": k8_set(full, model, "emitted"),
                    **{f"W{w}": k8_set(full, model, "looped", w) for w in WARPS}}
        if args.diagnose and name in DIAGNOSED:
            variants.update({d: k8_set(full, model, "looped", edits=e) for d, e in DIAGNOSTICS.items()})
        sets[name] = (model, full, variants)
    with concurrent.futures.ThreadPoolExecutor(cs.nvcc_workers()) as pool:
        futures = [pool.submit(K.build) for _, full, variants in sets.values() for K in (full, *variants.values())]
        for f in futures:
            f.result()
    print(json.dumps({"card": card, "build_s": round(time.perf_counter() - t0, 1)}), flush=True)
    for name, (model, full, variants) in sets.items():
        x0, sd_x, us, kK, goal = inputs(model, full)
        out = {"robot": name, "joints": model.num_joints, "card": card, "H": H,
               "fwd_statements": variants["team"].statements["forward"], "figures": {}, "max_abs_err": {}, "ms": {}}
        for v, K in variants.items():
            lib = K.build()["fwd"]
            a = K.kernel_attributes()["forward"]
            out["figures"][v] = {"num_regs": a["num_regs"], "local_bytes": a["local_bytes"],
                                 "smem_bytes": a["smem_bytes"], "sass_instructions": cs.sass_count(str(lib.path)),
                                 "ptxas": cs.ptxas_lines(lib.log)}
        for A in (6, 1):
            a_args = (x0, sd_x, us, kK, goal, 0.5 ** torch.arange(A, dtype=torch.float32, device="cuda"))
            if A == 6:
                ref = variants["W1"].plain().forward(*a_args)
                for w in WARPS:
                    got = variants[f"W{w}"].forward(*a_args)
                    out["max_abs_err"][f"W{w}"] = err = max(cs.bit_diff(g, r) for g, r in zip(got, ref))
                    if err != 0.0:
                        raise AssertionError(f"{name}: the looped K8 at {w} warps a block, max |d| = {err}, not 0")
            out["ms"][f"A{A}"] = cs.k8_turns(variants, a_args)
        out["t_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
