"""One fleet robot's batched fused solve, the port's against the JAX
package's, on the CPU: the fleet benchmark's problem.

Not collected by pytest (JAX's batched solve of a 6- or 7-joint robot takes
tens of minutes to compile in interpret mode, and hours to run). Run by hand
from the repository's root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fleet_cost_parity.py ROBOT OUT_DIR [witness|gains|solve] [S]

The problem is ``benchmarks/fleet_benchmark.py``'s (``:67-81``, ``:185-197``):
one ``default_rng(0)`` drawn in the fleet's order, B=1024 a robot, the
limits without inf clipped to +-pi, goals mid +- 0.3 half, q0 mid +- 0.2
half, at rest; H=50, 4 iterations, dt 0.01, float32, zero warm start.

``witness`` (the default) holds the port's solve to JAX's generic dynamics
(``dynamics.forward_dynamics_fast``, semi-implicit Euler and the position
clamps, no velocity clamp: the step JAX's batched kernels inline), which
compiles in a minute:

* controls: the port's plain solve of all B scenarios; its controls rolled
  out by JAX's step and scored by the batched solver's cost
  (``mpc/fused_batch.py:398-422``) in float64: the port's cost, states and
  zero-control cost against JAX's, scenario by scenario, and the controls
  inside the torque limits;
* sensitivity: the port's solve again from q0 moved by one float32 ulp,
  and the fewest scenarios whose return to their zero-control cost would
  lift the port's mean to ``benchmarks/fleet_results.json``'s;
* linearization: at the first iteration's nominal (the zero-control
  rollout) of the first S scenarios, the port's K2 plain version against
  ``jax.jacfwd`` of JAX's step.

``gains``: at that nominal, the port's K3 plain version against JAX's
backward kernel in interpret mode (one ``pallas_call``; a grid cell of S
scenarios, ``_SUB``, ``_LANE`` set to 1, S before the build).

``solve`` runs JAX's whole batched solve in interpret mode on the first S
scenarios beside the port's (finishes for the one-joint grippers).

Prints each figure and writes them to ``OUT_DIR/fleet_cost_parity_<robot>_<mode>.json``.
"""

import json
import os
import sys
import time

import numpy as np

B, H, ITERS, DT, G = 1024, 50, 4, 0.01, (0.0, 0.0, -9.81)
W_Q, W_DQ, W_U, W_T = 10.0, 0.5, 1e-4, 100.0  # the batched solver's defaults


def fleet_keys(robot_data):
    """The fleet benchmark's robots: the first key of each URDF."""
    seen, keys = set(), []
    for key in robot_data.list_robots():
        urdf = robot_data.ROBOT_DATABASE[key].urdf
        if urdf not in seen:
            seen.add(urdf)
            keys.append(key)
    return keys


def draws(key, jax_robot_data, jax_host_arrays, port_robot_data, jnp):
    """(x0 (B, 2n), goals (B, n)) of ``key``: the stream of default_rng(0)
    advanced through the robots before it in the fleet's order."""
    rng = np.random.default_rng(0)
    for k in fleet_keys(port_robot_data):
        host = jax_host_arrays(jax_robot_data.load_robot(k, dtype=jnp.float32, chain_joints_only=True))
        lo = np.clip(np.nan_to_num(host["joint_lower"], neginf=-np.pi, posinf=np.pi), -np.pi, np.pi)
        hi = np.clip(np.nan_to_num(host["joint_upper"], neginf=-np.pi, posinf=np.pi), -np.pi, np.pi)
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        n = len(lo)
        goals = (mid + rng.uniform(-0.3, 0.3, (B, n)) * half).astype(np.float32)
        q0 = (mid + rng.uniform(-0.2, 0.2, (B, n)) * half).astype(np.float32)
        if k == key:
            return np.concatenate([q0, np.zeros_like(q0)], axis=1), goals
    raise KeyError(f"{key} is not a fleet robot")


def tracking_cost(xs, us, goals):
    """The batched solver's cost in float64: xs (B, H+1, 2n) from x0, us
    (B, H, n)."""
    xs, us, goals = (np.asarray(a, np.float64) for a in (xs, us, goals))
    n = goals.shape[1]
    e, v = xs[:, :, :n] - goals[:, None], xs[:, :, n:]
    stage = (W_Q * e[:, :-1] ** 2 + W_DQ * v[:, :-1] ** 2).sum((1, 2)) + (W_U * us ** 2).sum((1, 2))
    return stage + (W_T * e[:, -1] ** 2 + 0.1 * W_T * v[:, -1] ** 2).sum(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.abs(b)).max())


def scaled(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def first_iteration(tm, x0, goals, S):
    """The port's first iteration on the first S scenarios, from zero
    controls: the handle, the staged x0 and goals, the controls, the
    nominal rollout, its pre-step states and K2's plain linearization."""
    import torch

    from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc

    n = goals.shape[1]
    small = build_batch_tracking_mpc(tm, goals[:S], S, H, DT, iterations=ITERS)
    x0_t, goal_t = torch.from_numpy(x0[:S]).T.contiguous(), torch.from_numpy(goals[:S]).T.contiguous()
    us0 = torch.zeros(H, n, S)
    xs0, _, _ = small.replay(x0_t, torch.zeros(H, 2 * n, S), us0, torch.zeros(H, n, 1 + 2 * n, S), goal_t, torch.zeros(S))
    sd_x = torch.cat([x0_t[None], xs0[:-1]]).contiguous()
    return small, x0_t, goal_t, us0, xs0, sd_x, small.linearize(sd_x, us0)  # AB: (H, 2n, 3n, S)


def witness(key, S, jax, jnp, jm, tm, x0, goals, out):
    import torch

    from manipulapy_tpu.dynamics import forward_dynamics_fast
    from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc

    n, nx = goals.shape[1], 2 * goals.shape[1]
    g = jnp.asarray(G, jnp.float32)

    def f(x, u):  # one scenario's step: JAX's generic dynamics, Euler, the position clamps
        q, dq = x[:n], x[n:]
        dq2 = dq + forward_dynamics_fast(jm, q, dq, u, g) * DT
        return jnp.concatenate([jnp.clip(q + dq2 * DT, jm.joint_lower, jm.joint_upper), dq2])

    def body(x, u):
        x2 = jax.vmap(f)(x, u)
        return x2, x2

    @jax.jit
    def rollout(x0, us):  # (B, 2n), (B, H, n) -> (B, H+1, 2n)
        _, xs = jax.lax.scan(body, x0, jnp.swapaxes(us, 0, 1))
        return jnp.concatenate([x0[:, None], jnp.swapaxes(xs, 0, 1)], axis=1)

    # 1. The port's solve of all B scenarios, its controls through JAX's step.
    t0 = time.perf_counter()
    mpc = build_batch_tracking_mpc(tm, goals, B, H, DT, iterations=ITERS)
    us, xs, cost = (v.numpy() for v in mpc.solve(torch.from_numpy(x0), torch.zeros(B, H, n)))
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jxs = np.asarray(rollout(jnp.asarray(x0), jnp.asarray(us)))
    jxs0 = np.asarray(rollout(jnp.asarray(x0), jnp.zeros((B, H, n), jnp.float32)))
    jax_s = time.perf_counter() - t0
    jcost, jcost0 = tracking_cost(jxs, us, goals), tracking_cost(jxs0, np.zeros_like(us), goals)
    port0 = build_batch_tracking_mpc(tm, goals, B, H, DT, iterations=0)
    cost0 = port0.solve(torch.from_numpy(x0), torch.zeros(B, H, n))[2].numpy()
    u_lim = np.asarray(tm.torque_limit, np.float64)
    out["controls"] = {
        "B": B, "port_mean_cost": float(cost.mean()), "jax_mean_cost_of_port_controls": float(jcost.mean()),
        "cost_max_rel_diff": rel(cost, jcost), "final_state_max_abs_diff": float(np.abs(xs[:, -1] - jxs[:, -1]).max()),
        "states_max_abs_diff": float(np.abs(xs - jxs).max()),
        "port_mean_zero_control_cost": float(cost0.mean()), "jax_mean_zero_control_cost": float(jcost0.mean()),
        "zero_control_cost_max_rel_diff": rel(cost0, jcost0),
        "controls_inside_limits": bool((np.abs(us) <= u_lim).all()), "finite": bool(np.isfinite(cost).all()),
        "improved_scenarios": int((cost < cost0).sum()), "port_solve_s": port_s, "jax_rollouts_s": jax_s,
    }
    print("controls", out["controls"], flush=True)

    # 2. The same solve from q0 moved by one float32 ulp; and the fewest
    # scenarios whose return to their zero-control cost would lift the
    # port's mean to the benchmark's recorded one.
    x0_ulp = x0.copy()
    x0_ulp[:, :n] = np.nextafter(x0[:, :n], np.float32(np.inf))
    cost_ulp = mpc.solve(torch.from_numpy(x0_ulp), torch.zeros(B, H, n))[2].numpy()
    with open(os.path.join(os.path.dirname(__file__), "..", "benchmarks", "fleet_results.json")) as fh:
        recorded = json.load(fh)["robots"][key]["mean_cost"]
    lift = np.cumsum(np.sort(cost0 - cost)[::-1])
    out["sensitivity"] = {
        "one_ulp_mean_cost": float(cost_ulp.mean()), "one_ulp_scenarios_moved_1pct": int((np.abs(cost_ulp - cost) > 0.01 * cost).sum()),
        "one_ulp_max_rel_diff": rel(cost_ulp, cost), "recorded_mean_cost": recorded,
        "scenarios_at_zero_control_cost_for_recorded_mean": int(np.searchsorted(lift, (recorded - cost.mean()) * B) + 1),
    }
    print("sensitivity", out["sensitivity"], flush=True)

    # 3. The first iteration's linearization on the first S scenarios.
    _, _, _, us0, _, sd_x, AB = first_iteration(tm, x0, goals, S)
    t0 = time.perf_counter()
    xx = jnp.asarray(sd_x.permute(0, 2, 1).reshape(H * S, nx).numpy())
    uu = jnp.asarray(us0.permute(0, 2, 1).reshape(H * S, n).numpy())
    jac = np.concatenate([np.asarray(jax.jit(jax.vmap(jax.jacfwd(f, i)))(xx, uu)) for i in (0, 1)], axis=-1)
    jac = jac.reshape(H, S, nx, nx + n).transpose(0, 2, 3, 1)
    ab = AB.numpy()
    out["linearization"] = {
        "S": S, "max_abs_diff_q_rows": float(np.abs(ab[:, :n] - jac[:, :n]).max()),
        "max_abs_diff_dq_rows": float(np.abs(ab[:, n:] - jac[:, n:]).max()),
        "scale_q_rows": float(np.abs(jac[:, :n]).max()), "scale_dq_rows": float(np.abs(jac[:, n:]).max()),
        "max_rel_diff_to_scale": scaled(ab, jac), "jax_s": time.perf_counter() - t0,
    }
    print("linearization", out["linearization"], flush=True)


def gains(key, S, jnp, jm, tm, x0, goals, out):
    import torch

    import manipulapy_tpu.mpc.fused_batch as jax_fused_batch

    small, _, goal_t, us0, xs0, sd_x, AB = first_iteration(tm, x0, goals, S)
    reg = torch.full((S,), 1e-6)
    kK = small.backward(AB, sd_x, us0, xs0[-1].contiguous(), goal_t, reg).numpy()
    t0 = time.perf_counter()
    jax_fused_batch._SUB, jax_fused_batch._LANE, jax_fused_batch._TILE_B = 1, S, S
    jmpc = jax_fused_batch.build_batch_tracking_mpc(jm, jnp.asarray(goals[:S]), S, H, DT, iterations=ITERS, interpret=True)
    tile = lambda t: jnp.asarray(np.asarray(t)[None, ..., None, :])  # (..., S) -> (1, ..., 1, S)
    jkK = np.asarray(jmpc.backward(tile(AB), tile(sd_x), tile(us0), tile(xs0[-1]), tile(goal_t), tile(reg)))[0][..., 0, :]
    out["gains"] = {
        "S": S, "max_abs_diff_k": float(np.abs(kK[:, :, 0] - jkK[:, :, 0]).max()),
        "scale_k": float(np.abs(jkK[:, :, 0]).max()), "max_abs_diff_K": float(np.abs(kK[:, :, 1:] - jkK[:, :, 1:]).max()),
        "scale_K": float(np.abs(jkK[:, :, 1:]).max()), "max_rel_diff_to_scale": scaled(kK, jkK),
        "jax_interpret_s": time.perf_counter() - t0,
    }
    print("gains", out["gains"], flush=True)


def solve(key, S, jnp, jm, tm, x0, goals, out):
    import torch

    import manipulapy_tpu.mpc.fused_batch as jax_fused_batch
    from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc

    x0, goals = x0[:S], goals[:S]
    n = goals.shape[1]
    t0 = time.perf_counter()
    mpc = build_batch_tracking_mpc(tm, goals, S, H, DT, iterations=ITERS)
    port = mpc.solve(torch.from_numpy(x0), torch.zeros(S, H, n))[2].numpy()
    out["port"] = {"cost": port.tolist(), "seconds": time.perf_counter() - t0}
    print("port", out["port"], flush=True)
    t0 = time.perf_counter()
    jax_fused_batch._SUB, jax_fused_batch._LANE, jax_fused_batch._TILE_B = 1, S, S
    jmpc = jax_fused_batch.build_batch_tracking_mpc(jm, jnp.asarray(goals), S, H, DT, iterations=ITERS, interpret=True)
    ref = np.asarray(jmpc.solve(jnp.asarray(x0), jnp.zeros((S, H, n), jnp.float32))[2])
    out["jax"] = {"cost": ref.tolist(), "seconds": time.perf_counter() - t0}
    out["rel_diff"] = (np.abs(port - ref) / np.abs(ref)).tolist()
    print("jax", out["jax"], "rel_diff", out["rel_diff"], flush=True)


def main(key: str, out_dir: str, mode: str = "witness", S: int = 8) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from manipulapy_tpu.models import robot_data as jax_robot_data
    from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
    from manipulapy_tpu_torch.models import from_host_arrays
    from manipulapy_tpu_torch.models import robot_data as port_robot_data

    x0, goals = draws(key, jax_robot_data, jax_host_arrays, port_robot_data, jnp)
    jm = jax_robot_data.load_robot(key, dtype=jnp.float32, chain_joints_only=True)
    tm = from_host_arrays(jax_host_arrays(jm), device="cpu")
    out = {"robot": key, "mode": mode}
    if mode == "witness":
        witness(key, S, jax, jnp, jm, tm, x0, goals, out)
    elif mode in ("gains", "solve"):
        (gains if mode == "gains" else solve)(key, S, jnp, jm, tm, x0, goals, out)
    else:
        raise SystemExit(f"mode must be witness, gains or solve, got {mode!r}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"fleet_cost_parity_{key}_{mode}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *(sys.argv[3:4]), *(int(a) for a in sys.argv[4:5]))
