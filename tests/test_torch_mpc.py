"""The port's generic MPC layer against the JAX package's.

* Forward-mode cgen values (``ops/cgen.py::Dual``) against ``jax.jvp`` on
  sin, cos, sqrt, the reciprocal, the clamp (tangent halved exactly at a
  bound) and a composite, with a leading seed axis; f64, 1e-12.
* The matrix small solves (``ops/smallinalg.py``) against JAX; f64, 1e-9.
* The cost library (``mpc/costs.py``) and its gradients against JAX; f64,
  1e-9.
* The generic iLQR (``mpc/ilqr.py``, ``torch.func`` derivatives) against
  JAX's on the 2R arm; f64, 1e-7 (the two sum matrix products in other
  orders, and the iteration carries the difference).

The batched fused solver and its kernels are in
``tests/test_torch_mpc_batch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc import costs as jcosts
from manipulapy_tpu.mpc.ilqr import ILQRParams as JParams, ilqr as jax_ilqr, make_step_fn as jax_step_fn
from manipulapy_tpu.mpc.pscan import parallel_riccati as jax_pscan
from manipulapy_tpu.ops import smallinalg as jsl
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.mpc import costs as tcosts
from manipulapy_tpu_torch.mpc.ilqr import ILQRParams, ilqr, make_step_fn, mpc_step, riccati_sweep
from manipulapy_tpu_torch.mpc.pscan import parallel_riccati
from manipulapy_tpu_torch.ops import cgen as cg
from manipulapy_tpu_torch.ops import smallinalg as tsl

CPU = torch.device("cpu")
G0 = (0.0, 0.0, 0.0)  # gravity-free keeps the toy problems well-conditioned, as in the JAX tests


def close(port, ref, tol=1e-9):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Forward-mode cgen values
# ---------------------------------------------------------------------------

DUAL_CASES = {
    "sin": (cg.sin, jnp.sin, [-2.0, -0.3, 0.0, 0.7, 3.0]),
    "cos": (cg.cos, jnp.cos, [-2.0, -0.3, 0.0, 0.7, 3.0]),
    "sqrt": (cg.sqrt, jnp.sqrt, [0.01, 0.5, 1.0, 4.0, 9.0]),
    "recip": (cg.recip, lambda x: 1.0 / x, [-3.0, -0.5, 0.25, 1.0, 7.0]),
    # Outside, at the lower bound, inside, at the upper bound, outside.
    "clip": (lambda v: cg.clip(v, -1.0, 2.0), lambda x: jnp.clip(x, -1.0, 2.0), [-1.5, -1.0, 0.3, 2.0, 2.5]),
    "clip_upper_only": (lambda v: cg.clip(v, -np.inf, 2.0), lambda x: jnp.clip(x, -np.inf, 2.0), [-9.0, 0.0, 2.0, 2.5, 1.0]),
    "composite": (
        lambda v: cg.sub(cg.mul(cg.sin(v), v), cg.mul(2.0, cg.recip(cg.add(v, 3.0)))) * 0.5 - v,
        lambda x: (jnp.sin(x) * x - 2.0 * (1.0 / (x + 3.0))) * 0.5 - x,
        [-1.0, 0.0, 0.5, 1.5, 2.5],
    ),
}


@pytest.mark.parametrize("case", sorted(DUAL_CASES))
def test_dual_matches_jax_jvp(case):
    port_fn, jax_fn, xs = DUAL_CASES[case]
    x = np.asarray(xs, dtype=np.float64)
    seeds = np.random.default_rng(0).normal(size=(3, x.size))  # leading seed axis
    out = port_fn(cg.Dual(torch.from_numpy(x), torch.from_numpy(seeds)))
    primal, tangent = jax.vmap(lambda s: jax.jvp(jax_fn, (jnp.asarray(x),), (s,)))(jnp.asarray(seeds))
    close(cg.primal(out).numpy(), primal[0], 1e-12)
    close(cg.tangent(out).numpy(), tangent, 1e-12)


def test_dual_clip_tangent_is_half_at_a_bound():
    x = torch.tensor([-1.5, -1.0, 0.3, 2.0, 2.5, float("nan")])
    t = cg.tangent(cg.clip(cg.Dual(x, torch.ones(2, 6)), -1.0, 2.0))
    assert t[:, :5].tolist() == [[0.0, 0.5, 1.0, 0.5, 0.0]] * 2
    assert t[:, 5].tolist() == [0.0, 0.0]  # a NaN primal has tangent 0, as in JAX


def test_dual_folds_zero_tangents_and_emits_c():
    em = cg.Emitter()
    x, s = cg.CVar(em, "x"), cg.CVar(em, "s")
    d = cg.Dual(x, s)
    assert cg.mul(d, 0.0) == 0.0  # primal and tangent fold: a constant
    assert cg.add(d, 0.0) is d
    assert cg.dual(x, 0.0) is x  # a zero tangent leaves the primal
    assert cg.tangent(2.0) == 0.0 and cg.primal(x) is x
    y = cg.sin(d) * 3.0
    assert isinstance(y, cg.Dual) and y.p.name != y.t.name
    assert em.lines[:4] == [
        "const float t0 = sinf(x);",
        "const float t1 = cosf(x);",
        "const float t2 = s * t1;",
        "const float t3 = t0 * 3.000000000e+00f;",
    ]
    c = cg.clip(d, -1.0, 2.0)
    assert "? s : ((x == (-1.000000000e+00f) || x == 2.000000000e+00f) ? s * 5.000000000e-01f" in em.lines[-1]
    assert isinstance(c, cg.Dual)


def test_c_function_signature_and_statement_count():
    src, ops = cg.c_function(
        "f", [("a", 2)], ["w"], [("out", 2)], lambda a, w: [[cg.mul(a[0], w), cg.add(a[1], 1.0)]]
    )
    assert src.startswith("static __device__ __forceinline__ void f(")
    assert "const float a[2]," in src and "float w," in src and "float out[2])" in src
    assert "out[0] = t0;" in src and "out[1] = t1;" in src and ops == 2
    with pytest.raises(ValueError):
        cg.c_function("g", [("a", 2)], [], [("out", 3)], lambda a: [[a[0]]])


# ---------------------------------------------------------------------------
# Small solves
# ---------------------------------------------------------------------------


def test_matrix_small_solves_match_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 5, 5))
    M = A @ A.transpose(0, 2, 1) + 5 * np.eye(5)
    rhs = rng.normal(size=(4, 5, 3))
    C, J = rng.normal(size=(2, 4, 6, 6))
    G = np.eye(6) + (C @ C.transpose(0, 2, 1)) @ (J @ J.transpose(0, 2, 1))
    rhs_g = rng.normal(size=(4, 6, 2))
    tM = torch.from_numpy(M)
    close(tsl.solve_spd_small_mat(tM, torch.from_numpy(rhs)).numpy(), jsl.solve_spd_small_mat(jnp.asarray(M), jnp.asarray(rhs)))
    close(
        tsl.chol_solve_small_mat(tsl.chol_factor_small(tM), torch.from_numpy(rhs)).numpy(),
        jsl.chol_solve_small_mat(jsl.chol_factor_small(jnp.asarray(M)), jnp.asarray(rhs)),
    )
    close(
        tsl.solve_general_small_mat(torch.from_numpy(G), torch.from_numpy(rhs_g)).numpy(),
        jsl.solve_general_small_mat(jnp.asarray(G), jnp.asarray(rhs_g)),
    )
    close(tsl.solve_general_small_mat(torch.from_numpy(G), torch.from_numpy(rhs_g)).numpy(), np.linalg.solve(G, rhs_g))


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ur5_pair():
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


def _cost_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, 2 * n), rng.uniform(-5, 5, n), rng.uniform(-1, 1, (4, 2 * n))


def test_tracking_costs_and_gradients_match_jax(ur5_pair):
    jm, tm = ur5_pair
    x, u, ref = _cost_inputs(6)
    q_goal = ref[0, :6]
    pairs = [
        (tcosts.quadratic_tracking_cost(torch.from_numpy(ref[0]), 2.0, 0.3, 1e-3),
         jcosts.quadratic_tracking_cost(jnp.asarray(ref[0]), 2.0, 0.3, 1e-3)),
        (tcosts.quadratic_tracking_cost(torch.from_numpy(ref)), jcosts.quadratic_tracking_cost(jnp.asarray(ref))),
        (tcosts.make_tracking_costs(tm, torch.from_numpy(q_goal))[0], jcosts.make_tracking_costs(jm, jnp.asarray(q_goal))[0]),
    ]
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    for t_cost, j_cost in pairs:
        close(t_cost(tx, tu, 2).numpy(), j_cost(jnp.asarray(x), jnp.asarray(u), 2))
        close(torch.func.grad(t_cost)(tx, tu, 2).numpy(), jax.grad(j_cost)(jnp.asarray(x), jnp.asarray(u), 2))
    t_term = tcosts.make_tracking_costs(tm, torch.from_numpy(q_goal), w_terminal=50.0)[1]
    j_term = jcosts.make_tracking_costs(jm, jnp.asarray(q_goal), w_terminal=50.0)[1]
    close(t_term(tx).numpy(), j_term(jnp.asarray(x)))
    close(torch.func.hessian(t_term)(tx).numpy(), jax.hessian(j_term)(jnp.asarray(x)))


def test_pose_tracking_cost_matches_jax(ur5_pair):
    jm, tm = ur5_pair
    from manipulapy_tpu import kinematics as jkin

    x, u, _ = _cost_inputs(6, seed=1)
    T_goal = np.array(jkin.forward_kinematics(jm, jnp.asarray(x[:6] + 0.2)))
    t_cost = tcosts.pose_tracking_cost(tm, torch.from_numpy(T_goal))
    j_cost = jcosts.pose_tracking_cost(jm, jnp.asarray(T_goal))
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    close(t_cost(tx, tu, 0).numpy(), j_cost(jnp.asarray(x), jnp.asarray(u), 0))
    close(torch.func.grad(t_cost)(tx, tu, 0).numpy(), jax.grad(j_cost)(jnp.asarray(x), jnp.asarray(u), 0), 1e-8)


# ---------------------------------------------------------------------------
# Generic iLQR
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planar_pair():
    jm = jax_catalog.two_link_planar(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


def _solve_both(planar_pair, H, iters, q_goal, limits=None, fused=True):
    jm, tm = planar_pair
    params_t = ILQRParams(horizon=H, dt=0.05, iterations=iters)
    params_j = JParams(horizon=H, dt=0.05, iterations=iters)
    t_run, t_term = tcosts.make_tracking_costs(tm, torch.tensor(q_goal, dtype=torch.float64), w_terminal=300.0)
    j_run, j_term = jcosts.make_tracking_costs(jm, jnp.asarray(q_goal), w_terminal=300.0)
    x0 = np.array([0.1, -0.2, 0.0, 0.3])
    t_lim = {k: torch.tensor(v, dtype=torch.float64) for k, v in (limits or {}).items()}
    j_lim = {k: jnp.asarray(v) for k, v in (limits or {}).items()}
    res_t = ilqr(
        make_step_fn(tm, 0.05, g=G0, fused=fused), t_run, t_term,
        torch.from_numpy(x0), torch.zeros((H, 2), dtype=torch.float64), params_t, **t_lim,
    )
    res_j = jax_ilqr(
        jax_step_fn(jm, 0.05, g=jnp.zeros(3), fused=fused), j_run, j_term,
        jnp.asarray(x0), jnp.zeros((H, 2)), params_j, **j_lim,
    )
    return res_t, res_j


@pytest.mark.parametrize("variant", ["fused", "generic_step", "torque_limits"])
def test_ilqr_matches_jax(planar_pair, variant):
    limits = {"u_min": [-3.0, -2.0], "u_max": [3.0, 2.0]} if variant == "torque_limits" else None
    # Three iterations: later ones accept or reject steps that change the
    # cost by ~1e-15, a rounding tie that the two packages may break apart.
    res_t, res_j = _solve_both(planar_pair, 15, 3, [0.6, -0.4], limits, fused=variant != "generic_step")
    for name in ("xs", "us", "cost", "gains_K"):
        close(getattr(res_t, name).numpy(), getattr(res_j, name), 1e-7)
    assert bool(res_t.converged) == bool(res_j.converged)
    if limits:
        us = res_t.us.numpy()
        assert np.all(np.abs(us[:, 0]) <= 3.0 + 1e-12) and np.all(np.abs(us[:, 1]) <= 2.0 + 1e-12)


def _lqr_problem(seed, H=10, nx=6, nu=3):
    """A random well-posed LQR subproblem (the JAX test's generator), f64."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((H, nx, nx))
    Wu = rng.standard_normal((H, nu, nu))
    WT = rng.standard_normal((nx, nx))
    return (
        np.eye(nx) + 0.01 * rng.standard_normal((H, nx, nx)),  # A
        0.1 * rng.standard_normal((H, nx, nu)),  # B
        rng.standard_normal((H, nx)),  # lx
        rng.standard_normal((H, nu)),  # lu
        np.eye(nx) + 0.1 * (W @ W.transpose(0, 2, 1)),  # lxx
        np.eye(nu) + 0.1 * (Wu @ Wu.transpose(0, 2, 1)),  # luu
        0.05 * rng.standard_normal((H, nu, nx)),  # lux
        rng.standard_normal(nx),  # Vx_T
        np.eye(nx) + 0.1 * (WT @ WT.T),  # Vxx_T
    )


@pytest.mark.parametrize("H", [1, 7, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_parallel_riccati_matches_jax(seed, H):
    """The log-depth suffix scan against JAX's ``associative_scan``, and
    against the port's own sequential sweep at reg 0; f64, atol 1e-9."""
    prob = _lqr_problem(seed, H=H)
    ks, Ks, dV, ok = parallel_riccati(*(torch.from_numpy(a) for a in prob))
    ks_j, Ks_j, dV_j, ok_j = jax_pscan(*(jnp.asarray(a) for a in prob))
    assert bool(ok) and bool(ok_j)
    close(ks.numpy(), ks_j, 1e-9)
    close(Ks.numpy(), Ks_j, 1e-9)
    close(dV.numpy(), dV_j, 1e-9)
    ks_s, Ks_s, dV_s, ok_s = riccati_sweep(*(torch.from_numpy(a) for a in prob), reg=0.0)
    assert bool(ok_s)
    close(ks.numpy(), ks_s.numpy(), 1e-9)
    close(Ks.numpy(), Ks_s.numpy(), 1e-9)
    close(dV.numpy(), dV_s.numpy(), 1e-9)


def test_parallel_riccati_flags_an_indefinite_quu():
    prob = [torch.from_numpy(a) for a in _lqr_problem(0)]
    prob[5] = -prob[5]  # luu negative definite: Quu loses definiteness
    assert not bool(parallel_riccati(*prob)[3])


def test_ilqr_parallel_riccati_matches_jax(planar_pair):
    """``ILQRParams(parallel_riccati=True)`` against JAX's on the 2R arm,
    three iterations from ``reg_init``; f64, the cost to 1e-9 relative.
    The scan bakes reg into the whole value recursion and the sequential
    sweep puts it on the factorised Quu only, so the two backends give the
    same gains only without it: one iteration of each at ``reg_init=0``."""
    jm, tm = planar_pair
    H, q_goal = 15, [0.6, -0.4]
    t_run, t_term = tcosts.make_tracking_costs(tm, torch.tensor(q_goal, dtype=torch.float64), w_terminal=300.0)
    j_run, j_term = jcosts.make_tracking_costs(jm, jnp.asarray(q_goal), w_terminal=300.0)
    x0 = np.array([0.1, -0.2, 0.0, 0.3])
    res_t = ilqr(make_step_fn(tm, 0.05, g=G0), t_run, t_term, torch.from_numpy(x0),
                 torch.zeros((H, 2), dtype=torch.float64),
                 ILQRParams(horizon=H, dt=0.05, iterations=3, parallel_riccati=True))
    res_j = jax_ilqr(jax_step_fn(jm, 0.05, g=jnp.zeros(3)), j_run, j_term, jnp.asarray(x0),
                     jnp.zeros((H, 2)), JParams(horizon=H, dt=0.05, iterations=3, parallel_riccati=True))
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost), rtol=1e-9)
    for name in ("xs", "us", "gains_K"):
        close(getattr(res_t, name).numpy(), getattr(res_j, name), 1e-7)
    one = [ilqr(make_step_fn(tm, 0.05, g=G0), t_run, t_term, torch.from_numpy(x0),
                torch.zeros((H, 2), dtype=torch.float64),
                ILQRParams(horizon=H, dt=0.05, iterations=1, reg_init=0.0, parallel_riccati=par))
           for par in (True, False)]
    close(one[0].gains_K.numpy(), one[1].gains_K.numpy(), 1e-9)


def test_mpc_step_tracks_goal(planar_pair):
    """The closed receding-horizon loop drives the 2R arm to its goal (the
    JAX test_receding_horizon_tracks at its size)."""
    _, tm = planar_pair
    params = ILQRParams(horizon=12, dt=0.05, iterations=4)
    step = make_step_fn(tm, params.dt, g=G0)
    q_goal = torch.tensor([0.5, -0.3], dtype=torch.float64)
    run, term = tcosts.make_tracking_costs(tm, q_goal, w_terminal=300.0)
    x = torch.zeros(4, dtype=torch.float64)
    us = torch.zeros((12, 2), dtype=torch.float64)
    for _ in range(25):
        u, us_next, res = mpc_step(step, run, term, x, us, params)
        assert torch.equal(us_next[:-1], res.us[1:]) and torch.equal(us_next[-1], res.us[-1])
        us = us_next
        x = step(x, u)
    np.testing.assert_allclose(x[:2].numpy(), q_goal.numpy(), atol=0.05)
    assert float(x[2:].abs().max()) < 0.2
