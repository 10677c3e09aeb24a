"""The port's IK family (``ik``, ``ik_cache``, ``trac_ik``) against the JAX
package's.

The port's masked loops are fed JAX's own random-draw tables, computed
here with ``jax.random`` from the key chains of JAX's ``solve_ik`` (three
keys a round: the next key, a normal draw, a uniform draw) and ``sqp_ik``
(two: the next key, a uniform draw), so the restart branches are
comparable too. Tolerances, f64 on UR5:

* ``solve_ik_batch`` and ``solve_ik`` on reachable FK targets: θ to 1e-8,
  equal ``iterations`` and ``success``;
* ``solve_ik`` on the unreachable ``T_far`` (restarts fire): equal
  ``success`` and ``iterations``, ``trans_err`` to 1e-6 relative;
* ``sqp_ik``: θ to 1e-8, equal ``iterations`` and ``success``;
* the error, the DLS step and the guess helpers to 1e-10; ``select_best``
  on JAX's NaN-lane cases; ``IKInitialGuessCache`` call for call (exact).

The strategy layers (``multi_start_ik``, ``smart_ik``, ``robust_ik``,
``adaptive_multi_start_ik``, ``TracIKSolver``) draw their random guesses
from ``torch.Generator`` streams, which JAX's threefry keys do not give:
they are held to JAX's behaviour (success on reachable targets, the
strategies' order) rather than to its numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import ik as jik
from manipulapy_tpu import ik_cache as jcache
from manipulapy_tpu import kinematics as jkin
from manipulapy_tpu import trac_ik as jtrac
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import ik, ik_cache, trac_ik
from manipulapy_tpu_torch.kinematics import forward_kinematics
from manipulapy_tpu_torch.models import from_host_arrays

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ur5_pair():
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


def jax_ik_draws(rounds, n, seed=0):
    """JAX ``solve_ik``'s (normals, uniforms) of every round, as tensors."""
    key, normals, uniforms = jax.random.PRNGKey(seed), [], []
    for _ in range(rounds):
        key, sub, sub2 = jax.random.split(key, 3)
        normals.append(jax.random.normal(sub, (n,), dtype=jnp.float64))
        uniforms.append(jax.random.uniform(sub2, (n,), dtype=jnp.float64))
    return torch.from_numpy(np.array(jnp.stack(normals))), torch.from_numpy(np.array(jnp.stack(uniforms)))


def jax_sqp_draws(rounds, n, seed=0):
    key, uniforms = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        uniforms.append(jax.random.uniform(sub, (n,), dtype=jnp.float64))
    return torch.from_numpy(np.array(jnp.stack(uniforms)))


def _fk_targets(jm, q):
    return np.array(jax.vmap(lambda x: jkin.forward_kinematics(jm, x))(jnp.asarray(q)))


def _same(res_t, res_j, theta_tol=1e-8):
    np.testing.assert_allclose(res_t.theta.numpy(), np.asarray(res_j.theta), rtol=theta_tol, atol=theta_tol)
    assert res_t.iterations.tolist() == np.asarray(res_j.iterations).tolist()
    assert res_t.success.tolist() == np.asarray(res_j.success).tolist()


def test_error_and_dls_step_match_jax(ur5_pair):
    jm, tm = ur5_pair
    rng = np.random.default_rng(0)
    T_a, T_b = _fk_targets(jm, rng.uniform(-1.5, 1.5, (2, 6)))
    for T in (T_b, T_a):  # a generic pose, and the same pose (zero error)
        V, rot, trans = ik.geometric_error(torch.from_numpy(T_a), torch.from_numpy(T))
        V_j, rot_j, trans_j = jik.geometric_error(jnp.asarray(T_a), jnp.asarray(T))
        np.testing.assert_allclose(V.numpy(), np.asarray(V_j), atol=1e-10)
        assert abs(float(rot) - float(rot_j)) < 1e-10 and abs(float(trans) - float(trans_j)) < 1e-10
    J, V = rng.standard_normal((6, 6)), rng.standard_normal(6)
    for damping in (0.0, 0.05):
        for port, ref in ((ik.dls_solve, jik.dls_solve), (ik.dls_solve_svd, jik.dls_solve_svd)):
            np.testing.assert_allclose(port(torch.from_numpy(J), torch.from_numpy(V), damping).numpy(),
                                       np.asarray(ref(jnp.asarray(J), jnp.asarray(V), damping)), atol=1e-9)


def test_solve_ik_batch_matches_jax_on_fk_targets(ur5_pair):
    """FK poses of q in U[-1.5, 1.5], guesses q + N(0, 0.3) (the JAX
    test's protocol); one lane needs a restart."""
    jm, tm = ur5_pair
    rng = np.random.default_rng(1)
    q = rng.uniform(-1.5, 1.5, (8, 6))
    guesses = q + rng.normal(0, 0.3, (8, 6))
    T = _fk_targets(jm, q)
    res_j = jik.solve_ik_batch(jm, jnp.asarray(T), jnp.asarray(guesses), max_iterations=100)
    res_t = ik.solve_ik_batch(tm, torch.from_numpy(T), torch.from_numpy(guesses), max_iterations=100,
                              draws=jax_ik_draws(100, 6))
    _same(res_t, res_j)
    assert bool(res_t.success.all()) and int(res_t.iterations.max()) > 3 * int(res_t.iterations.min())
    np.testing.assert_allclose(res_t.trans_err.numpy(), np.asarray(res_j.trans_err), atol=1e-12)


@pytest.mark.parametrize("target", ["reachable", "far"])
def test_solve_ik_matches_jax(ur5_pair, target):
    """One lane: a reachable pose from a guess 0.2 rad off, and ``T_far``
    at 5 m from zeros (JAX's ``test_unreachable_target_reports_failure``),
    where stalls restart the solve by JAX's normal and uniform draws."""
    jm, tm = ur5_pair
    if target == "far":
        T, guess = np.eye(4), np.zeros(6)
        T[:3, 3] = [5.0, 0.0, 0.0]
    else:
        q = np.random.default_rng(2).uniform(-1.0, 1.0, 6)
        T, guess = _fk_targets(jm, q[None])[0], q + 0.2
    res_j = jik.solve_ik(jm, jnp.asarray(T), jnp.asarray(guess), max_iterations=60)
    res_t = ik.solve_ik(tm, torch.from_numpy(T), torch.from_numpy(guess), max_iterations=60,
                        draws=jax_ik_draws(60, 6))
    assert bool(res_t.success) == bool(res_j.success) == (target == "reachable")
    assert int(res_t.iterations) == int(res_j.iterations)
    np.testing.assert_allclose(float(res_t.trans_err), float(res_j.trans_err), rtol=1e-6)
    if target == "reachable":
        _same(res_t, res_j)
    else:
        assert float(res_t.trans_err) > 1.0


def test_default_draws_are_the_seeded_generator(ur5_pair):
    """Without a table the port draws its own from ``torch.Generator(seed)``:
    the same seed gives the same result, and a reachable lane converges."""
    _, tm = ur5_pair
    q = torch.tensor([[0.3, -0.5, 0.8, 0.1, -0.2, 0.6]], dtype=torch.float64)
    T = forward_kinematics(tm, q)
    normals, uniforms = ik.ik_draws(tm, 50, seed=3)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(normals, torch.randn((50, 6), generator=gen, dtype=torch.float64))
    assert torch.equal(uniforms, torch.rand((50, 6), generator=gen, dtype=torch.float64))
    a = ik.solve_ik_batch(tm, T, q + 0.3, max_iterations=50, seed=3)
    b = ik.solve_ik_batch(tm, T, q + 0.3, max_iterations=50, draws=(normals, uniforms))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and bool(a.success.all())


def test_sqp_ik_matches_jax(ur5_pair):
    jm, tm = ur5_pair
    q = np.array([0.4, -0.8, 0.9, 0.3, -0.5, 0.7])
    T = _fk_targets(jm, q[None])[0]
    res_j = jtrac.sqp_ik(jm, jnp.asarray(T), jnp.asarray(q + 0.3), max_iterations=60)
    res_t = trac_ik.sqp_ik(tm, torch.from_numpy(T), torch.from_numpy(q + 0.3), max_iterations=60,
                           draws=jax_sqp_draws(60, 6))
    _same(res_t, res_j)
    assert bool(res_t.success) and float(res_t.trans_err) < 1e-6


@pytest.mark.parametrize("solver", ["dls", "sqp"])
def test_early_exit_changes_no_lane(ur5_pair, monkeypatch, solver):
    """The loop leaves once every lane is done, read on the host every
    ``DONE_CHECK_EVERY`` rounds: it runs fewer rounds, and each lane's
    result has the bits of the run through all ``max_iterations`` rounds."""
    _, tm = ur5_pair
    q = torch.from_numpy(np.random.default_rng(4).uniform(-1.0, 1.0, (4, 6)))
    T, guesses = forward_kinematics(tm, q), q + 0.2
    if solver == "dls":
        mod, call = ik, lambda: ik.solve_ik_batch(tm, T, guesses, max_iterations=100)
    else:
        mod, call = trac_ik, lambda: trac_ik.sqp_ik(tm, T[0], guesses[0], max_iterations=100)
    rounds, jacobian = [], mod.jacobian
    monkeypatch.setattr(mod, "jacobian", lambda *a: (rounds.append(1), jacobian(*a))[1])
    early = call()
    n_early, every = len(rounds), ik.DONE_CHECK_EVERY
    monkeypatch.setattr(ik, "DONE_CHECK_EVERY", 10**9)
    full = call()
    assert n_early < 100 and n_early % every == 0 and len(rounds) - n_early == 100
    assert bool(early.success.all())
    assert all(torch.equal(a, b) for a, b in zip(early, full))


def test_guess_helpers_match_jax(ur5_pair):
    jm, tm = ur5_pair
    q_true = np.array([0.4, -0.6, 0.8, 0.2, -0.3, 0.5])
    T = _fk_targets(jm, q_true[None])[0]
    np.testing.assert_allclose(ik.midpoint_guess(tm).numpy(), np.asarray(jik.midpoint_guess(jm)), atol=1e-12)
    np.testing.assert_allclose(ik.workspace_heuristic_guess(tm, torch.from_numpy(T)).numpy(),
                               np.asarray(jik.workspace_heuristic_guess(jm, jnp.asarray(T))), atol=1e-10)
    np.testing.assert_allclose(ik.extrapolate_guess(tm, torch.from_numpy(q_true + 0.05), torch.from_numpy(T)).numpy(),
                               np.asarray(jik.extrapolate_guess(jm, jnp.asarray(q_true + 0.05), jnp.asarray(T))),
                               atol=1e-10)
    g = ik.random_guesses(tm, torch.Generator().manual_seed(0), 64)
    assert g.shape == (64, 6)
    assert bool((g >= tm.joint_lower).all()) and bool((g <= tm.joint_upper).all())


SELECT_CASES = {
    "nan_lane_does_not_win": (
        [[1.0, 1.0], [2.0, 2.0]], [False, True], [5, 7], [np.nan, 1e-7], [np.nan, 2e-7]),
    "all_failed_picks_lowest_finite_error": (
        [[1.0], [2.0], [3.0]], [False, False, False], [1, 2, 3], [np.nan, 0.5, 0.2], [np.nan, 0.1, 0.3]),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_best_matches_jax(case):
    theta, success, iters, rot, trans = SELECT_CASES[case]
    got = ik.select_best(ik.IKResult(torch.tensor(theta), torch.tensor(success), torch.tensor(iters),
                                     torch.tensor(rot), torch.tensor(trans)))
    ref = jik.select_best(jik.IKResult(jnp.asarray(theta), jnp.asarray(success), jnp.asarray(iters),
                                       jnp.asarray(rot), jnp.asarray(trans)))
    np.testing.assert_array_equal(got.theta.numpy(), np.asarray(ref.theta))
    assert bool(got.success) == bool(ref.success) and int(got.iterations) == int(ref.iterations)


def test_guess_cache_matches_jax_call_for_call():
    """The same calls on both caches, host arrays in and out: FIFO eviction
    at capacity, k-NN blends, a distance gate, lazy inserts (a failed one
    dropped), len and clear."""
    rng = np.random.default_rng(7)
    poses = [np.eye(4) for _ in range(7)]
    for P in poses:
        P[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    sols = rng.uniform(-1, 1, (7, 6))
    t, j = ik_cache.IKInitialGuessCache(max_entries=4, k=3), jcache.IKInitialGuessCache(max_entries=4, k=3)
    assert t.lookup(poses[0]) is None and j.lookup(poses[0]) is None
    for i in range(5):
        t.add(poses[i], sols[i], quality=1.0 + i)
        j.add(poses[i], sols[i], quality=1.0 + i)
    t.add_async(poses[5], torch.tensor(True), torch.from_numpy(sols[5]))
    j.add_async(poses[5], jnp.asarray(True), jnp.asarray(sols[5]))
    t.add_async(torch.from_numpy(poses[6]), torch.tensor(False), torch.from_numpy(sols[6]))
    j.add_async(poses[6], jnp.asarray(False), jnp.asarray(sols[6]))
    assert len(t) == len(j) == 4
    for query in (poses[2], poses[5], poses[0], np.eye(4)):
        ht, hj = t.lookup_with_distance(query), j.lookup_with_distance(query)
        np.testing.assert_array_equal(ht[0], hj[0])
        assert ht[1] == hj[1]
        assert (t.lookup(query, max_distance=0.05) is None) == (j.lookup(query, max_distance=0.05) is None)
    t.clear()
    j.clear()
    assert len(t) == len(j) == 0


def test_strategy_layers_solve_reachable_poses(ur5_pair):
    """multi_start_ik, smart_ik (its cache filled lazily, then the fast
    path), robust_ik, adaptive_multi_start_ik and TracIKSolver on FK poses,
    as the JAX tests hold them."""
    _, tm = ur5_pair
    qs = torch.tensor([[0.5, -0.7, 0.6, 0.4, -0.3, 0.2], [0.3, -0.6, 0.8, 0.2, -0.4, 0.5]], dtype=torch.float64)
    T0, T1 = forward_kinematics(tm, qs)
    kw = dict(max_iterations=120)
    res = ik.multi_start_ik(tm, T0, num_starts=6, **kw)
    assert bool(res.success) and float(res.trans_err) < 1e-5

    cache = ik_cache.IKInitialGuessCache()
    first = ik_cache.smart_ik(tm, T0, q_current=qs[0] + 0.2, cache=cache, **kw)
    assert bool(first.success) and len(cache._pending) == 1
    assert len(cache) == 1 and not cache._pending  # read at the first host access
    again = ik_cache.smart_ik(tm, T0, cache=cache, **kw)  # the near hit alone first
    assert bool(again.success) and len(cache) == 2
    assert ik_cache.smart_ik(tm, T0, strategy="cached") is None
    with pytest.raises(ValueError, match="Unknown IK strategy"):
        ik_cache.smart_ik(tm, T0, strategy="bogus")

    assert bool(ik_cache.robust_ik(tm, T1, **kw).success)
    res, used = ik_cache.adaptive_multi_start_ik(tm, T1, initial_starts=2, max_starts=8, **kw)
    assert bool(res.success) and used in (2, 6, 14)

    solver = trac_ik.TracIKSolver(tm, timeout=5.0, num_guesses=6)
    res = solver.solve(T1)
    assert bool(res.success) and float(res.trans_err) < 1e-6
    assert bool(trac_ik.trac_ik_solve(tm, T0, qs[0] + 0.1, num_guesses=5, timeout=5.0).success)
