"""Lie group, kinematics and dynamics of the port against the JAX package.

Inputs come from ``np.random.default_rng`` and go through both packages in
f64; every comparison uses rtol = atol = 1e-9. The JAX side is vmapped and
jitted once per robot (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import dynamics as jdyn
from manipulapy_tpu import kinematics as jkin
from manipulapy_tpu.core import lie as jlie
from manipulapy_tpu.core import time_scaling as jts
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import dynamics as tdyn
from manipulapy_tpu_torch import kinematics as tkin
from manipulapy_tpu_torch.core import lie as tlie
from manipulapy_tpu_torch.core import time_scaling as tts
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.ops import smallinalg

CPU = torch.device("cpu")

TOL = dict(rtol=1e-9, atol=1e-9)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def j64(x):
    return jnp.asarray(x, dtype=jnp.float64)


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


# ---------------------------------------------------------------------------
# Lie group
# ---------------------------------------------------------------------------


def _rotvecs():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate(
        [rng.uniform(0.1, 3.0, 6), [0.0, 1e-9, 5e-5, np.pi, np.pi - 1e-7, np.pi - 5e-4]]
    )
    return axes * angles[:, None]


def test_skew_unskew_adjoint_ad_twist():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(5, 3))
    V = rng.normal(size=(5, 6))
    close(tlie.skew(t64(v)), jlie.skew(j64(v)))
    close(tlie.unskew(tlie.skew(t64(v))), v)
    close(tlie.ad_twist(t64(V)), jlie.ad_twist(j64(V)))
    T = np.asarray(jlie.se3_exp(j64(V)))
    close(tlie.adjoint(t64(T)), jlie.adjoint(j64(T)))
    close(tlie.trans_inv(t64(T)), jlie.trans_inv(j64(T)))
    R, p = tlie.trans_to_rp(t64(T))
    close(tlie.rp_to_trans(R, p), T)


def test_so3_exp_log_including_small_and_near_pi():
    w = _rotvecs()
    R_port = tlie.so3_exp(t64(w))
    R_jax = jlie.so3_exp(j64(w))
    close(R_port, R_jax)
    close(tlie.so3_log(R_port), jlie.so3_log(R_jax))


def test_so3_log_exact_pi_rotations():
    R = np.stack([np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])])
    w = tlie.so3_log(t64(R))
    close(w, jlie.so3_log(j64(R)))
    np.testing.assert_allclose(torch.linalg.norm(w, dim=-1).numpy(), np.pi, atol=1e-12)


def test_se3_exp_log():
    rng = np.random.default_rng(2)
    V = np.concatenate([_rotvecs(), rng.normal(size=(12, 3))], axis=-1)
    T = tlie.se3_exp(t64(V))
    close(T, jlie.se3_exp(j64(V)))
    close(tlie.se3_log(T), jlie.se3_log(j64(np.asarray(T))))


def test_exp_twist_revolute_and_prismatic():
    rng = np.random.default_rng(3)
    w = rng.normal(size=3)
    w /= np.linalg.norm(w)
    S_rev = np.concatenate([w, rng.normal(size=3)])
    S_pri = np.concatenate([np.zeros(3), rng.normal(size=3)])
    theta = rng.uniform(-3, 3, size=7)
    for S in (S_rev, S_pri):
        close(tlie.exp_twist(t64(S), t64(theta)), jax.vmap(lambda t: jlie.exp_twist(j64(S), t))(j64(theta)))


@pytest.mark.parametrize("method", [3, 5, 1])
def test_time_scaling(method):
    for Tf in (2.0, 0.0, -1.0):
        for N in (7, 1, 0):
            port = tts.scaling_profile(Tf, N, method, dtype=torch.float64)
            ref = jts.scaling_profile(Tf, N, method, dtype=jnp.float64)
            for a, b in zip(port, ref):
                assert a.shape == b.shape
                close(a, b)


# ---------------------------------------------------------------------------
# Kinematics and dynamics, UR5 and Panda
# ---------------------------------------------------------------------------

_MAKERS = {
    "ur5": lambda: jax_catalog.ur5(dtype=jnp.float64),
    "panda": lambda: jax_catalog.panda(dtype=jnp.float64),
}


@pytest.fixture(scope="module", params=sorted(_MAKERS))
def case(request):
    """Both models, a batch of inputs, and every JAX reference output."""
    jm = _MAKERS[request.param]()
    tm = from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)
    n = tm.num_joints
    rng = np.random.default_rng(7)
    B = 9
    x = dict(
        q=rng.uniform(-1.5, 1.5, (B, n)),
        dq=rng.uniform(-1.0, 1.0, (B, n)),
        ddq=rng.uniform(-2.0, 2.0, (B, n)),
        tau=rng.uniform(-20.0, 20.0, (B, n)),
        f=rng.uniform(-5.0, 5.0, (B, 6)),
    )
    g = np.array([0.3, -0.2, -9.7])

    def ref_all(q, dq, ddq, tau, f):
        return dict(
            fk_space=jkin.forward_kinematics(jm, q),
            fk_body=jkin.forward_kinematics(jm, q, frame="body"),
            prefixes=jkin.link_prefix_transforms(jm, q),
            com=jkin.com_transforms(jm, q),
            jac_space=jkin.jacobian(jm, q),
            jac_body=jkin.jacobian_body(jm, q),
            com_jac=jdyn.com_jacobians(jm, q),
            mass=jdyn.mass_matrix(jm, q),
            grav=jdyn.gravity_forces(jm, q, j64(g)),
            cor=jdyn.coriolis_forces(jm, q, dq),
            rnea=jdyn.rnea(jm, q, dq, ddq),
            rnea_tip=jdyn.rnea(jm, q, dq, ddq, j64(g), f),
            bias=jdyn.bias_forces(jm, q, dq),
            invdyn_tip=jdyn.inverse_dynamics(jm, q, dq, ddq, None, f),
            fd_fast=jdyn.forward_dynamics_fast(jm, q, dq, tau),
            fd_fast_tip=jdyn.forward_dynamics_fast(jm, q, dq, tau, j64(g), f),
            fd=jdyn.forward_dynamics(jm, q, dq, tau),
            fd_tip=jdyn.forward_dynamics(jm, q, dq, tau, None, f),
        )

    ref = jax.jit(jax.vmap(ref_all))(*(j64(x[k]) for k in ("q", "dq", "ddq", "tau", "f")))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return tm, {k: t64(v) for k, v in x.items()}, t64(g), ref


def test_forward_kinematics(case):
    tm, x, _, ref = case
    close(tkin.forward_kinematics(tm, x["q"]), ref["fk_space"])
    close(tkin.forward_kinematics(tm, x["q"], frame="body"), ref["fk_body"])
    close(tkin.forward_kinematics(tm, x["q"][0]), ref["fk_space"][0])


def test_prefix_and_com_transforms(case):
    tm, x, _, ref = case
    close(tkin.link_prefix_transforms(tm, x["q"]), ref["prefixes"])
    close(tkin.com_transforms(tm, x["q"]), ref["com"])


def test_jacobians(case):
    tm, x, _, ref = case
    close(tkin.jacobian(tm, x["q"]), ref["jac_space"])
    close(tkin.jacobian_body(tm, x["q"]), ref["jac_body"])
    close(tkin.jacobian_body(tm, x["q"][3]), ref["jac_body"][3])
    with pytest.raises(ValueError):
        tkin.jacobian(tm, x["q"], frame="world")


def test_com_jacobians_and_mass_matrix(case):
    tm, x, _, ref = case
    close(tdyn.com_jacobians(tm, x["q"]), ref["com_jac"])
    M = tdyn.mass_matrix(tm, x["q"])
    close(M, ref["mass"])
    assert bool((torch.linalg.eigvalsh(M) > 0).all())


def test_gravity_and_coriolis(case):
    tm, x, g, ref = case
    close(tdyn.gravity_forces(tm, x["q"], g), ref["grav"])
    close(tdyn.coriolis_forces(tm, x["q"], x["dq"]), ref["cor"])
    close(tdyn.coriolis_forces(tm, x["q"][0], x["dq"][0]), ref["cor"][0])


def test_rnea_and_bias(case):
    tm, x, g, ref = case
    close(tdyn.rnea(tm, x["q"], x["dq"], x["ddq"]), ref["rnea"])
    close(tdyn.rnea(tm, x["q"], x["dq"], x["ddq"], g, x["f"]), ref["rnea_tip"])
    close(tdyn.bias_forces(tm, x["q"], x["dq"]), ref["bias"])


def test_inverse_dynamics_matches_rnea(case):
    tm, x, _, ref = case
    lagrange = tdyn.inverse_dynamics(tm, x["q"], x["dq"], x["ddq"], None, x["f"])
    close(lagrange, ref["invdyn_tip"])
    close(lagrange, tdyn.rnea(tm, x["q"], x["dq"], x["ddq"], None, x["f"]).numpy(), rtol=1e-8, atol=1e-8)


def test_forward_dynamics_fast(case):
    tm, x, g, ref = case
    close(tdyn.forward_dynamics_fast(tm, x["q"], x["dq"], x["tau"]), ref["fd_fast"])
    close(tdyn.forward_dynamics_fast(tm, x["q"], x["dq"], x["tau"], g, x["f"]), ref["fd_fast_tip"])


def test_forward_dynamics(case):
    tm, x, _, ref = case
    close(tdyn.forward_dynamics(tm, x["q"], x["dq"], x["tau"]), ref["fd"])
    close(tdyn.forward_dynamics(tm, x["q"], x["dq"], x["tau"], None, x["f"]), ref["fd_tip"])


def test_smallinalg_solves_spd():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 7, 7))
    M = t64(A @ A.transpose(0, 2, 1) + 7 * np.eye(7))
    rhs = t64(rng.normal(size=(4, 7)))
    x = smallinalg.solve_spd_small(M, rhs)
    close(x, torch.linalg.solve(M, rhs).numpy())
    L = smallinalg.chol_factor_small(M)
    close(L[3][1], torch.linalg.cholesky(M)[:, 3, 1].numpy())
