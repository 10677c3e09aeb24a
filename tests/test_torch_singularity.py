"""The port's singularity and manipulability analysis against the JAX
package's.

Inputs come from ``numpy.random.default_rng`` and go to both packages, in
float64; the JAX functions take one configuration and are run per row
where the port takes a batch. Tolerance 1e-9 on singular values and what is
made of them (two SVD routines on the same 6 x 6 or 3 x n matrix); the
ellipsoid axes are compared up to the sign of each column, which an SVD
leaves free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import kinematics as jkin
from manipulapy_tpu import singularity as js
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import singularity as ts
from manipulapy_tpu_torch.models import catalog, from_host_arrays

CPU = torch.device("cpu")
T = torch.from_numpy
_MAKERS = {"ur5": jax_catalog.ur5, "two_link_planar": jax_catalog.two_link_planar, "panda": jax_catalog.panda}


def close(port, ref, tol=1e-9):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=sorted(_MAKERS))
def case(request):
    """Both models, and configurations of which row 0 is singular (the
    stretched arm) for the two arms whose singularity is known."""
    jm = _MAKERS[request.param](dtype=jnp.float64)
    tm = from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)
    n = tm.num_joints
    q = np.random.default_rng(n).uniform(-1.2, 1.2, (5, n))
    if request.param == "panda":
        lo, hi = np.asarray(jm.joint_lower), np.asarray(jm.joint_upper)
        q = (lo + hi) / 2 + q * (hi - lo) / 4
    else:
        q[0] = 0.0
    return request.param, jm, tm, q


def test_scalar_measures_match_jax(case):
    name, jm, tm, q = case
    got = {
        "singularity_measure": ts.singularity_measure(tm, T(q)),
        "condition_number": ts.condition_number(tm, T(q)),
        "manipulability_measure": ts.manipulability_measure(tm, T(q)),
        "is_singular": ts.is_singular(tm, T(q)),
        "near_singularity": ts.near_singularity(tm, T(q)),
    }
    for fn_name, g in got.items():
        assert g.shape == (5,)
        ref = np.stack([np.asarray(getattr(js, fn_name)(jm, jnp.asarray(x))) for x in q])
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), ref)
        elif fn_name == "condition_number":
            close(g[1:].numpy(), ref[1:], 1e-8)  # row 0 may divide by sigma_min ~ 1e-17
        else:
            close(g.numpy(), ref)
    if name != "panda":
        assert bool(got["is_singular"][0]) and not bool(got["is_singular"][1:].any())
        assert float(got["condition_number"][0]) > 1e6


def test_thresholds():
    tm = catalog.two_link_planar(dtype=torch.float64, device=CPU)
    q = torch.tensor([[0.0, 0.005], [0.0, 0.5]], dtype=torch.float64)  # sigma_min ~ 0.005 sin-ish, then regular
    sigma = ts.singularity_measure(tm, q)
    assert 1e-4 < float(sigma[0]) < 1e-2
    assert ts.is_singular(tm, q).tolist() == [False, False]
    assert ts.near_singularity(tm, q).tolist() == [True, False]
    assert ts.is_singular(tm, q, threshold=0.05).tolist() == [True, False]


def test_manipulability_ellipsoid_matches_jax(case):
    _, jm, tm, q = case
    (lin, ang) = ts.manipulability_ellipsoid(tm, T(q[1:]))
    k = min(3, tm.num_joints)
    assert lin.radii.shape == (4, k) and lin.axes.shape == (4, 3, k)
    for b in range(4):
        lin_j, ang_j = js.manipulability_ellipsoid(jm, jnp.asarray(q[1 + b]))
        for got, ref in ((lin, lin_j), (ang, ang_j)):
            close(got.radii[b].numpy(), ref.radii)
            # The axes of distinct radii, up to sign; a planar arm's angular
            # block has one nonzero radius.
            distinct = np.asarray(ref.radii) > 1e-9
            ga, ra = got.axes[b].numpy()[:, distinct], np.asarray(ref.axes)[:, distinct]
            close(np.abs(np.sum(ga * ra, axis=0)), np.ones(int(distinct.sum())), 1e-7)


def test_monte_carlo_workspace(case):
    """The samples are the forward kinematics of uniform draws within the
    limits: re-seeding the generator reproduces the draws, which go through
    JAX's FK; and a UR5's lie within its reach."""
    name, jm, tm, _ = case
    n = tm.num_joints
    pts = ts.monte_carlo_workspace(tm, torch.Generator().manual_seed(3), 200)
    assert pts.shape == (200, 3) and pts.dtype == torch.float64
    u = torch.rand((200, n), generator=torch.Generator().manual_seed(3), dtype=torch.float64).numpy()
    lo = np.where(np.isfinite(jm.joint_lower), jm.joint_lower, -np.pi)
    hi = np.where(np.isfinite(jm.joint_upper), jm.joint_upper, np.pi)
    qs = jnp.asarray(lo + u * (hi - lo))
    ref = jax.vmap(lambda x: jkin.forward_kinematics(jm, x)[:3, 3])(qs)
    close(pts.numpy(), ref)
    again = ts.monte_carlo_workspace(tm, torch.Generator().manual_seed(4), 200)
    assert not torch.equal(pts, again)
    if name == "ur5":
        assert float(pts.norm(dim=-1).max()) <= 1.1
        assert float(pts.norm(dim=-1).max()) > 0.5
