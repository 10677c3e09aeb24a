"""The port's step program against the JAX package's, and its emitted C.

``build_fd_step`` runs the cgen emitter on tensors (the plain PyTorch
version of the rollout kernel's step); ``build_fd_step_source`` runs the
same emitter on symbolic values and gives the C source of the kernel's
device function. Here both are held against JAX ``build_fd_step``:

* f64: states within 1e-9, ddq within 1e-7 (ddq reaches ~1e3);
* f32: 1e-4 on q, 1e-3 on dq and 2e-1 on ddq, the JAX package's rollout
  tolerances (f32 conditioning of the wrist joints, not a maths change);
* the emitted C, compiled with the host g++ behind a ``__device__`` shim
  and called through ctypes, against the plain version at the f32
  tolerances.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.ops import fd_step as jfd
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.ops import cgen as cg
from manipulapy_tpu_torch.ops import fd_step as tfd

F64_TOL = (1e-9, 1e-9, 1e-7)
F32_TOL = (1e-4, 1e-3, 2e-1)

_MAKERS = {"ur5": jax_catalog.ur5, "panda": jax_catalog.panda}


@pytest.fixture(scope="module")
def models():
    """JAX model (f64) and the port's model built from its host arrays."""
    out = {}
    for name, make in _MAKERS.items():
        jm = make(dtype=jnp.float64)
        out[name] = (jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64))
    return out


def _inputs(n, B, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, n) if B else (n,)
    q = rng.uniform(-1.0, 1.0, shape)
    dq = rng.uniform(-0.5, 0.5, shape)
    tau = rng.uniform(-10.0, 10.0, shape)
    return [x.astype(dtype) for x in (q, dq, tau)]


def _compare(port_out, jax_out, tols):
    for p, j, tol in zip(port_out, jax_out, tols):
        j = np.asarray(j)
        assert p.shape == j.shape
        assert str(p.dtype).endswith(str(j.dtype))
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=tol)


STEP_CASES = {
    "default": dict(),
    "no_velocity_clip": dict(clip_velocity=False),
    "no_limits": dict(clip_limits=False),
    "custom_g": dict(g=(0.5, -1.0, -3.0)),
}


@pytest.mark.parametrize("robot", sorted(_MAKERS))
@pytest.mark.parametrize("variant", sorted(STEP_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_matches_jax(models, robot, variant, dtype):
    jm, tm = models[robot]
    kw = STEP_CASES[variant]
    dt = 0.05  # large enough that the clamps engage on some scenarios
    q, dq, tau = _inputs(tm.num_joints, 41, np.dtype(dtype), seed=1)
    jax_out = jfd.build_fd_step(jm, dt, **kw)(*(jnp.asarray(x) for x in (q, dq, tau)))
    port_out = tfd.build_fd_step(tm, dt, **kw)(*(torch.from_numpy(x) for x in (q, dq, tau)))
    _compare(port_out, jax_out, F64_TOL if dtype == "float64" else F32_TOL)


@pytest.mark.parametrize("robot", sorted(_MAKERS))
def test_step_unbatched_matches_jax(models, robot):
    jm, tm = models[robot]
    q, dq, tau = _inputs(tm.num_joints, 0, np.float64, seed=2)
    jax_out = jfd.build_fd_step(jm, 0.01)(*(jnp.asarray(x) for x in (q, dq, tau)))
    port_out = tfd.build_fd_step(tm, 0.01)(*(torch.from_numpy(x) for x in (q, dq, tau)))
    assert port_out[0].shape == (tm.num_joints,)
    _compare(port_out, jax_out, F64_TOL)


@pytest.mark.parametrize("robot", sorted(_MAKERS))
def test_bias_mass_matches_jax(models, robot):
    jm, tm = models[robot]
    q, dq, _ = _inputs(tm.num_joints, 13, np.float64, seed=3)
    g = (0.0, 0.2, -9.81)
    M_j, b_j = jfd.build_bias_mass_fn(jm, g)(jnp.asarray(q), jnp.asarray(dq))
    M_t, b_t = tfd.build_bias_mass_fn(tm, g)(torch.from_numpy(q), torch.from_numpy(dq))
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# The emitted C source
# ---------------------------------------------------------------------------

_HARNESS = """\
#include <math.h>
#define __device__
#define __forceinline__ inline
{step}
extern "C" void step_batch(const float* q, const float* dq, const float* tau,
                           float* q_out, float* dq_out, float* ddq_out, int B) {{
  for (int b = 0; b < B; ++b) {{
    float qq[{n}], dd[{n}], tt[{n}], aa[{n}];
    for (int j = 0; j < {n}; ++j) {{
      qq[j] = q[b * {n} + j]; dd[j] = dq[b * {n} + j]; tt[j] = tau[b * {n} + j];
    }}
    fd_step(qq, dd, tt, aa);
    for (int j = 0; j < {n}; ++j) {{
      q_out[b * {n} + j] = qq[j]; dq_out[b * {n} + j] = dd[j]; ddq_out[b * {n} + j] = aa[j];
    }}
  }}
}}
"""


def _compile_host(tmp_path, name, source):
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    cpp = tmp_path / f"{name}.cpp"
    so = tmp_path / f"{name}.so"
    cpp.write_text(source)
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", str(so), str(cpp)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.step_batch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    return lib


def _run_host(lib, q, dq, tau):
    outs = [np.empty_like(q) for _ in range(3)]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.step_batch(ptr(q), ptr(dq), ptr(tau), *(ptr(o) for o in outs), q.shape[0])
    return [torch.from_numpy(o) for o in outs]


@pytest.mark.parametrize("robot", sorted(_MAKERS))
def test_emitted_c_matches_plain_version(models, robot, tmp_path):
    _, tm = models[robot]
    n = tm.num_joints
    dt = 0.05
    _, step_src, ops = tfd.build_fd_step_source(tm, dt)
    assert ops > 1000
    lib = _compile_host(tmp_path, robot, _HARNESS.format(step=step_src, n=n))
    q, dq, tau = _inputs(n, 257, np.float32, seed=4)
    q[0, 0] = np.nan  # a diverged scenario stays NaN (clamps propagate NaN)
    q[1] *= 10.0  # past the joint limits: the position clamps engage
    got = _run_host(lib, q, dq, tau)
    ref = tfd.build_fd_step(tm.to(dtype=torch.float32), dt)(*(torch.from_numpy(x) for x in (q, dq, tau)))
    assert all(bool(torch.isnan(x[0]).all()) for x in got)
    for g_out, r_out, tol in zip(got, ref, F32_TOL):
        torch.testing.assert_close(g_out[1:], r_out[1:], rtol=0, atol=tol)
    lower, upper = tm.joint_lower.float(), tm.joint_upper.float()
    assert bool(((got[0][1:] >= lower) & (got[0][1:] <= upper)).all())


def test_emitted_source_rules(models):
    _, tm = models["panda"]
    _, src, _ = tfd.build_fd_step_source(tm, 0.01, clip_velocity=False)
    # Every float literal is an f32 literal; no double arithmetic sneaks in.
    for lit in re.findall(r"[0-9]\.[0-9]+e[+-][0-9]+f?", src):
        assert lit.endswith("f"), lit
    assert "sinf(" in src and "cosf(" in src and "sqrtf(" in src
    for banned in ("__sinf", "__cosf", "fminf", "fmaxf", "double"):
        assert banned not in src
    # Position clamps only: Panda has finite position limits on all joints.
    assert src.count(" ? ") == 2 * 7
    _, src_v, _ = tfd.build_fd_step_source(tm, 0.01)
    assert src_v.count(" ? ") == 4 * 7


def test_c_literal_is_f32_rounding():
    assert cg.c_literal(1.0) == "1.000000000e+00f"
    assert cg.c_literal(-2.5) == "(-2.500000000e+00f)"
    lit = cg.c_literal(0.1)
    assert np.float32(float(lit.rstrip("f"))) == np.float32(0.1)
    with pytest.raises(ValueError):
        cg.c_literal(float("inf"))
    with pytest.raises(ValueError):
        cg.c_literal(1e39)  # overflows f32


def test_cvar_clip_drops_infinite_bound():
    em = cg.Emitter()
    x = cg.CVar(em, "x")
    cg.clip(x, -np.inf, 2.0)
    cg.clip(x, -1.0, np.inf)
    cg.clip(x, -1.0, 2.0)
    assert em.lines == [
        "const float t0 = (x > 2.000000000e+00f ? 2.000000000e+00f : x);",
        "const float t1 = (x < (-1.000000000e+00f) ? (-1.000000000e+00f) : x);",
        "const float t2 = (x < (-1.000000000e+00f) ? (-1.000000000e+00f) : "
        "(x > 2.000000000e+00f ? 2.000000000e+00f : x));",
    ]


def test_cgen_folds_constants_on_every_backend():
    em = cg.Emitter()
    x = cg.CVar(em, "x")
    t = torch.tensor([1.0, 2.0])
    for v in (x, t):
        assert cg.mul(v, 0.0) == 0.0
        assert cg.mul(1.0, v) is v
        assert cg.add(0.0, v) is v
        assert cg.sub(v, 0.0) is v
    assert cg.sqrt(4.0) == 2.0 and cg.recip(4.0) == 0.25
    assert cg.clip(5.0, -1.0, 2.0) == 2.0
    assert torch.equal(cg.recip(t), torch.tensor([1.0, 0.5]))
    assert cg.sin(x).name == "t0" and em.lines[-1] == "const float t0 = sinf(x);"
    assert (2.0 - x).name == "t1" and em.lines[-1] == "const float t1 = 2.000000000e+00f - x;"
    with pytest.raises(TypeError):
        em.ref(t)
