"""The port's rollout path against the JAX package's, and its dispatch.

* The plain PyTorch rollout (``ops/fd_step.py::build_rollout``, the plain
  version of the CUDA kernel) and the public
  ``trajectory.forward_dynamics_trajectory`` against JAX ``build_rollout``,
  the plain reference of the Pallas rollout kernel (the JAX tests run that
  kernel in interpret mode only under ``slow``). B=67, N=6, intRes 1 and 3.
* The generic path (tip wrenches) against JAX
  ``_forward_dynamics_trajectory_generic``; ``inverse_dynamics_trajectory``
  and ``joint_trajectory`` against JAX.
* Which engine serves a call: a CUDA float32 (B, n) call goes to the
  kernel and never to the plain version; CPU tensors go to the plain
  version.

The kernel itself runs on a card in ``tests/test_torch_cuda.py``.

Tolerances: f64 within 1e-9 on states and 1e-7 on ddq; f32 1e-4 on q,
1e-3 on dq and 2e-1 on ddq.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.ops import fd_step as jfd
from manipulapy_tpu_torch import trajectory as ttraj
from manipulapy_tpu_torch.models import catalog, from_host_arrays
from manipulapy_tpu_torch.ops import _build, dispatch
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops.cuda_rollout import CudaRollout, build_cuda_rollout, rollout_source

F64_TOL = (1e-9, 1e-9, 1e-7)
F32_TOL = (1e-4, 1e-3, 2e-1)
B, N = 67, 6


@pytest.fixture(scope="module")
def ur5_pair():
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64)


def _inputs(n, dtype, batch=(B,), steps=N, seed=0):
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(-1.0, 1.0, batch + (n,))
    dq0 = rng.uniform(-0.5, 0.5, batch + (n,))
    tau = rng.uniform(-10.0, 10.0, batch + (steps, n))
    return [x.astype(dtype) for x in (q0, dq0, tau)]


def _compare(port_out, jax_out, tols):
    for p, j, tol in zip(port_out, jax_out, tols):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def jax_rollouts(ur5_pair):
    """JAX build_rollout outputs, one jit per (dtype, intRes)."""
    jm, _ = ur5_pair
    out = {}
    for dtype, int_res in (("float64", 1), ("float64", 3), ("float32", 1)):
        x = _inputs(6, np.dtype(dtype))
        ys = jfd.build_rollout(jm, dt=0.01, intRes=int_res)(*(jnp.asarray(v) for v in x))
        out[dtype, int_res] = (x, [np.asarray(y) for y in ys])
    return out


@pytest.mark.parametrize("dtype,int_res", [("float64", 1), ("float64", 3), ("float32", 1)])
def test_plain_rollout_matches_jax(ur5_pair, jax_rollouts, dtype, int_res):
    _, tm = ur5_pair
    x, ref = jax_rollouts[dtype, int_res]
    port = tfd.build_rollout(tm, dt=0.01, intRes=int_res)(*(torch.from_numpy(v) for v in x))
    assert isinstance(tfd.build_rollout(tm), torch.nn.Module)
    _compare(port, ref, F64_TOL if dtype == "float64" else F32_TOL)


@pytest.mark.parametrize("dtype,int_res", [("float64", 1), ("float64", 3), ("float32", 1)])
def test_forward_dynamics_trajectory_matches_jax(ur5_pair, jax_rollouts, dtype, int_res):
    _, tm = ur5_pair
    x, ref = jax_rollouts[dtype, int_res]
    port = ttraj.forward_dynamics_trajectory(
        tm, *(torch.from_numpy(v) for v in x), dt=0.01, intRes=int_res
    )
    _compare(port, ref, F64_TOL if dtype == "float64" else F32_TOL)


def test_unbatched_rollout_matches_batched(ur5_pair, jax_rollouts):
    _, tm = ur5_pair
    x, ref = jax_rollouts["float64", 1]
    port = ttraj.forward_dynamics_trajectory(tm, *(torch.from_numpy(v[5]) for v in x))
    assert port[0].shape == (N, 6)
    _compare(port, [r[5] for r in ref], F64_TOL)


def test_generic_path_with_tip_wrench_matches_jax(ur5_pair):
    jm, tm = ur5_pair
    q0, dq0, tau = _inputs(6, np.float64, batch=(3,), steps=4, seed=5)
    rng = np.random.default_rng(6)
    F = rng.uniform(-3.0, 3.0, (3, 4, 6))
    g = np.array([0.0, 0.5, -9.0])
    for Ftip, int_res in ((F, 2), (F[0, 0], 1)):
        ref = jtraj._forward_dynamics_trajectory_generic(
            jm, *(jnp.asarray(v) for v in (q0, dq0, tau)), jnp.asarray(g), jnp.asarray(Ftip), 0.01, int_res
        )
        port = ttraj.forward_dynamics_trajectory(
            tm, *(torch.from_numpy(v) for v in (q0, dq0, tau)),
            g=torch.from_numpy(g), Ftipmat=torch.from_numpy(Ftip), dt=0.01, intRes=int_res,
        )
        _compare(port, ref, F64_TOL)


def test_generic_path_agrees_with_engine_without_wrench(ur5_pair, jax_rollouts):
    _, tm = ur5_pair
    x, ref = jax_rollouts["float64", 3]
    port = ttraj._forward_dynamics_trajectory_generic(tm, *(torch.from_numpy(v) for v in x), intRes=3)
    _compare(port, ref, F64_TOL)


def test_rollout_needing_grad_takes_generic_path(ur5_pair):
    _, tm = ur5_pair
    q0, dq0, tau = (torch.from_numpy(v) for v in _inputs(6, np.float64, batch=(2,), steps=3))
    tau.requires_grad_(True)
    qs, _, _ = ttraj.forward_dynamics_trajectory(tm, q0, dq0, tau)
    qs[:, -1].sum().backward()
    assert tau.grad is not None and bool(torch.isfinite(tau.grad).all())


@pytest.mark.parametrize("use_rnea", [True, False])
def test_inverse_dynamics_trajectory_matches_jax(ur5_pair, use_rnea):
    jm, tm = ur5_pair
    rng = np.random.default_rng(8)
    th, dth, ddth = (rng.uniform(-1.0, 1.0, (2, 5, 6)) for _ in range(3))
    Ftip = rng.uniform(-2.0, 2.0, 6)
    for f in (None, Ftip):
        ref = jtraj.inverse_dynamics_trajectory(
            jm, *(jnp.asarray(v) for v in (th, dth, ddth)),
            Ftip=None if f is None else jnp.asarray(f), use_rnea=use_rnea,
        )
        port = ttraj.inverse_dynamics_trajectory(
            tm, *(torch.from_numpy(v) for v in (th, dth, ddth)),
            Ftip=None if f is None else torch.from_numpy(f), use_rnea=use_rnea,
        )
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", [3, 5, 1])
def test_joint_trajectory_matches_jax(ur5_pair, method):
    jm, tm = ur5_pair
    rng = np.random.default_rng(9)
    start = rng.uniform(-1.0, 1.0, (4, 6))
    end = rng.uniform(-8.0, 8.0, (4, 6))  # beyond the limits: positions clip
    ref = jtraj.joint_trajectory(jm, jnp.asarray(start), jnp.asarray(end), 2.0, 11, method)
    port = ttraj.joint_trajectory(tm, torch.from_numpy(start), torch.from_numpy(end), 2.0, 11, method)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# Dispatch and the kernel's wrapper
# ---------------------------------------------------------------------------


def test_rollout_kind_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dispatch.rollout_kind(cuda, torch.float32, True) == "cuda"
    assert dispatch.rollout_kind(cuda, torch.float64, True) == "torch"
    assert dispatch.rollout_kind(cuda, torch.float32, False) == "torch"
    assert dispatch.rollout_kind(cpu, torch.float32, True) == "torch"
    with pytest.raises(ValueError):
        dispatch.rollout_engine(catalog.ur5(), 0.01, 1, (0.0, 0.0, -9.81), kind="pallas")


def test_engine_cache_keys_on_digest():
    a = catalog.ur5()
    b = catalog.ur5()
    x = [torch.from_numpy(v) for v in _inputs(6, np.float32, batch=(2,), steps=2)]
    key_args = dict(dt=0.01, intRes=1, g=(0.0, 0.0, -9.81), device=torch.device("cpu"),
                    dtype=torch.float32, batched_2d=True)
    ea = ttraj._rollout_engine_for(a, **key_args)
    assert ttraj._rollout_engine_for(b, **key_args) is ea
    assert ea.kind == "torch"
    ttraj.forward_dynamics_trajectory(b, *x)
    cuda_engine = ttraj._rollout_engine_for(a, **dict(key_args, device=torch.device("cuda")))
    assert isinstance(cuda_engine, CudaRollout) and cuda_engine.kind == "cuda"


def test_cuda_rollout_on_cpu_tensors_runs_plain_version(ur5_pair, jax_rollouts):
    _, tm = ur5_pair
    x, ref = jax_rollouts["float32", 1]
    engine = build_cuda_rollout(tm.to(dtype=torch.float32), dt=0.01)
    before = CudaRollout.launch_count
    out = engine(*(torch.from_numpy(v) for v in x))
    _compare(out, ref, F32_TOL)
    assert engine.launches == 0 and CudaRollout.launch_count == before


def test_cuda_rollout_refuses_non_cuda_non_cpu_inputs():
    engine = build_cuda_rollout(catalog.ur5())
    x = [torch.empty(s, device="meta") for s in ((4, 6), (4, 6), (4, 3, 6))]
    with pytest.raises(ValueError):
        engine(*x)
    with pytest.raises(ValueError):
        build_cuda_rollout(catalog.ur5(), intRes=0)


def test_cuda_rollout_checks_inputs():
    engine = build_cuda_rollout(catalog.ur5())
    good = [torch.zeros(s) for s in ((4, 6), (4, 6), (4, 3, 6))]
    cases = [
        ((torch.zeros(4, 5), good[1], good[2]), ValueError),
        ((good[0], torch.zeros(3, 6), good[2]), ValueError),
        ((good[0], good[1], torch.zeros(4, 3, 5)), ValueError),
        ((good[0].double(), good[1], good[2]), TypeError),
        ((good[0], good[1], torch.zeros(4, 6, 3).transpose(1, 2)), ValueError),
    ]
    for args, err in cases:
        with pytest.raises(err):
            engine._check(*args)
    engine._check(*good)


def test_rollout_source_assembles_template(ur5_pair):
    _, tm = ur5_pair
    src = rollout_source(tm, 0.01, 3)
    assert "#define MPT_NJ 6" in src and "#define MPT_INT_RES 3" in src
    assert "static __device__ __forceinline__ void fd_step(" in src
    assert 'extern "C" int launch(' in src and "mpt_rollout_kernel<<<" in src
    assert src.index("void fd_step(") < src.index("mpt_rollout_kernel(")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library("// empty\n", "nothing")
