"""The CUDA rollout kernel on a card, against its plain PyTorch version.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU. The module imports no JAX, so it also runs on a machine without JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: 1e-4 on q, 1e-3 on dq and 2e-1 on ddq (float32).
"""

import numpy as np
import pytest
import torch

from manipulapy_tpu_torch import trajectory
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.ops.cuda_rollout import CudaRollout, build_cuda_rollout
from manipulapy_tpu_torch.ops.fd_step import build_rollout

pytestmark = pytest.mark.cuda

F32_TOL = (1e-4, 1e-3, 2e-1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc); this host has none")
    return torch.device("cuda")


def _inputs(n, B, N, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.uniform(-1.0, 1.0, (B, n)),
        rng.uniform(-0.5, 0.5, (B, n)),
        rng.uniform(-10.0, 10.0, (B, N, n)),
    )
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize(
    "robot,int_res,B,N", [("ur5", 1, 1031, 20), ("ur5", 3, 257, 6), ("panda", 1, 515, 10)]
)
def test_kernel_matches_plain_version(cuda_device, robot, int_res, B, N):
    model = catalog.get_robot(robot, device=cuda_device)
    x = _inputs(model.num_joints, B, N, cuda_device)
    engine = build_cuda_rollout(model, dt=0.01, intRes=int_res)
    got = engine(*x)
    ref = build_rollout(model, dt=0.01, intRes=int_res)(*x)
    torch.cuda.synchronize()
    assert engine.launches == 1
    for a, b, tol in zip(got, ref, F32_TOL):
        assert a.shape == (B, N, model.num_joints)
        assert float((a - b).abs().max()) <= tol


def test_kernel_keeps_nan_scenarios(cuda_device):
    model = catalog.ur5(device=cuda_device)
    q0, dq0, tau = _inputs(6, 64, 5, cuda_device, seed=1)
    q0[3, 2] = float("nan")
    qs, dqs, ddqs = build_cuda_rollout(model)(q0, dq0, tau)
    torch.cuda.synchronize()
    assert bool(torch.isnan(qs[3, 1:]).all()) and bool(torch.isnan(ddqs[3]).all())
    others = torch.cat([qs[:3], qs[4:]])
    assert bool(torch.isfinite(others).all())


def test_public_route_uses_kernel(cuda_device):
    model = catalog.ur5(device=cuda_device)
    x = _inputs(6, 67, 6, cuda_device)
    before = CudaRollout.launch_count
    qs, _, _ = trajectory.forward_dynamics_trajectory(model, *x)
    torch.cuda.synchronize()
    assert CudaRollout.launch_count == before + 1
    assert qs.shape == (67, 6, 6) and bool(torch.isfinite(qs).all())


def test_kernel_rejects_float64_on_card(cuda_device):
    engine = build_cuda_rollout(catalog.ur5(device=cuda_device))
    x = [t.double() for t in _inputs(6, 4, 2, cuda_device)]
    with pytest.raises(TypeError):
        engine(*x)


def test_kernel_reports_registers(cuda_device):
    attrs = build_cuda_rollout(catalog.ur5(device=cuda_device)).kernel_attributes()
    assert 0 < attrs["num_regs"] <= 255 and attrs["max_threads"] >= 128
