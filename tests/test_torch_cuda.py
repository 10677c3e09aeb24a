"""The CUDA kernels on a card, against their plain PyTorch versions: the
rollout (K1), the batched fused MPC (K2-K5), the single-problem fused MPC
(K6-K8) and the planning path's elementwise kernels (K9, K10).

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU. The module imports no JAX, so it also runs on a machine without JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: 1e-4 on q, 1e-3 on dq and 2e-1 on ddq (float32) for the
rollout, and max |d| = 0 for its staged kernel at B off the block and N
around the chunk (``-k bitwise``); 1e-5 of each
output's largest magnitude for K3 (the same
operations in the same order with --fmad=false, so 0 is expected; K3's
own tests alone: ``-k "backward_kernel and not single"``); every other MPC
kernel bit for bit: K7's ``-k "single and backward"``; K6's, with NaN where
the plain version has NaN, both of its designs, a 12-joint chain and an
8-joint solve: ``-k single_problem_linearize``; K2's, with NaN where the
plain version has NaN: ``-k linearize_kernel``; K5's and K8's, the same:
``-k "replay or forward_kernel"``; K4's with its trajectories and the
12-joint solve: ``-k "linesearch or serial_chain_12"``); the JAX test's bars (cost rtol 1e-5,
final state atol 5e-4, controls atol 5e-3) for the
whole MPC solves against the plain solvers; for K9 2e-6 / 2e-5 / 2e-4 on pos
/ vel / acc and for K10 rtol 1e-4 with atol 1e-5 on U and 1e-4 on its
gradient, the JAX kernel tests' bars (0 is expected here too).
"""

import re

import numpy as np
import pytest
import torch

from manipulapy_tpu_torch import create_planner, potential_field, trajectory
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.ops.cuda_mpc_batch import BatchMPCKernels
from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels
from manipulapy_tpu_torch.ops.cuda_rollout import BLOCK, CHUNK, CudaRollout, build_cuda_rollout
from manipulapy_tpu_torch.ops import elementwise as ew
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


def _assert_bitwise(got, ref, shape):
    for a, b in zip(got, ref):
        assert a.shape == shape
        assert float((a - b).abs().max()) == 0.0  # also fails on NaN


@pytest.mark.parametrize("N", [1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1])
@pytest.mark.parametrize("B", [BLOCK - 1, 3 * BLOCK + 7])
def test_kernel_is_bitwise_off_the_block_and_chunk(cuda_device, B, N):
    """B off the block, N at and around the chunk's boundaries."""
    model = catalog.ur5(device=cuda_device)
    x = _inputs(6, B, N, cuda_device, seed=N)
    engine = build_cuda_rollout(model)
    got = engine(*x)
    ref = build_rollout(model, dt=0.01)(*x)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref, (B, N, 6))
    assert engine.launches == 1


@pytest.mark.parametrize("robot,int_res", [("panda", 1), ("ur5", 3)])
def test_kernel_is_bitwise_for_panda_and_substeps(cuda_device, robot, int_res):
    model = catalog.get_robot(robot, device=cuda_device)
    n, B, N = model.num_joints, 2 * BLOCK + 5, 2 * CHUNK + 3
    x = _inputs(n, B, N, cuda_device, seed=int_res)
    got = build_cuda_rollout(model, intRes=int_res)(*x)
    ref = build_rollout(model, dt=0.01, intRes=int_res)(*x)
    torch.cuda.synchronize()
    _assert_bitwise(got, ref, (B, N, n))


@pytest.mark.parametrize("robot", ["ur5", "panda"])
def test_kernel_reports_shared_bytes_and_keeps_its_occupancy(cuda_device, robot):
    """The tiles in dynamic shared memory, none static; no more local
    bytes than the 32 of sinf/cosf's reduction frame; and the tiles cost no
    block an SM."""
    model = catalog.get_robot(robot, device=cuda_device)
    a = build_cuda_rollout(model).kernel_attributes()
    # five tiles (tau twice, q, dq, ddq), a row of CHUNK * n floats made odd
    assert a["dynamic_smem_bytes"] == 5 * BLOCK * ((CHUNK * model.num_joints) | 1) * 4
    assert a["smem_bytes"] == 0 and a["local_bytes"] <= 32
    assert a["max_threads"] == BLOCK
    assert a["blocks_per_sm"] == a["blocks_per_sm_without_tiles"] >= 1


# ---------------------------------------------------------------------------
# The batched fused MPC kernels (K2-K5)
# ---------------------------------------------------------------------------

MPC_RTOL = 1e-5


def _mpc_problem(model, B, H, device, seed=0):
    """x0 (B, 2n) at rest inside the limits, goals (B, n) near them, and
    torques (H, n, B) within 30% of the limits, from numpy."""
    n = model.num_joints
    rng = np.random.default_rng(seed)
    lo, hi = model.joint_lower.cpu().double().numpy(), model.joint_upper.cpu().double().numpy()
    q0 = (lo + hi) / 2 + rng.uniform(-0.5, 0.5, (B, n)) * (hi - lo) / 2
    goals = np.clip(q0 + rng.uniform(-0.3, 0.3, (B, n)), lo, hi)
    u_lim = model.torque_limit.cpu().double().numpy()
    us = rng.uniform(-0.3, 0.3, (H, n, B)) * u_lim[None, :, None]
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).contiguous()
    return f32(np.concatenate([q0, np.zeros_like(q0)], axis=1)), f32(goals), f32(us)


def _close_to_scale(got, ref):
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())
    assert float((got - ref).abs().max()) <= MPC_RTOL * float(ref.abs().max())


@pytest.mark.parametrize("robot", ["panda", "ur5"])
def test_mpc_kernels_match_plain_versions(cuda_device, robot):
    """B=257 (not a multiple of the block), H=8; K2 and K3 fed from a real
    nominal trajectory, K4 and K5 from K3's gains."""
    model = catalog.get_robot(robot, device=cuda_device)
    n, nx, B, H = model.num_joints, 2 * model.num_joints, 257, 8
    x0, goals, us = _mpc_problem(model, B, H, cuda_device)
    K = build_batch_tracking_mpc(model, goals, B, H, 0.01).kernels
    P = K.plain()
    x0_t, goal_t = x0.T.contiguous(), goals.T.contiguous()
    zeros = lambda *s: torch.zeros(s, device=cuda_device)
    before = dict(BatchMPCKernels.launch_count)
    init = (x0_t, zeros(H, nx, B), us, zeros(H, n, 1 + nx, B), goal_t, zeros(B))
    xs0 = K.replay(*init)
    for g, r in zip(xs0, P.replay(*init)):
        _close_to_scale(g, r)
    sd_x = torch.cat([x0_t[None], xs0[0][:-1]]).contiguous()
    AB = K.linearize(sd_x, us)
    _close_to_scale(AB, P.linearize(sd_x, us))
    args = (AB, sd_x, us, xs0[0][-1].contiguous(), goal_t, torch.full((B,), 1e-6, device=cuda_device))
    kK = K.backward(*args)
    _close_to_scale(kK, P.backward(*args))
    alphas = 0.5 ** torch.arange(6, device=cuda_device, dtype=torch.float32)
    args = (x0_t, sd_x, us, kK, goal_t, alphas)
    _close_to_scale(K.linesearch_costs(*args), P.linesearch_costs(*args))
    for g, r in zip(K.linesearch(*args), P.linesearch(*args)):
        _close_to_scale(g, r)
    args = (x0_t, sd_x, us, kK, goal_t, alphas[torch.arange(B, device=cuda_device) % 6].contiguous())
    for g, r in zip(K.replay(*args), P.replay(*args)):
        _close_to_scale(g, r)
    torch.cuda.synchronize()
    after = BatchMPCKernels.launch_count
    assert {k: after[k] - before[k] for k in after} == {
        "linearize": 1, "backward": 1, "linesearch_costs": 1, "linesearch": 1, "replay": 2
    }


# K2 alone: one thread per (scenario, group of LIN_SEEDS seeds, step), the
# primal step once and each tangent once per seed, bitwise against the plain
# linearization (NaN where it is NaN). Its local bytes in blocks of 64, UR5
# at 3 seeds a thread and Panda at 1 (PERF.md section 6, nvcc 12.8): more
# local bytes than these would mean a worse schedule.
K2_LOCAL_BYTES = {"ur5": 40, "panda": 0}
_K2_SETS = {}


def _k2(robot, device, g=(0.0, 0.0, -9.81)):
    """K2-K5 for a robot at dt 0.01 with its own torque limits (one build a
    robot and g for the whole module)."""
    if (robot, g) not in _K2_SETS:
        model = catalog.get_robot(robot, device=device)
        u_lim = [float(v) for v in model.torque_limit.cpu()]
        _K2_SETS[robot, g] = (model, BatchMPCKernels(model, 0.01, g=g, u_lim=u_lim))
    return _K2_SETS[robot, g]


def _lin_states(model, B, H, device, seed):
    """xs (H, 2n, B) inside the joint limits, us (H, n, B) within 30% of the
    torque limits, from numpy."""
    n = model.num_joints
    rng = np.random.default_rng(seed)
    lo, hi = model.joint_lower.cpu().double().numpy(), model.joint_upper.cpu().double().numpy()
    lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
    q = (lo + hi)[None, :, None] / 2 + rng.uniform(-0.8, 0.8, (H, n, B)) * (hi - lo)[None, :, None] / 2
    dq = rng.uniform(-0.5, 0.5, (H, n, B))
    us = rng.uniform(-0.3, 0.3, (H, n, B)) * model.torque_limit.cpu().double().numpy()[None, :, None]
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).contiguous()
    return f32(np.concatenate([q, dq], axis=1)), f32(us)


def _assert_bits_and_nans(got, ref):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan], ref.view(torch.int32)[~nan])


@pytest.mark.parametrize("H", [1, 50])
@pytest.mark.parametrize("B", [1, 3, 257, 1024])
@pytest.mark.parametrize("robot", ["ur5", "panda"])
def test_linearize_kernel_is_bitwise(cuda_device, robot, B, H):
    model, K = _k2(robot, cuda_device)
    n = model.num_joints
    xs, us = _lin_states(model, B, H, cuda_device, seed=B + H)
    before = BatchMPCKernels.launch_count["linearize"]
    AB = K.linearize(xs, us)
    torch.cuda.synchronize()
    assert BatchMPCKernels.launch_count["linearize"] == before + 1
    assert AB.shape == (H, 2 * n, 3 * n, B)
    ref = K.linearize_plain(xs, us)
    assert bool(torch.isfinite(ref).all())
    _assert_bits_and_nans(AB, ref)


@pytest.mark.parametrize("robot", ["ur5", "panda"])
def test_linearize_kernel_halves_the_tangent_on_a_limit(cuda_device, robot):
    """Gravity off, scenario 0 at rest on joint 0's lower limit with zero
    torque: q'_0 is the limit exactly and its tangent is halved there."""
    model, K = _k2(robot, cuda_device, g=(0.0, 0.0, 0.0))
    n = model.num_joints
    xs, us = _lin_states(model, 257, 8, cuda_device, seed=3)
    xs[:, 0, 0] = model.joint_lower[0]
    xs[:, n:, 0], us[..., 0] = 0.0, 0.0
    AB = K.linearize(xs, us)
    torch.cuda.synchronize()
    _assert_bits_and_nans(AB, K.linearize_plain(xs, us))
    assert bool((AB[:, 0, 0, 0] == 0.5).all())  # d q'_0 / d q_0 on the limit


@pytest.mark.parametrize("robot", ["ur5", "panda"])
def test_linearize_kernel_keeps_a_nan_scenario_to_itself(cuda_device, robot):
    """Scenario 5's joint-0 velocity NaN at every step: its Jacobians go
    NaN where the plain version's do, the other 256 keep the clean run's
    bits. K2's local bytes stay at or below the recorded figure."""
    model, K = _k2(robot, cuda_device)
    n = model.num_joints
    xs, us = _lin_states(model, 257, 8, cuda_device, seed=4)
    clean = K.linearize(xs, us)
    xs[:, n, 5] = float("nan")
    dirty = K.linearize(xs, us)
    torch.cuda.synchronize()
    _assert_bits_and_nans(dirty, K.linearize_plain(xs, us))
    assert bool(torch.isnan(dirty[..., 5]).any())
    others = torch.arange(257, device=cuda_device) != 5
    assert torch.equal(dirty[..., others].view(torch.int32), clean[..., others].view(torch.int32))
    attrs = K.kernel_attributes()["linearize"]
    assert attrs["local_bytes"] <= K2_LOCAL_BYTES[robot] and attrs["max_threads"] == 64


@pytest.fixture(scope="module")
def panda_bwd_nominal():
    """K3's inputs at Panda B=1024, H=50 from the solver's own controls (50
    open-loop steps of random torques leave some scenarios non-finite), the
    Levenberg term cycling through 1e-6, 1e-3 and 10 over the scenarios."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc); this host has none")
    dev = torch.device("cuda")
    model = catalog.panda(device=dev)
    B, H, n = 1024, 50, 7
    x0, goals, _ = _mpc_problem(model, B, H, dev, seed=5)
    mpc = build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=2)
    us = mpc.solve(x0, torch.zeros((B, H, n), device=dev))[0].permute(1, 2, 0).contiguous()
    K = mpc.kernels
    zeros = lambda *s: torch.zeros(s, device=dev)
    x0_t, goal_t = x0.T.contiguous(), goals.T.contiguous()
    xs = K.replay(x0_t, zeros(H, 2 * n, B), us, zeros(H, n, 1 + 2 * n, B), goal_t, zeros(B))[0]
    sd_x = torch.cat([x0_t[None], xs[:-1]]).contiguous()
    reg = torch.tensor([1e-6, 1e-3, 10.0], device=dev)[torch.arange(B, device=dev) % 3].contiguous()
    return K, (K.linearize(sd_x, us), sd_x, us, xs, goal_t, reg)


def _bwd_args(nominal, B, H):
    """The first B scenarios and H steps, x_last the state after step H."""
    AB, sd_x, us, xs, goal, reg = nominal
    c = lambda x: x[..., :B].contiguous()
    return c(AB[:H]), c(sd_x[:H]), c(us[:H]), c(xs[H - 1]), c(goal), c(reg)


@pytest.mark.parametrize("H", [1, 50])
@pytest.mark.parametrize("B", [1, 3, 257, 1024])
def test_backward_kernel_matches_plain_version(cuda_device, panda_bwd_nominal, B, H):
    """K3, one warp per scenario, against its plain version: the same
    operations in the same order, so max |d| = 0 is expected; the gate is
    1e-5 of the largest |plain|. One launch per call."""
    K, nominal = panda_bwd_nominal
    args = _bwd_args(nominal, B, H)
    before = BatchMPCKernels.launch_count["backward"]
    kK = K.backward(*args)
    torch.cuda.synchronize()
    assert BatchMPCKernels.launch_count["backward"] == before + 1
    ref = K.backward_plain(*args)
    assert kK.shape == (H, 7, 15, B)
    _close_to_scale(kK, ref)


def test_backward_kernel_keeps_a_nan_scenario_to_itself(cuda_device, panda_bwd_nominal):
    """Scenario 5's Jacobians all NaN: its gains go NaN, the other 256 stay
    bit for bit those of the clean run (warps share a block, not a storage
    region). K3 keeps its state in dynamic shared memory: no local (stack)
    bytes, no static shared bytes."""
    K, nominal = panda_bwd_nominal
    args = _bwd_args(nominal, 257, 8)
    clean = K.backward(*args)
    AB = args[0].clone()
    AB[..., 5] = float("nan")
    dirty = K.backward(AB, *args[1:])
    torch.cuda.synchronize()
    assert bool(torch.isnan(dirty[..., 5]).all())
    others = torch.arange(257, device=cuda_device) != 5
    assert torch.equal(dirty[..., others].view(torch.int32), clean[..., others].view(torch.int32))
    attrs = K.kernel_attributes()["backward"]
    assert attrs["local_bytes"] == 0 and 0 < attrs["num_regs"] <= 255 and attrs["smem_bytes"] == 0
    assert K.layout_bytes()["backward"] == 19056  # 4 warps' storage for Panda


def test_mpc_solve_runs_on_the_kernels(cuda_device):
    model = catalog.panda(device=cuda_device)
    B, H = 64, 10
    x0, goals, _ = _mpc_problem(model, B, H, cuda_device, seed=1)
    mpc = build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=2)
    us0 = torch.zeros((B, H, 7), device=cuda_device)
    BatchMPCKernels.reset_launch_count()
    us, xs, cost = mpc.solve(x0, us0)
    torch.cuda.synchronize()
    assert BatchMPCKernels.launch_count == {"linearize": 2, "backward": 2, "linesearch_costs": 0, "linesearch": 2,
                                            "replay": 1}
    us_p, xs_p, cost_p = mpc.solve_plain(x0, us0)
    assert us.shape == (B, H, 7) and xs.shape == (B, H + 1, 14) and cost.shape == (B,)
    assert float(((cost - cost_p).abs() / cost_p.abs()).max()) <= 1e-5
    assert float((xs[:, -1] - xs_p[:, -1]).abs().max()) <= 5e-4
    assert float((us - us_p).abs().max()) <= 5e-3
    assert bool((us.abs() <= model.torque_limit).all())


def test_mpc_kernels_reject_float64_and_mixed_devices(cuda_device):
    model = catalog.two_link_planar(device=cuda_device)
    K = build_batch_tracking_mpc(model, [0.1, 0.2], 3, 2, 0.01).kernels
    xs, us = torch.zeros((2, 4, 3), device=cuda_device), torch.zeros((2, 2, 3), device=cuda_device)
    with pytest.raises(TypeError):
        K.linearize(xs.double(), us.double())
    with pytest.raises(ValueError):
        K.linearize(xs, us.cpu())
    with pytest.raises(ValueError):
        K.linearize(xs, us[:, :1])
    assert K.linearize(xs, us).shape == (2, 4, 6, 3)


# K5 alone: one thread a scenario, bitwise against the plain replay (NaN
# where it is NaN), at the main path's widths and off the block; its team
# variant (TEAM_WARPS warps per TEAM_S scenarios run each closed-loop step,
# the emitted step partitioned over the warps) likewise.


def _replay_args(model, K, B, H, device, seed):
    """x0 at rest inside the limits, a nominal of states inside the limits
    and torques within 30% of the limits, gains of 0.1 scale, one alpha a
    scenario."""
    n = model.num_joints
    x0, goals, _ = _mpc_problem(model, B, 1, device, seed)
    sd_x, us = _lin_states(model, B, H, device, seed)
    rng = np.random.default_rng(seed)
    kK = torch.from_numpy(rng.uniform(-0.1, 0.1, (H, n, 1 + 2 * n, B)).astype(np.float32)).to(device)
    alpha = (0.5 ** torch.arange(6, device=device, dtype=torch.float32))[torch.arange(B, device=device) % 6]
    return x0.T.contiguous(), sd_x, us, kK, goals.T.contiguous(), alpha.contiguous()


@pytest.mark.parametrize("robot, B, H", [
    ("panda", 1024, 50), ("panda", 4096, 50), ("panda", 16384, 50), ("panda", 1025, 50),
    ("panda", 33, 7), ("ur5", 1024, 50), ("ur5", 31, 7),
])
def test_replay_kernel_is_bitwise_the_plain_version(cuda_device, robot, B, H):
    model, K = _k2(robot, cuda_device)
    args = _replay_args(model, K, B, H, cuda_device, seed=B)
    before = BatchMPCKernels.launch_count["replay"]
    got = K.replay(*args)
    torch.cuda.synchronize()
    assert BatchMPCKernels.launch_count["replay"] == before + 1
    for g, r in zip(got, K.replay_plain(*args)):
        _assert_bits_and_nans(g, r)
    assert K.team is None and K.kernel_attributes()["replay"]["max_threads"] == 128


_TEAMS = {}


def _team(robot, device):
    """K5's team variant (8 warps per 32 scenarios, 2 teams a block) for a
    robot, its fwd unit alone."""
    if robot not in _TEAMS:
        model = catalog.get_robot(robot, device=device)
        cls = type("Team", (BatchMPCKernels,), {"TEAM_WARPS": 8, "UNITS": {"fwd": BatchMPCKernels.UNITS["fwd"]}})
        _TEAMS[robot] = (model, cls(model, 0.01, u_lim=[float(v) for v in model.torque_limit.cpu()]))
    return _TEAMS[robot]


@pytest.mark.parametrize("robot, B, H", [("panda", 1024, 50), ("panda", 1025, 7), ("ur5", 31, 7)])
def test_replay_team_variant_is_bitwise_the_plain_version(cuda_device, robot, B, H):
    model, K = _team(robot, cuda_device)
    args = _replay_args(model, K, B, H, cuda_device, seed=B)
    for g, r in zip(K.replay(*args), K.replay_plain(*args)):
        _assert_bits_and_nans(g, r)
    team = K.team_attributes()
    assert (team["warps"], team["scenarios"], team["teams_per_block"]) == (K.TEAM_WARPS, K.TEAM_S, K.TEAM_PER_BLOCK)
    assert team["phases"] == K.team.partition.phases and team["slots"] == max(K.team.slots, 1)
    assert team["dynamic_smem_bytes"] == K.layout_bytes()["replay_team"]


def test_replay_kernel_fits_fewer_teams_a_block_for_eight_joints(cuda_device):
    """An 8-joint chain's team (the variant unit) needs more than half the
    shared memory a block may take, so its block holds one team; a
    12-joint chain's holds 16 scenarios a team. Still bit for bit."""
    for n, B, H in ((8, 100, 6), (12, 40, 3)):
        model = catalog.serial_chain(n, device=cuda_device)
        K = type("Team", (BatchMPCKernels,), {"TEAM_WARPS": 8, "UNITS": {"fwd": BatchMPCKernels.UNITS["fwd"]}})(
            model, 0.01, u_lim=[10.0] * n)
        rng = np.random.default_rng(n)
        f32 = lambda *shape: torch.from_numpy(rng.uniform(-1.0, 1.0, shape).astype(np.float32)).to(cuda_device)
        args = (f32(2 * n, B) * 0.5, f32(H, 2 * n, B) * 0.5, f32(H, n, B) * 3.0, f32(H, n, 1 + 2 * n, B) * 0.1,
                f32(n, B), f32(B).abs())
        for g, r in zip(K.replay(*args), K.replay_plain(*args)):
            _assert_bits_and_nans(g, r)
        team = K.team_attributes()
        assert team["teams_per_block"] == 1 < K.TEAM_PER_BLOCK
        assert team["scenarios"] == (32 if n == 8 else 16)
        assert team["dynamic_smem_bytes"] <= 232448


def test_replay_kernel_keeps_a_nan_scenario_to_itself(cuda_device):
    """Scenario 5's gains all NaN: its rows go NaN, every other scenario of
    its team keeps the clean run's bits."""
    model, K = _k2("panda", cuda_device)
    args = list(_replay_args(model, K, 64, 10, cuda_device, seed=3))
    clean = K.replay(*args)
    args[3] = args[3].clone()
    args[3][..., 5] = float("nan")
    dirty = K.replay(*args)
    for g, c, r in zip(dirty, clean, K.replay_plain(*args)):
        _assert_bits_and_nans(g, r)
        assert bool(torch.isnan(g[..., 5]).all())
        keep = [b for b in range(64) if b != 5]
        assert torch.equal(g[..., keep].view(torch.int32), c[..., keep].view(torch.int32))


def test_linesearch_trajectory_at_the_chosen_alpha_is_the_replay(cuda_device):
    """K4 keeps every alpha's trajectory: at each scenario's alpha (here b %
    6) its states, controls and cost are the one-thread K5's replay at that
    alpha, bit for bit, at the main path's width; each launch counts once."""
    model, K = _k2("panda", cuda_device)
    B, H, A = 1024, 50, 6
    x0_t, sd_x, us, kK, goal_t, alpha = _replay_args(model, K, B, H, cuda_device, seed=11)
    alphas = 0.5 ** torch.arange(A, device=cuda_device, dtype=torch.float32)
    before = dict(BatchMPCKernels.launch_count)
    costs, xs_all, us_all = K.linesearch(x0_t, sd_x, us, kK, goal_t, alphas)
    xs, us_r, cost = K.replay(x0_t, sd_x, us, kK, goal_t, alpha)
    torch.cuda.synchronize()
    assert {k: BatchMPCKernels.launch_count[k] - before[k] for k in ("linesearch", "replay")} == {
        "linesearch": 1, "replay": 1}
    idx, cols = torch.arange(B, device=cuda_device) % A, torch.arange(B, device=cuda_device)
    assert bool(torch.isfinite(costs).any())  # the random nominal diverges under some alphas, in both
    _assert_bits_and_nans(xs_all[:, :, idx, cols], xs)
    _assert_bits_and_nans(us_all[:, :, idx, cols], us_r)
    _assert_bits_and_nans(costs[idx, cols], cost)
    _assert_bits_and_nans(costs, K.linesearch_costs(x0_t, sd_x, us, kK, goal_t, alphas))
    for g, r in zip((costs, xs_all, us_all), K.linesearch_plain(x0_t, sd_x, us, kK, goal_t, alphas)):
        _assert_bits_and_nans(g, r)


@pytest.mark.parametrize("threads", [32, 64])
def test_linesearch_block_variants_match_the_default(cuda_device, threads):
    """K4 built with 32 or 64 threads a block (``MPT_BLOCK``, the fwd unit
    alone) gives the default's bits, with and without its trajectories, at
    B off every block and at a main-path width."""
    model, K = _k2("panda", cuda_device)
    V = type("Block", (BatchMPCKernels,), {"UNITS": {"fwd": BatchMPCKernels.UNITS["fwd"]},
                                            "DEFINES": {"MPT_BLOCK": threads}})(model, 0.01, u_lim=K.P.u_lim)
    assert V.kernel_attributes()["linesearch"]["max_threads"] == threads
    alphas = 0.5 ** torch.arange(6, device=cuda_device, dtype=torch.float32)
    for B, H in ((1025, 8), (4096, 50)):
        x0_t, sd_x, us, kK, goal_t, _ = _replay_args(model, K, B, H, cuda_device, seed=B + threads)
        args = (x0_t, sd_x, us, kK, goal_t, alphas)
        for g, r in zip(V.linesearch(*args), K.linesearch(*args)):
            _assert_bits_and_nans(g, r)
        _assert_bits_and_nans(V.linesearch_costs(*args), K.linesearch_costs(*args))


def test_serial_chain_12_solve_builds_and_every_stage_is_bitwise(cuda_device):
    """A 12-joint chain (K3's storage past the 48 KB a block may declare
    statically, K5 one thread a scenario): the whole batched solve builds and
    runs on the kernels, B=64 H=10, and each of K2-K5 and the line search
    with its trajectories gives its plain version's bits on that solve's own
    nominal."""
    n, B, H = 12, 64, 10
    model = catalog.serial_chain(n, device=cuda_device)
    u_lim = [20.0] * n
    rng = np.random.default_rng(12)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device).contiguous()
    x0 = f32(np.concatenate([rng.uniform(-0.5, 0.5, (B, n)), np.zeros((B, n))], 1))
    goals = f32(rng.uniform(-0.5, 0.5, (B, n)))
    mpc = build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=2, u_limit=u_lim)
    K, P = mpc.kernels, mpc.kernels.plain()
    BatchMPCKernels.reset_launch_count()
    us_k, xs_k, cost_k = mpc.solve(x0, torch.zeros((B, H, n), device=cuda_device))
    torch.cuda.synchronize()
    assert BatchMPCKernels.launch_count == {"linearize": 2, "backward": 2, "linesearch_costs": 0, "linesearch": 2,
                                            "replay": 1}
    assert us_k.shape == (B, H, n) and xs_k.shape == (B, H + 1, 2 * n)
    assert all(bool(torch.isfinite(v).all()) for v in (us_k, xs_k, cost_k))
    assert bool((us_k.abs() <= 20.0).all())
    assert K.layout_bytes()["backward"] > 48 * 1024
    x0_t, goal_t = x0.T.contiguous(), goals.T.contiguous()
    us = us_k.permute(1, 2, 0).contiguous()
    zeros = lambda *shape: torch.zeros(shape, device=cuda_device)
    init = (x0_t, zeros(H, 2 * n, B), us, zeros(H, n, 1 + 2 * n, B), goal_t, zeros(B))
    xs0 = K.replay(*init)
    for g, r in zip(xs0, P.replay(*init)):
        _assert_bits_and_nans(g, r)
    sd_x = torch.cat([x0_t[None], xs0[0][:-1]]).contiguous()
    AB = K.linearize(sd_x, us)
    _assert_bits_and_nans(AB, P.linearize(sd_x, us))
    bwd = (AB, sd_x, us, xs0[0][-1].contiguous(), goal_t, torch.full((B,), 1e-3, device=cuda_device))
    kK = K.backward(*bwd)
    _assert_bits_and_nans(kK, P.backward(*bwd))
    alphas = 0.5 ** torch.arange(6, device=cuda_device, dtype=torch.float32)
    ls = (x0_t, sd_x, us, kK, goal_t, alphas)
    _assert_bits_and_nans(K.linesearch_costs(*ls), P.linesearch_costs(*ls))
    for g, r in zip(K.linesearch(*ls), P.linesearch(*ls)):
        _assert_bits_and_nans(g, r)
    rep = (x0_t, sd_x, us, kK, goal_t, alphas[torch.arange(B, device=cuda_device) % 6].contiguous())
    for g, r in zip(K.replay(*rep), P.replay(*rep)):
        _assert_bits_and_nans(g, r)


# ---------------------------------------------------------------------------
# The single-problem fused MPC kernels (K6-K8)
# ---------------------------------------------------------------------------


def test_single_mpc_kernels_match_plain_versions(cuda_device):
    """Panda, H=37 (K6's H*m threads end mid-block), random torques within
    30% of the limits; K6 and K7 fed from their open-loop rollout, K8 from
    K7's gains."""
    model = catalog.panda(device=cuda_device)
    n, nx, H = 7, 14, 37
    x0, goals, us = _mpc_problem(model, 1, H, cuda_device, seed=2)
    x0, goal, us = x0[0].contiguous(), goals[0].contiguous(), us[..., 0].contiguous()
    mpc = build_tracking_mpc(model, goal, H, 0.01)
    K, P = mpc.kernels, mpc.kernels.plain()
    zeros = lambda *s: torch.zeros(s, device=cuda_device)
    before = dict(SingleMPCKernels.launch_count)
    init = (x0, zeros(H, nx), us, zeros(H, n, 1 + nx), goal, zeros(1))
    xs0 = K.forward(*init)
    for g, r in zip(xs0, P.forward(*init)):
        _close_to_scale(g, r)
    sd_x = torch.cat([x0[None], xs0[0][0, :-1]]).contiguous()
    AB = K.linearize(sd_x, us)
    _assert_bits_and_nans(AB, P.linearize(sd_x, us))
    two_wT = torch.tensor([200.0] * n + [20.0] * n, device=cuda_device)
    Vx = two_wT * (xs0[0][0, -1] - torch.cat([goal, zeros(n)]))
    args = (AB, sd_x, us, goal, torch.cat([torch.diag(two_wT), Vx[None]]).contiguous(),
            torch.tensor(1e-6, device=cuda_device))
    kK = K.backward(*args)
    _close_to_scale(kK, P.backward(*args))
    args = (x0, sd_x, us, kK, goal, 0.5 ** torch.arange(6, device=cuda_device, dtype=torch.float32))
    for g, r in zip(K.forward(*args), P.forward(*args)):
        _close_to_scale(g, r)
    torch.cuda.synchronize()
    after = SingleMPCKernels.launch_count
    assert {k: after[k] - before[k] for k in after} == {"linearize": 1, "backward": 1, "forward": 2}


# K6 alone: the lean one-seed body, one thread a (step, seed) lane or split
# over a team of warps per 32 lanes (``LIN_WARPS``); "default" is the unit
# as built, "other" the other design (a team of 4 warps, or one thread a
# lane where the default is a team).
_K6_SETS = {}


def _k6(robot, design, device):
    default = SingleMPCKernels.LIN_WARPS
    warps = default if design == "default" else (0 if default else 4)
    if (robot, warps) not in _K6_SETS:
        model = catalog.get_robot(robot, device=device)
        cls = type("K6", (SingleMPCKernels,), {"LIN_WARPS": warps, "UNITS": {"lin": ("linearize",)}})
        _K6_SETS[robot, warps] = (model, cls(model, 0.01, u_lim=[float(v) for v in model.torque_limit.cpu()]))
    return _K6_SETS[robot, warps]


def _single_lin_states(model, H, device, seed):
    xs, us = _lin_states(model, 1, H, device, seed)
    return xs[..., 0].contiguous(), us[..., 0].contiguous()


@pytest.mark.parametrize("H", [1, 37, 50, 128])
@pytest.mark.parametrize("design", ["default", "other"])
@pytest.mark.parametrize("robot", ["ur5", "panda"])
def test_single_problem_linearize_is_bitwise(cuda_device, robot, design, H):
    """Bit for bit, NaN where the plain version has NaN; H*m lanes end
    mid-team at H = 1, 37 and 50 for the Panda (21, 777, 1050)."""
    model, K = _k6(robot, design, cuda_device)
    n = model.num_joints
    xs, us = _single_lin_states(model, H, cuda_device, seed=H)
    before = SingleMPCKernels.launch_count["linearize"]
    AB = K.linearize(xs, us)
    torch.cuda.synchronize()
    assert SingleMPCKernels.launch_count["linearize"] == before + 1
    assert AB.shape == (H, 2 * n, 3 * n)
    ref = K.linearize_plain(xs, us)
    assert bool(torch.isfinite(ref).all())
    _assert_bits_and_nans(AB, ref)


@pytest.mark.parametrize("design", ["default", "other"])
def test_single_problem_linearize_keeps_a_nan_step_to_itself(cuda_device, design):
    """Step 3 of 8 has a NaN velocity of joint 0: its Jacobian goes NaN
    where the plain version's does, every other step keeps the clean run's
    bits. No local bytes; a team's dynamic shared bytes are its layout's."""
    model, K = _k6("panda", design, cuda_device)
    xs, us = _single_lin_states(model, 8, cuda_device, seed=5)
    clean = K.linearize(xs, us)
    xs[3, 7] = float("nan")
    dirty = K.linearize(xs, us)
    torch.cuda.synchronize()
    _assert_bits_and_nans(dirty, K.linearize_plain(xs, us))
    assert bool(torch.isnan(dirty[3]).any())
    others = torch.arange(8, device=cuda_device) != 3
    assert torch.equal(dirty[others].view(torch.int32), clean[others].view(torch.int32))
    attrs = K.kernel_attributes()["linearize"]
    assert 0 < attrs["num_regs"] <= 255
    _assert_no_spills(K)
    if K.lin_team is None:
        assert attrs["max_threads"] == 32 and "linearize_team" not in K.layout_bytes()
    else:
        team = K.team_attributes("linearize")
        assert team["warps"] == K.LIN_WARPS and attrs["max_threads"] == 32 * K.LIN_WARPS
        assert team["phases"] == K.lin_team.partition.phases and team["slots"] == max(K.lin_team.slots, 1)
        assert _team_lanes(K) == 32 and team["dynamic_smem_bytes"] > 48 * 1024


def _assert_no_spills(K):
    """K6's unit spills nothing (ptxas's report of its one kernel); its local
    bytes are at most the 32-byte frame of sinf's and cosf's slow path."""
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", K.build()["lin"].log)
    assert spills and all(st == ld == "0" for st, ld in spills)
    assert K.kernel_attributes()["linearize"]["local_bytes"] <= 32


def _team_lanes(K):
    """K6's team's lanes: 32, or the most (halving) whose storage fits a
    block; its dynamic shared bytes are its layout's."""
    team = K.team_attributes("linearize")
    lane_bytes = (2 * K.nx + K.n + K.m + max(K.lin_team.slots, 1)) * 4  # x, u, s, the column, the slots
    lanes = team["scenarios"]
    assert team["dynamic_smem_bytes"] == lanes * lane_bytes == K.layout_bytes()["linearize_team"] <= 232448
    assert lanes == 32 or 2 * lanes * lane_bytes > 232448
    return lanes


def test_single_problem_linearize_of_serial_chain_12_and_its_stages_are_bitwise(cuda_device):
    """A 12-joint chain, one problem, H=10 (past the solver's n <= 8, the
    JAX package's limit, so the stages are driven as the solve drives
    them): all three units build, K6's team halves its lanes until its
    slots fit a block (16 at 8 warps), and each of K6-K8 gives its plain
    version's bits on the open loop of random torques and K7's gains."""
    n, H = 12, 10
    model = catalog.serial_chain(n, device=cuda_device)
    K = SingleMPCKernels(model, 0.01, u_lim=[20.0] * n)
    P = K.plain()
    rng = np.random.default_rng(12)
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(cuda_device).contiguous()
    x0 = f32(np.concatenate([rng.uniform(-0.5, 0.5, n), np.zeros(n)]))
    us, goal = f32(rng.uniform(-5.0, 5.0, (H, n))), f32(rng.uniform(-0.5, 0.5, n))
    zeros = lambda *shape: torch.zeros(shape, device=cuda_device)
    init = (x0, zeros(H, 2 * n), us, zeros(H, n, 1 + 2 * n), goal, zeros(1))
    xs0 = K.forward(*init)
    for g, r in zip(xs0, P.forward(*init)):
        _assert_bits_and_nans(g, r)
    sd_x = torch.cat([x0[None], xs0[0][0, :-1]]).contiguous()
    AB = K.linearize(sd_x, us)
    _assert_bits_and_nans(AB, P.linearize(sd_x, us))
    two_wT = torch.tensor([2.0 * w for w in K.P.wT], device=cuda_device)
    Vx = two_wT * (xs0[0][0, -1] - torch.cat([goal, zeros(n)]))
    bwd = (AB, sd_x, us, goal, torch.cat([torch.diag(two_wT), Vx[None]]).contiguous(),
           torch.tensor(1e-3, device=cuda_device))
    kK = K.backward(*bwd)
    _assert_bits_and_nans(kK, P.backward(*bwd))
    fwd = (x0, sd_x, us, kK, goal, 0.5 ** torch.arange(6, device=cuda_device, dtype=torch.float32))
    for g, r in zip(K.forward(*fwd), P.forward(*fwd)):
        _assert_bits_and_nans(g, r)
    assert bool(torch.isfinite(AB).all()) and bool(torch.isfinite(kK).all())
    if K.lin_team is not None:
        assert _team_lanes(K) < 32


def test_single_problem_linearize_in_an_8_joint_solve(cuda_device):
    """n = 8, the largest the solver takes (K6's team's storage the most
    lanes that fit a block): the solve launches 2/2/3 kernels and meets the
    plain solver at the JAX test's bars."""
    n, H = 8, 10
    model = catalog.serial_chain(n, device=cuda_device)
    rng = np.random.default_rng(8)
    goal = rng.uniform(-0.5, 0.5, n)
    mpc = build_tracking_mpc(model, goal, H, 0.01, iterations=2, u_limit=[20.0] * n)
    x0 = torch.from_numpy(np.concatenate([rng.uniform(-0.3, 0.3, n), np.zeros(n)]).astype(np.float32)).to(cuda_device)
    us0 = torch.zeros((H, n), device=cuda_device)
    SingleMPCKernels.reset_launch_count()
    us, xs, cost = mpc.solve(x0, us0)
    torch.cuda.synchronize()
    assert SingleMPCKernels.launch_count == {"linearize": 2, "backward": 2, "forward": 3}
    us_p, xs_p, cost_p = mpc.solve_plain(x0, us0)
    assert all(bool(torch.isfinite(v).all()) for v in (us, xs, cost))
    assert float((cost - cost_p).abs() / cost_p.abs()) <= 1e-5
    assert float((xs[-1] - xs_p[-1]).abs().max()) <= 5e-4
    assert float((us - us_p).abs().max()) <= 5e-3
    if mpc.kernels.lin_team is not None:
        _team_lanes(mpc.kernels)


@pytest.fixture(scope="module")
def panda_single_nominal():
    """K7's inputs at Panda H=128 from the solver's own controls (2
    iterations from rest inside the limits), rolled open loop by K8 with
    zero gains and linearized by K6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc); this host has none")
    dev = torch.device("cuda")
    model = catalog.panda(device=dev)
    H, n = 128, 7
    x0, goals, _ = _mpc_problem(model, 1, H, dev, seed=6)
    x0, goal = x0[0].contiguous(), goals[0].contiguous()
    mpc = build_tracking_mpc(model, goal, H, 0.01, iterations=2)
    us = mpc.solve(x0, torch.zeros((H, n), device=dev))[0].contiguous()
    K = mpc.kernels
    zeros = lambda *s: torch.zeros(s, device=dev)
    xs = K.forward(x0, zeros(H, 2 * n), us, zeros(H, n, 1 + 2 * n), goal, zeros(1))[0][0]
    sd_x = torch.cat([x0[None], xs[:-1]]).contiguous()
    return K, (K.linearize(sd_x, us), sd_x, us, xs, goal)


def _single_bwd_args(K, nominal, H, reg):
    """The first H steps, Vterm the terminal value function at the state
    after step H: diag(2 wT), then 2 wT (x - goal)."""
    AB, sd_x, us, xs, goal = nominal
    two_wT = torch.tensor([2.0 * w for w in K.P.wT], device=goal.device)
    Vx = two_wT * (xs[H - 1] - torch.cat([goal, torch.zeros_like(goal)]))
    Vterm = torch.cat([torch.diag(two_wT), Vx[None]]).contiguous()
    c = lambda x: x[:H].contiguous()
    return c(AB), c(sd_x), c(us), goal, Vterm, torch.tensor(reg, device=goal.device)


@pytest.mark.parametrize("H, reg", [(1, 1e-6), (37, 1e-3), (50, 10.0), (128, 1e-6)])
def test_single_backward_kernel_matches_plain_version(cuda_device, panda_single_nominal, H, reg):
    """K7, one block of threads, against its plain version: the same
    operations in the same order, bit for bit. One launch per call."""
    K, nominal = panda_single_nominal
    args = _single_bwd_args(K, nominal, H, reg)
    before = SingleMPCKernels.launch_count["backward"]
    kK = K.backward(*args)
    torch.cuda.synchronize()
    assert SingleMPCKernels.launch_count["backward"] == before + 1
    ref = K.backward_plain(*args)
    assert kK.shape == (H, 7, 15) and bool(torch.isfinite(ref).all())
    assert torch.equal(kK.view(torch.int32), ref.view(torch.int32))


def test_single_backward_kernel_nan_step_leaves_later_steps_alone(cuda_device, panda_single_nominal):
    """Every entry of AB at step 4 of 8 NaN: the gains of steps 0-4 go NaN
    (the sweep runs backwards), those of steps 5-7 stay bit for bit those of
    the clean run. K7 keeps its state in shared memory: no local (stack)
    bytes."""
    K, nominal = panda_single_nominal
    args = _single_bwd_args(K, nominal, 8, 1e-3)
    clean = K.backward(*args)
    AB = args[0].clone()
    AB[4] = float("nan")
    dirty = K.backward(AB, *args[1:])
    torch.cuda.synchronize()
    assert bool(torch.isnan(dirty[:5]).all())
    assert torch.equal(dirty[5:].view(torch.int32), clean[5:].view(torch.int32))
    attrs = K.kernel_attributes()["backward"]
    assert attrs["local_bytes"] == 0 and 0 < attrs["num_regs"] <= 255 and attrs["smem_bytes"] > 0


def test_single_solve_runs_on_the_kernels(cuda_device):
    model = catalog.panda(device=cuda_device)
    H = 10
    x0, goals, _ = _mpc_problem(model, 1, H, cuda_device, seed=3)
    mpc = build_tracking_mpc(model, goals[0], H, 0.01, iterations=2)
    x0, us0 = x0[0].contiguous(), torch.zeros((H, 7), device=cuda_device)
    SingleMPCKernels.reset_launch_count()
    us, xs, cost = mpc.solve(x0, us0)
    torch.cuda.synchronize()
    assert SingleMPCKernels.launch_count == {"linearize": 2, "backward": 2, "forward": 3}
    us_p, xs_p, cost_p = mpc.solve_plain(x0, us0)
    assert us.shape == (H, 7) and xs.shape == (H + 1, 14) and cost.shape == ()
    assert float((cost - cost_p).abs() / cost_p.abs()) <= 1e-5
    assert float((xs[-1] - xs_p[-1]).abs().max()) <= 5e-4
    assert float((us - us_p).abs().max()) <= 5e-3
    assert bool((us.abs() <= model.torque_limit).all())


def test_single_mpc_kernels_reject_float64_and_mixed_devices(cuda_device):
    model = catalog.two_link_planar(device=cuda_device)
    mpc = build_tracking_mpc(model, [0.1, 0.2], 3, 0.01)
    K = mpc.kernels
    xs, us = torch.zeros((3, 4), device=cuda_device), torch.zeros((3, 2), device=cuda_device)
    with pytest.raises(TypeError):
        K.linearize(xs.double(), us.double())
    with pytest.raises(ValueError):
        K.linearize(xs, us.cpu())
    with pytest.raises(ValueError):
        K.linearize(xs, us[:, :1])
    with pytest.raises(TypeError):
        mpc.forward(xs[0].double(), xs.double(), us.double(), torch.zeros((3, 2, 5), device=cuda_device).double(),
                    us[0].double(), torch.ones(1, device=cuda_device).double())
    assert K.linearize(xs, us).shape == (3, 4, 6)


# ---------------------------------------------------------------------------
# The planning path's elementwise kernels (K9, K10)
# ---------------------------------------------------------------------------

TRAJ_ATOL = (2e-6, 2e-5, 2e-4)  # pos, vel, acc


def _launches():
    return dict(ew.ElementwiseKernels.launch_count)


@pytest.mark.parametrize("method", [3, 5, 1])
@pytest.mark.parametrize("B,N,J,Tf", [(3, 300, 6, 2.0), (2, 101, 3, 1.0), (257, 129, 7, 0.37)])
def test_trajectory_kernel_matches_plain_version(cuda_device, method, B, N, J, Tf):
    rng = np.random.default_rng(B)
    start, end = (torch.from_numpy(rng.uniform(-1, 1, (B, J)).astype(np.float32)).to(cuda_device) for _ in range(2))
    before = _launches()
    got = ew.trajectory_kernel(start, end, Tf, N, method)
    torch.cuda.synchronize()
    assert _launches() == {**before, "trajectory": before["trajectory"] + 1}
    ref = ew.trajectory_plain(start, end, Tf, N, method)
    for g, r, atol in zip(got, ref, TRAJ_ATOL):
        assert g.shape == (B, N, J) and bool(torch.isfinite(g).all())
        assert float((g - r).abs().max()) <= atol


@pytest.mark.parametrize("P,O,d0", [(400, 5, 0.6), (1031, 0, 0.5), (5000, 32, 0.5), (300, 2500, 0.3)])
def test_potential_kernel_matches_plain_version(cuda_device, P, O, d0):
    """O=2500 takes three tiles of the staged obstacles; one point lies on an
    obstacle."""
    rng = np.random.default_rng(P)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    pts, goal, obstacles = f32(rng.uniform(-1, 1, (P, 3))), f32(rng.uniform(-1, 1, 3)), f32(rng.uniform(-1, 1, (O, 3)))
    if O:
        pts[1] = obstacles[O - 1]
    before = _launches()
    U, grad = ew.cartesian_potential_kernel(pts, goal, obstacles, d0)
    torch.cuda.synchronize()
    assert _launches() == {**before, "potential": before["potential"] + 1}
    U_ref, grad_ref = ew.cartesian_potential_plain(pts, goal, obstacles, d0)
    assert U.shape == (P,) and grad.shape == (P, 3)
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(U, U_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grad, grad_ref, rtol=1e-4, atol=1e-4)


def test_trajectory_kernel_past_32_bit_indices(cuda_device):
    """B * N * J just above 2**32 elements (51.5 GB of outputs): the rows
    whose flat indices need more than 32 bits, and the first ones, against
    the plain version of those rows."""
    B, N, J, rows = 174763, 4096, 6, 64
    assert B * N * J > 2**32 and (B - rows) * N * J < 2**32
    if torch.cuda.mem_get_info(cuda_device)[0] < 56 * 2**30:
        pytest.skip("needs 56 GiB of free device memory")
    gen = torch.Generator(cuda_device).manual_seed(0)
    start, end = (torch.rand((B, J), generator=gen, device=cuda_device) * 2 - 1 for _ in range(2))
    got = ew.trajectory_kernel(start, end, 2.0, N, 5)
    for rows_of in (slice(0, rows), slice(B - rows, B)):
        ref = ew.trajectory_plain(start[rows_of], end[rows_of], 2.0, N, 5)
        for g, r, atol in zip(got, ref, TRAJ_ATOL):
            assert float((g[rows_of] - r).abs().max()) <= atol
    del got
    torch.cuda.empty_cache()


def test_elementwise_kernels_count_no_launch_for_empty_work(cuda_device):
    before = _launches()
    pos, vel, acc = ew.trajectory_kernel(*(torch.zeros((0, 6), device=cuda_device),) * 2, 1.0, 10)
    assert pos.shape == vel.shape == acc.shape == (0, 10, 6)
    assert ew.trajectory_kernel(*(torch.zeros((4, 0), device=cuda_device),) * 2, 1.0, 10)[0].shape == (4, 10, 0)
    U, grad = ew.cartesian_potential_kernel(*(torch.zeros(s, device=cuda_device) for s in ((0, 3), (3,), (5, 3))))
    assert U.shape == (0,) and grad.shape == (0, 3) and U.device.type == "cuda"
    assert _launches() == before


def test_planning_entry_points_use_the_kernels(cuda_device):
    model = catalog.ur5(device=cuda_device)
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    start, goal = f32(rng.uniform(-1, 1, (33, 6))), f32(rng.uniform(-8, 8, (33, 6)))
    before = _launches()
    plan = trajectory.batch_joint_trajectory(model, start, goal, 2.0, 50)
    assert plan.position.shape == (33, 50, 6)
    assert bool((plan.position <= model.joint_upper).all() and (plan.position >= model.joint_lower).all())
    one = trajectory.joint_trajectory(model, start[0], goal, 2.0, 50, clip_to_limits=False)  # broadcast start
    assert one.velocity.shape == (33, 50, 6) and bool((one.position.abs() > 6.3).any())
    points = potential_field.link_positions(model, plan.position)
    U, grad = potential_field.cartesian_potential_field(points, f32(np.array([0.4, 0.1, 0.3])), f32(rng.uniform(-0.5, 0.5, (7, 3))))
    torch.cuda.synchronize()
    assert U.shape == (33, 50, 6) and grad.shape == (33, 50, 6, 3)
    assert _launches() == {"trajectory": before["trajectory"] + 2, "potential": before["potential"] + 1}
    # Degenerate, float64 and autograd calls take the tensor formulation.
    trajectory.joint_trajectory(model, start, goal, 0.0, 50)
    trajectory.joint_trajectory(model, start, goal, 2.0, 1)
    trajectory.joint_trajectory(model.to(dtype=torch.float64), start.double(), goal.double(), 2.0, 50)
    trajectory.joint_trajectory(model, start, goal.clone().requires_grad_(True), 2.0, 50)
    potential_field.cartesian_potential_field(points.clone().requires_grad_(True), torch.zeros(3, device=cuda_device), points[0, 0])
    assert _launches() == {"trajectory": before["trajectory"] + 2, "potential": before["potential"] + 1}


def test_planner_runs_on_the_card(cuda_device):
    model = catalog.ur5(device=cuda_device)
    q0, q1 = np.zeros(6), np.array([0.5, -0.4, 0.4, 0.0, 0.0, 0.0])
    cloud = potential_field.link_positions(model, torch.tensor(0.5 * q1, dtype=torch.float32, device=cuda_device))[3:4]
    planner = create_planner(model, obstacle_points=cloud.cpu().numpy(), sphere_radius=0.05)
    before = _launches()["trajectory"]
    plan = planner.joint_trajectory(q0, q1, 1.0, 20, avoid_collisions=True, avoidance_steps=10)
    assert plan.position.device.type == "cuda" and plan.position.shape == (20, 6)
    assert _launches()["trajectory"] == before + 1
    assert "collision_avoidance" in planner.performance_stats["per_op"]


def test_elementwise_kernels_reject_float64_and_mixed_devices(cuda_device):
    start = torch.zeros((4, 6), device=cuda_device)
    with pytest.raises(TypeError):
        ew.trajectory_kernel(start.double(), start.double(), 1.0, 10)
    with pytest.raises(ValueError):
        ew.trajectory_kernel(start, start.cpu(), 1.0, 10)
    with pytest.raises(ValueError):
        ew.trajectory_kernel(start.T, start.T, 1.0, 10)  # not contiguous
    with pytest.raises(ValueError):
        ew.trajectory_kernel(start.requires_grad_(True), start, 1.0, 10)
    pts = torch.zeros((5, 3), device=cuda_device)
    with pytest.raises(TypeError):
        ew.cartesian_potential_kernel(pts.double(), pts[0].double(), pts.double())
    with pytest.raises(ValueError):
        ew.cartesian_potential_kernel(pts, pts[0].cpu(), pts)
    attrs = ew.kernels().kernel_attributes()
    assert set(attrs) == {"trajectory", "potential"} and all(0 < a["num_regs"] <= 255 for a in attrs.values())


# K8 alone: one team of FWD_WARPS warps per 32 alphas runs each closed-loop
# step, bitwise against the plain version.
@pytest.mark.parametrize("H, A", [(50, 6), (37, 6), (50, 1), (8, 33)])
def test_forward_kernel_is_bitwise_the_plain_version(cuda_device, H, A):
    model = catalog.panda(device=cuda_device)
    n = 7
    x0, goals, _ = _mpc_problem(model, 1, 1, cuda_device, seed=H)
    sd_x, us = _lin_states(model, 1, H, cuda_device, seed=H)
    rng = np.random.default_rng(A)
    kK = torch.from_numpy(rng.uniform(-0.1, 0.1, (H, n, 1 + 2 * n)).astype(np.float32)).to(cuda_device)
    K = build_tracking_mpc(model, goals[0], H, 0.01).kernels
    args = (x0[0].contiguous(), sd_x[..., 0].contiguous(), us[..., 0].contiguous(), kK, goals[0].contiguous(),
            0.5 ** torch.arange(A, device=cuda_device, dtype=torch.float32))
    before = SingleMPCKernels.launch_count["forward"]
    got = K.forward(*args)
    torch.cuda.synchronize()
    assert SingleMPCKernels.launch_count["forward"] == before + 1
    for g, r in zip(got, K.forward_plain(*args)):
        _assert_bits_and_nans(g, r)
    team = K.team_attributes()
    assert team["warps"] == K.FWD_WARPS and team["phases"] == K.team.partition.phases


# The fleet layer on the card (parallel/): the rollout split over a mesh
# runs K1 a chunk, bit for bit the unsharded call; the fleet round on the
# fused solver runs K2-K5 a robot, bit for bit each robot's own solver.
def test_distributed_rollout_runs_k1_and_is_bitwise(cuda_device):
    from manipulapy_tpu_torch import parallel

    model = catalog.ur5(device=cuda_device)
    x = _inputs(6, 1031, 12, cuda_device, seed=4)
    mesh = parallel.make_mesh(devices=[cuda_device] * 2)  # two chunks on one card, B padded to 1032
    before = CudaRollout.launch_count
    got = parallel.distributed_rollout(model, mesh, *x, dt=0.01)
    torch.cuda.synchronize()
    assert CudaRollout.launch_count == before + 2
    ref = trajectory.forward_dynamics_trajectory(model, *x, dt=0.01)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (1031, 12, 6) and torch.equal(g, r)


def test_fleet_round_on_the_fused_solver_is_bitwise_each_robots_own(cuda_device):
    from manipulapy_tpu_torch import parallel
    from manipulapy_tpu_torch.mpc.ilqr import ILQRParams

    ur5, panda = catalog.ur5(device=cuda_device), catalog.panda(device=cuda_device)
    fleet = parallel.stack_models([panda, ur5])
    S, H, n_max = 64, 10, 7
    x0 = torch.zeros((2, S, 2 * n_max), device=cuda_device)
    goals = torch.zeros((2, S, n_max), device=cuda_device)
    for r, m in enumerate((panda, ur5)):
        x0_r, goals_r, _ = _mpc_problem(m, S, H, cuda_device, seed=r)
        n = m.num_joints
        x0[r, :, :n], x0[r, :, n_max:n_max + n], goals[r, :, :n] = x0_r[:, :n], x0_r[:, n:], goals_r
    us0 = torch.zeros((2, S, H, n_max), device=cuda_device)
    params = ILQRParams(horizon=H, dt=0.01, iterations=2, line_search_steps=6)
    mesh = parallel.make_mesh()
    fused = parallel.build_fleet_fused_mpc(fleet, mesh, S, H, 0.01, iterations=2, line_search_steps=6)
    BatchMPCKernels.reset_launch_count()
    us, costs, fleet_cost = parallel.fleet_mpc_round(fleet, mesh, x0, us0, goals, params, solver="fused_batch",
                                                     fused_mpc=fused)
    torch.cuda.synchronize()
    assert BatchMPCKernels.launch_count == {"linearize": 4, "backward": 4, "linesearch_costs": 0,
                                            "linesearch": 4, "replay": 2}
    for r, m in enumerate((panda, ur5)):
        n = m.num_joints
        own = build_batch_tracking_mpc(m, goals[r, :, :n], S, H, 0.01, iterations=2, line_search_steps=6)
        x0_r = torch.cat([x0[r, :, :n], x0[r, :, n_max:n_max + n]], dim=1)
        us_r, _, cost_r = own.solve(x0_r, torch.zeros((S, H, n), device=cuda_device))
        assert torch.equal(us[r, :, :, :n], us_r) and torch.equal(costs[r], cost_r)
    assert not us[1, :, :, 6].any()  # UR5's padded joint
    assert torch.isclose(fleet_cost, costs.mean(), rtol=1e-6)
