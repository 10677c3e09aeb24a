"""The port's elementwise planning kernels (K9, K10) against the JAX
package's.

* The plain versions (``trajectory_plain``, ``cartesian_potential_plain``)
  against the JAX Pallas kernels in interpret mode and against the jnp
  formulations, on the shapes of ``tests/test_pallas.py`` and with its
  tolerances: trajectory 2e-6 / 2e-5 / 2e-4 on pos / vel / acc (float32;
  ``linspace`` and ``t / (N - 1)`` differ in the last bit), potential rtol
  1e-4 with atol 1e-5 on U and 1e-4 on its gradient.
* The kernel bodies of ``csrc/elementwise.cuh``, compiled with the host g++
  behind a ``__device__`` shim and driven by a host loop, against the plain
  versions. K9: bitwise (the same operations in the same order, no
  contraction). K10: rtol 1e-5, atol 1e-6, because PyTorch's float32 ``sqrt``
  on the CPU is not correctly rounded (about 0.7% of inputs are one ulp off
  ``sqrtf``); on a CUDA device it is ``sqrtf`` and the two agree bitwise.
* The wrappers on CPU tensors, their checks, and the source rules.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.core.time_scaling import scaling_profile as jax_scaling_profile
from manipulapy_tpu.ops.pallas_kernels import cartesian_potential_pallas, trajectory_pallas
from manipulapy_tpu.potential_field import cartesian_potential_field as jax_cartesian_potential_field
from manipulapy_tpu_torch.ops import dispatch
from manipulapy_tpu_torch.ops import elementwise as ew

TRAJ_ATOL = (2e-6, 2e-5, 2e-4)  # pos, vel, acc
POT_RTOL, POT_ATOL = 1e-4, (1e-5, 1e-4)  # U, grad


def _endpoints(B, J, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, J)).astype(np.float32), rng.uniform(-1, 1, (B, J)).astype(np.float32))


def _cloud(P, O, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    obstacles = rng.uniform(-1, 1, (O, 3)).astype(np.float32)
    return pts, np.asarray([0.3, -0.2, 0.5], np.float32), obstacles


# -- K9 ------------------------------------------------------------------------


@pytest.mark.parametrize("method", [3, 5, 1])
@pytest.mark.parametrize("B,J,N,Tf", [(3, 6, 300, 2.0), (2, 3, 101, 1.0)])
def test_trajectory_plain_matches_pallas_interpret(method, B, J, N, Tf):
    start, end = _endpoints(B, J)
    ref = trajectory_pallas(jnp.asarray(start), jnp.asarray(end), Tf, N, method, interpret=True)
    got = ew.trajectory_plain(torch.from_numpy(start), torch.from_numpy(end), Tf, N, method)
    for g, r, atol in zip(got, ref, TRAJ_ATOL):
        assert g.shape == (B, N, J) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=atol)


@pytest.mark.parametrize("method", [3, 5, 1])
def test_trajectory_plain_matches_jnp_profile(method):
    B, J, N, Tf = 3, 6, 300, 2.0
    start, end = _endpoints(B, J)
    s, sd, sdd = (np.asarray(x) for x in jax_scaling_profile(Tf, N, method, dtype=jnp.float32))
    delta = (end - start)[:, None, :]
    ref = (start[:, None, :] + s[None, :, None] * delta, sd[None, :, None] * delta, sdd[None, :, None] * delta)
    got = ew.trajectory_plain(torch.from_numpy(start), torch.from_numpy(end), Tf, N, method)
    for g, r, atol in zip(got, ref, TRAJ_ATOL):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol)


def test_trajectory_boundary_conditions():
    start, end = torch.zeros((1, 4)), torch.ones((1, 4))
    pos, vel, acc = ew.trajectory_plain(start, end, 1.5, 128, 5)
    np.testing.assert_allclose(pos[0, 0].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(pos[0, -1].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(vel[0, 0].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(vel[0, -1].numpy(), 0.0, atol=1e-5)


def test_trajectory_wrapper_on_cpu_is_the_plain_version():
    start, end = (torch.from_numpy(x) for x in _endpoints(4, 5, seed=3))
    before = dict(ew.ElementwiseKernels.launch_count)
    got = ew.trajectory_kernel(start, end, 0.7, 33, 3)
    ref = ew.trajectory_plain(start, end, 0.7, 33, 3)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert ew.ElementwiseKernels.launch_count == before  # no launch on the CPU
    f64 = ew.trajectory_kernel(start.double(), end.double(), 0.7, 33, 3)
    assert f64[0].dtype == torch.float64


@pytest.mark.parametrize(
    "kwargs",
    [dict(Tf=0.0), dict(Tf=-1.0), dict(N=1), dict(N=0), dict(start=torch.zeros(6)), dict(end=torch.zeros((2, 5)))],
)
def test_trajectory_wrapper_rejects(kwargs):
    args = dict(start=torch.zeros((2, 6)), end=torch.ones((2, 6)), Tf=1.0, N=10)
    args.update(kwargs)
    for fn in (ew.trajectory_kernel, ew.trajectory_plain):
        with pytest.raises(ValueError):
            fn(args["start"], args["end"], args["Tf"], args["N"], 5)


# -- K10 -----------------------------------------------------------------------


@pytest.mark.parametrize("P,O,d0", [(400, 5, 0.6), (77, 0, 0.5), (130, 32, 0.5)])
def test_potential_plain_matches_pallas_interpret_and_jnp(P, O, d0):
    pts, goal, obstacles = _cloud(P, O)
    got = ew.cartesian_potential_plain(*(torch.from_numpy(x) for x in (pts, goal, obstacles)), d0)
    refs = [jax_cartesian_potential_field(jnp.asarray(pts), jnp.asarray(goal), jnp.asarray(obstacles), d0)]
    if O > 0:  # the Pallas kernel stages its obstacles in SMEM and takes no empty set
        refs.append(cartesian_potential_pallas(jnp.asarray(pts), jnp.asarray(goal), jnp.asarray(obstacles), d0, interpret=True))
    assert got[0].shape == (P,) and got[1].shape == (P, 3)
    for ref in refs:
        for g, r, atol in zip(got, ref, POT_ATOL):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=POT_RTOL, atol=atol)


def test_potential_outside_influence_is_attractive_only():
    U, g = ew.cartesian_potential_plain(
        torch.tensor([[2.0, 0.0, 0.0]]), torch.zeros(3), torch.tensor([[-2.0, 0.0, 0.0]]), 0.5
    )
    assert float(U[0]) == pytest.approx(2.0)
    np.testing.assert_allclose(g[0].numpy(), [2.0, 0.0, 0.0], atol=1e-6)


def test_potential_exact_overlap_is_finite():
    """A point on an obstacle: 1/d = 1e9, the coefficient ~ -1e36 is finite
    in float32 and multiplies a zero offset."""
    pts, goal, obstacles = _cloud(9, 4, seed=5)
    pts[3] = obstacles[2]
    got = ew.cartesian_potential_plain(*(torch.from_numpy(x) for x in (pts, goal, obstacles)), 0.5)
    ref = cartesian_potential_pallas(jnp.asarray(pts), jnp.asarray(goal), jnp.asarray(obstacles), 0.5, interpret=True)
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    assert float(got[0][3]) > 1e17
    for g, r, atol in zip(got, ref, POT_ATOL):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=POT_RTOL, atol=atol)


def test_potential_wrapper_on_cpu_is_the_plain_version():
    pts, goal, obstacles = (torch.from_numpy(x) for x in _cloud(50, 3, seed=6))
    before = dict(ew.ElementwiseKernels.launch_count)
    got = ew.cartesian_potential_kernel(pts, goal, obstacles, 0.4)
    ref = ew.cartesian_potential_plain(pts, goal, obstacles, 0.4)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert ew.ElementwiseKernels.launch_count == before
    with pytest.raises(ValueError):
        ew.cartesian_potential_kernel(pts[:, :2], goal, obstacles, 0.4)
    with pytest.raises(ValueError):
        ew.cartesian_potential_kernel(pts, goal, obstacles[:, :2], 0.4)
    with pytest.raises(ValueError):
        ew.cartesian_potential_kernel(pts, goal[:2], obstacles, 0.4)
    with pytest.raises(ValueError):
        ew.cartesian_potential_kernel(pts, goal, obstacles, 0.0)


def test_wrappers_answer_empty_work():
    """No scenario, no joint or no point: outputs of the right shape."""
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    assert [tuple(x.shape) for x in ew.trajectory_kernel(f32(0, 6), f32(0, 6), 1.0, 10)] == [(0, 10, 6)] * 3
    assert [tuple(x.shape) for x in ew.trajectory_kernel(f32(4, 0), f32(4, 0), 1.0, 10)] == [(4, 10, 0)] * 3
    U, grad = ew.cartesian_potential_kernel(f32(0, 3), f32(3), f32(5, 3))
    assert tuple(U.shape) == (0,) and tuple(grad.shape) == (0, 3)


# -- routing -------------------------------------------------------------------


def test_elementwise_kind():
    f32, f64 = torch.float32, torch.float64
    assert dispatch.elementwise_kind(torch.device("cuda"), f32, False) == "cuda"
    assert dispatch.elementwise_kind("cuda:1", f32, False) == "cuda"
    assert dispatch.elementwise_kind(torch.device("cuda"), f32, True) == "torch"
    assert dispatch.elementwise_kind(torch.device("cuda"), f64, False) == "torch"
    assert dispatch.elementwise_kind(torch.device("cpu"), f32, False) == "torch"


# -- the kernel bodies, compiled for the host ------------------------------------

_HARNESS = """\
#define __device__
#define __forceinline__ inline
#include "{cuh}"
template <int METHOD>
static void traj_all(const float* start, const float* end, float* pos, float* vel, float* acc,
                     unsigned long long total, unsigned long long N, unsigned long long J, float Tf) {{
  const float n1 = (float)(N - 1);
  const float inv_tf = 1.0f / Tf;
  for (unsigned long long i = 0; i < total; ++i) {{
    traj_at<METHOD>(start, end, pos, vel, acc, i, N, J, n1, inv_tf);
  }}
}}
extern "C" void host_trajectory(const float* start, const float* end, float* pos, float* vel, float* acc,
                                long long B, long long N, long long J, float Tf, int method) {{
  const unsigned long long total = (unsigned long long)(B * N * J);
  if (method == 3) traj_all<3>(start, end, pos, vel, acc, total, N, J, Tf);
  else if (method == 5) traj_all<5>(start, end, pos, vel, acc, total, N, J, Tf);
  else traj_all<1>(start, end, pos, vel, acc, total, N, J, Tf);
}}
// The kernel's tiling over the obstacles, with a tile of `tile`.
extern "C" void host_potential(const float* points, const float* goal, const float* obstacles, float* U,
                               float* grad, int P, int O, float d0, float inv_d0, int tile) {{
  for (int p = 0; p < P; ++p) {{
    const float px = points[3 * p], py = points[3 * p + 1], pz = points[3 * p + 2];
    float u, gx, gy, gz;
    potential_init(px, py, pz, goal, &u, &gx, &gy, &gz);
    for (int o0 = 0; o0 < O; o0 += tile) {{
      const int count = O - o0 < tile ? O - o0 : tile;
      potential_accumulate(px, py, pz, obstacles + 3 * o0, count, d0, inv_d0, &u, &gx, &gy, &gz);
    }}
    U[p] = u; grad[3 * p] = gx; grad[3 * p + 1] = gy; grad[3 * p + 2] = gz;
  }}
}}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the kernel bodies")
    tmp = tmp_path_factory.mktemp("elementwise")
    cpp, so = tmp / "elementwise.cpp", tmp / "elementwise.so"
    cpp.write_text(_HARNESS.format(cuh=ew.TEMPLATE))
    subprocess.run(
        ["g++", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)], check=True, timeout=300
    )
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_trajectory.argtypes = [P] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int]
    lib.host_potential.argtypes = [P] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int]
    lib.host_trajectory.restype = lib.host_potential.restype = None
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("method", [3, 5, 1])
@pytest.mark.parametrize("B,J,N,Tf", [(3, 6, 300, 2.0), (5, 7, 101, 0.37)])
def test_trajectory_body_matches_plain_version(host_lib, method, B, J, N, Tf):
    start, end = _endpoints(B, J, seed=7)
    outs = [np.full((B, N, J), np.nan, np.float32) for _ in range(3)]
    host_lib.host_trajectory(_ptr(start), _ptr(end), *(_ptr(o) for o in outs), B, N, J, Tf, method)
    ref = ew.trajectory_plain(torch.from_numpy(start), torch.from_numpy(end), Tf, N, method)
    for o, r in zip(outs, ref):
        np.testing.assert_array_equal(o, r.numpy())


@pytest.mark.parametrize("P,O,d0,tile", [(400, 5, 0.6, 1024), (77, 0, 0.5, 1024), (130, 32, 0.5, 7)])
def test_potential_body_matches_plain_version(host_lib, P, O, d0, tile):
    pts, goal, obstacles = _cloud(P, O, seed=8)
    if O:
        pts[1] = obstacles[O - 1]  # exact overlap
    U, grad = np.full((P,), np.nan, np.float32), np.full((P, 3), np.nan, np.float32)
    host_lib.host_potential(_ptr(pts), _ptr(goal), _ptr(obstacles), _ptr(U), _ptr(grad), P, O, d0, 1.0 / d0, tile)
    ref = ew.cartesian_potential_plain(*(torch.from_numpy(x) for x in (pts, goal, obstacles)), d0)
    np.testing.assert_allclose(U, ref[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, ref[1].numpy(), rtol=1e-5, atol=1e-6)


def test_source_rules():
    """No fast-math intrinsics, no min/max with C's NaN rule, and no double
    literals (every literal carries the f suffix) in the kernels' source."""
    src = ew.TEMPLATE.read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for banned in ("rsqrtf", "__fdividef", "__sinf", "__cosf", "__expf", "fminf", "fmaxf", "use_fast_math"):
        assert banned not in code, banned
    assert "sqrtf(" in code
    doubles = [m for m in re.findall(r"(?<![\w.])\d+\.\d*(?:[eE][-+]?\d+)?(?![\w.])|(?<![\w.])\d+[eE][-+]?\d+(?![\w.])", code)]
    assert doubles == [], doubles
    assert code.count("__global__") == 2
