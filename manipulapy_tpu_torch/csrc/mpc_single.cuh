// Single-problem fused tracking-MPC kernels (K6-K8) for Hopper (sm_90a).
//
// Replace the three Pallas kernels of manipulapy_tpu/mpc/fused.py:
//   K6 linearize  lin_kernel  (pallas_call in `linearize`)
//   K7 backward   bwd_kernel  (pallas_call in `backward`)
//   K8 forward    fwd_kernel  (pallas_call in `forward_packed`)
//
// This file is a template. ops/cuda_mpc_single.py writes one translation
// unit per (robot, dt, g, cost weights, torque limits) and per unit, which
// holds, in order:
//   #define MPT_NJ <n> and one of MPT_UNIT_LIN, MPT_UNIT_BWD, MPT_UNIT_FWD;
//   the unit's generated device functions, emitted from the same Python
//   code over cgen values as the plain PyTorch versions:
//     LIN: fd_step_jvp (ops/fd_step.py::build_fd_step_jvp_source);
//     BWD: riccati_step_gj (the Gauss-Jordan Riccati step of fused.py);
//     FWD: mpc_fwd_step (K4's closed-loop step), mpc_terminal_fused;
//   this file.
// The three units build in parallel, one nvcc each.
//
// Layout: time-major, one problem, no padding:
//   xs (H, nx), us (H, n), AB (H, nx, m), kK (H, n, 1+nx) (row j: k_j, then
//   row j of K), goal (n), Vterm (nx+1, nx) (Vxx rows, then Vx), reg (one
//   float), x0 (nx), alphas (A); K8 writes xs (A, H, nx), us (A, H, n) and
//   costs (A). The TPU's 128-lane staging (timesteps or alphas on the lanes,
//   packed AB / kK / V tiles) is gone, and so is its sequential grid axis:
//   a loop inside one thread takes its place and that of the VMEM scratch.
//
// Bound and design, per kernel (one problem, so none of them fills the card;
// the path is bound by launch latency and by dependent chains):
//   K6: one thread per (seed k, step t), H*m threads (1050 for Panda at
//       H=50), one warp per block so that they spread over H*m/32 SMs; each
//       runs the step and its tangent for seed k and writes column k of AB
//       at t. The same function as K2 at B=1, with its own entry point.
//   K7: one thread runs the whole time-reversed sweep, the value function
//       (nx+1)*nx in thread-local arrays, Quu solved by the pivot-free
//       Gauss-Jordan of fused.py. H dependent steps of ~28k operations
//       (Panda): latency-bound by construction, the solve's largest stage.
//       A block-cooperative version is a later change.
//   K8: one thread per alpha, the closed-loop rollout with the step inlined,
//       streaming out xs and us and writing the cost.
// Every kernel is built with --fmad=false and the emitter's order of
// operations, so each agrees bitwise with its plain PyTorch version.
//
// The per-thread bodies (`*_thread`) are plain functions: a host harness
// compiles this file with `__device__` defined away and runs them in a loop
// (tests/test_torch_mpc_single.py).

#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifndef MPT_NJ
#error "MPT_NJ must be defined before mpc_single.cuh"
#endif

#define MPT_NX (2 * MPT_NJ)             // state [q; dq]
#define MPT_M (3 * MPT_NJ)              // tangent seeds [x; u]
#define MPT_KK (1 + MPT_NX)             // gains per joint: k, then a row of K
#define MPT_VN ((MPT_NX + 1) * MPT_NX)  // value function: Vxx rows, then Vx
#define MPT_WARP 32

#ifdef __CUDACC__
#define MPT_ATTRIBUTES(NAME, KERNEL)                                          \
  extern "C" int NAME(int* num_regs, int* local_bytes, int* max_threads,   \
                      int* smem_bytes) {                                    \
    cudaFuncAttributes a;                                                   \
    const cudaError_t err = cudaFuncGetAttributes(&a, KERNEL);              \
    if (err != cudaSuccess) return (int)err;                                \
    *num_regs = a.numRegs;                                                  \
    *local_bytes = (int)a.localSizeBytes;                                   \
    *max_threads = a.maxThreadsPerBlock;                                    \
    *smem_bytes = (int)a.sharedSizeBytes;                                   \
    return 0;                                                               \
  }
#endif

// ---------------------------------------------------------------- K6 -----
#if defined(MPT_UNIT_LIN)
// Thread `idx` = t * m + k: neighbouring threads write neighbouring columns.
static __device__ __forceinline__ void lin_thread(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int idx) {
  const int t = idx / MPT_M, k = idx % MPT_M;
  float x[MPT_NX], u[MPT_NJ], x_next[MPT_NX], col[MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = xs[t * MPT_NX + i];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) u[j] = us[t * MPT_NJ + j];
  fd_step_jvp(x, u, k, x_next, col);
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) AB[((size_t)t * MPT_NX + i) * MPT_M + k] = col[i];
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_WARP) mps_lin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * MPT_M) return;
  lin_thread(xs, us, AB, idx);
}

// xs (H, nx), us (H, n) -> AB (H, nx, m). H*m threads, one warp per block.
extern "C" int launch_linearize(const float* xs, const float* us, float* AB,
                                int H, void* stream) {
  if (H <= 0) return 0;
  const unsigned int blocks = (unsigned int)((H * MPT_M + MPT_WARP - 1) / MPT_WARP);
  mps_lin_kernel<<<blocks, MPT_WARP, 0, (cudaStream_t)stream>>>(xs, us, AB, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linearize, mps_lin_kernel)
#endif
#endif  // MPT_UNIT_LIN

// ---------------------------------------------------------------- K7 -----
#if defined(MPT_UNIT_BWD)
static __device__ __forceinline__ void bwd_thread(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ goal,
    const float* __restrict__ Vterm, const float* __restrict__ reg,
    float* __restrict__ kK, int H) {
  float g[MPT_NJ], V[MPT_VN], V_next[MPT_VN];
  float ab[MPT_NX * MPT_M], x[MPT_NX], u[MPT_NJ], kk[MPT_NJ * MPT_KK];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) g[j] = goal[j];
#pragma unroll
  for (int e = 0; e < MPT_VN; ++e) V[e] = Vterm[e];
  const float r = reg[0];
  for (int t = H - 1; t >= 0; --t) {
    const size_t ab_row = (size_t)t * (MPT_NX * MPT_M);
#pragma unroll
    for (int e = 0; e < MPT_NX * MPT_M; ++e) ab[e] = AB[ab_row + e];
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) x[i] = xs[t * MPT_NX + i];
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) u[j] = us[t * MPT_NJ + j];
    riccati_step_gj(ab, x, u, g, V, r, kk, V_next);
    const size_t kk_row = (size_t)t * (MPT_NJ * MPT_KK);
#pragma unroll
    for (int e = 0; e < MPT_NJ * MPT_KK; ++e) kK[kk_row + e] = kk[e];
#pragma unroll
    for (int e = 0; e < MPT_VN; ++e) V[e] = V_next[e];
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(1) mps_bwd_kernel(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ goal,
    const float* __restrict__ Vterm, const float* __restrict__ reg,
    float* __restrict__ kK, int H) {
  bwd_thread(AB, xs, us, goal, Vterm, reg, kK, H);
}

// AB (H, nx, m), xs (H, nx), us (H, n), goal (n), Vterm (nx+1, nx),
// reg (1) -> kK (H, n, 1+nx). One thread.
extern "C" int launch_backward(const float* AB, const float* xs,
                               const float* us, const float* goal,
                               const float* Vterm, const float* reg, float* kK,
                               int H, void* stream) {
  if (H <= 0) return 0;
  mps_bwd_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(AB, xs, us, goal, Vterm, reg, kK, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_backward, mps_bwd_kernel)
#endif
#endif  // MPT_UNIT_BWD

// ---------------------------------------------------------------- K8 -----
#if defined(MPT_UNIT_FWD)
// The closed-loop rollout under alpha a: post-step states and controls to
// xs_out / us_out at row a, the total cost to costs[a].
static __device__ __forceinline__ void fwd_thread(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ xs_out, float* __restrict__ us_out,
    float* __restrict__ costs, int H, int a) {
  float x[MPT_NX], g[MPT_NJ], sdx[MPT_NX], sdu[MPT_NJ], kk[MPT_NJ * MPT_KK];
  float u[MPT_NJ], c[1], x_next[MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = x0[i];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) g[j] = goal[j];
  const float alpha = alphas[a];
  float acc = 0.0f;
  for (int t = 0; t < H; ++t) {
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) sdx[i] = sd_x[t * MPT_NX + i];
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) sdu[j] = sd_u[t * MPT_NJ + j];
    const size_t kk_row = (size_t)t * (MPT_NJ * MPT_KK);
#pragma unroll
    for (int e = 0; e < MPT_NJ * MPT_KK; ++e) kk[e] = kK[kk_row + e];
    mpc_fwd_step(x, sdx, sdu, kk, g, alpha, u, c, x_next);
    acc = acc + c[0];
    const size_t row = (size_t)a * H + t;
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) {
      x[i] = x_next[i];
      xs_out[row * MPT_NX + i] = x[i];
    }
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) us_out[row * MPT_NJ + j] = u[j];
  }
  mpc_terminal_fused(x, g, c);
  costs[a] = acc + c[0];
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_WARP) mps_fwd_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ costs,
    int H, int A) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  fwd_thread(x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, a);
}

// x0 (nx), sd_x (H, nx), sd_u (H, n), kK (H, n, 1+nx), goal (n),
// alphas (A) -> xs (A, H, nx), us (A, H, n), costs (A). One thread per alpha.
extern "C" int launch_forward(const float* x0, const float* sd_x,
                              const float* sd_u, const float* kK,
                              const float* goal, const float* alphas, float* xs,
                              float* us, float* costs, int H, int A,
                              void* stream) {
  if (H <= 0 || A <= 0) return 0;
  const unsigned int blocks = (unsigned int)((A + MPT_WARP - 1) / MPT_WARP);
  mps_fwd_kernel<<<blocks, MPT_WARP, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, A);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_forward, mps_fwd_kernel)
#endif
#endif  // MPT_UNIT_FWD
