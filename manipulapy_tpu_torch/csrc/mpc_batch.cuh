// Batched fused tracking-MPC kernels (K2-K5) for Hopper (sm_90a).
//
// Replace the four Pallas kernels of manipulapy_tpu/mpc/fused_batch.py:
//   K2 linearize         lin_kernel     (pallas_call in `linearize`)
//   K3 backward          bwd_kernel     (pallas_call in `backward`)
//   K4 linesearch_costs  cost_kernel    (pallas_call in `linesearch_costs`)
//   K5 replay            replay_kernel  (pallas_call in `replay`)
//
// This file is a template. ops/cuda_mpc_batch.py writes one translation
// unit per (robot, dt, g, cost weights, torque limits) and per unit, which
// holds, in order:
//   #define MPT_NJ <n>, MPT_BLOCK <threads>, and one of MPT_UNIT_LIN,
//     MPT_UNIT_BWD, MPT_UNIT_FWD;
//   the unit's generated device functions, emitted from the same Python
//   code over cgen values as the plain PyTorch versions:
//     LIN: fd_step_jvp (ops/fd_step.py::build_fd_step_jvp_source);
//     BWD: riccati_terminal, riccati_step;
//     FWD: mpc_fwd_step, mpc_terminal (one body, two entry points);
//   this file.
// The three units build in parallel, one nvcc each.
//
// Layout. Every tensor is scenario-minor, (..., B), so the threads of a
// warp, which own neighbouring scenarios, touch neighbouring addresses:
//   xs (H, nx, B), us (H, n, B), AB (H, nx, m, B), kK (H, n, 1+nx, B),
//   x0 / x_last (nx, B), goal (n, B), reg / alpha / cost (B), costs (A, B).
// There is no padding: every kernel guards `b < B`. The TPU's (8, 128)
// tiles and its sequential grid axes are gone: a loop inside one thread
// takes the place of a sequential axis, and of the VMEM scratch it carried.
//
// Bound and design, per kernel (statement counts are the emitter's, Panda):
//   K2: one thread per (scenario b, seed k, step t), B*m*H independent
//       threads; each runs the step and its tangent for seed k (~13k
//       statements) and writes column k of AB at t. Operations bound it
//       (~13k statements against 4*(3n + 2n) bytes per thread); the primal
//       is recomputed by each of the m seeds, the price of keeping one
//       seed's tangent per thread instead of m.
//   K3: one thread per scenario, t = H-1 ... 0 inside the thread, the
//       value function (nx+1)*nx in a thread-local array (local memory).
//       Its least time is set by operations (~26k statements per step),
//       but at B=1024 only B/128 blocks run, so one thread's 50 dependent
//       steps set its time (PERF.md); spreading a scenario over a warp is
//       a later change.
//   K4: one thread per (scenario, alpha), the closed-loop rollout with the
//       step inlined; K5 one thread per scenario with its own alpha,
//       streaming out xs, us and the cost. Operations set K4's least time
//       and bytes K5's (~5k statements per step); at B=1024 both are
//       latency-bound like K3.
// Every kernel is built with --fmad=false and the emitter's order of
// operations, so each agrees bitwise with its plain PyTorch version.
//
// The per-thread bodies (`*_thread`) are plain functions of the scenario
// index: a host harness compiles this file with `__device__` defined away
// and runs them in a loop (tests/test_torch_mpc_batch.py).

#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifndef MPT_NJ
#error "MPT_NJ must be defined before mpc_batch.cuh"
#endif
#ifndef MPT_BLOCK
#define MPT_BLOCK 128
#endif

#define MPT_NX (2 * MPT_NJ)         // state [q; dq]
#define MPT_M (3 * MPT_NJ)          // tangent seeds [x; u]
#define MPT_KK (1 + MPT_NX)         // gains per joint: k, then a row of K
#define MPT_VN ((MPT_NX + 1) * MPT_NX)  // value function: Vxx rows, then Vx

// Element (row, b) of a scenario-minor tensor with B scenarios.
#define MPT_AT(ptr, row, b, B) ((ptr)[(size_t)(row) * (size_t)(B) + (size_t)(b)])

#ifdef __CUDACC__
#define MPT_ATTRIBUTES(NAME, KERNEL)                                          \
  extern "C" int NAME(int* num_regs, int* local_bytes, int* max_threads) {  \
    cudaFuncAttributes a;                                                   \
    const cudaError_t err = cudaFuncGetAttributes(&a, KERNEL);              \
    if (err != cudaSuccess) return (int)err;                                \
    *num_regs = a.numRegs;                                                  \
    *local_bytes = (int)a.localSizeBytes;                                   \
    *max_threads = a.maxThreadsPerBlock;                                    \
    return 0;                                                               \
  }
#endif

// ---------------------------------------------------------------- K2 -----
#if defined(MPT_UNIT_LIN)
static __device__ __forceinline__ void lin_thread(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int B, int b, int k, int t) {
  float x[MPT_NX], u[MPT_NJ], x_next[MPT_NX], col[MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(xs, t * MPT_NX + i, b, B);
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) u[j] = MPT_AT(us, t * MPT_NJ + j, b, B);
  fd_step_jvp(x, u, k, x_next, col);
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i)
    MPT_AT(AB, ((size_t)t * MPT_NX + i) * MPT_M + k, b, B) = col[i];
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BLOCK) mpt_lin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lin_thread(xs, us, AB, B, b, (int)blockIdx.y, (int)blockIdx.z);
}

// xs (H, nx, B), us (H, n, B) -> AB (H, nx, m, B). Grid (B blocks, m, H).
extern "C" int launch_linearize(const float* xs, const float* us, float* AB,
                                int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const dim3 grid((unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK), MPT_M,
                  (unsigned int)H);
  mpt_lin_kernel<<<grid, MPT_BLOCK, 0, (cudaStream_t)stream>>>(xs, us, AB, B);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linearize, mpt_lin_kernel)
#endif
#endif  // MPT_UNIT_LIN

// ---------------------------------------------------------------- K3 -----
#if defined(MPT_UNIT_BWD)
static __device__ __forceinline__ void bwd_thread(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ x_last,
    const float* __restrict__ goal, const float* __restrict__ reg,
    float* __restrict__ kK, int B, int H, int b) {
  float g[MPT_NJ], xl[MPT_NX], V[MPT_VN], V_next[MPT_VN];
  float ab[MPT_NX * MPT_M], x[MPT_NX], u[MPT_NJ], kk[MPT_NJ * MPT_KK];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) g[j] = MPT_AT(goal, j, b, B);
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) xl[i] = MPT_AT(x_last, i, b, B);
  const float r = reg[b];
  riccati_terminal(xl, g, V);
  for (int t = H - 1; t >= 0; --t) {
    const size_t ab_row = (size_t)t * (MPT_NX * MPT_M);
#pragma unroll
    for (int e = 0; e < MPT_NX * MPT_M; ++e) ab[e] = MPT_AT(AB, ab_row + e, b, B);
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(xs, t * MPT_NX + i, b, B);
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) u[j] = MPT_AT(us, t * MPT_NJ + j, b, B);
    riccati_step(ab, x, u, g, V, r, kk, V_next);
    const size_t kk_row = (size_t)t * (MPT_NJ * MPT_KK);
#pragma unroll
    for (int e = 0; e < MPT_NJ * MPT_KK; ++e) MPT_AT(kK, kk_row + e, b, B) = kk[e];
#pragma unroll
    for (int e = 0; e < MPT_VN; ++e) V[e] = V_next[e];
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BLOCK) mpt_bwd_kernel(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ x_last,
    const float* __restrict__ goal, const float* __restrict__ reg,
    float* __restrict__ kK, int B, int H) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  bwd_thread(AB, xs, us, x_last, goal, reg, kK, B, H, b);
}

// AB (H, nx, m, B), xs (H, nx, B), us (H, n, B), x_last (nx, B),
// goal (n, B), reg (B) -> kK (H, n, 1+nx, B).
extern "C" int launch_backward(const float* AB, const float* xs,
                               const float* us, const float* x_last,
                               const float* goal, const float* reg, float* kK,
                               int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const unsigned int blocks = (unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK);
  mpt_bwd_kernel<<<blocks, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      AB, xs, us, x_last, goal, reg, kK, B, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_backward, mpt_bwd_kernel)
#endif
#endif  // MPT_UNIT_BWD

// ----------------------------------------------------------- K4 and K5 ---
#if defined(MPT_UNIT_FWD)
// The closed-loop rollout of one scenario under one alpha. Writes the
// trajectory when xs_out is not null (K5) and returns the total cost.
static __device__ __forceinline__ float fwd_rollout(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, float alpha, float* __restrict__ xs_out,
    float* __restrict__ us_out, int B, int H, int b) {
  float x[MPT_NX], g[MPT_NJ], sdx[MPT_NX], sdu[MPT_NJ], kk[MPT_NJ * MPT_KK];
  float u[MPT_NJ], c[1], x_next[MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(x0, i, b, B);
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) g[j] = MPT_AT(goal, j, b, B);
  float acc = 0.0f;
  for (int t = 0; t < H; ++t) {
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) sdx[i] = MPT_AT(sd_x, t * MPT_NX + i, b, B);
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) sdu[j] = MPT_AT(sd_u, t * MPT_NJ + j, b, B);
    const size_t kk_row = (size_t)t * (MPT_NJ * MPT_KK);
#pragma unroll
    for (int e = 0; e < MPT_NJ * MPT_KK; ++e) kk[e] = MPT_AT(kK, kk_row + e, b, B);
    mpc_fwd_step(x, sdx, sdu, kk, g, alpha, u, c, x_next);
    acc = acc + c[0];
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) x[i] = x_next[i];
    if (xs_out != NULL) {
#pragma unroll
      for (int i = 0; i < MPT_NX; ++i) MPT_AT(xs_out, t * MPT_NX + i, b, B) = x[i];
#pragma unroll
      for (int j = 0; j < MPT_NJ; ++j) MPT_AT(us_out, t * MPT_NJ + j, b, B) = u[j];
    }
  }
  mpc_terminal(x, g, c);
  return acc + c[0];
}

static __device__ __forceinline__ void cost_thread(
    const float* x0, const float* sd_x, const float* sd_u, const float* kK,
    const float* goal, const float* alphas, float* costs, int B, int H, int b,
    int a) {
  MPT_AT(costs, a, b, B) =
      fwd_rollout(x0, sd_x, sd_u, kK, goal, alphas[a], NULL, NULL, B, H, b);
}

static __device__ __forceinline__ void replay_thread(
    const float* x0, const float* sd_x, const float* sd_u, const float* kK,
    const float* goal, const float* alpha, float* xs, float* us, float* cost,
    int B, int H, int b) {
  cost[b] = fwd_rollout(x0, sd_x, sd_u, kK, goal, alpha[b], xs, us, B, H, b);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BLOCK) mpt_cost_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ costs, int B, int H) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  cost_thread(x0, sd_x, sd_u, kK, goal, alphas, costs, B, H, b, (int)blockIdx.y);
}

__global__ void __launch_bounds__(MPT_BLOCK) mpt_replay_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alpha,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ cost,
    int B, int H) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  replay_thread(x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H, b);
}

// x0 (nx, B), sd_x (H, nx, B), sd_u (H, n, B), kK (H, n, 1+nx, B),
// goal (n, B), alphas (A) -> costs (A, B). Grid (B blocks, A).
extern "C" int launch_linesearch_costs(const float* x0, const float* sd_x,
                                       const float* sd_u, const float* kK,
                                       const float* goal, const float* alphas,
                                       float* costs, int B, int H, int A,
                                       void* stream) {
  if (B <= 0 || A <= 0) return 0;
  const dim3 grid((unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK), (unsigned int)A);
  mpt_cost_kernel<<<grid, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alphas, costs, B, H);
  return (int)cudaGetLastError();
}

// The same inputs with one alpha per scenario, alpha (B) -> xs (H, nx, B),
// us (H, n, B), cost (B).
extern "C" int launch_replay(const float* x0, const float* sd_x,
                             const float* sd_u, const float* kK,
                             const float* goal, const float* alpha, float* xs,
                             float* us, float* cost, int B, int H,
                             void* stream) {
  if (B <= 0) return 0;
  const unsigned int blocks = (unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK);
  mpt_replay_kernel<<<blocks, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linesearch_costs, mpt_cost_kernel)
MPT_ATTRIBUTES(attributes_replay, mpt_replay_kernel)
#endif
#endif  // MPT_UNIT_FWD
