// K8's looped form: the single-problem line-search forward on K0's loop
// over links, one warp an alpha, its lanes over the joints, for Hopper
// (sm_90a).
//
// Replaces, beside the team K8 of csrc/mpc_single.cuh (the emitted
// closed-loop step split over a team of 32 warps), the Pallas kernel
// manipulapy_tpu/mpc/fused.py:375 (`fwd_kernel`, in `forward_packed`): the
// closed-loop rollout of every line-search alpha of one problem, streaming
// out xs and us, with the running and the terminal cost.
//
// This file is a template. ops/cuda_mpc_single.py::single_fwd_loop_unit_source
// writes one translation unit per joint count that holds, in order:
//   #define MPT_NJ <n>, MPT_FWDL_WARPS <warps a block>
//   the table's layout, MPT_TAB_* and MPT_COST_* (ops/fd_step.py::table_defines)
//   csrc/fd_step_loop.cuh (the link's transform, the RNEA's pieces, the clamp)
//   ops/cgen.py::TEAM_SOURCE (the barrier and cp.async helpers)
//   this file.
// Every robot of n joints runs the same unit: the robot, its torque bounds
// and the cost weights are the table (ops/fd_step.py::fwd_table), carried by
// the launch's __grid_constant__ parameter as for the looped K4 and K5.
//
// Why. The team K8 runs the emitted step, ~12k instructions a step split
// into 32 straight-line programs, so every SM fetches the whole program once
// a step and the fetch bounds it (PERF.md). One thread an alpha running the
// looped step alone is bound by its dependent chains instead (the looped K5
// at B = 1024 takes longer than the team K8). Here the lanes of one warp
// share each step of one alpha, and the code is the loop over links, once.
//
// Layout. Warp w of block b rolls alpha a = b * MPT_FWDL_WARPS + w (warps
// past A repeat the last alpha and store nothing); lane j owns joint j:
//   * the Jacobian column JB_j, column j of M's upper triangle (M[i][j],
//     i <= j) and bias_j, all in registers;
//   * row j of the Cholesky factor, y_j and x_j of the two solves;
//   * q_j, dq_j and u_j, and row j of the step's gains.
// Lanes from n up idle through the lanes' own work. What every lane needs of
// link k (the transform of q_k, V, Vd and the wrench F) every lane computes
// with the same operations, so their bits agree. Values cross lanes through
// the warp's own region of shared memory with __syncwarp() between the
// phases: the state (q, dq), u, the JB columns (two buffers, by the link's
// parity, so one barrier a link suffices), the factor's rows and
// reciprocals, and the solves' entries. Step t's rows (sd_x, sd_u, the gains)
// are one copy a block, staged by cp.async one step ahead; the block meets
// once a step.
//
// Parity. Each output entry's whole sum stays in one lane, in
// fd_step_loop's order: M[i][j] over k = 0..n-1 set at k == j; the factor
// column by column (mpt_chol_factor); the forward solve's sum for y_i in
// order kk = 0..i-1, each term subtracted once y_kk is published; the
// backward solve's in order kk = i+1..n-1; the controller's sum in the
// emitter's order; the running cost in every lane in mpt_fwd_loop_step's
// order (lane 0's is stored). The terminal cost is K8's fused one: every q
// term, then every dq term (cuda_mpc_single.py::terminal_cost_fused). The
// unit builds with --fmad=false, so this is the serial looped closed-loop
// step bit for bit; its plain version is cuda_mpc_single.py::
// loop_forward_plain (ops/fd_step.py::fd_fwd_loop_planes, one column an
// alpha, then the fused terminal).
//
// The host harness (tests/test_torch_single_fwd_loop.py) compiles this file
// with `__device__` defined away and MPT_HOST_TEAM defined: every thread of
// a block is a coroutine that yields at each barrier, so each phase runs
// lane by lane, warp by warp, before the next begins.

#ifndef MPT_NJ
#error "MPT_NJ must be defined before fwd_loop_lanes.cuh"
#endif
#ifndef MPT_FWDL_WARPS
#error "MPT_FWDL_WARPS (warps a block) must be defined before fwd_loop_lanes.cuh"
#endif
#ifndef MPT_TEAM_SOURCE
#error "ops/cgen.py::TEAM_SOURCE must come before fwd_loop_lanes.cuh"
#endif
#if MPT_NJ > 32 || MPT_FWDL_WARPS < 1 || MPT_FWDL_WARPS > 32
#error "a lane a joint (n <= 32) and 1 to 32 warps a block"
#endif

#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define MPT_NX (2 * MPT_NJ)  // state [q; dq]
#define MPT_KK (1 + MPT_NX)  // gains per joint: k, then a row of K
#define MPT_WARP 32
#define MPT_FWDL_THREADS (MPT_WARP * MPT_FWDL_WARPS)
#define MPT_ROWN (MPT_NX + MPT_NJ + MPT_NJ * MPT_KK)  // a step's rows: sd_x, sd_u, the gains

// Storage, in floats. The block's: ROWS 2 x ROWN (step t's rows in buffer
// t & 1), GOAL n. Each warp's (W_* offsets within its region):
//   X    nx          the state of the step that runs
//   U    n           its controls
//   JB   2 x 6 x n   the Jacobian columns of link k in buffer k & 1, element-major
//   L    n x n       the factor's rows
//   INV  n           1 / L_jj
//   Y    n           the forward solve
//   XS   n           the backward solve (ddq)
#define MPT_L_ROWS 0
#define MPT_L_GOAL (2 * MPT_ROWN)
#define MPT_L_WARPS (MPT_L_GOAL + MPT_NJ)
#define MPT_W_X 0
#define MPT_W_U (MPT_W_X + MPT_NX)
#define MPT_W_JB (MPT_W_U + MPT_NJ)
#define MPT_W_L (MPT_W_JB + 12 * MPT_NJ)
#define MPT_W_INV (MPT_W_L + MPT_NJ * MPT_NJ)
#define MPT_W_Y (MPT_W_INV + MPT_NJ)
#define MPT_W_XS (MPT_W_Y + MPT_NJ)
#define MPT_W_FLOATS (MPT_W_XS + MPT_NJ)
#define MPT_L_FLOATS (MPT_L_WARPS + MPT_FWDL_WARPS * MPT_W_FLOATS)
#define MPT_L_BYTES ((size_t)MPT_L_FLOATS * sizeof(float))
#if MPT_L_FLOATS * 4 > 48 * 1024
#error "a block's storage exceeds the 48 KB of static shared memory"
#endif

// The lanes of one warp meet (__syncwarp); on the host, a coroutine's yield.
static __device__ __forceinline__ void mpt_lanes_sync() {
#if defined(__CUDA_ARCH__)
  __syncwarp();
#elif defined(MPT_HOST_TEAM)
  mpt_host_yield();
#endif
}

// Step t's rows into ROWS buffer t & 1, one group of copies by the block.
static __device__ __forceinline__ void fwdl_rows(
    int tid, float* sm, const float* __restrict__ sd_x, const float* __restrict__ sd_u,
    const float* __restrict__ kK, int t) {
  float* dst = sm + MPT_L_ROWS + (t & 1) * MPT_ROWN;
  for (int k = tid; k < MPT_ROWN; k += MPT_FWDL_THREADS) {
    const float* src;
    if (k < MPT_NX) src = sd_x + (size_t)t * MPT_NX + k;
    else if (k < MPT_NX + MPT_NJ) src = sd_u + (size_t)t * MPT_NJ + (k - MPT_NX);
    else src = kK + (size_t)t * MPT_NJ * MPT_KK + (k - MPT_NX - MPT_NJ);
    mpt_team_copy(dst + k, src, true);
  }
  mpt_team_commit();
}

// The running cost at the state X under the controls U, every term in
// mpt_fwd_loop_step's order (csrc/mpc_batch.cuh).
static __device__ __forceinline__ float fwdl_running_cost(const float* X, const float* U, const float* goal,
                                                          const float* W) {
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float e = X[i] - goal[i];
    const float te = (W[MPT_COST_W_Q] * e) * e;
    c = i == 0 ? te : c + te;
    c = c + (W[MPT_COST_W_DQ] * X[MPT_NJ + i]) * X[MPT_NJ + i];
  }
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) c = c + (W[MPT_COST_W_U] * U[j]) * U[j];
  return c;
}

// K8's terminal cost (terminal_cost_fused): every q term, then every dq
// term (the dq goal is 0), the first set, not added.
static __device__ __forceinline__ float fwdl_terminal_cost(const float* X, const float* goal, const float* W) {
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float e = X[i] - goal[i];
    const float te = (W[MPT_COST_WT_Q] * e) * e;
    c = i == 0 ? te : c + te;
  }
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float e = X[MPT_NJ + i];
    c = c + (W[MPT_COST_WT_DQ] * e) * e;
  }
  return c;
}

// One closed-loop step of the warp's alpha, by lane j: X (the state) is
// read and replaced, U written; lane j < n returns u_j, q_j' and dq_j' in
// u, q, dq for the stores; every lane returns the running cost.
static __device__ __forceinline__ float fwdl_step(
    int j, float* wm, const float* rows, const float* goal, float alpha, float* u_out, float* q_out,
    float* dq_out, const float* __restrict__ tab) {
  const float* W = tab + MPT_TAB_FLOATS;
  float* X = wm + MPT_W_X;
  float* U = wm + MPT_W_U;
  const bool own = j < MPT_NJ;

  // The controller: u_j = clamp(sd_u_j + alpha k_j + sum_i K_ji dx_i, +-u_lim_j).
  float uj = 0.0f;
  if (own) {
    const float* r = rows + MPT_NX + MPT_NJ + j * MPT_KK;
    uj = rows[MPT_NX + j] + alpha * r[0];
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) uj = uj + r[1 + i] * (X[i] - rows[i]);
    const float lim = tab[MPT_TAB_HEAD + j * MPT_TAB_STRIDE + MPT_TAB_U_LIM];
    uj = mpt_clamp(uj, -lim, lim);
    U[j] = uj;
  }
  mpt_lanes_sync();
  const float c = fwdl_running_cost(X, U, goal, W);

  // The pass over the links (mpt_loop_dynamics, split by columns).
  float V[6], Vd[6], JB[6], Mc[MPT_NJ], bias = 0.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    V[e] = 0.0f;
    V[3 + e] = 0.0f;
    Vd[e] = 0.0f;
    Vd[3 + e] = -tab[MPT_TAB_G + e];
    JB[e] = 0.0f;
    JB[3 + e] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) Mc[i] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < MPT_NJ; ++k) {
    const float* L = tab + MPT_TAB_HEAD + k * MPT_TAB_STRIDE;
    const float* A = L + MPT_TAB_A;
    const float dqk = X[MPT_NJ + k];
    float R[9], p[3];
    mpt_link_transform(L, X[k], R, p);
    float* jb = wm + MPT_W_JB + (k & 1) * 6 * MPT_NJ;
    if (own && j <= k) {
      if (j < k) {
        mpt_ad(R, p, JB);
      } else {
#pragma unroll
        for (int e = 0; e < 6; ++e) JB[e] = A[e];
      }
#pragma unroll
      for (int e = 0; e < 6; ++e) jb[e * MPT_NJ + j] = JB[e];
    }
    // The RNEA's forward sweep (ddq = 0) and link k's wrench, every lane.
    float Adq[6], adV[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) Adq[e] = A[e] * dqk;
    mpt_ad(R, p, V);
#pragma unroll
    for (int e = 0; e < 6; ++e) V[e] = V[e] + Adq[e];
    mpt_ad(R, p, Vd);
    mpt_ad_twist(V, Adq, adV);
#pragma unroll
    for (int e = 0; e < 6; ++e) Vd[e] = Vd[e] + adV[e];
    const float* I = L + MPT_TAB_I;
    const float m = L[MPT_TAB_M];
    float F[6], GV[6];
    mpt_wrench(I, m, V, Vd, F, GV);
    mpt_lanes_sync();
    // M[i][j] += JB_i . G JB_j (i <= j), bias_j += JB_j . F; the first
    // term of each (at k == j) set, not added.
    if (own && j <= k) {
      float GJ[6], Ji[6];
      mpt_inertia(I, m, JB, GJ);
#pragma unroll
      for (int i = 0; i < MPT_NJ; ++i) {
        if (i <= j) {
#pragma unroll
          for (int e = 0; e < 6; ++e) Ji[e] = jb[e * MPT_NJ + i];
          const float d = mpt_dot6(Ji, GJ);
          Mc[i] = (j == k) ? d : Mc[i] + d;
        }
      }
      const float d = mpt_dot6(JB, F);
      bias = (j == k) ? d : bias + d;
    }
  }

  // The Cholesky factor, column by column (mpt_chol_factor): lane j forms
  // L_jj from its row, then the lanes below form their entry of column j.
  float* Lm = wm + MPT_W_L;
  float* INV = wm + MPT_W_INV;
  float Lr[MPT_NJ], inv_own = 0.0f;
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) Lr[i] = 0.0f;
#pragma unroll
  for (int col = 0; col < MPT_NJ; ++col) {
    if (j == col) {
      float s = Mc[col];
#pragma unroll
      for (int kk = 0; kk < col; ++kk) s = s - Lr[kk] * Lr[kk];
      const float d = sqrtf(s);
      Lr[col] = d;
      inv_own = 1.0f / d;
#pragma unroll
      for (int kk = 0; kk <= col; ++kk) Lm[col * MPT_NJ + kk] = Lr[kk];
      INV[col] = inv_own;
    }
    mpt_lanes_sync();
    if (own && j > col) {
      float t = Mc[col];
#pragma unroll
      for (int kk = 0; kk < col; ++kk) t = t - Lr[kk] * Lm[col * MPT_NJ + kk];
      Lr[col] = t * INV[col];
    }
  }

  // M ddq = u - bias: the forward solve, each y_i's sum in order kk < i,
  // the term of y_kk subtracted once lane kk has published it.
  float* Y = wm + MPT_W_Y;
  float* XS = wm + MPT_W_XS;
  float s = uj - bias, y_own = 0.0f;
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    if (j == i) {
      y_own = s * inv_own;
      Y[i] = y_own;
    }
    mpt_lanes_sync();
    if (own && j > i) s = s - Lr[i] * Y[i];
  }
  // The backward solve, x_i = (y_i - sum_{kk > i} L_kk,i x_kk) / L_ii in
  // order kk = i+1..n-1: lane i reads column i of the factor.
  float x_own = 0.0f;
#pragma unroll
  for (int i = MPT_NJ - 1; i >= 0; --i) {
    if (j == i) {
      float t = y_own;
#pragma unroll
      for (int kk = i + 1; kk < MPT_NJ; ++kk) t = t - Lm[kk * MPT_NJ + i] * XS[kk];
      x_own = t * inv_own;
      XS[i] = x_own;
    }
    mpt_lanes_sync();
  }

  // Semi-implicit Euler and the clamps (fd_step_loop), lane j's joint.
  if (own) {
    const float* Lj = tab + MPT_TAB_HEAD + j * MPT_TAB_STRIDE;
    const float dt = tab[MPT_TAB_DT];
    const float dqj = X[MPT_NJ + j] + x_own * dt;
    const float qj = mpt_clamp(X[j] + dqj * dt, Lj[MPT_TAB_LOWER], Lj[MPT_TAB_UPPER]);
    const float vel = Lj[MPT_TAB_VEL];
    const float dqc = mpt_clamp(dqj, -vel, vel);
    *u_out = uj;
    *q_out = qj;
    *dq_out = dqc;
  }
  return c;
}

// The closed loops of alphas a0 .. a0 + MPT_FWDL_WARPS - 1 by thread `tid`
// of the block: warp w rolls alpha a0 + w. Step t+1's rows are on their
// way while step t runs; the block meets after each step, once they have
// landed and every warp's new state is in place.
static __device__ __forceinline__ void fwd_loop_block(
    int tid, float* sm, const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ costs,
    int H, int A, int a0, const float* __restrict__ tab) {
  const int w = tid / MPT_WARP, j = tid % MPT_WARP;
  const int a = a0 + w;
  const bool stores = a < A;
  const float alpha = alphas[stores ? a : A - 1];
  float* wm = sm + MPT_L_WARPS + w * MPT_W_FLOATS;
  const float* gl = sm + MPT_L_GOAL;
  for (int e = tid; e < MPT_NJ; e += MPT_FWDL_THREADS) sm[MPT_L_GOAL + e] = goal[e];
  if (j < MPT_NX) wm[MPT_W_X + j] = x0[j];
  if (MPT_NX > MPT_WARP && j + MPT_WARP < MPT_NX) wm[MPT_W_X + j + MPT_WARP] = x0[j + MPT_WARP];
  fwdl_rows(tid, sm, sd_x, sd_u, kK, 0);
  mpt_team_wait_all();
  mpt_team_sync(1, MPT_FWDL_THREADS);
  float acc = 0.0f;
  for (int t = 0; t < H; ++t) {
    if (t + 1 < H) fwdl_rows(tid, sm, sd_x, sd_u, kK, t + 1);
    float u = 0.0f, q = 0.0f, dq = 0.0f;
    const float c = fwdl_step(j, wm, sm + MPT_L_ROWS + (t & 1) * MPT_ROWN, gl, alpha, &u, &q, &dq, tab);
    acc = acc + c;
    if (j < MPT_NJ) {
      wm[MPT_W_X + j] = q;
      wm[MPT_W_X + MPT_NJ + j] = dq;
      if (stores) {
        const size_t row = (size_t)a * H + t;
        xs[row * MPT_NX + j] = q;
        xs[row * MPT_NX + MPT_NJ + j] = dq;
        us[row * MPT_NJ + j] = u;
      }
    }
    mpt_team_wait_all();
    mpt_team_sync(1, MPT_FWDL_THREADS);
  }
  if (j == 0 && stores) costs[a] = acc + fwdl_terminal_cost(wm + MPT_W_X, gl, tab + MPT_TAB_FLOATS);
}

#ifdef __CUDACC__
// The table and the cost weights, by value: they live in the launch's
// parameter space (4 + 47 n + 5 floats, 1916 bytes at n = 10).
struct MptFwdTable {
  float v[MPT_TAB_FLOATS + MPT_COST_FLOATS];
};

__global__ void __launch_bounds__(MPT_FWDL_THREADS) mps_fwd_loop_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ costs,
    int H, int A, const __grid_constant__ MptFwdTable tab) {
  __shared__ float sm[MPT_L_FLOATS];
  fwd_loop_block((int)threadIdx.x, sm, x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, A,
                 (int)blockIdx.x * MPT_FWDL_WARPS, tab.v);
}

// x0 (nx), sd_x (H, nx), sd_u (H, n), kK (H, n, 1+nx), goal (n),
// alphas (A) -> xs (A, H, nx), us (A, H, n), costs (A). MPT_FWDL_WARPS
// alphas a block, one a warp. `table` is the robot's table and cost
// weights in host memory (MPT_TAB_FLOATS + MPT_COST_FLOATS floats), copied
// into the launch.
extern "C" int launch_forward(const float* x0, const float* sd_x,
                              const float* sd_u, const float* kK,
                              const float* goal, const float* alphas, float* xs,
                              float* us, float* costs, int H, int A,
                              const float* table, void* stream) {
  if (H <= 0 || A <= 0) return 0;
  MptFwdTable tab;
  for (int i = 0; i < MPT_TAB_FLOATS + MPT_COST_FLOATS; ++i) tab.v[i] = table[i];
  const unsigned int blocks = (unsigned int)((A + MPT_FWDL_WARPS - 1) / MPT_FWDL_WARPS);
  mps_fwd_loop_kernel<<<blocks, MPT_FWDL_THREADS, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, A, tab);
  return (int)cudaGetLastError();
}

extern "C" int attributes_forward(int* num_regs, int* local_bytes, int* max_threads, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mps_fwd_loop_kernel);
  if (err != cudaSuccess) return (int)err;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  *smem_bytes = (int)a.sharedSizeBytes;
  return 0;
}
#endif

// The looped K8's layout: warps (alphas) a block, lanes a warp, joints (the
// lanes at work), the shared bytes of a block and of a warp's region.
extern "C" int layout_forward_loop(int* out) {
  out[0] = MPT_FWDL_WARPS;
  out[1] = MPT_WARP;
  out[2] = MPT_NJ;
  out[3] = (int)MPT_L_BYTES;
  out[4] = (int)(MPT_W_FLOATS * sizeof(float));
  return 0;
}
