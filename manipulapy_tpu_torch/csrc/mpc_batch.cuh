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
//     LIN: #define MPT_LIN_SEEDS <G>, MPT_LIN_BLOCK <threads>,
//          fd_step_jvp_group (ops/fd_step.py::build_fd_step_jvp_group_source);
//     BWD: riccati_terminal, riccati_step;
//     FWD: #define MPT_TEAM_S <scenarios a team>, MPT_TEAM_PER_BLOCK
//          <teams a block>; mpc_fwd_step, mpc_terminal (K4), and the same
//          step split over a team of warps (mpt_fwd_team, with
//          ops/cgen.py::TEAM_SOURCE) for K5;
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
//   K2: one thread per (scenario b, group of G = MPT_LIN_SEEDS seeds, step
//       t), B*(m/G)*H independent threads in blocks of MPT_LIN_BLOCK; each
//       runs the primal step once and the tangents of seeds gG .. gG+G-1
//       (Panda, G = 3: ~30k statements, against 3 x 13k when each seed
//       recomputed the step) and writes those G columns of AB at t.
//       Operations bound it (~30k statements against 4*(3n + 2nG) bytes
//       per thread). The primal and G tangents live at once: the body is
//       emitted in an order that holds fewer values (ops/fd_step.py,
//       `lean`), about (1 + G) x 115 at its peak for Panda and 87 for UR5,
//       against 255 registers; Panda's thread still spills, part of it to
//       shared memory (ptxas -O1 and its shared-memory spilling, PERF.md
//       §6).
//   K3: one warp per scenario, MPT_BWD_WARPS = 4 scenarios a block, so
//       B/4 blocks (256 at B=1024, about two per SM). t = H-1 ... 0 stays
//       inside the warp; its state (value function, [A | B] of step t, the
//       Q blocks, the Cholesky factor, the gains) lives in the warp's own
//       region of shared memory, none on the stack. A step is seven phases
//       over the lanes (see the K3 section); each entry's sum stays in one
//       lane in the emitter's order. AB, xs and us of step t-1 are loaded
//       into registers while step t computes. Operations set its least time
//       (~26k statements per step); a step's dependent chain is its
//       phases' longest sums. From B=4096 on, shared-memory loads (both
//       operands of every product) most likely bound it (PERF.md).
//   K4: one thread per (scenario, alpha), the closed-loop rollout with the
//       step inlined. Operations set its least time (~5k statements per
//       step); at B=1024 it is latency-bound: B threads fill few of the
//       132 SMs.
//   K5: a team of MPT_FWD_TEAM_W warps per MPT_TEAM_S scenarios (on the
//       lanes), MPT_TEAM_PER_BLOCK teams a block: each closed-loop step is
//       the emitted step partitioned into one straight-line program per
//       warp over MPT_FWD_TEAM_P phases (ops/cgen.py::team_function), the
//       team's named barrier between phases, values that cross warps in
//       shared-memory slots, the next step's rows on their way by cp.async.
//       Every statement is the emitted one, so the bits are the plain
//       version's. What bounds it is the instruction stream, not the
//       dependent chain: the step is ~6k instructions of straight-line code
//       (~12k split over 8 warps, the slots' loads and stores included)
//       that no instruction cache holds, so each SM fetches it anew every
//       step (PERF.md section 6).
// Every kernel is built with --fmad=false and the emitter's order of
// operations, so each agrees bitwise with its plain PyTorch version.
//
// The per-thread bodies (`*_thread`) are plain functions of the scenario
// index, and K3's phases plain functions of the lane: a host harness
// compiles this file with `__device__` defined away (and MPT_HOST_TEAM
// defined, so each of K3's phases runs lanes 0..31 in turn) and runs them in
// a loop; K5's team function runs there with each thread a coroutine that
// yields at every barrier (tests/test_torch_mpc_batch.py).

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

// ---------------------------------------------------------------- K2 -----
#if defined(MPT_UNIT_LIN)
#if !defined(MPT_LIN_SEEDS) || !defined(MPT_LIN_BLOCK)
#error "MPT_LIN_SEEDS and MPT_LIN_BLOCK must be defined with fd_step_jvp_group"
#endif
#if MPT_M % MPT_LIN_SEEDS != 0
#error "MPT_LIN_SEEDS must divide the 3n seeds"
#endif
#define MPT_LIN_GROUPS (MPT_M / MPT_LIN_SEEDS)

// Thread (b, grp, t): the step at (x, u) of scenario b, step t, and the
// columns grp*G .. grp*G+G-1 of its Jacobian. Consecutive threads own
// consecutive scenarios, so every load and store is one coalesced row.
static __device__ __forceinline__ void lin_thread(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int B, int b, int grp, int t) {
  float x[MPT_NX], u[MPT_NJ], x_next[MPT_NX], col[MPT_LIN_SEEDS * MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(xs, t * MPT_NX + i, b, B);
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) u[j] = MPT_AT(us, t * MPT_NJ + j, b, B);
  const int k0 = grp * MPT_LIN_SEEDS;
  fd_step_jvp_group(x, u, k0, x_next, col);
  const size_t row0 = (size_t)t * MPT_NX * MPT_M + (size_t)k0;
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i)
#pragma unroll
    for (int j = 0; j < MPT_LIN_SEEDS; ++j)
      MPT_AT(AB, row0 + (size_t)i * MPT_M + j, b, B) = col[j * MPT_NX + i];
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_LIN_BLOCK) mpt_lin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int B) {
  // The body's live values exceed the 255 registers a thread may hold; let
  // ptxas spill part of them to shared memory before local memory.
  asm volatile(".pragma \"enable_smem_spilling\";");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lin_thread(xs, us, AB, B, b, (int)blockIdx.y, (int)blockIdx.z);
}

// xs (H, nx, B), us (H, n, B) -> AB (H, nx, m, B). Grid (B blocks, m/G, H).
extern "C" int launch_linearize(const float* xs, const float* us, float* AB,
                                int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const dim3 grid((unsigned int)((B + MPT_LIN_BLOCK - 1) / MPT_LIN_BLOCK),
                  MPT_LIN_GROUPS, (unsigned int)H);
  mpt_lin_kernel<<<grid, MPT_LIN_BLOCK, 0, (cudaStream_t)stream>>>(xs, us, AB, B);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linearize, mpt_lin_kernel)
#endif
#endif  // MPT_UNIT_LIN

// ---------------------------------------------------------------- K3 -----
#if defined(MPT_UNIT_BWD)
// One warp per scenario. The warp's state lives in its own region of
// shared memory (`mpt_bwd_team`) and each step of the sweep is a sequence of
// phases, `__syncwarp()` between them. Every output entry of a phase belongs
// to one lane (round robin, e = lane, lane + 32, ...), and that lane takes
// the entry's whole sum in the emitter's order (`riccati_step` of
// ops/cuda_mpc_batch.py: the first term, then left to right), so each
// entry gets the plain version's IEEE operations and, with --fmad=false,
// its bits. The generated part of the unit gives `riccati_terminal`,
// MPT_BWD_2WX (2 w_x, nx) and MPT_BWD_2WU (2 w_u): the folded weights. Where
// a weight is exactly 0 the plain version folds its term away and the
// kernel multiplies by 0; the two differ only for a non-finite input or in
// the sign of a zero.
#define MPT_BWD_WARPS 4                       // scenarios per block
#define MPT_LANES 32
#define MPT_AB (MPT_NX * MPT_M)               // [A | B] of one step
#define MPT_UPPER (MPT_NX * (MPT_NX + 1) / 2)  // upper triangle of nx x nx
#define MPT_KKN (MPT_NJ * MPT_KK)             // gains of one step
#define MPT_ROUNDS(count) (((count) + MPT_LANES - 1) / MPT_LANES)
// Registers a lane holds the next step's inputs in: its entries of AB, then
// of [x; u].
#define MPT_PRE_AB MPT_ROUNDS(MPT_AB)
#define MPT_PRE (MPT_PRE_AB + MPT_ROUNDS(MPT_NX + MPT_NJ))

// One warp's storage (Panda: 1191 floats). Row-major matrices, one region
// per warp, so the lanes of a phase read neighbouring entries of one row
// or one entry for all (a broadcast). VAB is dead once the Q blocks exist,
// and the factor, the gains and their products take its place.
struct mpt_bwd_team {
  float V[MPT_VN];   // Vxx rows, then Vx: of step t+1, of step t after phase 7
  float ab[MPT_AB];  // row i: A_t[i, :], then B_t[i, :]
  float x[MPT_NX], u[MPT_NJ], g[MPT_NJ];
  float Qx[MPT_NX], Qu[MPT_NJ];
  float Qxx[MPT_NX * MPT_NX];  // upper triangle only
  float Quu[MPT_NJ * MPT_NJ];
  float Qux[MPT_NJ * MPT_NX];
  union {
    float VAB[MPT_AB];  // phases 2-3: Vxx [A | B]
    struct {
      float L[MPT_NJ * MPT_NJ], inv_d[MPT_NJ];      // phase 4 on
      float kk[MPT_KKN];                             // phase 5 on: k_j, row j of K
      float Quu_k[MPT_NJ], KtQuu[MPT_NX * MPT_NJ];  // phase 6 on
    } s;
  };
  float reg;
};

// Entry e of the upper triangle, row by row: (i, k) with k >= i.
static __device__ __forceinline__ void mpt_upper(int e, int* i, int* k) {
  int r = 0;
  while (e >= MPT_NX - r) {
    e -= MPT_NX - r;
    ++r;
  }
  *i = r;
  *k = r + e;
}

static __device__ __forceinline__ void bwd_load_ends(
    int lane, mpt_bwd_team* tm, const float* __restrict__ x_last,
    const float* __restrict__ goal, const float* __restrict__ reg, int B, int b) {
  for (int e = lane; e <= MPT_NX + MPT_NJ; e += MPT_LANES) {
    if (e < MPT_NX) tm->x[e] = MPT_AT(x_last, e, b, B);
    else if (e < MPT_NX + MPT_NJ) tm->g[e - MPT_NX] = MPT_AT(goal, e - MPT_NX, b, B);
    else tm->reg = reg[b];
  }
}

// Step t's inputs into the lane's registers (issued a step ahead of use).
static __device__ __forceinline__ void bwd_prefetch(
    int lane, float* pre, const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, int B, int b, int t) {
  const size_t ab_row = (size_t)t * MPT_AB;
#pragma unroll
  for (int r = 0; r < MPT_PRE_AB; ++r) {
    const int e = lane + r * MPT_LANES;
    if (e < MPT_AB) pre[r] = MPT_AT(AB, ab_row + e, b, B);
  }
#pragma unroll
  for (int r = MPT_PRE_AB; r < MPT_PRE; ++r) {
    const int e = lane + (r - MPT_PRE_AB) * MPT_LANES;
    if (e < MPT_NX) pre[r] = MPT_AT(xs, (size_t)t * MPT_NX + e, b, B);
    else if (e < MPT_NX + MPT_NJ) pre[r] = MPT_AT(us, (size_t)t * MPT_NJ + (e - MPT_NX), b, B);
  }
}

static __device__ __forceinline__ void bwd_commit(int lane, mpt_bwd_team* tm, const float* pre) {
#pragma unroll
  for (int r = 0; r < MPT_PRE_AB; ++r) {
    const int e = lane + r * MPT_LANES;
    if (e < MPT_AB) tm->ab[e] = pre[r];
  }
#pragma unroll
  for (int r = MPT_PRE_AB; r < MPT_PRE; ++r) {
    const int e = lane + (r - MPT_PRE_AB) * MPT_LANES;
    if (e < MPT_NX) tm->x[e] = pre[r];
    else if (e < MPT_NX + MPT_NJ) tm->u[e - MPT_NX] = pre[r];
  }
}

// Phase 1: Qx = lx + Vx A, Qu = lu + Vx B; entry e is column e of [A | B].
static __device__ __forceinline__ void bwd_gradients(int lane, mpt_bwd_team* tm) {
  const float* Vx = tm->V + MPT_NX * MPT_NX;
  for (int e = lane; e < MPT_M; e += MPT_LANES) {
    float s = Vx[0] * tm->ab[e];
#pragma unroll
    for (int k = 1; k < MPT_NX; ++k) s = s + Vx[k] * tm->ab[k * MPT_M + e];
    if (e < MPT_NJ) tm->Qx[e] = MPT_BWD_2WX[e] * (tm->x[e] - tm->g[e]) + s;
    else if (e < MPT_NX) tm->Qx[e] = MPT_BWD_2WX[e] * tm->x[e] + s;  // goal velocity 0
    else tm->Qu[e - MPT_NX] = MPT_BWD_2WU * tm->u[e - MPT_NX] + s;
  }
}

// Phase 2: VAB = Vxx [A | B] (VA, then VB, per row).
static __device__ __forceinline__ void bwd_value_products(int lane, mpt_bwd_team* tm) {
  for (int e = lane; e < MPT_AB; e += MPT_LANES) {
    const int k = e / MPT_M, c = e - k * MPT_M;
    const float* Vk = tm->V + k * MPT_NX;
    float s = Vk[0] * tm->ab[c];
#pragma unroll
    for (int l = 1; l < MPT_NX; ++l) s = s + Vk[l] * tm->ab[l * MPT_M + c];
    tm->VAB[e] = s;
  }
}

// Phase 3: Q[r][c] = sum_l [A | B][l][r] VAB[l][c] for the upper triangle
// of Qxx (+ 2 w_x on its diagonal), Quu (+ (2 w_u + reg) on its diagonal)
// and Qux.
static __device__ __forceinline__ void bwd_q_blocks(int lane, mpt_bwd_team* tm) {
  const float diag_u = MPT_BWD_2WU + tm->reg;
  for (int e = lane; e < MPT_UPPER + MPT_NJ * MPT_NJ + MPT_NJ * MPT_NX; e += MPT_LANES) {
    int r, c;
    if (e < MPT_UPPER) {
      mpt_upper(e, &r, &c);
    } else if (e < MPT_UPPER + MPT_NJ * MPT_NJ) {
      const int f = e - MPT_UPPER;
      r = MPT_NX + f / MPT_NJ;
      c = MPT_NX + f % MPT_NJ;
    } else {
      const int f = e - MPT_UPPER - MPT_NJ * MPT_NJ;
      r = MPT_NX + f / MPT_NX;
      c = f % MPT_NX;
    }
    float s = tm->ab[r] * tm->VAB[c];
#pragma unroll
    for (int l = 1; l < MPT_NX; ++l) s = s + tm->ab[l * MPT_M + r] * tm->VAB[l * MPT_M + c];
    if (e < MPT_UPPER) {
      if (r == c) s = s + MPT_BWD_2WX[r];
      tm->Qxx[r * MPT_NX + c] = s;
    } else if (r >= MPT_NX && c >= MPT_NX) {
      if (r == c) s = s + diag_u;
      tm->Quu[(r - MPT_NX) * MPT_NJ + (c - MPT_NX)] = s;
    } else {
      tm->Qux[(r - MPT_NX) * MPT_NX + c] = s;
    }
  }
}

// Phase 4, column j of the Cholesky factor of Quu (`_chol_solve_cols`):
// every lane i >= j forms the pivot d = sqrt(Quu_jj - sum_k L_jk^2) and 1/d
// (the same operations, so the same bits), lane j stores them and each
// lane i > j its L_ij.
static __device__ __forceinline__ void bwd_cholesky_column(int lane, mpt_bwd_team* tm, int j) {
  if (lane >= j && lane < MPT_NJ) {
    float* L = tm->s.L;
    float s = tm->Quu[j * MPT_NJ + j];
    for (int k = 0; k < j; ++k) s = s - L[j * MPT_NJ + k] * L[j * MPT_NJ + k];
    const float d = sqrtf(s);
    const float inv = 1.0f / d;
    if (lane == j) {
      L[j * MPT_NJ + j] = d;
      tm->s.inv_d[j] = inv;
    } else {
      float si = tm->Quu[lane * MPT_NJ + j];
      for (int k = 0; k < j; ++k) si = si - L[lane * MPT_NJ + k] * L[j * MPT_NJ + k];
      L[lane * MPT_NJ + j] = si * inv;
    }
  }
}

// Phase 5: lane c solves Quu z = rhs_c (rhs_0 = Qu, rhs_{1+i} = Qux[:, i]),
// forward then back substitution, and stores -z as column c of the gains,
// in shared memory and in kK[t].
static __device__ __forceinline__ void bwd_solve(
    int lane, mpt_bwd_team* tm, float* __restrict__ kK, int B, int b, int t) {
  if (lane < MPT_KK) {
    const float* L = tm->s.L;
    const float* inv_d = tm->s.inv_d;
    float y[MPT_NJ], z[MPT_NJ];
#pragma unroll
    for (int i = 0; i < MPT_NJ; ++i) {
      float s = lane == 0 ? tm->Qu[i] : tm->Qux[i * MPT_NX + (lane - 1)];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i * MPT_NJ + k] * y[k];
      y[i] = s * inv_d[i];
    }
#pragma unroll
    for (int i = MPT_NJ - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < MPT_NJ; ++k) s = s - L[k * MPT_NJ + i] * z[k];
      z[i] = s * inv_d[i];
    }
    const size_t row = (size_t)t * MPT_KKN;
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      const float v = -z[j];
      tm->s.kk[j * MPT_KK + lane] = v;
      MPT_AT(kK, row + j * MPT_KK + lane, b, B) = v;
    }
  }
}

// Phase 6: Quu k, then K^T Quu.
static __device__ __forceinline__ void bwd_gain_products(int lane, mpt_bwd_team* tm) {
  const float* kk = tm->s.kk;
  for (int e = lane; e < MPT_NJ + MPT_NX * MPT_NJ; e += MPT_LANES) {
    if (e < MPT_NJ) {
      float s = tm->Quu[e * MPT_NJ] * kk[0];
#pragma unroll
      for (int j2 = 1; j2 < MPT_NJ; ++j2) s = s + tm->Quu[e * MPT_NJ + j2] * kk[j2 * MPT_KK];
      tm->s.Quu_k[e] = s;
    } else {
      const int f = e - MPT_NJ, i = f / MPT_NJ, j2 = f % MPT_NJ;
      float s = kk[1 + i] * tm->Quu[j2];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) s = s + kk[j * MPT_KK + 1 + i] * tm->Quu[j * MPT_NJ + j2];
      tm->s.KtQuu[i * MPT_NJ + j2] = s;
    }
  }
}

// Phase 7: Vx' = (Qx + K^T (Quu k + Qu)) + Qux^T k, and the upper triangle of
// Vxx' = ((Qxx + K^T Quu K) + K^T Qux) + Qux^T K, mirrored, into V.
static __device__ __forceinline__ void bwd_value_update(int lane, mpt_bwd_team* tm) {
  const float* kk = tm->s.kk;  // K[j][i] = kk[j * MPT_KK + 1 + i], k_j = kk[j * MPT_KK]
  for (int e = lane; e < MPT_NX + MPT_UPPER; e += MPT_LANES) {
    if (e < MPT_NX) {
      float s = kk[1 + e] * (tm->s.Quu_k[0] + tm->Qu[0]);
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) s = s + kk[j * MPT_KK + 1 + e] * (tm->s.Quu_k[j] + tm->Qu[j]);
      float s2 = tm->Qux[e] * kk[0];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) s2 = s2 + tm->Qux[j * MPT_NX + e] * kk[j * MPT_KK];
      tm->V[MPT_NX * MPT_NX + e] = (tm->Qx[e] + s) + s2;
    } else {
      int i, k;
      mpt_upper(e - MPT_NX, &i, &k);
      float a = tm->s.KtQuu[i * MPT_NJ] * kk[1 + k];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) a = a + tm->s.KtQuu[i * MPT_NJ + j] * kk[j * MPT_KK + 1 + k];
      float c1 = kk[1 + i] * tm->Qux[k];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) c1 = c1 + kk[j * MPT_KK + 1 + i] * tm->Qux[j * MPT_NX + k];
      float c2 = tm->Qux[i] * kk[1 + k];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) c2 = c2 + tm->Qux[j * MPT_NX + i] * kk[j * MPT_KK + 1 + k];
      const float v = ((tm->Qxx[i * MPT_NX + k] + a) + c1) + c2;
      tm->V[i * MPT_NX + k] = v;
      tm->V[k * MPT_NX + i] = v;
    }
  }
}

// A phase: on the card the calling lane runs it and the warp meets at
// __syncwarp(); in the host harness (MPT_HOST_TEAM) lanes 0..31 run it one
// after the other before the next phase, each with its own registers.
#if defined(MPT_HOST_TEAM)
#define MPT_PHASE(call)                                        \
  do {                                                         \
    for (int lane = 0; lane < MPT_LANES; ++lane) { call; }     \
  } while (0)
#define MPT_PRE_OF(lane) pre[lane]
#define MPT_PRE_DECL float pre[MPT_LANES][MPT_PRE]
#else
#define MPT_PHASE(call)         \
  do {                          \
    const int lane = my_lane;   \
    call;                       \
    __syncwarp();               \
  } while (0)
#define MPT_PRE_OF(lane) pre
#define MPT_PRE_DECL float pre[MPT_PRE]
#endif

// Scenario b's whole sweep, t = H-1 ... 0, by the warp whose lane this is.
static __device__ __forceinline__ void bwd_sweep(
    int my_lane, mpt_bwd_team* tm, const float* __restrict__ AB,
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ x_last, const float* __restrict__ goal,
    const float* __restrict__ reg, float* __restrict__ kK, int B, int H, int b) {
  MPT_PRE_DECL;
  (void)my_lane;
  MPT_PHASE(bwd_load_ends(lane, tm, x_last, goal, reg, B, b));
  MPT_PHASE(if (lane == 0) riccati_terminal(tm->x, tm->g, tm->V));
  MPT_PHASE(bwd_prefetch(lane, MPT_PRE_OF(lane), AB, xs, us, B, b, H - 1));
  MPT_PHASE(bwd_commit(lane, tm, MPT_PRE_OF(lane)));
  for (int t = H - 1; t >= 0; --t) {
    if (t > 0) MPT_PHASE(bwd_prefetch(lane, MPT_PRE_OF(lane), AB, xs, us, B, b, t - 1));
    MPT_PHASE(bwd_gradients(lane, tm));
    MPT_PHASE(bwd_value_products(lane, tm));
    MPT_PHASE(bwd_q_blocks(lane, tm));
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) MPT_PHASE(bwd_cholesky_column(lane, tm, j));
    MPT_PHASE(bwd_solve(lane, tm, kK, B, b, t));
    MPT_PHASE(bwd_gain_products(lane, tm));
    MPT_PHASE(bwd_value_update(lane, tm));
    if (t > 0) MPT_PHASE(bwd_commit(lane, tm, MPT_PRE_OF(lane)));
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BWD_WARPS * MPT_LANES) mpt_bwd_warp_kernel(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ x_last,
    const float* __restrict__ goal, const float* __restrict__ reg,
    float* __restrict__ kK, int B, int H) {
  __shared__ mpt_bwd_team teams[MPT_BWD_WARPS];
  const int w = (int)threadIdx.x / MPT_LANES;
  const int b = (int)blockIdx.x * MPT_BWD_WARPS + w;
  if (b >= B) return;  // the whole warp: its lanes meet no one else
  bwd_sweep((int)threadIdx.x % MPT_LANES, &teams[w], AB, xs, us, x_last, goal, reg, kK, B, H, b);
}

// AB (H, nx, m, B), xs (H, nx, B), us (H, n, B), x_last (nx, B),
// goal (n, B), reg (B) -> kK (H, n, 1+nx, B). MPT_BWD_WARPS scenarios a block.
extern "C" int launch_backward(const float* AB, const float* xs,
                               const float* us, const float* x_last,
                               const float* goal, const float* reg, float* kK,
                               int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const unsigned int blocks = (unsigned int)(((long long)B + MPT_BWD_WARPS - 1) / MPT_BWD_WARPS);
  mpt_bwd_warp_kernel<<<blocks, MPT_BWD_WARPS * MPT_LANES, 0, (cudaStream_t)stream>>>(
      AB, xs, us, x_last, goal, reg, kK, B, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_backward, mpt_bwd_warp_kernel)
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

// K5: a team of MPT_FWD_TEAM_W warps owns MPT_TEAM_S scenarios, scenario
// b0 + s on lane s of every warp (lanes s + S, s + 2S, ... repeat lane s's
// work in the same columns, and only lane s stores). Each step is the
// emitted team step `mpt_fwd_team` (ops/cgen.py::team_function): warp w runs
// its own straight-line program over MPT_FWD_TEAM_P phases, the team's named
// barrier between them; values that cross warps go through slots. Storage
// of one team, in floats, each value a column of MPT_TEAM_S lanes:
//   XIN   2 x nx     the state of step t in buffer t & 1, written by step t-1
//   ROWS  2 x ROWN   sd_x, sd_u, kK of step t in buffer t & 1 (cp.async)
//   GOAL  n
//   OB    2 x (n+1)  u, then the running cost, of step t in buffer t & 1
//   SLOTS MPT_FWD_TEAM_SLOTS
#if !defined(MPT_TEAM_S) || !defined(MPT_TEAM_PER_BLOCK) || !defined(MPT_FWD_TEAM_W)
#error "MPT_TEAM_S, MPT_TEAM_PER_BLOCK and the emitted team step must come before K5"
#endif
#if 32 % MPT_TEAM_S != 0 || MPT_TEAM_S % 4 != 0 || MPT_TEAM_PER_BLOCK > 15 || MPT_FWD_TEAM_W * MPT_TEAM_PER_BLOCK > 32
#error "a team's S must divide 32 and be a multiple of 4; a block holds at most 15 teams and 32 warps"
#endif
#define MPT_ROWN (MPT_NX + MPT_NJ + MPT_NJ * MPT_KK)
#define MPT_TEAM_THREADS (32 * MPT_FWD_TEAM_W)
#define MPT_T_XIN 0
#define MPT_T_ROWS (MPT_T_XIN + 2 * MPT_NX * MPT_TEAM_S)
#define MPT_T_GOAL (MPT_T_ROWS + 2 * MPT_ROWN * MPT_TEAM_S)
#define MPT_T_OB (MPT_T_GOAL + MPT_NJ * MPT_TEAM_S)
#define MPT_T_SLOTS (MPT_T_OB + 2 * (MPT_NJ + 1) * MPT_TEAM_S)
#define MPT_T_FLOATS (MPT_T_SLOTS + MPT_FWD_TEAM_SLOTS * MPT_TEAM_S)
#define MPT_T_BYTES ((size_t)MPT_T_FLOATS * sizeof(float))
// Teams a block: MPT_TEAM_PER_BLOCK where their storage fits the 232448
// bytes of shared memory a block may take, else as many as fit (a robot with
// more joints has more slots).
#define MPT_SMEM_MAX 232448
#if MPT_T_FLOATS * 4 > MPT_SMEM_MAX
#error "one team's storage exceeds the shared memory a block may take"
#endif
#define MPT_TEAMS (MPT_TEAM_PER_BLOCK * MPT_T_FLOATS * 4 <= MPT_SMEM_MAX ? MPT_TEAM_PER_BLOCK \
                   : MPT_SMEM_MAX / (MPT_T_FLOATS * 4))

// x0 and the goals of the team's scenarios into XIN buffer 0 and GOAL
// (zeros past B).
static __device__ __forceinline__ void replay_team_init(
    int tid, float* tm, const float* __restrict__ x0, const float* __restrict__ goal,
    int B, int b0) {
  for (int e = tid; e < (MPT_NX + MPT_NJ) * MPT_TEAM_S; e += MPT_TEAM_THREADS) {
    const int k = e / MPT_TEAM_S, s = e % MPT_TEAM_S, b = b0 + s;
    if (k < MPT_NX) tm[MPT_T_XIN + e] = b < B ? MPT_AT(x0, k, b, B) : 0.0f;
    else tm[MPT_T_GOAL + e - MPT_NX * MPT_TEAM_S] = b < B ? MPT_AT(goal, k - MPT_NX, b, B) : 0.0f;
  }
}

// One block of step t's rows (`rows` of them from row t * rows of `src`) of
// the team's scenarios into `dst`, value-major (element e: value e / S of
// scenario e % S), so consecutive threads copy consecutive scenarios of one
// row. By 4 scenarios a copy where B % 4 == 0 (16 aligned bytes, the team's
// four scenarios all below B or all past it), else one.
static __device__ __forceinline__ void replay_team_block(
    int tid, float* dst, const float* __restrict__ src, int rows, int B, int b0, int t) {
  const float* base = src + (size_t)t * rows * (size_t)B + b0;
  if (B % 4 == 0) {
    for (int e = 4 * tid; e < rows * MPT_TEAM_S; e += 4 * MPT_TEAM_THREADS) {
      const int k = e / MPT_TEAM_S, s = e % MPT_TEAM_S;
      const bool ok = b0 + s < B;
      mpt_team_copy4(dst + e, ok ? base + (size_t)k * B + s : src, ok);
    }
  } else {
    for (int e = tid; e < rows * MPT_TEAM_S; e += MPT_TEAM_THREADS) {
      const int k = e / MPT_TEAM_S, s = e % MPT_TEAM_S;
      const bool ok = b0 + s < B;
      mpt_team_copy(dst + e, ok ? base + (size_t)k * B + s : src, ok);
    }
  }
}

// Step t's rows of the team's scenarios (sd_x, sd_u, kK) into ROWS buffer
// t & 1, one group of copies.
static __device__ __forceinline__ void replay_team_rows(
    int tid, float* tm, const float* __restrict__ sd_x, const float* __restrict__ sd_u,
    const float* __restrict__ kK, int B, int b0, int t) {
  float* dst = tm + MPT_T_ROWS + (t & 1) * MPT_ROWN * MPT_TEAM_S;
  replay_team_block(tid, dst, sd_x, MPT_NX, B, b0, t);
  replay_team_block(tid, dst + MPT_NX * MPT_TEAM_S, sd_u, MPT_NJ, B, b0, t);
  replay_team_block(tid, dst + (MPT_NX + MPT_NJ) * MPT_TEAM_S, kK, MPT_NJ * MPT_KK, B, b0, t);
  mpt_team_commit();
}

// Step t's post-step state and controls of the team's scenarios to rows t
// of xs and us, one coalesced row at a time; thread s < S adds scenario s's
// running cost to its sum, in the order of the steps.
static __device__ __forceinline__ void replay_team_store(
    int tid, const float* tm, float* __restrict__ xs, float* __restrict__ us, float* acc,
    int B, int b0, int t) {
  const float* x_next = tm + MPT_T_XIN + ((t + 1) & 1) * MPT_NX * MPT_TEAM_S;
  const float* ob = tm + MPT_T_OB + (t & 1) * (MPT_NJ + 1) * MPT_TEAM_S;
  for (int e = tid; e < (MPT_NX + MPT_NJ) * MPT_TEAM_S; e += MPT_TEAM_THREADS) {
    const int k = e / MPT_TEAM_S, s = e % MPT_TEAM_S, b = b0 + s;
    if (b < B) {
      if (k < MPT_NX) MPT_AT(xs, (size_t)t * MPT_NX + k, b, B) = x_next[e];
      else MPT_AT(us, (size_t)t * MPT_NJ + (k - MPT_NX), b, B) = ob[e - MPT_NX * MPT_TEAM_S];
    }
  }
  if (tid < MPT_TEAM_S) *acc = *acc + ob[MPT_NJ * MPT_TEAM_S + tid];
}

// Thread s < S: scenario b0 + s's terminal cost, added to its running sum.
static __device__ __forceinline__ void replay_team_finish(
    int tid, const float* tm, float acc, float* __restrict__ cost, int B, int b0, int H) {
  if (tid < MPT_TEAM_S && b0 + tid < B) {
    const float* xin = tm + MPT_T_XIN + (H & 1) * MPT_NX * MPT_TEAM_S;
    float x[MPT_NX], g[MPT_NJ], c[1];
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) x[i] = xin[i * MPT_TEAM_S + tid];
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) g[j] = tm[MPT_T_GOAL + j * MPT_TEAM_S + tid];
    mpc_terminal(x, g, c);
    cost[b0 + tid] = acc + c[0];
  }
}

// The replay of scenarios b0 .. b0+S-1 by thread `tid` of their team, whose
// barrier is `bar`. Step t+1's rows are on their way while step t runs; the
// team meets after the step's last phase, once they have landed. Every
// thread runs every step and barrier; only the stores look at B.
static __device__ __forceinline__ void replay_team(
    int tid, int bar, float* tm, const float* __restrict__ x0,
    const float* __restrict__ sd_x, const float* __restrict__ sd_u,
    const float* __restrict__ kK, const float* __restrict__ goal,
    const float* __restrict__ alpha, float* __restrict__ xs, float* __restrict__ us,
    float* __restrict__ cost, int B, int H, int b0) {
  const int w = tid / 32, ln = tid % MPT_TEAM_S;
  const float a = b0 + ln < B ? alpha[b0 + ln] : 0.0f;
  float acc = 0.0f;
  replay_team_init(tid, tm, x0, goal, B, b0);
  replay_team_rows(tid, tm, sd_x, sd_u, kK, B, b0, 0);
  mpt_team_wait_all();
  mpt_team_sync(bar, MPT_TEAM_THREADS);
  for (int t = 0; t < H; ++t) {
    if (t + 1 < H) replay_team_rows(tid, tm, sd_x, sd_u, kK, B, b0, t + 1);
    mpt_fwd_team(w, bar, tm + MPT_T_XIN + (t & 1) * MPT_NX * MPT_TEAM_S + ln,
                 tm + MPT_T_ROWS + (t & 1) * MPT_ROWN * MPT_TEAM_S + ln, tm + MPT_T_GOAL + ln,
                 tm + MPT_T_OB + (t & 1) * (MPT_NJ + 1) * MPT_TEAM_S + ln,
                 tm + MPT_T_XIN + ((t + 1) & 1) * MPT_NX * MPT_TEAM_S + ln,
                 tm + MPT_T_SLOTS + ln, a);
    mpt_team_wait_all();
    mpt_team_sync(bar, MPT_TEAM_THREADS);
    replay_team_store(tid, tm, xs, us, &acc, B, b0, t);
  }
  replay_team_finish(tid, tm, acc, cost, B, b0, H);
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

__global__ void __launch_bounds__(MPT_TEAM_THREADS * MPT_TEAMS) mpt_replay_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alpha,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ cost,
    int B, int H) {
  extern __shared__ float mpt_team_smem[];
  const int team = (int)threadIdx.x / MPT_TEAM_THREADS;
  const int b0 = ((int)blockIdx.x * MPT_TEAMS + team) * MPT_TEAM_S;
  if (b0 >= B) return;  // the whole team: its barrier is its own
  replay_team((int)threadIdx.x % MPT_TEAM_THREADS, 1 + team, mpt_team_smem + (size_t)team * MPT_T_FLOATS,
              x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H, b0);
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
// us (H, n, B), cost (B). Blocks of MPT_TEAMS teams; the teams'
// storage is dynamic shared memory, whose limit is raised once per device.
#define MPT_REPLAY_SMEM (MPT_T_BYTES * MPT_TEAMS)
extern "C" int launch_replay(const float* x0, const float* sd_x,
                             const float* sd_u, const float* kK,
                             const float* goal, const float* alpha, float* xs,
                             float* us, float* cost, int B, int H,
                             void* stream) {
  static bool raised[64];
  if (B <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(mpt_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MPT_REPLAY_SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const long long teams = ((long long)B + MPT_TEAM_S - 1) / MPT_TEAM_S;
  const unsigned int blocks = (unsigned int)((teams + MPT_TEAMS - 1) / MPT_TEAMS);
  mpt_replay_kernel<<<blocks, MPT_TEAM_THREADS * MPT_TEAMS, MPT_REPLAY_SMEM,
                      (cudaStream_t)stream>>>(x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H);
  return (int)cudaGetLastError();
}

// K5's team: warps, scenarios a team, teams a block, phases a step, slots,
// and the dynamic shared bytes of a block.
extern "C" int team_replay(int* out) {
  out[0] = MPT_FWD_TEAM_W;
  out[1] = MPT_TEAM_S;
  out[2] = MPT_TEAMS;
  out[3] = MPT_FWD_TEAM_P;
  out[4] = MPT_FWD_TEAM_SLOTS;
  out[5] = (int)MPT_REPLAY_SMEM;
  return 0;
}
MPT_ATTRIBUTES(attributes_linesearch_costs, mpt_cost_kernel)
MPT_ATTRIBUTES(attributes_replay, mpt_replay_kernel)
#endif
#endif  // MPT_UNIT_FWD
