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
//   #define MPT_NJ <n>, MPT_BWD_THREADS <threads>, and one of MPT_UNIT_LIN,
//     MPT_UNIT_BWD, MPT_UNIT_FWD;
//   the unit's generated part, emitted from the same Python code over cgen
//   values as the plain PyTorch versions:
//     LIN: #define MPT_LIN_SEEDS 1 and the lean one-seed body
//          fd_step_jvp_group (ops/fd_step.py::build_fd_step_jvp_group_source,
//          K2's for Panda); or, with MPT_LIN_TEAM, the same body with the
//          seed an input column split over a team of warps (mpt_lin_team,
//          with ops/cgen.py::TEAM_SOURCE), put where the K6 section marks it;
//     BWD: the folded weights MPT_BWD_2WX, MPT_BWD_2WU only: K7's phases
//       do the operations of riccati_step_gj (the Gauss-Jordan Riccati step
//       of fused.py), written by hand in the same order;
//     FWD: mpc_fwd_step (K4's closed-loop step), mpc_terminal_fused, and
//       the same step split over a team of warps (mpt_fwd_team, with
//       ops/cgen.py::TEAM_SOURCE);
//   this file.
// The three units build in parallel, one nvcc each.
//
// Layout: time-major, one problem, no padding:
//   xs (H, nx), us (H, n), AB (H, nx, m), kK (H, n, 1+nx) (row j: k_j, then
//   row j of K), goal (n), Vterm (nx+1, nx) (Vxx rows, then Vx), reg (one
//   float), x0 (nx), alphas (A); K8 writes xs (A, H, nx), us (A, H, n) and
//   costs (A). The TPU's 128-lane staging (timesteps or alphas on the lanes,
//   packed AB / kK / V tiles) is gone, and so is its sequential grid axis:
//   a loop inside the kernel takes its place, and registers or shared
//   memory that of the VMEM scratch.
//
// Bound and design, per kernel (one problem, so none of them fills the card;
// the path is bound by launch latency and by dependent chains):
//   K6: H*m lanes (step t, seed k) (1050 for Panda at H=50), each the
//       step and its tangent for seed k, column k of AB at t: the function
//       K2 computes at B=1. ~13k straight-line statements a lane (Panda),
//       33 warps' worth of lanes, far from the card's rates: the bound is
//       fetching the program on each SM, about five cycles an instruction
//       for a warp alone, whether or not it spills (PERF.md). Either one
//       thread a lane, one warp a block (the H*m/32 blocks spread over as
//       many SMs), or a team of MPT_LIN_TEAM_W warps per 32 lanes, one
//       team a block: the body split into one program per warp (as K8's
//       step), so the warps fetch and run their parts side by side (at 8
//       warps for Panda: 39 phases, 2389 statements in a row of 13455,
//       18% faster). Which one a unit builds is
//       ops/cuda_mpc_single.py::LIN_WARPS, chosen by timing.
//   K7: one block of MPT_BWD_THREADS threads runs the whole time-reversed
//       sweep; its state lives in shared memory and each step is 4 + n
//       phases over the threads (see the K7 section), Quu solved by the
//       pivot-free Gauss-Jordan of fused.py one pivot a phase. H dependent
//       steps of ~30k operations (Panda) spread over the block: bound by
//       the phases' dependent chains and barriers.
//   K8: one team of MPT_FWD_TEAM_W warps a block runs the closed loops of
//       32 alphas (one a lane), each step the emitted step partitioned over
//       the warps as K5's (ops/cgen.py::team_function), the next step's rows
//       by cp.async; xs, us and the costs leave after each step. Bound by
//       the instruction stream of its ~12k-instruction step, as K5.
// Every kernel is built with --fmad=false and the emitter's order of
// operations, so each agrees bitwise with its plain PyTorch version.
//
// The per-thread bodies (`*_thread`) and K7's phases are plain functions: a
// host harness compiles this file with `__device__` defined away (and
// MPT_HOST_TEAM defined, so each of K7's phases runs threads 0..T-1 in turn)
// and runs them in a loop; K6's and K8's team functions run there with each
// thread a coroutine that yields at every barrier
// (tests/test_torch_mpc_single.py). `mpt_layout_linearize_team` gives the
// shared bytes a block of K6's team takes, from the kernel's own macros, to
// the host too.

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
// A lane is (step t, seed k), idx = t * m + k, H*m lanes; neighbouring
// lanes own neighbouring columns of AB at t.
#if !defined(MPT_LIN_TEAM)
// One thread a lane runs the lean one-seed body, `fd_step_jvp_group` at
// MPT_LIN_SEEDS = 1 (K2's thread body for Panda), and writes column k of AB
// at t; one warp a block, so the H*m/32 blocks spread over as many SMs.
#if MPT_LIN_SEEDS != 1
#error "K6 runs one seed a thread"
#endif
static __device__ __forceinline__ void lin_thread(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int idx) {
  const int t = idx / MPT_M, k = idx % MPT_M;
  float x[MPT_NX], u[MPT_NJ], x_next[MPT_NX], col[MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = xs[t * MPT_NX + i];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) u[j] = us[t * MPT_NJ + j];
  fd_step_jvp_group(x, u, k, x_next, col);
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) AB[((size_t)t * MPT_NX + i) * MPT_M + k] = col[i];
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_WARP) mps_lin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int H) {
  // As K2's: should the body's live values pass the 255 registers, let
  // ptxas spill to shared memory before local memory.
  asm volatile(".pragma \"enable_smem_spilling\";");
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
#else  // MPT_LIN_TEAM
// A block is one team of MPT_LIN_TEAM_W warps that owns MPT_LIN_S lanes,
// idx0 .. idx0+S-1 (idx0 = S * blockIdx.x), lane idx0 + l on lane l of every
// warp (lanes l + S, l + 2S, ... repeat lane l's work in the same columns).
// The body is the same lean one-seed body with the seed's one-hot row s as
// an input column, split by ops/cgen.py::team_function into one
// straight-line program per warp over MPT_LIN_TEAM_P phases, the team's
// named barrier between them; values that cross warps go through slots.
// Every statement keeps its text, so each lane gets the one-thread body's
// bits. Storage, in floats, each value a column of S lanes:
//   IN    nx + n + m   x_t, u_t and s (s_i = k == i ? 1 : 0) of the lane
//   COL   nx           column k of AB at t
//   SLOTS MPT_LIN_TEAM_SLOTS
// Lanes past H*m run on the last lane's index, so that they meet every
// barrier, and store nothing.
#define MPT_L_IN (MPT_NX + MPT_NJ + MPT_M)
#define MPT_L_LANE (MPT_L_IN + MPT_NX + MPT_LIN_TEAM_SLOTS)  // floats a lane
#define MPT_SMEM_MAX 232448
#define MPT_L_FITS(S) ((S) * MPT_L_LANE * 4 <= MPT_SMEM_MAX)
// Lanes a team: 32, halved until the team's storage fits a block (a robot
// with more joints has more slots: a chain of 8 takes 255488 bytes at 32).
#define MPT_LIN_S (MPT_L_FITS(32) ? 32 : MPT_L_FITS(16) ? 16 : MPT_L_FITS(8) ? 8 \
                   : MPT_L_FITS(4) ? 4 : MPT_L_FITS(2) ? 2 : 1)
#define MPT_TS MPT_LIN_S
// MPT_LIN_TEAM_STEP: the unit's writer puts the emitted team body here (its
// MPT_LIN_TEAM_* defines and warp programs), after MPT_TS.
#if !defined(MPT_LIN_TEAM_W)
#error "the emitted team body must come before K6's team"
#endif
#if !MPT_L_FITS(1)
#error "one lane's storage exceeds the shared memory a block may take"
#endif
#define MPT_LIN_THREADS (MPT_WARP * MPT_LIN_TEAM_W)
#define MPT_L_XIN 0
#define MPT_L_COL (MPT_L_IN * MPT_LIN_S)
#define MPT_L_SLOTS (MPT_L_COL + MPT_NX * MPT_LIN_S)
#define MPT_L_FLOATS (MPT_L_SLOTS + MPT_LIN_TEAM_SLOTS * MPT_LIN_S)
#define MPT_L_BYTES ((size_t)MPT_L_FLOATS * sizeof(float))
extern "C" long long mpt_layout_linearize_team(void) { return (long long)MPT_L_BYTES; }

// The team's lanes' inputs into IN, row by row (element e: row e / S of lane
// e % S), so consecutive threads fill consecutive lanes of one row.
static __device__ __forceinline__ void lin_team_load(
    int tid, float* tm, const float* __restrict__ xs, const float* __restrict__ us, int HM, int idx0) {
  for (int e = tid; e < MPT_L_IN * MPT_LIN_S; e += MPT_LIN_THREADS) {
    const int r = e / MPT_LIN_S, l = e - r * MPT_LIN_S;
    const int idx = idx0 + l < HM ? idx0 + l : HM - 1;
    const int t = idx / MPT_M, k = idx - t * MPT_M;
    float v;
    if (r < MPT_NX) v = xs[(size_t)t * MPT_NX + r];
    else if (r < MPT_NX + MPT_NJ) v = us[(size_t)t * MPT_NJ + (r - MPT_NX)];
    else v = r - MPT_NX - MPT_NJ == k ? 1.0f : 0.0f;
    tm[MPT_L_XIN + e] = v;
  }
}

// Column k of AB at t of each lane below H*m; consecutive threads store
// consecutive lanes of one row, so neighbouring addresses.
static __device__ __forceinline__ void lin_team_store(
    int tid, const float* tm, float* __restrict__ AB, int HM, int idx0) {
  for (int e = tid; e < MPT_NX * MPT_LIN_S; e += MPT_LIN_THREADS) {
    const int i = e / MPT_LIN_S, idx = idx0 + (e - i * MPT_LIN_S);
    if (idx < HM) {
      const int t = idx / MPT_M, k = idx - t * MPT_M;
      AB[((size_t)t * MPT_NX + i) * MPT_M + k] = tm[MPT_L_COL + e];
    }
  }
}

// Lanes idx0 .. idx0+S-1 by thread `tid` of their team (barrier 1).
static __device__ __forceinline__ void lin_team(
    int tid, float* tm, const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int HM, int idx0) {
  const int w = tid / MPT_WARP, ln = tid % MPT_LIN_S;
  lin_team_load(tid, tm, xs, us, HM, idx0);
  mpt_team_sync(1, MPT_LIN_THREADS);
  mpt_lin_team(w, 1, tm + MPT_L_XIN + ln, tm + MPT_L_COL + ln, tm + MPT_L_SLOTS + ln);
  mpt_team_sync(1, MPT_LIN_THREADS);
  lin_team_store(tid, tm, AB, HM, idx0);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_LIN_THREADS) mps_lin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int H) {
  extern __shared__ float mpt_team_smem[];
  lin_team((int)threadIdx.x, mpt_team_smem, xs, us, AB, H * MPT_M, (int)blockIdx.x * MPT_LIN_S);
}

// xs (H, nx), us (H, n) -> AB (H, nx, m). One team a block of S lanes; its
// storage is dynamic shared memory, whose limit is raised once per device.
extern "C" int launch_linearize(const float* xs, const float* us, float* AB,
                                int H, void* stream) {
  static bool raised[64];
  if (H <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(mps_lin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MPT_L_BYTES);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const unsigned int blocks = (unsigned int)((H * MPT_M + MPT_LIN_S - 1) / MPT_LIN_S);
  mps_lin_kernel<<<blocks, MPT_LIN_THREADS, MPT_L_BYTES, (cudaStream_t)stream>>>(xs, us, AB, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linearize, mps_lin_kernel)

// K6's team: warps, lanes a team, teams a block, phases, slots, and the
// dynamic shared bytes of a block.
extern "C" int team_linearize(int* out) {
  out[0] = MPT_LIN_TEAM_W;
  out[1] = MPT_LIN_S;
  out[2] = 1;
  out[3] = MPT_LIN_TEAM_P;
  out[4] = MPT_LIN_TEAM_SLOTS;
  out[5] = (int)MPT_L_BYTES;
  return 0;
}
#endif
#endif  // MPT_LIN_TEAM
#endif  // MPT_UNIT_LIN

// ---------------------------------------------------------------- K7 -----
#if defined(MPT_UNIT_BWD)
// One block of MPT_BWD_THREADS threads runs the one problem's sweep,
// t = H-1 ... 0. Its state (`mps_bwd_state`) lives in static shared memory,
// none on the stack, and each Riccati step is a sequence of phases with
// `__syncthreads()` between them:
//   1. Qx = lx + Vx A, Qu = lu + Vx B, and VAB = Vxx [A | B] (one interval:
//      both read V and [A | B] only);
//   2. Qxx, Quu and Qux, each entry in full: Qxx[i][k] and Qxx[k][i] are
//      different sums with different bits, and Vxx' reads both;
//   3. Gauss-Jordan over the augmented rows [Quu | Qu | Qux], one phase per
//      pivot p (`_gj_solve_rows`: only columns > p), reading one of two
//      buffers and writing the other; the last pivot writes the gains
//      k = -sol[:, 0], K = -sol[:, 1:] to shared memory and to kK[t];
//   4. Quu k and K^T Quu;
//   5. Vx' and the symmetrised Vxx' = 0.5 (full + full^T); step t-1's
//      [A | B], x and u, loaded into registers while step t computed, go to
//      shared memory here.
// Every output entry of a phase belongs to one thread (round robin, e = tid,
// tid + T, ...), which takes the entry's whole sum in `riccati_step_gj`'s
// order (the first term, then left to right), so each entry gets the plain
// version's IEEE operations and, with --fmad=false, its bits. Each thread of
// a pivot forms 1 / aug[p][p] and the scaled pivot row entry it needs itself:
// the same operations, so the same bits, and one barrier a pivot. The
// generated part of the unit gives MPT_BWD_2WX (2 w_x, nx) and MPT_BWD_2WU
// (2 w_u). Where a weight is exactly 0 the plain version folds its term away
// and the kernel multiplies by 0; the two differ only for a non-finite input
// or in the sign of a zero.
//
// Bound: one problem, so neither bytes nor operations come near the card's
// rates; a step's time is its phases' dependent chains (14-term sums, one
// reciprocal and a multiply-subtract per pivot) and 4 + n barriers. The
// wrapper builds 256 threads a block: with 128, phases 1 and 2 take three
// rounds instead of two, the kernel is slower, and ptxas keeps one register
// on the stack around the division's slow-path call (PERF.md).
#ifndef MPT_BWD_THREADS
#error "MPT_BWD_THREADS must be defined before mpc_single.cuh"
#endif
#define MPT_T MPT_BWD_THREADS
#define MPT_AB (MPT_NX * MPT_M)               // [A | B] of one step
#define MPT_UPPER (MPT_NX * (MPT_NX + 1) / 2)  // upper triangle of nx x nx
#define MPT_KKN (MPT_NJ * MPT_KK)             // gains of one step
#define MPT_AUG (MPT_NJ + MPT_KK)             // augmented row: Quu, Qu, Qux
#define MPT_STEP_IN (MPT_AB + MPT_NX + MPT_NJ)  // a step's inputs: [A | B], x, u
#define MPT_ROUNDS(count) (((count) + MPT_T - 1) / MPT_T)
#define MPT_PRE MPT_ROUNDS(MPT_STEP_IN)      // registers a thread prefetches into

// The block's storage (Panda: 1709 floats, 6836 bytes). Row-major matrices.
struct mps_bwd_state {
  float V[MPT_VN];   // Vxx rows, then Vx: of step t+1, of step t after phase 5
  float ab[MPT_AB];  // row i: A_t[i, :], then B_t[i, :]
  float x[MPT_NX], u[MPT_NJ], g[MPT_NJ];
  float Qx[MPT_NX], Qu[MPT_NJ];
  float Qxx[MPT_NX * MPT_NX], Quu[MPT_NJ * MPT_NJ], Qux[MPT_NJ * MPT_NX];
  float VAB[MPT_AB];                 // Vxx [A | B]: VA, then VB, per row
  float aug[2][MPT_NJ * MPT_AUG];    // Gauss-Jordan, ping-pong
  float kk[MPT_KKN];                 // k_j, then row j of K
  float Quu_k[MPT_NJ], KtQuu[MPT_NX * MPT_NJ];
  float reg;
};

// Entry e of the upper triangle, row by row: (i, k) with k >= i.
static __device__ __forceinline__ void mps_upper(int e, int* i, int* k) {
  int r = 0;
  while (e >= MPT_NX - r) {
    e -= MPT_NX - r;
    ++r;
  }
  *i = r;
  *k = r + e;
}

// Entry e of a step's inputs: [A | B] (row-major), then x, then u.
static __device__ __forceinline__ float bwd_step_input(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, int t, int e) {
  if (e < MPT_AB) return AB[(size_t)t * MPT_AB + e];
  if (e < MPT_AB + MPT_NX) return xs[(size_t)t * MPT_NX + (e - MPT_AB)];
  return us[(size_t)t * MPT_NJ + (e - MPT_AB - MPT_NX)];
}

static __device__ __forceinline__ void bwd_store_input(mps_bwd_state* s, int e, float v) {
  if (e < MPT_AB) s->ab[e] = v;
  else if (e < MPT_AB + MPT_NX) s->x[e - MPT_AB] = v;
  else s->u[e - MPT_AB - MPT_NX] = v;
}

// The terminal value function, the goal, reg and step H-1's inputs.
static __device__ __forceinline__ void bwd_start(
    int tid, mps_bwd_state* s, const float* __restrict__ AB,
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ goal, const float* __restrict__ Vterm,
    const float* __restrict__ reg, int H) {
  for (int e = tid; e < MPT_VN + MPT_NJ + 1 + MPT_STEP_IN; e += MPT_T) {
    if (e < MPT_VN) s->V[e] = Vterm[e];
    else if (e < MPT_VN + MPT_NJ) s->g[e - MPT_VN] = goal[e - MPT_VN];
    else if (e == MPT_VN + MPT_NJ) s->reg = reg[0];
    else {
      const int f = e - (MPT_VN + MPT_NJ + 1);
      bwd_store_input(s, f, bwd_step_input(AB, xs, us, H - 1, f));
    }
  }
}

// Step t's inputs into the thread's registers (issued a step ahead of use).
static __device__ __forceinline__ void bwd_prefetch(
    int tid, float* pre, const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, int t) {
#pragma unroll
  for (int r = 0; r < MPT_PRE; ++r) {
    const int e = tid + r * MPT_T;
    if (e < MPT_STEP_IN) pre[r] = bwd_step_input(AB, xs, us, t, e);
  }
}

static __device__ __forceinline__ void bwd_commit(int tid, mps_bwd_state* s, const float* pre) {
#pragma unroll
  for (int r = 0; r < MPT_PRE; ++r) {
    const int e = tid + r * MPT_T;
    if (e < MPT_STEP_IN) bwd_store_input(s, e, pre[r]);
  }
}

// Phase 1: entry e < m is column e of Vx [A | B], giving Qx or Qu (Qu also
// into column n of the augmented rows); the rest is VAB, row k, column c.
static __device__ __forceinline__ void bwd_gradients_products(int tid, mps_bwd_state* s) {
  for (int e = tid; e < MPT_M + MPT_AB; e += MPT_T) {
    const float* Vk;
    int c;
    if (e < MPT_M) {
      Vk = s->V + MPT_NX * MPT_NX;
      c = e;
    } else {
      const int f = e - MPT_M, k = f / MPT_M;
      Vk = s->V + k * MPT_NX;
      c = f - k * MPT_M;
    }
    float acc = Vk[0] * s->ab[c];
#pragma unroll
    for (int l = 1; l < MPT_NX; ++l) acc = acc + Vk[l] * s->ab[l * MPT_M + c];
    if (e >= MPT_M) {
      s->VAB[e - MPT_M] = acc;
    } else if (e < MPT_NJ) {
      s->Qx[e] = MPT_BWD_2WX[e] * (s->x[e] - s->g[e]) + acc;
    } else if (e < MPT_NX) {
      s->Qx[e] = MPT_BWD_2WX[e] * s->x[e] + acc;  // goal velocity 0
    } else {
      const int j = e - MPT_NX;
      const float q = MPT_BWD_2WU * s->u[j] + acc;
      s->Qu[j] = q;
      s->aug[0][j * MPT_AUG + MPT_NJ] = q;
    }
  }
}

// Phase 2: Q[r][c] = sum_l [A | B][l][r] VAB[l][c] over all of Qxx (+ 2 w_x
// on its diagonal), Quu (+ (2 w_u + reg) on its diagonal) and Qux; Quu and
// Qux also into the augmented rows.
static __device__ __forceinline__ void bwd_q_blocks(int tid, mps_bwd_state* s) {
  const float diag_u = MPT_BWD_2WU + s->reg;
  for (int e = tid; e < MPT_NX * MPT_NX + MPT_NJ * MPT_NJ + MPT_NJ * MPT_NX; e += MPT_T) {
    int r, c;
    if (e < MPT_NX * MPT_NX) {
      r = e / MPT_NX;
      c = e - r * MPT_NX;
    } else if (e < MPT_NX * MPT_NX + MPT_NJ * MPT_NJ) {
      const int f = e - MPT_NX * MPT_NX;
      r = MPT_NX + f / MPT_NJ;
      c = MPT_NX + f % MPT_NJ;
    } else {
      const int f = e - MPT_NX * MPT_NX - MPT_NJ * MPT_NJ;
      r = MPT_NX + f / MPT_NX;
      c = f % MPT_NX;
    }
    float acc = s->ab[r] * s->VAB[c];
#pragma unroll
    for (int l = 1; l < MPT_NX; ++l) acc = acc + s->ab[l * MPT_M + r] * s->VAB[l * MPT_M + c];
    if (r < MPT_NX) {
      if (r == c) acc = acc + MPT_BWD_2WX[r];
      s->Qxx[e] = acc;
    } else if (c >= MPT_NX) {
      const int j = r - MPT_NX, j2 = c - MPT_NX;
      if (j == j2) acc = acc + diag_u;
      s->Quu[j * MPT_NJ + j2] = acc;
      s->aug[0][j * MPT_AUG + j2] = acc;
    } else {
      const int j = r - MPT_NX;
      s->Qux[j * MPT_NX + c] = acc;
      s->aug[0][j * MPT_AUG + MPT_NJ + 1 + c] = acc;
    }
  }
}

// Phase 3, pivot p: columns c > p of every row from buffer p % 2 into the
// other. Row p takes aug[p][c] / aug[p][p] (as aug[p][c] * (1 / aug[p][p])),
// every other row aug[r][c] - aug[r][p] row_p[c]. No pivot is guarded, as in
// `_gj_solve`. At the last pivot the columns left are the solution, entry e
// is kk[e] (k_j, then row j of K) and the thread stores its negation.
static __device__ __forceinline__ void bwd_gj_pivot(
    int tid, mps_bwd_state* s, int p, float* __restrict__ kK, int t) {
  const float* src = s->aug[p & 1];
  float* dst = s->aug[(p + 1) & 1];
  const int width = MPT_AUG - p - 1;
  const float inv = 1.0f / src[p * MPT_AUG + p];
  for (int e = tid; e < MPT_NJ * width; e += MPT_T) {
    const int r = e / width, c = p + 1 + (e - r * width);
    const float row_p = src[p * MPT_AUG + c] * inv;
    const float v = r == p ? row_p : src[r * MPT_AUG + c] - src[r * MPT_AUG + p] * row_p;
    if (p == MPT_NJ - 1) {
      s->kk[e] = -v;
      kK[(size_t)t * MPT_KKN + e] = -v;
    } else {
      dst[r * MPT_AUG + c] = v;
    }
  }
}

// Phase 4: Quu k, then K^T Quu.
static __device__ __forceinline__ void bwd_gain_products(int tid, mps_bwd_state* s) {
  const float* kk = s->kk;
  for (int e = tid; e < MPT_NJ + MPT_NX * MPT_NJ; e += MPT_T) {
    if (e < MPT_NJ) {
      float acc = s->Quu[e * MPT_NJ] * kk[0];
#pragma unroll
      for (int j2 = 1; j2 < MPT_NJ; ++j2) acc = acc + s->Quu[e * MPT_NJ + j2] * kk[j2 * MPT_KK];
      s->Quu_k[e] = acc;
    } else {
      const int f = e - MPT_NJ, i = f / MPT_NJ, j2 = f % MPT_NJ;
      float acc = kk[1 + i] * s->Quu[j2];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) acc = acc + kk[j * MPT_KK + 1 + i] * s->Quu[j * MPT_NJ + j2];
      s->KtQuu[i * MPT_NJ + j2] = acc;
    }
  }
}

// Entry (i, k) of Vxx' before symmetrisation:
// ((Qxx[i][k] + (K^T Quu K)[i][k]) + (K^T Qux)[i][k]) + (Qux^T K)[i][k].
static __device__ __forceinline__ float bwd_value_entry(const mps_bwd_state* s, int i, int k) {
  const float* kk = s->kk;  // K[j][i] = kk[j * MPT_KK + 1 + i]
  float a = s->KtQuu[i * MPT_NJ] * kk[1 + k];
#pragma unroll
  for (int j = 1; j < MPT_NJ; ++j) a = a + s->KtQuu[i * MPT_NJ + j] * kk[j * MPT_KK + 1 + k];
  float b = kk[1 + i] * s->Qux[k];
#pragma unroll
  for (int j = 1; j < MPT_NJ; ++j) b = b + kk[j * MPT_KK + 1 + i] * s->Qux[j * MPT_NX + k];
  float c = s->Qux[i] * kk[1 + k];
#pragma unroll
  for (int j = 1; j < MPT_NJ; ++j) c = c + s->Qux[j * MPT_NX + i] * kk[j * MPT_KK + 1 + k];
  return ((s->Qxx[i * MPT_NX + k] + a) + b) + c;
}

// Phase 5: Vx' = (Qx + K^T (Quu k + Qu)) + Qux^T k, and the upper triangle of
// Vxx' = 0.5 (full + full^T), mirrored, into V.
static __device__ __forceinline__ void bwd_value_update(int tid, mps_bwd_state* s) {
  const float* kk = s->kk;
  for (int e = tid; e < MPT_NX + MPT_UPPER; e += MPT_T) {
    if (e < MPT_NX) {
      float a = (s->Quu_k[0] + s->Qu[0]) * kk[1 + e];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) a = a + (s->Quu_k[j] + s->Qu[j]) * kk[j * MPT_KK + 1 + e];
      float b = kk[0] * s->Qux[e];
#pragma unroll
      for (int j = 1; j < MPT_NJ; ++j) b = b + kk[j * MPT_KK] * s->Qux[j * MPT_NX + e];
      s->V[MPT_NX * MPT_NX + e] = (s->Qx[e] + a) + b;
    } else {
      int i, k;
      mps_upper(e - MPT_NX, &i, &k);
      const float ik = bwd_value_entry(s, i, k);
      const float ki = i == k ? ik : bwd_value_entry(s, k, i);
      const float v = 0.5f * (ik + ki);
      s->V[i * MPT_NX + k] = v;
      s->V[k * MPT_NX + i] = v;
    }
  }
}

// A phase: on the card the calling thread runs it and the block meets at
// __syncthreads(); in the host harness (MPT_HOST_TEAM) threads 0..T-1 run it
// one after the other before the next phase, each with its own registers.
// MPT_EACH is a phase without the barrier.
#if defined(MPT_HOST_TEAM)
#define MPT_EACH(call)                                   \
  do {                                                   \
    for (int tid = 0; tid < MPT_T; ++tid) { call; }      \
  } while (0)
#define MPT_PHASE(call) MPT_EACH(call)
#define MPT_PRE_OF(tid) pre[tid]
#define MPT_PRE_DECL float pre[MPT_T][MPT_PRE]
#else
#define MPT_EACH(call)        \
  do {                        \
    const int tid = my_tid;   \
    call;                     \
  } while (0)
#define MPT_PHASE(call) \
  do {                  \
    MPT_EACH(call);     \
    __syncthreads();    \
  } while (0)
#define MPT_PRE_OF(tid) pre
#define MPT_PRE_DECL float pre[MPT_PRE]
#endif

// The whole sweep, t = H-1 ... 0, by the block whose thread this is; no
// thread leaves before the end.
static __device__ __forceinline__ void bwd_sweep(
    int my_tid, mps_bwd_state* s, const float* __restrict__ AB,
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ goal, const float* __restrict__ Vterm,
    const float* __restrict__ reg, float* __restrict__ kK, int H) {
  MPT_PRE_DECL;
  (void)my_tid;
  MPT_PHASE(bwd_start(tid, s, AB, xs, us, goal, Vterm, reg, H));
  for (int t = H - 1; t >= 0; --t) {
    if (t > 0) MPT_EACH(bwd_prefetch(tid, MPT_PRE_OF(tid), AB, xs, us, t - 1));
    MPT_PHASE(bwd_gradients_products(tid, s));
    MPT_PHASE(bwd_q_blocks(tid, s));
#pragma unroll
    for (int p = 0; p < MPT_NJ; ++p) MPT_PHASE(bwd_gj_pivot(tid, s, p, kK, t));
    MPT_PHASE(bwd_gain_products(tid, s));
    // [A | B], x and u are last read in phase 2: step t-1's may land now.
    if (t > 0) MPT_EACH(bwd_commit(tid, s, MPT_PRE_OF(tid)));
    MPT_PHASE(bwd_value_update(tid, s));
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BWD_THREADS) mps_bwd_block_kernel(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ goal,
    const float* __restrict__ Vterm, const float* __restrict__ reg,
    float* __restrict__ kK, int H) {
  __shared__ mps_bwd_state state;
  bwd_sweep((int)threadIdx.x, &state, AB, xs, us, goal, Vterm, reg, kK, H);
}

// AB (H, nx, m), xs (H, nx), us (H, n), goal (n), Vterm (nx+1, nx),
// reg (1) -> kK (H, n, 1+nx). One block of MPT_BWD_THREADS threads.
extern "C" int launch_backward(const float* AB, const float* xs,
                               const float* us, const float* goal,
                               const float* Vterm, const float* reg, float* kK,
                               int H, void* stream) {
  if (H <= 0) return 0;
  mps_bwd_block_kernel<<<1, MPT_BWD_THREADS, 0, (cudaStream_t)stream>>>(
      AB, xs, us, goal, Vterm, reg, kK, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_backward, mps_bwd_block_kernel)
#endif
#endif  // MPT_UNIT_BWD

// ---------------------------------------------------------------- K8 -----
#if defined(MPT_UNIT_FWD)
#if !defined(MPT_FWD_TEAM_W) || !defined(MPT_TS)
#error "the emitted team step must come before K8"
#endif
// A block is one team of MPT_FWD_TEAM_W warps that rolls alphas a0 .. a0+31
// (a0 = 32 * blockIdx.x), alpha a0 + l on lane l of every warp (lanes past A
// repeat the last alpha in their own columns, and store nothing). Each step
// is the emitted team step `mpt_fwd_team` (ops/cgen.py::team_function):
// warp w runs its own straight-line program over MPT_FWD_TEAM_P phases, the
// block's barrier between them; values that cross warps go through slots.
// Storage, in floats; per-alpha values are columns of 32 lanes, the rows
// (sd_x, sd_u, kK of a step) and the goal one copy that every lane reads:
//   XIN   2 x nx x 32  the state of step t in buffer t & 1
//   ROWS  2 x ROWN     step t's rows in buffer t & 1 (cp.async)
//   GOAL  n
//   OB    2 x (n+1) x 32  u, then the running cost, of step t in buffer t & 1
//   SLOTS MPT_FWD_TEAM_SLOTS x 32
#define MPT_ROWN (MPT_NX + MPT_NJ + MPT_NJ * MPT_KK)
#define MPT_TEAM_THREADS (MPT_WARP * MPT_FWD_TEAM_W)
#define MPT_T_XIN 0
#define MPT_T_ROWS (2 * MPT_NX * MPT_WARP)
#define MPT_T_GOAL (MPT_T_ROWS + 2 * MPT_ROWN)
#define MPT_T_OB (MPT_T_GOAL + MPT_NJ)
#define MPT_T_SLOTS (MPT_T_OB + 2 * (MPT_NJ + 1) * MPT_WARP)
#define MPT_T_FLOATS (MPT_T_SLOTS + MPT_FWD_TEAM_SLOTS * MPT_WARP)
#define MPT_T_BYTES ((size_t)MPT_T_FLOATS * sizeof(float))

// x0 into every lane's column of XIN buffer 0, and the goal.
static __device__ __forceinline__ void fwd_team_init(
    int tid, float* tm, const float* __restrict__ x0, const float* __restrict__ goal) {
  for (int e = tid; e < MPT_NX * MPT_WARP + MPT_NJ; e += MPT_TEAM_THREADS) {
    if (e < MPT_NX * MPT_WARP) tm[MPT_T_XIN + e] = x0[e / MPT_WARP];
    else tm[MPT_T_GOAL + e - MPT_NX * MPT_WARP] = goal[e - MPT_NX * MPT_WARP];
  }
}

// Step t's rows into ROWS buffer t & 1, one group of copies.
static __device__ __forceinline__ void fwd_team_rows(
    int tid, float* tm, const float* __restrict__ sd_x, const float* __restrict__ sd_u,
    const float* __restrict__ kK, int t) {
  float* dst = tm + MPT_T_ROWS + (t & 1) * MPT_ROWN;
  for (int k = tid; k < MPT_ROWN; k += MPT_TEAM_THREADS) {
    const float* src;
    if (k < MPT_NX) src = sd_x + (size_t)t * MPT_NX + k;
    else if (k < MPT_NX + MPT_NJ) src = sd_u + (size_t)t * MPT_NJ + (k - MPT_NX);
    else src = kK + (size_t)t * MPT_NJ * MPT_KK + (k - MPT_NX - MPT_NJ);
    mpt_team_copy(dst + k, src, true);
  }
  mpt_team_commit();
}

// Step t's post-step states and controls of alphas a0 .. a0+31 to xs[a, t]
// and us[a, t]; thread l < 32 adds alpha a0 + l's running cost to its sum.
static __device__ __forceinline__ void fwd_team_store(
    int tid, const float* tm, float* __restrict__ xs, float* __restrict__ us, float* acc,
    int H, int A, int a0, int t) {
  const float* x_next = tm + MPT_T_XIN + ((t + 1) & 1) * MPT_NX * MPT_WARP;
  const float* ob = tm + MPT_T_OB + (t & 1) * (MPT_NJ + 1) * MPT_WARP;
  for (int e = tid; e < (MPT_NX + MPT_NJ) * MPT_WARP; e += MPT_TEAM_THREADS) {
    const int l = e / (MPT_NX + MPT_NJ), k = e % (MPT_NX + MPT_NJ);
    if (a0 + l < A) {
      const size_t row = (size_t)(a0 + l) * H + t;
      if (k < MPT_NX) xs[row * MPT_NX + k] = x_next[k * MPT_WARP + l];
      else us[row * MPT_NJ + (k - MPT_NX)] = ob[(k - MPT_NX) * MPT_WARP + l];
    }
  }
  if (tid < MPT_WARP) *acc = *acc + ob[MPT_NJ * MPT_WARP + tid];
}

// Thread l < 32: alpha a0 + l's terminal cost, added to its running sum.
static __device__ __forceinline__ void fwd_team_finish(
    int tid, const float* tm, float acc, float* __restrict__ costs, int H, int A, int a0) {
  if (tid < MPT_WARP && a0 + tid < A) {
    const float* xin = tm + MPT_T_XIN + (H & 1) * MPT_NX * MPT_WARP;
    float x[MPT_NX], g[MPT_NJ], c[1];
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) x[i] = xin[i * MPT_WARP + tid];
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) g[j] = tm[MPT_T_GOAL + j];
    mpc_terminal_fused(x, g, c);
    costs[a0 + tid] = acc + c[0];
  }
}

// The closed loops of alphas a0 .. a0+31 by thread `tid` of the block's
// team (barrier 1). Step t+1's rows are on their way while step t runs;
// the team meets after the step's last phase, once they have landed.
static __device__ __forceinline__ void fwd_team(
    int tid, float* tm, const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ costs,
    int H, int A, int a0) {
  const int w = tid / MPT_WARP, l = tid % MPT_WARP;
  const float alpha = alphas[a0 + l < A ? a0 + l : A - 1];
  float acc = 0.0f;
  fwd_team_init(tid, tm, x0, goal);
  fwd_team_rows(tid, tm, sd_x, sd_u, kK, 0);
  mpt_team_wait_all();
  mpt_team_sync(1, MPT_TEAM_THREADS);
  for (int t = 0; t < H; ++t) {
    if (t + 1 < H) fwd_team_rows(tid, tm, sd_x, sd_u, kK, t + 1);
    mpt_fwd_team(w, 1, tm + MPT_T_XIN + (t & 1) * MPT_NX * MPT_WARP + l,
                 tm + MPT_T_ROWS + (t & 1) * MPT_ROWN, tm + MPT_T_GOAL,
                 tm + MPT_T_OB + (t & 1) * (MPT_NJ + 1) * MPT_WARP + l,
                 tm + MPT_T_XIN + ((t + 1) & 1) * MPT_NX * MPT_WARP + l,
                 tm + MPT_T_SLOTS + l, alpha);
    mpt_team_wait_all();
    mpt_team_sync(1, MPT_TEAM_THREADS);
    fwd_team_store(tid, tm, xs, us, &acc, H, A, a0, t);
  }
  fwd_team_finish(tid, tm, acc, costs, H, A, a0);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_TEAM_THREADS) mps_fwd_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ costs,
    int H, int A) {
  extern __shared__ float mpt_team_smem[];
  fwd_team((int)threadIdx.x, mpt_team_smem, x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, A,
           (int)blockIdx.x * MPT_WARP);
}

// x0 (nx), sd_x (H, nx), sd_u (H, n), kK (H, n, 1+nx), goal (n),
// alphas (A) -> xs (A, H, nx), us (A, H, n), costs (A). One team a block
// of 32 alphas; its storage is dynamic shared memory, whose limit is
// raised once per device.
extern "C" int launch_forward(const float* x0, const float* sd_x,
                              const float* sd_u, const float* kK,
                              const float* goal, const float* alphas, float* xs,
                              float* us, float* costs, int H, int A,
                              void* stream) {
  static bool raised[64];
  if (H <= 0 || A <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(mps_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MPT_T_BYTES);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const unsigned int blocks = (unsigned int)((A + MPT_WARP - 1) / MPT_WARP);
  mps_fwd_kernel<<<blocks, MPT_TEAM_THREADS, MPT_T_BYTES, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, A);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_forward, mps_fwd_kernel)

// K8's team: warps, alphas a team, teams a block, phases a step, slots, and
// the dynamic shared bytes of a block.
extern "C" int team_forward(int* out) {
  out[0] = MPT_FWD_TEAM_W;
  out[1] = MPT_WARP;
  out[2] = 1;
  out[3] = MPT_FWD_TEAM_P;
  out[4] = MPT_FWD_TEAM_SLOTS;
  out[5] = (int)MPT_T_BYTES;
  return 0;
}
#endif
#endif  // MPT_UNIT_FWD
