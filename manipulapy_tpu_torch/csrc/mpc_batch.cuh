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
//          or, K2's looped form, one unit per (n, G) for every robot of n
//          joints: MPT_LIN_LOOP, the table's layout, csrc/fd_step_loop.cuh
//          and csrc/fd_step_loop_jvp.cuh (ops/cuda_mpc_batch.py::
//          lin_loop_unit_source), the robot's table a kernel argument;
//     BWD: riccati_terminal, riccati_step;
//     FWD: mpc_fwd_step, mpc_terminal (K4 and K5 run the same
//          fwd_rollout); or, their looped form, one unit per n for every
//          robot of n joints: MPT_FWD_LOOP, the table's layout and
//          csrc/fd_step_loop.cuh (ops/cuda_mpc_batch.py::
//          fwd_loop_unit_source), the robot's table and cost weights a
//          kernel argument; with MPT_REPLAY_TEAM, K5's variant unit, also
//          MPT_TEAM_S_MAX <scenarios a team>, MPT_TEAM_PER_BLOCK <teams a
//          block> and the step split over a team of warps (mpt_fwd_team,
//          with ops/cgen.py::TEAM_SOURCE);
//   this file.
// The three units build in parallel, one nvcc each.
//
// Layout. Every tensor is scenario-minor, (..., B), so the threads of a
// warp, which own neighbouring scenarios, touch neighbouring addresses:
//   xs (H, nx, B), us (H, n, B), AB (H, nx, m, B), kK (H, n, 1+nx, B),
//   x0 / x_last (nx, B), goal (n, B), reg / alpha / cost (B), costs (A, B),
//   and K4's trajectories of every alpha, xs_all (H, nx, A, B) and us_all
//   (H, n, A, B): the plain version's layout, the alpha between the row and
//   the scenario, so each store is one coalesced row of B.
// There is no padding: every kernel guards `b < B`. The TPU's (8, 128)
// tiles and its sequential grid axes are gone: a loop inside one thread
// takes the place of a sequential axis, and of the VMEM scratch it carried.
//
// Bound and design, per kernel (statement counts are the emitter's, Panda):
//   K2: (the emitted form; the looped form's design is in
//       csrc/fd_step_loop_jvp.cuh: groups of one seed kind, 2n/G + 1 of
//       them, the robot in a __grid_constant__ table)
//       one thread per (scenario b, group of G = MPT_LIN_SEEDS seeds, step
//       t), B*(m/G)*H independent threads in blocks of MPT_LIN_BLOCK; each
//       runs the primal step once and the tangents of seeds gG .. gG+G-1
//       and writes those G columns of AB at t. Operations bound it (Panda,
//       G = 1: ~13k statements against 4*(3n + 2n) bytes per thread). The
//       primal and G tangents live at once: the body is emitted in an order
//       that holds fewer values (ops/fd_step.py, `lean`), about (1 + G) x
//       115 at its peak for Panda, against 255 registers. At G = 3 Panda's
//       thread spills (1560 local bytes; ~30k statements against 3 x 13k)
//       and takes 1.7x as long as at G = 1, which spills nothing; UR5's
//       fits (40 local bytes) and is 19-24% faster at G = 3 than at 1, so G
//       comes from the joints (ops/cuda_mpc_batch.py::lin_seeds; ptxas -O1
//       and its shared-memory spilling, PERF.md section 6).
//   K3: one warp per scenario, MPT_BWD_WARPS = 4 scenarios a block, so
//       B/4 blocks (256 at B=1024, about two per SM). t = H-1 ... 0 stays
//       inside the warp; its state (value function, [A | B] of step t, the
//       Q blocks, the Cholesky factor, the gains) lives in the warp's own
//       region of dynamic shared memory (a block's grows with n: 19056
//       bytes for Panda, 54736 at n = 12, past the 48 KB a block may
//       declare statically), none on the stack. A step is seven phases
//       over the lanes (see the K3 section); each entry's sum stays in one
//       lane in the emitter's order. AB, xs and us of step t-1 are loaded
//       into registers while step t computes. Operations set its least time
//       (~26k statements per step); a step's dependent chain is its
//       phases' longest sums. From B=4096 on, shared-memory loads (both
//       operands of every product) most likely bound it (PERF.md).
//   K4: one thread per (scenario, alpha), the closed-loop rollout with the
//       step inlined, in blocks of MPT_BLOCK; `linesearch` also stores each
//       step's post-step state and control (21 floats a step for Panda,
//       coalesced), so the solver selects the chosen alpha's trajectory
//       and replays nothing.
//   K5: one thread per scenario with its own alpha, the same fwd_rollout,
//       streaming out xs, us and the cost; the solver runs it once, for
//       the initial rollout. Its variant unit (MPT_REPLAY_TEAM) runs a team
//       of MPT_FWD_TEAM_W warps per MPT_TEAM_S scenarios (on the lanes):
//       each closed-loop step is the emitted step partitioned into one
//       straight-line program per warp (ops/cgen.py::team_function), the
//       team's named barrier between phases, values that cross warps in
//       shared-memory slots; the split doubles the code (~12k instructions
//       over 8 warps for Panda) and was 1.3-3.2x slower than one thread.
//   K4 and K5 take one of two forms, one unit for both: the emitted step
//   (mpc_fwd_step), or with MPT_FWD_LOOP the looped step (fd_step_loop,
//   the robot, its torque bounds and the cost weights in the launch's
//   table; one unit per joint count). Two regimes bound them (H100, B=1024,
//   H=50, 6 alphas; PERF.md section 5):
//     - below ~6k statements of the emitted step, latency: K4's 48 blocks
//       of 128 threads (K5's 8) leave each SM at most one warp a
//       scheduler, each thread 50 dependent steps, so nothing hides an
//       instruction's latency; K4 runs at ~0.1 ms per 1000 statements,
//       ~10x its operations' bound. The looped step does ~15% more
//       operations with fewer registers (151-168 against 165-255) and is
//       1.1-1.35x slower there: a third block an SM has no warp to give.
//     - past it, the instruction fetch: the emitted kernels' 7.8k-14.8k
//       SASS instructions outgrow what an SM caches and its rate falls by
//       up to half (Gen3, Jaco, 10-joint Jaco). The looped step's
//       3.1k-5.2k stay inside, back at the latency-bound rate: 0.78x the
//       emitted time on the Gen3, 0.48x on the Jaco chain, 0.44x on the
//       10-joint Jaco.
//   ops/cuda_mpc_batch.py::fwd_form routes each joint count by the
//   emitted statements to the faster form.
// Every kernel is built with --fmad=false and the emitter's order of
// operations, so each agrees bitwise with its plain PyTorch version.
//
// The per-thread bodies (`*_thread`) are plain functions of the scenario
// index, and K3's phases plain functions of the lane: a host harness
// compiles this file with `__device__` defined away (and MPT_HOST_TEAM
// defined, so each of K3's phases runs lanes 0..31 in turn) and runs them in
// a loop; K5's team variant runs there with each thread a coroutine that
// yields at every barrier (tests/test_torch_mpc_batch.py). The `mpt_layout_*`
// functions give the shared bytes a block takes, from the same macros and
// types as the kernels, to the host too.

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
#error "MPT_LIN_SEEDS and MPT_LIN_BLOCK must be defined with K2's step"
#endif

#ifdef MPT_LIN_LOOP
// The looped form (csrc/fd_step_loop_jvp.cuh): the robot is the table, a
// kernel argument; groups of one seed kind (q, dq: G a thread; tau: all n).
#define MPT_LIN_GROUPS MPT_LOOP_GROUPS
#define MPT_LIN_TABLE , const float* __restrict__ tab
#define MPT_LIN_TABLE_ARG , tab.v

// Thread (b, grp, t): the step at (x, u) of scenario b, step t, and the
// columns of group grp's seeds, each stored as it is made.
static __device__ __forceinline__ void lin_thread(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int B, int b, int grp, int t MPT_LIN_TABLE) {
  float x[MPT_NX], u[MPT_NJ];
#pragma unroll
  for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(xs, t * MPT_NX + i, b, B);
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) u[j] = MPT_AT(us, t * MPT_NJ + j, b, B);
  const size_t row0 = (size_t)t * MPT_NX * MPT_M;
  fd_step_loop_jvp(x, u, grp, tab, [&](int s, int i, float v) {
    MPT_AT(AB, row0 + (size_t)i * MPT_M + s, b, B) = v;
  });
}
#else
#if MPT_M % MPT_LIN_SEEDS != 0
#error "MPT_LIN_SEEDS must divide the 3n seeds"
#endif
#define MPT_LIN_GROUPS (MPT_M / MPT_LIN_SEEDS)
#define MPT_LIN_TABLE
#define MPT_LIN_TABLE_ARG

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
#endif

#ifdef __CUDACC__
#ifdef MPT_LIN_LOOP
// The robot's table, by value: it lives in the launch's parameter space.
struct MptTable {
  float v[MPT_TAB_FLOATS];
};
#define MPT_LIN_KERNEL_TABLE , const __grid_constant__ MptTable tab
#define MPT_LIN_LAUNCH_TABLE , const float* table
#else
#define MPT_LIN_KERNEL_TABLE
#define MPT_LIN_LAUNCH_TABLE
#endif

__global__ void __launch_bounds__(MPT_LIN_BLOCK) mpt_lin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ AB, int B MPT_LIN_KERNEL_TABLE) {
  // The body's live values exceed the 255 registers a thread may hold; let
  // ptxas spill part of them to shared memory before local memory.
  asm volatile(".pragma \"enable_smem_spilling\";");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lin_thread(xs, us, AB, B, b, (int)blockIdx.y, (int)blockIdx.z MPT_LIN_TABLE_ARG);
}

// xs (H, nx, B), us (H, n, B) -> AB (H, nx, m, B). Grid (B blocks, groups,
// H). The looped form's `table` is the robot's in host memory
// (MPT_TAB_FLOATS floats), copied into the launch.
extern "C" int launch_linearize(const float* xs, const float* us, float* AB,
                                int B, int H MPT_LIN_LAUNCH_TABLE, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const dim3 grid((unsigned int)((B + MPT_LIN_BLOCK - 1) / MPT_LIN_BLOCK),
                  MPT_LIN_GROUPS, (unsigned int)H);
#ifdef MPT_LIN_LOOP
  MptTable tab;
  for (int i = 0; i < MPT_TAB_FLOATS; ++i) tab.v[i] = table[i];
  mpt_lin_kernel<<<grid, MPT_LIN_BLOCK, 0, (cudaStream_t)stream>>>(xs, us, AB, B, tab);
#else
  mpt_lin_kernel<<<grid, MPT_LIN_BLOCK, 0, (cudaStream_t)stream>>>(xs, us, AB, B);
#endif
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linearize, mpt_lin_kernel)

// The blocks of MPT_LIN_BLOCK threads an SM holds.
extern "C" int occupancy_linearize(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mpt_lin_kernel, MPT_LIN_BLOCK, 0);
}
#endif
#endif  // MPT_UNIT_LIN

// ---------------------------------------------------------------- K3 -----
#if defined(MPT_UNIT_BWD)
// One warp per scenario, MPT_BWD_WARPS scenarios a block. The warp's state
// lives in its own region of shared memory (`mpt_bwd_team`); the block's
// threads copy the next step's inputs of all its scenarios into them
// together (bwd_stage), and each step of the sweep is four phases,
// `__syncwarp()` between them and `__syncthreads()` after the last:
//   A  lane c takes column c of [A | B] (and c + 32 past ten joints): Qx_c
//      or Qu_c, then column c of Vxx [A | B] in its registers, then column c
//      of the Q blocks, Q[r][c] = [A | B][:, r] . (Vxx [A | B])[:, c]. Vx,
//      Vxx's rows and the columns r are broadcasts: every lane reads the same
//      four floats at once. Lanes past the m columns help the longest
//      columns with their Q entries.
//   B  lane c < 1 + nx forms the whole Cholesky factor of Quu
//      in its registers (every solving lane does the same operations, so
//      gets the same bits) and solves column c of [Qu | Qux], storing -z as
//      column c of the gains. Past MPT_BWD_FACTOR_REGS joints the factor
//      would spill: there it lives in shared memory, one phase a column
//      before the solves (n + 3 phases a step).
//   C  lane i < nx forms row i of K^T Quu (Quu's rows broadcasts); the
//      lanes past nx (wrapping past 32) form Quu k.
//   D  Vx' on lanes 0 .. nx-1, then Vxx''s upper triangle in 2x2 tiles, one
//      tile a lane (round robin past 32 tiles), mirrored into V.
// Every output entry belongs to one lane, which takes its whole sum in the
// emitter's order (`riccati_step` of ops/cuda_mpc_batch.py: the first term,
// then left to right), so each entry gets the plain version's IEEE
// operations and, with --fmad=false, its bits. Every loop over the unit's
// dimensions is unrolled at compile time; which entries a lane owns follows
// from its lane index alone (the tiles' indices are set once a sweep). The
// generated part of the unit gives `riccati_terminal`, MPT_BWD_2WX (2 w_x,
// nx) and MPT_BWD_2WU (2 w_u): the folded weights. Where a weight is exactly
// 0 the plain version folds its term away and the kernel multiplies by 0;
// the two differ only for a non-finite input or in the sign of a zero.
#define MPT_BWD_WARPS 4                       // scenarios per block
#define MPT_LANES 32
#define MPT_AB (MPT_NX * MPT_M)               // [A | B] of one step
#define MPT_KKN (MPT_NJ * MPT_KK)             // gains of one step
#define MPT_ROUNDS(count) (((count) + MPT_LANES - 1) / MPT_LANES)
#define MPT_PAD4(count) (((count) + 3) / 4 * 4)
#define MPT_NXS MPT_PAD4(MPT_NX)  // row stride of an nx-wide row: whole float4s
#define MPT_NS MPT_PAD4(MPT_NJ)   // row stride of an n-wide row
// Column stride of [A | B]: an odd number of float4s, so that lanes reading
// their own columns at once meet in no bank.
#define MPT_ABS ((MPT_NXS / 4 | 1) * 4)
#define MPT_TILES (MPT_NJ * (MPT_NJ + 1) / 2)  // 2x2 tiles on or above Vxx's diagonal
// Step t-1's [A | B], x and u arrive in the other of two buffers by
// asynchronous copies (cp.async: no register holds them) while step t runs
// (two or three steps ahead were no faster on any joint count).
// Blocks an SM must hold, which caps the registers a thread takes: up to 7
// joints 4 (128 registers), at 8 joints 3 (168), elsewhere as many as the
// body needs. Each is the largest that spills nothing, where it was faster
// on the card (an H100; PERF.md section 6).
#define MPT_BWD_MIN_BLOCKS (MPT_NJ <= 7 ? 4 : MPT_NJ == 8 ? 3 : 1)
#define MPT_BWD_FACTOR_REGS 13  // joints up to which a lane holds the whole factor in registers
#if MPT_NJ > MPT_BWD_FACTOR_REGS
#define MPT_BWD_SHARED_FACTOR 1
#endif
// Phase A's work a lane. Column c's Q entries are its Qux (or Quu) rows r =
// nx .. m-1, then Qxx's rows r = 0 .. c (c < nx). Where the m columns leave
// lanes over (n <= 10), lane m + h helps column nx-1-h, h < MPT_HELPERS:
// the column's own lane keeps its n rows r >= nx and Qxx's rows 0 .. a-1,
// the helper takes rows a .. c, a = max(0, (c + 2 - n) / 2) so that neither
// has more than half but the own lane all its rows r >= nx.
#define MPT_MAX2(p, q) ((p) > (q) ? (p) : (q))
#define MPT_HELPERS (MPT_LANES <= MPT_M ? 0 : MPT_LANES - MPT_M < MPT_NX ? MPT_LANES - MPT_M : MPT_NX)
#define MPT_KEPT(c) MPT_MAX2(0, ((c) + 2 - MPT_NJ) / 2)
// The most Q entries a lane has: an unhelped column's, a helped column's
// own lane's, or a helper's (the longest column's each).
#define MPT_Q_ITERS                                                             \
  MPT_MAX2(MPT_MAX2(MPT_NJ, MPT_HELPERS < MPT_NX ? MPT_M - MPT_HELPERS : 0),    \
           MPT_HELPERS ? MPT_MAX2(MPT_NJ + MPT_KEPT(MPT_NX - 1), MPT_NX - MPT_KEPT(MPT_NX - 1)) : 0)

// One warp's storage (Panda: 1840 floats). Every row and column starts on
// a float4, so a lane reads four floats of it with one load.
struct mpt_bwd_team {
  float V[(MPT_NX + 1) * MPT_NXS];  // Vxx's rows, then Vx: of step t+1, of step t after phase D
  float ab[2][MPT_M * MPT_ABS];     // step t's in ab[t & 1]: column c of [A | B] at c * MPT_ABS
  float x[2][MPT_NXS], u[2][MPT_NS];
  union {
    float Vt[MPT_VN];  // the terminal value function (row stride nx), until it is copied into V
    struct {
      float Qxx[MPT_NX * MPT_NXS];  // upper triangle only
      float Qux[MPT_NJ * MPT_NXS];
    } q;
  };
  float Quu[MPT_NJ * MPT_NS];
#ifdef MPT_BWD_SHARED_FACTOR
  float L[MPT_NJ * MPT_NS], inv_d[MPT_NS];  // the factor's lower triangle, 1 / its diagonal
#endif
  float K[MPT_NJ * MPT_NXS];      // K[j][i] at j * MPT_NXS + i
  float KtQuu[MPT_NJ * MPT_NXS];  // (K^T Quu)[i][j2] at j2 * MPT_NXS + i
  float Qx[MPT_NXS];  // x_T until step H-1's phase A
  float Qu[MPT_NS], g[MPT_NS], k[MPT_NS], Quu_k[MPT_NS];
  float reg[4];
};

// What a lane keeps in registers from phase to phase: its work in phase A,
// a column a round (c | first row past nx's Qux rows << 8 | first Qxx row
// << 16 | entries << 24: the own lane's Qux rows come first, a helper has
// none), and phase D's tiles (row tile << 8 | column tile, -1 past the
// last).
struct mpt_bwd_lane {
  int col[MPT_ROUNDS(MPT_M)];
  int tile[MPT_ROUNDS(MPT_TILES)];
};

// N floats from shared memory (N a multiple of 4), a float4 at a time.
template <int N>
static __device__ __forceinline__ void mpt_row(float* dst, const float* src) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    dst[i] = v.x;
    dst[i + 1] = v.y;
    dst[i + 2] = v.z;
    dst[i + 3] = v.w;
  }
#else
  for (int i = 0; i < N; ++i) dst[i] = src[i];
#endif
}

// Two floats from shared memory, one load.
static __device__ __forceinline__ void mpt_pair(float* dst, const float* src) {
#ifdef __CUDACC__
  const float2 v = *reinterpret_cast<const float2*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
#else
  dst[0] = src[0];
  dst[1] = src[1];
#endif
}

// The lane's columns of phase A and tiles of Vxx''s upper triangle, row
// tile by row tile (once a sweep).
static __device__ __forceinline__ void bwd_lane_setup(int lane, mpt_bwd_lane* me) {
#pragma unroll
  for (int p = 0; p < MPT_ROUNDS(MPT_M); ++p) {
    const int c = lane + p * MPT_LANES, h = c - MPT_M;
    if (c < MPT_M) {
      const bool helped = c < MPT_NX && MPT_NX - 1 - c < MPT_HELPERS;
      const int rows = c >= MPT_NX ? 0 : helped ? MPT_KEPT(c) : c + 1;
      me->col[p] = c | MPT_NJ << 8 | (MPT_NJ + rows) << 24;
    } else if (p == 0 && h < MPT_HELPERS) {
      const int hc = MPT_NX - 1 - h;
      me->col[p] = hc | MPT_KEPT(hc) << 16 | (hc + 1 - MPT_KEPT(hc)) << 24;
    } else {
      me->col[p] = 0;
    }
  }
#pragma unroll
  for (int p = 0; p < MPT_ROUNDS(MPT_TILES); ++p) {
    int e = lane + p * MPT_LANES, ti = 0;
    while (ti < MPT_NJ && e >= MPT_NJ - ti) {
      e -= MPT_NJ - ti;
      ++ti;
    }
    me->tile[p] = ti < MPT_NJ ? (ti << 8 | (ti + e)) : -1;
  }
}

static __device__ __forceinline__ void bwd_load_ends(
    int lane, mpt_bwd_team* tm, const float* __restrict__ x_last,
    const float* __restrict__ goal, const float* __restrict__ reg, int B, int b) {
  if (b >= B) return;  // a warp past the last scenario: it only keeps the block's pace
  for (int e = lane; e <= MPT_NX + MPT_NJ; e += MPT_LANES) {
    if (e < MPT_NX) tm->Qx[e] = MPT_AT(x_last, e, b, B);
    else if (e < MPT_NX + MPT_NJ) tm->g[e - MPT_NX] = MPT_AT(goal, e - MPT_NX, b, B);
    else tm->reg[0] = reg[b];
  }
}

// The terminal value function into V's padded rows.
static __device__ __forceinline__ void bwd_terminal_copy(int lane, mpt_bwd_team* tm) {
  for (int e = lane; e < MPT_VN; e += MPT_LANES) {
    const int r = e / MPT_NX;
    tm->V[r * MPT_NXS + (e - r * MPT_NX)] = tm->Vt[e];
  }
}

// One float from global to shared memory: on the card an asynchronous copy
// (cp.async), which holds no register and does not stall the lane; a plain
// copy in the host harness. bwd_wait completes the thread's copies.
static __device__ __forceinline__ void bwd_copy(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned int to = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(to), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

static __device__ __forceinline__ void bwd_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Step t's inputs for the block's scenarios b0 .. b0 + MPT_BWD_WARPS - 1
// into buffer t & 1 of each one's storage (issued a step ahead of use), by
// the block's threads together: thread tid copies entries f = tid / W, + 32,
// + 64, ... of scenario b0 + tid % W (W = MPT_BWD_WARPS). A warp's copy thus
// reads 8 entries of 4 neighbouring scenarios, 16 bytes of a sector each,
// where one warp a scenario would read 32 sectors for 4 bytes each. The
// entries run column by column (f = c nx + l), so neighbouring threads fill
// neighbouring words of a column; entry f0 + 32 r is column c0 + 32 r / nx,
// row l0 + 32 r % nx (one column on where that passes nx), with c0, l0
// entry f0's: no division a round. A step's [A | B] of all B scenarios is
// indexed in 32 bits (launch_backward refuses a B past that).
static __device__ __forceinline__ void bwd_stage(
    int tid, mpt_bwd_team* teams, const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, int B, int b0, int t) {
  int f0 = tid / MPT_BWD_WARPS;
#ifdef __CUDA_ARCH__
  // f0 opaque to the compiler: it forms the copies' addresses anew at each
  // step rather than holding them all in registers through the sweep.
  asm volatile("" : "+r"(f0));
#endif
  const int s = tid % MPT_BWD_WARPS, b = b0 + s;
  if (b >= B) return;
  mpt_bwd_team* tm = teams + s;
  const int c0 = f0 / MPT_NX, l0 = f0 - c0 * MPT_NX;
  const float* src = AB + (size_t)t * MPT_AB * (size_t)B + (size_t)b;
  float* ab = tm->ab[t & 1];
#pragma unroll
  for (int r = 0; r < MPT_ROUNDS(MPT_AB); ++r) {
    const int wrap = l0 + r * MPT_LANES % MPT_NX >= MPT_NX;
    const int c = c0 + r * MPT_LANES / MPT_NX + wrap, l = l0 + r * MPT_LANES % MPT_NX - wrap * MPT_NX;
    if (c < MPT_M) bwd_copy(ab + c * MPT_ABS + l, src + (unsigned int)(l * MPT_M + c) * (unsigned int)B);
  }
#pragma unroll
  for (int r = 0; r < MPT_ROUNDS(MPT_NX + MPT_NJ); ++r) {
    const int e = f0 + r * MPT_LANES;
    if (e < MPT_NX) bwd_copy(tm->x[t & 1] + e, &MPT_AT(xs, (size_t)t * MPT_NX + e, b, B));
    else if (e < MPT_NX + MPT_NJ) bwd_copy(tm->u[t & 1] + (e - MPT_NX), &MPT_AT(us, (size_t)t * MPT_NJ + (e - MPT_NX), b, B));
  }
}

// Phase A, the lane's work on column c of [A | B] (a), `col` of
// mpt_bwd_lane:
//   Qx_c = lx_c + Vx . a (c < nx), Qu_{c-nx} = lu + Vx . a (the own lane);
//   VAB_c = Vxx a, each row of Vxx a broadcast;
//   Q[r][c] = [A | B][:, r] . VAB_c for the lane's rows r of Qxx's upper
//   triangle (+ 2 w_x on its diagonal), Qux, and Quu (+ (2 w_u + reg) on its
//   diagonal). The own lanes' r agree at each round, a broadcast.
static __device__ __forceinline__ void bwd_column(int col, mpt_bwd_team* tm, int t) {
  const int c = col & 255, qux = col >> 8 & 255, r0 = col >> 16 & 255, count = col >> 24;
  const float* ab = tm->ab[t & 1];
  const float* x = tm->x[t & 1];
  float a[MPT_NXS], v[MPT_NXS];
  mpt_row<MPT_NXS>(a, ab + c * MPT_ABS);
  if (qux) {
    mpt_row<MPT_NXS>(v, tm->V + MPT_NX * MPT_NXS);
    float s = v[0] * a[0];
#pragma unroll
    for (int k = 1; k < MPT_NX; ++k) s = s + v[k] * a[k];
    if (c < MPT_NJ) tm->Qx[c] = MPT_BWD_2WX[c] * (x[c] - tm->g[c]) + s;
    else if (c < MPT_NX) tm->Qx[c] = MPT_BWD_2WX[c] * x[c] + s;  // goal velocity 0
    else tm->Qu[c - MPT_NX] = MPT_BWD_2WU * tm->u[t & 1][c - MPT_NX] + s;
  }
  float vab[MPT_NX];
#pragma unroll
  for (int k = 0; k < MPT_NX; ++k) {
    mpt_row<MPT_NXS>(v, tm->V + k * MPT_NXS);
    float sk = v[0] * a[0];
#pragma unroll
    for (int l = 1; l < MPT_NX; ++l) sk = sk + v[l] * a[l];
    vab[k] = sk;
  }
  const float diag = c < MPT_NX ? MPT_BWD_2WX[c] : MPT_BWD_2WU + tm->reg[0];
  // Every round runs on every lane (a lane past its count sums a row it
  // does not store), so the rounds' sums form one straight line whose
  // chains the compiler interleaves.
#pragma unroll
  for (int e = 0; e < MPT_Q_ITERS; ++e) {
    const int q = e < qux ? MPT_NX + e : r0 + (e - qux);
    const int r = q < MPT_M ? q : MPT_M - 1;
    mpt_row<MPT_NXS>(v, ab + r * MPT_ABS);
    float sr = v[0] * vab[0];
#pragma unroll
    for (int l = 1; l < MPT_NX; ++l) sr = sr + v[l] * vab[l];
    if (r == c) sr = sr + diag;
    float* dst = r < MPT_NX ? tm->q.Qxx + r * MPT_NXS + c
                 : c < MPT_NX ? tm->q.Qux + (r - MPT_NX) * MPT_NXS + c
                              : tm->Quu + (r - MPT_NX) * MPT_NS + (c - MPT_NX);
    if (e < count) *dst = sr;
  }
}

static __device__ __forceinline__ void bwd_columns(int lane, const mpt_bwd_lane* me, mpt_bwd_team* tm, int t) {
  (void)lane;
#pragma unroll
  for (int p = 0; p < MPT_ROUNDS(MPT_M); ++p)
    if (me->col[p]) bwd_column(me->col[p], tm, t);
}

// Phase B: the Cholesky factor of Quu (`_chol_solve_cols`, in place over
// Quu's lower triangle) by every lane that solves, then lane c's column:
// Quu z = rhs_c (rhs_0 = Qu, rhs_{1+i} = Qux[:, i]), forward then back
// substitution, -z stored as column c of the gains, in kK[t] and in shared
// memory (k, or column c-1 of K). Past 15 joints a step has more gain
// columns (1 + nx) than a warp has lanes: lane c also takes column c + 32.
#ifdef MPT_BWD_SHARED_FACTOR
// Column j of the factor in shared memory: every lane i >= j forms the pivot
// d = sqrt(Quu_jj - sum_k L_jk^2) and 1/d (the same operations, so the same
// bits), lane j stores 1/d and each lane i > j its L_ij.
static __device__ __forceinline__ void bwd_factor_column(int lane, mpt_bwd_team* tm, int j) {
  if (lane >= j && lane < MPT_NJ) {
    const float* L = tm->L;
    float s = tm->Quu[j * MPT_NS + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j * MPT_NS + k] * L[j * MPT_NS + k];
    const float inv = 1.0f / sqrtf(s);
    if (lane == j) {
      tm->inv_d[j] = inv;
    } else {
      float si = tm->Quu[lane * MPT_NS + j];
#pragma unroll
      for (int k = 0; k < j; ++k) si = si - L[lane * MPT_NS + k] * L[j * MPT_NS + k];
      tm->L[lane * MPT_NS + j] = si * inv;
    }
  }
}
#define MPT_L(i, k) tm->L[(i) * MPT_NS + (k)]
#define MPT_INV_D(i) tm->inv_d[i]
#else
#define MPT_L(i, k) L[i][k]
#define MPT_INV_D(i) inv_d[i]
#endif

static __device__ __forceinline__ void bwd_solve(
    int lane, mpt_bwd_team* tm, float* __restrict__ kK, int B, int b, int t) {
  if (lane >= MPT_KK) return;
#ifndef MPT_BWD_SHARED_FACTOR
  float L[MPT_NJ][MPT_NJ], inv_d[MPT_NJ];
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    float row[MPT_NS];
    mpt_row<MPT_NS>(row, tm->Quu + i * MPT_NS);
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = row[j];
  }
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) {
    float s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    inv_d[j] = 1.0f / sqrtf(s);
#pragma unroll
    for (int i = j + 1; i < MPT_NJ; ++i) {
      float si = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) si = si - L[i][k] * L[j][k];
      L[i][j] = si * inv_d[j];
    }
  }
#endif
  const size_t row = (size_t)t * MPT_KKN;
#pragma unroll
  for (int p = 0; p < MPT_ROUNDS(MPT_KK); ++p) {
    const int c = lane + p * MPT_LANES;
    if (c >= MPT_KK) break;
    float y[MPT_NJ], z[MPT_NJ];
#pragma unroll
    for (int i = 0; i < MPT_NJ; ++i) {
      float s = c == 0 ? tm->Qu[i] : tm->q.Qux[i * MPT_NXS + (c - 1)];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - MPT_L(i, k) * y[k];
      y[i] = s * MPT_INV_D(i);
    }
#pragma unroll
    for (int i = MPT_NJ - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < MPT_NJ; ++k) s = s - MPT_L(k, i) * z[k];
      z[i] = s * MPT_INV_D(i);
    }
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      const float v = -z[j];
      if (b < B) MPT_AT(kK, row + j * MPT_KK + c, b, B) = v;
      if (c == 0) tm->k[j] = v;
      else tm->K[j * MPT_NXS + (c - 1)] = v;
    }
  }
}

// Phase C: row i = lane of K^T Quu (lanes below nx), and Quu k (the lanes
// past nx, then lanes 0, 1, ... where nx + n passes 32).
static __device__ __forceinline__ void bwd_gain_products(int lane, mpt_bwd_team* tm) {
  float q[MPT_NS];
  if (lane < MPT_NX) {
    float acc[MPT_NJ];
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      const float kji = tm->K[j * MPT_NXS + lane];
      mpt_row<MPT_NS>(q, tm->Quu + j * MPT_NS);
#pragma unroll
      for (int j2 = 0; j2 < MPT_NJ; ++j2) acc[j2] = j == 0 ? kji * q[j2] : acc[j2] + kji * q[j2];
    }
#pragma unroll
    for (int j2 = 0; j2 < MPT_NJ; ++j2) tm->KtQuu[j2 * MPT_NXS + lane] = acc[j2];
  }
  const int e = (lane + MPT_LANES - MPT_NX) % MPT_LANES;
  if (e < MPT_NJ) {
    float kv[MPT_NS];
    mpt_row<MPT_NS>(q, tm->Quu + e * MPT_NS);
    mpt_row<MPT_NS>(kv, tm->k);
    float s = q[0] * kv[0];
#pragma unroll
    for (int j2 = 1; j2 < MPT_NJ; ++j2) s = s + q[j2] * kv[j2];
    tm->Quu_k[e] = s;
  }
}

// Phase D: Vx' = (Qx + K^T (Quu k + Qu)) + Qux^T k, then each of the lane's
// tiles of Vxx' = ((Qxx + K^T Quu K) + K^T Qux) + Qux^T K, its entries on or
// above the diagonal mirrored into V.
static __device__ __forceinline__ void bwd_value_update(int lane, const mpt_bwd_lane* me, mpt_bwd_team* tm) {
  const float* K = tm->K;
  const float* Qux = tm->q.Qux;
  if (lane < MPT_NX) {
    float s = K[lane] * (tm->Quu_k[0] + tm->Qu[0]);
#pragma unroll
    for (int j = 1; j < MPT_NJ; ++j) s = s + K[j * MPT_NXS + lane] * (tm->Quu_k[j] + tm->Qu[j]);
    float s2 = Qux[lane] * tm->k[0];
#pragma unroll
    for (int j = 1; j < MPT_NJ; ++j) s2 = s2 + Qux[j * MPT_NXS + lane] * tm->k[j];
    tm->V[MPT_NX * MPT_NXS + lane] = (tm->Qx[lane] + s) + s2;
  }
#pragma unroll
  for (int p = 0; p < MPT_ROUNDS(MPT_TILES); ++p) {
    const int tile = me->tile[p];
    if (tile < 0) break;
    const int i0 = 2 * (tile >> 8), k0 = 2 * (tile & 255);
    float a[2][2], c1[2][2], c2[2][2];
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      float kq[2], ki[2], kk[2], xi[2], xk[2];
      mpt_pair(kq, tm->KtQuu + j * MPT_NXS + i0);  // (K^T Quu)[i][j]
      mpt_pair(ki, K + j * MPT_NXS + i0);
      mpt_pair(kk, K + j * MPT_NXS + k0);
      mpt_pair(xi, Qux + j * MPT_NXS + i0);
      mpt_pair(xk, Qux + j * MPT_NXS + k0);
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          const float ta = kq[di] * kk[dk], t1 = ki[di] * xk[dk], t2 = xi[di] * kk[dk];
          a[di][dk] = j == 0 ? ta : a[di][dk] + ta;
          c1[di][dk] = j == 0 ? t1 : c1[di][dk] + t1;
          c2[di][dk] = j == 0 ? t2 : c2[di][dk] + t2;
        }
    }
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int i = i0 + di, k = k0 + dk;
        if (k < i) continue;  // below the diagonal of a diagonal tile
        const float v = ((tm->q.Qxx[i * MPT_NXS + k] + a[di][dk]) + c1[di][dk]) + c2[di][dk];
        tm->V[i * MPT_NXS + k] = v;
        tm->V[k * MPT_NXS + i] = v;
      }
  }
}

// A phase: on the card the calling thread runs it and the warp meets at
// __syncwarp(), or the block at __syncthreads() at a step's end, where the
// block's copies of the next step's inputs are complete; in the host
// harness (MPT_HOST_TEAM) the block's threads run it one after the other
// before the next phase, each with its own registers. Either way a phase
// sees, for thread tid: its lane, its warp's storage tm, scenario b and its
// lane's registers me.
#if defined(MPT_HOST_TEAM)
#define MPT_PHASE(call)                                                     \
  do {                                                                      \
    for (int tid = 0; tid < MPT_BWD_WARPS * MPT_LANES; ++tid) {             \
      const int lane = tid % MPT_LANES;                                     \
      mpt_bwd_team* tm = teams + tid / MPT_LANES;                           \
      const int b = b0 + tid / MPT_LANES;                                   \
      mpt_bwd_lane* me = lanes + tid;                                       \
      (void)lane, (void)tm, (void)b, (void)me;                              \
      call;                                                                 \
    }                                                                       \
  } while (0)
#define MPT_STEP_END(call) MPT_PHASE(call)
#else
#define MPT_PHASE(call) \
  do {                  \
    call;               \
    __syncwarp();       \
  } while (0)
#define MPT_STEP_END(call) \
  do {                     \
    call;                  \
    bwd_wait();            \
    __syncthreads();       \
  } while (0)
#endif

// Scenarios b0 .. b0 + MPT_BWD_WARPS - 1, each its whole sweep, t = H-1
// ... 0, by the block (thread my_tid on the card; every thread in the host
// harness). Warps past the last scenario run the steps on storage nobody
// filled and store nothing: they keep the block's barriers.
static __device__ __forceinline__ void bwd_sweep(
    int my_tid, mpt_bwd_team* teams, const float* __restrict__ AB,
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ x_last, const float* __restrict__ goal,
    const float* __restrict__ reg, float* __restrict__ kK, int B, int H, int b0) {
#if defined(MPT_HOST_TEAM)
  mpt_bwd_lane lanes[MPT_BWD_WARPS * MPT_LANES];
  (void)my_tid;
#else
  const int tid = my_tid, lane = tid % MPT_LANES;
  mpt_bwd_team* tm = teams + tid / MPT_LANES;
  const int b = b0 + tid / MPT_LANES;
  mpt_bwd_lane lane_regs;
  mpt_bwd_lane* me = &lane_regs;
#endif
  MPT_PHASE(bwd_lane_setup(lane, me); bwd_load_ends(lane, tm, x_last, goal, reg, B, b);
            bwd_stage(tid, teams, AB, xs, us, B, b0, H - 1));
  MPT_PHASE(if (lane == 0) riccati_terminal(tm->Qx, tm->g, tm->Vt));
  MPT_STEP_END(bwd_terminal_copy(lane, tm));
  for (int t = H - 1; t >= 0; --t) {
    MPT_PHASE(if (t > 0) bwd_stage(tid, teams, AB, xs, us, B, b0, t - 1);
              bwd_columns(lane, me, tm, t));
#ifdef MPT_BWD_SHARED_FACTOR
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) MPT_PHASE(bwd_factor_column(lane, tm, j));
#endif
    MPT_PHASE(bwd_solve(lane, tm, kK, B, b, t));
    MPT_PHASE(bwd_gain_products(lane, tm));
    MPT_STEP_END(bwd_value_update(lane, me, tm));
  }
}

// The warps' storage, dynamic shared memory: past ten joints it exceeds the
// 48 KB a block may declare statically.
#define MPT_BWD_SMEM (MPT_BWD_WARPS * sizeof(mpt_bwd_team))
extern "C" long long mpt_layout_backward(void) { return (long long)MPT_BWD_SMEM; }

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BWD_WARPS * MPT_LANES, MPT_BWD_MIN_BLOCKS) mpt_bwd_warp_kernel(
    const float* __restrict__ AB, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ x_last,
    const float* __restrict__ goal, const float* __restrict__ reg,
    float* __restrict__ kK, int B, int H) {
  extern __shared__ float4 mpt_bwd_smem[];
  mpt_bwd_team* teams = reinterpret_cast<mpt_bwd_team*>(mpt_bwd_smem);
  bwd_sweep((int)threadIdx.x, teams, AB, xs, us, x_last, goal, reg, kK, B, H,
            (int)blockIdx.x * MPT_BWD_WARPS);
}

// AB (H, nx, m, B), xs (H, nx, B), us (H, n, B), x_last (nx, B),
// goal (n, B), reg (B) -> kK (H, n, 1+nx, B). MPT_BWD_WARPS scenarios a
// block; their storage's limit is raised once per device.
extern "C" int launch_backward(const float* AB, const float* xs,
                               const float* us, const float* x_last,
                               const float* goal, const float* reg, float* kK,
                               int B, int H, void* stream) {
  static bool raised[64];
  if (B <= 0 || H <= 0) return 0;
  if ((long long)MPT_AB * B > 0xffffffffLL) return (int)cudaErrorInvalidValue;  // bwd_stage's 32-bit index
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(mpt_bwd_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MPT_BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const unsigned int blocks = (unsigned int)(((long long)B + MPT_BWD_WARPS - 1) / MPT_BWD_WARPS);
  mpt_bwd_warp_kernel<<<blocks, MPT_BWD_WARPS * MPT_LANES, MPT_BWD_SMEM, (cudaStream_t)stream>>>(
      AB, xs, us, x_last, goal, reg, kK, B, H);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_backward, mpt_bwd_warp_kernel)

// The blocks of MPT_BWD_WARPS warps an SM holds, with their shared storage
// (the limit raised first, as launch_backward does).
extern "C" int occupancy_backward(int* blocks) {
  const cudaError_t err = cudaFuncSetAttribute(mpt_bwd_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)MPT_BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mpt_bwd_warp_kernel, MPT_BWD_WARPS * MPT_LANES,
                                                            MPT_BWD_SMEM);
}
#endif
#endif  // MPT_UNIT_BWD

// ----------------------------------------------------------- K4 and K5 ---
#if defined(MPT_UNIT_FWD)
#ifdef MPT_FWD_LOOP
// The looped form (one unit per joint count, every robot of n joints):
// the closed-loop step on K0's loop over links (csrc/fd_step_loop.cuh),
// the robot, its torque bounds (MPT_TAB_U_LIM) and the cost weights
// (MPT_COST_*, after the table) in the launch's __grid_constant__
// parameter. ops/fd_step.py::fd_fwd_loop_planes is its plain version,
// operation for operation.
#ifdef MPT_REPLAY_TEAM
#error "K5's team splits the emitted step; the looped form runs one thread a scenario"
#endif
#define MPT_FWD_TABLE , const float* __restrict__ tab
#define MPT_FWD_TABLE_ARG , tab

// Step t of scenario b: u = clamp(u_nom + alpha k + K dx, +-u_lim) (each
// gain row read as its control is formed), the running cost at the
// pre-step state, returned, then the looped step: q and dq in place.
// Every sum in the emitter's order (ops/cuda_mpc_batch.py::fwd_step).
static __device__ __forceinline__ float mpt_fwd_loop_step(
    float q[MPT_NJ], float dq[MPT_NJ], const float g[MPT_NJ], const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK, float alpha, float u[MPT_NJ],
    int B, int b, int t, const float* __restrict__ tab) {
  const float* W = tab + MPT_TAB_FLOATS;
  float dx[MPT_NX];
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    dx[i] = q[i] - MPT_AT(sd_x, t * MPT_NX + i, b, B);
    dx[MPT_NJ + i] = dq[i] - MPT_AT(sd_x, t * MPT_NX + MPT_NJ + i, b, B);
  }
  const size_t kk_row = (size_t)t * (MPT_NJ * MPT_KK);
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) {
    const size_t r = kk_row + (size_t)j * MPT_KK;
    float uj = MPT_AT(sd_u, t * MPT_NJ + j, b, B) + alpha * MPT_AT(kK, r, b, B);
#pragma unroll
    for (int i = 0; i < MPT_NX; ++i) uj = uj + MPT_AT(kK, r + 1 + i, b, B) * dx[i];
    const float lim = tab[MPT_TAB_HEAD + j * MPT_TAB_STRIDE + MPT_TAB_U_LIM];
    u[j] = mpt_clamp(uj, -lim, lim);
  }
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float e = q[i] - g[i];
    const float te = (W[MPT_COST_W_Q] * e) * e;
    c = i == 0 ? te : c + te;
    c = c + (W[MPT_COST_W_DQ] * dq[i]) * dq[i];
  }
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) c = c + (W[MPT_COST_W_U] * u[j]) * u[j];
  float ddq[MPT_NJ];
  fd_step_loop(q, dq, u, ddq, tab);
  return c;
}

// The terminal cost with the table's weights.
static __device__ __forceinline__ float mpt_fwd_loop_terminal(
    const float q[MPT_NJ], const float dq[MPT_NJ], const float g[MPT_NJ], const float* __restrict__ tab) {
  const float* W = tab + MPT_TAB_FLOATS;
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float e = q[i] - g[i];
    const float te = (W[MPT_COST_WT_Q] * e) * e;
    c = i == 0 ? te : c + te;
    c = c + (W[MPT_COST_WT_DQ] * dq[i]) * dq[i];
  }
  return c;
}

// fwd_rollout (below) on the looped step.
static __device__ __forceinline__ float fwd_rollout(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, float alpha, float* __restrict__ xs_out,
    float* __restrict__ us_out, int stride, int B, int H, int b, const float* __restrict__ tab) {
  float q[MPT_NJ], dq[MPT_NJ], g[MPT_NJ], u[MPT_NJ];
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    q[i] = MPT_AT(x0, i, b, B);
    dq[i] = MPT_AT(x0, MPT_NJ + i, b, B);
    g[i] = MPT_AT(goal, i, b, B);
  }
  float acc = 0.0f;
  for (int t = 0; t < H; ++t) {
    acc = acc + mpt_fwd_loop_step(q, dq, g, sd_x, sd_u, kK, alpha, u, B, b, t, tab);
    if (xs_out != NULL) {
#pragma unroll
      for (int i = 0; i < MPT_NJ; ++i) {
        MPT_AT(xs_out, (size_t)(t * MPT_NX + i) * stride, b, B) = q[i];
        MPT_AT(xs_out, (size_t)(t * MPT_NX + MPT_NJ + i) * stride, b, B) = dq[i];
      }
#pragma unroll
      for (int j = 0; j < MPT_NJ; ++j)
        MPT_AT(us_out, (size_t)(t * MPT_NJ + j) * stride, b, B) = u[j];
    }
  }
  return acc + mpt_fwd_loop_terminal(q, dq, g, tab);
}
#else
#define MPT_FWD_TABLE
#define MPT_FWD_TABLE_ARG
// The closed-loop rollout of one scenario under one alpha. Writes each
// step's post-step state and control when xs_out is not null, row r of
// them at xs_out[r * stride * B] (K5: stride 1; K4: the A alphas, xs_out
// already at its alpha's column), and returns the total cost.
static __device__ __forceinline__ float fwd_rollout(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, float alpha, float* __restrict__ xs_out,
    float* __restrict__ us_out, int stride, int B, int H, int b) {
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
      for (int i = 0; i < MPT_NX; ++i)
        MPT_AT(xs_out, (size_t)(t * MPT_NX + i) * stride, b, B) = x[i];
#pragma unroll
      for (int j = 0; j < MPT_NJ; ++j)
        MPT_AT(us_out, (size_t)(t * MPT_NJ + j) * stride, b, B) = u[j];
    }
  }
  mpc_terminal(x, g, c);
  return acc + c[0];
}
#endif

// K4, costs only: thread (b, a) scores alpha a for scenario b.
static __device__ __forceinline__ void cost_thread(
    const float* x0, const float* sd_x, const float* sd_u, const float* kK,
    const float* goal, const float* alphas, float* costs, int B, int H, int b,
    int a MPT_FWD_TABLE) {
  MPT_AT(costs, a, b, B) =
      fwd_rollout(x0, sd_x, sd_u, kK, goal, alphas[a], NULL, NULL, 1, B, H, b MPT_FWD_TABLE_ARG);
}

// K4 with the trajectories: thread (b, a) also stores alpha a's states and
// controls into xs_all (H, nx, A, B) and us_all (H, n, A, B).
static __device__ __forceinline__ void linesearch_thread(
    const float* x0, const float* sd_x, const float* sd_u, const float* kK,
    const float* goal, const float* alphas, float* costs, float* xs_all,
    float* us_all, int B, int H, int A, int b, int a MPT_FWD_TABLE) {
  const size_t col = (size_t)a * (size_t)B;
  MPT_AT(costs, a, b, B) = fwd_rollout(x0, sd_x, sd_u, kK, goal, alphas[a], xs_all + col,
                                       us_all + col, A, B, H, b MPT_FWD_TABLE_ARG);
}

// K5: scenario b under its own alpha.
static __device__ __forceinline__ void replay_thread(
    const float* x0, const float* sd_x, const float* sd_u, const float* kK,
    const float* goal, const float* alpha, float* xs, float* us, float* cost,
    int B, int H, int b MPT_FWD_TABLE) {
  cost[b] = fwd_rollout(x0, sd_x, sd_u, kK, goal, alpha[b], xs, us, 1, B, H, b MPT_FWD_TABLE_ARG);
}

#ifdef __CUDACC__
#ifdef MPT_FWD_LOOP
// The table and the cost weights, by value: they live in the launch's
// parameter space (4 + 47 n + 5 floats, 1916 bytes at n = 10).
struct MptFwdTable {
  float v[MPT_TAB_FLOATS + MPT_COST_FLOATS];
};
static MptFwdTable mpt_fwd_table(const float* table) {
  MptFwdTable tab;
  for (int i = 0; i < MPT_TAB_FLOATS + MPT_COST_FLOATS; ++i) tab.v[i] = table[i];
  return tab;
}
#define MPT_FWD_KERNEL_TABLE , const __grid_constant__ MptFwdTable tab
#define MPT_FWD_KERNEL_ARG , tab.v
#define MPT_FWD_LAUNCH_TABLE , const float* table
#define MPT_FWD_LAUNCH_ARG , mpt_fwd_table(table)
#else
#define MPT_FWD_KERNEL_TABLE
#define MPT_FWD_KERNEL_ARG
#define MPT_FWD_LAUNCH_TABLE
#define MPT_FWD_LAUNCH_ARG
#endif

// K4: block (i, a) holds scenarios i*MPT_BLOCK .. of alpha a; STORE adds
// the trajectories (`linesearch`), without it the costs alone
// (`linesearch_costs`).
template <bool STORE>
__global__ void __launch_bounds__(MPT_BLOCK) mpt_cost_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alphas,
    float* __restrict__ costs, float* __restrict__ xs_all, float* __restrict__ us_all,
    int B, int H MPT_FWD_KERNEL_TABLE) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (STORE)
    linesearch_thread(x0, sd_x, sd_u, kK, goal, alphas, costs, xs_all, us_all, B, H,
                      (int)gridDim.y, b, (int)blockIdx.y MPT_FWD_KERNEL_ARG);
  else
    cost_thread(x0, sd_x, sd_u, kK, goal, alphas, costs, B, H, b, (int)blockIdx.y MPT_FWD_KERNEL_ARG);
}

// x0 (nx, B), sd_x (H, nx, B), sd_u (H, n, B), kK (H, n, 1+nx, B),
// goal (n, B), alphas (A) -> costs (A, B). Grid (B blocks, A). The looped
// form's `table` is the robot's table and cost weights in host memory
// (MPT_TAB_FLOATS + MPT_COST_FLOATS floats), copied into the launch.
extern "C" int launch_linesearch_costs(const float* x0, const float* sd_x,
                                       const float* sd_u, const float* kK,
                                       const float* goal, const float* alphas,
                                       float* costs, int B, int H, int A
                                       MPT_FWD_LAUNCH_TABLE, void* stream) {
  if (B <= 0 || A <= 0) return 0;
  const dim3 grid((unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK), (unsigned int)A);
  mpt_cost_kernel<false><<<grid, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alphas, costs, NULL, NULL, B, H MPT_FWD_LAUNCH_ARG);
  return (int)cudaGetLastError();
}

// The same inputs -> costs (A, B), xs_all (H, nx, A, B), us_all (H, n, A, B).
extern "C" int launch_linesearch(const float* x0, const float* sd_x,
                                 const float* sd_u, const float* kK,
                                 const float* goal, const float* alphas,
                                 float* costs, float* xs_all, float* us_all,
                                 int B, int H, int A MPT_FWD_LAUNCH_TABLE, void* stream) {
  if (B <= 0 || A <= 0) return 0;
  const dim3 grid((unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK), (unsigned int)A);
  mpt_cost_kernel<true><<<grid, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alphas, costs, xs_all, us_all, B, H MPT_FWD_LAUNCH_ARG);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_linesearch_costs, mpt_cost_kernel<false>)
MPT_ATTRIBUTES(attributes_linesearch, mpt_cost_kernel<true>)
#endif

#if !defined(MPT_REPLAY_TEAM)
#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_BLOCK) mpt_replay_kernel(
    const float* __restrict__ x0, const float* __restrict__ sd_x,
    const float* __restrict__ sd_u, const float* __restrict__ kK,
    const float* __restrict__ goal, const float* __restrict__ alpha,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ cost,
    int B, int H MPT_FWD_KERNEL_TABLE) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  replay_thread(x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H, b MPT_FWD_KERNEL_ARG);
}

// The same inputs with one alpha per scenario, alpha (B) -> xs (H, nx, B),
// us (H, n, B), cost (B).
extern "C" int launch_replay(const float* x0, const float* sd_x,
                             const float* sd_u, const float* kK,
                             const float* goal, const float* alpha, float* xs,
                             float* us, float* cost, int B, int H
                             MPT_FWD_LAUNCH_TABLE, void* stream) {
  if (B <= 0) return 0;
  const unsigned int blocks = (unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK);
  mpt_replay_kernel<<<blocks, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H MPT_FWD_LAUNCH_ARG);
  return (int)cudaGetLastError();
}
MPT_ATTRIBUTES(attributes_replay, mpt_replay_kernel)
#endif
#else  // MPT_REPLAY_TEAM
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
#if !defined(MPT_TEAM_S_MAX) || !defined(MPT_TEAM_PER_BLOCK)
#error "MPT_TEAM_S_MAX and MPT_TEAM_PER_BLOCK must come before K5's team"
#endif
#define MPT_ROWN (MPT_NX + MPT_NJ + MPT_NJ * MPT_KK)
#define MPT_TEAM_THREADS (32 * MPT_FWD_TEAM_W)
// Floats a team holds per scenario, and the shared memory a block may take.
#define MPT_T_LANE (2 * MPT_NX + 2 * MPT_ROWN + MPT_NJ + 2 * (MPT_NJ + 1) + MPT_FWD_TEAM_SLOTS)
#define MPT_SMEM_MAX 232448
#define MPT_T_FITS(S) ((S) * MPT_T_LANE * 4 <= MPT_SMEM_MAX)
// Scenarios a team: MPT_TEAM_S_MAX, halved (to 4 at least) until one team's
// storage fits a block: a robot with more joints has longer rows and more
// slots (n = 12 takes 285568 bytes at 32 scenarios).
#define MPT_TEAM_S (MPT_T_FITS(MPT_TEAM_S_MAX) ? MPT_TEAM_S_MAX        \
                    : MPT_TEAM_S_MAX >= 8 && MPT_T_FITS(MPT_TEAM_S_MAX / 2) ? MPT_TEAM_S_MAX / 2 \
                    : MPT_TEAM_S_MAX >= 16 && MPT_T_FITS(MPT_TEAM_S_MAX / 4) ? MPT_TEAM_S_MAX / 4 \
                    : 4)
// MPT_TEAM_STEP: the unit's writer puts the emitted team step here (its
// MPT_FWD_TEAM_* defines and warp programs, ops/cgen.py::team_function),
// after the macros its programs read (MPT_TS, the team's scenarios).
#if !defined(MPT_FWD_TEAM_W)
#error "the emitted team step must come before K5's team"
#endif
#if 32 % MPT_TEAM_S_MAX != 0 || MPT_TEAM_S_MAX % 4 != 0 || MPT_TEAM_PER_BLOCK > 15 || MPT_FWD_TEAM_W * MPT_TEAM_PER_BLOCK > 32
#error "a team's S must divide 32 and be a multiple of 4; a block holds at most 15 teams and 32 warps"
#endif
#define MPT_T_XIN 0
#define MPT_T_ROWS (MPT_T_XIN + 2 * MPT_NX * MPT_TEAM_S)
#define MPT_T_GOAL (MPT_T_ROWS + 2 * MPT_ROWN * MPT_TEAM_S)
#define MPT_T_OB (MPT_T_GOAL + MPT_NJ * MPT_TEAM_S)
#define MPT_T_SLOTS (MPT_T_OB + 2 * (MPT_NJ + 1) * MPT_TEAM_S)
#define MPT_T_FLOATS (MPT_T_SLOTS + MPT_FWD_TEAM_SLOTS * MPT_TEAM_S)
#define MPT_T_BYTES ((size_t)MPT_T_FLOATS * sizeof(float))
#if MPT_T_FLOATS * 4 > MPT_SMEM_MAX
#error "one team's storage exceeds the shared memory a block may take"
#endif
// Teams a block: MPT_TEAM_PER_BLOCK where their storage fits, else as many
// as fit.
#define MPT_TEAMS (MPT_TEAM_PER_BLOCK * MPT_T_FLOATS * 4 <= MPT_SMEM_MAX ? MPT_TEAM_PER_BLOCK \
                   : MPT_SMEM_MAX / (MPT_T_FLOATS * 4))
#define MPT_REPLAY_SMEM (MPT_T_BYTES * MPT_TEAMS)
extern "C" long long mpt_layout_replay_team(void) { return (long long)MPT_REPLAY_SMEM; }

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

// The same inputs with one alpha per scenario, alpha (B) -> xs (H, nx, B),
// us (H, n, B), cost (B). Blocks of MPT_TEAMS teams; the teams'
// storage is dynamic shared memory, whose limit is raised once per device.
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
MPT_ATTRIBUTES(attributes_replay, mpt_replay_kernel)
#endif
#endif  // MPT_REPLAY_TEAM

#ifdef __CUDACC__
// The blocks an SM holds of K4's costs alone, K4 with its trajectories and
// K5 (one thread a scenario; -1 for K5's team variant).
extern "C" int occupancy_fwd(int* blocks) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mpt_cost_kernel<false>, MPT_BLOCK, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, mpt_cost_kernel<true>, MPT_BLOCK, 0);
#if !defined(MPT_REPLAY_TEAM)
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 2, mpt_replay_kernel, MPT_BLOCK, 0);
#else
  blocks[2] = -1;
#endif
  return (int)err;
}
#endif
#endif  // MPT_UNIT_FWD
