// Exact-dynamics rollout kernel (K1, with the step program K0 inlined)
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel of manipulapy_tpu/ops/pallas_rollout.py
// (build_pallas_rollout, the pallas_call of its inner `kernel`).
//
// This file is a template. ops/cuda_rollout.py writes one translation unit
// per (robot, dt / intRes, g, clip flags) that holds, in order:
//   #define MPT_NJ <n>           number of joints
//   #define MPT_INT_RES <k>      Euler substeps per waypoint
//   #define MPT_CHUNK <c>        waypoints a block stages at a time
//   #define MPT_BLOCK <T>        threads a block
//   the generated `fd_step(q, dq, tau, ddq)` device function
//     (ops/fd_step.py::build_fd_step_source: ~3k straight-line f32 ops for
//     a UR5, robot geometry folded in as constants)
//   this file.
//
// Design. One thread owns one scenario for the whole horizon: q and dq
// stay in registers across all N waypoints and intRes substeps, which is
// what the TPU kernel's VMEM scratch carry did across its sequential grid
// axis. Blocks never depend on each other. A block of T threads owns T
// consecutive scenarios and walks the horizon in chunks of MPT_CHUNK
// waypoints. For chunk k:
//   load:  chunk k+1's torques of the block's scenarios (T runs of c * n
//          contiguous floats in the row-major (B, N, n) tensor) start on
//          their way into the other tau tile by cp.async, element i by
//          thread i mod T, so consecutive threads read consecutive
//          addresses; then the block waits for chunk k's, and meets;
//   steps: each thread runs its scenario's c waypoints, reading tau from
//          its own tile row and writing the pre-step q and dq and the last
//          substep's ddq to its rows of three more tiles (the values, and
//          the order, of the Pallas kernel body); the block meets;
//   store: the three tiles back to (B, N, n), as coalesced as the load.
// Two __syncthreads() a chunk. Threads past B take part in every phase and
// barrier and only skip their loads, stores and steps; no thread returns
// early.
//
// Tiles. Five of T rows each, a row MPT_CHUNK * n floats rounded up to an
// odd count, so in the steps phase the 32 lanes' rows start in 32 distinct
// banks and their reads and writes do not conflict. Dynamic shared memory,
// 5 * T * MPT_ROW * 4 bytes a block: UR5 (n = 6, chunk 3, rows of 19)
// 48640 bytes at T = 128, Panda 53760, so as many blocks still fit an SM as
// the registers allow (UR5 at intRes 1, 128 registers: 4 blocks of 128; at
// intRes 3, 168: 3; Panda, 255: 2). Above the 48 KB default, `prepare`
// raises the limit with cudaFuncSetAttribute, once per device.
//
// Bound. The step program is ~3k scalar f32 operations per scenario per
// substep (UR5), against 4 * 4 * n bytes loaded and stored per waypoint;
// DRAM bytes are far from the limit (~0.63 GB per UR5 B=131072 N=50 call,
// ~0.19 ms at 3.35 TB/s), operations bound it (0.58 ms at one f32
// instruction per lane per clock). The one-thread-per-row kernel this
// design replaced read and wrote (B, N, n) in place, its neighbouring
// threads 1200 bytes apart, so every warp-wide 4-byte access cost 32 sector
// transactions: 3.19-3.36 ms, against 0.76 ms with no per-waypoint traffic
// and 1.10-1.16 ms staged (UR5, B=131072, N=50, H100 80GB HBM3 at 700 W).
// At the planning path's B = 1024 a launch fills 8 SMs with one warp a
// scheduler, and the loads' latency was the old kernel's other cost: 6.24
// ms, 4.11 with no per-waypoint traffic, 4.74-4.79 staged with the
// prefetch. Blocks of 32 threads (a unit built with MPT_BLOCK 32) spread
// that launch over 32 SMs but took 5.24-5.38 ms, so one block size, 128,
// serves both shapes.
//
// The phases are plain functions of the thread index: a host harness
// compiles this file with `__device__` defined away and MPT_HOST_TEAM
// defined, so that each phase runs threads 0..T-1 in turn
// (tests/test_torch_rollout.py).

#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifndef MPT_NJ
#error "MPT_NJ must be defined before rollout.cuh"
#endif
#ifndef MPT_INT_RES
#error "MPT_INT_RES must be defined before rollout.cuh"
#endif
#ifndef MPT_CHUNK
#error "MPT_CHUNK must be defined before rollout.cuh"
#endif
#ifndef MPT_BLOCK
#error "MPT_BLOCK must be defined before rollout.cuh"
#endif

#define MPT_CN (MPT_CHUNK * MPT_NJ)  // floats of one scenario's chunk
#define MPT_ROW (MPT_CN | 1)         // a tile row, an odd number of floats
// Tile k of a block of T threads starts at tiles + k * T * MPT_ROW: 0 and 1
// the torques of even and odd chunks, 2, 3 and 4 the chunk's q, dq, ddq.
#define MPT_TILES 5
#define MPT_TILE_FLOATS(T) ((size_t)MPT_TILES * (T) * MPT_ROW)

// Initial state of scenario b into the thread's registers.
static __device__ __forceinline__ void rollout_init(
    int b, int B, const float* __restrict__ q0, const float* __restrict__ dq0,
    float* q, float* dq) {
  if (b < B) {
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      q[j] = q0[(size_t)b * MPT_NJ + j];
      dq[j] = dq0[(size_t)b * MPT_NJ + j];
    }
  }
}

// The thread index, opaque to the compiler. The copies' index arithmetic
// depends on nothing but the thread, so the compiler would hoist all
// 2 * MPT_CN of its results out of the chunk loop and hold them in
// registers across the steps: the UR5 kernel went from 168 registers to
// 255 and spilled. Derived from this value, it is redone at every copy.
static __device__ __forceinline__ int rollout_opaque(int x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(x));
#endif
  return x;
}

// One float from global to shared memory where `ok`. On the card an
// asynchronous copy (cp.async, zero-filled where not `ok`), which holds no
// register and does not stall the thread: a chunk's torques arrive while
// the block steps through the chunk before it. rollout_commit closes a
// group of them, rollout_wait completes all but the last group.
static __device__ __forceinline__ void rollout_copy(float* dst, const float* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned int to = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(to), "l"(src), "r"(ok ? 4 : 0) : "memory");
#else
  if (ok) *dst = *src;
#endif
}

static __device__ __forceinline__ void rollout_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

static __device__ __forceinline__ void rollout_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Load: the torques of waypoints w0 .. w0+c-1 of scenarios b0 .. b0+T-1
// into `tile`, one group of copies (empty when c <= 0). Element i of the
// block's T x MPT_CN chunk is thread (i mod T)'s: scenario i / MPT_CN of
// the block, float i % MPT_CN of its run.
template <int T>
static __device__ __forceinline__ void rollout_load(
    int tid, float* __restrict__ tile, const float* __restrict__ tau,
    int b0, int B, int N, int w0, int c) {
  if (c > 0) {
    const int len = c * MPT_NJ, me = rollout_opaque(tid);
#pragma unroll
    for (int r = 0; r < MPT_CN; ++r) {
      const int i = r * T + me;
      const int s = i / MPT_CN, k = i % MPT_CN;
      const bool ok = k < len && b0 + s < B;
      rollout_copy(tile + s * MPT_ROW + k,
                   ok ? tau + ((size_t)(b0 + s) * N + w0) * MPT_NJ + k : tau, ok);
    }
  }
  rollout_commit();
}

// Steps: c waypoints of scenario b = b0 + tid from its registers, reading
// tau from row tid of tile `buf` (0 or 1) and writing q, dq (before the
// step) and ddq (of the last substep) to row tid of tiles 2, 3 and 4.
template <int T>
static __device__ __forceinline__ void rollout_steps(
    int tid, float* __restrict__ tiles, int buf, float* q, float* dq, int b,
    int B, int c) {
  if (b < B) {
    const float* tau_row = tiles + (buf * T + tid) * MPT_ROW;
    float* q_row = tiles + (2 * T + tid) * MPT_ROW;
    float* dq_row = tiles + (3 * T + tid) * MPT_ROW;
    float* ddq_row = tiles + (4 * T + tid) * MPT_ROW;
    float t[MPT_NJ], ddq[MPT_NJ];
    for (int w = 0; w < c; ++w) {
#pragma unroll
      for (int j = 0; j < MPT_NJ; ++j) {
        q_row[w * MPT_NJ + j] = q[j];
        dq_row[w * MPT_NJ + j] = dq[j];
        t[j] = tau_row[w * MPT_NJ + j];
      }
      for (int s = 0; s < MPT_INT_RES; ++s) fd_step(q, dq, t, ddq);
#pragma unroll
      for (int j = 0; j < MPT_NJ; ++j) ddq_row[w * MPT_NJ + j] = ddq[j];
    }
  }
}

// Store: tiles 2-4, waypoints w0 .. w0+c-1 of the block's scenarios, to
// qs, dqs and ddqs, element by element as the load reads them. The tile
// reads need no guard (they stay inside the tiles), so they do not wait on
// the stores' branches.
template <int T>
static __device__ __forceinline__ void rollout_store(
    int tid, const float* __restrict__ tiles, float* __restrict__ qs,
    float* __restrict__ dqs, float* __restrict__ ddqs, int b0, int B, int N,
    int w0, int c) {
  const int len = c * MPT_NJ, me = rollout_opaque(tid);
#pragma unroll
  for (int r = 0; r < MPT_CN; ++r) {
    const int i = r * T + me;
    const int s = i / MPT_CN, k = i % MPT_CN, from = s * MPT_ROW + k;
    const float q = tiles[2 * T * MPT_ROW + from];
    const float dq = tiles[3 * T * MPT_ROW + from];
    const float ddq = tiles[4 * T * MPT_ROW + from];
    if (k < len && b0 + s < B) {
      const size_t at = ((size_t)(b0 + s) * N + w0) * MPT_NJ + k;
      qs[at] = q;
      dqs[at] = dq;
      ddqs[at] = ddq;
    }
  }
}

// A phase: on the card the calling thread runs it and the block meets at
// __syncthreads(); in the host harness (MPT_HOST_TEAM) threads 0..T-1 run it
// one after the other before the next phase, each with its own registers.
// MPT_EACH is a phase without the barrier, MPT_SYNC a barrier after a call
// that is no thread's own.
#if defined(MPT_HOST_TEAM)
#define MPT_EACH(call)                            \
  do {                                            \
    for (int tid = 0; tid < T; ++tid) { call; }   \
  } while (0)
#define MPT_PHASE(call) MPT_EACH(call)
#define MPT_SYNC(call) call
#define MPT_OWN(x) x[tid]
#define MPT_STATE_DECL float q[T][MPT_NJ], dq[T][MPT_NJ]
#else
#define MPT_EACH(call)      \
  do {                      \
    const int tid = my_tid; \
    call;                   \
  } while (0)
#define MPT_PHASE(call) \
  do {                  \
    MPT_EACH(call);     \
    __syncthreads();    \
  } while (0)
#define MPT_SYNC(call) \
  do {                 \
    call;              \
    __syncthreads();   \
  } while (0)
#define MPT_OWN(x) x
#define MPT_STATE_DECL float q[MPT_NJ], dq[MPT_NJ]
#endif

// The whole horizon of scenarios b0 .. b0+T-1, by the block whose thread
// this is; every thread runs every phase. Chunk k's torques are in tile
// k & 1: the load of chunk k+1 goes to the tile that chunk k-1's steps
// read before the last barrier, and the barrier after rollout_wait also
// keeps chunk k's steps from overwriting q, dq, ddq before chunk k-1's
// store has read them.
template <int T>
static __device__ __forceinline__ void rollout_block(
    int my_tid, float* __restrict__ tiles, const float* __restrict__ q0,
    const float* __restrict__ dq0, const float* __restrict__ tau,
    float* __restrict__ qs, float* __restrict__ dqs, float* __restrict__ ddqs,
    int b0, int B, int N) {
  MPT_STATE_DECL;
  (void)my_tid;
  MPT_EACH(rollout_init(b0 + tid, B, q0, dq0, MPT_OWN(q), MPT_OWN(dq)));
  MPT_EACH(rollout_load<T>(tid, tiles, tau, b0, B, N, 0, N < MPT_CHUNK ? N : MPT_CHUNK));
  for (int w0 = 0, k = 0; w0 < N; w0 += MPT_CHUNK, ++k) {
    const int c = N - w0 < MPT_CHUNK ? N - w0 : MPT_CHUNK, next = w0 + c;
    float* other = tiles + ((k + 1) & 1) * T * MPT_ROW;
    MPT_EACH(rollout_load<T>(tid, other, tau, b0, B, N, next,
                             N - next < MPT_CHUNK ? N - next : MPT_CHUNK));
    MPT_SYNC(rollout_wait());
    MPT_PHASE(rollout_steps<T>(tid, tiles, k & 1, MPT_OWN(q), MPT_OWN(dq), b0 + tid, B, c));
    MPT_EACH(rollout_store<T>(tid, tiles, qs, dqs, ddqs, b0, B, N, w0, c));
  }
}

// The tiles' dynamic shared bytes a block, on the card and to the host.
#define MPT_SMEM_BYTES (MPT_TILE_FLOATS(MPT_BLOCK) * sizeof(float))
extern "C" long long mpt_layout_rollout(void) { return (long long)MPT_SMEM_BYTES; }

#ifdef __CUDACC__

__global__ void __launch_bounds__(MPT_BLOCK) mpt_rollout_kernel(
    const float* __restrict__ q0, const float* __restrict__ dq0,
    const float* __restrict__ tau, float* __restrict__ qs,
    float* __restrict__ dqs, float* __restrict__ ddqs, int B, int N) {
  extern __shared__ float mpt_tiles[];
  rollout_block<MPT_BLOCK>((int)threadIdx.x, mpt_tiles, q0, dq0, tau, qs, dqs,
                           ddqs, (int)(blockIdx.x * MPT_BLOCK), B, N);
}

// Lets the kernel take its tiles' dynamic shared bytes on the current
// device: once per device, before its first launch there.
extern "C" int prepare() {
  return (int)cudaFuncSetAttribute(mpt_rollout_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)MPT_SMEM_BYTES);
}

// q0, dq0: (B, n); tau, qs, dqs, ddqs: (B, N, n); all f32, contiguous, on
// the current device, which `prepare` has seen. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int launch(const float* q0, const float* dq0, const float* tau,
                      float* qs, float* dqs, float* ddqs, int B, int N,
                      void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const unsigned int blocks = (unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK);
  mpt_rollout_kernel<<<blocks, MPT_BLOCK, MPT_SMEM_BYTES, (cudaStream_t)stream>>>(
      q0, dq0, tau, qs, dqs, ddqs, B, N);
  return (int)cudaGetLastError();
}

// Registers per thread, local bytes per thread, the largest block, static
// and dynamic shared bytes a block, and the blocks an SM holds with the
// tiles and without them, on the current device.
extern "C" int kernel_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, mpt_rollout_kernel);
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)prepare();
  if (err != cudaSuccess) return (int)err;
  int with_tiles = 0, without = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &with_tiles, mpt_rollout_kernel, MPT_BLOCK, MPT_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &without, mpt_rollout_kernel, MPT_BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)MPT_SMEM_BYTES;
  out[5] = with_tiles;
  out[6] = without;
  return 0;
}
#endif
