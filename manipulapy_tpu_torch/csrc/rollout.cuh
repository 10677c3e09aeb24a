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
//   #define MPT_BLOCK <threads>  threads per block
//   the generated `fd_step(q, dq, tau, ddq)` device function
//     (ops/fd_step.py::build_fd_step_source: ~3k straight-line f32 ops for
//     a UR5, robot geometry folded in as constants)
//   this file.
//
// Design. One thread owns one scenario for the whole horizon: q and dq
// stay in registers across all N waypoints and intRes substeps, which is
// what the TPU kernel's VMEM scratch carry did across its sequential grid
// axis. Blocks never depend on each other, so there is no ordering to
// keep. At each waypoint the thread writes the pre-step q and dq, runs the
// substeps, then writes the last substep's ddq (the order of the Pallas
// kernel body). The guard `b < B` replaces the TPU's padding to
// 1024-scenario tiles.
//
// Bound. The step program is ~3k scalar f32 operations per scenario per
// substep (UR5), against 4 * 4 * n bytes loaded and stored per waypoint;
// DRAM bytes are far from the limit (~0.63 GB per UR5 B=131072 N=50 call,
// ~0.19 ms at 3.35 TB/s). What bounds it is the access pattern: the
// (B, N, n) row-major tensors are read and written in place, so the
// neighbouring threads of a warp touch addresses N * n * 4 bytes apart and
// every warp-wide 4-byte access costs 32 sector transactions. Measured on
// an H100 80GB HBM3 at 700 W (UR5, B=131072, N=50): 3.21 ms as shipped,
// 0.84 ms with the per-waypoint loads and stores removed. Staging rows
// through shared memory, or a (..., n, B) layout, is the next step.

#include <cuda_runtime.h>
#include <stddef.h>

#ifndef MPT_NJ
#error "MPT_NJ must be defined before rollout.cuh"
#endif
#ifndef MPT_INT_RES
#error "MPT_INT_RES must be defined before rollout.cuh"
#endif
#ifndef MPT_BLOCK
#define MPT_BLOCK 128
#endif

__global__ void __launch_bounds__(MPT_BLOCK) mpt_rollout_kernel(
    const float* __restrict__ q0, const float* __restrict__ dq0,
    const float* __restrict__ tau, float* __restrict__ qs,
    float* __restrict__ dqs, float* __restrict__ ddqs, int B, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float q[MPT_NJ], dq[MPT_NJ], t[MPT_NJ], ddq[MPT_NJ];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) {
    q[j] = q0[(size_t)b * MPT_NJ + j];
    dq[j] = dq0[(size_t)b * MPT_NJ + j];
  }
  const size_t first = (size_t)b * (size_t)N * MPT_NJ;
  for (int w = 0; w < N; ++w) {
    const size_t row = first + (size_t)w * MPT_NJ;
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      qs[row + j] = q[j];
      dqs[row + j] = dq[j];
      t[j] = tau[row + j];
    }
    for (int s = 0; s < MPT_INT_RES; ++s) fd_step(q, dq, t, ddq);
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) ddqs[row + j] = ddq[j];
  }
}

// q0, dq0: (B, n); tau, qs, dqs, ddqs: (B, N, n); all f32, contiguous, on
// the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int launch(const float* q0, const float* dq0, const float* tau,
                      float* qs, float* dqs, float* ddqs, int B, int N,
                      void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const unsigned int blocks = (unsigned int)((B + MPT_BLOCK - 1) / MPT_BLOCK);
  mpt_rollout_kernel<<<blocks, MPT_BLOCK, 0, (cudaStream_t)stream>>>(
      q0, dq0, tau, qs, dqs, ddqs, B, N);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes per thread and the largest
// block the kernel can launch with, as the runtime reports them.
extern "C" int kernel_attributes(int* num_regs, int* local_bytes,
                                 int* max_threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mpt_rollout_kernel);
  if (err != cudaSuccess) return (int)err;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}
