// Elementwise planning kernels (K9, K10) for Hopper (sm_90a).
//
// Replace the two Pallas kernels of manipulapy_tpu/ops/pallas_kernels.py:
//   K9  trajectory  _traj_kernel       (pallas_call in `trajectory_pallas`)
//   K10 potential   _potential_kernel  (pallas_call in
//                                       `cartesian_potential_pallas`)
//
// Neither kernel has robot constants, so this file is one static translation
// unit: ops/elementwise.py hands it to nvcc as it is, once.
//
// K9: point-to-point joint trajectories. (B, J) start and end, a duration Tf
// and N waypoints give pos, vel, acc, each (B, N, J) row-major:
//   tau = clip(t / (N - 1), 0, 1), (s, s', s'') cubic / quintic / linear in
//   tau with 1 / Tf multiplied in, pos = start + s d, vel = s' d, acc = s'' d,
//   d = end - start. Positions are not clipped to the joint limits here.
//   Design: one thread per output element of the final layout, in a
//   grid-stride loop, so the three stores of a warp are 128 contiguous bytes
//   each and no relayout follows (the TPU kernel put time on its 128 lanes
//   and paid a (B, J, N) -> (B, N, J) transpose outside). The method is a
//   template argument. The index is 64-bit, so any B*N*J that fits the
//   card's memory is served by the one kernel.
//   Bound: bytes. 12 bytes written per element against ~20 operations; the
//   endpoints (B*J*8 bytes) are read through the cache.
//
// K10: Cartesian potential field. (P, 3) points, a goal (3), (O, 3) obstacle
// points and an influence distance d0 give U (P) and its gradient (P, 3):
//   U = 1/2 |p - goal|^2 + sum_o [d < d0] 1/2 (1/d - 1/d0)^2,
//   grad = (p - goal) + sum_o [d < d0] -(1/d - 1/d0) / d^3 (p - o),
//   d = |p - o|, floored at 1e-9 in the reciprocals.
//   Design: one thread per point, U and the gradient in registers, a run-time
//   loop over the obstacles, which each block stages once in shared memory
//   (in tiles of MPT_OBS_TILE, so any O fits); the points are read and the
//   outputs written in their public row-major layout (the TPU kernel wanted
//   a (3, P) transpose and kept the obstacles in SMEM). sqrtf and the
//   divisions are IEEE (nvcc's defaults; no fast math).
//   Bound: operations for O above ~9 (about 26 per point and obstacle against
//   28 bytes per point), bytes below.
//
// Built with --fmad=false and written in the order of the Pallas kernels'
// arithmetic, so each kernel agrees bitwise with its plain PyTorch version
// (ops/elementwise.py: trajectory_plain, cartesian_potential_plain).
//
// The per-element bodies (`traj_element`, `potential_init`,
// `potential_accumulate`) are plain functions: a host harness compiles this
// file with `__device__` defined away and runs them in a loop
// (tests/test_torch_elementwise.py).

#include <math.h>
#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define MPT_EW_BLOCK 256      // threads per block, both kernels
#define MPT_OBS_TILE 1024     // obstacles staged per tile: 12 KB of shared memory
#define MPT_TRAJ_WAVES 16     // K9: blocks per SM before the grid-stride loop takes over

// ---------------------------------------------------------------- K9 -----
// METHOD 3: cubic, 5: quintic, anything else: linear. `t` is the waypoint,
// `n1` = N - 1 as a float, `inv_tf` = 1 / Tf.
template <int METHOD>
static __device__ __forceinline__ void traj_element(
    float start, float end, float t, float n1, float inv_tf,
    float* pos, float* vel, float* acc) {
  float tau = t / n1;
  tau = tau < 0.0f ? 0.0f : (tau > 1.0f ? 1.0f : tau);
  float s, s_dot, s_ddot;
  if (METHOD == 3) {
    s = 3.0f * (tau * tau) - 2.0f * (tau * tau * tau);
    s_dot = 6.0f * tau * (1.0f - tau) * inv_tf;
    s_ddot = 6.0f * (1.0f - 2.0f * tau) * inv_tf * inv_tf;
  } else if (METHOD == 5) {
    const float tau2 = tau * tau;
    const float tau3 = tau2 * tau;
    const float tau4 = tau2 * tau2;
    s = 10.0f * tau3 - 15.0f * tau4 + 6.0f * tau4 * tau;
    s_dot = (30.0f * tau2 - 60.0f * tau3 + 30.0f * tau4) * inv_tf;
    s_ddot = (60.0f * tau - 180.0f * tau2 + 120.0f * tau3) * inv_tf * inv_tf;
  } else {
    s = tau;
    s_dot = inv_tf;
    s_ddot = 0.0f;
  }
  const float delta = end - start;
  *pos = start + s * delta;
  *vel = s_dot * delta;
  *acc = s_ddot * delta;
}

// Element i of the (B, N, J) outputs: j = i % J, t = (i / J) % N,
// b = i / (N * J).
typedef unsigned long long mpt_index;
template <int METHOD>
static __device__ __forceinline__ void traj_at(
    const float* __restrict__ start, const float* __restrict__ end,
    float* __restrict__ pos, float* __restrict__ vel, float* __restrict__ acc,
    mpt_index i, mpt_index N, mpt_index J, float n1, float inv_tf) {
  const mpt_index row = i / J;
  const mpt_index j = i - row * J;
  const mpt_index b = row / N;
  const mpt_index t = row - b * N;
  const mpt_index e = b * J + j;
  traj_element<METHOD>(start[e], end[e], (float)t, n1, inv_tf, pos + i, vel + i, acc + i);
}

#ifdef __CUDACC__
template <int METHOD>
__global__ void __launch_bounds__(MPT_EW_BLOCK) mpt_traj_kernel(
    const float* __restrict__ start, const float* __restrict__ end,
    float* __restrict__ pos, float* __restrict__ vel, float* __restrict__ acc,
    mpt_index total, mpt_index N, mpt_index J, float Tf) {
  const float n1 = (float)(N - 1);
  const float inv_tf = 1.0f / Tf;
  const mpt_index stride = (mpt_index)gridDim.x * blockDim.x;
  for (mpt_index i = (mpt_index)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride)
    traj_at<METHOD>(start, end, pos, vel, acc, i, N, J, n1, inv_tf);
}

template <int METHOD>
static int launch_traj(const float* start, const float* end, float* pos,
                       float* vel, float* acc, long long B, long long N,
                       long long J, float Tf, cudaStream_t stream) {
  const long long total = B * N * J;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (total + MPT_EW_BLOCK - 1) / MPT_EW_BLOCK;
  const long long cap = (long long)sms * MPT_TRAJ_WAVES;
  if (blocks > cap) blocks = cap;
  mpt_traj_kernel<METHOD><<<(unsigned int)blocks, MPT_EW_BLOCK, 0, stream>>>(
      start, end, pos, vel, acc, (mpt_index)total, (mpt_index)N, (mpt_index)J, Tf);
  return (int)cudaGetLastError();
}

// start, end: (B, J); pos, vel, acc: (B, N, J); all f32, contiguous, on the
// current device. Tf > 0, N > 1 and B, J >= 1 (the wrapper checks, and
// answers empty work itself). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int launch_trajectory(const float* start, const float* end,
                                 float* pos, float* vel, float* acc,
                                 long long B, long long N, long long J,
                                 float Tf, int method, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (method == 3) return launch_traj<3>(start, end, pos, vel, acc, B, N, J, Tf, s);
  if (method == 5) return launch_traj<5>(start, end, pos, vel, acc, B, N, J, Tf, s);
  return launch_traj<1>(start, end, pos, vel, acc, B, N, J, Tf, s);
}
#endif  // __CUDACC__

// --------------------------------------------------------------- K10 -----
// The attractive part: U = 1/2 |p - goal|^2 and grad = p - goal.
static __device__ __forceinline__ void potential_init(
    float px, float py, float pz, const float* __restrict__ goal,
    float* u, float* gx, float* gy, float* gz) {
  const float dx = px - goal[0];
  const float dy = py - goal[1];
  const float dz = pz - goal[2];
  *u = 0.5f * (dx * dx + dy * dy + dz * dz);
  *gx = dx;
  *gy = dy;
  *gz = dz;
}

// Add the repulsive terms of `count` obstacles (x, y, z triples at `obs`), in
// order.
static __device__ __forceinline__ void potential_accumulate(
    float px, float py, float pz, const float* obs, int count, float d0,
    float inv_d0, float* u, float* gx, float* gy, float* gz) {
  float uu = *u, ax = *gx, ay = *gy, az = *gz;
  for (int o = 0; o < count; ++o) {
    const float ox = px - obs[3 * o + 0];
    const float oy = py - obs[3 * o + 1];
    const float oz = pz - obs[3 * o + 2];
    const float d2 = ox * ox + oy * oy + oz * oz;
    const float d = sqrtf(d2);
    const float d_safe = d > 1e-9f ? d : 1e-9f;
    const bool inside = d < d0;
    const float inv_d = 1.0f / d_safe;
    const float diff_inv = inv_d - inv_d0;
    uu = uu + (inside ? 0.5f * diff_inv * diff_inv : 0.0f);
    const float coeff = inside ? -diff_inv * inv_d * inv_d * inv_d : 0.0f;
    ax = ax + coeff * ox;
    ay = ay + coeff * oy;
    az = az + coeff * oz;
  }
  *u = uu;
  *gx = ax;
  *gy = ay;
  *gz = az;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MPT_EW_BLOCK) mpt_potential_kernel(
    const float* __restrict__ points, const float* __restrict__ goal,
    const float* __restrict__ obstacles, float* __restrict__ U,
    float* __restrict__ grad, int P, int O, float d0, float inv_d0) {
  extern __shared__ float obs_s[];
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < (size_t)P;
  float px = 0.0f, py = 0.0f, pz = 0.0f, u = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (live) {
    px = points[p * 3 + 0];
    py = points[p * 3 + 1];
    pz = points[p * 3 + 2];
    potential_init(px, py, pz, goal, &u, &gx, &gy, &gz);
  }
  // Every thread of the block stages and waits, also the ones past P.
  for (int o0 = 0; o0 < O; o0 += MPT_OBS_TILE) {
    const int count = O - o0 < MPT_OBS_TILE ? O - o0 : MPT_OBS_TILE;
    if (o0 > 0) __syncthreads();  // the previous tile is still being read
    for (int e = threadIdx.x; e < 3 * count; e += blockDim.x)
      obs_s[e] = obstacles[(size_t)o0 * 3 + e];
    __syncthreads();
    if (live) potential_accumulate(px, py, pz, obs_s, count, d0, inv_d0, &u, &gx, &gy, &gz);
  }
  if (live) {
    U[p] = u;
    grad[p * 3 + 0] = gx;
    grad[p * 3 + 1] = gy;
    grad[p * 3 + 2] = gz;
  }
}

// points (P, 3), goal (3), obstacles (O, 3) -> U (P), grad (P, 3); all f32,
// contiguous, on the current device; P >= 1 (the wrapper answers P = 0
// itself), O may be 0. inv_d0 is 1 / d0 as the caller rounded it. Launches on `stream` and returns cudaGetLastError().
extern "C" int launch_potential(const float* points, const float* goal,
                                const float* obstacles, float* U, float* grad,
                                int P, int O, float d0, float inv_d0,
                                void* stream) {
  const unsigned int blocks = (unsigned int)(((long long)P + MPT_EW_BLOCK - 1) / MPT_EW_BLOCK);
  const int tile = O < MPT_OBS_TILE ? O : MPT_OBS_TILE;
  const size_t shared = (size_t)tile * 3 * sizeof(float);
  mpt_potential_kernel<<<blocks, MPT_EW_BLOCK, shared, (cudaStream_t)stream>>>(
      points, goal, obstacles, U, grad, P, O, d0, inv_d0);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes per thread, the largest block a
// kernel can launch with and its static shared bytes per block, as the
// runtime reports them.
static int kernel_attributes(const void* kernel, int* num_regs, int* local_bytes,
                             int* max_threads, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  *smem_bytes = (int)a.sharedSizeBytes;
  return 0;
}
// K9's are those of the quintic instance, the default method's.
extern "C" int attributes_trajectory(int* num_regs, int* local_bytes, int* max_threads,
                                     int* smem_bytes) {
  return kernel_attributes((const void*)mpt_traj_kernel<5>, num_regs, local_bytes,
                           max_threads, smem_bytes);
}
extern "C" int attributes_potential(int* num_regs, int* local_bytes, int* max_threads,
                                    int* smem_bytes) {
  return kernel_attributes((const void*)mpt_potential_kernel, num_regs, local_bytes,
                           max_threads, smem_bytes);
}
#endif  // __CUDACC__
