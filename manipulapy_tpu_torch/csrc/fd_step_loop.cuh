// The exact-dynamics step program (K0) as a loop over links, the robot's
// geometry read from a table, for Hopper (sm_90a).
//
// Replaces, in the rollout kernel (csrc/rollout.cuh with MPT_LOOP_STEP),
// the emitted straight-line step of ops/fd_step.py::build_fd_step_source,
// the port of manipulapy_tpu/ops/fd_step.py:274 (build_fd_step_planes),
// which the Pallas rollout kernel inlines.
//
// This file is a template. ops/cuda_rollout.py writes one translation unit
// per (joint count, intRes) that holds, in order:
//   #define MPT_NJ <n>             number of joints
//   the table's layout, MPT_TAB_* (ops/fd_step.py::table_defines)
//   this file, then csrc/rollout.cuh with MPT_LOOP_STEP defined.
// Every robot of n joints runs the same unit: the robot, dt and g are the
// table (ops/fd_step.py::link_table), a kernel argument.
//
// Why. The emitted step is one statement per operation with the geometry
// folded in: 2745-7732 statements a step on the calibrated fleet, whose
// rollout's rate fell by half between 5662 and 5878 statements while the
// smaller programs ran at 15.8-20.2e12 statements/s (H100 80GB HBM3, 700 W,
// PERF.md §5): each SM fetches the whole program once per step of every
// warp, and past the instruction cache the fetch bounds it. Here the
// per-link work is written once and runs n times, so the code is a few
// times the work of one link (~0.4-0.7k operations) however many links.
//
// What one step computes (the plain version, operation for operation, is
// ops/fd_step.py::fd_step_loop_planes): one pass over the links k = 0..n-1
//   * Td = exp(-[A_k] q_k) M_prev_k^-1, link k-1's CoM frame to link k's;
//   * JB_i <- Ad(Td) JB_i for i < k, JB_k = A_k: link k's CoM Jacobian;
//   * V, Vd <- the RNEA's forward sweep (ddq = 0, Vd starting at [0; -g],
//     so gravity enters as the base's acceleration);
//   * F = G_k Vd - ad_V^T G_k V, link k's wrench;
//   * M[i][j] += JB_i . G_k JB_j (i <= j <= k), bias[i] += JB_i . F: the
//     mass matrix from the CoM Jacobians, and the RNEA's backward sweep as
//     the sum of J^T F over the links, so no link's values are kept for a
//     second pass;
// then the Cholesky solve of M ddq = tau - bias, semi-implicit Euler and
// the clamps (a clamp of zero width gives +0.0, as ops/cgen.py::clip).
//
// Registers. The loop over links is not unrolled (#pragma unroll 1); every
// loop inside it runs over joints, is unrolled to MPT_NJ and is guarded by
// the link index (i < k, i == k, j <= k), so every register array (the
// Jacobian columns JB, M's upper triangle, bias, V and Vd) is indexed by
// compile-time constants only and stays in registers: an array indexed by
// k itself would go to local memory. q_k and dq_k are picked from their
// arrays the same way. The link's row of the table is read with k, the
// same for every lane.
//
// The table is a __grid_constant__ kernel parameter (rollout.cuh's
// MptTable, 4 + 49 n floats: 1584 bytes at n = 8), not a __constant__
// array written before the launch: the parameter travels with its launch,
// so two robots of the same n, one library, launched on two streams cannot
// see each other's table; and a row read with the warp-uniform k is one
// constant-bank read that every lane shares.
//
// Bound. The operations: ops/fd_step.py::loop_step_ops counts 389 / 4129 /
// 5337 / 6731 a step at n = 1 / 6 / 7 / 8, about as many as the emitted
// program's 4336-7732 statements for the 6- to 8-joint calibrated arms and
// more than the short ones' (2745 for the ABB): the emitted program folds
// the geometry's zeros and ones, the loop does every operation. The route
// (ops/cuda_rollout.py::step_form) takes this form where it is faster.
//
// Parity. The unit builds with --fmad=false and no fast math, as every
// unit: each operation rounds once, as each eager operation of the plain
// version does; sinf, cosf and sqrtf are the library's, 1.0f / d the IEEE
// division, formed once per pivot outside the solve's loops.

#ifndef MPT_NJ
#error "MPT_NJ must be defined before fd_step_loop.cuh"
#endif
#ifndef MPT_TAB_HEAD
#error "the table's layout (ops/fd_step.py::table_defines) must be defined before fd_step_loop.cuh"
#endif

#define MPT_TAB_FLOATS (MPT_TAB_HEAD + MPT_NJ * MPT_TAB_STRIDE)

static __device__ __forceinline__ float mpt_dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

static __device__ __forceinline__ float mpt_dot6(const float* a, const float* b) {
  return ((((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3]) + a[4] * b[4]) + a[5] * b[5];
}

// c = a x b.
static __device__ __forceinline__ void mpt_cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// x <- Ad(T) x for T = (R, p) and a twist x = [w; v]: [R w; p x (R w) + R v].
static __device__ __forceinline__ void mpt_ad(const float* R, const float* p, float* x) {
  float w[3], Rv[3], c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = mpt_dot3(R + 3 * i, x);
    Rv[i] = mpt_dot3(R + 3 * i, x + 3);
  }
  mpt_cross(p, w, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = w[i];
    x[3 + i] = c[i] + Rv[i];
  }
}

// out = G x for G = [[I, 0], [0, m 1]].
static __device__ __forceinline__ void mpt_inertia(const float* I, float m, const float* x, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = mpt_dot3(I + 3 * i, x);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = m * x[3 + i];
}

// x clamped to [lo, hi]; an infinite bound leaves x, NaN stays NaN, and a
// clamp of zero width gives the bound as +0.0 where it is zero.
static __device__ __forceinline__ float mpt_clamp(float x, float lo, float hi) {
  if (lo == hi) return x != x ? x : hi + 0.0f;
  return x < lo ? lo : (x > hi ? hi : x);
}

// One step: q and dq updated in place, ddq written; `tab` is the robot's
// table (MPT_TAB_FLOATS floats).
static __device__ __forceinline__ void fd_step_loop(
    float q[MPT_NJ], float dq[MPT_NJ], const float tau[MPT_NJ], float ddq[MPT_NJ],
    const float* __restrict__ tab) {
  float V[6], Vd[6], JB[MPT_NJ][6], M[MPT_NJ][MPT_NJ], bias[MPT_NJ];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[i] = 0.0f;
    V[3 + i] = 0.0f;
    Vd[i] = 0.0f;
    Vd[3 + i] = -tab[MPT_TAB_G + i];
  }
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    bias[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 6; ++e) JB[i][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) M[i][j] = 0.0f;
  }

#pragma unroll 1
  for (int k = 0; k < MPT_NJ; ++k) {
    const float* L = tab + MPT_TAB_HEAD + k * MPT_TAB_STRIDE;
    const float* A = L + MPT_TAB_A;
    float qk = q[0], dqk = dq[0];
#pragma unroll
    for (int i = 1; i < MPT_NJ; ++i) {
      if (i == k) {
        qk = q[i];
        dqk = dq[i];
      }
    }
    const float s = sinf(qk), c = cosf(qk);
    // Td = exp(-[A] q_k) M_prev^-1: at -q, sin is -s and 1 - cos is 1 - c.
    const float th = -qk, sn = -s, omc = 1.0f - c;
    const float tms = th - sn;
    const float w0 = A[0], w1 = A[1], w2 = A[2];
    const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
    float Re[9], pe[3], R[9], p[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      Re[i] = (i % 4 == 0) ? 1.0f + omc * L[MPT_TAB_W2 + i]
                           : sn * W[i] + omc * L[MPT_TAB_W2 + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pe[i] = th * A[3 + i] + (omc * L[MPT_TAB_WV + i] + tms * L[MPT_TAB_W2V + i]);
    }
    const float* Rc = L + MPT_TAB_MPREV_R;
    const float* pc = L + MPT_TAB_MPREV_P;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        R[3 * i + j] = (Re[3 * i] * Rc[j] + Re[3 * i + 1] * Rc[3 + j]) + Re[3 * i + 2] * Rc[6 + j];
      }
      p[i] = mpt_dot3(Re + 3 * i, pc) + pe[i];
    }

    // Link k's CoM Jacobian: the earlier columns into its frame, its own.
#pragma unroll
    for (int i = 0; i < MPT_NJ; ++i) {
      if (i < k) {
        mpt_ad(R, p, JB[i]);
      } else if (i == k) {
#pragma unroll
        for (int e = 0; e < 6; ++e) JB[i][e] = A[e];
      }
    }

    // The RNEA's forward sweep (ddq = 0).
    float Adq[6], top[3], c1[3], c2[3];
#pragma unroll
    for (int e = 0; e < 6; ++e) Adq[e] = A[e] * dqk;
    mpt_ad(R, p, V);
#pragma unroll
    for (int e = 0; e < 6; ++e) V[e] = V[e] + Adq[e];
    mpt_ad(R, p, Vd);
    mpt_cross(V, Adq, top);
    mpt_cross(V + 3, Adq, c1);
    mpt_cross(V, Adq + 3, c2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Vd[i] = Vd[i] + top[i];
      Vd[3 + i] = Vd[3 + i] + (c1[i] + c2[i]);
    }

    // F = G Vd - ad_V^T G V = G Vd + [w x Gw + v x Gv; w x Gv].
    const float* I = L + MPT_TAB_I;
    const float m = L[MPT_TAB_M];
    float GV[6], GVd[6], F[6], c3[3];
    mpt_inertia(I, m, V, GV);
    mpt_inertia(I, m, Vd, GVd);
    mpt_cross(V, GV, c1);
    mpt_cross(V + 3, GV + 3, c2);
    mpt_cross(V, GV + 3, c3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      F[i] = GVd[i] + (c1[i] + c2[i]);
      F[3 + i] = GVd[3 + i] + c3[i];
    }

    // M[i][j] += JB_i . G JB_j, bias[j] += JB_j . F; the first term of each
    // (at k == j) is set, not added.
#pragma unroll
    for (int j = 0; j < MPT_NJ; ++j) {
      if (j <= k) {
        float GJ[6];
        mpt_inertia(I, m, JB[j], GJ);
#pragma unroll
        for (int i = 0; i <= j; ++i) {
          const float d = mpt_dot6(JB[i], GJ);
          M[i][j] = (j == k) ? d : M[i][j] + d;
        }
        const float d = mpt_dot6(JB[j], F);
        bias[j] = (j == k) ? d : bias[j] + d;
      }
    }
  }

  // M ddq = tau - bias by Cholesky (ops/fd_step.py::_chol_solve_values),
  // M's lower triangle read from its upper.
  float Lc[MPT_NJ][MPT_NJ], inv_diag[MPT_NJ], y[MPT_NJ], x[MPT_NJ];
#pragma unroll
  for (int j = 0; j < MPT_NJ; ++j) {
    float s = M[j][j];
#pragma unroll
    for (int kk = 0; kk < j; ++kk) s = s - Lc[j][kk] * Lc[j][kk];
    const float d = sqrtf(s);
    Lc[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < MPT_NJ; ++i) {
      float t = M[j][i];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) t = t - Lc[i][kk] * Lc[j][kk];
      Lc[i][j] = t * inv_d;
    }
  }
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) inv_diag[i] = 1.0f / Lc[i][i];
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    float s = tau[i] - bias[i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) s = s - Lc[i][kk] * y[kk];
    y[i] = s * inv_diag[i];
  }
#pragma unroll
  for (int i = MPT_NJ - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int kk = i + 1; kk < MPT_NJ; ++kk) s = s - Lc[kk][i] * x[kk];
    x[i] = s * inv_diag[i];
  }

  // Semi-implicit Euler and the clamps.
  const float dt = tab[MPT_TAB_DT];
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float* Li = tab + MPT_TAB_HEAD + i * MPT_TAB_STRIDE;
    ddq[i] = x[i];
    const float dqi = dq[i] + x[i] * dt;
    q[i] = mpt_clamp(q[i] + dqi * dt, Li[MPT_TAB_LOWER], Li[MPT_TAB_UPPER]);
    const float vel = Li[MPT_TAB_VEL];
    dq[i] = mpt_clamp(dqi, -vel, vel);
  }
}
