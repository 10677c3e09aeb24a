// The looped step's forward mode: one step of K0 as a loop over links, the
// robot's geometry in a table, and columns of its Jacobian, for Hopper
// (sm_90a).
//
// Replaces, in the batched linearization kernel (K2, csrc/mpc_batch.cuh
// with MPT_LIN_LOOP), the emitted straight-line fd_step_jvp_group of
// ops/fd_step.py::build_fd_step_jvp_group_source: jax.linearize of the
// step inside lin_kernel, manipulapy_tpu/mpc/fused_batch.py:214-242.
//
// This file is a template. ops/cuda_mpc_batch.py writes one translation
// unit per (joint count, seeds a thread) that holds, in order:
//   #define MPT_NJ <n>, MPT_LIN_SEEDS <G>, MPT_LIN_BLOCK, MPT_LIN_LOOP, ...
//   the table's layout, MPT_TAB_* (ops/fd_step.py::table_defines)
//   csrc/fd_step_loop.cuh, this file, then csrc/mpc_batch.cuh.
// Every robot of n joints runs the same unit: the robot, dt and g are the
// table (ops/fd_step.py::link_table with clip_velocity=False, so the
// velocity limit is +inf), a __grid_constant__ kernel argument.
//
// Why. The emitted body is one statement per operation: the primal step
// and a tangent per seed, 8.6k-20k statements a thread on the 7- to
// 10-joint arms (one seed a thread), past the ~9k SASS instructions where
// the fetch of the code bounds a kernel on this card (PERF.md §5: K1 ran at
// half the rate past it). Here the per-link work is written once a pass.
//
// What a thread computes (the plain version, operation for operation, is
// ops/fd_step.py::fd_step_loop_jvp_planes). With ddq the primal's,
// M(q) ddq + h(q, dq) = tau, so for a seed s
//     d ddq = M^-1 (d tau - r),   r = d(M ddq + h) / ds at fixed ddq,
// solved with the primal's Cholesky factor (in exact arithmetic the
// derivative of the unrolled Cholesky that jax.linearize differentiates).
// The seeds come in three kinds, and a block holds one kind (the group is
// blockIdx.y):
//   * tau seeds (one group of all n): r = 0; the primal step, then n
//     solves with its factor, one column at a time;
//   * q and dq seeds (groups of G = MPT_LIN_SEEDS, G dividing n): after
//     the primal step, a second pass over the links (mpt_jvp_tangents)
//     that knows ddq carries the RNEA's full forward sweep (Vd with ddq,
//     so W_k = G_k Vd_k - ad_V^T G_k V_k is link k's whole wrench and
//     M ddq + h = sum_k JB_k^T W_k) and, from the seed's joint j on, the
//     tangents dV and dVd. A q_j seed turns link j's transform: there
//     dV = ad_{Ad V}(A_j), dVd = ad_{Ad Vd}(A_j) + ad_dV(A_j dq_j), and
//     every earlier Jacobian column moves by dJB_i = ad_{JB_i}(JB_j) (i <
//     j, in link k's frame), formed where it is used and never stored; a
//     dq_j seed starts at dV = A_j, dVd = ad_V(A_j). Past link j both move
//     with the link's transform and dVd gains ad_dV(A_k dq_k). Link k adds
//     JB_i . dW_k (+ dJB_i . W_k) to r_i, so dM is never formed.
// Then each column: d dq' = d dq + d ddq dt, d q' = d q + d dq' dt, and
// the clamps' tangents (ops/cgen.py::_clip_tangent's rule: t inside, 0.5 t
// on a bound, 0 outside or for a NaN primal; an infinite bound is none, so
// with both infinite, as dq' has in K2, the tangent is t whatever the
// primal: JAX does not clip there).
//
// Registers. The primal pass is csrc/fd_step_loop.cuh's (JB, M's upper
// triangle, bias, V, Vd: 104 floats at n = 8), the factor then stays live
// (n(n+1)/2 + n) with ddq through the second pass, which holds JB, V, Vd
// and per seed dV, dVd and r (12 + n). Both passes keep `#pragma unroll 1`
// on the links, every joint loop unrolled and guarded, so no array is
// indexed by the link counter; JB_j of the seed's joint is picked the same
// way. Seeds a thread: ops/cuda_mpc_batch.py::lin_loop_seeds, measured.
//
// Bound. K2's bound keeps counting the emitted body's statements; this
// form's own operations are ops/fd_step.py::loop_jvp_ops.
//
// Parity. --fmad=false and no fast math, as every unit: each operation
// rounds once, as each eager operation of the plain version does; sinf,
// cosf and sqrtf are the library's, 1.0f / d the IEEE division, formed
// once per pivot outside the solves.

#ifndef MPT_LIN_SEEDS
#error "MPT_LIN_SEEDS must be defined before fd_step_loop_jvp.cuh"
#endif
#if MPT_NJ % MPT_LIN_SEEDS != 0
#error "the looped K2's MPT_LIN_SEEDS must divide the joint count"
#endif

// Groups: n/G of q seeds, n/G of dq seeds, then one of the n tau seeds.
#define MPT_LOOP_QDQ_GROUPS (2 * MPT_NJ / MPT_LIN_SEEDS)
#define MPT_LOOP_GROUPS (MPT_LOOP_QDQ_GROUPS + 1)

// The tangent of mpt_clamp(p, lo, hi) for the tangent t.
static __device__ __forceinline__ float mpt_clamp_tangent(float p, float t, float lo, float hi) {
  const bool no_lo = lo == -INFINITY, no_hi = hi == INFINITY;
  const bool inside = (p > lo || no_lo) && (p < hi || no_hi);
  const bool at = (p == lo && !no_lo) || (p == hi && !no_hi);
  return inside ? t : (at ? t * 0.5f : 0.0f);
}

// The second pass: r[g] = d(M ddq + h) / ds at fixed ddq for the seeds s =
// s0 + g, g < G, all q seeds (s0 < n) or all dq seeds.
static __device__ __forceinline__ void mpt_jvp_tangents(
    const float q[MPT_NJ], const float dq[MPT_NJ], const float ddq[MPT_NJ], const float* __restrict__ tab,
    int s0, float r[MPT_LIN_SEEDS][MPT_NJ]) {
  const bool is_q = s0 < MPT_NJ;
  const int j0 = is_q ? s0 : s0 - MPT_NJ;
  float V[6], Vd[6], JB[MPT_NJ][6], dV[MPT_LIN_SEEDS][6], dVd[MPT_LIN_SEEDS][6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[i] = 0.0f;
    V[3 + i] = 0.0f;
    Vd[i] = 0.0f;
    Vd[3 + i] = -tab[MPT_TAB_G + i];
  }
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
#pragma unroll
    for (int e = 0; e < 6; ++e) JB[i][e] = 0.0f;
#pragma unroll
    for (int g = 0; g < MPT_LIN_SEEDS; ++g) r[g][i] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < MPT_LIN_SEEDS; ++g) {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      dV[g][e] = 0.0f;
      dVd[g][e] = 0.0f;
    }
  }

#pragma unroll 1
  for (int k = 0; k < MPT_NJ; ++k) {
    const float* L = tab + MPT_TAB_HEAD + k * MPT_TAB_STRIDE;
    const float* A = L + MPT_TAB_A;
    const float dqk = mpt_pick(dq, k), ddqk = mpt_pick(ddq, k);
    float R[9], p[3];
    mpt_link_transform(L, mpt_pick(q, k), R, p);
#pragma unroll
    for (int i = 0; i < MPT_NJ; ++i) {
      if (i < k) {
        mpt_ad(R, p, JB[i]);
      } else if (i == k) {
#pragma unroll
        for (int e = 0; e < 6; ++e) JB[i][e] = A[e];
      }
    }
    // The full forward sweep: Vd carries ddq.
    float Adq[6], AdV[6], AdVd[6], adV[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      Adq[e] = A[e] * dqk;
      AdV[e] = V[e];
      AdVd[e] = Vd[e];
    }
    mpt_ad(R, p, AdV);
#pragma unroll
    for (int e = 0; e < 6; ++e) V[e] = AdV[e] + Adq[e];
    mpt_ad(R, p, AdVd);
    mpt_ad_twist(V, Adq, adV);
#pragma unroll
    for (int e = 0; e < 6; ++e) Vd[e] = (AdVd[e] + adV[e]) + A[e] * ddqk;
    const float* I = L + MPT_TAB_I;
    const float m = L[MPT_TAB_M];
    float W[6], GV[6];
    mpt_wrench(I, m, V, Vd, W, GV);

#pragma unroll
    for (int g = 0; g < MPT_LIN_SEEDS; ++g) {
      const int j = j0 + g;
      if (k < j) continue;
      float t1[6], t2[6];
      if (k == j && is_q) {
        mpt_ad_twist(AdV, A, dV[g]);
        mpt_ad_twist(AdVd, A, t1);
        mpt_ad_twist(dV[g], Adq, t2);
#pragma unroll
        for (int e = 0; e < 6; ++e) dVd[g][e] = t1[e] + t2[e];
      } else if (k == j) {
#pragma unroll
        for (int e = 0; e < 6; ++e) dV[g][e] = A[e];
        mpt_ad_twist(V, A, dVd[g]);
      } else {
        mpt_ad(R, p, dV[g]);
        mpt_ad(R, p, dVd[g]);
        mpt_ad_twist(dV[g], Adq, t2);
#pragma unroll
        for (int e = 0; e < 6; ++e) dVd[g][e] = dVd[g][e] + t2[e];
      }
      // dW = G dVd + [dw x Gw + w x Gdw + dv x Gv + v x Gdv; dw x Gv + w x Gdv].
      float GdV[6], dW[6], c1[3], c2[3], c3[3], c4[3];
      mpt_inertia(I, m, dV[g], GdV);
      mpt_inertia(I, m, dVd[g], dW);
      {
        float top[3];
        mpt_cross(dV[g], GV, c1);
        mpt_cross(V, GdV, c2);
        mpt_cross(dV[g] + 3, GV + 3, c3);
        mpt_cross(V + 3, GdV + 3, c4);
#pragma unroll
        for (int i = 0; i < 3; ++i) top[i] = (c1[i] + c2[i]) + (c3[i] + c4[i]);
        mpt_cross(dV[g], GV + 3, c1);
        mpt_cross(V, GdV + 3, c2);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          dW[i] = dW[i] + top[i];
          dW[3 + i] = dW[3 + i] + (c1[i] + c2[i]);
        }
      }
      // JB_j, picked with compile-time indices.
      float Jj[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) Jj[e] = JB[0][e];
#pragma unroll
      for (int i = 1; i < MPT_NJ; ++i) {
        if (i == j) {
#pragma unroll
          for (int e = 0; e < 6; ++e) Jj[e] = JB[i][e];
        }
      }
#pragma unroll
      for (int i = 0; i < MPT_NJ; ++i) {
        if (i <= k) {
          float c = mpt_dot6(JB[i], dW);
          if (is_q && i < j) {
            float dJ[6];
            mpt_ad_twist(JB[i], Jj, dJ);
            c = c + mpt_dot6(dJ, W);
          }
          r[g][i] = r[g][i] + c;
        }
      }
    }
  }
}

// Seed s's column of the step's Jacobian from d ddq = M^-1 rhs: put(i, v)
// receives d x'_i / ds for i < 2n. q_pre and dq_pre are the primal's
// values before the clamps.
template <class Put>
static __device__ __forceinline__ void mpt_jvp_column(
    const float Lc[MPT_NJ][MPT_NJ], const float inv_diag[MPT_NJ], const float rhs[MPT_NJ],
    const float q_pre[MPT_NJ], const float dq_pre[MPT_NJ], const float* __restrict__ tab, int s, Put put) {
  const float dt = tab[MPT_TAB_DT];
  const int j = s % MPT_NJ;
  float dx[MPT_NJ];
  mpt_chol_apply(Lc, inv_diag, rhs, dx);
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    const float* Li = tab + MPT_TAB_HEAD + i * MPT_TAB_STRIDE;
    float d_dq = dx[i] * dt;
    if (s >= MPT_NJ && s < 2 * MPT_NJ && i == j) d_dq = 1.0f + d_dq;
    float d_q = d_dq * dt;
    if (s < MPT_NJ && i == j) d_q = 1.0f + d_q;
    const float vel = Li[MPT_TAB_VEL];
    put(i, mpt_clamp_tangent(q_pre[i], d_q, Li[MPT_TAB_LOWER], Li[MPT_TAB_UPPER]));
    put(MPT_NJ + i, mpt_clamp_tangent(dq_pre[i], d_dq, -vel, vel));
  }
}

// One (scenario, step, group): the primal step at x = [q; dq], u = tau and
// the Jacobian columns of the group's seeds, put(s, i, v) receiving
// d x'_i / d [x; u]_s.
template <class Put>
static __device__ __forceinline__ void fd_step_loop_jvp(
    const float x[2 * MPT_NJ], const float u[MPT_NJ], int grp, const float* __restrict__ tab, Put put) {
  float M[MPT_NJ][MPT_NJ], bias[MPT_NJ], Lc[MPT_NJ][MPT_NJ], inv_diag[MPT_NJ], rhs[MPT_NJ], ddq[MPT_NJ];
  float q_pre[MPT_NJ], dq_pre[MPT_NJ];
  mpt_loop_dynamics(x, x + MPT_NJ, tab, M, bias);
  mpt_chol_factor(M, Lc, inv_diag);
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) rhs[i] = u[i] - bias[i];
  mpt_chol_apply(Lc, inv_diag, rhs, ddq);
  const float dt = tab[MPT_TAB_DT];
#pragma unroll
  for (int i = 0; i < MPT_NJ; ++i) {
    dq_pre[i] = x[MPT_NJ + i] + ddq[i] * dt;
    q_pre[i] = x[i] + dq_pre[i] * dt;
  }
  if (grp < MPT_LOOP_QDQ_GROUPS) {
    const int s0 = grp * MPT_LIN_SEEDS;
    float r[MPT_LIN_SEEDS][MPT_NJ];
    mpt_jvp_tangents(x, x + MPT_NJ, ddq, tab, s0, r);
#pragma unroll
    for (int g = 0; g < MPT_LIN_SEEDS; ++g) {
#pragma unroll
      for (int i = 0; i < MPT_NJ; ++i) rhs[i] = -r[g][i];
      const int s = s0 + g;
      mpt_jvp_column(Lc, inv_diag, rhs, q_pre, dq_pre, tab, s, [&](int i, float v) { put(s, i, v); });
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < MPT_NJ; ++j) {
#pragma unroll
      for (int i = 0; i < MPT_NJ; ++i) rhs[i] = (i == j) ? 1.0f : 0.0f;
      const int s = 2 * MPT_NJ + j;
      mpt_jvp_column(Lc, inv_diag, rhs, q_pre, dq_pre, tab, s, [&](int i, float v) { put(s, i, v); });
    }
  }
}
