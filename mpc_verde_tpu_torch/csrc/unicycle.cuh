// The unicycle device model, shared by the line-search kernel (K2,
// rollout.cu) and the fused derivs+backward kernel (K3, fused.cu).
//
// The Pallas kernels inline the OCP's jaxprs; CUDA cannot inline a Python
// callable, so the model is a fixed device model passed by value: unicycle
// kinematics with an RK4 or Euler step of M substeps, the running cost
// L = (x - p[:3])' Q (x - p[:3]) + (u - r)' R (u - r) with the control
// reference r = p[u_ref : u_ref + 2] (r = 0 without one), an optional
// terminal weight Qf, and a constant control box.  The stage cost is L
// itself, or (quad_substeps > 0) the RK4 quadrature of L over dt with its own
// chain of quad_substeps unicycle substeps (rk4_step_with_quadrature),
// whatever integrator steps the state.  The step constants (h, h/2, h/6) of
// the dynamics and of the quadrature arrive already rounded to float from
// the host, as the PyTorch version computes them.  Built without fast math:
// sinf/cosf/logf keep full precision.
//
// Two optional cost terms read their columns of p (UnicycleDeviceModel in
// ops/cuda/rollout.py says which):
//   * the log barrier of the interior-point solvers (solver/ipm.py) on its
//     own box blb <= u <= bub, mu = p[barrier_mu], added to the stage cost.
//     Rule 1 ("streaming", ipm._barrier_term): -mu sum(log(d)) over
//     d = [u - blb, bub - u], +inf when some d <= 0 and mu > 0, exactly zero
//     (value and derivatives) when mu = 0.  Rule 2 ("batched",
//     make_barrier_solver): -mu (sum(log(u - blb)) + sum(log(bub - u))),
//     NaN outside the box.
//   * the PHR augmented-Lagrangian penalty of the state box xlb <= x <= xub
//     (solver/batched._augment_ocp_al), lam = p[al_lam : al_lam + 6],
//     mu = p[al_mu], on every stage and on the terminal state; an infinite
//     bound is an inactive row (c = -1).
//
// rhs / step / state_quad / running_cost / quadrature_cost / stage_cost /
// barrier_term / al_penalty are
// templates on the scalar type T: K2 evaluates them on float, K3 on the
// forward-mode numbers of dual.cuh, so both kernels evaluate one definition.
// The kernels (rollout.cuh, fused.cuh) are templates on the model and read
// every model through the same members: kNX, kNU, bounds (the stage's
// control box; here the constant one), clip, and the free functions step /
// stage_cost / has_terminal_cost / terminal_cost (ops/cuda/codegen.py
// gives a model generated from a trace the same surface).
// T needs +, -, * with T and float, / by a float, construction from a
// float, and mv_sin / mv_cos / mv_log / mv_max / mv_value overloads (scalar.cuh
// for float, dual.cuh for the dual numbers).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "scalar.cuh"

namespace {

constexpr int kNX = 3;
constexpr int kNU = 2;
constexpr int kNC = 2 * kNX;  // AL rows: lower bounds, then upper bounds
constexpr int kBarrierStreaming = 1, kBarrierBatched = 2;
constexpr int kModelFloats = 42, kModelInts = 10;

struct UnicycleModel {
  static constexpr int kNX = 3, kNU = 2;
  float h, h_half, h_sixth;  // RK4 substep constants (Euler uses h)
  int substeps;
  int euler;                 // 0: RK4, 1: explicit Euler
  int has_terminal;
  int barrier;               // 0 none, kBarrierStreaming, kBarrierBatched
  int barrier_mu;            // column of the barrier's mu in p
  int al;                    // 1: the AL penalty of the state box
  int al_lam, al_mu;         // columns of lam (kNC of them) and of its mu
  int u_ref;                 // first of the 2 columns of the control reference, or -1
  int quad_substeps;         // 0: discrete stage cost; else the quadrature's substeps
  float qh, qh_half, qh_sixth;  // the quadrature's RK4 substep constants
  float Q[kNX * kNX], R[kNU * kNU], Qf[kNX * kNX];
  float lb[kNU], ub[kNU];    // the clip box
  float blb[kNU], bub[kNU];  // the barrier's box
  float xlb[kNX], xub[kNX];  // the AL state box

  // Stage k's control box at state x: the constant clip box.
  __device__ __forceinline__ void bounds(const float (&)[kNX], int, float (&lo)[kNU],
                                         float (&hi)[kNU]) const {
#pragma unroll
    for (int a = 0; a < kNU; ++a) {
      lo[a] = lb[a];
      hi[a] = ub[a];
    }
  }

  // clip = min(max(v, lo), hi), NaN-propagating like jnp.clip (lo <= hi)
  __device__ __forceinline__ static float clip(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  }
};

// `model` is a host array of kModelFloats floats: h, h/2, h/6, Q, R, Qf, lb,
// ub, blb, bub, xlb, xub, qh, qh/2, qh/6 (UnicycleDeviceModel.packed() in
// ops/cuda/rollout.py); `ints` one of kModelInts ints: substeps, euler,
// has_terminal, barrier, barrier_mu, al, al_lam, al_mu, u_ref,
// quad_substeps (packed_ints()).
inline UnicycleModel unpack_model(const float* model, const int* ints) {
  UnicycleModel m;
  m.h = model[0];
  m.h_half = model[1];
  m.h_sixth = model[2];
  for (int i = 0; i < kNX * kNX; ++i) m.Q[i] = model[3 + i];
  for (int i = 0; i < kNU * kNU; ++i) m.R[i] = model[12 + i];
  for (int i = 0; i < kNX * kNX; ++i) m.Qf[i] = model[16 + i];
  for (int i = 0; i < kNU; ++i) m.lb[i] = model[25 + i];
  for (int i = 0; i < kNU; ++i) m.ub[i] = model[27 + i];
  for (int i = 0; i < kNU; ++i) m.blb[i] = model[29 + i];
  for (int i = 0; i < kNU; ++i) m.bub[i] = model[31 + i];
  for (int i = 0; i < kNX; ++i) m.xlb[i] = model[33 + i];
  for (int i = 0; i < kNX; ++i) m.xub[i] = model[36 + i];
  m.qh = model[39];
  m.qh_half = model[40];
  m.qh_sixth = model[41];
  m.substeps = ints[0];
  m.euler = ints[1];
  m.has_terminal = ints[2];
  m.barrier = ints[3];
  m.barrier_mu = ints[4];
  m.al = ints[5];
  m.al_lam = ints[6];
  m.al_mu = ints[7];
  m.u_ref = ints[8];
  m.quad_substeps = ints[9];
  return m;
}

// The columns of p the model reads all lie below npar.
inline bool model_fits(const UnicycleModel& m, int npar) {
  if (npar < kNX || m.barrier < 0 || m.barrier > kBarrierBatched) return false;
  if (m.barrier && (m.barrier_mu < 0 || m.barrier_mu >= npar)) return false;
  if (m.al && (m.al_lam < 0 || m.al_lam + kNC > npar || m.al_mu < 0 || m.al_mu >= npar))
    return false;
  if (m.u_ref < -1 || m.u_ref + kNU > npar || m.quad_substeps < 0) return false;
  return true;
}

template <class T>
__device__ __forceinline__ void rhs(const T (&x)[kNX], const T (&u)[kNU], T (&f)[kNX]) {
  f[0] = u[0] * mv_cos(x[2]);
  f[1] = u[0] * mv_sin(x[2]);
  f[2] = u[1];
}

// One step of the dynamics; the unicycle reads no parameter.
template <class T>
__device__ __forceinline__ void step(const UnicycleModel& m, T (&x)[kNX], const T (&u)[kNU],
                                     const float*) {
  for (int s = 0; s < m.substeps; ++s) {
    T k1[kNX], k2[kNX], k3[kNX], k4[kNX], t[kNX];
    rhs(x, u, k1);
    if (m.euler) {
#pragma unroll
      for (int i = 0; i < kNX; ++i) x[i] = x[i] + m.h * k1[i];
      continue;
    }
#pragma unroll
    for (int i = 0; i < kNX; ++i) t[i] = x[i] + m.h_half * k1[i];
    rhs(t, u, k2);
#pragma unroll
    for (int i = 0; i < kNX; ++i) t[i] = x[i] + m.h_half * k2[i];
    rhs(t, u, k3);
#pragma unroll
    for (int i = 0; i < kNX; ++i) t[i] = x[i] + m.h * k3[i];
    rhs(t, u, k4);
#pragma unroll
    for (int i = 0; i < kNX; ++i)
      x[i] = x[i] + m.h_sixth * (((k1[i] + 2.0f * k2[i]) + 2.0f * k3[i]) + k4[i]);
  }
}

// e' W e with e = x - p[:3]
template <class T>
__device__ __forceinline__ T state_quad(const float* W, const T (&x)[kNX], const float* p) {
  T e[kNX];
#pragma unroll
  for (int i = 0; i < kNX; ++i) e[i] = x[i] - p[i];
  T c = 0.0f;
#pragma unroll
  for (int j = 0; j < kNX; ++j) {
    T eW = 0.0f;
#pragma unroll
    for (int i = 0; i < kNX; ++i) eW = eW + e[i] * W[i * kNX + j];
    c = c + eW * e[j];
  }
  return c;
}

// The barrier's stage term (m.barrier != 0)
template <class T>
__device__ __forceinline__ T barrier_term(const UnicycleModel& m, const T (&u)[kNU],
                                          const float* p) {
  const float mu = p[m.barrier_mu];
  if (m.barrier == kBarrierBatched)
    return (-mu) * ((mv_log(u[0] - m.blb[0]) + mv_log(u[1] - m.blb[1])) +
                    (mv_log(m.bub[0] - u[0]) + mv_log(m.bub[1] - u[1])));
  if (!(mu > 0.0f)) return T(0.0f);  // the crossover round: exact zeros
  T pen = 0.0f;
#pragma unroll
  for (int r = 0; r < 2 * kNU; ++r) {
    const int a = r % kNU;
    const T d = r < kNU ? u[a] - m.blb[a] : m.bub[a] - u[a];
    // on or outside the box: -inf, so -mu * pen prices the point +inf
    pen = pen + (mv_value(d) > 0.0f ? mv_log(mv_max(d, 1e-30f)) : T(-INFINITY));
  }
  return (-mu) * pen;
}

// The AL penalty of the state box (m.al != 0)
template <class T>
__device__ __forceinline__ T al_penalty(const UnicycleModel& m, const T (&x)[kNX],
                                        const float* p) {
  const float* lam = p + m.al_lam;
  const float mu = p[m.al_mu];
  T tt = 0.0f;
  float ll = 0.0f;
#pragma unroll
  for (int r = 0; r < kNC; ++r) {
    const int j = r % kNX;
    const float bound = r < kNX ? m.xlb[j] : m.xub[j];
    T c = -1.0f;  // an inactive row
    if (isfinite(bound)) {
      const T cr = r < kNX ? bound - x[j] : x[j] - bound;
      if (isfinite(mv_value(cr))) c = cr;
    }
    const T t = mv_max(lam[r] + mu * c, 0.0f);
    tt = tt + t * t;
    ll = ll + lam[r] * lam[r];
  }
  return (tt - ll) / (2.0f * mu);
}

// L = e' Q e + du' R du, du = u - p[u_ref : u_ref + 2] (u without a reference)
template <class T>
__device__ __forceinline__ T running_cost(const UnicycleModel& m, const T (&x)[kNX],
                                          const T (&u)[kNU], const float* p) {
  T du[kNU];
#pragma unroll
  for (int j = 0; j < kNU; ++j) du[j] = m.u_ref >= 0 ? u[j] - p[m.u_ref + j] : u[j];
  T cu = 0.0f;
#pragma unroll
  for (int j = 0; j < kNU; ++j) {
    T uR = 0.0f;
#pragma unroll
    for (int i = 0; i < kNU; ++i) uR = uR + du[i] * m.R[i * kNU + j];
    cu = cu + uR * du[j];
  }
  return state_quad(m.Q, x, p) + cu;
}

// The RK4 quadrature of L over dt along the model's own RK4 chain of
// quad_substeps substeps from x (rk4_step_with_quadrature): per substep
// q += h/6 (((L1 + 2 L2) + 2 L3) + L4) and x += h/6 (((k1 + 2 k2) + 2 k3) + k4).
// Both sums are kept running, left to right, which is the same floats and
// keeps one stage's k live, not four.
template <class T>
__device__ __forceinline__ T quadrature_cost(const UnicycleModel& m, const T (&x0)[kNX],
                                             const T (&u)[kNU], const float* p) {
  T x[kNX], t[kNX], k[kNX], ks[kNX];
#pragma unroll
  for (int i = 0; i < kNX; ++i) x[i] = x0[i];
  T q = 0.0f;
#pragma unroll 1
  for (int s = 0; s < m.quad_substeps; ++s) {
    rhs(x, u, k);
    T lq = running_cost(m, x, u, p);
#pragma unroll
    for (int i = 0; i < kNX; ++i) ks[i] = k[i];
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      const float c = r == 3 ? m.qh : m.qh_half;
      const float w = r == 3 ? 1.0f : 2.0f;
#pragma unroll
      for (int i = 0; i < kNX; ++i) t[i] = x[i] + c * k[i];
      rhs(t, u, k);
      lq = lq + w * running_cost(m, t, u, p);
#pragma unroll
      for (int i = 0; i < kNX; ++i) ks[i] = ks[i] + w * k[i];
    }
#pragma unroll
    for (int i = 0; i < kNX; ++i) x[i] = x[i] + m.qh_sixth * ks[i];
    q = q + m.qh_sixth * lq;
  }
  return q;
}

template <class T>
__device__ __forceinline__ T stage_cost(const UnicycleModel& m, const T (&x)[kNX],
                                        const T (&u)[kNU], const float* p) {
  T c = m.quad_substeps > 0 ? quadrature_cost(m, x, u, p) : running_cost(m, x, u, p);
  if (m.barrier) c = c + barrier_term(m, u, p);
  if (m.al) c = c + al_penalty(m, x, p);
  return c;
}

// Whether the terminal cost is more than zero: a weight or the AL penalty.
__host__ __device__ __forceinline__ bool has_terminal_cost(const UnicycleModel& m) {
  return m.has_terminal || m.al;
}

template <class T>
__device__ __forceinline__ T terminal_cost(const UnicycleModel& m, const T (&x)[kNX],
                                           const float* p) {
  T c = m.has_terminal ? state_quad(m.Qf, x, p) : T(0.0f);
  if (m.al) c = c + al_penalty(m, x, p);
  return c;
}

}  // namespace
