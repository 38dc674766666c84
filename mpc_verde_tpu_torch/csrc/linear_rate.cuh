// The linear rate-form device model, shared by the line-search kernel (K2,
// rollout_linear.cu) and the fused derivs+backward kernel (K3,
// fused_linear.cu): the OCPs that ocp/rate.py's to_rate_form builds from a
// linear plant (LinearRateDeviceModel in ops/cuda/rollout.py).
//
// State z = [x; u_prev] (NX0 + NU), control w = du (NU), u = u_prev + w:
//   dynamics    x' = Ad x + Bd u,  u_prev' = u,
//   stage cost  (x - r)' Q (x - r) + (u - u_r)' R (u - u_r) + w' Rdu w,
//   stage box   max(dlb[k], ulb - u_prev) <= w <= min(dub[k], uub - u_prev).
// Ad (row-major) and Bd are constants of the model, or (ab_col >= 0) stage
// parameters: Ad in p[ab_col : ab_col + NX0^2], then Bd, row-major (the LTV
// families put each step's discretization there).  r is p[x_ref : x_ref +
// NX0] or (x_ref < 0) the constant target; u_r is p[u_ref : u_ref + NU] or
// (u_ref < 0) zero.  No terminal cost.  The rate bounds dlb / dub are
// device arrays (N, NU), read by pointer at the stage index; -inf / +inf
// entries leave a side open, and a pinned stage (move blocking) has
// dlb = dub = 0, where the clip gives exactly 0.
//
// step / stage_cost are templates on the scalar type T (float in K2, the
// dual numbers of dual.cuh in K3), as unicycle.cuh's are; the kernels read
// this model through the members unicycle.cuh's UnicycleModel has as well.
//
// CurvatureRateModel (nx0 3, nu 1) is the same model with the curvature cost
// of scenarios/curvature.py in place of the quadratic one, over
// p = (y_t, phi_t, kappa_t, v_des, ...) and R_t = 1 / kappa_t:
//   l2 (y - y_t)^2 + l3 (phi - phi_t)^2 + l1 (r R_t - v_des)^2
//     + R_t (tan(delta) - L kappa_t)^2,   delta = u_prev + w.
// It derives from LinearRateModel, whose step, box and terminal value it
// keeps; its own stage_cost overload is the only new code, so the quadratic
// instantiations compile as they did.
//
// WeightedRateModel (nx0 3, nu 1) is the quadratic model whose diagonal
// state weight Q[q_row][q_row] is the stage parameter p[q_col] in place of
// the constant, so that each problem of a batch sets its own (the tuning
// sweep of sweep.py: Q = diag(p[4], Q1, Q2)).  Its stage_cost selects that
// weight and otherwise computes as LinearRateModel's; a model kind of its
// own, so that the constant-weight instantiations keep their code.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "scalar.cuh"

namespace {

template <int NX0, int NU>
struct LinearRateModel {
  static constexpr int kNX0 = NX0, kNX = NX0 + NU, kNU = NU;
  // the host array of floats: Ad, Bd, Q, R, Rdu, target, ulb, uub
  static constexpr int kFloats = 2 * NX0 * NX0 + NX0 * NU + 2 * NU * NU + NX0 + 2 * NU;
  float Ad[NX0 * NX0], Bd[NX0 * NU], Q[NX0 * NX0], R[NU * NU], Rdu[NU * NU];
  float target[NX0], ulb[NU], uub[NU];
  const float *dlb, *dub;  // device (N, NU)
  int ab_col, x_ref, u_ref, N, q_row, q_col;

  // Stage k's box at state z (the state being rolled in K2, the nominal one
  // in K3): jnp.maximum / jnp.minimum of the rate bound and the magnitude
  // bound less u_prev.
  __device__ __forceinline__ void bounds(const float (&z)[kNX], int k, float (&lo)[NU],
                                         float (&hi)[NU]) const {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      const float l = ulb[a] - z[NX0 + a], h = uub[a] - z[NX0 + a];
      const float dl = dlb[k * NU + a], dh = dub[k * NU + a];
      lo[a] = dl < l ? l : dl;
      hi[a] = dh > h ? h : dh;
    }
  }

  // clip = min(max(v, lo), hi), NaN-propagating, as torch.clamp and
  // jnp.clip take it (hi where lo > hi)
  __device__ __forceinline__ static float clip(float v, float lo, float hi) {
    const float t = v < lo ? lo : v;
    return t > hi ? hi : t;
  }
};

template <class T, int NX0, int NU>
__device__ __forceinline__ void step(const LinearRateModel<NX0, NU>& m, T (&z)[NX0 + NU],
                                     const T (&w)[NU], const float* p) {
  const bool ltv = m.ab_col >= 0;
  T u[NU], xn[NX0];
#pragma unroll
  for (int a = 0; a < NU; ++a) u[a] = z[NX0 + a] + w[a];
#pragma unroll
  for (int i = 0; i < NX0; ++i) {
    T acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NX0; ++j)
      acc = acc + (ltv ? p[m.ab_col + i * NX0 + j] : m.Ad[i * NX0 + j]) * z[j];
#pragma unroll
    for (int a = 0; a < NU; ++a)
      acc = acc + (ltv ? p[m.ab_col + NX0 * NX0 + i * NU + a] : m.Bd[i * NU + a]) * u[a];
    xn[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NX0; ++i) z[i] = xn[i];
#pragma unroll
  for (int a = 0; a < NU; ++a) z[NX0 + a] = u[a];
}

// v' W v for an n x n row-major W of constants
template <int n, class T>
__device__ __forceinline__ T quad_form(const float* W, const T (&v)[n]) {
  T c = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    T vW = 0.0f;
#pragma unroll
    for (int i = 0; i < n; ++i) vW = vW + v[i] * W[i * n + j];
    c = c + vW * v[j];
  }
  return c;
}

template <class T, int NX0, int NU>
__device__ __forceinline__ T stage_cost(const LinearRateModel<NX0, NU>& m,
                                        const T (&z)[NX0 + NU], const T (&w)[NU],
                                        const float* p) {
  T e[NX0], du[NU];
#pragma unroll
  for (int i = 0; i < NX0; ++i) e[i] = z[i] - (m.x_ref >= 0 ? p[m.x_ref + i] : m.target[i]);
#pragma unroll
  for (int a = 0; a < NU; ++a)
    du[a] = (z[NX0 + a] + w[a]) - (m.u_ref >= 0 ? p[m.u_ref + a] : 0.0f);
  return (quad_form<NX0>(m.Q, e) + quad_form<NU>(m.R, du)) + quad_form<NU>(m.Rdu, w);
}

template <int NX0, int NU>
__host__ __device__ __forceinline__ bool has_terminal_cost(const LinearRateModel<NX0, NU>&) {
  return false;
}

template <class T, int NX0, int NU>
__device__ __forceinline__ T terminal_cost(const LinearRateModel<NX0, NU>&,
                                           const T (&)[NX0 + NU], const float*) {
  return T(0.0f);
}

// K3's terminal value (gradient and Hessian of the terminal cost): zeros.
template <int NX0, int NU>
__device__ __forceinline__ void model_terminal_value(const LinearRateModel<NX0, NU>&,
                                                     const float*, const float*,
                                                     float (&Vx)[NX0 + NU],
                                                     float (&Vxx)[NX0 + NU][NX0 + NU]) {
#pragma unroll
  for (int i = 0; i < NX0 + NU; ++i) {
    Vx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NX0 + NU; ++j) Vxx[i][j] = 0.0f;
  }
}

// `f` is a host array of kFloats floats (LinearRateDeviceModel.packed() in
// ops/cuda/rollout.py), `ints` one of 6: ab_col, x_ref, u_ref (-1 for none),
// N, the rows of `tables`, a device array of the rate bounds dlb then dub,
// (N, NU) each, and q_row, q_col (-1 for none).
template <int NX0, int NU>
inline LinearRateModel<NX0, NU> unpack_linear(const float* f, const int* ints,
                                              const float* tables) {
  LinearRateModel<NX0, NU> m;
  int o = 0;
  for (int i = 0; i < NX0 * NX0; ++i) m.Ad[i] = f[o++];
  for (int i = 0; i < NX0 * NU; ++i) m.Bd[i] = f[o++];
  for (int i = 0; i < NX0 * NX0; ++i) m.Q[i] = f[o++];
  for (int i = 0; i < NU * NU; ++i) m.R[i] = f[o++];
  for (int i = 0; i < NU * NU; ++i) m.Rdu[i] = f[o++];
  for (int i = 0; i < NX0; ++i) m.target[i] = f[o++];
  for (int i = 0; i < NU; ++i) m.ulb[i] = f[o++];
  for (int i = 0; i < NU; ++i) m.uub[i] = f[o++];
  m.ab_col = ints[0];
  m.x_ref = ints[1];
  m.u_ref = ints[2];
  m.N = ints[3];
  m.q_row = ints[4];
  m.q_col = ints[5];
  m.dlb = tables;
  m.dub = tables + (size_t)m.N * NU;
  return m;
}

template <int NX0, int NU>
struct CurvatureRateModel : LinearRateModel<NX0, NU> {
  static_assert(NX0 == 3 && NU == 1, "the curvature cost is the (3, 1) lateral-error model's");
  // the host array: LinearRateModel's floats, then L, lambda1, lambda2, lambda3
  static constexpr int kFloats = LinearRateModel<NX0, NU>::kFloats + 4;
  float L, lam1, lam2, lam3;
};

template <class T, int NX0, int NU>
__device__ __forceinline__ T stage_cost(const CurvatureRateModel<NX0, NU>& m,
                                        const T (&z)[NX0 + NU], const T (&w)[NU],
                                        const float* p) {
  const float Rt = 1.0f / p[2];
  const T ey = z[0] - p[0], ephi = z[1] - p[1], er = z[2] * Rt - p[3];
  const T zt = mv_tan(z[NX0] + w[0]) - m.L * p[2];
  return ((m.lam2 * (ey * ey) + m.lam3 * (ephi * ephi)) + m.lam1 * (er * er)) + (Rt * zt) * zt;
}

template <int NX0, int NU>
inline CurvatureRateModel<NX0, NU> unpack_curvature(const float* f, const int* ints,
                                                    const float* tables) {
  CurvatureRateModel<NX0, NU> m;
  static_cast<LinearRateModel<NX0, NU>&>(m) = unpack_linear<NX0, NU>(f, ints, tables);
  const float* c = f + LinearRateModel<NX0, NU>::kFloats;
  m.L = c[0];
  m.lam1 = c[1];
  m.lam2 = c[2];
  m.lam3 = c[3];
  return m;
}

template <int NX0, int NU>
struct WeightedRateModel : LinearRateModel<NX0, NU> {
  static_assert(NX0 == 3 && NU == 1, "the parameter weight is the sweep's (3, 1) model's");
};

// v' W v as quad_form, with the diagonal entry (qi, qi) of W replaced by qv
template <int n, class T>
__device__ __forceinline__ T quad_form_weighted(const float* W, const T (&v)[n], int qi,
                                                float qv) {
  T c = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    T vW = 0.0f;
#pragma unroll
    for (int i = 0; i < n; ++i) vW = vW + v[i] * (i == j && i == qi ? qv : W[i * n + j]);
    c = c + vW * v[j];
  }
  return c;
}

template <class T, int NX0, int NU>
__device__ __forceinline__ T stage_cost(const WeightedRateModel<NX0, NU>& m,
                                        const T (&z)[NX0 + NU], const T (&w)[NU],
                                        const float* p) {
  T e[NX0], du[NU];
#pragma unroll
  for (int i = 0; i < NX0; ++i) e[i] = z[i] - (m.x_ref >= 0 ? p[m.x_ref + i] : m.target[i]);
#pragma unroll
  for (int a = 0; a < NU; ++a)
    du[a] = (z[NX0 + a] + w[a]) - (m.u_ref >= 0 ? p[m.u_ref + a] : 0.0f);
  return (quad_form_weighted<NX0>(m.Q, e, m.q_row, p[m.q_col]) + quad_form<NU>(m.R, du)) +
         quad_form<NU>(m.Rdu, w);
}

template <int NX0, int NU>
inline WeightedRateModel<NX0, NU> unpack_weighted(const float* f, const int* ints,
                                                  const float* tables) {
  WeightedRateModel<NX0, NU> m;
  static_cast<LinearRateModel<NX0, NU>&>(m) = unpack_linear<NX0, NU>(f, ints, tables);
  return m;
}

// The columns of p the model reads lie below npar, and its tables cover the
// horizon N.
template <int NX0, int NU>
inline bool model_fits(const LinearRateModel<NX0, NU>& m, int npar, int N) {
  if (m.dlb == nullptr || m.N != N) return false;
  if (m.ab_col < -1 || (m.ab_col >= 0 && m.ab_col + NX0 * (NX0 + NU) > npar)) return false;
  if (m.x_ref < -1 || (m.x_ref >= 0 && m.x_ref + NX0 > npar)) return false;
  if (m.u_ref < -1 || (m.u_ref >= 0 && m.u_ref + NU > npar)) return false;
  return m.q_row == -1;   // a weight from the params is WeightedRateModel's
}

// The curvature cost reads p[0:4] besides the linear model's columns.
template <int NX0, int NU>
inline bool model_fits(const CurvatureRateModel<NX0, NU>& m, int npar, int N) {
  return npar >= 4 && model_fits(static_cast<const LinearRateModel<NX0, NU>&>(m), npar, N);
}

// The weighted model reads p[q_col] besides the linear model's columns.
template <int NX0, int NU>
inline bool model_fits(const WeightedRateModel<NX0, NU>& m, int npar, int N) {
  if (m.q_row < 0 || m.q_row >= NX0 || m.q_col < 0 || m.q_col >= npar) return false;
  LinearRateModel<NX0, NU> base = m;
  base.q_row = -1;
  return model_fits(base, npar, N);
}

}  // namespace
