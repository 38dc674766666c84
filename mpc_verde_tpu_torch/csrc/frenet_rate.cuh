// The Frenet rate-form device model, shared by the line-search kernel (K2,
// rollout_frenet.cu) and the fused derivs+backward kernel (K3,
// fused_frenet.cu): the OCP that scenarios/frenet.py builds with ocp/rate.py's
// to_rate_form from the path-frame model of models/frenet.py
// (FrenetRateDeviceModel in ops/cuda/rollout.py).
//
// State z = [y, phi, v, delta_prev, a_prev], control w = du, u = u_prev + w:
//   dynamics    x' = one RK4 step over T of f(x, u, p), u held;  u_prev' = u,
//               f = [v sin(phi - phi_t),
//                    v (tan(delta / L) - kappa_t cos(phi - phi_t) / (1 - (y - y_t) kappa_t)),
//                    a]
//   stage cost  (l1 (v - v_des)^2 + l2 (y - y_t)^2 + l3 (phi - phi_t)^2 + l4 a^2
//                + l5 (tan(delta) - L kappa_t)^2) / (N + 1)
//   stage box   max(dlb[k], ulb - u_prev) <= w <= min(dub[k], uub - u_prev)
// with p = (y_t, phi_t, kappa_t, v_des).  The dynamics have tan(delta / L)
// and the cost tan(delta), as the reference writes them
// (mpc_verde_tpu/models/frenet.py, scenarios/frenet.py).  No terminal cost.
// The rate bounds dlb / dub are device arrays (N, 2), read as the linear
// model reads its own (linear_rate.cuh).
//
// The dynamics and the cost read (x, u) only.  frenet_rk4 and frenet_cost
// take them as five numbers, so that K3 can seed its duals over those five
// and scatter the derivatives to z and w exactly (d/du_prev = d/dw = d/du;
// fused_frenet.cu): a dual of K3 is then the unicycle's size.  step /
// stage_cost wrap them in the kernels' surface (z, w), templates on the
// scalar type T as unicycle.cuh's are.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "scalar.cuh"

namespace {

struct FrenetRateModel {
  static constexpr int kNX0 = 3, kNX = 5, kNU = 2;
  // the host array of floats: h, h/2, h/6, L, N + 1, l1..l5, ulb, uub
  static constexpr int kFloats = 14;
  float h, h_half, h_sixth, L, stages;
  float lam[5];
  float ulb[kNU], uub[kNU];
  const float *dlb, *dub;  // device (N, kNU)
  int N;

  // Stage k's box at state z: the rate bound and the magnitude bound less
  // u_prev, as linear_rate.cuh's.
  __device__ __forceinline__ void bounds(const float (&z)[kNX], int k, float (&lo)[kNU],
                                         float (&hi)[kNU]) const {
#pragma unroll
    for (int a = 0; a < kNU; ++a) {
      const float l = ulb[a] - z[kNX0 + a], h_ = uub[a] - z[kNX0 + a];
      const float dl = dlb[k * kNU + a], dh = dub[k * kNU + a];
      lo[a] = dl < l ? l : dl;
      hi[a] = dh > h_ ? h_ : dh;
    }
  }

  // clip = min(max(v, lo), hi), NaN-propagating (hi where lo > hi)
  __device__ __forceinline__ static float clip(float v, float lo, float hi) {
    const float t = v < lo ? lo : v;
    return t > hi ? hi : t;
  }
};

// f(x, u, p) of models/frenet.py
template <class T>
__device__ __forceinline__ void frenet_rhs(const FrenetRateModel& m, const T (&x)[3],
                                           const T (&u)[2], const float* p, T (&f)[3]) {
  const T e = x[1] - p[1];
  const T cos_e = mv_cos(e);
  f[0] = x[2] * mv_sin(e);
  f[1] = x[2] * (mv_tan(u[0] / m.L) - (p[2] / (1.0f - (x[0] - p[0]) * p[2])) * cos_e);
  f[2] = u[1];
}

// One RK4 step of f over T from x with u held: x + h/6 (((k1 + 2 k2) + 2 k3)
// + k4), the sum taken as the stages come (ops/integrators.rk4_step's order).
template <class T>
__device__ __forceinline__ void frenet_rk4(const FrenetRateModel& m, const T (&x)[3],
                                           const T (&u)[2], const float* p, T (&xn)[3]) {
  T k[3], t[3], acc[3];
  frenet_rhs(m, x, u, p, k);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[i] = k[i];
    t[i] = x[i] + m.h_half * k[i];
  }
  frenet_rhs(m, t, u, p, k);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[i] = acc[i] + 2.0f * k[i];
    t[i] = x[i] + m.h_half * k[i];
  }
  frenet_rhs(m, t, u, p, k);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[i] = acc[i] + 2.0f * k[i];
    t[i] = x[i] + m.h * k[i];
  }
  frenet_rhs(m, t, u, p, k);
#pragma unroll
  for (int i = 0; i < 3; ++i) xn[i] = x[i] + m.h_sixth * (acc[i] + k[i]);
}

template <class T>
__device__ __forceinline__ T frenet_cost(const FrenetRateModel& m, const T (&x)[3],
                                         const T (&u)[2], const float* p) {
  const T ev = x[2] - p[3], ey = x[0] - p[0], ephi = x[1] - p[1];
  const T zt = mv_tan(u[0]) - m.L * p[2];
  return ((((m.lam[0] * (ev * ev) + m.lam[1] * (ey * ey)) + m.lam[2] * (ephi * ephi)) +
           m.lam[3] * (u[1] * u[1])) +
          m.lam[4] * (zt * zt)) /
         m.stages;
}

template <class T>
__device__ __forceinline__ void step(const FrenetRateModel& m, T (&z)[5], const T (&w)[2],
                                     const float* p) {
  T x[3], u[2], xn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = z[i];
#pragma unroll
  for (int a = 0; a < 2; ++a) u[a] = z[3 + a] + w[a];
  frenet_rk4(m, x, u, p, xn);
#pragma unroll
  for (int i = 0; i < 3; ++i) z[i] = xn[i];
#pragma unroll
  for (int a = 0; a < 2; ++a) z[3 + a] = u[a];
}

template <class T>
__device__ __forceinline__ T stage_cost(const FrenetRateModel& m, const T (&z)[5],
                                        const T (&w)[2], const float* p) {
  T x[3], u[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = z[i];
#pragma unroll
  for (int a = 0; a < 2; ++a) u[a] = z[3 + a] + w[a];
  return frenet_cost(m, x, u, p);
}

__host__ __device__ __forceinline__ bool has_terminal_cost(const FrenetRateModel&) {
  return false;
}

template <class T>
__device__ __forceinline__ T terminal_cost(const FrenetRateModel&, const T (&)[5], const float*) {
  return T(0.0f);
}

// K3's terminal value: zeros (no terminal cost).
__device__ __forceinline__ void model_terminal_value(const FrenetRateModel&, const float*,
                                                     const float*, float (&Vx)[5],
                                                     float (&Vxx)[5][5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    Vx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) Vxx[i][j] = 0.0f;
  }
}

// `f` is a host array of kFloats floats (FrenetRateDeviceModel.packed() in
// ops/cuda/rollout.py), `ints` one of 1: N, the rows of `tables`, a device
// array of the rate bounds dlb then dub, (N, 2) each.
inline FrenetRateModel unpack_frenet(const float* f, const int* ints, const float* tables) {
  FrenetRateModel m;
  m.h = f[0];
  m.h_half = f[1];
  m.h_sixth = f[2];
  m.L = f[3];
  m.stages = f[4];
  for (int i = 0; i < 5; ++i) m.lam[i] = f[5 + i];
  for (int a = 0; a < 2; ++a) m.ulb[a] = f[10 + a];
  for (int a = 0; a < 2; ++a) m.uub[a] = f[12 + a];
  m.N = ints[0];
  m.dlb = tables;
  m.dub = tables + (size_t)m.N * 2;
  return m;
}

// The model reads p[0:4], and its tables cover the horizon N.
inline bool model_fits(const FrenetRateModel& m, int npar, int N) {
  return m.dlb != nullptr && m.N == N && npar >= 4;
}

}  // namespace
