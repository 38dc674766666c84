// The unicycle device model, shared by the line-search kernel (K2,
// rollout.cu) and the fused derivs+backward kernel (K3, fused.cu).
//
// The Pallas kernels inline the OCP's jaxprs; CUDA cannot inline a Python
// callable, so the model is a fixed device model passed by value: unicycle
// kinematics with an RK4 or Euler step of M substeps, the stage cost
// (x - p[:3])' Q (x - p[:3]) + u' R u, an optional terminal weight Qf, and a
// constant control box.  The step constants (h, h/2, h/6) arrive already
// rounded to float from the host, as the PyTorch version computes them.
// Built without fast math: sinf/cosf keep full precision.
//
// rhs / step / state_quad / stage_cost are templates on the scalar type T:
// K2 evaluates them on float, K3 on the forward-mode numbers of dual.cuh,
// so both kernels evaluate one definition.  T needs +, -, * with T and
// float, construction from a float, and mv_sin / mv_cos overloads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNX = 3;
constexpr int kNU = 2;

struct UnicycleModel {
  float h, h_half, h_sixth;  // RK4 substep constants (Euler uses h)
  int substeps;
  int euler;                 // 0: RK4, 1: explicit Euler
  int has_terminal;
  float Q[kNX * kNX], R[kNU * kNU], Qf[kNX * kNX];
  float lb[kNU], ub[kNU];
};

// `model` is a host array of 3 + 9 + 4 + 9 + 2 + 2 floats: h, h/2, h/6, Q,
// R, Qf, lb, ub (UnicycleDeviceModel.packed() in ops/cuda/rollout.py).
inline UnicycleModel unpack_model(const float* model, int substeps, int euler,
                                  int has_terminal) {
  UnicycleModel m;
  m.h = model[0];
  m.h_half = model[1];
  m.h_sixth = model[2];
  for (int i = 0; i < kNX * kNX; ++i) m.Q[i] = model[3 + i];
  for (int i = 0; i < kNU * kNU; ++i) m.R[i] = model[12 + i];
  for (int i = 0; i < kNX * kNX; ++i) m.Qf[i] = model[16 + i];
  for (int i = 0; i < kNU; ++i) m.lb[i] = model[25 + i];
  for (int i = 0; i < kNU; ++i) m.ub[i] = model[27 + i];
  m.substeps = substeps;
  m.euler = euler;
  m.has_terminal = has_terminal;
  return m;
}

__device__ __forceinline__ float mv_sin(float a) { return sinf(a); }
__device__ __forceinline__ float mv_cos(float a) { return cosf(a); }

template <class T>
__device__ __forceinline__ void rhs(const T (&x)[kNX], const T (&u)[kNU], T (&f)[kNX]) {
  f[0] = u[0] * mv_cos(x[2]);
  f[1] = u[0] * mv_sin(x[2]);
  f[2] = u[1];
}

template <class T>
__device__ __forceinline__ void step(const UnicycleModel& m, T (&x)[kNX], const T (&u)[kNU]) {
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

template <class T>
__device__ __forceinline__ T stage_cost(const UnicycleModel& m, const T (&x)[kNX],
                                        const T (&u)[kNU], const float* p) {
  T cu = 0.0f;
#pragma unroll
  for (int j = 0; j < kNU; ++j) {
    T uR = 0.0f;
#pragma unroll
    for (int i = 0; i < kNU; ++i) uR = uR + u[i] * m.R[i * kNU + j];
    cu = cu + uR * u[j];
  }
  return state_quad(m.Q, x, p) + cu;
}

}  // namespace
