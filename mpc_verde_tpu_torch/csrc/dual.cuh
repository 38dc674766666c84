// Forward-mode dual numbers of first or second order over NZ seed
// directions, for the fused derivs+backward kernel (K3, fused.cu).
//
// Dual<NZ, true> carries a value, its gradient and its Hessian (the upper
// triangle, NZ (NZ + 1) / 2 entries) with respect to NZ independent
// variables; Dual<NZ, false> carries value and gradient only.  Evaluating a
// model on variables seeded by Dual::var gives every first and second
// derivative in one pass: forward over forward, the order of the JAX fused
// kernel's nested jacfwd (mpc_verde_tpu/ops/pallas/fused.py, dfun).  Only
// what the device models (unicycle.cuh and the models generated from a
// trace, ops/cuda/codegen.py) need is defined:
// + - * between duals and with float constants, negation, / by a float
// constant, the reciprocal and with it / of a float or a dual by a dual, sin,
// cos, tan, log, exp, sqrt and abs, max with a constant that follows the
// value as jnp.maximum does, and torch.maximum / torch.minimum of two duals,
// which follow the value as well.  CHAIN_COEFFS in ops/cuda/fused.py is the
// PyTorch twin of the scalar functions' chain rule.  A select on a value
// condition (torch.where) is a plain `c ? a : b` that copies the whole dual.
//
// Size: Dual<5, true> is 21 floats, and an RK4 step on three of them keeps
// about 18 live; see fused.cu for what ptxas makes of that.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "scalar.cuh"
#include "tri.cuh"

namespace {

template <int NZ, bool H>
struct Dual {
  static constexpr int kNH = H ? NZ * (NZ + 1) / 2 : 1;
  float v;
  float g[NZ];
  float h[kNH];

  __device__ __forceinline__ Dual() {}
  // a constant: zero derivatives
  __device__ __forceinline__ Dual(float c) : v(c) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) g[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNH; ++e) h[e] = 0.0f;
  }
  // the i-th independent variable at value c
  __device__ __forceinline__ static Dual var(float c, int i) {
    Dual d(c);
    d.g[i] = 1.0f;
    return d;
  }
  __device__ __forceinline__ float hess(int i, int j) const {
    static_assert(H, "a first-order dual carries no Hessian");
    return h[tri_index(NZ, i, j)];
  }
};

// The linear operations act component by component.
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator+(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = a.g[i] + b.g[i];
  if constexpr (H) {
#pragma unroll
    for (int e = 0; e < Dual<NZ, H>::kNH; ++e) r.h[e] = a.h[e] + b.h[e];
  }
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator-(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = a.g[i] - b.g[i];
  if constexpr (H) {
#pragma unroll
    for (int e = 0; e < Dual<NZ, H>::kNH; ++e) r.h[e] = a.h[e] - b.h[e];
  }
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator-(const Dual<NZ, H>& a, float c) {
  Dual<NZ, H> r = a;
  r.v = a.v - c;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator+(const Dual<NZ, H>& a, float c) {
  Dual<NZ, H> r = a;
  r.v = a.v + c;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator+(float c, const Dual<NZ, H>& a) {
  Dual<NZ, H> r = a;
  r.v = c + a.v;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator-(float c, const Dual<NZ, H>& a) {
  Dual<NZ, H> r = (-1.0f) * a;
  r.v = c - a.v;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator*(float c, const Dual<NZ, H>& a) {
  Dual<NZ, H> r;
  r.v = c * a.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = c * a.g[i];
  if constexpr (H) {
#pragma unroll
    for (int e = 0; e < Dual<NZ, H>::kNH; ++e) r.h[e] = c * a.h[e];
  }
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator*(const Dual<NZ, H>& a, float c) {
  return c * a;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator/(const Dual<NZ, H>& a, float c) {
  Dual<NZ, H> r;
  r.v = a.v / c;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = a.g[i] / c;
  if constexpr (H) {
#pragma unroll
    for (int e = 0; e < Dual<NZ, H>::kNH; ++e) r.h[e] = a.h[e] / c;
  }
  return r;
}

// (ab)'' = a'' b + a b'' + a' b'^T + b' a'^T
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator*(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
  if constexpr (H) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = i; j < NZ; ++j) {
        const int e = tri_index(NZ, i, j);
        r.h[e] = a.v * b.h[e] + b.v * a.h[e] + a.g[i] * b.g[j] + a.g[j] * b.g[i];
      }
  }
  return r;
}

// f(a) for a scalar f with f(a.v) = f0, f'(a.v) = f1, f''(a.v) = f2:
// g = f1 a',  H = f1 a'' + f2 a' a'^T
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> chain(const Dual<NZ, H>& a, float f0, float f1, float f2) {
  Dual<NZ, H> r;
  r.v = f0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = f1 * a.g[i];
  if constexpr (H) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = i; j < NZ; ++j) {
        const int e = tri_index(NZ, i, j);
        r.h[e] = f1 * a.h[e] + f2 * (a.g[i] * a.g[j]);
      }
  }
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_sin(const Dual<NZ, H>& a) {
  const float s = sinf(a.v), c = cosf(a.v);
  return chain(a, s, c, -s);
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_cos(const Dual<NZ, H>& a) {
  const float s = sinf(a.v), c = cosf(a.v);
  return chain(a, c, -s, -c);
}

// tan' = 1 + tan^2, tan'' = 2 tan (1 + tan^2)
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_tan(const Dual<NZ, H>& a) {
  const float t = tanf(a.v), s = 1.0f + t * t;
  return chain(a, t, s, 2.0f * t * s);
}

// 1 / a: the derivatives -r^2 and 2 r^3 at r = 1 / a.v
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_recip(const Dual<NZ, H>& a) {
  const float r = 1.0f / a.v;
  return chain(a, r, -(r * r), 2.0f * (r * r * r));
}

// c / a = c (1 / a); the value is the float quotient
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator/(float c, const Dual<NZ, H>& a) {
  Dual<NZ, H> r = c * mv_recip(a);
  r.v = c / a.v;
  return r;
}

// a / b = a (1 / b); the value is the float quotient
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator/(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r = a * mv_recip(b);
  r.v = a.v / b.v;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_log(const Dual<NZ, H>& a) {
  const float inv = 1.0f / a.v;
  return chain(a, logf(a.v), inv, -(inv * inv));
}

template <int NZ, bool H>
__device__ __forceinline__ float mv_value(const Dual<NZ, H>& a) {
  return a.v;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> operator-(const Dual<NZ, H>& a) {
  Dual<NZ, H> r = (-1.0f) * a;
  r.v = -a.v;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_exp(const Dual<NZ, H>& a) {
  const float e = expf(a.v);
  return chain(a, e, e, e);
}

// sqrt' = 1 / (2 s), sqrt'' = -1 / (4 s^3) at s = sqrt(a.v)
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_sqrt(const Dual<NZ, H>& a) {
  const float s = sqrtf(a.v), r = 1.0f / s;
  return chain(a, s, 0.5f * r, -0.25f * (r * r * r));
}

// |a|' = sign(a) (0 at a = 0, as torch.abs differentiates it), |a|'' = 0
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_abs(const Dual<NZ, H>& a) {
  return chain(a, fabsf(a.v), a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f), 0.0f);
}

// torch.maximum(a, b): the larger's derivatives, the mean of both at a tie
// (as torch differentiates it), a NaN of either side propagating.
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_maximum(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  if (a.v > b.v || a.v != a.v) return a;
  if (b.v > a.v || b.v != b.v) return b;
  Dual<NZ, H> r = 0.5f * (a + b);
  r.v = a.v;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_minimum(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  if (a.v < b.v || a.v != a.v) return a;
  if (b.v < a.v || b.v != b.v) return b;
  Dual<NZ, H> r = 0.5f * (a + b);
  r.v = a.v;
  return r;
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_maximum(const Dual<NZ, H>& a, float b) {
  return mv_maximum(a, Dual<NZ, H>(b));
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_maximum(float a, const Dual<NZ, H>& b) {
  return mv_maximum(Dual<NZ, H>(a), b);
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_minimum(const Dual<NZ, H>& a, float b) {
  return mv_minimum(a, Dual<NZ, H>(b));
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_minimum(float a, const Dual<NZ, H>& b) {
  return mv_minimum(Dual<NZ, H>(a), b);
}

template <int NZ, bool H>
struct MvScalar<Dual<NZ, H>> {
  using type = float;
};

// jnp.maximum(c, a) for a constant c, derivatives included: a's where
// a > c (or a is NaN), none where a < c, and half of a's at a tie, as
// jnp.maximum and torch.maximum differentiate it.
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_max(const Dual<NZ, H>& a, float c) {
  if (a.v < c) return Dual<NZ, H>(c);
  if (a.v == c) {
    Dual<NZ, H> r = 0.5f * a;
    r.v = a.v;
    return r;
  }
  return a;
}

}  // namespace
