// The float overloads of the scalar functions that the device models'
// templates call (mv_sin, mv_cos, mv_tan, mv_log, mv_value, mv_max, and for
// the models generated from a trace, ops/cuda/codegen.py, mv_exp, mv_sqrt,
// mv_abs, mv_recip, mv_maximum, mv_minimum), so that a model evaluates one
// definition on float in K2 and on the dual numbers of dual.cuh in K3.
// MvScalar<T> is the plain type beside T: T itself here, float for a dual
// number (dual.cuh).
// Built without fast math: sinf / cosf / tanf / logf keep full precision.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float mv_sin(float a) { return sinf(a); }
__device__ __forceinline__ float mv_cos(float a) { return cosf(a); }
__device__ __forceinline__ float mv_tan(float a) { return tanf(a); }
__device__ __forceinline__ float mv_log(float a) { return logf(a); }
__device__ __forceinline__ float mv_value(float a) { return a; }
// jnp.maximum(c, a): NaN propagates
__device__ __forceinline__ float mv_max(float a, float c) { return a < c ? c : a; }
__device__ __forceinline__ float mv_exp(float a) { return expf(a); }
__device__ __forceinline__ float mv_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float mv_abs(float a) { return fabsf(a); }
__device__ __forceinline__ float mv_recip(float a) { return 1.0f / a; }
// torch.maximum / torch.minimum: a NaN of either side propagates
__device__ __forceinline__ float mv_maximum(float a, float b) { return a > b || a != a ? a : b; }
__device__ __forceinline__ float mv_minimum(float a, float b) { return a < b || a != a ? a : b; }

template <class T>
struct MvScalar {
  using type = T;
};

}  // namespace
