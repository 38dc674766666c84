// The float overloads of the scalar functions that the device models'
// templates call (mv_sin, mv_cos, mv_tan, mv_log, mv_value, mv_max), so that
// a model evaluates one definition on float in K2 and on the dual numbers of
// dual.cuh in K3.  Built without fast math: sinf / cosf / tanf / logf keep
// full precision.

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

}  // namespace
