// The device functions of the instructions that a traced program
// (ops/cuda/trace.py) lowers beyond scalar.cuh's and dual.cuh's: tanh, the
// sigmoid, log1p, exp2, erfinv, floor, ceil, round, sign, pow with a tensor
// exponent, fmod and remainder, every primitive of that kind which Mosaic
// lowers into the JAX package's Pallas kernels.  Each comes as a float
// overload (K2, rollout.cuh), a double one (the host test of the generated
// header) and one on the second-order dual numbers of dual.cuh (K3,
// fused.cuh), so that a generated model evaluates one definition in every
// kernel.  The generated header (ops/cuda/codegen.py) includes this file only
// when its program uses one of them, so the hand-written kernels' library and
// every program without them keep their texts, and their library names.
//
// The dual rules follow torch.func on the evaluator (Program.evaluate), which
// the tests hold them to:
//   tanh     f' = 1 - t^2, f'' = -2 t (1 - t^2) at t = tanh(a)
//   sigmoid  f' = s (1 - s), f'' = s (1 - s)(1 - 2 s) at s = sigmoid(a)
//   log1p    f' = 1 / (1 + a), f'' = -1 / (1 + a)^2
//   exp2     f' = ln2 e, f'' = ln2^2 e at e = 2^a
//   erfinv   f' = (sqrt(pi) / 2) exp(y^2), f'' = 2 y f'^2 at y = erfinv(a)
//   floor, ceil, round (half to even), sign: no derivative, as torch.func
//     and JAX's JVP give (sign is 0 at NaN, as torch.sign)
//   fmod(a, b) = a - trunc(a / b) b and remainder(a, b) = a - floor(a / b) b
//     (b's sign, as torch.remainder and jnp.remainder): derivative 1 in a and
//     minus the quotient in b, none of second order
//   pow(a, b), value powf(a, b): f_a = b a^(b-1), f_b = a^b log a, f_aa =
//     b (b - 1) a^(b-2), f_ab = a^(b-1) (1 + b log a), f_bb = a^b log^2 a.
//     At a < 0 log a is NaN, so every derivative in b is NaN (those in a stay
//     finite where b is an integer), as torch's; at a = 0 and b >= 0 the
//     derivatives in b are 0, as torch's pow_backward_exponent masks them,
//     and at b = 0 those in a are 0, as its pow_backward masks them.
// No fast math: tanhf, log1pf, exp2f, erfinvf, powf keep full precision.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

// ---- float (K2) and double (the host test) --------------------------------

__device__ __forceinline__ float mv_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ double mv_tanh(double a) { return tanh(a); }
__device__ __forceinline__ float mv_sigmoid(float a) { return 1.0f / (1.0f + expf(-a)); }
__device__ __forceinline__ double mv_sigmoid(double a) { return 1.0 / (1.0 + exp(-a)); }
__device__ __forceinline__ float mv_log1p(float a) { return log1pf(a); }
__device__ __forceinline__ double mv_log1p(double a) { return log1p(a); }
__device__ __forceinline__ float mv_exp2(float a) { return exp2f(a); }
__device__ __forceinline__ double mv_exp2(double a) { return exp2(a); }
__device__ __forceinline__ float mv_erfinv(float a) { return erfinvf(a); }
__device__ __forceinline__ double mv_erfinv(double a) { return erfinv(a); }
__device__ __forceinline__ float mv_floor(float a) { return floorf(a); }
__device__ __forceinline__ double mv_floor(double a) { return floor(a); }
__device__ __forceinline__ float mv_ceil(float a) { return ceilf(a); }
__device__ __forceinline__ double mv_ceil(double a) { return ceil(a); }
// rint rounds half to even in the default rounding mode
__device__ __forceinline__ float mv_round(float a) { return rintf(a); }
__device__ __forceinline__ double mv_round(double a) { return rint(a); }
__device__ __forceinline__ float mv_sign(float a) { return float((a > 0.0f) - (a < 0.0f)); }
__device__ __forceinline__ double mv_sign(double a) { return double((a > 0.0) - (a < 0.0)); }
__device__ __forceinline__ float mv_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double mv_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float mv_fmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double mv_fmod(double a, double b) { return fmod(a, b); }

template <class R>
__device__ __forceinline__ R remainder_of_fmod(R r, R b) {
  return r != R(0) && (r < R(0)) != (b < R(0)) ? r + b : r;
}
__device__ __forceinline__ float mv_remainder(float a, float b) {
  return remainder_of_fmod(fmodf(a, b), b);
}
__device__ __forceinline__ double mv_remainder(double a, double b) {
  return remainder_of_fmod(fmod(a, b), b);
}

// ---- second-order dual numbers (K3) ---------------------------------------

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_tanh(const Dual<NZ, H>& a) {
  const float t = tanhf(a.v), d = 1.0f - t * t;
  return chain(a, t, d, -2.0f * t * d);
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_sigmoid(const Dual<NZ, H>& a) {
  const float s = mv_sigmoid(a.v), d = s * (1.0f - s);
  return chain(a, s, d, d * (1.0f - 2.0f * s));
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_log1p(const Dual<NZ, H>& a) {
  const float r = 1.0f / (1.0f + a.v);
  return chain(a, log1pf(a.v), r, -(r * r));
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_exp2(const Dual<NZ, H>& a) {
  const float e = exp2f(a.v), ln2 = 0.693147180559945309f;
  return chain(a, e, ln2 * e, (ln2 * ln2) * e);
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_erfinv(const Dual<NZ, H>& a) {
  const float y = erfinvf(a.v), f1 = 0.886226925452758014f * expf(y * y);  // sqrt(pi) / 2
  return chain(a, y, f1, 2.0f * y * (f1 * f1));
}

// the rounding functions: a constant, no derivative
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_floor(const Dual<NZ, H>& a) {
  return Dual<NZ, H>(floorf(a.v));
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_ceil(const Dual<NZ, H>& a) {
  return Dual<NZ, H>(ceilf(a.v));
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_round(const Dual<NZ, H>& a) {
  return Dual<NZ, H>(rintf(a.v));
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_sign(const Dual<NZ, H>& a) {
  return Dual<NZ, H>(mv_sign(a.v));
}

// fmod and remainder: a - q b for the quotient q the value's rule takes (C's
// trunc for fmod, floor for remainder), a constant of the derivatives; the
// value is the float function's.
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_fmod(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r = a - truncf(a.v / b.v) * b;
  r.v = fmodf(a.v, b.v);
  return r;
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_fmod(const Dual<NZ, H>& a, float b) {
  Dual<NZ, H> r = a;
  r.v = fmodf(a.v, b);
  return r;
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_fmod(float a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r = (-truncf(a / b.v)) * b;
  r.v = fmodf(a, b.v);
  return r;
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_remainder(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r = a - floorf(a.v / b.v) * b;
  r.v = mv_remainder(a.v, b.v);
  return r;
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_remainder(const Dual<NZ, H>& a, float b) {
  Dual<NZ, H> r = a;
  r.v = mv_remainder(a.v, b);
  return r;
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_remainder(float a, const Dual<NZ, H>& b) {
  Dual<NZ, H> r = (-floorf(a / b.v)) * b;
  r.v = mv_remainder(a, b.v);
  return r;
}

// f(a, b) for a scalar f of two duals with the value f0, the gradient
// (fa, fb) and the Hessian ((faa, fab), (fab, fbb)) at (a.v, b.v):
// g = fa a' + fb b',  H = fa a'' + fb b'' + faa a' a'^T + fbb b' b'^T
//                       + fab (a' b'^T + b' a'^T)
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> chain2(const Dual<NZ, H>& a, const Dual<NZ, H>& b,
                                              float f0, float fa, float fb, float faa,
                                              float fab, float fbb) {
  Dual<NZ, H> r;
  r.v = f0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.g[i] = fa * a.g[i] + fb * b.g[i];
  if constexpr (H) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = i; j < NZ; ++j) {
        const int e = tri_index(NZ, i, j);
        r.h[e] = fa * a.h[e] + fb * b.h[e] + faa * (a.g[i] * a.g[j]) +
                 fbb * (b.g[i] * b.g[j]) + fab * (a.g[i] * b.g[j] + b.g[i] * a.g[j]);
      }
  }
  return r;
}

// pow's partial derivatives at (a, b) (the rule at the top of this file):
// {value, f_a, f_b, f_aa, f_ab, f_bb}
struct PowPartials {
  float v, fa, fb, faa, fab, fbb;
};
__device__ __forceinline__ PowPartials pow_partials(float a, float b) {
  const float v = powf(a, b), pm1 = powf(a, b - 1.0f);
  const bool masked = a == 0.0f && b >= 0.0f;   // torch's rules for f_b, f_a
  const float la = logf(a);
  return {v,
          b == 0.0f ? 0.0f : b * pm1,
          masked ? 0.0f : v * la,
          b == 0.0f ? 0.0f : b * (b - 1.0f) * powf(a, b - 2.0f),
          masked ? 0.0f : pm1 * (1.0f + b * la),
          masked ? 0.0f : v * la * la};
}

template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_pow(const Dual<NZ, H>& a, const Dual<NZ, H>& b) {
  const PowPartials d = pow_partials(a.v, b.v);
  return chain2(a, b, d.v, d.fa, d.fb, d.faa, d.fab, d.fbb);
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_pow(const Dual<NZ, H>& a, float b) {
  const PowPartials d = pow_partials(a.v, b);
  return chain(a, d.v, d.fa, d.faa);
}
template <int NZ, bool H>
__device__ __forceinline__ Dual<NZ, H> mv_pow(float a, const Dual<NZ, H>& b) {
  const PowPartials d = pow_partials(a, b.v);
  return chain(b, d.v, d.fb, d.fbb);
}

}  // namespace
