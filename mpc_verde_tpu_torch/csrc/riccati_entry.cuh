// Batched box-constrained Riccati backward pass (K1): the C entry point of
// one (nx, nu), loaded with ctypes.
//
// K1 is built per size.  ops/cuda/build.py generates two translation units
// for a size when it is first used, one per variant, so that the two compile
// in parallel, and links them into a library of that size alone:
//   riccati_<nx>x<nu>.cu        includes this header and writes
//                               MV_RICCATI_ENTRY(nx, nu): the "thread"
//                               launcher (riccati.cuh) and the entry
//                               mv_riccati_backward_<nx>x<nu>;
//   riccati_warps_<nx>x<nu>.cu  defines mv_riccati_warps_launch_<nx>x<nu>,
//                               the "warps" launcher (riccati_warps.cuh).
// The kernels are templates on (NX, NU) alone, so every nx >= 1 and
// 1 <= nu <= 4 compiles from the same sources.

#pragma once

#include "riccati.cuh"

// The "warps" launcher of one size: `layout` is the host array of
// WarpsLayout's ints from `in` on (riccati_warps.cuh), `clocks` null or the
// device array that the timing instantiation fills.
using RiccatiWarpsLaunch = cudaError_t (*)(const RiccatiArgs&, bool, int, const int*,
                                           long long*, cudaStream_t);

namespace {

// `variant` is 0 "thread" or 1 "warps"; for "warps", `problems` is the
// number of problems a block takes and `layout` the plan's layout; `clocks`
// is null, or (nx = 3, nu = 2, DDP, "warps" only) a device array of 9 int64
// per block: the launch is then of the timing instantiation.  Returns the
// CUDA error of setting the shared-memory size or of the launch, or
// cudaErrorInvalidValue for a bad variant or plan.
template <int NX, int NU>
int riccati_entry(const RiccatiArgs& a, bool ddp, int variant, int problems,
                  const int* layout, void* clocks, void* stream, RiccatiWarpsLaunch warps) {
  if (variant < 0 || variant > 1 || (variant == 0 && clocks != nullptr))
    return cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) return riccati_launch<NX, NU>(a, ddp, s);
  return warps(a, ddp, problems, layout, static_cast<long long*>(clocks), s);
}

}  // namespace

// The C entry of size (NX, NU).  All pointers are device pointers to
// contiguous float32 tensors in the JAX (B, N, ...) layouts; fxx/fux/fuu are
// ignored when use_ddp is 0.  nx and nu must be the library's own size, else
// cudaErrorInvalidValue; the other arguments are riccati_entry's.
#define MV_RICCATI_ENTRY(NX, NU)                                                              \
  cudaError_t mv_riccati_warps_launch_##NX##x##NU(const RiccatiArgs&, bool, int, const int*,  \
                                                  long long*, cudaStream_t);                  \
  extern "C" int mv_riccati_backward_##NX##x##NU(                                             \
      int nx, int nu, int use_ddp, int B, int N, float tol, const float* fx, const float* fu, \
      const float* lx, const float* lu, const float* lxx, const float* luu, const float* lux, \
      const float* fxx, const float* fux, const float* fuu, const float* dlb,                 \
      const float* dub, const float* gN, const float* HN, const float* reg,                   \
      const float* ddp, float* kff, float* K, float* dV1, float* dV2, float* gmax,            \
      int variant, int problems, const int* layout, void* clocks, void* stream) {             \
    if (nx != NX || nu != NU) return cudaErrorInvalidValue;                                   \
    RiccatiArgs a{fx,  fu,  lx, lu, lxx, luu, lux, fxx, fux, fuu, dlb, dub,                   \
                  gN,  HN,  reg, ddp, kff, K, dV1, dV2, gmax, B, N, tol};                     \
    return riccati_entry<NX, NU>(a, use_ddp != 0, variant, problems, layout, clocks, stream,  \
                                 mv_riccati_warps_launch_##NX##x##NU);                        \
  }
