// Batched box-constrained Riccati backward pass (K1): the C entry point,
// loaded with ctypes.  The kernels are in riccati.cuh ("thread") and
// riccati_warps.cuh ("warps"); each instantiated (nx, nu) of each variant is
// compiled in its own riccati_<nx>x<nu>.cu or riccati_warps_<nx>x<nu>.cu.

#include "riccati.cuh"

// All pointers are device pointers to contiguous float32 tensors in the JAX
// (B, N, ...) layouts; fxx/fux/fuu are ignored when use_ddp is 0.  `variant`
// is 0 "thread" or 1 "warps"; for "warps", `problems` is the number of
// problems a block takes and `layout` a host array of the ints of
// WarpsLayout (riccati_warps.cuh) from `in` on, as riccati_launch_plan
// computes them; `clocks` is null, or (nx = 3, nu = 2, DDP, "warps" only) a
// device array of 9 int64 per block: the launch is then of the timing
// instantiation, which writes the block's cycles there.  Returns the CUDA
// error of setting the shared-memory size or of the launch, or
// cudaErrorInvalidValue for an (nx, nu) that has no instantiation or a bad
// plan.
extern "C" int mv_riccati_backward(int nx, int nu, int use_ddp, int B, int N, float tol,
                                   const float* fx, const float* fu, const float* lx,
                                   const float* lu, const float* lxx, const float* luu,
                                   const float* lux, const float* fxx, const float* fux,
                                   const float* fuu, const float* dlb, const float* dub,
                                   const float* gN, const float* HN, const float* reg,
                                   const float* ddp, float* kff, float* K, float* dV1,
                                   float* dV2, float* gmax, int variant, int problems,
                                   const int* layout, void* clocks, void* stream) {
  if (variant < 0 || variant > 1 || (variant == 0 && clocks != nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  RiccatiArgs a{fx, fu, lx, lu, lxx, luu, lux, fxx, fux, fuu, dlb, dub, gN, HN, reg, ddp,
                kff, K, dV1, dV2, gmax, B, N, tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool d = use_ddp != 0;
  long long* c = static_cast<long long*>(clocks);
  if (variant == 0) {
    if (nx == 3 && nu == 1) return mv_riccati_launch_3x1(a, d, s);
    if (nx == 3 && nu == 2) return mv_riccati_launch_3x2(a, d, s);
    if (nx == 4 && nu == 1) return mv_riccati_launch_4x1(a, d, s);
    if (nx == 5 && nu == 1) return mv_riccati_launch_5x1(a, d, s);
    if (nx == 5 && nu == 2) return mv_riccati_launch_5x2(a, d, s);
    if (nx == 4 && nu == 3) return mv_riccati_launch_4x3(a, d, s);
    if (nx == 5 && nu == 4) return mv_riccati_launch_5x4(a, d, s);
  } else {
    if (nx == 3 && nu == 1) return mv_riccati_warps_launch_3x1(a, d, problems, layout, c, s);
    if (nx == 3 && nu == 2) return mv_riccati_warps_launch_3x2(a, d, problems, layout, c, s);
    if (nx == 4 && nu == 1) return mv_riccati_warps_launch_4x1(a, d, problems, layout, c, s);
    if (nx == 5 && nu == 1) return mv_riccati_warps_launch_5x1(a, d, problems, layout, c, s);
    if (nx == 5 && nu == 2) return mv_riccati_warps_launch_5x2(a, d, problems, layout, c, s);
    if (nx == 4 && nu == 3) return mv_riccati_warps_launch_4x3(a, d, problems, layout, c, s);
    if (nx == 5 && nu == 4) return mv_riccati_warps_launch_5x4(a, d, problems, layout, c, s);
  }
  return cudaErrorInvalidValue;
}
