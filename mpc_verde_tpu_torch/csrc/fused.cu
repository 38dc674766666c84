// Fused stage derivatives + Riccati backward pass (K3): the C entry point,
// and the kernels of fused.cuh instantiated for the unicycle device model
// (unicycle.cuh), its timing instantiation included.  Every other OCP runs
// them on the model generated from its callables, in a library of its own
// (ops/cuda/codegen.py).
//
// Replaces the Pallas TPU kernel make_fused_backward
// (mpc_verde_tpu/ops/pallas/fused.py, body _make_fused_kernel); fused.cuh
// describes the design.

#include "dual.cuh"
#include "unicycle.cuh"

namespace {

// The unicycle's terminal value at x_N: the gradient and Hessian of
// (x - p[:3])' Qf (x - p[:3]) in closed form, plus the AL penalty's from one
// evaluation on second-order duals over x_N.
__device__ __forceinline__ void model_terminal_value(const UnicycleModel& m, const float* xN,
                                                     const float* pN, float (&Vx)[kNX],
                                                     float (&Vxx)[kNX][kNX]) {
#pragma unroll
  for (int i = 0; i < kNX; ++i)
#pragma unroll
    for (int j = 0; j < kNX; ++j)
      Vxx[i][j] = m.has_terminal ? m.Qf[i * kNX + j] + m.Qf[j * kNX + i] : 0.0f;
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kNX; ++j) acc = acc + Vxx[i][j] * (xN[j] - pN[j]);
    Vx[i] = acc;
  }
  if (m.al) {
    Dual<kNX, true> xz[kNX];
#pragma unroll
    for (int i = 0; i < kNX; ++i) xz[i] = Dual<kNX, true>::var(xN[i], i);
    const Dual<kNX, true> pen = al_penalty(m, xz, pN);
#pragma unroll
    for (int i = 0; i < kNX; ++i) {
      Vx[i] = Vx[i] + pen.g[i];
#pragma unroll
      for (int j = 0; j < kNX; ++j) Vxx[i][j] = Vxx[i][j] + pen.hess(i, j);
    }
  }
}

}  // namespace

#include "fused.cuh"

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: xs (B,N+1,nx), us (B,N,nu),
// ps (B,N+1,npar), reg (B,), ddp (B,); outputs kff (B,N,nu), K (B,N,nu,nx),
// dV1, dV2, gmax (B,).  The device model is the unicycle (nx 3, nu 2):
// `model` and `model_ints` are the host arrays of unicycle.cuh's
// unpack_model, `tables` is unused.  `variant` is 0 "thread" or 1 "staged";
// for "staged", `problems` is the number of problems a block takes,
// `threads` its size and `strides` a host array of StagedLayout's three
// per-problem strides, as fused_launch_plan computes them; `clocks` is null,
// or (DDP only) a device array of 3 int64 per block: the launch is then of
// the timing instantiation, which writes there the block's cycles in phase
// 1, phase 2 and the write-out.  Returns the CUDA error of setting the
// shared-memory size or of the launch, or cudaErrorInvalidValue for a bad
// plan, or a model that reads columns past npar.
extern "C" int mv_fused_backward(int use_ddp, int B, int N, int npar, float tol,
                                 const float* xs, const float* us, const float* ps,
                                 const float* reg, const float* ddp, const float* model,
                                 const int* model_ints, const float* tables, float* kff,
                                 float* K, float* dV1, float* dV2, float* gmax, int variant,
                                 int problems, int threads, const int* strides, void* clocks,
                                 void* stream) {
  if (variant < 0 || variant > 1) return cudaErrorInvalidValue;
  const UnicycleModel m = unpack_model(model, model_ints);
  if (!model_fits(m, npar)) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const FusedArgs g{xs, us, ps, reg, ddp, kff, K, dV1, dV2, gmax, B, N, npar, tol};
  return fused_run<UnicycleModel, true>(m, g, use_ddp != 0, variant, problems, threads, strides,
                                        static_cast<long long*>(clocks),
                                        static_cast<cudaStream_t>(stream));
}
