// Fused stage derivatives + Riccati backward pass (K3): the C entry point,
// and the kernels of fused.cuh instantiated for the unicycle device model
// (unicycle.cuh), its timing instantiation included.  The rate-form models'
// instantiations are in fused_linear.cu and fused_frenet.cu, compiled in
// parallel with this file.
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

// fused_linear.cu: model kind 1 (nx0 3, nu 1), 2 (nx0 4, nu 1), 4 (the
// curvature cost at nx0 3, nu 1) or 5 (the state weight from the params at
// nx0 3, nu 1), from the host arrays of linear_rate.cuh's unpack_linear /
// unpack_curvature / unpack_weighted and the device tables.
cudaError_t mv_fused_linear(int kind, const float* model, const int* ints, const float* tables,
                            const FusedArgs& g, bool use_ddp, int variant, int problems,
                            int threads, const int* strides, long long* clocks, cudaStream_t s);
// fused_frenet.cu: model kind 3, from the host arrays of frenet_rate.cuh's
// unpack_frenet and the device tables.
cudaError_t mv_fused_frenet(const float* model, const int* ints, const float* tables,
                            const FusedArgs& g, bool use_ddp, int variant, int problems,
                            int threads, const int* strides, long long* clocks, cudaStream_t s);

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: xs (B,N+1,nx), us (B,N,nu),
// ps (B,N+1,npar), reg (B,), ddp (B,); outputs kff (B,N,nu), K (B,N,nu,nx),
// dV1, dV2, gmax (B,).  `kind` is the device model: 0 the unicycle (nx 3,
// nu 2; `model` and `model_ints` the host arrays of unicycle.cuh's
// unpack_model, `tables` unused), 1 or 2 the linear rate-form model at
// (nx, nu) = (4, 1) or (5, 1) (the host arrays of linear_rate.cuh's
// unpack_linear, `tables` the device array of its per-stage rate bounds), 3
// the Frenet rate-form model at (5, 2) (frenet_rate.cuh's unpack_frenet,
// `tables` as for the linear model), 4 the linear model with the curvature
// cost at (4, 1) (unpack_curvature), 5 the linear model at (4, 1) with a
// state weight from the params (unpack_weighted).
// `variant` is 0 "thread" or 1 "staged"; for "staged", `problems` is the
// number of problems a block takes, `threads` its size and `strides` a host
// array of StagedLayout's three per-problem strides, as fused_launch_plan
// computes them; `clocks` is null, or (the unicycle, DDP only) a device
// array of 3 int64 per block: the launch is then of the timing
// instantiation, which writes there the block's cycles in phase 1, phase 2
// and the write-out.  Returns the CUDA error of setting the shared-memory
// size or of the launch, or cudaErrorInvalidValue for a bad model kind or
// plan, or a model that reads columns past npar.
extern "C" int mv_fused_backward(int kind, int use_ddp, int B, int N, int npar, float tol,
                                 const float* xs, const float* us, const float* ps,
                                 const float* reg, const float* ddp, const float* model,
                                 const int* model_ints, const float* tables, float* kff,
                                 float* K, float* dV1, float* dV2, float* gmax, int variant,
                                 int problems, int threads, const int* strides, void* clocks,
                                 void* stream) {
  if (kind < 0 || kind > 5 || variant < 0 || variant > 1) return cudaErrorInvalidValue;
  const UnicycleModel m = kind == 0 ? unpack_model(model, model_ints) : UnicycleModel{};
  if (kind == 0 && !model_fits(m, npar)) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const FusedArgs g{xs, us, ps, reg, ddp, kff, K, dV1, dV2, gmax, B, N, npar, tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* c = static_cast<long long*>(clocks);
  if (kind == 3)
    return mv_fused_frenet(model, model_ints, tables, g, use_ddp != 0, variant, problems, threads,
                           strides, c, s);
  if (kind != 0)
    return mv_fused_linear(kind, model, model_ints, tables, g, use_ddp != 0, variant, problems,
                           threads, strides, c, s);
  return fused_run<UnicycleModel, true>(m, g, use_ddp != 0, variant, problems, threads, strides,
                                        c, s);
}
