// Fused parallel line search / pre-roll (K2): the C entry point, and the
// kernels of rollout.cuh instantiated for the unicycle device model
// (unicycle.cuh).  The rate-form models' instantiations are in
// rollout_linear.cu and rollout_frenet.cu, compiled in parallel with this
// file.
//
// Replaces the Pallas TPU kernel linesearch_forward_pallas
// (mpc_verde_tpu/ops/pallas/rollout.py, body _make_kernel); rollout.cuh
// describes the design.

#include "unicycle.cuh"
#include "rollout.cuh"

// rollout_linear.cu: model kind 1 (nx0 3, nu 1), 2 (nx0 4, nu 1), 4 (the
// curvature cost at nx0 3, nu 1) or 5 (the state weight from the params at
// nx0 3, nu 1), from the host arrays of linear_rate.cuh's unpack_linear /
// unpack_curvature / unpack_weighted and the device tables.
cudaError_t mv_linesearch_linear(int kind, const float* model, const int* ints,
                                 const float* tables, const RolloutArgs& g, const Alphas& al,
                                 int variant, const LanesLayout& L, cudaStream_t s);
// rollout_frenet.cu: model kind 3, from the host arrays of frenet_rate.cuh's
// unpack_frenet and the device tables.
cudaError_t mv_linesearch_frenet(const float* model, const int* ints, const float* tables,
                                 const RolloutArgs& g, const Alphas& al, int variant,
                                 const LanesLayout& L, cudaStream_t s);

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: x0 (B,nx), xs (B,N+1,nx),
// us (B,N,nu), ps (B,N+1,npar), kff (B,N,nu), K (B,N,nu,nx); outputs xs_out,
// us_out, cost_out (B,) and best_out (B,) int32.  `kind` is the device
// model: 0 the unicycle (nx 3, nu 2; `model` and `model_ints` the host
// arrays of unicycle.cuh's unpack_model, `tables` unused), 1 or 2 the linear
// rate-form model at (nx, nu) = (4, 1) or (5, 1) (the host arrays of
// linear_rate.cuh's unpack_linear, `tables` the device array of its
// per-stage rate bounds), 3 the Frenet rate-form model at (5, 2)
// (frenet_rate.cuh's unpack_frenet, `tables` as for the linear model), 4 the
// linear model with the curvature cost at (4, 1) (unpack_curvature), 5 the
// linear model at (4, 1) with a state weight from the params
// (unpack_weighted).  `alphas` is a host array of n_alphas floats.
// `variant` is 0 "thread", 1 "lanes" or 2 "lanes_reroll"; for the lanes
// variants `problems` is the number of problems a block takes and `layout`
// a host array of the 9 ints of LanesLayout from `xs` on, as
// linesearch_launch_plan computes them.  Returns the CUDA error of setting
// the shared-memory size or of the launch, or cudaErrorInvalidValue for a
// bad alpha count, model kind or plan, or a model that reads columns past
// npar.
extern "C" int mv_linesearch_forward(int kind, int B, int N, int npar, const float* x0,
                                     const float* xs, const float* us, const float* ps,
                                     const float* kff, const float* K, const float* model,
                                     const int* model_ints, const float* tables,
                                     const float* alphas, int n_alphas, float* xs_out,
                                     float* us_out, float* cost_out, int* best_out, int variant,
                                     int problems, const int* layout, void* stream) {
  if (kind < 0 || kind > 5) return cudaErrorInvalidValue;
  Alphas al;
  LanesLayout L;
  const cudaError_t err = linesearch_prepare(alphas, n_alphas, variant, problems, layout, al, L);
  if (err != cudaSuccess) return err;
  const UnicycleModel m = kind == 0 ? unpack_model(model, model_ints) : UnicycleModel{};
  if (kind == 0 && !model_fits(m, npar)) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const RolloutArgs g{x0, xs, us, ps, kff, K, xs_out, us_out, cost_out, best_out, B, N, npar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 3) return mv_linesearch_frenet(model, model_ints, tables, g, al, variant, L, s);
  if (kind != 0) return mv_linesearch_linear(kind, model, model_ints, tables, g, al, variant, L, s);
  return linesearch_run(m, g, al, variant, L, s);
}
