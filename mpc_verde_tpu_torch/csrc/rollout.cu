// Fused parallel line search / pre-roll (K2) and the rounds' cost re-base:
// the C entry points, and the kernels of rollout.cuh instantiated for the
// unicycle device model (unicycle.cuh).  Every other OCP runs them on the
// model generated from its callables, in a library of its own
// (ops/cuda/codegen.py).
//
// Replaces the Pallas TPU kernel linesearch_forward_pallas
// (mpc_verde_tpu/ops/pallas/rollout.py, body _make_kernel); rollout.cuh
// describes the design.

#include "unicycle.cuh"
#include "rollout.cuh"

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: x0 (B,nx), xs (B,N+1,nx),
// us (B,N,nu), ps (B,N+1,npar), kff (B,N,nu), K (B,N,nu,nx); outputs xs_out,
// us_out, cost_out (B,) and best_out (B,) int32.  The device model is the
// unicycle (nx 3, nu 2): `model` and `model_ints` are the host arrays of
// unicycle.cuh's unpack_model, `tables` is unused.  `alphas` is a host array
// of n_alphas floats.  `variant` is 0 "lanes" or 1 "lanes_ring";
// `problems` is the number of problems a block takes and `layout` a host
// array of LanesLayout's ints as linesearch_prepare (rollout.cuh) reads them
// and linesearch_launch_plan computes them.
// Returns the CUDA error of setting the shared-memory size or of the launch,
// or cudaErrorInvalidValue for a bad alpha count or plan, or a model that
// reads columns past npar.
extern "C" int mv_linesearch_forward(int B, int N, int npar, const float* x0,
                                     const float* xs, const float* us, const float* ps,
                                     const float* kff, const float* K, const float* model,
                                     const int* model_ints, const float* tables,
                                     const float* alphas, int n_alphas, float* xs_out,
                                     float* us_out, float* cost_out, int* best_out, int variant,
                                     int problems, const int* layout, void* stream) {
  Alphas al;
  LanesLayout L;
  const cudaError_t err = linesearch_prepare(alphas, n_alphas, variant, problems, layout, al, L);
  if (err != cudaSuccess) return err;
  const UnicycleModel m = unpack_model(model, model_ints);
  if (!model_fits(m, npar)) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const RolloutArgs g{x0, xs, us, ps, kff, K, xs_out, us_out, cost_out, best_out, B, N, npar};
  return linesearch_run(m, g, al, variant, L, static_cast<cudaStream_t>(stream));
}

// Plain C entry point: what the CUDA runtime says of K2's `variant` kernel
// on the unicycle model at `threads` a block and `smem_bytes` of dynamic
// shared memory: out[0] registers a thread, out[1] local memory a thread
// (bytes), out[2] resident blocks an SM.  Returns the CUDA error.
extern "C" int mv_linesearch_occupancy(int variant, int threads, int smem_bytes, int* out) {
  return linesearch_occupancy<UnicycleModel>(variant, threads, smem_bytes, out);
}

// Plain C entry point of the rounds' cost re-base (trajectory_cost_kernel):
// xs (B,N+1,nx), us (B,N,nu), ps (B,N+1,npar), cost_in (B,) contiguous
// float32 and mask (B,) bool, device pointers; cost_out (B,) float32.
// `model`, `model_ints` and `tables` as for mv_linesearch_forward.  Returns
// the CUDA error of the launch, or cudaErrorInvalidValue for a model that
// reads columns past npar.
extern "C" int mv_trajectory_cost(int B, int N, int npar, const float* xs,
                                  const float* us, const float* ps, const bool* mask,
                                  const float* cost_in, const float* model,
                                  const int* model_ints, const float* tables, float* cost_out,
                                  void* stream) {
  const UnicycleModel m = unpack_model(model, model_ints);
  if (!model_fits(m, npar)) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const CostArgs g{xs, us, ps, mask, cost_in, cost_out, B, N, npar};
  return trajectory_cost_run(m, g, static_cast<cudaStream_t>(stream));
}
