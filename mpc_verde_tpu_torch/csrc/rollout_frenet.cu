// Fused parallel line search / pre-roll (K2) and the rounds' cost re-base for
// the Frenet rate-form device model (frenet_rate.cuh): the kernels of
// rollout.cuh instantiated at (nx, nu) = (5, 2), in a translation unit of
// their own that compiles in parallel with rollout.cu.

#include "frenet_rate.cuh"
#include "rollout.cuh"

// Called by mv_linesearch_forward (rollout.cu) for model kind 3.
cudaError_t mv_linesearch_frenet(const float* model, const int* ints, const float* tables,
                                 const RolloutArgs& g, const Alphas& al, int variant,
                                 const LanesLayout& L, cudaStream_t s) {
  const FrenetRateModel m = unpack_frenet(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return linesearch_run(m, g, al, variant, L, s);
}

// Called by mv_trajectory_cost (rollout.cu) for model kind 3.
cudaError_t mv_trajectory_cost_frenet(const float* model, const int* ints, const float* tables,
                                      const CostArgs& g, cudaStream_t s) {
  const FrenetRateModel m = unpack_frenet(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return trajectory_cost_run(m, g, s);
}
