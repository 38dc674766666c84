// Fused parallel line search / pre-roll (K2) and the rounds' cost re-base for
// the linear rate-form device model (linear_rate.cuh): the kernels of
// rollout.cuh instantiated at (nx0, nu) = (3, 1) and (4, 1), so (nx, nu) =
// (4, 1) and (5, 1), and for the curvature cost's model and the weighted model
// (a state weight from the params) at (3, 1), in a translation unit of their
// own that compiles in parallel with rollout.cu.

#include "linear_rate.cuh"
#include "rollout.cuh"

namespace {

// Unpack model kind 1, 2, 4 or 5 from the host arrays and the device tables,
// and call run(model) on it; cudaErrorInvalidValue for another kind or a
// model that reads columns past npar.
template <class Run>
cudaError_t on_linear(int kind, const float* model, const int* ints, const float* tables,
                      int npar, int N, Run run) {
  auto fits = [&](const auto& m) {
    return model_fits(m, npar, N) ? run(m) : cudaErrorInvalidValue;
  };
  if (kind == 1) return fits(unpack_linear<3, 1>(model, ints, tables));
  if (kind == 2) return fits(unpack_linear<4, 1>(model, ints, tables));
  if (kind == 4) return fits(unpack_curvature<3, 1>(model, ints, tables));
  if (kind == 5) return fits(unpack_weighted<3, 1>(model, ints, tables));
  return cudaErrorInvalidValue;
}

}  // namespace

// Called by mv_linesearch_forward (rollout.cu) for model kinds 1, 2, 4 and 5.
cudaError_t mv_linesearch_linear(int kind, const float* model, const int* ints,
                                 const float* tables, const RolloutArgs& g, const Alphas& al,
                                 int variant, const LanesLayout& L, cudaStream_t s) {
  return on_linear(kind, model, ints, tables, g.npar, g.N,
                   [&](const auto& m) { return linesearch_run(m, g, al, variant, L, s); });
}

// Called by mv_trajectory_cost (rollout.cu) for model kinds 1, 2, 4 and 5.
cudaError_t mv_trajectory_cost_linear(int kind, const float* model, const int* ints,
                                      const float* tables, const CostArgs& g, cudaStream_t s) {
  return on_linear(kind, model, ints, tables, g.npar, g.N,
                   [&](const auto& m) { return trajectory_cost_run(m, g, s); });
}
