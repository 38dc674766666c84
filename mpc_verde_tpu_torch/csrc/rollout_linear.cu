// Fused parallel line search / pre-roll (K2) for the linear rate-form device
// model (linear_rate.cuh): the kernels of rollout.cuh instantiated at
// (nx0, nu) = (3, 1) and (4, 1), so (nx, nu) = (4, 1) and (5, 1), and for the
// curvature cost's model and the weighted model (a state weight from the
// params) at (3, 1), in a translation unit of their own that compiles in
// parallel with rollout.cu.

#include "linear_rate.cuh"
#include "rollout.cuh"

namespace {

template <int NX0, int NU>
cudaError_t run_linear(const float* model, const int* ints, const float* tables,
                       const RolloutArgs& g, const Alphas& al, int variant, const LanesLayout& L,
                       cudaStream_t s) {
  const LinearRateModel<NX0, NU> m = unpack_linear<NX0, NU>(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return linesearch_run(m, g, al, variant, L, s);
}

template <int NX0, int NU>
cudaError_t run_weighted(const float* model, const int* ints, const float* tables,
                         const RolloutArgs& g, const Alphas& al, int variant, const LanesLayout& L,
                         cudaStream_t s) {
  const WeightedRateModel<NX0, NU> m = unpack_weighted<NX0, NU>(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return linesearch_run(m, g, al, variant, L, s);
}

template <int NX0, int NU>
cudaError_t run_curvature(const float* model, const int* ints, const float* tables,
                          const RolloutArgs& g, const Alphas& al, int variant,
                          const LanesLayout& L, cudaStream_t s) {
  const CurvatureRateModel<NX0, NU> m = unpack_curvature<NX0, NU>(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return linesearch_run(m, g, al, variant, L, s);
}

}  // namespace

// Called by mv_linesearch_forward (rollout.cu) for model kinds 1, 2, 4 and 5.
cudaError_t mv_linesearch_linear(int kind, const float* model, const int* ints,
                                 const float* tables, const RolloutArgs& g, const Alphas& al,
                                 int variant, const LanesLayout& L, cudaStream_t s) {
  if (kind == 1) return run_linear<3, 1>(model, ints, tables, g, al, variant, L, s);
  if (kind == 2) return run_linear<4, 1>(model, ints, tables, g, al, variant, L, s);
  if (kind == 4) return run_curvature<3, 1>(model, ints, tables, g, al, variant, L, s);
  if (kind == 5) return run_weighted<3, 1>(model, ints, tables, g, al, variant, L, s);
  return cudaErrorInvalidValue;
}
