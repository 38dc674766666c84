// Fused stage derivatives + Riccati backward pass (K3) for the linear
// rate-form device model (linear_rate.cuh): the kernels of fused.cuh
// instantiated at (nx0, nu) = (3, 1) and (4, 1), so (nx, nu) = (4, 1) and
// (5, 1), and for the curvature cost's model and the weighted model (a
// state weight from the params) at (3, 1), in a translation unit of their
// own that compiles in parallel with fused.cu.  No timing
// instantiation.

#include "dual.cuh"
#include "linear_rate.cuh"
#include "fused.cuh"

namespace {

template <int NX0, int NU>
cudaError_t run_linear(const float* model, const int* ints, const float* tables,
                       const FusedArgs& g, bool use_ddp, int variant, int problems, int threads,
                       const int* strides, long long* clocks, cudaStream_t s) {
  const LinearRateModel<NX0, NU> m = unpack_linear<NX0, NU>(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return fused_run<LinearRateModel<NX0, NU>, false>(m, g, use_ddp, variant, problems, threads,
                                                    strides, clocks, s);
}

template <int NX0, int NU>
cudaError_t run_weighted(const float* model, const int* ints, const float* tables,
                         const FusedArgs& g, bool use_ddp, int variant, int problems, int threads,
                         const int* strides, long long* clocks, cudaStream_t s) {
  const WeightedRateModel<NX0, NU> m = unpack_weighted<NX0, NU>(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return fused_run<WeightedRateModel<NX0, NU>, false>(m, g, use_ddp, variant, problems, threads,
                                                      strides, clocks, s);
}

template <int NX0, int NU>
cudaError_t run_curvature(const float* model, const int* ints, const float* tables,
                          const FusedArgs& g, bool use_ddp, int variant, int problems,
                          int threads, const int* strides, long long* clocks, cudaStream_t s) {
  const CurvatureRateModel<NX0, NU> m = unpack_curvature<NX0, NU>(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return fused_run<CurvatureRateModel<NX0, NU>, false>(m, g, use_ddp, variant, problems,
                                                       threads, strides, clocks, s);
}

}  // namespace

// Called by mv_fused_backward (fused.cu) for model kinds 1, 2, 4 and 5.
cudaError_t mv_fused_linear(int kind, const float* model, const int* ints, const float* tables,
                            const FusedArgs& g, bool use_ddp, int variant, int problems,
                            int threads, const int* strides, long long* clocks, cudaStream_t s) {
  if (kind == 1)
    return run_linear<3, 1>(model, ints, tables, g, use_ddp, variant, problems, threads, strides,
                            clocks, s);
  if (kind == 2)
    return run_linear<4, 1>(model, ints, tables, g, use_ddp, variant, problems, threads, strides,
                            clocks, s);
  if (kind == 4)
    return run_curvature<3, 1>(model, ints, tables, g, use_ddp, variant, problems, threads,
                               strides, clocks, s);
  if (kind == 5)
    return run_weighted<3, 1>(model, ints, tables, g, use_ddp, variant, problems, threads,
                              strides, clocks, s);
  return cudaErrorInvalidValue;
}
