// Riccati backward kernel, variant "warps" (riccati_warps.cuh), instantiated
// for nx = 4, nu = 1.
#include "riccati_warps.cuh"

cudaError_t mv_riccati_warps_launch_4x1(const RiccatiArgs& a, bool ddp, int problems,
                                        const int* layout, long long* clocks, cudaStream_t s) {
  return riccati_warps_launch<4, 1>(a, ddp, problems, layout, clocks, s);
}
