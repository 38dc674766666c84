// Riccati backward kernel, variant "warps" (riccati_warps.cuh), instantiated
// for nx = 5, nu = 2.
#include "riccati_warps.cuh"

cudaError_t mv_riccati_warps_launch_5x2(const RiccatiArgs& a, bool ddp, int problems,
                                        const int* layout, long long* clocks, cudaStream_t s) {
  return riccati_warps_launch<5, 2>(a, ddp, problems, layout, clocks, s);
}
