// Riccati backward kernel (riccati.cuh) instantiated for nx = 3, nu = 2.
#include "riccati.cuh"

cudaError_t mv_riccati_launch_3x2(const RiccatiArgs& a, bool ddp, cudaStream_t s) {
  return riccati_launch<3, 2>(a, ddp, s);
}
