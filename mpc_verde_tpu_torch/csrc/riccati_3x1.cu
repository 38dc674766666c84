// Riccati backward kernel (riccati.cuh) instantiated for nx = 3, nu = 1.
#include "riccati.cuh"

cudaError_t mv_riccati_launch_3x1(const RiccatiArgs& a, bool ddp, cudaStream_t s) {
  return riccati_launch<3, 1>(a, ddp, s);
}
