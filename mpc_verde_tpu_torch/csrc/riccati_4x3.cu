// Riccati backward kernel (riccati.cuh) instantiated for nx = 4, nu = 3.
#include "riccati.cuh"

cudaError_t mv_riccati_launch_4x3(const RiccatiArgs& a, bool ddp, cudaStream_t s) {
  return riccati_launch<4, 3>(a, ddp, s);
}
