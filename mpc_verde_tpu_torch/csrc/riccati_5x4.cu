// Riccati backward kernel (riccati.cuh) instantiated for nx = 5, nu = 4.
#include "riccati.cuh"

cudaError_t mv_riccati_launch_5x4(const RiccatiArgs& a, bool ddp, cudaStream_t s) {
  return riccati_launch<5, 4>(a, ddp, s);
}
