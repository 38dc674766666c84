// Riccati backward kernel, variant "thread" (riccati.cuh), instantiated for nx = 4, nu = 1.
#include "riccati.cuh"

cudaError_t mv_riccati_launch_4x1(const RiccatiArgs& a, bool ddp, cudaStream_t s) {
  return riccati_launch<4, 1>(a, ddp, s);
}
