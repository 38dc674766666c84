// Riccati backward kernel, variant "thread" (riccati.cuh), instantiated for nx = 5, nu = 2.
#include "riccati.cuh"

cudaError_t mv_riccati_launch_5x2(const RiccatiArgs& a, bool ddp, cudaStream_t s) {
  return riccati_launch<5, 2>(a, ddp, s);
}
