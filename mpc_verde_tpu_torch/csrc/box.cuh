// The stage's control box as the kernels K2 (rollout.cuh) and K3
// (fused.cuh) read it: model_box(m, x, p, k, lo, hi), evaluated on the state
// being rolled (K2) or the nominal state (K3).  A hand-written model gives
// bounds(x, k, lo, hi) and reads no parameter, so this template forwards to
// it; a model generated from the trace of an OCP's callables
// (ops/cuda/codegen.py), whose box cb(x, p, k) may read p, overloads
// model_box itself.

#pragma once

#include <cuda_runtime.h>

namespace {

template <class Model, int NX, int NU>
__device__ __forceinline__ void model_box(const Model& m, const float (&x)[NX], const float*,
                                          int k, float (&lo)[NU], float (&hi)[NU]) {
  m.bounds(x, k, lo, hi);
}

}  // namespace
