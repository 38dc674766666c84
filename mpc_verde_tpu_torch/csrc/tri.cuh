// Index into the upper triangle of a symmetric n x n matrix stored row-major
// (n (n + 1) / 2 entries): the order in which the dual numbers of dual.cuh
// keep a Hessian and in which the fused kernel's stage records in shared
// memory (SharedStage, riccati.cuh) store it.

#pragma once

namespace {

// Symmetric in (i, j).  Written without a branch or a recursive call, so that
// with the indices of an unrolled loop it folds to a constant: a recursive
// swap compiles to a run-time loop and makes every Hessian read an indexed
// one (a stack frame, where the duals would sit in registers).
__host__ __device__ constexpr int tri_index(int n, int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo * n - lo * (lo - 1) / 2 + (hi - lo);
}

}  // namespace
