// Batched box-constrained Riccati backward pass (K1), CUDA C++ for sm_90a:
// the kernel template.  ops/cuda/build.py generates the translation units of
// one (nx, nu) when that size is first used (riccati_entry.cuh) and compiles
// them into a library of that size alone.
//
// Replaces the Pallas TPU kernel riccati_backward_pallas
// (mpc_verde_tpu/ops/pallas/riccati.py, body _backward_stage / _make_kernel).
//
// What bounds it on the H100.  At B = 1024, N = 40, nx = 3, nu = 2 with DDP
// the function reads 100 floats a stage and writes 8: 17.7 MB, 5.3 us at
// 3.35 TB/s, and its arithmetic (about 1k flops a stage) is 0.6 us at
// 67 TFLOP/s.  Neither is the limit: the recursion is a chain of N stage
// QPs, each waiting for the next stage's (Vx, Vxx), and 1024 problems are too
// few threads to hide one chain behind another.  The chain's length in
// dependent instructions times N is the floor no design passes under.
//
// The stage (below: expand_u, expand_x, scan_candidates, free_gain,
// finish_stage) reads
// its derivatives through an accessor and is shared with the fused kernel K3
// (fused.cu), which computes the derivatives itself.  The 3^NU active-set
// patterns of the stage box QP (itertools.product order, strict-< first
// minimum) are unrolled at compile time per (NX, NU): each candidate step
// solves its free system (up to two free coordinates in closed form, three
// or four by no-pivot Gaussian elimination, as _backward_stage does).  The
// feedback gain K is solved once per stage, for the winning pattern only, on
// the masked system (identity rows for clamped coordinates, whose K rows are
// zero): solving it per candidate, as the TPU kernel does, made nvcc take
// minutes for nu = 4.
//
// Variants, chosen by the caller from the shape (riccati_launch_plan in
// ops/cuda/riccati.py, which also computes the shared-memory layout):
//   "warps" (riccati_warps.cuh, in its own generated unit a size):
//   a block stages its problems' derivative slabs in shared memory with
//   coalesced 16-byte copies and gives each problem one lane in each of its
//   warps; a warp per share of the active-set patterns solves the candidates
//   while another expands Qx, Qxx, Qux, and that warp then finishes the
//   stage.  It shortens the chain and removes the uncoalesced loads.
//   "thread" (this file): one thread per problem walks the stages N-1..0 over
//   device memory with (Vx, Vxx) and the accumulators in registers.  The
//   loads keep the JAX (B, N, ...) layout, so neighbouring threads read
//   addresses one stage-block apart and do not coalesce.  It needs no shared
//   memory, so it takes the shapes "warps" does not fit and the batches whose
//   "warps" blocks would run in many waves.
// Both run the same stage functions, so their results are the same floats.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>
#include <utility>

#include "tri.cuh"

// Kernel arguments: device pointers in the JAX (B, N, ...) layouts.
struct RiccatiArgs {
  const float *fx, *fu, *lx, *lu, *lxx, *luu, *lux, *fxx, *fux, *fuu;
  const float *dlb, *dub, *gN, *HN, *reg, *ddp;
  float *kff, *K, *dV1, *dV2, *gmax;
  int B, N;
  float tol;
};

namespace {

constexpr float kBig = 1e30f;

__host__ __device__ constexpr int pow3(int n) { return n == 0 ? 1 : 3 * pow3(n - 1); }

// Pattern digit of coordinate a: 0 free, 1 at lower, 2 at upper.  Coordinate
// 0 is the most significant digit, matching itertools.product((0, 1, 2)).
__host__ __device__ constexpr int pat_digit(int pat, int nu, int a) {
  return (pat / pow3(nu - 1 - a)) % 3;
}

__host__ __device__ constexpr int pat_nfree(int pat, int nu) {
  int n = 0;
  for (int a = 0; a < nu; ++a) n += pat_digit(pat, nu, a) == 0 ? 1 : 0;
  return n;
}

// Coordinate index of the j-th free coordinate of a pattern.
__host__ __device__ constexpr int pat_free(int pat, int nu, int j) {
  int n = 0;
  for (int a = 0; a < nu; ++a) {
    if (pat_digit(pat, nu, a) == 0) {
      if (n == j) return a;
      ++n;
    }
  }
  return 0;
}

// Calls f(std::integral_constant<int, I>{}) for I = 0..N-1, in order.
template <class F, int... Is>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}

template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// Solve A X_r = rhs_r for NR right-hand sides (stored X[r][0..NF-1]).
template <int NF, int NR>
__device__ __forceinline__ void solve_free(float (&A)[NF][NF], float (&X)[NR][NF]) {
  if constexpr (NF == 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r) X[r][0] = X[r][0] / A[0][0];
  } else if constexpr (NF == 2) {
    const float det = A[0][0] * A[1][1] - A[0][1] * A[1][0];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float x0 = (X[r][0] * A[1][1] - X[r][1] * A[0][1]) / det;
      const float x1 = (X[r][1] * A[0][0] - X[r][0] * A[1][0]) / det;
      X[r][0] = x0;
      X[r][1] = x1;
    }
  } else {
    // no-pivot Gaussian elimination: Quu is SPD + reg, leading pivots > 0
#pragma unroll
    for (int p = 0; p < NF; ++p) {
      const float ip = 1.0f / A[p][p];
#pragma unroll
      for (int r = p + 1; r < NF; ++r) {
        const float m = A[r][p] * ip;
#pragma unroll
        for (int c = p + 1; c < NF; ++c) A[r][c] = A[r][c] - m * A[p][c];
#pragma unroll
        for (int q = 0; q < NR; ++q) X[q][r] = X[q][r] - m * X[q][p];
      }
    }
#pragma unroll
    for (int q = 0; q < NR; ++q) {
#pragma unroll
      for (int r = NF - 1; r >= 0; --r) {
        float acc = X[q][r];
#pragma unroll
        for (int c = r + 1; c < NF; ++c) acc = acc - A[r][c] * X[q][c];
        X[q][r] = acc / A[r][r];
      }
    }
  }
}

// One active-set candidate: its step v and objective (kBig if infeasible,
// non-stationary, or clamped to a non-finite bound).
template <int NU, int PAT>
__device__ __forceinline__ void candidate(const float (&Quu)[NU][NU], const float (&Qu)[NU],
                                          const float (&lo)[NU], const float (&hi)[NU],
                                          float tol, float (&v)[NU], float& obj) {
  constexpr int NF = pat_nfree(PAT, NU);
  bool feas = true;
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    const int d = pat_digit(PAT, NU, a);
    if (d == 1) {
      feas = feas && isfinite(lo[a]);
      v[a] = isfinite(lo[a]) ? lo[a] : 0.0f;
    } else if (d == 2) {
      feas = feas && isfinite(hi[a]);
      v[a] = isfinite(hi[a]) ? hi[a] : 0.0f;
    } else {
      v[a] = 0.0f;
    }
  }
  if constexpr (NF > 0) {
    // Quu_FF v_F = -(Qu_F + Quu_FC v_C)
    float A[NF][NF];
    float X[1][NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = pat_free(PAT, NU, j);
#pragma unroll
      for (int c = 0; c < NF; ++c) A[j][c] = Quu[f][pat_free(PAT, NU, c)];
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < NU; ++c)
        if (pat_digit(PAT, NU, c) != 0) s = s + Quu[f][c] * v[c];
      X[0][j] = -(Qu[f] + s);
    }
    solve_free<NF, 1>(A, X);
#pragma unroll
    for (int j = 0; j < NF; ++j) v[pat_free(PAT, NU, j)] = X[0][j];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    const int d = pat_digit(PAT, NU, a);
    if (d == 0) {
      feas = feas && (v[a] >= lo[a] - tol) && (v[a] <= hi[a] + tol);
    } else {
      float g = Qu[a];
#pragma unroll
      for (int b = 0; b < NU; ++b) g = g + Quu[a][b] * v[b];
      feas = feas && (d == 1 ? g >= -tol : g <= tol);
    }
  }
  float o = 0.0f;
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int b = 0; b < NU; ++b) o = o + 0.5f * v[a] * Quu[a][b] * v[b];
#pragma unroll
  for (int a = 0; a < NU; ++a) o = o + Qu[a] * v[a];
  obj = feas ? o : kBig;
}

// Feedback gain of pattern `pat` (a runtime value): Quu_FF K_F = -Qux_F on
// the masked system, clamped rows zero.  A clamped row's right-hand sides
// never reach a free row's solution (its couplings are masked to 0), so they
// may hold anything.  With zeros, every clamped row costs NX divisions 0 / x,
// and a zero numerator sends the float32 division to its slow path: a
// subroutine of some 250 cycles, 1,700 cycles a stage at nx = 3, nu = 2 with
// one control at its bound (measured, riccati_stage_clocks).  With UNIT_RHS
// they hold 1, the divisions are 1 / 1, and the free rows' floats are the
// same.  K1's kernels pass UNIT_RHS; the default keeps K3's code as it was.
template <int NX, int NU, bool UNIT_RHS = false>
__device__ __forceinline__ void free_gain(const float (&Quu)[NU][NU], const float (&Qux)[NU][NX],
                                          int pat, float (&K)[NU][NX]) {
  bool fr[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) fr[a] = pat_digit(pat, NU, a) == 0;
  float A[NU][NU];
  float X[NX][NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NU; ++c) A[a][c] = (fr[a] && fr[c]) ? Quu[a][c] : (a == c ? 1.0f : 0.0f);
#pragma unroll
    for (int i = 0; i < NX; ++i) X[i][a] = fr[a] ? -Qux[a][i] : (UNIT_RHS ? 1.0f : 0.0f);
  }
  solve_free<NU, NX>(A, X);
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int i = 0; i < NX; ++i) K[a][i] = (UNIT_RHS && !fr[a]) ? 0.0f : X[i][a];
}

// The stage derivatives as the "thread" variant reads them: the (B, N, ...) arrays at
// problem-stage index s.  Stage accessors give fx(m, i) = dF_m/dx_i, fu(m, a),
// lx(i), lu(a), lxx(i, j), luu(a, c), lux(a, i), fxx(m, i, j), fux(m, a, i),
// fuu(m, a, c) (DDP only) and the step bounds lo(a) = lb - u, hi(a) = ub - u.
template <int NX, int NU, bool DDP>
struct GlobalStage {
  const float *fx_, *fu_, *lx_, *lu_, *lxx_, *luu_, *lux_, *fxx_, *fux_, *fuu_, *lo_, *hi_;

  __device__ __forceinline__ GlobalStage(const RiccatiArgs& g, size_t s)
      : fx_(g.fx + s * NX * NX), fu_(g.fu + s * NX * NU), lx_(g.lx + s * NX),
        lu_(g.lu + s * NU), lxx_(g.lxx + s * NX * NX), luu_(g.luu + s * NU * NU),
        lux_(g.lux + s * NU * NX),
        fxx_(DDP ? g.fxx + s * NX * NX * NX : nullptr),
        fux_(DDP ? g.fux + s * NX * NU * NX : nullptr),
        fuu_(DDP ? g.fuu + s * NX * NU * NU : nullptr),
        lo_(g.dlb + s * NU), hi_(g.dub + s * NU) {}

  __device__ __forceinline__ float fx(int m, int i) const { return fx_[m * NX + i]; }
  __device__ __forceinline__ float fu(int m, int a) const { return fu_[m * NU + a]; }
  __device__ __forceinline__ float lx(int i) const { return lx_[i]; }
  __device__ __forceinline__ float lu(int a) const { return lu_[a]; }
  __device__ __forceinline__ float lxx(int i, int j) const { return lxx_[i * NX + j]; }
  __device__ __forceinline__ float luu(int a, int c) const { return luu_[a * NU + c]; }
  __device__ __forceinline__ float lux(int a, int i) const { return lux_[a * NX + i]; }
  __device__ __forceinline__ float fxx(int m, int i, int j) const { return fxx_[(m * NX + i) * NX + j]; }
  __device__ __forceinline__ float fux(int m, int a, int i) const { return fux_[(m * NU + a) * NX + i]; }
  __device__ __forceinline__ float fuu(int m, int a, int c) const { return fuu_[(m * NU + a) * NU + c]; }
  __device__ __forceinline__ float lo(int a) const { return lo_[a]; }
  __device__ __forceinline__ float hi(int a) const { return hi_[a]; }
};

// The stage derivatives as one record of floats (in shared memory for K3's
// "staged" variant): per dynamics component m a gradient over z = [x; u] and,
// with DDP, the upper triangle of its Hessian (tri.cuh's order); the cost's
// gradient and Hessian triangle; then lo and hi.  kStride is the record
// length rounded up to an odd number of floats, so that consecutive records
// written by consecutive lanes fall into different shared-memory banks.
template <int NX, int NU, bool DDP>
struct SharedStage {
  static constexpr int kNZ = NX + NU;
  static constexpr int kTri = kNZ * (kNZ + 1) / 2;
  static constexpr int kF = kNZ + (DDP ? kTri : 0);  // floats per dynamics component
  static constexpr int kL = NX * kF;                 // the cost's gradient
  static constexpr int kLH = kL + kNZ;               // the cost's Hessian triangle
  static constexpr int kLo = kLH + kTri;
  static constexpr int kHi = kLo + NU;
  static constexpr int kFloats = kHi + NU;
  static constexpr int kStride = kFloats | 1;
  const float* r;

  __device__ __forceinline__ float fx(int m, int i) const { return r[m * kF + i]; }
  __device__ __forceinline__ float fu(int m, int a) const { return r[m * kF + NX + a]; }
  __device__ __forceinline__ float lx(int i) const { return r[kL + i]; }
  __device__ __forceinline__ float lu(int a) const { return r[kL + NX + a]; }
  __device__ __forceinline__ float lxx(int i, int j) const { return r[kLH + tri_index(kNZ, i, j)]; }
  __device__ __forceinline__ float luu(int a, int c) const {
    return r[kLH + tri_index(kNZ, NX + a, NX + c)];
  }
  __device__ __forceinline__ float lux(int a, int i) const {
    return r[kLH + tri_index(kNZ, NX + a, i)];
  }
  __device__ __forceinline__ float fxx(int m, int i, int j) const {
    return r[m * kF + kNZ + tri_index(kNZ, i, j)];
  }
  __device__ __forceinline__ float fux(int m, int a, int i) const {
    return r[m * kF + kNZ + tri_index(kNZ, NX + a, i)];
  }
  __device__ __forceinline__ float fuu(int m, int a, int c) const {
    return r[m * kF + kNZ + tri_index(kNZ, NX + a, NX + c)];
  }
  __device__ __forceinline__ float lo(int a) const { return r[kLo + a]; }
  __device__ __forceinline__ float hi(int a) const { return r[kHi + a]; }
};

// One stage of the box-constrained Riccati recursion (the port of
// riccati._backward_stage, which K1 and K3 share in JAX as well) comes in four
// parts, so that a kernel can give them to different warps: expand_u (Qu and
// Quu, all that the stage QP's candidates need), expand_x (Qx, Qxx, Qux; its
// rows are expand_x_row),
// scan_candidates (the warp's share of the 3^NU active-set patterns), then
// free_gain (the winner's gain) and finish_stage (the accumulators, the value
// update).
// backward_stage runs them all in one thread.  All read the stage's
// derivatives through an accessor `d` (GlobalStage, SlabStage of
// riccati_warps.cuh, SharedStage, or the dual numbers of fused.cu).  Each
// output entry is one expression whichever thread evaluates it, so every
// split gives the same floats.

// Qu = lu + fu' Vx and Quu = luu + fu' Vxx fu (+ ds Vx . fuu) + rg I.
template <int NX, int NU, bool DDP, class Stage>
__device__ __forceinline__ void expand_u(const Stage& d, float rg, float ds,
                                         const float (&Vx)[NX], const float (&Vxx)[NX][NX],
                                         float (&Qu)[NU], float (&Quu)[NU][NU]) {
  float VFu[NX][NU];
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) acc = acc + Vxx[j][m] * d.fu(m, a);
      VFu[j][a] = acc;
    }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) acc = acc + d.fu(j, a) * Vx[j];
    Qu[a] = d.lu(a) + acc;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float a2 = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) a2 = a2 + d.fu(m, a) * VFu[m][c];
      Quu[a][c] = d.luu(a, c) + a2;
    }
  }
  if constexpr (DDP) {
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) acc = acc + Vx[m] * d.fuu(m, a, c);
        Quu[a][c] = Quu[a][c] + ds * acc;
      }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) Quu[a][a] = Quu[a][a] + rg;
}

// VF = Vxx fx, which every row of expand_x reads.
template <int NX, class Stage>
__device__ __forceinline__ void value_times_fx(const Stage& d, const float (&Vxx)[NX][NX],
                                               float (&VF)[NX][NX]) {
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) acc = acc + Vxx[j][m] * d.fx(m, i);
      VF[j][i] = acc;
    }
}

// State coordinate i's share of expand_x (i may be a run-time value): Qx[i],
// row i of Qxx and column i of Qux.
template <int NX, int NU, bool DDP, class Stage>
__device__ __forceinline__ void expand_x_row(const Stage& d, float ds, const float (&Vx)[NX],
                                             const float (&VF)[NX][NX], int i, float& Qx_i,
                                             float (&Qxx_i)[NX], float (&Qux_i)[NU]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < NX; ++j) acc = acc + d.fx(j, i) * Vx[j];
  Qx_i = d.lx(i) + acc;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    float a2 = 0.0f;
#pragma unroll
    for (int m = 0; m < NX; ++m) a2 = a2 + d.fx(m, i) * VF[m][j];
    Qxx_i[j] = d.lxx(i, j) + a2;
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    float a2 = 0.0f;
#pragma unroll
    for (int m = 0; m < NX; ++m) a2 = a2 + d.fu(m, a) * VF[m][i];
    Qux_i[a] = d.lux(a, i) + a2;
  }
  if constexpr (DDP) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float a3 = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) a3 = a3 + Vx[m] * d.fxx(m, i, j);
      Qxx_i[j] = Qxx_i[j] + ds * a3;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float a3 = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) a3 = a3 + Vx[m] * d.fux(m, a, i);
      Qux_i[a] = Qux_i[a] + ds * a3;
    }
  }
}

// Qx = lx + fx' Vx, Qxx = lxx + fx' Vxx fx (+ ds Vx . fxx) and
// Qux = lux + fu' Vxx fx (+ ds Vx . fux): every row of expand_x_row.
template <int NX, int NU, bool DDP, class Stage>
__device__ __forceinline__ void expand_x(const Stage& d, float ds, const float (&Vx)[NX],
                                         const float (&Vxx)[NX][NX], float (&Qx)[NX],
                                         float (&Qxx)[NX][NX], float (&Qux)[NU][NX]) {
  float VF[NX][NX];
  value_times_fx<NX>(d, Vxx, VF);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float col[NU];
    expand_x_row<NX, NU, DDP>(d, ds, Vx, VF, i, Qx[i], Qxx[i], col);
#pragma unroll
    for (int a = 0; a < NU; ++a) Qux[a][i] = col[a];
  }
}

// The exact box QP by compile-time active-set enumeration: of the patterns
// PAT with PAT % W == w, in ascending order, the first with the least
// objective (strict <), its objective and its step.  With W = 1 that is the
// whole stage QP; with W warps, merge_candidates joins the warps' results.
// Pattern 0 is taken whatever its objective, as the sequential scan takes it;
// a share without pattern 0 starts from +inf, which a NaN never beats.
template <int NU, int W>
__device__ __forceinline__ void scan_candidates(const float (&Quu)[NU][NU], const float (&Qu)[NU],
                                                const float (&lo)[NU], const float (&hi)[NU],
                                                float tol, int w, float& best_obj,
                                                int& best_pat, float (&kff)[NU]) {
  best_obj = INFINITY;
  best_pat = w;
#pragma unroll
  for (int a = 0; a < NU; ++a) kff[a] = 0.0f;
  static_for<pow3(NU)>([&](auto pc) {
    constexpr int PAT = decltype(pc)::value;
    if (PAT % W == w) {
      float v[NU], obj;
      candidate<NU, PAT>(Quu, Qu, lo, hi, tol, v, obj);
      if (PAT == 0 || obj < best_obj) {
        best_obj = obj;
        best_pat = PAT;
#pragma unroll
        for (int a = 0; a < NU; ++a) kff[a] = v[a];
      }
    }
  });
}

// Whether share (obj, pat) replaces the best so far in the merge of the
// warps' shares, taken in the order w = 0, 1, ...: the result is the
// sequential scan's first minimum (share 0 starts the merge unconditionally).
__device__ __forceinline__ bool candidate_wins(float obj, int pat, float best_obj, int best_pat) {
  return obj < best_obj || (obj == best_obj && pat < best_pat);
}

// The rest of the stage once the winning pattern's step kff and gain Kg
// (free_gain) are known: the dV1 / dV2 / gmax increments and the value update.
template <int NX, int NU>
__device__ __forceinline__ void finish_stage(const float (&Qx)[NX], const float (&Qu)[NU],
                                             const float (&Qxx)[NX][NX],
                                             const float (&Quu)[NU][NU],
                                             const float (&Qux)[NU][NX], const float (&lo)[NU],
                                             const float (&hi)[NU], const float (&kff)[NU],
                                             const float (&Kg)[NU][NX], float (&Vx)[NX],
                                             float (&Vxx)[NX][NX], float& dV1, float& dV2,
                                             float& gmax) {
  // ---- step-quality / stationarity increments ---------------------------
  float Quk[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    dV1 = dV1 + kff[a] * Qu[a];
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      dV2 = dV2 + 0.5f * kff[a] * Quu[a][c] * kff[c];
      acc = acc + Quu[a][c] * kff[c];
    }
    Quk[a] = acc;
    // projected gradient |-clip(-Qu, lo, hi)|, NaN-propagating like jnp
    const float nq = -Qu[a];
    const float cl = nq < lo[a] ? lo[a] : (nq > hi[a] ? hi[a] : nq);
    const float pg = fabsf(cl);
    gmax = (pg > gmax || isnan(pg)) ? pg : gmax;
  }

  // ---- value function update ---------------------------------------------
  float Vx_n[NX], Vxx_n[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float acc = Qx[i];
#pragma unroll
    for (int a = 0; a < NU; ++a) acc = acc + Kg[a][i] * (Quk[a] + Qu[a]);
#pragma unroll
    for (int a = 0; a < NU; ++a) acc = acc + Qux[a][i] * kff[a];
    Vx_n[i] = acc;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float t = Qxx[i][j];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) t = t + Kg[a][i] * Quu[a][c] * Kg[c][j];
#pragma unroll
      for (int a = 0; a < NU; ++a) t = t + Kg[a][i] * Qux[a][j] + Qux[a][i] * Kg[a][j];
      Vxx_n[i][j] = t;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = Vx_n[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = 0.5f * (Vxx_n[i][j] + Vxx_n[j][i]);
  }
}

// One whole stage in one thread: updates the value function (Vx, Vxx) and the
// accumulators dV1, dV2, gmax in place, and returns the stage's kff and K.
// UNIT_RHS: see free_gain.
template <int NX, int NU, bool DDP, bool UNIT_RHS = false, class Stage>
__device__ __forceinline__ void backward_stage(const Stage& d, float rg, float ds, float tol,
                                               float (&Vx)[NX], float (&Vxx)[NX][NX],
                                               float& dV1, float& dV2, float& gmax,
                                               float (&kff)[NU], float (&Kg)[NU][NX]) {
  float Qx[NX], Qu[NU], Qxx[NX][NX], Quu[NU][NU], Qux[NU][NX];
  expand_x<NX, NU, DDP>(d, ds, Vx, Vxx, Qx, Qxx, Qux);
  expand_u<NX, NU, DDP>(d, rg, ds, Vx, Vxx, Qu, Quu);
  float lo[NU], hi[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    lo[a] = d.lo(a);
    hi[a] = d.hi(a);
  }
  float best_obj;
  int best_pat;
  scan_candidates<NU, 1>(Quu, Qu, lo, hi, tol, 0, best_obj, best_pat, kff);
  free_gain<NX, NU, UNIT_RHS>(Quu, Qux, best_pat, Kg);
  finish_stage<NX, NU>(Qx, Qu, Qxx, Quu, Qux, lo, hi, kff, Kg, Vx, Vxx, dV1, dV2, gmax);
}

template <int NX, int NU, bool DDP>
__global__ void riccati_thread_kernel(RiccatiArgs g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;

  float Vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = g.gN[(size_t)b * NX + i];
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = g.HN[((size_t)b * NX + i) * NX + j];
  }
  float dV1 = 0.0f, dV2 = 0.0f, gmax = 0.0f;
  const float rg = g.reg[b];
  const float ds = g.ddp[b];

#pragma unroll 1
  for (int k = g.N - 1; k >= 0; --k) {
    const size_t s = (size_t)b * g.N + k;
    float kff[NU], Kg[NU][NX];
    backward_stage<NX, NU, DDP, true>(GlobalStage<NX, NU, DDP>(g, s), rg, ds, g.tol, Vx, Vxx,
                                      dV1, dV2, gmax, kff, Kg);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      g.kff[s * NU + a] = kff[a];
#pragma unroll
      for (int i = 0; i < NX; ++i) g.K[(s * NU + a) * NX + i] = Kg[a][i];
    }
  }
  g.dV1[b] = dV1;
  g.dV2[b] = dV2;
  g.gmax[b] = gmax;
}

template <int NX, int NU>
cudaError_t riccati_launch(const RiccatiArgs& a, bool ddp, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int blocks = (a.B + kThreads - 1) / kThreads;
  if (ddp)
    riccati_thread_kernel<NX, NU, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    riccati_thread_kernel<NX, NU, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
