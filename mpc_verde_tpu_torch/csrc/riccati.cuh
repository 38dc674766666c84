// Batched box-constrained Riccati backward pass (K1), CUDA C++ for sm_90a:
// the kernel template.  Each riccati_<nx>x<nu>.cu instantiates one shape in
// its own translation unit, so the shapes compile in parallel; riccati.cu
// holds the C entry point.
//
// Replaces the Pallas TPU kernel riccati_backward_pallas
// (mpc_verde_tpu/ops/pallas/riccati.py, body _backward_stage / _make_kernel).
//
// Design: one thread per problem.  The TPU kernel walks the stages as a
// sequential grid axis and carries (Vx, Vxx) in VMEM scratch; here the
// thread walks the stages N-1..0 in a loop and keeps (Vx, Vxx) and the
// dV1/dV2/gmax accumulators in registers, so nothing carries across blocks.
// The 3^NU active-set patterns of the stage box QP (itertools.product order,
// strict-< first minimum) are unrolled at compile time per (NX, NU): each
// candidate step solves its free system (up to two free coordinates in
// closed form, three or four by no-pivot Gaussian elimination, as
// _backward_stage does).  The feedback gain K is solved once per stage, for
// the winning pattern only, on the masked system (identity rows for clamped
// coordinates, whose K rows are zero): solving it per candidate, as the TPU
// kernel does, made nvcc take minutes for nu = 4.
//
// What bounds it on the H100: with B = 1024 there are only 1024 threads, so
// the card is latency bound on the per-thread stage chain (N sequential
// stages of a few hundred dependent flops each), not on bytes or flops.
// The derivative loads keep the JAX (B, N, ...) layout, so neighbouring
// threads read addresses one stage-block apart and the loads do not
// coalesce.  Left for later: a problem-fastest (SoA) layout so each entry
// load coalesces, and more than one thread per problem.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>
#include <utility>

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
// the masked system, clamped rows zero.
template <int NX, int NU>
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
    for (int i = 0; i < NX; ++i) X[i][a] = fr[a] ? -Qux[a][i] : 0.0f;
  }
  solve_free<NU, NX>(A, X);
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int i = 0; i < NX; ++i) K[a][i] = X[i][a];
}

template <int NX, int NU, bool DDP>
__global__ void riccati_backward_kernel(RiccatiArgs g) {
  constexpr int P = pow3(NU);
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
    const float* fx = g.fx + s * NX * NX;
    const float* fu = g.fu + s * NX * NU;

    // ---- Q expansion ----------------------------------------------------
    float Qx[NX], Qu[NU], Qxx[NX][NX], Quu[NU][NU], Qux[NU][NX];
    float VF[NX][NX], VFu[NX][NU];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) acc = acc + Vxx[j][m] * fx[m * NX + i];
        VF[j][i] = acc;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) acc = acc + Vxx[j][m] * fu[m * NU + a];
        VFu[j][a] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + fx[j * NX + i] * Vx[j];
      Qx[i] = g.lx[s * NX + i] + acc;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float a2 = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) a2 = a2 + fx[m * NX + i] * VF[m][j];
        Qxx[i][j] = g.lxx[(s * NX + i) * NX + j] + a2;
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + fu[j * NU + a] * Vx[j];
      Qu[a] = g.lu[s * NU + a] + acc;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float a2 = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) a2 = a2 + fu[m * NU + a] * VFu[m][c];
        Quu[a][c] = g.luu[(s * NU + a) * NU + c] + a2;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float a2 = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) a2 = a2 + fu[m * NU + a] * VF[m][i];
        Qux[a][i] = g.lux[(s * NU + a) * NX + i] + a2;
      }
    }

    if constexpr (DDP) {
      const float* fxx = g.fxx + s * NX * NX * NX;
      const float* fux = g.fux + s * NX * NU * NX;
      const float* fuu = g.fuu + s * NX * NU * NU;
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < NX; ++m) acc = acc + Vx[m] * fxx[(m * NX + i) * NX + j];
          Qxx[i][j] = Qxx[i][j] + ds * acc;
        }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < NX; ++m) acc = acc + Vx[m] * fux[(m * NU + a) * NX + i];
          Qux[a][i] = Qux[a][i] + ds * acc;
        }
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < NX; ++m) acc = acc + Vx[m] * fuu[(m * NU + a) * NU + c];
          Quu[a][c] = Quu[a][c] + ds * acc;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) Quu[a][a] = Quu[a][a] + rg;

    float lo[NU], hi[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      lo[a] = g.dlb[s * NU + a];
      hi[a] = g.dub[s * NU + a];
    }

    // ---- exact box QP: compile-time active-set enumeration ----------------
    float kff[NU], best_obj = kBig;
    int best_pat = 0;
    static_for<P>([&](auto pc) {
      constexpr int PAT = decltype(pc)::value;
      float v[NU], obj;
      candidate<NU, PAT>(Quu, Qu, lo, hi, g.tol, v, obj);
      if (PAT == 0 || obj < best_obj) {
        best_obj = obj;
        best_pat = PAT;
#pragma unroll
        for (int a = 0; a < NU; ++a) kff[a] = v[a];
      }
    });
    float Kg[NU][NX];
    free_gain<NX, NU>(Quu, Qux, best_pat, Kg);

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
    riccati_backward_kernel<NX, NU, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    riccati_backward_kernel<NX, NU, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launcher per instantiated (nx, nu), each in its own riccati_<nx>x<nu>.cu.
cudaError_t mv_riccati_launch_3x1(const RiccatiArgs& a, bool ddp, cudaStream_t s);
cudaError_t mv_riccati_launch_3x2(const RiccatiArgs& a, bool ddp, cudaStream_t s);
cudaError_t mv_riccati_launch_4x3(const RiccatiArgs& a, bool ddp, cudaStream_t s);
cudaError_t mv_riccati_launch_5x4(const RiccatiArgs& a, bool ddp, cudaStream_t s);
