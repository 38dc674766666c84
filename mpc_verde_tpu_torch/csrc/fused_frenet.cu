// Fused stage derivatives + Riccati backward pass (K3) for the Frenet
// rate-form device model (frenet_rate.cuh): the kernels of fused.cuh
// instantiated at (nx, nu) = (5, 2), in a translation unit of their own that
// compiles in parallel with fused.cu.  No timing instantiation.
//
// The model's dynamics and cost read (x, u) only, u = u_prev + w, so the
// derivatives are taken on dual numbers over those five numbers (x, u) and
// not over the seven of (z, w): a Dual<5, true> is 21 floats where a
// Dual<7, true> would be 36, and the RK4 step holds about fourteen of them.
// FrenetStage reads them out over (z, w) exactly: a derivative by u_prev or
// by w is the derivative by u, every second-order block repeats f_uu or f_xu,
// and the rows of u_prev' = u are constants (1 on the diagonal of u_prev and
// of w, 0 elsewhere).  The staged variant stores the full (5, 2) record
// (SharedStage), so phase 2 runs K1's backward_stage unchanged.

#include "dual.cuh"
#include "frenet_rate.cuh"
#include "fused.cuh"

namespace {

constexpr int kSeeds = 5;  // x (3), then u (2)

// The seed of variable i of (z, w) = (y, phi, v, delta_prev, a_prev, w_delta,
// w_a): x itself, u for u_prev and for w.
__host__ __device__ constexpr int frenet_seed(int i) { return i < 5 ? i : i - 2; }

template <bool DDP>
struct FrenetStage {
  static constexpr int kNX = 5, kNU = 2;
  Dual<kSeeds, DDP> F[3];  // x' as functions of (x, u)
  Dual<kSeeds, true> L;
  float lo_[kNU], hi_[kNU];

  // first and second derivatives of component m of z' by variables i, j of (z, w)
  __device__ __forceinline__ float f1(int m, int i) const {
    return m < 3 ? F[m].g[frenet_seed(i)] : (i == m || i == m + 2 ? 1.0f : 0.0f);
  }
  __device__ __forceinline__ float f2(int m, int i, int j) const {
    return m < 3 ? F[m].hess(frenet_seed(i), frenet_seed(j)) : 0.0f;
  }
  __device__ __forceinline__ float l1(int i) const { return L.g[frenet_seed(i)]; }
  __device__ __forceinline__ float l2(int i, int j) const {
    return L.hess(frenet_seed(i), frenet_seed(j));
  }

  __device__ __forceinline__ float fx(int m, int i) const { return f1(m, i); }
  __device__ __forceinline__ float fu(int m, int a) const { return f1(m, kNX + a); }
  __device__ __forceinline__ float lx(int i) const { return l1(i); }
  __device__ __forceinline__ float lu(int a) const { return l1(kNX + a); }
  __device__ __forceinline__ float lxx(int i, int j) const { return l2(i, j); }
  __device__ __forceinline__ float luu(int a, int c) const { return l2(kNX + a, kNX + c); }
  __device__ __forceinline__ float lux(int a, int i) const { return l2(kNX + a, i); }
  __device__ __forceinline__ float fxx(int m, int i, int j) const { return f2(m, i, j); }
  __device__ __forceinline__ float fux(int m, int a, int i) const { return f2(m, kNX + a, i); }
  __device__ __forceinline__ float fuu(int m, int a, int c) const {
    return f2(m, kNX + a, kNX + c);
  }
  __device__ __forceinline__ float lo(int a) const { return lo_[a]; }
  __device__ __forceinline__ float hi(int a) const { return hi_[a]; }
};

// Stage k's derivatives at (z, w, p): frenet_rk4 and frenet_cost on duals
// seeded at (x, u = u_prev + w), and the step bounds: the stage box at z
// less w.
template <bool DDP>
__device__ __forceinline__ void linearize_stage(const FrenetRateModel& m, const float (&z)[5],
                                                const float (&w)[2], const float* p, int k,
                                                FrenetStage<DDP>& d) {
  float u[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) u[a] = z[3 + a] + w[a];
  {
    Dual<kSeeds, DDP> xd[3], ud[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) xd[i] = Dual<kSeeds, DDP>::var(z[i], i);
#pragma unroll
    for (int a = 0; a < 2; ++a) ud[a] = Dual<kSeeds, DDP>::var(u[a], 3 + a);
    frenet_rk4(m, xd, ud, p, d.F);
  }
  Dual<kSeeds, true> xh[3], uh[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) xh[i] = Dual<kSeeds, true>::var(z[i], i);
#pragma unroll
  for (int a = 0; a < 2; ++a) uh[a] = Dual<kSeeds, true>::var(u[a], 3 + a);
  d.L = frenet_cost(m, xh, uh, p);
  float lo[2], hi[2];
  m.bounds(z, k, lo, hi);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    d.lo_[a] = lo[a] - w[a];
    d.hi_[a] = hi[a] - w[a];
  }
}

// The stage record of SharedStage<5, 2, DDP> (riccati.cuh), written through
// the accessors.
template <bool DDP>
__device__ __forceinline__ void store_record(const FrenetStage<DDP>& d, float* r) {
  constexpr int kNZ = 7;
  using S = SharedStage<5, 2, DDP>;
#pragma unroll
  for (int m = 0; m < 5; ++m) {
#pragma unroll
    for (int i = 0; i < kNZ; ++i) r[m * S::kF + i] = d.f1(m, i);
    if constexpr (DDP) {
#pragma unroll
      for (int i = 0; i < kNZ; ++i)
#pragma unroll
        for (int j = i; j < kNZ; ++j) r[m * S::kF + kNZ + tri_index(kNZ, i, j)] = d.f2(m, i, j);
    }
  }
#pragma unroll
  for (int i = 0; i < kNZ; ++i) r[S::kL + i] = d.l1(i);
#pragma unroll
  for (int i = 0; i < kNZ; ++i)
#pragma unroll
    for (int j = i; j < kNZ; ++j) r[S::kLH + tri_index(kNZ, i, j)] = d.l2(i, j);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    r[S::kLo + a] = d.lo_[a];
    r[S::kHi + a] = d.hi_[a];
  }
}

template <bool DDP>
struct StageOf<FrenetRateModel, DDP> {
  using type = FrenetStage<DDP>;
};

}  // namespace

// Called by mv_fused_backward (fused.cu) for model kind 3.
cudaError_t mv_fused_frenet(const float* model, const int* ints, const float* tables,
                            const FusedArgs& g, bool use_ddp, int variant, int problems,
                            int threads, const int* strides, long long* clocks, cudaStream_t s) {
  const FrenetRateModel m = unpack_frenet(model, ints, tables);
  if (!model_fits(m, g.npar, g.N)) return cudaErrorInvalidValue;
  return fused_run<FrenetRateModel, false>(m, g, use_ddp, variant, problems, threads, strides,
                                           clocks, s);
}
