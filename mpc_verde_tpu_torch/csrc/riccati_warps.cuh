// Riccati backward pass (K1), variant "warps": the derivative slabs staged in
// shared memory, and a problem's stage dealt over the warps of its block.
// The generated unit riccati_warps_<nx>x<nu>.cu instantiates one shape
// (riccati_entry.cuh).
//
// A block takes `pb` consecutive problems (at most 32).  In the (B, N, ...)
// layout a problem's slice of each of the twelve input arrays is one
// contiguous chunk of N * e floats (e: the array's entries a stage), so the
// block copies them to shared memory with cp.async, 16 bytes a thread where
// the chunk is aligned, coalesced; every stage then reads shared memory
// through SlabStage, which indexes the chunks as they were copied
// (array-major, no repacking).  Each chunk starts `stride[a]` floats after
// the one before: riccati_launch_plan pads N * e to 4 modulo 32 floats, which
// keeps the 16-byte alignment and puts 8 problems' reads of one entry into 8
// different banks (unpadded, fx at N = 40 is 360 = 8 mod 32 floats apart:
// a 4-way conflict).
//
// Problem p of the block is lane p of every warp, and the warps share its
// stage (riccati.cuh's stage functions):
//   the last warp, the stage warp, keeps (Vx, Vxx) and the accumulators in
//   registers.  It runs expand_u and leaves Qu and Quu in an exchange area;
//   after the block's first barrier it runs expand_x while the candidate
//   warps work; after the second barrier it takes the first minimum over
//   their results in pattern order, then free_gain and finish_stage, and
//   puts kff and K into a staging area.
//   warps 0..W-1 (W = 3 for nu = 1, else 9), the candidate warps: between
//   the two barriers, the active-set patterns PAT with PAT % W == w on the
//   stage warp's Qu and Quu; the warp index selects among code unrolled at
//   compile time, so no warp diverges; each leaves its best (objective,
//   pattern, step) in a second exchange area.
// So a stage's chain is expand_u, the longer of expand_x and one share of the
// candidates, one merge, free_gain and finish_stage, where the "thread"
// variant has the whole stage with all 3^nu candidates in it, and only one
// warp reads the derivatives: a block's shared-memory loads, not its
// arithmetic, are what its warps contend for (with expand_u in every
// candidate warp, or expand_x dealt by rows over more warps, the same chain
// ran slower).  Lanes past the block's problems shadow problem 0 and write
// nothing.  After the walk the block writes kff and K to device memory as one
// coalesced slab an array, as K3 does.
//
// A second instantiation (DDP, nx = 3, nu = 2), launched only when the caller
// passes `clocks`, records a block's cycles: the load; summed over the
// stages, the stage warp's expand_u, expand_x (with the first barrier), its
// wait for the candidates (to the first of their results read), its merge,
// the gain and the rest of the stage; the write-out; and candidate warp 0's
// cycles from the Qu it reads to its result.  The solvers' kernel reads no
// clock.

#pragma once

#include <cuda_pipeline.h>
#include <stdint.h>

#include "launch.cuh"
#include "riccati.cuh"

namespace {

constexpr int kInputs = 12;  // fx fu lx lu lxx luu lux fxx fux fuu dlb dub
constexpr int kClockSlots = 9;

template <int NU>
constexpr int kCandWarps = NU == 1 ? 3 : 9;

// Floats a stage of input array a.
__host__ __device__ constexpr int slab_entries(int nx, int nu, int a) {
  const int e[kInputs] = {nx * nx, nx * nu, nx,           nu,           nx * nx, nu * nu,
                          nu * nx, nx * nx * nx, nx * nu * nx, nx * nu * nu, nu,      nu};
  return e[a];
}

// Shared-memory layout in floats for `pb` problems, computed by
// riccati_launch_plan in ops/cuda/riccati.py and by nothing else: per input
// array the offset of problem 0's chunk and the stride between problems'
// chunks (multiples of 4); the kff and K staging areas (offsets okff, oK,
// per-problem strides skff, sK); the exchange areas for (Qu, Quu) (xu:
// NU + NU * NU rows of pb floats) and for the candidate warps' results (xc:
// per warp 2 + NU rows of pb floats: objective, pattern, step).
struct WarpsLayout {
  int pb;
  int in[kInputs], stride[kInputs];
  int okff, oK, skff, sK, xu, xc, total;
};

// The stage derivatives read from the staged slabs: problem p, stage k.
template <int NX, int NU, bool DDP>
struct SlabStage {
  const float *fx_, *fu_, *lx_, *lu_, *lxx_, *luu_, *lux_, *fxx_, *fux_, *fuu_, *lo_, *hi_;

  static __device__ __forceinline__ const float* at(const float* smem, const WarpsLayout& L,
                                                    int a, int p, int k) {
    return smem + L.in[a] + p * L.stride[a] + k * slab_entries(NX, NU, a);
  }
  __device__ __forceinline__ SlabStage(const float* s, const WarpsLayout& L, int p, int k)
      : fx_(at(s, L, 0, p, k)), fu_(at(s, L, 1, p, k)), lx_(at(s, L, 2, p, k)),
        lu_(at(s, L, 3, p, k)), lxx_(at(s, L, 4, p, k)), luu_(at(s, L, 5, p, k)),
        lux_(at(s, L, 6, p, k)), fxx_(DDP ? at(s, L, 7, p, k) : nullptr),
        fux_(DDP ? at(s, L, 8, p, k) : nullptr), fuu_(DDP ? at(s, L, 9, p, k) : nullptr),
        lo_(at(s, L, 10, p, k)), hi_(at(s, L, 11, p, k)) {}

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

// Start the block's copy of nb chunks of n floats each, contiguous in device
// memory, to chunks `stride` floats apart in shared memory (dst and stride 16
// byte aligned): 16 bytes a thread where every chunk is aligned, else 4.  The
// caller commits and waits.
__device__ __forceinline__ void load_chunks(float* dst, int stride, const float* src, int n,
                                            int nb) {
  const bool wide = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int w = wide ? 4 : 1, per = n / w;
  for (int i = threadIdx.x; i < nb * per; i += blockDim.x) {
    const int p = i / per, c = (i - p * per) * w;
    __pipeline_memcpy_async(dst + p * stride + c, src + p * n + c, 4 * w);
  }
}

// The cycle counter, read no earlier than `dep` is known.  A plain clock64()
// is scheduled freely among arithmetic and even across a barrier, so a part
// is timed from a value its first instructions produce (after a barrier: the
// first value read from shared memory) to one its last instructions produce.
__device__ __forceinline__ long long clock_after(float dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "f"(dep) : "memory");
  return t;
}

template <int NX, int NU, bool DDP, bool CLOCKS>
__global__ void __launch_bounds__(32 * (kCandWarps<NU> + 1))
    riccati_warps_kernel(RiccatiArgs g, WarpsLayout L, long long* clocks) {
  constexpr int W = kCandWarps<NU>;
  constexpr int RC = 2 + NU;               // rows of one candidate warp's result
  constexpr bool kOwnPattern = W == pow3(NU);  // warp w has pattern w alone
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, PB = L.pb;
  const int b0 = blockIdx.x * PB;
  const int nb = min(PB, g.B - b0);
  long long t0 = 0, t1 = 0, t2 = 0, c_cand = 0;
  long long c_expand_u = 0, c_expand_x = 0, c_wait = 0, c_merge = 0, c_gain = 0, c_finish = 0;
  if constexpr (CLOCKS) t0 = clock64();

  // the block's slabs: per array, one chunk a problem
  const float* src[kInputs] = {g.fx,  g.fu,  g.lx,  g.lu,  g.lxx, g.luu,
                               g.lux, g.fxx, g.fux, g.fuu, g.dlb, g.dub};
#pragma unroll
  for (int a = 0; a < kInputs; ++a) {
    if (!DDP && a >= 7 && a <= 9) continue;
    const int n = N * slab_entries(NX, NU, a);
    load_chunks(smem + L.in[a], L.stride[a], src[a] + (size_t)b0 * n, n, nb);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if constexpr (CLOCKS) t1 = clock64();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = lane < nb;
  const int p = live ? lane : 0;  // idle lanes shadow problem 0 and write nothing
  float* xu = smem + L.xu;
  float* xc = smem + L.xc;
  float* okff = smem + L.okff;
  float* oK = smem + L.oK;

  if (w < W) {
    // a candidate warp: its share of the stage QP's patterns
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      const SlabStage<NX, NU, DDP> d(smem, L, p, k);
      float Qu[NU], Quu[NU][NU], lo[NU], hi[NU], v[NU], obj;
      int pat;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        lo[a] = d.lo(a);
        hi[a] = d.hi(a);
      }
      __syncthreads();  // the stage warp has left Qu and Quu
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        Qu[a] = xu[a * PB + p];
#pragma unroll
        for (int c = 0; c < NU; ++c) Quu[a][c] = xu[(NU + a * NU + c) * PB + p];
      }
      long long c0 = 0;
      if constexpr (CLOCKS) c0 = clock_after(Qu[0]);
      scan_candidates<NU, W>(Quu, Qu, lo, hi, g.tol, w, obj, pat, v);
      if (live) {
        float* r = xc + w * RC * PB + p;
        r[0] = obj;
        if constexpr (!kOwnPattern) r[PB] = __int_as_float(pat);
#pragma unroll
        for (int a = 0; a < NU; ++a) r[(2 + a) * PB] = v[a];
      }
      if constexpr (CLOCKS) c_cand += clock_after(obj + v[0]) - c0;
      __syncthreads();  // the candidates are there
    }
  } else {
    // the stage warp: the value function and everything but the candidates
    const int b = b0 + p;
    float Vx[NX], Vxx[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Vx[i] = g.gN[(size_t)b * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxx[i][j] = g.HN[((size_t)b * NX + i) * NX + j];
    }
    const float rg = g.reg[b];
    const float ds = g.ddp[b];
    float dV1 = 0.0f, dV2 = 0.0f, gmax = 0.0f;
    long long c0 = 0;
    if constexpr (CLOCKS) c0 = clock64();
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      long long c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0;
      const SlabStage<NX, NU, DDP> d(smem, L, p, k);
      float Qx[NX], Qu[NU], Qxx[NX][NX], Quu[NU][NU], Qux[NU][NX], lo[NU], hi[NU];
      expand_u<NX, NU, DDP>(d, rg, ds, Vx, Vxx, Qu, Quu);
      if (live) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          xu[a * PB + p] = Qu[a];
#pragma unroll
          for (int c = 0; c < NU; ++c) xu[(NU + a * NU + c) * PB + p] = Quu[a][c];
        }
      }
      if constexpr (CLOCKS) c1 = clock_after(Qu[0] + Quu[NU - 1][NU - 1]);
      __syncthreads();  // Qu and Quu are there: the candidate warps start
      expand_x<NX, NU, DDP>(d, ds, Vx, Vxx, Qx, Qxx, Qux);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        lo[a] = d.lo(a);
        hi[a] = d.hi(a);
      }
      if constexpr (CLOCKS) c2 = clock_after(Qxx[0][0] + Qux[NU - 1][NX - 1] + Qx[NX - 1]);
      __syncthreads();  // the candidates are there
      // the first minimum in pattern order over the warps' shares
      float best_obj = xc[p];
      if constexpr (CLOCKS) c3 = clock_after(best_obj);
      int best_pat = kOwnPattern ? 0 : __float_as_int(xc[PB + p]);
      int best_w = 0;
#pragma unroll
      for (int w2 = 1; w2 < W; ++w2) {
        const float o = xc[w2 * RC * PB + p];
        const int pt = kOwnPattern ? w2 : __float_as_int(xc[(w2 * RC + 1) * PB + p]);
        if (candidate_wins(o, pt, best_obj, best_pat)) {
          best_obj = o;
          best_pat = pt;
          best_w = w2;
        }
      }
      float kff[NU], Kg[NU][NX];
#pragma unroll
      for (int a = 0; a < NU; ++a) kff[a] = xc[(best_w * RC + 2 + a) * PB + p];
      if constexpr (CLOCKS) c4 = clock_after(kff[0]);
      free_gain<NX, NU, true>(Quu, Qux, best_pat, Kg);
      if constexpr (CLOCKS) c5 = clock_after(Kg[0][0] + Kg[NU - 1][NX - 1]);
      finish_stage<NX, NU>(Qx, Qu, Qxx, Quu, Qux, lo, hi, kff, Kg, Vx, Vxx, dV1, dV2, gmax);
      if (live) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          okff[p * L.skff + k * NU + a] = kff[a];
#pragma unroll
          for (int i = 0; i < NX; ++i) oK[p * L.sK + (k * NU + a) * NX + i] = Kg[a][i];
        }
      }
      if constexpr (CLOCKS) {
        const long long c6 = clock_after(Vxx[0][0] + Vxx[NX - 1][NX - 1] + Vx[0]);
        c_expand_u += c1 - c0;
        c_expand_x += c2 - c1;
        c_wait += c3 - c2;
        c_merge += c4 - c3;
        c_gain += c5 - c4;
        c_finish += c6 - c5;
        c0 = c6;
      }
    }
    if (live) {
      g.dV1[b] = dV1;
      g.dV2[b] = dV2;
      g.gmax[b] = gmax;
    }
  }
  __syncthreads();
  if constexpr (CLOCKS) t2 = clock64();

  // write-out: the block's kff and K slabs, coalesced
  const int LF = N * NU, LK = N * NU * NX;
  float* kff_o = g.kff + (size_t)b0 * LF;
  float* K_o = g.K + (size_t)b0 * LK;
  for (int i = threadIdx.x; i < nb * LF; i += blockDim.x) {
    const int q = i / LF;
    kff_o[i] = okff[q * L.skff + (i - q * LF)];
  }
  for (int i = threadIdx.x; i < nb * LK; i += blockDim.x) {
    const int q = i / LK;
    K_o[i] = oK[q * L.sK + (i - q * LK)];
  }
  if constexpr (CLOCKS) {
    long long* c = clocks + (size_t)blockIdx.x * kClockSlots;
    if (threadIdx.x == 0) c[8] = c_cand;  // candidate warp 0
    if (threadIdx.x == W * 32) {
      c[0] = t1 - t0;
      c[1] = c_expand_u;
      c[2] = c_expand_x;
      c[3] = c_wait;
      c[4] = c_merge;
      c[5] = c_gain;
      c[6] = c_finish;
      c[7] = clock64() - t2;
    }
  }
}

template <int NX, int NU, bool DDP, bool CLOCKS>
cudaError_t launch_warps(const RiccatiArgs& g, const WarpsLayout& L, long long* clocks,
                         cudaStream_t stream) {
  static bool permitted[kMaxDevices];
  const cudaError_t err =
      permit_shared_memory(riccati_warps_kernel<NX, NU, DDP, CLOCKS>, permitted);
  if (err != cudaSuccess) return err;
  const int blocks = (g.B + L.pb - 1) / L.pb;
  riccati_warps_kernel<NX, NU, DDP, CLOCKS>
      <<<blocks, 32 * (kCandWarps<NU> + 1), L.total * sizeof(float), stream>>>(g, L, clocks);
  return cudaGetLastError();
}

// The "warps" launcher of one (NX, NU): checks the plan's layout against the
// shape (every chunk holds its N * e floats at a 16-byte offset, the staging
// strides hold a problem's gains) and launches.  The timing instantiation
// exists for (3, 2) with DDP.
template <int NX, int NU>
cudaError_t riccati_warps_launch(const RiccatiArgs& g, bool ddp, int problems,
                                 const int* layout, long long* clocks, cudaStream_t stream) {
  if (problems < 1 || problems > 32) return cudaErrorInvalidValue;
  WarpsLayout L;
  L.pb = problems;
  for (int a = 0; a < kInputs; ++a) {
    L.in[a] = layout[a];
    L.stride[a] = layout[kInputs + a];
    const bool used = ddp || a < 7 || a > 9;
    if (used && (((L.in[a] | L.stride[a]) & 3) != 0 ||
                 L.stride[a] < g.N * slab_entries(NX, NU, a)))
      return cudaErrorInvalidValue;
  }
  const int* rest = layout + 2 * kInputs;
  L.okff = rest[0], L.oK = rest[1], L.skff = rest[2], L.sK = rest[3];
  L.xu = rest[4], L.xc = rest[5], L.total = rest[6];
  if (L.skff < g.N * NU || L.sK < g.N * NU * NX ||
      (size_t)L.total * sizeof(float) > (size_t)kSmemMaxBytes)
    return cudaErrorInvalidValue;
  if (clocks != nullptr) {
    if constexpr (NX == 3 && NU == 2) {
      if (ddp) return launch_warps<NX, NU, true, true>(g, L, clocks, stream);
    }
    return cudaErrorInvalidValue;
  }
  return ddp ? launch_warps<NX, NU, true, false>(g, L, nullptr, stream)
             : launch_warps<NX, NU, false, false>(g, L, nullptr, stream);
}

}  // namespace
