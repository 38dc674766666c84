// Fused stage derivatives + Riccati backward pass (K3), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel make_fused_backward
// (mpc_verde_tpu/ops/pallas/fused.py, body _make_fused_kernel).
//
// What it computes: from the trajectory alone (x_k, u_k, p_k) every stage's
// derivatives, the terminal value and the step bounds, then K1's recursion.
// The kernels are templates on the device model: the unicycle of
// unicycle.cuh (instantiated in fused.cu) and a model generated from the
// trace of an OCP's own callables (ops/cuda/codegen.py, one unit per traced
// program, its terminal value from duals over x_N).  The derivatives come
// from the model evaluated once on the dual numbers of dual.cuh over z =
// [x; u]: the dynamics on second-order duals with DDP and first-order ones
// without, the cost always on second-order ones, as the JAX kernel's
// nested-jacfwd pyramid does (fused.py:156-185).  The stage cost carries the model's optional
// barrier and AL terms (unicycle.cuh), so the derivative records hold
// theirs; the barrier at mu = 0 adds exact zeros.  The terminal value is the
// model's (model_terminal_value; for the unicycle, in fused.cu, gN = (Qf +
// Qf')(x_N - p_N[:3]), HN = Qf + Qf' (zeros without Qf), plus the AL
// penalty's gradient and Hessian from duals over x_N); the step bounds are
// the model's stage box at the nominal state less u_k (for the unicycle lb -
// u_k and ub - u_k), and each stage then runs K1's
// backward_stage (riccati.cuh), as the JAX kernels share
// riccati._backward_stage.  The derivatives never reach device memory.
//
// What bounds it on the H100.  Per problem it reads 328 floats and writes 323
// at N = 40, npar = 3: 2.7 MB for 1024 problems, 0.8 us at 3.35 TB/s.  Its
// arithmetic is about 4k flops a stage (3k of them the derivatives), 164
// MFLOP, 2.4 us at 67 TFLOP/s: operations bound it, not bytes.  What no
// design passes under is the recursion's chain: N stage QPs that each wait
// for the next stage's (Vx, Vxx).
//
// Design ("staged"): two phases in one launch, for a block of `problems`
// consecutive problems.
//   Phase 1, one thread per (problem, stage): the derivatives of all stages
//   are independent, so the block's threads take the problems x N stages in
//   turn (at N = 40, 8 problems: 160 threads, two stages each; the DDP
//   duals need about 250 registers a thread, so 256 threads are the most a
//   block can hold).  Each thread loads its (x_k, u_k, p_k), runs
//   linearize_stage, and stores the stage record (SharedStage's layout,
//   riccati.cuh: 84 floats with DDP, 39 without) to shared memory.
//   Phase 2, one thread per problem: K1's recursion k = N-1..0 on the
//   records, read through SharedStage.  kff and K go to a shared-memory
//   staging area and, after the recursion, to device memory as the block's
//   one contiguous slab per array, coalesced.
// Banks: records are stored record-major with odd strides.  The record
// stride is odd (85 or 39 floats), so phase 1's consecutive lanes (stages)
// write different banks; the per-problem stride (N records, made odd) and
// the staging strides are odd as well, so phase 2's lanes (problems) read and
// write different banks.  Component-major storage would serve phase 2 as
// well, but a record's entries then sit a run-time stride apart, where
// here they are compile-time offsets from one pointer.
//
// Variants, chosen by the caller from the shape (fused_launch_plan in
// ops/cuda/fused.py, which also computes the strides): "staged" as above;
// "thread" for horizons at which fewer than 4 problems' records fit a
// block's shared memory (so few lanes in phase 2 make "staged" the slower):
// one thread per problem walks the stages and computes each stage's
// derivatives in registers just before its stage QP.  Both run the same linearize_stage
// and backward_stage, so their results are the same floats.
//
// What is left: phase 2 is one warp per block with `problems` lanes busy,
// a chain of N stage QPs; spreading a stage's 3^nu active-set candidates
// over lanes would shorten it.  A second instantiation of the DDP kernel,
// launched only when the caller passes `clocks`, records each block's
// clock64() cycles in phase 1, phase 2 and the write-out; the solvers' kernel
// reads no clock.

#pragma once

#include <cuda_runtime.h>

#include "box.cuh"
#include "dual.cuh"
#include "launch.cuh"
#include "riccati.cuh"

struct FusedArgs {
  const float *xs, *us, *ps, *reg, *ddp;
  float *kff, *K, *dV1, *dV2, *gmax;
  int B, N, npar;
  float tol;
};

// Shared-memory layout in floats for `pb` problems: the records (per-problem
// stride rec, odd), then the kff and K staging areas (strides kff, K, odd).
// fused_launch_plan in ops/cuda/fused.py is the one place that computes the
// strides; the entry point takes them from there.
struct StagedLayout {
  int pb;
  int rec, kff, K;  // per-problem strides
};

namespace {

constexpr int kMaxThreads = 256;  // 255 registers a thread fill the register file

// backward_stage's view of one stage: the derivatives read off the duals
// (F: the dynamics, second order only with DDP; L: the stage cost).
template <class Model, bool DDP>
struct DualStage {
  static constexpr int kNX = Model::kNX, kNU = Model::kNU, kNZ = kNX + kNU;
  Dual<kNZ, DDP> F[kNX];
  Dual<kNZ, true> L;
  float lo_[kNU], hi_[kNU];

  __device__ __forceinline__ float fx(int m, int i) const { return F[m].g[i]; }
  __device__ __forceinline__ float fu(int m, int a) const { return F[m].g[kNX + a]; }
  __device__ __forceinline__ float lx(int i) const { return L.g[i]; }
  __device__ __forceinline__ float lu(int a) const { return L.g[kNX + a]; }
  __device__ __forceinline__ float lxx(int i, int j) const { return L.hess(i, j); }
  __device__ __forceinline__ float luu(int a, int c) const { return L.hess(kNX + a, kNX + c); }
  __device__ __forceinline__ float lux(int a, int i) const { return L.hess(kNX + a, i); }
  __device__ __forceinline__ float fxx(int m, int i, int j) const { return F[m].hess(i, j); }
  __device__ __forceinline__ float fux(int m, int a, int i) const { return F[m].hess(kNX + a, i); }
  __device__ __forceinline__ float fuu(int m, int a, int c) const {
    return F[m].hess(kNX + a, kNX + c);
  }
  __device__ __forceinline__ float lo(int a) const { return lo_[a]; }
  __device__ __forceinline__ float hi(int a) const { return hi_[a]; }
};

// Stage k's derivatives at (x, u, p): F(z) and l(z) on duals seeded at
// z = [x; u], and the step bounds: the stage box at x less u.
template <class Model, bool DDP>
__device__ __forceinline__ void linearize_stage(const Model& m, const float (&x)[Model::kNX],
                                                const float (&u)[Model::kNU], const float* p,
                                                int k, DualStage<Model, DDP>& d) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU, kNZ = kNX + kNU;
  {
    Dual<kNZ, DDP> uz[kNU];
#pragma unroll
    for (int i = 0; i < kNX; ++i) d.F[i] = Dual<kNZ, DDP>::var(x[i], i);
#pragma unroll
    for (int a = 0; a < kNU; ++a) uz[a] = Dual<kNZ, DDP>::var(u[a], kNX + a);
    step(m, d.F, uz, p);
  }
  Dual<kNZ, true> xz[kNX], uz[kNU];
#pragma unroll
  for (int i = 0; i < kNX; ++i) xz[i] = Dual<kNZ, true>::var(x[i], i);
#pragma unroll
  for (int a = 0; a < kNU; ++a) uz[a] = Dual<kNZ, true>::var(u[a], kNX + a);
  d.L = stage_cost(m, xz, uz, p);
  float lo[kNU], hi[kNU];
  model_box(m, x, p, k, lo, hi);
#pragma unroll
  for (int a = 0; a < kNU; ++a) {
    d.lo_[a] = lo[a] - u[a];
    d.hi_[a] = hi[a] - u[a];
  }
}

// Stage (b, k)'s derivatives from the trajectory in device memory.
template <class Model, bool DDP>
__device__ __forceinline__ void linearize_at(const FusedArgs& g, const Model& m, int b, int k,
                                             DualStage<Model, DDP>& d) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  const size_t s = (size_t)b * g.N + k;
  const size_t sx = (size_t)b * (g.N + 1) + k;
  float x[kNX], u[kNU];
#pragma unroll
  for (int i = 0; i < kNX; ++i) x[i] = g.xs[sx * kNX + i];
#pragma unroll
  for (int a = 0; a < kNU; ++a) u[a] = g.us[s * kNU + a];
  linearize_stage(m, x, u, g.ps + sx * g.npar, k, d);
}

// Terminal value at stage N of problem b: the model's gradient and Hessian
// of its terminal cost (model_terminal_value, found with the model).
template <class Model>
__device__ __forceinline__ void terminal_value(const FusedArgs& g, const Model& m, int b,
                                               float (&Vx)[Model::kNX],
                                               float (&Vxx)[Model::kNX][Model::kNX]) {
  constexpr int kNX = Model::kNX;
  const int N = g.N;
  const float* xN = g.xs + ((size_t)b * (N + 1) + N) * kNX;
  const float* pN = g.ps + ((size_t)b * (N + 1) + N) * g.npar;
  model_terminal_value(m, xN, pN, Vx, Vxx);
}

// ---- "thread": one thread per problem, derivatives in registers ------------

template <class Model, bool DDP>
__global__ void fused_thread_kernel(FusedArgs g, Model m) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;
  float Vx[kNX], Vxx[kNX][kNX];
  terminal_value(g, m, b, Vx, Vxx);
  float dV1 = 0.0f, dV2 = 0.0f, gmax = 0.0f;
  const float rg = g.reg[b];
  const float ds = g.ddp[b];

#pragma unroll 1
  for (int k = g.N - 1; k >= 0; --k) {
    const size_t s = (size_t)b * g.N + k;
    DualStage<Model, DDP> d;
    linearize_at<Model, DDP>(g, m, b, k, d);
    float kff[kNU], Kg[kNU][kNX];
    backward_stage<kNX, kNU, DDP>(d, rg, ds, g.tol, Vx, Vxx, dV1, dV2, gmax, kff, Kg);
#pragma unroll
    for (int a = 0; a < kNU; ++a) {
      g.kff[s * kNU + a] = kff[a];
#pragma unroll
      for (int i = 0; i < kNX; ++i) g.K[(s * kNU + a) * kNX + i] = Kg[a][i];
    }
  }
  g.dV1[b] = dV1;
  g.dV2[b] = dV2;
  g.gmax[b] = gmax;
}

// ---- "staged": derivatives of all stages to shared memory, then K1's walk --

template <class Model, bool DDP>
__device__ __forceinline__ void store_record(const DualStage<Model, DDP>& d, float* r) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU, kNZ = kNX + kNU;
  using S = SharedStage<kNX, kNU, DDP>;
#pragma unroll
  for (int m = 0; m < kNX; ++m) {
#pragma unroll
    for (int i = 0; i < kNZ; ++i) r[m * S::kF + i] = d.F[m].g[i];
    if constexpr (DDP) {
#pragma unroll
      for (int e = 0; e < S::kTri; ++e) r[m * S::kF + kNZ + e] = d.F[m].h[e];
    }
  }
#pragma unroll
  for (int i = 0; i < kNZ; ++i) r[S::kL + i] = d.L.g[i];
#pragma unroll
  for (int e = 0; e < S::kTri; ++e) r[S::kLH + e] = d.L.h[e];
#pragma unroll
  for (int a = 0; a < kNU; ++a) {
    r[S::kLo + a] = d.lo_[a];
    r[S::kHi + a] = d.hi_[a];
  }
}

template <class Model, bool DDP, bool CLOCKS>
__global__ void __launch_bounds__(kMaxThreads)
    fused_staged_kernel(FusedArgs g, Model m, StagedLayout L, long long* clocks) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  using S = SharedStage<kNX, kNU, DDP>;
  extern __shared__ float smem[];
  float* rec = smem;
  float* okff = rec + L.pb * L.rec;
  float* oK = okff + L.pb * L.kff;
  const int N = g.N;
  const int b0 = blockIdx.x * L.pb;
  const int nb = min(L.pb, g.B - b0);
  long long t0 = 0, t1 = 0, t2 = 0;
  if constexpr (CLOCKS) t0 = clock64();

  // phase 1: one (problem, stage) per thread and turn
  for (int s = threadIdx.x; s < nb * N; s += blockDim.x) {
    const int p = s / N, k = s - p * N;
    DualStage<Model, DDP> d;
    linearize_at<Model, DDP>(g, m, b0 + p, k, d);
    store_record(d, rec + p * L.rec + k * S::kStride);
  }
  __syncthreads();
  if constexpr (CLOCKS) t1 = clock64();

  // phase 2: one problem per thread
  if (threadIdx.x < nb) {
    const int p = threadIdx.x, b = b0 + p;
    float Vx[kNX], Vxx[kNX][kNX];
    terminal_value(g, m, b, Vx, Vxx);
    float dV1 = 0.0f, dV2 = 0.0f, gmax = 0.0f;
    const float rg = g.reg[b];
    const float ds = g.ddp[b];
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      float kff[kNU], Kg[kNU][kNX];
      backward_stage<kNX, kNU, DDP>(S{rec + p * L.rec + k * S::kStride}, rg, ds, g.tol, Vx, Vxx,
                                    dV1, dV2, gmax, kff, Kg);
#pragma unroll
      for (int a = 0; a < kNU; ++a) {
        okff[p * L.kff + k * kNU + a] = kff[a];
#pragma unroll
        for (int i = 0; i < kNX; ++i) oK[p * L.K + (k * kNU + a) * kNX + i] = Kg[a][i];
      }
    }
    g.dV1[b] = dV1;
    g.dV2[b] = dV2;
    g.gmax[b] = gmax;
  }
  __syncthreads();
  if constexpr (CLOCKS) t2 = clock64();

  // write-out: the block's kff and K slabs, coalesced
  const int LF = N * kNU, LK = N * kNU * kNX;
  float* kff_o = g.kff + (size_t)b0 * LF;
  float* K_o = g.K + (size_t)b0 * LK;
  for (int i = threadIdx.x; i < nb * LF; i += blockDim.x) {
    const int p = i / LF;
    kff_o[i] = okff[p * L.kff + (i - p * LF)];
  }
  for (int i = threadIdx.x; i < nb * LK; i += blockDim.x) {
    const int p = i / LK;
    K_o[i] = oK[p * L.K + (i - p * LK)];
  }
  if constexpr (CLOCKS) {
    if (threadIdx.x == 0) {
      const long long t3 = clock64();
      clocks[blockIdx.x * 3 + 0] = t1 - t0;
      clocks[blockIdx.x * 3 + 1] = t2 - t1;
      clocks[blockIdx.x * 3 + 2] = t3 - t2;
    }
  }
}

template <class Model, bool DDP, bool CLOCKS>
cudaError_t launch_staged(const FusedArgs& g, const Model& m, const StagedLayout& L,
                          int threads, long long* clocks, cudaStream_t stream) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  if (L.rec < g.N * SharedStage<kNX, kNU, DDP>::kStride || L.kff < g.N * kNU ||
      L.K < g.N * kNU * kNX)
    return cudaErrorInvalidValue;
  static bool permitted[kMaxDevices];
  const cudaError_t err =
      permit_shared_memory(fused_staged_kernel<Model, DDP, CLOCKS>, permitted);
  if (err != cudaSuccess) return err;
  const int blocks = (g.B + L.pb - 1) / L.pb;
  const size_t bytes = (size_t)L.pb * (L.rec + L.kff + L.K) * sizeof(float);
  fused_staged_kernel<Model, DDP, CLOCKS><<<blocks, threads, bytes, stream>>>(g, m, L, clocks);
  return cudaGetLastError();
}

// Launch `variant` (0 "thread", 1 "staged") on model m; the caller has
// checked the model.  `clocks` (DDP, "staged" only) selects the timing
// instantiation, which only a model with CLOCKS set has.
template <class Model, bool CLOCKS>
cudaError_t fused_run(const Model& m, const FusedArgs& g, bool use_ddp, int variant,
                      int problems, int threads, const int* strides, long long* clocks,
                      cudaStream_t s) {
  if (variant == 0) {
    if (clocks != nullptr) return cudaErrorInvalidValue;
    constexpr int kThreads = 64;
    const int blocks = (g.B + kThreads - 1) / kThreads;
    if (use_ddp)
      fused_thread_kernel<Model, true><<<blocks, kThreads, 0, s>>>(g, m);
    else
      fused_thread_kernel<Model, false><<<blocks, kThreads, 0, s>>>(g, m);
    return cudaGetLastError();
  }
  if (problems < 1 || threads < problems || threads > kMaxThreads) return cudaErrorInvalidValue;
  const StagedLayout L{problems, strides[0], strides[1], strides[2]};
  if (clocks != nullptr) {
    if constexpr (CLOCKS) {
      if (use_ddp) return launch_staged<Model, true, true>(g, m, L, threads, clocks, s);
    }
    return cudaErrorInvalidValue;
  }
  return use_ddp ? launch_staged<Model, true, false>(g, m, L, threads, nullptr, s)
                 : launch_staged<Model, false, false>(g, m, L, threads, nullptr, s);
}

}  // namespace
