// Fused stage derivatives + Riccati backward pass (K3), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel make_fused_backward
// (mpc_verde_tpu/ops/pallas/fused.py, body _make_fused_kernel).
//
// What it computes: from the trajectory alone (x_k, u_k, p_k) every stage's
// derivatives, the terminal value and the step bounds, then K1's recursion.
// The derivatives come from the unicycle device model (unicycle.cuh)
// evaluated once on the dual numbers of dual.cuh over z = [x; u]: the
// dynamics on second-order duals with DDP and first-order ones without, the
// cost always on second-order ones, as the JAX kernel's nested-jacfwd pyramid
// does (fused.py:156-185).  The stage cost carries the model's optional
// barrier and AL terms (unicycle.cuh), so the derivative records hold
// theirs; the barrier at mu = 0 adds exact zeros.  The terminal value starts
// at gN = (Qf + Qf')(x_N - p_N[:3]), HN = Qf + Qf' (zeros without Qf), plus
// the AL penalty's gradient and Hessian from duals over x_N; the step
// bounds are lb - u_k and ub - u_k, and each stage then runs K1's
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

#include <cuda_runtime.h>

#include "dual.cuh"
#include "launch.cuh"
#include "riccati.cuh"
#include "unicycle.cuh"

namespace {

constexpr int kNZ = kNX + kNU;
constexpr int kMaxThreads = 256;  // 255 registers a thread fill the register file

struct FusedArgs {
  const float *xs, *us, *ps, *reg, *ddp;
  float *kff, *K, *dV1, *dV2, *gmax;
  int B, N, npar;
  float tol;
};

// backward_stage's view of one stage: the derivatives read off the duals
// (F: the dynamics, second order only with DDP; L: the stage cost).
template <bool DDP>
struct DualStage {
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

// Stage derivatives at (x, u, p): F(z) and l(z) on duals seeded at z = [x; u].
template <bool DDP>
__device__ __forceinline__ void linearize_stage(const UnicycleModel& m, const float (&x)[kNX],
                                                const float (&u)[kNU], const float* p,
                                                DualStage<DDP>& d) {
  {
    Dual<kNZ, DDP> uz[kNU];
#pragma unroll
    for (int i = 0; i < kNX; ++i) d.F[i] = Dual<kNZ, DDP>::var(x[i], i);
#pragma unroll
    for (int a = 0; a < kNU; ++a) uz[a] = Dual<kNZ, DDP>::var(u[a], kNX + a);
    step(m, d.F, uz);
  }
  Dual<kNZ, true> xz[kNX], uz[kNU];
#pragma unroll
  for (int i = 0; i < kNX; ++i) xz[i] = Dual<kNZ, true>::var(x[i], i);
#pragma unroll
  for (int a = 0; a < kNU; ++a) uz[a] = Dual<kNZ, true>::var(u[a], kNX + a);
  d.L = stage_cost(m, xz, uz, p);
#pragma unroll
  for (int a = 0; a < kNU; ++a) {
    d.lo_[a] = m.lb[a] - u[a];
    d.hi_[a] = m.ub[a] - u[a];
  }
}

// Stage (b, k)'s derivatives from the trajectory in device memory.
template <bool DDP>
__device__ __forceinline__ void linearize_at(const FusedArgs& g, const UnicycleModel& m, int b,
                                             int k, DualStage<DDP>& d) {
  const size_t s = (size_t)b * g.N + k;
  const size_t sx = (size_t)b * (g.N + 1) + k;
  float x[kNX], u[kNU];
#pragma unroll
  for (int i = 0; i < kNX; ++i) x[i] = g.xs[sx * kNX + i];
#pragma unroll
  for (int a = 0; a < kNU; ++a) u[a] = g.us[s * kNU + a];
  linearize_stage<DDP>(m, x, u, g.ps + sx * g.npar, d);
}

// Terminal value at stage N of problem b: the gradient and Hessian of
// (x - p[:3])' Qf (x - p[:3]) in closed form, plus the AL penalty's from
// one evaluation on second-order duals over x_N.
__device__ __forceinline__ void terminal_value(const FusedArgs& g, const UnicycleModel& m, int b,
                                               float (&Vx)[kNX], float (&Vxx)[kNX][kNX]) {
  const int N = g.N;
  const float* xN = g.xs + ((size_t)b * (N + 1) + N) * kNX;
  const float* pN = g.ps + ((size_t)b * (N + 1) + N) * g.npar;
#pragma unroll
  for (int i = 0; i < kNX; ++i)
#pragma unroll
    for (int j = 0; j < kNX; ++j)
      Vxx[i][j] = m.has_terminal ? m.Qf[i * kNX + j] + m.Qf[j * kNX + i] : 0.0f;
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kNX; ++j) acc = acc + Vxx[i][j] * (xN[j] - pN[j]);
    Vx[i] = acc;
  }
  if (m.al) {
    Dual<kNX, true> xz[kNX];
#pragma unroll
    for (int i = 0; i < kNX; ++i) xz[i] = Dual<kNX, true>::var(xN[i], i);
    const Dual<kNX, true> pen = al_penalty(m, xz, pN);
#pragma unroll
    for (int i = 0; i < kNX; ++i) {
      Vx[i] = Vx[i] + pen.g[i];
#pragma unroll
      for (int j = 0; j < kNX; ++j) Vxx[i][j] = Vxx[i][j] + pen.hess(i, j);
    }
  }
}

// ---- "thread": one thread per problem, derivatives in registers ------------

template <bool DDP>
__global__ void fused_thread_kernel(FusedArgs g, UnicycleModel m) {
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
    DualStage<DDP> d;
    linearize_at<DDP>(g, m, b, k, d);
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

// Shared-memory layout in floats for `pb` problems: the records (per-problem
// stride rec, odd), then the kff and K staging areas (strides kff, K, odd).
// fused_launch_plan in ops/cuda/fused.py is the one place that computes the
// strides; the entry point takes them from there.
struct StagedLayout {
  int pb;
  int rec, kff, K;  // per-problem strides
};

template <bool DDP>
__device__ __forceinline__ void store_record(const DualStage<DDP>& d, float* r) {
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

template <bool DDP, bool CLOCKS>
__global__ void __launch_bounds__(kMaxThreads)
    fused_staged_kernel(FusedArgs g, UnicycleModel m, StagedLayout L, long long* clocks) {
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
    DualStage<DDP> d;
    linearize_at<DDP>(g, m, b0 + p, k, d);
    store_record<DDP>(d, rec + p * L.rec + k * S::kStride);
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

template <bool DDP, bool CLOCKS>
cudaError_t launch_staged(const FusedArgs& g, const UnicycleModel& m, const StagedLayout& L,
                          int threads, long long* clocks, cudaStream_t stream) {
  if (L.rec < g.N * SharedStage<kNX, kNU, DDP>::kStride || L.kff < g.N * kNU ||
      L.K < g.N * kNU * kNX)
    return cudaErrorInvalidValue;
  static bool permitted[kMaxDevices];
  const cudaError_t err = permit_shared_memory(fused_staged_kernel<DDP, CLOCKS>, permitted);
  if (err != cudaSuccess) return err;
  const int blocks = (g.B + L.pb - 1) / L.pb;
  const size_t bytes = (size_t)L.pb * (L.rec + L.kff + L.K) * sizeof(float);
  fused_staged_kernel<DDP, CLOCKS><<<blocks, threads, bytes, stream>>>(g, m, L, clocks);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: xs (B,N+1,3), us (B,N,2),
// ps (B,N+1,npar), reg (B,), ddp (B,); outputs kff (B,N,2), K (B,N,2,3),
// dV1, dV2, gmax (B,).  `model` and `model_ints` are the host arrays of
// unicycle.cuh's unpack_model.  `variant` is 0 "thread" or 1 "staged"; for "staged",
// `problems` is the number of problems a block takes, `threads` its size and
// `strides` a host array of StagedLayout's three per-problem strides, as
// fused_launch_plan computes them; `clocks` is null, or (DDP only) a device
// array of 3 int64 per block: the launch is then of the timing instantiation,
// which writes there the block's cycles in phase 1, phase 2 and the
// write-out.  Returns the CUDA error of setting the shared-memory size or of
// the launch, or cudaErrorInvalidValue for a model that reads columns past
// npar or a bad plan.
extern "C" int mv_fused_backward(int use_ddp, int B, int N, int npar, float tol,
                                 const float* xs, const float* us, const float* ps,
                                 const float* reg, const float* ddp, const float* model,
                                 const int* model_ints, float* kff, float* K, float* dV1,
                                 float* dV2, float* gmax, int variant, int problems, int threads,
                                 const int* strides, void* clocks, void* stream) {
  const UnicycleModel m = unpack_model(model, model_ints);
  if (!model_fits(m, npar) || variant < 0 || variant > 1) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const FusedArgs g{xs, us, ps, reg, ddp, kff, K, dV1, dV2, gmax, B, N, npar, tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    constexpr int kThreads = 64;
    const int blocks = (B + kThreads - 1) / kThreads;
    if (use_ddp)
      fused_thread_kernel<true><<<blocks, kThreads, 0, s>>>(g, m);
    else
      fused_thread_kernel<false><<<blocks, kThreads, 0, s>>>(g, m);
    return cudaGetLastError();
  }
  if (problems < 1 || threads < problems || threads > kMaxThreads) return cudaErrorInvalidValue;
  const StagedLayout L{problems, strides[0], strides[1], strides[2]};
  if (clocks != nullptr)
    return use_ddp ? launch_staged<true, true>(g, m, L, threads, static_cast<long long*>(clocks), s)
                   : cudaErrorInvalidValue;
  return use_ddp ? launch_staged<true, false>(g, m, L, threads, nullptr, s)
                 : launch_staged<false, false>(g, m, L, threads, nullptr, s);
}
