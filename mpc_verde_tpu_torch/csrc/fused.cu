// Fused stage derivatives + Riccati backward pass (K3), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel make_fused_backward
// (mpc_verde_tpu/ops/pallas/fused.py, body _make_fused_kernel).
//
// Design: one thread per problem walks the stages N-1..0 as K1 does, but
// reads only the trajectory (x_k, u_k, p_k) and computes each stage's
// derivatives in registers instead of reading K1's derivative arrays (96
// floats a stage at nx = 3, nu = 2 with DDP).  The derivatives come from the
// unicycle device model (unicycle.cuh) evaluated once on the dual numbers of
// dual.cuh over z = [x; u]: the dynamics on second-order duals with DDP and
// first-order ones without, the cost always on second-order ones, as the JAX
// kernel's nested-jacfwd pyramid does (fused.py:156-185).  The terminal value
// starts at gN = (Qf + Qf')(x_N - p_N[:3]), HN = Qf + Qf' (zeros without
// Qf), the step bounds are lb - u_k and ub - u_k, and each stage then runs
// K1's backward_stage (riccati.cuh), as the JAX kernels share
// riccati._backward_stage.  The TPU grid's sequential stage axis and its
// VMEM scratch become the thread's loop and registers.
//
// What bounds it on the H100: at B = 1024 the card runs 1024 threads, each a
// chain of N stages, and each stage is an RK4 step on 21-float dual numbers
// (about 2k flops and 8 sincos) before the stage QP, so it is latency bound
// on 16 of the 132 SMs.  ptxas fits the DDP variant in 250 registers with no
// spills (a 384-byte stack frame).  Left for later: one pass per Hessian
// entry on a 4-component hyper-dual (fewer live registers), several threads
// per problem, and a problem-fastest layout so the trajectory loads
// coalesce.

#include <cuda_runtime.h>

#include "dual.cuh"
#include "riccati.cuh"
#include "unicycle.cuh"

namespace {

constexpr int kNZ = kNX + kNU;

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

template <bool DDP>
__global__ void fused_backward_kernel(FusedArgs g, UnicycleModel m) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;
  const int N = g.N;

  // terminal value of (x - p[:3])' Qf (x - p[:3]) at stage N
  float Vx[kNX], Vxx[kNX][kNX];
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
  float dV1 = 0.0f, dV2 = 0.0f, gmax = 0.0f;
  const float rg = g.reg[b];
  const float ds = g.ddp[b];

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    const size_t s = (size_t)b * N + k;
    const size_t sx = (size_t)b * (N + 1) + k;
    float x[kNX], u[kNU];
#pragma unroll
    for (int i = 0; i < kNX; ++i) x[i] = g.xs[sx * kNX + i];
#pragma unroll
    for (int a = 0; a < kNU; ++a) u[a] = g.us[s * kNU + a];
    DualStage<DDP> d;
    linearize_stage<DDP>(m, x, u, g.ps + sx * g.npar, d);

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

}  // namespace

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: xs (B,N+1,3), us (B,N,2),
// ps (B,N+1,npar), reg (B,), ddp (B,); outputs kff (B,N,2), K (B,N,2,3),
// dV1, dV2, gmax (B,).  `model` is the host array of unicycle.cuh's
// unpack_model.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for npar < 3.
extern "C" int mv_fused_backward(int use_ddp, int B, int N, int npar, float tol,
                                 const float* xs, const float* us, const float* ps,
                                 const float* reg, const float* ddp, const float* model,
                                 int substeps, int euler, int has_terminal, float* kff,
                                 float* K, float* dV1, float* dV2, float* gmax,
                                 void* stream) {
  if (npar < kNX) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const UnicycleModel m = unpack_model(model, substeps, euler, has_terminal);
  const FusedArgs g{xs, us, ps, reg, ddp, kff, K, dV1, dV2, gmax, B, N, npar, tol};
  constexpr int kThreads = 64;
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_ddp)
    fused_backward_kernel<true><<<blocks, kThreads, 0, s>>>(g, m);
  else
    fused_backward_kernel<false><<<blocks, kThreads, 0, s>>>(g, m);
  return cudaGetLastError();
}
