// Fused parallel line search / pre-roll (K2), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel linesearch_forward_pallas
// (mpc_verde_tpu/ops/pallas/rollout.py, body _make_kernel).
//
// Design: one thread per problem.  The TPU grid (G, A+1) walks the alphas
// as a sequential grid axis with the running best in VMEM scratch; here one
// thread runs A cost-only passes over ascending alpha, keeping the first
// minimum (strict <), then re-rolls the winner and writes its trajectory:
// (A+1) * N sequential steps, nothing carried across blocks.  With zero
// gains and A = 1 it is the queue pre-roll, and the cost pass is skipped.
//
// The Pallas kernel inlines the user's jaxprs; CUDA cannot inline a Python
// callable, so the model is a fixed device model passed by value: unicycle
// kinematics with an RK4 or Euler step of M substeps, the stage cost
// (x - p[:3])' Q (x - p[:3]) + u' R u, an optional terminal weight Qf, and a
// constant control box.  The step constants (h, h/2, h/6) arrive already
// rounded to float from the host, as the PyTorch version computes them.
// Built without fast math: sinf/cosf keep full precision.
//
// What bounds it on the H100: at B = 1024 the card runs 1024 threads, each a
// chain of (A+1) * N dependent RK4 steps (8 sinf/cosf each), so it is bound
// by per-thread latency, not bytes (about 1 KB read per problem per pass).
// The (B, N, ...) loads do not coalesce.  Left for later: a problem-fastest
// layout, and spreading the alpha passes over threads.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kNX = 3;
constexpr int kNU = 2;
constexpr int kMaxAlphas = 32;

struct UnicycleModel {
  float h, h_half, h_sixth;  // RK4 substep constants (Euler uses h)
  int substeps;
  int euler;                 // 0: RK4, 1: explicit Euler
  int has_terminal;
  float Q[kNX * kNX], R[kNU * kNU], Qf[kNX * kNX];
  float lb[kNU], ub[kNU];
};

struct Alphas {
  float a[kMaxAlphas];
  int n;
};

struct RolloutArgs {
  const float *x0, *xs, *us, *ps, *kff, *K;
  float *xs_out, *us_out, *cost_out;
  int *best_out;
  int B, N, npar;
};

__device__ __forceinline__ void rhs(const float (&x)[kNX], const float (&u)[kNU],
                                    float (&f)[kNX]) {
  f[0] = u[0] * cosf(x[2]);
  f[1] = u[0] * sinf(x[2]);
  f[2] = u[1];
}

__device__ __forceinline__ void step(const UnicycleModel& m, float (&x)[kNX],
                                     const float (&u)[kNU]) {
  for (int s = 0; s < m.substeps; ++s) {
    float k1[kNX], k2[kNX], k3[kNX], k4[kNX], t[kNX];
    rhs(x, u, k1);
    if (m.euler) {
#pragma unroll
      for (int i = 0; i < kNX; ++i) x[i] = x[i] + m.h * k1[i];
      continue;
    }
#pragma unroll
    for (int i = 0; i < kNX; ++i) t[i] = x[i] + m.h_half * k1[i];
    rhs(t, u, k2);
#pragma unroll
    for (int i = 0; i < kNX; ++i) t[i] = x[i] + m.h_half * k2[i];
    rhs(t, u, k3);
#pragma unroll
    for (int i = 0; i < kNX; ++i) t[i] = x[i] + m.h * k3[i];
    rhs(t, u, k4);
#pragma unroll
    for (int i = 0; i < kNX; ++i)
      x[i] = x[i] + m.h_sixth * (((k1[i] + 2.0f * k2[i]) + 2.0f * k3[i]) + k4[i]);
  }
}

// e' W e with e = x - p[:3]
__device__ __forceinline__ float state_quad(const float* W, const float (&x)[kNX],
                                            const float* p) {
  float e[kNX];
#pragma unroll
  for (int i = 0; i < kNX; ++i) e[i] = x[i] - p[i];
  float c = 0.0f;
#pragma unroll
  for (int j = 0; j < kNX; ++j) {
    float eW = 0.0f;
#pragma unroll
    for (int i = 0; i < kNX; ++i) eW = eW + e[i] * W[i * kNX + j];
    c = c + eW * e[j];
  }
  return c;
}

__device__ __forceinline__ float stage_cost(const UnicycleModel& m, const float (&x)[kNX],
                                            const float (&u)[kNU], const float* p) {
  float cu = 0.0f;
#pragma unroll
  for (int j = 0; j < kNU; ++j) {
    float uR = 0.0f;
#pragma unroll
    for (int i = 0; i < kNU; ++i) uR = uR + u[i] * m.R[i * kNU + j];
    cu = cu + uR * u[j];
  }
  return state_quad(m.Q, x, p) + cu;
}

// Roll problem b at step length alpha; write xs/us when `write`.
__device__ float roll(const RolloutArgs& g, const UnicycleModel& m, int b, float alpha,
                      bool write) {
  const int N = g.N;
  float x[kNX];
#pragma unroll
  for (int i = 0; i < kNX; ++i) x[i] = g.x0[(size_t)b * kNX + i];
  float cost = 0.0f;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const size_t sk = (size_t)b * N + k;
    const float* xn = g.xs + ((size_t)b * (N + 1) + k) * kNX;
    const float* un = g.us + sk * kNU;
    const float* kf = g.kff + sk * kNU;
    const float* Kk = g.K + sk * kNU * kNX;
    const float* p = g.ps + ((size_t)b * (N + 1) + k) * g.npar;
    float dx[kNX], u[kNU];
#pragma unroll
    for (int i = 0; i < kNX; ++i) dx[i] = x[i] - xn[i];
#pragma unroll
    for (int a = 0; a < kNU; ++a) {
      float Kdx = 0.0f;
#pragma unroll
      for (int i = 0; i < kNX; ++i) Kdx = Kdx + Kk[a * kNX + i] * dx[i];
      const float v = (un[a] + alpha * kf[a]) + Kdx;
      // clip = min(max(v, lb), ub), NaN-propagating like jnp.clip
      u[a] = v < m.lb[a] ? m.lb[a] : (v > m.ub[a] ? m.ub[a] : v);
    }
    if (write) {
#pragma unroll
      for (int i = 0; i < kNX; ++i) g.xs_out[((size_t)b * (N + 1) + k) * kNX + i] = x[i];
#pragma unroll
      for (int a = 0; a < kNU; ++a) g.us_out[sk * kNU + a] = u[a];
    }
    cost = cost + stage_cost(m, x, u, p);
    step(m, x, u);
  }
  if (write) {
#pragma unroll
    for (int i = 0; i < kNX; ++i) g.xs_out[((size_t)b * (N + 1) + N) * kNX + i] = x[i];
  }
  if (m.has_terminal) cost = cost + state_quad(m.Qf, x, g.ps + ((size_t)b * (N + 1) + N) * g.npar);
  return cost;
}

__global__ void linesearch_forward_kernel(RolloutArgs g, UnicycleModel m, Alphas al) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;
  int best = 0;
  if (al.n > 1) {
    float best_c = FLT_MAX;
#pragma unroll 1
    for (int a = 0; a < al.n; ++a) {
      const float c = roll(g, m, b, al.a[a], false);
      if (c < best_c) {  // strict <, ascending alpha: first minimum
        best_c = c;
        best = a;
      }
    }
  }
  g.cost_out[b] = roll(g, m, b, al.a[best], true);
  g.best_out[b] = best;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Tensor pointers are device
// pointers to contiguous float32 tensors: x0 (B,3), xs (B,N+1,3), us (B,N,2),
// ps (B,N+1,npar), kff (B,N,2), K (B,N,2,3); outputs xs_out, us_out,
// cost_out (B,) and best_out (B,) int32.  `model` is a host array of
// 3 + 9 + 4 + 9 + 2 + 2 floats: h, h/2, h/6, Q, R, Qf, lb, ub.  `alphas` is a
// host array of n_alphas floats.  Returns the launch's cudaGetLastError(),
// or cudaErrorInvalidValue for a bad alpha count or npar < 3.
extern "C" int mv_linesearch_forward(int B, int N, int npar, const float* x0, const float* xs,
                                     const float* us, const float* ps, const float* kff,
                                     const float* K, const float* model, int substeps,
                                     int euler, int has_terminal, const float* alphas,
                                     int n_alphas, float* xs_out, float* us_out,
                                     float* cost_out, int* best_out, void* stream) {
  if (n_alphas < 1 || n_alphas > kMaxAlphas || npar < kNX) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  UnicycleModel m;
  m.h = model[0];
  m.h_half = model[1];
  m.h_sixth = model[2];
  for (int i = 0; i < kNX * kNX; ++i) m.Q[i] = model[3 + i];
  for (int i = 0; i < kNU * kNU; ++i) m.R[i] = model[12 + i];
  for (int i = 0; i < kNX * kNX; ++i) m.Qf[i] = model[16 + i];
  for (int i = 0; i < kNU; ++i) m.lb[i] = model[25 + i];
  for (int i = 0; i < kNU; ++i) m.ub[i] = model[27 + i];
  m.substeps = substeps;
  m.euler = euler;
  m.has_terminal = has_terminal;
  Alphas al;
  al.n = n_alphas;
  for (int i = 0; i < kMaxAlphas; ++i) al.a[i] = i < n_alphas ? alphas[i] : 0.0f;
  RolloutArgs g{x0, xs, us, ps, kff, K, xs_out, us_out, cost_out, best_out, B, N, npar};
  constexpr int kThreads = 64;
  const int blocks = (B + kThreads - 1) / kThreads;
  linesearch_forward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, m, al);
  return cudaGetLastError();
}
