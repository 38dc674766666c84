// Fused parallel line search / pre-roll (K2), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel linesearch_forward_pallas
// (mpc_verde_tpu/ops/pallas/rollout.py, body _make_kernel).
//
// What bounds it on the H100.  Per problem the function reads x0, the nominal
// xs, us, ps, kff and K and writes the winner's xs, us, cost and alpha index:
// 854 floats at N = 40, npar = 3, so 3.5 MB for 1024 problems, 1.0 us at
// 3.35 TB/s; its arithmetic is about 250 flops a step over (A + 1) N steps,
// 1.4 us at 67 TFLOP/s for A = 8.  Neither is the limit that matters: one
// candidate is a chain of N dependent RK4 steps (4 sinf/cosf pairs each), on
// the order of 10 us at N = 40, and no design can pass under that chain.
//
// Design ("lanes"): one lane per (problem, alpha).  A group of A_pad lanes
// (A rounded up to a power of two, inside one warp) serves one problem and
// rolls every candidate at once, so the chain is N steps and not (A + 1) N.
// A block takes `problems` consecutive problems.  In the (B, N, ...) layout
// their slices of xs, us, kff, K and ps are one contiguous slab per array:
// the block copies the five slabs to shared memory with cp.async (16 bytes a
// thread where the slab is aligned, coalesced), and every step then reads
// shared memory; the lanes of a group read one address, a broadcast.  Each
// lane writes its candidate's trajectory into its own shared-memory slot
// (stride padded to an odd number of floats: no bank conflict between
// lanes), the group finds the first minimum of (cost, alpha index) by
// shuffles, and the block copies the winners' slots to xs_out / us_out as
// one coalesced slab: no second roll.  Lanes past A and problems past B
// carry no candidate.  The tie rule is the sequential one: the lowest alpha
// index among the costs below FLT_MAX wins, a NaN cost never wins, and with
// no such cost the index is 0.  So a candidate that the barrier prices +inf
// (the "streaming" rule, on or outside its box) or NaN (the "batched" rule,
// outside it) loses to every finite one, as in the Pallas kernel.
//
// Variants, chosen by the caller from the shape (linesearch_launch_plan in
// ops/cuda/rollout.py, which also computes the shared-memory layout):
// "lanes" as above; "lanes_reroll" when the slots of a warp of lanes do not
// fit in shared memory: the nominal slabs only, and the winning lane rolls
// again and writes device memory itself; "thread" when even one problem's
// slabs do not fit: one thread per problem, A cost passes in sequence over
// device memory and one writing pass.  All three run the same roll() per
// candidate, so a lane's cost is the float the thread computes.
//
// What is left: us, kff and K slices are 16 floats modulo 32 apart at N = 40,
// so two of a warp's four problems share banks on those reads (2-way).  The
// kernel's time is one chain's latency: blocks of 32 to 256 threads take the
// same time at 1024 problems (measured, utils/tune_launch_plans.py), so what
// would shorten it is a shorter step, not another launch shape.
//
// The kernels are templates on the device model: the unicycle of
// unicycle.cuh (instantiated in rollout.cu, with its optional barrier and AL
// terms, which read more columns of ps: at N = 40 and npar = 11 a "lanes"
// block of 8 problems takes 84 KB of shared memory), the linear rate-form
// model of linear_rate.cuh with its curvature-cost variant
// (rollout_linear.cu) and the Frenet rate-form model of frenet_rate.cuh
// (rollout_frenet.cu), and a model generated from the trace of an OCP's own
// callables (ops/cuda/codegen.py, one unit per traced program).  A model
// gives kNX / kNU, the stage's box (model_box of box.cuh, evaluated on the
// state being rolled, so a state-dependent box follows the candidate), the
// clip, and the templates step / stage_cost / has_terminal_cost /
// terminal_cost, which K3 evaluates on dual numbers.  This header holds the kernels; each .cu file
// that includes it, after its model's header, instantiates them for its
// models and gives them one launcher (linesearch_run).  The same models
// price given trajectories for the rounds' cost re-base
// (trajectory_cost_kernel, at the end: glue of the solver loop, not K2).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "box.cuh"
#include "launch.cuh"

constexpr int kMaxAlphas = 32;

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

// The rounds' cost re-base's arguments (trajectory_cost_kernel).
struct CostArgs {
  const float *xs, *us, *ps;
  const bool* mask;
  const float* cost_in;
  float* cost_out;
  int B, N, npar;
};

// Shared-memory layout in floats: the five nominal slabs of `pb` problems,
// each at a multiple of 4 floats (16 bytes, for the vector copies), then
// (with slots) one candidate slot per lane, `slot` floats apart, and the
// winners' indices.  linesearch_launch_plan in ops/cuda/rollout.py is the one
// place that computes it; the entry point takes it from there.
struct LanesLayout {
  int pb, a_pad;
  int xs, us, kff, K, ps, cand, best;  // offsets
  int slot;                            // floats per candidate slot (odd)
  int total;
};

namespace {

// One problem's slices of the inputs, in device or in shared memory.
struct Problem {
  const float *x0, *xs, *us, *ps, *kff, *K;
};

// Roll one problem at step length alpha and return the cost; write the
// trajectory to xs_w (N+1, nx) and us_w (N, nu) unless xs_w is null.
template <class Model>
__device__ float roll(const Problem& q, const Model& m, int N, int npar, float alpha,
                      float* xs_w, float* us_w) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  float x[kNX];
#pragma unroll
  for (int i = 0; i < kNX; ++i) x[i] = q.x0[i];
  float cost = 0.0f;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const float* xn = q.xs + k * kNX;
    const float* un = q.us + k * kNU;
    const float* kf = q.kff + k * kNU;
    const float* Kk = q.K + k * kNU * kNX;
    const float* p = q.ps + k * npar;
    float dx[kNX], u[kNU], lo[kNU], hi[kNU];
    model_box(m, x, p, k, lo, hi);  // the box of the state being rolled
#pragma unroll
    for (int i = 0; i < kNX; ++i) dx[i] = x[i] - xn[i];
#pragma unroll
    for (int a = 0; a < kNU; ++a) {
      float Kdx = 0.0f;
#pragma unroll
      for (int i = 0; i < kNX; ++i) Kdx = Kdx + Kk[a * kNX + i] * dx[i];
      const float v = (un[a] + alpha * kf[a]) + Kdx;
      u[a] = Model::clip(v, lo[a], hi[a]);
    }
    if (xs_w) {
#pragma unroll
      for (int i = 0; i < kNX; ++i) xs_w[k * kNX + i] = x[i];
#pragma unroll
      for (int a = 0; a < kNU; ++a) us_w[k * kNU + a] = u[a];
    }
    cost = cost + stage_cost(m, x, u, p);
    step(m, x, u, p);
  }
  if (xs_w) {
#pragma unroll
    for (int i = 0; i < kNX; ++i) xs_w[N * kNX + i] = x[i];
  }
  if (has_terminal_cost(m)) cost = cost + terminal_cost(m, x, q.ps + N * npar);
  return cost;
}

// ---- "thread": one thread per problem over device memory -------------------

template <class Model>
__global__ void linesearch_thread_kernel(RolloutArgs g, Model m, Alphas al) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;
  const int N = g.N;
  const size_t sx = (size_t)b * (N + 1), su = (size_t)b * N;
  const Problem q{g.x0 + (size_t)b * kNX, g.xs + sx * kNX,    g.us + su * kNU,
                  g.ps + sx * g.npar,     g.kff + su * kNU,   g.K + su * kNU * kNX};
  int best = 0;
  if (al.n > 1) {
    float best_c = FLT_MAX;
#pragma unroll 1
    for (int a = 0; a < al.n; ++a) {
      const float c = roll(q, m, N, g.npar, al.a[a], nullptr, nullptr);
      if (c < best_c) {  // strict <, ascending alpha: first minimum
        best_c = c;
        best = a;
      }
    }
  }
  g.cost_out[b] = roll(q, m, N, g.npar, al.a[best], g.xs_out + sx * kNX, g.us_out + su * kNU);
  g.best_out[b] = best;
}

// ---- "lanes" / "lanes_reroll": one lane per (problem, alpha) ---------------

// Start the block's copy of n floats from device to shared memory (dst is 16
// byte aligned); the caller commits and waits.
__device__ __forceinline__ void load_slab(float* dst, const float* src, int n) {
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

template <class Model, bool SLOTS>
__global__ void linesearch_lanes_kernel(RolloutArgs g, Model m, Alphas al, LanesLayout L) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N;
  const int LX = (N + 1) * kNX, LU = N * kNU, LK = N * kNU * kNX, LP = (N + 1) * g.npar;
  const int b0 = blockIdx.x * L.pb;
  const int nb = min(L.pb, g.B - b0);

  load_slab(smem + L.xs, g.xs + (size_t)b0 * LX, nb * LX);
  load_slab(smem + L.us, g.us + (size_t)b0 * LU, nb * LU);
  load_slab(smem + L.kff, g.kff + (size_t)b0 * LU, nb * LU);
  load_slab(smem + L.K, g.K + (size_t)b0 * LK, nb * LK);
  load_slab(smem + L.ps, g.ps + (size_t)b0 * LP, nb * LP);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int pl = threadIdx.x / L.a_pad;  // problem within the block
  const int a = threadIdx.x % L.a_pad;   // alpha index
  const int b = b0 + pl;
  const bool active = pl < nb && a < al.n;
  const Problem q{g.x0 + (size_t)(active ? b : 0) * kNX, smem + L.xs + pl * LX,
                  smem + L.us + pl * LU,                 smem + L.ps + pl * LP,
                  smem + L.kff + pl * LU,                smem + L.K + pl * LK};
  float* xs_g = g.xs_out + (size_t)b * LX;
  float* us_g = g.us_out + (size_t)b * LU;

  if (!SLOTS && al.n == 1) {  // pre-roll: the writing pass alone
    if (active) {
      g.cost_out[b] = roll(q, m, N, g.npar, al.a[0], xs_g, us_g);
      g.best_out[b] = 0;
    }
    return;
  }

  float* slot = SLOTS ? smem + L.cand + threadIdx.x * L.slot : nullptr;
  float c = 0.0f;
  if (active) c = roll(q, m, N, g.npar, al.a[a], slot, SLOTS ? slot + LX : nullptr);

  // first minimum over the group: the lowest index among the costs < FLT_MAX
  const bool valid = active && c < FLT_MAX;
  float kc = valid ? c : FLT_MAX;
  int ki = valid ? a : INT_MAX;
  const unsigned mask =
      L.a_pad == 32 ? 0xffffffffu
                    : ((1u << L.a_pad) - 1u) << ((threadIdx.x & 31) / L.a_pad * L.a_pad);
  for (int off = L.a_pad >> 1; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(mask, kc, off, L.a_pad);
    const int oi = __shfl_xor_sync(mask, ki, off, L.a_pad);
    if (oc < kc || (oc == kc && oi < ki)) {
      kc = oc;
      ki = oi;
    }
  }
  const int best = ki == INT_MAX ? 0 : ki;
  const float c_best = __shfl_sync(mask, c, best, L.a_pad);
  if (a == 0 && pl < nb) {
    g.cost_out[b] = c_best;
    g.best_out[b] = best;
  }

  if (SLOTS) {
    int* bests = reinterpret_cast<int*>(smem + L.best);
    if (a == 0) bests[pl] = best;
    __syncthreads();
    const float* cand = smem + L.cand;
    float* xs_o = g.xs_out + (size_t)b0 * LX;
    float* us_o = g.us_out + (size_t)b0 * LU;
    for (int i = threadIdx.x; i < nb * LX; i += blockDim.x) {
      const int p = i / LX;
      xs_o[i] = cand[(p * L.a_pad + bests[p]) * L.slot + (i - p * LX)];
    }
    for (int i = threadIdx.x; i < nb * LU; i += blockDim.x) {
      const int p = i / LU;
      us_o[i] = cand[(p * L.a_pad + bests[p]) * L.slot + LX + (i - p * LU)];
    }
  } else if (active && a == best) {
    roll(q, m, N, g.npar, al.a[best], xs_g, us_g);
  }
}

template <class Model, bool SLOTS>
cudaError_t launch_lanes(const RolloutArgs& g, const Model& m, const Alphas& al,
                         const LanesLayout& L, cudaStream_t stream) {
  static bool permitted[kMaxDevices];
  const cudaError_t err =
      permit_shared_memory(linesearch_lanes_kernel<Model, SLOTS>, permitted);
  if (err != cudaSuccess) return err;
  const int blocks = (g.B + L.pb - 1) / L.pb;
  linesearch_lanes_kernel<Model, SLOTS>
      <<<blocks, L.pb * L.a_pad, L.total * sizeof(float), stream>>>(g, m, al, L);
  return cudaGetLastError();
}

// The alphas and the lanes plan as the kernels take them, from the C entry
// points' host arrays (`layout`: the 9 ints of LanesLayout from `xs` on);
// cudaErrorInvalidValue for a bad alpha count, variant or plan.
inline cudaError_t linesearch_prepare(const float* alphas, int n_alphas, int variant,
                                      int problems, const int* layout, Alphas& al,
                                      LanesLayout& L) {
  if (n_alphas < 1 || n_alphas > kMaxAlphas || variant < 0 || variant > 2)
    return cudaErrorInvalidValue;
  al.n = n_alphas;
  for (int i = 0; i < kMaxAlphas; ++i) al.a[i] = i < n_alphas ? alphas[i] : 0.0f;
  L = LanesLayout{};
  if (variant != 0) {
    int a_pad = 1;
    while (a_pad < n_alphas) a_pad *= 2;
    if (problems < 1 || problems * a_pad > 1024) return cudaErrorInvalidValue;
    L = LanesLayout{problems,  a_pad,     layout[0], layout[1], layout[2], layout[3],
                    layout[4], layout[5], layout[6], layout[7], layout[8]};
    if (((L.xs | L.us | L.kff | L.K | L.ps) & 3) != 0) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Launch `variant` (0 "thread", 1 "lanes", 2 "lanes_reroll") on model m; the
// caller has checked the model, the alphas and the plan.
template <class Model>
cudaError_t linesearch_run(const Model& m, const RolloutArgs& g, const Alphas& al, int variant,
                           const LanesLayout& L, cudaStream_t s) {
  if (variant == 0) {
    constexpr int kThreads = 64;
    const int blocks = (g.B + kThreads - 1) / kThreads;
    linesearch_thread_kernel<Model><<<blocks, kThreads, 0, s>>>(g, m, al);
    return cudaGetLastError();
  }
  return variant == 1 ? launch_lanes<Model, true>(g, m, al, L, s)
                      : launch_lanes<Model, false>(g, m, al, L, s);
}

// ---- the rounds' cost re-base: the cost of given trajectories ---------------
//
// Replaces no TPU kernel: the JAX streaming solver re-bases the cost of the
// slots whose continuation round ended (mpc_verde_tpu/solver/streaming.py)
// by an elementwise cost that XLA fuses into one fusion of the solver loop.
// Eager PyTorch runs the same expression as dozens of launches over every
// slot, GEMVs among them; this kernel is that fusion, written by hand, and
// prices only the masked slots.  For each problem b with mask[b] it sums
// stage_cost over k = 0..N-1 in order and adds the terminal cost, the loop
// and summation order of roll(), so the cost of an accepted trajectory (a
// rollout already clipped to its box) is the float K2 returned for it; it
// copies cost_in[b] where mask[b] is false.
//
// What bounds it: bytes.  A masked problem reads (N+1) nx + N nu + (N+1)
// npar floats, 1.5 KB at the bench's N = 40, nx 3, nu 2, npar 4.  When a few
// percent of the slots are masked, as at a round boundary, one thread a
// problem walks its own rows and the unmasked threads read and write one
// float; the time is then one problem's chain of N stages, each waiting on
// its loads: 0.053 ms on the H100 with 4% of 131,072 slots masked, against
// 0.003 ms of bytes.  With every slot masked, 0.33 ms against 0.058 ms: a
// warp's threads read rows 1.5 KB apart, so no load coalesces.  Either is
// small beside the solver iteration it serves (several ms at that width).

template <class Model>
__global__ void trajectory_cost_kernel(CostArgs g, Model m) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;
  if (!g.mask[b]) {
    g.cost_out[b] = g.cost_in[b];
    return;
  }
  const int N = g.N;
  const float* xs = g.xs + (size_t)b * (N + 1) * kNX;
  const float* us = g.us + (size_t)b * N * kNU;
  const float* ps = g.ps + (size_t)b * (N + 1) * g.npar;
  float x[kNX], u[kNU];
  float cost = 0.0f;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < kNX; ++i) x[i] = xs[k * kNX + i];
#pragma unroll
    for (int a = 0; a < kNU; ++a) u[a] = us[k * kNU + a];
    cost = cost + stage_cost(m, x, u, ps + k * g.npar);
  }
  if (has_terminal_cost(m)) {
#pragma unroll
    for (int i = 0; i < kNX; ++i) x[i] = xs[N * kNX + i];
    cost = cost + terminal_cost(m, x, ps + N * g.npar);
  }
  g.cost_out[b] = cost;
}

// Launch the re-base on model m; the caller has checked the model.
template <class Model>
cudaError_t trajectory_cost_run(const Model& m, const CostArgs& g, cudaStream_t s) {
  constexpr int kThreads = 128;
  const int blocks = (g.B + kThreads - 1) / kThreads;
  trajectory_cost_kernel<Model><<<blocks, kThreads, 0, s>>>(g, m);
  return cudaGetLastError();
}

}  // namespace
