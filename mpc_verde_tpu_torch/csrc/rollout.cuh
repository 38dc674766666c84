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
// Variants, chosen by the caller from the shape and the batch
// (linesearch_launch_plan in ops/cuda/rollout.py, which also computes the
// shared-memory layout): "lanes" as above, and "lanes_ring" (below) where
// the grid of "lanes" runs many waves with few of its warps on each SM.
// Both run the same roll_stage() per stage of a candidate and the same
// group_first_min, so the ring's cost, alpha index, xs and us are those of
// "lanes" bit for bit.
//
// "lanes_ring": the lanes of "lanes", with shared memory that does not grow
// with N.  A block streams its problems' nominal rows through a ring of two
// chunks of kRingChunk stages with cp.async: it loads the next chunk while
// the lanes roll the current one, one __syncthreads a chunk (a third chunk
// gained nothing).  A stage row holds the stage's xs, us, kff, K and ps of
// one problem; a problem's rows of a chunk are `pstride` floats apart (odd:
// the problems of a warp read different banks).  There are no candidate
// slots: after the shuffle that finds the first minimum, the block streams
// the ring once more and thread t < problems re-rolls problem t at its
// winning alpha and writes xs_out / us_out itself, so the second pass keeps
// only the first problems' warps busy.  With one alpha (the pre-roll) the
// first pass writes.  The chain is twice as long, but at (nx, nu) = (6, 2),
// N = 40 a block of 16 problems needs 28 KB where "lanes" needs 120 KB for
// 8: registers, not shared memory, then set how many blocks an SM holds.
//
// What bounds it: one candidate is a chain of N dependent steps, so a wave
// of blocks takes one chain whatever its width, and what sets the time of a
// batch of many waves is how many lanes an SM holds at once.  At B = 1024
// the grid of "lanes" is about one wave and blocks of 32 to 256 threads take
// the same time (utils/tune_launch_plans.py), so the plan constants
// measured there could not see it; at 131,072 problems "lanes" at (6, 2)
// runs 125 waves of one 2-warp block an SM (6.26 ms on the H100), the ring
// 13 of five 4-warp blocks (1.80 ms; PERF.md, section 6).
//
// The kernels are templates on the device model: the unicycle of
// unicycle.cuh (instantiated in rollout.cu, with its optional barrier and AL
// terms, which read more columns of ps: at N = 40 and npar = 11 a "lanes"
// block of 8 problems takes 84 KB of shared memory) and a model generated
// from the trace of an OCP's own callables (ops/cuda/codegen.py, one unit
// per traced program).  A model
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

// Shared-memory layout in floats.  "lanes": the five nominal slabs of `pb`
// problems, each at a multiple of 4 floats (16 bytes, for the vector
// copies), then one candidate slot per lane, `slot` floats apart, and the
// winners' indices.  "lanes_ring": two ring
// slots of one chunk each, `sstride` floats apart, each holding the chunk's
// kRingChunk stages of `row` floats (xs, us, kff, K, ps) for each problem,
// `pstride` floats apart; then the winners' indices at `best`.
// linesearch_launch_plan in ops/cuda/rollout.py is the one place that
// computes it; the entry point takes it from there.
struct LanesLayout {
  int pb, a_pad;
  int xs, us, kff, K, ps, cand, best;  // offsets
  int slot;                            // floats per candidate slot (odd)
  int total;
  int row, pstride, sstride;  // "lanes_ring" only
};

// The variants: the C entry's ids and linesearch_lanes_kernel's VARIANT.
enum { kLanesVariant = 0, kRingVariant = 1 };

namespace {

// One problem's slices of the inputs, in device or in shared memory.
struct Problem {
  const float *x0, *xs, *us, *ps, *kff, *K;
};

// One stage k of a candidate at step length alpha from state x: the
// clipped feedback control, the stage cost added to `cost`, x stepped.  The
// stage's nominal rows are xn (nx), un, kf (nu), Kk (nu x nx) and p (npar);
// x and the control are written to xs_w / us_w unless xs_w is null.
template <class Model>
__device__ __forceinline__ void roll_stage(const Model& m, float (&x)[Model::kNX], float& cost,
                                           int k, float alpha, const float* xn, const float* un,
                                           const float* kf, const float* Kk, const float* p,
                                           float* xs_w, float* us_w) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
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
    for (int i = 0; i < kNX; ++i) xs_w[i] = x[i];
#pragma unroll
    for (int a = 0; a < kNU; ++a) us_w[a] = u[a];
  }
  cost = cost + stage_cost(m, x, u, p);
  step(m, x, u, p);
}

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
  for (int k = 0; k < N; ++k)
    roll_stage(m, x, cost, k, alpha, q.xs + k * kNX, q.us + k * kNU, q.kff + k * kNU,
               q.K + k * kNU * kNX, q.ps + k * npar, xs_w ? xs_w + k * kNX : nullptr,
               xs_w ? us_w + k * kNU : nullptr);
  if (xs_w) {
#pragma unroll
    for (int i = 0; i < kNX; ++i) xs_w[N * kNX + i] = x[i];
  }
  if (has_terminal_cost(m)) cost = cost + terminal_cost(m, x, q.ps + N * npar);
  return cost;
}

// ---- "lanes" / "lanes_ring": one lane per (problem, alpha) -------------------

// Start the block's copy of n floats from device to shared memory (dst is 16
// byte aligned); the caller commits and waits.
__device__ __forceinline__ void load_slab(float* dst, const float* src, int n) {
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

// Stages a ring chunk, and chunks in the ring ("lanes_ring"; the plan's
// _RING_CHUNK and _RING_DEPTH).
constexpr int kRingChunk = 8, kRingDepth = 2;

template <int n>
__device__ __forceinline__ void copy_row(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < n; ++i) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// Start the copy of ring chunk i (a pass over the horizon is `nchunks`
// chunks; chunk i holds stages (i % nchunks) * kRingChunk on) of the
// block's nb problems into ring slot i % kRingDepth, one stage row (xs, us, kff,
// K, ps) a thread, and commit it: an empty group past the last chunk, so
// that every thread waits alike.  (A copy of consecutive floats by
// consecutive threads coalesces, but its index arithmetic cost more than
// it saved: 2.10 against 1.80 ms at the quadrotor cell's width on the
// H100.)
template <int kNX, int kNU>
__device__ __forceinline__ void load_chunk(float* smem, const RolloutArgs& g,
                                           const LanesLayout& L, int b0, int nb, int nchunks,
                                           int last, int i) {
  constexpr int C = kRingChunk;
  if (i < last) {
    const int N = g.N, npar = g.npar;
    const int k0 = (i % nchunks) * C, n = min(C, N - k0);
    float* slot = smem + (i % kRingDepth) * L.sstride;
    for (int r = threadIdx.x; r < nb * C; r += blockDim.x) {
      const int p = r / C, s = r - p * C;
      if (s >= n) continue;
      const size_t kx = (size_t)(b0 + p) * (N + 1) + k0 + s, ku = (size_t)(b0 + p) * N + k0 + s;
      float* d = slot + p * L.pstride + s * L.row;
      copy_row<kNX>(d, g.xs + kx * kNX);
      copy_row<kNU>(d + kNX, g.us + ku * kNU);
      copy_row<kNU>(d + kNX + kNU, g.kff + ku * kNU);
      copy_row<kNU * kNX>(d + kNX + 2 * kNU, g.K + ku * kNU * kNX);
      for (int j = 0; j < npar; ++j)
        __pipeline_memcpy_async(d + kNX + 2 * kNU + kNU * kNX + j, g.ps + kx * npar + j, 4);
    }
  }
  __pipeline_commit();
}

// The first minimum over a group of a_pad lanes (alpha index a, cost c):
// the lowest index among the costs < FLT_MAX, 0 if there is none; its cost
// in c_best.
__device__ __forceinline__ int group_first_min(float c, bool active, int a, int a_pad,
                                               float& c_best) {
  const bool valid = active && c < FLT_MAX;
  float kc = valid ? c : FLT_MAX;
  int ki = valid ? a : INT_MAX;
  const unsigned mask =
      a_pad == 32 ? 0xffffffffu : ((1u << a_pad) - 1u) << ((threadIdx.x & 31) / a_pad * a_pad);
  for (int off = a_pad >> 1; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(mask, kc, off, a_pad);
    const int oi = __shfl_xor_sync(mask, ki, off, a_pad);
    if (oc < kc || (oc == kc && oi < ki)) {
      kc = oc;
      ki = oi;
    }
  }
  const int best = ki == INT_MAX ? 0 : ki;
  c_best = __shfl_sync(mask, c, best, a_pad);
  return best;
}

// VARIANT kLanesVariant ("lanes") or kRingVariant ("lanes_ring").
template <class Model, int VARIANT>
__global__ void linesearch_lanes_kernel(RolloutArgs g, Model m, Alphas al, LanesLayout L) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N;
  const int LX = (N + 1) * kNX, LU = N * kNU, LK = N * kNU * kNX, LP = (N + 1) * g.npar;
  const int b0 = blockIdx.x * L.pb;
  const int nb = min(L.pb, g.B - b0);
  const int pl = threadIdx.x / L.a_pad;  // problem within the block
  const int a = threadIdx.x % L.a_pad;   // alpha index
  const int b = b0 + pl;
  const bool active = pl < nb && a < al.n;
  int* bests = reinterpret_cast<int*>(smem + L.best);
  float c_best;

  if constexpr (VARIANT == kRingVariant) {
    const int nchunks = (N + kRingChunk - 1) / kRingChunk;
    const int last = (al.n > 1 ? 2 : 1) * nchunks;
    load_chunk<kNX, kNU>(smem, g, L, b0, nb, nchunks, last, 0);
    int next = 0;  // the next chunk to roll
    // One pass over the horizon through the ring, the whole block in step:
    // each chunk waits for its copy, starts the copy of the next chunk into
    // the slot the previous one held, and rolls.  Where `on`
    // it rolls problem p at alpha from its x0 and returns the cost, writing
    // the trajectory to xs_w / us_w unless xs_w is null.
    auto pass = [&](bool on, int p, float alpha, float* xs_w, float* us_w) {
      float x[kNX] = {};
      float cost = 0.0f;
      if (on) {
#pragma unroll
        for (int i = 0; i < kNX; ++i) x[i] = g.x0[(size_t)(b0 + p) * kNX + i];
      }
#pragma unroll 1
      for (int c = 0; c < nchunks; ++c) {
        __pipeline_wait_prior(kRingDepth - 2);
        __syncthreads();
        load_chunk<kNX, kNU>(smem, g, L, b0, nb, nchunks, last, next + kRingDepth - 1);
        const float* rows = smem + (next++ % kRingDepth) * L.sstride + p * L.pstride;
        if (!on) continue;
        const int k0 = c * kRingChunk, n = min(kRingChunk, N - k0);
#pragma unroll 1
        for (int s = 0; s < n; ++s) {
          const float* r = rows + s * L.row;
          const int k = k0 + s;
          roll_stage(m, x, cost, k, alpha, r, r + kNX, r + kNX + kNU, r + kNX + 2 * kNU,
                     r + kNX + 2 * kNU + kNU * kNX, xs_w ? xs_w + k * kNX : nullptr,
                     xs_w ? us_w + k * kNU : nullptr);
        }
      }
      if (on) {
        if (xs_w) {
#pragma unroll
          for (int i = 0; i < kNX; ++i) xs_w[N * kNX + i] = x[i];
        }
        if (has_terminal_cost(m))
          cost = cost + terminal_cost(m, x, g.ps + ((size_t)(b0 + p) * (N + 1) + N) * g.npar);
      }
      return cost;
    };

    if (al.n == 1) {  // pre-roll: the writing pass alone
      const float c = pass(active, pl, al.a[0], g.xs_out + (size_t)b * LX,
                           g.us_out + (size_t)b * LU);
      if (active) {
        g.cost_out[b] = c;
        g.best_out[b] = 0;
      }
      return;
    }
    const float c = pass(active, pl, al.a[active ? a : 0], nullptr, nullptr);
    const int best = group_first_min(c, active, a, L.a_pad, c_best);
    if (a == 0 && pl < nb) {
      g.cost_out[b] = c_best;
      g.best_out[b] = best;
      bests[pl] = best;
    }
    __syncthreads();
    // the winners' pass: thread t re-rolls problem t
    const int t = threadIdx.x;
    const bool on = t < nb;
    pass(on, t, al.a[on ? bests[t] : 0], g.xs_out + (size_t)(b0 + t) * LX,
         g.us_out + (size_t)(b0 + t) * LU);
  } else {
    load_slab(smem + L.xs, g.xs + (size_t)b0 * LX, nb * LX);
    load_slab(smem + L.us, g.us + (size_t)b0 * LU, nb * LU);
    load_slab(smem + L.kff, g.kff + (size_t)b0 * LU, nb * LU);
    load_slab(smem + L.K, g.K + (size_t)b0 * LK, nb * LK);
    load_slab(smem + L.ps, g.ps + (size_t)b0 * LP, nb * LP);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const Problem q{g.x0 + (size_t)(active ? b : 0) * kNX, smem + L.xs + pl * LX,
                    smem + L.us + pl * LU,                 smem + L.ps + pl * LP,
                    smem + L.kff + pl * LU,                smem + L.K + pl * LK};
    float* slot = smem + L.cand + threadIdx.x * L.slot;
    float c = 0.0f;
    if (active) c = roll(q, m, N, g.npar, al.a[a], slot, slot + LX);
    const int best = group_first_min(c, active, a, L.a_pad, c_best);
    if (a == 0 && pl < nb) {
      g.cost_out[b] = c_best;
      g.best_out[b] = best;
      bests[pl] = best;
    }
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
  }
}

// Permit the lanes kernel of VARIANT on model m all of a block's dynamic
// shared memory (once a device).
template <class Model, int VARIANT>
cudaError_t permit_lanes() {
  static bool permitted[kMaxDevices];
  return permit_shared_memory(linesearch_lanes_kernel<Model, VARIANT>, permitted);
}

template <class Model, int VARIANT>
cudaError_t launch_lanes(const RolloutArgs& g, const Model& m, const Alphas& al,
                         const LanesLayout& L, cudaStream_t stream) {
  const cudaError_t err = permit_lanes<Model, VARIANT>();
  if (err != cudaSuccess) return err;
  const int blocks = (g.B + L.pb - 1) / L.pb;
  linesearch_lanes_kernel<Model, VARIANT>
      <<<blocks, L.pb * L.a_pad, L.total * sizeof(float), stream>>>(g, m, al, L);
  return cudaGetLastError();
}

// The alphas and the lanes plan as the kernels take them, from the C entry
// points' host arrays (`layout`: for "lanes" the 9 ints
// of LanesLayout from `xs` to `total`, for "lanes_ring" the 5 ints row,
// pstride, sstride, best, total); cudaErrorInvalidValue for a bad alpha
// count, variant or plan.
inline cudaError_t linesearch_prepare(const float* alphas, int n_alphas, int variant,
                                      int problems, const int* layout, Alphas& al,
                                      LanesLayout& L) {
  if (n_alphas < 1 || n_alphas > kMaxAlphas || variant < kLanesVariant ||
      variant > kRingVariant)
    return cudaErrorInvalidValue;
  al.n = n_alphas;
  for (int i = 0; i < kMaxAlphas; ++i) al.a[i] = i < n_alphas ? alphas[i] : 0.0f;
  L = LanesLayout{};
  int a_pad = 1;
  while (a_pad < n_alphas) a_pad *= 2;
  if (problems < 1 || problems * a_pad > 1024) return cudaErrorInvalidValue;
  L.pb = problems;
  L.a_pad = a_pad;
  if (variant == kRingVariant) {
    L.row = layout[0];
    L.pstride = layout[1];
    L.sstride = layout[2];
    L.best = layout[3];
    L.total = layout[4];
    if (L.pstride < kRingChunk * L.row || L.sstride < problems * L.pstride ||
        L.best < kRingDepth * L.sstride || L.total < L.best + problems)
      return cudaErrorInvalidValue;
    return cudaSuccess;
  }
  L.xs = layout[0];
  L.us = layout[1];
  L.kff = layout[2];
  L.K = layout[3];
  L.ps = layout[4];
  L.cand = layout[5];
  L.best = layout[6];
  L.slot = layout[7];
  L.total = layout[8];
  if (((L.xs | L.us | L.kff | L.K | L.ps) & 3) != 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Launch `variant` (kLanesVariant or kRingVariant) on model m; the caller
// has checked the model, the alphas and the plan but for the ring's row,
// checked here against the model's sizes.
template <class Model>
cudaError_t linesearch_run(const Model& m, const RolloutArgs& g, const Alphas& al, int variant,
                           const LanesLayout& L, cudaStream_t s) {
  constexpr int kNX = Model::kNX, kNU = Model::kNU;
  if (variant == kLanesVariant) return launch_lanes<Model, kLanesVariant>(g, m, al, L, s);
  if (L.row != kNX + 2 * kNU + kNU * kNX + g.npar) return cudaErrorInvalidValue;
  return launch_lanes<Model, kRingVariant>(g, m, al, L, s);
}

template <class Kernel>
cudaError_t kernel_occupancy(Kernel kernel, int threads, int smem_bytes, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel, threads, smem_bytes);
}

// What the CUDA runtime says of `variant`'s kernel on the model: out[0] its
// registers a thread, out[1] its local memory a thread (bytes; spills), and
// out[2] the blocks of `threads` threads and `smem_bytes` of dynamic shared
// memory an SM holds at once.
template <class Model>
cudaError_t linesearch_occupancy(int variant, int threads, int smem_bytes, int* out) {
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case kLanesVariant:
      err = permit_lanes<Model, kLanesVariant>();
      return err != cudaSuccess ? err
                                : kernel_occupancy(linesearch_lanes_kernel<Model, kLanesVariant>,
                                                   threads, smem_bytes, out);
    case kRingVariant:
      err = permit_lanes<Model, kRingVariant>();
      return err != cudaSuccess ? err
                                : kernel_occupancy(linesearch_lanes_kernel<Model, kRingVariant>,
                                                   threads, smem_bytes, out);
    default:
      return cudaErrorInvalidValue;
  }
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
