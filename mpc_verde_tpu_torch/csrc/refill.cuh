// The streaming solver's refill (ops/cuda/refill.py): each slot whose problem
// finished writes its result row and loads the next queued problem, in place;
// no other slot and no other row is touched.
//
// It replaces no TPU kernel: in the JAX solver the refill is a few selects
// inside the one XLA program of the lax.while_loop.  In PyTorch the same
// selects are some 45 kernels a turn over every slot, a full-width gather of
// the queue's rows and a full-width scatter into the results (the idle slots'
// rows all to one dummy row), although a turn changes a few percent of the
// slots.  What bounds the refill is the bytes of the rows it moves: the
// finished slots' trajectories out, the loaded problems' packed rows in.
//
// Two launches, and no count read by the host:
//   refill_scan_kernel: one block of 32 warps, each over a contiguous run of
//     slots, 16 a lane (five 16-byte loads), finds fin = done & (prob < M),
//     ranks the finished slots in slot order (the torch.cumsum of the plain
//     version) by warp scans, writes their list and its length, and the queue
//     pointer nq before and after the turn;
//   refill_move_kernel: a fixed grid of warps walks that list, one slot a warp,
//     its loads and stores coalesced along the rows: the result row
//     [xs | us | cost gnorm iacc+max(it,0) conv] to out[prob], then, where a
//     queued problem is left (nq + rank < M), its row [x0 | ps | us | xs | cost]
//     of qpk into the slot with a fresh solver state, else prob = M.
// The dummy row M of `out` is never written.
//
// Every value is moved or set, never computed but for the iteration count and
// the converged flag, so the result is the plain version's bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kScanThreads = 1024;   // 32 warps
constexpr int kGroup = 16;           // slots a lane reads at once: 16 flags, 4 x 4 ids
constexpr int kMoveThreads = 256;
constexpr int kMoveBlocksPerSm = 8;  // 64 warps an SM, the most one SM holds

// Bit j of the result: slot 16 g + j finished (done, with a problem below M).
// A whole group on 16-byte aligned arrays is read by five 16-byte loads.
__device__ __forceinline__ unsigned finished_group(int g, int B, int M, const bool* done,
                                                   const int* prob, bool vec) {
  const int s0 = g * kGroup;
  unsigned m = 0;
  if (vec && s0 + kGroup <= B) {
    const uint4 d = *reinterpret_cast<const uint4*>(done + s0);
    const unsigned dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 p = reinterpret_cast<const int4*>(prob + s0)[k];
      const int pk[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (((dw[k] >> (8 * b)) & 0xffu) && pk[b] < M) m |= 1u << (4 * k + b);
    }
  } else {
    for (int j = 0; j < kGroup; ++j) {
      const int s = s0 + j;
      if (s < B && done[s] && prob[s] < M) m |= 1u << j;
    }
  }
  return m;
}

// scratch: [number of finished slots, nq before the turn, their slots...].
// Warp w takes a contiguous run of groups; at each step its 32 lanes read 32
// consecutive groups (512 slots), so the list comes out in slot order.
__global__ void __launch_bounds__(kScanThreads)
refill_scan_kernel(int B, int M, const bool* __restrict__ done, const int* __restrict__ prob,
                   int* __restrict__ nq, int* __restrict__ scratch) {
  __shared__ int warp_base[kScanThreads / 32];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<size_t>(done) % 16 == 0) &&
                   (reinterpret_cast<size_t>(prob) % 16 == 0);
  const int groups = (B + kGroup - 1) / kGroup;
  const int per_warp = (groups + 32 * 32 - 1) / (32 * 32) * 32;   // a multiple of 32
  const int g_lo = warp * per_warp, g_hi = min(groups, g_lo + per_warp);
  int n = 0;
#pragma unroll 4
  for (int g0 = g_lo; g0 < g_hi; g0 += 32) {
    const int g = g0 + lane;
    if (g < g_hi) n += __popc(finished_group(g, B, M, done, prob, vec));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kAllLanes, n, d);
  if (lane == 0) warp_base[warp] = n;
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the warps' counts
    const int v = warp_base[lane];
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kAllLanes, incl, d);
      if (lane >= d) incl += u;
    }
    warp_base[lane] = incl - v;
    if (lane == 31) total = incl;
  }
  __syncthreads();
  int* list = scratch + 2;
  int off = warp_base[warp];
  for (int g0 = g_lo; g0 < g_hi; g0 += 32) {
    const int g = g0 + lane;
    unsigned m = g < g_hi ? finished_group(g, B, M, done, prob, vec) : 0u;
    const int c = __popc(m);
    int incl = c;   // the lanes before this one, in slot order
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kAllLanes, incl, d);
      if (lane >= d) incl += u;
    }
    int at = off + incl - c;
    while (m) {
      const int j = __ffs(m) - 1;
      list[at++] = g * kGroup + j;
      m &= m - 1;
    }
    off += __shfl_sync(kAllLanes, incl, 31);
  }
  if (threadIdx.x == 0) {
    const int q = *nq;
    scratch[0] = total;
    scratch[1] = q;
    *nq = q + min(total, M - q);
  }
}

template <class T>
struct RefillArgs {
  T* xs;       // (B, N+1, nx)
  T* us;       // (B, N, nu)
  T* cost;     // (B,)
  T* reg;
  int* it;
  bool* done;
  T* gnorm;
  int* stall;
  bool* fail;
  bool* ddp_on;
  T* x0s;      // (B, nx)
  T* ps;       // (B, N+1, npar)
  bool* capped;
  int* rst;
  int* iacc;
  int* alr;
  int* prob;
  T* out;          // (M+1, sx+su+4)
  const T* qpk;    // (M, nx+sp+su+sx+1)
  const int* scratch;
  int M, nx, sp, su, sx;
  T reg_init;
  bool use_ddp;
};

// dst[0:n] = src[0:n] by the 32 lanes of a warp, four loads in flight a lane
// before their stores.
template <class T>
__device__ __forceinline__ void warp_copy(T* __restrict__ dst, const T* __restrict__ src, int n,
                                          int lane) {
  for (int j0 = 0; j0 < n; j0 += 128) {
    T v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + 32 * k + lane;
      if (j < n) v[k] = src[j];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + 32 * k + lane;
      if (j < n) dst[j] = v[k];
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kMoveThreads) refill_move_kernel(RefillArgs<T> a) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int n = a.scratch[0];
  const long long q0 = a.scratch[1];
  const int* list = a.scratch + 2;
  const int sx = a.sx, su = a.su, sp = a.sp, nx = a.nx;
  const long long W = sx + su + 4, Q = nx + sp + su + sx + 1;
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); i < n; i += warps) {
    const long long s = list[i];
    T* xs = a.xs + s * sx;
    T* us = a.us + s * su;
    T* o = a.out + a.prob[s] * W;
    warp_copy(o, xs, sx, lane);
    warp_copy(o + sx, us, su, lane);
    if (lane == 0) {
      const T c = a.cost[s];
      o[sx + su] = c;
      o[sx + su + 1] = a.gnorm[s];
      o[sx + su + 2] = static_cast<T>(a.iacc[s] + max(a.it[s], 0));
      o[sx + su + 3] = !a.fail[s] && isfinite(c) && !a.capped[s] ? T(1) : T(0);
    }
    __syncwarp();   // every lane has read the slot before any lane writes it
    const long long cand = q0 + i;
    if (cand < a.M) {
      const T* q = a.qpk + cand * Q;
      warp_copy(a.x0s + s * nx, q, nx, lane);
      warp_copy(a.ps + s * sp, q + nx, sp, lane);
      warp_copy(us, q + nx + sp, su, lane);
      warp_copy(xs, q + nx + sp + su, sx, lane);
      if (lane == 0) {
        a.cost[s] = q[Q - 1];
        a.reg[s] = a.reg_init;
        a.it[s] = 0;
        a.gnorm[s] = T(INFINITY);
        a.stall[s] = 0;
        a.fail[s] = false;
        a.ddp_on[s] = a.use_ddp;
        a.capped[s] = false;
        a.done[s] = false;
        a.prob[s] = static_cast<int>(cand);
        a.rst[s] = 0;
        a.iacc[s] = 0;
        a.alr[s] = 0;
      }
    } else if (lane == 0) {
      a.prob[s] = a.M;
    }
  }
}

template <class T>
cudaError_t refill_run(const RefillArgs<T>& a, int B, bool* done, int* prob, int* nq,
                       int* scratch, cudaStream_t s) {
  refill_scan_kernel<<<1, kScanThreads, 0, s>>>(B, a.M, done, prob, nq, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // a warp a finished slot at most: no more blocks than B slots need
  const int warps_per_block = kMoveThreads / 32;
  const int needed = (B + warps_per_block - 1) / warps_per_block;
  const int blocks = needed < sms * kMoveBlocksPerSm ? needed : sms * kMoveBlocksPerSm;
  refill_move_kernel<T><<<blocks, kMoveThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <class T>
RefillArgs<T> refill_args(int M, int nx, int sp, int su, int sx, double reg_init, int use_ddp,
                          void* xs, void* us, void* cost, void* reg, int* it, bool* done,
                          void* gnorm, int* stall, bool* fail, bool* ddp_on, void* x0s, void* ps,
                          bool* capped, int* rst, int* iacc, int* alr, int* prob, void* out,
                          const void* qpk, const int* scratch) {
  return RefillArgs<T>{static_cast<T*>(xs), static_cast<T*>(us), static_cast<T*>(cost),
                       static_cast<T*>(reg), it, done, static_cast<T*>(gnorm), stall, fail,
                       ddp_on, static_cast<T*>(x0s), static_cast<T*>(ps), capped, rst, iacc, alr,
                       prob, static_cast<T*>(out), static_cast<const T*>(qpk), scratch, M, nx,
                       sp, su, sx, static_cast<T>(reg_init), use_ddp != 0};
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `dtype` 0 is float32, 1 float64,
// the type of xs, us, cost, reg, gnorm, x0s, ps, out and qpk; it, stall, rst,
// iacc, alr, prob (B,) and nq (a single value) are int32, done, fail, ddp_on and
// capped (B,) bool; every pointer a contiguous device array.  sx, su, sp are a
// slot's floats of xs, us and ps; out holds M + 1 rows of sx + su + 4 and qpk
// M rows of nx + sp + su + sx + 1.  `scratch` is B + 2 int32 of device memory.
// Returns the CUDA error of a launch, or cudaErrorInvalidValue for a bad dtype
// or size.
extern "C" int mv_refill_slots(int dtype, int B, int M, int nx, int sp, int su, int sx,
                               double reg_init, int use_ddp, void* xs, void* us, void* cost,
                               void* reg, int* it, bool* done, void* gnorm, int* stall, bool* fail,
                               bool* ddp_on, void* x0s, void* ps, bool* capped, int* rst,
                               int* iacc, int* alr, int* prob, int* nq, void* out,
                               const void* qpk, int* scratch, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 0 || M < 1 || nx < 1 || sp < 0 || su < 1 || sx < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return refill_run(refill_args<float>(M, nx, sp, su, sx, reg_init, use_ddp, xs, us, cost, reg,
                                         it, done, gnorm, stall, fail, ddp_on, x0s, ps, capped,
                                         rst, iacc, alr, prob, out, qpk, scratch),
                      B, done, prob, nq, scratch, s);
  return refill_run(refill_args<double>(M, nx, sp, su, sx, reg_init, use_ddp, xs, us, cost, reg,
                                        it, done, gnorm, stall, fail, ddp_on, x0s, ps, capped,
                                        rst, iacc, alr, prob, out, qpk, scratch),
                    B, done, prob, nq, scratch, s);
}
