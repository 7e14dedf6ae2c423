// step_integrate: the per-row integral of a held sample series, for Hopper.
//
// Replaces the TPU kernel `_step_kernel` (`_step_integrate_impl` /
// `step_integrate`, src/repro/core/engine_backend/pallas_backend.py:
// 424,456,467,481).  That kernel took blocks of 1024 rows, built each
// row's prefix sum of dens*dt in VMEM, found the window edges by counting
// and took cum[j1] - cum[j0] plus the tail.
//
// For each row i of ts, vals [N, M] (times non-decreasing, unused slots
// +inf) and its window [t0_i, t1_i]:
//
//   j0 = #(ts < t0),  j1 = #(ts <= t1) - 1
//   out = sum_{k in [j0, j1)} dens_k * dt_k + vals[j1] * (t1 - ts[j1])
//
// with dt_k = ts[k+1] - ts[k] (both operands masked to 0 where ts[k+1] is
// not finite, so no inf - inf is evaluated), dens_k = vals[k], or
// 0.5 * (vals[k] + vals[k+1]) under the trapezoid rule (vals[k+1] masked
// alike); out = 0 where the window selects no sample (j1 < j0 or j0 == M).
// numpy_backend.step_integrate and the plain PyTorch version compute the
// same, through a prefix sum.
//
// Design: one block per row, its size chosen by M (256 threads up to
// M = 8192, 512 up to 16384, then 1024), the window's edges found by the
// whole block in two rounds of loads:
//
// 1. each thread loads one pivot ts[t * stride], stride = ceil(M /
//    threads); ballots count the pivots < t0 and <= t1, which brackets j0
//    and j1 within `stride` entries each (at most 32 up to M = 8192);
// 2. warp 0 counts its bracket < t0 and warp 1 its bracket <= t1 (32
//    entries a ballot), and warp 1 keeps ts[j1] and vals[j1] for the tail
//    from the same loads.
//
// The block's threads then stride over [j0, j1) with neighbouring threads
// on neighbouring samples, each loading 2048 / threads terms before it
// adds them in order; warp shuffles and then one pass over the warps'
// partial sums in shared memory reduce them in a fixed tree order, so a
// row's result does not change from run to run.  No atomics: every output
// has one writer.  The windowed sum differs from the reference's
// cum[j1] - cum[j0] only by rounding.
//
// Bound on an H100: memory.  Each input read once is N*M*16 + N*24 bytes
// (ts and vals, t0 and t1, the output written) over 3.35 TB/s; what the
// windows need is less, 16 bytes per selected sample plus 24 per row, and
// only the selected samples are read here (plus a pivot a thread and two
// brackets), against four to six f64 operations each.  A §5 trial is one
// [1, M] row with M of 1,000 to 7,000, so there its time is the launch
// and the latency of three rounds of loads; wide batches keep 132 SMs
// busy with one row per block.  Built with -fmad=false, so each product
// is rounded on its own as in PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr unsigned kFull = 0xffffffffu;

struct StepArgs {
  // inputs: ts, vals [N, M], t0, t1 [N]; output [N]
  const double* ts;
  const double* vals;
  const double* t0;
  const double* t1;
  double* out;
};

constexpr int kNumPointers = 5;

// threads a block for rows of m samples: round 2's brackets hold at most
// 32 entries up to m = 32 * 1024
inline int threads_for(int64_t m) {
  return m <= 8192 ? 256 : (m <= 16384 ? 512 : 1024);
}

// dens_k * dt_k; every operand is loaded whatever ts[k + 1] holds, so no
// load waits on another
template <bool kTrap>
__device__ __forceinline__ double term(const double* ts, const double* vals,
                                       int64_t k) {
  const double nxt = ts[k + 1];
  const double cur = ts[k];
  const double v = vals[k];
  const double v_next = kTrap ? vals[k + 1] : 0.0;
  const bool fin = isfinite(nxt);
  const double dt = (fin ? nxt : 0.0) - (fin ? cur : 0.0);
  const double dens = kTrap ? 0.5 * (v + (fin ? v_next : 0.0)) : v;
  return dens * dt;
}

template <int kThreads, bool kTrap>
__global__ void __launch_bounds__(kThreads)
    step_integrate_kernel(StepArgs a, int64_t m) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kUnroll = 2048 / kThreads;  // terms in flight a thread
  __shared__ int s_count[2][kWarps];
  __shared__ int64_t s_j[2];
  __shared__ double s_tail[2];
  __shared__ double s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const double* ts = a.ts + row * m;
  const double* vals = a.vals + row * m;
  const double t0 = a.t0[row];
  const double t1 = a.t1[row];

  // round 1: a pivot a thread; the row is sorted, so the pivots below t0
  // (at most t1) are a prefix of them
  const int64_t stride = (m + kThreads - 1) / kThreads;
  const int64_t p = tid * stride;
  const bool live = p < m;
  const double piv = live ? ts[p] : 0.0;
  const unsigned below = __ballot_sync(kFull, live && piv < t0);
  const unsigned upto = __ballot_sync(kFull, live && piv <= t1);
  if (lane == 0) {
    s_count[0][warp] = __popc(below);
    s_count[1][warp] = __popc(upto);
  }
  __syncthreads();

  // round 2: c pivots pass, so the edge lies in [(c-1)*stride, c*stride):
  // warp 0 counts that bracket < t0, warp 1 counts its own <= t1
  if (warp < 2) {
    const int side = warp;
    int c = lane < kWarps ? s_count[side][lane] : 0;
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
    int64_t lo = 0;
    int64_t cnt = 0;
    double tail_t = 0.0;
    double tail_v = 0.0;
    if (c > 0) {
      lo = (c - 1) * stride;
      const int64_t hi = (int64_t)c * stride < m ? (int64_t)c * stride : m;
      for (int64_t base = lo; base < hi; base += 32) {
        const int64_t j = base + lane;
        const bool in = j < hi;
        const double tj = in ? ts[j] : 0.0;
        const double vj = (in && side == 1) ? vals[j] : 0.0;
        const unsigned b =
            __ballot_sync(kFull, in && (side == 0 ? tj < t0 : tj <= t1));
        if (side == 1 && b != 0u) {  // the last sample <= t1 so far
          const int src = 31 - __clz(b);
          tail_t = __shfl_sync(kFull, tj, src);
          tail_v = __shfl_sync(kFull, vj, src);
        }
        cnt += __popc(b);
      }
    }
    if (lane == 0) {
      s_j[side] = side == 0 ? lo + cnt : lo + cnt - 1;
      if (side == 1) {
        s_tail[0] = tail_t;
        s_tail[1] = tail_v;
      }
    }
  }
  __syncthreads();
  const int64_t j0 = s_j[0];
  const int64_t j1 = s_j[1];

  // kUnroll terms a thread in flight; a term past the window loads the
  // window's last (in bounds) and is not added
  double acc = 0.0;
  for (int64_t k = j0 + tid; k < j1; k += kUnroll * kThreads) {
    double x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ku = k + u * kThreads;
      x[u] = term<kTrap>(ts, vals, ku < j1 ? ku : j1 - 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u * kThreads < j1) acc += x[u];
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(kFull, acc, off);
  }
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();

  if (tid == 0) {
    double core = 0.0;
    for (int w = 0; w < kWarps; ++w) core += s_warp[w];
    double r = 0.0;
    if (j1 >= j0 && j0 < m) {
      // here 0 <= j0 <= j1 <= M - 1, and round 2 held ts[j1], vals[j1]
      r = core + s_tail[1] * (t1 - s_tail[0]);
    }
    a.out[row] = r;
  }
}

// the floor of a launch: step_integrate's grid and block, no work
__global__ void step_integrate_empty_kernel() {}

template <int kThreads>
cudaError_t launch_rows(const StepArgs& a, int64_t n, int64_t m,
                        int trapezoid, cudaStream_t st) {
  if (trapezoid) {
    step_integrate_kernel<kThreads, true><<<(unsigned)n, kThreads, 0, st>>>(
        a, m);
  } else {
    step_integrate_kernel<kThreads, false><<<(unsigned)n, kThreads, 0, st>>>(
        a, m);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

using repro_torch::StepArgs;

// ptrs: the 5 device pointers in StepArgs field order.  Launches one block
// per row on `stream` and returns the launch error (0 on success).
extern "C" int step_integrate_launch(void* const* ptrs, int64_t n, int64_t m,
                                     int trapezoid, void* stream) {
  static_assert(sizeof(StepArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "StepArgs must be exactly the pointer list");
  using namespace repro_torch;
  StepArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (n <= 0 || m <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  switch (threads_for(m)) {
    case 256:
      return (int)launch_rows<256>(a, n, m, trapezoid, st);
    case 512:
      return (int)launch_rows<512>(a, n, m, trapezoid, st);
    default:
      return (int)launch_rows<1024>(a, n, m, trapezoid, st);
  }
}

// The same arguments and grid as step_integrate_launch, an empty kernel:
// what a launch costs before any work.
extern "C" int step_integrate_empty_launch(void* const* ptrs, int64_t n,
                                           int64_t m, int trapezoid,
                                           void* stream) {
  using namespace repro_torch;
  if (n <= 0 || m <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  step_integrate_empty_kernel<<<(unsigned)n, threads_for(m), 0,
                                (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* step_integrate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int step_integrate_num_pointers() {
  return repro_torch::kNumPointers;
}
