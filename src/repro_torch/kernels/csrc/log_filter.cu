// log_filter: the Kepler/Maxwell first-order sensor filter, for Hopper.
//
// Replaces the TPU kernel `_scan_kernel` (`_log_filter_impl` /
// `log_filter`, src/repro/core/engine_backend/pallas_backend.py:497,516,566).
// That kernel wrote the filter y' = (P - y)/tau over piecewise-constant
// segments as the affine recurrence y_{i+1} = a_i*y_i + b_i and ran it as a
// blocked scan (512 rows x 64 segments, the state carried in VMEM across a
// sequential grid), then decayed each tick from the state at the start of
// its segment.
//
// Here the recurrence keeps the reference's own step,
// sp + (y - sp) * exp(-dt / tau), carried unchanged over zero-width
// (padding) segments, so it rounds as numpy_backend.log_filter and the
// plain PyTorch version do.  Two launches:
//
// 1. states: one thread per device row walks the row's S + 2 extended
//    segments in order (the t_lo padding, the row's S segments, the t_hi
//    padding) and writes the entry state of every segment, transposed to
//    [S + 3, G] so that neighbouring threads write neighbouring addresses.
//    A shared timeline (R = 1) is staged through shared memory a tile of
//    segments at a time; per-device rows are read from global memory.
// 2. readings: one thread per (row, tick) binary-searches the row's
//    extended edges (exact comparisons, the `searchsorted(..., "right") - 1`
//    of the reference, clipped to the segments) and decays the segment's
//    entry state to the tick.  Ticks need not be sorted.
//
// Bound on an H100: memory at the audit's shapes.  Per tick it reads the
// tick (8 B) and writes the reading (8 B), against one exp and six other
// f64 operations; per (row, segment) one exp and five operations, plus the
// row's edges and powers.  What the design does about it: ticks and
// readings are read and written coalesced, the shared timeline is read
// once per block, the states stay in L2 between the two launches.
//
// t_lo and t_hi (`span`) are device values, so the wrapper never waits for
// the card.  No atomics: every output has one writer.  Built with
// -fmad=false, so each product is rounded on its own as in PyTorch; CUDA's
// exp and glibc's may still differ by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;  // segments of a shared timeline staged at once

struct LogFilterArgs {
  // inputs: timeline rows [R, S+1] / [R, S] / [R], ticks [G, M], tau [G],
  // span [2] = (t_lo, t_hi)
  const double* edges;
  const double* powers;
  const double* idle;
  const double* ticks;
  const double* tau;
  const double* span;
  // scratch [S+3, G]: entry state of each extended segment; output [G, M]
  double* states;
  double* out;
};

constexpr int kNumPointers = 8;

// extended edge k of a row: t_lo, the row's S + 1 edges, t_hi
__device__ __forceinline__ double ext_edge(const double* e_row, int64_t s,
                                           double t_lo, double t_hi,
                                           int64_t k) {
  return k == 0 ? t_lo : (k <= s + 1 ? e_row[k - 1] : t_hi);
}

// power of extended segment k: idle, the row's S powers, idle
__device__ __forceinline__ double ext_power(const double* p_row, double idle,
                                            int64_t s, int64_t k) {
  return (k == 0 || k == s + 1) ? idle : p_row[k - 1];
}

__device__ __forceinline__ double filter_step(double y, double dt, double sp,
                                              double tau) {
  return dt > 0.0 ? sp + (y - sp) * exp(-dt / tau) : y;
}

__global__ void __launch_bounds__(kThreads)
    log_filter_states_kernel(LogFilterArgs a, int64_t r, int64_t g,
                             int64_t s) {
  __shared__ double sh_end[kTile];  // end edge of each staged segment
  __shared__ double sh_pow[kTile];
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < g;
  const bool shared_tl = r == 1;
  const int64_t tr = (shared_tl || !live) ? 0 : row;
  const double* e_row = a.edges + tr * (s + 1);
  const double* p_row = a.powers + tr * s;
  const double idle = a.idle[tr];
  const double t_lo = a.span[0];
  const double t_hi = a.span[1];
  const double tau = live ? a.tau[row] : 1.0;
  const int64_t n_seg = s + 2;

  double y = idle;
  double e_prev = t_lo;
  if (live) a.states[row] = y;
  if (shared_tl) {
    // every thread of the block takes part in staging, live or not
    for (int64_t k0 = 0; k0 < n_seg; k0 += kTile) {
      const int nk = (int)(n_seg - k0 < kTile ? n_seg - k0 : kTile);
      __syncthreads();
      for (int i = threadIdx.x; i < nk; i += kThreads) {
        sh_end[i] = ext_edge(e_row, s, t_lo, t_hi, k0 + i + 1);
        sh_pow[i] = ext_power(p_row, idle, s, k0 + i);
      }
      __syncthreads();
      if (live) {
        for (int i = 0; i < nk; ++i) {
          const double e_next = sh_end[i];
          y = filter_step(y, e_next - e_prev, sh_pow[i], tau);
          e_prev = e_next;
          a.states[(k0 + i + 1) * g + row] = y;
        }
      }
    }
  } else if (live) {
    for (int64_t k = 0; k < n_seg; ++k) {
      const double e_next = ext_edge(e_row, s, t_lo, t_hi, k + 1);
      y = filter_step(y, e_next - e_prev, ext_power(p_row, idle, s, k), tau);
      e_prev = e_next;
      a.states[(k + 1) * g + row] = y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    log_filter_readings_kernel(LogFilterArgs a, int64_t r, int64_t g,
                               int64_t s, int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g * m) return;
  const int64_t row = i / m;
  const int64_t tr = r == 1 ? 0 : row;
  const double* e_row = a.edges + tr * (s + 1);
  const double t_lo = a.span[0];
  const double t_hi = a.span[1];
  const double t = a.ticks[i];

  // count of extended edges <= t (searchsorted right), exact comparisons
  int64_t lo = 0;
  int64_t hi = s + 3;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ext_edge(e_row, s, t_lo, t_hi, mid) <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int64_t k = lo - 1;
  k = k < 0 ? 0 : (k > s + 1 ? s + 1 : k);

  const double sp = ext_power(a.powers + tr * s, a.idle[tr], s, k);
  const double e = ext_edge(e_row, s, t_lo, t_hi, k);
  const double y = a.states[k * g + row];
  a.out[i] = sp + (y - sp) * exp(-(t - e) / a.tau[row]);
}

}  // namespace
}  // namespace repro_torch

using repro_torch::LogFilterArgs;

// ptrs: the 8 device pointers in LogFilterArgs field order.  Launches both
// phases on `stream` and returns the first launch error (0 on success).
extern "C" int log_filter_launch(void* const* ptrs, int64_t r, int64_t g,
                                 int64_t s, int64_t m, void* stream) {
  static_assert(sizeof(LogFilterArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "LogFilterArgs must be exactly the pointer list");
  LogFilterArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (g <= 0) return 0;
  const int64_t t = repro_torch::kThreads;
  repro_torch::log_filter_states_kernel<<<(unsigned)((g + t - 1) / t),
                                          repro_torch::kThreads, 0,
                                          (cudaStream_t)stream>>>(a, r, g, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m <= 0) return (int)err;
  repro_torch::log_filter_readings_kernel<<<(unsigned)((g * m + t - 1) / t),
                                            repro_torch::kThreads, 0,
                                            (cudaStream_t)stream>>>(a, r, g,
                                                                    s, m);
  return (int)cudaGetLastError();
}

extern "C" const char* log_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int log_filter_num_pointers() { return repro_torch::kNumPointers; }
