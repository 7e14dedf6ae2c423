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
// Design: one block per row.  Thread 0 finds j0 and j1 by binary search on
// the sorted row (the counting of the TPU kernel, in log2(M) loads); the
// block's threads stride over [j0, j1) with neighbouring threads on
// neighbouring samples, each summing its own terms in order; warp shuffles
// and then one pass over the warps' partial sums in shared memory reduce
// them in a fixed tree order, so a row's result does not change from run
// to run.  No atomics: every output has one writer.  The windowed sum
// differs from the reference's cum[j1] - cum[j0] only by rounding.
//
// Bound on an H100: memory.  Each input read once is N*M*16 + N*24 bytes
// (ts and vals, t0 and t1, the output written) over 3.35 TB/s; what the
// windows need is less, 16 bytes per selected sample plus 24 per row, and
// only the selected samples are read here (plus log2(M) loads of the
// search), against four to six f64 operations each.  A §5 trial is one
// [1, M] row with M of 1,000 to 7,000, so there the launch itself
// dominates; wide batches keep 132 SMs busy with one row per block.
// Built with -fmad=false, so each product is rounded on its own as in
// PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct StepArgs {
  // inputs: ts, vals [N, M], t0, t1 [N]; output [N]
  const double* ts;
  const double* vals;
  const double* t0;
  const double* t1;
  double* out;
};

constexpr int kNumPointers = 5;

// number of entries of the sorted row below x (or at most x): the
// searchsorted "left" / "right" of the reference, exact comparisons
__device__ __forceinline__ int64_t count_below(const double* row, int64_t m,
                                               double x, bool inclusive) {
  int64_t lo = 0;
  int64_t hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const double v = row[mid];
    if (inclusive ? v <= x : v < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    step_integrate_kernel(StepArgs a, int64_t m, int trapezoid) {
  __shared__ int64_t s_j[2];
  __shared__ double s_warp[kWarps];
  const int64_t row = blockIdx.x;
  const double* ts = a.ts + row * m;
  const double* vals = a.vals + row * m;
  const double t0 = a.t0[row];
  const double t1 = a.t1[row];

  if (threadIdx.x == 0) {
    s_j[0] = count_below(ts, m, t0, false);
    s_j[1] = count_below(ts, m, t1, true) - 1;
  }
  __syncthreads();
  const int64_t j0 = s_j[0];
  const int64_t j1 = s_j[1];

  double acc = 0.0;
  for (int64_t k = j0 + threadIdx.x; k < j1; k += kThreads) {
    const double nxt = ts[k + 1];
    const bool fin = isfinite(nxt);
    const double dt = (fin ? nxt : 0.0) - (fin ? ts[k] : 0.0);
    const double dens =
        trapezoid ? 0.5 * (vals[k] + (fin ? vals[k + 1] : 0.0)) : vals[k];
    acc += dens * dt;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();

  if (threadIdx.x == 0) {
    double core = 0.0;
    for (int w = 0; w < kWarps; ++w) core += s_warp[w];
    double r = 0.0;
    if (j1 >= j0 && j0 < m) {
      // here 0 <= j0 <= j1 <= M - 1
      r = core + vals[j1] * (t1 - ts[j1]);
    }
    a.out[row] = r;
  }
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
  StepArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (n <= 0 || m <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  repro_torch::step_integrate_kernel<<<(unsigned)n, repro_torch::kThreads, 0,
                                       (cudaStream_t)stream>>>(a, m,
                                                               trapezoid);
  return (int)cudaGetLastError();
}

extern "C" const char* step_integrate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int step_integrate_num_pointers() {
  return repro_torch::kNumPointers;
}
