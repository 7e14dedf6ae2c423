// stream_ingest_grid: the monitor's clean-slab fast path, for Hopper.
//
// Replaces the TPU kernel `_ingest_grid_kernel` (`_stream_ingest_grid_impl`
// / `stream_ingest_grid`,
// src/repro/core/engine_backend/pallas_backend.py:276,353,390).  That
// kernel took 4096-device row blocks of the [D, M] slab into VMEM whole and
// ran row cumsums, a row `cummax` over change columns and the per-device
// reductions as vector operations on the block.
//
// Here one warp owns one device row and walks its M columns in chunks of
// 32: a warp-shuffle inclusive scan of (raw energy, corrected energy,
// change count, last change column) per chunk, with the carry held in
// registers from one chunk to the next, and per-lane partial sums of the
// window energies and of the corrected-reading moments, reduced across the
// warp at the end.  No shared memory and no block barrier; eight rows per
// block.  The shared time axis ts [M] is read by every warp and stays in
// L2 and L1.
//
// Bound on an H100: memory.  Per sample it reads v (8 B) and writes cum_e,
// cum_ec, run_dur (24 B) and run_rec (1 B), about 33 B/sample against
// about 35 f64 operations.  What the design does about it: one pass over
// the slab, neighbouring lanes on neighbouring columns so every load and
// store is coalesced, the previous column read from L1.
//
// No atomics: every output has exactly one writer, so results are the same
// from run to run.  Row sums differ from the plain version only by
// summation order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scan.cuh"

namespace repro_torch {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

struct GridArgs {
  // inputs: shared axis [M], readings [D, M], per device [D]
  const double* ts;
  const double* v;
  const double* prev_t;
  const double* prev_v;
  const bool* has_prev;
  const double* run_t;
  const int64_t* n_changes;
  const double* gain;
  const double* offset;
  const double* tshift;
  const double* win_a;
  const double* win_b;
  const double* max_hold;
  const double* env_lo;
  const double* env_hi;
  // outputs per device [D]
  double* new_v;
  double* new_run_t;
  int64_t* new_n_changes;
  double* d_energy;
  double* d_energy_corr;
  double* d_win;
  double* d_win_corr;
  double* sum_vc;
  double* sum_vc2;
  double* sum_abs_vc;
  double* max_abs_vc;
  int64_t* n_out;
  // outputs per sample [D, M]
  double* cum_e;
  double* cum_ec;
  double* run_dur;
  bool* run_rec;
};

constexpr int kNumPointers = 31;

__global__ void __launch_bounds__(kThreads)
stream_ingest_grid_kernel(GridArgs a, int64_t d, int64_t m, int trapezoid) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= d) return;  // the whole warp leaves together

  const double prev_t = a.prev_t[row];
  const double prev_v = a.prev_v[row];
  const bool has_prev = a.has_prev[row];
  const double run_t = a.run_t[row];
  const long long n_changes = a.n_changes[row];
  const double gain = a.gain[row];
  const double offset = a.offset[row];
  const double tshift = a.tshift[row];
  const double win_a = a.win_a[row];
  const double win_b = a.win_b[row];
  const double max_hold = a.max_hold[row];
  const double env_lo = a.env_lo[row];
  const double env_hi = a.env_hi[row];
  const bool trap = trapezoid != 0;

  const double* vrow = a.v + row * m;
  double* cum_e = a.cum_e + row * m;
  double* cum_ec = a.cum_ec + row * m;
  double* run_dur = a.run_dur + row * m;
  bool* run_rec = a.run_rec + row * m;

  RunScan carry = run_identity();
  double s_win = 0.0, s_win_c = 0.0, s_vc = 0.0, s_vc2 = 0.0, s_abs = 0.0;
  double s_max = 0.0;
  long long s_out = 0;

  for (int64_t c0 = 0; c0 < m; c0 += 32) {
    const int64_t j = c0 + lane;
    const bool valid = j < m;
    RunScan x = run_identity();
    SampleMath s;
    double t = 0.0;
    if (valid) {
      t = a.ts[j];
      const double v = vrow[j];
      const bool first = j == 0;
      const double pt = first ? prev_t : a.ts[j - 1];
      const double pv = first ? prev_v : vrow[j - 1];
      const bool has = first ? has_prev : true;
      s = sample_math(t, v, pt, pv, has, gain, offset, tshift, win_a, win_b,
                      max_hold, env_lo, env_hi, trap);
      x.e = s.inc;
      x.ec = s.inc_c;
      x.n = s.change ? 1 : 0;
      x.last = s.change ? j : -1;
      const double av = fabs(s.vc);
      s_win += s.w_inc;
      s_win_c += s.w_inc_c;
      s_vc += s.vc;
      s_vc2 += s.vc * s.vc;
      s_abs += av;
      s_max = av > s_max ? av : s_max;
      s_out += s.out ? 1 : 0;
    }

    RunScan excl_w;
    const RunScan incl_w = warp_scan(x, &excl_w);
    const RunScan incl = run_combine(carry, incl_w);
    const RunScan excl = run_combine(carry, excl_w);
    if (valid) {
      cum_e[j] = incl.e;
      cum_ec[j] = incl.ec;
      // the previous change in this row opens the run this one closes
      const double run_start = excl.last >= 0 ? a.ts[excl.last] : run_t;
      run_dur[j] = s.change ? t - run_start : 0.0;
      run_rec[j] = s.change && (n_changes + excl.n >= 1);
    }
    carry = run_shfl(incl, 31);
  }

  s_win = warp_sum(s_win);
  s_win_c = warp_sum(s_win_c);
  s_vc = warp_sum(s_vc);
  s_vc2 = warp_sum(s_vc2);
  s_abs = warp_sum(s_abs);
  s_max = warp_max(s_max);
  s_out = warp_sum(s_out);
  if (lane == 0) {
    a.new_v[row] = m > 0 ? vrow[m - 1] : prev_v;
    a.new_run_t[row] = carry.last >= 0 ? a.ts[carry.last] : run_t;
    a.new_n_changes[row] = n_changes + carry.n;
    a.d_energy[row] = carry.e;
    a.d_energy_corr[row] = carry.ec;
    a.d_win[row] = s_win;
    a.d_win_corr[row] = s_win_c;
    a.sum_vc[row] = s_vc;
    a.sum_vc2[row] = s_vc2;
    a.sum_abs_vc[row] = s_abs;
    a.max_abs_vc[row] = s_max;
    a.n_out[row] = s_out;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::GridArgs;

// ptrs: the 31 device pointers in GridArgs field order.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stream_ingest_grid_launch(void* const* ptrs, int64_t d,
                                         int64_t m, int trapezoid,
                                         void* stream) {
  static_assert(sizeof(GridArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "GridArgs must be exactly the pointer list");
  GridArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (d > 0) {
    const int64_t blocks =
        (d + repro_torch::kWarpsPerBlock - 1) / repro_torch::kWarpsPerBlock;
    repro_torch::stream_ingest_grid_kernel<<<(unsigned)blocks,
                                             repro_torch::kThreads, 0,
                                             (cudaStream_t)stream>>>(
        a, d, m, trapezoid);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* stream_ingest_grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int stream_ingest_grid_num_pointers() {
  return repro_torch::kNumPointers;
}
