// stream_ingest: the streaming monitor's general slab kernel, for Hopper.
//
// Replaces the TPU kernel `_ingest1d_kernel` with its jax prologue and
// epilogue (`_stream_ingest_impl` / `stream_ingest`,
// src/repro/core/engine_backend/pallas_backend.py:99,154,238).  That
// kernel ran a global cumsum over the flat slab in 32768-sample blocks,
// carried in VMEM from one sequential grid step to the next, and left the
// group re-basing, the segment sums and the run tracking to XLA.
//
// Here blocks run in parallel, so nothing carries between them: one
// thread block owns one device group (the samples start_idx[g] ..
// end_idx[g], sorted by time) and walks it in chunks of blockDim.  Each
// chunk does one block-wide inclusive scan of (raw energy, corrected
// energy, change count, last change index); the carry into the next chunk
// stays in shared memory.  The block writes the group's 14 outputs
// itself (the reference's 11 plus the reading moments Σvc², Σ|vc| and
// max|vc| that the per-label statistics need), so the whole epilogue of
// the TPU version is gone and the slab is read once.  The `seg` and
// `first` arrays of the plain version are implied by start_idx/end_idx
// and are not read.
//
// Bound on an H100: memory.  Per sample it reads t and v (16 B) and writes
// cum_e, cum_ec, vc, run_dur (32 B) and run_rec (1 B), about 49 B/sample
// against about 35 f64 operations.  What the design does about it: one
// pass, every per-sample value produced where it is used, loads of the
// previous sample served from L1.  Groups of very different sizes load
// the SMs unevenly; balancing them is left to a later change.
//
// No atomics: every output has exactly one writer, so results are the
// same from run to run.  Energies differ from the plain version only by
// summation order (the plain version re-bases a slab-wide prefix).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scan.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct IngestArgs {
  // per sample [K]
  const double* t;
  const double* v;
  // per group [U]
  const int64_t* start_idx;
  const int64_t* end_idx;
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
  // outputs per group [U]
  double* new_t;
  double* new_v;
  double* new_run_t;
  int64_t* new_n_changes;
  int64_t* counts;
  double* d_energy;
  double* d_energy_corr;
  double* d_win;
  double* d_win_corr;
  double* sum_vc;
  double* sum_vc2;
  double* sum_abs_vc;
  double* max_abs_vc;
  int64_t* n_out;
  // outputs per sample [K]
  double* cum_e;
  double* cum_ec;
  double* vc;
  double* run_dur;
  bool* run_rec;
};

constexpr int kNumPointers = 36;

// Six resident blocks per SM cap the kernel at 80 registers (104
// uncapped, which left room for four); the few bytes it then spills cost
// less than the lost occupancy did.
__global__ void __launch_bounds__(kThreads, 6)
stream_ingest_kernel(IngestArgs a, int trapezoid) {
  __shared__ RunScan warp_tot[kWarps];
  __shared__ RunScan carry_s;
  __shared__ double red_d[6][kWarps];
  __shared__ long long red_n[kWarps];

  const int64_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int64_t start = a.start_idx[g];
  const int64_t end = a.end_idx[g];
  const double prev_t = a.prev_t[g];
  const double prev_v = a.prev_v[g];
  const bool has_prev = a.has_prev[g];
  const double run_t = a.run_t[g];
  const long long n_changes = a.n_changes[g];
  const double gain = a.gain[g];
  const double offset = a.offset[g];
  const double tshift = a.tshift[g];
  const double win_a = a.win_a[g];
  const double win_b = a.win_b[g];
  const double max_hold = a.max_hold[g];
  const double env_lo = a.env_lo[g];
  const double env_hi = a.env_hi[g];
  const bool trap = trapezoid != 0;

  RunScan carry = run_identity();
  double s_win = 0.0, s_win_c = 0.0, s_vc = 0.0, s_vc2 = 0.0, s_abs = 0.0;
  double s_max = 0.0;
  long long s_out = 0;

  for (int64_t c0 = start; c0 <= end; c0 += kThreads) {
    const int64_t j = c0 + tid;
    const bool valid = j <= end;
    RunScan x = run_identity();
    SampleMath s;
    double t = 0.0;
    if (valid) {
      t = a.t[j];
      const double v = a.v[j];
      const bool first = j == start;
      const double pt = first ? prev_t : a.t[j - 1];
      const double pv = first ? prev_v : a.v[j - 1];
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

    // block-wide scan: warp scans, then the warp totals and the carry
    RunScan excl_w;
    const RunScan incl_w = warp_scan(x, &excl_w);
    if (lane == 31) warp_tot[warp] = incl_w;
    __syncthreads();
    RunScan base = carry;
    for (int w = 0; w < warp; ++w) base = run_combine(base, warp_tot[w]);
    const RunScan incl = run_combine(base, incl_w);
    const RunScan excl = run_combine(base, excl_w);

    if (valid) {
      a.cum_e[j] = incl.e;
      a.cum_ec[j] = incl.ec;
      a.vc[j] = s.vc;
      // the previous change in this group opens the run this one closes
      const double run_start = excl.last >= 0 ? a.t[excl.last] : run_t;
      a.run_dur[j] = s.change ? t - run_start : 0.0;
      a.run_rec[j] = s.change && (n_changes + excl.n >= 1);
    }
    // the last thread's inclusive value is the chunk's running total
    if (tid == kThreads - 1) carry_s = incl;
    __syncthreads();
    carry = carry_s;
  }

  // group reductions of the window energies, the reading moments and the
  // envelope count
  s_win = warp_sum(s_win);
  s_win_c = warp_sum(s_win_c);
  s_vc = warp_sum(s_vc);
  s_vc2 = warp_sum(s_vc2);
  s_abs = warp_sum(s_abs);
  s_max = warp_max(s_max);
  s_out = warp_sum(s_out);
  if (lane == 0) {
    red_d[0][warp] = s_win;
    red_d[1][warp] = s_win_c;
    red_d[2][warp] = s_vc;
    red_d[3][warp] = s_vc2;
    red_d[4][warp] = s_abs;
    red_d[5][warp] = s_max;
    red_n[warp] = s_out;
  }
  __syncthreads();
  if (tid == 0) {
    double w = 0.0, wc = 0.0, sv = 0.0, sv2 = 0.0, sa = 0.0, mx = 0.0;
    long long no = 0;
    for (int i = 0; i < kWarps; ++i) {
      w += red_d[0][i];
      wc += red_d[1][i];
      sv += red_d[2][i];
      sv2 += red_d[3][i];
      sa += red_d[4][i];
      mx = red_d[5][i] > mx ? red_d[5][i] : mx;
      no += red_n[i];
    }
    a.new_t[g] = a.t[end];
    a.new_v[g] = a.v[end];
    a.new_run_t[g] = carry.last >= 0 ? a.t[carry.last] : run_t;
    a.new_n_changes[g] = n_changes + carry.n;
    a.counts[g] = end - start + 1;
    a.d_energy[g] = carry.e;
    a.d_energy_corr[g] = carry.ec;
    a.d_win[g] = w;
    a.d_win_corr[g] = wc;
    a.sum_vc[g] = sv;
    a.sum_vc2[g] = sv2;
    a.sum_abs_vc[g] = sa;
    a.max_abs_vc[g] = mx;
    a.n_out[g] = no;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::IngestArgs;

// ptrs: the 36 device pointers in IngestArgs field order.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stream_ingest_launch(void* const* ptrs, int64_t n_groups,
                                    int trapezoid, void* stream) {
  static_assert(sizeof(IngestArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "IngestArgs must be exactly the pointer list");
  IngestArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (n_groups > 0) {
    repro_torch::stream_ingest_kernel<<<(unsigned)n_groups,
                                        repro_torch::kThreads, 0,
                                        (cudaStream_t)stream>>>(a, trapezoid);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* stream_ingest_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int stream_ingest_num_pointers() {
  return repro_torch::kNumPointers;
}
