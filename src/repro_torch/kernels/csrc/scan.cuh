// Warp-level scans shared by the two ingest kernels.
//
// One scan carries the four running quantities both kernels need along a
// device's samples: raw energy, corrected energy (sums), the number of
// reading changes (sum) and the index of the last change (max).  The
// identity is {0, 0, 0, -1}.
#pragma once

#include <stdint.h>

namespace repro_torch {

struct RunScan {
  double e;        // running raw energy
  double ec;       // running corrected energy
  long long n;     // reading changes so far
  long long last;  // index of the latest change, -1 before the first
};

__device__ __forceinline__ RunScan run_identity() {
  RunScan r;
  r.e = 0.0;
  r.ec = 0.0;
  r.n = 0;
  r.last = -1;
  return r;
}

// a (earlier) combined with b (later)
__device__ __forceinline__ RunScan run_combine(const RunScan& a,
                                               const RunScan& b) {
  RunScan r;
  r.e = a.e + b.e;
  r.ec = a.ec + b.ec;
  r.n = a.n + b.n;
  r.last = a.last > b.last ? a.last : b.last;
  return r;
}

__device__ __forceinline__ RunScan run_shfl_up(const RunScan& x, int delta) {
  RunScan r;
  r.e = __shfl_up_sync(0xffffffffu, x.e, delta);
  r.ec = __shfl_up_sync(0xffffffffu, x.ec, delta);
  r.n = __shfl_up_sync(0xffffffffu, x.n, delta);
  r.last = __shfl_up_sync(0xffffffffu, x.last, delta);
  return r;
}

__device__ __forceinline__ RunScan run_shfl(const RunScan& x, int lane) {
  RunScan r;
  r.e = __shfl_sync(0xffffffffu, x.e, lane);
  r.ec = __shfl_sync(0xffffffffu, x.ec, lane);
  r.n = __shfl_sync(0xffffffffu, x.n, lane);
  r.last = __shfl_sync(0xffffffffu, x.last, lane);
  return r;
}

// Inclusive scan within a full warp (all 32 lanes must call it).  Also
// returns the exclusive value (the identity on lane 0).
__device__ __forceinline__ RunScan warp_scan(RunScan x, RunScan* excl) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    RunScan y = run_shfl_up(x, o);
    if (lane >= o) x = run_combine(y, x);
  }
  RunScan prev = run_shfl_up(x, 1);
  *excl = lane == 0 ? run_identity() : prev;
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double warp_max(double x) {
  for (int o = 16; o > 0; o >>= 1) {
    double y = __shfl_down_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// The per-sample arithmetic of both kernels, written as the plain PyTorch
// version writes it (operation for operation, compiled without FMA
// contraction) so that every elementwise output is bitwise the same.
struct SampleMath {
  double vc;      // corrected reading
  double inc;     // raw energy increment
  double inc_c;   // corrected energy increment
  double w_inc;   // raw increment clipped to the window
  double w_inc_c; // corrected increment clipped to the (shifted) window
  bool change;    // reading differs from the previous sample
  bool out;       // corrected reading outside the envelope
};

__device__ __forceinline__ SampleMath sample_math(
    double t, double v, double pt, double pv, bool has, double gain,
    double offset, double tshift, double win_a, double win_b,
    double max_hold, double env_lo, double env_hi, bool trapezoid) {
  SampleMath s;
  s.vc = (v - offset) / gain;
  const double pvc = (pv - offset) / gain;
  const double dt = t - pt;
  const double hold = fmin(dt, max_hold);
  const double dens_r = trapezoid ? 0.5 * (pv + v) : pv;
  const double dens_c = trapezoid ? 0.5 * (pvc + s.vc) : pvc;
  s.inc = has ? dens_r * hold : 0.0;
  s.inc_c = has ? dens_c * hold : 0.0;
  s.w_inc = (has && pt >= win_a)
                ? dens_r * fmax(fmin(pt + hold, win_b) - pt, 0.0)
                : 0.0;
  const double pts = pt - tshift;
  s.w_inc_c = (has && pts >= win_a)
                  ? dens_c * fmax(fmin(pts + hold, win_b) - pts, 0.0)
                  : 0.0;
  s.change = has && (v != pv);
  s.out = (s.vc < env_lo) || (s.vc > env_hi);
  return s;
}

}  // namespace repro_torch
