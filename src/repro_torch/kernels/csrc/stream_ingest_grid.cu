// stream_ingest_grid: the monitor's clean-slab fast path, for Hopper.
//
// Replaces the TPU kernel `_ingest_grid_kernel` (`_stream_ingest_grid_impl`
// / `stream_ingest_grid`,
// src/repro/core/engine_backend/pallas_backend.py:276,353,390).  That
// kernel took 4096-device row blocks of the [D, M] slab into VMEM whole and
// ran row cumsums, a row `cummax` over change columns and the per-device
// reductions as vector operations on the block.
//
// Bound on an H100: bytes.  Per sample it reads v (8 B) and writes cum_e,
// cum_ec, run_dur (24 B) and run_rec (1 B), 33 B a sample: at the
// monitor's [100000, 500] slab 1.65 GB, 0.498 ms at 3.35 TB/s.  Its ~35
// f64 operations a sample need 0.05 ms at 34 TFLOP/s.
//
// The first design let one warp walk a row in 32-column chunks with a
// 5-step shuffle scan of (raw energy, corrected energy, change count,
// last change) every 32 samples and no `__restrict__`: one chunk of loads
// in flight a warp, a DRAM round trip and ~56 dependent shuffles per 32
// samples.  ptxas gave it 87 registers; at 8 warps a block the register
// file held 2 blocks (16 warps) an SM.  1.02 ms at [100000, 500] on an
// H100 80GB HBM3 at 700 W, 49% of the bound.
//
// This design keeps more bytes in flight and takes the scan off the path
// between loads:
//
// * Persistent blocks of 4 warps, as many as reside at once (the launch
//   asks the occupancy calculator).  A warp owns one row at a time and
//   walks its rows in turn (row += warps in the grid); the row's state and
//   the carry between tiles stay in registers.
// * A ring of input tiles in shared memory, 3 stages a warp.  A tile is
//   128 columns of the row's readings and of ts.  A stage is filled by
//   cp.async.bulk (1-D TMA) where the span's address and length are
//   multiples of 16 bytes, else by 8-byte cp.async (odd M puts every other
//   row 8 bytes off); both complete on the stage's mbarrier.  The ring
//   runs on across rows, so the next row's first tiles load while a row
//   ends; a row's 13 per-device inputs are loaded one row ahead.  While
//   the warp works on tile i, tiles i+1 and i+2 load.
// * Each lane owns 4 consecutive columns.  Pass 1 runs the per-sample
//   arithmetic on them in order (the column before comes from the previous
//   lane by shuffle, the previous tile or prev_t/prev_v) and folds them
//   serially, branch-free: the lane's running sums, its change count and
//   last change, its moment sums, and run_dur/run_rec of every change but
//   the lane's first.  One `warp_scan` of the lane totals a tile gives
//   each lane its exclusive prefix: cum_e and cum_ec are prefix plus
//   running sum, and the lane's first change closes the run that the
//   latest change before the lane opened, whose time comes from the tile
//   in shared memory or is carried from an earlier tile.  Nothing is
//   gathered from ts.
// * A lane's run is read from and staged to shared memory as 16-byte units
//   rotated by (lane / 4) % 2, so the 8 lanes of a quarter warp hit 8
//   bank groups; selects undo the rotation in registers.
// * The three f64 outputs of a tile leave by TMA bulk stores from the
//   staging where aligned (the warp goes on to the next tile), else by the
//   warp's 8-byte stores; run_rec in the widest words its address allows.
//   Every pointer is `__restrict__`.
//
// The per-sample arithmetic is scan.cuh's sample_math, as in the flat
// kernel.  ptxas gives this design 154 registers (the launch bounds ask
// for 3 blocks an SM, at most 168) and no spills; shared memory allows 6
// blocks, so 12 warps an SM.  Kernels that only move the same bytes ran
// faster as one flat stream than in this row order, and faster with more
// warps an SM than these registers allow (PERF.md): the row order and the
// residency set its time now.
//
// No atomics: every output has exactly one writer, so results are the same
// from run to run.  Row sums differ from the plain version only by
// summation order; every other output is bitwise the same.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scan.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;         // warps a block, one row each at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;     // resident blocks an SM (<= 168 registers)
constexpr int kRun = 4;           // consecutive columns a lane owns
constexpr int kTile = 32 * kRun;  // columns a tile
constexpr int kUnits = kRun / 2;  // a lane's 16-byte units
constexpr int kGroup = 8 / kUnits;  // lanes whose units share bank groups
constexpr int kStages = 3;        // input ring, per warp
constexpr int kParams = 13;       // per-device inputs, prev_t .. env_hi
constexpr int kMaxDevices = 64;   // launch configurations cached by device
constexpr unsigned kFull = 0xffffffffu;

struct GridArgs {
  // inputs: shared axis [M], readings [D, M], per device [D]
  const double* __restrict__ ts;
  const double* __restrict__ v;
  const double* __restrict__ prev_t;
  const double* __restrict__ prev_v;
  const bool* __restrict__ has_prev;
  const double* __restrict__ run_t;
  const int64_t* __restrict__ n_changes;
  const double* __restrict__ gain;
  const double* __restrict__ offset;
  const double* __restrict__ tshift;
  const double* __restrict__ win_a;
  const double* __restrict__ win_b;
  const double* __restrict__ max_hold;
  const double* __restrict__ env_lo;
  const double* __restrict__ env_hi;
  // outputs per device [D]
  double* __restrict__ new_v;
  double* __restrict__ new_run_t;
  int64_t* __restrict__ new_n_changes;
  double* __restrict__ d_energy;
  double* __restrict__ d_energy_corr;
  double* __restrict__ d_win;
  double* __restrict__ d_win_corr;
  double* __restrict__ sum_vc;
  double* __restrict__ sum_vc2;
  double* __restrict__ sum_abs_vc;
  double* __restrict__ max_abs_vc;
  int64_t* __restrict__ n_out;
  // outputs per sample [D, M]
  double* __restrict__ cum_e;
  double* __restrict__ cum_ec;
  double* __restrict__ run_dur;
  bool* __restrict__ run_rec;
};

constexpr int kNumPointers = 31;

// one warp's shared memory
struct alignas(16) WarpSmem {
  double v[kStages][kTile];  // readings, one tile a stage
  double t[kStages][kTile];  // ts at the same columns
  double out[3][kTile];      // cum_e, cum_ec, run_dur staged for the store
  unsigned char rec[kTile];  // run_rec staged, a lane's flags together
  uint64_t bar[kStages];     // a stage's fill completes here
};

constexpr int kSmemBytes = kWarps * (int)sizeof(WarpSmem);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D TMA: `bytes` (a multiple of 16) from global `src` (16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 1-D TMA store of `bytes` (a multiple of 16) to global `dst` (16-byte
// aligned) from shared memory, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and written global memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes before, the async proxy's reads after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Copy n columns (1 <= n <= kTile) of a row's readings `v` and of `t` into
// a stage.  The stage's barrier expects 33 arrivals a fill: one from lane
// 0 (with the bulk copies' bytes) and one from each lane's cp.async.
__device__ __forceinline__ void fill(WarpSmem& w, int stage, const double* v,
                                     const double* t, int n, int lane) {
  const uint32_t bar = smem_u32(&w.bar[stage]);
  const uint32_t bytes = 8u * (uint32_t)n;
  const bool bulk_v = (((uintptr_t)v | bytes) & 15) == 0;
  const bool bulk_t = (((uintptr_t)t | bytes) & 15) == 0;
  if (lane == 0) {
    const uint32_t tx = (bulk_v ? bytes : 0u) + (bulk_t ? bytes : 0u);
    if (tx) {
      mbar_arrive_expect_tx(bar, tx);
    } else {
      mbar_arrive(bar);
    }
    if (bulk_v) bulk_load(smem_u32(w.v[stage]), v, bytes, bar);
    if (bulk_t) bulk_load(smem_u32(w.t[stage]), t, bytes, bar);
  }
  if (!bulk_v) {
    for (int i = lane; i < n; i += 32) {
      cp_async8(smem_u32(w.v[stage] + i), v + i);
    }
  }
  if (!bulk_t) {
    for (int i = lane; i < n; i += 32) {
      cp_async8(smem_u32(w.t[stage] + i), t + i);
    }
  }
  cp_async_arrive(bar);
}

// a[k] <- a[(k + r) % kUnits] for a per-lane r, as rounds of selects
__device__ __forceinline__ void rotate(double2 (&a)[kUnits], int r) {
#pragma unroll
  for (int step = 1; step < kUnits; step <<= 1) {
    double2 b[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const double2 c = a[(k + step) % kUnits];
      b[k].x = (r & step) ? c.x : a[k].x;
      b[k].y = (r & step) ? c.y : a[k].y;
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) a[k] = b[k];
  }
}

// the lane's kRun columns of a tile as the copy left it, in order: unit u
// of the lane's run is read at step (u - s) % kUnits, s the lane's group
__device__ __forceinline__ void load_run(const double* tile, int lane,
                                         double (&x)[kRun]) {
  const int s = (lane / kGroup) % kUnits;
  double2 a[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    a[u] = *reinterpret_cast<const double2*>(tile + kRun * lane +
                                             2 * ((u + s) % kUnits));
  }
  rotate(a, (kUnits - s) % kUnits);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    x[2 * u] = a[u].x;
    x[2 * u + 1] = a[u].y;
  }
}

// a lane's run into a tile in shared memory, each value plus `base` where
// kAdd, its units written rotated as load_run reads them
template <bool kAdd>
__device__ __forceinline__ void stage_run(double* tile, int lane,
                                          const double (&x)[kRun],
                                          double base) {
  const int s = (lane / kGroup) % kUnits;
  double2 a[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    a[u] = kAdd ? make_double2(base + x[2 * u], base + x[2 * u + 1])
                : make_double2(x[2 * u], x[2 * u + 1]);
  }
  rotate(a, s);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    *reinterpret_cast<double2*>(tile + kRun * lane +
                                2 * ((u + s) % kUnits)) = a[u];
  }
}

// n staged columns to global memory by the warp, 8 bytes a lane,
// neighbouring lanes on neighbouring addresses (a tile the bulk store
// cannot take: dst or n*8 not a multiple of 16 bytes)
__device__ __forceinline__ void store_tile(double* dst, const double* src,
                                           int n, int lane) {
  for (int c = lane; c < n; c += 32) dst[c] = src[c];
}

// n staged flag bytes to global memory in the widest words dst allows
__device__ __forceinline__ void store_flags(unsigned char* dst,
                                            const unsigned char* src, int n,
                                            int lane) {
  const uintptr_t p = (uintptr_t)dst;
  int done = 0;
  if ((p & 7) == 0) {
    for (int q = lane; q < n / 8; q += 32) {
      reinterpret_cast<uint64_t*>(dst)[q] =
          reinterpret_cast<const uint64_t*>(src)[q];
    }
    done = n & ~7;
  } else if ((p & 3) == 0) {
    for (int q = lane; q < n / 4; q += 32) {
      reinterpret_cast<uint32_t*>(dst)[q] =
          reinterpret_cast<const uint32_t*>(src)[q];
    }
    done = n & ~3;
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = src[i];
}

// per-device input k (prev_t .. env_hi, in GridArgs order) of a row, as
// 64 bits
__device__ __forceinline__ uint64_t load_param(const GridArgs& a, int k,
                                               int64_t row) {
  switch (k) {
    case 0: return (uint64_t)__double_as_longlong(a.prev_t[row]);
    case 1: return (uint64_t)__double_as_longlong(a.prev_v[row]);
    case 2: return a.has_prev[row] ? 1u : 0u;
    case 3: return (uint64_t)__double_as_longlong(a.run_t[row]);
    case 4: return (uint64_t)a.n_changes[row];
    case 5: return (uint64_t)__double_as_longlong(a.gain[row]);
    case 6: return (uint64_t)__double_as_longlong(a.offset[row]);
    case 7: return (uint64_t)__double_as_longlong(a.tshift[row]);
    case 8: return (uint64_t)__double_as_longlong(a.win_a[row]);
    case 9: return (uint64_t)__double_as_longlong(a.win_b[row]);
    case 10: return (uint64_t)__double_as_longlong(a.max_hold[row]);
    case 11: return (uint64_t)__double_as_longlong(a.env_lo[row]);
    case 12: return (uint64_t)__double_as_longlong(a.env_hi[row]);
    default: return 0;
  }
}

__device__ __forceinline__ double param_f64(uint64_t held, int k) {
  return __longlong_as_double((long long)__shfl_sync(kFull, held, k));
}

template <bool kTrap>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stream_ingest_grid_kernel(const GridArgs a, int64_t d, int64_t m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  WarpSmem& w = reinterpret_cast<WarpSmem*>(smem)[threadIdx.x >> 5];
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  const int64_t row0 = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row0 >= d) return;  // the whole warp leaves together
  const int64_t rows = (d - 1 - row0) / stride + 1;
  const int64_t tiles = (m + kTile - 1) / kTile;  // a row
  const int64_t fills = rows * tiles;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&w.bar[s]), 33);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // fills go in order: the warp's rows in turn, each row's tiles in turn,
  // stage after stage
  int64_t issued = 0, fill_row = row0, fill_c0 = 0;
  int fill_stage = 0;
  auto issue = [&]() {
    const int n = (int)(m - fill_c0 < kTile ? m - fill_c0 : kTile);
    fill(w, fill_stage, a.v + fill_row * m + fill_c0, a.ts + fill_c0, n,
         lane);
    ++issued;
    fill_c0 += kTile;
    if (fill_c0 >= m) {
      fill_c0 = 0;
      fill_row += stride;
    }
    fill_stage = fill_stage + 1 == kStages ? 0 : fill_stage + 1;
  };
  for (int s = 0; s < kStages && issued < fills; ++s) issue();

  uint64_t next = lane < kParams ? load_param(a, lane, row0) : 0;
  int stage = 0;           // the stage the next tile is in
  uint32_t parity = 0;     // and the phase of its barrier
  for (int64_t i = 0; i < rows; ++i) {
    const int64_t row = row0 + i * stride;
    const uint64_t held = next;
    if (i + 1 < rows && lane < kParams) {
      next = load_param(a, lane, row + stride);
    }
    const double prev_t = param_f64(held, 0);
    const double prev_v = param_f64(held, 1);
    const bool has_prev = __shfl_sync(kFull, held, 2) != 0;
    const double run_t = param_f64(held, 3);
    const long long n_changes = (long long)__shfl_sync(kFull, held, 4);
    const double gain = param_f64(held, 5);
    const double offset = param_f64(held, 6);
    const double tshift = param_f64(held, 7);
    const double win_a = param_f64(held, 8);
    const double win_b = param_f64(held, 9);
    const double max_hold = param_f64(held, 10);
    const double env_lo = param_f64(held, 11);
    const double env_hi = param_f64(held, 12);

    RunScan carry = run_identity();  // the row up to the tile
    double base_t = run_t;  // time of the latest change before the tile
    double c_t = prev_t, c_v = prev_v;  // the column before the tile
    bool c_has = has_prev;
    double s_win = 0.0, s_win_c = 0.0, s_vc = 0.0, s_vc2 = 0.0, s_abs = 0.0;
    double s_max = 0.0;
    long long s_out = 0;

    for (int64_t c0 = 0; c0 < m; c0 += kTile) {
      const int n = (int)(m - c0 < kTile ? m - c0 : kTile);
      const int nv = n - kRun * lane < 0 ? 0 : (n - kRun * lane < kRun
                                                ? n - kRun * lane : kRun);
      const double* st = w.t[stage];
      const double* sv = w.v[stage];
      mbar_wait(smem_u32(&w.bar[stage]), parity);
      double tt[kRun], vv[kRun];
      load_run(st, lane, tt);
      load_run(sv, lane, vv);
      const double up_t = __shfl_up_sync(kFull, tt[kRun - 1], 1);
      const double up_v = __shfl_up_sync(kFull, vv[kRun - 1], 1);

      // pass 1: the lane's samples in order, folded serially.  Columns
      // past the tile's end go through with has = false (no increment, no
      // change) and count in no moment.  lc_e/lc_ec hold the lane's
      // running sums; a change after an earlier one in the lane gets its
      // run_dur and run_rec here, the lane's first change after the scan.
      double lc_e[kRun], lc_ec[kRun], rd[kRun];
      double e_run = 0.0, ec_run = 0.0, last_t = 0.0, first_t = 0.0;
      int last_j = -1, first_j = -1, n_lane = 0, out_lane = 0;
      uint32_t rec = 0;  // byte j: run_rec of column j
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const bool valid = j < nv;
        const SampleMath s = sample_math(
            tt[j], vv[j], j ? tt[j - 1] : (lane ? up_t : c_t),
            j ? vv[j - 1] : (lane ? up_v : c_v),
            valid && (j || lane || c_has), gain, offset, tshift, win_a,
            win_b, max_hold, env_lo, env_hi, kTrap);
        e_run += s.inc;
        ec_run += s.inc_c;
        lc_e[j] = e_run;
        lc_ec[j] = ec_run;
        const bool later = s.change && last_j >= 0;
        rd[j] = later ? tt[j] - last_t : 0.0;
        rec |= (uint32_t)later << (8 * j);
        first_t = s.change && last_j < 0 ? tt[j] : first_t;
        first_j = s.change && last_j < 0 ? j : first_j;
        last_t = s.change ? tt[j] : last_t;
        last_j = s.change ? j : last_j;
        n_lane += s.change ? 1 : 0;
        const double vc = valid ? s.vc : 0.0;
        const double av = fabs(vc);
        s_win += s.w_inc;
        s_win_c += s.w_inc_c;
        s_vc += vc;
        s_vc2 += vc * vc;
        s_abs += av;
        s_max = av > s_max ? av : s_max;
        out_lane += valid && s.out ? 1 : 0;
      }
      s_out += out_lane;

      // one scan of the lane totals
      RunScan x;
      x.e = e_run;
      x.ec = ec_run;
      x.n = n_lane;
      x.last = last_j >= 0 ? c0 + kRun * lane + last_j : -1;
      RunScan excl_w;
      warp_scan(x, &excl_w);
      const RunScan excl = run_combine(carry, excl_w);

      // the lane's first change closes the run the latest change before
      // the lane opened (in this tile, in an earlier one, or run_t)
      if (first_j >= 0) {
        const double start =
            excl_w.last >= 0 ? st[excl_w.last - c0] : base_t;
        const double dur = first_t - start;
#pragma unroll
        for (int j = 0; j < kRun; ++j) rd[j] = j == first_j ? dur : rd[j];
      }
      const uint32_t chg = rec | (first_j >= 0 ? 1u << (8 * first_j) : 0u);
      long long before = n_changes + excl.n;  // changes before the lane
      if (before >= 1) {
        rec = chg;
      } else {  // a carried count below 1: counted change by change
        rec = 0;
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if ((chg >> (8 * j)) & 1) {
            rec |= (uint32_t)(before >= 1) << (8 * j);
            ++before;
          }
        }
      }

      RunScan mine;  // the row through the lane's last column
      mine.e = excl.e + lc_e[kRun - 1];
      mine.ec = excl.ec + lc_ec[kRun - 1];
      mine.n = excl.n + x.n;
      mine.last = excl.last > x.last ? excl.last : x.last;
      carry = run_shfl(mine, (n - 1) / kRun);  // the tile's last column
      if (carry.last >= c0) base_t = st[carry.last - c0];
      c_t = st[n - 1];
      c_v = sv[n - 1];
      c_has = true;

      if (lane == 0) bulk_wait_read();
      __syncwarp();  // the previous tile's staged values have been read
      stage_run<true>(w.out[0], lane, lc_e, excl.e);
      stage_run<true>(w.out[1], lane, lc_ec, excl.ec);
      stage_run<false>(w.out[2], lane, rd, 0.0);
      *reinterpret_cast<uint32_t*>(w.rec + kRun * lane) = rec;
      fence_proxy_async();
      __syncwarp();  // the stage is read and the staging written
      if (issued < fills) issue();  // refill this stage
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1u;
      }

      const int64_t off = row * m + c0;
      double* const dsts[3] = {a.cum_e + off, a.cum_ec + off,
                               a.run_dur + off};
      const bool bulk = (((uintptr_t)dsts[0] | (uintptr_t)dsts[1] |
                          (uintptr_t)dsts[2] | (8u * n)) & 15) == 0;
      if (bulk) {
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            bulk_store(dsts[k], smem_u32(w.out[k]), 8u * n);
          }
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) store_tile(dsts[k], w.out[k], n, lane);
      }
      store_flags(reinterpret_cast<unsigned char*>(a.run_rec + off), w.rec,
                  n, lane);
    }

    s_win = warp_sum(s_win);
    s_win_c = warp_sum(s_win_c);
    s_vc = warp_sum(s_vc);
    s_vc2 = warp_sum(s_vc2);
    s_abs = warp_sum(s_abs);
    s_max = warp_max(s_max);
    s_out = warp_sum(s_out);
    if (lane == 0) {
      a.new_v[row] = c_v;
      a.new_run_t[row] = base_t;
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
  // the block's shared memory lives until the bulk stores have read it
  if (lane == 0) bulk_wait();
}

struct LaunchConfig {
  int blocks_per_sm;  // resident blocks an SM, from the occupancy calculator
  int sms;
  int registers;      // a thread, of the loaded kernel
  int local_bytes;    // local memory a thread (spills), of the loaded kernel
};

// the kernel's resident blocks per SM, registers and local memory, and the
// SM count of the current device, computed once a device (the shared
// memory attribute set then)
template <bool kTrap>
int launch_config(LaunchConfig* out) {
  static LaunchConfig cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev].sms == 0) {
    LaunchConfig c;
    err = cudaFuncSetAttribute(stream_ingest_grid_kernel<kTrap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.blocks_per_sm, stream_ingest_grid_kernel<kTrap>, kThreads,
          kSmemBytes);
    }
    cudaFuncAttributes attr;
    if (err == cudaSuccess) {
      err = cudaFuncGetAttributes(&attr, stream_ingest_grid_kernel<kTrap>);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return (int)err;
    if (c.blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    c.registers = attr.numRegs;
    c.local_bytes = (int)attr.localSizeBytes;
    cached[dev] = c;
  }
  *out = cached[dev];
  return 0;
}

int config(int trapezoid, LaunchConfig* out) {
  return trapezoid ? launch_config<true>(out) : launch_config<false>(out);
}

int64_t grid_blocks(const LaunchConfig& c, int64_t d) {
  const int64_t groups = (d + kWarps - 1) / kWarps;
  const int64_t resident = (int64_t)c.blocks_per_sm * c.sms;
  return groups < resident ? groups : resident;
}

}  // namespace
}  // namespace repro_torch

using repro_torch::GridArgs;

// ptrs: the 31 device pointers in GridArgs field order, none aliasing
// another.  Launches on `stream` and returns the first CUDA error (0 on
// success).
extern "C" int stream_ingest_grid_launch(void* const* ptrs, int64_t d,
                                         int64_t m, int trapezoid,
                                         void* stream) {
  static_assert(sizeof(GridArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "GridArgs must be exactly the pointer list");
  GridArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (d > 0) {
    repro_torch::LaunchConfig c;
    const int rc = repro_torch::config(trapezoid, &c);
    if (rc != 0) return rc;
    const unsigned blocks = (unsigned)repro_torch::grid_blocks(c, d);
    const cudaStream_t st = (cudaStream_t)stream;
    if (trapezoid) {
      repro_torch::stream_ingest_grid_kernel<true>
          <<<blocks, repro_torch::kThreads, repro_torch::kSmemBytes, st>>>(
              a, d, m);
    } else {
      repro_torch::stream_ingest_grid_kernel<false>
          <<<blocks, repro_torch::kThreads, repro_torch::kSmemBytes, st>>>(
              a, d, m);
    }
  }
  return (int)cudaGetLastError();
}

// out: resident blocks an SM, SMs, the grid's blocks for d rows, threads
// a block, dynamic shared memory bytes a block, registers a thread, local
// memory bytes a thread.  Returns the CUDA error.
extern "C" int stream_ingest_grid_config(int64_t d, int trapezoid,
                                         int64_t* out) {
  repro_torch::LaunchConfig c;
  const int rc = repro_torch::config(trapezoid, &c);
  if (rc != 0) return rc;
  out[0] = c.blocks_per_sm;
  out[1] = c.sms;
  out[2] = repro_torch::grid_blocks(c, d);
  out[3] = repro_torch::kThreads;
  out[4] = repro_torch::kSmemBytes;
  out[5] = c.registers;
  out[6] = c.local_bytes;
  return 0;
}

extern "C" const char* stream_ingest_grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int stream_ingest_grid_num_pointers() {
  return repro_torch::kNumPointers;
}
