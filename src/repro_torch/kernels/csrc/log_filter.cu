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
// sp + (y - sp) * exp(-dt / tau), carried unchanged where dt <= 0 (the
// zero-width padding), so it rounds as numpy_backend.log_filter and the
// plain PyTorch version do.  The plain version pads every row with a
// segment [t_lo, e_0) and [e_S, t_hi) of idle power, t_lo at or before
// every tick and t_hi past them.  Neither needs a number here: the state
// entering e_0 is idle + (idle - idle) * d, exactly idle; a tick before
// e_0 reads idle + 0 * exp(.), exactly idle (NaN for a NaN or -inf tick,
// as there); the state after t_hi is never read.  So a tick's segment is
// c = #(edges <= t), c = 0 before the first edge, and no span is taken.
//
// Two routes, chosen by the wrapper from the shape alone (kernels/
// log_filter.py, `plan`):
//
// 1. shared memory (`log_filter_tile_kernel`, one launch): a block takes
//    `rows` consecutive tick rows.  It stages the rows' edges and powers
//    (the shared row once) and tau by cp.async, on their own so that they
//    land in one round trip; then requests its first four stages of ticks
//    (4,096), which stay in flight while it computes every exp(-dt/tau) of
//    its (row, segment) pairs in parallel and runs the recurrence on one
//    lane per row: three dependent operations a step, the entry states
//    kept in shared memory.  Then each thread walks its own ticks of the
//    tile (one contiguous range; a tick's row by a multiply-high, not a
//    division), four at a time: their searches of the edges (padded with
//    +inf to a power of two, so no step checks a bound; a step is a load
//    at a constant offset, a compare and an add) run in lockstep, the
//    division by tau is a product and one FMA with no slow-path branch,
//    and the readings are stored coalesced; each stage of the ring is
//    refilled by the thread that read it.
// 2. two launches (S too long for one row's states in shared memory, above
//    ~8,000 segments): one thread per row writes the entry states to a
//    [S + 1, G] scratch, then one thread per tick searches the row's edges
//    in device memory.  Rows are the grid's y, so no tick divides.
//
// Bound on an H100: memory at the audit's shapes.  Per tick it reads the
// tick (8 B) and writes the reading (8 B); its f64 work is a search of
// log2(S) compares, a division and an exp (chip_smoke.py 5e counts the
// built kernel's f64 instructions for the bound).  What the design does
// about it: one launch, no scratch in device memory, the timeline read
// once a block, four stages of ticks in flight through the serial work,
// coalesced loads and stores, and few instructions a tick (the readings
// issue, more than they wait: PERF.md).
//
// No atomics: every output has one writer.  Built with -fmad=false, so
// each product is rounded on its own as in PyTorch; CUDA's exp and
// glibc's may still differ by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                    // ticks a thread has a stage
constexpr int kChunk = kThreads * kUnroll;    // ticks a stage
constexpr int kStages = 4;  // stages in flight a block (a power of two)
constexpr int kTile = 512;  // segments of a shared timeline staged at once
// shared memory a block may have on Hopper (227 KB)
constexpr int kMaxSmem = 232448;
// stored for a segment where the reference keeps the state (dt <= 0);
// exp never returns it
constexpr double kKeep = -1.0;

struct LogFilterArgs {
  // inputs: timeline rows [R, S+1] / [R, S] / [R], ticks [G, M], tau [G]
  const double* edges;
  const double* powers;
  const double* idle;
  const double* ticks;
  const double* tau;
  // scratch [S+1, G] of the two-launch route (null on the other); output
  // [G, M]
  double* states;
  double* out;
};

constexpr int kNumPointers = 7;

// the decay over a segment of width dt, or kKeep where the state is kept
__device__ __forceinline__ double decay(double dt, double tau) {
  return dt > 0.0 ? exp(-dt / tau) : kKeep;
}

__device__ __forceinline__ double chain_step(double y, double d, double sp) {
  return d == kKeep ? y : sp + (y - sp) * d;
}

// x / tau, given rinv = 1 / tau (correctly rounded): the product
// corrected by one FMA is the correctly rounded quotient (Markstein) for
// any finite x whose quotient neither overflows nor is subnormal, so the
// same number as the division, with no slow-path branch; an infinite or
// NaN product passes through
__device__ __forceinline__ double over_tau(double x, double tau,
                                           double rinv) {
  const double q0 = x * rinv;
  const double q = fma(rinv, fma(-tau, q0, x), q0);
  return isfinite(q0) ? q : q0;
}

__device__ __forceinline__ double reading(double t, double e, double y,
                                          double sp, double tau,
                                          double rinv) {
  return sp + (y - sp) * exp(over_tau(-(t - e), tau, rinv));
}

// #(e[0..n) <= t) for non-decreasing e, n >= 1, top the largest power of
// two <= n: the same steps for every thread, exact comparisons
__device__ __forceinline__ int count_le(const double* e, int n, int top,
                                        double t) {
  int pos = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int q = pos + step;
    if (q <= n && e[q - 1] <= t) pos = q;
  }
  return pos;
}

__device__ __forceinline__ int top_pow2(int n) {
  return 1 << (31 - __clz(n));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies but the kStages - 1 newest groups have landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of the tile route, in doubles: the ring of ticks; each
// row's tau, 1 / tau and idle (4 doubles a row, so that tau and 1 / tau
// load as one 16-byte unit); the edges of one shared row or of each tile
// row, padded with +inf to es, a power of two above S + 1, so that the
// search needs no bound check; the powers (with idle appended); each
// row's entry states at a stride made odd, so that the lanes of the
// recurrence hit distinct banks.
struct TileLayout {
  int s1, es, ys, nt;
  __host__ __device__ TileLayout(int64_t r, int s, int rows)
      : s1(s + 1), es(2), ys((s + 1) | 1), nt(r == 1 ? 1 : rows) {
    while (es <= s1) es <<= 1;
  }
  __host__ __device__ int64_t row_data() const { return kStages * kChunk; }
  __host__ __device__ int64_t edges(int rows) const {
    return row_data() + 4 * (int64_t)rows;
  }
  __host__ __device__ int64_t powers(int rows) const {
    return edges(rows) + (int64_t)nt * es;
  }
  __host__ __device__ int64_t states(int rows) const {
    return powers(rows) + (int64_t)nt * s1;
  }
  __host__ __device__ int64_t bytes(int rows) const {
    return 8 * (states(rows) + (int64_t)rows * ys);
  }
};

// kLv steps of the tick searches, for the kUnroll ticks of a thread at
// once: addr (a shared-memory address into a row's edges) moves 2^(kLv-1)
// edges on where the edge before them is <= t, then the smaller steps;
// each step is a load at a constant offset, a compare and an add
template <int kLv>
struct Search {
  static __device__ __forceinline__ void run(uint32_t (&addr)[kUnroll],
                                             const double (&t)[kUnroll]) {
    constexpr int kStep = 1 << (kLv - 1);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      double e;
      asm volatile("ld.shared.f64 %0, [%1+%2];\n"
                   : "=d"(e)
                   : "r"(addr[u]), "n"((kStep - 1) * 8));
      addr[u] += e <= t[u] ? kStep * 8 : 0;
    }
    Search<kLv - 1>::run(addr, t);
  }
};

template <>
struct Search<0> {
  static __device__ __forceinline__ void run(uint32_t (&)[kUnroll],
                                             const double (&)[kUnroll]) {}
};

// requests stage c's ticks of this thread: its elements of the tile are
// tid + j * kThreads, j = c * kUnroll + u
__device__ __forceinline__ void fill(double* ring, const double* tile, int n,
                                     int c, int tid) {
  double* st = ring + (c & (kStages - 1)) * kChunk;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = c * kChunk + u * kThreads + tid;
    if (i < n) cp_async8(smem_u32(st + u * kThreads + tid), tile + i);
  }
  cp_async_commit();
}

// What the readings of a tile need, in shared memory and registers.
struct Tile {
  double* ring;
  const double* rd;  // tau, 1 / tau, idle of each row
  const double* E;
  const double* P;
  const double* Y;
  const double* ticks;
  double* out;
  int n, m, nr, s1, es, ys;
  bool shared_tl;
  uint32_t magic;  // i / m = umulhi(i, magic) >> shift for i < 2^31
  int shift;
};

// The readings of a tile whose rows hold es = 2^kLv padded edges: this
// thread's ticks, kUnroll at a time, their searches in lockstep; a slot
// past the tile reads the last row and is not stored.
template <int kLv>
__device__ __forceinline__ void tile_readings(const Tile& w, int tid) {
  const uint32_t e_base = smem_u32(w.E);
  for (int c = 0; c * kChunk < w.n; ++c) {
    cp_async_wait_oldest();
    const double* st = w.ring + (c & (kStages - 1)) * kChunk;
    double t[kUnroll];
    int q[kUnroll];
    uint32_t a0[kUnroll];
    uint32_t a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c * kChunk + u * kThreads + tid;
      t[u] = st[u * kThreads + tid];
      const int row = w.m == 1 ? i : (int)(__umulhi(i, w.magic) >> w.shift);
      q[u] = row < w.nr ? row : w.nr - 1;
      a0[u] = e_base + (w.shared_tl ? 0 : q[u] * w.es * 8);
      a[u] = a0[u];
    }
    // a - a0 ends as 8 * #(edges <= t): +inf padding counts only an
    // infinite tick, clipped below
    Search<kLv>::run(a, t);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c * kChunk + u * kThreads + tid;
      const int k = min((int)((a[u] - a0[u]) >> 3), w.s1);
      // k == 0: before the first edge, idle (the plain version's
      // idle + 0 * exp(.))
      const int kk = (k > 0 ? k : 1) - 1;
      const int row = w.shared_tl ? 0 : q[u];
      const double2 tr = *reinterpret_cast<const double2*>(w.rd + q[u] * 4);
      const double idle = w.rd[q[u] * 4 + 2];
      const double v = reading(t[u], w.E[row * w.es + kk],
                               w.Y[q[u] * w.ys + kk], w.P[row * w.s1 + kk],
                               tr.x, tr.y);
      if (i < w.n) w.out[i] = k == 0 ? idle + (t[u] - t[u]) : v;
    }
    fill(w.ring, w.ticks, w.n, c + kStages, tid);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    log_filter_tile_kernel(LogFilterArgs a, int64_t r, int64_t g, int s,
                           int m, int rows) {
  extern __shared__ double sm[];
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int nr = (int)(g - row0 < rows ? g - row0 : rows);
  const TileLayout lay(r, s, rows);
  const int s1 = lay.s1;
  const int es = lay.es;
  const int ys = lay.ys;
  double* RD = sm + lay.row_data();
  double* E = sm + lay.edges(rows);
  double* P = sm + lay.powers(rows);
  double* Y = sm + lay.states(rows);

  // 0. the timeline rows (powers with idle appended), tau and idle, on
  //    their own: ahead of the ticks, they land in one round trip
  const bool shared_tl = r == 1;
  const int nt = shared_tl ? 1 : nr;
  const int64_t tr0 = shared_tl ? 0 : row0;
  for (int i = tid; i < nt * s1; i += kThreads) {
    const int rr = i / s1;
    const int k = i - rr * s1;
    cp_async8(smem_u32(E + rr * es + k), a.edges + (tr0 + rr) * s1 + k);
    cp_async8(smem_u32(P + i),
              k < s ? a.powers + (tr0 + rr) * s + k : a.idle + tr0 + rr);
  }
  for (int i = tid; i < nr; i += kThreads) {
    cp_async8(smem_u32(RD + 4 * i), a.tau + row0 + i);
    cp_async8(smem_u32(RD + 4 * i + 2),
              a.idle + (shared_tl ? 0 : row0 + i));
  }
  cp_async_commit();
  const int pad = es - s1;
  for (int i = tid; i < nt * pad; i += kThreads) {
    const int rr = i / pad;
    E[rr * es + s1 + (i - rr * pad)] =
        __longlong_as_double(0x7ff0000000000000LL);
  }
  cp_async_wait_all();
  __syncthreads();

  // 1. the first kStages stages of ticks, in flight through the decays
  //    and the recurrence
  Tile w;
  w.ring = sm;
  w.ticks = a.ticks + row0 * m;
  w.n = nr * m;  // the plan keeps a tile within 2^30 ticks
#pragma unroll
  for (int c = 0; c < kStages; ++c) fill(w.ring, w.ticks, w.n, c, tid);

  // 2. every decay of the tile, in parallel: Y[row][k + 1] holds segment
  //    k's until the recurrence overwrites it with the state after it
  for (int i = tid; i < nr; i += kThreads) RD[4 * i + 1] = 1.0 / RD[4 * i];
  for (int i = tid; i < nr * s; i += kThreads) {
    const int rr = i / s;
    const int k = i - rr * s;
    const double* e = E + (shared_tl ? 0 : rr * es);
    Y[rr * ys + k + 1] = decay(e[k + 1] - e[k], RD[4 * rr]);
  }
  __syncthreads();

  // 3. the recurrence, one lane per row; a step's decay and power are
  //    loaded before the previous step's state is stored
  if (tid < nr) {
    const double* p = P + (shared_tl ? 0 : tid * s1);
    double* y_row = Y + tid * ys;
    double y = RD[4 * tid + 2];
    y_row[0] = y;
    double d = y_row[1];  // y_row and p hold s1 >= 1 entries
    double sp = p[0];
    for (int k = 0; k < s; ++k) {
      const int kn = k + 1 < s ? k + 1 : k;
      const double d_next = y_row[kn + 1];
      const double sp_next = p[kn];
      y = chain_step(y, d, sp);
      y_row[k + 1] = y;
      d = d_next;
      sp = sp_next;
    }
  }
  __syncthreads();

  // 4. the readings
  w.rd = RD;
  w.E = E;
  w.P = P;
  w.Y = Y;
  w.out = a.out + row0 * m;
  w.m = m;
  w.nr = nr;
  w.s1 = s1;
  w.es = es;
  w.ys = ys;
  w.shared_tl = shared_tl;
  w.magic = 0;
  w.shift = 0;
  if (m > 1) {
    const int l = 32 - __clz(m - 1);  // ceil(log2(m))
    w.magic = (uint32_t)(((1ull << (31 + l)) + m - 1) / m);
    w.shift = l - 1;
  }
  switch (31 - __clz(es)) {
    case 1: tile_readings<1>(w, tid); break;
    case 2: tile_readings<2>(w, tid); break;
    case 3: tile_readings<3>(w, tid); break;
    case 4: tile_readings<4>(w, tid); break;
    case 5: tile_readings<5>(w, tid); break;
    case 6: tile_readings<6>(w, tid); break;
    case 7: tile_readings<7>(w, tid); break;
    case 8: tile_readings<8>(w, tid); break;
    case 9: tile_readings<9>(w, tid); break;
    case 10: tile_readings<10>(w, tid); break;
    case 11: tile_readings<11>(w, tid); break;
    case 12: tile_readings<12>(w, tid); break;
    default: tile_readings<13>(w, tid); break;  // es <= 8192 on this route
  }
  cp_async_wait_all();
}

// Two-launch route, 1: the entry states [S + 1, G], one thread per row.
// A shared timeline (R = 1) is staged through shared memory a tile of
// segments at a time; per-device rows are read from device memory.
__global__ void __launch_bounds__(kThreads)
    log_filter_states_kernel(LogFilterArgs a, int64_t r, int64_t g, int s) {
  __shared__ double sh_e[kTile + 1];
  __shared__ double sh_p[kTile];
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < g;
  const bool shared_tl = r == 1;
  const int64_t tr = (shared_tl || !live) ? 0 : row;
  const double* e_row = a.edges + tr * (s + 1);
  const double* p_row = a.powers + tr * s;
  const double tau = live ? a.tau[row] : 1.0;

  double y = a.idle[tr];
  if (live) a.states[row] = y;
  if (shared_tl) {
    // every thread of the block takes part in staging, live or not
    for (int k0 = 0; k0 < s; k0 += kTile) {
      const int nk = s - k0 < kTile ? s - k0 : kTile;
      __syncthreads();
      for (int i = threadIdx.x; i <= nk; i += kThreads) {
        sh_e[i] = e_row[k0 + i];
        if (i < nk) sh_p[i] = p_row[k0 + i];
      }
      __syncthreads();
      if (live) {
        for (int i = 0; i < nk; ++i) {
          y = chain_step(y, decay(sh_e[i + 1] - sh_e[i], tau), sh_p[i]);
          a.states[(int64_t)(k0 + i + 1) * g + row] = y;
        }
      }
    }
  } else if (live) {
    for (int k = 0; k < s; ++k) {
      y = chain_step(y, decay(e_row[k + 1] - e_row[k], tau), p_row[k]);
      a.states[(int64_t)(k + 1) * g + row] = y;
    }
  }
}

// Two-launch route, 2: one thread per tick, the grid's y walking rows.
__global__ void __launch_bounds__(kThreads)
    log_filter_readings_kernel(LogFilterArgs a, int64_t r, int64_t g, int s,
                               int64_t m) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= m) return;
  const int s1 = s + 1;
  const int top = top_pow2(s1);
  for (int64_t row = blockIdx.y; row < g; row += gridDim.y) {
    const int64_t tr = r == 1 ? 0 : row;
    const double* e_row = a.edges + tr * s1;
    const double idle = a.idle[tr];
    const double t = a.ticks[row * m + col];
    const int k = count_le(e_row, s1, top, t);
    double v;
    if (k == 0) {
      v = idle + (t - t);
    } else {
      const double sp = k - 1 < s ? a.powers[tr * s + k - 1] : idle;
      const double tau = a.tau[row];
      v = reading(t, e_row[k - 1], a.states[(int64_t)(k - 1) * g + row], sp,
                  tau, 1.0 / tau);
    }
    a.out[row * m + col] = v;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::LogFilterArgs;

// Never launched: chip_smoke.py counts the f64 instructions of these two in
// the built library's SASS (cuobjdump), the same inline functions the
// kernels run: a tick's reading, and a segment's decay and step.
extern "C" __global__ void log_filter_tick_ops(const double* in, double* out) {
  out[0] = repro_torch::reading(in[0], in[1], in[2], in[3], in[4], in[5]);
}

extern "C" __global__ void log_filter_step_ops(const double* in, double* out) {
  out[0] = repro_torch::chain_step(
      in[0], repro_torch::decay(in[1] - in[2], in[3]), in[4]);
}

// ptrs: the 7 device pointers in LogFilterArgs field order.  rows > 0: the
// shared-memory route with `rows` tick rows a block; rows == 0: the
// two-launch route (states must be [S + 1, G]).  Launches on `stream` and
// returns the first launch error (0 on success).
extern "C" int log_filter_launch(void* const* ptrs, int64_t r, int64_t g,
                                 int64_t s, int64_t m, int rows,
                                 void* stream) {
  static_assert(sizeof(LogFilterArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "LogFilterArgs must be exactly the pointer list");
  using namespace repro_torch;
  LogFilterArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (g <= 0 || m <= 0) return 0;
  if (s < 0 || s >= 0x7fffffffLL || rows < 0 || rows > 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (rows > 0) {
    const int64_t bytes = TileLayout(r, (int)s, rows).bytes(rows);
    const int64_t blocks = (g + rows - 1) / rows;
    if (bytes > kMaxSmem || blocks > 0x7fffffffLL ||
        (int64_t)rows * m > (1LL << 30)) {
      return (int)cudaErrorInvalidValue;
    }
    if (bytes > 48 * 1024) {  // above the default, a block must opt in
      cudaError_t err = cudaFuncSetAttribute(
          log_filter_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    log_filter_tile_kernel<<<(unsigned)blocks, kThreads, (size_t)bytes, st>>>(
        a, r, g, (int)s, (int)m, rows);
    return (int)cudaGetLastError();
  }
  if (a.states == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t t = kThreads;
  log_filter_states_kernel<<<(unsigned)((g + t - 1) / t), kThreads, 0, st>>>(
      a, r, g, (int)s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + t - 1) / t),
                  (unsigned)(g < 65535 ? g : 65535));
  log_filter_readings_kernel<<<grid, kThreads, 0, st>>>(a, r, g, (int)s, m);
  return (int)cudaGetLastError();
}

extern "C" const char* log_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int log_filter_num_pointers() { return repro_torch::kNumPointers; }
