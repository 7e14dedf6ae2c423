// stream_group: group a flat monitor slab by device on the card, for Hopper.
//
// Replaces no TPU kernel.  The reference orders a flat slab with
// `np.lexsort((t, dev))` (src/repro/core/stream/ingest.py:298) and leaves
// the duplicate and late flags, the drop counters, the compaction and the
// group arrays to numpy; the port did the same with two stable radix sorts
// of 64-bit keys and some twenty passes of gathers, masks and scans over
// the slab.  This source does that whole preparation of
// `IngestCore._ingest` in three calls from the host:
//
//   count  (1) zero the workspace; (2) count the samples of each device
//          with atomics, and the out-of-range ids and non-finite samples,
//          which are left out; (3) one block scans the counts into bucket
//          offsets and lists the buckets above kWarpSortMax (the wide
//          route).  The host reads [rejected, invalid, valid, wide, max].
//   sort   (4) scatter (t, v, arrival) into each device's bucket through an
//          atomic cursor: one 32-byte record, one memory sector, a sample;
//          (5) one warp a bucket of at most kWarpSortMax samples sorts it
//          by (t, arrival) in registers (a bitonic network: lanes exchange
//          by shuffles, a lane's own elements swap in registers), reads
//          that device's has/last_t once, flags duplicates and late
//          samples, adds the drop counts into the state and writes the
//          kept samples in order, baselined, at the bucket's start; wider
//          buckets take (5w): warps sort 1024-sample chunks in registers,
//          merge passes (merge path, all blocks) double the sorted runs,
//          one block a bucket flags and compacts; (6) one block scans the
//          kept counts.  The host reads [dup, late, kept, devices].
//   emit   (7) one block a device copies its kept samples to the outputs
//          with its group's index, first flag and bounds.
//
// Order: t compares as a double, so -0.0 == +0.0 (one key, the canonical
// +0.0) and ties go to the earlier arrival; non-finite samples never
// reach the sort.  The output is, bit for bit, what the two stable sorts
// and the passes after them give: the same kept samples in the same
// order, the same surviving duplicate, the same counts.
//
// Bound on an H100: memory.  A sample is read twice (dev, t, v: 48 B),
// scattered once (32 B), read by its bucket's sort (32 B) and, if kept,
// written (16 B), read (16 B) and emitted (dev, t, v, seg, first: 33 B):
// ~177 B a sample against ~800 B for the sorts and gathers it replaces;
// the least, the slab read once and the outputs written once, is ~57 B.
// What the design does about it: each sample lands in its bucket in one
// sector-sized write; the sort of a bucket of ~500 runs in one warp's
// registers and never leaves the SM; the flags, counters and baseline are
// applied where the sorted bucket already is.  The atomics of the count
// and the scatter go to a [D] int array that stays in L2; the scatter's
// writes are random, one sector each, and take the most time.  Tried and
// slower on the card: ranks drawn in the count so that the scatter needs
// no atomic, and a lane-major layout of the network (fewer shuffles).
//
// Workspace and scratch are laid out here (stream_group_workspace_bytes,
// stream_group_scratch_bytes); the wrapper allocates them.  The drop
// counters of the state are written in place, one writer a device; every
// other output has one writer too, so results are the same run to run.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

typedef unsigned long long u64;

constexpr int kWarpSortMax = 1024;  // the register route: 32 elements a lane
constexpr int kStats = 16;
constexpr u64 kPadKey = ~0ull;      // above the key of every finite double
constexpr u64 kSign = 0x8000000000000000ull;
constexpr unsigned kFull = 0xffffffffu;

// stats: what the host reads back
enum Stat {
  kRejected = 0, kInvalid, kValid, kWide, kMaxBucket,
  kDup, kLate, kKept, kDevices
};

struct __align__(32) Rec {  // one sample in its bucket: one 32-byte sector
  double t;
  double v;
  long long arrival;
  long long unused;
};

struct __align__(16) TV {
  double t;
  double v;
};

struct GroupArgs {
  // the slab [K]
  const long long* dev;
  const double* t;
  const double* v;
  // the monitor's state [D]
  const bool* has;
  const double* last_t;
  long long* n_dup;     // in place
  long long* n_late;    // in place
  const double* baseline;
  // stream_group_workspace_bytes(D) and stream_group_scratch_bytes(valid)
  void* ws;
  void* scratch;
  // outputs: [kept]
  long long* dev_o;
  double* t_o;
  double* v_o;
  long long* seg;
  bool* first;
  // outputs: [devices]
  long long* start_idx;
  long long* end_idx;
  long long* u_dev;
};

constexpr int kNumPointers = 18;

__host__ __device__ inline size_t align_up(size_t x) {
  return (x + 255) & ~size_t(255);
}

// The workspace: stats and cnt first (the part zeroed on every slab).
struct Layout {
  long long* stats;     // [kStats]
  int* cnt;             // [D] samples a device; the scatter's cursor
  int* kept;            // [D] kept samples a device
  int* drop_dup;        // [D] duplicates a device (this slab)
  int* drop_late;       // [D] late samples a device (this slab)
  int* wide;            // [D] the devices of the wide route
  long long* off;       // [D + 1] bucket offsets
  long long* kept_off;  // [D] kept offsets
  long long* u_idx;     // [D] the group index of each device that keeps
  size_t zeroed;        // bytes to zero: stats and cnt
  size_t bytes;
};

__host__ __device__ inline Layout layout(void* ws, long long n_dev) {
  Layout L;
  char* p = static_cast<char*>(ws);
  size_t at = 0;
  const size_t d = static_cast<size_t>(n_dev);
  L.stats = reinterpret_cast<long long*>(p + at);
  at += kStats * sizeof(long long);
  L.cnt = reinterpret_cast<int*>(p + at);
  at += d * sizeof(int);
  L.zeroed = at;
  at = align_up(at);
  L.kept = reinterpret_cast<int*>(p + at);
  at = align_up(at + d * sizeof(int));
  L.drop_dup = reinterpret_cast<int*>(p + at);
  at = align_up(at + d * sizeof(int));
  L.drop_late = reinterpret_cast<int*>(p + at);
  at = align_up(at + d * sizeof(int));
  L.wide = reinterpret_cast<int*>(p + at);
  at = align_up(at + d * sizeof(int));
  L.off = reinterpret_cast<long long*>(p + at);
  at = align_up(at + (d + 1) * sizeof(long long));
  L.kept_off = reinterpret_cast<long long*>(p + at);
  at = align_up(at + d * sizeof(long long));
  L.u_idx = reinterpret_cast<long long*>(p + at);
  at = align_up(at + d * sizeof(long long));
  L.bytes = at;
  return L;
}

// The scratch: the records by bucket, the kept (t, v) by bucket, and for
// the wide route a second set of records to merge into.
struct Scratch {
  Rec* rec;
  TV* tv;
  Rec* rec2;
  size_t bytes;
};

__host__ __device__ inline Scratch scratch_layout(void* s, long long valid,
                                                  bool wide) {
  Scratch S;
  char* p = static_cast<char*>(s);
  const size_t n = static_cast<size_t>(valid);
  size_t at = 0;
  S.rec = reinterpret_cast<Rec*>(p + at);
  at = align_up(at + n * sizeof(Rec));
  S.tv = reinterpret_cast<TV*>(p + at);
  at = align_up(at + n * sizeof(TV));
  S.rec2 = wide ? reinterpret_cast<Rec*>(p + at) : nullptr;
  if (wide) at = align_up(at + n * sizeof(Rec));
  S.bytes = at;
  return S;
}

// t as an unsigned key in the order of doubles, -0.0 as +0.0
__device__ __forceinline__ u64 t_key(double t) {
  u64 b = static_cast<u64>(__double_as_longlong(t));
  if ((b << 1) == 0) b = 0;
  return (b & kSign) ? ~b : (b | kSign);
}

__device__ __forceinline__ double key_t(u64 k) {
  const u64 b = (k & kSign) ? (k ^ kSign) : ~k;
  return __longlong_as_double(static_cast<long long>(b));
}

// the strict order of a bucket: key, then arrival; padding (kPadKey)
// after every sample, among itself by position.  `pos` indexes `rec`.
__device__ __forceinline__ bool before(u64 ka, int pa, u64 kb, int pb,
                                       const Rec* rec) {
  if (ka != kb) return ka < kb;
  if (ka == kPadKey) return pa < pb;
  return rec[pa].arrival < rec[pb].arrival;
}

__device__ __forceinline__ bool rec_before(const Rec& a, const Rec& b) {
  const u64 ka = t_key(a.t), kb = t_key(b.t);
  if (ka != kb) return ka < kb;
  return a.arrival < b.arrival;
}

// -- the register bitonic sort of one warp ---------------------------------
// Element i = r * 32 + lane sits in key[r]/pos[r] of lane `lane`.  Stages
// whose partner is another lane (j < 32) exchange by shuffles; stages
// whose partner is another register of the same lane (j >= 32) swap in
// registers, one instance a register distance RJ = j / 32 so that every
// register index is known to the compiler.
template <int E, int RJ>
__device__ __forceinline__ void reg_stage(u64 (&key)[E], int (&pos)[E],
                                          int k, const Rec* rec) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if ((r & RJ) == 0) {
      const int q = r | RJ;
      const bool up = ((r << 5) & k) == 0;
      const bool q_first = before(key[q], pos[q], key[r], pos[r], rec);
      if (q_first == up) {
        const u64 tk = key[r];
        key[r] = key[q];
        key[q] = tk;
        const int tp = pos[r];
        pos[r] = pos[q];
        pos[q] = tp;
      }
    }
  }
}

template <int E>
__device__ __forceinline__ void reg_stage_by(int rj, u64 (&key)[E],
                                             int (&pos)[E], int k,
                                             const Rec* rec) {
  if constexpr (E > 1) {
    if (rj == 1) return reg_stage<E, 1>(key, pos, k, rec);
  }
  if constexpr (E > 2) {
    if (rj == 2) return reg_stage<E, 2>(key, pos, k, rec);
  }
  if constexpr (E > 4) {
    if (rj == 4) return reg_stage<E, 4>(key, pos, k, rec);
  }
  if constexpr (E > 8) {
    if (rj == 8) return reg_stage<E, 8>(key, pos, k, rec);
  }
  if constexpr (E > 16) {
    if (rj == 16) return reg_stage<E, 16>(key, pos, k, rec);
  }
}

template <int E>
__device__ __forceinline__ void warp_sort(u64 (&key)[E], int (&pos)[E],
                                          const Rec* rec) {
  const int lane = threadIdx.x & 31;
  for (int k = 2; k <= 32 * E; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        reg_stage_by<E>(j >> 5, key, pos, k, rec);
        continue;
      }
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const u64 ok = __shfl_xor_sync(kFull, key[r], j);
        const int op = __shfl_xor_sync(kFull, pos[r], j);
        const bool up = ((((r << 5) | lane)) & k) == 0;
        const bool other_first = before(ok, op, key[r], pos[r], rec);
        // the lower element of an ascending pair keeps the first one
        if ((lower == up) == other_first) {
          key[r] = ok;
          pos[r] = op;
        }
      }
    }
  }
}

// Load up to 32 * E records of `rec` (n of them) as keys, sort them.
template <int E>
__device__ __forceinline__ void load_sort(const Rec* rec, int n,
                                          u64 (&key)[E], int (&pos)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int p = (r << 5) | lane;
    pos[r] = p;
    key[r] = p < n ? t_key(rec[p].t) : kPadKey;
  }
  warp_sort<E>(key, pos, rec);
}

// Flag a sorted bucket of n samples (E registers a lane) against the
// device's stored newest sample, write the kept ones in order at `out`
// (baselined), return the kept count; dups/lates get the drop counts.
template <int E>
__device__ __forceinline__ int flag_keep(const u64 (&key)[E],
                                         const int (&pos)[E], int n,
                                         const Rec* rec, bool has,
                                         double last, double base_w,
                                         TV* out, int* dups, int* lates) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0, nd = 0, nl = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = (r << 5) | lane;
    const bool real = i < n;
    const u64 up1 = __shfl_up_sync(kFull, key[r], 1);
    u64 prev = up1;
    if (r > 0) {
      const u64 carry = __shfl_sync(kFull, key[r > 0 ? r - 1 : 0], 31);
      if (lane == 0) prev = carry;
    }
    const bool dup = real && i > 0 && prev == key[r];
    const double tc = key_t(key[r]);
    const bool late = real && !dup && has && tc < last;
    const bool dropped = real && (dup || (has && tc == last));
    const bool keep = real && !dropped && !late;
    const unsigned km = __ballot_sync(kFull, keep);
    nd += __popc(__ballot_sync(kFull, dropped));
    nl += __popc(__ballot_sync(kFull, late));
    if (keep) {
      const Rec& x = rec[pos[r]];
      TV o;
      o.t = x.t;
      o.v = x.v - base_w;
      out[kept + __popc(km & below)] = o;
    }
    kept += __popc(km);
  }
  *dups = nd;
  *lates = nl;
  return kept;
}

// -- 1. count ---------------------------------------------------------------
constexpr int kThreads = 256;

__device__ __forceinline__ long long warp_sum_ll(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
group_count_kernel(GroupArgs a, long long k, long long n_dev) {
  const Layout L = layout(a.ws, n_dev);
  long long rej = 0, inv = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    const long long d = a.dev[i];
    if (d < 0 || d >= n_dev) {
      ++rej;
      continue;
    }
    if (!isfinite(a.t[i]) || !isfinite(a.v[i])) {
      ++inv;
      continue;
    }
    atomicAdd(&L.cnt[d], 1);
  }
  rej = warp_sum_ll(rej);
  inv = warp_sum_ll(inv);
  if ((threadIdx.x & 31) == 0) {
    if (rej) atomicAdd(reinterpret_cast<u64*>(&L.stats[kRejected]), (u64)rej);
    if (inv) atomicAdd(reinterpret_cast<u64*>(&L.stats[kInvalid]), (u64)inv);
  }
}

// -- block-wide scans of the one-block kernels --------------------------------
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;

// exclusive scan over the block; *total gets the block's sum
__device__ __forceinline__ long long block_excl_scan(long long x,
                                                     long long* total,
                                                     long long* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();  // warp_s free from the last use
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < (blockDim.x >> 5) ? warp_s[lane] : 0;
    long long wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    warp_s[lane] = wi - w;      // exclusive, by warp
    if (lane == 31) warp_s[32] = wi;
  }
  __syncthreads();
  *total = warp_s[32];
  return warp_s[warp] + incl - x;
}

__device__ __forceinline__ long long block_max(long long x,
                                               long long* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  __syncthreads();
  if (lane == 0) warp_s[warp] = x;
  __syncthreads();
  long long m = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
    m = warp_s[w] > m ? warp_s[w] : m;
  return m;
}

// bucket offsets from the counts; the wide route's list; [valid, wide, max]
__global__ void __launch_bounds__(kScanThreads)
group_offsets_kernel(GroupArgs a, long long n_dev) {
  const Layout L = layout(a.ws, n_dev);
  __shared__ long long warp_s[33];
  __shared__ int n_wide_s;
  if (threadIdx.x == 0) n_wide_s = 0;
  long long carry = 0, mx = 0;
  for (long long b0 = 0; b0 < n_dev; b0 += kScanThreads * kScanItems) {
    const long long i0 = b0 + (long long)threadIdx.x * kScanItems;
    int c[kScanItems];
    long long s = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      c[j] = i0 + j < n_dev ? L.cnt[i0 + j] : 0;
      s += c[j];
      mx = c[j] > mx ? c[j] : mx;
    }
    long long tot;
    long long run = carry + block_excl_scan(s, &tot, warp_s);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < n_dev) {
        L.off[i0 + j] = run;
        if (c[j] > kWarpSortMax) L.wide[atomicAdd(&n_wide_s, 1)] = (int)(i0 + j);
      }
      run += c[j];
    }
    carry += tot;
  }
  mx = block_max(mx, warp_s);
  if (threadIdx.x == 0) {
    L.off[n_dev] = carry;
    L.stats[kValid] = carry;
    L.stats[kWide] = n_wide_s;
    L.stats[kMaxBucket] = mx;
  }
}

// -- 2. sort ------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
group_scatter_kernel(GroupArgs a, long long k, long long n_dev) {
  const Layout L = layout(a.ws, n_dev);
  Rec* rec = static_cast<Rec*>(a.scratch);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    const long long d = a.dev[i];
    if (d < 0 || d >= n_dev) continue;
    const double t = a.t[i], v = a.v[i];
    if (!isfinite(t) || !isfinite(v)) continue;
    const int left = atomicSub(&L.cnt[d], 1);
    Rec* dst = rec + L.off[d] + left - 1;
    double2 tv;
    tv.x = t;
    tv.y = v;
    longlong2 ar;
    ar.x = i;
    ar.y = 0;
    reinterpret_cast<double2*>(dst)[0] = tv;
    reinterpret_cast<longlong2*>(dst)[1] = ar;
  }
}

constexpr int kSortWarps = kThreads / 32;

template <int E>
__device__ __forceinline__ void sort_bucket(const GroupArgs& a,
                                            const Layout& L, const Rec* rec,
                                            TV* out, long long d, int n) {
  u64 key[E];
  int pos[E];
  load_sort<E>(rec, n, key, pos);
  int nd, nl;
  const int kept = flag_keep<E>(key, pos, n, rec, a.has[d], a.last_t[d],
                                a.baseline[d], out, &nd, &nl);
  if ((threadIdx.x & 31) == 0) {
    L.kept[d] = kept;
    L.drop_dup[d] = nd;
    L.drop_late[d] = nl;
    if (nd) a.n_dup[d] += nd;
    if (nl) a.n_late[d] += nl;
  }
}

// One warp a device, two instances: kMaxE 16 sorts the buckets of at
// most 512 samples (and marks the empty ones), kMaxE 32 those of 513 to
// kWarpSortMax, so that the few above 512 do not set the registers, and
// with them the occupancy, of every other warp.  Buckets above
// kWarpSortMax are the wide route's.
template <int kMaxE>
__global__ void __launch_bounds__(kThreads)
group_sort_kernel(GroupArgs a, long long n_valid, long long n_dev) {
  const Layout L = layout(a.ws, n_dev);
  const Scratch S = scratch_layout(a.scratch, n_valid, false);
  const long long d = (long long)blockIdx.x * kSortWarps + (threadIdx.x >> 5);
  if (d >= n_dev) return;
  const long long base = L.off[d];
  const long long nb = L.off[d + 1] - base;
  constexpr int kLo = kMaxE == 32 ? 512 : -1;   // sizes (kLo, 32 * kMaxE]
  if (nb > 32 * kMaxE || nb <= kLo) return;
  const int n = (int)nb;
  const Rec* rec = S.rec + base;
  TV* out = S.tv + base;
  if constexpr (kMaxE == 32) {
    sort_bucket<32>(a, L, rec, out, d, n);
  } else {
    if (n == 0) {
      if ((threadIdx.x & 31) == 0) {
        L.kept[d] = 0;
        L.drop_dup[d] = 0;
        L.drop_late[d] = 0;
      }
    } else if (n <= 32) {
      sort_bucket<1>(a, L, rec, out, d, n);
    } else if (n <= 64) {
      sort_bucket<2>(a, L, rec, out, d, n);
    } else if (n <= 128) {
      sort_bucket<4>(a, L, rec, out, d, n);
    } else if (n <= 256) {
      sort_bucket<8>(a, L, rec, out, d, n);
    } else {
      sort_bucket<16>(a, L, rec, out, d, n);
    }
  }
}

// -- 2w. the wide route: buckets above kWarpSortMax ---------------------------
constexpr int kChunk = kWarpSortMax;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kThreads * kMergeItems;  // <= 2 * kChunk

// each warp sorts one kChunk-sample chunk of a wide bucket into rec2
__global__ void __launch_bounds__(kThreads)
group_wide_chunks_kernel(GroupArgs a, long long n_valid, long long n_dev,
                         long long n_wide) {
  const Layout L = layout(a.ws, n_dev);
  const Scratch S = scratch_layout(a.scratch, n_valid, true);
  const int lane = threadIdx.x & 31;
  const long long c0 =
      ((long long)blockIdx.x * kSortWarps + (threadIdx.x >> 5)) * kChunk;
  for (long long w = blockIdx.y; w < n_wide; w += gridDim.y) {
    const long long d = L.wide[w];
    const long long base = L.off[d];
    const long long n = L.off[d + 1] - base;
    if (c0 >= n) continue;
    const int m = (int)(n - c0 < kChunk ? n - c0 : kChunk);
    const Rec* rec = S.rec + base + c0;
    u64 key[kChunk / 32];
    int pos[kChunk / 32];
    load_sort<kChunk / 32>(rec, m, key, pos);
    Rec* dst = S.rec2 + base + c0;
#pragma unroll
    for (int r = 0; r < kChunk / 32; ++r) {
      const int i = (r << 5) | lane;
      if (i < m) dst[i] = rec[pos[r]];
    }
  }
}

// one merge pass: sorted runs of `run` samples into runs of 2 * run
__global__ void __launch_bounds__(kThreads)
group_wide_merge_kernel(GroupArgs a, long long n_valid, long long n_dev,
                        long long n_wide, long long run, int from_rec2) {
  const Layout L = layout(a.ws, n_dev);
  const Scratch S = scratch_layout(a.scratch, n_valid, true);
  const Rec* src = from_rec2 ? S.rec2 : S.rec;
  Rec* dst = from_rec2 ? S.rec : S.rec2;
  const long long o0 = (long long)blockIdx.x * kMergeTile;
  for (long long w = blockIdx.y; w < n_wide; w += gridDim.y) {
    const long long d = L.wide[w];
    const long long base = L.off[d];
    const long long n = L.off[d + 1] - base;
    if (o0 >= n) continue;
    // a tile never straddles two pairs: 2 * run is a multiple of the tile
    const long long p0 = (o0 / (2 * run)) * (2 * run);
    const long long la = n - p0 < run ? n - p0 : run;
    const long long rest = n - p0 - la;
    const long long lb = rest < 0 ? 0 : (rest < run ? rest : run);
    const Rec* A = src + base + p0;
    const Rec* B = A + la;
    const long long diag = o0 - p0 + (long long)threadIdx.x * kMergeItems;
    if (diag >= la + lb) continue;
    // merge path: how many of the first `diag` outputs come from A
    long long lo = diag - lb > 0 ? diag - lb : 0;
    long long hi = diag < la ? diag : la;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (rec_before(A[mid], B[diag - 1 - mid]))
        lo = mid + 1;
      else
        hi = mid;
    }
    long long ai = lo, bi = diag - lo;
    Rec* out = dst + base + p0 + diag;
    for (int s = 0; s < kMergeItems && diag + s < la + lb; ++s) {
      const bool take_a =
          ai < la && (bi >= lb || rec_before(A[ai], B[bi]));
      out[s] = take_a ? A[ai++] : B[bi++];
    }
  }
}

// flag and compact one sorted wide bucket a block
__global__ void __launch_bounds__(kScanThreads)
group_wide_keep_kernel(GroupArgs a, long long n_valid, long long n_dev,
                       long long n_wide, int in_rec2) {
  const Layout L = layout(a.ws, n_dev);
  const Scratch S = scratch_layout(a.scratch, n_valid, true);
  const Rec* sorted = in_rec2 ? S.rec2 : S.rec;
  __shared__ long long warp_s[33];
  for (long long w = blockIdx.x; w < n_wide; w += gridDim.x) {
    const long long d = L.wide[w];
    const long long base = L.off[d];
    const long long n = L.off[d + 1] - base;
    const bool has = a.has[d];
    const double last = a.last_t[d];
    const double base_w = a.baseline[d];
    const Rec* rec = sorted + base;
    TV* out = S.tv + base;
    long long kept = 0, nd = 0, nl = 0;
    for (long long c0 = 0; c0 < n; c0 += kScanThreads) {
      const long long i = c0 + threadIdx.x;
      const bool real = i < n;
      bool keep = false;
      Rec x;
      if (real) {
        x = rec[i];
        const u64 key = t_key(x.t);
        const bool dup = i > 0 && t_key(rec[i - 1].t) == key;
        const double tc = key_t(key);
        const bool late = !dup && has && tc < last;
        const bool dropped = dup || (has && tc == last);
        keep = !dropped && !late;
        nd += dropped;
        nl += late;
      }
      long long tot;
      const long long at = block_excl_scan(keep ? 1 : 0, &tot, warp_s);
      if (keep) {
        TV o;
        o.t = x.t;
        o.v = x.v - base_w;
        out[kept + at] = o;
      }
      kept += tot;
    }
    long long tot_d, tot_l;
    block_excl_scan(nd, &tot_d, warp_s);
    block_excl_scan(nl, &tot_l, warp_s);
    if (threadIdx.x == 0) {
      L.kept[d] = (int)kept;
      L.drop_dup[d] = (int)tot_d;
      L.drop_late[d] = (int)tot_l;
      if (tot_d) a.n_dup[d] += tot_d;
      if (tot_l) a.n_late[d] += tot_l;
    }
    __syncthreads();
  }
}

// kept offsets and group indices; [dup, late, kept, devices]
__global__ void __launch_bounds__(kScanThreads)
group_kept_kernel(GroupArgs a, long long n_dev) {
  const Layout L = layout(a.ws, n_dev);
  __shared__ long long warp_s[33];
  long long carry = 0, carry_u = 0, nd = 0, nl = 0;
  for (long long b0 = 0; b0 < n_dev; b0 += kScanThreads * kScanItems) {
    const long long i0 = b0 + (long long)threadIdx.x * kScanItems;
    int c[kScanItems];
    long long s = 0, su = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const bool in = i0 + j < n_dev;
      c[j] = in ? L.kept[i0 + j] : 0;
      s += c[j];
      su += c[j] > 0;
      if (in) {
        nd += L.drop_dup[i0 + j];
        nl += L.drop_late[i0 + j];
      }
    }
    long long tot, tot_u;
    long long run = carry + block_excl_scan(s, &tot, warp_s);
    long long run_u = carry_u + block_excl_scan(su, &tot_u, warp_s);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < n_dev) {
        L.kept_off[i0 + j] = run;
        L.u_idx[i0 + j] = run_u;
      }
      run += c[j];
      run_u += c[j] > 0;
    }
    carry += tot;
    carry_u += tot_u;
  }
  long long tot_d, tot_l;
  block_excl_scan(nd, &tot_d, warp_s);
  block_excl_scan(nl, &tot_l, warp_s);
  if (threadIdx.x == 0) {
    L.stats[kDup] = tot_d;
    L.stats[kLate] = tot_l;
    L.stats[kKept] = carry;
    L.stats[kDevices] = carry_u;
  }
}

// -- 3. emit ------------------------------------------------------------------
constexpr int kEmitThreads = 128;

__global__ void __launch_bounds__(kEmitThreads)
group_emit_kernel(GroupArgs a, long long n_valid, long long n_dev) {
  const Layout L = layout(a.ws, n_dev);
  const Scratch S = scratch_layout(a.scratch, n_valid, false);
  for (long long d = blockIdx.x; d < n_dev; d += gridDim.x) {
    const long long kc = L.kept[d];
    if (kc == 0) continue;
    const long long ko = L.kept_off[d];
    const long long u = L.u_idx[d];
    const TV* src = S.tv + L.off[d];
    if (threadIdx.x == 0) {
      a.u_dev[u] = d;
      a.start_idx[u] = ko;
      a.end_idx[u] = ko + kc - 1;
    }
    for (long long j = threadIdx.x; j < kc; j += kEmitThreads) {
      const TV x = src[j];
      a.dev_o[ko + j] = d;
      a.t_o[ko + j] = x.t;
      a.v_o[ko + j] = x.v;
      a.seg[ko + j] = u;
      a.first[ko + j] = j == 0;
    }
  }
}

inline unsigned stream_blocks(long long k) {
  // enough resident blocks to fill the card; the loops stride over the rest
  const long long want = (k + kThreads - 1) / kThreads;
  return (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

inline unsigned grid_x(long long n) {
  return (unsigned)(n < 0x7fffffffLL ? n : 0x7fffffffLL);
}

inline unsigned grid_y(long long n) {
  return (unsigned)(n < 65535 ? n : 65535);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

#define STREAM_GROUP_CHECK()                         \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

extern "C" int64_t stream_group_workspace_bytes(int64_t n_dev) {
  return (int64_t)layout(nullptr, n_dev).bytes;
}

extern "C" int64_t stream_group_scratch_bytes(int64_t n_valid, int wide) {
  return (int64_t)scratch_layout(nullptr, n_valid, wide != 0).bytes;
}

static GroupArgs unpack(void* const* ptrs) {
  static_assert(sizeof(GroupArgs) == kNumPointers * sizeof(void*),
                "GroupArgs must be exactly the pointer list");
  GroupArgs a;
  memcpy(&a, ptrs, sizeof(a));
  return a;
}

// (1)-(3): zero, count, offsets.  Reads dev, t, v; writes ws.
extern "C" int stream_group_count_launch(void* const* ptrs, int64_t k,
                                         int64_t n_dev, void* stream) {
  const GroupArgs a = unpack(ptrs);
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L = layout(a.ws, n_dev);
  const cudaError_t e = cudaMemsetAsync(a.ws, 0, L.zeroed, s);
  if (e != cudaSuccess) return (int)e;
  if (k > 0) {
    group_count_kernel<<<stream_blocks(k), kThreads, 0, s>>>(a, k, n_dev);
    STREAM_GROUP_CHECK();
  }
  group_offsets_kernel<<<1, kScanThreads, 0, s>>>(a, n_dev);
  STREAM_GROUP_CHECK();
  return 0;
}

// (4)-(6): scatter, sort and flag (and the wide route), kept offsets.
extern "C" int stream_group_sort_launch(void* const* ptrs, int64_t k,
                                        int64_t n_dev, int64_t n_valid,
                                        int64_t n_wide, int64_t max_bucket,
                                        void* stream) {
  const GroupArgs a = unpack(ptrs);
  cudaStream_t s = (cudaStream_t)stream;
  group_scatter_kernel<<<stream_blocks(k), kThreads, 0, s>>>(a, k, n_dev);
  STREAM_GROUP_CHECK();
  const long long sort_blocks = (n_dev + kSortWarps - 1) / kSortWarps;
  group_sort_kernel<16><<<grid_x(sort_blocks), kThreads, 0, s>>>(a, n_valid,
                                                                 n_dev);
  STREAM_GROUP_CHECK();
  if (max_bucket > 512) {
    group_sort_kernel<32><<<grid_x(sort_blocks), kThreads, 0, s>>>(
        a, n_valid, n_dev);
    STREAM_GROUP_CHECK();
  }
  if (n_wide > 0) {
    const long long chunks = (max_bucket + kChunk - 1) / kChunk;
    dim3 g1(grid_x((chunks + kSortWarps - 1) / kSortWarps), grid_y(n_wide));
    group_wide_chunks_kernel<<<g1, kThreads, 0, s>>>(a, n_valid, n_dev,
                                                     n_wide);
    STREAM_GROUP_CHECK();
    int in_rec2 = 1;
    dim3 g2(grid_x((max_bucket + kMergeTile - 1) / kMergeTile),
            grid_y(n_wide));
    for (long long run = kChunk; run < max_bucket; run *= 2) {
      group_wide_merge_kernel<<<g2, kThreads, 0, s>>>(a, n_valid, n_dev,
                                                      n_wide, run, in_rec2);
      STREAM_GROUP_CHECK();
      in_rec2 = !in_rec2;
    }
    group_wide_keep_kernel<<<grid_y(n_wide), kScanThreads, 0, s>>>(
        a, n_valid, n_dev, n_wide, in_rec2);
    STREAM_GROUP_CHECK();
  }
  group_kept_kernel<<<1, kScanThreads, 0, s>>>(a, n_dev);
  STREAM_GROUP_CHECK();
  return 0;
}

// (7): the outputs.
extern "C" int stream_group_emit_launch(void* const* ptrs, int64_t n_dev,
                                        int64_t n_valid, void* stream) {
  const GroupArgs a = unpack(ptrs);
  group_emit_kernel<<<grid_x(n_dev), kEmitThreads, 0, (cudaStream_t)stream>>>(
      a, n_valid, n_dev);
  STREAM_GROUP_CHECK();
  return 0;
}

extern "C" const char* stream_group_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int stream_group_num_pointers() { return kNumPointers; }
