// flash_attention_bwd_tc: the backward of forward attention on Hopper's
// tensor cores, for bf16 and f16 inputs whose head_dim is a multiple of
// 16, in two kernels: B2 (flash_attention_bwd_tc_dq_launch) and B3
// (flash_attention_bwd_tc_dkdv_launch).  f32, and a 16-bit head_dim that
// is not a multiple of 16, run on the CUDA cores (flash_attention_bwd.cu);
// the wrapper chooses before launch by the forward's rule.
//
// Replaces no TPU kernel: the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py:25) has no backward, and the
// reference trains by differentiating its jnp oracle `blocked_attention`
// (src/repro/models/layers.py:149).
//
// It computes what flash_attention_bwd.cu's header states, with f32
// accumulators.  As the forward's PV product does, P and dS are rounded
// to the input type where they enter a product as its A operand
// (FlashAttention-2 and -3 do the same).  exp is exp2 with log2(e) folded
// into the scores (f32 ulps apart).
//
// Bound on an H100 SXM: operations, 10 * D FLOPs for each kept (query
// head, key) pair at 989 TFLOP/s (dense bf16/f16).  The kernels execute
// 16 * D (B2 recomputes lse with a pass of S; B3 recomputes S and dP),
// every product on wgmma, the CUDA cores kept to the softmax's
// elementwise work:
//
// * B2 (dq).  A row is a (query position, query head of the group) pair,
//   as in the forward, so each K/V tile serves the whole group: 64 rows a
//   consumer warpgroup, two warpgroups a block (one at DMAX = 256, where
//   Q and dO for 128 rows would leave no room for the ring), and a
//   producer warp that keeps 64-key tiles in flight by TMA in a 2-stage
//   mbarrier ring (K in pass 1, K and V in pass 2; 4-D tensor maps over
//   [B, T, Hkv, D], 128-byte swizzle, zero fill past T and D).  Q and dO
//   are loaded once into the same swizzled layout.  delta = rowsum(dO * O)
//   a quad of threads a row; pass 1: S = Q K^T (m64n64k16) and the online
//   max / sum give lse, written [B, Hq, S] f32 with delta for B3; pass 2:
//   S and dP = dO V^T (m64n64k16), dS = P (dP - delta) (1 - t^2 where
//   soft-capped) in registers, then dQ += dS K (m64n{DMAX}k16, dS in the
//   input type as the register A operand, K read through the transpose
//   bit).  The last query tiles launch first: they see the most keys.
// * B3 (dk, dv).  A block owns a tile of keys of one KV head and keeps its
//   K and V in shared memory: 128 keys, 64 a consumer warpgroup, for
//   DMAX <= 128; at DMAX = 256, 64 keys with each warpgroup owning half of
//   dK's and dV's columns (all of them would be 256 f32 registers a
//   thread), both computing S^T and dP^T.  A producer warp brings the
//   64-position Q and dO tiles of every query head of the group that sees
//   the keys through a TMA ring, with their lse and delta.  S^T = K Q^T and
//   dP^T = V dO^T (m64n64k16, keys as M), P^T and dS^T in registers, then
//   dV += P^T dO and dK += dS^T Q (m64n{64,128}k16, P^T and dS^T in the
//   input type as register A operands, dO and Q through the transpose
//   bit).  The first key tiles launch first: under a causal mask they see
//   the most queries.
// * Masks apply only on tiles that straddle the diagonal, the window's
//   edge, S or T; tiles outside the masks are never loaded.  A masked
//   entry has P = 0, so a row that sees no key gets zero gradients.
// * No atomics: every output element has one writer, so the gradients
//   are deterministic.
//
// Shared memory at DMAX = 256: B2 Q 32 KB + dO 32 KB + 2 stages x (K 32 KB
// + V 32 KB); B3 K 32 KB + V 32 KB + 2 stages x (Q 32 KB + dO 32 KB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kWgRows = 64;        // rows of a consumer warpgroup (wgmma M)
constexpr int kTileRows = 64;      // keys of B2's tiles, positions of B3's
constexpr int kStages = 2;         // the TMA ring
constexpr int kSwizzleRow = 128;   // bytes of one swizzled row (64 halves)
constexpr int kAtom = 8 * kSwizzleRow;       // one 128-byte swizzle atom
constexpr int kBox = kTileRows * kSwizzleRow;  // one [64 rows, 64] box
constexpr int kDkvConsumers = 2;   // B3's consumer warpgroups
constexpr int kDkvThreads = 128 * (1 + kDkvConsumers);
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kEncodeError = 100000;  // + CUresult of a refused tensor map

struct BwdArgs {
  // inputs q, o, dout [B, S, Hq, D], k and v [B, T, Hkv, D]; lse and
  // delta [B, Hq, S] f32 (written by B2, read by B3); outputs dq
  // [B, S, Hq, D], dk and dv [B, T, Hkv, D]
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
};

constexpr int kNumPointers = 10;

struct Shape {
  int B, S, T, Hq, Hkv, D, G;
  int heads_per_tile;   // B2: GB, query heads of one group in a block
  int pos_per_tile;     // B2: BQ, query positions in a block
  int head_tiles;       // B2: ceil(G / GB)
  int causal, window;
  float softcap, scale;
};

template <int DMAX>
struct DqSmem {
  static constexpr int kConsumers = DMAX == 256 ? 1 : 2;
  static constexpr int kRows = kWgRows * kConsumers;   // rows a block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBoxes = DMAX / 64;             // 64-element boxes
  static constexpr int kRowBox = kRows * kSwizzleRow;
  static constexpr int kQ = kBoxes * kRowBox;          // Q, and dO
  static constexpr int kTile = kBoxes * kBox;          // one K or V tile
  static constexpr int kBars = 2 * kQ + 2 * kStages * kTile;
  // + the barriers, + slack to align the base to a swizzle atom
  static constexpr int kBytes = kBars + 2 * kStages * 8 + kAtom;
};

template <int DMAX>
struct DkvSmem {
  // at DMAX = 256 the warpgroups share the keys and halve the columns
  static constexpr bool kSplitCols = DMAX == 256;
  static constexpr int kKeys = kSplitCols ? kWgRows : 2 * kWgRows;
  static constexpr int kCols = kSplitCols ? DMAX / 2 : DMAX;
  static constexpr int kBoxes = DMAX / 64;
  static constexpr int kKeyBox = kKeys * kSwizzleRow;
  static constexpr int kKV = kBoxes * kKeyBox;         // K, and V
  static constexpr int kQTile = kBoxes * kBox;         // one Q or dO tile
  static constexpr int kStats = kStages * 2 * kTileRows * 4;  // lse, delta
  static constexpr int kBars = 2 * kKV + 2 * kStages * kQTile + kStats;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + kAtom;
};

// two packed 16-bit values as f32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  __half2 h;
  memcpy(&h, &u, sizeof(h));
  return __half22float2(h);
}
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, sizeof(h));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ bool kept(const Shape& sh, int qp, int key) {
  bool ok = qp < sh.S && key < sh.T;
  if (sh.causal) ok = ok && key <= qp;
  if (sh.window > 0) ok = ok && key > qp - sh.window;
  return ok;
}

// the extern shared buffer, its base raised to a swizzle atom
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kAtom - (a & (kAtom - 1))) & (kAtom - 1));
}

// d = A B^T over DMAX columns: A's 64 rows K-major at `a` (boxes
// `a_box` bytes apart), B's 64 rows K-major at `bt` (boxes kBox apart)
template <typename T, int DMAX>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a,
                                         int a_box, uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 16 elements in the atom
    mma_qk<T>(d, gmma_desc(a + (kk / 4) * a_box + step, 16, kAtom),
              gmma_desc(bt + (kk / 4) * kBox + step, 16, kAtom), kk > 0);
  }
}

// d += A B over 64 rows of the contraction: A from registers, B's 64
// rows of N columns at `b` in [boxes][64 rows][128 B] (transpose bit)
template <typename T, int N>
__device__ __forceinline__ void mma_cols(float (&d)[N / 2],
                                         uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk) {
    mma_pv<T, N>(d, a[kk], gmma_desc(b + kk * 16 * kSwizzleRow, kBox, kAtom));
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(DqSmem<DMAX>::kThreads, 1)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const T* __restrict__ q, const T* __restrict__ o,
                     const T* __restrict__ dout, float* __restrict__ lse_out,
                     float* __restrict__ delta_out, T* __restrict__ dq,
                     Shape sh) {
  using L = DqSmem<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* sQ = smem;                        // [boxes][kRows][128 B]
  uint8_t* sdO = sQ + L::kQ;                 // the same
  uint8_t* sK = sdO + L::kQ;                 // [stage][boxes][64 keys][128 B]
  uint8_t* sV = sK + kStages * L::kTile;     // the same
  const uint32_t full0 = smem_u32(smem + L::kBars);
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int GB = sh.heads_per_tile;
  const int BQ = sh.pos_per_tile;
  // the last query positions first: they see the most keys
  const int tile = (int)gridDim.x - 1 - (int)blockIdx.x;
  const int qt = tile / sh.head_tiles;
  const int g0 = (tile - qt * sh.head_tiles) * GB;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = qt * BQ;
  const int q_hi = min(i0 + BQ, sh.S) - 1;
  // the keys any row of this block may see
  int k_begin = 0, k_end = sh.T;
  if (sh.window > 0) k_begin = max(0, i0 - sh.window + 1);
  if (sh.causal) k_end = min(k_end, q_hi + 1);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTileRows - 1) / kTileRows : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, L::kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full; the ring's loads i <
    // n_tiles are pass 1's (K), the next n_tiles pass 2's (K and V)
    if constexpr (L::kConsumers > 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    if (tid == 0) {
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) - 1) & 1);
        const bool with_v = i >= n_tiles;
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, (with_v ? 2 : 1) * L::kTile);
        const int k0 = k_begin + (with_v ? i - n_tiles : i) * kTileRows;
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
          const int off = s * L::kTile + j * kBox;
          tma_load(smem_u32(sK + off), &tm_k, full, 64 * j, hkv, k0, b);
          if (with_v) {
            tma_load(smem_u32(sV + off), &tm_v, full, 64 * j, hkv, k0, b);
          }
        }
      }
    }
  } else {
    if constexpr (L::kConsumers > 1) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    }
    const int cw = wg - 1;          // consumer warpgroup
    const int ct = tid - 128 * wg;  // its thread
    const int D = sh.D;

    // row r of the block: position i0 + r / GB, head hkv * G + g0 + r % GB
    auto row_ok = [&](int r) {
      return r < BQ * GB && i0 + r / GB < sh.S && g0 + r % GB < sh.G;
    };
    auto row_offset = [&](int r) {
      return (((int64_t)b * sh.S + i0 + r / GB) * sh.Hq + hkv * sh.G + g0 +
              r % GB) * D;
    };
    auto row_stat = [&](int r) {
      return ((int64_t)b * sh.Hq + hkv * sh.G + g0 + r % GB) * sh.S + i0 +
             r / GB;
    };

    // Q and dO, this warpgroup's 64 rows, into the swizzled layout
    constexpr int kChunks = DMAX / 8;  // 16-byte chunks a row
    for (int idx = ct; idx < kWgRows * kChunks; idx += 128) {
      const int r = cw * kWgRows + idx / kChunks;
      const int c = idx % kChunks;
      uint4 xq = make_uint4(0u, 0u, 0u, 0u), xg = xq;
      if (c * 8 < D && row_ok(r)) {
        xq = *reinterpret_cast<const uint4*>(q + row_offset(r) + c * 8);
        xg = *reinterpret_cast<const uint4*>(dout + row_offset(r) + c * 8);
      }
      const int at = (c / 8) * L::kRowBox + r * kSwizzleRow +
                     (((c % 8) ^ (r % 8)) * 16);
      *reinterpret_cast<uint4*>(sQ + at) = xq;
      *reinterpret_cast<uint4*>(sdO + at) = xg;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");

    // this thread's fragment: rows r0 and r0 + 8 of the block, columns
    // 8n + 2 (lane % 4) + {0, 1}
    const int warp = ct / 32, lane = ct % 32;
    const int r0 = cw * kWgRows + warp * 16 + lane / 4;
    const int qp[2] = {i0 + r0 / GB, i0 + (r0 + 8) / GB};
    const int col = 2 * (lane % 4);

    // delta = rowsum(dO * O): a row's quad takes every fourth 8-element
    // chunk of it
    float delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float acc = 0.f;
      if (row_ok(r)) {
        const T* orow = o + row_offset(r);
        const T* grow = dout + row_offset(r);
        for (int c = 8 * (lane % 4); c < D; c += 32) {
          const uint4 xo = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 xg = *reinterpret_cast<const uint4*>(grow + c);
          const uint32_t wo[4] = {xo.x, xo.y, xo.z, xo.w};
          const uint32_t wg2[4] = {xg.x, xg.y, xg.z, xg.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = unpack2<T>(wo[e]), g = unpack2<T>(wg2[e]);
            acc = __fmaf_rn(a.x, g.x, acc);
            acc = __fmaf_rn(a.y, g.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[h] = acc;
      if (lane % 4 == 0 && row_ok(r)) delta_out[row_stat(r)] = acc;
    }

    const bool capped = sh.softcap > 0.f;
    const float s_scale = capped ? sh.scale / sh.softcap : sh.scale * kLog2e;
    const float s_cap = sh.softcap * kLog2e;
    const uint32_t q_desc = smem_u32(sQ) + cw * kWgRows * kSwizzleRow;
    const uint32_t do_desc = smem_u32(sdO) + cw * kWgRows * kSwizzleRow;
    // a tile needs its mask where it straddles T, the diagonal or the
    // window's lower edge for some row of the block
    auto masked = [&](int k0) {
      return k0 + kTileRows > sh.T ||
             (sh.causal && k0 + kTileRows - 1 > i0) ||
             (sh.window > 0 && k0 <= q_hi - sh.window);
    };

    // pass 1: the rows' log-sum-exp (log2 units) over the kept keys
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = k_begin + i * kTileRows;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      mma_rows<T, DMAX>(sc, q_desc, L::kRowBox, smem_u32(sK + s * L::kTile));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(empty0 + 8 * s);

      const bool mask = masked(k0);
      uint32_t keep = 0xffffffffu;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j / 2) % 2;
        const int key = k0 + 8 * (j / 4) + col + j % 2;
        float x = capped ? s_cap * tanhf(sc[j] * s_scale) : sc[j] * s_scale;
        if (mask && !kept(sh, qp[h], key)) {
          x = kNegInf;
          keep &= ~(1u << j);
        }
        sc[j] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2], m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        m_safe[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
        alpha[h] = m[h] <= kNegInf / 2 ? 0.f : exp2f(m[h] - m_safe[h]);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j / 2) % 2;
        sum[h] += (keep >> j) & 1u ? exp2f(sc[j] - m_safe[h]) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
    }
    float lse2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      lse2[h] = l[h] > 0.f ? m[h] + log2f(l[h]) : 0.f;
      const int r = r0 + 8 * h;
      if (lane % 4 == 0 && row_ok(r)) lse_out[row_stat(r)] = lse2[h] * kLn2;
    }

    // pass 2: dS, and dQ += dS K
    float acc[DMAX / 2];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int it = n_tiles + i;
      const int s = it % kStages;
      const int k0 = k_begin + i * kTileRows;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t k_base = smem_u32(sK + s * L::kTile);
      const uint32_t v_base = smem_u32(sV + s * L::kTile);

      // S = Q K^T, dP = dO V^T
      float sc[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_rows<T, DMAX>(sc, q_desc, L::kRowBox, k_base);
      mma_rows<T, DMAX>(dp, do_desc, L::kRowBox, v_base);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - delta) (1 - t^2), rounded to T as dQ's A operand
      const bool mask = masked(k0);
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j / 2) % 2;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * (j / 4) + col + e;
          float t = 0.f, x;
          if (capped) {
            t = tanhf(sc[j + e] * s_scale);
            x = s_cap * t;
          } else {
            x = sc[j + e] * s_scale;
          }
          const float p = !mask || kept(sh, qp[h], key)
                              ? exp2f(x - lse2[h]) : 0.f;
          const float g = p * (dp[j + e] - delta[h]);
          ds[e] = capped ? g * (1.f - t * t) : g;
        }
        // S columns 16kk .. 16kk + 15 are the A fragment of k-step kk
        da[j / 8][(j % 8) / 2] = pack2<T>(ds[0], ds[1]);
      }

      fence_regs(acc);
      wgmma_fence();
      mma_cols<T, DMAX>(acc, da, k_base);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (!row_ok(r)) continue;
      T* dst = dq + row_offset(r);
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        const int c = 8 * n + col;
        if (c < D) {
          *reinterpret_cast<uint32_t*>(dst + c) =
              pack2<T>(acc[4 * n + 2 * h] * sh.scale,
                       acc[4 * n + 2 * h + 1] * sh.scale);
        }
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kDkvThreads, 1)
    bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, Shape sh) {
  using L = DkvSmem<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* sK = smem;                        // [boxes][kKeys][128 B]
  uint8_t* sV = sK + L::kKV;                 // the same
  uint8_t* sQ = sV + L::kKV;                 // [stage][boxes][64 pos][128 B]
  uint8_t* sdO = sQ + kStages * L::kQTile;   // the same
  // [stage][64]: lse in log2 units, and delta, of the stage's positions
  float* sLse = reinterpret_cast<float*>(sdO + kStages * L::kQTile);
  float* sDelta = sLse + kStages * kTileRows;
  const uint32_t full0 = smem_u32(smem + L::kBars);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t kv_bar = empty0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int j0 = blockIdx.x * L::kKeys;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int j_last = min(j0 + L::kKeys, sh.T) - 1;
  // the query positions that see a key of the tile
  const int q_lo = sh.causal ? j0 : 0;
  int q_hi = sh.S - 1;
  if (sh.window > 0) q_hi = min(q_hi, j_last + sh.window - 1);
  const int n_qt = q_hi >= q_lo ? (q_hi - q_lo) / kTileRows + 1 : 0;
  const int n_loads = sh.G * n_qt;   // head g's tile t is load g n_qt + t

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, kDkvConsumers * 128);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp 0; lane 0 issues the TMA loads, every lane stages
    // lse and delta and arrives on the stage's barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kKV);
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
#pragma unroll
          for (int half = 0; half < L::kKeys / kTileRows; ++half) {
            const int off = j * L::kKeyBox + half * kBox;
            const int key = j0 + half * kTileRows;
            tma_load(smem_u32(sK + off), &tm_k, kv_bar, 64 * j, hkv, key, b);
            tma_load(smem_u32(sV + off), &tm_v, kv_bar, 64 * j, hkv, key, b);
          }
        }
      }
      for (int it = 0; it < n_loads; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
        const int g = it / n_qt;
        const int i0 = q_lo + (it - g * n_qt) * kTileRows;
        const int h = hkv * sh.G + g;
        const int64_t stat = ((int64_t)b * sh.Hq + h) * sh.S;
        for (int c = lane; c < kTileRows; c += 32) {
          const bool in = i0 + c < sh.S;
          sLse[s * kTileRows + c] = in ? lse[stat + i0 + c] * kLog2e : 0.f;
          sDelta[s * kTileRows + c] = in ? delta[stat + i0 + c] : 0.f;
        }
        const uint32_t full = full0 + 8 * s;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * L::kQTile);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j) {
            const int off = s * L::kQTile + j * kBox;
            tma_load(smem_u32(sQ + off), &tm_q, full, 64 * j, h, i0, b);
            tma_load(smem_u32(sdO + off), &tm_do, full, 64 * j, h, i0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;          // consumer warpgroup
    const int ct = tid - 128 * wg;  // its thread
    const int warp = ct / 32, lane = ct % 32;
    const int key_row = L::kSplitCols ? 0 : cw * kWgRows;  // its keys
    const int col0 = L::kSplitCols ? cw * L::kCols : 0;    // its columns
    // this thread's fragment: keys kp[0] and kp[1], query positions
    // 8n + 2 (lane % 4) + {0, 1} of the tile
    const int r0 = key_row + warp * 16 + lane / 4;
    const int kp[2] = {j0 + r0, j0 + r0 + 8};
    const int col = 2 * (lane % 4);

    const bool capped = sh.softcap > 0.f;
    const float s_scale = capped ? sh.scale / sh.softcap : sh.scale * kLog2e;
    const float s_cap = sh.softcap * kLog2e;
    const uint32_t k_desc = smem_u32(sK) + key_row * kSwizzleRow;
    const uint32_t v_desc = smem_u32(sV) + key_row * kSwizzleRow;

    float acc_k[L::kCols / 2], acc_v[L::kCols / 2];
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_loads; ++it) {
      const int s = it % kStages;
      const int i0 = q_lo + (it % n_qt) * kTileRows;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t q_base = smem_u32(sQ + s * L::kQTile);
      const uint32_t do_base = smem_u32(sdO + s * L::kQTile);
      const float* st_lse = sLse + s * kTileRows;
      const float* st_delta = sDelta + s * kTileRows;

      // S^T = K Q^T, dP^T = V dO^T
      float sc[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_rows<T, DMAX>(sc, k_desc, L::kKeyBox, q_base);
      mma_rows<T, DMAX>(dp, v_desc, L::kKeyBox, do_base);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T, rounded to T as the A operands of dV and dK
      const bool mask = i0 + kTileRows > sh.S || j0 + L::kKeys > sh.T ||
                        (sh.causal && j0 + L::kKeys - 1 > i0) ||
                        (sh.window > 0 &&
                         j0 <= i0 + kTileRows - 1 - sh.window);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j / 2) % 2;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (j / 4) + col + e;  // position in the tile
          float t = 0.f, x;
          if (capped) {
            t = tanhf(sc[j + e] * s_scale);
            x = s_cap * t;
          } else {
            x = sc[j + e] * s_scale;
          }
          p[e] = !mask || kept(sh, i0 + c, kp[h]) ? exp2f(x - st_lse[c])
                                                   : 0.f;
          const float g = p[e] * (dp[j + e] - st_delta[c]);
          ds[e] = capped ? g * (1.f - t * t) : g;
        }
        pa[j / 8][(j % 8) / 2] = pack2<T>(p[0], p[1]);
        da[j / 8][(j % 8) / 2] = pack2<T>(ds[0], ds[1]);
      }

      // dV += P^T dO, dK += dS^T Q over this warpgroup's columns
      fence_regs(acc_v);
      fence_regs(acc_k);
      wgmma_fence();
      mma_cols<T, L::kCols>(acc_v, pa, do_base + (col0 / 64) * kBox);
      mma_cols<T, L::kCols>(acc_k, da, q_base + (col0 / 64) * kBox);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(empty0 + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kp[h];
      if (key >= sh.T) continue;
      const int64_t off = (((int64_t)b * sh.T + key) * sh.Hkv + hkv) * sh.D;
#pragma unroll
      for (int n = 0; n < L::kCols / 8; ++n) {
        const int c = col0 + 8 * n + col;
        if (c < sh.D) {
          *reinterpret_cast<uint32_t*>(dk + off + c) =
              pack2<T>(acc_k[4 * n + 2 * h] * sh.scale,
                       acc_k[4 * n + 2 * h + 1] * sh.scale);
          *reinterpret_cast<uint32_t*>(dv + off + c) =
              pack2<T>(acc_v[4 * n + 2 * h], acc_v[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

// a 4-D map over x [B, N, H, D], boxes [1, 64 rows, 1, 64 elements]
int encode_rows(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int B, int N, int H, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {es * D, es * D * H, es * D * H * N};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTileRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int DMAX>
int launch_dq(const BwdArgs& a, Shape sh, cudaStream_t stream) {
  using L = DqSmem<DMAX>;
  static bool configured = false;
  if (int err = allow_smem(bwd_dq_tc_kernel<T, DMAX>, L::kBytes, configured)) {
    return err;
  }
  sh.heads_per_tile = sh.G < L::kRows ? sh.G : L::kRows;
  sh.pos_per_tile = L::kRows / sh.heads_per_tile;
  sh.head_tiles = (sh.G + sh.heads_per_tile - 1) / sh.heads_per_tile;
  const int64_t nx = (int64_t)((sh.S + sh.pos_per_tile - 1) /
                               sh.pos_per_tile) * sh.head_tiles;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tm_k, tm_v;
  int rc = encode_rows(&tm_k, a.k, map_type<T>(), sh.B, sh.T, sh.Hkv, sh.D);
  if (rc == 0) {
    rc = encode_rows(&tm_v, a.v, map_type<T>(), sh.B, sh.T, sh.Hkv, sh.D);
  }
  if (rc != 0) return rc;
  const dim3 grid((unsigned)nx, (unsigned)sh.Hkv, (unsigned)sh.B);
  bwd_dq_tc_kernel<T, DMAX><<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_k, tm_v, (const T*)a.q, (const T*)a.o, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dq, sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkdv(const BwdArgs& a, const Shape& sh, cudaStream_t stream) {
  using L = DkvSmem<DMAX>;
  static bool configured = false;
  if (int err = allow_smem(bwd_dkdv_tc_kernel<T, DMAX>, L::kBytes,
                           configured)) {
    return err;
  }
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int rc = encode_rows(&tm_q, a.q, map_type<T>(), sh.B, sh.S, sh.Hq, sh.D);
  if (rc == 0) {
    rc = encode_rows(&tm_do, a.dout, map_type<T>(), sh.B, sh.S, sh.Hq, sh.D);
  }
  if (rc == 0) {
    rc = encode_rows(&tm_k, a.k, map_type<T>(), sh.B, sh.T, sh.Hkv, sh.D);
  }
  if (rc == 0) {
    rc = encode_rows(&tm_v, a.v, map_type<T>(), sh.B, sh.T, sh.Hkv, sh.D);
  }
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((sh.T + L::kKeys - 1) / L::kKeys),
                  (unsigned)sh.Hkv, (unsigned)sh.B);
  bwd_dkdv_tc_kernel<T, DMAX><<<grid, kDkvThreads, L::kBytes, stream>>>(
      tm_q, tm_do, tm_k, tm_v, a.lse, a.delta, (T*)a.dk, (T*)a.dv, sh);
  return (int)cudaGetLastError();
}

template <typename T, bool kDq>
int launch_dim(const BwdArgs& a, const Shape& sh, cudaStream_t stream) {
  if (sh.D <= 64) {
    return kDq ? launch_dq<T, 64>(a, sh, stream)
               : launch_dkdv<T, 64>(a, sh, stream);
  }
  if (sh.D <= 128) {
    return kDq ? launch_dq<T, 128>(a, sh, stream)
               : launch_dkdv<T, 128>(a, sh, stream);
  }
  return kDq ? launch_dq<T, 256>(a, sh, stream)
             : launch_dkdv<T, 256>(a, sh, stream);
}

template <bool kDq>
int launch(void* const* ptrs, int B, int S, int T, int Hq, int Hkv, int D,
           int dtype, int causal, int window, float softcap, float scale,
           void* stream) {
  static_assert(sizeof(BwdArgs) == kNumPointers * sizeof(void*),
                "BwdArgs must be exactly the pointer list");
  BwdArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (B <= 0 || S <= 0 || T <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || D % 16 != 0 ||
      B > 65535 || Hkv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < kNumPointers; ++i) {
    if ((uintptr_t)ptrs[i] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  Shape sh;
  sh.B = B; sh.S = S; sh.T = T; sh.Hq = Hq; sh.Hkv = Hkv; sh.D = D;
  sh.G = Hq / Hkv;
  sh.heads_per_tile = sh.pos_per_tile = sh.head_tiles = 0;  // B2 sets them
  sh.causal = causal; sh.window = window;
  sh.softcap = softcap; sh.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 1: return launch_dim<__half, kDq>(a, sh, st);
    case 2: return launch_dim<__nv_bfloat16, kDq>(a, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// ptrs: the 10 device pointers in BwdArgs field order, each 16-byte
// aligned (a null pointer passes), the tensors contiguous.  dtype: 1
// half, 2 bfloat16; D a multiple of 16, at most 256.  B2: one block per
// (query tile, KV head, batch); writes lse, delta and dq.  B3 (after B2,
// on the same stream): one block per (key tile, KV head, batch); reads
// lse and delta, writes dk and dv.  Each returns the launch error (0 on
// success).
extern "C" int flash_attention_bwd_tc_dq_launch(void* const* ptrs, int B,
                                                int S, int T, int Hq,
                                                int Hkv, int D, int dtype,
                                                int causal, int window,
                                                float softcap, float scale,
                                                void* stream) {
  return repro_torch::launch<true>(ptrs, B, S, T, Hq, Hkv, D, dtype, causal,
                                   window, softcap, scale, stream);
}

extern "C" int flash_attention_bwd_tc_dkdv_launch(void* const* ptrs, int B,
                                                  int S, int T, int Hq,
                                                  int Hkv, int D, int dtype,
                                                  int causal, int window,
                                                  float softcap, float scale,
                                                  void* stream) {
  return repro_torch::launch<false>(ptrs, B, S, T, Hq, Hkv, D, dtype, causal,
                                    window, softcap, scale, stream);
}

extern "C" const char* flash_attention_bwd_tc_error_string(int code) {
  if (code >= repro_torch::kEncodeError) {
    static char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled refused a tensor "
             "map (CUresult %d)", code - repro_torch::kEncodeError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int flash_attention_bwd_tc_num_pointers() {
  return repro_torch::kNumPointers;
}
