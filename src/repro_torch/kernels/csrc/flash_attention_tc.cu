// flash_attention_tc: forward attention on Hopper's tensor cores, for
// bf16 and f16 inputs whose head_dim is a multiple of 16.
//
// Replaces the TPU kernel `_flash_kernel` (`flash_attention`,
// src/repro/kernels/flash_attention.py:25,94) for the 16-bit inputs; f32
// and a 16-bit head_dim that is not a multiple of 16 run on the CUDA
// cores (flash_attention.cu), the wrapper choosing before launch.  It
// computes what flash_attention.cu's header states, for q [B, S, Hq, D],
// k and v [B, T, Hkv, D], query head h reading KV head h / G:
//
//   s = (q . k) * scale in f32, soft-capped; masked (ragged, causal,
//   window) to -1e30; online softmax over 64-key tiles with the
//   reference's m_safe / alpha guards; l sums the f32 p, the PV product
//   takes p rounded to the input type and accumulates in f32; out =
//   acc / max(l, 1e-20).  A row with no valid key gives 0.
//
// exp is exp2 with log2(e) folded into the scores (f32 ulps apart).
//
// Bound on an H100 SXM: operations, 4 * D FLOPs for each (query head,
// key) pair the masks keep, at 989 TFLOP/s (dense bf16/f16).  The design
// puts both products on wgmma and keeps the CUDA cores to the softmax:
//
// * Rows and blocks.  A row is a (query position, query head of the
//   group) pair, the group's heads side by side, so every K/V tile is
//   shared by the whole MQA/GQA group.  One block owns 128 rows: two
//   consumer warpgroups of 64 rows (wgmma's M) and one producer warp.
//   A group wider than 128 heads takes several blocks of one position;
//   a group that does not divide 128 leaves padding rows, zero in Q,
//   never written.
// * K and V through TMA.  The producer loads 64-key tiles through 4-D
//   tensor maps over [B, T, Hkv, D], each tile as DMAX / 64 boxes of
//   [1, 64 keys, 1, 64 elements] with the 128-byte swizzle; a box past T
//   or past D is zero-filled by the hardware (a flattened 2-D view would
//   read the next KV head or batch there).  Tiles go into a 2-stage ring
//   with mbarrier completion.  Q is loaded once, with 16-byte loads into
//   the same swizzled layout.
// * S = Q K^T: wgmma m64n64k16, Q and K both K-major from shared memory,
//   f32 accumulators; scale, soft-cap and mask applied in registers, the
//   mask only on tiles that straddle the diagonal, the window's lower
//   edge or T.  Tiles wholly above the diagonal or below the window are
//   never loaded.
// * Online softmax in registers: a row lives in the 4 threads of a quad
//   (row max through two shuffles; l kept per thread and summed at the
//   end, since alpha is the row's).
// * O += P V: wgmma m64n{DMAX}k16 with P rounded to the input type in
//   registers (the S accumulator's fragment is the A operand's layout)
//   and V from shared memory in its natural [keys, D] layout, read
//   through the transpose bit.  At DMAX = 256 the accumulator is 128 f32
//   a thread; setmaxnreg moves registers from the producer to the
//   consumers.
//
// Shared memory at DMAX = 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB).

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

constexpr int kRows = 128;         // query rows per block
constexpr int kWgRows = 64;        // rows per consumer warpgroup
constexpr int kKeys = 64;          // keys per K/V tile
constexpr int kStages = 2;         // K/V ring
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kSwizzleRow = 128;   // bytes of one swizzled row (64 halves)
constexpr int kAtom = 8 * kSwizzleRow;   // one 128-byte swizzle atom
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 100000;  // + CUresult of a refused tensor map

struct FlashArgs {
  // inputs q [B, S, Hq, D], k and v [B, T, Hkv, D]; output o [B, S, Hq, D]
  const void* q;
  const void* k;
  const void* v;
  void* o;
};

constexpr int kNumPointers = 4;

struct Shape {
  int B, S, T, Hq, Hkv, D, G;
  int heads_per_tile;   // GB: query heads of one group in a block
  int pos_per_tile;     // BQ: query positions in a block
  int head_tiles;       // ceil(G / GB)
  int q_tiles;          // ceil(S / BQ)
  int causal, window;
  float softcap, scale;
};

template <int DMAX>
struct Smem {
  static constexpr int kBoxes = DMAX / 64;            // 64-element boxes
  static constexpr int kKeyBox = kKeys * kSwizzleRow;  // 8 KB
  static constexpr int kQBox = kRows * kSwizzleRow;    // 16 KB
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kTile = kBoxes * kKeyBox;      // one K or V tile
  static constexpr int kBars = kQ + 2 * kStages * kTile;
  // + the barriers, + slack to align the base to a swizzle atom
  static constexpr int kBytes = kBars + 2 * kStages * 8 + kAtom;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const T* __restrict__ q, T* __restrict__ o,
                              Shape sh) {
  using L = Smem<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((kAtom - (raw & (kAtom - 1))) & (kAtom - 1));
  uint8_t* sQ = smem;                        // [boxes][128 rows][128 B]
  uint8_t* sK = sQ + L::kQ;                  // [stage][boxes][64 keys][128 B]
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
      k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * L::kTile);
        const int k0 = k_begin + i * kKeys;
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
          const int off = s * L::kTile + j * L::kKeyBox;
          tma_load(smem_u32(sK + off), &tm_k, full, 64 * j, hkv, k0, b);
          tma_load(smem_u32(sV + off), &tm_v, full, 64 * j, hkv, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
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

    // Q, this warpgroup's 64 rows, into the swizzled layout
    constexpr int kChunks = DMAX / 8;  // 16-byte chunks a row
    for (int idx = ct; idx < kWgRows * kChunks; idx += 128) {
      const int r = cw * kWgRows + idx / kChunks;
      const int c = idx % kChunks;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (c * 8 < D && row_ok(r)) {
        x = *reinterpret_cast<const uint4*>(q + row_offset(r) + c * 8);
      }
      *reinterpret_cast<uint4*>(sQ + (c / 8) * L::kQBox + r * kSwizzleRow +
                                (((c % 8) ^ (r % 8)) * 16)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");

    // this thread's fragment: rows rw and rw + 8 of the warpgroup, columns
    // 8n + 2 (lane % 4) + {0, 1}
    const int warp = ct / 32, lane = ct % 32;
    const int r0 = cw * kWgRows + warp * 16 + lane / 4;
    const int qp[2] = {i0 + r0 / GB, i0 + (r0 + 8) / GB};
    const int col = 2 * (lane % 4);

    float acc[DMAX / 2];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const bool capped = sh.softcap > 0.f;
    const float s_scale = capped ? sh.scale / sh.softcap : sh.scale * kLog2e;
    const float s_cap = sh.softcap * kLog2e;
    const uint32_t q_desc = smem_u32(sQ) + cw * kWgRows * kSwizzleRow;

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = k_begin + i * kKeys;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      const uint32_t k_base = smem_u32(sK + s * L::kTile);
      const uint32_t v_base = smem_u32(sV + s * L::kTile);

      // S = Q K^T
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;  // 16 elements in the atom
        mma_qk<T>(sc,
                  gmma_desc(q_desc + (kk / 4) * L::kQBox + step, 16, kAtom),
                  gmma_desc(k_base + (kk / 4) * L::kKeyBox + step, 16, kAtom),
                  kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, soft-cap (log2 units), mask where the tile needs one
      const bool masked = k0 + kKeys > sh.T ||
                          (sh.causal && k0 + kKeys - 1 > i0) ||
                          (sh.window > 0 && k0 <= q_hi - sh.window);
      uint32_t keep = 0xffffffffu;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j / 2) % 2;
        const int key = k0 + 8 * (j / 4) + col + j % 2;
        float x = capped ? s_cap * tanhf(sc[j] * s_scale) : sc[j] * s_scale;
        if (masked) {
          bool ok = key < sh.T;
          if (sh.causal) ok = ok && key <= qp[h];
          if (sh.window > 0) ok = ok && key > qp[h] - sh.window;
          if (!ok) {
            x = kNegInf;
            keep &= ~(1u << j);
          }
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
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j / 2) % 2;
        const float p0 = (keep >> j) & 1u ? exp2f(sc[j] - m_safe[h]) : 0.f;
        const float p1 =
            (keep >> (j + 1)) & 1u ? exp2f(sc[j + 1] - m_safe[h]) : 0.f;
        sum[h] += p0 + p1;
        // S columns 16kk .. 16kk + 15 are the A fragment of k-step kk
        pa[j / 8][(j % 8) / 2] = pack2<T>(p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
      for (int j = 0; j < DMAX / 2; ++j) acc[j] *= alpha[(j / 2) % 2];

      // O += P V
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        mma_pv<T, DMAX>(acc, pa[kk],
                        gmma_desc(v_base + kk * 16 * kSwizzleRow,
                                  L::kKeyBox, kAtom));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * s);
    }

    // out = acc / max(l, 1e-20), the row's l summed over its quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-20f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (!row_ok(r)) continue;
      T* dst = o + row_offset(r);
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        const int c = 8 * n + col;
        if (c < D) {
          *reinterpret_cast<uint32_t*>(dst + c) = pack2<T>(
              acc[4 * n + 2 * h] / l[h], acc[4 * n + 2 * h + 1] / l[h]);
        }
      }
    }
  }
}

// a 4-D map over k or v [B, T, Hkv, D], boxes [1, 64 keys, 1, 64 elements]
int encode_kv(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              const Shape& sh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)sh.D, (cuuint64_t)sh.Hkv,
                              (cuuint64_t)sh.T, (cuuint64_t)sh.B};
  const cuuint64_t strides[3] = {es * sh.D, es * sh.D * sh.Hkv,
                                 es * sh.D * sh.Hkv * sh.T};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <typename T, int DMAX>
int launch_typed(const FlashArgs& a, const Shape& sh, dim3 grid,
                 cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DMAX>::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_k, tm_v;
  int rc = encode_kv(&tm_k, a.k, type, sh);
  if (rc == 0) rc = encode_kv(&tm_v, a.v, type, sh);
  if (rc != 0) return rc;
  flash_attention_tc_kernel<T, DMAX>
      <<<grid, kThreads, Smem<DMAX>::kBytes, stream>>>(
          tm_k, tm_v, (const T*)a.q, (T*)a.o, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const FlashArgs& a, const Shape& sh, dim3 grid,
               cudaStream_t stream) {
  if (sh.D <= 64) return launch_typed<T, 64>(a, sh, grid, stream);
  if (sh.D <= 128) return launch_typed<T, 128>(a, sh, grid, stream);
  return launch_typed<T, 256>(a, sh, grid, stream);
}

}  // namespace
}  // namespace repro_torch

using repro_torch::FlashArgs;

// ptrs: the 4 device pointers in FlashArgs field order, each 16-byte
// aligned, the tensors contiguous.  dtype: 1 half, 2 bfloat16; D a
// multiple of 16, at most 256.  Launches one block per (query tile, KV
// head, batch) on `stream` and returns the launch error (0 on success).
extern "C" int flash_attention_tc_launch(void* const* ptrs, int B, int S,
                                         int T, int Hq, int Hkv, int D,
                                         int dtype, int causal, int window,
                                         float softcap, float scale,
                                         void* stream) {
  static_assert(sizeof(FlashArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "FlashArgs must be exactly the pointer list");
  FlashArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || D % 16 != 0 ||
      T < 0 || B > 65535 || Hkv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < repro_torch::kNumPointers; ++i) {
    if ((uintptr_t)ptrs[i] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (T == 0) {
    // no key: every row gives 0
    return (int)cudaMemsetAsync(a.o, 0, (size_t)B * S * Hq * D * 2, st);
  }
  repro_torch::Shape sh;
  sh.B = B; sh.S = S; sh.T = T; sh.Hq = Hq; sh.Hkv = Hkv; sh.D = D;
  sh.G = Hq / Hkv;
  sh.heads_per_tile = sh.G < repro_torch::kRows ? sh.G : repro_torch::kRows;
  sh.pos_per_tile = repro_torch::kRows / sh.heads_per_tile;
  sh.head_tiles = (sh.G + sh.heads_per_tile - 1) / sh.heads_per_tile;
  sh.q_tiles = (S + sh.pos_per_tile - 1) / sh.pos_per_tile;
  sh.causal = causal; sh.window = window;
  sh.softcap = softcap; sh.scale = scale;
  const int64_t nx = (int64_t)sh.q_tiles * sh.head_tiles;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)nx, (unsigned)Hkv, (unsigned)B);
  switch (dtype) {
    case 1: return repro_torch::launch_dim<__half>(a, sh, grid, st);
    case 2: return repro_torch::launch_dim<__nv_bfloat16>(a, sh, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_tc_error_string(int code) {
  if (code >= repro_torch::kEncodeError) {
    static char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled refused the K/V map "
             "(CUresult %d)", code - repro_torch::kEncodeError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int flash_attention_tc_num_pointers() {
  return repro_torch::kNumPointers;
}
