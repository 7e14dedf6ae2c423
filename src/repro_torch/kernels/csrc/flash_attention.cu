// flash_attention: forward attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel `_flash_kernel` (`flash_attention`,
// src/repro/kernels/flash_attention.py:25,94,126).  That kernel ran a
// grid (B, Hkv, q block, k block) with the k axis innermost and
// sequential, carrying the online-softmax state (m, l, acc) in VMEM
// scratch across k steps; the G = Hq / Hkv query heads of a KV head
// shared each K/V block straight from VMEM; it skipped k blocks wholly
// above the causal diagonal.
//
// For q [B, S, Hq, D], k and v [B, T, Hkv, D] (float, half or bfloat16,
// D <= 256), query head h reading KV head h / G, scale D^-0.5:
//
//   s     = (q . k) * scale                      (f32)
//   s     = cap * tanh(s / cap)                  if softcap > 0
//   mask  = k_pos < T & q_pos < S & (k_pos <= q_pos if causal)
//           & (k_pos > q_pos - window if window > 0)
//   online softmax over k tiles, exactly as `_flash_kernel`:
//   m_new = max(m, max_j s);  m_safe = m_new <= -5e29 ? 0 : m_new
//   p     = mask ? exp(s - m_safe) : 0
//   alpha = m <= -5e29 ? 0 : exp(m - m_safe)
//   l     = l * alpha + sum_j p
//   acc   = acc * alpha + sum_j round_to_input_type(p) * v   (f32)
//   out   = acc / max(l, 1e-20), rounded to the input type
//
// so a row with no valid key gives 0.
//
// Design.  One block per (batch, KV head, tile of up to 64 query rows):
// a row is a (query position, query head of the group) pair, the group's
// heads side by side, so the G heads of an MQA/GQA group share every K/V
// tile from shared memory (the main path's G = 16 makes a tile 4
// positions x 16 heads).  The block loops over 32-key tiles in order,
// skipping tiles wholly above the causal diagonal or wholly outside the
// sliding window of every row of the tile (the TPU kernel skipped only
// the first; a skipped tile changes nothing, since every entry of it is
// masked).  Q (f32, converted once), the K and V tiles and the
// probabilities live in shared memory; the state (m, l) per row in
// shared memory, acc in registers (4 rows x D/16 columns a thread).
// The products run as f32 FMAs on the CUDA cores, register-tiled (2
// rows x 4 keys for the scores, 4 rows x D/16 columns for PV); tensor
// cores (mma/wgmma) and TMA are later work.
//
// Bound on an H100 SXM: operations, 4 * D FLOPs for each (query head,
// key) pair the masks keep, at 989 TFLOP/s (the dense bf16 tensor-core
// rate), against the bytes of q, k, v and out once each at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // query rows (position, head) per block
constexpr int kKeys = 32;     // keys per tile
constexpr float kNegInf = -1e30f;

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
  int heads_per_tile;   // GB: query heads of one group in a tile
  int pos_per_tile;     // BQ: query positions in a tile
  int head_tiles;       // ceil(G / GB)
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DMAX>
struct Smem {
  static constexpr int kQ = kRows * (DMAX + 1);
  static constexpr int kK = kKeys * (DMAX + 1);
  static constexpr int kV = kKeys * DMAX;
  static constexpr int kP = kRows * (kKeys + 1);
  static constexpr int kFloats = kQ + kK + kV + kP + 3 * kRows;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Shape sh) {
  extern __shared__ float smem[];
  float* sQ = smem;                          // [kRows][DMAX + 1]
  float* sK = sQ + Smem<DMAX>::kQ;           // [kKeys][DMAX + 1]
  float* sV = sK + Smem<DMAX>::kK;           // [kKeys][DMAX]
  float* sP = sV + Smem<DMAX>::kV;           // [kRows][kKeys + 1]
  float* sM = sP + Smem<DMAX>::kP;           // [kRows]
  float* sL = sM + kRows;                    // [kRows]
  float* sA = sL + kRows;                    // [kRows]

  const int tid = threadIdx.x;
  const int D = sh.D;
  const int GB = sh.heads_per_tile;
  const int BQ = sh.pos_per_tile;
  const int tile = blockIdx.x;
  const int qt = tile / sh.head_tiles;
  const int g0 = (tile - qt * sh.head_tiles) * GB;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = qt * BQ;
  const int rows = BQ * GB;

  // row r: query position i0 + r / GB, query head hkv * G + g0 + r % GB
  auto q_pos = [&](int r) { return i0 + r / GB; };
  auto row_ok = [&](int r) {
    return r < rows && i0 + r / GB < sh.S && g0 + r % GB < sh.G;
  };
  auto head_of = [&](int r) { return hkv * sh.G + g0 + r % GB; };

  for (int idx = tid; idx < kRows * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx - r * DMAX;
    float x = 0.f;
    if (d < D && row_ok(r)) {
      x = to_f32(q[(((int64_t)b * sh.S + q_pos(r)) * sh.Hq + head_of(r)) *
                       D + d]);
    }
    sQ[r * (DMAX + 1) + d] = x;
  }
  if (tid < kRows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  constexpr int kCols = DMAX / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  // the keys any row of this tile may see
  const int q_lo = i0;
  const int q_hi = min(i0 + BQ, sh.S) - 1;
  int k_begin = 0, k_end = sh.T;
  if (sh.window > 0) k_begin = max(0, q_lo - sh.window + 1);
  if (sh.causal) k_end = min(k_end, q_hi + 1);

  auto keep = [&](int r, int key) {
    const int qp = q_pos(r);
    bool ok = key < sh.T && row_ok(r);
    if (sh.causal) ok = ok && key <= qp;
    if (sh.window > 0) ok = ok && key > qp - sh.window;
    return ok;
  };

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile's PV is done with sK, sV, sP
    for (int idx = tid; idx < kKeys * DMAX; idx += kThreads) {
      const int j = idx / DMAX, d = idx - j * DMAX;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (d < D && key < sh.T) {
        const int64_t off =
            (((int64_t)b * sh.T + key) * sh.Hkv + hkv) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      sK[j * (DMAX + 1) + d] = kx;
      sV[j * DMAX + d] = vx;
    }
    __syncthreads();

    // scores: rows 2ty, 2ty + 1; keys tx + 8c
    {
      const int ty = tid >> 3, tx = tid & 7;
      const float* q0 = sQ + (2 * ty) * (DMAX + 1);
      const float* q1 = q0 + (DMAX + 1);
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int d = 0; d < D; ++d) {
        const float a0 = q0[d], a1 = q1[d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = sK[(tx + 8 * c) * (DMAX + 1) + d];
          s[0][c] = __fmaf_rn(a0, kv, s[0][c]);
          s[1][c] = __fmaf_rn(a1, kv, s[1][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 8 * c;
          float x = s[i][c] * sh.scale;
          if (sh.softcap > 0.f) x = sh.softcap * tanhf(x / sh.softcap);
          sP[r * (kKeys + 1) + j] = keep(r, k0 + j) ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: 4 threads a row, 8 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* pr = sP + r * (kKeys + 1) + part * 8;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, pr[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = keep(r, k0 + part * 8 + j) ? expf(pr[j] - m_safe)
                                                    : 0.f;
        sum += p;
        pr[j] = to_f32(from_f32<T>(p));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha =
            m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_safe);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows 4ty .. 4ty + 3, columns tx + 16c
    {
      const int ty = tid >> 4, tx = tid & 15;
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = sA[4 * ty + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= al[i];
      for (int j = 0; j < kKeys; ++j) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * (kKeys + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vx = sV[j * DMAX + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(p[i], vx, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();

  {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (!row_ok(r)) continue;
      const float l = fmaxf(sL[r], 1e-20f);
      T* dst = o + (((int64_t)b * sh.S + q_pos(r)) * sh.Hq + head_of(r)) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        if (d < D) dst[d] = from_f32<T>(acc[i][c] / l);
      }
    }
  }
}

template <typename T, int DMAX>
int launch_typed(const FlashArgs& a, const Shape& sh, dim3 grid,
                 cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DMAX>::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_attention_kernel<T, DMAX><<<grid, kThreads, Smem<DMAX>::kBytes,
                                    stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const FlashArgs& a, const Shape& sh, dim3 grid,
               cudaStream_t stream) {
  if (sh.D <= 32) return launch_typed<T, 32>(a, sh, grid, stream);
  if (sh.D <= 64) return launch_typed<T, 64>(a, sh, grid, stream);
  if (sh.D <= 128) return launch_typed<T, 128>(a, sh, grid, stream);
  return launch_typed<T, 256>(a, sh, grid, stream);
}

}  // namespace
}  // namespace repro_torch

using repro_torch::FlashArgs;

// ptrs: the 4 device pointers in FlashArgs field order.  dtype: 0 float,
// 1 half, 2 bfloat16.  Launches one block per (query tile, batch, KV
// head) on `stream` and returns the launch error (0 on success).
extern "C" int flash_attention_launch(void* const* ptrs, int B, int S, int T,
                                      int Hq, int Hkv, int D, int dtype,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  static_assert(sizeof(FlashArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "FlashArgs must be exactly the pointer list");
  FlashArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || T < 0 ||
      B > 65535 || Hkv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  repro_torch::Shape sh;
  sh.B = B; sh.S = S; sh.T = T; sh.Hq = Hq; sh.Hkv = Hkv; sh.D = D;
  sh.G = Hq / Hkv;
  sh.heads_per_tile = sh.G < repro_torch::kRows ? sh.G : repro_torch::kRows;
  sh.pos_per_tile = repro_torch::kRows / sh.heads_per_tile;
  sh.head_tiles = (sh.G + sh.heads_per_tile - 1) / sh.heads_per_tile;
  sh.causal = causal; sh.window = window;
  sh.softcap = softcap; sh.scale = scale;
  const int64_t q_tiles = (S + sh.pos_per_tile - 1) / sh.pos_per_tile;
  const int64_t nx = q_tiles * sh.head_tiles;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)nx, (unsigned)Hkv, (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return repro_torch::launch_dim<float>(a, sh, grid, st);
    case 1: return repro_torch::launch_dim<__half>(a, sh, grid, st);
    case 2: return repro_torch::launch_dim<__nv_bfloat16>(a, sh, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int flash_attention_num_pointers() {
  return repro_torch::kNumPointers;
}
