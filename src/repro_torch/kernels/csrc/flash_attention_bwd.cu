// flash_attention_bwd: the backward of forward attention with an online
// softmax, for Hopper, in two kernels: flash_attention_bwd_dq (B2) and
// flash_attention_bwd_dkdv (B3).
//
// Replaces no TPU kernel: the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py:25) has no backward, and the
// reference trains by differentiating its jnp oracle `blocked_attention`
// (src/repro/models/layers.py:149).  The port runs its forward kernels
// (csrc/flash_attention_tc.cu, csrc/flash_attention.cu) wherever its
// tensors are on the card, so its training step needs these for the
// gradient.
//
// For q, dO and O [B, S, Hq, D], k and v [B, T, Hkv, D] (float, half or
// bfloat16, D <= 256), query head h reading KV head h / G, scale D^-0.5,
// and the forward's masks (k_pos < T, q_pos < S, k_pos <= q_pos if
// causal, k_pos > q_pos - window if window > 0), all in f32:
//
//   raw   = (q . k) * scale;   s = cap * tanh(raw / cap) if cap > 0
//   lse   = log sum_{kept} exp(s)             (per query row)
//   P     = kept ? exp(s - lse) : 0
//   delta = rowsum(dO * O)
//   dS    = P * (dO . v - delta) * (1 - (s / cap)^2 if cap > 0)
//   dQ    = scale * sum_k dS K        dK = scale * sum_q dS Q
//   dV    = sum_q P dO
//
// A row with no kept key has P = 0, so its gradients are 0.  The
// gradients are written in the input type.
//
// Design.  No atomics: every output element has one writer, so the
// gradients are deterministic.
//
// * B2, one block per (batch, query head, tile of 64 query positions):
//   delta for its rows from dO and O, then pass 1 over the 32-key tiles
//   the masks keep (the forward's tile range) for the rows' online max
//   and sum, written out as lse [B, Hq, S] with delta [B, Hq, S] for B3,
//   then pass 2 over the same tiles: S and dO V^T in one loop over D (2
//   rows x 4 keys a thread), dS in shared memory, dQ += dS K in
//   registers (4 rows x D/16 columns a thread).
// * B3, one block per (batch, KV head, tile of 32 keys): K and V of the
//   tile stay in shared memory while the block walks the G query heads
//   of the group and, for each, the 64-row query tiles that see a key of
//   the tile (from the tile's first key if causal, up to its last key +
//   window - 1 if windowed): S^T and dP^T (2 keys x 4 rows a thread),
//   P and dS in shared memory, then dV += P^T dO and dK += dS^T Q in
//   registers (2 keys x D/16 columns a thread).
//
// Everything is f32 FMAs on the CUDA cores: no tensor cores (mma/wgmma)
// and no TMA.  B2 recomputes the scores twice and B3 once more, 16 * D
// FLOPs a kept (query head, key) pair in all.
//
// Bound on an H100 SXM: operations, 10 * D FLOPs for each kept (query
// head, key) pair (the function's work: S, dP, dV, dQ and dK at 2 * D
// each), at 989 TFLOP/s for 16-bit inputs (the dense tensor-core rate)
// and 67 TFLOP/s for f32, against the bytes of q, k, v, O and dO read
// once and dq, dk and dv written once at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // query positions per tile
constexpr int kKeys = 32;     // keys per tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ bool kept(const Shape& sh, int qp, int key) {
  bool ok = qp < sh.S && key < sh.T && key >= 0;
  if (sh.causal) ok = ok && key <= qp;
  if (sh.window > 0) ok = ok && key > qp - sh.window;
  return ok;
}

__device__ __forceinline__ float capped(const Shape& sh, float raw) {
  return sh.softcap > 0.f ? sh.softcap * tanhf(raw / sh.softcap) : raw;
}

// dS's factor from the soft-cap: d(cap tanh(raw / cap)) / d raw
__device__ __forceinline__ float cap_grad(const Shape& sh, float s) {
  if (sh.softcap <= 0.f) return 1.f;
  const float t = s / sh.softcap;
  return 1.f - t * t;
}

// row `r` of a [rows][DMAX + 1] f32 tile from x [B, N, H, D] at
// (b, n0 + r, h); zeros past N and past D
template <typename T, int DMAX>
__device__ __forceinline__ void load_rows(float* dst, const T* x, int rows,
                                          int b, int n0, int N, int H,
                                          int h, int D) {
  for (int idx = threadIdx.x; idx < rows * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx - r * DMAX;
    float val = 0.f;
    if (d < D && n0 + r < N && n0 + r >= 0) {
      val = to_f32(x[(((int64_t)b * N + n0 + r) * H + h) * D + d]);
    }
    dst[r * (DMAX + 1) + d] = val;
  }
}

template <int DMAX>
struct DqSmem {
  static constexpr int kQ = kRows * (DMAX + 1);
  static constexpr int kK = kKeys * (DMAX + 1);
  static constexpr int kS = kRows * (kKeys + 1);
  static constexpr int kFloats = 2 * kQ + 2 * kK + kS + 4 * kRows;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, float* __restrict__ lse_out,
                  float* __restrict__ delta_out, T* __restrict__ dq,
                  Shape sh) {
  extern __shared__ float smem[];
  float* sQ = smem;                            // [kRows][DMAX + 1]
  float* sdO = sQ + DqSmem<DMAX>::kQ;          // [kRows][DMAX + 1]
  float* sK = sdO + DqSmem<DMAX>::kQ;          // [kKeys][DMAX + 1]
  float* sV = sK + DqSmem<DMAX>::kK;           // [kKeys][DMAX + 1]
  float* sS = sV + DqSmem<DMAX>::kK;           // [kRows][kKeys + 1]
  float* sM = sS + DqSmem<DMAX>::kS;           // [kRows]
  float* sL = sM + kRows;                      // [kRows]
  float* sLse = sL + kRows;                    // [kRows]
  float* sDelta = sLse + kRows;                // [kRows]

  const int tid = threadIdx.x;
  const int D = sh.D;
  const int i0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / sh.G;
  const int64_t row_stat = ((int64_t)b * sh.Hq + h) * sh.S;

  load_rows<T, DMAX>(sQ, q, kRows, b, i0, sh.S, sh.Hq, h, D);
  load_rows<T, DMAX>(sdO, dout, kRows, b, i0, sh.S, sh.Hq, h, D);
  __syncthreads();
  // delta = rowsum(dO * O): 4 threads a row
  {
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (i0 + r < sh.S) {
      const T* orow = o + (((int64_t)b * sh.S + i0 + r) * sh.Hq + h) * D;
      const float* grow = sdO + r * (DMAX + 1);
      for (int d = part; d < D; d += 4) {
        acc = __fmaf_rn(to_f32(orow[d]), grow[d], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sDelta[r] = acc;
      sM[r] = kNegInf;
      sL[r] = 0.f;
      if (i0 + r < sh.S) delta_out[row_stat + i0 + r] = acc;
    }
  }

  const int q_hi = min(i0 + kRows, sh.S) - 1;
  int k_begin = 0, k_end = sh.T;
  if (sh.window > 0) k_begin = max(0, i0 - sh.window + 1);
  if (sh.causal) k_end = min(k_end, q_hi + 1);

  // S tile into sS (masked entries kNegInf), rows 2ty, 2ty + 1, keys
  // tx + 8c; with `dp`, dO V^T into dp as well
  auto scores = [&](bool with_dp, float (&s)[2][4], float (&dp)[2][4]) {
    const int ty = tid >> 3, tx = tid & 7;
    const float* q0 = sQ + (2 * ty) * (DMAX + 1);
    const float* q1 = q0 + (DMAX + 1);
    const float* o0 = sdO + (2 * ty) * (DMAX + 1);
    const float* o1 = o0 + (DMAX + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float a0 = q0[d], a1 = q1[d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = sK[(tx + 8 * c) * (DMAX + 1) + d];
        s[0][c] = __fmaf_rn(a0, kv, s[0][c]);
        s[1][c] = __fmaf_rn(a1, kv, s[1][c]);
      }
      if (with_dp) {
        const float g0 = o0[d], g1 = o1[d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float vv = sV[(tx + 8 * c) * (DMAX + 1) + d];
          dp[0][c] = __fmaf_rn(g0, vv, dp[0][c]);
          dp[1][c] = __fmaf_rn(g1, vv, dp[1][c]);
        }
      }
    }
  };

  // pass 1: the rows' log-sum-exp over the kept keys
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();
    load_rows<T, DMAX>(sK, k, kKeys, b, k0, sh.T, sh.Hkv, hkv, D);
    __syncthreads();
    {
      float s[2][4], dp[2][4];
      scores(false, s, dp);
      const int ty = tid >> 3, tx = tid & 7;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 8 * c;
          const float x = capped(sh, s[i][c] * sh.scale);
          sS[r * (kKeys + 1) + j] = kept(sh, i0 + r, k0 + j) ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    {
      const int r = tid >> 2, part = tid & 3;
      const float* pr = sS + r * (kKeys + 1) + part * 8;
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
        sum += pr[j] <= kNegInf / 2 ? 0.f : expf(pr[j] - m_safe);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha =
            m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_safe);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
  }
  __syncthreads();
  if (tid < kRows) {
    const float l = sL[tid];
    const float lse = l > 0.f ? sM[tid] + logf(l) : 0.f;
    sLse[tid] = lse;
    if (i0 + tid < sh.S) lse_out[row_stat + i0 + tid] = lse;
  }

  // pass 2: dS, and dQ += dS K
  constexpr int kCols = DMAX / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();
    load_rows<T, DMAX>(sK, k, kKeys, b, k0, sh.T, sh.Hkv, hkv, D);
    load_rows<T, DMAX>(sV, v, kKeys, b, k0, sh.T, sh.Hkv, hkv, D);
    __syncthreads();
    {
      float s[2][4], dp[2][4];
      scores(true, s, dp);
      const int ty = tid >> 3, tx = tid & 7;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 8 * c;
          float ds = 0.f;
          if (kept(sh, i0 + r, k0 + j)) {
            const float x = capped(sh, s[i][c] * sh.scale);
            const float p = expf(x - sLse[r]);
            ds = p * (dp[i][c] - sDelta[r]) * cap_grad(sh, x);
          }
          sS[r * (kKeys + 1) + j] = ds;
        }
      }
    }
    __syncthreads();
    {
      const int ty = tid >> 4, tx = tid & 15;
      for (int j = 0; j < kKeys; ++j) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = sS[(4 * ty + i) * (kKeys + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float kv = sK[j * (DMAX + 1) + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(ds[i], kv, acc[i][c]);
        }
      }
    }
  }

  {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (i0 + r >= sh.S) continue;
      T* dst = dq + (((int64_t)b * sh.S + i0 + r) * sh.Hq + h) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        if (d < D) dst[d] = from_f32<T>(acc[i][c] * sh.scale);
      }
    }
  }
}

template <int DMAX>
struct DkvSmem {
  static constexpr int kK = kKeys * (DMAX + 1);
  static constexpr int kQ = kRows * (DMAX + 1);
  static constexpr int kP = kKeys * (kRows + 1);
  static constexpr int kFloats = 2 * kK + 2 * kQ + 2 * kP + 2 * kRows;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Shape sh) {
  extern __shared__ float smem[];
  float* sK = smem;                            // [kKeys][DMAX + 1]
  float* sV = sK + DkvSmem<DMAX>::kK;          // [kKeys][DMAX + 1]
  float* sQ = sV + DkvSmem<DMAX>::kK;          // [kRows][DMAX + 1]
  float* sdO = sQ + DkvSmem<DMAX>::kQ;         // [kRows][DMAX + 1]
  float* sP = sdO + DkvSmem<DMAX>::kQ;         // [kKeys][kRows + 1]
  float* sdS = sP + DkvSmem<DMAX>::kP;         // [kKeys][kRows + 1]
  float* sLse = sdS + DkvSmem<DMAX>::kP;       // [kRows]
  float* sDelta = sLse + kRows;                // [kRows]

  const int tid = threadIdx.x;
  const int D = sh.D;
  const int j0 = blockIdx.x * kKeys;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int j_last = min(j0 + kKeys, sh.T) - 1;

  load_rows<T, DMAX>(sK, k, kKeys, b, j0, sh.T, sh.Hkv, hkv, D);
  load_rows<T, DMAX>(sV, v, kKeys, b, j0, sh.T, sh.Hkv, hkv, D);

  // the query positions that see a key of the tile
  const int q_lo = sh.causal ? j0 : 0;
  int q_hi = sh.S - 1;
  if (sh.window > 0) q_hi = min(q_hi, j_last + sh.window - 1);

  constexpr int kCols = DMAX / 16;
  float acc_k[2][kCols], acc_v[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < sh.G; ++g) {
    const int h = hkv * sh.G + g;
    const int64_t row_stat = ((int64_t)b * sh.Hq + h) * sh.S;
    for (int i0 = q_lo; i0 <= q_hi; i0 += kRows) {
      __syncthreads();  // the previous tile's products are done
      load_rows<T, DMAX>(sQ, q, kRows, b, i0, sh.S, sh.Hq, h, D);
      load_rows<T, DMAX>(sdO, dout, kRows, b, i0, sh.S, sh.Hq, h, D);
      if (tid < kRows) {
        const bool in = i0 + tid < sh.S;
        sLse[tid] = in ? lse[row_stat + i0 + tid] : 0.f;
        sDelta[tid] = in ? delta[row_stat + i0 + tid] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: keys 2kj, 2kj + 1; rows rr + 16c
      {
        const int kj = tid >> 4, rr = tid & 15;
        const float* k0p = sK + (2 * kj) * (DMAX + 1);
        const float* k1p = k0p + (DMAX + 1);
        const float* v0p = sV + (2 * kj) * (DMAX + 1);
        const float* v1p = v0p + (DMAX + 1);
        float s[2][4], dp[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float ka = k0p[d], kb = k1p[d];
          const float va = v0p[d], vb = v1p[d];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = rr + 16 * c;
            const float qv = sQ[r * (DMAX + 1) + d];
            const float gv = sdO[r * (DMAX + 1) + d];
            s[0][c] = __fmaf_rn(ka, qv, s[0][c]);
            s[1][c] = __fmaf_rn(kb, qv, s[1][c]);
            dp[0][c] = __fmaf_rn(va, gv, dp[0][c]);
            dp[1][c] = __fmaf_rn(vb, gv, dp[1][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = 2 * kj + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = rr + 16 * c;
            float p = 0.f, ds = 0.f;
            if (kept(sh, i0 + r, j0 + j)) {
              const float x = capped(sh, s[i][c] * sh.scale);
              p = expf(x - sLse[r]);
              ds = p * (dp[i][c] - sDelta[r]) * cap_grad(sh, x);
            }
            sP[j * (kRows + 1) + r] = p;
            sdS[j * (kRows + 1) + r] = ds;
          }
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys 2ty, 2ty + 1; columns tx + 16c
      {
        const int ty = tid >> 4, tx = tid & 15;
        const float* p0 = sP + (2 * ty) * (kRows + 1);
        const float* p1 = p0 + (kRows + 1);
        const float* d0 = sdS + (2 * ty) * (kRows + 1);
        const float* d1 = d0 + (kRows + 1);
        const int rows = min(kRows, sh.S - i0);
        for (int r = 0; r < rows; ++r) {
          const float pa = p0[r], pb = p1[r], da = d0[r], db = d1[r];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float gv = sdO[r * (DMAX + 1) + tx + 16 * c];
            const float qv = sQ[r * (DMAX + 1) + tx + 16 * c];
            acc_v[0][c] = __fmaf_rn(pa, gv, acc_v[0][c]);
            acc_v[1][c] = __fmaf_rn(pb, gv, acc_v[1][c]);
            acc_k[0][c] = __fmaf_rn(da, qv, acc_k[0][c]);
            acc_k[1][c] = __fmaf_rn(db, qv, acc_k[1][c]);
          }
        }
      }
    }
  }

  {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = j0 + 2 * ty + i;
      if (key >= sh.T) continue;
      const int64_t off = (((int64_t)b * sh.T + key) * sh.Hkv + hkv) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          dk[off + d] = from_f32<T>(acc_k[i][c] * sh.scale);
          dv[off + d] = from_f32<T>(acc_v[i][c]);
        }
      }
    }
  }
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

template <typename T, int DMAX>
int launch_dq(const BwdArgs& a, const Shape& sh, cudaStream_t stream) {
  static bool configured = false;
  const int bytes = DqSmem<DMAX>::kBytes;
  if (int err = allow_smem(bwd_dq_kernel<T, DMAX>, bytes, configured)) {
    return err;
  }
  const dim3 grid((unsigned)((sh.S + kRows - 1) / kRows), (unsigned)sh.Hq,
                  (unsigned)sh.B);
  bwd_dq_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
      (const T*)a.dout, a.lse, a.delta, (T*)a.dq, sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkdv(const BwdArgs& a, const Shape& sh, cudaStream_t stream) {
  static bool configured = false;
  const int bytes = DkvSmem<DMAX>::kBytes;
  if (int err = allow_smem(bwd_dkdv_kernel<T, DMAX>, bytes, configured)) {
    return err;
  }
  const dim3 grid((unsigned)((sh.T + kKeys - 1) / kKeys), (unsigned)sh.Hkv,
                  (unsigned)sh.B);
  bwd_dkdv_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, sh);
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
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || B > 65535 ||
      Hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Shape sh;
  sh.B = B; sh.S = S; sh.T = T; sh.Hq = Hq; sh.Hkv = Hkv; sh.D = D;
  sh.G = Hq / Hkv;
  sh.causal = causal; sh.window = window;
  sh.softcap = softcap; sh.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_dim<float, kDq>(a, sh, st);
    case 1: return launch_dim<__half, kDq>(a, sh, st);
    case 2: return launch_dim<__nv_bfloat16, kDq>(a, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// ptrs: the 10 device pointers in BwdArgs field order.  dtype: 0 float,
// 1 half, 2 bfloat16.  B2: one block per (query tile, query head, batch);
// writes lse, delta and dq.  B3 (after B2, on the same stream): one
// block per (key tile, KV head, batch); reads lse and delta, writes dk
// and dv.  Each returns the launch error (0 on success).
extern "C" int flash_attention_bwd_dq_launch(void* const* ptrs, int B, int S,
                                             int T, int Hq, int Hkv, int D,
                                             int dtype, int causal,
                                             int window, float softcap,
                                             float scale, void* stream) {
  return repro_torch::launch<true>(ptrs, B, S, T, Hq, Hkv, D, dtype, causal,
                                   window, softcap, scale, stream);
}

extern "C" int flash_attention_bwd_dkdv_launch(void* const* ptrs, int B,
                                               int S, int T, int Hq, int Hkv,
                                               int D, int dtype, int causal,
                                               int window, float softcap,
                                               float scale, void* stream) {
  return repro_torch::launch<false>(ptrs, B, S, T, Hq, Hkv, D, dtype, causal,
                                    window, softcap, scale, stream);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int flash_attention_bwd_num_pointers() {
  return repro_torch::kNumPointers;
}
