// rglru_scan_bwd: the backward of the RG-LRU linear recurrence, for Hopper.
//
// Replaces no TPU kernel: the TPU kernel `_rglru_kernel`
// (src/repro/kernels/rglru_scan.py:22) has no backward, and the reference
// trains by differentiating its jnp oracle `rglru_scan_ref`
// (src/repro/models/recurrent.py:66, an associative scan).  The port runs
// the forward kernel (csrc/rglru_scan.cu) wherever its tensors are on the
// card, so its training step needs this kernel for the gradient.
//
// For the forward h_t = fma(a_t, h_{t-1}, u_t), h_{-1} = 0, over a, h
// (the forward's f32 output) and dh, all f32 [B, S, D]:
//
//   g_{S-1} = dh_{S-1},   g_t = fma(a_{t+1}, g_{t+1}, dh_t)   (t < S-1)
//   du_t = g_t,           da_t = g_t * h_{t-1}  (da_0 = 0)
//
// time reversed, each step one fused multiply-add and one product, each
// rounded once.  The build passes -fmad=false, so the product is not
// contracted; the plain PyTorch version (`rglru_scan_bwd_plain`) rounds
// the same two operations in the same order and the two agree bitwise.
//
// Design.  As the forward: one thread per (batch, channel) carries g in a
// register and walks time backwards; neighbouring threads take
// neighbouring channels, so every load and store of a warp is one
// coalesced 128-byte line.  The chain is dependent, the loads are not:
// each thread loads a chunk of kUnroll steps of a, h and dh into
// registers before it runs the chain over them.
//
// Bound on an H100 SXM: bytes, 5 * B * S * D * 4 (a, h and dh read once,
// da and du written once) at 3.35 TB/s.
//
// The wrapper's route() sends D a multiple of 4 with 16-byte aligned
// pointers (every model width) to rglru_scan_bwd_tma.cu, a TMA ring that
// computes the same function bitwise; this kernel takes the rest.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

struct ScanBwdArgs {
  // inputs a, h, dh [B, S, D]; outputs da, du [B, S, D]
  const float* a;
  const float* h;
  const float* dh;
  float* da;
  float* du;
};

constexpr int kNumPointers = 5;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ h,
                          const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ du,
                          int64_t S, int64_t D, int64_t BD) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BD) return;
  const int64_t b = idx / D;
  const int64_t base = b * S * D + (idx - b * D);
  const float* pa = a + base;
  const float* ph = h + base;
  const float* pdh = dh + base;
  float* pda = da + base;
  float* pdu = du + base;

  // the last step: g = dh, no later step to carry from
  int64_t t = S - 1;
  float g = pdh[t * D];
  float a_next = pa[t * D];   // a_{t}, carried to step t - 1
  pdu[t * D] = g;
  pda[t * D] = t > 0 ? g * ph[(t - 1) * D] : 0.f;
  // steps S-2 .. 0 in chunks of kUnroll, loads of a chunk first
  float ca[kUnroll], ch[kUnroll], cd[kUnroll];
  int64_t hi = S - 2;   // the chunk's first (highest) step
  while (hi >= 0) {
    const int n = hi + 1 < kUnroll ? (int)(hi + 1) : kUnroll;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (i < n) {
        const int64_t s = hi - i;
        ca[i] = pa[s * D];
        cd[i] = pdh[s * D];
        ch[i] = s > 0 ? ph[(s - 1) * D] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (i < n) {
        const int64_t s = hi - i;
        g = __fmaf_rn(a_next, g, cd[i]);
        pdu[s * D] = g;
        pda[s * D] = s > 0 ? __fmul_rn(g, ch[i]) : 0.f;
        a_next = ca[i];
      }
    }
    hi -= n;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::ScanBwdArgs;

// ptrs: the 5 device pointers in ScanBwdArgs field order.  Launches one
// thread per (batch, channel) on `stream` and returns the launch error
// (0 on success).
extern "C" int rglru_scan_bwd_launch(void* const* ptrs, int64_t B, int64_t S,
                                     int64_t D, void* stream) {
  static_assert(sizeof(ScanBwdArgs) ==
                    repro_torch::kNumPointers * sizeof(void*),
                "ScanBwdArgs must be exactly the pointer list");
  ScanBwdArgs p;
  memcpy(&p, ptrs, sizeof(p));
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  const int64_t BD = B * D;
  const int64_t blocks = (BD + repro_torch::kThreads - 1) /
                         repro_torch::kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  repro_torch::rglru_scan_bwd_kernel<<<(unsigned)blocks,
                                       repro_torch::kThreads, 0,
                                       (cudaStream_t)stream>>>(
      p.a, p.h, p.dh, p.da, p.du, S, D, BD);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int rglru_scan_bwd_num_pointers() {
  return repro_torch::kNumPointers;
}
