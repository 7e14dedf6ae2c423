// rglru_scan: the RG-LRU linear recurrence, for Hopper.
//
// Replaces the TPU kernel `_rglru_kernel` (`rglru_scan`,
// src/repro/kernels/rglru_scan.py:22,40,54).  That kernel tiled
// (batch, channel block) over the grid and walked time in VMEM chunks with
// an f32 carry in scratch across sequential grid steps, the time axis
// padded with identity steps (a = 1, u = 0) that change nothing.
//
// For a, u [B, S, D] float32 (the wrapper casts to f32 first, as the TPU
// kernel does):
//
//   h_{-1} = 0,   h_t = fma(a_t, h_{t-1}, u_t),   out[b, t, d] = h_t  (f32)
//
// time in order, each step one fused multiply-add rounded once, as the
// TPU kernel computes `a_t * h + u_t` in interpret mode on XLA's CPU
// backend (which contracts it into an FMA).  The build passes
// -fmad=false, so the FMA is written out as __fmaf_rn; the plain PyTorch
// loop emulates the same FMA exactly, and the two agree bitwise.
//
// Design.  One thread per (batch, channel) carries h in a register and
// walks time; neighbouring threads take neighbouring channels, so every
// load and store of a warp is one coalesced 128-byte line.  The carry
// is a dependent chain, but the loads are not: each thread loads the
// next kUnroll steps of a and u into registers while it runs the chain
// over the current kUnroll, so ~2 * kUnroll loads per thread are in
// flight.  64-thread blocks spread B * D / 64 blocks over the SMs (128
// for the main path's [2, 3000, 4096]).
//
// Bound on an H100 SXM: bytes, 3 * B * S * D * 4 (a and u read once, h
// written once) at 3.35 TB/s; B * S * D FMAs are nothing beside it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 32;

struct ScanArgs {
  // inputs a, u [B, S, D]; output h [B, S, D]
  const float* a;
  const float* u;
  float* h;
};

constexpr int kNumPointers = 3;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ u, float* __restrict__ out,
                      int64_t S, int64_t D, int64_t BD) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BD) return;
  const int64_t b = idx / D;
  const int64_t base = b * S * D + (idx - b * D);
  const float* pa = a + base;
  const float* pu = u + base;
  float* po = out + base;
  float h = 0.f;
  const int64_t full = S / kUnroll * kUnroll;
  float ca[kUnroll], cu[kUnroll], na[kUnroll], nu[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = pa[i * D];
      cu[i] = pu[i * D];
    }
  }
  for (int64_t t = 0; t < full; t += kUnroll) {
    const int64_t nt = t + kUnroll;
    if (nt < full) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        na[i] = pa[(nt + i) * D];
        nu[i] = pu[(nt + i) * D];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = __fmaf_rn(ca[i], h, cu[i]);
      po[(t + i) * D] = h;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cu[i] = nu[i];
    }
  }
  for (int64_t t = full; t < S; ++t) {
    h = __fmaf_rn(pa[t * D], h, pu[t * D]);
    po[t * D] = h;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::ScanArgs;

// ptrs: the 3 device pointers in ScanArgs field order.  Launches one
// thread per (batch, channel) on `stream` and returns the launch error
// (0 on success).
extern "C" int rglru_scan_launch(void* const* ptrs, int64_t B, int64_t S,
                                 int64_t D, void* stream) {
  static_assert(sizeof(ScanArgs) == repro_torch::kNumPointers * sizeof(void*),
                "ScanArgs must be exactly the pointer list");
  ScanArgs p;
  memcpy(&p, ptrs, sizeof(p));
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  const int64_t BD = B * D;
  const int64_t blocks = (BD + repro_torch::kThreads - 1) /
                         repro_torch::kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  repro_torch::rglru_scan_kernel<<<(unsigned)blocks, repro_torch::kThreads,
                                   0, (cudaStream_t)stream>>>(
      p.a, p.u, p.h, S, D, BD);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int rglru_scan_num_pointers() { return repro_torch::kNumPointers; }
