// fma_chain: the paper's benchmark load (Listing 1), for Hopper.
//
// Replaces the TPU kernel `_fma_chain_kernel` (`fma_chain`,
// src/repro/kernels/fma_chain.py:26,40,55).  That kernel held one
// (block_rows, 128) f32 block per grid slot in VMEM and ran a dependent
// chain of VPU ops over it with fori_loop; slots at or past `n_active`
// copied their block through.
//
// For x [grid * block_rows, 128] float32, grid slot s (rows
// s*block_rows .. (s+1)*block_rows - 1):
//
//   s <  n_active: every element runs   v = fma(v, 2, 2); v = fma(v, .5, -1)
//                  niter times (both multiplies exact, so each FMA equals
//                  the plain version's multiply-then-add bitwise; a nan
//                  comes out as the card's canonical nan);
//   s >= n_active: out = x.
//
// Design.  One CUDA block per grid slot, and one block per SM: the launch
// asks for more dynamic shared memory than half of what an SM has (the
// memory itself is not used), so `active_fraction` sets how many SMs burn,
// as the paper's `nblocks = SM_count * PERCENT` does, and not how long
// the kernel runs.  Each thread keeps kChains elements in registers as
// independent chains, so a warp has kChains FMAs in flight per step:
// enough to cover the FMA latency with the 32 warps of a 1024-thread
// block.  Larger blocks run several tiles of kChains one after another.
// `niter` is a runtime argument (an int, as the reference's fori_loop
// counter), so the chain is a loop the compiler can neither fold nor
// unroll away; the FMAs are written as __fmaf_rn because
// the build passes -fmad=false, under which `v * 2.f + 2.f` would be a
// separate multiply and add.
//
// Bound on an H100 SXM: operations, 4 * niter * 128 * block_rows *
// n_active FLOPs (2 FMAs per element per iteration) at 67 TFLOP/s FP32,
// against 2 * N * 128 * 4 bytes at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_torch {
namespace {

constexpr int kLanes = 128;
constexpr int kChains = 32;
constexpr int kMaxThreads = 1024;
// more than half of the 228 KB of shared memory of an H100 SM: one block
// per SM
constexpr int kPadBytes = 120 * 1024;

struct FmaArgs {
  // input x [grid * block_rows, 128], output of the same shape
  const float* x;
  float* out;
};

constexpr int kNumPointers = 2;

// the dependent chain, kChains independent copies of it
__device__ __forceinline__ void burn(float (&v)[kChains], int niter) {
  for (int it = 0; it < niter; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) v[k] = __fmaf_rn(v[k], 2.f, 2.f);
#pragma unroll
    for (int k = 0; k < kChains; ++k) v[k] = __fmaf_rn(v[k], .5f, -1.f);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    fma_chain_kernel(FmaArgs a, int per_slot, int n_active, int niter) {
  extern __shared__ char s_pad[];  // occupancy only
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t base = (int64_t)blockIdx.x * per_slot + tid;
  const float* src = a.x + base;
  float* dst = a.out + base;
  if ((int)blockIdx.x >= n_active) {
    for (int i = 0; i < per_slot - tid; i += nt) dst[i] = src[i];
    return;
  }
  for (int tile = 0; tile < per_slot; tile += nt * kChains) {
    // this thread's elements are tile + k * nt + tid for k * nt < left
    const int left = per_slot - tile - tid;
    float v[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      v[k] = k * nt < left ? src[tile + k * nt] : 0.f;
    }
    burn(v, niter);
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (k * nt < left) dst[tile + k * nt] = v[k];
    }
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::FmaArgs;

// ptrs: the 2 device pointers in FmaArgs field order.  Launches `grid`
// blocks of up to 1024 threads (enough for kChains elements each) on
// `stream`, one per SM, and returns the launch error (0 on success).
extern "C" int fma_chain_launch(void* const* ptrs, int64_t grid,
                                int64_t block_rows, int64_t n_active,
                                int niter, void* stream) {
  static_assert(sizeof(FmaArgs) == repro_torch::kNumPointers * sizeof(void*),
                "FmaArgs must be exactly the pointer list");
  static bool configured = false;
  FmaArgs a;
  memcpy(&a, ptrs, sizeof(a));
  if (grid <= 0 || block_rows <= 0) return 0;
  // int offsets inside a slot, a tile of kMaxThreads * kChains past its end
  if (grid > 0x7fffffffLL ||
      block_rows > (0x7fffffffLL - repro_torch::kMaxThreads *
                                       repro_torch::kChains) /
                       repro_torch::kLanes) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        repro_torch::fma_chain_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, repro_torch::kPadBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t per_slot = block_rows * repro_torch::kLanes;
  int64_t threads = (per_slot + repro_torch::kChains - 1) /
                    repro_torch::kChains;
  threads = (threads + 31) / 32 * 32;
  if (threads > repro_torch::kMaxThreads) threads = repro_torch::kMaxThreads;
  repro_torch::fma_chain_kernel<<<(unsigned)grid, (unsigned)threads,
                                  repro_torch::kPadBytes,
                                  (cudaStream_t)stream>>>(
      a, (int)per_slot, (int)n_active, niter);
  return (int)cudaGetLastError();
}

extern "C" const char* fma_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int fma_chain_num_pointers() { return repro_torch::kNumPointers; }
