// rglru_scan_bwd_tma: the backward of the RG-LRU linear recurrence,
// redesigned for Hopper: the function of rglru_scan_bwd.cu, bitwise, with
// its inputs brought by TMA through a ring of time tiles in shared memory.
//
// Replaces no TPU kernel: the TPU kernel `_rglru_kernel`
// (src/repro/kernels/rglru_scan.py:22) has no backward, and the reference
// trains by differentiating its jnp oracle `rglru_scan_ref`
// (src/repro/models/recurrent.py:66).
//
// For the forward h_t = fma(a_t, h_{t-1}, u_t), h_{-1} = 0, over a, h
// (the forward's f32 output) and dh, all f32 [B, S, D]:
//
//   g_{S-1} = dh_{S-1},   g_t = fma(a_{t+1}, g_{t+1}, dh_t)   (t < S-1)
//   du_t = g_t,           da_t = g_t * h_{t-1}  (da_0 = 0)
//
// time reversed, each step one __fmaf_rn and one __fmul_rn in the order
// of rglru_scan_bwd.cu; the build passes -fmad=false, so the plain
// PyTorch version (`rglru_scan_bwd_plain`) agrees bitwise.  Time is never
// split into chunks whose carries are combined later: that would round
// differently.
//
// Bound on an H100 SXM: bytes, 5 * B * S * D * 4 (a, h and dh read once,
// da and du written once) at 3.35 TB/s.  The chain is S dependent FMAs a
// channel (~7 us at S = 3000), far below it.  The earlier design
// (rglru_scan_bwd.cu: a thread a channel, 64-thread blocks, a chunk's
// loads into registers before its chain) kept two warps an SM and ~1.6
// MB in flight only while a chunk loaded.
//
// Design.  A block owns kChannels = 32 channels of one batch row and has
// two warps:
//
// * The producer warp's first lane walks time backwards in tiles of
//   kSteps steps and keeps kStages tiles in flight.  A stage holds three
//   [kSteps, 32] f32 boxes of 4-D tensor maps over [B, S, 1, D] (no
//   swizzle; out-of-range elements read as zeros): dh at the tile's steps
//   t0 .. t0 + kSteps - 1, a one step later (row r is a_{t0+r+1}, the
//   decay step t0 + r needs) and h one step earlier (row r is
//   h_{t0+r-1}), all three on the stage's one mbarrier with the stage's
//   bytes.  At t0 = 0, h's row -1 is out of range and reads as zero; past
//   S - 1, a reads as zero.
// * The consumer warp, a lane a channel, reads the stage's rows into
//   registers (lane c reads word c of a 128-byte row: no bank conflicts),
//   releases the stage, runs the chain over them and writes du and da
//   into an output tile in shared memory, two tiles in turn; its first
//   lane stores each tile by TMA (a bulk group; rows past S - 1 and
//   channels past D are not written) and waits for a tile's reads before
//   the tile is written again.  Step S - 1 is its own step, g = dh (an
//   FMA with the zero-filled a would turn dh = -0.0 into +0.0), and da_0
//   is written as 0 (g times the zero-filled h_{-1} would give -0.0 for
//   g < 0 and NaN for an infinite g).
//
// The tile, measured at [2, 3000, 4096] on an H100 SXM (700 W): stores
// from registers, one 128-byte line a warp a step, took 0.205 ms alone
// (0.96 TB/s), so the outputs leave by TMA.  Then the reads bound it:
// with 16-step tiles the kernel took as long as its reads alone (0.168
// ms); 32-step tiles read faster alone but took 0.19-0.20 ms with the
// stores, and 3 stages beat 2, 4 and 6.  At that shape: 256 blocks of 26
// KB, two an SM, 36 KB of input an SM in flight.  No atomics: every
// output element has one writer.
//
// TMA takes 16-byte aligned base addresses and strides: D a multiple of
// 4 and every pointer 16-byte aligned.  The wrapper's route() sends other
// inputs to rglru_scan_bwd.cu.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kConsumers = 1;  // consumer warps, 32 channels each
constexpr int kChannels = 32 * kConsumers;  // a block's channels: a box row
constexpr int kSteps = 16;     // steps a tile: rows of a box
constexpr int kStages = 3;     // the ring
constexpr int kThreads = 32 * (1 + kConsumers);  // the producer warp first
constexpr int kBox = kSteps * kChannels;  // floats in a box
constexpr int kStageBytes = 3 * kBox * 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kOutBytes = 2 * 2 * kBox * 4;  // two tiles of da and du boxes
constexpr int kAlign = 128;  // TMA's shared-memory boxes
constexpr int kSmemBytes = kRingBytes + kOutBytes + kAlign;
constexpr int kEncodeError = 1000;  // + the CUresult of a refused encode

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
    rglru_scan_bwd_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                              const __grid_constant__ CUtensorMap tm_h,
                              const __grid_constant__ CUtensorMap tm_dh,
                              const __grid_constant__ CUtensorMap tm_da,
                              const __grid_constant__ CUtensorMap tm_du,
                              int S, int channel_blocks) {
  // the ring, stage s: the a box, the h box, the dh box; then two output
  // tiles, each a da box and a du box
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~(uintptr_t)(kAlign - 1));
  float* out = ring + kStages * 3 * kBox;
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full, then empty
  const int b = blockIdx.x / channel_blocks;
  const int c0 = (blockIdx.x - b * channel_blocks) * kChannels;
  const int tid = threadIdx.x;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * kStages;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 32 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32) {
    // producer: tile i of the walk starts at step t0, the last tile first
    if (tid == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) - 1) & 1);
        const int t0 = (n_tiles - 1 - i) * kSteps;
        const uint32_t full = full0 + 8 * s;
        const float* stage = ring + s * 3 * kBox;
        mbar_expect_tx(full, kStageBytes);
        tma_load(smem_u32(stage), &tm_a, full, c0, 0, t0 + 1, b);
        tma_load(smem_u32(stage + kBox), &tm_h, full, c0, 0, t0 - 1, b);
        tma_load(smem_u32(stage + 2 * kBox), &tm_dh, full, c0, 0, t0, b);
      }
    }
    return;
  }

  // consumer: thread `lane` carries g for channel c0 + lane; its first
  // thread starts the output tiles' TMA stores
  const int lane = tid - 32;
  auto consumers_sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
  };
  float g = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int t0 = (n_tiles - 1 - i) * kSteps;
    float* tile = out + (i & 1) * 2 * kBox;  // the da box, the du box
    float* oda = tile + lane;
    float* odu = oda + kBox;
    if (i >= 2) {
      // the output tile of step i - 2 has left shared memory
      if (lane == 0) bulk_wait_read<1>();
      consumers_sync();
    }
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    // the stage's rows into registers, then the stage back to the
    // producer: the chain's shared-memory writes below cannot hold up
    // these reads
    const float* sa = ring + s * 3 * kBox + lane;
    float ra[kSteps], rh[kSteps], rd[kSteps];
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      ra[r] = sa[r * kChannels];
      rh[r] = sa[kBox + r * kChannels];
      rd[r] = sa[2 * kBox + r * kChannels];
    }
    mbar_arrive(empty0 + 8 * s);
    // row `top` is step S - 1 in the last tile in time (g = dh, no later
    // step to carry from; rows past it are not stored), past the tile in
    // every other
    const int top = S - 1 - t0;
#pragma unroll
    for (int r = kSteps - 1; r >= 0; --r) {
      if (r > top) continue;
      // step t0 + r < S - 1: g = fma(a_{t+1}, g, dh_t)
      g = r == top ? rd[r] : __fmaf_rn(ra[r], g, rd[r]);
      // du_t = g, da_t = g * h_{t-1}, da_0 = 0
      odu[r * kChannels] = g;
      oda[r * kChannels] = t0 + r > 0 ? __fmul_rn(g, rh[r]) : 0.f;
    }
    fence_async_shared();
    consumers_sync();
    if (lane == 0) {
      tma_store(&tm_da, smem_u32(tile), c0, 0, t0, b);
      tma_store(&tm_du, smem_u32(tile + kBox), c0, 0, t0, b);
      bulk_commit_group();
    }
  }
  if (lane == 0) bulk_wait_all();
}

// a 4-D map over x [B, S, D] viewed as [B, S, 1, D], boxes [1, kSteps, 1,
// kChannels] f32, out-of-range elements read as zeros
int encode_steps(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
                 int64_t D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t es = 4;
  const cuuint64_t dims[4] = {(cuuint64_t)D, 1, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {es * D, es * D, es * D * S};
  const cuuint32_t box[4] = {kChannels, 1, kSteps, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

int launch(void* const* ptrs, int64_t B, int64_t S, int64_t D,
           cudaStream_t stream) {
  static_assert(sizeof(ScanBwdArgs) == kNumPointers * sizeof(void*),
                "ScanBwdArgs must be exactly the pointer list");
  ScanBwdArgs p;
  memcpy(&p, ptrs, sizeof(p));
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (D % 4 != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kNumPointers; ++i) {
    if ((uintptr_t)ptrs[i] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  const int64_t channel_blocks = (D + kChannels - 1) / kChannels;
  const int64_t blocks = B * channel_blocks;
  if (S > 0x7fffffffLL - 2 * kSteps || D > 0x7fffffffLL ||
      blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_bwd_tma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tm_a, tm_h, tm_dh, tm_da, tm_du;
  int rc = encode_steps(&tm_a, p.a, B, S, D);
  if (rc == 0) rc = encode_steps(&tm_h, p.h, B, S, D);
  if (rc == 0) rc = encode_steps(&tm_dh, p.dh, B, S, D);
  if (rc == 0) rc = encode_steps(&tm_da, p.da, B, S, D);
  if (rc == 0) rc = encode_steps(&tm_du, p.du, B, S, D);
  if (rc != 0) return rc;
  rglru_scan_bwd_tma_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                              stream>>>(tm_a, tm_h, tm_dh, tm_da, tm_du,
                                        (int)S, (int)channel_blocks);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// ptrs: the 5 device pointers in ScanBwdArgs field order, each 16-byte
// aligned, the tensors contiguous f32 [B, S, D]; D a multiple of 4.
// Launches one block per (batch row, 32 channels) on `stream` and returns
// the launch error (0 on success).
extern "C" int rglru_scan_bwd_tma_launch(void* const* ptrs, int64_t B,
                                         int64_t S, int64_t D, void* stream) {
  return repro_torch::launch(ptrs, B, S, D, (cudaStream_t)stream);
}

extern "C" const char* rglru_scan_bwd_tma_error_string(int code) {
  if (code >= repro_torch::kEncodeError) {
    static char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled refused a tensor "
             "map (CUresult %d)", code - repro_torch::kEncodeError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int rglru_scan_bwd_tma_num_pointers() {
  return repro_torch::kNumPointers;
}
