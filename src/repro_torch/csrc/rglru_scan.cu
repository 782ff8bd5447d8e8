// The RG-LRU gated linear recurrence (Griffin), every state written:
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = 0,
// on float32 (B, S, W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_rglru_kernel, wrapper rglru), which tiles channels into VMEM blocks
// and runs time in order inside the block.
//
// Bound on the H100: bytes.  The function reads x and a once and writes
// every h: 12 B per (batch, step, channel), about 10 flops on them; at
// recurrentgemma-9b's layer (4 x 3,072 x 4,096) 0.18 ms at 3.35 TB/s.
// The fold itself is one dependent FMA a step, so the kernel lives or
// dies by the bytes it keeps in flight: one thread per channel holding
// a few steps in registers covers a fraction of the memory latency
// (16,384 channels are ~4 warps an SM).
//
// Design: time in order per channel, fed from a shared-memory ring.
// - A block takes kTile = 64 channels of one batch row: two consumer
//   warps (one channel a lane, the state in a register) and one producer
//   warp.  At 4 x 4,096 channels that is 256 blocks, every one resident
//   at once (64 KB of ring each, up to three an SM), so the card streams
//   in one wave; 64-channel rows are 256 B, whole L2 lines.  Any tile
//   leaves 4 of the 132 SMs with less work (16,384 channels = 124.1 an
//   SM), which costs nothing while HBM, not the SMs, is the limit.
// - The producer keeps kStages = 4 stages of kSteps = 32 steps of x and
//   a in flight (64 KB a block): one bulk copy (cp.async.bulk, the TMA
//   engine) per (step, array) row, completing on the stage's mbarrier
//   with its byte count.  Consumers release a stage on a second
//   mbarrier once they have read it.  Rows that are not 16-byte
//   granules (W % 4 != 0, or a misaligned tensor) are staged by the
//   producer's lanes with plain loads instead; same ring, same
//   barriers.
// - Consumers fold their channel's steps from shared memory in order
//   and store every h_t straight to device memory (a warp's 32 lanes
//   write one 128-byte line a step), in the plain version's order: no
//   sum is reordered.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;                  // channels a block
constexpr int kConsumerWarps = kTile / 32;
constexpr int kSteps = 32;                 // steps a stage
constexpr int kStages = 4;                 // stages in the ring

__device__ __forceinline__ float step(float h, float a, float x) {
  return a * h + sqrtf(fmaxf(1.f - a * a, 0.f)) * x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from device
// memory into shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Stage {
  float x[kSteps][kTile];
  float a[kSteps][kTile];
};

__global__ void __launch_bounds__(kTile + 32)
    rglru_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      float* __restrict__ h, int s, int w, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  __shared__ uint64_t full[kStages], empty[kStages];

  const int tiles = (w + kTile - 1) / kTile;
  const long long row0 = static_cast<long long>(blockIdx.x / tiles) * s;
  const int c0 = (blockIdx.x % tiles) * kTile;
  const int width = min(kTile, w - c0);
  const int chunks = (s + kSteps - 1) / kSteps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);               // the producer's lanes
      mbar_init(&empty[i], kConsumerWarps);  // one lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    for (int k = 0; k < chunks; ++k) {
      const int slot = k % kStages;
      if (k >= kStages) mbar_wait(&empty[slot], ((k / kStages) - 1) & 1);
      const int t0 = k * kSteps, steps = min(kSteps, s - t0);
      Stage& st = ring[slot];
      if (bulk) {
        const unsigned bytes = static_cast<unsigned>(width) * 4u;
        if (lane == 0) mbar_arrive_expect_tx(&full[slot], 2u * steps * bytes);
        for (int r = lane; r < 2 * steps; r += 32) {
          const int t = r >> 1;
          const long long o = (row0 + t0 + t) * w + c0;
          if (r & 1) {
            bulk_load(st.a[t], a + o, bytes, &full[slot]);
          } else {
            bulk_load(st.x[t], x + o, bytes, &full[slot]);
          }
        }
        if (lane != 0) mbar_arrive(&full[slot]);
      } else {
#pragma unroll 4
        for (int i = lane; i < steps * width; i += 32) {
          const int t = i / width, c = i % width;
          const long long o = (row0 + t0 + t) * w + c0 + c;
          st.x[t][c] = x[o];
          st.a[t][c] = a[o];
        }
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // consumers: one channel a lane, time in order
  const int c = threadIdx.x;
  float* hp = h + row0 * w + c0 + c;
  float state = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int slot = k % kStages;
    mbar_wait(&full[slot], (k / kStages) & 1);
    const int t0 = k * kSteps, steps = min(kSteps, s - t0);
    const Stage& st = ring[slot];
    if (c < width) {
      if (steps == kSteps) {
#pragma unroll 8
        for (int t = 0; t < kSteps; ++t) {
          state = step(state, st.a[t][c], st.x[t][c]);
          hp[static_cast<long long>(t0 + t) * w] = state;
        }
      } else {
        for (int t = 0; t < steps; ++t) {
          state = step(state, st.a[t][c], st.x[t][c]);
          hp[static_cast<long long>(t0 + t) * w] = state;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

}  // namespace

extern "C" int rglru_scan_f32(const float* x, const float* a, float* h,
                              int batch, int s, int w, cudaStream_t stream) {
  if (batch <= 0 || s <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(batch) * ((w + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = kStages * static_cast<int>(sizeof(Stage));
  // once, by the first (warm-up) launch, outside any CUDA-graph capture
  static const cudaError_t set = cudaFuncSetAttribute(
      rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int bulk =
      w % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a)) &
       15) == 0;
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kTile + 32, smem,
                      stream>>>(x, a, h, s, w, bulk);
  return static_cast<int>(cudaGetLastError());
}
