// The RG-LRU gated linear recurrence (Griffin), every state written:
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = 0,
// on float32 (B, S, W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_rglru_kernel, wrapper rglru), which tiles channels into VMEM blocks
// and runs time in order inside the block.
//
// Design: one thread per (batch, channel), the state in a register, time
// in order.  Neighbouring threads hold neighbouring channels, so each
// step's loads of x and a and the store of h are coalesced.  Eight steps
// of x and a are loaded before they are folded in, so eight loads are in
// flight per thread while the dependent chain runs.
//
// Bound on the H100: bytes.  The function reads x and a once and writes
// every h: 12 B per (batch, step, channel), about 10 flops on them.  At
// the serving shapes (B x W = 16,384 threads) the card holds too few
// threads to cover memory latency fully; splitting time into chunks with
// a second pass would add parallelism.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float step(float h, float a, float x) {
  return a * h + sqrtf(fmaxf(1.f - a * a, 0.f)) * x;
}

__global__ void rglru_scan_kernel(const float* __restrict__ x,
                                  const float* __restrict__ a,
                                  float* __restrict__ h, int batch, int s,
                                  int w) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * w) return;
  const long long b = idx / w;
  const long long base = b * s * w + idx % w;
  float state = 0.f;
  int t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long o = base + static_cast<long long>(t + u) * w;
      xs[u] = x[o];
      as[u] = a[o];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = step(state, as[u], xs[u]);
      h[base + static_cast<long long>(t + u) * w] = state;
    }
  }
  for (; t < s; ++t) {
    const long long o = base + static_cast<long long>(t) * w;
    state = step(state, a[o], x[o]);
    h[o] = state;
  }
}

}  // namespace

extern "C" int rglru_scan_f32(const float* x, const float* a, float* h,
                              int batch, int s, int w, cudaStream_t stream) {
  if (batch <= 0 || s <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(batch) * w;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, a, h, batch, s, w);
  return static_cast<int>(cudaGetLastError());
}
