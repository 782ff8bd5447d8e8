// Deterministic float64 segment sum over a precomputed CSR segment map.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce/kernel.py
// (_segment_sum_kernel, wrapper segment_sum): out[s] = sum of values[i] over
// segment_ids[i] == s, ids >= S dropped.  The TPU kernel builds a one-hot
// block and runs a (1, E) @ (E, S) matmul in f32; this one keeps the
// engine's float64 and sums every segment in ascending entry order, which
// is exactly np.bincount's sequential loop, so the result is bit-equal to
// the numpy oracle (no float atomics, no reordering).
//
// The host builds the CSR form once per static mapping: `order` is a
// stable argsort of the kept ids (positions into `values`), `offsets` the
// per-segment start indices (S + 1 of them).
//
// Bound on the H100: bytes.  The function reads each value once (8 B) plus
// its position in `order` (4 B) and writes S doubles; there is no
// arithmetic to speak of.  At the engine's sizes (E <= 8192) one launch
// moves < 200 KB, so a launch costs its fixed overhead, not bandwidth.
// Design: one warp per segment.  The warp gathers 32 values at once (the
// loads overlap), then every lane folds them into the accumulator in
// index order through warp shuffles -- the order of the sum stays the
// sequential one while the memory latency is paid once per 32 entries.
// A very skewed mapping (few large segments, e.g. 8,192 interfaces onto
// 32 OSTs) leaves most SMs idle; splitting a segment across warps would
// change the summation order and is left for a later design.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void segment_sum_kernel(const double* __restrict__ values,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   double* __restrict__ out,
                                   int num_segments) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= num_segments) return;  // uniform across the warp
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  double acc = 0.0;
  for (int base = begin; base < end; base += 32) {
    const int k = base + lane;
    const double v = k < end ? values[order[k]] : 0.0;
    const int n = min(32, end - base);
    for (int j = 0; j < n; ++j) {
      acc += __shfl_sync(0xffffffffu, v, j);
    }
  }
  if (lane == 0) out[seg] = acc;
}

}  // namespace

extern "C" int segment_sum_f64(const double* values, const int* order,
                               const int* offsets, double* out,
                               int num_segments, cudaStream_t stream) {
  if (num_segments <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      values, order, offsets, out, num_segments);
  return static_cast<int>(cudaGetLastError());
}
