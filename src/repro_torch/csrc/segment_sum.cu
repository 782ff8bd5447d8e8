// Deterministic float64 segment sum over a precomputed CSR segment map,
// for one or several value columns at once.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce/kernel.py
// (_segment_sum_kernel, wrapper segment_sum): out[s] = sum of values[i] over
// segment_ids[i] == s, ids >= S dropped.  The TPU kernel builds a one-hot
// block and runs a (1, E) @ (E, S) matmul in f32; this one keeps the
// engine's float64 and sums every segment in ascending entry order, which
// is exactly np.bincount's sequential loop, so the result is bit-equal to
// the numpy oracle (no float atomics, no reordering, no split chain).
// values is (K, E) with rows `stride` apart; out is (K, S), each column
// k an independent ordered sum of row k, all K in one launch.
//
// The host builds the CSR form once per static mapping: `order` is a
// stable argsort of the kept ids (positions into a row of `values`),
// `offsets` the per-segment start indices (S + 1 of them).
//
// Bound on the H100: the order.  The function moves few bytes (each
// value once, 8 B, plus its position, 4 B; < 1 MB at the engine's
// sizes), but a segment's sum is one chain of dependent float64 adds
// (~4 ns each), so a launch costs at least its fixed overhead plus the
// longest segment's chain: 256 adds at the 8,192-interface OST map.
//
// Design: one warp per segment (and per group of up to kMaxCols
// columns), no block-wide syncs.  The segment is walked in chunks of up
// to 256 entries: every lane loads its share of a chunk's positions at
// once (one round trip), then issues one 8-byte cp.async per (entry,
// column) into shared memory (one more), so memory latency is paid
// once a chunk, not once per 32 entries.  Lane k then folds column k
// from shared memory in ascending entry order -- a bare chain of DADDs,
// with the shared loads running ahead of it -- while the next chunk's
// copies (double buffer) and the one after's positions are in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;      // columns a warp folds (grid.y groups more)
constexpr int kMaxChunk = 256;   // entries a chunk
constexpr int kMaxU = kMaxChunk / 32;
constexpr int kChunkDoubles = 512;  // chunk x columns held per buffer
constexpr int kFold = 8;         // adds whose operands are loaded together

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc + b[0] + b[kc] + ... + b[(len - 1) * kc], in that order: each
// group of kFold operands is loaded from shared memory before the
// previous group's adds, so the adds run back to back.
__device__ __forceinline__ double fold(double acc, const double* b, int kc,
                                       int len) {
  int j = 0;
  if (len >= kFold) {
    double x[kFold];
#pragma unroll
    for (int i = 0; i < kFold; ++i) x[i] = b[i * kc];
    for (j = kFold; j + kFold <= len; j += kFold) {
      double nx[kFold];
#pragma unroll
      for (int i = 0; i < kFold; ++i) nx[i] = b[(j + i) * kc];
#pragma unroll
      for (int i = 0; i < kFold; ++i) {
        acc = __dadd_rn(acc, x[i]);
        x[i] = nx[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kFold; ++i) acc = __dadd_rn(acc, x[i]);
  }
  for (; j < len; ++j) acc = __dadd_rn(acc, b[j * kc]);
  return acc;
}

__global__ void __launch_bounds__(256)
    segment_sum_kernel(const double* __restrict__ values, long long stride,
                       const int* __restrict__ order,
                       const int* __restrict__ offsets,
                       double* __restrict__ out, int num_segments,
                       int num_cols, int chunk) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * (blockDim.x >> 5) + warp;
  if (seg >= num_segments) return;  // uniform across the warp
  const int c0 = blockIdx.y * kMaxCols;
  const int kc = min(kMaxCols, num_cols - c0);
  const int kc_max = min(kMaxCols, num_cols);  // the launch's buffer width
  double* const bufs = smem + warp * 2 * chunk * kc_max;  // two buffers
  const double* col = values + c0 * stride;

  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  const int n_chunks = (end - begin + chunk - 1) / chunk;
  int pos[kMaxU];
  auto load_pos = [&](int ch) {  // positions of chunk ch, -1 past its end
    const int base = begin + ch * chunk;
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      const int j = u * 32 + lane;
      pos[u] = (j < chunk && base + j < end) ? order[base + j] : -1;
    }
  };
  auto issue = [&](int ch) {  // cp.async chunk ch's values into its buffer
    double* dst = bufs + (ch & 1) * chunk * kc_max;
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      if (pos[u] >= 0) {
        const int j = u * 32 + lane;
        for (int c = 0; c < kc; ++c) {
          cp_async8(dst + j * kc + c, col + c * stride + pos[u]);
        }
      }
    }
    cp_async_commit();
  };

  double acc = 0.0;
  if (n_chunks > 0) {
    load_pos(0);
    issue(0);
    if (n_chunks > 1) load_pos(1);
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      issue(ch + 1);  // its positions were loaded one fold ago
      if (ch + 2 < n_chunks) load_pos(ch + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of chunk ch are visible
    if (lane < kc) {
      acc = fold(acc, bufs + (ch & 1) * chunk * kc_max + lane, kc,
                 min(chunk, end - begin - ch * chunk));
    }
    __syncwarp();  // the buffer is free for chunk ch + 2
  }
  if (lane < kc) out[static_cast<long long>(c0 + lane) * num_segments + seg] =
      acc;
}

}  // namespace

// values (num_cols, E) with rows `stride` doubles apart; out (num_cols,
// num_segments); `max_len` is the map's longest segment.
extern "C" int segment_sum_f64(const double* values, long long stride,
                               const int* order, const int* offsets,
                               double* out, int num_segments, int num_cols,
                               int max_len, cudaStream_t stream) {
  if (num_segments <= 0 || num_cols <= 0 || max_len < 0 ||
      (num_cols + kMaxCols - 1) / kMaxCols > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kc = num_cols < kMaxCols ? num_cols : kMaxCols;
  // a chunk: the longest segment rounded up to a warp, at most 256 and
  // at most kChunkDoubles / kc entries (a multiple of 32)
  int chunk = (max_len + 31) / 32 * 32;
  const int cap = kChunkDoubles / kc / 32 * 32;
  chunk = chunk < 32 ? 32 : chunk;
  chunk = chunk > cap ? cap : chunk;
  chunk = chunk > kMaxChunk ? kMaxChunk : chunk;
  // many short segments: 8 warps a block; long ones: 4, so that a block
  // holds at most 32 KB of buffers either way
  const int warps = chunk == 32 ? 8 : 4;
  const size_t smem = sizeof(double) * warps * 2 * chunk * kc;
  const dim3 grid((num_segments + warps - 1) / warps,
                  (num_cols + kMaxCols - 1) / kMaxCols);
  segment_sum_kernel<<<grid, warps * 32, smem, stream>>>(
      values, stride, order, offsets, out, num_segments, num_cols, chunk);
  return static_cast<int>(cudaGetLastError());
}
