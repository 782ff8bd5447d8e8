// GBDT training histograms: per-(node, feature, bin) channel sums, in
// float64 (exact training) or float32 (fast training), deterministic.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tree_histogram/kernel.py
// (_tree_histogram_kernel, wrapper tree_histogram):
//   out[b, c, j, f, k] = sum of values[b, c, i] over node[b, i] == j and
//                        bins[b, i, f] == k,
// node ids outside [0, n_nodes) dropped.  The TPU kernel builds a one-hot
// block per (feature, sample tile) and runs a float32 matmul; that has no
// float64 form and no fixed summation order on this card.
//
// Bin codes never change during a training run, so the host builds once,
// per feature, the stable order of samples by bin code: `perm` (B, F, n)
// and the bin starts `bnd` (B, F, n_bins + 1) into it.  Bin k of feature f
// is then the segment perm[bnd[k] : bnd[k + 1]], in ascending sample index.
// A feature the caller skips (the trainer skips those that cannot split)
// has a row of zeros in `bnd`: all its segments are empty, its cells 0.
//
// Design: one warp per (batch, feature, bin) segment and group of 32
// output cells (cell = node * C + channel; one group while n_nodes * C <=
// 32, which covers depth-5 trees).  The warp stages 32 samples of the
// segment at a time in shared memory (node id and C values, gathered once
// per sample), then every lane walks them in order and adds the values of
// the samples whose node is its own cell's.  Each cell is therefore a
// sequential sum in ascending sample index -- the order np.bincount uses --
// so float64 results are bit-equal to the numpy oracle, two launches give
// the same bits, and no float atomics are used.  Every cell of `out` is
// written (empty cells get 0), so the output needs no zeroing.
//
// Bound on the H100: bytes.  The function reads each value once (C x 8 B
// or 4 B), each node id once (4 B), the order (F x n x 4 B) and the bin
// starts, and writes the histogram; the work is F x n x C adds (F = the
// walked features).  In practice the longest segment (a feature with few
// distinct values puts most samples in one bin) sets the launch's time,
// since one warp walks it; splitting a segment would change the
// summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChannels = 4;

template <typename T>
__global__ void tree_histogram_kernel(const T* __restrict__ values,
                                      const int* __restrict__ node,
                                      const int* __restrict__ perm,
                                      const int* __restrict__ bnd,
                                      T* __restrict__ out, int batch,
                                      int channels, int n, int n_features,
                                      int n_bins, int n_nodes, int groups) {
  __shared__ T s_val[kWarpsPerBlock][kMaxChannels][32];
  __shared__ int s_node[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  const long long n_warps =
      static_cast<long long>(batch) * n_features * n_bins * groups;
  if (w >= n_warps) return;  // uniform across the warp
  const int group = static_cast<int>(w % groups);
  w /= groups;
  const int bin = static_cast<int>(w % n_bins);
  w /= n_bins;
  const int f = static_cast<int>(w % n_features);
  const int b = static_cast<int>(w / n_features);

  const int cell = group * 32 + lane;
  const bool owner = cell < n_nodes * channels;
  const int my_node = owner ? cell / channels : -1;
  const int my_c = owner ? cell % channels : 0;

  const long long bf = static_cast<long long>(b) * n_features + f;
  const int* seg_bnd = bnd + bf * (n_bins + 1);
  const int begin = seg_bnd[bin];
  const int end = seg_bnd[bin + 1];
  const int* order = perm + bf * n;
  const T* vals = values + static_cast<long long>(b) * channels * n;
  const int* nodes = node + static_cast<long long>(b) * n;

  T acc = T(0);
  for (int base = begin; base < end; base += 32) {
    const int k = base + lane;
    int nd = -1;
    if (k < end) {
      const int i = order[k];
      nd = nodes[i];
      for (int c = 0; c < channels; ++c) {
        s_val[warp][c][lane] = vals[static_cast<long long>(c) * n + i];
      }
    }
    s_node[warp][lane] = nd;
    __syncwarp();
    const int m = min(32, end - base);
    for (int j = 0; j < m; ++j) {
      if (s_node[warp][j] == my_node) acc += s_val[warp][my_c][j];
    }
    __syncwarp();
  }
  if (owner) {
    const long long o =
        ((((static_cast<long long>(b) * channels + my_c) * n_nodes + my_node)
              * n_features + f) * n_bins) + bin;
    out[o] = acc;
  }
}

template <typename T>
int launch(const T* values, const int* node, const int* perm, const int* bnd,
           T* out, int batch, int channels, int n, int n_features,
           int n_bins, int n_nodes, cudaStream_t stream) {
  if (batch <= 0 || channels <= 0 || channels > kMaxChannels || n < 0 ||
      n_features <= 0 || n_bins <= 0 || n_nodes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (n_nodes * channels + 31) / 32;
  const long long n_warps =
      static_cast<long long>(batch) * n_features * n_bins * groups;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tree_histogram_kernel<T><<<static_cast<unsigned>(blocks),
                             kWarpsPerBlock * 32, 0, stream>>>(
      values, node, perm, bnd, out, batch, channels, n, n_features, n_bins,
      n_nodes, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tree_histogram_f64(const double* values, const int* node,
                                  const int* perm, const int* bnd,
                                  double* out, int batch, int channels, int n,
                                  int n_features, int n_bins, int n_nodes,
                                  cudaStream_t stream) {
  return launch<double>(values, node, perm, bnd, out, batch, channels, n,
                        n_features, n_bins, n_nodes, stream);
}

extern "C" int tree_histogram_f32(const float* values, const int* node,
                                  const int* perm, const int* bnd,
                                  float* out, int batch, int channels, int n,
                                  int n_features, int n_bins, int n_nodes,
                                  cudaStream_t stream) {
  return launch<float>(values, node, perm, bnd, out, batch, channels, n,
                       n_features, n_bins, n_nodes, stream);
}
