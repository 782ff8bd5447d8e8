// Dense-forest GBDT margins, one forest or a read/write pair with a
// per-row forest selector.
//
// Replaces the Pallas TPU kernels src/repro/kernels/gbdt_forest/kernel.py
// _paired_forest_kernel (wrapper paired_forest_margin) and _forest_kernel
// (wrapper forest_margin).  Each tree is a complete binary tree of depth D
// in dense arrays: feature/threshold (F, T, 2^D - 1), leaf (F, T, 2^D) with
// F = 1 or 2 forests.  A row descends idx = 2*idx + 1 + (x[f] > thr) for D
// levels (a +inf threshold always goes left), and its margin is the sum of
// the T reached leaves plus the forest's base score.  With `op` null the
// launch is the single-forest form (forest 0).
//
// Bound on the H100: bytes at the fleet's sizes.  Per row the function
// reads F_in * 4 B of features and 4 B of op and writes 4 B; the forest
// (~60 KB per forest at 160 trees, depth 5) is read once.  The work is
// N * T * D compares, far below the card's rate, but each is a dependent
// gather chain (node -> feature -> x value -> next node), so the kernel
// is latency-bound in practice.
// Design: one thread per row, trees summed in ascending order in a
// float32 accumulator (the TPU kernel's f32 sum, in sequential order).
// The block's rows are staged into shared memory with coalesced loads
// (row stride n_features + 1 to spread the banks), so the per-level
// feature gathers hit shared memory instead of scattered global lines.
// The forest is read through the read-only cache (__ldg); it stays in
// L1/L2 for the whole launch.  Staging the forest itself in shared
// memory is left for a later PR.

#include <cuda_runtime.h>

namespace {

__global__ void forest_margin_kernel(const float* __restrict__ x,
                                     const int* __restrict__ op,
                                     const int* __restrict__ feature,
                                     const float* __restrict__ threshold,
                                     const float* __restrict__ leaf,
                                     const float* __restrict__ base,
                                     float* __restrict__ out, int n,
                                     int n_features, int n_trees,
                                     int depth) {
  extern __shared__ float tile[];  // blockDim.x rows, stride n_features + 1
  const int stride = n_features + 1;
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = min(static_cast<int>(blockDim.x), n - row0);
  const float* src = x + static_cast<size_t>(row0) * n_features;
  for (int i = threadIdx.x; i < rows * n_features; i += blockDim.x) {
    tile[(i / n_features) * stride + (i % n_features)] = src[i];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;

  const int row = row0 + threadIdx.x;
  const int forest = op ? op[row] : 0;
  const int n_internal = (1 << depth) - 1;
  const int n_leaves = 1 << depth;
  const int* feat = feature + forest * n_trees * n_internal;
  const float* thr = threshold + forest * n_trees * n_internal;
  const float* lv = leaf + forest * n_trees * n_leaves;
  const float* xr = tile + threadIdx.x * stride;

  float acc = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const int* ft = feat + t * n_internal;
    const float* th = thr + t * n_internal;
    int idx = 0;
    for (int d = 0; d < depth; ++d) {
      idx = 2 * idx + 1 + (xr[__ldg(ft + idx)] > __ldg(th + idx));
    }
    acc += __ldg(lv + t * n_leaves + (idx - n_internal));
  }
  out[row] = acc + __ldg(base + forest);
}

}  // namespace

extern "C" int forest_margin_f32(const float* x, const int* op,
                                 const int* feature, const float* threshold,
                                 const float* leaf, const float* base,
                                 float* out, int n, int n_features,
                                 int n_trees, int depth,
                                 cudaStream_t stream) {
  if (n <= 0 || n_features <= 0 || depth < 1 || depth > 20) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the x tile lives in static-limit shared memory (48 KB): shrink the
  // block for wide rows rather than ask for the opt-in carve-out
  int threads = 128;
  while (threads > 32 &&
         static_cast<size_t>(threads) * (n_features + 1) * 4 > 48 * 1024) {
    threads /= 2;
  }
  const size_t smem = static_cast<size_t>(threads) * (n_features + 1) * 4;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + threads - 1) / threads;
  forest_margin_kernel<<<blocks, threads, smem, stream>>>(
      x, op, feature, threshold, leaf, base, out, n, n_features, n_trees,
      depth);
  return static_cast<int>(cudaGetLastError());
}
