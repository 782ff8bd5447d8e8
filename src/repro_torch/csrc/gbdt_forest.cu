// Dense-forest GBDT margins, one forest or a read/write pair with a
// per-row forest selector.
//
// Replaces the Pallas TPU kernels src/repro/kernels/gbdt_forest/kernel.py
// _paired_forest_kernel (wrapper paired_forest_margin) and _forest_kernel
// (wrapper forest_margin).  Each tree is a complete binary tree of depth D
// in dense arrays: feature/threshold (P, T, 2^D - 1), leaf (P, T, 2^D)
// with P = 1 or 2 forests.  A row descends idx = 2*idx + 1 + (x[f] > thr)
// for D levels (a +inf threshold always goes left), and its margin is the
// sum of the T reached leaves, in ascending tree order, plus the forest's
// base score.  With `op` null the launch is the single-forest form
// (forest 0).
//
// Bound on the H100: bytes, by far.  Per row the function reads
// n_features * 4 B of x and 4 B of op and writes 4 B; the forests (~60 KB
// each at 160 trees, depth 5) are read once: ~0.009 ms for the fleet's
// 196,608 x 36 rows.  The work is N * T * D compares, but each level is a
// chain of two dependent loads (node, then x[feature]), so what a design
// can reach is set by the loads it makes and where they land.
//
// Design: everything a descent touches lives in shared memory.
// - A block stages the forests its rows select, once: each node packed
//   as one 8-byte word (the feature's offset in the x tile, the
//   threshold's bits), the leaves beside them.  Blocks are persistent
//   (as many as fit on the SMs at once, most often one an SM) and each
//   takes one contiguous, even share of the rows, walked in tiles of
//   `rows` rows, so the staging is paid once a block.  The fleet's batch
//   is the read rows, then the write rows, so all but one block stage a
//   single forest.
// - The x tile is feature-major, x_s[f][r] with `rows` a multiple of 32:
//   a lane only ever reads its own row r, so a warp's 32 loads of any
//   features fall in 32 distinct banks (a row-major tile conflicts as
//   soon as the lanes' features differ).  A thread stages its own row
//   (16-byte loads where the rows allow).
// - A thread descends kGroup trees level by level together, so kGroup
//   independent load chains are in flight, then adds their leaves to its
//   float32 accumulator in ascending tree order: the margin is summed
//   t = 0..T-1, the plain version's order, whatever the group.  Depths
//   1 to 8 are compiled with their levels unrolled (no spills, and
//   faster at depth 5 than one loop over the depth); deeper forests take
//   the loop.
// - Limits (the wrapper raises a ValueError past them): the forests and
//   one tile must fit the 227 KB a block can opt into:
//       P * T * ((2^D - 1) * 8 + 2^D * 4) + rows * n_features * 4,
//   with rows the largest of 512, 256, 128, 64, 32 that fits
//   (kernel.py::forest_layout).  A pair of 160 trees of depth 5 takes
//   120,320 B, which leaves room for 512-row tiles up to 54 features and
//   32-row tiles up to 876.  `op` values must lie in [0, P), P <= 32.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kGroup = 8;  // trees descended together

// Descend trees t .. t + G - 1 of one forest for the row whose tile
// column is `xr`, then add their leaves to `acc` in ascending order.
// kDepth > 0 fixes the depth at compile time (levels unrolled); 0 reads
// it from `depth`.
template <int kDepth, int G>
__device__ __forceinline__ float add_trees(const int2* nodes,
                                           const float* leaves,
                                           const float* xr, int t, int depth,
                                           float acc) {
  const int levels = kDepth > 0 ? kDepth : depth;
  const int n_internal = (1 << levels) - 1;
  int idx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) idx[g] = 0;
#pragma unroll
  for (int d = 0; d < levels; ++d) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int2 nd = nodes[(t + g) * n_internal + idx[g]];
      idx[g] = 2 * idx[g] + 1 + (xr[nd.x] > __int_as_float(nd.y));
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc += leaves[(t + g) * (n_internal + 1) + idx[g] - n_internal];
  }
  return acc;
}

template <int kDepth>
__global__ void __launch_bounds__(512)
    forest_margin_kernel(const float* __restrict__ x,
                         const int* __restrict__ op,
                         const int* __restrict__ feature,
                         const float* __restrict__ threshold,
                         const float* __restrict__ leaf,
                         const float* __restrict__ base,
                         float* __restrict__ out, int n, int n_features,
                         int n_forests, int n_trees, int depth, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  const int n_internal = (1 << (kDepth > 0 ? kDepth : depth)) - 1;
  const int forest_nodes = n_trees * n_internal;
  const int forest_leaves = n_trees * (n_internal + 1);
  int2* nodes = reinterpret_cast<int2*>(smem);           // [P][T][2^D - 1]
  float* leaves = reinterpret_cast<float*>(nodes + n_forests * forest_nodes);
  float* xs = leaves + n_forests * forest_leaves;        // [F][rows]

  // this block's rows: a contiguous, even share
  const int per = n / gridDim.x, extra = n % gridDim.x;
  const int r0 = blockIdx.x * per + min(static_cast<int>(blockIdx.x), extra);
  const int r1 = r0 + per + (static_cast<int>(blockIdx.x) < extra);

  // the forests those rows select, staged once
  unsigned mine = op ? 0u : 1u;
  if (op) {
    for (int r = r0 + threadIdx.x; r < r1; r += rows) mine |= 1u << op[r];
  }
  for (int f = 0; f < n_forests; ++f) {
    if (!__syncthreads_or((mine >> f) & 1u)) continue;
    for (int i = threadIdx.x; i < forest_nodes; i += rows) {
      const int g = f * forest_nodes + i;
      nodes[g] = make_int2(feature[g] * rows, __float_as_int(threshold[g]));
    }
    for (int i = threadIdx.x; i < forest_leaves; i += rows) {
      leaves[f * forest_leaves + i] = leaf[f * forest_leaves + i];
    }
  }

  const float* xr = xs + threadIdx.x;
  for (int tile = r0; tile < r1; tile += rows) {
    __syncthreads();  // forests staged; the previous tile read
    const int row = tile + threadIdx.x;
    const bool live = row < r1;
    if (live) {
      const float* src = x + static_cast<size_t>(row) * n_features;
      if (vec) {
        for (int f = 0; f < n_features; f += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src + f));
          xs[f * rows + threadIdx.x] = v.x;
          xs[(f + 1) * rows + threadIdx.x] = v.y;
          xs[(f + 2) * rows + threadIdx.x] = v.z;
          xs[(f + 3) * rows + threadIdx.x] = v.w;
        }
      } else {
        for (int f = 0; f < n_features; ++f) {
          xs[f * rows + threadIdx.x] = __ldg(src + f);
        }
      }
    }
    __syncthreads();
    if (!live) continue;
    const int forest = op ? op[row] : 0;
    const int2* nd = nodes + forest * forest_nodes;
    const float* lv = leaves + forest * forest_leaves;
    float acc = 0.0f;
    int t = 0;
    for (; t + kGroup <= n_trees; t += kGroup) {
      acc = add_trees<kDepth, kGroup>(nd, lv, xr, t, depth, acc);
    }
    for (; t < n_trees; ++t) {
      acc = add_trees<kDepth, 1>(nd, lv, xr, t, depth, acc);
    }
    out[row] = acc + __ldg(base + forest);
  }
}

// The current device's shared-memory opt-in limit and SM count, queried
// once a device: a process may launch on several (a fleet mesh), and the
// opt-in and occupancy below are per device too.
constexpr int kMaxDevices = 64;

struct Device {
  cudaError_t err = cudaSuccess;
  int id = 0, smem_limit = 0, sms = 0;
};

const Device& device() {
  static Device cache[kMaxDevices];
  static bool ready[kMaxDevices] = {};
  static Device failed;
  int dev = 0;
  failed.err = cudaGetDevice(&dev);
  if (failed.err == cudaSuccess && (dev < 0 || dev >= kMaxDevices)) {
    failed.err = cudaErrorInvalidDevice;
  }
  if (failed.err != cudaSuccess) return failed;
  if (!ready[dev]) {
    Device d;
    d.id = dev;
    d.err = cudaDeviceGetAttribute(
        &d.smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (d.err == cudaSuccess) {
      d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    }
    cache[dev] = d;
    ready[dev] = true;
  }
  return cache[dev];
}

// The kernel is allowed the device's whole opt-in once a device, and its
// blocks an SM are asked again only when (rows, bytes) change: both by the
// first (warm-up) launch of a shape, outside any CUDA-graph capture, and
// reused by the launches captured after it.
template <int kDepth>
int launch(const float* x, const int* op, const int* feature,
           const float* threshold, const float* leaf, const float* base,
           float* out, int n, int n_features, int n_forests, int n_trees,
           int depth, int rows, int smem, const Device& d,
           cudaStream_t stream) {
  static bool set[kMaxDevices] = {};
  if (!set[d.id]) {
    const cudaError_t err = cudaFuncSetAttribute(
        forest_margin_kernel<kDepth>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    set[d.id] = true;
  }
  static int last_rows[kMaxDevices] = {}, last_smem[kMaxDevices] = {},
             per_sm[kMaxDevices] = {};
  if (rows != last_rows[d.id] || smem != last_smem[d.id]) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[d.id], forest_margin_kernel<kDepth>, rows,
        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    last_rows[d.id] = rows;
    last_smem[d.id] = smem;
  }
  if (per_sm[d.id] < 1) return static_cast<int>(cudaErrorInvalidValue);
  // persistent blocks, but none with fewer than 32 rows
  const int blocks =
      std::max(1, std::min(d.sms * per_sm[d.id], (n + 31) / 32));
  const int vec = n_features % 4 == 0 &&
                  (reinterpret_cast<size_t>(x) & 15) == 0;
  forest_margin_kernel<kDepth>
      <<<blocks, rows, static_cast<size_t>(smem), stream>>>(
          x, op, feature, threshold, leaf, base, out, n, n_features,
          n_forests, n_trees, depth, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rows` (threads a block, a multiple of 32, at most 512) is the x tile's
// height; the wrapper picks it from the shared-memory budget.
extern "C" int forest_margin_f32(const float* x, const int* op,
                                 const int* feature, const float* threshold,
                                 const float* leaf, const float* base,
                                 float* out, int n, int n_features,
                                 int n_forests, int n_trees, int depth,
                                 int rows, cudaStream_t stream) {
  if (n <= 0 || n_features <= 0 || n_trees <= 0 || depth < 1 || depth > 16 ||
      n_forests < 1 || n_forests > 32 || rows < 32 || rows > 512 ||
      rows % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      static_cast<long long>(n_forests) * n_trees *
          (((1LL << depth) - 1) * 8 + (1LL << depth) * 4) +
      static_cast<long long>(rows) * n_features * 4;
  const Device& d = device();
  if (d.err != cudaSuccess) return static_cast<int>(d.err);
  if (smem > d.smem_limit) return static_cast<int>(cudaErrorInvalidValue);
  // depths 1..8 compiled with their levels unrolled, deeper ones not
  using Launch = decltype(&launch<0>);
  static constexpr Launch kLaunch[] = {launch<0>, launch<1>, launch<2>,
                                       launch<3>, launch<4>, launch<5>,
                                       launch<6>, launch<7>, launch<8>};
  return kLaunch[depth <= 8 ? depth : 0](
      x, op, feature, threshold, leaf, base, out, n, n_features, n_forests,
      n_trees, depth, rows, static_cast<int>(smem), d, stream);
}
