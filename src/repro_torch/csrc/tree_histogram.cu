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
// Each cell (node * C + channel) is a sequential sum in ascending sample
// index -- the order np.bincount uses -- so float64 results are bit-equal
// to the numpy oracle, two launches give the same bits, and no float
// atomics are used.  Every cell of `out` is written (empty cells get 0).
//
// Bound on the H100.  The bytes are small (each value, node id and order
// entry read once: ~9 us at the paper-scale pair), so what bounds a launch
// is the order: the longest segment (a feature with few distinct values
// puts most samples in one bin; 96,268 of 100,000 rows at the paper-scale
// pair) is one chain of dependent float64 adds per cell, and the root
// level's cells hold every sample of it.  Splitting a segment would change
// the summation order.
//
// Design: one block of three warps per (batch, feature, bin) segment and
// group of 32 cells (one group while n_nodes * C <= 32, which covers
// depth-5 trees).  The segment is cut into 256-sample chunks; each step
// of the block works on three chunks at once:
//   two producer warps, each on its half of every chunk:
//     fetch the contiguous slice of `perm` of chunk t + 3 (16-byte
//     cp.async copies) and gather, through the slice that has landed,
//     the node ids and values of chunk t + 2 (cp.async into a ring of
//     four slots); then turn the landed chunk t + 1 into one row per
//     cell: the sample's value of the cell's channel where its node is
//     the cell's, +0.0 elsewhere (x + 0.0 == x bit for bit: a sum that
//     starts at +0.0 never holds -0.0);
//   the walker warp, lane = cell: adds its row of chunk t in order, read
//     16 bytes at a time -- two (float64) or four (float32) samples a
//     load and one add each;
// and a __syncthreads() ends the step.  So a cell's add chain issues
// nothing but its adds and their loads, and a gather has a step (~1 us
// in float64) to land.  One warp that fetched, selected and added in
// turn ran at ~2.3x the bare chain in float64, and float32 no faster.
// Short segments each get their own block.  add_chain_kernel, at the
// end, measures the bare chain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;   // samples a step
constexpr int kProducers = 2; // producer warps, each on its part of a chunk
constexpr int kPart = kChunk / kProducers;
constexpr int kPer = kPart / 32;  // samples a producer lane builds
constexpr int kThreads = 32 * (kProducers + 1);
constexpr int kSlots = 4;     // staging ring: chunks t + 1 ... t + 3
constexpr int kLead = kSlots - 2;
constexpr int kMaxChannels = 4;
static_assert(kPart % 32 == 0 && (kPer == 2 || kPer == 4), "chunk split");

template <typename T, int C>
struct Layout {  // dynamic shared memory of one block
  // a row of kChunk values, padded by 16 bytes so that consecutive rows
  // start in different banks
  static constexpr int row = kChunk + 16 / static_cast<int>(sizeof(T));
  // one staging slot: order slice, node ids, values (one row a channel)
  static constexpr int slot = kChunk * 2 * static_cast<int>(sizeof(int)) +
                              C * row * static_cast<int>(sizeof(T));
  static constexpr int staging = kSlots * slot;
  // the walker's rows: two buffers of `cells` rows
  static int bytes(int cells) {
    return staging + 2 * cells * row * static_cast<int>(sizeof(T));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v where `on`, else +0.0
__device__ __forceinline__ double keep(bool on, double v) {
  return __longlong_as_double(on ? __double_as_longlong(v) : 0LL);
}
__device__ __forceinline__ float keep(bool on, float v) {
  return __int_as_float(on ? __float_as_int(v) : 0);
}

// N consecutive values in shared memory, moved as one aligned vector
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T x[N];
};
template <int N, typename T>
__device__ __forceinline__ Vec<T, N> load(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}
template <int N, typename T>
__device__ __forceinline__ void store(T* p, const Vec<T, N>& v) {
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

// the adds round to nearest, never fused
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    tree_histogram_kernel(const T* __restrict__ values,
                          const int* __restrict__ node,
                          const int* __restrict__ perm,
                          const int* __restrict__ bnd, T* __restrict__ out,
                          int batch, int n, int n_features, int n_bins,
                          int n_nodes, int groups, int cells) {
  using L = Layout<T, C>;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // a 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool producer = warp < kProducers;
  const int part = warp * kPart;  // a producer's samples of each chunk
  long long w = blockIdx.x;
  const int group = static_cast<int>(w % groups);
  w /= groups;
  const int bin = static_cast<int>(w % n_bins);
  w /= n_bins;
  const int f = static_cast<int>(w % n_features);
  const int b = static_cast<int>(w / n_features);
  const int cell0 = group * 32;
  // cells of this group: [cell0, cell0 + g_cells)
  const int g_cells = min(32, n_nodes * C - cell0);

  const long long bf = static_cast<long long>(b) * n_features + f;
  const int* seg_bnd = bnd + bf * (n_bins + 1);
  // the segment as absolute positions in `perm`
  const long long e0 = bf * n + seg_bnd[bin];
  const long long e1 = bf * n + seg_bnd[bin + 1];
  const long long total = static_cast<long long>(batch) * n_features * n;
  const T* vals = values + static_cast<long long>(b) * C * n;
  const int* nodes = node + static_cast<long long>(b) * n;

  auto s_perm = [&](int slot) {
    return reinterpret_cast<int*>(smem + slot * L::slot);
  };
  auto s_node = [&](int slot) { return s_perm(slot) + kChunk; };
  auto s_val = [&](int slot) {
    return reinterpret_cast<T*>(s_perm(slot) + 2 * kChunk);
  };
  auto s_rows = [&](int t) {  // the walker's rows of chunk t
    return reinterpret_cast<T*>(smem + L::staging) + (t & 1) * cells * L::row;
  };

  const int out_c = (cell0 + lane) % C;
  const long long o =
      ((((static_cast<long long>(b) * C + out_c) * n_nodes +
         (cell0 + lane) / C) * n_features + f) * n_bins) + bin;
  if (e1 <= e0) {  // an empty segment: its cells are 0
    if (!producer && lane < g_cells) out[o] = T(0);
    return;
  }
  const long long w0 = e0 & ~3LL;  // 16-byte aligned window start
  const int n_chunks = static_cast<int>((e1 - w0 + kChunk - 1) / kChunk);

  // producer: its part of the order slice of chunk t, 4 entries a lane,
  // zero-filled past `perm`
  auto fetch_order = [&](int t) {
    if (t < n_chunks && lane < kPart / 4) {
      const long long a =
          w0 + static_cast<long long>(t) * kChunk + part + 4 * lane;
      const long long left = total - a;
      const int bytes =
          left >= 4 ? 16 : (left > 0 ? 4 * static_cast<int>(left) : 0);
      cp_async16(s_perm(t % kSlots) + part + 4 * lane,
                 bytes > 0 ? perm + a : perm, bytes);
    }
    cp_commit();
  };
  // producer: node ids and values of its part of chunk t, through its
  // landed order slice
  auto fetch_chunk = [&](int t) {
    if (t >= 0 && t < n_chunks) {
      const int slot = t % kSlots;
      const int* sp = s_perm(slot);
      int* sn = s_node(slot);
      T* sv = s_val(slot);
      const long long c0 = w0 + static_cast<long long>(t) * kChunk;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int p = part + lane + 32 * u;
        const long long a = c0 + p;
        if (a >= e0 && a < e1) {
          const int i = sp[p];
          cp_async<4>(sn + p, nodes + i);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            cp_async<static_cast<int>(sizeof(T))>(
                sv + c * L::row + p, vals + static_cast<long long>(c) * n + i);
          }
        } else {
          sn[p] = -1;  // outside the segment: matches no cell
        }
      }
    }
    cp_commit();
  };
  // producer: the walker's rows of its part of the landed chunk t, kPer
  // consecutive samples a lane
  auto build_rows = [&](int t) {
    if (t < 0 || t >= n_chunks) return;
    const int slot = t % kSlots;
    const int p = part + kPer * lane;
    const Vec<int, kPer> nd = load<kPer>(s_node(slot) + p);
    Vec<T, kPer> v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = load<kPer>(s_val(slot) + c * L::row + p);
    T* rows = s_rows(t) + p;
    const int j0 = cell0 / C;
    const int j1 = (cell0 + g_cells - 1) / C;
    for (int j = j0; j <= j1; ++j) {
      bool on[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) on[q] = nd.x[q] == j;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = j * C + c - cell0;
        if (k >= 0 && k < g_cells) {
          Vec<T, kPer> r;
#pragma unroll
          for (int q = 0; q < kPer; ++q) r.x[q] = keep(on[q], v[c].x[q]);
          store(rows + k * L::row, r);
        }
      }
    }
  };

  // Step t: each producer fetches its part of the order slice of chunk
  // t + kSlots - 1 and gathers its part of chunk t + kSlots - 2, then
  // builds its part of the rows of chunk t + 1;
  // the walker adds the rows of chunk t (steps before 0 only fill).  Each
  // step commits two cp.async groups (empty ones outside the segment), so
  // the order slice fetched the step before has landed once at most 2
  // groups are pending, and chunk t + 1 once at most 2 * (kLead - 1) are.
  const int my = lane < g_cells ? lane : 0;
  T acc = T(0);
  for (int t = 1 - kSlots; t < n_chunks; ++t) {
    if (producer) {
      fetch_order(t + kSlots - 1);
      cp_wait<2>();
      __syncwarp();
      fetch_chunk(t + kLead);
      cp_wait<2 * (kLead - 1)>();
      __syncwarp();
      build_rows(t + 1);
    } else if (t >= 0) {
      const T* row = s_rows(t) + my * L::row;
#pragma unroll
      for (int p = 0; p < kChunk; p += kVec) {
        const Vec<T, kVec> v = load<kVec>(row + p);
#pragma unroll
        for (int q = 0; q < kVec; ++q) acc = add_rn(acc, v.x[q]);
      }
    }
    __syncthreads();
  }
  if (!producer && lane < g_cells) out[o] = acc;
}

template <typename T, int C>
int launch(const T* values, const int* node, const int* perm, const int* bnd,
           T* out, int batch, int n, int n_features, int n_bins, int n_nodes,
           cudaStream_t stream) {
  using L = Layout<T, C>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_histogram_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(32));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int groups = (n_nodes * C + 31) / 32;
  const int cells = n_nodes * C < 32 ? n_nodes * C : 32;
  const long long blocks =
      static_cast<long long>(batch) * n_features * n_bins * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tree_histogram_kernel<T, C><<<static_cast<unsigned>(blocks), kThreads,
                                L::bytes(cells), stream>>>(
      values, node, perm, bnd, out, batch, n, n_features, n_bins, n_nodes,
      groups, cells);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* values, const int* node, const int* perm,
             const int* bnd, T* out, int batch, int channels, int n,
             int n_features, int n_bins, int n_nodes, cudaStream_t stream) {
  if (batch <= 0 || n < 0 || n_features <= 0 || n_bins <= 0 ||
      n_nodes <= 0 || (reinterpret_cast<uintptr_t>(perm) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (channels) {
    case 1: return launch<T, 1>(values, node, perm, bnd, out, batch, n,
                                n_features, n_bins, n_nodes, stream);
    case 2: return launch<T, 2>(values, node, perm, bnd, out, batch, n,
                                n_features, n_bins, n_nodes, stream);
    case 3: return launch<T, 3>(values, node, perm, bnd, out, batch, n,
                                n_features, n_bins, n_nodes, stream);
    case kMaxChannels:
      return launch<T, kMaxChannels>(values, node, perm, bnd, out, batch, n,
                                     n_features, n_bins, n_nodes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The order bound's probe: one thread adds n values, v[i % 8], into one
// float64 sum in that order -- the bare chain of n dependent adds that a
// cell of n samples costs at the least (every operand is in a register).
__global__ void add_chain_kernel(const double* __restrict__ v, long long n,
                                 double* __restrict__ out) {
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = v[j];
  double acc = 0.0;
  long long i = 0;
  for (; i + 8 <= n; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __dadd_rn(acc, r[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // the last n % 8 adds
    if (i + j < n) acc = __dadd_rn(acc, r[j]);
  }
  *out = acc;
}

}  // namespace

extern "C" int add_chain_f64(const double* v, long long n, double* out,
                             cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  add_chain_kernel<<<1, 1, 0, stream>>>(v, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tree_histogram_f64(const double* values, const int* node,
                                  const int* perm, const int* bnd,
                                  double* out, int batch, int channels, int n,
                                  int n_features, int n_bins, int n_nodes,
                                  cudaStream_t stream) {
  return dispatch<double>(values, node, perm, bnd, out, batch, channels, n,
                          n_features, n_bins, n_nodes, stream);
}

extern "C" int tree_histogram_f32(const float* values, const int* node,
                                  const int* perm, const int* bnd,
                                  float* out, int batch, int channels, int n,
                                  int n_features, int n_bins, int n_nodes,
                                  cudaStream_t stream) {
  return dispatch<float>(values, node, perm, bnd, out, batch, channels, n,
                         n_features, n_bins, n_nodes, stream);
}
