// The Mamba-1 selective scan over a whole prompt, with its final state:
//   h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t   (per d, n)
//   y_t = h_t . C_t + D * u_t
// u, delta (Bt, S, Dm) and B, C (Bt, S, N) in float32 or bf16, read as
// float32; A (Dm, N) and D (Dm,) float32; y (Bt, S, Dm) and the final
// state (Bt, Dm, N) float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan/kernel.py
// (_mamba_kernel, wrapper selective_scan), which tiles channels into VMEM
// blocks and runs time in order inside the block; the reference's model
// chunks the prompt into 512 steps for TPU memory and runs a second scan
// for the final state.  Here one launch scans the whole prompt and writes
// the final state too.
//
// Bound on the H100: the exponentials.  The function needs one
// exp(delta * A) per (batch, step, channel, state) -- 1.61e9 of them at
// falcon-mamba-7b's layer (4 x 3,072 x 8,192 x 16) -- and the SFU
// computes 16 a clock an SM: ~0.39 ms at 1.98 GHz, above the ~0.24 ms
// of its bytes (u and delta read once, y written once).
//
// Design (one launch, no atomics):
// - Lanes: a group of four lanes scans four channels; each lane holds
//   N / 4 states of each of the four channels (and their A, scaled by
//   log2(e)) in registers.  A block of 128 threads takes 128 channels of
//   one batch row, so each B_t / C_t value a lane loads serves four
//   channels, and the channel's y is a fixed butterfly over the group
//   (three __shfl_xor_sync a step for the four channels; the same
//   order every launch, so two launches are bit-equal).
// - One ex2.approx per exponential: each (step, state) costs one FMUL
//   and one MUFU op.
// - Time runs in chunks of 32 steps.  The block stages a chunk's u and
//   delta (its 128 channels), B and C in shared memory with cp.async,
//   double-buffered: chunk k + 1 is in flight while chunk k is folded.
//   u and delta go in 16-byte copies when Dm and the tensors allow it
//   (else 4-byte, else plain loads: bf16 with an odd Dm); channels past
//   Dm and steps past S are zero-filled and never written.
// - Fewer channels a lane (one or two), eight lanes a group and fewer
//   unrolled steps were slower in trial builds: four channels a lane
//   load B and C a quarter as often per channel, and fold four steps'
//   chains side by side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;                  // lanes sharing a channel's states
constexpr int kR = 4;                      // channels a lane
constexpr int kGroups = 32;                // lane groups a block
constexpr int kThreads = kLanes * kGroups;
constexpr int kChannels = kGroups * kR;    // channels a block
constexpr int kChunk = 32;                 // steps a staged chunk
constexpr int kUnroll = 4;                 // steps interleaved
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One chunk of a block's inputs, as they lie in device memory.
template <typename T, int N>
struct __align__(16) Stage {
  T u[kChunk][kChannels];
  T d[kChunk][kChannels];
  T b[kChunk][N];
  T c[kChunk][N];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// How a chunk is copied into shared memory (the host picks the widest
// granule that every copy's source and destination allow).
enum Copy : int { kPlain = 0, kAsync4 = 1, kAsync16 = 2 };

// dst[r][k] = src[r * stride + k] for r < kChunk, k < kCols; zero where
// r >= rows or k >= valid.  Granules never cross a row: kCols * sizeof(T)
// is a multiple of the granule, and the host checks that every row
// starts on one.
template <typename T, int kCols>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int rows,
                                           int valid, int mode) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int g16 = 16 / kSize;
  if constexpr (kCols % g16 == 0) {
    if (mode == kAsync16) {
      constexpr int per_row = kCols / g16;
      for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
        const int r = i / per_row, k = (i % per_row) * g16;
        const int n = r < rows ? min(g16, max(valid - k, 0)) : 0;
        cp_async16(dst + r * kCols + k, n ? src + r * stride + k : src,
                   n * kSize);
      }
      return;
    }
  }
  if (mode == kAsync4) {
    constexpr int g = 4 / kSize;
    constexpr int per_row = kCols / g;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int r = i / per_row, k = (i % per_row) * g;
      const bool ok = r < rows && k < valid;
      cp_async4(dst + r * kCols + k, ok ? src + r * stride + k : src,
                ok ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int r = i / kCols, k = i % kCols;
      dst[r * kCols + k] = (r < rows && k < valid) ? src[r * stride + k]
                                                   : T{};
    }
  }
}

// K consecutive staged values from p (aligned to K elements), as float.
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[K]) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}
template <int K>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[K]) {
  if constexpr (K == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
  } else if constexpr (K == 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

// v[q] without a dynamic register index.
__device__ __forceinline__ float pick(const float (&v)[kR], int q) {
  float x = v[0];
#pragma unroll
  for (int r = 1; r < kR; ++r) x = q == r ? v[r] : x;
  return x;
}

// The four lanes of a group each hold partial dot products of the
// group's four channels; afterwards lane q holds the full sum of channel
// q.  A fixed butterfly: at each xor step a lane keeps half of its
// values and sends the other half (3 shuffles, not 8).
__device__ __forceinline__ float group_sum(const float (&v)[kR], int q) {
  static_assert(kLanes == 4 && kR == 4, "a butterfly over four lanes");
  const bool hi1 = q & 1;
  float k0 = hi1 ? v[1] : v[0], s0 = hi1 ? v[0] : v[1];
  float k1 = hi1 ? v[3] : v[2], s1 = hi1 ? v[2] : v[3];
  k0 += __shfl_xor_sync(0xffffffffu, s0, 1);  // channel (q & 1)
  k1 += __shfl_xor_sync(0xffffffffu, s1, 1);  // channel 2 + (q & 1)
  const bool hi2 = q & 2;
  const float k = hi2 ? k1 : k0, s = hi2 ? k0 : k1;
  return k + __shfl_xor_sync(0xffffffffu, s, 2);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                          const float* __restrict__ A,
                          const T* __restrict__ B, const T* __restrict__ C,
                          const float* __restrict__ D, float* __restrict__ y,
                          float* __restrict__ h_last, int s, int dm,
                          int ud_mode, int bc_mode) {
  constexpr int kS = N / kLanes;  // states a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<T, N>* st = reinterpret_cast<Stage<T, N>*>(smem_raw);
  const int q = threadIdx.x & (kLanes - 1);
  const int g = threadIdx.x / kLanes;
  const int c0 = blockIdx.x * kChannels;
  const int cg = c0 + g * kR;          // the group's first channel
  const int cy = cg + q;               // the channel whose y this lane writes
  const long long row = static_cast<long long>(blockIdx.y) * s;
  float a2[kR][kS], h[kR][kS], dd[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool live = cg + r < dm;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      a2[r][i] = live ? A[static_cast<long long>(cg + r) * N + q * kS + i] *
                            kLog2e
                      : 0.f;
      h[r][i] = 0.f;
    }
    dd[r] = live ? D[cg + r] : 0.f;
  }
  const float dy = pick(dd, q);

  const int n_chunks = (s + kChunk - 1) / kChunk;
  auto stage = [&](int k) {  // chunk k into st[k & 1]
    Stage<T, N>& dst = st[k & 1];
    const int t0 = k * kChunk;
    const int rows = min(kChunk, s - t0);
    const long long o = (row + t0) * dm + c0;
    stage_rows<T, kChannels>(&dst.u[0][0], u + o, dm, rows, dm - c0,
                             ud_mode);
    stage_rows<T, kChannels>(&dst.d[0][0], delta + o, dm, rows, dm - c0,
                             ud_mode);
    stage_rows<T, N>(&dst.b[0][0], B + (row + t0) * N, N, rows, N, bc_mode);
    stage_rows<T, N>(&dst.c[0][0], C + (row + t0) * N, N, rows, N, bc_mode);
    cp_async_commit();
  };

  stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk k has landed for every thread
    const Stage<T, N>& cur = st[k & 1];
    const int t0 = k * kChunk;
    const int len = min(kChunk, s - t0);
    float* yrow = y + (row + t0) * dm + cy;
    const bool write = cy < dm;
#pragma unroll(kUnroll)
    for (int t = 0; t < len; ++t) {
      float ut[kR], dt[kR], bt[kS], ct[kS], acc[kR];
      load_vec(&cur.u[t][g * kR], ut);
      load_vec(&cur.d[t][g * kR], dt);
      load_vec(&cur.b[t][q * kS], bt);
      load_vec(&cur.c[t][q * kS], ct);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float du = dt[r] * ut[r];
        acc[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          h[r][i] = fmaf(ex2(dt[r] * a2[r][i]), h[r][i], du * bt[i]);
          acc[r] = fmaf(h[r][i], ct[i], acc[r]);
        }
      }
      const float yt = group_sum(acc, q);
      if (write) {
        yrow[static_cast<long long>(t) * dm] = fmaf(dy, pick(ut, q), yt);
      }
    }
    __syncthreads();  // st[k & 1] is free for chunk k + 2
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (cg + r < dm) {
      float* out = h_last +
                   (static_cast<long long>(blockIdx.y) * dm + cg + r) * N +
                   q * kS;
#pragma unroll
      for (int i = 0; i < kS; ++i) out[i] = h[r][i];
    }
  }
}

template <typename T, int N>
int launch(const void* u, const void* delta, const float* A, const void* B,
           const void* C, const float* D, float* y, float* h_last, int batch,
           int s, int dm, cudaStream_t stream) {
  const T* ut = static_cast<const T*>(u);
  const T* dt = static_cast<const T*>(delta);
  const T* bt = static_cast<const T*>(B);
  const T* ct = static_cast<const T*>(C);
  // u and delta rows start on 16 bytes when Dm does and the tensors do
  // (a block's first channel is a multiple of kChannels); 4-byte copies
  // need an even Dm in bf16.  B and C rows hold an even N.
  auto on = [](const void* p, int a) {
    return reinterpret_cast<unsigned long long>(p) % a == 0;
  };
  const int row_bytes = dm * static_cast<int>(sizeof(T));
  const int ud_mode =
      row_bytes % 16 == 0 && on(ut, 16) && on(dt, 16) ? kAsync16
      : row_bytes % 4 == 0 && on(ut, 4) && on(dt, 4) ? kAsync4
                                                      : kPlain;
  const int bc_mode = on(bt, 4) && on(ct, 4) ? kAsync4 : kPlain;
  const int smem = 2 * static_cast<int>(sizeof(Stage<T, N>));
  auto kernel = selective_scan_kernel<T, N>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((dm + kChannels - 1) / kChannels, batch);
  kernel<<<grid, kThreads, smem, stream>>>(ut, dt, A, bt, ct, D, y, h_last,
                                           s, dm, ud_mode, bc_mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int n, const void* u, const void* delta, const float* A,
             const void* B, const void* C, const float* D, float* y,
             float* h_last, int batch, int s, int dm, cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<T, 4>(u, delta, A, B, C, D, y, h_last, batch, s, dm,
                          stream);
    case 8:
      return launch<T, 8>(u, delta, A, B, C, D, y, h_last, batch, s, dm,
                          stream);
    case 16:
      return launch<T, 16>(u, delta, A, B, C, D, y, h_last, batch, s, dm,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B and C alike).
extern "C" int selective_scan_fwd(int dtype, const void* u, const void* delta,
                                  const float* A, const void* B,
                                  const void* C, const float* D, float* y,
                                  float* h_last, int batch, int s, int dm,
                                  int n, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 || dm <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return dispatch<float>(n, u, delta, A, B, C, D, y, h_last, batch, s, dm,
                           stream);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(n, u, delta, A, B, C, D, y, h_last, batch,
                                   s, dm, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
