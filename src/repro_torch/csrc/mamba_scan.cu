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
// Design: one thread per (batch, channel) holds the channel's N states
// and its row of A in registers and runs time in order.  A block of 128
// channels of one batch row shares B_t and C_t: the block stages them
// for 16 steps at a time in shared memory, and each thread loads its u
// and delta for those 16 steps before folding them in (coalesced across
// channels, 32 loads in flight per thread).
//
// Bound on the H100: bytes.  The function reads u and delta once (2 x
// 2 B at bf16 per (batch, step, channel)), B and C, and writes y (4 B);
// its work is about 6 flops and one exp per (batch, step, channel,
// state).  At falcon-mamba-7b's width there are 4 x 8,192 threads, few
// for the card; a chunked scan with a second pass would add parallelism.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                          const float* __restrict__ A,
                          const T* __restrict__ B, const T* __restrict__ C,
                          const float* __restrict__ D, float* __restrict__ y,
                          float* __restrict__ h_last, int s, int dm) {
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.y) * s;
  const bool live = c < dm;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[static_cast<long long>(c) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    __syncthreads();  // the previous chunk's B and C are consumed
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const long long o = (row + t0 + t) * N + n;
      bs[t][n] = t < len ? to_float(B[o]) : 0.f;
      cs[t][n] = t < len ? to_float(C[o]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    float us[kChunk], ds[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const long long o = (row + t0 + t) * dm + c;
      us[t] = t < len ? to_float(u[o]) : 0.f;
      ds[t] = t < len ? to_float(delta[o]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < len) {
        const float du = ds[t] * us[t];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(ds[t] * a[n]) * h[n] + du * bs[t][n];
          acc += h[n] * cs[t][n];
        }
        y[(row + t0 + t) * dm + c] = acc + dd * us[t];
      }
    }
  }
  if (live) {
    float* out = h_last + (static_cast<long long>(blockIdx.y) * dm + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* u, const void* delta, const float* A, const void* B,
           const void* C, const float* D, float* y, float* h_last, int batch,
           int s, int dm, cudaStream_t stream) {
  const dim3 grid((dm + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D, y, h_last, s,
      dm);
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
