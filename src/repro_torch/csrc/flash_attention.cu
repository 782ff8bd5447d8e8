// Attention forward with an online softmax: GQA, end-aligned causal mask,
// sliding window, Gemma-2 softcap; float32 or bf16 in, float32 inside,
// the output in the input's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, wrapper flash_attention):
//   o[b, h, i] = softmax_j(mask(cap(q[b, h, i] . k[b, g(h), j] * scale)))
//                . v[b, g(h), :],   g(h) = h / (Hq / Hkv),
// with query i at position i + Skv - Sq, key j valid iff j < Skv, and
// (causal) j <= that position, (window > 0) j > that position - window.
// A row with no valid key outputs 0 (its normalizer is 0).
//
// Design (a first, simple version: float32 on CUDA cores, no tensor
// cores, no TMA).  One block of 128 threads per (batch, q-head, tile of
// 32 queries); q-head h reads kv-head g(h) through the strides, with no
// repeat in memory.  The block walks 32-key tiles of k/v, staged in shared
// memory as float32 (rows padded to D + 1 words against bank conflicts),
// and only the tiles inside the causal/window band of its queries -- the
// Pallas kernel's `needed` guard, as a loop range.  Each warp owns 8
// query rows; a group of 8 lanes owns 2 rows, its lanes 4 key columns of
// a tile and D / 8 output columns of each row.  Row max and sum of a tile
// are shuffles within the 8 lanes; the probabilities go through shared
// memory to the P.V product.  Statistics and the accumulator stay in
// registers until the last tile, then each row is divided by its sum.
// Warps whose rows all lie past Sq (decode has Sq = 1) skip the math.
// No atomics: two launches give the same bits.
//
// Every operand is read through (batch, head, sequence) strides with the
// last axis contiguous, so the decode path passes the live slice of a
// (B, Hkv, Smax, D) cache as a view, and the output can be laid out
// (B, Sq, Hq, D) in memory, what the output projection reads.
//
// Bound on the H100: at prefill the product work, 4 * D flops per (query,
// key) pair inside the band, against the bf16 tensor-core peak (this
// version runs at the float32 CUDA-core rate, far below it); at decode
// (Sq = 1) the bytes of the live cache slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;       // queries per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128; // 4 warps x 8 rows

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, group, sq, skv, causal, window;
  float softcap, scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

template <int D>
constexpr int smem_bytes() {
  return (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int NO = D / 8;  // output columns per lane and row
  extern __shared__ float smem[];
  float* qs = smem;              // kBQ x LD
  float* ks = qs + kBQ * LD;     // kBK x LD
  float* vs = ks + kBK * LD;     // kBK x LD
  float* ps = vs + kBK * LD;     // kBQ x LP

  const int tid = threadIdx.x;
  const int sub = tid & 7;        // lane within the row group
  const int r0 = (tid >> 3) * 2;  // the group's two rows
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.hq;
  const int h = blockIdx.y % a.hq;
  const int hk = h / a.group;
  const int off = a.skv - a.sq;  // end alignment

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = q0 + r;
    qs[r * LD + d] = i < a.sq ? to_float(qg[i * a.q_ss + d]) : 0.f;
  }

  // the keys any of this block's queries may see
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + kBQ, a.sq) - 1 + off;
  int k_begin = 0, k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1);

  const bool active = q0 + (tid >> 5) * 8 < a.sq;  // uniform per warp
  float o[2][NO];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int j = 0; j < NO; ++j) o[rr][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int j = kt + r;
      const bool ok = j < a.skv;
      ks[r * LD + d] = ok ? to_float(kg[j * a.k_ss + d]) : 0.f;
      vs[r * LD + d] = ok ? to_float(vg[j * a.v_ss + d]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[rr][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qa = qs[r0 * LD + d];
      const float qb = qs[(r0 + 1) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = ks[(sub + 8 * c) * LD + d];
        s[0][c] += qa * kv;
        s[1][c] += qb * kv;
      }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = q0 + r0 + rr + off;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = kt + sub + 8 * c;
        float x = s[rr][c] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool ok = kpos < a.skv && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        s[rr][c] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[rr][c]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[rr], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[rr] - m_new);  // 0 while m[rr] is -inf
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[rr][c] = expf(s[rr][c] - m_new);  // masked -> 0
          sum += s[rr][c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[rr][c] = 0.f;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[rr] = alpha * l[rr] + sum;
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) o[rr][j] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[(r0 + rr) * LP + sub + 8 * c] = s[rr][c];
    }
    __syncwarp();  // a warp reads only its own rows of ps
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float pa = ps[r0 * LP + c];
      const float pb = ps[(r0 + 1) * LP + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float vv = vs[c * LD + sub + 8 * j];
        o[0][j] += pa * vv;
        o[1][j] += pb * vv;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + r0 + rr;
    if (i >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float y = l[rr] > 0.f ? o[rr][j] / l[rr] : 0.f;
      og[i * a.o_ss + sub + 8 * j] = from_float<T>(y);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, batch * a.hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    case 256: return launch<T, 256>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  strides: the
// (batch, head, sequence) strides, in elements, of q, k, v and o, in that
// order (12 values); the last axis of each is contiguous.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int batch, int hq,
                                   int hkv, int sq, int skv, int d,
                                   const long long* strides, int causal,
                                   int window, float softcap, float scale,
                                   cudaStream_t stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || batch * static_cast<long long>(hq) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.hq = hq;
  a.group = hq / hkv;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.q_ss = strides[2];
  a.k_sb = strides[3];
  a.k_sh = strides[4];
  a.k_ss = strides[5];
  a.v_sb = strides[6];
  a.v_sh = strides[7];
  a.v_ss = strides[8];
  a.o_sb = strides[9];
  a.o_sh = strides[10];
  a.o_ss = strides[11];
  if (dtype == 0) return dispatch<float>(a, batch, d, stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, batch, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
