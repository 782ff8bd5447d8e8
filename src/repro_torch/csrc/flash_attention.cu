// Attention forward with an online softmax: GQA, end-aligned causal mask,
// sliding window, Gemma-2 softcap; float32 or bf16 in, float32 statistics
// and sums, the output in the input's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, wrapper flash_attention):
//   o[b, h, i] = softmax_j(mask(cap(q[b, h, i] . k[b, g(h), j] * scale)))
//                . v[b, g(h), :],   g(h) = h / (Hq / Hkv),
// with query i at position i + Skv - Sq, key j valid iff j < Skv, and
// (causal) j <= that position, (window > 0) j > that position - window.
// A row with no valid key outputs 0 (its normalizer is 0).
//
// Every operand is read through (batch, head, sequence) strides with the
// last axis contiguous, so decode passes the live slice of a (B, Hkv,
// Smax, D) cache as a view, and the output can be laid out (B, Sq, Hq, D)
// in memory, what the output projection reads.  No form uses atomics: two
// launches give the same bits.  The wrapper picks one of three forms:
//
// 1. Decode (Sq = 1) in bf16, split-KV with GQA packing.  Bound on the
//    H100: the
//    bytes of the live cache slice (2 MB per (batch, kv-head) at 2,048
//    keys and D = 256), which one block per (batch, q-head) would
//    not pull: 32-64 blocks for 132 SMs, each walking the slice alone and
//    reading it again for every q-head of its group.  Here a block takes
//    one (batch, kv-head, group of up to 16 q-heads, split of <= 64 keys):
//    it copies the split's keys and values into shared memory once, with
//    16-byte cp.async copies, for all the q-heads of the group, which are
//    the 16 rows of an mma.sync tile (S = Q K^T and O = P V on tensor
//    cores, the softmax in float32).  Each block writes float32 partials (m, l, unnormalized o) for its
//    split; flash_combine_kernel folds the splits in a fixed order.  The
//    wrapper chooses the split count from the live keys and the SM count
//    so that the card holds two blocks per SM.
// 2. Prefill in bf16 (Sq > 1), on tensor cores.  Bound: the 4 * D flops
//    of each (query, key) pair inside the band, at the bf16 tensor-core
//    rate.  A block holds 64 query rows (4 warps x 16); K/V tiles of 64
//    keys (32 at D = 256, for registers) come through a two-stage cp.async
//    ring into shared memory, rows padded by 16 bytes so that ldmatrix is
//    free of bank conflicts.  S = Q K^T and O += P V are mma.sync.m16n8k16
//    bf16 products with float32 accumulators, fed by ldmatrix (V through
//    its .trans form); softmax statistics, the softcap and the masks stay
//    in float32 registers, masks only on the band's edge tiles, and only
//    band tiles are visited.  P is rounded to bf16 for the P.V product, as
//    the TPU kernel's MXU does.  Query tiles are launched heaviest first.
// 3. Float32, any Sq (tests, the smoke configs in float32): float32 on
//    CUDA cores, one block of 128 threads per (batch, q-head, 32 queries);
//    32-key tiles staged in shared memory (rows padded to D + 1 words);
//    each group of 8 lanes owns 2 query rows.  Tensor cores would mean
//    TF32, which cannot hold the float32 bar of 2e-5.  On request it also
//    writes each row's log-sum-exp m + log(l) of its scaled, soft-capped
//    logits (-inf for a row with no key), what a sequence-sharded decode
//    merges its ranks' partial softmaxes by; the output is the same bits
//    either way.
//
// Head dims: 8 (float32 form only), 16, 32, 64, 128, 160 and 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq) or null; the float32 form only
  int hq, group, sq, skv, causal, window;
  float softcap, scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes < 16 zero-fills the rest (0: no read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------- //
// 3. float32: CUDA cores
// ---------------------------------------------------------------------- //
constexpr int kBQ = 32;        // queries per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 8 rows

template <int D>
constexpr int f32_smem_bytes() {
  return (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int NO = D / 8;  // output columns per lane and row
  extern __shared__ float smem_f[];
  float* qs = smem_f;            // kBQ x LD
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

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = q0 + r;
    qs[r * LD + d] = i < a.sq ? qg[i * a.q_ss + d] : 0.f;
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
      ks[r * LD + d] = ok ? kg[j * a.k_ss + d] : 0.f;
      vs[r * LD + d] = ok ? vg[j * a.v_ss + d] : 0.f;
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
      og[i * a.o_ss + sub + 8 * j] = l[rr] > 0.f ? o[rr][j] / l[rr] : 0.f;
    }
    if (a.lse != nullptr && sub == 0)  // the row group shares m and l
      a.lse[(static_cast<long long>(b) * a.hq + h) * a.sq + i] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------- //
// 2. bf16, Sq > 1: tensor cores (mma.sync.m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------- //
constexpr int kMmaRows = 64;     // query rows per block (4 warps x 16)
constexpr int kMmaThreads = 128;

template <int D>
struct MmaTile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 8;               // padded row, elements
  static constexpr int smem_bytes =
      (kMmaRows + 4 * BK) * LD * static_cast<int>(sizeof(bf16));
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// tanh(y) = 1 - 2 / (1 + e^{2y}): one exp and one reciprocal, absolute
// error ~1e-7 (saturates to +-1 for large |y|)
__device__ __forceinline__ float tanh_fast(float y) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * y));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_prefill_mma_kernel(Args a) {
  constexpr int BK = MmaTile<D>::BK;
  constexpr int LD = MmaTile<D>::LD;
  constexpr int NS = BK / 8;   // S n-tiles (8 keys each)
  constexpr int NO = D / 8;    // O n-tiles (8 columns each)
  constexpr int CH = D / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* qs = reinterpret_cast<bf16*>(smem_b);  // kMmaRows x LD
  bf16* ks = qs + kMmaRows * LD;               // 2 stages x BK x LD
  bf16* vs = ks + 2 * BK * LD;                 // 2 stages x BK x LD

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // the lane's rows: g and g + 8 of its warp's 16
  const int t4 = lane & 3;   // the lane's column pair in each 8-wide n-tile
  const int n_qt = (a.sq + kMmaRows - 1) / kMmaRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kMmaRows;
  const int b = blockIdx.y / a.hq;
  const int h = blockIdx.y % a.hq;
  const int hk = h / a.group;
  const int off = a.skv - a.sq;

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int q_lo = q0 + off;
  const int q_hi = min(q0 + kMmaRows, a.sq) - 1 + off;
  int k_begin = 0, k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  for (int idx = tid; idx < kMmaRows * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx % CH;
    const int i = q0 + r;
    cp_async16(qs + r * LD + c * 8, i < a.sq ? qg + i * a.q_ss + c * 8 : qg,
               i < a.sq ? 16 : 0);
  }
  auto load_tile = [&](int it) {
    const int kt = k_begin + it * BK;
    bf16* kd = ks + (it & 1) * BK * LD;
    bf16* vd = vs + (it & 1) * BK * LD;
    for (int idx = tid; idx < BK * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = idx % CH;
      const int j = kt + r;
      const bool ok = j < a.skv;  // rows past the keys are zero-filled
      cp_async16(kd + r * LD + c * 8, ok ? kg + j * a.k_ss + c * 8 : kg,
                 ok ? 16 : 0);
      cp_async16(vd + r * LD + c * 8, ok ? vg + j * a.v_ss + c * 8 : vg,
                 ok ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_commit();

  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum
  const int row0 = warp * 16;  // the warp's first row in the block

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * BK;
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_commit();
    cp_wait<1>();  // tile it (and q) have landed
    __syncthreads();
    const bf16* kst = ks + (it & 1) * BK * LD;
    const bf16* vst = vs + (it & 1) * BK * LD;

    // S = Q K^T: 16 rows x BK keys per warp
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qs + (row0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, softcap, and the masks on the band's edge tiles
    const bool edge = !(kt + BK <= a.skv &&
                        (!a.causal || kt + BK - 1 <= q_lo) &&
                        (a.window <= 0 || kt > q_hi - a.window));
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanh_fast(x / a.softcap);
        if (edge) {
          const int j = kt + nt * 8 + t4 * 2 + (e & 1);
          const int qpos = q0 + row0 + g + (e >> 1) * 8 + off;
          const bool ok = j < a.skv && (!a.causal || j <= qpos) &&
                          (a.window <= 0 || j > qpos - a.window);
          if (!ok) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    // online softmax; a row's 4 lanes hold its columns
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = __expf(m[rr] - m_new);  // 0 while m[rr] is -inf
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            s[nt][e] = __expf(s[nt][e] - m_new);  // masked -> 0
            sum += s[nt][e];
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) s[nt][2 * rr] = s[nt][2 * rr + 1] = 0.f;
      }
      l[rr] = alpha * l[rr] + sum;
      m[rr] = m_new;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        o[nt][2 * rr] *= alpha;
        o[nt][2 * rr + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 (the accumulator layout of two S n-tiles
    // is the A-operand layout of one 16-key step)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vst + (kk * 16 + (lane & 7)
                                     + ((lane >> 3) & 1) * 8) * LD
                                  + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int i = q0 + row0 + g + rr * 8;
    if (i >= a.sq) continue;
    bf16* orow = og + i * a.o_ss + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
          __floats2bfloat162_rn(o[nt][2 * rr] * inv, o[nt][2 * rr + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------- //
// 1. decode (Sq = 1): split-KV partials, then an ordered combine
// ---------------------------------------------------------------------- //
constexpr int kDecHeads = 16;  // q-heads of one GQA group per block, most
constexpr int kDecKeys = 64;   // keys per split, at most
constexpr int kDecThreads = 128;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  float* part_o;   // (B * Hq, splits, D)
  float* part_ml;  // (B * Hq, splits, 2): running max, sum
  int hq, hkv, group, hchunks, skv, k_begin, split_len, n_splits;
  float softcap, scale;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

// The bf16 decode on tensor cores: a block's up to 16 q-heads are the 16
// rows of one mma tile, its split's keys the columns.  S = Q K^T, then the
// softmax of each row in float32 (P rounded to bf16, as in the prefill),
// then O = P V, each warp a quarter of the keys in S and of the columns
// in O.
template <int D>
struct DecMma {
  static constexpr int LD = D + 8;          // Q, K, V rows (bf16), padded
  static constexpr int LP = kDecKeys + 8;   // P rows (bf16), padded
  static constexpr int smem_bytes =
      (kDecHeads + 2 * kDecKeys) * LD * static_cast<int>(sizeof(bf16))
      + kDecHeads * kDecKeys * static_cast<int>(sizeof(float))
      + kDecHeads * LP * static_cast<int>(sizeof(bf16));
};

template <int D>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_mma_kernel(DecodeArgs a) {
  constexpr int LD = DecMma<D>::LD;
  constexpr int LP = DecMma<D>::LP;
  constexpr int CH = D / 8;                  // 16-byte chunks per row
  constexpr int NPAIR = D / 16;              // pairs of 8-column O tiles
  constexpr int PPW = (NPAIR + 3) / 4;       // pairs per warp
  extern __shared__ __align__(16) unsigned char smem_m[];
  bf16* qs = reinterpret_cast<bf16*>(smem_m);    // kDecHeads x LD
  bf16* ks = qs + kDecHeads * LD;                // kDecKeys x LD
  bf16* vs = ks + kDecKeys * LD;                 // kDecKeys x LD
  float* ss = reinterpret_cast<float*>(vs + kDecKeys * LD);  // 16 x keys
  bf16* ps = reinterpret_cast<bf16*>(ss + kDecHeads * kDecKeys);  // 16 x LP

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x;
  int y = blockIdx.y;
  const int hc = y % a.hchunks;
  y /= a.hchunks;
  const int hk = y % a.hkv;
  const int b = y / a.hkv;
  const int g0 = hc * kDecHeads;
  const int gc = min(kDecHeads, a.group - g0);  // q-heads in this block
  const int h0 = hk * a.group + g0;
  const int j0 = a.k_begin + split * a.split_len;
  const int nk = min(a.split_len, a.skv - j0);  // >= 1 by construction

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh
      + static_cast<long long>(j0) * a.k_ss;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh
      + static_cast<long long>(j0) * a.v_ss;
  // rows past the heads or the keys are zero-filled
  for (int idx = tid; idx < kDecHeads * CH; idx += kDecThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < gc;
    cp_async16(qs + r * LD + c * 8, ok ? qg + (h0 + r) * a.q_sh + c * 8 : qg,
               ok ? 16 : 0);
  }
  for (int idx = tid; idx < kDecKeys * CH; idx += kDecThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < nk;
    cp_async16(ks + r * LD + c * 8, ok ? kg + r * a.k_ss + c * 8 : kg,
               ok ? 16 : 0);
  }
  cp_commit();
  for (int idx = tid; idx < kDecKeys * CH; idx += kDecThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < nk;
    cp_async16(vs + r * LD + c * 8, ok ? vg + r * a.v_ss + c * 8 : vg,
               ok ? 16 : 0);
  }
  cp_commit();
  cp_wait<1>();  // q and the keys have landed
  __syncthreads();

  {  // S = Q K^T: warp w takes keys 16w .. 16w + 15
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kb, ks + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                          + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa, kb[0], kb[1]);
      mma_bf16(s[1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        ss[(g + (e >> 1) * 8) * kDecKeys + key] = key < nk ? x : -INFINITY;
      }
    }
  }
  __syncthreads();

  // softmax of each head over the split's keys: warp w takes rows w, w+4..
  for (int r = warp; r < kDecHeads; r += kDecThreads / 32) {
    const float x0 = ss[r * kDecKeys + lane];
    const float x1 = ss[r * kDecKeys + lane + 32];
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    // nk >= 1 and every key in the split is valid: mx is finite
    const float p0 = __expf(x0 - mx);  // keys past nk: -inf -> 0
    const float p1 = __expf(x1 - mx);
    float sum = p0 + p1;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    ps[r * LP + lane] = __float2bfloat16(p0);
    ps[r * LP + lane + 32] = __float2bfloat16(p1);
    if (lane == 0 && r < gc) {
      float* ml = a.part_ml
          + (((long long)b * a.hq + h0 + r) * a.n_splits + split) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  cp_wait<0>();  // the values have landed
  __syncthreads();

  // O = P V over the split's keys: warp w takes column pairs w, w+4, ..
  float o[PPW][2][4] = {};
  const int steps = (nk + 15) / 16;
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t pa[4];
    ldmatrix_x4(pa, ps + (lane & 15) * LP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int pair = warp + 4 * i;
      if (pair < NPAIR) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7)
                                    + ((lane >> 3) & 1) * 8) * LD
                                 + pair * 16 + (lane >> 4) * 8);
        mma_bf16(o[i][0], pa, vb[0], vb[1]);
        mma_bf16(o[i][1], pa, vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + rr * 8;
    if (r >= gc) continue;
    float* po = a.part_o
        + (((long long)b * a.hq + h0 + r) * a.n_splits + split) * D + t4 * 2;
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int pair = warp + 4 * i;
      if (pair < NPAIR) {
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          *reinterpret_cast<float2*>(po + pair * 16 + tt * 8) =
              make_float2(o[i][tt][2 * rr], o[i][tt][2 * rr + 1]);
        }
      }
    }
  }
}

// out[b, h] = sum_s e^{m_s - M} o_s / sum_s e^{m_s - M} l_s; a split with
// no key (m = -inf, l = 0) adds nothing, a row with none outputs 0.  When
// lse is not null, lse[b, h] = M + log(sum_s e^{m_s - M} l_s), the row's
// log-sum-exp of its scaled logits (-inf for a row with no key).  One
// block per (batch, q-head) of kCombineParts x D threads: the splits'
// weights are staged in shared memory (kMaxSplits at most), each part
// sums one contiguous range of splits in ascending order, and the parts'
// sums are added in part order -- a fixed order, so the bits repeat.
constexpr int kMaxSplits = 4096;
constexpr int kCombineParts = 4;

__global__ void flash_combine_kernel(const float* __restrict__ part_o,
                                     const float* __restrict__ part_ml,
                                     void* out, float* __restrict__ lse,
                                     int hq, int d, int n_splits,
                                     long long o_sb, long long o_sh) {
  extern __shared__ float smem_c[];
  float* sw = smem_c;                  // n_splits: m, then e^{m - M}
  float* sl = sw + n_splits;           // n_splits: l
  float* sacc = sl + n_splits;         // kCombineParts x d
  __shared__ float s_red[32];
  __shared__ float s_sum[kCombineParts];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = tid % d, part = tid / d;
  const float* ml = part_ml + static_cast<long long>(bh) * n_splits * 2;
  float mx = -INFINITY;
  for (int s = tid; s < n_splits; s += blockDim.x) {
    sw[s] = ml[2 * s];
    sl[s] = ml[2 * s + 1];
    mx = fmaxf(mx, sw[s]);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  if ((tid & 31) == 0) s_red[tid >> 5] = mx;
  __syncthreads();
  mx = -INFINITY;
  for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i)
    mx = fmaxf(mx, s_red[i]);  // a max is exact in any order
  for (int s = tid; s < n_splits; s += blockDim.x)
    sw[s] = mx != -INFINITY ? expf(sw[s] - mx) : 0.f;
  __syncthreads();
  const int per = (n_splits + kCombineParts - 1) / kCombineParts;
  const int lo = part * per, hi = min(n_splits, lo + per);
  const float* po = part_o + static_cast<long long>(bh) * n_splits * d + col;
  float acc = 0.f, sum = 0.f;
#pragma unroll 8
  for (int s = lo; s < hi; ++s) {
    acc += sw[s] * po[static_cast<long long>(s) * d];
    sum += sw[s] * sl[s];
  }
  sacc[part * d + col] = acc;
  if (col == 0) s_sum[part] = sum;
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < kCombineParts; ++p) {
      acc += sacc[p * d + col];
      sum += s_sum[p];
    }
    bf16* o = static_cast<bf16*>(out) + (bh / hq) * o_sb + (bh % hq) * o_sh;
    o[col] = __float2bfloat16(sum > 0.f ? acc / sum : 0.f);
    if (lse != nullptr && col == 0)
      lse[bh] = sum > 0.f ? mx + logf(sum) : -INFINITY;
  }
}

// ---------------------------------------------------------------------- //
// launches
// ---------------------------------------------------------------------- //
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch_f32(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<D>();
  static int set = allow_smem(flash_fwd_f32_kernel<D>, bytes);
  if (set != 0) return set;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, batch * a.hq);
  flash_fwd_f32_kernel<D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = MmaTile<D>::smem_bytes;
  static int set = allow_smem(flash_prefill_mma_kernel<D>, bytes);
  if (set != 0) return set;
  const dim3 grid((a.sq + kMmaRows - 1) / kMmaRows, batch * a.hq);
  flash_prefill_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode_mma(const DecodeArgs& a, int batch, cudaStream_t stream) {
  constexpr int bytes = DecMma<D>::smem_bytes;
  static int set = allow_smem(flash_decode_mma_kernel<D>, bytes);
  if (set != 0) return set;
  const dim3 grid(a.n_splits, batch * a.hkv * a.hchunks);
  flash_decode_mma_kernel<D><<<grid, kDecThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 forms' head dims: multiples of 16 (the mma k-step); 160 is
// stablelm-12b's (10 k-steps, 20 16-byte chunks a row, 336-byte padded
// shared rows; 105 KB of shared memory in the prefill form, 54 KB in
// decode, 640 combine threads)
#define REPRO_BY_DIM(CALL)                        \
  switch (d) {                                    \
    case 16: return CALL(16);                     \
    case 32: return CALL(32);                     \
    case 64: return CALL(64);                     \
    case 128: return CALL(128);                   \
    case 160: return CALL(160);                   \
    case 256: return CALL(256);                   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// the float32 form's: also D = 8 (the smoke configs of starcoder2-15b
// and llava-next-34b), one output column a lane
#define REPRO_BY_DIM_F32(CALL)                    \
  switch (d) {                                    \
    case 8: return CALL(8);                       \
    case 16: return CALL(16);                     \
    case 32: return CALL(32);                     \
    case 64: return CALL(64);                     \
    case 128: return CALL(128);                   \
    case 160: return CALL(160);                   \
    case 256: return CALL(256);                   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// form: 0 = float32 on CUDA cores, 1 = bf16 on tensor cores (q, k, v and
// o alike); Sq > 1.  strides: the (batch, head, sequence) strides, in
// elements, of q, k, v and o, in that order (12 values); the last axis of
// each is contiguous, and for form 1 q, k and v start on 16 bytes and their
// strides are multiples of 8 elements.  lse: null, or for form 0 a
// contiguous (B, Hq, Sq) float32 buffer for the rows' log-sum-exp.
extern "C" int flash_attention_fwd(int form, const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int batch, int hq,
                                   int hkv, int sq, int skv, int d,
                                   const long long* strides, int causal,
                                   int window, float softcap, float scale,
                                   cudaStream_t stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv <= 0 || batch * static_cast<long long>(hq) > 65535 ||
      (lse != nullptr && form != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
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
  if (form == 0) {
#define REPRO_F32(D) launch_f32<D>(a, batch, stream)
    REPRO_BY_DIM_F32(REPRO_F32)
#undef REPRO_F32
  }
  if (form == 1) {
    for (int i = 0; i < 9; ++i)
      if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(q) || !aligned16(k) || !aligned16(v))
      return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_MMA(D) launch_mma<D>(a, batch, stream)
    REPRO_BY_DIM(REPRO_MMA)
#undef REPRO_MMA
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bfloat16, Sq = 1.  strides: (batch, head) of
// q, then (batch, head, sequence) of k and v (8 values); q, k and v start
// on 16 bytes and their strides are multiples of 16 bytes.  part_o (B * Hq,
// n_splits, D) and part_ml (B * Hq, n_splits, 2) are float32 scratch;
// split s covers keys [k_begin + s * split_len, ...) up to Skv, and
// n_splits * split_len must cover them with no empty split.
extern "C" int flash_attention_decode(const void* q, const void* k,
                                      const void* v, float* part_o,
                                      float* part_ml, int batch, int hq,
                                      int hkv, int skv, int d,
                                      const long long* strides, int k_begin,
                                      int n_splits, int split_len,
                                      float softcap, float scale,
                                      cudaStream_t stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || skv <= 0 ||
      k_begin < 0 || k_begin >= skv || n_splits <= 0 || split_len <= 0 ||
      split_len > kDecKeys || n_splits > kMaxSplits ||
      k_begin + static_cast<long long>(n_splits - 1) * split_len >= skv ||
      k_begin + static_cast<long long>(n_splits) * split_len < skv ||
      !aligned16(q) || !aligned16(k) || !aligned16(v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.part_o = part_o;
  a.part_ml = part_ml;
  a.hq = hq;
  a.hkv = hkv;
  a.group = hq / hkv;
  a.hchunks = (a.group + kDecHeads - 1) / kDecHeads;
  a.skv = skv;
  a.k_begin = k_begin;
  a.split_len = split_len;
  a.n_splits = n_splits;
  a.softcap = softcap;
  a.scale = scale;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.k_sb = strides[2];
  a.k_sh = strides[3];
  a.k_ss = strides[4];
  a.v_sb = strides[5];
  a.v_sh = strides[6];
  a.v_ss = strides[7];
  for (int i = 0; i < 8; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * static_cast<long long>(hkv) * a.hchunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_DEC(D) launch_decode_mma<D>(a, batch, stream)
  REPRO_BY_DIM(REPRO_DEC)
#undef REPRO_DEC
}

// o[b, h, 0, :] (bfloat16) from the decode partials; o_sb, o_sh in
// elements; lse (B * Hq float32, or null) the rows' log-sum-exp
extern "C" int flash_attention_combine(const float* part_o,
                                       const float* part_ml, void* o,
                                       float* lse, int batch, int hq, int d,
                                       int n_splits,
                                       long long o_sb, long long o_sh,
                                       cudaStream_t stream) {
  if (batch <= 0 || hq <= 0 || d <= 0 || d % 8 != 0 ||
      kCombineParts * d > 1024 || n_splits <= 0 || n_splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(batch * hq);
  const int threads = kCombineParts * d;
  const int bytes =
      (2 * n_splits + kCombineParts * d) * static_cast<int>(sizeof(float));
  flash_combine_kernel<<<blocks, threads, bytes, stream>>>(
      part_o, part_ml, o, lse, hq, d, n_splits, o_sb, o_sh);
  return static_cast<int>(cudaGetLastError());
}
