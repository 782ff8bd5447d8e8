// Correctly rounded float64 power, x ** e, for the PFS engine's
// congestion factor (pfs/state.py::engine_step: (buffer / queued) ** e).
//
// The engine's float64 arithmetic is bit-equal across the card and the
// CPU everywhere but here: CUDA's pow is within 2 ulp, not correctly
// rounded, and a last bit of the congestion factor can flip a discrete
// step of the simulation.  This kernel rounds x ** e correctly: log(x)
// in double-double (CUDA's log, then one Newton step through a
// double-double exp), times e, then a double-double exp (reduction by
// ln 2, a 2^-10 scaling, a degree-8 Taylor series, ten squarings), whose
// high part is the nearest double to a value accurate to ~2^-100.  So it
// returns glibc's pow (and numpy's, where numpy calls libm) but for
// values within ~2^-47 ulp of a rounding tie.
//
// Every double-double step uses the _rn intrinsics, so nvcc contracts
// nothing into an FMA but the exact products' error terms; the plain
// version (kernels/pow_cr/ref.py) runs the same steps with Dekker's
// exact products and gives the same bits.
//
// One thread an element: the engine calls it on one value per OST.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct dd { double hi, lo; };

__device__ __forceinline__ dd two_sum(double a, double b) {
  double s = __dadd_rn(a, b);
  double bb = __dsub_rn(s, a);
  return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb))};
}

__device__ __forceinline__ dd quick_two_sum(double a, double b) {
  double s = __dadd_rn(a, b);
  return {s, __dsub_rn(b, __dsub_rn(s, a))};
}

__device__ __forceinline__ dd two_prod(double a, double b) {
  double p = __dmul_rn(a, b);
  return {p, __fma_rn(a, b, -p)};
}

__device__ __forceinline__ dd dd_add(dd a, dd b) {
  dd s = two_sum(a.hi, b.hi);
  dd t = two_sum(a.lo, b.lo);
  dd u = quick_two_sum(s.hi, __dadd_rn(s.lo, t.hi));
  return quick_two_sum(u.hi, __dadd_rn(u.lo, t.lo));
}

__device__ __forceinline__ dd dd_mul(dd a, dd b) {
  dd p = two_prod(a.hi, b.hi);
  return quick_two_sum(p.hi, __dadd_rn(
      p.lo, __dadd_rn(__dmul_rn(a.hi, b.lo), __dmul_rn(a.lo, b.hi))));
}

__device__ __forceinline__ dd dd_mul_d(dd a, double b) {
  dd p = two_prod(a.hi, b);
  return quick_two_sum(p.hi, __dadd_rn(p.lo, __dmul_rn(a.lo, b)));
}

__device__ dd exp_dd(dd z) {
  const dd neg_ln2 = {-0.6931471805599453, -2.3190468138462996e-17};
  const dd sixth = {1.0 / 6.0, 9.25185853854297e-18};
  double k = rint(__ddiv_rn(z.hi, -neg_ln2.hi));
  dd r = dd_add(z, dd_mul_d(neg_ln2, k));
  r.hi = __dmul_rn(r.hi, 0x1p-10);
  r.lo = __dmul_rn(r.lo, 0x1p-10);
  dd r2 = dd_mul(r, r), r3 = dd_mul(r2, r), r4 = dd_mul(r2, r2);
  double h = r.hi;
  // r^4 (1/24 + r/120 + ... + r^5/9!): its terms sit below 2^-50 of 1,
  // so plain doubles carry them
  double tail = __dadd_rn(__ddiv_rn(1.0, 24.0), __dmul_rn(h, __dadd_rn(
      __ddiv_rn(1.0, 120.0), __dmul_rn(h, __dadd_rn(
          __ddiv_rn(1.0, 720.0), __dmul_rn(h, __dadd_rn(
              __ddiv_rn(1.0, 5040.0), __dmul_rn(h, __dadd_rn(
                  __ddiv_rn(1.0, 40320.0), __ddiv_rn(h, 362880.0))))))))));
  dd em1 = dd_add(r, dd_mul_d(r2, 0.5));
  em1 = dd_add(em1, dd_mul(r3, sixth));
  em1 = dd_add(em1, dd_mul_d(r4, tail));
  for (int i = 0; i < 10; ++i)                  // (1 + m)^2 = 1 + 2m + m^2
    em1 = dd_add(dd_mul_d(em1, 2.0), dd_mul(em1, em1));
  dd res = dd_add({1.0, 0.0}, em1);
  int ki = static_cast<int>(k);
  return {ldexp(res.hi, ki), ldexp(res.lo, ki)};
}

__device__ dd log_dd(double x) {
  double l0 = log(x);                           // within an ulp or so
  dd e = exp_dd({-l0, 0.0});                    // ~1 / x
  dd t = dd_add(dd_mul_d(e, x), {-1.0, 0.0});   // x e^-l0 - 1, tiny
  return dd_add({l0, 0.0}, t);                  // one Newton step
}

__global__ void pow_cr_kernel(const double* __restrict__ x,
                              double* __restrict__ out, double e, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double xi = x[i];
  if (xi == 1.0) {
    out[i] = 1.0;
  } else if (!(xi > 0.0) || isinf(xi)) {        // outside the engine's use
    out[i] = pow(xi, e);
  } else {
    out[i] = exp_dd(dd_mul_d(log_dd(xi), e)).hi;
  }
}

}  // namespace

extern "C" int pow_cr_f64(const double* x, double* out, double e, int n,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  pow_cr_kernel<<<(n + 127) / 128, 128, 0, stream>>>(x, out, e, n);
  return static_cast<int>(cudaGetLastError());
}
