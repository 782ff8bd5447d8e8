#!/usr/bin/env python3
"""The card's exp2 rate, bare and inside the selective scan's arithmetic.

    PYTHONPATH=src python3 benchmarks/torch_sfu_rate.py

Builds two probe kernels with the port's ``nvcc`` flags and times them
with CUDA events: ``bare`` chains ``ex2.approx`` alone (8 chains a
thread), ``scan`` runs ``csrc/mamba_scan.cu``'s per-step arithmetic for
one lane (4 channels x 4 states: FMUL, MUFU, FMUL, FFMA, FFMA a state)
with no loads, shuffles or stores.  Each runs at the scan's occupancy at
falcon-mamba-7b's layer (2 blocks of 128 threads an SM) and at more
blocks.  Prints one JSON line of exp2 results a clock an SM at the
card's highest SM clock (``chip_smoke.py``'s bound assumes 16 there),
with the clock ``nvidia-smi`` reads right after the runs beside it.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess

import torch

SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__global__ void bare(float* out, int iters) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = 0.001f * (threadIdx.x + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = ex2(-x[i]);
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += x[i];
  if (s == 12345.f) out[0] = s;
}
__global__ void scan(float* out, int iters) {
  float a[16], h[16], b[4], c[4], y = 0.f;
  for (int i = 0; i < 16; ++i) { a[i] = -0.01f * (i + 1); h[i] = 0.f; }
  for (int i = 0; i < 4; ++i) { b[i] = 0.1f * i; c[i] = 0.2f * i; }
  for (int it = 0; it < iters; it += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = fmaf(static_cast<float>(it + u), 1e-7f,
                           0.01f * threadIdx.x);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float du = d * (0.5f + r);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = r * 4 + i;
          h[k] = fmaf(ex2(d * a[k]), h[k], du * b[i]);
          acc = fmaf(h[k], c[i], acc);
        }
        y += acc;
      }
    }
  }
  for (int i = 0; i < 16; ++i) y += h[i];
  if (y == 12345.f) out[0] = y;
}
extern "C" int run(int which, float* out, int blocks, int threads,
                   int iters, cudaStream_t stream) {
  if (which == 0) bare<<<blocks, threads, 0, stream>>>(out, iters);
  else scan<<<blocks, threads, 0, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_sfu_rate: no CUDA device")
    from repro_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "sfu_rate.cu"
    lib_path = _build.BUILD_DIR / "sfu_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(pathlib.Path(lib_path))).run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for which, name, per_iter, iters in ((0, "bare", 8, 20000),
                                         (1, "scan", 16, 4000)):
        for blocks_per_sm in (2, 4, 8):
            blocks = blocks_per_sm * sms
            launch = lambda: fn(which, out.data_ptr(), blocks, 128,  # noqa
                                iters, stream)
            if launch() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            runs.append(dict(kernel=name, blocks_per_sm=blocks_per_sm,
                             threads=128, ms=ms,
                             ex2=blocks * 128 * iters * per_iter))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip()
    clock_mhz = float(smi.split(",")[-1])
    for r in runs:
        r["ex2_per_clock_per_sm"] = r["ex2"] / (r["ms"] * 1e-3) / sms \
            / (clock_mhz * 1e6)
    print(json.dumps(dict(device=smi, sms=sms, clock_mhz=clock_mhz,
                          runs=runs)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
