#!/usr/bin/env python3
"""The error of the decay formulas the scan's backward can use for A =
exp(x), x = dt a <= 0, on one NVIDIA GPU: each formula's mean relative
error (its bias, which compounds along a state's chain of decays) and its
largest, against exp in float64, over x in four ranges (a million draws
each, uniform in the range).  Run from the repository root:

    python3 scripts/exp_bias.py

The formulas (``csrc``-style CUDA, compiled here by ``nvcc`` as the loader
compiles the kernels):

* ``expf``: the accurate expf;
* ``ex2``: ex2.approx.ftz of x log2 e (the forward kernel's);
* ``ex2_shift``: 0.5 ex2.approx.ftz(x log2 e + 1), the argument moved up
  by one;
* ``fast_expf``: CUDA's __expf.

Prints the card's name and power limit, then one line per (formula,
range).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__global__ void k(const float* x, double* err, int n, int f) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  const float l2e = 1.4426950408889634f;
  float r;
  if (f == 0) r = expf(v);
  else if (f == 1) r = ex2(v * l2e);
  else if (f == 2) r = 0.5f * ex2(fmaf(v, l2e, 1.f));
  else r = __expf(v);
  const double want = exp((double)v);
  err[i] = ((double)r - want) / want;
}
extern "C" int run(const void* x, void* err, int n, int f) {
  k<<<(n + 255) / 256, 256>>>((const float*)x, (double*)err, n, f);
  return (int)cudaDeviceSynchronize();
}
"""
FORMULAS = ("expf", "ex2", "ex2_shift", "fast_expf")
RANGES = ((-0.01, 0.0), (-0.1, -0.01), (-1.0, -0.1), (-4.0, -1.0))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_bias: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import loader

    print(cs._card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "exp_bias.cu", Path(tmp) / "libexp_bias.so"
        cu.write_text(SRC)
        subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-o", str(so),
                        str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        g = torch.Generator(device="cuda").manual_seed(0)
        n = 1 << 20
        for lo, hi in RANGES:
            x = torch.rand(n, generator=g, device="cuda") * (hi - lo) + lo
            err = torch.empty(n, dtype=torch.float64, device="cuda")
            for f, name in enumerate(FORMULAS):
                rc = lib.run(ctypes.c_void_p(x.data_ptr()),
                             ctypes.c_void_p(err.data_ptr()),
                             ctypes.c_int(n), ctypes.c_int(f))
                if rc:
                    raise RuntimeError(f"exp_bias kernel failed ({rc})")
                print(f"{name:10s} x in [{lo}, {hi}): mean rel err "
                      f"{float(err.mean()):+.3e}, max |rel err| "
                      f"{float(err.abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
