"""Measure the rate of mma.sync on a CUDA card: the ceiling of the port's
mma.sync kernels (TF32 m16n8k8, the f32 cores' 3xTF32 products at a third of
it; bf16 m16n8k16).

    python3 scripts/mma_peak.py

Compiles a small kernel with nvcc into build/mma_peak/ (gitignored): every
warp of 256-thread CTAs issues eight independent mma.sync into registers,
20,000 times, with no load and no store in the loop. Prints one JSON line:
the card (``nvidia-smi`` name and power limit) and TFLOP/s for each type at
132, 264 and 528 CTAs, from CUDA events around one launch.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool BF16>
__global__ void __launch_bounds__(256) peak(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = b0 + 7;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
                     "{%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
                     "{%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_peak(int bf16, float* out, int blocks, int iters) {
  if (bf16) peak<true><<<blocks, 256>>>(out, iters);
  else peak<false><<<blocks, 256>>>(out, iters);
  return cudaGetLastError();
}
"""

ITERS = 20_000
# FLOP of one mma.sync: 2 m n k
MMA_FLOP = {"tf32 m16n8k8": 2 * 16 * 8 * 8, "bf16 m16n8k16": 2 * 16 * 8 * 16}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_peak: no CUDA card is available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parents[1]
    build = repo / "build" / "mma_peak"
    build.mkdir(parents=True, exist_ok=True)
    (build / "peak.cu").write_text(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(build / "peak.so"), str(build / "peak.cu")], check=True)
    lib = ctypes.CDLL(str(build / "peak.so"))
    lib.run_peak.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    out = torch.empty(528 * 256, device="cuda")
    rates = {}
    for bf16, (name, flop) in enumerate(MMA_FLOP.items()):
        for blocks in (132, 264, 528):
            if lib.run_peak(bf16, out.data_ptr(), blocks, 100) != 0:
                raise RuntimeError("launch failed")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            lib.run_peak(bf16, out.data_ptr(), blocks, ITERS)
            end.record()
            torch.cuda.synchronize()
            mmas = blocks * 8 * ITERS * 8  # CTAs x warps x iterations x products
            rates[f"{name} {blocks} CTAs"] = mmas * flop / (start.elapsed_time(end) * 1e-3) / 1e12
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "tflops": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
