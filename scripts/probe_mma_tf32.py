#!/usr/bin/env python3
"""Throughput of ``mma.sync.m16n8k8`` with TF32 inputs on one CUDA card.

    python3 scripts/probe_mma_tf32.py

Builds a micro-kernel into ``build/probe_mma/`` in which every warp runs a
loop of ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` on 8
independent accumulators (no memory traffic), launches it on every SM with
4, 8 and 16 warps per SM, and prints one JSON line per launch: TFLOP/s
(2*16*8*8 per product) and products per SM per clock at the SM clock that
``nvidia-smi`` reads during the run. This is the ceiling that the SMT
encode's 3xTF32 products (``csrc/smt_encode.cu``) can reach with
``mma.sync``; the card's published dense TF32 peak (495 TFLOP/s) is for
``wgmma``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = __float_as_uint(0.5f); b[1] = __float_as_uint(0.25f);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  mma_loop<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e0);
  mma_loop<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0); cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    import torch

    from avlen_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("probe_mma_tf32: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "build", "probe_mma")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "probe.cu"), os.path.join(out_dir, "libprobe.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    iters = 20000
    for warps in (4, 8, 16):
        out = torch.empty(sms * warps * 32, device="cuda")
        ms = ctypes.c_float()
        rc = lib.run(out.data_ptr(), sms, warps * 32, iters, ctypes.byref(ms))
        if rc != 0:
            raise RuntimeError(f"probe launch failed: {rc}")
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60).stdout.strip()
        products = sms * warps * iters * 8
        tflops = products * 2 * 16 * 8 * 8 / (ms.value * 1e-3) / 1e12
        per_clk = None
        if clock.isdigit() and int(clock) > 0:
            per_clk = products / sms / (ms.value * 1e-3 * int(clock) * 1e6)
        print(json.dumps({"warps_per_sm": warps, "ms": ms.value, "tflops": tflops,
                          "products_per_sm_per_clock": per_clk, "sm_clock_mhz_after": clock,
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
