#!/usr/bin/env python3
"""Where the partial-irfft kernel's time goes, phase by phase, on one CUDA card.

    python3 scripts/profile_irfft_phases.py

Builds two copies of ``avlen_tpu_torch/csrc/partial_irfft.cu`` into
``build/irfft_phases/`` with a ``%globaltimer`` stamp (thread 0 of each CTA)
at every phase boundary and the CTA's SM id:

- ``cluster4``: the kernel as it is (8192 values and 256 threads a CTA, so
  clusters of 4 CTAs on the audio path);
- ``cluster8``: 4096 values a CTA (clusters of 8 on the audio path) with
  three CTAs an SM, the alternative that the measurement weighs against it.

For each, at the audio path's shape (N 65536, window 15999 + 16000) with 1
and 32 rows, it prints one JSON line: the CUDA-event time per launch (timed
as ``chip_smoke.py`` times), the span from the first CTA's start to the last
CTA's end, the mean and max time of each phase over the CTAs,
``cudaOccupancyMaxActiveClusters``, how many SMs ran 0, 1, 2 and 3 CTAs, and
the max error against the plain version. cuFFT's ``irfft`` + slice is timed
in the same process. The stamps cost a warp barrier and a store per phase.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("tables", "pass1_stage0", "pass1_rest", "cluster_sync1", "pass2_remote_reads",
          "cluster_sync2", "pass2_rest_and_store")
STAMP = '''
__device__ unsigned long long g_stamp[9][16384];
#define STAMP(i) do { __syncwarp(); if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_stamp[i][blockIdx.x] = t_; \\
  if (i == 0) { unsigned sm_; asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_)); g_stamp[8][blockIdx.x] = sm_; } } } while (0)
'''


def instrumented(src: str) -> str:
    marks = [  # (text, stamp index, where)
        ("  extern __shared__ float4 smem_raw[];\n", 0, "after"),
        ("  __syncthreads();\n  auto exp_n", 1, "before_auto"),
        ("      else stage<8>(Q, ns, cols1, lc1, twq, Q, load_z, store);\n", 2, "after"),
        ("  cluster_sync();  // every CTA's s complete and visible to the cluster\n", 3, "around"),
        ("  cluster_sync();  // no CTA reads another's s after this, so s is free\n", 5, "around"),
    ]
    for text, i, where in marks:
        if src.count(text) != 1:
            raise RuntimeError(f"marker not found once in partial_irfft.cu: {text!r}")
        if where == "after":
            src = src.replace(text, text + f"  STAMP({i});\n")
        elif where == "before_auto":
            src = src.replace(text, f"  __syncthreads();\n  STAMP({i});\n  auto exp_n")
        else:
            src = src.replace(text, f"  STAMP({i});\n" + text + f"  STAMP({i + 1});\n")
    end = src.index("}\n\nint g_smem_attr")
    src = src[:end] + "  STAMP(7);\n" + src[end:]
    src = src.replace("namespace {\n\nconstexpr int kThreads", STAMP + "namespace {\n\nconstexpr int kThreads", 1)
    src += ('\nextern "C" int read_stamps(void* host) '
            '{ return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp)); }\n')
    return src.replace('#include "smem_fft.cuh"',
                       f'#include "{os.path.join(ROOT, "avlen_tpu_torch", "csrc", "smem_fft.cuh")}"')


def variants(src: str):
    c8 = src.replace("constexpr int kElems = 8192;", "constexpr int kElems = 4096;")
    c8 = c8.replace("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")
    if c8.count("kElems = 4096") != 1 or c8.count("__launch_bounds__(kThreads, 3)") != 1:
        raise RuntimeError("cluster8 variant: constants not found")
    return {"cluster4": (src, 8192), "cluster8": (c8, 4096)}


def main() -> int:
    import numpy as np
    import torch

    from avlen_tpu_torch.ops import irfft_cuda
    from avlen_tpu_torch.utils import cuda_build
    from chip_smoke import time_ms

    if not torch.cuda.is_available():
        print("profile_irfft_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    src = open(os.path.join(ROOT, "avlen_tpu_torch", "csrc", "partial_irfft.cu")).read()
    out_dir = os.path.join(ROOT, "build", "irfft_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, _) in variants(src).items():
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(instrumented(text))
        procs[name] = (so, subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(so)
        lib.partial_irfft.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(irfft_cuda._CPlan),
                                      ctypes.c_void_p]
        lib.partial_irfft_max_clusters.argtypes = [ctypes.c_int] * 3
        lib.read_stamps.argtypes = [ctypes.c_void_p]
        libs[name] = lib

    dev = torch.device("cuda:0")
    fft_len, start, length = 65536, 15999, 16000
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {rows: torch.fft.rfft(torch.randn(rows, fft_len, generator=gen, device=dev), dim=-1)
             for rows in (1, 32)}
    for name, (_, elems) in variants(src).items():
        lib = libs[name]
        for rows, spec in specs.items():
            h = fft_len // 2
            cluster = h // elems
            plan = irfft_cuda.irfft_plan(fft_len, start, length, rows)
            cplan = irfft_cuda._c_plan(plan)
            cplan.cluster, cplan.cols1, cplan.cols2 = cluster, plan.P // cluster, plan.Q // cluster
            smem = elems * 8 + (plan.smem_bytes - irfft_cuda.CTA_ELEMS * 8)
            cplan.smem_bytes = smem
            max_clusters = lib.partial_irfft_max_clusters(cluster, smem, plan.threads)
            out = torch.empty(rows, length, device=dev)
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

            def launch():
                rc = lib.partial_irfft(spec.data_ptr(), out.data_ptr(), ctypes.byref(cplan), stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            launch()
            torch.cuda.synchronize()
            err = (out - irfft_cuda.partial_irfft_plain(spec, fft_len, start, length)).abs().max().item()
            ms, how = time_ms(launch)
            launch()
            torch.cuda.synchronize()
            stamps = np.zeros((9, 16384), dtype=np.uint64)
            if lib.read_stamps(stamps.ctypes.data):
                raise RuntimeError("read_stamps failed")
            n = rows * cluster
            t = stamps[:8, :n].astype(np.int64)
            per_sm = np.bincount(np.bincount(stamps[8, :n].astype(np.int64), minlength=132), minlength=4)[:4]
            d = np.diff(t, axis=0) / 1e3
            print(json.dumps({
                "variant": name, "rows": rows, "cluster": cluster, "values_per_cta": elems,
                "max_active_clusters": max_clusters, "ms": ms, "timing": how,
                "span_us": float(t[7].max() - t[0].min()) / 1e3,
                "phases_us": {p: {"mean": float(d[i].mean()), "max": float(d[i].max())}
                              for i, p in enumerate(PHASES)},
                "sms_running_0_1_2_3_ctas": per_sm.tolist(), "max_abs_err": err,
            }), flush=True)
    spec = specs[32]
    lib_ms, how = time_ms(lambda: torch.fft.irfft(spec, n=fft_len, dim=-1)[..., start:start + length])
    print(json.dumps({"library": "torch.fft.irfft + slice", "rows": 32, "ms": lib_ms, "timing": how}))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
