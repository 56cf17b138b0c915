#!/usr/bin/env python3
"""Device time of spectrogram kernel sources, in turns, on one CUDA card.

    python3 scripts/profile_spectrogram.py [--src PATH ...] [--baseline] [--batch N ...]

Builds each ``--src`` (default: ``avlen_tpu_torch/csrc/spectrogram.cu``; any
source that keeps the C entry ``spectrogram``, with or without the twiddle
table) into ``build/spectrogram_variants/``; ``--baseline`` puts the radix-2
kernel it replaced first (``chip_smoke.SPEC_BASELINE_COMMIT``, from git or
``build/spectrogram_baseline/``). At each batch (default 16, the rollout's
envs, and 256, a row block of the spectrogram bank) of 16 kHz binaural audio
with ``savi.yaml``'s spectrogram settings, it times every source in turns
(first, ..., last, last, ..., first) as ``chip_smoke.py`` times kernels, and
prints one JSON line per source and batch: the times, the max error against
the plain version, kernels per call by ``torch.profiler``, and ptxas'
registers and spill bytes of each kernel entry. A variant that computes only
part of the function (for timing) shows its error, which nothing checks.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from avlen_tpu_torch.ops import spectrogram_cuda
    from avlen_tpu_torch.ops.audio import SpectrogramConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--baseline", action="store_true", help="time the radix-2 kernel it replaced first")
    ap.add_argument("--batch", action="append", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_spectrogram: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    srcs = args.src or [os.path.join(ROOT, "avlen_tpu_torch", "csrc", "spectrogram.cu")]
    if args.baseline:
        base = chip_smoke.spectrogram_baseline_source()
        if base is None:
            raise SystemExit("profile_spectrogram: the radix-2 kernel's source is not available")
        srcs = [base] + srcs
    libs = [chip_smoke.SpectrogramLibrary(s, f"v{i}") for i, s in enumerate(srcs)]
    cfg = SpectrogramConfig(sampling_rate=16000)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in args.batch or [16, 256]:
        audio = 0.3 * torch.randn(b, 2, cfg.sampling_rate, generator=gen, device=dev)
        want = spectrogram_cuda.spectrogram_plain(audio, cfg)
        times = {lib.tag: [] for lib in libs}
        for lib in libs + libs[::-1]:
            times[lib.tag].append(chip_smoke.time_ms(lambda: lib(audio, cfg))[0])
        for lib in libs:
            err = (lib(audio, cfg) - want).abs().max().item()
            _, per_call, _ = chip_smoke.profiled_ms(lambda: lib(audio, cfg))
            ptxas = {entry: chip_smoke.ptxas_report(lib.build_log, entry)
                     for entry in sorted(set(re.findall(r"Compiling entry function '(\w+)'", lib.build_log)))}
            print(json.dumps({
                "src": os.path.relpath(lib.src, ROOT), "shape": list(audio.shape), "ms": times[lib.tag],
                "max_abs_err": err, "kernels_per_call": per_call,
                "ptxas_registers_spill_store_load": ptxas, "nvidia_smi": smi,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
