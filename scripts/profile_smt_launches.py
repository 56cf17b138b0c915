#!/usr/bin/env python3
"""Device time of each launch of one SMT-encode call, in call order, on one CUDA card.

    python3 scripts/profile_smt_launches.py [--src PATH ...] [--batch 16] [--memory 150] [--feat 276]

Builds each ``--src`` (default: ``avlen_tpu_torch/csrc/smt_encode.cu``; any
source that keeps the C entry ``smt_encode``) into ``build/smt_variants/``
and runs it at the rollout shape of ``savi.yaml`` (entries (B, 151, 288),
goal (B, 256), d_model 256, 8 heads; random weights from a seed), or at
(B, memory + 1, feat + 12) (the AVLEN step's: ``--batch 6`` with
``--memory 3`` for π_l, ``--feat 308`` for π_q). For each
source it prints one JSON line: the max error against the plain version and
against an f64 evaluation of it (beside the plain f32 version's own), the
CUDA-event time per call (timed as ``chip_smoke.py`` times), ptxas'
registers and spills per kernel, and ``torch.profiler``'s device events of
20 calls, grouped by their position within a call. Sources are timed in
turns (first, second, ..., second, first) in one process.
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
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops import smt_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--memory", type=int, default=150, help="memory entries before the current step")
    ap.add_argument("--feat", type=int, default=276, help="step features, the pose last")
    ap.add_argument("--entries-scale", type=float, default=1.0,
                    help="multiply the entries (e.g. 100 for a badly conditioned encode)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_smt_launches: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    srcs = args.src or [os.path.join(ROOT, "avlen_tpu_torch", "csrc", "smt_encode.cu")]
    libs = [chip_smoke.SmtLibrary(s, f"v{i}") for i, s in enumerate(srcs)]

    feat, d, nhead, b, m = args.feat, 256, 8, args.batch, args.memory
    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(feat - 4, feat),
                          generator=torch.Generator().manual_seed(7)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, feat, generator=gen, device=dev)
    mem = torch.randn(b, m, feat, generator=gen, device=dev)
    mask = (torch.rand(b, m, generator=gen, device=dev) > 0.3).float()
    goal = torch.randn(b, d, generator=gen, device=dev)
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        entries = entries * args.entries_scale
        params = dict(enc.named_parameters())
        want = smt_cuda.smt_encode_plain(params, entries, valid, goal, nhead)
        want64 = smt_cuda.smt_encode_plain({k: v.double() for k, v in params.items()}, entries.double(),
                                           valid.double(), goal.double(), nhead)
        plain_err64 = (want.double() - want64).abs().max().item()
        times = {lib.tag: [] for lib in libs}
        for lib in libs + libs[::-1]:
            times[lib.tag].append(chip_smoke.time_ms(lambda: lib(params, entries, valid, goal, nhead))[0])
        for lib in libs:
            got = lib(params, entries, valid, goal, nhead)
            err = (got - want).abs().max().item()
            err64 = (got.double() - want64).abs().max().item()
            per_call, positions = chip_smoke.launch_profile(lambda: lib(params, entries, valid, goal, nhead))
            ptxas = {}
            for entry in sorted(set(re.findall(r"Compiling entry function '(\w+)'", lib.build_log))):
                stack = re.search(entry + r"'.*?(\d+) bytes stack frame", lib.build_log, re.S)
                ptxas[entry] = (*chip_smoke.ptxas_report(lib.build_log, entry),
                                int(stack.group(1)) if stack else None)
            print(json.dumps({
                "src": os.path.relpath(lib.src, ROOT), "shape": list(entries.shape),
                "entries_scale": args.entries_scale, "max_abs_err": err, "max_abs_err_vs_f64": err64,
                "plain_max_abs_err_vs_f64": plain_err64,
                "ms": times[lib.tag], "kernels_per_call": per_call,
                "launches_us": [[name[:90], us] for name, us in positions],
                "sum_us": sum(us for _, us in positions), "ptxas": ptxas, "nvidia_smi": smi,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
