#!/usr/bin/env python3
"""The readings that a cell's limits are set from, and its control.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--mode program|tf32|bf16]

For each seed, one process runs the cell's set-up and checked rounds and
the reference after them, without the measured window, and prints one JSON
line of the numbers compared. ``program`` is the program as the
configuration states it: the limit's lower reading is the largest over a
dozen seeds or more. ``tf32`` is the control: the program with TF32 on in
cuDNN and cuBLAS, the nearest precision below the float32 the configuration
states (the reference stays at float32); ``bf16`` the program's own
``TPU.PRECISION bfloat16`` path; ``fault.<name>`` one of ``faults.py``'s
faults planted in the program. The control's and the faults' smallest
readings are the upper ones. The benchmark's runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# one process, few threads: the host paces the acting step, and other
# threads of this process would take its cores
os.environ.setdefault("OMP_NUM_THREADS", "2")

from portbench import harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402

MODES = {"program": {}, "tf32": {"program_tf32": True}, "bf16": {"extra_opts": ("TPU.PRECISION", "bfloat16")}}
MODES.update({f"fault.{name}": {"fault": name} for name in FAULTS})


def readings(workload: str, seed: int, mode: str, device=None, extra_opts=()):
    """The numbers compared of one seed's set-up and checked rounds, and
    what each round read."""
    import torch

    from portbench import run

    bench = harness.benchmark()
    entry = harness.cell(workload, bench)
    work = harness.workload_file(entry["name"])
    if device is None:
        harness.require_cards(entry["chips"])
        device = torch.device("cuda", 0)
    harness.precision_guard()
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0", "--trace", "0"])
    ctx = dict(args=args, config=harness.config_file(entry["config"]), workload=work, device=torch.device(device),
               bench=bench, t_start=time.perf_counter(), window=False, **MODES[mode])
    ctx["extra_opts"] = tuple(ctx.get("extra_opts", ())) + tuple(extra_opts)
    fault = FAULTS[ctx.pop("fault")]() if "fault" in ctx else contextlib.nullcontext()
    with fault:
        out = harness.driver_module(work["driver"]).run(ctx)
    harness.precision_guard()
    return {c["name"]: c["value"] for c in out["compared"]}, out["info"]["diag"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=sorted(MODES), default="program")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers, diag = readings(args.workload, seed, args.mode)
        print(json.dumps({"mode": args.mode, "seed": seed, "seconds": time.perf_counter() - t0, **numbers,
                          "diag": diag}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
