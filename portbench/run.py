#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name from
BENCHMARK.json (see portbench/README.md). The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device`` and, traced, ``breakdown``, then
``compared``: each number that decided ``correct`` beside its limit, as
the last lines of standard error also give them. Exits non-zero, printing
no result, without the CUDA devices the cell asks for, or if a module of
the JAX stack was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# one process, few threads: the host paces the acting step, and other
# threads of this process would take its cores
os.environ.setdefault("OMP_NUM_THREADS", "2")

from portbench import compare, harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device=None, extra_opts=(), t_start=None):
    """The cell's result and the numbers compared; ``device`` other than
    the card (the tests' CPU runs) skips the card check."""
    import torch

    bench = harness.benchmark()
    entry = harness.cell(args.workload, bench)
    conf = harness.config_file(entry["config"])
    work = harness.workload_file(entry["name"])
    if device is None:
        harness.require_cards(entry["chips"])
        device = torch.device("cuda", 0)
    harness.precision_guard()
    driver = harness.driver_module(work["driver"])
    out = driver.run(dict(args=args, config=conf, workload=work, device=torch.device(device), bench=bench,
                          extra_opts=extra_opts, t_start=T_START if t_start is None else t_start))
    names = harness.cell_metrics(args.workload, "per_layer" if args.trace else "end_to_end", bench)
    metrics = {}
    for m in names:
        if args.trace:
            value = harness.metric_module(m["name"]).read(out["rec"])
        else:
            value = out["e2e"].get(m["name"], {}).get("value")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": compare.correct(out["compared"]) and out["failed"] == 0,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if args.trace and out["rec"].get("trace"):
        tr = out["rec"]["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    return result, out


def main(argv=None) -> int:
    args = parse(argv)
    harness.prepare_environment()
    try:
        result, out = run_cell(args)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    found = harness.banned_modules()
    if found:
        print(f"portbench: modules of the JAX stack were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    info = out.get("info", {})
    print("portbench: " + " ".join(f"{k}={v}" for k, v in info.items()), file=sys.stderr)
    print(f"portbench: card {harness.power_limit()}", file=sys.stderr)
    harness.emit(result, out["compared"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
