#!/usr/bin/env python3
"""The SAVi training cell's host time split by the program's own spans.

    python3 scripts/profile_torch_spans.py --seed 7 --mode traced|on|off [--seconds 51] [--out DIR]
    python3 scripts/profile_torch_spans.py --mode offcost
    python3 scripts/profile_torch_spans.py --seed 7 --mode traced --seconds 2 --tiny   (a rehearsal on the CPU)

Runs portbench's ``savi.train.e32`` cell once on the card, as
``portbench/run.py`` does, with the span recorder of
``avlen_tpu_torch/utils/profiling.py`` put on from outside:

- ``traced``: ``--trace 1``, the recorder on over the window, and the
  profiled round annotated with the program's spans, its CUDA runtime calls
  kept: launch calls and blocking calls per acting step, idle gaps named by
  the innermost program span, the exported clock offset checked against the
  profiler's own annotations;
- ``on``: ``--trace 0`` with the recorder on over the window (what tracing
  costs end to end);
- ``off``: ``--trace 0`` as the benchmark runs it;
- ``offcost``: on the host alone, the ns of one span site with tracing off.

With the recorder on, the line also gives the window's CUDA-graph counters
of the acting forwards and the share of their calls that replayed
(``window.graphs``, ``window.replay_share``).

Prints one JSON line, also written to ``DIR/<mode>-<seed>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("OMP_NUM_THREADS", "2")

# CUDA runtime calls that put work on a stream, and those that block the host
LAUNCH_CALLS = ("LaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch",
                "LaunchCooperativeKernel")
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                  "cudaMemcpy2D", "cudaMemset")


def is_launch(name: str) -> bool:
    return any(k in name for k in LAUNCH_CALLS)


def is_blocking(name: str) -> bool:
    return name in BLOCKING_CALLS


def per_step(agg, steps, key="total_ns"):
    return agg[key] / steps / 1e6 if agg else 0.0


def window_split(sp, rec, info):
    """Per acting step ms of each span over the window, and the derived
    numbers: the loop's own time, the four-part sum against the step's
    median, the collect's CPU share, the collector's pauses a round, and
    each graphed entry point's calls and the share of them replayed."""
    by = sp["by_name"]
    steps = by["collect.step"]["count"]
    names = sp["spans"]["name"]
    g = lambda n, k="total_ns": per_step(by.get(n), steps, k)  # noqa: E731
    collect_self = g("collect", "self_ns") + g("collect.step", "self_ns") + g("collect.bootstrap") + g(
        "collect.stack")
    cpu = sum(ns for _, ns in sp["cpu_ns"])
    wall = sum(e - s for n, s, e in zip(names, sp["spans"]["start_ns"], sp["spans"]["end_ns"]) if n == "collect")
    rounds = max(sp["rounds"], 1)
    out = {
        "acting_steps": steps, "rounds": sp["rounds"],
        "ms_per_step": {n: round(g(n), 4) for n in sorted(by) if by[n]["count"] >= steps},
        "self_ms_per_step": {n: round(g(n, "self_ns"), 4) for n in sorted(by) if by[n]["count"] >= steps},
        "collect_self_host_ms": collect_self, "belief_host_ms": g("collect.belief"),
        "act_span_ms": g("collect.act"), "env_step_span_ms": g("collect.env_step"),
        "step_span_ms": g("collect.step"),
        "collect_cpu_share": cpu / wall if wall else None,
        "gc_pause_ms_per_round": sum(p[2] for p in sp["gc"]) / 1e6 / rounds,
        "gc_pauses_by_gen": [sum(1 for p in sp["gc"] if p[0] == k) for k in range(3)],
        "gc_longest_ms_by_gen": [max([p[2] / 1e6 for p in sp["gc"] if p[0] == k], default=0.0) for k in range(3)],
        "graphs": sp.get("graphs", {}),
        "replay_share": {n: c["replays"] / max(sum(c.values()), 1) for n, c in sp.get("graphs", {}).items()},
        "update_ms": per_step(by.get("update"), sp["rounds"] or 1),
        "update_stream_ms": per_step(by.get("update"), sp["rounds"] or 1, "stream_ns"),
    }
    if rec.get("act_host_ms") is not None:
        four = collect_self + g("collect.belief") + rec["act_host_ms"] + rec["env_step_host_ms"]
        med = info.get("step_ms_median")
        out.update(act_host_ms=rec["act_host_ms"], env_step_host_ms=rec["env_step_host_ms"], four_sum_ms=four,
                   step_ms_median=med, four_sum_over_median=four / med if med else None)
    return out


def runtime_split(prof, sp):
    """Launch and blocking runtime calls whose host start lies in a
    ``collect.step`` annotation of the profiled round, per acting step; the
    same through the in-memory spans and the exported offset."""
    raw = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if "CUDA" not in str(e.device_type())]
    steps = sorted((s, s + d) for n, s, d in raw if n == "collect.step")
    calls = sorted((s, d, n) for n, s, d in raw if is_launch(n) or is_blocking(n))

    def within(intervals):
        launches = blocking = wait = j = 0
        for s0, s1 in intervals:
            while j < len(calls) and calls[j][0] < s0:
                j += 1
            k = j
            while k < len(calls) and calls[k][0] < s1:
                s, d, n = calls[k]
                if is_launch(n):
                    launches += 1
                else:
                    blocking += 1
                    wait += d
                k += 1
        n = max(len(intervals), 1)
        return {"steps": len(intervals), "launches_per_act_step": launches / n,
                "blocking_per_act_step": blocking / n, "sync_wait_ms": wait / n / 1e6}

    out = {"by_annotation": within(steps)}
    off = sp.get("clock_offset_ns")
    if off is not None:
        s = sp["spans"]
        mine = sorted((st + off, e + off) for n, st, e in zip(s["name"], s["start_ns"], s["end_ns"])
                      if n == "collect.step")
        out["by_offset"] = within(mine)
        out["clock_offset_ns"] = off
        resid = [a[0] - b[0] for a, b in zip(mine, steps)] if len(mine) == len(steps) else []
        out["offset_residual_us"] = [min(resid) / 1e3, max(resid) / 1e3] if resid else None
    names = {}
    for _, d, n in calls:
        names.setdefault(n, [0, 0])
        names[n][0] += 1
        names[n][1] += d
    out["calls"] = {n: [c, round(d / 1e6, 3)] for n, (c, d) in sorted(names.items(), key=lambda kv: -kv[1][0])}
    return out


def long_gaps(events, labels, window, ops, least_us=1000.0):
    """Every idle gap of the device of at least ``least_us``, counted by
    the innermost label running at its start (``harness.reduce_trace``'s
    rule; it keeps only each name's longest)."""
    from portbench import harness

    _, merged = harness.union_seconds((st, st + d) for _, st, d in ops)
    edges = [window[0]] + [x for a, b in merged for x in (a, b)] + [window[1]]
    host = sorted((st, st + d, n) for n, dev, st, d, _ in events if not dev and n in set(labels))
    count = {}
    for k in range(0, len(edges) - 1, 2):
        a, b = edges[k], edges[k + 1]
        if b - a < least_us:
            continue
        running = [h for h in host if h[0] <= a < h[1]]
        name = max(running, key=lambda h: h[0])[2] if running else "host (unlabelled)"
        count[name] = count.get(name, 0) + 1
    return dict(sorted(count.items(), key=lambda kv: -kv[1]))


def run(args):
    import torch

    from avlen_tpu_torch.utils import profiling
    from portbench import harness, program
    from portbench import run as pb_run

    harness.prepare_environment()
    state = {}
    whole_rounds = harness.whole_rounds
    if args.mode in ("traced", "on"):
        def recorded_rounds(run_round, seconds, clock=time.perf_counter, sync=lambda: None):
            profiling.enable()
            try:
                return whole_rounds(run_round, seconds, clock, sync)
            finally:
                profiling.disable()
                state["window"] = profiling.export()
        harness.whole_rounds = recorded_rounds
    if args.mode == "traced":
        def profiled(run_fn, device, labels):
            from torch.profiler import ProfilerActivity, profile, record_function

            launches = {}
            harness.sync(device)
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with program.recorded_launches(launches), profile(activities=activities) as prof:
                profiling.enable(annotate=True)
                with record_function("portbench.window"):
                    run_fn()
                harness.sync(device)
                profiling.disable()
            sp = profiling.export(prof)
            events = program.profiler_events(prof)
            mark = [e for e in events if e[0] == "portbench.window" and not e[1]]
            w = (mark[0][2], mark[0][2] + mark[0][3])
            names = tuple(labels) + profiling.SPAN_NAMES + ("portbench.window",)
            trace = harness.reduce_trace(events, names, w)
            state["profiled"] = dict(runtime_split(prof, sp), by_name=sp["by_name"], graphs=sp["graphs"],
                                     idle_gaps=trace["idle_gaps"], gaps_over_1ms=long_gaps(events, names, w,
                                                                                           trace["ops"]),
                                     busy_s=trace["busy_s"], window_s=trace["window_s"])
            return {"trace": trace, "launches": launches}
        program.profiled = profiled
    ns = argparse.Namespace(workload="savi.train.e32", seed=args.seed, seconds=args.seconds,
                            trace=int(args.mode == "traced"))
    if args.tiny:  # the tests' tiny world on the CPU
        from portbench.tests.conftest import TINY

        result, out = pb_run.run_cell(ns, device="cpu", extra_opts=TINY)
    else:
        result, out = pb_run.run_cell(ns)
    line = {"mode": args.mode, "seed": args.seed, "card": harness.power_limit(), "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "e2e": {k: v["value"] for k, v in out["e2e"].items()},
            "step_ms_median": out["info"].get("step_ms_median"), "rounds": out["info"].get("rounds"),
            "torch": torch.__version__}
    if "window" in state:
        line["window"] = window_split(state["window"], out["rec"], out["info"])
        line["window_by_name"] = state["window"]["by_name"]
    if "profiled" in state:
        line["profiled"] = state["profiled"]
    return line


def offcost(n=200_000):
    """ns per span site with tracing off, and per ``Timings.time`` block."""
    from avlen_tpu_torch.utils import profiling

    profiling.disable()
    span = profiling.span
    best = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("collect.act"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        best.append((t1 - t0 - (time.perf_counter_ns() - t1)) / n)
    return {"mode": "offcost", "ns_per_span_off": statistics.median(best), "python": sys.version.split()[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("traced", "on", "off", "offcost"), required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "spans"))
    ap.add_argument("--tiny", action="store_true", help="a rehearsal on the CPU at the tests' tiny world")
    args = ap.parse_args(argv)
    line = offcost() if args.mode == "offcost" else run(args)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.mode}-{args.seed}.json"), "w") as f:
        json.dump(line, f)
    brief = {k: v for k, v in line.items() if k not in ("window_by_name",)}
    if "profiled" in brief:
        brief["profiled"] = {k: v for k, v in brief["profiled"].items() if k not in ("by_name", "calls")}
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
