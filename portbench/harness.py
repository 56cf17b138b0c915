"""The benchmark's general machinery, driven by the files named in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/workloads/<cell>.json``); the traffic file names the driver
(``portbench/drivers/<driver>.py``) that runs it. A per-layer metric is
``portbench/metrics/<metric>.py`` (its unit, layer, the end-to-end metric
it moves, and ``read(rec)``), and a kernel's work count is
``portbench/rooflines/<kernel>.py``. Each is found by its name, so a later
cell, metric or roofline is a new file and an entry in BENCHMARK.json.

This module also holds what every run shares: the environment (build and
kernel caches inside the checkout, TF32 off, no JAX), the card check, the
trace reduction (device busy time, idle gaps by host phase, kernel time by
name pattern), the roofline share and the result line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PORTBENCH = Path(__file__).resolve().parent
ROOT = PORTBENCH.parent
# top-level module names no run may load (the JAX package and its stack);
# the port's own name begins with one of them and is compared whole
BANNED = ("jax", "jaxlib", "flax", "optax", "avlen_tpu")
# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "bytes": 3.35e12}


# --------------------------------------------------------------- files by name
def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict:
    path = PORTBENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {kind[:-1]} file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def config_file(name: str) -> Dict:
    return _json("configs", name)


def workload_file(name: str) -> Dict:
    return _json("workloads", name)


def _module(kind: str, name: str):
    path = PORTBENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {kind[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    return _module("metrics", name)


def roofline_module(kernel: str):
    return _module("rooflines", kernel)


def roofline_names() -> List[str]:
    """Every kernel that has a roofline file."""
    return sorted(p.stem for p in (PORTBENCH / "rooflines").glob("*.py"))


def driver_module(name: str):
    return _module("drivers", name)


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(name: str, section: str, bench: Optional[Dict] = None) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports: those that list it under ``workloads``; an end-to-end metric
    without the key (``setup_s``) is reported by every cell. Every
    per-layer entry lists its cells."""
    bench = bench or benchmark()
    if section == "end_to_end":
        return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return [m for m in bench["per_layer"] if name in m["workloads"]]


# --------------------------------------------------------------- environment
def prepare_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may pull in JAX through Flax."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "nv_compute_cache"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def precision_guard() -> None:
    """TF32 off: the configurations state float32. Also the process's
    intra-op threads, which the host's share of a step would lose."""
    import torch

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"portbench: this cell needs {chips} CUDA device(s); {n} available")


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


# --------------------------------------------------------------- clocks
class HostEvent:
    """``torch.cuda.Event``'s two calls on the host clock (CPU runs)."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def new_event(device):
    import torch

    if getattr(device, "type", device) == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def sync(device) -> None:
    import torch

    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize(device)


def whole_rounds(run_round, seconds: float, clock=time.perf_counter, sync=lambda: None):
    """Runs ``run_round()`` once, then again while the clock says one more
    round, as long as the longest so far, ends within ``seconds`` of the
    start. Returns (the wall seconds of each round, the window's wall
    seconds, ending after ``sync()``)."""
    sync()
    t0 = last = clock()
    rounds: List[float] = []
    while not rounds or (last - t0) + max(rounds) <= seconds:
        run_round()
        now = clock()
        rounds.append(now - last)
        last = now
    sync()
    return rounds, clock() - t0


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile by ``statistics.quantiles``' default (exclusive) rule
    over 100 cut points; the value itself for fewer than two."""
    vals = sorted(values)
    if len(vals) < 2:
        return vals[0]
    return statistics.quantiles(vals, n=100)[int(round(q * 100)) - 1]


# --------------------------------------------------------------- traces
def union_seconds(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(seconds covered, merged intervals) of (start_us, end_us) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, [(s, e) for s, e in merged]


def reduce_trace(events, labels: Sequence[str], window_us: Tuple[float, float]) -> Dict:
    """From profiler events as (name, on the device, start µs, duration µs,
    a user annotation): the device operations (kernels, copies, sets) as
    (name, start_us, dur_us), the device's busy seconds over the window, the
    top operations by time, and the longest idle gaps named by the innermost
    host label running at their start."""
    ops, host = [], []
    label_set = set(labels)
    for name, on_device, start, dur, annotation in events:
        if on_device:
            annotation = annotation or name in label_set or name.startswith(("Optimizer.", "ProfilerStep"))
            if dur > 0 and not annotation:
                ops.append((name, float(start), float(dur)))
        elif name in label_set:
            host.append((float(start), float(start + dur), name))
    busy_s, merged = union_seconds((s, s + d) for _, s, d in ops)
    by_name: Dict[str, float] = {}
    for name, _, d in ops:
        by_name[name] = by_name.get(name, 0.0) + d / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    w0, w1 = window_us
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    host.sort()
    named: Dict[str, float] = {}
    for s, e in gaps:
        running = [h for h in host if h[0] <= s < h[1]]
        name = max(running, key=lambda h: h[0])[2] if running else "host (unlabelled)"
        named[name] = max(named.get(name, 0.0), (e - s) / 1e6)
    longest = sorted(((name, sec) for name, sec in named.items()), key=lambda kv: -kv[1])[:10]
    return {"ops": ops, "busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in longest]}


def kernel_seconds(ops, patterns: Sequence[str]) -> Tuple[float, int]:
    """(device seconds, launches seen) of the operations whose name holds
    one of ``patterns``."""
    hit = [d for name, _, d in ops if any(p in name for p in patterns)]
    return sum(hit) / 1e6, len(hit)


def roofline_share(rec: Dict, kernel: str) -> Optional[float]:
    """The least time the card could take for ``kernel``'s launches in the
    traced sub-window, over the device time its kernels took, in %. None
    where the trace or the launch record has nothing of it."""
    trace, launches = rec.get("trace"), rec.get("launches", {}).get(kernel)
    if not trace or not launches:
        return None
    roof = roofline_module(kernel)
    seconds, seen = kernel_seconds(trace["ops"], roof.PATTERNS)
    if seconds <= 0 or seen == 0:
        return None
    least = 0.0
    for args in launches:
        flops, nbytes = roof.work(**args)
        least += max(flops / PEAK[roof.PEAK], nbytes / PEAK["bytes"])
    return 100.0 * least / seconds


# --------------------------------------------------------------- result
def emit(result: Dict, compared: List[Dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output, with
    ``compared`` as its last key."""
    result = dict(result)
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in compared}
    for c in compared:
        print(f"portbench compared {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
