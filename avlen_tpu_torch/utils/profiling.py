"""Profiling: the train loops' splits and the span recorder.

``Timings`` is the reference's env_time/pth_time splits
(av_nav/ppo/ppo_trainer.py:326-336): named wall-clock totals on
``time.perf_counter``, always on, which the four train loops log every
LOG_INTERVAL updates.

The span recorder is off unless ``enable()`` was called. ``span(name)``
marks where one layer's work happens (``SPAN_NAMES`` lists every name the
program uses); off, it returns one shared no-op after a single flag test,
reading no clock and allocating nothing. On, each span records its name,
its start and end on ``time.perf_counter_ns``, its parent span, the round
(superstep, counted by ``next_round``) and the acting step it belongs to,
and on request a CUDA event pair on the current stream (``stream=True``,
read only at ``export``) and the thread's CPU time (``cpu=True``). The
collector's pauses are recorded too. ``Timings.time`` opens a span of its
own name, so the loop's parts are the roots of the span tree.

``enable(annotate=True)`` also enters a profiler range (as
``torch.profiler.record_function`` does) of each span's name, and
``export(profile)`` then gives the offset from the recorder's clock to that
profiler's event clock, so that the in-memory spans join the device trace. The kernel wrappers' ``.launches`` counters
live beside their kernels (``ops/*_cuda.py``). The acting forwards' CUDA-graph runners (``models/graphed.py``)
register their counters in ``GRAPH_COUNTERS``, and ``export`` gives their counts over the recording. A graph replay
opens none of the spans inside the forward it replays (``act.towers``, ``act.smt``, ``act.heads``).

``count(name, n)`` adds to a named counter of the recording while it is on
(``COUNTER_NAMES`` lists them: the CLIP tower's rows, the host speaker's
queries, cache hits and decodes), and ``export`` gives them. The CLIP
tower's calls are ``InteractiveDDPPOTrainer.clip_calls``.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

# every span name the program opens; the Timings keys open spans too
SPAN_NAMES = (
    "profiling.clock_anchor",
    "superstep_time", "collect_time", "update_time", "host_time", "checkpoint_time",
    "superstep.sync", "trainer.refresh_episode_stream",
    "collect", "collect.step", "collect.belief", "collect.act", "collect.env_step",
    "collect.bootstrap", "collect.stack",
    "collect.option", "collect.dialog", "collect.instruction", "collect.clip", "speaker.decode",
    "act.towers", "act.smt", "act.heads",
    "env.dynamics", "env.audio", "env.frames",
    "update", "update.gae", "update.minibatch", "update.backward", "update.optimizer_step",
    "update.belief_step",
)
ANCHOR = SPAN_NAMES[0]
# every counter name the program adds to
COUNTER_NAMES = ("clip.rows", "speaker.queries", "speaker.cache_hits", "speaker.decodes")


class Timings:
    """Accumulating named wall-clock splits (env_time / pth_time style)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time(self, name: str, stream: bool = False) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name, stream=stream):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def summary(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in sorted(self.totals.items()))

    def reset(self) -> None:
        self.totals.clear()


# ------------------------------------------------------------ span recorder
class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_rec: Optional["Recorder"] = None
# each CUDA-graph entry point's counters (captures, replays, eager_calls), by name
GRAPH_COUNTERS: Dict[str, Dict[str, int]] = {}


def span(name: str, stream: bool = False, cpu: bool = False, step: Optional[int] = None):
    """A context that records one span while tracing is on. ``stream``:
    also a CUDA event pair on the current stream; ``cpu``: also the
    thread's CPU time; ``step``: the acting step its children belong to."""
    if not _on:
        return _OFF
    return _Span(_rec, name, stream, cpu, step)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        counters = _rec.counters
        counters[name] = counters.get(name, 0) + n


def next_round() -> None:
    """The spans from here on belong to the next round (superstep)."""
    if _on:
        _rec.round_id += 1
        _rec.step_id = -1


def enable(annotate: bool = False) -> None:
    """Start a new recording (the previous one is dropped). ``annotate``:
    each span also enters a ``record_function`` of its name, and an anchor
    span opens at once for the clock offset."""
    global _on, _rec
    disable()
    _rec = Recorder(annotate)
    gc.callbacks.append(_rec.on_gc)
    _on = True
    if annotate:
        with span(ANCHOR):
            pass


def disable() -> None:
    """Stop recording and remove the collector callback; the recording stays
    for ``export``."""
    global _on
    _on = False
    if _rec is not None and _rec.on_gc in gc.callbacks:
        gc.callbacks.remove(_rec.on_gc)


def export(profile=None) -> Optional[Dict]:
    """The recording, read after the window (the stream events are waited
    for here): per name the count, total and self host ns (self: less its
    child spans) and, for stream spans, the stream ns; the raw spans by
    column; the CPU ns of ``cpu`` spans; the annotated spans, each with the
    ns its profiler range took to enter (the profiler stamps the range's
    start inside that interval); the collector's pauses as
    (generation, start ns, ns, round); the rounds begun; and the offset
    from the recorder's clock to ``profile``'s (a finished
    ``torch.profiler.profile``) event clock, else None; and each graphed
    entry point's captures, replays and eager calls since ``enable``; and
    the counters added to since ``enable``. None before any recording."""
    return _rec.export(profile) if _rec is not None else None


class Recorder:
    """One recording: spans by column, preallocated and doubled when full."""

    COLUMNS = ("name", "start_ns", "end_ns", "parent", "round", "step")
    CAPACITY = 1 << 15  # rows: a 150-step SAVi round opens ~1,700 spans, a 51 s window ~20,000

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.cols = {c: [0] * self.CAPACITY for c in self.COLUMNS}
        self.n = 0
        self.stack: List[int] = []
        self.round_id = 0
        self.step_id = -1
        self.annotated: List[List[int]] = []  # (span index, ns its range took to enter)
        self.events: List = []  # (span index, start event, end event)
        self.cpu_ns: List[List[int]] = []
        self.gc: List[List[int]] = []
        self.gc_t0 = 0
        self.counters: Dict[str, int] = {}
        self.graphs0 = {name: dict(c) for name, c in GRAPH_COUNTERS.items()}

    def open(self, name: str) -> int:
        i = self.n
        if i == len(self.cols["name"]):
            for col in self.cols.values():
                col.extend([0] * len(col))
        self.n = i + 1
        c = self.cols
        c["name"][i] = name
        c["parent"][i] = self.stack[-1] if self.stack else -1
        c["round"][i] = self.round_id
        c["step"][i] = self.step_id
        c["end_ns"][i] = -1
        self.stack.append(i)
        c["start_ns"][i] = time.perf_counter_ns()
        return i

    def close(self, i: int, end_ns: int) -> None:
        self.cols["end_ns"][i] = end_ns
        self.stack.pop()

    def on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self.gc_t0 = time.perf_counter_ns()
        else:
            self.gc.append([info["generation"], self.gc_t0, time.perf_counter_ns() - self.gc_t0, self.round_id])

    def export(self, profile=None) -> Dict:
        n, c = self.n, self.cols
        spans = {k: col[:n] for k, col in c.items()}
        dur = [e - s if e >= 0 else 0 for s, e in zip(spans["start_ns"], spans["end_ns"])]
        child = [0] * n
        for i, p in enumerate(spans["parent"]):
            if p >= 0:
                child[p] += dur[i]
        stream_ns = []
        for i, e0, e1 in self.events:
            if e1 is None:  # the CPU: the host clock stands in
                stream_ns.append([i, dur[i]])
            else:
                e1.synchronize()
                stream_ns.append([i, int(e0.elapsed_time(e1) * 1e6)])
        by_name: Dict[str, Dict[str, int]] = {}
        for i, name in enumerate(spans["name"]):
            if spans["end_ns"][i] < 0:
                continue
            agg = by_name.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0})
            agg["count"] += 1
            agg["total_ns"] += dur[i]
            agg["self_ns"] += dur[i] - child[i]
        for i, ns in stream_ns:
            agg = by_name.get(spans["name"][i])
            if agg is not None:
                agg["stream_ns"] = agg.get("stream_ns", 0) + ns
        graphs = {name: {k: v - self.graphs0.get(name, {}).get(k, 0) for k, v in c.items()}
                  for name, c in GRAPH_COUNTERS.items()}
        return {"by_name": by_name, "spans": spans, "stream_ns": stream_ns, "cpu_ns": list(self.cpu_ns),
                "gc": list(self.gc), "rounds": self.round_id, "annotated": list(self.annotated),
                "clock_offset_ns": self.clock_offset(profile) if profile is not None else None, "graphs": graphs,
                "counters": dict(self.counters)}

    def clock_offset(self, profile) -> Optional[int]:
        """The median of (profiler start − recorder start) over the
        annotated spans, matched by name and order, of each name that both
        hold equally often (a span cut by the profile's start or end makes
        its name's counts differ, and that name is left out). A profile's
        first annotation is stamped up to ~0.1 ms late; the median is not
        moved by it."""
        mine: Dict[str, List[int]] = defaultdict(list)
        for i, _ in self.annotated:
            mine[self.cols["name"][i]].append(self.cols["start_ns"][i])
        theirs: Dict[str, List[int]] = defaultdict(list)
        for name, start_ns in profiler_starts(profile):
            if name in mine:
                theirs[name].append(start_ns)
        offsets = [t - m for name, ts in theirs.items() if len(ts) == len(mine[name])
                   for m, t in zip(sorted(mine[name]), sorted(ts))]
        return int(statistics.median(offsets)) if offsets else None


def profiler_starts(profile):
    """(name, start ns) of each host event of a finished
    ``torch.profiler.profile`` (its raw results: building the event tree
    takes minutes for a round's events)."""
    for e in profile.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            yield e.name(), e.start_ns()


def _annotation(name: str):
    """A profiler range named ``name``: torch's C++ range where it has one
    (its entry stamps within about a µs of the call, where
    ``record_function``'s Python path takes 5-60 µs, more on a loaded
    host), else ``record_function``."""
    import torch

    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    from torch.profiler import record_function

    return record_function(name)


class _Span:
    __slots__ = ("rec", "name", "stream", "cpu", "step", "i", "ev", "rf", "entered", "cpu0", "prev_step")

    def __init__(self, rec: Recorder, name: str, stream: bool, cpu: bool, step: Optional[int]):
        self.rec, self.name, self.stream, self.cpu, self.step = rec, name, stream, cpu, step

    def __enter__(self):
        r = self.rec
        if self.step is not None:
            self.prev_step, r.step_id = r.step_id, self.step
        if self.cpu:
            self.cpu0 = time.thread_time_ns()
        self.ev = None
        if self.stream:
            import torch

            if torch.cuda.is_initialized():
                self.ev = torch.cuda.Event(enable_timing=True)
                self.ev.record()
        self.rf = _annotation(self.name) if r.annotate else None
        self.i = r.open(self.name)
        if self.rf is not None:  # inside the recorder's start and end
            self.rf.__enter__()
            self.entered = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.perf_counter_ns()
        r, i = self.rec, self.i
        r.close(i, end)
        if self.rf is not None:
            r.annotated.append([i, self.entered - r.cols["start_ns"][i]])
        if self.stream:
            e1 = None
            if self.ev is not None:
                import torch

                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
            r.events.append((i, self.ev, e1))
        if self.cpu:
            r.cpu_ns.append([i, time.thread_time_ns() - self.cpu0])
        if self.step is not None:
            r.step_id = self.prev_step
        return False
